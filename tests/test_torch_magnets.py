"""The port's magnet fields against the JAX package's.

Each field gets the same marshalled state (a titan_tpu scene carried over
with ``state_from_numpy``) in both packages:

- ``forces.magnet_forces`` against ``titan_tpu.ops.forces.magnet_forces``:
  f64 (x64 on) to 1e-9; f32 to 2e-5 * max(max |want|, 1) plus rtol 1e-4,
  the tolerance of tests/test_magnets_grid.py (f32 pair sums taken in
  another order);
- ``magnets.binned_magnet_forces`` against the JAX binned pass, with and
  without receiver compaction, on a deleted-mass (trash-row) scene and an
  overflowing cell, at the same f32 tolerance;
- ``magnets_grid.grid_magnet_forces_plain`` (the plain version of the grid
  kernel) against ``titan_tpu.ops.magnets_grid.grid_magnet_forces`` in
  Pallas interpret mode on one 400-mass scene, and against the JAX binned
  pass on the overflow and edge-clipped scenes of tests/test_magnets_grid.py;
- the magnet flags of ``_feature_flags`` (binned, grid, receivers) equal
  to the JAX package's at marshal;
- the eager step's magnet term (``step.magnet_pass``) in f64 to 1e-9 on the
  pairwise, binned and compacted-receiver routes, against the JAX XLA
  step, and the eager chunk's hoisted receiver set;
- the route table of ``step.magnet_route`` (shapes only, no field).

Small tensors: torch runs these on one thread (several threads cost more
than they save at these sizes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu.ops import forces as JF
from titan_tpu.ops.magnets import binned_magnet_forces
from titan_tpu.ops.magnets_grid import grid_magnet_forces as jax_grid
from titan_tpu.ops.step import build_chunk_fn as jax_chunk_fn
from titan_tpu.state import pad_to
from titan_tpu_torch.ops import forces as TF
from titan_tpu_torch.ops import fused_step
from titan_tpu_torch.ops import magnets as TM
from titan_tpu_torch.ops import magnets_grid as TG
from titan_tpu_torch.ops import step as tstep
from titan_tpu_torch.state import SceneShape, xla_only_shape

from test_torch_magnet_scenes import link_scene
from test_torch_step import carry_over

CUTOFF = 0.14
# one compiled program per scene instead of one per eager operation
jax_binned = jax.jit(binned_magnet_forces, static_argnums=(1, 2, 3),
                     static_argnames=("receivers",))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def magnet_scene(n=400, seed=0, spread=1.5, dtype="float32", edit=None):
    """The random magnet cloud of tests/test_magnets_binned.py (a few
    masses per 0.14 m cell, many pairs straddling the cutoff), marshalled
    in titan_tpu; ``edit(store)`` changes it before the marshal."""
    rng = np.random.RandomState(seed)
    sim = titan_tpu.Simulation(titan_tpu.SimConfig(
        dtype=dtype, magnet_binned_threshold=10**9))
    st = sim._store
    for _ in range(n):
        sim.createMass(titan_tpu.Vec(*rng.uniform(-spread, spread, 3)))
    st.mag_rad[:n] = rng.uniform(0.01, 0.05, n)
    st.mag_stiffness[:n] = rng.uniform(100, 500, n)
    st.mag_maxf[:n] = rng.uniform(0.0, 2.0, n)
    st.mag_scale[:n] = rng.choice([0.0, 1.0], n)
    if edit is not None:
        edit(st)
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


def deleted_and_zero_param(st):
    """Deleted masses, and a zero-parameter mass inside a magnet's shell,
    which must still act as a shell-contact source (sim.cu:842)."""
    st.valid[[7, 123]] = False
    for i in (3, 50, 200):
        st.mag_rad[i] = st.mag_stiffness[i] = 0.0
        st.mag_maxf[i] = st.mag_scale[i] = 0.0
    st.pos[300] = (2.5, 2.5, 0.0)
    st.mag_rad[300], st.mag_stiffness[300] = 0.06, 200.0
    st.pos[301] = (2.53, 2.5, 0.0)
    st.mag_rad[301] = st.mag_stiffness[301] = 0.0
    st.mag_maxf[301] = st.mag_scale[301] = 0.0


def trash_row_scene():
    """tests/test_magnets_binned.py's trash-row regression: a receiver, a
    deleted magnet 0.05 m away, and the rest far off, so the receiver's
    3 x 3 window is mostly empty cells (it reads the empty row)."""
    sim = titan_tpu.Simulation(titan_tpu.SimConfig())
    st = sim._store
    sim.createMass(titan_tpu.Vec(0, 0, 0))
    sim.createMass(titan_tpu.Vec(0.05, 0, 0))
    for i in range(30):
        sim.createMass(titan_tpu.Vec(5 + i * 0.5, 5, 5))
    st.mag_rad[:2] = 0.05
    st.mag_stiffness[:2] = 200.0
    st.mag_maxf[:2] = 1.0
    st.mag_scale[:2] = 1.0
    st.valid[1] = False
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


def attractor_scene(n=600, n_att=24, seed=3):
    """Sparse pure attractors (every shell radius 0) in a cloud, one of
    them deleted: the receiver-compaction case."""
    rng = np.random.RandomState(seed)
    sim = titan_tpu.Simulation(titan_tpu.SimConfig(
        magnet_binned_threshold=16))
    st = sim._store
    for _ in range(n):
        sim.createMass(titan_tpu.Vec(*rng.uniform(-1.5, 1.5, 3)))
    att = rng.choice(n, n_att, replace=False)
    st.mag_maxf[att] = rng.uniform(0.5, 2.0, n_att)
    st.mag_scale[:n] = 1.0
    st.valid[att[0]] = False
    st.valid[17] = False
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


def edge_scene():
    """96 masses far outside the grid's +-17.9 m span, clipped into the
    edge cell (tests/test_magnets_grid.py::test_grid_edge_cells)."""
    rng = np.random.RandomState(6)
    sim = titan_tpu.Simulation(titan_tpu.SimConfig())
    n = 96
    for _ in range(n):
        sim.createMass(titan_tpu.Vec(
            *(np.asarray([-30.0, -30.0, 0.0]) + rng.uniform(0, 0.3, 3))))
    st = sim._store
    st.mag_rad[:n] = 0.04
    st.mag_stiffness[:n] = 300.0
    st.mag_maxf[:n] = 1.0
    st.mag_scale[:n] = 1.0
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


def assert_f32_close(got, want):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * scale,
                               rtol=1e-4)


def test_magnet_forces_matches_jax_f64(x64):
    jsim = magnet_scene(dtype="float64", edit=deleted_and_zero_param)
    masses = carry_over(jsim)[1].masses
    assert masses.pos.dtype == torch.float64
    want = np.asarray(JF.magnet_forces(jsim._state.masses, CUTOFF))
    got = TF.magnet_forces(masses, CUTOFF)
    assert np.abs(want[:, 300]).max() > 0, "shell overlap not exercised"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("seed,chunk", [(0, 2048), (1, 2048), (2, 128)])
def test_magnet_forces_matches_jax_f32(seed, chunk):
    """Chunk 128 takes both packages through their source-chunk loops."""
    jsim = magnet_scene(seed=seed)
    masses = carry_over(jsim)[1].masses
    want = JF.magnet_forces(jsim._state.masses, CUTOFF, chunk=chunk)
    assert_f32_close(TF.magnet_forces(masses, CUTOFF, chunk=chunk), want)


@pytest.mark.parametrize("case", ["dense", "deleted_zero_param", "trash_row",
                                  "overflow", "receivers"])
def test_binned_matches_jax(case):
    receivers = 0
    if case == "dense":
        jsim, a, cap = magnet_scene(seed=1), pad_to(400, 8), 64
    elif case == "deleted_zero_param":
        jsim = magnet_scene(seed=2, edit=deleted_and_zero_param)
        a, cap = pad_to(400, 8), 64
    elif case == "trash_row":
        jsim, a, cap = trash_row_scene(), pad_to(32, 8), 16
    elif case == "overflow":
        # ~one cell holds all 64: 56 of them are no source, all receive
        jsim, a, cap = magnet_scene(n=64, seed=4, spread=0.01), 64, 8
    else:
        jsim = attractor_scene()
        a, cap = jsim._shape.magnet_binned
        receivers = jsim._shape.magnet_receivers
        assert receivers
    masses = carry_over(jsim)[1].masses
    want = jax_binned(jsim._state.masses, CUTOFF, a, cap, receivers=receivers)
    got = TM.binned_magnet_forces(masses, CUTOFF, a, cap,
                                  receivers=receivers)
    assert_f32_close(got, want)
    if case == "trash_row":
        assert torch.all(got[:, 0] == 0.0)      # nothing left in range
        assert torch.all(got[:, 1] == 0.0)      # the deleted magnet
    if case == "receivers":
        # the compacted rows are the valid attractors only
        nz = torch.nonzero(torch.any(got != 0.0, dim=0)).flatten().tolist()
        att = np.flatnonzero(jsim._store.mag_maxf[:600] != 0.0)
        assert nz and set(nz) <= set(att.tolist())


def test_grid_plain_matches_jax_interpret():
    """The one interpret-mode call of the JAX grid kernel (it is slow on
    the CPU)."""
    jsim = magnet_scene(seed=0)
    masses = carry_over(jsim)[1].masses
    want = jax_grid(jsim._state.masses, CUTOFF, pad_to(400, 8), 16, True)
    assert_f32_close(TG.grid_magnet_forces_plain(masses, CUTOFF, 16), want)


@pytest.mark.parametrize("case", ["overflow", "edge", "deleted_zero_param"])
def test_grid_plain_matches_jax_binned(case):
    """Where a cell holds more than the cap, the JAX grid pass is its
    binned pass (its lax.cond): the plain grid version must give the
    binned field with no branch."""
    if case == "overflow":
        jsim, a, cap = magnet_scene(n=64, seed=4, spread=0.01), 64, 8
    elif case == "edge":
        jsim, a, cap = edge_scene(), pad_to(96, 8), 128
    else:
        jsim = magnet_scene(seed=5, edit=deleted_and_zero_param)
        a, cap = pad_to(400, 8), 64
    masses = carry_over(jsim)[1].masses
    want = jax_binned(jsim._state.masses, CUTOFF, a, cap)
    got = TG.grid_magnet_forces_plain(masses, CUTOFF, cap)
    assert_f32_close(got, want)
    if case == "overflow":
        assert torch.count_nonzero(got) > 0


def test_grid_on_cpu_is_plain():
    """On a CPU tensor the grid wrapper runs its plain version."""
    jsim = magnet_scene(n=64, seed=4, spread=0.01)
    masses = carry_over(jsim)[1].masses
    before = TG.grid_magnet_forces.launches
    assert torch.equal(TG.grid_magnet_forces(masses, CUTOFF, 8),
                       TG.grid_magnet_forces_plain(masses, CUTOFF, 8))
    assert TG.grid_magnet_forces.launches == before


def big_magnet_sim(pkg, n=12000, attractors=False, **cfg):
    """12k masses by direct store fill, marshalled (no step): the scene of
    tests/test_magnets_grid.py::_big_magnet_sim; ``attractors`` makes them
    sparse pure attractors instead."""
    rng = np.random.RandomState(7)
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    st = sim._store
    st.reserve_masses(n)
    st.pos[:n] = rng.uniform(-3, 3, (n, 3))
    st.valid[:n] = True
    st.n_masses = n
    if attractors:
        st.mag_maxf[: n // 10] = 1.0
        st.mag_scale[:n] = 1.0
    else:
        st.mag_rad[:n] = 0.03
        st.mag_stiffness[:n] = 200.0
        st.mag_maxf[:n] = 1.0
        st.mag_scale[:n] = 1.0
    st.valid[5] = False
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


@pytest.mark.parametrize("case", [
    "default", "float64", "cap12", "grid_off", "pallas_off", "attractors",
    "below_threshold"])
def test_magnet_flags_match_jax(case):
    kw = dict(default={}, float64=dict(dtype="float64"),
              cap12=dict(magnet_cell_cap=12),
              grid_off=dict(magnet_grid_threshold=10**9),
              pallas_off=dict(use_pallas=False),
              attractors=dict(attractors=True),
              below_threshold=dict(magnet_binned_threshold=20000))[case]
    flags = ("has_magnets", "magnet_binned", "magnet_grid",
             "magnet_receivers", "all_valid")
    got, want = (big_magnet_sim(pkg, **kw)._shape
                 for pkg in (titan_tpu_torch, titan_tpu))
    assert ({f: getattr(got, f) for f in flags}
            == {f: getattr(want, f) for f in flags})
    assert got.has_magnets
    if case == "default":
        assert got.magnet_binned and got.magnet_grid
    if case == "attractors":
        assert got.magnet_receivers and not got.magnet_grid


def receiver_lattice(pkg):
    """A 4^3 lattice with three pure attractors (shell radius 0): binned
    with a compacted receiver set."""
    cfg = dict(dtype="float64", magnet_binned_threshold=1)
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    sim.createLattice(pkg.Vec(0, 0, 0.5), pkg.Vec(0.3, 0.3, 0.3), 4, 4, 4)
    st = sim._store
    st.mag_scale[:64] = 1.0
    st.mag_maxf[[0, 21, 42]] = 0.5
    sim.createPlane(pkg.Vec(0, 0, 1), 0)
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


@pytest.mark.parametrize("route", ["pairwise", "binned", "receivers"])
def test_eager_step_with_magnets_matches_jax_f64(route, x64):
    if route == "receivers":
        jsim = receiver_lattice(titan_tpu)
        assert jsim._shape.magnet_receivers
    else:
        jsim = link_scene(titan_tpu, dtype="float64", magnetic_force=1.0,
                          binned=route == "binned")
    shape, state = carry_over(jsim)
    assert fused_step.fused_reject_reason(shape) is not None   # f64
    before = tstep.run_eager.steps
    out = tstep.build_chunk_fn(shape)(state, 20)
    assert tstep.run_eager.steps == before + 20
    want = jax_chunk_fn(jsim._shape)(jsim._state, jnp.int32(20))
    n = jsim._store.n_masses
    for f in ("pos", "vel", "acc"):
        np.testing.assert_allclose(
            getattr(out.masses, f).numpy()[:, :n],
            np.asarray(getattr(want.masses, f))[:, :n], atol=1e-9,
            rtol=1e-9, err_msg=f)
    if route == "receivers":
        # the hoisted receiver set gives the step's own answer
        step = tstep.build_step_fn(shape)
        one = step(state)
        hoisted = step(state, magnet_ridx=tstep.chunk_ridx(shape,
                                                           state.masses))
        assert torch.equal(one.masses.vel, hoisted.masses.vel)


def route_shape(binned, grid=False, receivers=0):
    return SceneShape(
        n_masses=64, n_springs=0, max_degree=0, stencil_deltas=(),
        has_remainder=False, n_planes=0, n_balls=0, plane_friction=(),
        cap_cp=0, cap_ball=0, cap_pl=0, cap_dir=0, has_magnets=True,
        has_drag=False, has_breathing=False, has_actuated=False,
        has_damping=False, all_valid=True,
        config=titan_tpu_torch.SimConfig(device="cpu"),
        magnet_binned=(64, 16) if binned else (), magnet_grid=grid,
        magnet_receivers=receivers)


# (binned, magnet_grid, receivers) -> route of the fused step, of its
# plain version and of the eager step, on the card and on the CPU
@pytest.mark.parametrize("scene,cuda_routes,cpu_routes", [
    ((False, False, 0), ("pairwise", "all_pairs", "all_pairs"),
     ("pairwise", "all_pairs", "all_pairs")),
    ((True, True, 0), ("grid", "grid_plain", "grid"),
     ("binned", "binned", "binned")),
    # magnet_grid off by the JAX package's TPU policy (use_pallas, cell
    # cap, threshold) or by receiver compaction: the fused step still
    # takes the grid kernel on the card
    ((True, False, 0), ("grid", "grid_plain", "binned"),
     ("binned", "binned", "binned")),
    ((True, False, 8), ("grid", "grid_plain", "binned"),
     ("binned", "binned", "binned"))])
def test_magnet_route(scene, cuda_routes, cpu_routes):
    """``step.magnet_route`` is the one place a magnet pass is picked: the
    fused step on the card always takes a kernel, the eager step takes the
    grid kernel only where ``magnet_grid`` is set, and ``xla_only_shape``
    (the gradient paths' shape) keeps the eager step off both kernels."""
    shape = route_shape(*scene)
    for dev, want in (("cuda", cuda_routes), ("cpu", cpu_routes)):
        d = torch.device(dev)
        got = (tstep.magnet_route(shape, d, fused=True),
               tstep.magnet_route(shape, d, fused=True, plain=True),
               tstep.magnet_route(shape, d))
        assert got == want, dev
        assert tstep.magnet_route(xla_only_shape(shape), d) in (
            "all_pairs", "binned")
