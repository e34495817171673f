"""The port's halo-exchange route (``titan_tpu_torch/parallel/halo.py``)
and its exchange layer (``parallel/comm.py``) against ``titan_tpu``.

- ``build_halo_chunk`` over 4 CPU shards (``make_mesh(devices=[cpu] *
  4)``) against ``titan_tpu.parallel.halo.build_halo_chunk`` on a 4-device
  CPU mesh, over ``tests/test_halo.py``'s variants (plain springs,
  damping, breathing, actuation, drag with deleted masses, a local
  constraint, windowed and gathered remainder springs, pairwise and binned
  magnets, Verlet, RK2): the same marshalled state through both, 20 steps,
  in f64 (x64 on), pos, vel and acc and the advanced rests within 1e-9;
  one f32 case within 1e-5 (``tests/test_torch_step.py``'s f32 tolerance);
  the JAX chunk compiled without XLA's optimisation passes
  (``test_torch_step.py::FAST_XLA``).
- ``halo_reject_reason`` equal to the JAX package's, string for string,
  over a table of scene shapes and shard counts.
- The exchange layer on its own: the ring's edges wrap, the gather and
  its transpose under autograd, the sum in axis order, halos filled in
  place; placement and gather of a state round-trip.

The scenes are ``tests/test_halo.py``'s long lattice (32 x 4 x 4, deltas up
to 21: 128-mass blocks over 4 shards), built by ``titan_tpu`` and carried
into the port (``test_torch_step.py::carry_over``).
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu.parallel import halo as jhalo
from titan_tpu.parallel import make_mesh as jax_make_mesh
from titan_tpu_torch.parallel import comm, make_mesh
from titan_tpu_torch.parallel import halo, sharded
from titan_tpu_torch.state import shape_from_fields

from test_torch_step import FAST_XLA, carry_over

SHARDS = 4
STEPS = 20
TOL_F64, TOL_F32 = 1e-9, 1e-5


def dist_scene(pkg, dtype="float32", damping=0.0, breathing=False,
               actuated=False, drag=0.0, deleted=False,
               local_constraint=False, integrator=None, magnets=False,
               magnet_binned=False, magnet_plain=False, remainder=False,
               remainder_actuated=False, remainder_long=False,
               marshal=True, **config):
    """``tests/test_halo.py::_scene`` in either package and dtype: a 32 x 4
    x 4 lattice (8 m long) on a friction plane, with the features asked
    for (the port's on the CPU)."""
    cfg = dict(dict(velocity_clamp=False, dtype=dtype), **config)
    if integrator:
        cfg["integrator"] = getattr(pkg.Integrator, integrator.upper())
    if magnets:
        cfg["magnet_cutoff"] = 0.6
    if magnet_binned:
        cfg.update(magnet_binned_threshold=2, magnet_cell_cap=64)
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    sim.createLattice(pkg.Vec(0, 0, 3), pkg.Vec(8, 1, 1), 32, 4, 4)
    sim.setAllSpringConstantValues(500.0)
    if remainder or remainder_actuated:
        # index offsets that are no family's: remainder springs within a
        # 128-mass block's reach
        for base, d in ((10, 23), (70, 29), (200, 31), (300, 37)):
            sp = sim.createSpring(sim.masses[base], sim.masses[base + d])
            sp._k = 800.0
            sp.defaultLength()
            if remainder_actuated:
                sp._type = pkg.ACTUATED_CONTRACT
                sp._l_min = sp._rest * 0.8
                sp._rate = 0.4
    if remainder_long:
        # spans past a block: the gathered remainder path
        for base, d in ((10, 293), (40, 211), (5, 449), (100, 307)):
            sp = sim.createSpring(sim.masses[base], sim.masses[base + d])
            sp._k = 800.0
            sp.defaultLength()
    if magnets:
        for i in (3, 7, 19, 63, 79, 200, 204):
            mm = sim.masses[i]
            mm.rad = 0.05
            mm.stiffness = 200.0
            mm.max_mag_force = 1.0
            mm.mag_scale_factor = 1.0
    if magnet_plain:
        mm = sim.masses[5]
        mm.rad = 0.3
        mm.stiffness = 150.0
        mm.max_mag_force = 0.5
        mm.mag_scale_factor = 1.0
        sim._store.mag_stiffness[21] = 0.0
    st = sim._store
    if damping:
        st.damping[: st.n_springs] = damping
    if breathing:
        half = st.n_springs // 2
        st.s_type[:half] = pkg.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[:half] = 6.0
    if actuated:
        q = st.n_springs // 4
        st.s_type[:q] = pkg.ACTUATED_EXPAND
        st.l_max[:q] = st.rest[:q] * 1.15
        st.rate[:q] = 0.3
    if drag:
        st.drag[: st.n_masses] = drag
    if deleted:
        st.valid[10] = False
        st.valid[200] = False
    if local_constraint:
        sim.masses[5].addConstraint(pkg.CONTACT_PLANE, pkg.Vec(0, 0, 1),
                                    -0.5)
    sim.createPlane(pkg.Vec(0, 0, 1), 0, 0.2, 0.3)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    sim.setTimeStep(0.0001)
    if marshal:
        sim._T = 0.0
        sim._marshal()
    return sim


def cpu_mesh(shards=SHARDS):
    return make_mesh(("shard",), devices=[torch.device("cpu")] * shards)


def halo_run(shape, state, steps, mesh=None):
    """The port's halo route over ``mesh`` (default 4 CPU shards) as the
    control plane runs it: place, chunk, gather."""
    mesh = mesh or cpu_mesh()
    run = halo.build_halo_chunk(shape, mesh)
    b = shape.n_masses // mesh.shape["shard"]
    return sharded.DistributedChunk("halo", shape, mesh, "shard", b,
                                    run)(state, steps)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(("shard",), devices=jax.devices()[:SHARDS])


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def jax_halo(jsim, mesh, steps):
    """``titan_tpu``'s halo chunk over ``mesh``, compiled with FAST_XLA."""
    placed = jhalo.place(jsim._state, mesh)
    fn = jhalo.build_halo_chunk(jsim._shape, mesh)(placed)
    n = jnp.int32(steps)
    return fn.lower(placed, n).compile(compiler_options=FAST_XLA)(placed, n)


def assert_close(port, want, n, tol, rests=False):
    for f in ("pos", "vel", "acc"):
        np.testing.assert_allclose(
            getattr(port.masses, f).numpy()[:, :n],
            np.asarray(getattr(want.masses, f))[:, :n], atol=tol, rtol=0,
            err_msg=f)
    np.testing.assert_allclose(port.masses.T.numpy()[:n],
                               np.asarray(want.masses.T)[:n], atol=tol)
    if rests:
        np.testing.assert_allclose(port.stencil.rest.numpy(),
                                   np.asarray(want.stencil.rest), atol=tol)
        np.testing.assert_allclose(port.springs.rest.numpy(),
                                   np.asarray(want.springs.rest), atol=tol)


VARIANTS = {
    "plain": dict(),
    "breathing_actuated": dict(breathing=True, actuated=True),
    "drag_deleted": dict(drag=0.3, deleted=True),
    "local_constraint": dict(local_constraint=True),
    "verlet_damped": dict(integrator="verlet", damping=0.4),
    "rk2_damped_actuated": dict(integrator="rk2", damping=0.4,
                                actuated=True),
    "remainder_actuated": dict(remainder_actuated=True),
    "remainder_long_damped": dict(remainder_long=True, damping=0.5),
    "magnet_plain_contact": dict(magnets=True, magnet_plain=True),
    "magnets_binned_deleted": dict(magnets=True, magnet_binned=True,
                                   deleted=True),
    "rk2_magnets_binned_remainder": dict(integrator="rk2", magnets=True,
                                         magnet_binned=True,
                                         remainder=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_halo_chunk_matches_jax_f64(variant, jax_mesh, x64):
    jsim = dist_scene(titan_tpu, "float64", **VARIANTS[variant])
    assert jhalo.halo_supported(jsim._shape, SHARDS)
    shape, state = carry_over(jsim)
    assert halo.halo_reject_reason(shape, SHARDS) is None
    if "remainder_long" in variant:
        assert not halo._remainder_windowed(shape, SHARDS)
    elif "remainder" in variant:
        assert halo._remainder_windowed(shape, SHARDS)
    want = jax_halo(jsim, jax_mesh, STEPS)
    got = halo_run(shape, state, STEPS)
    assert got.masses.pos.dtype == torch.float64
    assert_close(got, want, jsim._store.n_masses, TOL_F64, rests=True)
    assert not torch.equal(got.masses.pos, state.masses.pos)


def test_halo_chunk_matches_jax_f32(jax_mesh):
    jsim = dist_scene(titan_tpu, damping=0.3, remainder=True)
    shape, state = carry_over(jsim)
    want = jax_halo(jsim, jax_mesh, STEPS)
    got = halo_run(shape, state, STEPS)
    n = jsim._store.n_masses
    for f in ("pos", "vel"):
        np.testing.assert_allclose(
            getattr(got.masses, f).numpy()[:, :n],
            np.asarray(getattr(want.masses, f))[:, :n], atol=TOL_F32,
            err_msg=f)


def _shapes():
    """(label, JAX shape, shard count) cases for the reject reasons."""
    base = dist_scene(titan_tpu)._shape
    long = dist_scene(titan_tpu, remainder_long=True)._shape
    cube = titan_tpu.Simulation(titan_tpu.SimConfig(velocity_clamp=False))
    cube.createLattice(titan_tpu.Vec(0, 0, 3), titan_tpu.Vec(1, 1, 1), 8, 8,
                       8)
    cube._T = 0.0
    cube._marshal()
    cfg = base.config
    rep = dataclasses.replace
    return [
        ("plain", base, 4), ("plain 8", base, 8), ("plain 16", base, 16),
        ("cube 8", cube._shape, 8),
        ("gathered remainder", long, 4),
        ("strict extern", rep(base, config=rep(
            cfg, persistent_extern_force=False)), 4),
        ("no stencil", rep(base, config=rep(cfg, use_stencil=False)), 4),
        ("no springs", rep(base, stencil_deltas=(), has_remainder=False), 4),
        ("indivisible", rep(base, n_masses=510), 4),
        ("rk2", rep(base, config=rep(
            cfg, integrator=titan_tpu.Integrator.RK2)), 4),
    ]


def test_halo_reject_reason_matches_jax():
    for label, jshape, d in _shapes():
        want = jhalo.halo_reject_reason(jshape, d)
        got = halo.halo_reject_reason(shape_from_fields(jshape, "cpu"), d)
        assert got == want, (label, got, want)
    assert [jhalo.halo_reject_reason(s, d) is None
            for _, s, d in _shapes()].count(True) == 5


def test_ring_edges_wrap_and_gather_transposes():
    mesh = cpu_mesh()
    blocks = [torch.arange(6.0).reshape(1, 6) + 10 * i for i in range(4)]
    prev, nxt = comm.ring_edges(mesh, blocks, 2)
    assert torch.equal(prev[0], blocks[3][:, 4:])
    assert torch.equal(nxt[3], blocks[0][:, :2])
    assert torch.equal(prev[2], blocks[1][:, 4:])
    ext = comm.halo_extend(mesh, blocks, 2)
    assert torch.equal(ext[1], torch.cat([blocks[0][:, 4:], blocks[1],
                                          blocks[2][:, :2]], dim=1))
    leaves = [b.clone().requires_grad_() for b in blocks]
    full = comm.all_gather(mesh, leaves)
    w = torch.linspace(0, 1, 24).reshape(1, 24)
    grads = torch.autograd.grad((full * w).sum(), leaves)
    for i, g in enumerate(grads):
        assert torch.equal(g, w[:, 6 * i:6 * (i + 1)])
    parts = comm.local_rows(mesh, full.detach(), 6)
    assert all(torch.equal(p, b) for p, b in zip(parts, blocks))
    vals = [torch.tensor([0.1]), torch.tensor([0.2]), torch.tensor([1e8]),
            torch.tensor([-1e8])]
    assert torch.equal(comm.psum(mesh, vals),
                       ((vals[0] + vals[1]) + vals[2]) + vals[3])


def test_fill_halos_in_place_and_state_round_trip():
    mesh = cpu_mesh()
    wins = [torch.zeros(2, 3 + 5 + 3) for _ in range(4)]
    for i, w in enumerate(wins):
        w[:, 3:8] = i + 1
    comm.fill_halos(mesh, wins, 3, 5)
    assert torch.all(wins[0][:, :3] == 4) and torch.all(wins[0][:, 8:] == 2)
    assert torch.all(wins[2][:, :3] == 2) and torch.all(wins[2][:, 3:8] == 3)
    jsim = dist_scene(titan_tpu, remainder=True, local_constraint=True)
    shape, state = carry_over(jsim)
    shards = sharded.shard_state(sharded.pad_state(state, 4 * 130), mesh,
                                 "shard", 130)
    assert shards[1].masses.pos.shape == (3, 130)
    assert shards[1].stencil.k.shape[1] == 130
    assert shards[1].springs.left.shape == state.springs.left.shape
    back = sharded.unpad_state(sharded.gather_state(mesh, shards),
                               shape.n_masses)
    for group in ("masses", "stencil", "lcon", "topo", "springs"):
        a, b = getattr(back, group), getattr(state, group)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                (group, f.name)
