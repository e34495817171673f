"""The port's remainder springs (springs in no stencil family) against
titan_tpu, in every form the port computes them.

- ``forces.remainder_forces_plain`` (the ordered incidence sum, the plain
  version of ``csrc/step_body.cuh::remainder_forces``) against the JAX
  package's ``spring_forces`` + GATHER scatter, and the port's
  ``compact_remainder_forces`` against the JAX one, in f64 at 1e-9, on
  lattices with cross links: plain, damped, breathing, ACTUATED, a fixed
  endpoint, a deleted endpoint, a hub of degree 10;
- the eager step with SEGMENT scatter against the JAX XLA step in f64 at
  1e-9, and ``fused_chunk_plain`` on that scene (whose topology carries no
  incidence table, so ``forces.incidence`` builds one) bitwise the same
  scene marshalled for GATHER;
- ``fused_chunk_plain`` against ``titan_tpu.ops.pallas_step`` in Pallas
  interpret mode at tests/test_pallas_step.py's tolerances (pos / vel
  1e-5, remainder rest 1e-6), and ``tiled_chunk_plain`` against
  ``titan_tpu.ops.pallas_tiled``'s chunk with its remainder glue, in
  interpret mode, at tests/test_torch_tiled.py's (pos and vel 5e-6 /
  rtol 1e-5; ACTUATED pos 3e-5 / 1e-4, vel 5e-3 / 1e-3, rest 1e-5: the
  port's tiled path takes the families' closed-form rest, the JAX glue
  advances it step by step);
- ``step.chunk_route`` and ``diff.grad_route`` against the JAX package's
  rules (``pallas_reject_reason``, ``adjoint_reject_reason``) on shapes
  either side of the selector budget and of the residency rule, and a
  scene without stencil families on the fused step (a deliberate
  deviation: the reference runs it on XLA);
- a ``Simulation`` with links made before start and at a pause, against
  titan_tpu in f32 and f64 (tests/test_torch_simulation.py's tolerances),
  on the fused route, not the eager one.
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
from titan_tpu.ops import adjoint as jadj
from titan_tpu.ops import forces as JF
from titan_tpu.ops import pallas_step, pallas_tiled
from titan_tpu.state import SceneShape as JaxShape
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import forces as F
from titan_tpu_torch.ops import fused_step, tiled_step
from titan_tpu_torch.ops import step as tstep
from titan_tpu_torch.ops.adjoint import adjoint_resident_bytes

from test_torch_simulation import TOL, demo_scene, dtype, positions  # noqa: F401
from test_torch_step import carry_over, jax_chunk_ref
from test_torch_tiled import _lattice_shape

KINDS = ("plain", "damped", "breathing", "actuated", "fixed", "deleted",
         "hub")


def link_scene(pkg, kind="plain", integrator=None, dtype="float32", n=5,
               links=12, friction=False, scatter=None, marshal=True):
    """An n^3 lattice over a plane (with a 0.4 / 0.6 friction plane and the
    bottom layer sliding 1 cm inside it for ``friction``: 5 cm deep, the
    penalty contact throws that layer at the velocity clamp, where f32
    rounding alone sets its tangential velocity, XLA's and PyTorch's 3e-3
    apart in 30 steps with no link at all) and ``links`` cross
    links in scripts/tpu_mega_glue_breakdown.py's pattern
    (``RandomState(0)``, one endpoint in each half of the masses, k 500,
    rest the current distance), built the same way in either package (the
    port on the CPU).  ``kind``: "damped" links (0.5), "breathing" ones
    (ACTIVE_CONTRACT_THEN_EXPAND, omega 7), "actuated" (half expanding to
    1.2 rest, half contracting to 0.8, rate 0.5), a "fixed" or "deleted"
    endpoint, or a "hub" (mass 0 with 9 more links)."""
    cfg = dict(dtype=dtype)
    if integrator:
        cfg["integrator"] = pkg.Integrator(integrator)
    if scatter:
        cfg["scatter"] = pkg.ScatterMode[scatter]
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    sim.createLattice(pkg.Vec(0, 0, 0.49 if friction else 1.0),
                      pkg.Vec(1, 1, 1), n, n, n)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    nm, s0 = st.n_masses, st.n_springs
    rng = np.random.RandomState(0)
    ends = [(rng.randint(nm // 2), nm // 2 + rng.randint(nm - nm // 2))
            for _ in range(links)]
    if kind == "hub":
        ends += [(0, int(j)) for j in rng.choice(np.arange(2, nm), 9,
                                                  replace=False)]
    for a, b in ends:
        sim.createSpring(sim.masses[a], sim.masses[b])
    s1 = st.n_springs
    st.k[s0:s1] = 500.0
    if kind == "damped":
        st.damping[s0:s1] = 0.5
    elif kind == "breathing":
        st.s_type[s0:s1] = pkg.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[s0:s1] = 7.0
    elif kind == "actuated":
        mid = (s0 + s1) // 2
        st.s_type[s0:mid] = pkg.ACTUATED_EXPAND
        st.l_max[s0:mid] = st.rest[s0:mid] * 1.2
        st.s_type[mid:s1] = pkg.ACTUATED_CONTRACT
        st.l_min[mid:s1] = st.rest[mid:s1] * 0.8
        st.rate[s0:s1] = 0.5
    elif kind == "fixed":
        st.fixed[ends[0][0]] = True
    elif kind == "deleted":
        st.valid[ends[1][1]] = False
    if friction:
        sim.createPlane(pkg.Vec(0, 0, 1), 0, 0.4, 0.6)
        st.vel[:nm] = (0.3, 0.1, 0.0)
    else:
        sim.createPlane(pkg.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    if marshal:
        sim._T = 0.0
        sim._marshal()
    return sim


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("kind", KINDS)
def test_remainder_forces_match_jax(kind, x64):
    jsim = link_scene(titan_tpu, kind, dtype="float64", friction=True)
    js = jsim._state
    assert jsim._shape.has_remainder
    shape, state = carry_over(jsim)
    n = jsim._store.n_masses
    t, dt = 0.37, js.dt
    # drive the springs off their rest and their ends apart in velocity
    rng = np.random.RandomState(3)
    pos = np.asarray(js.masses.pos) + rng.normal(0, 0.02, js.masses.pos.shape)
    vel = rng.normal(0, 0.5, js.masses.vel.shape)
    jm = dataclasses.replace(js.masses, pos=jnp.asarray(pos),
                             vel=jnp.asarray(vel))
    tm = dataclasses.replace(state.masses, pos=torch.from_numpy(pos),
                             vel=torch.from_numpy(vel))
    br = jsim._shape.has_breathing
    f_sp, rest_j = JF.spring_forces(jm, js.springs, jnp.float64(t), dt, br)
    want = np.asarray(JF.scatter_spring_forces(
        f_sp, js.topo, jm.fixed, js.masses.pos.shape[1],
        titan_tpu.ScatterMode.GATHER))
    got, rest_t = F.remainder_forces_plain(
        tm, state.springs, state.topo, torch.tensor(t, dtype=torch.float64),
        state.dt, br, shape.has_damping)
    got = torch.where(tm.fixed, 0.0, got).numpy()
    assert np.abs(want[:, :n]).max() > 1.0
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(rest_t.numpy(), np.asarray(rest_j),
                               atol=1e-12)
    if kind == "actuated":
        assert not np.array_equal(np.asarray(rest_j),
                                  np.asarray(js.springs.rest))

    # the O(S) form of the tiled glue, endpoint validity folded in
    jsp = dataclasses.replace(js.springs, valid=(
        js.springs.valid & jm.valid[js.springs.left]
        & jm.valid[js.springs.right]))
    tsp = dataclasses.replace(state.springs, valid=torch.from_numpy(
        np.array(jsp.valid)))
    cw, crj = JF.compact_remainder_forces(
        jsp, jm.pos, jm.vel, js.springs.rest, jnp.float64(t), dt, 0, n, br,
        shape.has_damping)
    cg, crt = F.compact_remainder_forces(
        tsp, tm.pos, tm.vel, state.springs.rest,
        torch.tensor(t, dtype=torch.float64), state.dt, 0, n, br,
        shape.has_damping)
    np.testing.assert_allclose(cg.numpy(), np.asarray(cw), atol=1e-9,
                               rtol=1e-9)
    np.testing.assert_allclose(crt.numpy(), np.asarray(crj), atol=1e-12)


def test_segment_scatter_matches_jax(x64):
    """SEGMENT scatter in the eager step (f64, 30 steps, damped links and a
    hub) against the JAX XLA step; and the fused chunk's plain version on
    that scene, whose topology has no incidence table, bitwise the scene
    marshalled for GATHER."""
    jsim = link_scene(titan_tpu, "hub", dtype="float64", scatter="SEGMENT")
    st = jsim._store
    st.damping[: st.n_springs] = 0.3
    jsim._marshal()
    assert jsim._shape.config.scatter is titan_tpu.ScatterMode.SEGMENT
    shape, state = carry_over(jsim)
    assert state.topo.inc_idx.shape[0] != shape.n_masses
    out = tstep.run_eager(tstep.build_step_fn(shape), state, 30)
    want = jax_chunk_ref(jsim._shape, jsim._state, 30)
    n = st.n_masses
    for f in ("pos", "vel", "acc"):
        np.testing.assert_allclose(getattr(out.masses, f).numpy()[:, :n],
                                   np.asarray(getattr(want.masses, f))[:, :n],
                                   atol=1e-9, rtol=1e-9, err_msg=f)

    gsim = link_scene(titan_tpu_torch, "hub", scatter="GATHER",
                      marshal=False)
    ssim = link_scene(titan_tpu_torch, "hub", scatter="SEGMENT",
                      marshal=False)
    outs = []
    for sim in (gsim, ssim):
        sim._store.damping[: sim._store.n_springs] = 0.3
        sim._T = 0.0
        sim._marshal()
        R = F.stage_remainder(sim._shape, sim._state)
        outs.append((R, fused_step.fused_chunk_plain(sim._shape, sim._state,
                                                     20)))
    (rg, og), (rs, os_) = outs
    assert torch.equal(rg["inc"], rs["inc"]) and torch.equal(rg["sign"],
                                                             rs["sign"])
    for f in ("pos", "vel", "acc"):
        assert torch.equal(getattr(og.masses, f), getattr(os_.masses, f)), f


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl
    orig_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig_call(*args, **kwargs)

    for mod in ("pallas_step", "pallas_tiled"):
        monkeypatch.setattr(f"titan_tpu.ops.{mod}.pl.pallas_call",
                            interp_call)


# (kind, integrator, friction): each integrator, the link kinds but a
# deleted endpoint (held in f64 above and by the adjoint's tests)
FUSED_CASES = [("plain", None, False), ("damped", "verlet", True),
               ("breathing", None, False), ("actuated", "rk2", False),
               ("fixed", None, True), ("hub", "rk2", True)]


@pytest.mark.parametrize("kind,integrator,friction", FUSED_CASES)
def test_fused_plain_matches_pallas_kernel(kind, integrator, friction,
                                           interpret):
    jsim = link_scene(titan_tpu, kind, integrator, friction=friction)
    assert pallas_step.pallas_reject_reason(jsim._shape) is None
    shape, state = carry_over(jsim)
    assert fused_step.fused_reject_reason(shape) is None
    assert tstep.chunk_route(shape) == ("fused", None)
    steps = 20
    out = fused_step.fused_chunk(shape, state, steps)   # CPU: plain version
    want = pallas_step.build_pallas_chunk(jsim._shape)(jsim._state,
                                                       jnp.int32(steps))
    n = jsim._store.n_masses
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out.masses, f).numpy()[:, :n],
                                   np.asarray(getattr(want.masses, f))[:, :n],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(out.springs.rest.numpy(),
                               np.asarray(want.springs.rest), atol=1e-6,
                               rtol=1e-6)
    if kind == "actuated":
        assert not torch.equal(out.springs.rest, state.springs.rest)


@pytest.mark.parametrize("kind,integrator,friction", [
    ("damped", "verlet", True), ("actuated", "rk2", False),
    ("hub", None, True)])
def test_tiled_plain_matches_pallas_tiled_glue(kind, integrator, friction,
                                               interpret):
    jsim = link_scene(titan_tpu, kind, integrator, friction=friction)
    assert pallas_tiled.tiled_reject_reason(jsim._shape) is None
    shape, state = carry_over(jsim)
    assert tiled_step.tiled_reject_reason(shape) is None
    assert tiled_step.mega_seg(shape) == 0
    steps = 20
    out = tiled_step.tiled_chunk(shape, state, steps)   # CPU: plain version
    want = pallas_tiled.build_tiled_chunk(jsim._shape)(jsim._state,
                                                       jnp.int32(steps))
    n = jsim._store.n_masses
    act = shape.has_actuated
    ptol = dict(atol=3e-5, rtol=1e-4) if act else dict(atol=5e-6, rtol=1e-5)
    vtol = dict(atol=5e-3, rtol=1e-3) if act else dict(atol=5e-6, rtol=1e-5)
    for f, tol in (("pos", ptol), ("vel", vtol)):
        np.testing.assert_allclose(getattr(out.masses, f).numpy()[:, :n],
                                   np.asarray(getattr(want.masses, f))[:, :n],
                                   err_msg=f, **tol)
    np.testing.assert_allclose(out.springs.rest.numpy(),
                               np.asarray(want.springs.rest), atol=1e-5,
                               rtol=1e-5)


def _jax_twin(port_shape):
    vals = {f.name: getattr(port_shape, f.name)
            for f in dataclasses.fields(port_shape) if f.name != "config"}
    return JaxShape(config=titan_tpu.SimConfig(), **vals)


# (nx, S): 43^3 either side of the selector budget (2,048 fits, 2,176 not:
# 16.48 / 17.51 MB of 16 MiB); 60^3 either side of the residency rule
# with the selectors inside their budget (S 384: 98.0 MB; 896: 106.4 MB);
# 100^3 with the 512 links of the stress path (33.6 MB of selectors)
ROUTE_SHAPES = [(43, 1024), (43, 2048), (43, 2176), (60, 384), (60, 896),
                (100, 512)]


@pytest.mark.parametrize("nx,s", ROUTE_SHAPES)
def test_remainder_routes_follow_jax_rules(nx, s):
    shape = _lattice_shape(nx, has_remainder=True, n_springs=s,
                           max_degree=4)
    jshape = _jax_twin(shape)
    fused = pallas_step.pallas_reject_reason(jshape) is None
    assert tstep.chunk_route(shape) == ("fused" if fused else "tiled", None)
    adj = jadj.adjoint_reject_reason(jshape) is None
    assert tdiff.grad_route(shape) == (
        "adjoint" if adj else "tiled_adjoint", None)
    fits = (nx, s) not in ((43, 2176), (100, 512))
    assert (tstep.remainder_selector_bytes(shape)
            <= tstep.REM_SEL_BUDGET) == fits
    if not fused:   # the tiled step takes per-step launches only
        assert tiled_step.mega_seg(shape) == 0
    if (nx, s) == (43, 1024):
        # the bench 43^3 + 1,024 links path: fused step and fused adjoint
        assert 41.9e6 < tstep.resident_bytes(shape) < 42.1e6
        assert 44 < adjoint_resident_bytes(shape) / 2 ** 20 < 46


def test_scene_without_stencil_families_takes_fused_step():
    """use_stencil off puts every spring in the remainder: the reference
    refuses such scenes on both kernels and runs XLA
    (``pallas_step.py:69-70``); the port keeps them on its fused kernel,
    as it does the spring-less magnet swarm (ROADMAP C3).  Its gradient
    takes fast_rollout: the adjoints want stencil families, as the
    reference's do."""
    sim = titan_tpu_torch.Simulation(titan_tpu_torch.SimConfig(
        device="cpu", use_stencil=False))
    sim.createLattice(titan_tpu_torch.Vec(0, 0, 1), titan_tpu_torch.Vec(
        1, 1, 1), 3, 3, 3)
    sim.createPlane(titan_tpu_torch.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(titan_tpu_torch.Vec(0, 0, -9.8))
    sim._T = 0.0
    sim._marshal()
    shape = sim._shape
    assert not shape.stencil_deltas and shape.has_remainder
    assert tstep.chunk_route(shape) == ("fused", None)
    assert tdiff.grad_route(shape)[0] == "fast"
    before = tstep.run_eager.steps
    out = tstep.build_chunk_fn(shape)(sim._state, 10)
    want = tstep.run_eager(tstep.build_step_fn(shape), sim._state, 10)
    assert tstep.run_eager.steps == before + 10
    np.testing.assert_allclose(out.masses.pos.numpy(),
                               want.masses.pos.numpy(), atol=1e-6)


def test_simulation_links_match_jax(dtype):  # noqa: F811
    """README's demo scene with cross links made before start, and more at
    a pause: the port re-marshals at resume and stays on its fused route
    (f32; f64 runs the eager step), as titan_tpu its XLA chunk."""
    got, want = [], []
    before = tstep.run_eager.steps
    for pkg, out in ((titan_tpu_torch, got), (titan_tpu, want)):
        sim = demo_scene(pkg, dtype)
        for a, b in ((3, 101), (17, 88), (40, 124)):
            sim.createSpring(sim.masses[a], sim.masses[b])
        sim.start()
        sim.wait(0.004)
        sim.getAll()
        out.append((sim.time(), *positions(sim)))
        assert sim._shape.has_remainder
        for a, b in ((0, 77), (60, 64), (9, 110)):
            sp = sim.createSpring(sim.masses[a], sim.masses[b])
            sp._k = 5000.0
        sim.resume()
        sim.wait(0.004)
        sim.getAll()
        out.append((sim.time(), *positions(sim)))
        if pkg is titan_tpu_torch and dtype == "float32":
            assert tstep.chunk_route(sim._shape) == ("fused", None)
            assert tstep.run_eager.steps == before
        sim.stop()
    tol = TOL[dtype]
    for g, w in zip(got, want):
        assert g[0] == pytest.approx(w[0], abs=1e-12)
        np.testing.assert_allclose(g[1], w[1], atol=tol["pos"],
                                   rtol=tol["pos"])
        np.testing.assert_allclose(g[2], w[2], atol=tol["vel"],
                                   rtol=tol["vel"])
