"""The port's tiled step (``titan_tpu_torch/ops/tiled_step.py``) against the
TPU kernel it replaces, the chunk route, and the uniform-break repair.

- ``tiled_chunk_plain`` (the plain PyTorch version of the CUDA kernels)
  against ``titan_tpu``'s XLA chunk over 30 steps, one case per variant of
  ``chip_smoke.py``'s tiled phase, at the tolerances tests/test_pallas_tiled.py
  holds the TPU kernel to against that chunk: pos 5e-6 / rtol 1e-5 and vel
  5e-6 / 1e-5, actuated pos 3e-5 / 1e-4 and vel 5e-3 / 1e-3 (the closed-form
  rest against the XLA step's per-step additions, amplified in velocity),
  actuated rest 1e-5;
- one case against ``titan_tpu.ops.pallas_tiled.build_tiled_chunk`` in
  Pallas interpret mode, one mega segment and a per-step tail;
- the plain chunk's segmentation (two mega segments and a tail) bitwise
  equal to single plain steps;
- the route on scene shapes alone;
- a ``set()`` that breaks a family's uniform k at a pause, in both
  packages.

The CUDA kernels themselves are held against ``tiled_chunk_plain`` on the
card by ``chip_smoke.py`` (this suite imports JAX, which the machine with
the card does not have).
"""

import torch_threads  # noqa: F401  (before torch)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu.ops import pallas_tiled
from titan_tpu_torch.ops import step as tstep
from titan_tpu_torch.ops import tiled_step
from titan_tpu_torch.state import SceneShape

from test_torch_step import carry_over, jax_chunk_ref

# chip_smoke.py's tiled variants, on a 10 x 6 x 6 lattice (deltas up to 43)
VARIANTS = {
    "euler": dict(),
    "clamp_off": dict(clamp=False),
    "verlet": dict(integrator="verlet"),
    "rk2": dict(integrator="rk2"),
    "damping_friction": dict(damping=0.4, friction=True),
    "actuated": dict(actuated=True),
    "breathing": dict(breathing=True),
    "drag": dict(drag=0.3),
    "ball": dict(ball=True),
    "nonuniform_k": dict(nonuniform_k=True),
    "nonuniform_rest": dict(nonuniform_rest=True),
    "deleted": dict(deleted=True),
}


def tiled_scene(pkg, integrator=None, clamp=True, damping=0.0,
                friction=False, actuated=False, breathing=False, drag=0.0,
                ball=False, nonuniform_k=False, nonuniform_rest=False,
                deleted=False, marshal=True):
    """A 10 x 6 x 6 lattice (360 masses) falling onto a plane, exercising
    the given features, built the same way in either package (the port on
    the CPU)."""
    cfg = dict(velocity_clamp=clamp)
    if integrator:
        cfg["integrator"] = pkg.Integrator(integrator)
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    # friction: the bottom layer starts inside the plane, sliding
    sim.createLattice(pkg.Vec(0, 0, 0.45 if friction else 2),
                      pkg.Vec(2, 1, 1), 10, 6, 6)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    s, n = st.n_springs, st.n_masses
    if damping:
        st.damping[:s] = damping
    if breathing:
        st.s_type[: s // 2] = pkg.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[: s // 2] = 7.0
    if actuated:
        third = s // 3
        st.s_type[:third] = pkg.ACTUATED_EXPAND
        st.l_max[:third] = st.rest[:third] * 1.2
        st.rate[:third] = 0.5
        st.s_type[third:2 * third] = pkg.ACTUATED_CONTRACT
        st.l_min[third:2 * third] = st.rest[third:2 * third] * 0.8
        st.rate[third:2 * third] = 0.5
        # a few springs start past their bound: they must never advance
        st.l_max[:8] = st.rest[:8] * 0.9
    if drag:
        st.drag[:n] = drag
    if deleted:
        st.valid[[7, 100, 211]] = False
    if nonuniform_k:
        st.k[:s] *= 1.0 + 0.1 * np.random.RandomState(1).rand(s)
    if nonuniform_rest:
        st.rest[:s] *= 1.0 + 0.01 * np.random.RandomState(0).rand(s)
    if friction:
        sim.createPlane(pkg.Vec(0, 0, 1), 0, 0.4, 0.6)
        st.vel[:n] = (0.3, 0.1, 0.0)
    else:
        sim.createPlane(pkg.Vec(0, 0, 1), 0)
    if ball:
        sim.createBall(pkg.Vec(0, 0, 1.2), 0.6)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    if marshal:
        sim._T = 0.0
        sim._marshal()
    return sim


def assert_like_jax(out, want, n, actuated):
    """The test_pallas_tiled.py tolerances (module docstring)."""
    ptol = dict(atol=3e-5, rtol=1e-4) if actuated \
        else dict(atol=5e-6, rtol=1e-5)
    vtol = dict(atol=5e-3, rtol=1e-3) if actuated \
        else dict(atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(out.masses.pos.numpy()[:, :n],
                               np.asarray(want.masses.pos)[:, :n], **ptol,
                               err_msg="pos")
    np.testing.assert_allclose(out.masses.vel.numpy()[:, :n],
                               np.asarray(want.masses.vel)[:, :n], **vtol,
                               err_msg="vel")
    np.testing.assert_allclose(out.masses.T.numpy()[:n],
                               np.asarray(want.masses.T)[:n], atol=1e-7)
    assert float(out.t) == pytest.approx(float(want.t), abs=1e-7)
    if actuated:
        np.testing.assert_allclose(out.stencil.rest.numpy(),
                                   np.asarray(want.stencil.rest),
                                   atol=1e-5, rtol=1e-5, err_msg="rest")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tiled_plain_matches_jax_chunk(variant):
    jsim = tiled_scene(titan_tpu, **VARIANTS[variant])
    assert pallas_tiled.tiled_supported(jsim._shape)
    shape, state = carry_over(jsim)
    assert tiled_step.tiled_reject_reason(shape) is None
    if variant == "nonuniform_k":
        assert not shape.stencil_uniform[0]
    elif variant == "nonuniform_rest":
        assert not shape.stencil_uniform[1]
    elif variant == "euler":
        assert shape.stencil_uniform == (True,) * 5

    out = tiled_step.tiled_chunk(shape, state, 30)    # CPU: plain version
    want = jax_chunk_ref(jsim._shape, jsim._state, 30)
    assert_like_jax(out, want, jsim._store.n_masses, shape.has_actuated)
    if shape.has_actuated:
        assert not torch.equal(out.stencil.rest, state.stencil.rest), \
            "actuation did nothing"
    # the chunk never writes into its input state
    np.testing.assert_array_equal(state.masses.pos.numpy(),
                                  np.asarray(jsim._state.masses.pos))


def test_tiled_plain_matches_pallas_tiled_interpret(monkeypatch):
    """One mega segment and a 4-step tail of the TPU kernel itself, in
    interpret mode (as tests/test_smoke_kernels.py runs it)."""
    from conftest import force_tiled_interpret
    jsim = tiled_scene(titan_tpu, breathing=True, damping=0.4)
    force_tiled_interpret(monkeypatch)
    steps = tiled_step.MEGA_SEG + 4
    want = pallas_tiled.build_tiled_chunk(jsim._shape)(jsim._state,
                                                       jnp.int32(steps))
    shape, state = carry_over(jsim)
    out = tiled_step.tiled_chunk(shape, state, steps)
    assert_like_jax(out, want, jsim._store.n_masses, False)


def test_plain_chunk_segments_are_single_steps():
    """37 steps = two mega segments and a tail of 5, bitwise the 37 single
    plain steps at their indices: the segmentation moves neither t nor the
    closed-form actuation count."""
    for kw in (dict(actuated=True, breathing=True, damping=0.4),
               dict(integrator="rk2", actuated=True)):
        shape, state = carry_over(tiled_scene(titan_tpu, **kw))
        assert tiled_step.mega_seg(shape) == 16
        out = tiled_step.tiled_chunk_plain(shape, state, 37)
        inv = tiled_step.prep_tiled_inputs(shape, state)
        m = state.masses
        pos, vel, acc = m.pos, m.vel, m.acc
        for i in range(37):
            pos, vel, acc = tiled_step.tiled_step_plain(shape, inv, pos, vel,
                                                        acc, i)
        want = tiled_step.finish_tiled_chunk(shape, state, inv, 37, pos, vel,
                                             acc)
        for f in ("pos", "vel", "acc", "T"):
            assert torch.equal(getattr(out.masses, f),
                               getattr(want.masses, f)), f
        assert torch.equal(out.stencil.rest, want.stencil.rest)


def _lattice_shape(nx, **flags):
    """The port's SceneShape of an nx^3 lattice on a plane, from the shape
    alone (no arrays): N padded to 128, the 13 lattice families."""
    d = [1, nx, nx * nx, nx - 1, nx * nx - 1, nx * nx - nx, nx * nx + 1,
         nx + 1, nx * nx + nx, -(nx * nx - nx + 1), nx * nx - nx - 1,
         nx * nx + nx - 1, nx * nx + nx + 1]
    cfg = titan_tpu_torch.SimConfig(device="cpu")
    base = dict(
        n_masses=-(-nx ** 3 // 128) * 128, n_springs=128, max_degree=0,
        stencil_deltas=tuple(d), has_remainder=False, n_planes=1,
        n_balls=0, plane_friction=(False,), cap_cp=0, cap_ball=0, cap_pl=0,
        cap_dir=0, has_magnets=False, has_drag=False, has_breathing=False,
        has_actuated=False, has_damping=False, all_valid=True, config=cfg,
        stencil_uniform=(True,) * 5)
    base.update(flags)
    return SceneShape(**base)


def test_chunk_route_on_shapes(caplog):
    assert tstep.chunk_route(_lattice_shape(100)) == ("tiled", None)
    assert tstep.chunk_route(_lattice_shape(43))[0] == "fused"
    assert tstep.chunk_route(_lattice_shape(20))[0] == "fused"
    # a magnet lattice past magnet_pallas_max: the tiled step with its
    # per-pass field glue, as on a TPU
    assert tstep.chunk_route(_lattice_shape(100, has_magnets=True)) \
        == ("tiled", None)
    rk2 = _lattice_shape(100, config=titan_tpu_torch.SimConfig(
        device="cpu", integrator=titan_tpu_torch.Integrator.RK2))
    assert tstep.chunk_route(rk2)[0] == "tiled"
    # local constraints run in both step kernels: by the residency rule,
    # whose slot rows count, as on a TPU
    local = _lattice_shape(100, cap_cp=1)
    assert tstep.chunk_route(local) == ("tiled", None)
    assert tstep.chunk_route(_lattice_shape(43, cap_cp=1)) == ("fused", None)
    # a scene neither kernel takes (f64) falls back to the eager loop, with
    # a warning naming both reasons
    f64 = _lattice_shape(100, has_remainder=True,
                         config=titan_tpu_torch.SimConfig(device="cpu",
                                                          dtype="float64"))
    route, reason = tstep.chunk_route(f64)
    assert route == "eager"
    assert "f32-only" in reason and "tiled step" in reason
    with caplog.at_level("WARNING", logger="titan_tpu_torch"):
        tstep.build_chunk_fn(f64)
    assert "eager" in caplog.text and "tiled step" in caplog.text


def test_uniform_break_demotes_family_field():
    """A ``set()`` of one spring's k (x10) at a pause breaks its family's
    uniform k: both packages clear the flag, and the plain tiled chunk then
    follows the new k as JAX's XLA chunk does.  With the flag left set it
    would go on reading the family's old scalar: the spring taken is the
    most strained one of the contact scene, where that is a 0.6 m/s error
    in 30 steps."""
    sims = []
    for pkg in (titan_tpu, titan_tpu_torch):
        sim = tiled_scene(pkg, friction=True, marshal=False)
        sim.start()
        sim.wait(0.002)
        sim.getAll()
        assert sim._shape.stencil_uniform[0]
        sims.append(sim)
    jsim, tsim = sims
    st = jsim._store
    s = st.n_springs
    ln = np.linalg.norm(st.pos[st.right[:s]] - st.pos[st.left[:s]], axis=1)
    j = int(np.argmax(np.abs(st.rest[:s] - ln)))
    for sim in sims:
        sp = sim.springs[j]
        sp._k = 10 * sp._k
        sim.set(sp)
        assert not sim._shape.stencil_uniform[0]
        assert sim._shape.stencil_uniform[1:] == (True,) * 4
    shape = tsim._shape
    assert tiled_step._plan(shape) == ("k",)
    fi, slot = int(tsim._sp_family[j]), int(tsim._sp_slot[j])
    assert float(tsim._state.stencil.k[fi, slot]) == 8000.0
    # the port's shape on JAX's paused state: the same numbers in both
    _, state = carry_over(jsim)
    assert torch.equal(state.stencil.k, tsim._state.stencil.k)
    out = tiled_step.tiled_chunk(shape, state, 30)
    want = jax_chunk_ref(jsim._shape, jsim._state, 30)
    assert_like_jax(out, want, st.n_masses, False)
    for sim in sims:
        sim.stop()
