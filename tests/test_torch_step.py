"""The port's eager step against titan_tpu's XLA step, on identical state.

Each scene is built and marshalled by titan_tpu; its state crosses into the
port through ``titan_tpu_torch.state.state_from_numpy`` so that both packages
step exactly the same numbers.  f64 (x64 on, as in test_parity.py) must agree
to 1e-9 (the same math, differently ordered sums); f32 to 1e-5.  One scene
also runs against the independent numpy oracle ``reference_impl``.

``build_scene`` is shared with the other ``test_torch_*`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu.ops.step import build_chunk_fn as jax_chunk_fn
from titan_tpu.state import state_to_numpy
from titan_tpu_torch.ops import step as tstep
from titan_tpu_torch.state import shape_from_fields, state_from_numpy

import reference_impl as ref

VARIANTS = ["plain", "friction", "ball", "beam", "damping", "breathing",
            "actuated", "drag", "deleted", "verlet", "rk2", "remainder"]


def build_scene(pkg, variant="plain", dtype="float32", n=4, marshal=True):
    """A small lattice scene exercising one feature, built the same way in
    either package (``titan_tpu`` or ``titan_tpu_torch``, whose port is
    asked for the CPU)."""
    cfg = dict(dtype=dtype, velocity_clamp=variant != "clamp_off")
    if variant == "verlet":
        cfg["integrator"] = pkg.Integrator.VERLET
    elif variant.startswith("rk2"):
        cfg["integrator"] = pkg.Integrator.RK2
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    # friction: start the lattice inside the plane, sliding, so that the
    # contact and both friction branches run
    center = pkg.Vec(0, 0, 0.3 if variant == "friction" else 2)
    if variant == "beam":
        sim.createBeam(center, pkg.Vec(1, 1, 1), n, n, n)
    else:
        sim.createLattice(center, pkg.Vec(1, 1, 1), n, n, n)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    s, nm = st.n_springs, st.n_masses
    if variant == "damping":
        st.damping[:s] = 0.5
    if variant == "breathing":
        st.s_type[: s // 2] = pkg.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[: s // 2] = 7.0
    if variant.endswith("actuated"):
        third = s // 3
        st.s_type[:third] = pkg.ACTUATED_EXPAND
        st.l_max[:third] = st.rest[:third] * 1.2
        st.rate[:third] = 0.5
        st.s_type[third:2 * third] = pkg.ACTUATED_CONTRACT
        st.l_min[third:2 * third] = st.rest[third:2 * third] * 0.8
        st.rate[third:2 * third] = 0.5
    if variant == "drag":
        st.drag[:nm] = 0.3
    if variant == "deleted":
        st.valid[3] = False
        st.valid[17] = False
    if variant == "remainder":
        # index offsets 23, 29, 31 are no lattice family: remainder springs
        for base, d in ((10, 23), (2, 29), (17, 31)):
            sp = sim.createSpring(sim.masses[base], sim.masses[base + d])
            sp._k = 600.0
    if variant == "friction":
        sim.createPlane(pkg.Vec(0, 0, 1), 0, 0.4, 0.6)
        st.vel[:nm] = (0.3, 0.1, 0.0)
        sim.setGlobalAcceleration(pkg.Vec(0.5, 0, -9.8))
    else:
        sim.createPlane(pkg.Vec(0, 0, 1), 0)
        sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    if variant == "ball":
        sim.createBall(pkg.Vec(0, 0, 1.0), 0.6)
    sim.setTimeStep(0.0001)
    if marshal:
        sim._T = 0.0
        sim._marshal()
    return sim


def carry_over(jsim):
    """(port shape, port state) on the CPU from a marshalled titan_tpu sim."""
    return (shape_from_fields(jsim._shape, "cpu"),
            state_from_numpy(state_to_numpy(jsim._state), "cpu"))


def assert_states_close(port, jax_state, n, atol, rtol=0.0, rest_atol=None,
                        fields=("pos", "vel", "acc")):
    got, want = port.masses, jax_state.masses
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy()[:, :n],
                                   np.asarray(getattr(want, f))[:, :n],
                                   atol=atol, rtol=rtol, err_msg=f)
    np.testing.assert_allclose(got.T.numpy()[:n], np.asarray(want.T)[:n],
                               atol=atol)
    np.testing.assert_allclose(float(port.t), float(jax_state.t), atol=atol)
    ra = atol if rest_atol is None else rest_atol
    np.testing.assert_allclose(port.stencil.rest.numpy(),
                               np.asarray(jax_state.stencil.rest),
                               atol=ra, rtol=rtol)
    np.testing.assert_allclose(port.springs.rest.numpy(),
                               np.asarray(jax_state.springs.rest),
                               atol=ra, rtol=rtol)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _run_both(variant, dtype, steps):
    jsim = build_scene(titan_tpu, variant, dtype)
    shape, state = carry_over(jsim)
    out = tstep.run_eager(tstep.build_step_fn(shape), state, steps)
    want = jax_chunk_fn(jsim._shape)(jsim._state, jnp.int32(steps))
    return jsim, state, out, want


@pytest.mark.parametrize("variant", VARIANTS)
def test_eager_step_matches_jax_f64(variant, x64):
    jsim, state, out, want = _run_both(variant, "float64", 30)
    assert out.masses.pos.dtype == torch.float64
    assert_states_close(out, want, jsim._store.n_masses, atol=1e-9)
    if variant == "actuated":
        assert not torch.equal(out.stencil.rest, state.stencil.rest)
    if variant == "remainder":
        assert jsim._shape.has_remainder


@pytest.mark.parametrize("variant", VARIANTS)
def test_eager_step_matches_jax_f32(variant):
    jsim, _, out, want = _run_both(variant, "float32", 30)
    assert out.masses.pos.dtype == torch.float32
    # acc is left out in f32: it is a sum of nearly cancelling spring
    # forces over a small mass, so one f32 ulp of a spring length (3e-8 at
    # rest 0.33) moves it by ~2.4e-4 here -- summation order alone does
    # that; pos/vel/T (and acc in f64 above) pin the physics
    assert_states_close(out, want, jsim._store.n_masses, atol=1e-5,
                        rtol=1e-5, rest_atol=1e-6, fields=("pos", "vel"))


def test_eager_step_matches_numpy_oracle(x64):
    """The port alone against the entity-at-a-time numpy transcription of
    the reference kernels (f64, 1e-9, as tests/test_parity.py)."""
    jsim = build_scene(titan_tpu, "damping", "float64", n=3)
    scene = ref.from_simulation(jsim)
    shape, state = carry_over(jsim)
    step = tstep.build_step_fn(shape)
    t = 0.0
    for _ in range(40):
        ref.step(scene, 1e-4, t)
        t += 1e-4
        state = step(state)
    n = jsim._store.n_masses
    np.testing.assert_allclose(state.masses.pos.numpy()[:, :n].T, scene.pos,
                               atol=1e-9)
    np.testing.assert_allclose(state.masses.vel.numpy()[:, :n].T, scene.vel,
                               atol=1e-9)


def test_chunk_dispatch(caplog):
    """Lattice scenes take the fused chunk; a scene outside its envelope
    takes the eager loop, with a warning naming the reason."""
    shape, state = carry_over(build_scene(titan_tpu, "plain"))
    before = tstep.run_eager.steps
    tstep.build_chunk_fn(shape)(state, 3)
    assert tstep.run_eager.steps == before

    shape, state = carry_over(build_scene(titan_tpu, "remainder"))
    with caplog.at_level("WARNING", logger="titan_tpu_torch"):
        out = tstep.build_chunk_fn(shape)(state, 3)
    assert tstep.run_eager.steps == before + 3
    assert "remainder" in caplog.text
    assert float(out.t) == pytest.approx(3e-4)
