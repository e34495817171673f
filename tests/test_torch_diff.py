"""The port's differentiable rollouts (``titan_tpu_torch/diff.py``) against
the JAX package's.

- ``adjoint_rollout`` gradients on the CPU (forward ``fused_chunk_plain``,
  backward ``trace_run_plain`` + ``bwd_run_plain``, 20 steps in segments
  of 10) against ``jax.grad`` through ``titan_tpu.diff.rollout`` (the JAX
  package's XLA step, the reference tests/test_adjoint.py holds its own
  adjoint to), on the scenes of that file inside the port's envelope, for
  the nine gradient arguments at that file's normalised atol 5e-4;
- ``rollout`` gradients (autograd through the eager step) against
  ``jax.grad`` through ``titan_tpu.diff.rollout`` in f64 to 1e-9;
- ``grad_rollout``'s routing (a 100^3-shaped scene to the tiled adjoint),
  and ``fast_rollout`` / ``trajectory``.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
from titan_tpu import diff as jdiff
from titan_tpu.state import xla_only_shape
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import fused_step

from test_adjoint import SCENES, _scene
from test_torch_step import build_scene, carry_over, jax_grad_ref
from test_torch_tiled import _lattice_shape

# The scenes of test_adjoint.py inside the port's envelope (the local
# ones are in test_torch_adjoint_local.py).  A case's JAX reference
# (tracing and compiling the gradient of a 20-step scan, without XLA's
# optimisation passes: jax_grad_ref) takes ~3-7 s here, so they are spread
# over this file, test_torch_diff_scenes.py and
# test_torch_diff_integrators.py, which pytest-xdist runs side by side.
ADJ_SCENES = ["friction_damping", "clamp", "drag_ball", "beam_fixed",
              "deleted_extern", "breathing", "verlet", "rk2", "actuated",
              "rk2_actuated"]
GRAD_ARGS = ["pos", "vel", "k", "rest", "m", "extern", "g", "omega", "rate"]


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _jax_state(state, args):
    pos, vel, k, rest, m, extern, g, omega, rate = args
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel, m=m,
                                   extern_force=extern),
        stencil=dataclasses.replace(state.stencil, k=k, rest=rest,
                                    omega=omega, rate=rate),
        g=g)


def _port_args(state):
    """The nine gradient arguments of a port state, as fresh leaves that
    require grad, and the state built on them."""
    args = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel, state.stencil.k,
        state.stencil.rest, state.masses.m, state.masses.extern_force,
        state.g, state.stencil.omega, state.stencil.rate)]
    pos, vel, k, rest, m, extern, g, omega, rate = args
    st = dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel, m=m,
                                   extern_force=extern),
        stencil=dataclasses.replace(state.stencil, k=k, rest=rest,
                                    omega=omega, rate=rate),
        g=g)
    return args, st


def _weights(jstate, n):
    """The loss weights of test_adjoint.py (seed 3): pos and vel of the
    real masses, and the stencil rest."""
    rng = np.random.RandomState(3)
    cols = jstate.masses.pos.shape[1]
    wpos = rng.normal(0, 1, (3, cols)).astype(np.float32)
    wvel = rng.normal(0, 1, (3, cols)).astype(np.float32)
    wpos[:, n:] = 0.0
    wvel[:, n:] = 0.0
    wrest = (rng.normal(0, 1, jstate.stencil.rest.shape).astype(np.float32)
             * np.asarray(jstate.stencil.mask))
    return wpos, wvel, wrest


@pytest.mark.parametrize("scene_name", ADJ_SCENES[:3])
def test_adjoint_rollout_grads_match_jax_adjoint(scene_name):
    check_adjoint_scene(scene_name)


def check_adjoint_scene(scene_name):
    """The port's adjoint_rollout gradients against jax.grad through the
    JAX package's XLA rollout, on one scene of test_adjoint.py: the
    reference test_adjoint.py holds the JAX adjoint to, at the same
    tolerance."""
    jsim = _scene(**SCENES[scene_name])
    jshape, jstate = jsim._shape, jsim._state
    n = jsim._store.n_masses
    wpos, wvel, wrest = _weights(jstate, n)
    actuated = jshape.has_actuated

    def jloss(*args):
        out = jdiff.rollout(xla_only_shape(jshape), _jax_state(jstate, args),
                            20)
        loss = jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)
        if actuated:
            loss = loss + jnp.sum(out.stencil.rest * wrest)
        return loss

    jargs = (jstate.masses.pos, jstate.masses.vel, jstate.stencil.k,
             jstate.stencil.rest, jstate.masses.m,
             jstate.masses.extern_force, jstate.g, jstate.stencil.omega,
             jstate.stencil.rate)
    want = jax_grad_ref(jloss, tuple(range(9)), jargs)

    shape, state = carry_over(jsim)
    assert tdiff.adjoint_supported(shape)
    args, st = _port_args(state)
    out = tdiff.adjoint_rollout(shape, st, 20, segment=10)
    loss = (torch.sum(out.masses.pos * torch.from_numpy(wpos))
            + torch.sum(out.masses.vel * torch.from_numpy(wvel)))
    if actuated:
        loss = loss + torch.sum(out.stencil.rest * torch.from_numpy(wrest))
    got = torch.autograd.grad(loss, args, allow_unused=True)

    msk = np.asarray(jstate.stencil.mask)
    for name, a, x in zip(GRAD_ARGS, got, want):
        x = np.asarray(x)
        a = np.zeros_like(x) if a is None else a.numpy()
        if name in ("pos", "vel", "extern"):
            a, x = a[:, :n], x[:, :n]
        elif name == "m":
            a, x = a[:n], x[:n]
        elif name in ("k", "rest", "omega", "rate"):
            a, x = a * msk, x * msk
        assert np.isfinite(a).all(), f"grad[{name}] not finite"
        scale = max(np.abs(x).max(), 1e-8)
        np.testing.assert_allclose(a / scale, x / scale, atol=5e-4,
                                   err_msg=f"grad[{name}] mismatch")


def test_adjoint_rollout_forward_is_fused_chunk():
    shape, state = carry_over(build_scene(titan_tpu, "friction"))
    out = tdiff.adjoint_rollout(shape, state, 20, segment=10)
    want = fused_step.fused_chunk(shape, state, 20)
    for f in ("pos", "vel", "acc", "T"):
        np.testing.assert_array_equal(getattr(out.masses, f).numpy(),
                                      getattr(want.masses, f).numpy(), f)
    assert float(out.t) == float(want.t)


def _f64_scene(variant):
    jsim = build_scene(titan_tpu, variant, "float64")
    st = jsim._store
    st.rest[: st.n_springs] *= 1.03      # pre-stress: real k / rest grads
    jsim._marshal()
    return jsim


@pytest.mark.parametrize("variant,ckpt", [("friction", None), ("rk2", 5)])
def test_rollout_grads_match_jax_rollout_f64(variant, ckpt, x64):
    jsim = _f64_scene(variant)
    jshape, jstate = jsim._shape, jsim._state
    n = jsim._store.n_masses
    wpos, wvel, _ = _weights(jstate, n)
    steps = 10

    def jloss(*args):
        out = jdiff.rollout(xla_only_shape(jshape), _jax_state(jstate, args),
                            steps)
        return jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)

    jargs = (jstate.masses.pos, jstate.masses.vel, jstate.stencil.k,
             jstate.stencil.rest, jstate.masses.m,
             jstate.masses.extern_force, jstate.g, jstate.stencil.omega,
             jstate.stencil.rate)
    want = jax_grad_ref(jloss, tuple(range(9)), jargs)

    shape, state = carry_over(jsim)
    args, st = _port_args(state)
    out = tdiff.rollout(shape, st, steps, checkpoint_every=ckpt)
    loss = (torch.sum(out.masses.pos * torch.from_numpy(wpos).double())
            + torch.sum(out.masses.vel * torch.from_numpy(wvel).double()))
    got = torch.autograd.grad(loss, args, allow_unused=True)
    for name, a, x in zip(GRAD_ARGS, got, want):
        x = np.asarray(x)
        a = np.zeros_like(x) if a is None else a.numpy()
        np.testing.assert_allclose(a, x, rtol=1e-9, atol=1e-9,
                                   err_msg=f"grad[{name}]")


def test_fast_rollout_grads_equal_rollout_f64(x64):
    """fast_rollout (chunk forward, eager recompute backward) gives the
    gradients of rollout; an f64 scene runs its chunks through the eager
    step too."""
    shape, state = carry_over(_f64_scene("damping"))
    grads = []
    for fn in (lambda s: tdiff.rollout(shape, s, 12),
               lambda s: tdiff.fast_rollout(shape, s, 12, segment=4)):
        args, st = _port_args(state)
        out = fn(st)
        loss = torch.sum(out.masses.pos ** 2) + torch.sum(out.masses.vel)
        grads.append(torch.autograd.grad(loss, args, allow_unused=True))
    for name, a, b in zip(GRAD_ARGS, *grads):
        if b is None:
            assert a is None or not bool(a.any()), name
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_trajectories():
    shape, state = carry_over(build_scene(titan_tpu, "plain"))
    final, traj = tdiff.trajectory(shape, state, 6, every=2)
    ffinal, ftraj = tdiff.fast_trajectory(shape, state, 6, every=2)
    assert traj.shape == ftraj.shape == (3, 3, shape.n_masses)
    want = fused_step.fused_chunk(shape, state, 6)
    np.testing.assert_array_equal(ffinal.masses.pos.numpy(),
                                  want.masses.pos.numpy())
    np.testing.assert_allclose(final.masses.pos.numpy(),
                               want.masses.pos.numpy(), atol=1e-6)
    np.testing.assert_array_equal(ftraj[-1].numpy(), ffinal.masses.pos.numpy())
    with pytest.raises(ValueError, match="divisible"):
        tdiff.trajectory(shape, state, 5, every=2)


def test_grad_rollout_routing(monkeypatch, caplog, x64):
    calls = []
    for name in ("adjoint_rollout", "fast_rollout"):
        orig = getattr(tdiff, name)
        monkeypatch.setattr(tdiff, name, lambda *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(*a, **k))

    shape, state = carry_over(build_scene(titan_tpu, "plain"))
    out = tdiff.grad_rollout(shape, state, 4)
    assert calls == ["adjoint_rollout"]
    assert float(out.t) == pytest.approx(4e-4)

    calls.clear()
    shape, state = carry_over(build_scene(titan_tpu, "plain", "float64"))
    with caplog.at_level("WARNING", logger="titan_tpu_torch"):
        tdiff.grad_rollout(shape, state, 4)
    assert calls == ["fast_rollout"]
    assert "f32-only" in caplog.text and "fast_rollout" in caplog.text

    # a 100^3-shaped scene is past the fused adjoint's residency rule: the
    # tiled adjoint, as the JAX package routes it (titan_tpu/diff.py:154-160)
    calls.clear()
    monkeypatch.setattr(tdiff, "tiled_adjoint_rollout",
                        lambda sh, st, n, segment=None:
                        calls.append("tiled_adjoint_rollout") or st)
    sentinel = object()
    assert tdiff.grad_rollout(_lattice_shape(100), sentinel, 200) is sentinel
    assert calls == ["tiled_adjoint_rollout"]
    assert tdiff.grad_route(_lattice_shape(43)) == ("adjoint", None)

    with pytest.raises(NotImplementedError, match="A9"):
        tdiff.grad_rollout(shape, state, 4, mesh=object())


def test_adjoint_rollout_rejects(x64):
    shape, state = carry_over(build_scene(titan_tpu, "plain", "float64"))
    with pytest.raises(ValueError, match="envelope"):
        tdiff.adjoint_rollout(shape, state, 4)
    shape, state = carry_over(build_scene(titan_tpu, "plain"))
    with pytest.raises(ValueError, match="divide"):
        tdiff.adjoint_rollout(shape, state, 10, segment=3)
