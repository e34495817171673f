"""The port's adjoints on scenes with per-mass local constraints.

- ``backward_step`` is the VJP of ``forward_step`` (``torch.func.vjp``) on
  a marshalled 4^3 scene with every slot type (contact planes with and
  without friction, a ball, constraint planes, directions) and drag, under
  Euler with the clamp, Verlet and RK2, in f64 at 1e-9: its state and the
  fused step's own staging (``adjoint._prep``), cast to f64;
- ``adjoint_rollout`` gradients (20 steps in segments of 10) against
  ``jax.grad`` through the JAX package's XLA rollout on tests/
  test_adjoint.py's ``local_mix``, ``local_drag``, ``local_verlet`` and
  ``local_rk2`` scenes at that file's normalised atol 5e-4
  (``test_torch_diff.py::check_adjoint_scene``);
- ``tiled_adjoint_rollout`` (``tiled_trace_run_plain`` and
  ``tiled_bwd_run_plain``) against ``jax.grad`` through the XLA rollout,
  the reference tests/test_adjoint_tiled.py holds the JAX tiled adjoint to,
  on its ``local_dir`` scene (4 steps in segments of 2) at that file's
  normalised atol 2e-4.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
from titan_tpu import diff as jdiff
from titan_tpu.state import xla_only_shape
from titan_tpu_torch.ops import adjoint as tadj
from titan_tpu_torch.ops import adjoint_tiled

import test_adjoint_tiled
from test_torch_diff import check_adjoint_scene
from test_torch_local import add_local
from test_torch_step import build_scene, carry_over, jax_grad_ref


def _f64(v):
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v.double()
    if isinstance(v, list):
        return [_f64(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_f64(x) for x in v)
    return v


@pytest.mark.parametrize("integrator", ["plain", "verlet", "rk2"])
def test_backward_step_is_vjp_of_forward_step_on_scene(integrator):
    jsim = build_scene(titan_tpu, integrator, marshal=False)
    add_local(jsim, titan_tpu, ("cp", "ball", "pl", "dir"))
    jsim._store.drag[: jsim._store.n_masses] = 0.3
    jsim._T = 0.0
    jsim._marshal()
    shape, state = carry_over(jsim)
    assert tadj.adjoint_supported(shape)
    P = {k: _f64(v) for k, v in tadj._prep(shape, state).items()}
    assert P["lc"] is not None and P["caps"] == (1, 1, 1, 1)
    m = state.masses
    pos, vel, acc = (t.double() for t in (m.pos, m.vel, m.acc))
    # moving masses, so that constraint planes and directions act
    vel = vel + torch.tensor([0.3, 0.1, -0.2], dtype=torch.float64)[:, None]
    rng = np.random.RandomState(5)
    gp2, gv2, ga2 = (torch.from_numpy(rng.normal(0, 1, pos.shape))
                     for _ in range(3))
    rg, rs = tadj.torch_rolls()
    t_now = torch.tensor(0.37, dtype=torch.float64)
    diffable = ["k", "rest", "cf", "minv", "drag"]

    def fwd(pos, vel, acc, params):
        return tadj.forward_step(pos, vel, acc, {**P, **params}, rg, rs,
                                 t_now, s_idx=3.0)

    _, vjp = torch.func.vjp(fwd, pos, vel, acc, {k: P[k] for k in diffable})
    gpos_v, gvel_v, gacc_v, gpar_v = vjp((gp2, gv2, ga2))
    gpos, gvel, gacc, bars = tadj.backward_step(pos, vel, gp2, gv2, ga2, P,
                                                rg, rs, t_now, s_idx=3.0)
    tol = dict(rtol=1e-9, atol=1e-9)
    for name, a, b in (("gpos", gpos, gpos_v), ("gvel", gvel, gvel_v),
                       ("gacc_prev", gacc, gacc_v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **tol)
    for name in diffable:
        got = bars[name]
        got = torch.stack(got) if isinstance(got, list) else got
        np.testing.assert_allclose(got.numpy(), gpar_v[name].numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("scene_name", ["local_mix", "local_drag",
                                        "local_verlet", "local_rk2"])
def test_adjoint_rollout_local_grads_match_jax(scene_name):
    check_adjoint_scene(scene_name)


def test_tiled_adjoint_local_grads_match_jax():
    sim = test_adjoint_tiled._scene(**test_adjoint_tiled.VARIANTS["local_dir"])
    jshape, jstate = sim._shape, sim._state
    n = sim._store.n_masses
    rng = np.random.RandomState(0)
    npad = jstate.masses.pos.shape[1]
    wpos = rng.normal(0, 1, (3, npad)).astype(np.float32)
    wvel = rng.normal(0, 1, (3, npad)).astype(np.float32)
    wpos[:, n:] = 0.0
    wvel[:, n:] = 0.0
    steps = 4

    def with4(state, pos, vel, k, rest):
        return dataclasses.replace(
            state,
            masses=dataclasses.replace(state.masses, pos=pos, vel=vel),
            stencil=dataclasses.replace(state.stencil, k=k, rest=rest))

    def jloss(pos, vel, k, rest):
        out = jdiff.rollout(xla_only_shape(jshape),
                            with4(jstate, pos, vel, k, rest), steps)
        return jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)

    m, stc = jstate.masses, jstate.stencil
    want = jax_grad_ref(jloss, (0, 1, 2, 3), (m.pos, m.vel, stc.k, stc.rest))

    shape, state = carry_over(sim)
    assert shape.cap_dir == 1
    assert adjoint_tiled.tiled_adjoint_reject_reason(shape) is None
    args = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel, state.stencil.k,
        state.stencil.rest)]
    out = adjoint_tiled.tiled_adjoint_rollout(shape, with4(state, *args),
                                              steps, segment=2)
    loss = (torch.sum(out.masses.pos * torch.from_numpy(wpos))
            + torch.sum(out.masses.vel * torch.from_numpy(wvel)))
    got = torch.autograd.grad(loss, args)
    for name, a, x in zip(("pos", "vel", "k", "rest"), got, want):
        a, x = a.numpy(), np.asarray(x)
        assert np.isfinite(a).all(), f"grad[{name}] not finite"
        scale = max(np.abs(x).max(), 1e-8)
        err = float((np.abs(a - x) / scale).max())
        assert err < 2e-4, (name, err)
