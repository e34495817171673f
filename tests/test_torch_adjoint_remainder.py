"""The port's adjoints on scenes with remainder springs (springs in no
stencil family), with their per-spring gradients.

- ``adjoint_rollout`` (the fused adjoint's plain versions on the CPU) and
  ``tiled_adjoint_rollout`` against ``jax.grad`` through the JAX package's
  XLA rollout, 20 steps in segments of 10, on tests/test_adjoint.py's
  cross-link scenes (``_scene``: damped ACTUATED links with a deleted
  endpoint on the fused adjoint, damped breathing links under Verlet on
  the tiled one; RK2 is held through ``backward_step`` here and in
  tests/test_torch_adjoint.py), over pos, vel and the remainder
  springs' k, rest, damping, omega and rate (the rest output in the loss
  where the links are ACTUATED), at that file's normalised atol 5e-4; the
  k, damping and rate of an invalid spring are 0 in both (``rem_ok``);
- ``backward_step`` is the VJP of ``forward_step`` (``torch.func.vjp``)
  for the remainder springs' rows and rest, on a marshalled 5^3 scene with
  damped, breathing or ACTUATED cross links in f64 at 1e-9;
- the fused and tiled traces replay their chunks bitwise with ACTUATED
  links, and ``grad_rollout`` routes a remainder scene to the fused
  adjoint.
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
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import adjoint as tadj
from titan_tpu_torch.ops import adjoint_tiled, fused_step, tiled_step

import test_adjoint
from test_torch_remainder import link_scene
from test_torch_step import carry_over, jax_grad_ref

SPRING_ARGS = ("k", "rest", "damping", "omega", "rate")


def _with(state, args, springs_of):
    pos, vel, *sp = args
    return dataclasses.replace(
        state, masses=dataclasses.replace(state.masses, pos=pos, vel=vel),
        springs=dataclasses.replace(springs_of(state),
                                    **dict(zip(SPRING_ARGS, sp))))


# tests/test_adjoint.py's cross-link scenes, two REM_SCENES in one each:
# cross_actuated with cross_deleted's deleted endpoint on the fused
# adjoint, cross_verlet with cross_breathing's links on the tiled one
SCENES = {"fused": dict(cross=True, cross_actuated=True, damping=0.2,
                        deleted=True, friction=True),
          "tiled": dict(cross=True, cross_breathing=True, damping=0.2,
                        integrator="verlet", friction=True)}


@pytest.mark.parametrize("route", ["fused", "tiled"])
def test_remainder_grads_match_jax(route):
    sim = test_adjoint._scene(**SCENES[route])
    jshape, jstate = sim._shape, sim._state
    n = sim._store.n_masses
    rng = np.random.RandomState(5)
    npad = jstate.masses.pos.shape[1]
    wpos, wvel = (rng.normal(0, 1, (3, npad)).astype(np.float32)
                  for _ in range(2))
    wpos[:, n:] = 0.0
    wvel[:, n:] = 0.0
    wrest = rng.normal(0, 1, jstate.springs.rest.shape).astype(np.float32)
    act = jshape.has_actuated
    steps = 20

    def jloss(*args):
        out = jdiff.rollout(xla_only_shape(jshape),
                            _with(jstate, args, lambda s: s.springs), steps)
        loss = jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)
        if act:
            loss = loss + jnp.sum(out.springs.rest * wrest)
        return loss

    sp = jstate.springs
    jargs = (jstate.masses.pos, jstate.masses.vel) + tuple(
        getattr(sp, k) for k in SPRING_ARGS)
    want = jax_grad_ref(jloss, tuple(range(len(jargs))), jargs)

    shape, state = carry_over(sim)
    assert shape.has_remainder
    args = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel) + tuple(
        getattr(state.springs, k) for k in SPRING_ARGS)]
    st = _with(state, args, lambda s: s.springs)
    if route == "fused":
        assert tdiff.grad_route(shape) == ("adjoint", None)
        out = tdiff.adjoint_rollout(shape, st, steps, segment=10)
    else:
        assert adjoint_tiled.tiled_adjoint_reject_reason(shape) is None
        assert not adjoint_tiled.mega_adjoint_ok(shape)
        out = adjoint_tiled.tiled_adjoint_rollout(shape, st, steps,
                                                  segment=10)
    loss = (torch.sum(out.masses.pos * torch.from_numpy(wpos))
            + torch.sum(out.masses.vel * torch.from_numpy(wvel)))
    if act:
        loss = loss + torch.sum(out.springs.rest * torch.from_numpy(wrest))
    got = torch.autograd.grad(loss, args, allow_unused=True)

    rem_ok = np.asarray(sp.valid & jstate.masses.valid[sp.left]
                        & jstate.masses.valid[sp.right])
    checked = {"pos", "vel", "k", "rest"}
    checked |= {"damping"} if shape.has_damping else set()
    checked |= {"omega"} if route == "tiled" else set()
    checked |= {"rate"} if act else set()
    for name, a, x in zip(("pos", "vel") + SPRING_ARGS, got, want):
        if name not in checked:
            continue
        x = np.asarray(x)
        a = a.numpy()
        if name in ("pos", "vel"):
            a, x = a[:, :n], x[:, :n]
        elif name in ("k", "damping", "rate"):
            x = x * rem_ok
            assert not np.any(a[~rem_ok]), name
        assert np.isfinite(a).all(), f"grad[{name}] not finite"
        scale = np.abs(x).max()
        assert scale > 0, name
        np.testing.assert_allclose(a / scale, x / scale, atol=5e-4,
                                   err_msg=f"grad[{name}] mismatch")


@pytest.mark.parametrize("kind,integrator", [
    ("damped", "rk2"), ("breathing", None), ("actuated", "verlet")])
def test_backward_step_is_vjp_on_link_scene(kind, integrator):
    jsim = link_scene(titan_tpu, kind, integrator, friction=True)
    shape, state = carry_over(jsim)
    P = tadj._prep(shape, state)

    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) \
            and v.is_floating_point() else v

    P = {k: ({kk: f64(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else tuple(f64(c) for c in v) if isinstance(v, tuple)
             else [tuple(f64(c) for c in x) for x in v]
             if isinstance(v, list) else f64(v)) for k, v in P.items()}
    P["dt"] = P["dt"].double()
    rem = P["rem"]
    m = state.masses
    pos, vel, acc = (t.double() for t in (m.pos, m.vel, m.acc))
    rng = np.random.RandomState(5)
    pos = pos + torch.from_numpy(rng.normal(0, 0.01, pos.shape))
    vel = vel + torch.from_numpy(rng.normal(0, 0.3, vel.shape))
    gp2, gv2, ga2 = (torch.from_numpy(rng.normal(0, 1, pos.shape))
                     for _ in range(3))
    rg, rs = tadj.torch_rolls()
    t_now = torch.tensor(0.37, dtype=torch.float64)

    def fwd(pos, vel, acc, p, rest):
        Pv = {**P, "rem": {**rem, "p": p, "rest": rest}}
        return tadj.forward_step(pos, vel, acc, Pv, rg, rs, t_now, s_idx=3.0)

    _, vjp = torch.func.vjp(fwd, pos, vel, acc, rem["p"], rem["rest"])
    gpos_v, gvel_v, gacc_v, gp_v, grest_v = vjp((gp2, gv2, ga2))
    gpos, gvel, gacc, bars = tadj.backward_step(pos, vel, gp2, gv2, ga2, P,
                                                rg, rs, t_now, s_idx=3.0)
    tol = dict(rtol=1e-9, atol=1e-9)
    for name, a, b in (("gpos", gpos, gpos_v), ("gvel", gvel, gvel_v),
                       ("gacc_prev", gacc, gacc_v),
                       ("rest_e", bars["rest_e"], grest_v),
                       ("k_e", bars["k_e"], gp_v[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **tol)
    rows = {"damped": ("damp_e", 1), "breathing": ("omega_e", 3),
            "actuated": ("aratedt_e", 6)}
    bar, row = rows[kind]
    assert np.abs(gp_v[row].numpy()).max() > 0
    np.testing.assert_allclose(bars[bar].numpy(), gp_v[row].numpy(),
                               err_msg=bar, **tol)


@pytest.mark.parametrize("integrator", [None, "rk2"])
def test_traces_replay_chunks_with_actuated_links(integrator):
    """trace[t] is the input of step t of each chunk's plain version, and
    the remainder rest the chunk outputs advanced, so that the replay's
    rest path is the forward's."""
    shape, state = carry_over(link_scene(titan_tpu, "actuated", integrator))
    seg = 6
    for trace_run, chunk in ((tadj.trace_run, fused_step.fused_chunk_plain),
                             (adjoint_tiled.tiled_trace_run,
                              tiled_step.tiled_chunk_plain)):
        trace = trace_run(shape, state, seg)             # CPU: plain
        prev = chunk(shape, state, seg - 1)
        assert not torch.equal(prev.springs.rest, state.springs.rest)
        np.testing.assert_array_equal(
            trace[-1].numpy(),
            torch.cat([prev.masses.pos, prev.masses.vel]).numpy())
