"""The port's distributed tiled adjoint (``titan_tpu_torch/parallel/
halo_adjoint.py``) and ``diff.grad_rollout(mesh=)``.

- ``grad_rollout(mesh=)`` over 4 CPU shards (the plain versions of the
  replay and of B7 on each shard's window) against the port's
  single-device ``tiled_adjoint_rollout`` (its plain versions), 12 steps
  in segments of 6, gradients of a seeded loss over pos, vel, k, rest, m,
  extern_force and g: bitwise under Euler, Verlet and RK2, and with
  damping and actuation; a glue scene (binned magnets and remainder
  springs under RK2, the split backward with the glue's vjp between its
  parts; one 6-step segment) within 1e-5 of each gradient's max
  |single-device| (the glue's remainder forces are summed in another
  order: measured 4e-8).
- Against ``titan_tpu``'s gradient through its XLA rollout
  (``test_torch_step.py::jax_grad_ref``), 8 steps, at
  ``tests/test_torch_adjoint_tiled.py``'s 2e-4 of each gradient's max.
- The routes and the refusal of ``tests/test_halo_adjoint.py:364-441``:
  inside its envelope the distributed adjoint, with no warning; outside it
  (exact-pairwise magnets) a warning and the single-device adjoint;
  outside every adjoint a RuntimeError under a mesh, ``fast_rollout``
  without.
- ``halo_adjoint_reject_reason`` equal to the JAX package's on its
  non-geometric conditions (the JAX geometry rounds halos and blocks to
  1,024-row tiles, the port's does not), and the one-hop rule.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu import diff as jdiff
from titan_tpu.parallel import halo_adjoint as jha
from titan_tpu.state import xla_only_shape
from titan_tpu_torch import diff
from titan_tpu_torch.ops import adjoint_tiled
from titan_tpu_torch.parallel import halo_adjoint
from titan_tpu_torch.state import shape_from_fields

from test_torch_halo import cpu_mesh, dist_scene
from test_torch_step import carry_over, jax_grad_ref

GRAD_ARGS = ("pos", "vel", "k", "rest", "m", "extern_force", "g")
STEPS, SEG = 12, 6
TOL_GLUE = 1e-5
# tests/test_torch_adjoint_tiled.py's ATOL (of each gradient's max)
ATOL_JAX = 2e-4


def _with(state, args):
    pos, vel, k, rest, m, ext, g = args
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel, m=m,
                                   extern_force=ext),
        stencil=dataclasses.replace(state.stencil, k=k, rest=rest), g=g)


def _weights(state, seed=0):
    rng = np.random.RandomState(seed)
    n = state.masses.pos.shape[1]
    w = [rng.normal(0, 1, (3, n)).astype(np.float32) for _ in range(2)]
    valid = state.masses.valid.numpy()
    return [x * valid for x in w]


def port_grads(shape, state, rollout, steps=STEPS):
    """Gradients of weights . (final pos, vel) through ``rollout``."""
    args = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel, state.stencil.k,
        state.stencil.rest, state.masses.m, state.masses.extern_force,
        state.g)]
    out = rollout(shape, _with(state, args), steps)
    wpos, wvel = (torch.from_numpy(w) for w in _weights(state))
    loss = (torch.sum(out.masses.pos * wpos)
            + torch.sum(out.masses.vel * wvel))
    return torch.autograd.grad(loss, args), out


def mesh_rollout(mesh):
    return lambda sh, st, k: diff.grad_rollout(sh, st, k, segment=SEG,
                                               mesh=mesh)


def single_rollout(sh, st, k):
    return adjoint_tiled.tiled_adjoint_rollout(sh, st, k, segment=SEG)


def port_scene(**kw):
    sim = dist_scene(titan_tpu_torch, marshal=False, **kw)
    st = sim._store
    st.rest[: st.n_springs] *= 1.03      # pre-stress: real k / rest grads
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


BITWISE = {
    "euler": dict(velocity_clamp=True),
    "verlet": dict(integrator="verlet"),
    "rk2": dict(integrator="rk2"),
    "rk2_damped_actuated": dict(integrator="rk2", damping=0.4,
                                actuated=True, deleted=True),
}


@pytest.mark.parametrize("variant", sorted(BITWISE))
def test_mesh_grads_bitwise_single_device(variant):
    shape, state = port_scene(**BITWISE[variant])
    assert halo_adjoint.halo_adjoint_reject_reason(shape, 4) is None
    got, out = port_grads(shape, state, mesh_rollout(cpu_mesh()))
    want, ref = port_grads(shape, state, single_rollout)
    assert torch.equal(out.masses.pos, ref.masses.pos)
    for name, a, b in zip(GRAD_ARGS, got, want):
        assert torch.equal(a, b), name
    assert float(got[2].abs().max()) > 0


def test_mesh_glue_grads_match_single_device():
    shape, state = port_scene(integrator="rk2", magnets=True,
                              magnet_binned=True, remainder=True,
                              damping=0.3)
    assert shape.has_magnets and shape.has_remainder
    got, _ = port_grads(shape, state, mesh_rollout(cpu_mesh()), SEG)
    want, _ = port_grads(shape, state, single_rollout, SEG)
    for name, a, b in zip(GRAD_ARGS, got, want):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= TOL_GLUE * scale, name


def test_mesh_grads_match_jax():
    jsim = dist_scene(titan_tpu, marshal=False, damping=0.2)
    st = jsim._store
    st.rest[: st.n_springs] *= 1.03
    jsim._T = 0.0
    jsim._marshal()
    jshape, jstate = jsim._shape, jsim._state
    wpos, wvel = _weights(carry_over(jsim)[1])

    def jloss(*args):
        pos, vel, k, rest, m, ext, g = args
        s = jstate
        s = dataclasses.replace(
            s, masses=dataclasses.replace(s.masses, pos=pos, vel=vel, m=m,
                                          extern_force=ext),
            stencil=dataclasses.replace(s.stencil, k=k, rest=rest), g=g)
        out = jdiff.rollout(xla_only_shape(jshape), s, 8)
        return jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)

    m, stc = jstate.masses, jstate.stencil
    want = jax_grad_ref(jloss, tuple(range(7)), (
        m.pos, m.vel, stc.k, stc.rest, m.m, m.extern_force, jstate.g))
    shape, state = carry_over(jsim)
    got, _ = port_grads(shape, state, lambda sh, st_, k: diff.grad_rollout(
        sh, st_, k, segment=4, mesh=cpu_mesh()), steps=8)
    msk = np.asarray(stc.mask)
    for name, a, x in zip(GRAD_ARGS, got, want):
        a, x = a.numpy(), np.asarray(x)
        if name in ("k", "rest"):
            a, x = a * msk, x * msk
        scale = max(np.abs(x).max(), 1e-8)
        assert float((np.abs(a - x) / scale).max()) < ATOL_JAX, name


def test_grad_rollout_mesh_routes(monkeypatch, caplog):
    shape, state = port_scene()
    mesh = cpu_mesh()
    called = {}
    orig = halo_adjoint.halo_adjoint_rollout

    def spy(*a, **k):
        called["dist"] = True
        return orig(*a, **k)

    monkeypatch.setattr(halo_adjoint, "halo_adjoint_rollout", spy)
    with caplog.at_level(logging.WARNING, logger="titan_tpu_torch"):
        out = diff.grad_rollout(shape, state, 2, segment=2, mesh=mesh)
    assert called.get("dist")
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    ref = orig(shape, state, mesh, 2, segment=2)
    assert torch.equal(out.masses.pos, ref.masses.pos)

    pshape, pstate = port_scene(magnets=True)
    assert pshape.has_magnets and not pshape.magnet_binned
    assert "exact-pairwise" in halo_adjoint.halo_adjoint_reject_reason(
        pshape, 4)
    monkeypatch.setattr(diff, "adjoint_rollout", lambda *a, **k: "SINGLE")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="titan_tpu_torch"):
        out = diff.grad_rollout(pshape, pstate, 2, segment=2, mesh=mesh)
    assert out == "SINGLE"
    msgs = [r.message for r in caplog.records
            if r.levelno >= logging.WARNING]
    assert any("distributed adjoint" in m for m in msgs), msgs


def test_grad_rollout_mesh_refuses_recompute_fallback(monkeypatch):
    shape, state = port_scene()
    monkeypatch.setattr(diff, "grad_route",
                        lambda s: ("fast", "stub: outside both"))
    monkeypatch.setattr(
        "titan_tpu_torch.parallel.halo_adjoint.halo_adjoint_reject_reason",
        lambda s, n: "stub: outside distributed envelope")
    with pytest.raises(RuntimeError, match="outside every fused"):
        diff.grad_rollout(shape, state, 2, segment=2, mesh=cpu_mesh())
    monkeypatch.setattr(diff, "fast_rollout", lambda *a, **k: "FAST")
    assert diff.grad_rollout(shape, state, 2, segment=2) == "FAST"


def test_halo_adjoint_reject_reason():
    jbase = dist_scene(titan_tpu)._shape
    rep = dataclasses.replace
    for js in (rep(jbase, config=rep(jbase.config,
                                     persistent_extern_force=False)),
               dist_scene(titan_tpu, magnets=True)._shape,
               rep(jbase, config=rep(jbase.config, use_pallas=False))):
        want = jha.halo_adjoint_reject_reason(js, 4)
        assert want is not None
        assert halo_adjoint.halo_adjoint_reject_reason(
            shape_from_fields(js, "cpu"), 4) == want
    shape = shape_from_fields(jbase, "cpu")
    assert halo_adjoint.halo_adjoint_reject_reason(shape, 4) is None
    rk2 = rep(shape, config=rep(shape.config,
                                integrator=titan_tpu_torch.Integrator.RK2))
    assert halo_adjoint.halo_adjoint_reject_reason(rk2, 4) is None
    # 8 shards: blocks of 64 masses, RK2's backward halo 4 x 21 = 84
    assert halo_adjoint.halo_adjoint_reject_reason(shape, 8) is None
    assert halo_adjoint.halo_adjoint_reject_reason(rk2, 8) == (
        "backward halo 84 exceeds the per-device block 64 (one-hop "
        "neighbor exchange)")
    with pytest.raises(ValueError, match="distributed adjoint envelope"):
        halo_adjoint.halo_adjoint_rollout(rk2, None, cpu_mesh(8), 2)
    assert halo_adjoint.default_segment(shape, 4, 200) == 50
