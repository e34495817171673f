"""The port's tiled adjoint (``titan_tpu_torch/ops/adjoint_tiled.py``) on the
CPU, where its wrappers run their plain versions.

- ``tiled_adjoint_rollout`` gradients (forward ``tiled_chunk_plain``,
  backward ``tiled_trace_run_plain`` + ``tiled_bwd_run_plain``, 20 steps in
  segments of 10) against ``jax.grad`` through ``titan_tpu.diff.rollout``
  (the JAX package's XLA step, the reference tests/test_adjoint_tiled.py
  holds the JAX tiled adjoint to) with that file's loss and its normalised
  atol 2e-4, for pos, vel, k, rest, m, extern_force and g, on four
  variants (Euler with the clamp, damping with friction, Verlet, RK2;
  rest pre-stressed 3% so that k matters).  The JAX tiled adjoint itself
  is not run here: in Pallas interpret mode it costs tens of seconds a
  case, and tests/test_adjoint_tiled.py already holds it to the same
  reference.  Each reference is ``jax.jit`` of the gradient, compiled once
  per case (its variants differ in static flags, so no two share one)
  without XLA's optimisation passes (``test_torch_step.py::jax_grad_ref``).
- ``tiled_bwd_run_plain`` against ``torch.autograd.grad`` through the plain
  tiled steps on the same segment, on the other tiled variants (and
  actuation under Euler and RK2, whose closed-form rest the tiled forward
  and the transpose share; the JAX step advances rest iteratively): the
  cotangents of pos, vel and acc and the gradients of the staged inputs
  (a field that rides as a family scalar gets the sum of its springs'
  gradients).  f32; the transpose recomputes the force in the fused step's
  summation order (as the JAX package's tiled backward does), autograd
  differentiates the tiled order, so the two agree to rounding: held at
  ``TOL_AUTOGRAD`` of each gradient's max |autograd|.
- ``tiled_trace_run_plain`` over 37 steps (two resident-grid segments and
  a tail) bitwise the inputs of the plain chunk's steps.
- ``diff.grad_route`` on scene shapes alone, and the default segment.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu import diff as jdiff
from titan_tpu.state import xla_only_shape
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import adjoint_tiled, tiled_step

from test_torch_step import carry_over, jax_grad_ref
from test_torch_tiled import _lattice_shape, tiled_scene

# _check_grads of tests/test_adjoint_tiled.py
ATOL = 2e-4
# tiled_bwd_run_plain vs autograd through the tiled steps, per gradient:
# max |d| <= TOL_AUTOGRAD * max |autograd| (module docstring); the largest
# seen over these variants was 1.7e-6 (ball, pos)
TOL_AUTOGRAD = 2e-5

JAX_VARIANTS = {
    "plain": dict(),
    "damping_friction": dict(damping=0.4, friction=True),
    "verlet": dict(integrator="verlet"),
    "rk2": dict(integrator="rk2"),
}
AUTOGRAD_VARIANTS = {
    "actuated": dict(actuated=True),
    "rk2_actuated": dict(integrator="rk2", actuated=True),
    "damping_friction": dict(damping=0.4, friction=True),
    "breathing": dict(breathing=True),
    "drag_clamp": dict(drag=0.3),
    "ball": dict(ball=True),
    "nonuniform_k": dict(nonuniform_k=True),
    "nonuniform_rest": dict(nonuniform_rest=True),
    "deleted": dict(deleted=True),
}
GRAD_ARGS = ("pos", "vel", "k", "rest", "m", "extern_force", "g")


def _with(state, args):
    """``state`` with (pos, vel, k, rest, m, extern_force, g) replaced."""
    pos, vel, k, rest, m, ext, g = args
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel, m=m,
                                   extern_force=ext),
        stencil=dataclasses.replace(state.stencil, k=k, rest=rest), g=g)


@pytest.mark.parametrize("variant", sorted(JAX_VARIANTS))
def test_tiled_adjoint_grads_match_jax(variant):
    jsim = tiled_scene(titan_tpu, marshal=False, **JAX_VARIANTS[variant])
    st = jsim._store
    st.rest[: st.n_springs] *= 1.03      # pre-stress: real k / rest grads
    jsim._T = 0.0
    jsim._marshal()
    jshape, jstate = jsim._shape, jsim._state
    n = jsim._store.n_masses
    npad = jstate.masses.pos.shape[1]
    rng = np.random.RandomState(0)
    wpos = rng.normal(0, 1, (3, npad)).astype(np.float32)
    wvel = rng.normal(0, 1, (3, npad)).astype(np.float32)
    wpos[:, n:] = 0.0
    wvel[:, n:] = 0.0

    def jloss(*args):
        out = jdiff.rollout(xla_only_shape(jshape), _with(jstate, args), 20)
        return jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)

    m, stc = jstate.masses, jstate.stencil
    jargs = (m.pos, m.vel, stc.k, stc.rest, m.m, m.extern_force, jstate.g)
    want = jax_grad_ref(jloss, tuple(range(7)), jargs)

    shape, state = carry_over(jsim)
    assert tdiff.grad_route(shape)[0] == "adjoint"   # small: fused adjoint
    assert adjoint_tiled.tiled_adjoint_reject_reason(shape) is None
    args = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel, state.stencil.k,
        state.stencil.rest, state.masses.m, state.masses.extern_force,
        state.g)]
    out = adjoint_tiled.tiled_adjoint_rollout(shape, _with(state, args), 20,
                                              segment=10)
    loss = (torch.sum(out.masses.pos * torch.from_numpy(wpos))
            + torch.sum(out.masses.vel * torch.from_numpy(wvel)))
    got = torch.autograd.grad(loss, args)
    msk = np.asarray(stc.mask)
    for name, a, x in zip(GRAD_ARGS, got, want):
        a, x = a.numpy(), np.asarray(x)
        if name in ("k", "rest"):
            a, x = a * msk, x * msk
        assert np.isfinite(a).all(), f"grad[{name}] not finite"
        scale = max(np.abs(x).max(), 1e-8)
        err = float((np.abs(a - x) / scale).max())
        assert err < ATOL, (name, err)


def _autograd_grads(shape, state, seg, cts):
    """Gradients of cts . (pos, vel, acc) after ``seg`` plain tiled steps
    with respect to the input (pos, vel, acc) and the staged inputs."""
    inv = tiled_step.prep_tiled_inputs(shape, state)
    keys = [k for k in ("fparams", "k", "rest", "damping", "bsign", "bomega",
                        "aratedt", "const_f", "minv", "drag") if k in inv]
    leaves = {k: inv[k].clone().requires_grad_() for k in keys}
    inv = dict(inv, **leaves)
    m = state.masses
    x0 = [t.clone().requires_grad_() for t in (m.pos, m.vel, m.acc)]
    pos, vel, acc = x0
    for step in range(seg):
        pos, vel, acc = tiled_step.tiled_step_plain(shape, inv, pos, vel, acc,
                                                    step)
    acc = torch.where(inv["move"], acc, x0[2])     # finish_tiled_chunk
    loss = sum(torch.sum(x * c) for x, c in zip((pos, vel, acc), cts))
    grads = torch.autograd.grad(loss, x0 + list(leaves.values()),
                                allow_unused=True)
    return dict(zip(["pos", "vel", "acc"] + keys, grads)), inv


@pytest.mark.parametrize("variant", sorted(AUTOGRAD_VARIANTS))
def test_tiled_bwd_plain_matches_autograd(variant):
    sim = tiled_scene(titan_tpu_torch, marshal=False,
                      **AUTOGRAD_VARIANTS[variant])
    st = sim._store
    # moving from the start: autograd through |v| (drag, the clamp) is not
    # finite at v = 0, where the transpose takes the subgradient 0
    st.vel[: st.n_masses] = (0.3, -0.2, 0.1)
    sim._T = 0.0
    sim._marshal()
    shape, state = sim._shape, sim._state
    seg = 12
    rng = np.random.RandomState(5)
    cts = [torch.from_numpy(rng.normal(0, 1, (3, shape.n_masses))
                            .astype(np.float32)) for _ in range(3)]
    want, inv = _autograd_grads(shape, state, seg, cts)
    trace = adjoint_tiled.tiled_trace_run_plain(shape, state, seg)
    got = adjoint_tiled.tiled_bwd_run_plain(shape, state, trace, *cts)
    ok = inv["pair_ok"]
    nf = len(shape.stencil_deltas)
    bits = torch.stack([ok[fi] for fi in range(nf)]).float()
    pairs = [(k, got[k], want[k]) for k in ("pos", "vel", "acc")]
    pairs += [("cf", got["cf"], want["const_f"]),
              ("minv", got["minv"], want["minv"])]
    if shape.has_drag:
        pairs.append(("drag", got["drag"], want["drag"]))
    fp = want["fparams"]
    for key, plane, row, mask in (("k", "k", 0, bits),
                                  ("rest", "rest", 1, None),
                                  ("omega", "bomega", 4, None),
                                  ("aratedt", "aratedt", None, None),
                                  ("damping", "damping", None, bits)):
        if key not in got:
            continue
        g = got[key] if mask is None else got[key] * mask
        if plane in want:
            w = want[plane] if mask is None else want[plane] * mask
            pairs.append((key, g, w))
        else:   # a family scalar: the sum of its springs' gradients
            pairs.append((key, g.sum(dim=1), fp[row]))
    assert {"k", "rest"} <= {p[0] for p in pairs}
    for name, a, b in pairs:
        assert bool(torch.isfinite(a).all()), f"{name} not finite"
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max()) / scale
        assert err <= TOL_AUTOGRAD, (name, err)
    if variant == "nonuniform_k":
        assert "k" in inv and "bits" not in inv
    if variant == "nonuniform_rest":
        assert "rest" in inv


@pytest.mark.parametrize("integrator", [None, "verlet", "rk2"])
def test_tiled_trace_is_the_chunk_bitwise(integrator):
    sim = tiled_scene(titan_tpu_torch, integrator=integrator, damping=0.4)
    shape, state = sim._shape, sim._state
    seg = 2 * tiled_step.MEGA_SEG + 5
    trace = adjoint_tiled.tiled_trace_run_plain(shape, state, seg)
    assert trace.shape == (seg, 6, shape.n_masses)
    assert torch.equal(trace[0], torch.cat([state.masses.pos,
                                            state.masses.vel]))
    for s in (1, tiled_step.MEGA_SEG, tiled_step.MEGA_SEG + 1, seg - 1):
        out = tiled_step.tiled_chunk_plain(shape, state, s)
        assert torch.equal(trace[s], torch.cat([out.masses.pos,
                                                out.masses.vel])), s


def test_tiled_adjoint_forward_is_tiled_chunk():
    sim = tiled_scene(titan_tpu_torch, damping=0.4, friction=True)
    shape, state = sim._shape, sim._state
    out = adjoint_tiled.tiled_adjoint_rollout(shape, state, 20, segment=10)
    want = tiled_step.tiled_chunk(shape, state, 20)
    for f in ("pos", "vel", "acc", "T"):
        assert torch.equal(getattr(out.masses, f), getattr(want.masses, f)), f
    with pytest.raises(ValueError, match="divide"):
        adjoint_tiled.tiled_adjoint_rollout(shape, state, 10, segment=3)


def test_grad_route_on_shapes():
    assert tdiff.grad_route(_lattice_shape(43)) == ("adjoint", None)
    assert tdiff.grad_route(_lattice_shape(20)) == ("adjoint", None)
    assert tdiff.grad_route(_lattice_shape(100)) == ("tiled_adjoint", None)
    rk2 = _lattice_shape(100, config=titan_tpu_torch.SimConfig(
        device="cpu", integrator=titan_tpu_torch.Integrator.RK2))
    assert tdiff.grad_route(rk2)[0] == "tiled_adjoint"
    route, reason = tdiff.grad_route(_lattice_shape(100, has_magnets=True))
    assert route == "fast"
    assert "fused adjoint:" in reason and "tiled adjoint:" in reason
    # local constraints run in both adjoints: by the residency rule
    assert tdiff.grad_route(_lattice_shape(100, cap_cp=1)) == (
        "tiled_adjoint", None)
    # past the residency rule but outside the tiled adjoint (33 families,
    # one more than the existence mask has bits): the fused adjoint, which
    # has no size cap on the card
    wide = _lattice_shape(100, stencil_deltas=tuple(range(1, 34)))
    assert adjoint_tiled.tiled_adjoint_reject_reason(wide) is not None
    assert tdiff.grad_route(wide) == ("adjoint", None)


def test_default_segment():
    big, small = _lattice_shape(100), _lattice_shape(43)
    # 100^3: the trace caps a segment at 62 steps
    assert adjoint_tiled.default_segment(big, 200) == 50
    assert adjoint_tiled.default_segment(big, 160) == 32   # multiple of 16
    assert adjoint_tiled.default_segment(big, 120) == 60
    assert adjoint_tiled.default_segment(small, 256) == 64
    assert adjoint_tiled.default_segment(small, 10) == 10
    assert adjoint_tiled.default_segment(small, 200) == 50
