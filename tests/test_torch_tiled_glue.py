"""The tiled step's magnet glue and the tiled adjoint's glue path
(``titan_tpu_torch/ops/tiled_step.py``, ``ops/adjoint_tiled.py``): a magnet
scene steps one force pass at a time, each pass's constant force
``const_f + field`` (0 on fixed masses) at the pass's positions, the RK2
midpoint's between rk2a and rk2b; the replay keeps each pass's constant
force in the trace (9 rows, 12 under RK2); the backward routes each pass's
cotangent through the field's transpose.

- ``tiled_adjoint_rollout`` (its plain versions on the CPU) against
  ``jax.grad`` through ``titan_tpu.diff.rollout`` of ``xla_only_shape``, 4
  steps in segments of 2, on tests/test_adjoint_tiled.py's glue variants
  (``magnet_glue``, ``glue_verlet``, ``glue_everything``,
  ``rk2_magnet_glue``, ``rk2_glue_everything``: their features on a 30 x
  6 x 1 sheet, ``glue_scene``), with ``magnet_pallas_max`` lowered so that
  ``grad_route`` takes the tiled adjoint, and ``glue_everything`` binned
  (``magnet_binned_threshold`` lowered: the binned pass's vjp); over pos,
  vel, k, rest and the four magnet parameters at that file's atol 2e-4 of
  each gradient's max;
- ``tiled_bwd_run_plain`` against autograd through the plain tiled steps
  with the glue (``TOL_AUTOGRAD`` of each gradient's max), unbinned and
  binned, Euler and RK2;
- ``tiled_trace_run_plain`` holds each step's input and its passes'
  constant forces, bitwise the plain chunk's.

Small tensors: torch runs these on one thread.
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
from titan_tpu_torch.ops import adjoint_tiled, fused_step, tiled_step
from titan_tpu_torch.ops import forces as F
from titan_tpu_torch.ops import magnets

import test_adjoint_tiled
from test_torch_step import carry_over, jax_grad_ref

# _check_grads of tests/test_adjoint_tiled.py
ATOL = 2e-4
# tiled_bwd_run_plain vs autograd through the plain tiled steps, as
# tests/test_torch_adjoint_tiled.py holds them
TOL_AUTOGRAD = 2e-5
NX = 30          # the sheet's masses along x
GLUE = ("magnet_glue", "glue_verlet", "glue_everything", "rk2_magnet_glue",
        "rk2_glue_everything")
GRAD_ARGS = ("pos", "vel", "k", "rest", "mag_rad", "mag_stiffness",
             "mag_maxf", "mag_scale")


def glue_scene(variant, binned=False):
    """tests/test_adjoint_tiled.py's ``_scene`` for ``variant`` (its
    features: damping, friction, drag, fixed and deleted masses, cross
    links, magnets, integrator; pre-stress, plane and ball) on a 30 x 6 x 1
    sheet (180 masses, 4 families: the JAX reference compiles in ~2 s, a
    third of a 13-family lattice's time), marshalled in titan_tpu with
    ``magnet_pallas_max`` 64 (and ``magnet_binned_threshold`` 8 where
    ``binned``).  The cross links join the same fractions of the masses as
    at 80 x 6 x 6; the magnets sit at that scene's indices scaled alike."""
    kw = test_adjoint_tiled.VARIANTS[variant]
    cfg = dict(velocity_clamp=False, host_store_dtype="float32",
               magnet_pallas_max=64)
    if binned:
        cfg["magnet_binned_threshold"] = 8
    if kw.get("integrator"):
        cfg["integrator"] = titan_tpu.Integrator(kw["integrator"])
    Vec = titan_tpu.Vec
    sim = titan_tpu.Simulation(titan_tpu.SimConfig(**cfg))
    sim.createLattice(Vec(0, 0, 3), Vec(1.5, 1, 0), NX, 6, 1)
    st = sim._store
    nm = st.n_masses
    if kw.get("cross"):
        for a, b in [(0, 1500), (5, 2050), (12, 2600), (12, 977),
                     (40, 1203)]:
            sim.createSpring(sim.getMassByIndex(a * nm // 2880),
                             sim.getMassByIndex(b * nm // 2880))
    sim.setAllSpringConstantValues(800.0)
    sim.createPlane(Vec(0, 0, 1), 0, *((0.4, 0.6) if kw.get("friction")
                                       else ()))
    sim.createBall(Vec(1.0, 0.2, 2.2), 0.5)
    sim.setTimeStep(1e-4)
    sim.setGlobalAcceleration(Vec(0, 0, -9.8))
    st.rest[: st.n_springs] *= 1.03
    st.damping[: st.n_springs] = kw.get("damping", 0.0)
    st.drag[:nm] = kw.get("drag", 0.0)
    if kw.get("deleted"):
        st.valid[[7, 100]] = False
    if kw.get("fixed"):
        st.fixed[[3, 50]] = True
    for i in (0, 3, nm // 4, nm // 2, 2 * nm // 3, nm - 40):
        st.mag_rad[i] = 0.35
        st.mag_stiffness[i] = 5.0
    for i in (0, 3, 9, nm // 4, nm // 4 + 10, nm // 2, 2 * nm // 3,
              2 * nm // 3 + 13, nm - 40, nm - 30):
        st.mag_maxf[i] = 0.5
        st.mag_scale[i] = 1.0
    sim._T = 0.0
    sim._marshal()
    return sim


def _with(state, args):
    pos, vel, k, rest, *mag = args
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel,
                                   **dict(zip(GRAD_ARGS[4:], mag))),
        stencil=dataclasses.replace(state.stencil, k=k, rest=rest))


@pytest.mark.parametrize("variant", GLUE)
def test_tiled_glue_grads_match_jax(variant):
    binned = variant == "glue_everything"
    jsim = glue_scene(variant, binned=binned)
    jshape, jstate = jsim._shape, jsim._state
    assert jshape.has_magnets and bool(jshape.magnet_binned) == binned
    n = jsim._store.n_masses
    npad = jstate.masses.pos.shape[1]
    rng = np.random.RandomState(0)
    wpos, wvel = (rng.normal(0, 1, (3, npad)).astype(np.float32)
                  for _ in range(2))
    wpos[:, n:] = 0.0
    wvel[:, n:] = 0.0
    steps = 4

    def jloss(*args):
        out = jdiff.rollout(xla_only_shape(jshape), _with(jstate, args),
                            steps)
        return jnp.sum(out.masses.pos * wpos) + jnp.sum(out.masses.vel * wvel)

    m = jstate.masses
    jargs = ((m.pos, m.vel, jstate.stencil.k, jstate.stencil.rest)
             + tuple(getattr(m, k) for k in GRAD_ARGS[4:]))
    want = jax_grad_ref(jloss, tuple(range(len(jargs))), jargs)

    shape, state = carry_over(jsim)
    assert tdiff.grad_route(shape) == ("tiled_adjoint", None)
    assert not adjoint_tiled.mega_adjoint_ok(shape)
    args = [t.clone().requires_grad_() for t in (
        (state.masses.pos, state.masses.vel, state.stencil.k,
         state.stencil.rest)
        + tuple(getattr(state.masses, k) for k in GRAD_ARGS[4:]))]
    out = tdiff.grad_rollout(shape, _with(state, args), steps, segment=2)
    loss = (torch.sum(out.masses.pos * torch.from_numpy(wpos))
            + torch.sum(out.masses.vel * torch.from_numpy(wvel)))
    got = torch.autograd.grad(loss, args)
    valid = state.masses.valid.numpy()
    for name, a, x in zip(GRAD_ARGS, got, want):
        a, x = a.numpy(), np.asarray(x)
        assert np.isfinite(a).all(), f"grad[{name}] not finite"
        if name.startswith("mag"):
            a, x = a * valid, x * valid
        elif name == "k":
            # the k of a missing spring gets 0 (pair_ok), the XLA path's
            # roll still differentiates it
            ok = tiled_step.prep_tiled_inputs(shape, state)["pair_ok"]
            x = x * ok.numpy()
        scale = max(np.abs(x).max(), 1e-8)
        assert np.abs(x).max() > 0, f"grad[{name}] is 0: nothing to hold"
        err = float((np.abs(a - x) / scale).max())
        assert err < ATOL, (name, err)


def _field(shape, masses, binned):
    """The plain tiled chunk's field as a differentiable function of (pos,
    the four magnet parameters): 0 on fixed masses."""
    def field(pos, p4):
        m = dataclasses.replace(masses, pos=pos, **dict(zip(GRAD_ARGS[4:],
                                                            p4)))
        cut = shape.config.magnet_cutoff
        if binned:
            a_cells, cap = shape.magnet_binned
            f = magnets.binned_magnet_forces(m, cut, a_cells, cap)
        else:
            f = F.magnet_forces(m, cut)
        return torch.where(masses.fixed, 0.0, f)
    return field


@pytest.mark.parametrize("variant,binned", [
    ("magnet_glue", False), ("rk2_glue_everything", False),
    ("glue_everything", True), ("rk2_magnet_glue", True)])
def test_tiled_glue_bwd_matches_autograd(variant, binned):
    shape, state = carry_over(glue_scene(variant, binned=binned))
    seg = 6
    rng = np.random.RandomState(5)
    cts = [torch.from_numpy(rng.normal(0, 1, (3, shape.n_masses))
                            .astype(np.float32)) for _ in range(3)]
    m = state.masses
    inv = tiled_step.prep_tiled_inputs(shape, state)
    x0 = [t.clone().requires_grad_() for t in (m.pos, m.vel, m.acc)]
    p4 = [getattr(m, k).clone().requires_grad_() for k in GRAD_ARGS[4:]]
    f = _field(shape, m, binned)
    pos, vel, acc = x0
    for step in range(seg):
        pos, vel, acc = tiled_step.tiled_step_plain(
            shape, inv, pos, vel, acc, step, lambda p: f(p, p4))
    acc = torch.where(inv["move"], acc, x0[2])     # finish_tiled_chunk
    loss = sum(torch.sum(x * c) for x, c in zip((pos, vel, acc), cts))
    want = torch.autograd.grad(loss, x0 + p4)
    trace = adjoint_tiled.tiled_trace_run_plain(shape, state, seg)
    got = adjoint_tiled.tiled_bwd_run_plain(shape, state, trace, *cts)
    valid = m.valid
    pairs = [(k, got[k], w) for k, w in zip(("pos", "vel", "acc"), want)]
    pairs += [(k, torch.where(valid, got["mag"][i], 0.0),
               torch.where(valid, w, 0.0))
              for i, (k, w) in enumerate(zip(GRAD_ARGS[4:], want[3:]))]
    for name, a, b in pairs:
        assert bool(torch.isfinite(a).all()), f"{name} not finite"
        scale = max(float(b.abs().max()), 1e-30)
        if name.startswith("mag"):
            assert scale > 1e-30, name
        err = float((a - b).abs().max()) / scale
        assert err <= TOL_AUTOGRAD, (name, err)


@pytest.mark.parametrize("variant", ["magnet_glue", "rk2_glue_everything"])
def test_tiled_glue_trace_is_the_chunk_bitwise(variant):
    shape, state = carry_over(glue_scene(variant))
    seg = 5
    trace = adjoint_tiled.tiled_trace_run(shape, state, seg)   # CPU: plain
    rk2 = shape.config.integrator.name == "RK2"
    assert trace.shape == (seg, 12 if rk2 else 9, shape.n_masses)
    field = fused_step.magnet_field_fn(shape, state, plain=True)
    cf = tiled_step.prep_tiled_inputs(shape, state)["const_f"]
    for s in range(seg):
        out = tiled_step.tiled_chunk_plain(shape, state, s)
        assert torch.equal(trace[s, :6], torch.cat([out.masses.pos,
                                                    out.masses.vel])), s
        assert torch.equal(trace[s, 6:9], cf + field(out.masses.pos)), s
