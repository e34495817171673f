"""The port's adjoint math (``titan_tpu_torch/ops/adjoint.py``) against the
JAX package's, and the gradient-safe eager step.

- ``backward_step`` against ``titan_tpu.ops.adjoint.backward_step`` under
  ``jnp_rolls``, on the inputs tests/test_adjoint.py makes
  (``np.random.RandomState(7)``, sqrt + divide form), for every variant of
  that file inside the port's envelope: f64 at 1e-9 (x64 on) and f32 at
  that file's 2e-4.  Its remainder springs, staged there as one-hot
  selectors, cross into the port's staging (``forces.stage_remainder``:
  an incidence table and per-spring rows) through ``_port_remainder``;
- ``backward_step`` against ``torch.func.vjp`` of the port's own
  ``forward_step`` in f64;
- ``trace_run_plain`` replays ``fused_chunk_plain`` bitwise;
- autograd through the eager step is finite in contact with a friction
  plane and under drag from rest, and equals ``jax.grad`` through
  ``titan_tpu.diff.rollout`` in f64 to 1e-9.
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
from titan_tpu import diff as jdiff
from titan_tpu.ops import adjoint as jadj
from titan_tpu.state import xla_only_shape
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import adjoint as tadj
from titan_tpu_torch.ops import fused_step

from test_adjoint import N, ROWS, VARIANTS, _mkP
from test_torch_step import build_scene, carry_over, jax_grad_ref
from titan_tpu_torch.builders import build_incidence

# the variants of test_adjoint.py inside the port's envelope: local
# constraints and remainder springs run in it; magnets do not yet
PORT_VARIANTS = sorted(v for v, kw in VARIANTS.items()
                       if not kw.get("magnets"))

# the per-spring gradient keys of the two packages' backward_step
REM_BARS = ("k_e", "rest_e", "damp_e", "omega_e", "aratedt_e")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _inputs(variant, dtype):
    """(JAX P, port P, primal + cotangent arrays) for one variant, made as
    test_adjoint.py makes them, in ``dtype``."""
    rng = np.random.RandomState(7)
    kw = dict(damping=False, clamp=False, drag=False, planes=0, fric=False,
              ball=False, fixed=False, breathing=False, verlet=False,
              rk2=False, actuated=False)
    kw.update(VARIANTS[variant])
    P = _mkP(rng, "legacy", **kw)
    arrays = [rng.normal(0, s, (3, ROWS, 128)) for s in (1, 0.8, 1, 1, 1, 1)]
    arrays = [np.asarray(np.float32(a), dtype) for a in arrays]

    def cast(v):
        return np.asarray(v, np.float32).astype(dtype)

    Pj, Pt = dict(P), dict(P)
    for key, v in P.items():
        if isinstance(v, jax.Array) and v.ndim >= 2:
            Pj[key] = jnp.asarray(cast(v))
            if key not in ("rowsel", "lanesel", "remp", "aratedt_e",
                           "sstop_e"):     # the remainder: _port_remainder
                Pt[key] = torch.from_numpy(
                    cast(v).reshape(v.shape[:-2] + (N,)))
    for key in ("planes", "balls"):
        Pj[key] = [tuple(jnp.asarray(cast(c)) for c in pp) for pp in P[key]]
        Pt[key] = [tuple(float(cast(c)) for c in pp) for pp in P[key]]
    Pj["dt"] = jnp.asarray(cast(P["dt"]))
    Pt["dt"] = float(cast(P["dt"]))
    Pt["rem"] = _port_remainder(P, cast) if P["has_remainder"] else None
    return Pj, Pt, arrays


def _port_remainder(P, cast):
    """test_adjoint.py's remainder springs (one-hot endpoint selectors
    rowsel / lanesel, rows remp [k, rest, damping, bsign, bomega] and the
    closed-form aratedt_e / sstop_e) as ``forces.stage_remainder`` stages
    them: ends, the incidence table, the rows ``REM_ROWS``, rest."""
    s = P["n_rem"]
    lr = (np.argmax(np.asarray(P["rowsel"]), axis=1) * 128
          + np.argmax(np.asarray(P["lanesel"]), axis=1))
    left, right = lr[:s], lr[s:]
    inc, sign = build_incidence(left, right, N, s)
    remp = cast(P["remp"])[:, :, 0]
    zero = np.zeros(s, remp.dtype)
    act = P["aratedt_e"] is not None
    rows = [remp[0], remp[2], remp[3], remp[4], zero, zero,
            cast(P["aratedt_e"])[:, 0] if act else zero,
            cast(P["sstop_e"])[:, 0] if act else zero]
    return dict(inc=torch.from_numpy(inc), sign=torch.from_numpy(
                    sign.astype(remp.dtype)),
                ends=torch.from_numpy(np.stack([left, right]).astype(
                    np.int32)),
                p=torch.from_numpy(np.stack(rows)),
                rest=torch.from_numpy(remp[1].copy()))


def _flat(a):
    return torch.from_numpy(np.array(a).reshape(np.shape(a)[:-2] + (N,)))


def _bar_names(Pt):
    names = ["k", "rest", "cf", "minv"]
    names += ["damping"] * Pt["has_damping"] + ["drag"] * Pt["has_drag"]
    names += ["omega"] * Pt["has_breathing"]
    names += ["aratedt"] * Pt["has_actuated"]
    if Pt["rem"] is not None:
        names += ["k_e", "rest_e"] + ["damp_e"] * Pt["has_damping"]
        names += ["omega_e"] * Pt["has_breathing"]
        names += ["aratedt_e"] * Pt["has_actuated"]
    return names


def _stacked(bars, name):
    v = bars[name]
    return torch.stack(v) if isinstance(v, list) else v


# f32 cases: every variant but local_rk2, whose random inputs are so badly
# conditioned in f32 that both packages' f32 gradients leave the f64 value
# by up to 2.95e-2 (the two by 2.7e-4 on one of 1,536 velocity entries);
# it is held in f64 at 1e-9 and against the port's own VJP
F32_VARIANTS = [v for v in PORT_VARIANTS if v != "local_rk2"]


@pytest.mark.parametrize("variant,dtype",
                         [(v, "float64") for v in PORT_VARIANTS]
                         + [(v, "float32") for v in F32_VARIANTS])
def test_backward_step_matches_jax(variant, dtype, x64):
    Pj, Pt, (pos, vel, acc, gp2, gv2, ga2) = _inputs(variant, dtype)
    rg_j, rs_j = jadj.jnp_rolls(ROWS)
    t_now, s_idx = np.asarray(0.37, dtype), 3.0
    want = jadj.backward_step(*(jnp.asarray(a) for a in (pos, vel, gp2, gv2,
                                                         ga2)),
                              Pj, rg_j, rs_j, jnp.asarray(t_now),
                              s_idx=jnp.asarray(s_idx, dtype))
    rg, rs = tadj.torch_rolls()
    got = tadj.backward_step(*(_flat(a) for a in (pos, vel, gp2, gv2, ga2)),
                             Pt, rg, rs, torch.tensor(t_now), s_idx=s_idx)
    tol = (dict(rtol=1e-9, atol=1e-9) if dtype == "float64"
           else dict(rtol=2e-4, atol=2e-4))
    if dtype == "float64" and Pt["rem"] is not None:
        # the JAX package's remainder gather and scatter are one-hot
        # matrix products with preferred_element_type float32
        # (titan_tpu/ops/pallas_step.py::remainder_gather), so in f64 its
        # remainder terms carry f32 roundings (measured up to 7.3e-7
        # relative); the port's own f64 VJP check holds them at 1e-9
        tol = dict(rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("gpos", "gvel", "gacc_prev"), got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), _flat(b).numpy(), err_msg=name,
                                   **tol)
    wb = {k: (jnp.stack(v) if isinstance(v, list) else v)
          for k, v in want[3].items()}
    for name in _bar_names(Pt):
        w = (np.asarray(wb[name])[:, 0] if name in REM_BARS
             else _flat(wb[name]).numpy())
        np.testing.assert_allclose(_stacked(got[3], name).numpy(), w,
                                   err_msg=name, **tol)


@pytest.mark.parametrize("variant", PORT_VARIANTS)
def test_backward_step_is_vjp_of_forward_step(variant):
    """The hand-derived transpose equals autograd's VJP of the port's own
    forward_step, for the state and every parameter, in f64."""
    _, P, (pos, vel, acc, gp2, gv2, ga2) = _inputs(variant, "float64")
    pos, vel, acc, gp2, gv2, ga2 = (_flat(a) for a in (pos, vel, acc, gp2,
                                                       gv2, ga2))
    rg, rs = tadj.torch_rolls()
    t_now = torch.tensor(0.37, dtype=torch.float64)
    diffable = ["k", "rest", "cf", "minv"]
    diffable += ["damping"] * P["has_damping"] + ["drag"] * P["has_drag"]
    diffable += ["bomega"] * P["has_breathing"]
    diffable += ["aratedt"] * P["has_actuated"]

    rem = P["rem"]
    if rem is not None:
        # the remainder springs' rows and rest: k, damping, bomega,
        # aratedt (REM_ROWS 0, 1, 3, 6) against k_e, damp_e, omega_e,
        # aratedt_e
        diffable += ["rem_p", "rem_rest"]
        P = {**P, "rem_p": rem["p"], "rem_rest": rem["rest"]}

    def fwd(pos, vel, acc, params):
        Pv = {**P, **params}
        if rem is not None:
            Pv["rem"] = {**rem, "p": params["rem_p"],
                         "rest": params["rem_rest"]}
        return tadj.forward_step(pos, vel, acc, Pv, rg, rs, t_now,
                                 s_idx=3.0)

    params = {k: P[k] for k in diffable}
    _, vjp = torch.func.vjp(fwd, pos, vel, acc, params)
    gpos_v, gvel_v, gacc_v, gpar_v = vjp((gp2, gv2, ga2))
    gpos, gvel, gacc, bars = tadj.backward_step(pos, vel, gp2, gv2, ga2, P,
                                                rg, rs, t_now, s_idx=3.0)
    tol = dict(rtol=1e-9, atol=1e-9)
    for name, a, b in (("gpos", gpos, gpos_v), ("gvel", gvel, gvel_v),
                       ("gacc_prev", gacc, gacc_v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **tol)
    for name in diffable:
        if name == "rem_p":
            rows = [("k_e", 0)] + [("damp_e", 1)] * P["has_damping"]
            rows += [("omega_e", 3)] * P["has_breathing"]
            rows += [("aratedt_e", 6)] * P["has_actuated"]
            for bar, row in rows:
                np.testing.assert_allclose(
                    bars[bar].numpy(), gpar_v[name][row].numpy(),
                    err_msg=bar, **tol)
            continue
        bar = {"bomega": "omega", "rem_rest": "rest_e"}.get(name, name)
        np.testing.assert_allclose(_stacked(bars, bar).numpy(),
                                   gpar_v[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("variant", ["friction", "breathing", "actuated",
                                     "verlet", "rk2"])
def test_trace_replays_fused_chunk_bitwise(variant):
    """trace[t] is the input of step t of fused_chunk_plain: the last entry,
    stepped once, is the segment's output, bitwise."""
    shape, state = carry_over(build_scene(titan_tpu, variant))
    seg = 8
    trace = tadj.trace_run(shape, state, seg)          # CPU: plain version
    assert trace.shape == (seg, 6, shape.n_masses)
    np.testing.assert_array_equal(
        trace[0].numpy(), torch.cat([state.masses.pos,
                                     state.masses.vel]).numpy())
    prev = fused_step.fused_chunk_plain(shape, state, seg - 1)
    last = dataclasses.replace(prev, masses=dataclasses.replace(
        prev.masses, pos=trace[-1, :3].clone(), vel=trace[-1, 3:].clone()))
    got = fused_step.fused_chunk_plain(shape, last, 1)
    want = fused_step.fused_chunk_plain(shape, state, seg)
    for f in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(getattr(got.masses, f).numpy(),
                                      getattr(want.masses, f).numpy(), f)
    np.testing.assert_array_equal(got.stencil.rest.numpy(),
                                  want.stencil.rest.numpy())


def _repair_scene(pkg, kind):
    """The scenes that gave non-finite gradients before the eager step's
    norms were guarded: a 4^3 lattice (k = 800, rest x 1.03) at rest,
    either in contact with a 0.4 / 0.6 friction plane or under drag 0.3."""
    cfg = dict(dtype="float64")
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    z = 0.45 if kind == "friction" else 2.0
    sim.createLattice(pkg.Vec(0, 0, z), pkg.Vec(1, 1, 1), 4, 4, 4)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    st.rest[: st.n_springs] *= 1.03
    if kind == "friction":
        sim.createPlane(pkg.Vec(0, 0, 1), 0, 0.4, 0.6)
    else:
        st.drag[: st.n_masses] = 0.3
        sim.createPlane(pkg.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


@pytest.mark.parametrize("kind", ["friction", "drag"])
def test_eager_step_gradients_finite_and_match_jax(kind, x64):
    jsim = _repair_scene(titan_tpu, kind)
    n = jsim._store.n_masses
    jshape, jstate = jsim._shape, jsim._state
    steps = 5

    def jloss(pos, vel, k):
        st = dataclasses.replace(
            jstate, masses=dataclasses.replace(jstate.masses, pos=pos,
                                               vel=vel),
            stencil=dataclasses.replace(jstate.stencil, k=k))
        out = jdiff.rollout(xla_only_shape(jshape), st, steps)
        return jnp.sum(out.masses.pos[:, :n] + out.masses.vel[:, :n])

    want = jax_grad_ref(jloss, (0, 1, 2), (
        jstate.masses.pos, jstate.masses.vel, jstate.stencil.k))

    shape, state = carry_over(jsim)
    pos, vel, k = (t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel, state.stencil.k))
    state = dataclasses.replace(
        state, masses=dataclasses.replace(state.masses, pos=pos, vel=vel),
        stencil=dataclasses.replace(state.stencil, k=k))
    out = tdiff.rollout(shape, state, steps)
    loss = torch.sum(out.masses.pos[:, :n] + out.masses.vel[:, :n])
    got = torch.autograd.grad(loss, [pos, vel, k])
    for name, a, b in zip(("pos", "vel", "k"), got, want):
        assert bool(torch.isfinite(a).all()), f"d/d{name} not finite"
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
