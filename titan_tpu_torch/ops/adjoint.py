"""The fused adjoint: gradients of a rollout with both passes on the card.

Counterpart of ``titan_tpu/ops/adjoint.py``.  A rollout is cut into
segments; each segment is a ``torch.autograd.Function``:

  forward  : ``fused_chunk`` (the CUDA kernel ``csrc/fused_step.cu`` on the
             card), keeping only the segment's input state;
  backward : (1) ``trace_run`` replays the segment and writes each step's
             input (pos_t, vel_t) to a trace [seg, 6, N];
             (2) ``bwd_run`` sweeps the trace in reverse with the
             hand-derived transpose of the step, carrying the cotangents
             of (pos, vel, acc) and accumulating the parameter gradients;
             (3) ``assemble_ct`` maps those onto the segment's inputs.

``trace_run`` and ``bwd_run`` launch the hand-written kernels of
``csrc/adjoint.cu`` for state on the card and run their plain PyTorch
versions (``trace_run_plain``, ``bwd_run_plain``) for state on the CPU;
anything else raises.  A scene on ``fused_step.takes_plain_spring_path``
(plain springs, family-uniform k: every main path) runs the replay's and
the backward's plain-spring loops (k from ``fused_step.bits_k``;
``trace_path``, ``trace_launch_count``) and, without magnets, folds each
reversed step's phases into one launch (``bwd_launch_count``).

The math below is the JAX package's, as plain functions on [.., N]
tensors with a roll pair (``rg`` reads index n + d, ``rs`` is its
inverse; ``torch_rolls``), in the sqrt + divide form that the CPU and
``fused_step.cu`` compute.  The adjoint of a step recomputes the step's
forward from the traced (pos, vel) and transposes it: integrator, drag,
the per-mass local constraints (directions, constraint planes, balls,
contact planes), balls, planes (static and kinetic friction), then the
spring families and the remainder springs.  Constraint planes and
directions mutate the velocity the integrator reads, so each force pass's
velocity cotangent threads back through them to the pass's input velocity.

Remainder springs (``titan_tpu/ops/adjoint.py:236-280``, transpose
:1121-1182) ride as ``forces.stage_remainder`` stages them; where the JAX
kernel's transpose reuses its one-hot gather and scatter, each mass here
walks its incidence row again: the spring's cotangent is gf at its right
end less gf at its left, each endpoint takes its own share of the position
and velocity cotangents, and the per-spring gradients are summed over the
segment's steps into [S] arrays.

ACTUATED rest is evaluated in closed form in the transpose (after c force
calls, rest_c = rest0 + min(c, s_stop) arate dt), as the JAX package does,
while the forward and the replay advance it step by step; the two differ
by about 1e-7 relative.

Differentiable inputs: masses.pos, vel, acc, extern_force, m, drag,
mag_rad, mag_stiffness, mag_maxf, mag_scale, stencil.k, rest, damping, omega, rate, springs.k, rest, damping, omega,
rate, and g.  dt, plane and ball geometry, the local-constraint slots, t
and the actuation bounds get no gradient.

Magnets (``titan_tpu/ops/adjoint.py:282-300``, transpose :935-1017).  The
forward feeds each force pass's pairwise or grid field through the
constant force (``fused_step._magnet_passes``); the replay runs the same
passes with the replay kernel and keeps each pass's constant force
``const_f + field`` in the trace entry (``trace_rows``: 9 rows, 12 under
RK2), which the backward reads.  After each pass's spring phase the
field's transpose (the B5 kernel ``csrc/magnets_adjoint.cuh``, launched
inside the sweep; plain version ``magnets.magnet_transpose_plain``) turns that pass's force cotangent on
movable masses into position cotangents and the per-mass gradients of
mag_rad, mag_stiffness, mag_maxf and mag_scale (``MAG_BARS``).  The
transpose is the all-pairs field's, so the adjoint takes unbinned magnet
scenes only: a binned scene's field visits at most ``cell_cap`` sources
per 3 x 3 neighbourhood, a different function once a neighbourhood holds
more (``adjoint_reject_reason``).

Envelope (``adjoint_reject_reason``): the fused step's, without scenes that
have no stencil family, and magnet scenes only within the reference's
``magnet_pallas_max`` and pairwise-temporaries rules and unbinned.  A trace
that does not fit on the card raises out-of-memory in the backward; a
shorter ``segment`` makes it smaller.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..config import ACTUATED_CONTRACT, ACTUATED_EXPAND, Integrator
from ..state import SceneShape, SimState
from . import forces as F
from .fused_step import (_ChunkArgs, _LocalSlots, _Remainder, _checked,
                         _chunk_args, _magnet_passes, bits_k, cf_rows,
                         deltas_on, fused_chunk, fused_reject_reason,
                         local_struct, magnet_field_fn, prep_invariants,
                         remainder_struct, takes_plain_spring_path,
                         trace_rows)
from .magnets import (magnet_transpose_plain, pairwise_field_lanes,
                      pairwise_params)
from .step import MAGNET_PAIR_BUDGET, local_caps, magnet_pair_bytes


def adjoint_reject_reason(shape: SceneShape):
    """None if the adjoint kernels accept this scene, else why not: the
    fused step's envelope, less scenes without stencil families, less
    magnet scenes outside the reference's fused envelope
    (``titan_tpu/ops/pallas_step.py:71-73``, :97-98: ``magnet_pallas_max``
    masses and the pairwise temporaries' budget) and binned magnet scenes:
    the transpose (B5) is the all-pairs field's, and a binned field caps
    the sources of each neighbourhood.  The reference's fused adjoint
    takes a binned scene within ``magnet_pallas_max`` (only where
    ``magnet_binned_threshold`` is set below it) through its dense field;
    the port's forward takes the grid field there, so its gradient goes to
    the tiled adjoint, whose glue transposes the binned pass.  Memory is
    no part of it: a trace too large for the card raises
    ``torch.OutOfMemoryError`` when the backward allocates it
    (``trace_run``), as the JAX package's staging fails cleanly.
    ``diff.grad_route`` reads the reference's residency rule
    (``step.fits_fused`` with ``adjoint_resident_bytes``) to choose
    between this adjoint and the tiled one."""
    if not shape.stencil_deltas:
        return "no stencil spring families"
    if shape.has_magnets:
        cfg = shape.config
        if shape.n_masses > cfg.magnet_pallas_max:
            return (f"magnetic scene with {shape.n_masses} masses > "
                    f"magnet_pallas_max={cfg.magnet_pallas_max}")
        if magnet_pair_bytes(shape) > MAGNET_PAIR_BUDGET:
            return (f"pairwise magnet temporaries at {shape.n_masses} "
                    "masses exceed 16 MB")
        if shape.magnet_binned:
            return ("binned magnets: the adjoint's transpose is the "
                    "all-pairs field's, and the binned field caps each "
                    "neighbourhood's sources")
    return fused_reject_reason(shape)


def adjoint_supported(shape: SceneShape) -> bool:
    return adjoint_reject_reason(shape) is None


def adjoint_resident_bytes(shape: SceneShape) -> int:
    """Bytes the TPU's fused adjoint would hold resident in VMEM for this
    scene: the port's copy of ``titan_tpu/ops/adjoint.py:107-137``, term
    for term, the rule by which the reference sends a gradient to its tiled
    adjoint (budget ``ops/step.py::RESIDENT_BUDGET``, 100 MB, as the JAX
    package's ``_VMEM_BUDGET``).  Per mass: the per-family parameters in
    and their gradient accumulators out, the local-constraint slot rows and
    the transpose's staged stage inputs (f per contact plane, (f, v) per
    constraint plane and direction; two passes' worth under RK2), the
    carries, two trace slots and ~10 vec3 temporaries; plus the remainder
    springs' selectors and per-spring terms and the magnet transpose's
    temporaries."""
    n, f = shape.n_masses, len(shape.stencil_deltas)
    fam = f * ((3 if shape.has_damping else 2) * 2
               + (3 if shape.has_breathing else 0)
               + (3 if shape.has_actuated else 0))
    caps = local_caps(shape)
    lc_stash = 3 * (caps[0] + 2 * caps[2] + 2 * caps[3])
    if shape.config.integrator is Integrator.RK2:
        lc_stash *= 2
    nbytes = 4 * n * (fam + F.local_slot_rows(caps) + lc_stash + 3 * 14
                      + 8 + 12)
    if shape.has_remainder:
        s = shape.n_springs
        nbytes += 4 * 2 * s * (n // 128 + 5 * 128) + 4 * s * 24
    if shape.has_magnets:
        nbytes += 8 * (n // 128) * 128 * 128 * 4
    return nbytes


# ---------------------------------------------------------------------------
# Step math on [.., N] tensors (titan_tpu/ops/adjoint.py:157-1200).
#
# ``P`` is a dict: k / rest / damping / bsign / bomega / aratedt / sstop
# [F, N]; minv / fixed / drag [1, N]; cf [3, N]; planes: list of
# (nx, ny, nz, off, fk, fs) scalars; plane_friction: per-plane bools;
# balls: list of (cx, cy, cz, rad); lc: the stacked local-constraint slots
# [L, N] (``forces.stage_local``) or None, and caps their capacities; dt;
# plus the static flags deltas, clamp, verlet, rk2, has_damping, has_drag,
# has_breathing, has_actuated and normal_coeff.
# ---------------------------------------------------------------------------

def torch_rolls():
    """(roll_gather, roll_scatter) along the last axis: ``rg(x, d)[n] =
    x[n + d]`` and its inverse (the JAX package's ``jnp_rolls`` on a flat
    axis)."""
    def rg(x, d):
        return torch.roll(x, -d, dims=-1)

    def rs(x, d):
        return torch.roll(x, d, dims=-1)

    return rg, rs


def _vdot3(a, b):
    return torch.sum(a * b, dim=0)


def _inv_len(d2):
    """Guarded 1/|d| and |d| from d2, sqrt + divide."""
    ln = torch.where(d2 > 0, torch.sqrt(torch.where(d2 > 0, d2, 1.0)), 0.0)
    inv = torch.where(ln > 0, 1.0 / torch.where(ln > 0, ln, 1.0), 0.0)
    return inv, ln


def _rest_eff(P, fi, t_now, cidx=None):
    """Per-family effective rest: the closed-form ACTUATED rest after
    ``cidx`` force calls, then the breathing scale
    rest * (1 + bsign sin(bomega t)).  A spring has at most one mechanism
    (aratedt = 0 on breathing springs, bsign = 0 on actuated ones)."""
    rest = P["rest"][fi]
    if P["has_actuated"]:
        rest = rest + (torch.clamp(P["sstop"][fi], max=cidx)
                       * P["aratedt"][fi])
    if P["has_breathing"]:
        rest = rest * (1.0 + P["bsign"][fi]
                       * torch.sin(P["bomega"][fi] * t_now))
    return rest


def _force(pos, vel, P, rg, rs, t_now=None, keep_stages=False, cidx=None,
           cf=None):
    """Full force evaluation (magnets, springs, planes, balls, local
    constraints, drag), the fused step's ``compute_forces``.  Returns (f,
    v, stages): v is the velocity the local constraints leave (what drag
    and the integrator read); with keep_stages, stages holds the force
    entering each plane and local contact plane (their friction selects
    read it), the (force, velocity) entering each constraint plane and
    direction, the final velocity and the per-family intermediates the
    transpose reuses.  The constant force is ``cf`` where given (a magnet
    scene's trace holds each pass's ``const_f + field``), else ``P["cf"]``
    plus, for a magnet scene (``P["mag"]``, the folded [5, N] parameters),
    the pairwise field at ``pos``, 0 on frozen masses, in the field
    kernel's order (``magnets.pairwise_field_lanes``)."""
    if cf is not None:
        f = cf + 0.0
    elif P.get("mag") is not None:
        f = P["cf"] + pairwise_field_lanes(pos, P["mag"], P["magnet_cutoff"]
                                           ) * (1.0 - P["fixed"])
    else:
        f = P["cf"] + 0.0
    fam = ({"inv": [], "cm": [], "ax": [], "ln": []} if keep_stages
           else None)
    for fi, d in enumerate(P["deltas"]):
        diff = rg(pos, d) - pos
        inv, ln = _inv_len(_vdot3(diff, diff))
        rest = _rest_eff(P, fi, t_now, cidx)
        axdot = None
        cm = P["k"][fi] * (rest - ln)
        if P["has_damping"]:
            axdot = _vdot3(vel - rg(vel, d), diff)
            cm = cm + (axdot * inv) * P["damping"][fi]
        fs_ = (cm * inv) * diff
        f = f - fs_ + rs(fs_, d)
        if fam is not None:
            fam["inv"].append(inv)
            fam["cm"].append(cm)
            fam["ax"].append(axdot)
            fam["ln"].append(ln)
    rem = None
    if P.get("rem") is not None:
        R = P["rem"]
        rem = F.remainder_eval(R, pos, vel, t_now, P["dt"], R["rest"],
                               _rem_flags(P), cidx)
        f = f + F.incidence_sum(R, (rem["cm"] * rem["inv"]) * rem["diff"])
    stages = ({"plane_in": [], "lcp_in": [], "lpl_in": [], "ldir_in": [],
               "fam": fam, "rem": rem} if keep_stages else None)
    for p, pp in enumerate(P["planes"]):
        if keep_stages:
            stages["plane_in"].append(f)
        f = _plane_fwd(f, pos, vel, pp, P["plane_friction"][p],
                       P["normal_coeff"])
    for bb in P["balls"]:
        f = _ball_fwd(f, pos, bb, P["normal_coeff"])
    v = vel
    if P.get("lc") is not None:
        f, v = F.local_slots(f, pos, v, P["lc"], P["caps"],
                             P["normal_coeff"], stages)
    if P["has_drag"]:
        vn = torch.sqrt(_vdot3(v, v))
        f = f - P["drag"] * vn * v
    if keep_stages:
        stages["v_final"] = v
    return f, v, stages


def _rem_flags(P):
    return P["has_damping"], P["has_breathing"], P["has_actuated"]


def _nvec(nx, ny, nz, like):
    """The plane normal as a [3, N] field shaped like ``like``."""
    return torch.stack([torch.as_tensor(c, dtype=like.dtype,
                                        device=like.device).expand_as(like)
                        for c in (nx, ny, nz)])


def _plane_fwd(f, pos, vel, pp, fric, normal_coeff):
    """One global contact plane (object.cu:76-109), as the fused step."""
    nx, ny, nz, off, fk, fs = pp
    disp = pos[0] * nx + pos[1] * ny + pos[2] * nz - off
    nvec = _nvec(nx, ny, nz, disp)
    inside = disp < 0
    if fric:
        fn_mag = f[0] * nx + f[1] * ny + f[2] * nz
        f_n = fn_mag * nvec
        has_fric = (fs > 0) | (fk > 0)
        vdotn = vel[0] * nx + vel[1] * ny + vel[2] * nz
        v_perp = vel - vdotn * nvec
        v_norm = torch.sqrt(_vdot3(v_perp, v_perp))
        kinetic = v_norm > 1e-16
        fn_abs = torch.abs(fn_mag)
        safe_vn = torch.where(kinetic, v_norm, 1.0)
        f_kin = f - v_perp * (fk * fn_abs / safe_vn)
        f_perp = f - f_n
        fp_norm = torch.sqrt(_vdot3(f_perp, f_perp))
        f_sta = torch.where(fs * fn_abs > fp_norm, f - f_perp, f)
        f_fric = torch.where(kinetic, f_kin, f_sta)
        f = torch.where(inside & has_fric, f_fric, f)
    contact = torch.where(inside, -disp * normal_coeff, 0.0)
    return f + contact * nvec


def _ball_fwd(f, pos, bb, normal_coeff):
    cx, cy, cz, rad = bb
    d0, d1, d2_ = pos[0] - cx, pos[1] - cy, pos[2] - cz
    dist = torch.sqrt(d0 * d0 + d1 * d1 + d2_ * d2_)
    safe = torch.where(dist > 0, dist, 1.0)
    # tensor / tensor: float / tensor would round twice (reciprocal, then
    # a product), unlike the kernel and the JAX package
    push = torch.where((dist <= rad) & (dist > 0),
                       safe.new_full((), normal_coeff) / safe, 0.0)
    return f + torch.stack([d0, d1, d2_]) * push


def _cidx(P, s_idx, call):
    """Force-call count for the closed-form ACTUATED rest: 1-based, two
    calls per RK2 step (rest advances on every force evaluation)."""
    if not P["has_actuated"]:
        return None
    base = 2.0 * s_idx if P["rk2"] else s_idx
    return base + call


def forward_step(pos, vel, acc_prev, P, rg, rs, t_now=None, s_idx=0.0):
    """One Euler, Verlet or RK2 step (the fused step's body with the
    closed-form actuated rest).  The constraint-mutated velocities feed
    the update: under RK2 pass 1's (vel1) the predictor and the corrector,
    pass 2's (vel2) the position.  Returns (pos2, vel2, acc)."""
    nf = 1.0 - P["fixed"]
    fx = P["fixed"]
    dt = P["dt"]
    if P["rk2"]:
        f1, vel1, _ = _force(pos, vel, P, rg, rs, t_now,
                             cidx=_cidx(P, s_idx, 1.0))
        acc1 = f1 * P["minv"]
        pos_h = (pos + 0.5 * vel1 * dt) * nf + pos * fx
        vel_h = (vel1 + 0.5 * acc1 * dt) * nf + vel1 * fx
        t_h = None if t_now is None else t_now + 0.5 * dt
        f2, vel2, _ = _force(pos_h, vel_h, P, rg, rs, t_h,
                             cidx=_cidx(P, s_idx, 2.0))
        acc = f2 * P["minv"]
        v2 = (vel1 + acc * dt) * nf + vel * fx
        pos2 = pos + vel2 * dt * nf
        return pos2, v2, acc * nf + acc_prev * fx
    f, vel_m, _ = _force(pos, vel, P, rg, rs, t_now,
                         cidx=_cidx(P, s_idx, 1.0))
    acc = f * P["minv"]
    if P["verlet"]:
        v2 = vel_m + 0.5 * (acc_prev + acc) * dt
        v2 = v2 * nf + vel * fx
        pos2 = pos + (v2 * dt + 0.5 * acc * dt * dt) * nf
    else:
        v2 = vel_m + acc * dt
        if P["clamp"]:
            vn = torch.sqrt(_vdot3(v2, v2))
            v2 = torch.where(vn > 1.0, v2 / torch.where(vn > 0, vn, 1.0), v2)
        v2 = v2 * nf + vel * fx
        pos2 = pos + v2 * dt * nf
    return pos2, v2, acc * nf + acc_prev * fx


def _bars_accumulate(dst, src):
    """dst += src for the per-force-pass gradient bars (RK2 runs two
    force transposes per step)."""
    for key, v in src.items():
        if key not in dst:
            dst[key] = v
        elif isinstance(v, list):
            dst[key] = [a + b for a, b in zip(dst[key], v)]
        else:
            dst[key] = dst[key] + v


def backward_step(pos, vel, gpos2, gvel2, gacc2, P, rg, rs, t_now=None,
                  s_idx=0.0, cfs=None):
    """Transpose of ``forward_step`` at primal (pos, vel): from the
    cotangents of (pos2, vel2, acc) to those of (pos, vel, acc_prev), plus
    the parameter bars of this step (titan_tpu/ops/adjoint.py:600-689).
    ``cfs`` are a magnet scene's per-pass constant forces from its trace
    (else each pass recomputes the field); the field's transpose
    (``_magnet_bars``) follows each pass's force transpose and adds to
    that pass's position cotangent, in the order the kernels add it."""
    nf = 1.0 - P["fixed"]
    fx = P["fixed"]
    dt = P["dt"]
    cf1, cf2 = tuple(cfs) + (None,) * (2 - len(cfs)) if cfs else (None, None)
    mag = P.get("mag") is not None
    if P["rk2"]:
        # two force passes per dt, each with its own transpose; the
        # midpoint is recomputed from the traced (pos, vel)
        c1, c2 = _cidx(P, s_idx, 1.0), _cidx(P, s_idx, 2.0)
        f1, vel1, st1 = _force(pos, vel, P, rg, rs, t_now, keep_stages=True,
                               cidx=c1, cf=cf1)
        acc1 = f1 * P["minv"]
        pos_h = (pos + 0.5 * vel1 * dt) * nf + pos * fx
        vel_h = (vel1 + 0.5 * acc1 * dt) * nf + vel1 * fx
        t_h = None if t_now is None else t_now + 0.5 * dt
        f2, _, st2 = _force(pos_h, vel_h, P, rg, rs, t_h, keep_stages=True,
                            cidx=c2, cf=cf2)
        # v2 = (vel1 + acc dt) nf + vel fx; pos2 = pos + vel2 dt nf;
        # acc_out = acc nf + acc_prev fx; each pass's velocity cotangent
        # (on its mutated vel1 / vel2) threads back through its own force
        # transpose
        gpos = gpos2 + 0.0
        gacc_prev = gacc2 * fx
        gvel2ct = gpos2 * (dt * nf)
        gvel1 = gvel2 * nf
        gvel0 = gvel2 * fx
        gacc = gacc2 * nf + gvel2 * (dt * nf)
        gf2 = gacc * P["minv"]
        minv_bar = torch.sum(gacc * f2, dim=0, keepdim=True)
        gpos_h, gv_h, bars = _force_transpose(pos_h, vel_h, gf2, gvel2ct,
                                              P, rg, rs, t_h, st2, cidx=c2)
        if mag:
            gpos_h = gpos_h + _magnet_bars(pos_h, bars["cf"], P, bars)
        # vel_h = (vel1 + 0.5 acc1 dt) nf + vel1 fx; pos_h likewise
        gvel1 = gvel1 + gv_h + gpos_h * (0.5 * dt * nf)
        gacc1 = gv_h * (0.5 * dt * nf)
        gpos = gpos + gpos_h
        gf1 = gacc1 * P["minv"]
        minv_bar = minv_bar + torch.sum(gacc1 * f1, dim=0, keepdim=True)
        gp_c, gv_c, bars1 = _force_transpose(pos, vel, gf1, gvel1, P, rg,
                                             rs, t_now, st1, cidx=c1)
        gpos = gpos + gp_c
        if mag:
            gpos = gpos + _magnet_bars(pos, bars1["cf"], P, bars1)
        _bars_accumulate(bars, bars1)
        bars["minv"] = minv_bar
        return gpos, gvel0 + gv_c, gacc_prev, bars

    c1 = _cidx(P, s_idx, 1.0)
    f_final, vel_m, st = _force(pos, vel, P, rg, rs, t_now, keep_stages=True,
                                cidx=c1, cf=cf1)
    acc = f_final * P["minv"]
    gpos = gpos2 + 0.0
    gv2 = gvel2 + gpos2 * (dt * nf)
    if P["verlet"]:
        gvel0 = gv2 * fx
        gvel_mut = gv2 * nf
        gacc_prev = gacc2 * fx + gv2 * (0.5 * dt * nf)
        gacc = (gacc2 * nf + gv2 * (0.5 * dt * nf)
                + gpos2 * (0.5 * dt * dt * nf))
    else:
        gacc_prev = gacc2 * fx
        gacc = gacc2 * nf
        gvel0 = gv2 * fx
        gv2c = gv2 * nf
        if P["clamp"]:
            v1 = vel_m + acc * dt
            vn2 = _vdot3(v1, v1)
            vn = torch.sqrt(torch.where(vn2 > 0, vn2, 1.0))
            over = (vn2 > 0) & (vn > 1.0)
            invn = 1.0 / vn
            dot_ = _vdot3(v1, gv2c)
            gv1 = torch.where(over,
                              invn * gv2c - ((invn * invn * invn) * dot_) * v1,
                              gv2c)
        else:
            gv1 = gv2c
        gvel_mut = gv1
        gacc = gacc + gv1 * dt
    gf = gacc * P["minv"]
    gp_c, gv_c, bars = _force_transpose(pos, vel, gf, gvel_mut, P, rg, rs,
                                        t_now, st, cidx=c1)
    bars["minv"] = torch.sum(gacc * f_final, dim=0, keepdim=True)
    gpos = gpos + gp_c
    if mag:
        gpos = gpos + _magnet_bars(pos, bars["cf"], P, bars)
    return gpos, gvel0 + gv_c, gacc_prev, bars


#: the magnet parameter gradients of one step, in the rows of the
#: kernels' [4, N] accumulator
MAG_BARS = ("mag_rad", "mag_stiffness", "mag_maxf", "mag_scale")


def _magnet_bars(pos, gf, P, bars):
    """Transpose of a force pass's magnet field at ``pos`` (the branch of
    titan_tpu/ops/adjoint.py:935-1017) for ``gf``, the pass's cotangent on
    its constant force (``bars["cf"]``; the field's is gf on movable
    masses): adds the [N] ``MAG_BARS`` to ``bars`` and returns the
    position cotangent.  ``P["mag_vjp"]`` where set (the tiled glue of a
    binned scene, ``magnets.binned_field_vjp``), else the pairwise
    transpose in the B5 kernel's order (``magnets.magnet_transpose_plain``)."""
    if P.get("mag_vjp") is not None:
        gp, g4 = P["mag_vjp"](pos, gf * (1.0 - P["fixed"]))
    else:
        gp, g4 = magnet_transpose_plain(pos, P["mag"], P["fixed"], gf,
                                        P["magnet_cutoff"])
    for key, g in zip(MAG_BARS, g4):
        bars[key] = g
    return gp


def _force_transpose(pos, vel, gf, gvel_mut, P, rg, rs, t_now, st,
                     cidx=None):
    """Transpose of ``_force`` at primal (pos, vel) for the cotangents
    ``gf`` (on the force) and ``gvel_mut`` (on the constraint-mutated
    velocity the integrator consumed): returns (gpos part, gvel part on
    the input velocity, parameter bars).  ``st`` is the matching
    ``_force(..., keep_stages=True)`` stages.  Legacy (sqrt + divide)
    branch of titan_tpu/ops/adjoint.py:692-1120."""
    gpos = torch.zeros_like(pos)
    bars = {}
    nc = P["normal_coeff"]
    gvel = gvel_mut + 0.0

    # ---- drag (reads the final mutated velocity) ----
    if P["has_drag"]:
        vF = st["v_final"]
        sq = _vdot3(vF, vF)
        vn = torch.sqrt(torch.where(sq > 0, sq, 1.0))
        vnm = torch.where(sq > 0, vn, 0.0)
        dotv = _vdot3(vF, gf)
        gvel = gvel - P["drag"] * (vnm * gf
                                   + torch.where(sq > 0, dotv / vn, 0.0)
                                   * vF)
        bars["drag"] = -(vnm * dotv)[None]

    # ---- local constraints (reverse slot order); afterwards gvel is the
    # cotangent on the input velocity ----
    if P.get("lc") is not None:
        gf, gvel, gpos = _local_transpose(pos, vel, gf, gvel, gpos, P, st)

    # ---- balls (reverse order); gf passes through ----
    for bb in reversed(P["balls"]):
        cx, cy, cz, rad = bb
        dvec = torch.stack([pos[0] - cx, pos[1] - cy, pos[2] - cz])
        dist = torch.sqrt(_vdot3(dvec, dvec))
        safe = torch.where(dist > 0, dist, 1.0)
        active = (dist <= rad) & (dist > 0)
        push = torch.where(active, safe.new_full((), nc) / safe, 0.0)
        gpush = _vdot3(dvec, gf)
        gdvec = push * gf
        gdist = torch.where(active, -nc * gpush / (safe * safe), 0.0)
        gdvec = gdvec + (gdist / safe) * dvec
        gpos = gpos + gdvec

    # ---- planes (reverse order) ----
    for p in range(len(P["planes"]) - 1, -1, -1):
        f_in = st["plane_in"][p]
        nx, ny, nz, off, fk, fs = P["planes"][p]
        disp = pos[0] * nx + pos[1] * ny + pos[2] * nz - off
        nvec = _nvec(nx, ny, nz, disp)
        inside = disp < 0
        gcontact = _vdot3(gf, nvec)
        gdisp = torch.where(inside, -nc * gcontact, 0.0)
        gpos = gpos + gdisp * nvec
        if P["plane_friction"][p]:
            fn_mag = f_in[0] * nx + f_in[1] * ny + f_in[2] * nz
            f_n = fn_mag * nvec
            has_fric = (fs > 0) | (fk > 0)
            vdotn = vel[0] * nx + vel[1] * ny + vel[2] * nz
            v_perp = vel - vdotn * nvec
            v_norm = torch.sqrt(_vdot3(v_perp, v_perp))
            kinetic = v_norm > 1e-16
            fn_abs = torch.abs(fn_mag)
            safe_vn = torch.where(kinetic, v_norm, 1.0)
            f_perp = f_in - f_n
            fp_norm = torch.sqrt(_vdot3(f_perp, f_perp))
            sta_hold = fs * fn_abs > fp_norm
            sel = inside & has_fric
            gf_fric = torch.where(sel, gf, 0.0)
            gf = torch.where(sel, 0.0, gf)
            gf, gvel = _friction_transpose(gf, gvel, gf_fric, nvec, vel,
                                           v_perp, v_norm, kinetic, fn_mag,
                                           fn_abs, safe_vn, sta_hold, fk)

    # ---- spring families (f_acc += -f + rs(f, d)) ----
    nfam = len(P["deltas"])
    gk, grest = [None] * nfam, [None] * nfam
    gdamp = [None] * nfam if P["has_damping"] else None
    gomega = [None] * nfam if P["has_breathing"] else None
    garate = [None] * nfam if P["has_actuated"] else None
    for fi, d in enumerate(P["deltas"]):
        diff = rg(pos, d) - pos
        rest_b = P["rest"][fi]
        advc = None
        if P["has_actuated"]:
            advc = torch.clamp(P["sstop"][fi], max=cidx)
            rest_b = rest_b + advc * P["aratedt"][fi]
        if P["has_breathing"]:
            # rest_eff = rest_b * scale, scale = 1 + bsign sin(bomega t)
            scale = 1.0 + P["bsign"][fi] * torch.sin(P["bomega"][fi] * t_now)
            rest = rest_b * scale
        else:
            scale = None
            rest = rest_b
        k = P["k"][fi]
        inv, ln = st["fam"]["inv"][fi], st["fam"]["ln"][fi]
        cm, ax = st["fam"]["cm"][fi], st["fam"]["ax"][fi]
        fbar = -gf + rg(gf, d)
        cbar = _vdot3(fbar, diff)
        dbar = (cm * inv) * fbar
        magbar = cbar * inv
        invbar = cbar * cm
        gk[fi] = magbar * (rest - ln)
        resteffbar = magbar * k
        lnbar = -magbar * k
        if P["has_damping"]:
            vr = rg(vel, d)
            dmp = P["damping"][fi]
            axialbar = magbar * dmp
            abar = axialbar * inv
            invbar = invbar + axialbar * ax
            gdamp[fi] = magbar * (ax * inv)
            dbar = dbar + abar * (vel - vr)
            gvel = gvel + abar * diff + rs(-(abar * diff), d)
        # inv = 1/ln (guarded); ln = sqrt(d2) (guarded)
        lnbar = lnbar - torch.where(ln > 0, invbar * inv * inv, 0.0)
        d2bar = torch.where(inv > 0, 0.5 * lnbar * inv, 0.0)
        if P["has_breathing"]:
            restbbar = resteffbar * scale
            scalebar = resteffbar * rest_b
            gomega[fi] = (scalebar * P["bsign"][fi]
                          * torch.cos(P["bomega"][fi] * t_now) * t_now)
        else:
            restbbar = resteffbar
        grest[fi] = restbbar
        if P["has_actuated"]:
            # rest_b = rest0 + advc aratedt (advc piecewise constant)
            garate[fi] = restbbar * advc
        dbar = dbar + 2.0 * diff * d2bar
        gpos = gpos - dbar + rs(dbar, d)
    if P.get("rem") is not None:
        gpos, gvel = _remainder_transpose(vel, gf, gpos, gvel, P, t_now,
                                          st["rem"], bars)
    bars["cf"] = gf
    bars["k"] = gk
    bars["rest"] = grest
    if P["has_damping"]:
        bars["damping"] = gdamp
    if P["has_breathing"]:
        bars["omega"] = gomega
    if P["has_actuated"]:
        bars["aratedt"] = garate
    return gpos, gvel, bars


def _remainder_transpose(vel, gf, gpos, gvel, P, t_now, e, bars):
    """Transpose of the remainder springs' sum in ``_force`` (the families'
    transpose on per-spring arrays; titan_tpu/ops/adjoint.py:1121-1182) at
    its intermediates ``e`` (``forces.remainder_eval``): each spring's
    force cotangent is gf at its right end less gf at its left, and its
    position and velocity cotangents go to both ends through the incidence
    rows, in row order (``forces.incidence_sum``), as the backward kernels
    add them.  Adds the per-spring bars k_e, rest_e (, damp_e, omega_e,
    aratedt_e) [S] to ``bars``; returns (gpos, gvel)."""
    R = P["rem"]
    p = R["p"]
    left, right = R["ends"][0].long(), R["ends"][1].long()
    diff, inv, ln, cm = e["diff"], e["inv"], e["ln"], e["cm"]
    fbar = gf[:, right] - gf[:, left]
    cbar = _vdot3(fbar, diff)
    dbar = (cm * inv) * fbar
    magbar = cbar * inv
    invbar = cbar * cm
    bars["k_e"] = magbar * (e["rest"] - ln)
    resteffbar = magbar * p[0]
    lnbar = -magbar * p[0]
    if P["has_damping"]:
        ax = e["ax"]
        axialbar = magbar * p[1]
        abar = axialbar * inv
        invbar = invbar + axialbar * ax
        bars["damp_e"] = magbar * (ax * inv)
        dbar = dbar + abar * (vel[:, left] - vel[:, right])
        gvel = gvel + F.incidence_sum(R, abar * diff, -1.0)
    lnbar = lnbar - torch.where(ln > 0, invbar * inv * inv, 0.0)
    d2bar = torch.where(inv > 0, 0.5 * lnbar * inv, 0.0)
    dbar = dbar + 2.0 * diff * d2bar
    restbbar = resteffbar
    if P["has_breathing"]:
        restbbar = resteffbar * e["scale"]
        bars["omega_e"] = (resteffbar * e["rest_b"] * p[2]
                           * torch.cos(p[3] * t_now) * t_now)
    bars["rest_e"] = restbbar
    if P["has_actuated"]:
        bars["aratedt_e"] = restbbar * e["advc"]
    return gpos + F.incidence_sum(R, dbar), gvel


def _local_transpose(pos, vel, gf, gv, gpos, P, st):
    """Transpose of ``forces.local_slots`` in reverse order (directions,
    constraint planes, balls, contact planes; titan_tpu/ops/adjoint.py:
    718-860) for the force cotangent ``gf`` and the running velocity
    cotangent ``gv``; adds the balls' and contact planes' position parts to
    ``gpos``.  Returns (gf, gv, gpos): gf on the force entering the local
    block, gv on the input velocity."""
    lc, caps, nc = P["lc"], P["caps"], P["normal_coeff"]
    ball_base = 7 * caps[0]
    pl_base = ball_base + 5 * caps[1]
    dir_base = pl_base + 5 * caps[2]
    for idx in reversed(range(caps[3])):               # directions
        o = dir_base + 5 * idx
        act = lc[o] > 0.5
        tvec, fric = lc[o + 1:o + 4], lc[o + 4]
        f_in, v_in = st["ldir_in"][idx]
        nfv = f_in - tvec * _vdot3(f_in, tvec)
        v_norm = torch.sqrt(_vdot3(v_in, v_in))
        moving = v_norm >= 1e-16
        nf_norm = torch.sqrt(_vdot3(nfv, nfv))
        # v_out = where(act & moving, t dot(v_in, t), v_in)
        selv = act & moving
        gtd = torch.where(selv, gv, 0.0)
        gv = torch.where(selv, 0.0, gv) + tvec * _vdot3(tvec, gtd)
        # f_out = where(act, where(moving, f3, f2), f_in);
        # f3 = f2 - |nfv| fric t;  f2 = f_in - nfv
        gf3 = torch.where(act & moving, gf, 0.0)
        gf2 = gf3 + torch.where(act & ~moving, gf, 0.0)
        gf_keep = torch.where(~act, gf, 0.0)
        gnf_norm = -fric * _vdot3(tvec, gf3)
        gnfv = (torch.where(nf_norm > 0,
                            gnf_norm / torch.where(nf_norm > 0, nf_norm, 1.0),
                            0.0) * nfv - gf2)
        gf = gf_keep + gf2 + (gnfv - tvec * _vdot3(tvec, gnfv))
    for idx in reversed(range(caps[2])):               # constraint planes
        o = pl_base + 5 * idx
        act = lc[o] > 0.5
        nvec, fric = lc[o + 1:o + 4], lc[o + 4]
        f_in, v_in = st["lpl_in"][idx]
        nf_ = _vdot3(f_in, nvec)
        v_norm = torch.sqrt(_vdot3(v_in, v_in))
        moving = v_norm >= 1e-16
        v2c = v_in - nvec * _vdot3(v_in, nvec)
        safe = torch.where(moving, v_norm, 1.0)
        # v_out = where(act & moving, v2c, v_in)
        selv = act & moving
        gv2c = torch.where(selv, gv, 0.0)
        gv = torch.where(selv, 0.0, gv)
        # f_out = where(act, where(moving, f3, f2), f_in);
        # f3 = f2 - fric nf v2c / safe;  f2 = f_in - n nf
        gf3 = torch.where(act & moving, gf, 0.0)
        gf2 = gf3 + torch.where(act & ~moving, gf, 0.0)
        gf_keep = torch.where(~act, gf, 0.0)
        s = fric / safe
        gnf = -s * _vdot3(v2c, gf3)
        gv2c = gv2c - (s * nf_) * gf3
        gsafe = fric * nf_ * _vdot3(v2c, gf3) / (safe * safe)
        gv_norm = torch.where(moving, gsafe, 0.0)
        gv = gv + gv2c - nvec * _vdot3(nvec, gv2c)
        gv = gv + (torch.where(v_norm > 0,
                               gv_norm / torch.where(v_norm > 0, v_norm, 1.0),
                               0.0) * v_in)
        gnf = gnf - _vdot3(nvec, gf2)
        gf = gf_keep + gf2 + gnf * nvec
    for idx in reversed(range(caps[1])):               # balls
        o = ball_base + 5 * idx
        act = lc[o] > 0.5
        dvec = pos - lc[o + 1:o + 4]
        dist = torch.sqrt(_vdot3(dvec, dvec))
        safe = torch.where(dist > 0, dist, 1.0)
        hit = (dist <= lc[o + 4]) & (dist > 0)
        push = torch.where(hit, safe.new_full((), nc) / safe, 0.0)
        # f_out = f_in + where(act, dvec push, 0)
        geff = torch.where(act, gf, 0.0)
        gpush = _vdot3(dvec, geff)
        gdvec = push * geff
        gdist = torch.where(hit, -nc * gpush / (safe * safe), 0.0)
        gpos = gpos + (gdvec + (gdist / safe) * dvec)
    for idx in reversed(range(caps[0])):               # contact planes
        o = 7 * idx
        act = lc[o] > 0.5
        nvec = lc[o + 1:o + 4]
        off, fk, fs = lc[o + 4], lc[o + 5], lc[o + 6]
        f_in = st["lcp_in"][idx]
        # contact planes precede every velocity mutation: their friction
        # reads the input velocity
        disp = _vdot3(pos, nvec) - off
        inside = disp < 0
        fn_mag = _vdot3(f_in, nvec)
        has_fric = (fs > 0) | (fk > 0)
        v_perp = vel - _vdot3(vel, nvec) * nvec
        v_norm = torch.sqrt(_vdot3(v_perp, v_perp))
        kinetic = v_norm > 1e-16
        fn_abs = torch.abs(fn_mag)
        safe_vn = torch.where(kinetic, v_norm, 1.0)
        f_perp = f_in - fn_mag * nvec
        fp_norm = torch.sqrt(_vdot3(f_perp, f_perp))
        sta_hold = fs * fn_abs > fp_norm
        # f_out = where(act, f_new, f_in)
        gnew = torch.where(act, gf, 0.0)
        gf = torch.where(~act, gf, 0.0)
        # + where(inside, -disp nc, 0) n
        gdisp = torch.where(inside, -nc * _vdot3(gnew, nvec), 0.0)
        gpos = gpos + gdisp * nvec
        # f_new = where(inside & has_fric, f_fric, f_in)
        sel = inside & has_fric
        gf_fric = torch.where(sel, gnew, 0.0)
        gf = gf + torch.where(sel, 0.0, gnew)
        gf, gv = _friction_transpose(gf, gv, gf_fric, nvec, vel, v_perp,
                                     v_norm, kinetic, fn_mag, fn_abs,
                                     safe_vn, sta_hold, fk)
    return gf, gv, gpos


def _friction_transpose(gf, gv, gf_fric, nvec, vel, v_perp, v_norm, kinetic,
                        fn_mag, fn_abs, safe_vn, sta_hold, fk):
    """Transpose of a contact plane's friction select f_fric = where(
    kinetic, f - v_perp fk |f_n| / |v_perp|, where(hold, f - f_perp, f))
    for its cotangent ``gf_fric``: adds the parts on the entering force to
    ``gf`` and on the velocity to ``gv``."""
    gf_kin = torch.where(kinetic, gf_fric, 0.0)
    gf_sta = torch.where(kinetic, 0.0, gf_fric)
    # f_sta = where(hold, f - f_perp, f)
    gf = gf + gf_sta
    gf_perp = torch.where(sta_hold, -gf_sta, 0.0)
    # f_perp = f - f_n
    gf = gf + gf_perp
    gf_n = -gf_perp
    # f_kin = f - v_perp * s,  s = fk fn_abs / safe_vn
    gf = gf + gf_kin
    s = fk * fn_abs / safe_vn
    gs = -_vdot3(v_perp, gf_kin)
    gv_perp = -s * gf_kin
    gfn_abs = fk * gs / safe_vn
    gsafe_vn = -fk * fn_abs * gs / (safe_vn * safe_vn)
    gv_norm = torch.where(kinetic, gsafe_vn, 0.0)
    gv_perp = gv_perp + torch.where(v_norm > 0, gv_norm / safe_vn,
                                    0.0) * v_perp
    # v_perp = vel - (vel . n) n
    gv = gv + gv_perp
    gvdotn = -_vdot3(nvec, gv_perp)
    gv = gv + gvdotn * nvec
    # f_n = fn_mag n; fn_abs = |fn_mag|; fn_mag = dot(f, n)
    gfn_mag = _vdot3(gf_n, nvec) + torch.sign(fn_mag) * gfn_abs
    return gf + gfn_mag * nvec, gv


# ---------------------------------------------------------------------------
# Staging (titan_tpu/ops/adjoint.py:1576-1658)
# ---------------------------------------------------------------------------

def _actuation_inputs(state: SimState, pair_ok):
    """Closed-form actuation inputs: the signed per-call rest advance
    ``aratedt`` and the call count ``sstop`` at which the one-sided bound
    is crossed (invalid pairs never actuate, sim.cu:1163).  [F, N] f32."""
    stc = state.stencil
    styp = stc.type
    arate = torch.where(styp == ACTUATED_EXPAND, stc.rate,
                        torch.where(styp == ACTUATED_CONTRACT, -stc.rate,
                                    0.0))
    arate = torch.where(pair_ok, arate, 0.0).float()
    aratedt = arate * state.dt.float()
    abound = torch.where(
        styp == ACTUATED_EXPAND, stc.l_max,
        torch.where(styp == ACTUATED_CONTRACT, stc.l_min, 0.0)).float()
    nz = aratedt != 0
    sstop = torch.where(
        nz, torch.ceil((abound - stc.rest.float())
                       / torch.where(nz, aratedt, 1.0)), 0.0)
    return aratedt, torch.clamp(sstop, min=0.0)


def _prep(shape: SceneShape, state: SimState, inv: dict = None) -> dict:
    """The math's ``P`` from the fused step's own staging
    (``prep_invariants``, or ``inv`` where the caller has it): the
    backward differentiates exactly that physics."""
    if inv is None:
        inv = prep_invariants(shape, state)
    cfg = shape.config
    P = {
        "deltas": shape.stencil_deltas, "k": inv["k_eff"],
        "rest": state.stencil.rest, "minv": inv["minv"],
        "fixed": inv["fixed"], "cf": inv["const_f"],
        "planes": [tuple(inv["planes"][p, c] for c in range(6))
                   for p in range(shape.n_planes)],
        "plane_friction": shape.plane_friction,
        "balls": [tuple(inv["balls"][b, c] for c in range(4))
                  for b in range(shape.n_balls)],
        "dt": inv["scal"][0], "t0": inv["scal"][1],
        "clamp": cfg.velocity_clamp,
        "verlet": cfg.integrator is Integrator.VERLET,
        "rk2": cfg.integrator is Integrator.RK2,
        "has_damping": shape.has_damping, "has_drag": shape.has_drag,
        "has_breathing": shape.has_breathing,
        "has_actuated": shape.has_actuated,
        "normal_coeff": cfg.normal_coeff,
        "damping": inv["damp_eff"] if shape.has_damping else None,
        "drag": state.masses.drag[None, :] if shape.has_drag else None,
        "bsign": inv["bsign"] if shape.has_breathing else None,
        "bomega": inv["bomega"] if shape.has_breathing else None,
        "aratedt": None, "sstop": None, "pair_ok": inv["pair_ok"],
        "lc": inv.get("lc"), "caps": local_caps(shape),
        "rem": inv.get("rem"),
    }
    if shape.has_actuated:
        P["aratedt"], P["sstop"] = _actuation_inputs(state, inv["pair_ok"])
    if shape.has_magnets:
        P["mag"] = pairwise_params(state.masses)
        P["magnet_cutoff"] = cfg.magnet_cutoff
    return P


# ---------------------------------------------------------------------------
# The two kernels' plain versions, and their dispatch
# ---------------------------------------------------------------------------

def trace_run_plain(shape: SceneShape, state: SimState, seg: int,
                    field=None):
    """Plain version of the trace kernel (``build_trace_run`` :1661):
    replays ``seg`` steps of the fused chunk and returns each step's input
    (pos_t, vel_t), with a magnet scene's per-pass constant forces, as a
    trace [seg, trace_rows, N].  ``field`` is ``fused_chunk_plain``'s (the
    card's checks feed the kernel's field, to hold the step bitwise)."""
    from .fused_step import fused_chunk_plain
    trace = []
    fused_chunk_plain(shape, state, seg, trace=trace, field=field)
    return torch.stack(trace)


def _bar_keys(shape: SceneShape) -> list:
    """The per-family gradient keys of ``bwd_run`` for a scene."""
    return (["k", "rest"] + ["damping"] * shape.has_damping
            + ["omega"] * shape.has_breathing
            + ["aratedt"] * shape.has_actuated)


def rem_bar_keys(shape: SceneShape) -> list:
    """The per-spring gradient keys of ``bwd_run`` for a scene, in the
    rows of the backward kernels' [5, S] accumulator: k_e, rest_e, damp_e,
    omega_e, aratedt_e (the last three where the scene has the feature)."""
    if not shape.has_remainder:
        return []
    return (["k_e", "rest_e"] + ["damp_e"] * shape.has_damping
            + ["omega_e"] * shape.has_breathing
            + ["aratedt_e"] * shape.has_actuated)


def bwd_run_plain(shape: SceneShape, state: SimState, trace, gpos, gvel,
                  gacc, inv: dict = None) -> dict:
    """Plain version of the backward kernel (``build_bwd_run`` :1716):
    the reverse sweep of ``backward_step`` over ``trace`` from the
    cotangents (gpos, gvel, gacc) of the segment's output.  Returns the
    cotangents of its input (pos, vel, acc) and the parameter gradients:
    k, rest (, damping, omega, aratedt) [F, N], cf [3, N], minv (, drag)
    [N], the remainder springs' k_e, rest_e (, damp_e, omega_e, aratedt_e)
    [S] (``rem_bar_keys``), plus ``pair_ok`` (and ``rem_ok``).  ``inv``
    is ``prep_invariants(shape, state)`` where the caller has it
    already."""
    return sweep_plain(shape, _prep(shape, state, inv), trace, gpos, gvel,
                       gacc)


def sweep_plain(shape: SceneShape, P: dict, trace, gpos, gvel,
                gacc) -> dict:
    """The reverse sweep of ``backward_step`` with the step math's inputs
    ``P`` (``bwd_run_plain``; the tiled adjoint passes the tiled step's
    staging)."""
    rg, rs = torch_rolls()
    seg = trace.shape[0]
    acc = {}
    mag = P.get("mag") is not None
    for t in range(seg - 1, -1, -1):
        t_now = P["t0"] + t * P["dt"]
        cfs = cf_rows(trace, t)
        gpos, gvel, gacc, bars = backward_step(
            trace[t, :3], trace[t, 3:6], gpos, gvel, gacc, P, rg, rs, t_now,
            s_idx=float(t), cfs=cfs)
        for key in _bar_keys(shape):
            b = torch.stack(bars[key])
            acc[key] = acc[key] + b if key in acc else b
        if mag:
            b = torch.stack([bars[k] for k in MAG_BARS])
            acc["mag"] = acc["mag"] + b if "mag" in acc else b
        for key in (["cf", "minv"] + ["drag"] * shape.has_drag
                    + rem_bar_keys(shape)):
            acc[key] = acc[key] + bars[key] if key in acc else bars[key]
    g = {"pos": gpos, "vel": gvel, "acc": gacc, "pair_ok": P["pair_ok"]}
    if shape.has_remainder:
        g["rem_ok"] = P["rem"]["ok"]
    g.update({k: v for k, v in acc.items() if k not in ("minv", "drag")})
    g["minv"] = acc["minv"][0]
    if shape.has_drag:
        g["drag"] = acc["drag"][0]
    return g


def _lib():
    from .. import _build
    from .fused_step import _PassArgs
    lib = _build.load("adjoint")
    lib.titan_adjoint_trace.argtypes = [ctypes.POINTER(_ChunkArgs),
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.titan_adjoint_trace.restype = ctypes.c_int
    lib.titan_adjoint_trace_pass.argtypes = [ctypes.POINTER(_ChunkArgs),
                                             ctypes.POINTER(_PassArgs),
                                             ctypes.c_void_p]
    lib.titan_adjoint_trace_pass.restype = ctypes.c_int
    lib.titan_adjoint_bwd.argtypes = [ctypes.POINTER(_BwdArgs),
                                      ctypes.c_void_p]
    lib.titan_adjoint_bwd.restype = ctypes.c_int
    lib.titan_adjoint_bwd_kernel_info.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.titan_adjoint_bwd_kernel_info.restype = ctypes.c_int
    lib.titan_adjoint_trace_kernel_info.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.titan_adjoint_trace_kernel_info.restype = ctypes.c_int
    return lib


def trace_path(shape: SceneShape) -> str:
    """The replay's kernel on the card, a rule of the scene alone: "plain"
    on the plain-spring path (``takes_plain_spring_path``: the forward's
    plain-spring step with the trace stored, at 128 threads a block),
    else "general" (the general body, 256).  Either way one launch per
    force pass; a magnet scene's field kernels run between the passes."""
    return "plain" if takes_plain_spring_path(shape) else "general"


def trace_launch_count(shape: SceneShape, seg: int) -> tuple:
    """(launches, launches on the plain-spring loop) of one segment's
    replay of ``seg`` steps: one per force pass, two a step under RK2."""
    n = seg * (2 if shape.config.integrator is Integrator.RK2 else 1)
    return n, n if trace_path(shape) == "plain" else 0


def trace_kernel_info(shape: SceneShape) -> dict:
    """What the replay's kernel of ``shape`` (``trace_path``, its
    remainder instantiation where the scene has remainder springs)
    launches with on the current card: threads a block, registers and
    local-memory bytes a thread, co-resident blocks an SM and blocks in
    the grid."""
    out = (ctypes.c_int * 5)()
    rc = _lib().titan_adjoint_trace_kernel_info(
        int(trace_path(shape) == "plain"), int(shape.has_remainder),
        shape.n_masses, torch.cuda.current_device(), out)
    if rc != 0:
        raise RuntimeError(f"trace_kernel_info: CUDA error {rc}")
    return dict(threads=out[0], registers=out[1], local_bytes=out[2],
                blocks_per_sm=out[3], grid=out[4])


def _trace_run_cuda(shape: SceneShape, state: SimState, seg: int, inv):
    lib = _lib()
    a, keep = _chunk_args(shape, state, seg, inv)
    rows = trace_rows(shape)
    try:
        trace = torch.empty((seg, rows, shape.n_masses), dtype=torch.float32,
                            device=state.masses.pos.device)
    except torch.OutOfMemoryError as e:
        mib = seg * rows * shape.n_masses * 4 >> 20
        raise torch.OutOfMemoryError(
            f"the adjoint's {seg}-step trace ({mib} MiB) does not fit on the "
            f"card; a shorter segment makes it smaller: {e}") from e
    stream = torch.cuda.current_stream(trace.device).cuda_stream
    if shape.has_magnets:
        # the forward's passes (fused_step._magnet_passes), each with the
        # replay kernel and its constant force kept in the trace
        plain = int(trace_path(shape) == "plain")

        def run(p):
            rc = lib.titan_adjoint_trace_pass(ctypes.byref(a),
                                              ctypes.byref(p), stream)
            if rc != 0:
                raise RuntimeError(f"adjoint trace kernel launch failed: "
                                   f"CUDA error {rc}")
            trace_run.launches += 1
            trace_run.plain_launches += plain
        _magnet_passes(shape, state, seg, keep[0],
                       magnet_field_fn(shape, state, plain=False), run,
                       trace=trace)
        return trace
    rc = lib.titan_adjoint_trace(ctypes.byref(a), trace.data_ptr(), stream)
    del keep     # freed on this stream: reused only by later work on it
    if rc != 0:
        raise RuntimeError(f"adjoint trace kernel launch failed: CUDA error "
                           f"{rc}")
    launches, on_loop = trace_launch_count(shape, seg)
    trace_run.launches += launches
    trace_run.plain_launches += on_loop
    return trace


def trace_run(shape: SceneShape, state: SimState, seg: int,
              inv: dict = None):
    """The segment's trace [seg, trace_rows, N]: the CUDA trace kernel for
    state on the card (a magnet scene replays the forward's passes, each
    field kernel's field with the replay kernel), ``trace_run_plain`` for
    state on the CPU.  ``inv`` is ``prep_invariants(shape, state)`` where
    the caller has it already (the kernel reads it).  The route is
    ``trace_path(shape)``; ``trace_run.launches`` counts the replay
    kernel's launches (``trace_launch_count``), ``trace_run.plain_launches``
    those on the plain-spring loop."""
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return trace_run_plain(shape, state, seg)
    if dev.type != "cuda":
        raise ValueError(f"trace_run: state on {dev}; expected cpu or cuda")
    return _trace_run_cuda(shape, state, seg, inv)


trace_run.launches = 0
trace_run.plain_launches = 0


class _BwdArgs(ctypes.Structure):
    """Mirror of ``struct BwdChunkArgs`` in ``csrc/adjoint.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "nf", "n_planes", "n_balls", "seg", "integrator", "clamp",
        "has_damping", "has_breathing", "has_actuated", "has_drag",
        "device")]
        + [("normal_coeff", ctypes.c_float), ("np", ctypes.c_int),
           ("cutoff", ctypes.c_float)]
        + [(f, ctypes.c_void_p) for f in (
            "deltas", "scal", "planes", "balls", "cforce", "minv", "fixed",
            "k", "rest", "damping", "bsign", "bomega", "aratedt", "sstop",
            "drag", "trace", "gpos_in", "gvel_in", "gacc_in", "gpos",
            "gvel", "gacc", "gk", "grest", "gdamp", "gomega", "garate",
            "gcf", "gminv", "gdrag", "gf", "gpc", "gvc", "pos_h",
            "vel_h", "grem", "mag", "gmag")]
        + [("local", _LocalSlots), ("rem", _Remainder)]
        + [(f, ctypes.c_void_p) for f in ("gf_odd", "kscal", "bits")])


def bwd_launch_count(shape: SceneShape, seg: int) -> tuple:
    """(launches, launches on the plain-spring loop) of one segment's
    backward sweep of ``seg`` steps.  The general body: two a step, five
    under RK2 (the midpoint, then the force and spring phases of pass 2
    and of pass 1).  The plain-spring path
    (``fused_step.takes_plain_spring_path``) without magnets folds the
    phases that only a mass's own data joins into one launch: seg + 1
    (each launch step t's spring phase, then step t - 1's force phase),
    under RK2 3 seg + 1 (the last step's midpoint, then a step's pass-2
    force phase, its pass-2 spring and pass-1 force phases, its pass-1
    spring phase and step t - 1's midpoint); with magnets, whose transpose
    reads every mass's gf between the phases, the general body's
    count."""
    rk2 = shape.config.integrator is Integrator.RK2
    plain = takes_plain_spring_path(shape)
    if plain and not shape.has_magnets:
        n = 3 * seg + 1 if rk2 else seg + 1
    else:
        n = seg * (5 if rk2 else 2)
    return n, n if plain else 0


#: bwd_kernel_info's kernel names and the C entry's numbers
BWD_KERNELS = {"force": 1, "spring": 2, "mid": 3, "fold": 4, "fold_rk2": 5}


def bwd_kernel_info(kernel: str, shape: SceneShape) -> dict:
    """What one kernel of the fused backward launches with on the current
    card as ``shape``'s sweep launches it: threads a block, registers and
    local-memory bytes a thread, its co-resident blocks an SM.
    ``kernel``: a ``BWD_KERNELS`` name ("fold" and "fold_rk2" are the
    folded sweep's launches of a plain-spring scene without magnets); the
    instantiation (plain-spring, remainder) and the block (the folded
    sweep's or the unfolded one's) are the scene's."""
    plain = takes_plain_spring_path(shape)
    fold = plain and not shape.has_magnets
    out = (ctypes.c_int * 4)()
    rc = _lib().titan_adjoint_bwd_kernel_info(
        BWD_KERNELS[kernel], int(plain), int(fold), int(shape.has_remainder),
        torch.cuda.current_device(), out)
    if rc != 0:
        raise RuntimeError(f"bwd_kernel_info: CUDA error {rc}")
    return dict(threads=out[0], registers=out[1], local_bytes=out[2],
                blocks_per_sm=out[3])


def magnet_args(a, shape: SceneShape, state: SimState, g: dict, empty,
                kernel: str) -> list:
    """Set a backward's magnet fields (``BwdChunkArgs`` /
    ``TiledBwdArgs``): the trace's rows and, for a magnet scene, the cutoff,
    the folded parameters and the [4, N] gradient accumulator, which
    becomes ``g["mag"]``.  Returns the tensors the launch reads."""
    a.np = trace_rows(shape)
    if not shape.has_magnets:
        return []
    n = shape.n_masses
    prm = pairwise_params(state.masses)
    a.cutoff = float(shape.config.magnet_cutoff)
    a.mag = _checked("magnet params", prm, (5, n), kernel=kernel)
    g["mag"] = empty((4, n))
    a.gmag = g["mag"].data_ptr()
    return [prm]


def rem_bars(shape: SceneShape, empty) -> tuple:
    """(the backward kernels' [5, S] per-spring accumulator, {key: its
    row}) for ``rem_bar_keys(shape)``; (None, {}) without remainder
    springs.  Rows k_e, rest_e, damp_e, omega_e, aratedt_e: the kernels
    write a row only where the scene has its feature."""
    if not shape.has_remainder:
        return None, {}
    grem = empty((5, shape.n_springs))
    rows = dict(k_e=0, rest_e=1, damp_e=2, omega_e=3, aratedt_e=4)
    return grem, {k: grem[rows[k]] for k in rem_bar_keys(shape)}


def _bwd_run_cuda(shape: SceneShape, state: SimState, trace, gpos, gvel,
                  gacc, inv) -> dict:
    lib = _lib()
    cfg = shape.config
    m = state.masses
    dev = m.pos.device
    n, nf = shape.n_masses, len(shape.stencil_deltas)
    seg = int(trace.shape[0])
    if inv is None:
        inv = prep_invariants(shape, state)
    deltas = deltas_on(shape.stencil_deltas, dev)
    vec, fam = (3, n), (nf, n)
    empty = lambda s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    keys = _bar_keys(shape)
    g = {"pos": empty(vec), "vel": empty(vec), "acc": empty(vec),
         "cf": empty(vec), "minv": empty((n,))}
    g.update({k: empty(fam) for k in keys})
    if shape.has_drag:
        g["drag"] = empty((n,))
    plain = takes_plain_spring_path(shape)
    fold = plain and not shape.has_magnets
    # gf, gpc, gvc, pos_h, vel_h (and the folded sweep's second gf)
    scratch = [empty(vec) for _ in range(5 + fold)]

    a = _BwdArgs()
    a.n, a.nf, a.seg = n, nf, seg
    a.n_planes, a.n_balls = shape.n_planes, shape.n_balls
    a.integrator = {Integrator.EULER: 0, Integrator.VERLET: 1,
                    Integrator.RK2: 2}[cfg.integrator]
    a.clamp = int(cfg.velocity_clamp)
    a.has_damping, a.has_breathing = int(shape.has_damping), int(shape.has_breathing)
    a.has_actuated, a.has_drag = int(shape.has_actuated), int(shape.has_drag)
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    a.normal_coeff = float(cfg.normal_coeff)
    a.deltas = _checked("deltas", deltas, (nf,), torch.int32)
    a.scal = _checked("scal", inv["scal"], (2,))
    a.planes = _checked("planes", inv["planes"], (max(shape.n_planes, 1), 6))
    a.balls = _checked("balls", inv["balls"], (max(shape.n_balls, 1), 4))
    a.cforce = _checked("const_f", inv["const_f"], vec)
    a.minv = _checked("minv", inv["minv"], (1, n))
    a.fixed = _checked("fixed", inv["fixed"], (1, n))
    a.k = _checked("k", inv["k_eff"], fam)
    a.rest = _checked("rest", state.stencil.rest, fam)
    keep = [inv]
    if shape.has_damping:
        a.damping = _checked("damping", inv["damp_eff"], fam)
    if shape.has_breathing:
        a.bsign = _checked("bsign", inv["bsign"], fam)
        a.bomega = _checked("bomega", inv["bomega"], fam)
    if shape.has_actuated:
        aratedt, sstop = _actuation_inputs(state, inv["pair_ok"])
        a.aratedt = _checked("aratedt", aratedt, fam)
        a.sstop = _checked("sstop", sstop, fam)
        keep += [aratedt, sstop]
    if shape.has_drag:
        a.drag = _checked("drag", m.drag, (n,))
    keep += magnet_args(a, shape, state, g, empty, "adjoint")
    a.trace = _checked("trace", trace, (seg, a.np, n))
    a.gpos_in = _checked("gpos", gpos, vec)
    a.gvel_in = _checked("gvel", gvel, vec)
    a.gacc_in = _checked("gacc", gacc, vec)
    a.gpos, a.gvel, a.gacc = (g[k].data_ptr() for k in ("pos", "vel", "acc"))
    a.gk, a.grest = g["k"].data_ptr(), g["rest"].data_ptr()
    for key, field in (("damping", "gdamp"), ("omega", "gomega"),
                       ("aratedt", "garate"), ("drag", "gdrag")):
        if key in g:
            setattr(a, field, g[key].data_ptr())
    a.gcf, a.gminv = g["cf"].data_ptr(), g["minv"].data_ptr()
    a.gf, a.gpc, a.gvc, a.pos_h, a.vel_h = (t.data_ptr()
                                            for t in scratch[:5])
    if plain:
        # the replay's, where it ran on this inv (_chunk_args)
        kscal, bits = ((inv["kscal"], inv["bits"]) if "bits" in inv
                       else bits_k(shape, state, inv))
        a.kscal = _checked("kscal", kscal, (nf,), kernel="adjoint")
        a.bits = _checked("bits", bits, (n,), torch.int32, kernel="adjoint")
        keep += [kscal, bits]
    if fold:
        a.gf_odd = scratch[5].data_ptr()
    a.local = local_struct(shape, inv)
    a.rem = remainder_struct(shape, inv, closed=True)
    grem, rem_g = rem_bars(shape, empty)
    if grem is not None:
        a.grem = grem.data_ptr()
        g.update(rem_g, rem_ok=inv["rem"]["ok"])

    rc = lib.titan_adjoint_bwd(ctypes.byref(a),
                               torch.cuda.current_stream(dev).cuda_stream)
    del keep, scratch   # freed on this stream: reused only by later work
    if rc != 0:
        raise RuntimeError(f"adjoint backward kernel launch failed: CUDA "
                           f"error {rc}")
    passes = 2 if cfg.integrator is Integrator.RK2 else 1
    launches, on_loop = bwd_launch_count(shape, seg)
    bwd_run.launches += launches
    bwd_run.plain_launches += on_loop
    if shape.has_magnets:
        bwd_run.mag_launches += seg * passes
    g["pair_ok"] = inv["pair_ok"]
    return g


def bwd_run(shape: SceneShape, state: SimState, trace, gpos, gvel,
            gacc, inv: dict = None) -> dict:
    """The reverse sweep over ``trace``: the CUDA backward kernel for
    state on the card, ``bwd_run_plain`` for state on the CPU (the same
    keys).  ``inv`` is ``prep_invariants(shape, state)`` where the caller
    has it already.  ``bwd_run.launches`` counts the step kernels'
    launches (``bwd_launch_count``), ``bwd_run.plain_launches`` those on
    the plain-spring loop, ``bwd_run.mag_launches`` the magnet
    transpose's (B5: one per force pass of a magnet scene)."""
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return bwd_run_plain(shape, state, trace, gpos, gvel, gacc, inv)
    if dev.type != "cuda":
        raise ValueError(f"bwd_run: state on {dev}; expected cpu or cuda")
    return _bwd_run_cuda(shape, state, trace, gpos, gvel, gacc, inv)


bwd_run.launches = 0
bwd_run.plain_launches = 0
bwd_run.mag_launches = 0


# ---------------------------------------------------------------------------
# The autograd segment and the public rollout
# ---------------------------------------------------------------------------

#: the differentiable leaves of a state, in the order a segment takes them:
#: masses, stencil families, remainder springs (``springs.<name>``), g
MASS_LEAVES = ("pos", "vel", "acc", "extern_force", "m", "drag", "mag_rad",
               "mag_stiffness", "mag_maxf", "mag_scale")
STENCIL_LEAVES = ("k", "rest", "damping", "omega", "rate")
SPRING_LEAVES = ("k", "rest", "damping", "omega", "rate")
LEAVES = (MASS_LEAVES + STENCIL_LEAVES
          + tuple(f"springs.{k}" for k in SPRING_LEAVES) + ("g",))


def leaves_of(state: SimState) -> list:
    """The differentiable tensors of ``state`` in ``LEAVES`` order."""
    return ([getattr(state.masses, k) for k in MASS_LEAVES]
            + [getattr(state.stencil, k) for k in STENCIL_LEAVES]
            + [getattr(state.springs, k) for k in SPRING_LEAVES]
            + [state.g])


def with_leaves(state: SimState, leaves) -> SimState:
    """``state`` with its differentiable tensors replaced by ``leaves``
    (``LEAVES`` order)."""
    nm, ns, nr = len(MASS_LEAVES), len(STENCIL_LEAVES), len(SPRING_LEAVES)
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(
            state.masses, **dict(zip(MASS_LEAVES, leaves[:nm]))),
        stencil=dataclasses.replace(
            state.stencil, **dict(zip(STENCIL_LEAVES, leaves[nm:nm + ns]))),
        springs=dataclasses.replace(
            state.springs,
            **dict(zip(SPRING_LEAVES, leaves[nm + ns:nm + ns + nr]))),
        g=leaves[nm + ns + nr])


def segment_outputs(shape: SceneShape, out: SimState) -> tuple:
    """What a segment ``Function`` returns: pos, vel, acc, the stencil and
    the remainder rest (differentiable), then T and t (not).  A rest the
    chunk passed through is copied, so that no input is returned as an
    output."""
    def rest(r):
        return r if shape.has_actuated else r.clone()
    return (out.masses.pos, out.masses.vel, out.masses.acc,
            rest(out.stencil.rest), rest(out.springs.rest), out.masses.T,
            out.t)


def state_from_outputs(state: SimState, outs) -> SimState:
    """The state after a segment from its ``Function``'s outputs."""
    pos, vel, acc, rest, rem_rest, T, t = outs
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel, acc=acc,
                                   T=T),
        stencil=dataclasses.replace(state.stencil, rest=rest),
        springs=dataclasses.replace(state.springs, rest=rem_rest), t=t)


def _rate_ct(g_aratedt, sstop, ct_rest, seg, shape, styp, dt, ok):
    """d loss / d rate of ACTUATED springs: rate acts through aratedt =
    sign rate dt, in the backward's accumulated ``g_aratedt`` and in the
    closed-form rest the segment outputs, whose cotangent ``ct_rest``
    reaches aratedt times min(calls, sstop)."""
    calls = (2.0 * seg if shape.config.integrator is Integrator.RK2
             else float(seg))
    g = g_aratedt + torch.clamp(sstop, max=calls) * ct_rest
    sign = torch.where(styp == ACTUATED_EXPAND, 1.0,
                       torch.where(styp == ACTUATED_CONTRACT, -1.0, 0.0))
    return torch.where(ok, sign * dt * g, 0.0)


def assemble_ct(shape: SceneShape, seg: int, s0: SimState, ct_rest,
                ct_rem_rest, g: dict) -> dict:
    """Map the backward's gradient dict ``g`` onto the segment's
    differentiable inputs (titan_tpu/ops/adjoint.py:1835-1962), given
    ``ct_rest`` and ``ct_rem_rest``, the cotangents of the segment's output
    stencil and remainder rest.  ``m`` gets gradients through minv = 1/m
    and through cf = extern + m g; ``g`` through cf; ``rate`` through
    aratedt = sign rate dt and through the closed-form rest the segment
    outputs.  The k, damping and rate of a missing or invalid spring get
    0, as in the JAX package (``pair_ok``, ``rem_ok``).  Leaves with no
    gradient map to None."""
    m0 = s0.masses
    ok = g["pair_ok"]
    dt = s0.dt.float()
    out = dict.fromkeys(LEAVES)
    out["pos"], out["vel"], out["acc"] = g["pos"], g["vel"], g["acc"]
    out["extern_force"] = g["cf"]
    out["m"] = (torch.sum(s0.g[:, None] * g["cf"], dim=0)
                - g["minv"] / (m0.m * m0.m))
    if shape.has_drag:
        out["drag"] = g["drag"]
    if shape.has_magnets:
        # the staging folds validity into the parameters, so an invalid
        # mass's have no effect (titan_tpu/ops/adjoint.py:1850-1863)
        for key, gm in zip(MAG_BARS, g["mag"]):
            out[key] = torch.where(m0.valid, gm, 0.0)
    out["k"] = torch.where(ok, g["k"], 0.0)
    out["rest"] = ct_rest + g["rest"]
    if shape.has_damping:
        out["damping"] = torch.where(ok, g["damping"], 0.0)
    if shape.has_breathing:
        out["omega"] = g["omega"]
    if shape.has_actuated:
        _, sstop = _actuation_inputs(s0, ok)
        out["rate"] = _rate_ct(g["aratedt"], sstop, ct_rest, seg, shape,
                               s0.stencil.type, dt, ok)
    out["springs.rest"] = ct_rem_rest
    if shape.has_remainder:
        rok = g["rem_ok"]
        out["springs.k"] = torch.where(rok, g["k_e"], 0.0)
        out["springs.rest"] = ct_rem_rest + g["rest_e"]
        if shape.has_damping:
            out["springs.damping"] = torch.where(rok, g["damp_e"], 0.0)
        if shape.has_breathing:
            out["springs.omega"] = g["omega_e"]
        if shape.has_actuated:
            sstop_e = F.stage_remainder(shape, s0)["p"][7]
            out["springs.rate"] = _rate_ct(g["aratedt_e"], sstop_e,
                                           ct_rem_rest, seg, shape,
                                           s0.springs.type, dt, rok)
    out["g"] = torch.sum(m0.m[None, :] * g["cf"], dim=1)
    return out


class _AdjointSegment(torch.autograd.Function):
    """One segment: the fused chunk forward, trace + reverse-sweep
    backward."""

    @staticmethod
    def forward(ctx, shape, seg, state, *leaves):
        out = fused_chunk(shape, with_leaves(state, leaves), seg)
        ctx.shape, ctx.seg, ctx.state = shape, seg, state
        ctx.save_for_backward(*leaves)
        outs = segment_outputs(shape, out)
        ctx.mark_non_differentiable(*outs[-2:])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, gpos, gvel, gacc, grest, grem, _gT, _gt):
        shape, seg = ctx.shape, ctx.seg
        s0 = with_leaves(ctx.state, ctx.saved_tensors)
        inv = prep_invariants(shape, s0)     # read by both passes
        trace = trace_run(shape, s0, seg, inv)
        g = bwd_run(shape, s0, trace, gpos.contiguous(), gvel.contiguous(),
                    gacc.contiguous(), inv)
        del trace        # the segment's trace is freed before the next one
        ct = assemble_ct(shape, seg, s0, grest, grem, g)
        return (None, None, None) + tuple(ct[k] for k in LEAVES)


def default_segment(n_steps: int) -> int:
    """The largest divisor of ``n_steps`` that is <= 128 (the trace holds
    segment x 6 x N floats; one state is kept per segment)."""
    return next(s for s in range(min(n_steps, 128), 0, -1)
                if n_steps % s == 0)


def adjoint_rollout(shape: SceneShape, state: SimState, n_steps: int,
                    segment: Optional[int] = None) -> SimState:
    """Differentiable rollout whose forward and backward both run the
    port's kernels on the card (module docstring).  Residual memory is one
    input state per segment plus, during the backward, one trace of
    ``segment`` steps.  Gradients are the exact transpose of the fused
    step's physics for the differentiable inputs listed in the module
    docstring.  A scene outside ``adjoint_supported`` raises;
    ``diff.grad_rollout`` routes it to the tiled adjoint or
    ``fast_rollout``."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    seg = segment or default_segment(n_steps)
    if n_steps % seg != 0:
        raise ValueError(f"segment {seg} does not divide n_steps {n_steps}")
    r = adjoint_reject_reason(shape)
    if r is not None:
        raise ValueError(f"scene outside the adjoint kernel envelope: {r}")
    for _ in range(n_steps // seg):
        state = state_from_outputs(state, _AdjointSegment.apply(
            shape, seg, state, *leaves_of(state)))
    return state
