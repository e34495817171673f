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
anything else raises.

The math below is the JAX package's, as plain functions on [.., N]
tensors with a roll pair (``rg`` reads index n + d, ``rs`` is its
inverse; ``torch_rolls``), in the sqrt + divide form that the CPU and
``fused_step.cu`` compute.  The adjoint of a step recomputes the step's
forward from the traced (pos, vel) and transposes it: integrator, drag,
balls, planes (static and kinetic friction), then the spring families.

ACTUATED rest is evaluated in closed form in the transpose (after c force
calls, rest_c = rest0 + min(c, s_stop) arate dt), as the JAX package does,
while the forward and the replay advance it step by step; the two differ
by about 1e-7 relative.

Differentiable inputs: masses.pos, vel, acc, extern_force, m, drag,
stencil.k, rest, damping, omega, rate, and g.  dt, plane and ball
geometry, t and the actuation bounds get no gradient.

Envelope (``adjoint_reject_reason``): the fused step's, without magnets
and without spring-less scenes.  A trace that does not fit on the card
raises out-of-memory in the backward; a shorter ``segment`` makes it
smaller.  Remainder springs and local constraints wait for the fused step's
envelope to grow, the magnet branches for a later slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..config import ACTUATED_CONTRACT, ACTUATED_EXPAND, Integrator
from ..state import SceneShape, SimState
from .fused_step import (_ChunkArgs, _chunk_args, _checked, deltas_on,
                         fused_chunk, fused_reject_reason, prep_invariants)


def adjoint_reject_reason(shape: SceneShape):
    """None if the adjoint kernels accept this scene, else why not: the
    fused step's envelope, less magnet scenes and scenes without stencil
    families.  The fused step takes both, but the adjoint's transpose has
    no magnet branch yet (``titan_tpu/ops/adjoint.py:282-300``, :935), so
    its gradients would leave the magnet term out.  Memory is no part of
    it: a trace too large for the card raises ``torch.OutOfMemoryError``
    when the backward allocates it (``trace_run``), as the JAX package's
    staging fails cleanly.  ``diff.grad_route`` reads the reference's
    residency rule (``adjoint_resident_bytes``) to choose between this
    adjoint and the tiled one."""
    if shape.has_magnets:
        return ("magnets: the adjoint kernels have no magnet branch yet "
                "(ROADMAP B4/B5)")
    if not shape.stencil_deltas:
        return "no stencil spring families"
    return fused_reject_reason(shape)


def adjoint_supported(shape: SceneShape) -> bool:
    return adjoint_reject_reason(shape) is None


def adjoint_resident_bytes(shape: SceneShape) -> int:
    """Bytes the TPU's fused adjoint would hold resident in VMEM for this
    scene: the port's copy of ``titan_tpu/ops/adjoint.py:107-137``, the
    rule by which the reference sends a gradient to its tiled adjoint
    (budget ``ops/step.py::RESIDENT_BUDGET``, 100 MB, as the JAX package's
    ``_VMEM_BUDGET``).  The remainder, local-constraint and magnet terms
    are left out, as ``ops/step.py::resident_bytes`` leaves them out: the
    fused adjoint refuses those scenes before this rule is read.  Per
    mass: the per-family parameters in and their gradient accumulators
    out, the carries, two trace slots and ~10 vec3 temporaries."""
    n, f = shape.n_masses, len(shape.stencil_deltas)
    fam = f * ((3 if shape.has_damping else 2) * 2
               + (3 if shape.has_breathing else 0)
               + (3 if shape.has_actuated else 0))
    return 4 * n * (fam + 3 * 14 + 8 + 12)


# ---------------------------------------------------------------------------
# Step math on [.., N] tensors (titan_tpu/ops/adjoint.py:157-1200).
#
# ``P`` is a dict: k / rest / damping / bsign / bomega / aratedt / sstop
# [F, N]; minv / fixed / drag [1, N]; cf [3, N]; planes: list of
# (nx, ny, nz, off, fk, fs) scalars; plane_friction: per-plane bools;
# balls: list of (cx, cy, cz, rad); dt; plus the static flags deltas,
# clamp, verlet, rk2, has_damping, has_drag, has_breathing, has_actuated
# and normal_coeff.
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


def _force(pos, vel, P, rg, rs, t_now=None, keep_stages=False, cidx=None):
    """Full force evaluation (springs, planes, balls, drag), the fused
    step's ``compute_forces``.  Returns (f, stages): with keep_stages,
    stages holds the force entering each plane (its friction selects read
    it) and the per-family intermediates the transpose reuses."""
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
    stages = {"plane_in": [], "fam": fam} if keep_stages else None
    for p, pp in enumerate(P["planes"]):
        if keep_stages:
            stages["plane_in"].append(f)
        f = _plane_fwd(f, pos, vel, pp, P["plane_friction"][p],
                       P["normal_coeff"])
    for bb in P["balls"]:
        f = _ball_fwd(f, pos, bb, P["normal_coeff"])
    if P["has_drag"]:
        vn = torch.sqrt(_vdot3(vel, vel))
        f = f - P["drag"] * vn * vel
    return f, stages


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
    closed-form actuated rest).  Returns (pos2, vel2, acc)."""
    nf = 1.0 - P["fixed"]
    fx = P["fixed"]
    dt = P["dt"]
    if P["rk2"]:
        f1, _ = _force(pos, vel, P, rg, rs, t_now, cidx=_cidx(P, s_idx, 1.0))
        acc1 = f1 * P["minv"]
        pos_h = (pos + 0.5 * vel * dt) * nf + pos * fx
        vel_h = (vel + 0.5 * acc1 * dt) * nf + vel * fx
        t_h = None if t_now is None else t_now + 0.5 * dt
        f2, _ = _force(pos_h, vel_h, P, rg, rs, t_h,
                       cidx=_cidx(P, s_idx, 2.0))
        acc = f2 * P["minv"]
        v2 = (vel + acc * dt) * nf + vel * fx
        pos2 = pos + vel_h * dt * nf
        return pos2, v2, acc * nf + acc_prev * fx
    f, _ = _force(pos, vel, P, rg, rs, t_now, cidx=_cidx(P, s_idx, 1.0))
    acc = f * P["minv"]
    if P["verlet"]:
        v2 = vel + 0.5 * (acc_prev + acc) * dt
        v2 = v2 * nf + vel * fx
        pos2 = pos + (v2 * dt + 0.5 * acc * dt * dt) * nf
    else:
        v2 = vel + acc * dt
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
                  s_idx=0.0):
    """Transpose of ``forward_step`` at primal (pos, vel): from the
    cotangents of (pos2, vel2, acc) to those of (pos, vel, acc_prev), plus
    the parameter bars of this step (titan_tpu/ops/adjoint.py:600-689)."""
    nf = 1.0 - P["fixed"]
    fx = P["fixed"]
    dt = P["dt"]
    if P["rk2"]:
        # two force passes per dt, each with its own transpose; the
        # midpoint is recomputed from the traced (pos, vel)
        c1, c2 = _cidx(P, s_idx, 1.0), _cidx(P, s_idx, 2.0)
        f1, st1 = _force(pos, vel, P, rg, rs, t_now, keep_stages=True,
                         cidx=c1)
        acc1 = f1 * P["minv"]
        pos_h = (pos + 0.5 * vel * dt) * nf + pos * fx
        vel_h = (vel + 0.5 * acc1 * dt) * nf + vel * fx
        t_h = None if t_now is None else t_now + 0.5 * dt
        f2, st2 = _force(pos_h, vel_h, P, rg, rs, t_h, keep_stages=True,
                         cidx=c2)
        # v2 = (vel + acc dt) nf + vel fx; pos2 = pos + vel_h dt nf;
        # acc_out = acc nf + acc_prev fx
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
        # vel_h = (vel + 0.5 acc1 dt) nf + vel fx; pos_h likewise
        gvel1 = gvel1 + gv_h + gpos_h * (0.5 * dt * nf)
        gacc1 = gv_h * (0.5 * dt * nf)
        gpos = gpos + gpos_h
        gf1 = gacc1 * P["minv"]
        minv_bar = minv_bar + torch.sum(gacc1 * f1, dim=0, keepdim=True)
        gp_c, gv_c, bars1 = _force_transpose(pos, vel, gf1, gvel1, P, rg,
                                             rs, t_now, st1, cidx=c1)
        _bars_accumulate(bars, bars1)
        bars["minv"] = minv_bar
        return gpos + gp_c, gvel0 + gv_c, gacc_prev, bars

    c1 = _cidx(P, s_idx, 1.0)
    f_final, st = _force(pos, vel, P, rg, rs, t_now, keep_stages=True,
                         cidx=c1)
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
            v1 = vel + acc * dt
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
    return gpos + gp_c, gvel0 + gv_c, gacc_prev, bars


def _force_transpose(pos, vel, gf, gvel_mut, P, rg, rs, t_now, st,
                     cidx=None):
    """Transpose of ``_force`` at primal (pos, vel) for the cotangents
    ``gf`` (on the force) and ``gvel_mut`` (on the velocity the
    integrator consumed): returns (gpos part, gvel part, parameter bars).
    ``st`` is the matching ``_force(..., keep_stages=True)`` stages.
    Legacy (sqrt + divide) branch of titan_tpu/ops/adjoint.py:692-1120."""
    gpos = torch.zeros_like(pos)
    bars = {}
    nc = P["normal_coeff"]
    gvel = gvel_mut + 0.0

    # ---- drag ----
    if P["has_drag"]:
        sq = _vdot3(vel, vel)
        vn = torch.sqrt(torch.where(sq > 0, sq, 1.0))
        vnm = torch.where(sq > 0, vn, 0.0)
        dotv = _vdot3(vel, gf)
        gvel = gvel - P["drag"] * (vnm * gf
                                   + torch.where(sq > 0, dotv / vn, 0.0)
                                   * vel)
        bars["drag"] = -(vnm * dotv)[None]

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
            gf1 = gf
            gf_fric = torch.where(sel, gf1, 0.0)
            gf = torch.where(sel, 0.0, gf1)
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
            # v_perp = vel - vdotn n
            gvel = gvel + gv_perp
            gvdotn = -_vdot3(nvec, gv_perp)
            gvel = gvel + gvdotn * nvec
            # f_n = fn_mag n; fn_abs = |fn_mag|; fn_mag = dot(f, n)
            gfn_mag = _vdot3(gf_n, nvec) + torch.sign(fn_mag) * gfn_abs
            gf = gf + gfn_mag * nvec

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
    }
    if shape.has_actuated:
        P["aratedt"], P["sstop"] = _actuation_inputs(state, inv["pair_ok"])
    return P


# ---------------------------------------------------------------------------
# The two kernels' plain versions, and their dispatch
# ---------------------------------------------------------------------------

def trace_run_plain(shape: SceneShape, state: SimState, seg: int):
    """Plain version of the trace kernel (``build_trace_run`` :1661):
    replays ``seg`` steps of the fused chunk and returns each step's input
    (pos_t, vel_t) as a trace [seg, 6, N]."""
    from .fused_step import fused_chunk_plain
    trace = []
    fused_chunk_plain(shape, state, seg, trace=trace)
    return torch.stack(trace)


def _bar_keys(shape: SceneShape) -> list:
    """The per-family gradient keys of ``bwd_run`` for a scene."""
    return (["k", "rest"] + ["damping"] * shape.has_damping
            + ["omega"] * shape.has_breathing
            + ["aratedt"] * shape.has_actuated)


def bwd_run_plain(shape: SceneShape, state: SimState, trace, gpos, gvel,
                  gacc, inv: dict = None) -> dict:
    """Plain version of the backward kernel (``build_bwd_run`` :1716):
    the reverse sweep of ``backward_step`` over ``trace`` from the
    cotangents (gpos, gvel, gacc) of the segment's output.  Returns the
    cotangents of its input (pos, vel, acc) and the parameter gradients:
    k, rest (, damping, omega, aratedt) [F, N], cf [3, N], minv (, drag)
    [N], plus ``pair_ok``.  ``inv`` is ``prep_invariants(shape, state)``
    where the caller has it already."""
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
    for t in range(seg - 1, -1, -1):
        t_now = P["t0"] + t * P["dt"]
        gpos, gvel, gacc, bars = backward_step(
            trace[t, :3], trace[t, 3:], gpos, gvel, gacc, P, rg, rs, t_now,
            s_idx=float(t))
        for key in _bar_keys(shape):
            b = torch.stack(bars[key])
            acc[key] = acc[key] + b if key in acc else b
        for key in ["cf", "minv"] + ["drag"] * shape.has_drag:
            acc[key] = acc[key] + bars[key] if key in acc else bars[key]
    g = {"pos": gpos, "vel": gvel, "acc": gacc, "pair_ok": P["pair_ok"]}
    g.update({k: v for k, v in acc.items() if k not in ("minv", "drag")})
    g["minv"] = acc["minv"][0]
    if shape.has_drag:
        g["drag"] = acc["drag"][0]
    return g


def _lib():
    from .. import _build
    lib = _build.load("adjoint")
    lib.titan_adjoint_trace.argtypes = [ctypes.POINTER(_ChunkArgs),
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.titan_adjoint_trace.restype = ctypes.c_int
    lib.titan_adjoint_bwd.argtypes = [ctypes.POINTER(_BwdArgs),
                                      ctypes.c_void_p]
    lib.titan_adjoint_bwd.restype = ctypes.c_int
    return lib


def _trace_run_cuda(shape: SceneShape, state: SimState, seg: int, inv):
    lib = _lib()
    a, keep = _chunk_args(shape, state, seg, inv)
    try:
        trace = torch.empty((seg, 6, shape.n_masses), dtype=torch.float32,
                            device=state.masses.pos.device)
    except torch.OutOfMemoryError as e:
        mib = seg * 6 * shape.n_masses * 4 >> 20
        raise torch.OutOfMemoryError(
            f"the adjoint's {seg}-step trace ({mib} MiB) does not fit on the "
            f"card; a shorter segment makes it smaller: {e}") from e
    rc = lib.titan_adjoint_trace(
        ctypes.byref(a), trace.data_ptr(),
        torch.cuda.current_stream(trace.device).cuda_stream)
    del keep     # freed on this stream: reused only by later work on it
    if rc != 0:
        raise RuntimeError(f"adjoint trace kernel launch failed: CUDA error "
                           f"{rc}")
    trace_run.launches += seg * (2 if shape.config.integrator
                                 is Integrator.RK2 else 1)
    return trace


def trace_run(shape: SceneShape, state: SimState, seg: int,
              inv: dict = None):
    """The segment's trace [seg, 6, N]: the CUDA trace kernel for state on
    the card, ``trace_run_plain`` for state on the CPU.  ``inv`` is
    ``prep_invariants(shape, state)`` where the caller has it already (the
    kernel reads it).  ``trace_run.launches`` counts the kernel launches
    (one per step, two for RK2)."""
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return trace_run_plain(shape, state, seg)
    if dev.type != "cuda":
        raise ValueError(f"trace_run: state on {dev}; expected cpu or cuda")
    return _trace_run_cuda(shape, state, seg, inv)


trace_run.launches = 0


class _BwdArgs(ctypes.Structure):
    """Mirror of ``struct BwdChunkArgs`` in ``csrc/adjoint.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "nf", "n_planes", "n_balls", "seg", "integrator", "clamp",
        "has_damping", "has_breathing", "has_actuated", "has_drag",
        "device")]
        + [("normal_coeff", ctypes.c_float)]
        + [(f, ctypes.c_void_p) for f in (
            "deltas", "scal", "planes", "balls", "cforce", "minv", "fixed",
            "k", "rest", "damping", "bsign", "bomega", "aratedt", "sstop",
            "drag", "trace", "gpos_in", "gvel_in", "gacc_in", "gpos",
            "gvel", "gacc", "gk", "grest", "gdamp", "gomega", "garate",
            "gcf", "gminv", "gdrag", "gf", "gpc", "gvc", "pos_h",
            "vel_h")])


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
    scratch = [empty(vec) for _ in range(5)]     # gf, gpc, gvc, pos_h, vel_h

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
    a.trace = _checked("trace", trace, (seg, 6, n))
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
    a.gf, a.gpc, a.gvc, a.pos_h, a.vel_h = (t.data_ptr() for t in scratch)

    rc = lib.titan_adjoint_bwd(ctypes.byref(a),
                               torch.cuda.current_stream(dev).cuda_stream)
    del keep, scratch   # freed on this stream: reused only by later work
    if rc != 0:
        raise RuntimeError(f"adjoint backward kernel launch failed: CUDA "
                           f"error {rc}")
    bwd_run.launches += seg * (5 if cfg.integrator is Integrator.RK2 else 2)
    g["pair_ok"] = inv["pair_ok"]
    return g


def bwd_run(shape: SceneShape, state: SimState, trace, gpos, gvel,
            gacc, inv: dict = None) -> dict:
    """The reverse sweep over ``trace``: the CUDA backward kernel for
    state on the card, ``bwd_run_plain`` for state on the CPU (the same
    keys).  ``inv`` is ``prep_invariants(shape, state)`` where the caller
    has it already.  ``bwd_run.launches`` counts the kernel launches (two
    per step, five for RK2)."""
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return bwd_run_plain(shape, state, trace, gpos, gvel, gacc, inv)
    if dev.type != "cuda":
        raise ValueError(f"bwd_run: state on {dev}; expected cpu or cuda")
    return _bwd_run_cuda(shape, state, trace, gpos, gvel, gacc, inv)


bwd_run.launches = 0


# ---------------------------------------------------------------------------
# The autograd segment and the public rollout
# ---------------------------------------------------------------------------

#: the differentiable leaves of a state, in the order a segment takes them
MASS_LEAVES = ("pos", "vel", "acc", "extern_force", "m", "drag")
STENCIL_LEAVES = ("k", "rest", "damping", "omega", "rate")
LEAVES = MASS_LEAVES + STENCIL_LEAVES + ("g",)


def leaves_of(state: SimState) -> list:
    """The differentiable tensors of ``state`` in ``LEAVES`` order."""
    return ([getattr(state.masses, k) for k in MASS_LEAVES]
            + [getattr(state.stencil, k) for k in STENCIL_LEAVES]
            + [state.g])


def with_leaves(state: SimState, leaves) -> SimState:
    """``state`` with its differentiable tensors replaced by ``leaves``
    (``LEAVES`` order)."""
    nm, ns = len(MASS_LEAVES), len(STENCIL_LEAVES)
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(
            state.masses, **dict(zip(MASS_LEAVES, leaves[:nm]))),
        stencil=dataclasses.replace(
            state.stencil, **dict(zip(STENCIL_LEAVES, leaves[nm:nm + ns]))),
        g=leaves[nm + ns])


def segment_outputs(shape: SceneShape, out: SimState) -> tuple:
    """What a segment ``Function`` returns: pos, vel, acc, stencil rest
    (differentiable), then T and t (not).  A rest the chunk passed through
    is copied, so that no input is returned as an output."""
    rest = out.stencil.rest if shape.has_actuated else out.stencil.rest.clone()
    return (out.masses.pos, out.masses.vel, out.masses.acc, rest,
            out.masses.T, out.t)


def state_from_outputs(state: SimState, outs) -> SimState:
    """The state after a segment from its ``Function``'s outputs."""
    pos, vel, acc, rest, T, t = outs
    return dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel, acc=acc,
                                   T=T),
        stencil=dataclasses.replace(state.stencil, rest=rest), t=t)


def assemble_ct(shape: SceneShape, seg: int, s0: SimState, ct_rest,
                g: dict) -> dict:
    """Map the backward's gradient dict ``g`` onto the segment's
    differentiable inputs (titan_tpu/ops/adjoint.py:1835-1900, stencil
    part), given ``ct_rest``, the cotangent of the segment's output rest.
    ``m`` gets gradients through minv = 1/m and through cf = extern + m g;
    ``g`` through cf; ``rate`` through aratedt = sign rate dt and through
    the closed-form rest the segment outputs.  Leaves with no gradient
    map to None."""
    m0 = s0.masses
    ok = g["pair_ok"]
    out = dict.fromkeys(LEAVES)
    out["pos"], out["vel"], out["acc"] = g["pos"], g["vel"], g["acc"]
    out["extern_force"] = g["cf"]
    out["m"] = (torch.sum(s0.g[:, None] * g["cf"], dim=0)
                - g["minv"] / (m0.m * m0.m))
    if shape.has_drag:
        out["drag"] = g["drag"]
    out["k"] = torch.where(ok, g["k"], 0.0)
    out["rest"] = ct_rest + g["rest"]
    if shape.has_damping:
        out["damping"] = torch.where(ok, g["damping"], 0.0)
    if shape.has_breathing:
        out["omega"] = g["omega"]
    if shape.has_actuated:
        _, sstop = _actuation_inputs(s0, ok)
        calls = (2.0 * seg if shape.config.integrator is Integrator.RK2
                 else float(seg))
        g_aratedt = g["aratedt"] + torch.clamp(sstop, max=calls) * ct_rest
        styp = s0.stencil.type
        sign = torch.where(styp == ACTUATED_EXPAND, 1.0,
                           torch.where(styp == ACTUATED_CONTRACT, -1.0, 0.0))
        out["rate"] = torch.where(ok, sign * s0.dt.float() * g_aratedt, 0.0)
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
        ctx.mark_non_differentiable(outs[4], outs[5])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, gpos, gvel, gacc, grest, _gT, _gt):
        shape, seg = ctx.shape, ctx.seg
        s0 = with_leaves(ctx.state, ctx.saved_tensors)
        inv = prep_invariants(shape, s0)     # read by both passes
        trace = trace_run(shape, s0, seg, inv)
        g = bwd_run(shape, s0, trace, gpos.contiguous(), gvel.contiguous(),
                    gacc.contiguous(), inv)
        del trace        # the segment's trace is freed before the next one
        ct = assemble_ct(shape, seg, s0, grest, g)
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
    docstring; scenes outside ``adjoint_supported`` use
    ``diff.fast_rollout``."""
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
