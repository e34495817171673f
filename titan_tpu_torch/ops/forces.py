"""Force computation: springs, scatter, global constraints.

Counterpart of ``titan_tpu/ops/forces.py`` for the subset on the port's
path.  All functions are pure: they consume and produce ``[3, N]``
component-major tensors and never write into their inputs.  Norms are
sqrt + divide, as the JAX package computes them on the CPU
(``titan_tpu/ops/forces.py::use_rsqrt``), and every norm goes through
``_safe_norm`` so that autograd through the step stays finite.  Local
constraints and SEGMENT scatter are later slices of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import (ACTIVE_CONTRACT_THEN_EXPAND, ACTIVE_EXPAND_THEN_CONTRACT,
                      ACTUATED_CONTRACT, ACTUATED_EXPAND, ScatterMode)
from ..state import GlobalConstraints, MassState, SpringState, Topology

Tensor = torch.Tensor


def _safe_norm(sq: Tensor) -> Tensor:
    """sqrt of a sum of squares, gradient-safe at 0
    (``titan_tpu/ops/forces.py::_safe_norm``).  d sqrt / dx is infinite at
    0, and a ``torch.where`` that masks the value afterwards still sends
    inf * 0 = NaN back in reverse mode; guarding the operand keeps the
    forward values bitwise the same and the gradient zero there."""
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def _inv_norm(length: Tensor) -> Tensor:
    """1 / length, 0 where length == 0 (zero-length springs exert nothing)."""
    return torch.where(length > 0,
                       1.0 / torch.where(length > 0, length, 1.0), 0.0)


def _breathe_and_actuate(rest, styp, omega, l_max, l_min, rate, ok, t, dt):
    """(scale, new rest) of breathing / actuated springs (reference
    computeSpringForces, sim.cu:1166-1181): ACTIVE_* scale the rest length
    by 1 -/+ 0.2 sin(omega t); ACTUATED_* move rest at ``rate`` while it is
    short of l_max / above l_min.  Invalid springs never actuate
    (sim.cu:1163 returns before the rest mutation)."""
    sin_wt = torch.sin(omega * t)
    scale = torch.where(
        styp == ACTIVE_CONTRACT_THEN_EXPAND, 1.0 - 0.2 * sin_wt,
        torch.where(styp == ACTIVE_EXPAND_THEN_CONTRACT, 1.0 + 0.2 * sin_wt,
                    1.0))
    rest = torch.where(
        ok & (styp == ACTUATED_EXPAND) & (rest < l_max), rest + rate * dt,
        torch.where(ok & (styp == ACTUATED_CONTRACT) & (rest > l_min),
                    rest - rate * dt, rest))
    return scale, rest


def spring_forces(masses: MassState, springs: SpringState, t: Tensor,
                  dt: Tensor, has_breathing: bool) -> Tuple[Tensor, Tensor]:
    """Per-spring Hooke + axial damping force, plus actuation (reference
    computeSpringForces, sim.cu:1157-1200):
      f = k (rest*scale - |d|) d_hat + dot(v_l - v_r, d_hat) damping d_hat
    with d = pos_right - pos_left.  Returns (force [3, S], applied +f at
    the right endpoint and -f at the left, new rest [S])."""
    left, right = springs.left.long(), springs.right.long()
    d = masses.pos[:, right] - masses.pos[:, left]
    length = _safe_norm(torch.sum(d * d, dim=0))
    unit = d * _inv_norm(length)
    pair_valid = springs.valid & masses.valid[left] & masses.valid[right]
    rest = springs.rest
    scale = 1.0
    if has_breathing:
        scale, rest = _breathe_and_actuate(
            rest, springs.type, springs.omega, springs.l_max, springs.l_min,
            springs.rate, pair_valid, t, dt)
    dv = masses.vel[:, left] - masses.vel[:, right]
    axial_dv = torch.sum(dv * unit, dim=0)
    mag = springs.k * (rest * scale - length) + axial_dv * springs.damping
    f = torch.where(pair_valid, mag * unit, 0.0)
    return f, rest


def stencil_spring_forces(masses: MassState, st, deltas: tuple, t: Tensor,
                          dt: Tensor, has_breathing: bool,
                          has_damping: bool = True, all_valid: bool = False
                          ) -> Tuple[Tensor, Tensor]:
    """Spring forces of the offset families: family f connects mass n to
    n + deltas[f], so the endpoint gather is ``torch.roll(x, -d)`` and the
    scatter onto the right endpoint ``torch.roll(f, d)``.  Wrapped lanes are
    mask=False slots whose force is zeroed before the scatter.  Returns
    (accumulated mass force [3, N], new rest [F, N])."""
    pos, vel, valid = masses.pos, masses.vel, masses.valid
    f_acc = torch.zeros_like(pos)
    new_rest = []
    for fi, d in enumerate(deltas):
        diff = torch.roll(pos, -d, dims=-1) - pos               # right - left
        length = _safe_norm(torch.sum(diff * diff, dim=0))
        unit = diff * _inv_norm(length)
        pair_ok = st.mask[fi]
        if not all_valid:
            pair_ok = pair_ok & valid & torch.roll(valid, -d, dims=-1)
        rest = st.rest[fi]
        scale = 1.0
        if has_breathing:
            scale, rest = _breathe_and_actuate(
                rest, st.type[fi], st.omega[fi], st.l_max[fi], st.l_min[fi],
                st.rate[fi], pair_ok, t, dt)
        new_rest.append(rest)
        mag = st.k[fi] * (rest * scale - length)
        if has_damping:
            vel_r = torch.roll(vel, -d, dims=-1)
            mag = mag + torch.sum((vel - vel_r) * unit, dim=0) * st.damping[fi]
        f = torch.where(pair_ok, mag, 0.0) * unit
        # -f at the left endpoint (n), +f at the right (n + d)
        f_acc = f_acc - f + torch.roll(f, d, dims=-1)
    rest_out = torch.stack(new_rest) if has_breathing else st.rest
    return f_acc, rest_out


def scatter_spring_forces(f_springs: Tensor, topo: Topology, fixed: Tensor,
                          mode: ScatterMode) -> Tensor:
    """+f on right endpoints, -f on left, skipping fixed masses, as a
    deterministic per-mass gather over the incidence lists (GATHER mode;
    replaces the reference's atomicAdd scatter, sim.cu:1189-1196)."""
    if mode is not ScatterMode.GATHER:
        raise NotImplementedError(
            f"scatter mode {mode.name} is not ported yet (GATHER only)")
    zero = torch.zeros((3, 1), dtype=f_springs.dtype, device=f_springs.device)
    fpad = torch.cat([f_springs, zero], dim=1)                  # [3, S+1]
    idx = topo.inc_idx.long()
    mf = torch.stack([torch.sum(fpad[c][idx] * topo.inc_sign, dim=1)
                      for c in range(3)])
    return torch.where(fixed, 0.0, mf)


def _vdot(a: Tensor, n: Tensor) -> Tensor:
    """dot of a [3, N] field with a [3] vector -> [N]."""
    return torch.sum(a * n[:, None], dim=0)


def apply_contact_plane(f: Tensor, pos: Tensor, vel: Tensor, normal: Tensor,
                        offset: Tensor, fk: Tensor, fs: Tensor,
                        normal_coeff: float,
                        static_friction_hint: bool = True) -> Tensor:
    """One global contact plane (reference CudaContactPlane::applyForce,
    object.cu:76-109): inside (disp < 0) and with friction, kinetic
    (|v_perp| > 1e-16) f -= v_perp fk |f_n| / |v_perp|, else static
    f -= f_perp when fs |f_n| > |f_perp|, from the force accumulated so
    far; then the penalty f += -disp NORMAL n."""
    nb = normal[:, None]
    disp = _vdot(pos, normal) - offset
    inside = disp < 0
    if static_friction_hint:
        fn_mag = _vdot(f, normal)
        f_n = fn_mag * nb
        has_friction = (fs > 0) | (fk > 0)
        v_perp = vel - _vdot(vel, normal) * nb
        v_norm = _safe_norm(torch.sum(v_perp * v_perp, dim=0))
        kinetic = v_norm > 1e-16
        fn_abs = torch.abs(fn_mag)
        safe_vn = torch.where(kinetic, v_norm, 1.0)
        f_kin = f - v_perp * (fk * fn_abs / safe_vn)
        f_perp = f - f_n
        fp_norm = _safe_norm(torch.sum(f_perp * f_perp, dim=0))
        f_sta = torch.where(fs * fn_abs > fp_norm, f - f_perp, f)
        f_fric = torch.where(kinetic, f_kin, f_sta)
        f = torch.where(inside & has_friction, f_fric, f)
    contact = torch.where(inside, -disp * normal_coeff, 0.0)
    return f + contact * nb


def apply_ball(f: Tensor, pos: Tensor, center: Tensor, radius: Tensor,
               normal_coeff: float) -> Tensor:
    """One global ball: radial penalty inside it (reference
    CudaBall::applyForce, object.cu:56-59), zero at dist == 0."""
    d = pos - center[:, None]
    dist = _safe_norm(torch.sum(d * d, dim=0))
    safe = torch.where(dist > 0, dist, 1.0)
    push = torch.where((dist <= radius) & (dist > 0), normal_coeff / safe, 0.0)
    return f + d * push


def apply_global_constraints(f: Tensor, masses: MassState,
                             gcon: GlobalConstraints, n_planes: int,
                             n_balls: int, normal_coeff: float,
                             plane_friction: tuple = ()) -> Tensor:
    """All global planes then all balls, in registration order
    (sim.cu:1303-1309)."""
    for p in range(n_planes):
        f = apply_contact_plane(
            f, masses.pos, masses.vel, gcon.plane_normal[p],
            gcon.plane_offset[p], gcon.plane_fk[p], gcon.plane_fs[p],
            normal_coeff,
            static_friction_hint=(plane_friction[p]
                                  if p < len(plane_friction) else True))
    for b in range(n_balls):
        f = apply_ball(f, masses.pos, gcon.ball_center[b],
                       gcon.ball_radius[b], normal_coeff)
    return f


def magnet_forces(masses: MassState, cutoff: float,
                  chunk: int = 2048) -> Tensor:
    """All-pairs magnet interaction within ``cutoff`` (masked O(N^2));
    [3, N].  Reference computeExternalMagnetForce (sim.cu:1223-1241), as
    ``titan_tpu/ops/forces.py::magnet_forces``: for a valid receiver i and
    each valid source j != i with |temp| < cutoff, temp = pos_i - pos_j,

      shell:  + |inter| stiffness_i temp_hat   where inter = |temp| -
              (rad_i + rad_j) < 0
      magnet: - scale_j max_mag_force_i / max(|temp|^2, 1e-12) temp_hat

    Sources are taken in chunks of ``chunk`` to bound the [3, N, chunk]
    temporary.  This is also the plain version of the pairwise field
    kernel (``csrc/magnets.cu``, ``ops/magnets.py::pairwise_magnet_field``).
    """
    pos = masses.pos
    n = pos.shape[1]
    iota = torch.arange(n, device=pos.device)
    total = torch.zeros_like(pos)
    for j0 in range(0, n, chunk):
        sl = slice(j0, min(j0 + chunk, n))
        diff = pos[:, :, None] - pos[:, None, sl]              # [3, N, C]
        dist2 = torch.sum(diff * diff, dim=0)                  # [N, C]
        dist = _safe_norm(dist2)
        pair_ok = ((dist < cutoff) & (iota[:, None] != iota[None, sl])
                   & masses.valid[:, None] & masses.valid[None, sl])
        safe_dist = torch.where(dist > 0, dist, 1.0)
        inter = dist - (masses.mag_rad[:, None] + masses.mag_rad[None, sl])
        shell = torch.where(inter < 0,
                            torch.abs(inter) * masses.mag_stiffness[:, None],
                            0.0)
        attract = (masses.mag_scale[None, sl] * masses.mag_maxf[:, None]
                   / torch.clamp(dist2, min=1e-12))
        coeff = torch.where(pair_ok, (shell - attract) / safe_dist, 0.0)
        total = total + torch.sum(diff * coeff[None], dim=2)
    return total
