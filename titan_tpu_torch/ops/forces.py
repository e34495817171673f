"""Force computation: springs, scatter, global constraints.

Counterpart of ``titan_tpu/ops/forces.py`` for the subset on the port's
path.  All functions are pure: they consume and produce ``[3, N]``
component-major tensors and never write into their inputs.  Norms are
sqrt + divide, as the JAX package computes them on the CPU
(``titan_tpu/ops/forces.py::use_rsqrt``), and every norm goes through
``_safe_norm`` so that autograd through the step stays finite.

Remainder springs (springs in no stencil family) have three forms here:
the eager step's ``spring_forces`` + ``scatter_spring_forces`` (GATHER or
SEGMENT), the O(S) ``compact_remainder_forces`` of the JAX package's tiled
glue, and ``remainder_sum`` on the kernels' staging (``stage_remainder``),
the plain version of ``csrc/step_body.cuh::remainder_forces``: each mass
walks its row of the incidence table and adds its springs' forces in
incidence order, which ``torch.sum`` over the row would not fix.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import (ACTIVE_CONTRACT_THEN_EXPAND, ACTIVE_EXPAND_THEN_CONTRACT,
                      ACTUATED_CONTRACT, ACTUATED_EXPAND, ScatterMode)
from ..state import (GlobalConstraints, LocalConstraints, MassState,
                     SpringState, Topology)

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
    """+f on right endpoints, -f on left, skipping fixed masses
    (``titan_tpu/ops/forces.py::scatter_spring_forces``; replaces the
    reference's atomicAdd scatter, sim.cu:1189-1196).  GATHER: a per-mass
    gather over the incidence lists.  SEGMENT: the forces [f; -f] taken in
    the endpoint-sorted order ``topo.seg_perm`` and summed per endpoint id
    ``topo.seg_ids`` (``index_add_``: in order on the CPU, in no fixed
    order on the card)."""
    n = fixed.shape[0]
    if mode is ScatterMode.SEGMENT:
        both = torch.cat([f_springs, -f_springs], dim=1)        # [3, 2S]
        sortd = both[:, topo.seg_perm.long()]
        mf = torch.zeros((3, n), dtype=f_springs.dtype,
                         device=f_springs.device).index_add_(
            1, topo.seg_ids.long(), sortd)
        return torch.where(fixed, 0.0, mf)
    zero = torch.zeros((3, 1), dtype=f_springs.dtype, device=f_springs.device)
    fpad = torch.cat([f_springs, zero], dim=1)                  # [3, S+1]
    idx = topo.inc_idx.long()
    mf = torch.stack([torch.sum(fpad[c][idx] * topo.inc_sign, dim=1)
                      for c in range(3)])
    return torch.where(fixed, 0.0, mf)


def compact_remainder_forces(sp: SpringState, pos_all: Tensor, vel_all,
                             rem_rest: Tensor, t_now, dt, my0: int, b: int,
                             has_breathing: bool, has_damping: bool
                             ) -> Tuple[Tensor, Tensor]:
    """O(S) remainder-spring evaluation: per-spring endpoint takes and a
    dropping scatter-add onto the rows [my0, my0 + b)
    (``titan_tpu/ops/forces.py::compact_remainder_forces``, the JAX tiled
    glue's form).  ``sp.valid`` must have endpoint validity folded in (it
    gates the force and the actuated advance); fixed masses are the
    caller's.  Returns (f [3, b], new rest [S])."""
    left, right = sp.left.long(), sp.right.long()
    diff = pos_all[:, right] - pos_all[:, left]
    length = _safe_norm(torch.sum(diff * diff, dim=0))
    inv = _inv_norm(length)
    rest, scale = rem_rest, 1.0
    if has_breathing:
        scale, rest = _breathe_and_actuate(
            rem_rest, sp.type, sp.omega, sp.l_max, sp.l_min, sp.rate,
            sp.valid, t_now, dt)
    mag = sp.k * (rest * scale - length)
    if has_damping:
        axial = torch.sum((vel_all[:, left] - vel_all[:, right])
                          * (diff * inv), dim=0)
        mag = mag + axial * sp.damping
    f = torch.where(sp.valid, mag, 0.0) * (diff * inv)
    li, ri = left - my0, right - my0
    li = torch.where((li >= 0) & (li < b), li, b)             # b: dropped
    ri = torch.where((ri >= 0) & (ri < b), ri, b)
    buf = torch.zeros((3, b + 1), dtype=pos_all.dtype, device=pos_all.device)
    buf = buf.index_add(1, li, -f).index_add(1, ri, f)
    return buf[:, :b], rest


def incidence(springs: SpringState, n_masses: int, degree: int
              ) -> Tuple[Tensor, Tensor]:
    """(inc_idx [N, D] int32, inc_sign [N, D]) of the valid remainder
    springs, in ``builders.build_incidence``'s order (per mass, its entries
    as the stable sort of [right ends; left ends] puts them), on the
    springs' device: the incidence table of a scene marshalled for SEGMENT
    scatter, which carries none."""
    s = springs.left.shape[0]
    dev = springs.left.device
    ar = torch.arange(s, device=dev)
    keep = torch.cat([springs.valid, springs.valid])
    ids = torch.cat([springs.right, springs.left]).long()[keep]
    sign = torch.cat([torch.ones(s, device=dev),
                      -torch.ones(s, device=dev)])[keep]
    spring_of = torch.cat([ar, ar])[keep]
    order = torch.sort(ids, stable=True).indices
    ids, sign, spring_of = ids[order], sign[order], spring_of[order]
    counts = torch.bincount(ids, minlength=n_masses)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(ids.shape[0], device=dev) - starts[ids]
    inc = torch.full((n_masses, degree), s, dtype=torch.int32, device=dev)
    inc_sign = torch.zeros((n_masses, degree), device=dev)
    inc[ids, slot] = spring_of.to(torch.int32)
    inc_sign[ids, slot] = sign
    return inc, inc_sign


# rows of the staged per-spring array ``p`` of ``stage_remainder``; the
# kernels read them by the same numbers (csrc/step_body.cuh::Remainder)
REM_ROWS = ("k", "damping", "bsign", "bomega", "arate", "abound", "aratedt",
            "sstop")


def stage_remainder(shape, state, dtype=torch.float32) -> dict:
    """The remainder springs as the kernels take them
    (``titan_tpu/ops/pallas_step.py::stage_remainder`` without its one-hot
    selectors): ``inc`` / ``sign`` the incidence table [N, D] (the
    topology's, or built by ``incidence``), ``ends`` [2, S] int32 (left,
    right), ``p`` [8, S] (``REM_ROWS``: k, damping, bsign, bomega, arate,
    abound, and the adjoints' closed-form rest inputs aratedt = arate dt and
    sstop, the call count at which the one-sided bound is crossed: rest0 +
    min(c, sstop) aratedt after c force calls), ``rest`` [S] and ``ok``
    (the valid springs between valid masses).  k, damping and arate are
    zero where ``ok`` is not, so that such a spring exerts nothing and its
    rest stays."""
    m, sp = state.masses, state.springs
    left, right = sp.left.long(), sp.right.long()
    ok = sp.valid & m.valid[left] & m.valid[right]
    styp = sp.type
    arate = torch.where(styp == ACTUATED_EXPAND, sp.rate,
                        torch.where(styp == ACTUATED_CONTRACT, -sp.rate, 0.0))
    b = torch.full_like(sp.omega, 0.2, dtype=dtype)     # 0.2 in dtype
    rows = [torch.where(ok, sp.k, 0.0), torch.where(ok, sp.damping, 0.0),
            torch.where(styp == ACTIVE_CONTRACT_THEN_EXPAND, -b,
                        torch.where(styp == ACTIVE_EXPAND_THEN_CONTRACT, b,
                                    0.0)),
            sp.omega, torch.where(ok, arate, 0.0),
            torch.where(styp == ACTUATED_EXPAND, sp.l_max,
                        torch.where(styp == ACTUATED_CONTRACT, sp.l_min,
                                    0.0))]
    rows = [r.to(dtype) for r in rows]
    rest = sp.rest.to(dtype)
    aratedt = rows[4] * state.dt.to(dtype)
    nz = aratedt != 0
    sstop = torch.where(nz, torch.ceil((rows[5] - rest) / torch.where(
        nz, aratedt, 1.0)), 0.0)
    rows += [aratedt, torch.clamp(sstop, min=0.0)]
    topo = state.topo
    if topo.inc_idx.shape[0] == shape.n_masses:
        inc, sign = topo.inc_idx, topo.inc_sign
    else:
        inc, sign = incidence(sp, shape.n_masses, shape.max_degree)
    return dict(inc=inc.to(torch.int32).contiguous(),
                sign=sign.to(dtype).contiguous(),
                ends=torch.stack([sp.left, sp.right]).to(torch.int32),
                p=torch.stack(rows).contiguous(), rest=rest, ok=ok)


def remainder_eval(R: dict, pos: Tensor, vel: Tensor, t, dt, rest: Tensor,
                   flags: tuple, cidx=None):
    """Every remainder spring at (pos, vel) in the kernels' arithmetic
    (``csrc/step_body.cuh::spring_eval``).  ``flags`` is (has_damping,
    has_breathing, has_actuated).  ACTUATED rest advances once from
    ``rest`` (the forward's carried rest), or with ``cidx`` takes the
    closed form after ``cidx`` force calls from the staged rest0 (the
    adjoints).  Returns a dict of the per-spring intermediates: diff, ln,
    inv, ax, cm, the effective rest and, before the breathing scale,
    rest_b, scale and advc, and new_rest; the force on the right endpoint
    is (cm inv) diff."""
    has_damping, has_breathing, has_actuated = flags
    p = R["p"]
    left, right = R["ends"][0].long(), R["ends"][1].long()
    diff = pos[:, right] - pos[:, left]
    d2 = torch.sum(diff * diff, dim=0)
    ln = _safe_norm(d2)
    inv = _inv_norm(ln)
    r, advc = rest, None
    if has_actuated:
        if cidx is None:
            ar, ab = p[4], p[5]
            adv = ((ar > 0) & (r < ab)) | ((ar < 0) & (r > ab))
            r = r + torch.where(adv, ar * dt, 0.0)
        else:
            advc = torch.clamp(p[7], max=cidx)
            r = r + advc * p[6]
    out = dict(diff=diff, ln=ln, inv=inv, new_rest=r, rest_b=r, advc=advc,
               scale=None, ax=None)
    if has_breathing:
        out["scale"] = 1.0 + p[2] * torch.sin(p[3] * t)
        r = r * out["scale"]
    cm = p[0] * (r - ln)
    if has_damping:
        ax = torch.sum((vel[:, left] - vel[:, right]) * diff, dim=0)
        cm = cm + (ax * inv) * p[1]
        out["ax"] = ax
    out["rest"], out["cm"] = r, cm
    return out


def incidence_sum(R: dict, per_spring: Tensor, sign_of=1.0) -> Tensor:
    """sum over each mass's incidence row, in row order from zero, of
    sign x per_spring[:, spring] (``sign_of`` -1 takes -sign): the plain
    version of the kernels' walk of the table."""
    zero = torch.zeros((per_spring.shape[0], 1), dtype=per_spring.dtype,
                       device=per_spring.device)
    fpad = torch.cat([per_spring, zero], dim=1)
    inc, sign = R["inc"].long(), R["sign"] * sign_of
    acc = torch.zeros((per_spring.shape[0], inc.shape[0]),
                      dtype=per_spring.dtype, device=per_spring.device)
    for d in range(inc.shape[1]):
        acc = acc + fpad[:, inc[:, d]] * sign[:, d]
    return acc


def remainder_sum(R: dict, pos: Tensor, vel: Tensor, t, dt, rest: Tensor,
                  flags: tuple, cidx=None) -> Tuple[Tensor, Tensor]:
    """The remainder springs' force on every mass [3, N] and the advanced
    rest [S]: ``remainder_eval``, then each mass's row of the incidence
    table summed in order (``incidence_sum``).  The plain version of
    ``csrc/step_body.cuh::remainder_forces`` (and, with ``cidx``, of the
    backward's recompute)."""
    e = remainder_eval(R, pos, vel, t, dt, rest, flags, cidx)
    return incidence_sum(R, (e["cm"] * e["inv"]) * e["diff"]), e["new_rest"]


def remainder_forces_plain(masses: MassState, springs: SpringState,
                           topo: Topology, t, dt, has_breathing: bool,
                           has_damping: bool, max_degree: int = None
                           ) -> Tuple[Tensor, Tensor]:
    """The remainder springs' force on every mass [3, N] and their new
    rest [S], as the kernels compute them (``remainder_sum`` on
    ``stage_remainder``), in the state's dtype: the ordered twin of
    ``spring_forces`` + ``scatter_spring_forces``, fixed masses included
    (the kernels freeze them in the update).  ``max_degree`` sizes the
    incidence table of a topology that has none (SEGMENT scatter)."""
    from types import SimpleNamespace
    st = SimpleNamespace(masses=masses, springs=springs, topo=topo, dt=dt)
    shape = SimpleNamespace(n_masses=masses.pos.shape[1],
                            max_degree=max_degree or topo.inc_idx.shape[1])
    R = stage_remainder(shape, st, masses.pos.dtype)
    # a breathing scale of 1 and a zero rate change nothing, so the
    # breathing flag gates both mechanisms, as in spring_forces
    return remainder_sum(R, masses.pos, masses.vel, t, dt, R["rest"],
                         (has_damping, has_breathing, has_breathing))


def _vdot(a: Tensor, n: Tensor) -> Tensor:
    """dot of a [3, N] field with a [3] or [3, N] vector -> [N]."""
    return torch.sum(a * (n[:, None] if n.dim() == 1 else n), dim=0)


def apply_contact_plane(f: Tensor, pos: Tensor, vel: Tensor, normal: Tensor,
                        offset: Tensor, fk: Tensor, fs: Tensor,
                        normal_coeff: float,
                        static_friction_hint: bool = True) -> Tensor:
    """One global contact plane (reference CudaContactPlane::applyForce,
    object.cu:76-109): inside (disp < 0) and with friction, kinetic
    (|v_perp| > 1e-16) f -= v_perp fk |f_n| / |v_perp|, else static
    f -= f_perp when fs |f_n| > |f_perp|, from the force accumulated so
    far; then the penalty f += -disp NORMAL n.  ``normal`` is [3] (a
    global plane) or [3, N] (a per-mass contact-plane slot)."""
    nb = normal[:, None] if normal.dim() == 1 else normal
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


def apply_constraint_plane(f: Tensor, vel: Tensor, normal: Tensor,
                           friction: Tensor, active: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """Per-mass constraint plane (reference CudaConstraintPlane::applyForce,
    object.cu:118-127): the normal force and velocity are projected out.
    A reference quirk kept: |v| is taken BEFORE the normal velocity is
    removed, and the friction term divides the updated velocity by that old
    norm.  ``normal`` is [3, N], ``friction`` and ``active`` [N].  Returns
    (force, velocity)."""
    nf = _vdot(f, normal)
    f2 = f - normal * nf
    v_norm = _safe_norm(torch.sum(vel * vel, dim=0))
    moving = v_norm >= 1e-16
    v2 = vel - normal * _vdot(vel, normal)
    safe_vn = torch.where(moving, v_norm, 1.0)
    f3 = f2 - friction * nf * v2 / safe_vn
    f_out = torch.where(active, torch.where(moving, f3, f2), f)
    return f_out, torch.where(active & moving, v2, vel)


def apply_direction(f: Tensor, vel: Tensor, tangent: Tensor,
                    friction: Tensor, active: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Per-mass direction constraint (reference CudaDirection::applyForce,
    object.cu:136-144): motion only along the tangent t,
      nf = f - dot(f, t) t;  f -= nf;
      if |v| >= 1e-16: v = t dot(v, t);  f += -|nf| friction t.
    Returns (force, velocity)."""
    nf = f - tangent * _vdot(f, tangent)
    f2 = f - nf
    v_norm = _safe_norm(torch.sum(vel * vel, dim=0))
    moving = v_norm >= 1e-16
    nf_norm = _safe_norm(torch.sum(nf * nf, dim=0))
    f3 = f2 - nf_norm * friction * tangent
    f_out = torch.where(active, torch.where(moving, f3, f2), f)
    return f_out, torch.where(active & moving,
                              tangent * _vdot(vel, tangent), vel)


def local_slot_rows(caps: Tuple[int, int, int, int]) -> int:
    """Rows of the stacked local-constraint slot array ``stage_local``
    builds (``titan_tpu/ops/pallas_step.py::_lc_planes``)."""
    cp, ball, pl, dr = caps
    return 7 * cp + 5 * (ball + pl + dr)


def stage_local(lcon: LocalConstraints, caps: Tuple[int, int, int, int],
                dtype=None) -> Tensor:
    """The per-mass local-constraint slots as one [L, N] array in the
    kernels' reference order (``titan_tpu/ops/pallas_step.py::
    stage_local_constraints``): per contact plane act, normal xyz, offset,
    fk, fs (7 rows); per ball act, centre xyz, radius (5); per constraint
    plane act, normal xyz, friction (5); per direction act, tangent xyz,
    friction (5).  ``act`` is 1 where slot j < the mass's count.  Every
    step of the port reads its slots from this one array."""
    cp, ball, pl, dr = caps
    dtype = dtype or lcon.cp_offset.dtype
    parts = []

    def act(j, count):
        return (j < count).to(dtype)[None]

    for j in range(cp):
        parts += [act(j, lcon.cp_count), lcon.cp_normal[:, j, :].T,
                  lcon.cp_offset[:, j][None], lcon.cp_fk[:, j][None],
                  lcon.cp_fs[:, j][None]]
    for j in range(ball):
        parts += [act(j, lcon.ball_count), lcon.ball_center[:, j, :].T,
                  lcon.ball_radius[:, j][None]]
    for j in range(pl):
        parts += [act(j, lcon.pl_count), lcon.pl_normal[:, j, :].T,
                  lcon.pl_friction[:, j][None]]
    for j in range(dr):
        parts += [act(j, lcon.dir_count), lcon.dir_tangent[:, j, :].T,
                  lcon.dir_friction[:, j][None]]
    return torch.cat(parts, dim=0).to(dtype).contiguous()


def local_slots(f: Tensor, pos: Tensor, vel: Tensor, lc: Tensor,
                caps: Tuple[int, int, int, int], normal_coeff: float,
                stages: dict = None) -> Tuple[Tensor, Tensor]:
    """The local-constraint slots of ``stage_local`` in reference order
    (sim.cu:1311-1326): contact planes, balls, constraint planes,
    directions; slot j of a type acts where its ``act`` row is set.
    Constraint planes and directions mutate the velocity, which drag and
    the integrator then read.  The plain version of every kernel's local
    branch (``csrc/step_body.cuh::local_constraints``), in its operation
    order.  With a ``stages`` dict, the force entering each contact plane
    (``lcp_in``) and the (force, velocity) entering each constraint plane
    (``lpl_in``) and direction (``ldir_in``) are appended to it, as the
    adjoint's transpose reads them.  Returns (force, velocity)."""
    cp, ball, pl, dr = caps
    o = 0
    for _ in range(cp):
        act = lc[o] > 0.5
        if stages is not None:
            stages["lcp_in"].append(f)
        f_new = apply_contact_plane(f, pos, vel, lc[o + 1:o + 4], lc[o + 4],
                                    lc[o + 5], lc[o + 6], normal_coeff)
        f = torch.where(act, f_new, f)
        o += 7
    for _ in range(ball):
        act = lc[o] > 0.5
        dvec = pos - lc[o + 1:o + 4]
        dist = _safe_norm(torch.sum(dvec * dvec, dim=0))
        safe = torch.where(dist > 0, dist, 1.0)
        # tensor / tensor: float / tensor rounds twice (module docstring
        # of ops/fused_step.py)
        push = torch.where((dist <= lc[o + 4]) & (dist > 0),
                           safe.new_full((), normal_coeff) / safe, 0.0)
        f = torch.where(act, f + dvec * push, f)
        o += 5
    for _ in range(pl):
        if stages is not None:
            stages["lpl_in"].append((f, vel))
        f, vel = apply_constraint_plane(f, vel, lc[o + 1:o + 4], lc[o + 4],
                                        lc[o] > 0.5)
        o += 5
    for _ in range(dr):
        if stages is not None:
            stages["ldir_in"].append((f, vel))
        f, vel = apply_direction(f, vel, lc[o + 1:o + 4], lc[o + 4],
                                 lc[o] > 0.5)
        o += 5
    return f, vel


def apply_local_constraints(f: Tensor, vel: Tensor, masses: MassState,
                            lcon: LocalConstraints,
                            caps: Tuple[int, int, int, int],
                            normal_coeff: float) -> Tuple[Tensor, Tensor]:
    """Per-mass local constraints in reference order: contact planes,
    balls, constraint planes, directions (sim.cu:1311-1326,
    ``titan_tpu/ops/forces.py::apply_local_constraints``); slot j of a
    type is active iff j < the mass's count.  Returns (force, velocity)."""
    return local_slots(f, masses.pos, vel, stage_local(lcon, caps), caps,
                       normal_coeff)


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
