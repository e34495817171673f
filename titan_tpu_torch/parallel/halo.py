"""Explicit halo-exchange stepping across shards: the counterpart of
``titan_tpu/parallel/halo.py``.

Masses are block-sharded along N (``sharded.py``); each shard steps its
block with plain PyTorch operations, as the JAX package steps it with XLA
inside ``shard_map`` (the JAX module has no Pallas kernel, so neither has
this one), and the only traffic between shards per force pass is

  1. two-sided halos of pos (+ vel where springs are damped) of ``H``
     entries from the ring neighbours (``comm.halo_extend``), H covering the
     stencil offsets and, where they fit, the remainder springs' span;
  2. two "spill" buffers of spring forces bound for the neighbours' edge
     masses (``comm.ring_edges``);
  3. for magnet scenes, and remainder springs wider than a block, one
     gather of pos (``comm.all_gather``); the magnets' source parameters
     are gathered once per chunk.

The global wrap-around pairs are masked: mass validity is folded into the
stencil mask and the remainder springs' valid flags at chunk entry.  The
envelope (``halo_reject_reason``) and every per-shard formula are the JAX
module's, line for line; the order of each sum follows it too, so the
route agrees with the single-device step to f32 rounding, and in f64 to
1e-9.

Magnets: exact pairwise (each shard's receivers against every gathered
source) and cell-binned (every shard builds the same bin table from the
gathered positions, ``binned_magnet_block_forces``, and evaluates its own
receivers: per receiver the single-device binned pass's candidates in its
order).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..config import (ACTIVE_CONTRACT_THEN_EXPAND, ACTIVE_EXPAND_THEN_CONTRACT,
                      ACTUATED_CONTRACT, ACTUATED_EXPAND, Integrator)
from ..ops import integrators as I
from ..ops.step import _mass_forces
from ..state import SceneShape, SimState
from . import comm
from .mesh import Mesh


def halo_reject_reason(shape: SceneShape, n_devices: int):
    """None if the halo-exchange path accepts this scene on ``n_devices``
    shards, else a one-line reason naming the envelope condition that
    failed (``titan_tpu/parallel/halo.py:58-82``)."""
    cfg = shape.config
    if cfg.integrator not in (Integrator.EULER, Integrator.VERLET,
                              Integrator.RK2):
        return (f"integrator {cfg.integrator.name} not supported by the "
                "halo path")
    if not cfg.use_stencil:
        return "use_stencil off"
    if not shape.stencil_deltas and not shape.has_remainder:
        return "no springs to exchange halos for"
    if not cfg.persistent_extern_force:
        return "strict per-step extern_force mode"
    if shape.n_masses % n_devices != 0:
        return (f"{shape.n_masses} masses not divisible by "
                f"{n_devices} devices")
    block = shape.n_masses // n_devices
    # remainder spans wider than the block don't reject the scene: those
    # springs switch to the gathered path
    w = _halo_width(shape, _remainder_windowed(shape, n_devices))
    if block <= w:
        return (f"halo width {w} (max stencil index span) "
                f">= per-device block {block}")
    return None


def halo_supported(shape: SceneShape, n_devices: int) -> bool:
    return halo_reject_reason(shape, n_devices) is None


def _halo_width(shape: SceneShape, include_remainder: bool = True) -> int:
    spans = [abs(d) for d in shape.stencil_deltas]
    if shape.has_remainder and include_remainder:
        spans.append(shape.remainder_span)
    return max(spans + [1])


def _remainder_windowed(shape: SceneShape, n_devices: int) -> bool:
    """True if remainder springs fit the halo window (evaluated locally,
    spills exchanged); False: the gathered path (gathered pos, replicated
    spring evaluation, dropping scatters into the local block)."""
    block = shape.n_masses // n_devices
    return shape.has_remainder and shape.remainder_span < block


def gathered_remainder_forces(sp, pos_all, vel_all, rem_rest, t_now, dt,
                              my0, b, has_breathing, has_damping):
    """Remainder-spring force on one shard's block [my0, my0 + b) from the
    gathered positions: every shard evaluates every remainder spring and
    keeps the force components that land in its block
    (``halo.py:104-120``, over the port's
    ``ops/forces.py::compact_remainder_forces``).  The ACTUATED rest
    advance reads only replicated arrays, so every shard computes the same
    new rest.  Returns (f_local [3, b], new_rem_rest)."""
    from ..ops.forces import compact_remainder_forces
    return compact_remainder_forces(sp, pos_all, vel_all, rem_rest,
                                    t_now, dt, my0, b, has_breathing,
                                    has_damping)


def binned_magnet_block_forces(shape, pos_all, mag_src, pos_loc, valid_loc,
                               rad_loc, stiff_loc, maxf_loc, rid):
    """Cell-binned magnet force on one shard's receivers
    (``halo.py:123-148``): the bin table of every gathered source (built
    the same on every shard), and the forces of the receivers ``rid``
    (global mass ids; the receiver parameters align with it) only.  Per
    receiver the candidates and their order are the single-device binned
    pass's.  Returns [3, len(rid)]."""
    from ..ops.magnets import (build_source_bins, cell_ids,
                               neighborhood_rows, receiver_forces)
    cfg = shape.config
    a_cells, cell_cap = shape.magnet_binned
    src_rad, src_scale, src_ok = mag_src
    bins, tbl, _ = build_source_bins(
        pos_all, src_ok, src_rad, src_scale, cfg.magnet_cutoff,
        a_cells, cell_cap)
    rcell = cell_ids(pos_loc, valid_loc, cfg.magnet_cutoff)
    rows9 = neighborhood_rows(tbl, rcell, a_cells)
    return receiver_forces(bins, rows9, cfg.magnet_cutoff,
                           shape.n_masses, pos_loc, rad_loc, stiff_loc,
                           maxf_loc, rid)


def _breathing(shape, typ, omega, t_now):
    sin_wt = torch.sin(omega * t_now)
    return torch.where(
        typ == ACTIVE_CONTRACT_THEN_EXPAND, 1.0 - 0.2 * sin_wt,
        torch.where(typ == ACTIVE_EXPAND_THEN_CONTRACT, 1.0 + 0.2 * sin_wt,
                    1.0))


def _actuate(ok, typ, rest, l_max, l_min, rate, dt):
    return torch.where(
        ok & (typ == ACTUATED_EXPAND) & (rest < l_max), rest + rate * dt,
        torch.where(ok & (typ == ACTUATED_CONTRACT) & (rest > l_min),
                    rest - rate * dt, rest))


def _inv(length):
    return torch.where(length > 0,
                       1.0 / torch.where(length > 0, length, 1.0), 0.0)


def fold_validity(shape: SceneShape, mesh: Mesh, shards: List[SimState]
                  ) -> List[SimState]:
    """Each shard with endpoint validity folded into its stencil mask and
    the remainder springs' valid flags (``halo.py:458-475``): the right
    ends' validity arrives by one halo exchange, the remainder endpoints'
    by one gather, once per chunk."""
    if shape.all_valid:
        return shards
    deltas = shape.stencil_deltas
    valid = [s.masses.valid for s in shards]
    out = list(shards)
    if deltas:
        w = max(abs(d) for d in deltas)
        ext = comm.halo_extend(mesh, valid, w)
        b = valid[0].shape[-1]
        for i, s in enumerate(shards):
            mask = torch.stack([
                s.stencil.mask[fi] & valid[i] & ext[i][w + d:w + d + b]
                for fi, d in enumerate(deltas)])
            out[i] = dataclasses.replace(
                out[i], stencil=dataclasses.replace(s.stencil, mask=mask))
    if shape.has_remainder:
        v_all = comm.all_gather(mesh, valid)
        for i, s in enumerate(out):
            sp = s.springs
            va = comm._to(v_all, sp.valid.device)
            out[i] = dataclasses.replace(s, springs=dataclasses.replace(
                sp, valid=sp.valid & va[sp.left.long()]
                & va[sp.right.long()]))
    return out


def build_halo_chunk(shape: SceneShape, mesh: Mesh, axis: str = "shard"):
    """``run(shards, n_steps) -> shards``: the halo-exchange chunk over
    this process's shards (blocks of N / D masses, ``sharded.shard_state``)
    (``halo.py:151-480``)."""
    deltas = shape.stencil_deltas
    n_dev = mesh.shape[axis]
    rem_windowed = _remainder_windowed(shape, n_dev)
    halo = _halo_width(shape, rem_windowed)
    cfg = shape.config
    is_verlet = cfg.integrator is Integrator.VERLET
    is_rk2 = cfg.integrator is Integrator.RK2
    # _mass_forces applies every per-mass force verbatim on the local
    # block; magnets are globally pairwise and handled here instead
    shape_local = dataclasses.replace(shape, has_magnets=False)
    rem_gathered = shape.has_remainder and not rem_windowed

    def eval_forces(states, pos, vel, st_rest, rem_rest, t_now, mag_src):
        """One force evaluation of every local shard at (pos, vel, t_now)
        (``halo.py:172-358``).  Returns per shard (f_acc, vel_out,
        new_st_rest, new_rem_rest)."""
        b = pos[0].shape[1]
        pos_all = (comm.all_gather(mesh, pos)
                   if (rem_gathered or shape.has_magnets) else None)
        pos_ext = comm.halo_extend(mesh, pos, halo)
        vel_ext = (comm.halo_extend(mesh, vel, halo) if shape.has_damping
                   else None)
        vel_all = (comm.all_gather(mesh, vel)
                   if rem_gathered and shape.has_damping else None)
        f_accs, spills, new_rests, new_rems = [], [], [], []
        for i, (state, my0) in enumerate(zip(states, mesh.local)):
            my0 = my0 * b
            st, dt = state.stencil, state.dt
            p, v = pos[i], vel[i]
            f_acc = torch.zeros_like(p)
            spill = torch.zeros((3, 2 * halo), dtype=p.dtype,
                                device=p.device)
            new_rest = st_rest[i]
            for fi, d in enumerate(deltas):
                pos_r = pos_ext[i][:, halo + d:halo + d + b]
                diff = pos_r - p
                length = torch.sqrt(torch.sum(diff * diff, dim=0))
                inv = _inv(length)
                pair_ok = st.mask[fi]      # validity folded in at entry
                rest = st_rest[i][fi]
                if shape.has_breathing:
                    scale = _breathing(shape, st.type[fi], st.omega[fi],
                                       t_now)
                    # ACTUATED rest lives at the left endpoint's block
                    rest = _actuate(pair_ok, st.type[fi], rest,
                                    st.l_max[fi], st.l_min[fi],
                                    st.rate[fi], dt)
                    new_rest = torch.cat([new_rest[:fi], rest[None],
                                          new_rest[fi + 1:]])
                else:
                    scale = 1.0
                mag = st.k[fi] * (rest * scale - length)
                if shape.has_damping:
                    vel_r = vel_ext[i][:, halo + d:halo + d + b]
                    axial = torch.sum((v - vel_r) * (diff * inv), dim=0)
                    mag = mag + axial * st.damping[fi]
                f = torch.where(pair_ok, mag, 0.0) * (diff * inv)
                f_acc = f_acc - f
                # +f lands at n + d: the local window plus a spill
                c = torch.nn.functional.pad(f, (halo + d, halo - d))
                f_acc = f_acc + c[:, halo:halo + b]
                spill = spill + torch.cat([c[:, :halo], c[:, halo + b:]],
                                          dim=1)
            new_rem = rem_rest[i]
            if rem_gathered:
                f_rem, new_rem = gathered_remainder_forces(
                    state.springs, comm._to(pos_all, p.device),
                    None if vel_all is None else comm._to(vel_all, p.device),
                    rem_rest[i], t_now, dt, my0, b, shape.has_breathing,
                    shape.has_damping)
                f_acc = f_acc + f_rem
            elif shape.has_remainder:
                # each remainder spring is owned by its LEFT endpoint's
                # shard; both endpoints are inside the window (envelope)
                sp = state.springs
                li = sp.left.long() - my0
                owned = sp.valid & (li >= 0) & (li < b)
                lidx = torch.clamp(li, 0, b - 1) + halo
                ridx = lidx + (sp.right.long() - sp.left.long())
                pl = pos_ext[i][:, lidx]
                pr = pos_ext[i][:, ridx]
                diff = pr - pl
                length = torch.sqrt(torch.sum(diff * diff, dim=0))
                inv = _inv(length)
                rest, scale = rem_rest[i], 1.0
                if shape.has_breathing:
                    scale = _breathing(shape, sp.type, sp.omega, t_now)
                    rest = _actuate(sp.valid, sp.type, rest, sp.l_max,
                                    sp.l_min, sp.rate, dt)
                    new_rem = rest
                mag = sp.k * (rest * scale - length)
                if shape.has_damping:
                    vl = vel_ext[i][:, lidx]
                    vr = vel_ext[i][:, ridx]
                    axial = torch.sum((vl - vr) * (diff * inv), dim=0)
                    mag = mag + axial * sp.damping
                f = torch.where(owned, mag, 0.0) * (diff * inv)
                buf = torch.zeros((3, b + 2 * halo), dtype=p.dtype,
                                  device=p.device)
                buf = buf.index_add(1, lidx, -f).index_add(1, ridx, f)
                f_acc = f_acc + buf[:, halo:halo + b]
                spill = spill + torch.cat([buf[:, :halo],
                                           buf[:, halo + b:]], dim=1)
            f_accs.append(f_acc)
            spills.append(spill)
            new_rests.append(new_rest)
            new_rems.append(new_rem)
        # deliver spills: each shard's prev-spill to the previous shard's
        # tail, its next-spill to the next shard's head
        from_prev, from_next = comm.ring_edges(mesh, spills, halo)
        out = []
        for i, state in enumerate(states):
            m = state.masses
            f_acc = f_accs[i]
            f_acc = torch.cat([f_acc[:, :halo] + from_prev[i],
                               f_acc[:, halo:]], dim=1)
            f_acc = torch.cat([f_acc[:, :b - halo],
                               f_acc[:, b - halo:] + from_next[i]], dim=1)
            f_acc = torch.where(m.fixed, 0.0, f_acc)
            p = pos[i]
            my0 = mesh.local[i] * b
            if shape.has_magnets and shape.magnet_binned:
                rid = my0 + torch.arange(b, dtype=torch.int32,
                                         device=p.device)
                src = tuple(comm._to(x, p.device) for x in mag_src)
                f_mag = binned_magnet_block_forces(
                    shape, comm._to(pos_all, p.device), src, p, m.valid,
                    m.mag_rad, m.mag_stiffness, m.mag_maxf, rid)
                # fixed masses return before the magnet pass
                # (sim.cu:1292-1298); they still act as sources
                f_acc = f_acc + torch.where(m.fixed | ~m.valid, 0.0, f_mag)
            elif shape.has_magnets:
                f_acc = f_acc + torch.where(m.fixed, 0.0, _pairwise_block(
                    cfg, comm._to(pos_all, p.device),
                    tuple(comm._to(x, p.device) for x in mag_src), m, p,
                    my0))
            f_acc, vel_out = _mass_forces(
                state, dataclasses.replace(m, pos=p, vel=vel[i]), f_acc,
                shape_local)
            out.append((f_acc, vel_out, new_rests[i], new_rems[i]))
        return out

    def local_step(states, mag_src):
        pos = [s.masses.pos for s in states]
        vel0 = [s.masses.vel for s in states]
        st_rest = [s.stencil.rest for s in states]
        rem_rest = [s.springs.rest for s in states]
        t = states[0].t
        dt = states[0].dt
        res = eval_forces(states, pos, vel0, st_rest, rem_rest, t, mag_src)
        if is_rk2:
            # the reference's RK2 (sim.cu:1778-1799): midpoint predictor,
            # then corrector, forces and halos evaluated twice per dt
            pos_h, vel_h, pend = [], [], []
            for s, (f1, vel1, rest1, rrest1) in zip(states, res):
                m = s.masses
                move = m.valid & ~m.fixed
                acc1 = f1 / m.m
                ph = m.pos + 0.5 * vel1 * dt
                vh = vel1 + 0.5 * acc1 * dt
                pos_h.append(torch.where(move, ph, m.pos))
                vel_h.append(torch.where(move, vh, vel1))
                pend.append((vel1, rest1, rrest1))
            res2 = eval_forces(states, pos_h, vel_h,
                               [p[1] for p in pend], [p[2] for p in pend],
                               t + 0.5 * dt, mag_src)
            upd = []
            for s, (vel1, _, _), (f2, vel2, rest2, rrest2) in zip(
                    states, pend, res2):
                m = s.masses
                acc = f2 / m.m
                upd.append((m.pos + vel2 * dt, vel1 + acc * dt, acc, rest2,
                            rrest2))
        else:
            upd = []
            for s, (f_acc, vel2, new_rest, new_rem) in zip(states, res):
                m = s.masses
                if is_verlet:
                    p2, v3, acc = I.verlet(m.pos, vel2, m.acc, f_acc, m.m,
                                           dt)
                else:
                    p2, v3, acc = I.euler(m.pos, vel2, f_acc, m.m, dt,
                                          cfg.velocity_clamp)
                upd.append((p2, v3, acc, new_rest, new_rem))
        out = []
        for s, (p2, v3, acc, new_rest, new_rem) in zip(states, upd):
            m = s.masses
            move = m.valid & ~m.fixed
            new_m = dataclasses.replace(
                m, pos=torch.where(move, p2, m.pos),
                vel=torch.where(move, v3, m.vel),
                acc=torch.where(move, acc, m.acc),
                T=m.T + torch.where(move, dt, 0.0))
            new = dataclasses.replace(s, masses=new_m, t=s.t + dt)
            if shape.has_breathing:
                new = dataclasses.replace(
                    new, stencil=dataclasses.replace(s.stencil,
                                                     rest=new_rest),
                    springs=dataclasses.replace(s.springs, rest=new_rem))
            out.append(new)
        return out

    def run(shards: List[SimState], n_steps: int) -> List[SimState]:
        folded = fold_validity(shape, mesh, shards)
        mag_src = None
        if shape.has_magnets:
            # every valid mass is a source, magnetic or not (the reference
            # grid inserts every mass, sim.cu:842): gathered once a chunk
            mag_src = tuple(comm.all_gather(
                mesh, [getattr(s.masses, f) for s in folded])
                for f in ("mag_rad", "mag_scale", "valid"))
        states = folded
        for _ in range(int(n_steps)):
            states = local_step(states, mag_src)
        # the unfolded masks and valid flags go back into the state
        return [dataclasses.replace(
            s, stencil=dataclasses.replace(s.stencil, mask=o.stencil.mask),
            springs=dataclasses.replace(s.springs, valid=o.springs.valid))
            for s, o in zip(states, shards)]

    return run


def _pairwise_block(cfg, src_pos, mag_src, m, pos, my0):
    """Exact pairwise magnet force on one shard's receivers against every
    gathered source (``halo.py:322-351``; reference
    computeExternalMagnetForce, sim.cu:1223-1241)."""
    src_rad, src_scale, src_ok = mag_src
    diff = pos[:, :, None] - src_pos[:, None, :]            # [3, B, N]
    dist2 = torch.sum(diff * diff, dim=0)
    dist = torch.where(dist2 > 0,
                       torch.sqrt(torch.where(dist2 > 0, dist2, 1.0)), 0.0)
    b, n = dist.shape
    ridx_g = my0 + torch.arange(b, device=pos.device)[:, None]
    sidx_g = torch.arange(n, device=pos.device)[None, :]
    pair_ok = ((dist < cfg.magnet_cutoff) & (ridx_g != sidx_g)
               & m.valid[:, None] & src_ok[None, :])
    safe = torch.where(dist > 0, dist, 1.0)
    inter = dist - (m.mag_rad[:, None] + src_rad[None, :])
    shell = torch.where(inter < 0,
                        torch.abs(inter) * m.mag_stiffness[:, None], 0.0)
    attract = (src_scale[None, :] * m.mag_maxf[:, None]
               / torch.clamp(dist2, min=1e-12))
    coeff = torch.where(pair_ok, (shell - attract) / safe, 0.0)
    return torch.sum(diff * coeff[None], dim=2)


def place(state: SimState, mesh: Mesh, axis: str = "shard") -> List[SimState]:
    """This process's shards of ``state`` with the halo path's placement
    (``halo.py:483-505``; ``sharded.shard_state``)."""
    from .sharded import shard_state
    return shard_state(state, mesh, axis)
