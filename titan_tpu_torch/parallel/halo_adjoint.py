"""The distributed tiled adjoint: gradients across shards.  The
counterpart of ``titan_tpu/parallel/halo_adjoint.py``.

Each segment of a rollout is a ``torch.autograd.Function`` on the global
state, as ``ops/adjoint_tiled.py``'s is on one device:

  forward  : the distributed tiled chunk (``halo_tiled.py``) over the
             segment, keeping only its input state;
  backward : (1) the replay: the same distributed forward, each shard's
             window widened to the backward's halo HW (2h for Euler and
             Verlet, 4h for RK2, ``halo_adjoint.py:16-19``) with pos and vel
             exchanged before every step, so that each shard's trace entry,
             written by the per-step trace kernel (PERF.md row 5) over the
             whole window, holds the step's true input on every row; a
             glue scene's trace also holds each pass's constant force, its
             halos exchanged (9 rows, 12 under RK2);
             (2) the reverse sweep: per step the neighbours' HW edge rows of
             the cotangent carry (gpos, gvel, gacc) are copied into each
             shard's halos, and the per-step tiled backward (B7, PERF.md
             row 9: its force and spring phases, five launches under RK2)
             runs on the shard's window; the backward gathers every
             contribution to a row from its window, so the centre rows'
             results are the single-device kernel's;
             (3) the centre rows of the carry and of the per-mass and
             per-spring gradients are gathered and mapped onto the
             segment's inputs (``ops/adjoint.py::assemble_ct``).

Glue scenes (remainder springs, binned magnets).  The replay keeps each
force pass's constant force and remainder rest input.  Per reversed step,
the kernel's force cotangent on the constant force (gf on movable masses)
is gathered from every shard and routed through autograd of the same glue
(``halo_tiled.Glue.force``) at the traced state: the gather's transpose
hands each shard its rows of the position (and velocity) cotangent, the
magnets' per-mass parameter cotangents land likewise, the remainder
springs' parameter cotangents are those of the one replicated evaluation
(the glue runs once per process over every mass, so nothing is counted
twice and no seed needs masking), and the remainder rest's cotangent
chains to the pass before.  The magnet field's vjp is autograd through the
binned pass (``magnets.binned_field_vjp``'s form), whose candidates are the
grid kernel's.  RK2 glue scenes run the split backward
(``halo_adjoint.py:45-55``): pass 2 and the midpoint (B7's rk2b part),
the midpoint glue's vjp, a second exchange of the midpoint cotangents,
then pass 1 (rk2a) and the step glue's vjp.

Trace memory is seg x (6, 9 or 12) rows x (B + 2 HW) x 4 bytes a shard.
Envelope (``halo_adjoint_reject_reason``): the distributed tiled forward's,
persistent external force, and HW at most a block (one-hop exchange).  The
JAX module's VMEM test has no counterpart.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..config import Integrator
from ..ops.adjoint import (LEAVES, _bar_keys, _bars_accumulate, _cidx,
                           _force, _force_transpose, assemble_ct,
                           backward_step, leaves_of, segment_outputs,
                           state_from_outputs, torch_rolls, with_leaves)
from ..ops.adjoint_tiled import (TRACE_BYTES, MAX_SEGMENT, _plain_inputs,
                                 bwd_args, tiled_bwd_run)
from ..ops.fused_step import cf_rows
from ..state import SceneShape, SimState
from . import comm
from .halo_tiled import (DistStepper, Glue, _geometry, build_halo_tiled_chunk,
                         halo_tiled_reject_reason)
from .mesh import Mesh
from .sharded import DistributedChunk, pad_state, shard_state

#: B7's launches a reversed step (``csrc/adjoint_body.cuh::
#: enqueue_reversed``): force and spring phases, five under RK2
_PART_ALL, _PART_RK2B, _PART_RK2A = 0, 1, 2


def _geom_dist(shape: SceneShape, n_devices: int):
    """(h, hw, b): the distributed forward's halo and block, and the
    backward's halo depth (``halo_adjoint.py:92-99``)."""
    h, b = _geometry(shape, n_devices)
    mult = 4 if shape.config.integrator is Integrator.RK2 else 2
    return h, mult * h, b


def _has_glue(shape: SceneShape) -> bool:
    return shape.has_remainder or shape.has_magnets


def trace_planes(shape: SceneShape) -> int:
    """Rows of a shard's trace entry: pos and vel, then each force pass's
    constant force for a glue scene (``_tr_planes``)."""
    if not _has_glue(shape):
        return 6
    return 12 if shape.config.integrator is Integrator.RK2 else 9


def halo_adjoint_reject_reason(shape: SceneShape, n_devices: int):
    """None if the distributed adjoint accepts this scene on ``n_devices``
    shards, else a one-line reason (``halo_adjoint.py:102-117``)."""
    r = halo_tiled_reject_reason(shape, n_devices)
    if r is not None:
        return r
    if not shape.config.persistent_extern_force:
        return "strict per-step extern_force mode"
    _, hw, b = _geom_dist(shape, n_devices)
    if hw > b:
        return (f"backward halo {hw} exceeds the per-device block {b} "
                "(one-hop neighbor exchange)")
    return None


def default_segment(shape: SceneShape, n_devices: int, n_steps: int) -> int:
    """``halo_adjoint_rollout``'s default segment (``halo_adjoint.py:623-
    627``): the largest divisor of ``n_steps`` of at most ``MAX_SEGMENT``
    steps whose per-shard trace fits in ``TRACE_BYTES``."""
    _, hw, b = _geom_dist(shape, n_devices)
    cap = max(1, int(TRACE_BYTES // (4 * trace_planes(shape) * (b + 2 * hw))))
    return next(s for s in range(min(n_steps, MAX_SEGMENT, cap), 0, -1)
                if n_steps % s == 0)


# ---------------------------------------------------------------------------
# The glue's transpose
# ---------------------------------------------------------------------------

class GlueVjp:
    """The glue's vjp over a segment: ``pass_vjp`` for each force pass in
    reverse, accumulating the remainder springs' and the magnets'
    parameter cotangents and carrying the remainder rest's."""

    def __init__(self, glue: Glue, grem: Optional[torch.Tensor]):
        self.glue = glue
        shape = glue.shape
        self.chain = (None if not shape.has_remainder else
                      comm._to(grem, glue.dev).to(glue.springs.rest.dtype))
        self.rem = {}
        self.mag = None

    def _field(self, leaves):
        """The binned field of the gathered masses as a function of pos
        and the [4] magnet parameter leaves, 0 on fixed masses
        (``magnets.binned_field_vjp``'s primal)."""
        from ..ops.magnets import binned_magnet_forces, magnet_receiver_idx
        g = self.glue
        shape = g.gshape
        a_cells, cap = shape.magnet_binned
        m = g.masses
        ridx = (magnet_receiver_idx(m, shape.magnet_receivers)
                if shape.magnet_receivers else None)

        def field(pos):
            mm = dataclasses.replace(
                m, pos=pos, mag_rad=leaves[0], mag_stiffness=leaves[1],
                mag_maxf=leaves[2], mag_scale=leaves[3])
            f = binned_magnet_forces(mm, shape.config.magnet_cutoff, a_cells,
                                     cap, chunk_cells=16384,
                                     receivers=shape.magnet_receivers,
                                     ridx=ridx)
            return torch.where(m.fixed, 0.0, f)
        return field

    def pass_vjp(self, pos_all, vel_all, t_i, dt, rest_in, cfbar_all):
        """The vjp of one pass's glue at its traced input (gathered pos,
        vel, the pass's remainder rest input) for the cotangent
        ``cfbar_all`` of its force [3, D b] and the carried rest
        cotangent.  Returns (gpos_all, gvel_all or None)."""
        g = self.glue
        shape = g.shape
        with torch.enable_grad():
            p = pos_all.detach().requires_grad_()
            v = (vel_all.detach().requires_grad_()
                 if shape.has_remainder and shape.has_damping else None)
            leaves, rem_leaves, mag_leaves = [p], [], []
            if v is not None:
                leaves.append(v)
            field = None
            if shape.has_remainder:
                sp = g.springs
                rem_leaves = [rest_in.detach().requires_grad_()] + [
                    getattr(sp, k).detach().requires_grad_()
                    for k in ("k", "damping", "omega", "rate")]
                g.springs = dataclasses.replace(
                    sp, **dict(zip(("k", "damping", "omega", "rate"),
                                   rem_leaves[1:])))
            if shape.has_magnets:
                m = g.masses
                mag_leaves = [getattr(m, k).detach().requires_grad_()
                              for k in ("mag_rad", "mag_stiffness",
                                        "mag_maxf", "mag_scale")]
                field = self._field(mag_leaves)
            try:
                extra, new_rest = g.force(
                    p, v, t_i, dt, rem_leaves[0] if rem_leaves else None,
                    field=field)
            finally:
                if shape.has_remainder:
                    g.springs = sp
            outs, cots = [extra], [cfbar_all]
            if shape.has_remainder:
                outs.append(new_rest)
                cots.append(self.chain)
            every = leaves + rem_leaves + mag_leaves
            grads = torch.autograd.grad(outs, every, cots, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for gr, x in zip(grads, every)]
        gpos = grads[0]
        gvel = grads[1] if v is not None else None
        k = len(leaves)
        if shape.has_remainder:
            self.chain = grads[k]
            for name, gr in zip(("k", "damping", "omega", "rate"),
                                grads[k + 1:k + 5]):
                self.rem[name] = self.rem.get(name, 0) + gr
            k += 5
        if shape.has_magnets:
            gm = torch.stack(grads[k:k + 4])
            self.mag = gm if self.mag is None else self.mag + gm
        return gpos, gvel


# ---------------------------------------------------------------------------
# The backward on the shards
# ---------------------------------------------------------------------------

class _ShardSweep:
    """One shard's reverse sweep over its window: the plain version
    (``ops/adjoint.py::backward_step`` on the tiled staging, split at RK2's
    midpoint for glue scenes) on the CPU, B7's per-step parts on the
    card."""

    def __init__(self, kern, trace, gpos, gvel, gacc, np_rows: int,
                 glue: bool):
        self.k = kern
        self.glue = glue
        self.trace = trace
        self.kind = kern.kind
        if self.kind == "cpu":
            self.P = _plain_inputs(kern.shape, kern.inv)
            self.rg, self.rs = torch_rolls()
            self.gp, self.gv, self.ga = gpos, gvel, gacc
            self.acc = {}
            return
        self.a, self.g, self.scratch, self._keep = bwd_args(
            kern.shape, kern.wstate, trace, gpos, gvel, gacc, kern.inv,
            mega=False, np_rows=np_rows)
        self._args = (gpos, gvel, gacc)
        self.gp, self.gv, self.ga = (self.g[x] for x in ("pos", "vel",
                                                         "acc"))
        self.stream = torch.cuda.current_stream(kern.dev).cuda_stream
        self.lib = _bwd_lib()
        self._call(self.lib.titan_tiled_bwd_begin)

    def _call(self, fn, *args):
        rc = fn(ctypes.byref(self.a), *args, self.stream)
        if rc != 0:
            raise RuntimeError(f"distributed tiled backward kernel launch "
                               f"failed: CUDA error {rc}")

    def _accumulate(self, bars, shape):
        for key in _bar_keys(shape):
            b = torch.stack(bars[key])
            self.acc[key] = self.acc[key] + b if key in self.acc else b
        for key in ["cf", "minv"] + ["drag"] * shape.has_drag:
            self.acc[key] = (self.acc[key] + bars[key] if key in self.acc
                             else bars[key])

    def _t_now(self, t):
        return self.P["t0"] + t * self.P["dt"]

    def step_all(self, t: int):
        """Reversed step t whole.  Returns, for a glue scene, the cotangent
        on the pass's constant force, a [3, n] window."""
        if self.kind == "cpu":
            tr = self.trace
            self.gp, self.gv, self.ga, bars = backward_step(
                tr[t, :3], tr[t, 3:6], self.gp, self.gv, self.ga, self.P,
                self.rg, self.rs, self._t_now(t), s_idx=float(t),
                cfs=cf_rows(tr, t))
            self._accumulate(bars, self.k.shape)
            return bars["cf"]
        self._call(self.lib.titan_tiled_bwd_part, t, _PART_ALL)
        self._count(5 if self.a.integrator == 2 else 2)
        if not self.glue:
            return None
        return self.scratch[0] * (1.0 - self.k.inv["fixed"])

    def step_b(self, t: int):
        """RK2's pass 2 and midpoint (the split backward's first part).
        Returns (pos_h, vel_h, the pass's constant-force cotangent), and
        leaves the midpoint's cotangents in ``mid`` for ``step_a``."""
        if self.kind == "cpu":
            tr = self.trace
            r = _rk2_part_b(tr[t, :3], tr[t, 3:6], self.gp, self.gv,
                            self.ga, self.P, self.rg, self.rs,
                            self._t_now(t), float(t), cf_rows(tr, t))
            self._pending = r
            self.mid = [r["gpos_h"], r["gv_h"]]
            return r["pos_h"], r["vel_h"], r["bars"]["cf"]
        self._call(self.lib.titan_tiled_bwd_part, t, _PART_RK2B)
        self._count(3)
        s = self.scratch
        self.mid = [s[1], s[2]]
        return s[3], s[4], s[0] * (1.0 - self.k.inv["fixed"])

    def step_a(self, t: int):
        """RK2's pass 1 after ``step_b`` and the midpoint glue.  Returns
        the pass's constant-force cotangent."""
        if self.kind == "cpu":
            r = self._pending
            r["gpos_h"], r["gv_h"] = self.mid
            tr = self.trace
            self.gp, self.gv, self.ga, bars, cf1 = _rk2_part_a(
                r, tr[t, :3], tr[t, 3:6], self.P, self.rg, self.rs,
                self._t_now(t))
            self._accumulate(bars, self.k.shape)
            return cf1
        self._call(self.lib.titan_tiled_bwd_part, t, _PART_RK2A)
        self._count(2)
        return self.scratch[0] * (1.0 - self.k.inv["fixed"])

    def _count(self, launches: int):
        tiled_bwd_run.step_launches += launches
        tiled_bwd_run.plain_launches += launches * self.a.plain_springs

    def bars(self) -> dict:
        """The window's gradient accumulators: k, rest (, damping, omega,
        aratedt) [F, n], cf [3, n], minv (, drag) [n]."""
        if self.kind == "cpu":
            out = dict(self.acc)
            out["minv"] = out["minv"][0]
            if "drag" in out:
                out["drag"] = out["drag"][0]
            return out
        return {k: v for k, v in self.g.items()
                if k not in ("pos", "vel", "acc")}


def _bwd_lib():
    from ..ops.adjoint_tiled import _lib
    return _lib()


def _rk2_part_b(pos, vel, gpos2, gvel2, gacc2, P, rg, rs, t_now, s_idx,
                cfs):
    """The first part of ``ops/adjoint.py::backward_step``'s RK2 branch:
    the step's two force passes, then pass 2's transpose at the midpoint.
    Returns what ``_rk2_part_a`` continues from."""
    nf, fx, dt = 1.0 - P["fixed"], P["fixed"], P["dt"]
    cf1, cf2 = cfs
    c1, c2 = _cidx(P, s_idx, 1.0), _cidx(P, s_idx, 2.0)
    f1, vel1, st1 = _force(pos, vel, P, rg, rs, t_now, keep_stages=True,
                           cidx=c1, cf=cf1)
    acc1 = f1 * P["minv"]
    pos_h = (pos + 0.5 * vel1 * dt) * nf + pos * fx
    vel_h = (vel1 + 0.5 * acc1 * dt) * nf + vel1 * fx
    t_h = t_now + 0.5 * dt
    f2, _, st2 = _force(pos_h, vel_h, P, rg, rs, t_h, keep_stages=True,
                        cidx=c2, cf=cf2)
    gacc = gacc2 * nf + gvel2 * (dt * nf)
    gf2 = gacc * P["minv"]
    gpos_h, gv_h, bars = _force_transpose(pos_h, vel_h, gf2, gpos2 * (dt * nf),
                                          P, rg, rs, t_h, st2, cidx=c2)
    return dict(pos_h=pos_h, vel_h=vel_h, gpos_h=gpos_h, gv_h=gv_h,
                bars=bars, f1=f1, st1=st1, c1=c1, gpos=gpos2 + 0.0,
                gacc_prev=gacc2 * fx, gvel1=gvel2 * nf, gvel0=gvel2 * fx,
                minv_bar=torch.sum(gacc * f2, dim=0, keepdim=True))


def _rk2_part_a(r, pos, vel, P, rg, rs, t_now):
    """The rest of ``backward_step``'s RK2 branch from ``_rk2_part_b``,
    whose midpoint cotangents (``gpos_h``, ``gv_h``) the caller may have
    added the midpoint glue's to: pass 1's transpose.  Returns (gpos, gvel,
    gacc_prev, bars, pass 1's constant-force cotangent)."""
    nf, dt = 1.0 - P["fixed"], P["dt"]
    gvel1 = r["gvel1"] + r["gv_h"] + r["gpos_h"] * (0.5 * dt * nf)
    gacc1 = r["gv_h"] * (0.5 * dt * nf)
    gpos = r["gpos"] + r["gpos_h"]
    gf1 = gacc1 * P["minv"]
    minv_bar = r["minv_bar"] + torch.sum(gacc1 * r["f1"], dim=0,
                                         keepdim=True)
    gp_c, gv_c, bars1 = _force_transpose(pos, vel, gf1, gvel1, P, rg, rs,
                                         t_now, r["st1"], cidx=r["c1"])
    cf1 = bars1["cf"]
    bars = r["bars"]
    _bars_accumulate(bars, bars1)
    bars["minv"] = minv_bar
    return gpos + gp_c, r["gvel0"] + gv_c, r["gacc_prev"], bars, cf1


def dist_bwd(shape: SceneShape, mesh: Mesh, axis: str, s0: SimState,
             seg: int, gpos, gvel, gacc, grem) -> dict:
    """Replay and reverse sweep of one segment from ``s0`` (module
    docstring) for the cotangents of its output; returns the gradient dict
    of ``ops/adjoint_tiled.py::tiled_bwd_run`` on the global (unpadded)
    mass axis, with a glue scene's remainder and magnet gradients under
    ``glue_rem`` and ``mag``."""
    n = s0.masses.valid.shape[-1]
    d_all = mesh.shape[axis]
    _, hw, b = _geom_dist(shape, d_all)
    rows = trace_planes(shape)
    glue = _has_glue(shape)
    rk2 = shape.config.integrator is Integrator.RK2
    shards = shard_state(pad_state(s0, d_all * b), mesh, axis, b)
    st = DistStepper(shape, mesh, shards, b, hw, trace_rows=rows)
    kern = st.kern
    traces = [torch.empty((seg, rows, k.n), dtype=torch.float32,
                          device=k.dev) for k in kern]
    for s in range(seg):
        st.step(s, entries=[tr[s] for tr in traces])

    def window(x):
        pad = torch.nn.functional.pad(x, (0, d_all * b - n))
        blocks = comm.local_rows(mesh, pad.contiguous(), b)
        return [torch.nn.functional.pad(bl, (hw, hw)).contiguous()
                for bl in blocks]
    f32 = lambda x: x.to(torch.float32)                     # noqa: E731
    gp0, gv0, ga0 = (window(f32(x)) for x in (gpos, gvel, gacc))
    sweeps = [_ShardSweep(k, tr, p, v, a, rows, glue)
              for k, tr, p, v, a in zip(kern, traces, gp0, gv0, ga0)]
    vjp = GlueVjp(st.glue, grem) if glue else None
    centres = lambda xs: [k.centre(x) for k, x in zip(kern, xs)]  # noqa
    rtrace = st.rtrace
    dt32, t032 = st.dt32, st.t032

    def add_glue(cfbars, pos, vel, t_i, rest_in, dst_p, dst_v):
        """The vjp of one pass's glue, each shard's rows added to the
        centres of ``dst_p`` (and ``dst_v``)."""
        cf_all = comm.all_gather(mesh, centres(cfbars))
        p_all = comm.all_gather(mesh, centres(pos))
        v_all = comm.all_gather(mesh, centres(vel))
        gp_all, gv_all = vjp.pass_vjp(p_all, v_all, t_i, dt32, rest_in,
                                      cf_all)
        for k, d, r in zip(kern, dst_p, comm.local_rows(mesh, gp_all, b)):
            k.centre(d).add_(r)
        if gv_all is not None:
            for k, d, r in zip(kern, dst_v,
                               comm.local_rows(mesh, gv_all, b)):
                k.centre(d).add_(r)

    for t in range(seg - 1, -1, -1):
        for carry in ("gp", "gv", "ga"):
            comm.fill_halos(mesh, [getattr(sw, carry) for sw in sweeps], hw,
                            b)
        t_i = t032 + t * dt32
        pos_t = [tr[t, 0:3] for tr in traces]
        vel_t = [tr[t, 3:6] for tr in traces]
        if glue and rk2:
            mids = [sw.step_b(t) for sw in sweeps]
            add_glue([m[2] for m in mids], [m[0] for m in mids],
                     [m[1] for m in mids], t_i + 0.5 * dt32,
                     rtrace[2 * t + 1],
                     [sw.mid[0] for sw in sweeps],
                     [sw.mid[1] for sw in sweeps])
            for j in range(2):
                comm.fill_halos(mesh, [sw.mid[j] for sw in sweeps], hw, b)
            cf1 = [sw.step_a(t) for sw in sweeps]
            add_glue(cf1, pos_t, vel_t, t_i, rtrace[2 * t],
                     [sw.gp for sw in sweeps], [sw.gv for sw in sweeps])
        else:
            cfs = [sw.step_all(t) for sw in sweeps]
            if glue:
                add_glue(cfs, pos_t, vel_t, t_i, rtrace[t],
                         [sw.gp for sw in sweeps], [sw.gv for sw in sweeps])

    def gathered(xs):
        return comm.all_gather(mesh, centres(xs))[..., :n]

    g = {"pos": gathered([sw.gp for sw in sweeps]),
         "vel": gathered([sw.gv for sw in sweeps]),
         "acc": gathered([sw.ga for sw in sweeps]),
         "pair_ok": gathered([k.inv["pair_ok"] for k in kern])}
    bars = [sw.bars() for sw in sweeps]
    for key in bars[0]:
        g[key] = gathered([bb[key] for bb in bars])
    if glue:
        g["glue_rem"] = dict(vjp.rem, rest=vjp.chain)
        if shape.has_magnets:
            g["mag"] = vjp.mag[..., :n]
    return g


# ---------------------------------------------------------------------------
# The autograd segment and the public rollout
# ---------------------------------------------------------------------------

class _HaloAdjointSegment(torch.autograd.Function):
    """One segment: the distributed tiled chunk forward, the distributed
    replay and reverse sweep backward
    (``_halo_adjoint_segment_cached``)."""

    @staticmethod
    def forward(ctx, shape, seg, mesh, axis, chunk, state, *leaves):
        out = chunk(with_leaves(state, leaves), seg)
        ctx.shape, ctx.seg, ctx.mesh, ctx.axis = shape, seg, mesh, axis
        ctx.state = state
        ctx.save_for_backward(*leaves)
        outs = segment_outputs(shape, out)
        ctx.mark_non_differentiable(*outs[-2:])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, gpos, gvel, gacc, grest, grem, _gT, _gt):
        shape, seg = ctx.shape, ctx.seg
        s0 = with_leaves(ctx.state, ctx.saved_tensors)
        g = dist_bwd(shape, ctx.mesh, ctx.axis, s0, seg, gpos, gvel, gacc,
                     grem)
        # the glue's remainder gradients are whole here (its rest chain
        # and the parameters it reads): assemble the rest without them
        base = dataclasses.replace(shape, has_remainder=False)
        ct = assemble_ct(base, seg, s0, grest, grem, g)
        if shape.has_remainder:
            rem = g["glue_rem"]
            ct["springs.rest"] = rem["rest"].to(s0.springs.rest.dtype)
            for k, used in (("k", True), ("damping", shape.has_damping),
                            ("omega", shape.has_breathing),
                            ("rate", shape.has_actuated)):
                ct[f"springs.{k}"] = rem[k] if used else None
        return (None,) * 6 + tuple(ct[k] for k in LEAVES)


def halo_adjoint_rollout(shape: SceneShape, state: SimState, mesh: Mesh,
                         n_steps: int, segment=None,
                         axis: str = "shard") -> SimState:
    """Differentiable distributed rollout (module docstring): the forward
    is the distributed tiled chunk, the backward the per-shard replay and
    B7 sweep with exchanged halo windows.  Trace memory is ``segment`` x
    (6, 9 or 12) x (B + 2 HW) x 4 bytes a shard."""
    n_dev = mesh.shape[axis]
    r = halo_adjoint_reject_reason(shape, n_dev)
    if r is not None:
        raise ValueError(
            f"scene outside the distributed adjoint envelope: {r}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    seg = segment or default_segment(shape, n_dev, n_steps)
    if n_steps % seg != 0:
        raise ValueError(f"segment {seg} does not divide n_steps {n_steps}")
    run = build_halo_tiled_chunk(shape, mesh, axis)
    chunk = DistributedChunk("halo_tiled", shape, mesh, axis, run.b, run)
    for _ in range(n_steps // seg):
        state = state_from_outputs(state, _HaloAdjointSegment.apply(
            shape, seg, mesh, axis, chunk, state, *leaves_of(state)))
    return state
