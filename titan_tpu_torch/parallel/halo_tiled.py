"""Distributed tiled stepping: the port's tiled kernels run on each shard's
halo'd window.  The counterpart of ``titan_tpu/parallel/halo_tiled.py``.

The halo route (``halo.py``) steps each block with plain PyTorch; a large
scene then pays the gap between plain PyTorch and the kernel that the
single-device tiled step (``ops/tiled_step.py``) closes.  This route runs
that same kernel on every shard.

Why the kernel composes with halos unchanged.  The port's tiled kernel
gives one thread to each mass of ``[0, n)`` and gathers both incident
springs of each family, clamping or skipping partners outside the array
(``csrc/tiled_step.cu``).  Launched with ``n`` the length of a shard's
window, H + B + H rows (H = max |delta|: the shard's block with both ring
neighbours' H edge rows), every centre row reads only rows inside the
window, and the rows that read past its ends are halo rows, whose results
are thrown away.  So a centre row's arithmetic is the single-device
kernel's, operation for operation:

  - per STEP: the neighbours' H edge rows of pos (+ vel where springs are
    damped) are copied into the halos (``comm.fill_halos``; the state stays
    in window layout between steps, so no centre row is copied), before
    each launch, and before RK2's second pass again;
  - per CHUNK: the invariants (the existence bits, the [F, N] parameter
    planes, the constant force, inverse mass, frozen mask, drag and the
    local-constraint slots) are staged once per shard by
    ``tiled_step.prep_tiled_inputs`` on the shard's window state, which one
    exchange builds; the family scalars are the global ones (each family's
    first masked lane over every shard).  The closed-form ACTUATED rest
    needs no rest carried between steps, so this holds for actuated scenes.

No force is exchanged: springs of a neighbour's edge masses are evaluated
again here, on halo rows.  The ring's first and last shards receive each
other's edges; the pairs across that wrap are masked, because the stencil
mask has no spring past either end of the mass array, and the padding at
its end is inert.  A plain-spring scene with no glue, distributed, is
bitwise the single-device tiled chunk (whose resident-grid segments are
bitwise its per-step launches), on the CPU through the plain version and on
the card through the kernels.

Glue.  Remainder springs and magnets enter as per-pass glue through the
kernel's constant-force input, as in the JAX module (``dist_glue_force``):
one gather of pos (and vel where damped) per force pass, then the
remainder springs evaluated over the gathered state
(``halo.gathered_remainder_forces`` over every mass, their ACTUATED rest
advanced per pass as the JAX glue advances it) and the magnet field of the
gathered masses (``fused_step.magnet_field_fn``: the grid field kernel on
the card, its plain version on the CPU, exactly the single-device tiled
glue's field; each shard keeps its own rows).  The field's compacted
receiver set is the single-device one (``ops/step.py::chunk_ridx`` on the
gathered masses), which plays the role of the JAX module's
``magnet_recv_plan``.  The glue is evaluated once per process, for all of
its shards: in one process D times less work than each shard evaluating
it, and between processes the same replicated evaluation the JAX glue's
setup makes.  The single-device tiled step runs remainder springs inside
its kernel with a closed-form rest, so a distributed remainder scene agrees
with it to a tolerance, not bitwise.

Distributed resident grids (``_dist_mega_plan``): a shard's window widened
to KH = k h rows a side (2 k h under RK2), one resident-grid launch of k
steps over it with no exchange inside (``titan_tiled_segment``); errors
creep inward one force reach a step and stop short of the centre.  The
gate is the JAX module's rule and its TPU-measured constant,
``DIST_MEGA_MAX_TAX``; ``TITAN_DIST_MEGA=1`` forces it on, ``=0`` off.

Envelope (``halo_tiled_reject_reason``): the tiled step's; magnet scenes
need the binned structure (exact-pairwise ones stay on ``halo.py``); and
``use_pallas``.  Blocks are ceil(N / D) masses, at least H, the mass axis
padded with inert rows, so any mass count is accepted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import List

import torch

from ..config import Integrator
from ..ops import tiled_step as T
from ..ops.fused_step import family_scalars
from ..state import SceneShape, SimState
from . import comm
from .mesh import Mesh
from .sharded import _mass_dim, block_size

#: the distributed resident grid's gate: a shard's k-step window pays a
#: redundant-compute tax of 2 KH / b for the per-launch cost it saves; the
#: JAX package measured break-even on a TPU and engages only at a tax of
#: at most this (``halo_tiled.py:74-87``).  Not retuned for the card.
DIST_MEGA_MAX_TAX = 0.08


def _geometry(shape: SceneShape, n_devices: int):
    """(h, b): the halo width max |delta| and the shard's block, ceil(N /
    D) masses and at least h (one-hop exchange)."""
    h = max(abs(d) for d in shape.stencil_deltas)
    return h, block_size(shape.n_masses, n_devices, at_least=h)


def _dist_mega_plan(shape: SceneShape, b: int, h: int):
    """(k, KH): steps per distributed resident-grid launch and its window's
    halo, or (0, 0) to stay per-step (``halo_tiled.py:93-119``): the scene
    must take resident grids on one device (``tiled_step.mega_seg``), KH =
    k h (2 k h under RK2's double pass) must fit in a block, and 2 KH / b
    must stay within ``DIST_MEGA_MAX_TAX`` unless ``TITAN_DIST_MEGA=1``."""
    force = os.environ.get("TITAN_DIST_MEGA", "")
    if force == "0":
        return 0, 0
    k = T.mega_seg(shape)
    if k == 0:
        return 0, 0
    h_step = 2 * h if shape.config.integrator is Integrator.RK2 else h
    kh = k * h_step
    if kh > b:
        return 0, 0        # the halo exceeds the block (one-hop exchange)
    if force != "1" and 2 * kh > DIST_MEGA_MAX_TAX * b:
        return 0, 0        # the redundant compute would eat the win
    return k, kh


def halo_tiled_reject_reason(shape: SceneShape, n_devices: int):
    """None if the distributed tiled route accepts this scene on
    ``n_devices`` shards, else a one-line reason
    (``halo_tiled.py:137-155``)."""
    r = T.tiled_reject_reason(shape)
    if r is not None:
        return r
    if shape.has_magnets and not shape.magnet_binned:
        return ("exact-pairwise magnet scenes (below "
                "magnet_binned_threshold) stay on the halo-XLA path -- "
                "the distributed glue uses the D-way binned structure")
    if not shape.config.use_pallas:
        return "use_pallas off"
    return None


def halo_tiled_supported(shape: SceneShape, n_devices: int) -> bool:
    return halo_tiled_reject_reason(shape, n_devices) is None


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

def window_shape(shape: SceneShape, n_win: int) -> SceneShape:
    """The shape the kernel sees on a shard's window of ``n_win`` rows: no
    remainder springs or magnets (their forces arrive as glue)."""
    return dataclasses.replace(
        shape, n_masses=n_win, has_remainder=False, has_magnets=False,
        magnet_binned=(), magnet_grid=False, magnet_receivers=0,
        remainder_span=0)


def window_states(mesh: Mesh, shards: List[SimState], hw: int
                  ) -> List[SimState]:
    """Each shard's state over its window [hw + B + hw]: every per-mass
    leaf the tiled staging reads (masses, stencil, lcon) extended by both
    ring neighbours' ``hw`` edge rows, in one exchange."""
    out = [dict() for _ in shards]
    for group in ("masses", "stencil", "lcon"):
        proto = getattr(shards[0], group)
        per = [dict() for _ in shards]
        for f in dataclasses.fields(proto):
            x0 = getattr(proto, f.name)
            d = _mass_dim(group, f.name, x0)
            leaves = [getattr(getattr(s, group), f.name).movedim(d, -1)
                      for s in shards]
            ext = comm.halo_extend(mesh, leaves, hw)
            for i, e in enumerate(ext):
                per[i][f.name] = e.movedim(-1, d).contiguous()
        for i, s in enumerate(shards):
            out[i][group] = dataclasses.replace(getattr(s, group), **per[i])
    return [dataclasses.replace(s, **o) for s, o in zip(shards, out)]


def global_fparams(mesh: Mesh, shape: SceneShape, shards: List[SimState]):
    """The family scalars [5, F] of the whole scene on each shard's device:
    each family's first masked lane over every shard, in axis order
    (``fused_step.family_scalars`` on the global state)."""
    nf = len(shape.stencil_deltas)
    rows = []
    for s in shards:
        fs = family_scalars(shape, s)
        has = s.stencil.mask.any(dim=1).to(fs.dtype)[None]
        rows.append(torch.cat([fs, has])[..., None])        # [6, F, 1]
    every = comm.all_gather(mesh, rows)                      # [6, F, D]
    first = torch.argmax(every[5], dim=1)                    # [F]
    fp = every[:5, torch.arange(nf, device=every.device), first]
    return [comm._to(fp.contiguous(), s.masses.pos.device) for s in shards]


def _backend(dev: torch.device) -> str:
    """"cuda" (the kernels) or "cpu" (their plain versions) for a shard on
    ``dev``; anything else raises."""
    if dev.type in ("cpu", "cuda"):
        return dev.type
    raise ValueError(f"distributed tiled route: shard on {dev}; expected "
                     "cpu or cuda")


class ShardKernels:
    """One shard's staged window for one chunk: its window shape, the
    tiled staging ``inv`` (``prep_tiled_inputs``), and on the card the
    kernel's argument struct (``tiled_step.chunk_struct``, which holds
    pointers into ``inv``) and the stream it launches on."""

    def __init__(self, shape: SceneShape, wstate: SimState, fparams,
                 hw: int, b: int, k_seg: int = 0, trace: bool = False):
        self.hw, self.b = hw, b
        self.n = b + 2 * hw
        self.wstate = wstate
        self.shape = window_shape(shape, self.n)
        self.inv = T.prep_tiled_inputs(self.shape, wstate)
        self.inv["fparams"] = fparams
        self.dev = wstate.masses.pos.device
        self.kind = _backend(self.dev)
        self.trace = trace
        if self.kind == "cuda":
            # c points into the scratch (the RK2 grid's midpoint buffers)
            self.c, _, self._scratch = T.chunk_struct(
                self.shape, wstate, max(k_seg, 1), k_seg, self.inv)
            self.stream = torch.cuda.current_stream(self.dev).cuda_stream
            if trace:
                from ..ops.adjoint_tiled import _lib as trace_lib
                self._run = trace_lib().titan_tiled_trace_pass
            else:
                self._run = T._lib().titan_tiled_pass

    def centre(self, x):
        return x[..., self.hw:self.hw + self.b]

    def launch(self, mode: int, step: int, cf, pos, vel, acc=None,
               pos0=None, vel0=None, v1=None, entry=None):
        """One force pass of ``step`` (its index in the chunk) in ``mode``
        (``tiled_step``'s _EULER, _VERLET, _RK2A, _RK2B) over the window,
        with the constant force ``cf`` [3, n] (None: the staged one).
        Returns the pass's outputs: (pos, vel, acc), or for rk2a (pos_h,
        vel_h, v1), v1 the velocity the local constraints leave (on the
        card None where the scene has none: the kernel then reads the
        step's input velocity).  With ``entry`` (a
        trace entry [rows, n]), the step's input (pos, vel) is written to
        its first 6 rows (rk2a and single passes)."""
        cf = self.inv["const_f"] if cf is None else cf
        if self.kind == "cpu":
            out = pass_plain(self.shape, self.inv, mode, step, cf, pos, vel,
                             acc, pos0, vel0, v1)
            if entry is not None and mode != T._RK2B:
                entry[0:3].copy_(pos)
                entry[3:6].copy_(vel)
            return out
        return self._launch_cuda(mode, step, cf, pos, vel, acc, pos0, vel0,
                                 v1, entry)

    def _launch_cuda(self, mode, step, cf, pos, vel, acc, pos0, vel0, v1,
                     entry):
        p = T._TiledPass()
        e = torch.empty_like
        ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
        p.step, p.mode = step, mode
        p.cforce = cf.data_ptr()
        p.pos, p.vel, p.acc = pos.data_ptr(), vel.data_ptr(), ptr(acc)
        p.pos0, p.vel0, p.v1 = ptr(pos0), ptr(vel0), ptr(v1)
        p.entry = ptr(entry)
        if mode == T._RK2A:
            out = (e(pos), e(vel),
                   e(vel) if "lc" in self.inv else None)
            p.pos_dst, p.vel_dst, p.acc_dst = out[0].data_ptr(), \
                out[1].data_ptr(), None
            p.v1_dst = ptr(out[2])
        else:
            out = (e(pos), e(vel), e(vel))
            p.pos_dst, p.vel_dst, p.acc_dst = (t.data_ptr() for t in out)
            p.v1_dst = None
        rc = self._run(ctypes.byref(self.c), ctypes.byref(p), self.stream)
        if rc != 0:
            raise RuntimeError(f"distributed tiled kernel launch failed: "
                               f"CUDA error {rc}")
        counter = _trace_counter() if self.trace else T.tiled_chunk
        counter.step_launches += 1
        counter.plain_launches += self.c.plain_springs
        return out

    def segment(self, step0: int, k: int, pos, vel, acc):
        """k steps from step ``step0`` over the window with no exchange in
        between: one resident-grid launch on the card
        (``titan_tiled_segment``), k plain passes on the CPU.  Returns
        (pos, vel, acc)."""
        if self.kind == "cpu":
            for s in range(step0, step0 + k):
                pos, vel, acc = plain_step(self, s, None, pos, vel, acc)
            return pos, vel, acc
        c = self.c
        out = [torch.empty_like(pos) for _ in range(3)]
        tmp = [torch.empty_like(pos) for _ in range(3)]
        c.pos_in, c.vel_in, c.acc_in = (t.data_ptr() for t in (pos, vel,
                                                                acc))
        c.pos_out, c.vel_out, c.acc_out = (t.data_ptr() for t in out)
        c.pos_tmp, c.vel_tmp, c.acc_tmp = (t.data_ptr() for t in tmp)
        rc = T._lib().titan_tiled_segment(ctypes.byref(c), int(step0),
                                          self.stream)
        if rc != 0:
            raise RuntimeError(f"distributed resident-grid launch failed: "
                               f"CUDA error {rc}")
        T.tiled_chunk.mega_launches += 1
        T.tiled_chunk.plain_launches += c.plain_springs
        del tmp         # freed on this stream: reused only by later work
        return tuple(out)


def _trace_counter():
    from ..ops.adjoint_tiled import tiled_trace_run
    return tiled_trace_run


def pass_plain(shape: SceneShape, inv: dict, mode: int, step: int, cf, pos,
               vel, acc=None, pos0=None, vel0=None, v1=None):
    """Plain version of one force pass of the per-step kernel: the
    arithmetic of ``tiled_step.tiled_step_plain`` split at RK2's midpoint,
    so that the midpoint's halos can be exchanged between the passes.
    ``cf`` is the pass's constant force.  Returns what ``ShardKernels.
    launch`` returns."""
    dt, t0 = inv["scal"][0], inv["scal"][1]
    frozen, minv = inv["fixed"], inv["minv"]
    keep = 1.0 - frozen
    cfg = shape.config
    if mode == T._RK2A:
        f, v1 = T._forces(shape, inv, pos, vel, t0 + step * dt, 2.0 * step,
                          cf)
        a1 = f * minv
        ph = (pos + 0.5 * v1 * dt) * keep + pos * frozen
        vh = (v1 + 0.5 * a1 * dt) * keep + v1 * frozen
        return ph, vh, v1
    if mode == T._RK2B:
        f, v2m = T._forces(shape, inv, pos, vel, t0 + (step + 0.5) * dt,
                           2.0 * step + 1.0, cf)
        new_acc = f * minv
        v2 = (v1 + new_acc * dt) * keep + vel0 * frozen
        p2 = pos0 + v2m * dt * keep
        return p2, v2, new_acc * keep
    f, vm = T._forces(shape, inv, pos, vel, t0 + step * dt, float(step), cf)
    new_acc = f * minv
    if mode == T._VERLET:
        v2 = vm + 0.5 * (acc + new_acc) * dt
        v2 = v2 * keep + vel * frozen
        p2 = pos + (v2 * dt + 0.5 * new_acc * dt * dt) * keep
    else:
        v2 = vm + new_acc * dt
        if cfg.velocity_clamp:
            vn = T._safe_norm(torch.sum(v2 * v2, dim=0))
            v2 = torch.where(vn > 1.0, v2 / torch.where(vn > 0, vn, 1.0), v2)
        v2 = v2 * keep + vel * frozen
        p2 = pos + v2 * dt * keep
    return p2, v2, new_acc * keep


def plain_step(k: ShardKernels, step: int, cf, pos, vel, acc):
    """One whole step of a shard's window with no exchange inside (a
    resident segment's step, on the CPU)."""
    integ = k.shape.config.integrator
    if integ is Integrator.RK2:
        ph, vh, v1 = pass_plain(k.shape, k.inv, T._RK2A, step, cf, pos, vel)
        return pass_plain(k.shape, k.inv, T._RK2B, step, cf, ph, vh,
                          pos0=pos, vel0=vel, v1=v1)
    mode = T._VERLET if integ is Integrator.VERLET else T._EULER
    return pass_plain(k.shape, k.inv, mode, step, cf, pos, vel, acc)


# ---------------------------------------------------------------------------
# Glue
# ---------------------------------------------------------------------------

class Glue:
    """The per-pass magnet / remainder glue of a chunk (module docstring),
    evaluated once per process over the gathered state.  Made once per
    chunk from the padded shards: the remainder springs with endpoint
    validity folded in (while the arrays are replicated), the frozen mask
    and the magnets' parameters, gathered."""

    def __init__(self, shape: SceneShape, mesh: Mesh, shards: List[SimState],
                 b: int, plain: bool):
        self.shape, self.mesh, self.b = shape, mesh, b
        self.n_all = b * mesh.shape[mesh.axis_names[0]]
        self.dev = mesh.home
        gather = lambda name: comm.all_gather(        # noqa: E731
            mesh, [getattr(s.masses, name) for s in shards])
        self.fixed = gather("fixed")
        valid = gather("valid")
        self.springs = None
        if shape.has_remainder:
            sp = shards[0].springs
            sp = dataclasses.replace(
                sp, **{f.name: comm._to(getattr(sp, f.name), self.dev)
                       for f in dataclasses.fields(sp)})
            if not shape.all_valid:
                sp = dataclasses.replace(
                    sp, valid=sp.valid & valid[sp.left.long()]
                    & valid[sp.right.long()])
            self.springs = sp
        self.field = None
        if shape.has_magnets:
            self.masses = dataclasses.replace(
                shards[0].masses,
                **{name: gather(name) for name in (
                    "pos", "vel", "acc", "extern_force", "m", "T", "fixed",
                    "valid", "drag", "mag_rad", "mag_stiffness", "mag_maxf",
                    "mag_scale")})
            self.gshape = dataclasses.replace(shape, n_masses=self.n_all)
            from ..ops.fused_step import magnet_field_fn
            gstate = dataclasses.replace(shards[0], masses=self.masses)
            self.field = magnet_field_fn(self.gshape, gstate, plain=plain)

    def force(self, pos_all, vel_all, t_i, dt, rem_rest, field=None):
        """The glue force [3, D b] at gathered (pos, vel), and the remainder
        rest after the pass (``dist_glue_force``).  ``field`` replaces the
        magnet field function (the adjoint's differentiable one)."""
        shape = self.shape
        extra = torch.zeros_like(pos_all)
        if shape.has_remainder:
            from .halo import gathered_remainder_forces
            f_rem, rem_rest = gathered_remainder_forces(
                self.springs, pos_all, vel_all, rem_rest, t_i, dt, 0,
                self.n_all, shape.has_breathing, shape.has_damping)
            # spring forces never land on fixed masses (sim.cu:1187-1193)
            extra = extra + torch.where(self.fixed, 0.0, f_rem)
        if shape.has_magnets:
            extra = extra + (field or self.field)(pos_all)
        return extra, rem_rest


def dist_glue_force(glue: Glue, mesh: Mesh, pos_blocks, vel_blocks, t_i, dt,
                    rem_rest):
    """The per-pass glue force on each local shard's block, [3, b] each, and
    the remainder rest after the pass (``halo_tiled.py:181-228``): one
    gather of pos (and vel where damped), the glue over the gathered
    state, each shard's own rows."""
    pos_all = comm.all_gather(mesh, pos_blocks)
    vel_all = (comm.all_gather(mesh, vel_blocks)
               if glue.shape.has_remainder and glue.shape.has_damping
               else None)
    extra, rem_rest = glue.force(pos_all, vel_all, t_i, dt, rem_rest)
    return comm.local_rows(mesh, extra, glue.b), rem_rest


# ---------------------------------------------------------------------------
# The chunk
# ---------------------------------------------------------------------------

def _with_centre(k: ShardKernels, base, extra):
    """``base`` [3, n] with ``extra`` [3, b] added on the centre rows: a
    pass's constant force."""
    cf = base.clone()
    cf[:, k.hw:k.hw + k.b] = base[:, k.hw:k.hw + k.b] + extra
    return cf


class DistStepper:
    """The distributed forward of one chunk on this process's shards, in
    window layout: built once per chunk (one exchange of the window states,
    the staging, the glue), then stepped pass by pass with the halo
    exchanges in between.  ``hw`` is the windows' halo (H for the
    forward; the adjoint's replay uses its backward's deeper one, which
    leaves the centre rows unchanged) and ``trace`` a list of per-shard
    traces [seg, rows, n] the replay writes each step's input (and each
    pass's constant force) into."""

    def __init__(self, shape: SceneShape, mesh: Mesh, shards, b: int,
                 hw: int, trace_rows: int = 0):
        self.shape, self.mesh, self.b, self.hw = shape, mesh, b, hw
        self.rk2 = shape.config.integrator is Integrator.RK2
        self.verlet = shape.config.integrator is Integrator.VERLET
        self.has_glue = shape.has_remainder or shape.has_magnets
        fparams = global_fparams(mesh, shape, shards)
        wstates = window_states(mesh, shards, hw)
        self.kern = [ShardKernels(shape, w, fp, hw, b,
                                  trace=trace_rows > 0)
                     for w, fp in zip(wstates, fparams)]
        self.glue = (Glue(shape, mesh, shards, b,
                          plain=self.kern[0].kind == "cpu")
                     if self.has_glue else None)
        self.pos = [w.masses.pos.to(torch.float32).contiguous()
                    for w in wstates]
        self.vel = [w.masses.vel.to(torch.float32).contiguous()
                    for w in wstates]
        self.acc = [w.masses.acc.to(torch.float32).contiguous()
                    for w in wstates]
        s0 = shards[0]
        self.dt32, self.t032 = s0.dt.float(), s0.t.float()
        self.rem_rest = (comm._to(s0.springs.rest, mesh.home)
                         if shape.has_remainder else None)
        self.rtrace = []            # each pass's remainder rest input

    def exchange(self, xs):
        comm.fill_halos(self.mesh, xs, self.hw, self.b)

    def _glue_cfs(self, pos, vel, t_i, entries, slot):
        """Each shard's constant force of a pass at (pos, vel): const_f
        plus the glue on the centre rows (None without glue).  With trace
        entries, written into their row ``slot`` with the neighbours' rows
        in the halos, so that the backward reads it everywhere."""
        if not self.has_glue:
            return [None] * len(self.kern)
        self.rtrace.append(self.rem_rest)
        extra, self.rem_rest = dist_glue_force(
            self.glue, self.mesh, [k.centre(p) for k, p in zip(self.kern,
                                                               pos)],
            [k.centre(v) for k, v in zip(self.kern, vel)], t_i,
            self.dt32, self.rem_rest)
        cfs = [_with_centre(k, k.inv["const_f"], e)
               for k, e in zip(self.kern, extra)]
        if entries is not None:
            rows = [en[6 + 3 * slot:9 + 3 * slot] for en in entries]
            for r, cf in zip(rows, cfs):
                r.copy_(cf)
            self.exchange(rows)
            cfs = rows
        return cfs

    def step(self, s: int, entries=None):
        """Step ``s`` of the chunk on every shard (``entries``: each
        shard's trace entry of the step, or None)."""
        kern = self.kern
        full = entries is not None          # a replay's trace is whole
        self.exchange(self.pos)
        if self.shape.has_damping or full:
            self.exchange(self.vel)
        t_i = self.t032 + s * self.dt32
        cfs = self._glue_cfs(self.pos, self.vel, t_i, entries, 0)
        ent = entries or [None] * len(kern)
        if self.rk2:
            mids = [k.launch(T._RK2A, s, cf, p, v, entry=e)
                    for k, cf, p, v, e in zip(kern, cfs, self.pos, self.vel,
                                              ent)]
            ph, vh = [m[0] for m in mids], [m[1] for m in mids]
            self.exchange(ph)
            if self.shape.has_damping:
                self.exchange(vh)
            cfs = self._glue_cfs(ph, vh, t_i + 0.5 * self.dt32, entries, 1)
            outs = [k.launch(T._RK2B, s, cf, a, bv, pos0=p, vel0=v, v1=m[2])
                    for k, cf, a, bv, p, v, m in zip(
                        kern, cfs, ph, vh, self.pos, self.vel, mids)]
        else:
            mode = T._VERLET if self.verlet else T._EULER
            outs = [k.launch(mode, s, cf, p, v, a, entry=e)
                    for k, cf, p, v, a, e in zip(kern, cfs, self.pos,
                                                 self.vel, self.acc, ent)]
        self.pos = [o[0] for o in outs]
        self.vel = [o[1] for o in outs]
        self.acc = [o[2] for o in outs]

    def segments(self, step0: int, n_seg: int, k: int, kh: int, shards):
        """``n_seg`` distributed resident-grid segments of ``k`` steps from
        step ``step0``, on windows of halo ``kh`` staged here; the state
        comes back into this stepper's windows."""
        fparams = [kk.inv["fparams"] for kk in self.kern]
        wk = window_states(self.mesh, shards, kh)
        kern = [ShardKernels(self.shape, w, fp, kh, self.b, k_seg=k)
                for w, fp in zip(wk, fparams)]
        def move(src_k, dst_k, src, dst):
            for ks, kd, x, d in zip(src_k, dst_k, src, dst):
                kd.centre(d).copy_(ks.centre(x))

        pos = [w.masses.pos.float().contiguous() for w in wk]
        vel = [w.masses.vel.float().contiguous() for w in wk]
        acc = [w.masses.acc.float().contiguous() for w in wk]
        move(self.kern, kern, self.pos, pos)
        move(self.kern, kern, self.vel, vel)
        move(self.kern, kern, self.acc, acc)
        for si in range(n_seg):
            for xs in (pos, vel, acc):
                comm.fill_halos(self.mesh, xs, kh, self.b)
            outs = [kk.segment(step0 + si * k, k, p, v, a)
                    for kk, p, v, a in zip(kern, pos, vel, acc)]
            pos = [o[0] for o in outs]
            vel = [o[1] for o in outs]
            acc = [o[2] for o in outs]
        move(kern, self.kern, pos, self.pos)
        move(kern, self.kern, vel, self.vel)
        move(kern, self.kern, acc, self.acc)

    def finish(self, shards: List[SimState], n_steps: int) -> List[SimState]:
        """The shards after the chunk (``halo_tiled.py:491-515``): the
        centre rows of pos, vel, acc (frozen masses keep their acc), T and
        t advanced, the closed-form ACTUATED rest at the chunk's end, the
        remainder rest the glue advanced."""
        rk2 = self.rk2
        out = []
        for k, s, p, v, a in zip(self.kern, shards, self.pos, self.vel,
                                 self.acc):
            m = s.masses
            move = k.centre(k.inv["move"])
            dtn = n_steps * s.dt
            acc = torch.where(move, k.centre(a).to(m.acc.dtype), m.acc)
            new_m = dataclasses.replace(
                m, pos=k.centre(p).to(m.pos.dtype),
                vel=k.centre(v).to(m.vel.dtype), acc=acc,
                T=m.T + torch.where(move, dtn, 0.0))
            new = dataclasses.replace(s, masses=new_m, t=s.t + dtn)
            if self.shape.has_actuated:
                n_adv = float(n_steps * (2 if rk2 else 1))
                rest = s.stencil.rest + torch.clamp(
                    k.centre(k.inv["sstop"]), max=n_adv) \
                    * k.centre(k.inv["aratedt"])
                new = dataclasses.replace(new, stencil=dataclasses.replace(
                    s.stencil, rest=rest.to(s.stencil.rest.dtype)))
            if self.shape.has_remainder:
                new = dataclasses.replace(new, springs=dataclasses.replace(
                    s.springs, rest=comm._to(self.rem_rest,
                                             s.springs.rest.device)))
            out.append(new)
        return out


def build_halo_tiled_chunk(shape: SceneShape, mesh: Mesh,
                           axis: str = "shard"):
    """``run(shards, n_steps) -> shards``: the distributed tiled chunk over
    this process's shards (blocks of ``_geometry``'s b masses) with one
    launch of the tiled kernel per shard per step (two under RK2), or
    distributed resident-grid segments where ``_dist_mega_plan`` engages
    (``halo_tiled.py:231-517``)."""
    n_dev = mesh.shape[axis]
    h, b = _geometry(shape, n_dev)
    k_seg, kh = _dist_mega_plan(shape, b, h)

    def run(shards: List[SimState], n_steps: int) -> List[SimState]:
        n_steps = int(n_steps)
        st = DistStepper(shape, mesh, shards, b, h)
        lower = 0
        if k_seg and n_steps >= k_seg:
            n_seg = n_steps // k_seg
            st.segments(0, n_seg, k_seg, kh, shards)
            lower = n_seg * k_seg
        for s in range(lower, n_steps):
            st.step(s)
        return st.finish(shards, n_steps)

    run.b, run.h, run.k_seg, run.kh = b, h, k_seg, kh
    return run
