"""The tiled chunk: counterpart of ``titan_tpu/ops/pallas_tiled.py``.

``tiled_chunk`` advances a scene by n whole steps.  For state on the card it
launches the hand-written CUDA kernels of ``csrc/tiled_step.cu``:
``n // MEGA_SEG`` resident-grid launches of ``MEGA_SEG`` steps each (the
TPU's mega and megark2 modes), then one launch per remaining step (two for
RK2: the TPU's single, rk2a and rk2b modes).  For state on the CPU it runs
``tiled_chunk_plain``, a plain PyTorch transcription of the TPU kernel's
body (``pallas_tiled.py::_build_kernel`` on its non-rsqrt branch) with
``torch.roll`` for its rolls and its accumulation order: per family
``fw - f + roll(f, d)`` from zero, then ``f_acc = fw + (const_f +
remainder)``, then planes, balls, the per-mass local constraints
(``forces.local_slots`` on the fused step's stacked slot array), drag and
the update.  That is the opposite
order of the fused step's, so the two agree to f32 rounding, not bitwise.  There is no fallback
between the two: a CUDA tensor goes to the kernels or raises.

What the TPU kernel's plan carries over (``_plan``): a field that is uniform
within every family rides as one scalar per family, and a uniform k as that
scalar times bit f of one int32 existence mask per mass, in place of the
[F, N] planes the fused step reads; fields that vary ride as [F, N] planes.
ACTUATED rest has the closed form ``rest0 + min(s + 1, s_stop) rate dt``
from the chunk's start (``pallas_tiled.py:41-51``; two advances per dt under
RK2), so no rest is carried through the chunk.

Remainder springs (springs in no stencil family) run inside every per-step
launch (``csrc/step_body.cuh::remainder_forces``, on the fused step's
staging ``forces.stage_remainder``), where the TPU evaluates them between
launches as glue fed through its constant-force input
(``pallas_tiled.py:1609-1640``, ``forces.compact_remainder_forces``).  They
take the families' closed-form ACTUATED rest, where the TPU's glue carries
it step by step: the two agree to ~1e-7 relative.  As on the TPU, a scene
with them takes no resident grid (``mega_seg``).

Magnets.  As on the TPU, the field enters through the constant-force input
as per-step glue (``pallas_tiled.py:1609-1700``): a magnet scene steps one
force pass at a time from Python (``glue_passes``), each pass fed
``const_f + field`` at its own positions, 0 on fixed masses, the RK2
midpoint's evaluated between rk2a and rk2b.  On the card the field is the
pairwise kernel (``csrc/magnets.cu``) for an unbinned scene and the grid
kernel (``csrc/magnets_grid.cu``) for a binned one (``step.magnet_route``,
the fused step's); ``tiled_chunk_plain`` takes their plain versions.  Glue
scenes take no resident grid (``mega_seg``).

A scene whose springs are plain and whose k is family-uniform
(``fused_step.takes_plain_spring_path``: every main path) sums its
families with the plain-spring loop (``csrc/step_body.cuh::
plain_family_sum``) in every kernel but the forward RK2 grid:
``_TiledChunk.plain_springs`` marks it, ``tiled_chunk.plain_launches``
counts the launches that took the loop (``plain_launch_count``) and
``step_kernel_info`` reports each kernel's block, registers and occupancy.

Envelope (``tiled_reject_reason``): f32 Euler, Verlet or RK2, persistent
external force, stencil families.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import (ACTIVE_CONTRACT_THEN_EXPAND, ACTIVE_EXPAND_THEN_CONTRACT,
                      ACTUATED_CONTRACT, ACTUATED_EXPAND, Integrator)
from ..state import SceneShape, SimState
from . import forces as F
from .fused_step import (MAX_BIT_FAMILIES, _LocalSlots, _Remainder,
                         _checked, _finish_chunk, existence_bits,
                         family_scalars, k_rides_bits, local_struct,
                         pass_cforce, remainder_struct,
                         takes_plain_spring_path)
from .forces import _safe_norm
from .step import local_caps

#: steps per resident-grid launch (``pallas_tiled.py:1717``).  Even: the
#: segment's last step lands in its first buffer.  The ``n % MEGA_SEG`` tail
#: runs one launch per step.
MEGA_SEG = 16

# the existence bitmask is one int32 per mass (csrc/tiled_body.cuh)
_MAX_FAMILIES = MAX_BIT_FAMILIES
_INTEGRATOR_CODE = {Integrator.EULER: 0, Integrator.VERLET: 1,
                    Integrator.RK2: 2}


def _plan(shape: SceneShape) -> tuple:
    """The per-family fields that ride as [F, N] planes
    (``pallas_tiled.py::_plan``); every other field the scene uses rides as
    one scalar per family.  A uniform k rides as its scalar times the
    existence bitmask; rest is a plane where it is not uniform and whenever
    the scene is actuated (rest is state there), with the closed-form
    actuation inputs beside it; damping is always a plane, zero where no
    spring exists, because a scalar would damp missing springs too."""
    _, u_rest, _, u_type, u_omega = shape.stencil_uniform
    planes = []
    if not k_rides_bits(shape):
        planes.append("k")
    if not u_rest or shape.has_actuated:
        planes.append("rest")
    if shape.has_actuated:
        planes += ["aratedt", "sstop"]
    if shape.has_damping:
        planes.append("damping")
    if shape.has_breathing and not u_type:
        planes.append("bsign")
    if shape.has_breathing and not u_omega:
        planes.append("bomega")
    return tuple(planes)


def tiled_reject_reason(shape: SceneShape):
    """None if the tiled step accepts this scene, else a one-line reason
    naming the envelope condition that failed."""
    cfg = shape.config
    if cfg.integrator not in _INTEGRATOR_CODE:
        return (f"integrator {cfg.integrator.name} not supported by the "
                "tiled kernel")
    if cfg.dtype != "float32":
        return f"dtype {cfg.dtype} (the tiled kernel is f32-only)"
    if not cfg.use_stencil or not shape.stencil_deltas:
        return "no stencil spring families"
    if not cfg.persistent_extern_force:
        return "strict per-step extern_force mode"
    if len(shape.stencil_deltas) > _MAX_FAMILIES:
        return (f"{len(shape.stencil_deltas)} stencil families > "
                f"{_MAX_FAMILIES} (one bit each in the int32 existence mask)")
    return None


def mega_seg(shape: SceneShape) -> int:
    """Steps per resident-grid launch for this scene, 0 for one launch per
    step (``pallas_tiled.py::_mega_env_ok``): Euler, Verlet or RK2 with no
    per-step glue between steps.  Local constraints are no glue: they run
    inside every step kernel.  Remainder springs run there too, but stay
    off the resident grid by the reference's rule, where they are glue."""
    if shape.config.integrator not in _INTEGRATOR_CODE:
        return 0
    if shape.has_remainder or shape.has_magnets:
        return 0
    return MEGA_SEG


def prep_tiled_inputs(shape: SceneShape, state: SimState) -> dict:
    """The chunk's loop-invariant kernel inputs
    (``pallas_tiled.py::prep_flat_inputs``): the family scalars [5, F] (k, rest, damping, breathing sign and
    frequency) taken from each family's first masked lane, the int32
    existence bitmask (bit f = a spring of family f between two valid
    masses) where k is uniform, the [F, N] planes of ``_plan`` (k and
    damping validity-folded), the closed-form actuation inputs ``aratedt``
    (signed rate * dt) and ``sstop`` (the advance count at which the
    one-sided bound is crossed), and the per-mass inputs: constant force
    m g + extern, inverse mass, the frozen mask (fixed or invalid), drag,
    the [dt, t] scalars, the plane and ball tables, the stacked
    local-constraint slots ``lc`` [L, N] and the remainder springs ``rem``
    (where the scene has them, as the fused step stages them), and
    ``pair_ok``
    (where a spring exists between two valid masses), which the tiled
    adjoint masks its per-spring gradients with."""
    m, st = state.masses, state.stencil
    deltas = shape.stencil_deltas
    dev = m.pos.device
    f32 = torch.float32
    pair_ok = st.mask
    if not shape.all_valid:
        pair_ok = torch.stack([
            pair_ok[fi] & m.valid & torch.roll(m.valid, -d, dims=-1)
            for fi, d in enumerate(deltas)])
    styp = st.type
    fparams = family_scalars(shape, state)
    inv = dict(fparams=fparams, pair_ok=pair_ok)
    plan = _plan(shape)
    if "k" not in plan:
        inv["bits"] = existence_bits(pair_ok)
    else:
        inv["k"] = torch.where(pair_ok, st.k, 0.0).to(f32)
    if "rest" in plan:
        inv["rest"] = st.rest.to(f32)
    if shape.has_actuated:
        # invalid pairs never actuate (reference early-return, sim.cu:1163)
        arate = torch.where(styp == ACTUATED_EXPAND, st.rate,
                            torch.where(styp == ACTUATED_CONTRACT, -st.rate,
                                        0.0))
        aratedt = torch.where(pair_ok, arate, 0.0).to(f32) * state.dt.to(f32)
        abound = torch.where(
            styp == ACTUATED_EXPAND, st.l_max,
            torch.where(styp == ACTUATED_CONTRACT, st.l_min, 0.0)).to(f32)
        nz = aratedt != 0
        sstop = torch.where(
            nz, torch.ceil((abound - st.rest.to(f32))
                           / torch.where(nz, aratedt, 1.0)), 0.0)
        inv["aratedt"], inv["sstop"] = aratedt, torch.clamp(sstop, min=0.0)
    if "damping" in plan:
        inv["damping"] = torch.where(pair_ok, st.damping, 0.0).to(f32)
    if "bsign" in plan:
        inv["bsign"] = torch.where(
            styp == ACTIVE_CONTRACT_THEN_EXPAND, -0.2,
            torch.where(styp == ACTIVE_EXPAND_THEN_CONTRACT, 0.2,
                        0.0)).to(f32)
    if "bomega" in plan:
        inv["bomega"] = st.omega.to(f32)
    move = m.valid & ~m.fixed
    inv.update(
        move=move,
        fixed=(~move).to(f32),
        minv=(1.0 / m.m).to(f32),
        const_f=(m.extern_force + m.m * state.g[:, None]).to(f32),
        drag=m.drag.to(f32),
        scal=torch.stack([state.dt.float(), state.t.float()]))
    planes = torch.zeros((max(shape.n_planes, 1), 6), dtype=f32, device=dev)
    if shape.n_planes:
        g = state.gcon
        planes[: shape.n_planes] = torch.cat([
            g.plane_normal, g.plane_offset[:, None], g.plane_fk[:, None],
            g.plane_fs[:, None]], dim=1).to(f32)
    balls = torch.zeros((max(shape.n_balls, 1), 4), dtype=f32, device=dev)
    if shape.n_balls:
        balls[: shape.n_balls] = torch.cat([
            state.gcon.ball_center, state.gcon.ball_radius[:, None]],
            dim=1).to(f32)
    inv["planes"], inv["balls"] = planes, balls
    if any(local_caps(shape)):
        inv["lc"] = F.stage_local(state.lcon, local_caps(shape), f32)
    if shape.has_remainder:
        inv["rem"] = F.stage_remainder(shape, state, f32)
    return inv


def _forces(shape: SceneShape, inv: dict, pos, vel, t_now, adv_base: float,
            cf=None):
    """(force, mutated velocity) of every mass at (pos, vel), in the TPU
    body's order: families (``family_forces``, pallas_tiled.py:673-738),
    the constant force with the remainder springs' sum added to it (the
    TPU's glue), then planes, balls, local constraints and drag
    (``mass_tail`` :748).  Its norms are gradient-safe at 0
    (``forces._safe_norm``, the same values), so that autograd through the
    plain chunk stays finite: the tiled adjoint's tests hold its transpose
    against that.  ``cf`` is a magnet scene's constant force of the pass
    (``const_f`` + the field), else ``inv["const_f"]``."""
    fp = inv["fparams"]
    nc = shape.config.normal_coeff
    fw = torch.zeros_like(pos)
    for fi, d in enumerate(shape.stencil_deltas):
        diff = torch.roll(pos, -d, dims=-1) - pos
        d2 = torch.sum(diff * diff, dim=0)
        ln = _safe_norm(d2)
        inv_ln = torch.where(ln > 0, 1.0 / torch.where(ln > 0, ln, 1.0), 0.0)
        if "bits" in inv:
            k = fp[0, fi] * ((inv["bits"] >> fi) & 1).to(pos.dtype)
        else:
            k = inv["k"][fi]
        rest = inv["rest"][fi] if "rest" in inv else fp[1, fi]
        if shape.has_actuated:
            adv = torch.clamp(inv["sstop"][fi], max=adv_base + 1.0)
            rest = rest + adv * inv["aratedt"][fi]
        if shape.has_breathing:
            bsign = inv["bsign"][fi] if "bsign" in inv else fp[3, fi]
            bomega = inv["bomega"][fi] if "bomega" in inv else fp[4, fi]
            rest = rest * (1.0 + bsign * torch.sin(bomega * t_now))
        mag = k * (rest - ln)
        if shape.has_damping:
            vr = torch.roll(vel, -d, dims=-1)
            axial = torch.sum((vel - vr) * diff, dim=0) * inv_ln
            mag = mag + axial * inv["damping"][fi]
        f = (mag * inv_ln) * diff
        fw = fw - f + torch.roll(f, d, dims=-1)
    if cf is None:
        cf = inv["const_f"]
    if "rem" in inv:
        R = inv["rem"]
        cf = cf + F.remainder_sum(
            R, pos, vel, t_now, inv["scal"][0], R["rest"],
            (shape.has_damping, shape.has_breathing, shape.has_actuated),
            cidx=adv_base + 1.0)[0]
    f_acc = fw + cf
    planes, balls = inv["planes"], inv["balls"]
    for p in range(shape.n_planes):
        nvec = planes[p, :3][:, None]
        off, fk, fs = planes[p, 3], planes[p, 4], planes[p, 5]
        disp = torch.sum(pos * nvec, dim=0) - off
        inside = disp < 0
        if shape.plane_friction[p]:
            fn_mag = torch.sum(f_acc * nvec, dim=0)
            f_n = fn_mag * nvec
            has_fric = (fs > 0) | (fk > 0)
            v_perp = vel - torch.sum(vel * nvec, dim=0) * nvec
            v_norm = _safe_norm(torch.sum(v_perp * v_perp, dim=0))
            kinetic = v_norm > 1e-16
            fn_abs = torch.abs(fn_mag)
            safe_vn = torch.where(kinetic, v_norm, 1.0)
            f_kin = f_acc - v_perp * (fk * fn_abs / safe_vn)
            f_perp = f_acc - f_n
            fp_norm = _safe_norm(torch.sum(f_perp * f_perp, dim=0))
            f_sta = torch.where(fs * fn_abs > fp_norm, f_acc - f_perp, f_acc)
            f_fric = torch.where(kinetic, f_kin, f_sta)
            f_acc = torch.where(inside & has_fric, f_fric, f_acc)
        contact = torch.where(inside, -disp * nc, 0.0)
        f_acc = f_acc + contact * nvec
    for b in range(shape.n_balls):
        dvec = pos - balls[b, :3][:, None]
        dist = _safe_norm(torch.sum(dvec * dvec, dim=0))
        safe = torch.where(dist > 0, dist, 1.0)
        # a tensor numerator: PyTorch evaluates float / tensor as
        # reciprocal(tensor) * float, two roundings where the kernel has one
        push = torch.where((dist <= balls[b, 3]) & (dist > 0),
                           safe.new_full((), nc) / safe, 0.0)
        f_acc = f_acc + dvec * push
    if "lc" in inv:
        f_acc, vel = F.local_slots(f_acc, pos, vel, inv["lc"],
                                   local_caps(shape), nc)
    if shape.has_drag:
        vn = _safe_norm(torch.sum(vel * vel, dim=0))
        f_acc = f_acc - inv["drag"] * vn * vel
    return f_acc, vel


def tiled_step_plain(shape: SceneShape, inv: dict, pos, vel, acc,
                     step: int, field=None, cfs: list = None):
    """Step ``step`` of a chunk (its index from the chunk's start), plain:
    one force evaluation and the "single" integrate tail, or under RK2 the
    rk2a predictor and the rk2b corrector (``pallas_tiled.py:852-930``).
    The update reads the velocity the local constraints leave; under RK2
    the predictor and corrector start from pass 1's (vel1) and the position
    advances with pass 2's.  Frozen masses keep pos and vel (the midpoint
    velocity of a frozen mass is vel1) and get acc 0.  A magnet scene's
    pass takes the constant force ``const_f + field(pos)`` at its own
    positions (the TPU's per-step glue, ``pallas_tiled.py:1609-1642``: at
    the step's input, and under RK2 again at the midpoint), each appended
    to ``cfs`` where given.  Returns (pos, vel, acc)."""
    cfg = shape.config
    dt, t0 = inv["scal"][0], inv["scal"][1]
    frozen, minv = inv["fixed"], inv["minv"]
    keep = 1.0 - frozen

    def glue(p):
        if field is None:
            return None
        cf = inv["const_f"] + field(p)
        if cfs is not None:
            cfs.append(cf)
        return cf

    if cfg.integrator is Integrator.RK2:
        # rest advances once per force pass: 2 step, then 2 step + 1
        f, v1 = _forces(shape, inv, pos, vel, t0 + step * dt, 2.0 * step,
                        glue(pos))
        a1 = f * minv
        ph = (pos + 0.5 * v1 * dt) * keep + pos * frozen
        vh = (v1 + 0.5 * a1 * dt) * keep + v1 * frozen
        f, v2m = _forces(shape, inv, ph, vh, t0 + (step + 0.5) * dt,
                         2.0 * step + 1.0, glue(ph))
        new_acc = f * minv
        v2 = (v1 + new_acc * dt) * keep + vel * frozen
        p2 = pos + v2m * dt * keep
        return p2, v2, new_acc * keep
    f, vm = _forces(shape, inv, pos, vel, t0 + step * dt, float(step),
                    glue(pos))
    new_acc = f * minv
    if cfg.integrator is Integrator.VERLET:
        v2 = vm + 0.5 * (acc + new_acc) * dt
        v2 = v2 * keep + vel * frozen
        p2 = pos + (v2 * dt + 0.5 * new_acc * dt * dt) * keep
    else:
        v2 = vm + new_acc * dt
        if cfg.velocity_clamp:
            vn = _safe_norm(torch.sum(v2 * v2, dim=0))
            v2 = torch.where(vn > 1.0, v2 / torch.where(vn > 0, vn, 1.0), v2)
        v2 = v2 * keep + vel * frozen
        p2 = pos + v2 * dt * keep
    return p2, v2, new_acc * keep


def finish_tiled_chunk(shape: SceneShape, state: SimState, inv: dict,
                       n_steps: int, pos, vel, acc) -> SimState:
    """The chunk's output state (``pallas_tiled.py:1885-1903``): frozen
    masses get their old acc back, T advances for moving masses, and
    ACTUATED rest, the families' and the remainder springs', takes the
    closed form at the chunk's end (two advances per dt under RK2)."""
    acc = torch.where(inv["move"], acc, state.masses.acc)
    rest, rem_rest = state.stencil.rest, None
    if shape.has_actuated:
        n_adv = float(n_steps * (2 if shape.config.integrator
                                 is Integrator.RK2 else 1))
        rest = rest + torch.clamp(inv["sstop"], max=n_adv) * inv["aratedt"]
        if shape.has_remainder:
            p = inv["rem"]["p"]
            rem_rest = inv["rem"]["rest"] + torch.clamp(p[7], max=n_adv) \
                * p[6]
    return _finish_chunk(shape, state, inv, n_steps, pos, vel, acc, rest,
                         rem_rest)


def tiled_chunk_plain(shape: SceneShape, state: SimState,
                      n_steps: int, trace: list = None,
                      field=None) -> SimState:
    """Plain PyTorch version of the tiled chunk, on whatever device
    ``state`` lives on: each step ``tiled_step_plain`` at its index in the
    chunk, as the kernels' launches number them (resident-grid segments and
    the per-step tail alike).  A magnet scene feeds ``field`` (default
    ``fused_step.magnet_field_fn(shape, state, plain=True)``: the field
    kernels' plain versions) into every pass's constant force.  With a
    ``trace`` list, each step's input (pos, vel) is appended to it as a
    [6, N] tensor, with a magnet scene's per-pass constant forces after it
    ([9, N], [12, N] under RK2): the tiled adjoint's replay."""
    from .fused_step import magnet_field_fn
    inv = prep_tiled_inputs(shape, state)
    if shape.has_magnets and field is None:
        field = magnet_field_fn(shape, state, plain=True)
    m = state.masses
    pos, vel, acc = m.pos, m.vel, m.acc
    for step in range(n_steps):
        entry = [pos, vel]
        pos, vel, acc = tiled_step_plain(shape, inv, pos, vel, acc, step,
                                         field, entry)
        if trace is not None:
            trace.append(torch.cat(entry))
    return finish_tiled_chunk(shape, state, inv, n_steps, pos, vel, acc)


class _TiledArgs(ctypes.Structure):
    """Mirror of ``struct TiledArgs`` in ``csrc/tiled_body.cuh``."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "nf", "n_planes", "n_balls", "clamp", "has_damping",
        "has_breathing", "has_actuated", "has_drag")]
        + [("normal_coeff", ctypes.c_float),
           ("deltas", ctypes.c_int * _MAX_FAMILIES)]
        + [(f, ctypes.c_void_p) for f in (
            "scal", "fparams", "planes", "balls", "bits", "k", "rest",
            "aratedt", "sstop", "damping", "bsign", "bomega", "cforce",
            "minv", "fixed", "drag")]
        + [("local", _LocalSlots), ("rem", _Remainder)])


class _TiledChunk(ctypes.Structure):
    """Mirror of ``struct TiledChunk`` in ``csrc/tiled_step.cu``."""

    _fields_ = ([("a", _TiledArgs)]
                + [(f, ctypes.c_int) for f in (
                    "n_steps", "k_seg", "integrator", "device")]
                + [(f, ctypes.c_void_p) for f in (
                    "pos_in", "vel_in", "acc_in", "pos_out", "vel_out",
                    "acc_out", "pos_tmp", "vel_tmp", "acc_tmp", "pos_half",
                    "vel_half", "vel_v1")]
                + [("plain_springs", ctypes.c_int)])


class _TiledPass(ctypes.Structure):
    """Mirror of ``struct TiledPass`` in ``csrc/tiled_chunk.cuh``: one
    per-step launch of a magnet scene with its pass's constant force."""

    _fields_ = ([("step", ctypes.c_int), ("mode", ctypes.c_int)]
                + [(f, ctypes.c_void_p) for f in (
                    "cforce", "pos", "vel", "acc", "pos0", "vel0", "pos_dst",
                    "vel_dst", "acc_dst", "v1_dst", "v1", "entry")])


# the per-step kernel's modes (csrc/tiled_body.cuh enum Mode)
_EULER, _VERLET, _RK2A, _RK2B = 0, 1, 2, 3
#: ``step_kernel_info``'s names of those modes
STEP_MODES = ("euler", "verlet", "rk2a", "rk2b")


def _lib():
    from .. import _build
    lib = _build.load("tiled_step")
    lib.titan_tiled_chunk.argtypes = [ctypes.POINTER(_TiledChunk),
                                      ctypes.c_void_p]
    lib.titan_tiled_chunk.restype = ctypes.c_int
    lib.titan_tiled_pass.argtypes = [ctypes.POINTER(_TiledChunk),
                                     ctypes.POINTER(_TiledPass),
                                     ctypes.c_void_p]
    lib.titan_tiled_pass.restype = ctypes.c_int
    lib.titan_tiled_coop_blocks.argtypes = [ctypes.c_int] * 3
    lib.titan_tiled_coop_blocks.restype = ctypes.c_int
    lib.titan_tiled_kernel_info.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.titan_tiled_kernel_info.restype = ctypes.c_int
    return lib


def coop_blocks(integrator: Integrator, device=None,
                plain: bool = False) -> int:
    """The co-resident block limit of the resident-grid kernel that
    ``integrator`` launches: the largest grid a cooperative launch takes
    (``plain``: the plain-spring Euler / Verlet grid, 512 threads a block;
    else, and for the forward RK2 grid, 256)."""
    dev = torch.device("cuda", device if device is not None
                       else torch.cuda.current_device())
    got = _lib().titan_tiled_coop_blocks(
        _INTEGRATOR_CODE[integrator], dev.index, int(plain))
    if got <= 0:
        raise RuntimeError(f"tiled_step: cooperative launch unavailable on "
                           f"{dev} (CUDA error {-got})")
    return got


def step_kernel_info(kind: str, mode, plain: bool, rem: bool = False,
                     trace: bool = False, device=None) -> dict:
    """What one kernel of the tiled chunk (``trace``: of its replay,
    ``csrc/tiled_adjoint.cu``) launches with: threads a block, registers
    a thread, local-memory bytes a thread (spills) and co-resident blocks
    an SM.  ``kind`` "step": the per-step kernel of ``mode`` (one of
    ``STEP_MODES``; ``rem``: its remainder instantiation); "grid": the
    resident grid of ``mode`` (an ``Integrator``).  ``plain``: the kernel
    a scene on the plain-spring path launches (the forward RK2 grid: its
    general body)."""
    dev = torch.device("cuda", device if device is not None
                       else torch.cuda.current_device())
    code = STEP_MODES.index(mode) if kind == "step" \
        else _INTEGRATOR_CODE[mode]
    if trace:
        from .adjoint_tiled import _lib as trace_lib
        fn = trace_lib().titan_tiled_trace_kernel_info
    else:
        fn = _lib().titan_tiled_kernel_info
    out = (ctypes.c_int * 4)()
    rc = fn(("step", "grid").index(kind), code, int(plain), int(rem),
            dev.index, out)
    if rc != 0:
        raise RuntimeError(f"tiled_step step_kernel_info: CUDA error {rc}")
    return dict(zip(("threads", "registers", "local_bytes", "blocks_per_sm"),
                    out))


def chunk_struct(shape: SceneShape, state: SimState, n_steps: int,
                 k_seg: int, inv: dict):
    """(``_TiledChunk`` for ``n_steps`` steps from ``state`` with the
    staging ``inv`` (``prep_tiled_inputs``), its three output tensors pos,
    vel, acc, the scratch it points into); raises naming any input the
    kernels do not take.  ``k_seg`` is 0 (one launch per step throughout)
    or ``MEGA_SEG``."""
    reason = tiled_reject_reason(shape)
    if reason is not None:
        raise ValueError(f"tiled_chunk: scene outside the envelope: {reason}")
    if k_seg and not mega_seg(shape):
        raise ValueError("tiled_chunk: this scene takes per-step launches "
                         "only (k_seg 0)")
    cfg = shape.config
    m = state.masses
    dev = m.pos.device
    n, nf = shape.n_masses, len(shape.stencil_deltas)
    vec, fam = (3, n), (nf, n)
    a = _TiledArgs()
    a.n, a.nf = n, nf
    a.n_planes, a.n_balls = shape.n_planes, shape.n_balls
    a.clamp = int(cfg.velocity_clamp)
    a.has_damping, a.has_breathing = (int(shape.has_damping),
                                      int(shape.has_breathing))
    a.has_actuated, a.has_drag = int(shape.has_actuated), int(shape.has_drag)
    a.normal_coeff = float(cfg.normal_coeff)
    a.deltas[:nf] = shape.stencil_deltas
    kern = "tiled"
    a.scal = _checked("scal", inv["scal"], (2,), kernel=kern)
    a.fparams = _checked("fparams", inv["fparams"], (5, nf), kernel=kern)
    a.planes = _checked("planes", inv["planes"], (max(shape.n_planes, 1), 6),
                        kernel=kern)
    a.balls = _checked("balls", inv["balls"], (max(shape.n_balls, 1), 4),
                       kernel=kern)
    if "bits" in inv:
        a.bits = _checked("bits", inv["bits"], (n,), torch.int32, kern)
    for name in ("k", "rest", "aratedt", "sstop", "damping", "bsign",
                 "bomega"):
        if name in inv:
            setattr(a, name, _checked(name, inv[name], fam, kernel=kern))
    a.cforce = _checked("const_f", inv["const_f"], vec, kernel=kern)
    a.minv = _checked("minv", inv["minv"], (n,), kernel=kern)
    a.fixed = _checked("fixed", inv["fixed"], (n,), kernel=kern)
    a.drag = _checked("drag", inv["drag"], (n,), kernel=kern)
    a.local = local_struct(shape, inv, kern)
    a.rem = remainder_struct(shape, inv, kern, closed=True)

    empty = lambda s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    out = [empty(vec) for _ in range(3)]
    tmp = [empty(vec) for _ in range(3)]
    rk2 = cfg.integrator is Integrator.RK2
    # RK2's midpoint, and with local constraints pass 1's mutated velocity
    half = [empty(vec) if rk2 else None for _ in range(2)]
    half.append(empty(vec) if rk2 and "lc" in inv else None)
    c = _TiledChunk()
    c.a = a
    c.n_steps, c.k_seg = n_steps, k_seg
    c.integrator = _INTEGRATOR_CODE[cfg.integrator]
    c.device = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    c.pos_in = _checked("pos", m.pos, vec, kernel="tiled")
    c.vel_in = _checked("vel", m.vel, vec, kernel="tiled")
    c.acc_in = _checked("acc", m.acc, vec, kernel="tiled")
    c.pos_out, c.vel_out, c.acc_out = (t.data_ptr() for t in out)
    c.pos_tmp, c.vel_tmp, c.acc_tmp = (t.data_ptr() for t in tmp)
    c.pos_half, c.vel_half, c.vel_v1 = (None if t is None else t.data_ptr()
                                        for t in half)
    c.plain_springs = int(takes_plain_spring_path(shape))
    return c, out, tmp + half


def launch_counts(shape: SceneShape, n_steps: int, k_seg: int):
    """(resident-grid launches, per-step launches) of an ``n_steps`` chunk
    cut into ``k_seg``-step resident-grid segments (0: none) and a tail of
    one launch per step, two under RK2."""
    n_seg = n_steps // k_seg if k_seg else 0
    per = 2 if shape.config.integrator is Integrator.RK2 else 1
    return n_seg, (n_steps - n_seg * k_seg) * per


def plain_launch_count(shape: SceneShape, mega: int, step: int,
                       trace: bool = False) -> int:
    """How many of ``mega`` resident-grid and ``step`` per-step launches of
    the chunk (``trace``: of its replay) take the plain-spring loop: all
    of them on a scene on the plain-spring path, but the forward RK2
    grid's; none elsewhere (``csrc/tiled_chunk.cuh::grid_plain``)."""
    if not takes_plain_spring_path(shape):
        return 0
    rk2 = shape.config.integrator is Integrator.RK2
    return step + (mega if trace or not rk2 else 0)


def glue_passes(shape: SceneShape, state: SimState, n_steps: int,
                inv: dict, field, run, trace=None):
    """``n_steps`` per-step launches of a magnet scene, one force pass at a
    time (the TPU's per-step magnet glue, ``pallas_tiled.py:1609-1700``):
    the field at the pass's positions (0 on fixed masses), then
    ``run(p)``, which launches one pass (``_TiledPass`` p) of the tiled
    step or of its replay with the constant force ``const_f + field``;
    under RK2 the field is evaluated again at the midpoint, between rk2a
    and rk2b.  With ``trace`` ([n_steps, trace_rows, N]), each pass's
    constant force is written into its row of the step's entry
    (``fused_step.pass_cforce``) and read from there, and the step's first pass carries the entry, where the
    replay writes the step's input (pos, vel).  Returns the final (pos,
    vel, acc)."""
    m = state.masses
    integ = shape.config.integrator
    rk2 = integ is Integrator.RK2
    empty = torch.empty_like
    p = _TiledPass()
    v1 = empty(m.vel) if rk2 and "lc" in inv else None
    pos, vel, acc = m.pos, m.vel, m.acc

    def cforce(step, slot, at):
        return pass_cforce(inv, field, at, trace, step, slot)

    def ptr(t):
        return None if t is None else t.data_ptr()

    for s in range(n_steps):
        p.step = s
        p.entry = None if trace is None else trace[s].data_ptr()
        p.pos0 = p.vel0 = p.v1 = p.v1_dst = None
        fpos, fvel = pos, vel
        if rk2:
            ph, vh = empty(pos), empty(vel)
            cf = cforce(s, 0, pos)
            p.mode, p.cforce = _RK2A, cf.data_ptr()
            p.pos, p.vel, p.acc = pos.data_ptr(), vel.data_ptr(), None
            p.pos_dst, p.vel_dst, p.acc_dst = ph.data_ptr(), vh.data_ptr(), \
                None
            p.v1_dst = ptr(v1)
            run(p)
            p.entry, p.v1_dst, p.v1 = None, None, ptr(v1)
            p.pos0, p.vel0 = pos.data_ptr(), vel.data_ptr()
            fpos, fvel = ph, vh
        out = (empty(pos), empty(vel), empty(acc))
        cf = cforce(s, int(rk2), fpos)
        p.mode = _RK2B if rk2 else (
            _VERLET if integ is Integrator.VERLET else _EULER)
        p.cforce = cf.data_ptr()
        p.pos, p.vel, p.acc = fpos.data_ptr(), fvel.data_ptr(), acc.data_ptr()
        p.pos_dst, p.vel_dst, p.acc_dst = (t.data_ptr() for t in out)
        run(p)
        pos, vel, acc = out
    return pos, vel, acc


def _tiled_chunk_cuda(shape: SceneShape, state: SimState, n_steps: int,
                      k_seg: int, field=None) -> SimState:
    """The kernel chunk: ``n_steps // k_seg`` resident-grid launches, then
    one launch per remaining step (two for RK2); ``k_seg`` is 0 (one
    launch per step throughout) or ``MEGA_SEG``.  A magnet scene runs
    ``glue_passes`` with ``field`` (default
    ``fused_step.magnet_field_fn(shape, state, plain=False)``: the field
    kernels)."""
    inv = prep_tiled_inputs(shape, state)
    c, out, scratch = chunk_struct(shape, state, n_steps, k_seg, inv)
    dev = state.masses.pos.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if shape.has_magnets:
        from .fused_step import magnet_field_fn
        lib = _lib()

        def run(p):
            rc = lib.titan_tiled_pass(ctypes.byref(c), ctypes.byref(p),
                                      stream)
            if rc != 0:
                raise RuntimeError(f"tiled_step kernel launch failed: CUDA "
                                   f"error {rc}")
            tiled_chunk.step_launches += 1
            tiled_chunk.plain_launches += c.plain_springs
        out = glue_passes(shape, state, n_steps, inv,
                          field or magnet_field_fn(shape, state, plain=False),
                          run)
        return finish_tiled_chunk(shape, state, inv, n_steps, *out)
    rc = _lib().titan_tiled_chunk(ctypes.byref(c), stream)
    if rc != 0:
        raise RuntimeError(f"tiled_step kernel launch failed: CUDA error {rc}")
    # The temporaries are freed when this frame drops them, while the
    # kernels may still run: safe, because the caching allocator reuses
    # memory freed on this stream only for later work on it.
    del scratch
    mega, step = launch_counts(shape, n_steps, k_seg)
    tiled_chunk.mega_launches += mega
    tiled_chunk.step_launches += step
    tiled_chunk.plain_launches += plain_launch_count(shape, mega, step)
    return finish_tiled_chunk(shape, state, inv, n_steps, *out)


def tiled_chunk(shape: SceneShape, state: SimState, n_steps) -> SimState:
    """``n_steps`` tiled steps: the CUDA kernels for state on the card, the
    plain version for state on the CPU.  ``tiled_chunk.mega_launches``
    counts resident-grid launches, ``tiled_chunk.step_launches`` per-step
    launches (two per RK2 step), ``tiled_chunk.plain_launches`` those of
    either that ran the plain-spring loop."""
    n_steps = int(n_steps)
    if n_steps <= 0:
        return state
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return tiled_chunk_plain(shape, state, n_steps)
    if dev.type != "cuda":
        raise ValueError(f"tiled_chunk: state on {dev}; expected cpu or cuda")
    return _tiled_chunk_cuda(shape, state, n_steps, mega_seg(shape))


tiled_chunk.mega_launches = 0
tiled_chunk.step_launches = 0
tiled_chunk.plain_launches = 0
