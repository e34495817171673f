"""The fused multi-step chunk: counterpart of ``titan_tpu/ops/pallas_step.py``.

``fused_chunk`` advances a scene by n whole steps.  For state on the card it
launches the hand-written CUDA kernel ``csrc/fused_step.cu`` (one launch per
step, two for RK2); for state on the CPU it runs ``fused_chunk_plain``, a
plain PyTorch transcription of the TPU kernel's body
(``pallas_step.py::_build_kernel``) with ``torch.roll`` for its rolls and its
accumulation order: the constant force first, then per family
``f_acc - f + roll(f, d)``, then the remainder springs' sum, then planes,
balls, the per-mass local constraints, drag and the update.  There is no
fallback between the two: a CUDA tensor goes to the kernel or raises.

Local constraints.  The per-mass slots ride as one stacked [L, N] array
(``forces.stage_local``, built once per chunk): contact planes, balls,
constraint planes and directions in reference order.  Constraint planes and
directions mutate the velocity that drag and the update read; under RK2 the
corrector starts from pass 1's mutated velocity and advances the position
with pass 2's, as ``titan_tpu/ops/step.py``'s RK2 branch does.

Remainder springs (springs in no stencil family: cross-agent links, a
``createSpring`` between any two masses) ride as ``forces.stage_remainder``
stages them: the incidence table [N, D] of ``Topology`` and per-spring rows.
Each mass walks its row and evaluates each of its springs itself (both
endpoints of a spring compute the same force, from the spring's left and
right ends in that order), adding sign x force in row order
(``forces.remainder_sum``).  Where the TPU kernel gathers and scatters
through one-hot selectors on its matrix unit (``pallas_step.py:348-404``),
a thread here simply reads the endpoints.  ACTUATED remainder rest is
carried per spring and advances on every force pass, ping-ponging between
two [S] buffers that start equal (a spring no thread owns keeps its rest);
the left endpoint's thread writes it.

Magnets.  The step kernel has no magnet code.  For a magnet scene each force
pass first computes the magnet field at that pass's positions, 0 on fixed
masses, and the step then runs with the constant force ``const_f + field``
(as the TPU's tiled path feeds its per-step magnet glue,
``pallas_tiled.py:1609-1642``); RK2 evaluates it twice per step, at the
step's input and at its midpoint.  On the card the field is the pairwise
kernel (``csrc/magnets.cu``) for an unbinned scene and the grid kernel
(``csrc/magnets_grid.cu``) for every binned one (``step.magnet_route``),
and the passes are launched one at a time from Python
(``titan_fused_pass``); ``fused_chunk_plain`` takes the plain versions.
Scenes without magnets keep one C call per chunk.  The adjoint's replay
runs the same passes (``_magnet_passes`` with a trace), keeping each pass's
constant force in the trace.

Envelope (``fused_reject_reason``): f32, persistent external force.
Unlike the TPU kernel there is no on-chip memory budget, so N and the
remainder springs have no cap; ``step.chunk_route`` keeps the TPU's
budgets as route rules.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..config import (ACTIVE_CONTRACT_THEN_EXPAND, ACTIVE_EXPAND_THEN_CONTRACT,
                      ACTUATED_CONTRACT, ACTUATED_EXPAND, Integrator)
from ..state import SceneShape, SimState
from . import forces as F
from .magnets import pairwise_params
from .step import chunk_ridx, local_caps, magnet_pass, magnet_route

_INTEGRATOR_CODE = {Integrator.EULER: 0, Integrator.VERLET: 1,
                    Integrator.RK2: 2}
# rows of the family-scalar table (pallas_tiled.py:1416-1422)
SCALAR_ROWS = ("k", "rest", "damping", "type", "omega")
# the existence bitmask is one int32 per mass (csrc/tiled_body.cuh)
MAX_BIT_FAMILIES = 32


def k_rides_bits(shape: SceneShape) -> bool:
    """Whether the kernels take k as one scalar per family times bit f of
    an int32 existence mask per mass (``family_scalars``,
    ``existence_bits``), in place of the [F, N] k plane: where k is uniform
    within every family (``SceneShape.stencil_uniform``, which a
    uniform-breaking edit clears) and the families fit the mask's bits.
    The tiled step's plan and the fused step share this test."""
    return bool(shape.stencil_uniform[0]) and \
        len(shape.stencil_deltas) <= MAX_BIT_FAMILIES


def family_scalars(shape: SceneShape, state: SimState,
                   rows=SCALAR_ROWS) -> torch.Tensor:
    """The family scalars [len(rows), F] f32 (of ``SCALAR_ROWS``: k, rest,
    damping, breathing sign and frequency), each taken from its family's
    first masked lane where that field is uniform within every family,
    else 0 (``pallas_tiled.py::prep_flat_inputs``)."""
    st = state.stencil
    f32 = torch.float32
    uniform = dict(zip(SCALAR_ROWS, shape.stencil_uniform))
    # a family without springs reads lane 0: harmless, its k is 0 there
    lane0 = torch.argmax(st.mask.to(torch.uint8), dim=1)[:, None]
    nf = len(shape.stencil_deltas)

    def field(name):
        if name != "type":
            return dict(k=st.k, rest=st.rest, damping=st.damping,
                        omega=st.omega)[name]
        return torch.where(
            st.type == ACTIVE_CONTRACT_THEN_EXPAND, -0.2,
            torch.where(st.type == ACTIVE_EXPAND_THEN_CONTRACT, 0.2,
                        0.0)).to(f32)
    return torch.stack([
        torch.gather(field(f), 1, lane0)[:, 0].to(f32) if uniform[f]
        else torch.zeros(nf, dtype=f32, device=st.k.device)
        for f in rows]).contiguous()


def existence_bits(pair_ok: torch.Tensor) -> torch.Tensor:
    """The int32 existence mask [N]: bit f of mass m is set where the
    spring (f, m) exists between two valid masses (``pair_ok`` [F, N]);
    the bits are distinct, so their sum is their union."""
    shifts = torch.arange(pair_ok.shape[0], dtype=torch.int32,
                          device=pair_ok.device)[:, None]
    return torch.sum(pair_ok.to(torch.int32) << shifts, dim=0,
                     dtype=torch.int32)


def bits_k(shape: SceneShape, state: SimState, inv: dict) -> tuple:
    """The plain-spring path's k: (``kscal`` [F], ``bits`` [N]), whose
    kscal[f] x bit f of bits[m] is ``inv["k_eff"][f, m]`` bit for bit
    where ``k_rides_bits``; the tiled prep's scalars and bits."""
    return (family_scalars(shape, state, ("k",))[0].contiguous(),
            existence_bits(inv["pair_ok"]))


def fused_reject_reason(shape: SceneShape):
    """None if the fused step accepts this scene, else a one-line reason
    naming the envelope condition that failed."""
    cfg = shape.config
    if cfg.integrator not in _INTEGRATOR_CODE:
        return f"integrator {cfg.integrator.name} not supported in-kernel"
    if cfg.dtype != "float32":
        return (f"dtype {cfg.dtype} (the fused kernel is f32-only; other "
                "dtypes run the eager step)")
    if not cfg.persistent_extern_force:
        return ("strict per-step extern_force mode "
                "(persistent_extern_force=False)")
    return None


def prep_invariants(shape: SceneShape, state: SimState) -> dict:
    """Loop-invariant kernel inputs (``pallas_step.py::prep_invariants``):
    validity folded into k / damping / arate (validity changes only at a
    re-marshal), breathing sign and frequency, inverse mass, the frozen
    mask (fixed or invalid), the constant force m g + extern, the
    [dt, t] scalars, the plane / ball tables, the stacked local-constraint
    slots ``lc`` [L, N] (``forces.stage_local``; only where the scene has
    them), the remainder springs ``rem`` (``forces.stage_remainder``;
    only where the scene has them), and ``pair_ok`` (where a spring exists
    between two valid masses), which the adjoint masks its k / damping /
    rate gradients with."""
    m = state.masses
    dtype = m.pos.dtype
    pair_ok = state.stencil.mask
    if not shape.all_valid and shape.stencil_deltas:
        pair_ok = torch.stack([
            pair_ok[fi] & m.valid & torch.roll(m.valid, -d, dims=-1)
            for fi, d in enumerate(shape.stencil_deltas)])
    st = state.stencil
    styp = st.type
    inv = dict(
        pair_ok=pair_ok,
        k_eff=torch.where(pair_ok, st.k, 0.0),
        damp_eff=torch.where(pair_ok, st.damping, 0.0),
        bsign=torch.where(
            styp == ACTIVE_CONTRACT_THEN_EXPAND, -0.2,
            torch.where(styp == ACTIVE_EXPAND_THEN_CONTRACT, 0.2,
                        0.0)).to(dtype),
        bomega=st.omega,
        minv=(1.0 / m.m)[None, :],
        move=m.valid & ~m.fixed,
        const_f=m.extern_force + m.m * state.g[:, None],
        scal=torch.stack([state.dt.float(), state.t.float()]),
    )
    inv["fixed"] = (~inv["move"]).to(dtype)[None, :]
    planes = torch.zeros((max(shape.n_planes, 1), 6), dtype=torch.float32,
                         device=m.pos.device)
    if shape.n_planes:
        g = state.gcon
        planes[: shape.n_planes] = torch.cat([
            g.plane_normal, g.plane_offset[:, None], g.plane_fk[:, None],
            g.plane_fs[:, None]], dim=1).float()
    balls = torch.zeros((max(shape.n_balls, 1), 4), dtype=torch.float32,
                        device=m.pos.device)
    if shape.n_balls:
        balls[: shape.n_balls] = torch.cat([
            state.gcon.ball_center, state.gcon.ball_radius[:, None]],
            dim=1).float()
    inv["planes"], inv["balls"] = planes, balls
    if any(local_caps(shape)):
        inv["lc"] = F.stage_local(state.lcon, local_caps(shape), dtype)
    if shape.has_remainder:
        inv["rem"] = F.stage_remainder(shape, state, dtype)
    if shape.has_actuated:
        # +rate / -rate / 0 and the matching bound; invalid pairs never
        # mutate rest (reference early-return, sim.cu:1163)
        arate = torch.where(styp == ACTUATED_EXPAND, st.rate,
                            torch.where(styp == ACTUATED_CONTRACT, -st.rate,
                                        0.0))
        inv["arate"] = torch.where(pair_ok, arate, 0.0).to(dtype)
        inv["abound"] = torch.where(
            styp == ACTUATED_EXPAND, st.l_max,
            torch.where(styp == ACTUATED_CONTRACT, st.l_min, 0.0)).to(dtype)
    return inv


def _finish_chunk(shape, state, inv, n_steps, pos, vel, acc, rest,
                  rem_rest=None):
    """The chunk's output state: fresh pos/vel/acc (+ the family and
    remainder rest), advanced T and t."""
    m = state.masses
    dtn = n_steps * state.dt
    new = dataclasses.replace(
        state,
        masses=dataclasses.replace(
            m, pos=pos, vel=vel, acc=acc,
            T=m.T + torch.where(inv["move"], dtn, 0.0)),
        t=state.t + dtn)
    if shape.has_actuated:
        new = dataclasses.replace(new, stencil=dataclasses.replace(
            state.stencil, rest=rest))
        if shape.has_remainder:
            new = dataclasses.replace(new, springs=dataclasses.replace(
                state.springs, rest=rem_rest))
    return new


def magnet_field_fn(shape: SceneShape, state: SimState, plain: bool):
    """``field(pos)``: the fused step's magnet field [3, N] of ``state``'s
    masses moved to ``pos``, 0 on fixed masses (which return before the
    magnet pass, sim.cu:1292-1298, but still act as sources), by
    ``step.magnet_route`` (``plain`` picks the kernels' plain versions).
    What is constant over the chunk (the pairwise kernel's folded
    parameters, the compacted receiver set) is made once here."""
    m = state.masses
    route = magnet_route(shape, m.pos.device, fused=True, plain=plain)
    params = pairwise_params(m) if route == "pairwise" else None
    ridx = chunk_ridx(shape, m) if route == "binned" else None

    def field(pos):
        return torch.where(m.fixed, 0.0, magnet_pass(
            dataclasses.replace(m, pos=pos), shape, ridx, fused=True,
            plain=plain, params=params))
    return field


def fused_chunk_plain(shape: SceneShape, state: SimState,
                      n_steps: int, trace: list = None,
                      field=None) -> SimState:
    """Plain PyTorch version of the fused kernel: ``n_steps`` steps of the
    TPU kernel body (``pallas_step.py::_build_kernel``), sqrt + divide
    norms, on whatever device ``state`` lives on.  With a ``trace`` list,
    each step's input (pos, vel) is appended to it, and for a magnet scene
    each force pass's constant force ``const_f + field`` after them (9 rows,
    12 under RK2): the plain version of the adjoint's trace kernel
    (``ops/adjoint.py::trace_run_plain``).  A magnet scene adds
    ``field(pos)`` to the constant force of every force pass; ``field``
    defaults to ``magnet_field_fn(shape, state, plain=True)`` (the grid
    kernel's plain version for a binned scene on the card, the binned pass
    on the CPU, as in the JAX package off the TPU)."""
    cfg = shape.config
    inv = prep_invariants(shape, state)
    if shape.has_magnets and field is None:
        field = magnet_field_fn(shape, state, plain=True)
    m = state.masses
    dt, t0 = inv["scal"][0], inv["scal"][1]
    frozen = inv["fixed"] != 0
    minv = inv["minv"]
    k, damp = inv["k_eff"], inv["damp_eff"]
    planes, balls = inv["planes"], inv["balls"]
    nc = cfg.normal_coeff
    caps = local_caps(shape)
    rem_flags = (shape.has_damping, shape.has_breathing, shape.has_actuated)
    cfs = []           # the constant force of each pass of a step

    def compute_forces(pos, vel, t_now, rest, rem_rest):
        """(force, mutated velocity, rest, remainder rest) at (pos,
        vel)."""
        f_acc = inv["const_f"]
        if shape.has_magnets:
            f_acc = f_acc + field(pos)
            cfs.append(f_acc)
        new_rest = []
        for fi, d in enumerate(shape.stencil_deltas):
            diff = torch.roll(pos, -d, dims=-1) - pos
            d2 = torch.sum(diff * diff, dim=0)
            ln = torch.sqrt(d2)
            inv_ln = torch.where(ln > 0,
                                 1.0 / torch.where(ln > 0, ln, 1.0), 0.0)
            r = rest[fi]
            if shape.has_actuated:
                ar, ab = inv["arate"][fi], inv["abound"][fi]
                adv = ((ar > 0) & (r < ab)) | ((ar < 0) & (r > ab))
                r = r + torch.where(adv, ar * dt, 0.0)
                new_rest.append(r)
            if shape.has_breathing:
                r = r * (1.0 + inv["bsign"][fi]
                         * torch.sin(inv["bomega"][fi] * t_now))
            mag = k[fi] * (r - ln)
            if shape.has_damping:
                vr = torch.roll(vel, -d, dims=-1)
                axial = torch.sum((vel - vr) * diff, dim=0) * inv_ln
                mag = mag + axial * damp[fi]
            f = (mag * inv_ln) * diff
            f_acc = f_acc - f + torch.roll(f, d, dims=-1)
        if shape.has_remainder:
            f_rem, rem_rest = F.remainder_sum(inv["rem"], pos, vel, t_now,
                                              dt, rem_rest, rem_flags)
            f_acc = f_acc + f_rem
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
                v_norm = torch.sqrt(torch.sum(v_perp * v_perp, dim=0))
                kinetic = v_norm > 1e-16
                fn_abs = torch.abs(fn_mag)
                safe_vn = torch.where(kinetic, v_norm, 1.0)
                f_kin = f_acc - v_perp * (fk * fn_abs / safe_vn)
                f_perp = f_acc - f_n
                fp_norm = torch.sqrt(torch.sum(f_perp * f_perp, dim=0))
                f_sta = torch.where(fs * fn_abs > fp_norm, f_acc - f_perp,
                                    f_acc)
                f_fric = torch.where(kinetic, f_kin, f_sta)
                f_acc = torch.where(inside & has_fric, f_fric, f_acc)
            contact = torch.where(inside, -disp * nc, 0.0)
            f_acc = f_acc + contact * nvec
        for b in range(shape.n_balls):
            dvec = pos - balls[b, :3][:, None]
            dist = torch.sqrt(torch.sum(dvec * dvec, dim=0))
            safe = torch.where(dist > 0, dist, 1.0)
            # a tensor numerator: PyTorch evaluates float / tensor as
            # reciprocal(tensor) * float, two roundings where the kernel
            # has one
            push = torch.where((dist <= balls[b, 3]) & (dist > 0),
                               safe.new_full((), nc) / safe, 0.0)
            f_acc = f_acc + dvec * push
        if any(caps):
            f_acc, vel = F.local_slots(f_acc, pos, vel, inv["lc"], caps, nc)
        if shape.has_drag:
            vn = torch.sqrt(torch.sum(vel * vel, dim=0))
            f_acc = f_acc - m.drag * vn * vel
        return f_acc, vel, (torch.stack(new_rest) if new_rest
                            else rest), rem_rest

    pos, vel, acc = m.pos, m.vel, m.acc
    rest, rem = state.stencil.rest, state.springs.rest
    for step in range(n_steps):
        entry = [pos, vel]
        cfs.clear()
        t_base = t0 + step * dt
        if cfg.integrator is Integrator.RK2:
            # the predictor and the corrector start from pass 1's mutated
            # velocity vel1 (a frozen mass's midpoint velocity is vel1);
            # the position advances with pass 2's mutated velocity vel2
            f1, vel1, rest, rem = compute_forces(pos, vel, t_base, rest, rem)
            acc1 = f1 * minv
            pos_h = torch.where(frozen, pos, pos + 0.5 * vel1 * dt)
            vel_h = torch.where(frozen, vel1, vel1 + 0.5 * acc1 * dt)
            f2, vel2, rest, rem = compute_forces(pos_h, vel_h,
                                                 t_base + 0.5 * dt, rest, rem)
            new_acc = f2 * minv
            v2 = vel1 + new_acc * dt
            p2 = pos + vel2 * dt
        else:
            f, vel_m, rest, rem = compute_forces(pos, vel, t_base, rest, rem)
            new_acc = f * minv
            if cfg.integrator is Integrator.VERLET:
                v2 = vel_m + 0.5 * (acc + new_acc) * dt
                p2 = pos + (v2 * dt + 0.5 * new_acc * dt * dt)
            else:
                v2 = vel_m + new_acc * dt
                if cfg.velocity_clamp:
                    vn = torch.sqrt(torch.sum(v2 * v2, dim=0))
                    v2 = torch.where(vn > 1.0,
                                     v2 / torch.where(vn > 0, vn, 1.0), v2)
                p2 = pos + v2 * dt
        if trace is not None:
            trace.append(torch.cat(entry + cfs))
        pos = torch.where(frozen, pos, p2)
        vel = torch.where(frozen, vel, v2)
        acc = torch.where(frozen, acc, new_acc)
    return _finish_chunk(shape, state, inv, n_steps, pos, vel, acc, rest,
                         rem)


class _LocalSlots(ctypes.Structure):
    """Mirror of ``struct LocalSlots`` in ``csrc/step_body.cuh``: the slot
    capacities and the stacked [L, N] slot array (null without slots)."""

    _fields_ = ([(f, ctypes.c_int) for f in ("cp", "ball", "pl", "dir")]
                + [("lc", ctypes.c_void_p)])


def local_struct(shape: SceneShape, inv: dict,
                 kernel: str = "fused") -> _LocalSlots:
    """The kernels' ``LocalSlots`` of a scene from its staging ``inv``
    (whose ``lc`` is ``forces.stage_local``), checked as ``kernel`` takes
    it."""
    ls = _LocalSlots()
    caps = local_caps(shape)
    ls.cp, ls.ball, ls.pl, ls.dir = caps
    if any(caps):
        ls.lc = _checked("lc", inv["lc"],
                         (F.local_slot_rows(caps), shape.n_masses),
                         kernel=kernel)
    return ls


class _Remainder(ctypes.Structure):
    """Mirror of ``struct Remainder`` in ``csrc/step_body.cuh``: the
    remainder springs as ``forces.stage_remainder`` stages them (null
    pointers without remainder springs); the caller sets the rest buffers
    of each pass."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "d", "s", "has_damping", "has_breathing", "has_actuated",
        "closed")]
        + [(f, ctypes.c_void_p) for f in (
            "inc", "sign", "ends", "p", "rest_src", "rest_dst")])


def remainder_struct(shape: SceneShape, inv: dict, kernel: str = "fused",
                     closed: bool = False) -> _Remainder:
    """The kernels' ``Remainder`` of a scene from its staging ``inv``
    (whose ``rem`` is ``forces.stage_remainder``), checked as ``kernel``
    takes it; its rest_src is the staged rest.  ``closed``: ACTUATED rest
    in the closed form (the tiled step, the adjoints' backward), else
    advanced per pass and carried (the fused step and its replay)."""
    r = _Remainder()
    if not shape.has_remainder:
        return r
    R = inv["rem"]
    n, s = shape.n_masses, shape.n_springs
    d = int(R["inc"].shape[1])
    r.d, r.s = d, s
    r.has_damping, r.has_breathing = (int(shape.has_damping),
                                      int(shape.has_breathing))
    r.has_actuated, r.closed = int(shape.has_actuated), int(closed)
    r.inc = _checked("inc_idx", R["inc"], (n, d), torch.int32, kernel)
    r.sign = _checked("inc_sign", R["sign"], (n, d), kernel=kernel)
    r.ends = _checked("ends", R["ends"], (2, s), torch.int32, kernel)
    r.p = _checked("remainder rows", R["p"], (len(F.REM_ROWS), s),
                   kernel=kernel)
    r.rest_src = _checked("remainder rest", R["rest"], (s,), kernel=kernel)
    return r


class _ChunkArgs(ctypes.Structure):
    """Mirror of ``struct ChunkArgs`` in ``csrc/step_body.cuh``."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "nf", "n_planes", "n_balls", "n_steps", "integrator", "clamp",
        "has_damping", "has_breathing", "has_actuated", "has_drag",
        "device")]
        + [("normal_coeff", ctypes.c_float)]
        + [(f, ctypes.c_void_p) for f in (
            "deltas", "scal", "planes", "balls", "pos_in", "vel_in",
            "acc_in", "cforce", "minv", "fixed", "k", "rest_in", "damping",
            "bsign", "bomega", "arate", "abound", "drag", "pos_out",
            "vel_out", "acc_out", "pos_tmp", "vel_tmp", "acc_tmp",
            "pos_half", "vel_half", "vel_v1", "rest_out", "rest_tmp",
            "rem_out", "rem_tmp")]
        + [("local", _LocalSlots), ("rem", _Remainder)]
        + [("kscal", ctypes.c_void_p), ("bits", ctypes.c_void_p)])


def takes_plain_spring_path(shape: SceneShape) -> bool:
    """Whether the fused step and the Euler / Verlet resident grid sum
    this scene's families with their plain-spring loop
    (``csrc/step_body.cuh::plain_family_sum``), and the tiled adjoint's
    backward kernels (B7, B8) transpose them with theirs
    (``csrc/adjoint_body.cuh::plain_family_transpose``): stencil families
    whose springs are plain (no damping, breathing or actuation) and whose
    k rides the existence bits (``k_rides_bits``).  Other scenes take the
    kernels' general body."""
    return bool(shape.stencil_deltas) and k_rides_bits(shape) and not (
        shape.has_damping or shape.has_breathing or shape.has_actuated)


def _checked(name, t, shape, dtype=torch.float32, kernel="fused"):
    """``t``'s pointer as ``kernel`` takes it, or raise naming what is
    wrong."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(
            f"{kernel} kernel input {name}: expected a contiguous {dtype} "
            f"CUDA tensor of shape {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous="
            f"{t.is_contiguous()})")
    return t.data_ptr()


@functools.lru_cache(maxsize=None)
def deltas_on(deltas: tuple, device: torch.device) -> torch.Tensor:
    """The stencil deltas as an int32 tensor on ``device``, made once per
    scene layout: every launch reads them, and each fresh copy to the card
    would wait for the host."""
    return torch.tensor(deltas, dtype=torch.int32, device=device)


def _chunk_args(shape: SceneShape, state: SimState, n_steps: int,
                inv: dict = None):
    """(``_ChunkArgs``, what it points into) for ``n_steps`` steps of the
    step kernel from ``state``; the second item holds every tensor the
    launch reads or writes, starting with the invariants and the outputs
    pos, vel, acc and rest.  ``inv`` is ``prep_invariants(shape, state)``
    where the caller has it already.  A scene on the plain-spring path
    (``takes_plain_spring_path``) gets its k as ``bits_k``, kept in
    ``inv`` for the adjoint's backward."""
    cfg = shape.config
    m = state.masses
    dev = m.pos.device
    n, nf = shape.n_masses, len(shape.stencil_deltas)
    if inv is None:
        inv = prep_invariants(shape, state)
    deltas = deltas_on(shape.stencil_deltas, dev)
    vec, fam = (3, n), (nf, n)
    empty = lambda s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    pos_out, vel_out, acc_out = empty(vec), empty(vec), empty(vec)
    caps = local_caps(shape)
    rk2_local = cfg.integrator is Integrator.RK2 and any(caps)
    # pos/vel/acc tmp, pos/vel half (+ RK2's pass-1 mutated velocity)
    scratch = [empty(vec) for _ in range(6 if rk2_local else 5)]
    rest_in = state.stencil.rest
    rest_out = empty(fam) if shape.has_actuated else rest_in
    rest_tmp = empty(fam) if shape.has_actuated else rest_in
    # the remainder rest's two buffers start equal: a spring no thread
    # owns (padding) is never written and keeps its rest
    rem_in = inv["rem"]["rest"] if shape.has_remainder else None
    rem_out = rem_tmp = rem_in
    if shape.has_remainder and shape.has_actuated:
        rem_out, rem_tmp = rem_in.clone(), rem_in.clone()

    a = _ChunkArgs()
    a.n, a.nf, a.n_steps = n, nf, n_steps
    a.n_planes, a.n_balls = shape.n_planes, shape.n_balls
    a.integrator = _INTEGRATOR_CODE[cfg.integrator]
    a.clamp = int(cfg.velocity_clamp)
    a.has_damping, a.has_breathing = int(shape.has_damping), int(shape.has_breathing)
    a.has_actuated, a.has_drag = int(shape.has_actuated), int(shape.has_drag)
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    a.normal_coeff = float(cfg.normal_coeff)
    a.deltas = _checked("deltas", deltas, (nf,), torch.int32)
    a.scal = _checked("scal", inv["scal"], (2,))
    a.local = local_struct(shape, inv)
    a.rem = remainder_struct(shape, inv)
    a.planes = _checked("planes", inv["planes"], (max(shape.n_planes, 1), 6))
    a.balls = _checked("balls", inv["balls"], (max(shape.n_balls, 1), 4))
    a.pos_in = _checked("pos", m.pos, vec)
    a.vel_in = _checked("vel", m.vel, vec)
    a.acc_in = _checked("acc", m.acc, vec)
    a.cforce = _checked("const_f", inv["const_f"], vec)
    a.minv = _checked("minv", inv["minv"], (1, n))
    a.fixed = _checked("fixed", inv["fixed"], (1, n))
    a.k = _checked("k", inv["k_eff"], fam)
    a.rest_in = _checked("rest", rest_in, fam)
    a.damping = _checked("damping", inv["damp_eff"], fam)
    a.bsign = _checked("bsign", inv["bsign"], fam)
    a.bomega = _checked("bomega", inv["bomega"], fam)
    if shape.has_actuated:
        a.arate = _checked("arate", inv["arate"], fam)
        a.abound = _checked("abound", inv["abound"], fam)
    a.drag = _checked("drag", m.drag, (n,))
    if takes_plain_spring_path(shape):
        inv["kscal"], inv["bits"] = bits_k(shape, state, inv)
        a.kscal = _checked("kscal", inv["kscal"], (nf,))
        a.bits = _checked("bits", inv["bits"], (n,), torch.int32)
    a.pos_out, a.vel_out, a.acc_out = (t.data_ptr()
                                       for t in (pos_out, vel_out, acc_out))
    (a.pos_tmp, a.vel_tmp, a.acc_tmp, a.pos_half,
     a.vel_half) = (t.data_ptr() for t in scratch[:5])
    if rk2_local:
        a.vel_v1 = scratch[5].data_ptr()
    a.rest_out, a.rest_tmp = rest_out.data_ptr(), rest_tmp.data_ptr()
    if rem_in is not None:
        a.rem_out, a.rem_tmp = rem_out.data_ptr(), rem_tmp.data_ptr()
    # The temporaries are freed when the caller drops them, while the
    # kernels may still be running: safe, because the caching allocator
    # reuses memory freed on this stream only for later work on it.
    return a, (inv, pos_out, vel_out, acc_out, rest_out, rem_out, deltas,
               scratch, rest_tmp, rem_tmp)


class _PassArgs(ctypes.Structure):
    """Mirror of ``struct PassArgs`` in ``csrc/step_body.cuh``: the buffers
    of one force pass of the step kernel (and the replay's trace
    entry)."""

    _fields_ = ([("step", ctypes.c_int), ("mode", ctypes.c_int)]
                + [(f, ctypes.c_void_p) for f in (
                    "fpos", "fvel", "pos0", "vel0", "acc0", "rest_src",
                    "cforce", "pos_dst", "vel_dst", "acc_dst", "rest_dst",
                    "vel_v1", "rem_src", "rem_dst", "trace")])


# the kernel's step modes (csrc/step_body.cuh enum Mode)
_EULER, _VERLET, _RK2_HALF, _RK2_FULL = 0, 1, 2, 3


def _lib():
    from .. import _build
    lib = _build.load("fused_step")
    lib.titan_fused_chunk.argtypes = [ctypes.POINTER(_ChunkArgs),
                                      ctypes.c_void_p]
    lib.titan_fused_chunk.restype = ctypes.c_int
    lib.titan_fused_pass.argtypes = [ctypes.POINTER(_ChunkArgs),
                                     ctypes.POINTER(_PassArgs),
                                     ctypes.c_void_p]
    lib.titan_fused_pass.restype = ctypes.c_int
    lib.titan_fused_kernel_info.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.titan_fused_kernel_info.restype = ctypes.c_int
    return lib


def kernel_info(rem: bool = False) -> tuple:
    """(registers a thread, co-resident blocks an SM) of the plain-spring
    step kernel (its REM instantiation with ``rem``) at its block size."""
    regs, per_sm = ctypes.c_int(), ctypes.c_int()
    rc = _lib().titan_fused_kernel_info(int(rem), ctypes.byref(regs),
                                        ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"fused_step kernel_info: CUDA error {rc}")
    return regs.value, per_sm.value


def _fused_chunk_cuda(shape: SceneShape, state: SimState, n_steps: int,
                      field=None) -> SimState:
    """The kernel chunk.  A magnet scene runs ``_magnet_passes`` with
    ``field`` (default ``magnet_field_fn(shape, state, plain=False)``)."""
    lib = _lib()
    a, keep = _chunk_args(shape, state, n_steps)
    inv, pos_out, vel_out, acc_out, rest_out, rem_out = keep[:6]
    stream = torch.cuda.current_stream(pos_out.device).cuda_stream
    if shape.has_magnets:
        def run(p):
            rc = lib.titan_fused_pass(ctypes.byref(a), ctypes.byref(p),
                                      stream)
            if rc != 0:
                raise RuntimeError(
                    f"fused_step kernel launch failed: CUDA error {rc}")
            fused_chunk.launches += 1
        pos_out, vel_out, acc_out, rest_out, rem_out = _magnet_passes(
            shape, state, n_steps, inv,
            field or magnet_field_fn(shape, state, plain=False), run)
    else:
        rc = lib.titan_fused_chunk(ctypes.byref(a), stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_step kernel launch failed: CUDA error {rc}")
        fused_chunk.launches += n_steps * (2 if shape.config.integrator
                                           is Integrator.RK2 else 1)
    return _finish_chunk(shape, state, inv, n_steps, pos_out, vel_out,
                         acc_out, rest_out, rem_out)


def trace_rows(shape: SceneShape) -> int:
    """Rows of an adjoint trace entry, the one place its layout is decided:
    the step's input pos and vel (rows 0-5), then for a magnet scene each
    force pass's constant force ``const_f + field`` (``cf_row``): 6, 9, or
    12 under RK2 (the tiled adjoint's glue contract,
    ``titan_tpu/ops/adjoint_tiled.py:513-546``).  The replays write it
    (``_magnet_passes``, ``tiled_step.glue_passes`` and the plain chunks,
    which append the passes' constant forces in pass order) and the sweeps
    read it (``adjoint.sweep_plain``, ``csrc/adjoint_body.cuh``)."""
    if not shape.has_magnets:
        return 6
    return 12 if shape.config.integrator is Integrator.RK2 else 9


def cf_row(trace, step: int, slot: int):
    """The view of force pass ``slot``'s constant force (1 is RK2's second
    pass) in entry ``step`` of a trace [seg, trace_rows, N]."""
    return trace[step, 6 + 3 * slot:9 + 3 * slot]


def cf_rows(trace, step: int) -> list:
    """Every force pass's constant force in entry ``step`` of a trace, in
    pass order (none without magnets)."""
    return [cf_row(trace, step, k) for k in range((trace.shape[1] - 6) // 3)]


def pass_cforce(inv: dict, field, at, trace=None, step: int = 0,
                slot: int = 0):
    """A force pass's constant force ``const_f + field(at)``; with a trace,
    written into its row (``cf_row``) and returned as that view."""
    if trace is None:
        return inv["const_f"] + field(at)
    cf = cf_row(trace, step, slot)
    torch.add(inv["const_f"], field(at), out=cf)
    return cf


def _magnet_passes(shape, state, n_steps, inv, field, run, trace=None):
    """``n_steps`` steps of a magnet scene, one force pass at a time: the
    field at the pass's positions, then ``run(p)``, which launches one
    pass of the step kernel (or of the adjoint's replay) with the
    ``_PassArgs`` p, whose constant force is ``const_f + field``.  Every
    pass writes fresh buffers (the remainder rest's start as a copy of the
    last, see _chunk_args).  With ``trace`` ([n_steps, trace_rows, N]),
    each pass's constant force is written into its row of the step's entry
    (``pass_cforce``) and read from there, and the step's first pass
    carries the entry, where the replay kernel writes the step's input
    (pos, vel).  Returns the final
    (pos, vel, acc, rest, remainder rest)."""
    m = state.masses
    rk2 = shape.config.integrator is Integrator.RK2
    mode = {Integrator.EULER: _EULER, Integrator.VERLET: _VERLET,
            Integrator.RK2: _RK2_FULL}[shape.config.integrator]
    pos, vel, acc, rest = m.pos, m.vel, m.acc, state.stencil.rest
    rem = inv["rem"]["rest"] if shape.has_remainder else None
    rem_moves = shape.has_remainder and shape.has_actuated
    empty = torch.empty_like
    p = _PassArgs()
    # RK2 with local constraints: the predictor stores pass 1's mutated
    # velocity here and the corrector starts from it
    v1 = empty(vel) if rk2 and any(local_caps(shape)) else None
    p.vel_v1 = None if v1 is None else v1.data_ptr()

    def launch(step, mode, slot, fpos, fvel, dst):
        nonlocal rest, rem
        cf = pass_cforce(inv, field, fpos, trace, step, slot)
        p.trace = (trace[step].data_ptr() if trace is not None and slot == 0
                   else None)
        rest_dst = empty(rest) if shape.has_actuated else rest
        rem_dst = rem.clone() if rem_moves else rem
        if rem is not None:
            p.rem_src, p.rem_dst = rem.data_ptr(), rem_dst.data_ptr()
        p.step, p.mode = step, mode
        p.fpos, p.fvel = fpos.data_ptr(), fvel.data_ptr()
        p.pos0, p.vel0, p.acc0 = pos.data_ptr(), vel.data_ptr(), acc.data_ptr()
        p.rest_src, p.rest_dst = rest.data_ptr(), rest_dst.data_ptr()
        p.cforce = cf.data_ptr()
        p.pos_dst, p.vel_dst = dst[0].data_ptr(), dst[1].data_ptr()
        p.acc_dst = dst[2].data_ptr() if len(dst) > 2 else None
        run(p)
        rest, rem = rest_dst, rem_dst

    for s in range(n_steps):
        fpos, fvel = pos, vel
        if rk2:
            fpos, fvel = empty(pos), empty(vel)
            launch(s, _RK2_HALF, 0, pos, vel, (fpos, fvel))
        out = (empty(pos), empty(vel), empty(acc))
        launch(s, mode, int(rk2), fpos, fvel, out)
        pos, vel, acc = out
    return pos, vel, acc, rest, rem


def fused_chunk(shape: SceneShape, state: SimState, n_steps) -> SimState:
    """``n_steps`` fused steps: the CUDA kernel for state on the card, the
    plain version for state on the CPU.  ``fused_chunk.launches`` counts
    the step kernel's launches (one per step, two for RK2)."""
    n_steps = int(n_steps)
    if n_steps <= 0:
        return state
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return fused_chunk_plain(shape, state, n_steps)
    if dev.type != "cuda":
        raise ValueError(f"fused_chunk: state on {dev}; expected cpu or cuda")
    return _fused_chunk_cuda(shape, state, n_steps)


fused_chunk.launches = 0
