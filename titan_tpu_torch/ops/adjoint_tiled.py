"""The tiled adjoint: gradients of scenes past the fused adjoint's residency
rule, such as the 100^3 stress config (1M masses, 12.7M springs).

Counterpart of ``titan_tpu/ops/adjoint_tiled.py``.  A rollout is cut into
segments; each segment is a ``torch.autograd.Function``:

  forward  : ``tiled_step.tiled_chunk``, the chunk ``Simulation`` runs on
             such a scene (the resident-grid and per-step kernels of
             ``csrc/tiled_step.cu`` on the card), keeping only the
             segment's input state;
  backward : (1) ``tiled_trace_run`` replays the segment through the same
             launches and writes each step's input (pos, vel) to a trace
             [seg, 6, N] (B6, the TPU's megatrace mode);
             (2) ``tiled_bwd_run`` sweeps the trace in reverse with the
             transpose of the step (``ops/adjoint.py::backward_step``) on
             the tiled step's staging, carrying the cotangents of (pos,
             vel, acc) and accumulating per-spring parameter gradients:
             one cooperative launch per segment for Euler and Verlet (B8),
             two launches per step otherwise (B7, five for RK2);
             (3) ``ops/adjoint.py::assemble_ct`` maps those onto the
             segment's inputs.

``tiled_trace_run`` and ``tiled_bwd_run`` launch the hand-written kernels of
``csrc/tiled_adjoint.cu`` for state on the card and run their plain
PyTorch versions (``tiled_trace_run_plain``, ``tiled_bwd_run_plain``) for
state on the CPU; anything else raises.

The staging is the tiled forward's own (``tiled_step.prep_tiled_inputs``):
a field that is uniform in its family rides as one scalar per family, a
uniform k as that scalar times the family's bit of one int32 existence mask
per mass, the rest as [F, N] planes, so the backward transposes exactly the
values the forward consumed.  Every spring still gets its own gradient
[F, N], whether its field rode as a scalar or as a plane (``bar_plan``).
ACTUATED rest is in closed form in the forward and the transpose alike.

What the TPU module needs and this one does not: halo windows and their
padded trace layout (one thread per mass gathers both incident springs of
each family, so the transpose needs no halo), the VMEM sizing of the
backward tile (``_bwd_vmem_est``, ``_shrink_bwd_tile``, ``_geom``) and the
A/B hooks (``TITAN_MEGA_ADJ``, ``TITAN_MEGA_COMPACT``, ``CARRY_MODE``).

Remainder springs run inside the per-step replay and B7 (the fused
adjoint's remainder transpose, ``csrc/adjoint_body.cuh``), where the TPU
feeds them in as glue and splits its RK2 backward around the glue's vjp
(``_build_bwd_tile_kernel``'s rk2a / rk2b modes, a trace of 9 rows per
step): the tiled step's closed-form rest makes that unnecessary.  Their
scenes take no resident grid, forward or backward, as in the reference.

Magnet glue follows the reference's data contract (``build_tiled_trace``
:513-546, ``build_tiled_bwd`` :1182-1340).  The replay runs the forward's
glue passes (``tiled_step.glue_passes``) and keeps each step's constant
force ``const_f + field`` in its trace entry: 9 rows, 12 under RK2 (both
passes').  The backward reads each pass's constant force from there and
routes the pass's force cotangent gf (on movable masses) through the
field's transpose before the earlier pass runs: on an unbinned scene the
pairwise transpose kernel (B5, ``csrc/magnets_adjoint.cuh``) inside the
sweep; on a binned one autograd through the binned pass
(``magnets.binned_field_vjp``, as the JAX package takes that vjp in XLA)
between B7's parts, rk2b, the midpoint's vjp, then rk2a under RK2
(``_glue_sweep``).  Glue scenes take no resident grid here either.

The backward of a scene whose springs are plain and whose k is
family-uniform (``fused_step.takes_plain_spring_path``: every main path)
runs loops compiled for it, in B7 and B8 alike (``_TiledBwdArgs.
plain_springs``; ``csrc/adjoint_body.cuh::plain_family_transpose``), with
B8 at a block size of its own (``bwd_kernel_info``).

Envelope (``tiled_adjoint_reject_reason``): the tiled step's, local
constraints, remainder springs and magnets included.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..config import Integrator
from ..state import SceneShape, SimState
from .adjoint import (LEAVES, assemble_ct, leaves_of, magnet_args,
                      rem_bars, segment_outputs, state_from_outputs,
                      sweep_plain, trace_rows, with_leaves)
from .fused_step import (_LocalSlots, _Remainder, _checked, local_struct,
                         magnet_field_fn, remainder_struct,
                         takes_plain_spring_path)
from .magnets import binned_field_vjp, pairwise_params
from .step import local_caps
from .tiled_step import (_INTEGRATOR_CODE, _MAX_FAMILIES, _TiledChunk,
                         _TiledPass, chunk_struct, glue_passes, launch_counts,
                         mega_seg, plain_launch_count, prep_tiled_inputs,
                         tiled_chunk, tiled_chunk_plain, tiled_reject_reason)

#: the default segment's cap on the trace ([seg, trace_rows, N] f32), and
#: on its steps (``adjoint_tiled.py:1504-1520``)
TRACE_BYTES, MAX_SEGMENT = 1.5e9, 64


def tiled_adjoint_reject_reason(shape: SceneShape):
    """None if the tiled adjoint accepts this scene, else a one-line reason
    naming the envelope condition that failed: the tiled step's envelope
    (``adjoint_tiled.py:347-367`` without its VMEM terms; the persistent
    extern-force check is part of ``tiled_reject_reason``)."""
    return tiled_reject_reason(shape)


def mega_adjoint_ok(shape: SceneShape) -> bool:
    """True where the backward runs one resident-grid launch per segment
    (B8; ``_mega_adjoint_ok`` :194-215 without its VMEM fit): Euler and
    Verlet scenes whose forward runs resident grids, that is with no
    per-step glue (``tiled_step.mega_seg``, the reference's
    ``_mega_env_ok``).  RK2 runs B7's per-step launches, as in the JAX
    package."""
    return (shape.config.integrator in (Integrator.EULER, Integrator.VERLET)
            and mega_seg(shape) > 0)


def bar_plan(shape: SceneShape):
    """({name: (first row, rows)}, rows in all) of the backward's gradient
    block [NB, N] (``_bar_plan`` :169-191): cf 3, minv 1, then k, rest (,
    damping, omega, aratedt) F rows each, then drag 1.  k gets its F rows
    also where it rides as family scalars times the existence bit."""
    nf = len(shape.stencil_deltas)
    plan, p = {}, 0
    for name, rows in (("cf", 3), ("minv", 1), ("k", nf), ("rest", nf),
                       ("damping", nf * shape.has_damping),
                       ("omega", nf * shape.has_breathing),
                       ("aratedt", nf * shape.has_actuated),
                       ("drag", int(shape.has_drag))):
        if rows:
            plan[name] = (p, rows)
            p += rows
    return plan, p


def default_segment(shape: SceneShape, n_steps: int) -> int:
    """The JAX package's default segment (``tiled_adjoint_rollout``
    :1504-1520): the largest divisor of ``n_steps`` of at most
    ``MAX_SEGMENT`` steps whose trace fits in ``TRACE_BYTES``, or, where
    one exists, the largest such multiple of ``MEGA_SEG``, so that the
    replay runs resident-grid launches only.  The JAX package prefers the
    multiple for its resident-grid adjoint (Euler, Verlet); here RK2's
    forward and replay run resident-grid launches too, so it applies to
    every scene whose chunk does."""
    cap = max(1, int(TRACE_BYTES // (4 * trace_rows(shape)
                                     * shape.n_masses)))
    hi = min(n_steps, MAX_SEGMENT, cap)
    seg = next(s for s in range(hi, 0, -1) if n_steps % s == 0)
    k = mega_seg(shape)
    if k:
        seg = next((s for s in range(hi - hi % k, 0, -k)
                    if n_steps % s == 0), seg)
    return seg


# ---------------------------------------------------------------------------
# The math's inputs from the tiled staging, and the plain versions
# ---------------------------------------------------------------------------

def _plain_inputs(shape: SceneShape, inv: dict) -> dict:
    """``ops/adjoint.py``'s step-math dict ``P`` from the tiled staging
    ``inv`` (``_stage_flat`` :377-431): family scalars expanded to [F, N]
    (a uniform k as scalar x existence bit, value-exact), planes as they
    are, and the tiled step's cf, inverse mass, frozen mask and drag."""
    cfg = shape.config
    nf, n = len(shape.stencil_deltas), shape.n_masses
    fp = inv["fparams"]

    def field(name, row):
        return inv[name] if name in inv else fp[row][:, None].expand(nf, n)

    if "bits" in inv:
        bit = torch.stack([(inv["bits"] >> fi) & 1 for fi in range(nf)])
        k = fp[0][:, None] * bit.to(fp.dtype)
    else:
        k = inv["k"]
    return {
        "deltas": shape.stencil_deltas, "k": k, "rest": field("rest", 1),
        "minv": inv["minv"][None], "fixed": inv["fixed"][None],
        "cf": inv["const_f"],
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
        "damping": inv["damping"] if shape.has_damping else None,
        "drag": inv["drag"][None] if shape.has_drag else None,
        "bsign": field("bsign", 3) if shape.has_breathing else None,
        "bomega": field("bomega", 4) if shape.has_breathing else None,
        "aratedt": inv.get("aratedt"), "sstop": inv.get("sstop"),
        "pair_ok": inv["pair_ok"],
        "lc": inv.get("lc"), "caps": local_caps(shape),
        "rem": inv.get("rem"),
    }


def tiled_trace_run_plain(shape: SceneShape, state: SimState, seg: int,
                          field=None):
    """Plain version of the trace replay (B6): ``tiled_chunk_plain`` over
    ``seg`` steps with each step's input (pos, vel), and a magnet scene's
    per-pass constant forces, written to the trace [seg, trace_rows, N].
    ``field`` is ``tiled_chunk_plain``'s (the card's checks feed the
    kernel's field, to hold the replay bitwise)."""
    trace = []
    tiled_chunk_plain(shape, state, seg, trace=trace, field=field)
    return torch.stack(trace)


def glue_vjp(shape: SceneShape, state: SimState):
    """The magnet glue's transpose on a binned scene, ``vjp(pos, gfm) ->
    (gpos, [4, N])``: autograd through the binned pass
    (``magnets.binned_field_vjp``), whose forward took the grid field, as
    ``build_tiled_bwd`` takes this vjp in XLA (:1248-1305).  An unbinned
    scene's is the pairwise transpose (B5), inside the sweep."""
    m = state.masses
    return lambda pos, gfm: binned_field_vjp(m, shape, pos, gfm)


def tiled_bwd_run_plain(shape: SceneShape, state: SimState, trace, gpos,
                        gvel, gacc, inv: dict = None) -> dict:
    """Plain version of the tiled backward (B7 and B8; ``build_tiled_bwd``
    :1182): the reverse sweep of ``ops/adjoint.py::backward_step`` over
    ``trace`` on the tiled staging, from the cotangents (gpos, gvel, gacc)
    of the segment's output.  A magnet scene's passes read their constant
    force from the trace and route its cotangent through the glue's
    transpose: the pairwise transpose's plain version
    (``magnets.magnet_transpose_plain``) on an unbinned scene, the binned
    pass's vjp (``glue_vjp``) on a binned one.  Returns the keys of
    ``ops/adjoint.py::bwd_run_plain``.  ``inv`` is
    ``prep_tiled_inputs(shape, state)`` where the caller has it."""
    if inv is None:
        inv = prep_tiled_inputs(shape, state)
    P = _plain_inputs(shape, inv)
    if shape.has_magnets:
        P["mag"] = pairwise_params(state.masses)
        P["magnet_cutoff"] = shape.config.magnet_cutoff
        if shape.magnet_binned:
            P["mag_vjp"] = glue_vjp(shape, state)
    return sweep_plain(shape, P, trace, gpos, gvel, gacc)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

class _TiledBwdArgs(ctypes.Structure):
    """Mirror of ``struct TiledBwdArgs`` in ``csrc/tiled_adjoint.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "nf", "n_planes", "n_balls", "seg", "integrator", "clamp",
        "has_damping", "has_breathing", "has_actuated", "has_drag",
        "device")]
        + [("normal_coeff", ctypes.c_float), ("np", ctypes.c_int),
           ("cutoff", ctypes.c_float),
           ("deltas", ctypes.c_int * _MAX_FAMILIES)]
        + [(f, ctypes.c_void_p) for f in (
            "scal", "planes", "balls", "fparams", "bits", "k", "rest",
            "damping", "bsign", "bomega", "aratedt", "sstop", "cforce",
            "minv", "fixed", "drag", "trace", "gpos_in", "gvel_in",
            "gacc_in", "gpos", "gvel", "gacc", "gk", "grest", "gdamp",
            "gomega", "garate", "gcf", "gminv", "gdrag", "gf", "gpc", "gvc",
            "pos_h", "vel_h", "grem", "mag", "gmag")]
        + [("local", _LocalSlots), ("rem", _Remainder),
           ("plain_springs", ctypes.c_int)])


def _lib():
    from .. import _build
    lib = _build.load("tiled_adjoint")
    lib.titan_tiled_trace.argtypes = [ctypes.POINTER(_TiledChunk),
                                      ctypes.c_void_p, ctypes.c_void_p]
    lib.titan_tiled_trace.restype = ctypes.c_int
    lib.titan_tiled_bwd.argtypes = [ctypes.POINTER(_TiledBwdArgs),
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.titan_tiled_bwd.restype = ctypes.c_int
    lib.titan_tiled_adjoint_coop_blocks.argtypes = [ctypes.c_int] * 4
    lib.titan_tiled_adjoint_coop_blocks.restype = ctypes.c_int
    lib.titan_tiled_bwd_kernel_info.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.titan_tiled_bwd_kernel_info.restype = ctypes.c_int
    lib.titan_tiled_trace_pass.argtypes = [ctypes.POINTER(_TiledChunk),
                                           ctypes.POINTER(_TiledPass),
                                           ctypes.c_void_p]
    lib.titan_tiled_trace_pass.restype = ctypes.c_int
    lib.titan_tiled_bwd_begin.argtypes = [ctypes.POINTER(_TiledBwdArgs),
                                          ctypes.c_void_p]
    lib.titan_tiled_bwd_begin.restype = ctypes.c_int
    lib.titan_tiled_bwd_part.argtypes = [ctypes.POINTER(_TiledBwdArgs),
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.titan_tiled_bwd_part.restype = ctypes.c_int
    lib.titan_tiled_trace_kernel_info.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.titan_tiled_trace_kernel_info.restype = ctypes.c_int
    return lib


def coop_blocks(kind: str, integrator: Integrator, device=None,
                plain: bool = False) -> int:
    """The co-resident block limit (the largest cooperative grid) of the
    trace replay's resident-grid kernel (``kind="trace"``) or of the
    resident-grid backward (``kind="bwd"``) for ``integrator``;
    ``plain``: the instantiation a plain-spring scene launches, at its own
    block size."""
    dev = torch.device("cuda", device if device is not None
                       else torch.cuda.current_device())
    got = _lib().titan_tiled_adjoint_coop_blocks(
        {"trace": 0, "bwd": 1}[kind], _INTEGRATOR_CODE[integrator],
        int(plain), dev.index)
    if got <= 0:
        raise RuntimeError(f"tiled_adjoint: cooperative launch unavailable "
                           f"on {dev} (CUDA error {-got})")
    return got


#: the backward kernels ``bwd_kernel_info`` reports on
BWD_KERNELS = ("B8", "force", "spring", "mid")


def bwd_kernel_info(kernel: str, plain: bool, rem: bool = False,
                    device=None) -> dict:
    """What one backward kernel launches with: threads a block, registers
    a thread, local-memory bytes a thread (spills) and co-resident blocks
    an SM, of B8 (``kernel="B8"``) or of B7's ``"force"``, ``"spring"`` or
    RK2 ``"mid"`` kernel, on the plain-spring path (``plain``) or the
    general body, with B7's remainder calls (``rem``)."""
    dev = torch.device("cuda", device if device is not None
                       else torch.cuda.current_device())
    out = (ctypes.c_int * 4)()
    rc = _lib().titan_tiled_bwd_kernel_info(BWD_KERNELS.index(kernel),
                                            int(plain), int(rem), dev.index,
                                            out)
    if rc != 0:
        raise RuntimeError(f"tiled_adjoint bwd_kernel_info: CUDA error {rc}")
    return dict(zip(("threads", "registers", "local_bytes", "blocks_per_sm"),
                    out))


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _tiled_trace_cuda(shape: SceneShape, state: SimState, seg: int,
                      inv: dict, k_seg: int):
    """B6: the trace of ``seg`` steps through the forward's launches, cut
    into ``k_seg``-step resident-grid segments (0: one launch per step); a
    magnet scene's through its glue passes (``tiled_step.glue_passes``),
    each pass's constant force kept in the trace."""
    c, out, scratch = chunk_struct(shape, state, seg, k_seg, inv)
    rows = trace_rows(shape)
    try:
        trace = torch.empty((seg, rows, shape.n_masses), dtype=torch.float32,
                            device=state.masses.pos.device)
    except torch.OutOfMemoryError as e:
        mib = seg * rows * shape.n_masses * 4 >> 20
        raise torch.OutOfMemoryError(
            f"the tiled adjoint's {seg}-step trace ({mib} MiB) does not fit "
            f"on the card; a shorter segment makes it smaller: {e}") from e
    if shape.has_magnets:
        lib = _lib()
        stream = torch.cuda.current_stream(trace.device).cuda_stream

        def run(p):
            rc = lib.titan_tiled_trace_pass(ctypes.byref(c), ctypes.byref(p),
                                            stream)
            if rc != 0:
                raise RuntimeError(f"tiled adjoint trace kernel launch "
                                   f"failed: CUDA error {rc}")
            tiled_trace_run.step_launches += 1
            tiled_trace_run.plain_launches += c.plain_springs
        glue_passes(shape, state, seg, inv,
                    magnet_field_fn(shape, state, plain=False), run,
                    trace=trace)
        return trace
    rc = _lib().titan_tiled_trace(
        ctypes.byref(c), trace.data_ptr(),
        torch.cuda.current_stream(trace.device).cuda_stream)
    del out, scratch    # freed on this stream: reused only by later work
    if rc != 0:
        raise RuntimeError(f"tiled adjoint trace kernel launch failed: CUDA "
                           f"error {rc}")
    mega, step = launch_counts(shape, seg, k_seg)
    tiled_trace_run.mega_launches += mega
    tiled_trace_run.step_launches += step
    tiled_trace_run.plain_launches += plain_launch_count(shape, mega, step)
    return trace


def tiled_trace_run(shape: SceneShape, state: SimState, seg: int,
                    inv: dict = None):
    """The segment's trace [seg, 6, N]: the CUDA replay (B6) for state on
    the card, ``tiled_trace_run_plain`` for state on the CPU.  ``inv`` is
    ``prep_tiled_inputs(shape, state)`` where the caller has it.
    ``tiled_trace_run.mega_launches`` and ``.step_launches`` count the
    replay's resident-grid and per-step launches, ``.plain_launches``
    those of either that ran the plain-spring loop (as ``tiled_chunk``'s;
    the RK2 replay's grid takes it too)."""
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return tiled_trace_run_plain(shape, state, seg)
    if dev.type != "cuda":
        raise ValueError(f"tiled_trace_run: state on {dev}; expected cpu or "
                         "cuda")
    if inv is None:
        inv = prep_tiled_inputs(shape, state)
    return _tiled_trace_cuda(shape, state, seg, inv, mega_seg(shape))


tiled_trace_run.mega_launches = 0
tiled_trace_run.step_launches = 0
tiled_trace_run.plain_launches = 0


def bwd_args(shape: SceneShape, state: SimState, trace, gpos, gvel, gacc,
             inv: dict, mega: bool, np_rows: int = None):
    """(``_TiledBwdArgs`` of the sweep over ``trace`` from the cotangents
    (gpos, gvel, gacc), the gradient dict its accumulators and carry are
    views of, the scratch and the other tensors it points into) for
    ``tiled_bwd_run``'s kernels; ``np_rows`` overrides the trace's rows (a
    distributed shard's trace carries its glue's constant forces though
    its window's shape has no magnets)."""
    cfg = shape.config
    dev = state.masses.pos.device
    n, nf = shape.n_masses, len(shape.stencil_deltas)
    seg = int(trace.shape[0])
    vec, fam = (3, n), (nf, n)
    kern = "tiled adjoint"
    empty = lambda s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    plan, nb = bar_plan(shape)
    bars = empty((nb, n))
    g = {name: bars[o:o + rows] for name, (o, rows) in plan.items()}
    g["minv"] = g["minv"][0]
    if "drag" in g:
        g["drag"] = g["drag"][0]
    g.update(pos=empty(vec), vel=empty(vec), acc=empty(vec))
    scratch = [empty(vec) for _ in range(6 if mega else 5)]

    a = _TiledBwdArgs()
    a.n, a.nf, a.seg = n, nf, seg
    a.n_planes, a.n_balls = shape.n_planes, shape.n_balls
    a.integrator = _INTEGRATOR_CODE[cfg.integrator]
    a.clamp = int(cfg.velocity_clamp)
    a.has_damping, a.has_breathing = (int(shape.has_damping),
                                      int(shape.has_breathing))
    a.has_actuated, a.has_drag = int(shape.has_actuated), int(shape.has_drag)
    a.device = _device_index(dev)
    a.normal_coeff = float(cfg.normal_coeff)
    a.deltas[:nf] = shape.stencil_deltas
    a.scal = _checked("scal", inv["scal"], (2,), kernel=kern)
    a.planes = _checked("planes", inv["planes"], (max(shape.n_planes, 1), 6),
                        kernel=kern)
    a.balls = _checked("balls", inv["balls"], (max(shape.n_balls, 1), 4),
                       kernel=kern)
    a.fparams = _checked("fparams", inv["fparams"], (5, nf), kernel=kern)
    if "bits" in inv:
        a.bits = _checked("bits", inv["bits"], (n,), torch.int32, kern)
    for name in ("k", "rest", "damping", "bsign", "bomega", "aratedt",
                 "sstop"):
        if name in inv:
            setattr(a, name, _checked(name, inv[name], fam, kernel=kern))
    a.cforce = _checked("const_f", inv["const_f"], vec, kernel=kern)
    a.minv = _checked("minv", inv["minv"], (n,), kernel=kern)
    a.fixed = _checked("fixed", inv["fixed"], (n,), kernel=kern)
    if shape.has_drag:
        a.drag = _checked("drag", inv["drag"], (n,), kernel=kern)
    keep = magnet_args(a, shape, state, g, empty, kern)
    binned = shape.has_magnets and bool(shape.magnet_binned)
    if binned:          # the glue's transpose runs between the parts
        a.mag = a.gmag = None
    if np_rows is not None:
        a.np = np_rows
    a.trace = _checked("trace", trace, (seg, a.np, n), kernel=kern)
    a.gpos_in = _checked("gpos", gpos, vec, kernel=kern)
    a.gvel_in = _checked("gvel", gvel, vec, kernel=kern)
    a.gacc_in = _checked("gacc", gacc, vec, kernel=kern)
    a.gpos, a.gvel, a.gacc = (g[k].data_ptr() for k in ("pos", "vel", "acc"))
    for key, field in (("k", "gk"), ("rest", "grest"), ("damping", "gdamp"),
                       ("omega", "gomega"), ("aratedt", "garate"),
                       ("cf", "gcf"), ("minv", "gminv"), ("drag", "gdrag")):
        if key in g:
            setattr(a, field, g[key].data_ptr())
    a.gf, a.gpc, a.gvc, a.pos_h, a.vel_h = (t.data_ptr()
                                            for t in scratch[:5])
    a.local = local_struct(shape, inv, kern)
    a.rem = remainder_struct(shape, inv, kern, closed=True)
    plain = takes_plain_spring_path(shape)
    a.plain_springs = int(plain)
    grem, rem_g = rem_bars(shape, empty)
    if grem is not None:
        a.grem = grem.data_ptr()
        g.update(rem_g, rem_ok=inv["rem"]["ok"])
    return a, g, scratch, keep + [grem]


def _tiled_bwd_cuda(shape: SceneShape, state: SimState, trace, gpos, gvel,
                    gacc, inv: dict, mega: bool) -> dict:
    """B8 (``mega``; Euler and Verlet) or B7's per-step launches."""
    reason = tiled_adjoint_reject_reason(shape)
    if reason is not None:
        raise ValueError(f"tiled_bwd_run: scene outside the envelope: "
                         f"{reason}")
    if mega and not mega_adjoint_ok(shape):
        raise ValueError(f"tiled_bwd_run: no resident-grid backward for "
                         f"{shape.config.integrator.name}")
    a, g, scratch, keep = bwd_args(shape, state, trace, gpos, gvel, gacc,
                                   inv, mega)
    cfg = shape.config
    seg = a.seg
    plain = bool(a.plain_springs)
    binned = shape.has_magnets and bool(shape.magnet_binned)
    gf_odd = scratch[5].data_ptr() if mega else None

    stream = torch.cuda.current_stream(trace.device).cuda_stream
    passes = 2 if cfg.integrator is Integrator.RK2 else 1
    if binned:
        _glue_sweep(shape, state, a, g, scratch, trace,
                    1.0 - inv["fixed"], stream)
    else:
        rc = _lib().titan_tiled_bwd(ctypes.byref(a), int(mega), gf_odd,
                                    stream)
        if rc != 0:
            raise RuntimeError(f"tiled adjoint backward kernel launch "
                               f"failed: CUDA error {rc}")
        if shape.has_magnets:
            tiled_bwd_run.mag_launches += seg * passes
    del scratch, keep   # freed on this stream: reused only by later work
    launches = 1 if mega else seg * (5 if passes == 2 else 2)
    if mega:
        tiled_bwd_run.mega_launches += launches
    else:
        tiled_bwd_run.step_launches += launches
    if plain:
        tiled_bwd_run.plain_launches += launches
    g["pair_ok"] = inv["pair_ok"]
    return g


def _glue_sweep(shape: SceneShape, state: SimState, a, g: dict, scratch,
                trace, keep, stream):
    """B7 of a binned magnet scene, split as ``build_tiled_bwd`` splits it
    (:1182-1340): per reversed step the kernels' part (both phases; under
    RK2 rk2b, the midpoint and pass 2), then the glue's vjp of that pass
    (``glue_vjp``: its field cotangent is the pass's force cotangent gf on
    movable masses, ``keep``) added to the pass's position cotangent (the
    carry, or the midpoint's before pass 1 reads it), then under RK2 rk2a
    (pass 1) and its vjp.  The trace gives each pass's positions."""
    lib = _lib()
    vjp = glue_vjp(shape, state)
    rk2 = shape.config.integrator is Integrator.RK2
    gf, gpc, pos_h = scratch[0], scratch[1], scratch[3]
    g["mag"].zero_()

    def call(fn, *args):
        rc = fn(ctypes.byref(a), *args, stream)
        if rc != 0:
            raise RuntimeError(f"tiled adjoint backward kernel launch "
                               f"failed: CUDA error {rc}")

    def glue(pos, dst):
        gp, g4 = vjp(pos, gf * keep)
        dst.add_(gp)
        g["mag"].add_(g4)

    call(lib.titan_tiled_bwd_begin)
    for t in range(a.seg - 1, -1, -1):
        if rk2:
            call(lib.titan_tiled_bwd_part, t, 1)      # rk2b
            glue(pos_h, gpc)
            call(lib.titan_tiled_bwd_part, t, 2)      # rk2a
        else:
            call(lib.titan_tiled_bwd_part, t, 0)
        glue(trace[t, :3], g["pos"])


def tiled_bwd_run(shape: SceneShape, state: SimState, trace, gpos, gvel,
                  gacc, inv: dict = None) -> dict:
    """The reverse sweep over ``trace``: for state on the card one
    resident-grid launch for Euler and Verlet (B8), per-step launches for
    RK2 (B7); ``tiled_bwd_run_plain`` for state on the CPU (the same keys).
    ``inv`` is ``prep_tiled_inputs(shape, state)`` where the caller has it.
    ``tiled_bwd_run.mega_launches`` counts B8's launches,
    ``.step_launches`` B7's (two per step, five for RK2), ``.plain_launches``
    those of either that ran the plain-spring loop (a scene on
    ``takes_plain_spring_path``), ``.mag_launches`` the magnet transpose's
    inside B7 (B5, one per force pass of an unbinned magnet scene)."""
    dev = state.masses.pos.device
    if dev.type == "cpu":
        return tiled_bwd_run_plain(shape, state, trace, gpos, gvel, gacc,
                                   inv)
    if dev.type != "cuda":
        raise ValueError(f"tiled_bwd_run: state on {dev}; expected cpu or "
                         "cuda")
    if inv is None:
        inv = prep_tiled_inputs(shape, state)
    return _tiled_bwd_cuda(shape, state, trace, gpos, gvel, gacc, inv,
                           mega_adjoint_ok(shape))


tiled_bwd_run.mega_launches = 0
tiled_bwd_run.step_launches = 0
tiled_bwd_run.plain_launches = 0
tiled_bwd_run.mag_launches = 0


# ---------------------------------------------------------------------------
# The autograd segment and the public rollout
# ---------------------------------------------------------------------------

class _TiledAdjointSegment(torch.autograd.Function):
    """One segment: the tiled chunk forward, trace + reverse-sweep backward
    (``_tiled_adjoint_segment_cached`` :1463-1488)."""

    @staticmethod
    def forward(ctx, shape, seg, state, *leaves):
        out = tiled_chunk(shape, with_leaves(state, leaves), seg)
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
        inv = prep_tiled_inputs(shape, s0)     # read by both passes
        trace = tiled_trace_run(shape, s0, seg, inv)
        g = tiled_bwd_run(shape, s0, trace, gpos.contiguous(),
                          gvel.contiguous(), gacc.contiguous(), inv)
        del trace        # the segment's trace is freed before the next one
        ct = assemble_ct(shape, seg, s0, grest, grem, g)
        return (None, None, None) + tuple(ct[k] for k in LEAVES)


def tiled_adjoint_rollout(shape: SceneShape, state: SimState, n_steps: int,
                          segment: Optional[int] = None) -> SimState:
    """Differentiable rollout for scenes past the fused adjoint's residency
    rule whose forward and backward both run the tiled kernels on the card
    (module docstring).  Residual memory is one state per segment plus,
    during the backward, one (pos, vel) trace of ``segment`` steps
    (``default_segment`` caps it at 1.5 GB)."""
    r = tiled_adjoint_reject_reason(shape)
    if r is not None:
        raise ValueError(f"scene outside the tiled adjoint envelope: {r}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    seg = segment or default_segment(shape, n_steps)
    if n_steps % seg != 0:
        raise ValueError(f"segment {seg} does not divide n_steps {n_steps}")
    for _ in range(n_steps // seg):
        state = state_from_outputs(state, _TiledAdjointSegment.apply(
            shape, seg, state, *leaves_of(state)))
    return state
