"""Magnet fields: the cell-binned pass and the pairwise field kernel.

Counterpart of ``titan_tpu/ops/magnets.py``.  The reference rebuilds a
256 x 256 occupancy grid every step and scans the 3 x 3 cell neighbourhood
of each mass (sim.cu:822-932, 1250-1281).  The binned pass here follows the
JAX package's form of it:

  1. a 2-D cell id per mass on a grid whose cells are the interaction cutoff
     (0.14 m) wide, so the 3 x 3 window holds every pair within the cutoff;
  2. one stable sort by cell id, so the masses of a cell are contiguous;
  3. a candidate table [A + 1, 6, C] of source data (A = padded count of
     valid masses, C = per-cell capacity, ``SimConfig.magnet_cell_cap``): a
     mass beyond the C-th of its cell stops acting as a source but still
     receives (the reference's overflow rule), and row A is the empty row
     that every empty neighbour cell reads;
  4. a dense cell -> table-row map, and a masked pairwise sum of each
     receiver against its 3 x 3 rows, in chunks of receivers.

With ``receivers`` > 0 only the masses that can feel a force (valid, with a
nonzero ``mag_maxf``) are computed; that is exact only when no mass has a
shell radius (``SceneShape.magnet_receivers``).

``pairwise_magnet_field`` is the exact all-pairs field: the hand-written
CUDA kernel ``csrc/magnets.cu`` for state on the card, its plain version
``forces.magnet_forces`` for state on the CPU.  The dense-grid field kernel
is in ``ops/magnets_grid.py``.

The adjoints' magnet branch: the pairwise field's transpose for one force
pass is the CUDA kernel ``csrc/magnets_adjoint.cuh`` (B5), which the
adjoints' sweeps launch (``magnet_transpose`` launches it alone, for tests
and timing); ``magnet_transpose_plain`` is its plain version and
``pairwise_field_lanes`` the field, both in the kernels' summation order
(each lane's partners in index order, then the shuffle tree), so that
both kernels are bitwise their plain versions; ``binned_field_vjp`` is the
binned pass's vjp, the tiled glue's transpose on a binned scene.
"""

from __future__ import annotations

import ctypes

import torch

from ..state import MassState
from . import forces as F

# cells are cutoff-sized; 256 of 0.14 m span +-17.9 m, and positions outside
# are clipped into the edge cells, which only adds far candidates that the
# cutoff rejects
GRID_DIM = 256
_SENTINEL = GRID_DIM * GRID_DIM + 7          # the cell id of invalid masses


def cell_ids(pos: torch.Tensor, valid: torch.Tensor,
             cutoff: float) -> torch.Tensor:
    """Flat 2-D cell id per mass, int32 [N]; invalid masses get a sentinel
    above every real cell, so they sort last and match no lookup."""
    G = GRID_DIM
    # a tensor divisor: on the card PyTorch turns a division by a Python
    # float into a multiplication by its reciprocal
    c = torch.floor(pos[:2] / pos.new_full((), cutoff)).to(torch.int32)
    c = torch.clamp(c + G // 2, 0, G - 1)
    return torch.where(valid, c[0] * G + c[1], _SENTINEL)


def magnet_receiver_idx(masses: MassState, receivers: int) -> torch.Tensor:
    """The compacted receiver set: the first ``receivers`` masses by the
    flag ``valid & mag_maxf != 0``, flagged ones first and ties in index
    order (as ``jax.lax.top_k``); int64 [receivers].  Constant over a
    chunk, so a stepping loop computes it once per chunk."""
    flag = masses.valid & (masses.mag_maxf != 0.0)
    _, order = torch.sort(flag.to(torch.int32), descending=True, stable=True)
    return order[:receivers]


def binned_magnet_forces(masses: MassState, cutoff: float, n_cells: int,
                         cell_cap: int, chunk_cells: int = 512,
                         receivers: int = 0,
                         ridx: torch.Tensor = None) -> torch.Tensor:
    """Magnet field via the cell-binned structure; [3, N].  The same
    physics as ``forces.magnet_forces`` wherever no cell holds more than
    ``cell_cap`` masses; beyond that, the excess masses of a cell stop
    acting as sources but still receive.  ``n_cells`` (A) must be at least
    the number of valid masses.  ``binned_magnet_forces.passes`` counts the
    calls, so that a run shows which field route it took."""
    binned_magnet_forces.passes += 1
    pos = masses.pos
    n = pos.shape[1]
    bins, tbl, cell = build_source_bins(
        pos, masses.valid, masses.mag_rad, masses.mag_scale, cutoff,
        n_cells, cell_cap)
    if receivers:
        if ridx is None:
            ridx = magnet_receiver_idx(masses, receivers)
        flag = masses.valid[ridx] & (masses.mag_maxf[ridx] != 0.0)
        rows9 = neighborhood_rows(tbl, cell[ridx], n_cells)
        f_r = receiver_forces(bins, rows9, cutoff, n, pos[:, ridx],
                              masses.mag_rad[ridx],
                              masses.mag_stiffness[ridx],
                              masses.mag_maxf[ridx], ridx, chunk_cells)
        # the padding beyond the flagged count picks unflagged masses
        f_r = torch.where(flag, f_r, 0.0)
        out = torch.zeros_like(pos)
        out[:, ridx] = f_r
        return out
    rows9 = neighborhood_rows(tbl, cell, n_cells)
    iota = torch.arange(n, device=pos.device)
    f = receiver_forces(bins, rows9, cutoff, n, pos, masses.mag_rad,
                        masses.mag_stiffness, masses.mag_maxf, iota,
                        chunk_cells)
    return torch.where(masses.valid, f, 0.0)


binned_magnet_forces.passes = 0


def build_source_bins(pos, valid, mag_rad, mag_scale, cutoff: float,
                      n_cells: int, cell_cap: int):
    """(bins [A+1, 6, C], tbl [G*G], cell [N]): the candidate table (x, y,
    z, rad, scale, id as float; empty slots hold a far-away position so
    every pair test fails on distance; row A is the empty row), the dense
    cell -> table-row map (A for an empty cell), and each mass's cell id.
    Every valid mass is a source, magnetic or not: a mass with zero
    parameters still feels and exerts shell contact (the reference grid
    inserts every mass, sim.cu:842)."""
    n = pos.shape[1]
    dev = pos.device
    G, A, C = GRID_DIM, n_cells, cell_cap
    cell = cell_ids(pos, valid, cutoff)
    csort, order = torch.sort(cell, stable=True)
    iota = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = csort[1:] != csort[:-1]                     # segment starts
    seg_id = torch.cumsum(first.long(), 0) - 1
    seg_start, _ = torch.cummax(torch.where(first, iota, 0), 0)
    rank = iota - seg_start                                 # slot in its cell
    msort = csort != _SENTINEL
    # invalid masses route to A + 1, outside both tables, and drop out.  (A
    # is the empty row, in bounds: routing them there once let a deleted
    # magnet's stale fields act on every receiver with an empty neighbour,
    # titan_tpu/ops/magnets.py:182-188.)
    aidx = torch.where(msort, seg_id, A + 1)
    acell = torch.full((A,), _SENTINEL, dtype=torch.int32, device=dev)
    keep = aidx < A
    acell[aidx[keep]] = csort[keep]
    tbl = torch.full((G * G,), A, dtype=torch.int64, device=dev)
    real = acell < G * G
    tbl[acell[real].long()] = torch.arange(A, device=dev)[real]
    # flat slot base of each mass in the [A+1, 6, C] table, in original
    # mass order; invalid masses and ranks >= C go out of bounds and drop
    size = (A + 1) * 6 * C
    base_s = torch.where(msort & (rank < C), aidx * (6 * C) + rank, size)
    base_o = torch.full((n,), size, dtype=torch.int64, device=dev)
    base_o[order] = base_s
    far = 1e9
    fields = torch.stack([pos[0], pos[1], pos[2], mag_rad, mag_scale,
                          iota.to(pos.dtype)])
    fill = torch.tensor([far, far, far, 0.0, 0.0, float(n)], dtype=pos.dtype,
                        device=dev)
    flat = fill[None, :, None].expand(A + 1, 6, C).reshape(-1).clone()
    ok = base_o < size
    for f in range(6):
        flat[base_o[ok] + f * C] = fields[f][ok]
    return flat.reshape(A + 1, 6, C), tbl, cell


def neighborhood_rows(tbl: torch.Tensor, rcell: torch.Tensor,
                      n_cells: int) -> torch.Tensor:
    """Table rows of each receiver's 3 x 3 cell neighbourhood, [R, 9].
    Ids off the grid and the invalid-mass sentinel map to the empty row A.
    The +-1 wrap of flat ids at the grid's y edges only adds far candidates,
    which the cutoff rejects (cells are cutoff-sized)."""
    G = GRID_DIM
    shifts = torch.tensor([dx * G + dy for dx in (-1, 0, 1)
                           for dy in (-1, 0, 1)], dtype=torch.int64,
                          device=rcell.device)
    ncell = rcell.long()[:, None] + shifts[None, :]
    ok = (ncell >= 0) & (ncell < G * G) & (rcell < G * G)[:, None]
    return torch.where(ok, tbl[torch.clamp(ncell, 0, G * G - 1)], n_cells)


def receiver_forces(bins: torch.Tensor, rows9: torch.Tensor, cutoff: float,
                    n_total: int, rpos, rrad, rstiff, rmaxf, rid,
                    chunk_cells: int = 512) -> torch.Tensor:
    """Force on each of R receivers from the binned sources, [3, R], in
    chunks of ``chunk_cells`` receivers.  ``rid`` are the receivers' mass
    ids (the self pair is excluded by id), ``n_total`` the mass count."""
    C = bins.shape[2]
    far = 1e9
    R = rpos.shape[1]
    out = []
    for r0 in range(0, R, chunk_cells):
        sl = slice(r0, min(r0 + chunk_cells, R))
        cand = bins[rows9[sl]]                              # [B, 9, 6, C]
        cand = cand.transpose(1, 2).reshape(-1, 6, 9 * C)   # [B, 6, 9C]
        cpos = cand[:, 0:3].transpose(0, 1)                 # [3, B, 9C]
        crad, cscale = cand[:, 3], cand[:, 4]
        cid = cand[:, 5].long()
        diff = rpos[:, sl, None] - cpos
        dist2 = torch.sum(diff * diff, dim=0)
        pos_d = (dist2 > 0) & (dist2 < far)
        dist = torch.where(pos_d, torch.sqrt(torch.where(pos_d, dist2, 1.0)),
                           far)
        safe = torch.where(pos_d, dist, 1.0)
        rid_c = rid[sl].long()[:, None]
        pair_ok = ((dist < cutoff) & (rid_c != cid) & (rid_c < n_total)
                   & (cid < n_total))
        inter = dist - (rrad[sl, None] + crad)
        shell = torch.where(inter < 0, torch.abs(inter) * rstiff[sl, None],
                            0.0)
        attract = cscale * rmaxf[sl, None] / torch.clamp(dist2, min=1e-12)
        coeff = torch.where(pair_ok, (shell - attract) / safe, 0.0)
        out.append(torch.sum(diff * coeff[None], dim=2))
    if not out:
        return rpos.new_zeros((3, 0))
    return torch.cat(out, dim=1)


# --------------------------------------------------------------------------
# The pairwise field kernel (csrc/magnets.cu)
# --------------------------------------------------------------------------

def pairwise_params(masses: MassState) -> torch.Tensor:
    """[5, N] f32 kernel parameters, folded with validity as the TPU
    kernel stages them (``titan_tpu/ops/pallas_step.py:800-808``): shell
    radius, shell stiffness, max pull force and susceptibility scale, each
    zeroed on invalid masses, then the validity flag."""
    v = masses.valid
    return torch.stack([
        torch.where(v, masses.mag_rad, 0.0),
        torch.where(v, masses.mag_stiffness, 0.0),
        torch.where(v, masses.mag_maxf, 0.0),
        torch.where(v, masses.mag_scale, 0.0),
        v.to(masses.pos.dtype)]).contiguous()


def _checked(name, t, shape, dtype=torch.float32):
    from .fused_step import _checked as checked
    return checked(name, t, shape, dtype, kernel="magnet")


def pairwise_magnet_field(masses: MassState, cutoff: float,
                          params: torch.Tensor = None) -> torch.Tensor:
    """The exact all-pairs magnet field [3, N] at ``masses.pos``: the CUDA
    kernel for state on the card (``params`` = ``pairwise_params(masses)``
    where the caller has it), ``forces.magnet_forces`` for state on the
    CPU.  ``pairwise_magnet_field.launches`` counts the kernel launches."""
    pos = masses.pos
    if pos.device.type == "cpu":
        return F.magnet_forces(masses, cutoff)
    if pos.device.type != "cuda":
        raise ValueError(f"pairwise_magnet_field: state on {pos.device}")
    from .. import _build
    lib = _build.load("magnets")
    fn = lib.titan_pairwise_magnet
    fn.argtypes = [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    n = pos.shape[1]
    if params is None:
        params = pairwise_params(masses)
    out = torch.empty((3, n), dtype=torch.float32, device=pos.device)
    rc = fn(n, float(cutoff), _checked("pos", pos, (3, n)),
            _checked("params", params, (5, n)), out.data_ptr(),
            torch.cuda.current_stream(pos.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pairwise magnet kernel launch failed: CUDA "
                           f"error {rc}")
    pairwise_magnet_field.launches += 1
    return out


pairwise_magnet_field.launches = 0


# --------------------------------------------------------------------------
# The pairwise field's transpose (csrc/magnets_adjoint.cuh) and the plain
# versions in the kernels' summation order
# --------------------------------------------------------------------------

_LANES = 32


def _lane_blocks(pos, prm, cutoff: float):
    """Yield, for each block k of 32 partners (j = 32 k + lane), the pair
    quantities of every mass i against them, [.., N, 32], as the kernels
    compute them: d = p_i - p_j, |d|^2, dist, safe, max(|d|^2, 1e-12), the
    shell overlap inter, the pair mask (both valid, i != j, dist < cutoff)
    and the partners' columns j."""
    n = pos.shape[1]
    dev = pos.device
    lane = torch.arange(_LANES, device=dev)
    iota = torch.arange(n, device=dev)
    valid = prm[4] != 0
    for k in range(-(-n // _LANES)):
        j = k * _LANES + lane
        live = j < n
        jc = torch.clamp(j, max=n - 1)
        d = pos[:, :, None] - pos[:, jc][:, None, :]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        pos_d = d2 > 0
        # guarded: autograd through sqrt at 0 would give NaN
        dist = torch.where(pos_d, torch.sqrt(torch.where(pos_d, d2, 1.0)),
                           0.0)
        ok = (live[None, :] & (iota[:, None] != j[None, :])
              & valid[:, None] & valid[jc][None, :] & (dist < cutoff))
        safe = torch.where(dist > 0, dist, 1.0)
        md = torch.clamp(d2, min=1e-12)
        inter = dist - (prm[0][:, None] + prm[0][jc][None, :])
        yield jc, d, d2, dist, safe, md, inter, ok


def _xor_tree(acc):
    """The kernels' __shfl_xor_sync reduction of the last (lane) axis:
    lane 0's sum."""
    lane = torch.arange(_LANES, device=acc.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc[..., 0]


def pairwise_field_lanes(pos, prm, cutoff: float):
    """The pairwise field [3, N] at ``pos`` from the folded parameters
    ``prm`` [5, N] (``pairwise_params``), in ``csrc/magnets.cu``'s
    summation order (each lane's partners in index order, then the
    shuffle tree), so that it equals the kernel bitwise; differentiable
    (the fused adjoint's step math, ``ops/adjoint.py::_force``)."""
    acc = pos.new_zeros((3, pos.shape[1], _LANES))
    for jc, d, d2, dist, safe, md, inter, ok in _lane_blocks(pos, prm,
                                                             cutoff):
        shell = torch.where(inter < 0, torch.abs(inter) * prm[1][:, None],
                            0.0)
        attract = prm[3][jc][None, :] * prm[2][:, None] / md
        coeff = (shell - attract) / safe
        acc = torch.where(ok, acc + d * coeff, acc)
    return _xor_tree(acc)


def _pair_bar(d, d2, dist, safe, md, inter, stiff_r, maxf_r, scale_s, g):
    """``magnets_adjoint.cuh::pair_bar``: (gd, ginter, gstiff, gmaxf,
    gscale) of the receivers' field terms for their cotangent g."""
    shell = torch.where(inter < 0, torch.abs(inter) * stiff_r, 0.0)
    attract = scale_s * maxf_r / md
    coeff = (shell - attract) / safe
    gcoeff = d[0] * g[0] + d[1] * g[1] + d[2] * g[2]
    gshell = gcoeff / safe
    gattr = -gshell
    gsafe = -(shell - attract) * gcoeff / (safe * safe)
    ginter = torch.where(inter < 0, -stiff_r * gshell, 0.0)
    gstiff = torch.where(inter < 0, -inter * gshell, 0.0)
    gmaxf = gattr * scale_s / md
    gscale = gattr * maxf_r / md
    gdist2 = torch.where(d2 > 1e-12, -gattr * scale_s * maxf_r / (md * md),
                         0.0)
    gdist = ginter + torch.where(dist > 0, gsafe, 0.0)
    gdist2 = gdist2 + torch.where(dist > 0, 0.5 * gdist / safe, 0.0)
    gd = coeff * g + 2.0 * d * gdist2
    return gd, ginter, gstiff, gmaxf, gscale


def magnet_transpose_plain(pos, prm, fixed, gf, cutoff: float):
    """Plain version of the pairwise field's transpose
    (``csrc/magnets_adjoint.cuh``, ``titan_tpu/ops/adjoint.py:935-1017``)
    for one force pass, in the kernel's summation order: the field's
    cotangent is ``gf * (1 - fixed)``; each mass sums, per lane, its
    receiver row (gpos += gd; its radius, stiffness and maxf gradients)
    and its source column (gpos -= gd; its radius and scale gradients),
    then the shuffle tree.  Returns (gpos [3, N], [4, N] gradients of
    rad, stiffness, maxf, scale)."""
    n = pos.shape[1]
    fixed = fixed.reshape(n)
    gfm = gf * (1.0 - fixed)
    acc = pos.new_zeros((7, n, _LANES))
    for jc, d, d2, dist, safe, md, inter, ok in _lane_blocks(pos, prm,
                                                             cutoff):
        r = _pair_bar(d, d2, dist, safe, md, inter, prm[1][:, None],
                      prm[2][:, None], prm[3][jc][None, :], gfm[:, :, None])
        s = _pair_bar(-d, d2, dist, safe, md, inter, prm[1][jc][None, :],
                      prm[2][jc][None, :], prm[3][:, None],
                      gfm[:, jc][:, None, :])
        new = torch.cat([acc[:3] + r[0] - s[0],
                         (acc[3] - r[1] - s[1])[None],
                         (acc[4] + r[2])[None], (acc[5] + r[3])[None],
                         (acc[6] + s[4])[None]])
        acc = torch.where(ok, new, acc)
    out = _xor_tree(acc)
    return out[:3], out[3:]


def magnet_transpose(pos, prm, fixed, gf, cutoff: float):
    """One force pass's pairwise field transpose (B5) launched on its own,
    a hook for tests and timing: the adjoints launch the kernel inside
    their sweeps (``csrc/adjoint_body.cuh``), counted by
    ``adjoint.bwd_run.mag_launches`` and
    ``adjoint_tiled.tiled_bwd_run.mag_launches``.  The CUDA kernel of
    ``csrc/magnets_adjoint.cuh`` for state on the card, bitwise
    ``magnet_transpose_plain``, which runs for state on the CPU.  ``fixed``
    [N] is 1 on frozen masses, ``gf`` [3, N] the pass's force cotangent.
    Returns (gpos [3, N], [4, N]).  ``magnet_transpose.launches`` counts
    this hook's launches only."""
    if pos.device.type == "cpu":
        return magnet_transpose_plain(pos, prm, fixed, gf, cutoff)
    if pos.device.type != "cuda":
        raise ValueError(f"magnet_transpose: state on {pos.device}")
    from .. import _build
    lib = _build.load("adjoint")
    fn = lib.titan_magnet_transpose
    fn.argtypes = [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    n = pos.shape[1]
    gpos = torch.zeros((3, n), dtype=torch.float32, device=pos.device)
    gmag = torch.zeros((4, n), dtype=torch.float32, device=pos.device)
    rc = fn(n, float(cutoff), _checked("pos", pos, (3, n)),
            _checked("params", prm, (5, n)),
            _checked("fixed", fixed.reshape(n), (n,)),
            _checked("gf", gf, (3, n)), gpos.data_ptr(), gmag.data_ptr(),
            torch.cuda.current_stream(pos.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"magnet transpose kernel launch failed: CUDA "
                           f"error {rc}")
    magnet_transpose.launches += 1
    return gpos, gmag


magnet_transpose.launches = 0


def binned_field_vjp(masses: MassState, shape, pos, gfm,
                     chunk_cells: int = 16384):
    """The binned field's vjp (the tiled magnet glue's transpose on a
    binned scene, as ``titan_tpu/ops/adjoint_tiled.py:1281-1305`` takes it
    in XLA): autograd through ``binned_magnet_forces`` at ``pos`` for the
    field's cotangent ``gfm`` (0 on frozen masses).  The grid kernel that
    fed the forward computes the same candidates (sources of rank < C in
    their cell), so this re-linearises its primal.  Returns (gpos [3, N],
    [4, N] gradients of rad, stiffness, maxf, scale)."""
    import dataclasses
    a_cells, cap = shape.magnet_binned
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (
            pos, masses.mag_rad, masses.mag_stiffness, masses.mag_maxf,
            masses.mag_scale)]
        mm = dataclasses.replace(
            masses, pos=leaves[0], mag_rad=leaves[1],
            mag_stiffness=leaves[2], mag_maxf=leaves[3],
            mag_scale=leaves[4])
        ridx = (magnet_receiver_idx(masses, shape.magnet_receivers)
                if shape.magnet_receivers else None)
        f = binned_magnet_forces(mm, shape.config.magnet_cutoff, a_cells,
                                 cap, chunk_cells=chunk_cells,
                                 receivers=shape.magnet_receivers, ridx=ridx)
        grads = torch.autograd.grad(f, leaves, gfm, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    return grads[0], torch.stack(grads[1:])
