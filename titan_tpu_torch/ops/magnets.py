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
