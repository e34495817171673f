"""The dense-grid magnet field (``titan_tpu/ops/magnets_grid.py``).

On the TPU, ``_grid_kernel`` streams a dense slot table [C, 8, G, G] through
VMEM and builds each block's 3 x 3 neighbourhood from rolls; a ``lax.cond``
sends the whole pass to the binned path (``ops/magnets.py``) whenever a
cell holds more than C masses.  On the card the table and the rolls are not
needed:

  setup (PyTorch, on the card): the cell id of every mass
      (``magnets.cell_ids``), one stable sort of the cell ids, the start
      of each cell's run in the sorted order ([G*G + 1],
      ``searchsorted``; a source's rank in its cell is its distance from
      that start), and the source fields (position, shell radius, scale)
      gathered into the sorted order, so that a cell's sources are
      contiguous;
  kernel (``csrc/magnets_grid.cu``): one thread per receiver, in the
      original mass order, walks the clamped 3 x 3 neighbour cells in
      (dx, dy) order and in each the sources of rank < C, in sorted order,
      accumulating in that fixed order.

The overflow branch needs no host sync: in both branches of the JAX
``lax.cond`` the receivers are exactly the valid masses, and the sources
are exactly the valid masses of rank < C in their cell (with no overflow
that is every valid mass; with it, the binned path's overflow rule,
``titan_tpu/ops/magnets.py:156-163``).  So "sources of rank < C" computes
``magnets_grid.py:245`` on every scene, with no branch.  Self pairs and
coincident pairs contribute nothing, as in both JAX branches.

``grid_magnet_forces`` launches the kernel for state on the card and runs
``grid_magnet_forces_plain`` (the same candidates, in the same order, as
vectorised PyTorch) for state on the CPU.  ``ops/step.py::magnet_route``
takes this route only on the card; on the CPU it takes the binned pass, as
the JAX package does off the TPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..state import MassState
from .magnets import GRID_DIM, _checked, cell_ids


@functools.lru_cache(maxsize=None)
def _cell_range(device: torch.device) -> torch.Tensor:
    """0 .. G*G as int32 on ``device``, made once: the probe values of the
    cell-start search."""
    return torch.arange(GRID_DIM * GRID_DIM + 1, dtype=torch.int32,
                        device=device)


def grid_setup(masses: MassState, cutoff: float):
    """(cell [N] int32, starts [G*G + 1] int32, src [5, N]): each mass's
    cell id (the sentinel for invalid masses), where each cell's run
    starts in the stable sort by cell id, and the source fields (x, y, z,
    shell radius, scale) in that sorted order.  The sources of cell c are
    the columns ``starts[c] : starts[c + 1]`` of ``src``."""
    m = masses
    cell = cell_ids(m.pos, m.valid, cutoff)
    csort, order = torch.sort(cell, stable=True)
    starts = torch.searchsorted(csort, _cell_range(cell.device),
                                out_int32=True)
    src = torch.cat([m.pos, m.mag_rad[None], m.mag_scale[None]])
    return cell, starts, torch.index_select(src, 1, order)


def grid_magnet_forces_plain(masses: MassState, cutoff: float,
                             cell_cap: int, setup=None) -> torch.Tensor:
    """Plain PyTorch version of the grid field kernel, [3, N]: every
    receiver's candidates (3 x 3 neighbour cells in (dx, dy) order, the
    first ``cell_cap`` sources of each) as a [N, 9C] table, the kernel's
    per-pair arithmetic on all of them at once, then the sum over the
    candidates in the kernel's order, one candidate at a time.  ``setup``
    is ``grid_setup(masses, cutoff)`` where the caller has it."""
    G, C = GRID_DIM, cell_cap
    pos = masses.pos
    n = pos.shape[1]
    dev = pos.device
    cell, starts, src = setup or grid_setup(masses, cutoff)
    cell = cell.long()
    starts = starts.long()
    real = cell < G * G
    cx, cy = cell // G, cell % G
    cols = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            x, y = cx + dx, cy + dy
            inr = real & (x >= 0) & (x < G) & (y >= 0) & (y < G)
            cc = torch.where(inr, x * G + y, 0)
            s0 = starts[cc]
            cnt = torch.where(inr, torch.clamp(starts[cc + 1] - s0, max=C), 0)
            k = torch.arange(C, device=dev)
            cols.append((s0[:, None] + k, k < cnt[:, None]))
    sidx = torch.cat([c[0] for c in cols], dim=1)            # [N, 9C]
    ok = torch.cat([c[1] for c in cols], dim=1)
    s = torch.clamp(sidx, max=max(n - 1, 0))
    d0 = pos[0][:, None] - src[0][s]
    d1 = pos[1][:, None] - src[1][s]
    d2 = pos[2][:, None] - src[2][s]
    dist2 = d0 * d0 + d1 * d1 + d2 * d2
    ok = ok & (dist2 > 0)
    dist = torch.sqrt(torch.where(ok, dist2, 1.0))
    ok = ok & (dist < cutoff)
    inter = dist - (masses.mag_rad[:, None] + src[3][s])
    shell = torch.where(inter < 0,
                        torch.abs(inter) * masses.mag_stiffness[:, None], 0.0)
    attract = (src[4][s] * masses.mag_maxf[:, None]
               / torch.clamp(dist2, min=1e-12))
    coeff = (shell - attract) / torch.where(ok, dist, 1.0)
    terms = torch.where(ok, torch.stack([d0, d1, d2]) * coeff, 0.0)
    out = torch.zeros_like(pos)
    for q in range(terms.shape[2]):
        out = out + terms[:, :, q]
    return out


def grid_magnet_forces(masses: MassState, cutoff: float,
                       cell_cap: int) -> torch.Tensor:
    """Magnet field [3, N] over the dense grid: the setup in PyTorch and
    the CUDA kernel for state on the card, ``grid_magnet_forces_plain`` for
    state on the CPU.  ``grid_magnet_forces.launches`` counts the kernel
    launches."""
    pos = masses.pos
    if pos.device.type == "cpu":
        return grid_magnet_forces_plain(masses, cutoff, cell_cap)
    if pos.device.type != "cuda":
        raise ValueError(f"grid_magnet_forces: state on {pos.device}")
    from .. import _build
    lib = _build.load("magnets_grid")
    fn = lib.titan_grid_magnet
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    cell, starts, src = grid_setup(masses, cutoff)
    n = pos.shape[1]
    out = torch.empty((3, n), dtype=torch.float32, device=pos.device)
    rc = fn(n, int(cell_cap), float(cutoff),
            _checked("cell", cell, (n,), torch.int32),
            _checked("starts", starts, (GRID_DIM * GRID_DIM + 1,),
                     torch.int32),
            _checked("src", src, (5, n)),
            _checked("pos", pos, (3, n)),
            _checked("mag_rad", masses.mag_rad, (n,)),
            _checked("mag_stiffness", masses.mag_stiffness, (n,)),
            _checked("mag_maxf", masses.mag_maxf, (n,)),
            out.data_ptr(),
            torch.cuda.current_stream(pos.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grid magnet kernel launch failed: CUDA error "
                           f"{rc}")
    grid_magnet_forces.launches += 1
    return out


grid_magnet_forces.launches = 0
