"""The dense-grid magnet field (``titan_tpu/ops/magnets_grid.py``).

On the TPU, ``_grid_kernel`` streams a dense slot table [C, 8, G, G] through
VMEM and builds each block's 3 x 3 neighbourhood from rolls; a ``lax.cond``
sends the whole pass to the binned path (``ops/magnets.py``) whenever a
cell holds more than C masses.  On the card the table and the rolls are not
needed:

  setup (PyTorch, on the card; ``grid_setup``): the cell id of every
      mass (``magnets.cell_ids``), one stable sort of the cell ids (the
      sorted ids and the permutation), the start of each cell's run and of
      each grid row's run in the sorted order (one ``searchsorted``; a
      source's rank in its cell is its distance from that start), and the
      source fields (position, shell radius, scale) and the receiver's
      (stiffness, max force) gathered into the sorted order, so that a
      cell's sources are contiguous;
  kernel (``csrc/magnets_grid.cu``): the receivers in sorted order, one
      block per tile of ``GRID_TILE`` consecutive receivers of one grid
      row (``grid_tiles`` lists them as the kernel derives them), the
      tile's candidates (each cell's first C sources in the three rows and
      the cells its receivers' neighbourhoods reach) staged in shared
      memory, and each receiver walking its clamped 3 x 3 cells in (dx, dy)
      order and in each the sources of rank < C, in sorted order,
      accumulating in that fixed order; each field is written to the
      receiver's own column.

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
from typing import NamedTuple

import numpy as np
import torch

from ..state import MassState
from .magnets import GRID_DIM, _checked, cell_ids


# the kernel's tile (receivers a block), stage (sources a block holds in
# shared memory) and window (cells of a grid row a block stages) as
# csrc/magnets_grid.cu is built by default (TITAN_GRID_TILE and _STAGE
# may be set with -D); ``kernel_info`` reads a build's own
GRID_TILE, GRID_STAGE, GRID_WINDOW = 128, 512, 96


class GridSetup(NamedTuple):
    """One pass's setup (``grid_setup``)."""
    cell: torch.Tensor      # [N] int32 cell id of each mass (the sentinel
    #                         for an invalid one)
    starts: torch.Tensor    # [G*G + 1] int32 each cell's run, sorted order
    src: torch.Tensor       # [7, N] x, y, z, shell radius, scale,
    #                         stiffness, max force, sorted
    csort: torch.Tensor     # [N] int32 the cell ids in sorted order
    order: torch.Tensor     # [N] int64 the stable sort's permutation
    rows: torch.Tensor      # [G + 1] int32 each grid row's run (starts[x*G])


@functools.lru_cache(maxsize=None)
def _probes(device: torch.device) -> torch.Tensor:
    """The cell-start search's probe values as int32 on ``device``, made
    once: every cell 0 .. G*G, then every row's first cell 0, G, .., G*G."""
    G = GRID_DIM
    return torch.cat([torch.arange(G * G + 1, dtype=torch.int32),
                      torch.arange(0, G * G + 1, G,
                                   dtype=torch.int32)]).to(device)


def grid_setup(masses: MassState, cutoff: float) -> GridSetup:
    """Each mass's cell id (the sentinel for invalid masses), the stable
    sort by cell id (``csort``, ``order``), where each cell's run starts in
    it (``starts``; the sources of cell c are the columns ``starts[c] :
    starts[c + 1]`` of ``src``) and where each grid row's run starts
    (``rows``, the invalid masses after ``rows[G]``), and the source fields
    (x, y, z, shell radius, scale) and the receiver's (stiffness, max
    force) in the sorted order."""
    m = masses
    G = GRID_DIM
    cell = cell_ids(m.pos, m.valid, cutoff)
    csort, order = torch.sort(cell, stable=True)
    found = torch.searchsorted(csort, _probes(cell.device), out_int32=True)
    src = torch.cat([m.pos, m.mag_rad[None], m.mag_scale[None],
                     m.mag_stiffness[None], m.mag_maxf[None]])
    return GridSetup(cell, found[:G * G + 1],
                     torch.index_select(src, 1, order), csort, order,
                     found[G * G + 1:])


def grid_tiles(setup: GridSetup, cell_cap: int, tile: int = GRID_TILE
               ) -> dict:
    """The kernel's tiles for one pass, as its blocks derive them from
    ``setup.rows``: block b takes tile b of the row-major order, each grid
    row's sorted receivers cut into runs of ``tile`` (the last one
    shorter), the invalid masses last as row G.  Per tile (int64 [B]):
    ``row``, its receivers ``first`` .. ``last`` - 1 in sorted order, the
    cells ``ylo`` .. ``yhi`` of its window in rows ``row`` - 1 .. ``row`` +
    1 (the cells its receivers' neighbourhoods reach, clamped to the grid),
    and ``staged``, the window's sources (each cell's first ``cell_cap``;
    0 on row G).  A tile whose window is wider than the build's window
    or holds more sources than its stage reads them from device memory
    (``tiles_over_budget``)."""
    G = GRID_DIM
    rows = setup.rows.long()
    dev = rows.device
    n = setup.csort.shape[0]
    ends = torch.cat([rows[1:], rows.new_full((1,), n)])
    per = (ends - rows + tile - 1) // tile
    row = torch.repeat_interleave(torch.arange(G + 1, device=dev), per)
    b = torch.arange(row.shape[0], device=dev)
    first = rows[row] + (b - (torch.cumsum(per, 0) - per)[row]) * tile
    last = torch.minimum(first + tile, ends[row])
    real = row < G
    cs = setup.csort.long()
    ylo = torch.where(real, torch.clamp(cs[first] % G - 1, min=0), 0)
    yhi = torch.where(real, torch.clamp(cs[last - 1] % G + 1, max=G - 1), 0)
    starts = setup.starts.long()
    capped = torch.clamp(starts[1:] - starts[:-1], max=cell_cap)
    pre = torch.cat([capped.new_zeros(1), torch.cumsum(capped, 0)])
    staged = torch.zeros_like(row)
    for dx in (-1, 0, 1):
        xr = row + dx
        ok = real & (xr >= 0) & (xr < G)
        base = torch.where(ok, xr * G, 0)
        staged += torch.where(ok, pre[base + yhi + 1] - pre[base + ylo], 0)
    return dict(row=row, first=first, last=last, ylo=ylo, yhi=yhi,
                staged=staged)


def tiles_over_budget(setup: GridSetup, cell_cap: int,
                      tile: int = GRID_TILE, stage: int = GRID_STAGE,
                      window: int = GRID_WINDOW):
    """(tiles over the shared-memory budget, tiles): the tiles of a pass
    whose window is wider than ``window`` cells a row or holds more than
    ``stage`` sources, which read their candidates from device memory."""
    t = grid_tiles(setup, cell_cap, tile)
    over = (t["row"] < GRID_DIM) & ((t["yhi"] - t["ylo"] + 1 > window)
                                   | (t["staged"] > stage))
    return int(over.sum()), int(over.shape[0])


@functools.lru_cache(maxsize=None)
def cutoff_threshold(cutoff: float) -> float:
    """The least float32 t whose float32 square root is at least
    ``cutoff`` (as float32): ``sqrt(d2) < cutoff`` holds exactly when
    ``d2 < t`` for every float32 d2, since the square root is correctly
    rounded and monotone.  The kernel rejects a pair by it before taking
    the square root."""
    c = np.float32(cutoff)
    if not c > 0:
        return 0.0 if c <= 0 else float("nan")
    t = np.float32(c * c)
    while t > 0 and np.sqrt(np.nextafter(t, np.float32(0))) >= c:
        t = np.nextafter(t, np.float32(0))
    while np.sqrt(t) < c:
        t = np.nextafter(t, np.float32(np.inf))
    return float(t)


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
    cell, starts, src = (setup or grid_setup(masses, cutoff))[:3]
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


@functools.lru_cache(maxsize=None)
def _lib():
    from .. import _build
    lib = _build.load("magnets_grid")
    lib.titan_grid_magnet.argtypes = ([ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float]
                                      + [ctypes.c_void_p] * 7)
    lib.titan_grid_magnet.restype = ctypes.c_int
    lib.titan_grid_kernel_info.argtypes = [ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.titan_grid_kernel_info.restype = ctypes.c_int
    return lib


def kernel_info(device=None) -> dict:
    """The grid kernel's build and launch: its ``tile`` (receivers and
    threads a block), the ``blocks_asked`` an SM of its
    ``__launch_bounds__``, its ``stage`` (sources a block holds) and
    ``window`` (cells of a grid row a block stages), and on the card its
    registers a thread, local-memory bytes a thread and co-resident blocks
    an SM."""
    dev = torch.device("cuda", device if device is not None
                       else torch.cuda.current_device())
    out = (ctypes.c_int * 7)()
    rc = _lib().titan_grid_kernel_info(dev.index, out)
    if rc != 0:
        raise RuntimeError(f"grid magnet kernel_info: CUDA error {rc}")
    return dict(zip(("tile", "blocks_asked", "stage", "window", "registers",
                     "local_bytes", "blocks_per_sm"), out))


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
    g = grid_setup(masses, cutoff)
    n = pos.shape[1]
    out = torch.empty((3, n), dtype=torch.float32, device=pos.device)
    rc = _lib().titan_grid_magnet(
        n, int(cell_cap), cutoff_threshold(float(cutoff)),
        _checked("csort", g.csort, (n,), torch.int32),
        _checked("order", g.order, (n,), torch.int64),
        _checked("starts", g.starts, (GRID_DIM * GRID_DIM + 1,),
                 torch.int32),
        _checked("rows", g.rows, (GRID_DIM + 1,), torch.int32),
        _checked("src", g.src, (7, n)),
        out.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grid magnet kernel launch failed: CUDA error "
                           f"{rc}")
    grid_magnet_forces.launches += 1
    return out


grid_magnet_forces.launches = 0
