"""The grid magnet kernel's tiles and staged walk, on the CPU.

``csrc/magnets_grid.cu`` takes the receivers in the order of the setup's
stable sort by cell id, one block per tile of consecutive receivers of one
grid row, stages each tile's candidates (each window cell's first C
sources) in shared memory and walks them there.  The kernel runs only on
the card, where ``chip_smoke.py`` holds it bitwise against
``grid_magnet_forces_plain``; here:

- ``magnets_grid.grid_tiles`` (the tiles as the kernel's blocks derive them
  from ``grid_setup``'s row starts) against a numpy brute force on small
  seeded clouds: overflow, edge cells, invalid masses, rows wider than one
  tile, windows over the stage.  Every receiver lies in exactly one tile,
  no tile crosses a grid row, and each tile's window covers its
  receivers' 3 x 3 neighbour cells;
- the block's staged walk emulated in numpy float32 (kept here, not in the
  package), reading the staged copy or, over the stage, the sorted source
  array, is bitwise ``grid_magnet_forces_plain``;
- the kernel's early reject ``d2 < cutoff_threshold(cutoff)`` decides as
  ``sqrt(d2) < cutoff`` on every float32 within 64 ulps of the threshold.

No JAX reference: ``grid_magnet_forces_plain`` is held against the JAX
package's grid kernel by tests/test_torch_magnets.py.
"""

import torch_threads  # noqa: F401  (before torch)

import numpy as np
import pytest
import torch

from titan_tpu_torch.ops import magnets_grid as TG
from titan_tpu_torch.state import MassState

G = TG.GRID_DIM
CUTOFF = 0.14


def cloud(pos, seed, valid=None):
    """A MassState on the CPU at ``pos`` [n, 3] with seeded magnet
    parameters (a tenth of the sources with scale 0)."""
    rng = np.random.RandomState(seed)
    n = len(pos)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    zeros = f32(np.zeros((3, n)))
    return MassState(
        pos=f32(np.asarray(pos).T.copy()), vel=zeros, acc=zeros,
        extern_force=zeros, m=f32(np.ones(n)), T=f32(np.zeros(n)),
        fixed=torch.zeros(n, dtype=torch.bool),
        valid=torch.ones(n, dtype=torch.bool) if valid is None
        else torch.from_numpy(valid),
        drag=f32(np.zeros(n)), mag_rad=f32(rng.uniform(0.01, 0.05, n)),
        mag_stiffness=f32(rng.uniform(100, 500, n)),
        mag_maxf=f32(rng.uniform(0.0, 2.0, n)),
        mag_scale=f32(rng.choice([0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                                  1.0, 1.0], n)))


def scene(name):
    """(masses, cell cap) of one seeded cloud."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "random":            # a few masses a cell
        return cloud(rng.uniform(-1.5, 1.5, (400, 3)), 1), 16
    if name == "overflow":          # 64 masses in about one cell, cap 8
        return cloud(rng.uniform(-0.01, 0.01, (64, 3)), 2), 8
    if name == "edge":              # clipped into the grid's corner cells
        p = np.concatenate([rng.uniform(0, 0.3, (48, 3)) - 30.0,
                            rng.uniform(0, 0.3, (48, 3)) + 30.0])
        return cloud(p, 3), 128
    if name == "invalid":           # deleted masses sort last, receive 0
        valid = rng.uniform(size=300) > 0.3
        return cloud(rng.uniform(-0.8, 0.8, (300, 3)), 4, valid), 16
    if name == "wide_row":          # one grid row, many tiles
        p = np.stack([rng.uniform(0.0, 0.13, 600),
                      rng.uniform(-2.5, 2.5, 600),
                      rng.uniform(-0.1, 0.1, 600)], 1)
        return cloud(p, 5), 16
    if name == "dense":             # windows over the default stage
        return cloud(rng.uniform(-0.2, 0.2, (3000, 3)), 6), 512
    raise ValueError(name)


def brute_tiles(masses, cap, tile):
    """The tiles by numpy from the cell ids: the stable sort, each grid
    row's run cut into runs of ``tile``, and each tile's window and staged
    source count."""
    cells = TG.cell_ids(masses.pos, masses.valid, CUTOFF).numpy()
    cs = np.sort(cells, kind="stable")
    row_of = np.minimum(cs // G, G)
    counts = np.bincount(cells[cells < G * G], minlength=G * G)
    out = {k: [] for k in ("row", "first", "last", "ylo", "yhi", "staged")}
    for x in range(G + 1):
        idx = np.nonzero(row_of == x)[0]
        for a in range(0, len(idx), tile):
            first, last = idx[a], idx[min(a + tile, len(idx)) - 1] + 1
            ylo = yhi = staged = 0
            if x < G:
                ys = cs[first:last] % G
                ylo, yhi = max(ys.min() - 1, 0), min(ys.max() + 1, G - 1)
                for xr in (x - 1, x, x + 1):
                    if 0 <= xr < G:
                        staged += int(np.minimum(
                            counts[xr * G + ylo: xr * G + yhi + 1],
                            cap).sum())
            for k, v in zip(out, (x, first, last, ylo, yhi, staged)):
                out[k].append(v)
    return {k: np.asarray(v, np.int64) for k, v in out.items()}, cs


SCENES = ("random", "overflow", "edge", "invalid", "wide_row", "dense")


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("name", SCENES)
def test_tile_table(name, tile):
    """grid_tiles is the brute force's tiles; they partition the sorted
    receivers, none crosses a grid row, and each window holds every
    receiver's 3 x 3 neighbour cells."""
    masses, cap = scene(name)
    setup = TG.grid_setup(masses, CUTOFF)
    got = {k: v.numpy() for k, v in TG.grid_tiles(setup, cap, tile).items()}
    want, cs = brute_tiles(masses, cap, tile)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = len(cs)
    covered = np.concatenate([np.arange(a, b) for a, b in
                              zip(got["first"], got["last"])])
    np.testing.assert_array_equal(covered, np.arange(n))
    assert (got["last"] - got["first"] <= tile).all()
    for b in range(len(got["row"])):
        c = cs[got["first"][b]:got["last"][b]]
        assert (np.minimum(c // G, G) == got["row"][b]).all()
        if got["row"][b] < G:
            y = c % G
            lo, hi = np.maximum(y - 1, 0), np.minimum(y + 1, G - 1)
            assert (got["ylo"][b] <= lo).all() and (hi <= got["yhi"][b]).all()
    if name == "wide_row":
        assert np.bincount(got["row"]).max() > 1


def test_dense_scene_exceeds_the_stage():
    """The dense cloud (chip_smoke.py builds the same kind of scene) has
    tiles whose windows hold more than the kernel's default stage."""
    masses, cap = scene("dense")
    over, tiles = TG.tiles_over_budget(TG.grid_setup(masses, CUTOFF), cap)
    assert 0 < over <= tiles


def staged_walk(masses, cap, tile, stage, window):
    """The kernel's blocks in torch float32: per tile, the window's staged
    copy (each cell's first ``cap`` sources, cell after cell), then each
    receiver's walk over its clamped 3 x 3 cells in (dx, dy) order, from
    the copy or, over ``stage`` sources or ``window`` cells a row, from
    each cell's run in the sorted source array, with the
    early reject ``d2 < t``, accumulating one source at a time; each field
    written to the receiver's own column.  Unwritten columns stay NaN.
    (The CPU's vectorised square root is not always correctly rounded, as
    the card's is; torch.sqrt here takes the plain version's.)"""
    setup = TG.grid_setup(masses, CUTOFF)
    tiles = {k: v.tolist() for k, v in TG.grid_tiles(setup, cap, tile).items()}
    src = setup.src
    cs, order = setup.csort.tolist(), setup.order.tolist()
    starts = setup.starts.tolist()
    t_cut = TG.cutoff_threshold(CUTOFF)
    out = torch.full_like(masses.pos, float("nan"))
    for b, x in enumerate(tiles["row"]):
        first, last = tiles["first"][b], tiles["last"][b]
        if x == G:
            out[:, order[first:last]] = 0.0
            continue
        ylo, yhi = tiles["ylo"][b], tiles["yhi"][b]
        nw = yhi - ylo + 1
        s0, cnt = [], []
        for xr in (x - 1, x, x + 1):
            for y in range(ylo, yhi + 1):
                ok = 0 <= xr < G
                c = xr * G + y
                s0.append(starts[c] if ok else 0)
                cnt.append(min(starts[c + 1] - starts[c], cap) if ok else 0)
        off = np.concatenate([[0], np.cumsum(cnt)]).tolist()
        fits = nw <= window and off[-1] <= stage
        staged = src[:, [a + k for a, c in zip(s0, cnt) for k in range(c)]]
        for j in range(first, last):
            cy = cs[j] % G
            cand = []
            for dx in (-1, 0, 1):
                if not 0 <= x + dx < G:
                    continue
                for dy in (-1, 0, 1):
                    if not 0 <= cy + dy < G:
                        continue
                    w = (dx + 1) * nw + (cy + dy - ylo)
                    cand.append(staged[:, off[w]:off[w + 1]] if fits else
                                src[:, s0[w]:s0[w] + cnt[w]])
            q = torch.cat(cand, 1)
            i = order[j]
            e = src[:3, j:j + 1] - q[:3]
            d2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
            take = (d2 > 0) & (d2 < t_cut)
            e, d2, q = e[:, take], d2[take], q[:, take]
            dist = torch.sqrt(d2)
            inter = dist - (src[3, j] + q[3])
            shell = torch.where(inter < 0, torch.abs(inter)
                                * masses.mag_stiffness[i], 0.0)
            attract = q[4] * masses.mag_maxf[i] / torch.clamp(d2, min=1e-12)
            terms = e * ((shell - attract) / dist)
            f = torch.zeros(3)
            for k in range(terms.shape[1]):
                f = f + terms[:, k]
            out[:, i] = f
    return out


S, W = TG.GRID_STAGE, TG.GRID_WINDOW


@pytest.mark.parametrize("name,tile,stage,window", [
    ("random", 128, S, W), ("random", 64, 48, W), ("overflow", 64, S, W),
    ("overflow", 32, 16, W), ("edge", 64, S, W), ("invalid", 128, S, W),
    ("wide_row", 64, S, W), ("wide_row", 128, 100, W),
    ("wide_row", 128, S, 6)])
def test_staged_walk_is_plain(name, tile, stage, window):
    """The emulated blocks are bitwise the plain version, staged and over
    the budget alike; every output column written."""
    masses, cap = scene(name)
    got = staged_walk(masses, cap, tile, stage, window)
    want = TG.grid_magnet_forces_plain(masses, CUTOFF, cap)
    assert not got.isnan().any()
    assert torch.equal(got, want)
    assert want.abs().max() > 0
    if (stage, window) != (S, W):
        setup = TG.grid_setup(masses, CUTOFF)
        assert TG.tiles_over_budget(setup, cap, tile, stage, window)[0] > 0


@pytest.mark.parametrize("cutoff", [0.14, 0.1, 0.05, 1.0, 0.333, 7.5])
def test_cutoff_threshold(cutoff):
    """d2 < t decides as float32 sqrt(d2) < cutoff within 64 ulps of t."""
    t = np.float32(TG.cutoff_threshold(cutoff))
    bits = t.view(np.int32) + np.arange(-64, 65, dtype=np.int32)
    d2 = bits.view(np.float32)
    c = np.float32(cutoff)
    np.testing.assert_array_equal(d2 < t, np.sqrt(d2) < c)
    assert np.sqrt(t) >= c > np.sqrt(d2[63])
