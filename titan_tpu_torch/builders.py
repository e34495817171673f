"""Vectorized scene topology generation (host side, numpy).

Replaces the reference's nested-loop C++ builders (Lattice object.cu:235-296,
Beam object.cu:299-363, Cube object.cu:182-199) with array programs that emit
identical mass positions, identical mass ordering (index = k + j*nz + i*ny*nz,
reference object.cu:257), and identical spring (left, right) pairs in the
identical emission order, so index-based user code (e.g. the multi-agent test
wiring masses[100] of one lattice to masses[0] of the next,
test/physics/multiagent_unittest.cpp:29-35) behaves the same.

A copy of ``titan_tpu/builders.py`` for the PyTorch port.  Lattices of
64,000 sites and up take the C++ emitter of ``titan_tpu_torch/native``, as
the JAX package's do; it emits the same springs in the same order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def lattice_positions(center, dims, nx: int, ny: int, nz: int) -> np.ndarray:
    """Mass positions of an nx*ny*nz lattice, ordered k + j*nz + i*ny*nz.

    Matches reference object.cu:242-248: component c of the grid coordinate is
    i/(n-1) - 0.5 when n > 1 else 0, scaled by dims and offset by center.
    """
    center = np.asarray(center, dtype=np.float64)
    dims = np.asarray(dims, dtype=np.float64)
    fx = (np.arange(nx) / (nx - 1.0) - 0.5) if nx > 1 else np.zeros(nx)
    fy = (np.arange(ny) / (ny - 1.0) - 0.5) if ny > 1 else np.zeros(ny)
    fz = (np.arange(nz) / (nz - 1.0) - 0.5) if nz > 1 else np.zeros(nz)
    gx, gy, gz = np.meshgrid(fx, fy, fz, indexing="ij")  # [nx, ny, nz]
    pos = np.stack([gx, gy, gz], axis=-1) * dims + center  # [nx, ny, nz, 3]
    return pos.reshape(-1, 3)  # C-order flatten == (i, j, k) nesting


def lattice_springs(nx: int, ny: int, nz: int) -> Tuple[np.ndarray, np.ndarray]:
    """Spring endpoint indices (left, right) of the 13-family lattice topology.

    Emission order matches the reference's per-cell loop (object.cu:250-291):
    cells iterate in (i, j, k) order, and within each cell the families are:
      F1..F7: forward corner springs, (l,m,n) in {0,1}^3 \\ {0} with n fastest
              -- left=(i,j,k), right=(i+l, j+m, k+n)
      F8:  (i,j,k+1)->(i,j+1,k)        [k<nz-1, j<ny-1]
      F9:  (i,j,k+1)->(i+1,j,k)        [k<nz-1, i<nx-1]
      F10: (i,j,k+1)->(i+1,j+1,k)      [all three interior]
      F11: (i+1,j,k+1)->(i,j+1,k)
      F12: (i,j+1,k+1)->(i+1,j,k)
      F13: (i,j+1,k)->(i+1,j,k)        [j<ny-1, i<nx-1]
    """
    if nx * ny * nz >= 64_000:  # the C++ emitter for big scenes
        from . import native
        return native.lattice_springs(nx, ny, nz)
    return lattice_springs_numpy(nx, ny, nz)


def lattice_springs_numpy(nx: int, ny: int,
                          nz: int) -> Tuple[np.ndarray, np.ndarray]:
    """``lattice_springs`` in numpy at any size (the C++ emitter's
    reference)."""
    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )

    def idx(di_l, dj_l, dk_l, di_r, dj_r, dk_r):
        left = (K + dk_l) + (J + dj_l) * nz + (I + di_l) * ny * nz
        right = (K + dk_r) + (J + dj_r) * nz + (I + di_r) * ny * nz
        return left, right

    in_x = I < nx - 1
    in_y = J < ny - 1
    in_z = K < nz - 1

    families = []  # list of (left, right, mask), each [nx, ny, nz]
    # F1..F7 corner springs, n (z) fastest to match the reference loop order
    for l in (0, 1):
        for m in (0, 1):
            for n in (0, 1):
                if l == 0 and m == 0 and n == 0:
                    continue
                mask = np.ones_like(in_x)
                if l:
                    mask = mask & in_x
                if m:
                    mask = mask & in_y
                if n:
                    mask = mask & in_z
                families.append((*idx(0, 0, 0, l, m, n), mask))
    families.append((*idx(0, 0, 1, 0, 1, 0), in_z & in_y))           # F8
    families.append((*idx(0, 0, 1, 1, 0, 0), in_z & in_x))           # F9
    families.append((*idx(0, 0, 1, 1, 1, 0), in_z & in_y & in_x))    # F10
    families.append((*idx(1, 0, 1, 0, 1, 0), in_z & in_y & in_x))    # F11
    families.append((*idx(0, 1, 1, 1, 0, 0), in_z & in_y & in_x))    # F12
    families.append((*idx(0, 1, 0, 1, 0, 0), in_y & in_x))           # F13

    # Stack family as the innermost axis, then C-flatten -> per-cell family
    # order nested inside (i, j, k) cell order, exactly like the reference.
    left = np.stack([f[0] for f in families], axis=-1).reshape(-1)
    right = np.stack([f[1] for f in families], axis=-1).reshape(-1)
    mask = np.stack([f[2] for f in families], axis=-1).reshape(-1)
    sel = np.flatnonzero(mask)
    return left[sel].astype(np.int32), right[sel].astype(np.int32)


def lattice_spring_count(nx: int, ny: int, nz: int) -> int:
    """Closed-form count of the 13-family topology (for capacity planning)."""
    left, right = lattice_springs(nx, ny, nz)
    return int(left.shape[0])


def cube_positions(center, side_length: float) -> np.ndarray:
    """8 cube corners (reference object.cu:186-188): corner i at
    side_length * (Vec(i&1, (i>>1)&1, (i>>2)&1) - 0.5) + center."""
    center = np.asarray(center, dtype=np.float64)
    i = np.arange(8)
    corners = np.stack([i & 1, (i >> 1) & 1, (i >> 2) & 1], axis=-1).astype(np.float64)
    return side_length * (corners - 0.5) + center


def cube_springs() -> Tuple[np.ndarray, np.ndarray]:
    """All 28 corner pairs (i, j), i<j, in reference order (object.cu:190-194)."""
    pairs = [(i, j) for i in range(8) for j in range(i + 1, 8)]
    left = np.array([p[0] for p in pairs], dtype=np.int32)
    right = np.array([p[1] for p in pairs], dtype=np.int32)
    return left, right


def beam_fixed_mask(nx: int, ny: int, nz: int) -> np.ndarray:
    """Beam = lattice with all i==0 masses fixed (reference object.cu:310-312)."""
    fixed = np.zeros(nx * ny * nz, dtype=bool)
    fixed[: ny * nz] = True
    return fixed


def rest_lengths(pos: np.ndarray, left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Default rest length = initial endpoint distance (reference
    object.cu:293-295 / Spring::defaultLength).

    Per-column `take` on a transposed copy: at 100^3 (12.7M springs) numpy
    row-gathers of [S, 3] f64 run ~5x slower than three 1-D takes, and the
    naive expression also allocates three 300 MB row temporaries."""
    posT = np.ascontiguousarray(pos.T)
    acc = None
    for j in range(posT.shape[0]):
        d = posT[j].take(right)
        np.subtract(d, posT[j].take(left), out=d)
        np.multiply(d, d, out=d)
        if acc is None:
            acc = d
        else:
            np.add(acc, d, out=acc)
    return np.sqrt(acc, out=acc)


def build_incidence(
    left: np.ndarray, right: np.ndarray, n_masses: int, n_springs_padded: int,
    valid: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-mass incidence lists for gather-mode force accumulation.

    Returns (inc_idx [N, D], inc_sign [N, D]) where D is the max vertex degree;
    inc_idx pads with ``n_springs_padded`` (callers append a zero row to the
    per-spring force array).  Sign +1 for right endpoints, -1 for left
    (reference applies +f to right, -f to left, sim.cu:1189-1196).
    """
    s = left.shape[0]
    ids = np.concatenate([right, left]).astype(np.int64)
    signs = np.concatenate([np.ones(s), -np.ones(s)])
    spring_of = np.concatenate([np.arange(s), np.arange(s)])
    if valid is not None:
        keep = np.concatenate([valid, valid])
        ids, signs, spring_of = ids[keep], signs[keep], spring_of[keep]
    order = np.argsort(ids, kind="stable")
    ids, signs, spring_of = ids[order], signs[order], spring_of[order]
    counts = np.bincount(ids, minlength=n_masses)
    max_deg = int(counts.max()) if counts.size and ids.size else 1
    max_deg = max(max_deg, 1)
    inc_idx = np.full((n_masses, max_deg), n_springs_padded, dtype=np.int32)
    inc_sign = np.zeros((n_masses, max_deg), dtype=np.float64)
    # slot position of each entry within its mass's list
    starts = np.zeros(n_masses + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(ids.shape[0]) - starts[ids]
    inc_idx[ids, slot] = spring_of
    inc_sign[ids, slot] = signs
    return inc_idx, inc_sign


def build_stencil_groups(
    left: np.ndarray, right: np.ndarray, valid: np.ndarray,
    n_masses: int, max_families: int = 26, min_count: int = 16,
):
    """Bucket springs by constant index offset (delta = right - left).

    Returns (families, remainder_idx):
      families: list of (delta, spring_idx [c], left_pos [c]) where every
        left_pos is unique within the family (one spring per (delta, left)).
      remainder_idx: spring indices that didn't fit any family.

    A lattice's 13 spring families each have a constant delta (reference
    object.cu:250-291), so regular scenes bucket completely; irregular
    springs (cross-agent links, STL remainders) fall through to the general
    gather path.  Families below ``min_count`` springs aren't worth a full
    [N]-wide stencil pass and stay in the remainder.
    """
    s = left.shape[0]
    alive = np.flatnonzero(valid)
    delta = right[alive] - left[alive]
    remainder = []
    families = []
    # process offsets by popularity; each offset's springs in index order
    # from one stable sort (a scan per offset costs seconds per thousand
    # irregular springs at 100^3)
    by_delta = np.argsort(delta, kind="stable")
    vals, starts, counts = np.unique(delta[by_delta], return_index=True,
                                     return_counts=True)
    order = np.argsort(-counts)
    threshold = max(min_count, n_masses // 256)
    for gi in order:
        d, c = int(vals[gi]), int(counts[gi])
        sel = alive[by_delta[starts[gi]:starts[gi] + c]]
        if d == 0 or c < threshold or len(families) >= max_families:
            remainder.append(sel)
            continue
        lp = left[sel]
        if np.unique(lp).shape[0] != c:
            # duplicate (delta, left) pairs: keep the first spring per slot
            # in the family, push the rest to the remainder
            first = np.zeros(c, dtype=bool)
            seen = {}
            for i, v in enumerate(lp):
                if v not in seen:
                    seen[v] = True
                    first[i] = True
            families.append((d, sel[first], lp[first]))
            remainder.append(sel[~first])
        else:
            families.append((d, sel, lp))
    rem = (np.concatenate(remainder) if remainder
           else np.zeros(0, dtype=np.int64))
    rem.sort()  # keep remainder in original emission order
    return families, rem


def build_segment_sort(
    left: np.ndarray, right: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted-segment permutation for SEGMENT scatter mode.

    Returns (perm [2S], sorted_ids [2S]) where the first S entries of the
    unsorted id list are right endpoints (+f) and the last S are left (-f).
    """
    ids = np.concatenate([right, left]).astype(np.int32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    return perm, ids[perm]
