"""Binary STL import: parse, point-inside ray casting, lattice voxelization
(a copy of ``titan_tpu/stl.py``).

Host-side, vectorized numpy port of the reference's header-only parser
(include/Titan/stlparser.h) and Simulation::importFromSTL (sim.cu:2085-2151).
The import votes with ``STLFile.inside``, never ``native.stl_inside``: the
two cast different rays, and this one keeps the JAX package's masses.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from . import builders
from .containers import Container


@dataclasses.dataclass
class STLFile:
    header: bytes
    normals: np.ndarray   # [F, 3]
    tris: np.ndarray      # [F, 3, 3] (v1, v2, v3)

    @property
    def num_triangles(self) -> int:
        return self.tris.shape[0]

    def bounding_box(self):
        """(center [3], dims [3]) -- reference stlFile::getBoundingBox
        (stlparser.h:193-211).  NOTE the reference initializes min/max to
        DBL_MIN (a tiny positive number), so its bbox silently clips negative
        coordinates; we compute the true bbox (documented deviation)."""
        v = self.tris.reshape(-1, 3)
        lo, hi = v.min(axis=0), v.max(axis=0)
        return (hi - lo) / 2 + lo, hi - lo

    def inside(self, points: np.ndarray, num_rays: int = 10,
               seed: int = 0) -> np.ndarray:
        """Majority vote of odd ray-triangle crossing counts over num_rays
        random rays (reference stlFile::inside, stlparser.h:251-285), with
        Moller-Trumbore intersection (stlparser.h:213-245).

        Vectorized over all points and triangles at once; ``points`` is
        [P, 3], returns bool [P].  Deterministic via ``seed`` (the reference
        uses libc rand() state).
        """
        rng = np.random.default_rng(seed)
        rays = rng.uniform(-1000, 1000, size=(num_rays, 3))
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        eps = 1e-6

        v1 = self.tris[:, 0]                       # [F, 3]
        e1 = self.tris[:, 1] - v1                  # [F, 3]
        e2 = self.tris[:, 2] - v1
        votes = np.zeros(points.shape[0], dtype=np.int64)
        for r in rays:
            h = np.cross(r, e2)                    # [F, 3]
            a = np.einsum("fc,fc->f", e1, h)       # [F]
            ok = np.abs(a) >= eps
            f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
            # s depends on the point: [P, F, 3]
            s = points[:, None, :] - v1[None, :, :]
            u = f * np.einsum("pfc,fc->pf", s, h)
            q = np.cross(s, e1[None, :, :])        # [P, F, 3]
            v = f * np.einsum("pfc,c->pf", q, r)
            t = f * np.einsum("fc,pfc->pf", e2, q)
            hit = (ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0)
                   & (t > eps))
            votes += np.sum(hit, axis=1) % 2
        return votes / num_rays > 0.5


def parse_stl(path: str) -> STLFile:
    """Binary STL: 80-byte header, uint32 count, 50-byte records
    (reference parseSTL, stlparser.h:301-336)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header = data[:80]
    (count,) = struct.unpack_from("<I", data, 80)
    rec = np.frombuffer(data, dtype=np.uint8, count=count * 50, offset=84)
    rec = rec.reshape(count, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(count, 12).astype(np.float64)
    return STLFile(header=header, normals=floats[:, 0:3],
                   tris=floats[:, 3:12].reshape(count, 3, 3))


def import_from_stl(sim, path: str, density: float = 10.0,
                    num_rays: int = 5) -> Container:
    """Voxelize an STL into a culled lattice (reference sim.cu:2085-2151):
    scale the model's bbox to max-dimension 10, build a num_pts^3 lattice,
    keep masses whose mapped-back point is inside the mesh, drop springs with
    a culled endpoint."""
    f = parse_stl(path)
    center, dims = f.bounding_box()
    xdim, ydim, zdim = dims
    dimmax = float(max(dims))
    dimx, dimy, dimz = 10 * dims / dimmax
    num_pts = int(np.cbrt(density * (10 / dimmax) ** 3 * xdim * ydim * zdim))
    num_pts = max(num_pts, 2)

    pos = builders.lattice_positions(
        np.array([0.0, 0.0, dimz]),
        np.array([dimx - 0.001, dimy - 0.001, dimz - 0.001]),
        num_pts, num_pts, num_pts)
    left, right = builders.lattice_springs(num_pts, num_pts, num_pts)

    # map lattice coordinates back into the model frame (sim.cu:2110)
    mapped = np.stack([
        center[0] + (xdim / dimx) * pos[:, 0],
        center[1] + (ydim / dimy) * pos[:, 1],
        (zdim / dimz) * (pos[:, 2] - dimz) + center[2],
    ], axis=1)
    keep = f.inside(mapped, num_rays=num_rays)

    # Culled sites stay in the store as structural index HOLES (invalid,
    # never compacted) instead of being removed: spring index deltas then
    # remain the 13 lattice strides, so the whole import buckets into
    # stencil families and runs on the fused-kernel fast path.  (The
    # reference compacts, sim.cu:2130-2147; compacting here measured only
    # 65% of springs bucketed at max_families=64 vs 100% with holes.)
    # Springs touching a culled site are dropped outright, as there.
    s_keep = keep[left] & keep[right]
    left, right = left[s_keep], right[s_keep]
    rest = builders.rest_lengths(pos, left, right)

    c = Container(sim)
    all_idx = sim._store.add_masses_bulk(pos, m=0.1)
    st = sim._store
    st.valid[all_idx[~keep]] = False
    st.hole[all_idx[~keep]] = True
    c._mass_idx = all_idx[keep]          # user-visible: kept masses only
    c._spring_idx = sim._store.add_springs_bulk(
        all_idx[left], all_idx[right], k=10000.0, rest=rest)
    return c
