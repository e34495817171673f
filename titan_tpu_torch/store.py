"""Growable host-side SoA staging store (a copy of ``titan_tpu/store.py``).

This is the host mirror of the device state: the source of truth before
``start()`` and the landing zone for ``get``/``getAll`` readback afterwards.
It replaces the reference's per-entity host objects + per-entity cudaMalloc
marshalling (sim.cu:933-1041) with flat numpy arrays; the flyweight handles in
entities.py give users the reference's object-per-mass API without paying an
object per mass (a 100^3 lattice is 1M masses -- the reference really does
1M cudaMallocs at start, sim.cu:942-944).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .config import PASSIVE_SOFT


@dataclasses.dataclass
class LocalConstraintRecord:
    """Sparse per-mass local constraint lists (reference LOCAL_CONSTRAINTS,
    object.h:181-201).  Only masses that actually have constraints get one."""

    contact_planes: List[Tuple[np.ndarray, float]] = dataclasses.field(default_factory=list)
    balls: List[Tuple[np.ndarray, float]] = dataclasses.field(default_factory=list)
    constraint_planes: List[Tuple[np.ndarray, float]] = dataclasses.field(default_factory=list)
    directions: List[Tuple[np.ndarray, float]] = dataclasses.field(default_factory=list)


class HostStore:
    """SoA arrays for masses and springs, with amortized-doubling growth.

    ``dtype`` is the float dtype of the host mirror (default float64, the
    reference's precision for host objects).  Pass float32 (e.g. via
    SimConfig.host_store_dtype) to halve host RAM and marshal staging for
    giant scenes -- at 100^3 the f64 store alone is ~1.5 GB.
    """

    _MASS_FIELDS_3 = ("pos", "vel", "acc", "extern_force", "color")

    #: reference default mass color (mass.cu:17); GRAPHICS-only data that
    #: lives host-side only -- it never reaches the device state
    DEFAULT_COLOR = (1.0, 0.2, 0.2)
    _MASS_FIELDS_1 = ("m", "T", "drag", "mag_rad", "mag_stiffness",
                      "mag_maxf", "mag_scale")

    def __init__(self, dtype=np.float64):
        self.dtype = np.dtype(dtype)
        self.n_masses = 0
        self.n_springs = 0
        cap_m, cap_s = 64, 64
        # mass arrays [(cap, 3)] / [(cap,)]
        for f in self._MASS_FIELDS_3:
            setattr(self, f, np.zeros((cap_m, 3), dtype=self.dtype))
        for f in self._MASS_FIELDS_1:
            setattr(self, f, np.zeros(cap_m, dtype=self.dtype))
        self.fixed = np.zeros(cap_m, dtype=bool)
        self.valid = np.zeros(cap_m, dtype=bool)
        # structural index holes: culled lattice sites (STL voxelization)
        # kept as permanently-invalid rows so spring index DELTAS stay the
        # lattice strides and the whole scene buckets into stencil families
        # (a compacted import measured only 65% bucketed at max_families;
        # holes-kept buckets 100% into the 13 lattice families).  Holes are
        # never compacted away and don't count toward the dead fraction.
        self.hole = np.zeros(cap_m, dtype=bool)
        # spring arrays
        self.left = np.full(cap_s, -1, dtype=np.int64)
        self.right = np.full(cap_s, -1, dtype=np.int64)
        self.s_valid = np.zeros(cap_s, dtype=bool)
        self.k = np.zeros(cap_s, dtype=self.dtype)
        self.rest = np.zeros(cap_s, dtype=self.dtype)
        self.damping = np.zeros(cap_s, dtype=self.dtype)
        self.s_type = np.zeros(cap_s, dtype=np.int8)
        self.omega = np.zeros(cap_s, dtype=self.dtype)
        self.l_max = np.zeros(cap_s, dtype=self.dtype)
        self.l_min = np.zeros(cap_s, dtype=self.dtype)
        self.rate = np.zeros(cap_s, dtype=self.dtype)
        # sparse local constraints
        self.local: Dict[int, LocalConstraintRecord] = {}

    # -- growth --------------------------------------------------------------
    def _grow(self, names, new_cap):
        for name in names:
            arr = getattr(self, name)
            shape = (new_cap,) + arr.shape[1:]
            grown = np.zeros(shape, dtype=arr.dtype)
            if arr.dtype == np.int64:
                grown.fill(-1)
            grown[: arr.shape[0]] = arr
            setattr(self, name, grown)

    def reserve_masses(self, count: int) -> None:
        need = self.n_masses + count
        cap = self.valid.shape[0]
        if need > cap:
            new_cap = max(need, cap * 2)
            self._grow(self._MASS_FIELDS_3 + self._MASS_FIELDS_1
                       + ("fixed", "valid", "hole"), new_cap)

    def reserve_springs(self, count: int) -> None:
        need = self.n_springs + count
        cap = self.s_valid.shape[0]
        if need > cap:
            new_cap = max(need, cap * 2)
            self._grow(("left", "right", "s_valid", "k", "rest", "damping",
                        "s_type", "omega", "l_max", "l_min", "rate"), new_cap)

    # -- appends ---------------------------------------------------------------
    def add_mass(self, pos, m: float = 0.1, fixed: bool = False,
                 rad: float = 0.0, stiffness: float = 1000.0,
                 max_mag_force: float = 0.0, mag_scale_factor: float = 0.0) -> int:
        """Append one mass; defaults follow Mass(const Vec&, ...) (mass.h:18-19).

        NOTE the reference's no-arg Mass() constructor uses m = 1.0
        (mass.cu:8-9); callers wanting that pass m explicitly.
        """
        self.reserve_masses(1)
        i = self.n_masses
        self.pos[i] = np.asarray(pos, dtype=np.float64)
        self.vel[i] = 0.0
        self.acc[i] = 0.0
        self.extern_force[i] = 0.0
        self.m[i] = m
        self.T[i] = 0.0
        self.drag[i] = 0.0
        self.mag_rad[i] = rad
        self.mag_stiffness[i] = stiffness
        self.mag_maxf[i] = max_mag_force
        self.mag_scale[i] = mag_scale_factor
        self.color[i] = self.DEFAULT_COLOR
        self.fixed[i] = fixed
        self.valid[i] = True
        self.n_masses += 1
        return i

    def add_masses_bulk(self, pos: np.ndarray, m: float = 0.1,
                        fixed: np.ndarray | None = None,
                        stiffness: float = 1000.0) -> np.ndarray:
        """Vectorized bulk append (builders); returns the new index range."""
        count = pos.shape[0]
        self.reserve_masses(count)
        i0, i1 = self.n_masses, self.n_masses + count
        self.pos[i0:i1] = pos
        self.vel[i0:i1] = 0.0
        self.acc[i0:i1] = 0.0
        self.extern_force[i0:i1] = 0.0
        self.m[i0:i1] = m
        self.T[i0:i1] = 0.0
        self.drag[i0:i1] = 0.0
        self.mag_rad[i0:i1] = 0.0
        self.mag_stiffness[i0:i1] = stiffness
        self.mag_maxf[i0:i1] = 0.0
        self.mag_scale[i0:i1] = 0.0
        self.color[i0:i1] = self.DEFAULT_COLOR
        self.fixed[i0:i1] = False if fixed is None else fixed
        self.valid[i0:i1] = True
        self.n_masses = i1
        return np.arange(i0, i1, dtype=np.int64)

    def add_spring(self, left: int = -1, right: int = -1, k: float = 10000.0,
                   rest: float = 1.0, s_type: int = PASSIVE_SOFT,
                   omega: float = 0.0, damping: float = 0.0,
                   l_max: float = 0.0, l_min: float = 0.0,
                   rate: float = 0.0) -> int:
        """Append one spring; defaults follow Spring() (spring.h:22-23)."""
        self.reserve_springs(1)
        i = self.n_springs
        self.left[i] = left
        self.right[i] = right
        self.s_valid[i] = True
        self.k[i] = k
        self.rest[i] = rest
        self.damping[i] = damping
        self.s_type[i] = s_type
        self.omega[i] = omega
        self.l_max[i] = l_max
        self.l_min[i] = l_min
        self.rate[i] = rate
        self.n_springs += 1
        return i

    def add_springs_bulk(self, left: np.ndarray, right: np.ndarray,
                         k: float = 10000.0,
                         rest: np.ndarray | float = 1.0) -> np.ndarray:
        count = left.shape[0]
        self.reserve_springs(count)
        i0, i1 = self.n_springs, self.n_springs + count
        self.left[i0:i1] = left
        self.right[i0:i1] = right
        self.s_valid[i0:i1] = True
        self.k[i0:i1] = k
        self.rest[i0:i1] = rest
        self.damping[i0:i1] = 0.0
        self.s_type[i0:i1] = PASSIVE_SOFT
        self.omega[i0:i1] = 0.0
        self.l_max[i0:i1] = 0.0
        self.l_min[i0:i1] = 0.0
        self.rate[i0:i1] = 0.0
        self.n_springs = i1
        return np.arange(i0, i1, dtype=np.int64)

    def local_record(self, i: int) -> LocalConstraintRecord:
        rec = self.local.get(i)
        if rec is None:
            rec = LocalConstraintRecord()
            self.local[i] = rec
        return rec

    # -- compaction -------------------------------------------------------------
    def compact(self) -> Tuple[np.ndarray, np.ndarray]:
        """Physically drop soft-deleted masses/springs (the reference's
        invalidate + thrust::remove compaction, sim.cu:343-414).

        Springs attached to a dropped mass are dropped with it (the
        reference's deleteMass removes associated springs).  Returns
        (mass_remap, spring_remap): old index -> new index, -1 = dropped.
        """
        n, s = self.n_masses, self.n_springs
        # structural holes are part of the index GEOMETRY (they keep spring
        # deltas equal to lattice strides); only real deletions are dropped
        keep_m = self.valid[:n] | self.hole[:n]
        new_m = np.cumsum(keep_m, dtype=np.int64) - 1
        new_m[~keep_m] = -1

        left, right = self.left[:s], self.right[:s]
        attached = (left >= 0) & (right >= 0)
        ends_ok = np.ones(s, dtype=bool)
        ends_ok[attached] = (keep_m[left[attached]]
                             & keep_m[right[attached]])
        keep_s = self.s_valid[:s] & ends_ok
        new_s = np.cumsum(keep_s, dtype=np.int64) - 1
        new_s[~keep_s] = -1

        for f in self._MASS_FIELDS_3 + self._MASS_FIELDS_1 + ("fixed",
                                                              "valid",
                                                              "hole"):
            arr = getattr(self, f)
            arr[: int(keep_m.sum())] = arr[:n][keep_m]
        for f in ("s_valid", "k", "rest", "damping", "s_type", "omega",
                  "l_max", "l_min", "rate"):
            arr = getattr(self, f)
            arr[: int(keep_s.sum())] = arr[:s][keep_s]
        lk, rk = left[keep_s], right[keep_s]
        self.left[: int(keep_s.sum())] = np.where(lk >= 0, new_m[lk], -1)
        self.right[: int(keep_s.sum())] = np.where(rk >= 0, new_m[rk], -1)
        self.n_masses = int(keep_m.sum())
        self.n_springs = int(keep_s.sum())
        self.local = {int(new_m[i]): rec for i, rec in self.local.items()
                      if i < n and new_m[i] >= 0}
        return new_m, new_s
