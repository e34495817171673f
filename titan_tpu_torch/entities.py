"""Flyweight entity handles: the reference's ``Mass``/``Spring`` object API
backed by rows of the host SoA store (a copy of ``titan_tpu/entities.py``).

Reference API surface: class Mass (mass.h:16-87) and class Spring
(spring.h:20-75).  Attribute names keep the reference's spelling, including
the underscore-prefixed public spring fields (``_k``, ``_rest``, ``_left``...)
that the reference's own tests poke directly
(test/physics/multiagent_unittest.cpp:47-48 does ``s1->_k = 0.01``).

Handles are views: mutating ``mass.pos`` writes the store; values observed
after ``start()`` are the last ``get``/``getAll`` snapshot, exactly like the
reference's host objects.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .config import CONSTRAINT_PLANE, CONTACT_PLANE, BALL, DIRECTION
from .vec import Vec


def _row_property(kind: str):
    """Store-row accessor that survives compaction.

    The reference frees deleted masses and physically compacts the device
    arrays (thrust::remove, sim.cu:353-414) -- surviving host POINTERS stay
    valid.  Handles here are row indices, so each compaction appends an
    old->new remap on the Simulation and handles lazily re-translate (and
    cache) their row on first use afterwards.  Accessing a handle whose
    entity was compacted away raises, the analog of the reference's freed
    pointer (which would be a use-after-free there).
    """

    def get(self):
        sim = self._sim
        if self._gen != sim._gen:
            i = sim._translate_index(self._gen, self._i_raw, kind)
            object.__setattr__(self, "_i_raw", i)
            object.__setattr__(self, "_gen", sim._gen)
        i = self._i_raw
        if i < 0:
            raise RuntimeError(
                f"this {kind} was deleted and compacted away")
        return i

    return property(get)


class Mass:
    """Handle to one mass (store row)."""

    __slots__ = ("_sim", "_i_raw", "_gen")

    def __init__(self, sim, index: int):
        object.__setattr__(self, "_sim", sim)
        object.__setattr__(self, "_i_raw", index)
        object.__setattr__(self, "_gen", getattr(sim, "_gen", 0))

    _i = _row_property("mass")

    @property
    def index(self) -> int:
        return self._i

    # -- core properties (reference mass.h:22-34) -----------------------------
    @property
    def m(self) -> float:
        return float(self._sim._store.m[self._i])

    @m.setter
    def m(self, v: float) -> None:
        self._sim._store.m[self._i] = v
        self._sim._touch_mass(self._i, "m")

    @property
    def T(self) -> float:
        return float(self._sim._store.T[self._i])

    @T.setter
    def T(self, v: float) -> None:
        self._sim._store.T[self._i] = v
        self._sim._touch_mass(self._i, "T")

    @property
    def pos(self) -> Vec:
        return Vec(self._sim._store.pos[self._i])  # writable view

    @pos.setter
    def pos(self, v) -> None:
        self._sim._store.pos[self._i] = Vec(v).numpy() if isinstance(v, Vec) else np.asarray(v)
        self._sim._touch_mass(self._i, "pos")

    @property
    def vel(self) -> Vec:
        return Vec(self._sim._store.vel[self._i])

    @vel.setter
    def vel(self, v) -> None:
        self._sim._store.vel[self._i] = Vec(v).numpy() if isinstance(v, Vec) else np.asarray(v)
        self._sim._touch_mass(self._i, "vel")

    def acceleration(self) -> Vec:
        """Reference mass.h:34."""
        return Vec(self._sim._store.acc[self._i].copy())

    @property
    def color(self) -> Vec:
        """Render color, rgb in [0, 1] (reference mass.h:50; default
        (1.0, 0.2, 0.2), mass.cu:17).  Host-side graphics data: consumed
        by the live viewer and HTML export, never staged to the device."""
        return Vec(self._sim._store.color[self._i].copy())

    @color.setter
    def color(self, v) -> None:
        self._sim._store.color[self._i] = \
            Vec(v).numpy() if isinstance(v, Vec) else np.asarray(v)

    def setExternalForce(self, v) -> None:
        """Persistent user external force (reference mass.h:33; see
        SimConfig.persistent_extern_force for the semantics note)."""
        self._sim._store.extern_force[self._i] = Vec(v).numpy() if isinstance(v, Vec) else np.asarray(v)
        self._sim._touch_mass(self._i, "extern_force")

    # -- magnet properties (reference mass.h:27-32) ----------------------------
    @property
    def rad(self) -> float:
        return float(self._sim._store.mag_rad[self._i])

    @rad.setter
    def rad(self, v: float) -> None:
        self._sim._store.mag_rad[self._i] = v
        self._sim._touch_mass(self._i)

    @property
    def stiffness(self) -> float:
        return float(self._sim._store.mag_stiffness[self._i])

    @stiffness.setter
    def stiffness(self, v: float) -> None:
        self._sim._store.mag_stiffness[self._i] = v
        self._sim._touch_mass(self._i)

    @property
    def max_mag_force(self) -> float:
        return float(self._sim._store.mag_maxf[self._i])

    @max_mag_force.setter
    def max_mag_force(self, v: float) -> None:
        self._sim._store.mag_maxf[self._i] = v
        self._sim._touch_mass(self._i)

    @property
    def mag_scale_factor(self) -> float:
        return float(self._sim._store.mag_scale[self._i])

    @mag_scale_factor.setter
    def mag_scale_factor(self, v: float) -> None:
        self._sim._store.mag_scale[self._i] = v
        self._sim._touch_mass(self._i)

    def isMagnetic(self) -> bool:
        """Reference mass.h:32: (bool) round(max_mag_force).  Uses C round
        semantics (half away from zero) -- Python's round() would give
        round(0.5) == 0."""
        return bool(math.floor(abs(self.max_mag_force) + 0.5))

    # -- constraints (reference mass.h:39-47, mass.cu:102-161) -----------------
    def fix(self) -> None:
        self._sim._store.fixed[self._i] = True
        self._sim._touch_mass(self._i)

    def unfix(self) -> None:
        self._sim._store.fixed[self._i] = False
        self._sim._touch_mass(self._i)

    @property
    def fixed(self) -> bool:
        return bool(self._sim._store.fixed[self._i])

    @property
    def valid(self) -> bool:
        return bool(self._sim._store.valid[self._i])

    def setDrag(self, C: float) -> None:
        self._sim._store.drag[self._i] = C
        self._sim._touch_mass(self._i)

    def addConstraint(self, ctype: int, vec, num: float) -> None:
        """Reference Mass::addConstraint (mass.cu:104-122)."""
        rec = self._sim._store.local_record(self._i)
        v = np.asarray(Vec(vec).numpy() if isinstance(vec, Vec) else vec,
                       dtype=np.float64)
        if ctype == CONSTRAINT_PLANE:
            n = v / math.sqrt(float(np.dot(v, v)))
            rec.constraint_planes.append((n, float(num)))
        elif ctype == CONTACT_PLANE:
            n = v / math.sqrt(float(np.dot(v, v)))
            rec.contact_planes.append((n, float(num)))
        elif ctype == BALL:
            rec.balls.append((v, float(num)))
        elif ctype == DIRECTION:
            t = v / math.sqrt(float(np.dot(v, v)))
            rec.directions.append((t, float(num)))
        else:
            raise ValueError(f"unknown constraint type {ctype}")
        self._sim._mark_structure_dirty(mass_index=self._i)

    def clearConstraints(self, ctype: Optional[int] = None) -> None:
        rec = self._sim._store.local.get(self._i)
        if rec is None:
            return
        if ctype is None:
            self._sim._store.local.pop(self._i, None)
        elif ctype == CONSTRAINT_PLANE:
            rec.constraint_planes.clear()
        elif ctype == CONTACT_PLANE:
            rec.contact_planes.clear()
        elif ctype == BALL:
            rec.balls.clear()
        elif ctype == DIRECTION:
            rec.directions.clear()
        self._sim._mark_structure_dirty(mass_index=self._i)

    def __repr__(self):
        p = self._sim._store.pos[self._i]
        return f"Mass(#{self._i}, pos=({p[0]}, {p[1]}, {p[2]}), m={self.m})"


def _spring_scalar(field):
    def get(self):
        return float(getattr(self._sim._store, field)[self._i])

    def set(self, v):
        getattr(self._sim._store, field)[self._i] = v
        self._sim._touch_spring(self._i, rest=(field == "rest"))

    return property(get, set)


class Spring:
    """Handle to one spring (store row).  Reference spring.h:20-75."""

    __slots__ = ("_sim", "_i_raw", "_gen")

    def __init__(self, sim, index: int):
        object.__setattr__(self, "_sim", sim)
        object.__setattr__(self, "_i_raw", index)
        object.__setattr__(self, "_gen", getattr(sim, "_gen", 0))

    _i = _row_property("spring")

    @property
    def index(self) -> int:
        return self._i

    _k = _spring_scalar("k")
    _rest = _spring_scalar("rest")
    _omega = _spring_scalar("omega")
    _damping = _spring_scalar("damping")
    _l_max = _spring_scalar("l_max")
    _l_min = _spring_scalar("l_min")
    _rate = _spring_scalar("rate")

    @property
    def _type(self) -> int:
        return int(self._sim._store.s_type[self._i])

    @_type.setter
    def _type(self, v: int) -> None:
        self._sim._store.s_type[self._i] = v
        self._sim._touch_spring(self._i)

    @property
    def _left(self) -> Optional[Mass]:
        li = int(self._sim._store.left[self._i])
        return Mass(self._sim, li) if li >= 0 else None

    @_left.setter
    def _left(self, m: Optional[Mass]) -> None:
        self._sim._store.left[self._i] = -1 if m is None else m._i
        self._sim._touch_spring(self._i)

    @property
    def _right(self) -> Optional[Mass]:
        ri = int(self._sim._store.right[self._i])
        return Mass(self._sim, ri) if ri >= 0 else None

    @_right.setter
    def _right(self, m: Optional[Mass]) -> None:
        self._sim._store.right[self._i] = -1 if m is None else m._i
        self._sim._touch_spring(self._i)

    # -- reference methods (spring.h:40-49) ------------------------------------
    def setRestLength(self, rest_length: float) -> None:
        self._rest = rest_length

    def defaultLength(self) -> None:
        """Rest length := current endpoint distance (reference spring.cu)."""
        st = self._sim._store
        li, ri = int(st.left[self._i]), int(st.right[self._i])
        if li < 0 or ri < 0:
            raise ValueError("spring has no masses attached")
        d = st.pos[ri] - st.pos[li]
        st.rest[self._i] = math.sqrt(float(np.dot(d, d)))
        self._sim._touch_spring(self._i, rest=True)

    def changeType(self, s_type: int, omega: float) -> None:
        self._type = s_type
        self._omega = omega

    def addDamping(self, constant: float) -> None:
        self._damping = constant

    def setLeft(self, m: Mass) -> None:
        self._left = m

    def setRight(self, m: Mass) -> None:
        self._right = m

    def setMasses(self, left: Mass, right: Mass) -> None:
        self._left = left
        self._right = right

    def __repr__(self):
        return (f"Spring(#{self._i}, left={int(self._sim._store.left[self._i])}, "
                f"right={int(self._sim._store.right[self._i])}, k={self._k}, "
                f"rest={self._rest})")


class HandleSeq:
    """Lazy sequence of handles over an index array (``sim.masses`` etc.)."""

    __slots__ = ("_sim", "_cls", "_indices")

    def __init__(self, sim, cls, indices):
        self._sim = sim
        self._cls = cls
        self._indices = indices  # numpy int array or callable -> length

    def _idx(self):
        ind = self._indices
        return ind() if callable(ind) else ind

    def __len__(self):
        ind = self._idx()
        return int(ind) if np.isscalar(ind) else len(ind)

    def __getitem__(self, i):
        ind = self._idx()
        if np.isscalar(ind):
            n = int(ind)
            if isinstance(i, slice):
                return [self._cls(self._sim, j) for j in range(*i.indices(n))]
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(i)
            return self._cls(self._sim, i)
        if isinstance(i, slice):
            return [self._cls(self._sim, int(j)) for j in ind[i]]
        return self._cls(self._sim, int(ind[i]))

    def __iter__(self):
        for j in range(len(self)):
            yield self[j]
