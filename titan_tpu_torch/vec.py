"""Host-side 3-vector matching the reference's ``titan::Vec`` API surface.

The reference implements a CUDA-callable double-precision 3-vector with a
full operator set plus ``dot``/``cross`` (reference: include/Titan/vec.h:33-166,
src/vec.cu:13-45).  A copy of ``titan_tpu/vec.py``: this type exists *only*
on the host, as a convenience for scene construction and user code; all
device math happens on SoA torch tensors.  The device-side ``atomicVecAdd``
(reference vec.cu:13-37) has no equivalent here by design: spring->mass force
accumulation is a deterministic gather (see titan_tpu_torch/ops/forces.py,
``scatter_spring_forces``, and the per-mass gather of the CUDA kernel).
"""

from __future__ import annotations

import math
from typing import Iterable, Union

import numpy as np

Number = Union[int, float, np.floating]


class Vec:
    """A mutable 3-vector of Python floats.

    May wrap a view into a larger numpy array (the flyweight entity handles in
    titan_tpu_torch/entities.py expose ``mass.pos`` as a writable view into the host
    SoA store), in which case in-place mutation writes through.
    """

    __slots__ = ("_v",)

    def __init__(self, x: Union[Number, Iterable, "Vec", np.ndarray] = 0.0,
                 y: Number = 0.0, z: Number = 0.0):
        if isinstance(x, Vec):
            self._v = x._v.astype(np.float64, copy=True)
        elif isinstance(x, np.ndarray):
            # wrap without copy -> view semantics for store-backed vectors
            self._v = x
        elif isinstance(x, (list, tuple)):
            self._v = np.asarray(x, dtype=np.float64).copy()
        else:
            self._v = np.array([x, y, z], dtype=np.float64)

    # -- basic accessors ----------------------------------------------------
    def __getitem__(self, i: int) -> float:
        return float(self._v[i])

    def __setitem__(self, i: int, val: Number) -> None:
        self._v[i] = val

    def __iter__(self):
        return iter(float(c) for c in self._v)

    def __len__(self) -> int:
        return 3

    @property
    def x(self) -> float:
        return float(self._v[0])

    @property
    def y(self) -> float:
        return float(self._v[1])

    @property
    def z(self) -> float:
        return float(self._v[2])

    def numpy(self) -> np.ndarray:
        return np.asarray(self._v, dtype=np.float64).copy()

    # -- arithmetic (all return fresh Vecs) ----------------------------------
    def __add__(self, other):
        return Vec(self._v + _coerce(other))

    def __radd__(self, other):
        return Vec(_coerce(other) + self._v)

    def __sub__(self, other):
        return Vec(self._v - _coerce(other))

    def __rsub__(self, other):
        return Vec(_coerce(other) - self._v)

    def __mul__(self, other):
        return Vec(self._v * _scalar_or_vec(other))

    def __rmul__(self, other):
        return Vec(_scalar_or_vec(other) * self._v)

    def __truediv__(self, other):
        return Vec(self._v / _scalar_or_vec(other))

    def __neg__(self):
        return Vec(-self._v)

    # in-place ops write through when wrapping a store view
    def __iadd__(self, other):
        self._v += _coerce(other)
        return self

    def __isub__(self, other):
        self._v -= _coerce(other)
        return self

    def __imul__(self, other):
        self._v *= _scalar_or_vec(other)
        return self

    def __itruediv__(self, other):
        self._v /= _scalar_or_vec(other)
        return self

    def __eq__(self, other):
        if not isinstance(other, (Vec, list, tuple, np.ndarray)):
            return NotImplemented
        return bool(np.all(self._v == _coerce(other)))

    def __repr__(self):
        return f"Vec({self._v[0]}, {self._v[1]}, {self._v[2]})"

    # -- norms ----------------------------------------------------------------
    def norm(self) -> float:
        return float(math.sqrt(float(np.dot(self._v, self._v))))

    def sum(self) -> float:
        return float(np.sum(self._v))

    def normalized(self) -> "Vec":
        n = self.norm()
        return Vec(self._v / n)


def _coerce(other) -> np.ndarray:
    if isinstance(other, Vec):
        return other._v
    return np.asarray(other, dtype=np.float64)


def _scalar_or_vec(other):
    if isinstance(other, Vec):
        return other._v
    return other


def dot(a: Vec, b: Vec) -> float:
    """Dot product (reference: src/vec.cu:39-41)."""
    return float(np.dot(_coerce(a), _coerce(b)))


def cross(a: Vec, b: Vec) -> Vec:
    """Cross product (reference: src/vec.cu:43-45)."""
    return Vec(np.cross(_coerce(a), _coerce(b)))
