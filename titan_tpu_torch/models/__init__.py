"""Assembled model families (cloth, rope, walker, quadruped, tensegrity,
magnet truss); the counterpart of ``titan_tpu/models``."""

from .archetypes import (cloth, quadruped, rope, tensegrity,  # noqa: F401
                         truss_tetrahedron, walker)
