"""Native (C++) host-side helpers, loaded with ctypes: a port of
``titan_tpu/native``.

``topology.cpp`` (a copy of the JAX package's) emits a lattice's springs in
the numpy builders' exact order and runs the STL point-inside test.  It is
built at first use, never at import, with ``g++ -O3 -shared -fPIC`` into
``titan_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags; each process compiles into a
file of its own and moves it into place with ``os.replace``, so processes
that build at once never load a half-written library.  A failed build
raises with the compiler's report: ``builders.lattice_springs`` takes this
path for every lattice of 64,000 sites and up, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "topology.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the build of ``topology.cpp`` lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"libtitan_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``topology.cpp`` if its build is missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded native library, building it first if needed."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.titan_lattice_spring_count.restype = ctypes.c_int64
            lib.titan_lattice_spring_count.argtypes = [ctypes.c_int32] * 3
            lib.titan_lattice_springs.restype = ctypes.c_int64
            lib.titan_lattice_springs.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.titan_stl_inside.restype = None
            lib.titan_stl_inside.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8)]
            _lib = lib
        return _lib


def lattice_springs(nx: int, ny: int, nz: int):
    """(left, right) int32 spring endpoints of the 13-family lattice, in
    ``builders.lattice_springs``' order."""
    lib = get_lib()
    count = lib.titan_lattice_spring_count(nx, ny, nz)
    left = np.empty(count, dtype=np.int32)
    right = np.empty(count, dtype=np.int32)
    written = lib.titan_lattice_springs(
        nx, ny, nz,
        left.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        right.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if written != count:
        raise RuntimeError(f"titan_lattice_springs wrote {written} springs "
                           f"of {count}")
    return left, right


def stl_inside(tris: np.ndarray, pts: np.ndarray, num_rays: int,
               seed: int = 1) -> np.ndarray:
    """Majority-vote ray-casting inside test of ``pts`` [P, 3] against the
    triangles ``tris`` [F, 3, 3]; bool [P].  Its rays come from its own
    xorshift stream, not ``stl.STLFile.inside``'s, so the two can part on
    points near a face."""
    lib = get_lib()
    tris = np.ascontiguousarray(tris, dtype=np.float64)
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    out = np.zeros(pts.shape[0], dtype=np.uint8)
    lib.titan_stl_inside(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), tris.shape[0],
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), pts.shape[0],
        num_rays, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)
