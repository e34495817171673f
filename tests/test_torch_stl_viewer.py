"""The port's host modules of STL import, recording and live viewing, the
native emitter and the test helpers against titan_tpu's: ``stl.py``,
``runtime/viewer.py``, ``runtime/live.py``, ``native/`` and
``testutil.py``.

- ``parse_stl`` and ``STLFile.inside`` give JAX's arrays exactly; the
  store after ``importFromSTL`` holds JAX's pos, valid, hole, left, right
  and rest exactly, and the import buckets into the same stencil families.
- ``Recorder``'s frames within 1e-5 of JAX's (f32; a cube in free fall),
  its exports the same document but for frame rounding.
- ``LiveViewer`` serves the page, the topology and frames over loopback;
  each frame it samples equals the snapshot of its time.
- The native lattice emitter equals the numpy emitter and
  ``titan_tpu.native``'s, and its inside test the numpy one's on the unit
  cube of ``tests/test_native.py``.  ``titan_tpu.native`` runs on its own
  ``topology.cpp`` compiled into this test's temporary directory: its own
  build writes the JAX package's directory without a temporary file, and
  ``tests/test_native.py`` may build it at the same time in another
  worker.
- ``energy`` and ``momentum`` equal JAX's at rtol 1e-6 (f64 runs).
"""

import torch_threads  # noqa: F401  (before torch)

import ctypes
import json
import pathlib
import subprocess
import time
import urllib.request

import jax
import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu import native as jax_native
from titan_tpu import stl as jax_stl
from titan_tpu import testutil as jax_testutil
from titan_tpu.runtime import viewer as jax_viewer
from titan_tpu_torch import builders, native, stl, testutil
from titan_tpu_torch.ops.step import chunk_route
from titan_tpu_torch.runtime import viewer
from titan_tpu_torch.runtime.live import LiveViewer

from test_stl import _box_tris, _write_binary_stl

PKGS = (titan_tpu_torch, titan_tpu)


def new_sim(pkg, **cfg):
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    return pkg.Simulation(pkg.SimConfig(**cfg))


def ell_tris():
    """An L-shaped solid (test_stl.py's union of two boxes)."""
    return np.concatenate([_box_tris([0, 0, 0], [2, 1, 1]),
                           _box_tris([0, 0, 1], [1, 1, 2])])


@pytest.fixture(scope="module")
def ell_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("stl") / "ell.stl")
    _write_binary_stl(p, ell_tris())
    return p


def test_parse_and_inside_match_jax(ell_path):
    got, want = stl.parse_stl(ell_path), jax_stl.parse_stl(ell_path)
    assert got.header == want.header
    np.testing.assert_array_equal(got.normals, want.normals)
    np.testing.assert_array_equal(got.tris, want.tris)
    for a, b in zip(got.bounding_box(), want.bounding_box()):
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(4).uniform(-0.5, 2.5, size=(300, 3))
    inside = got.inside(pts, num_rays=9)
    np.testing.assert_array_equal(inside, want.inside(pts, num_rays=9))
    assert 0 < inside.sum() < len(pts)


def test_import_from_stl_matches_jax(ell_path):
    stores, shapes = {}, {}
    for pkg in PKGS:
        sim = new_sim(pkg, velocity_clamp=False)
        c = sim.importFromSTL(ell_path, density=3.0, num_rays=9)
        st = sim._store
        n, s = st.n_masses, st.n_springs
        assert len(c.masses) == int(np.count_nonzero(st.valid[:n]))
        stores[pkg] = {f: getattr(st, f)[:k].copy() for f, k in (
            ("pos", n), ("valid", n), ("hole", n), ("left", s),
            ("right", s), ("rest", s))}
        sim.createPlane(pkg.Vec(0, 0, 1), 0)
        sim.setTimeStep(0.0001)
        sim.start()
        sim.pause(0.005)
        sim.getAll()
        assert np.isfinite(st.pos[:n][st.valid[:n]]).all()
        shapes[pkg] = sim._shape
        sim.stop()
    for f, arr in stores[titan_tpu_torch].items():
        np.testing.assert_array_equal(arr, stores[titan_tpu][f], err_msg=f)
    st = stores[titan_tpu_torch]
    assert st["hole"].any() and np.array_equal(st["hole"], ~st["valid"])
    got, want = shapes[titan_tpu_torch], shapes[titan_tpu]
    assert got.stencil_deltas == want.stencil_deltas
    assert len(got.stencil_deltas) == 13 and not got.has_remainder
    assert chunk_route(got)[0] == "fused"


def record(pkg, tmp_path):
    sim = new_sim(pkg, velocity_clamp=False)
    sim.createCube(pkg.Vec(0, 0, 2), 1.0)
    sim.createPlane(pkg.Vec(0, 0, 1), 0)
    sim.setViewport(pkg.Vec(12, -3, 7), pkg.Vec(0, 0, 2), pkg.Vec(0, 0, 1))
    sim.setTimeStep(0.0001)
    rec = (viewer if pkg is titan_tpu_torch else jax_viewer).Recorder(
        sim, cadence=0.01)
    assert sim.fps() == -1.0
    sim.start()
    rec.run_until(0.05)
    fps = sim.fps()
    html = str(tmp_path / f"{pkg.__name__}.html")
    rec.export_html(html)
    npz = str(tmp_path / f"{pkg.__name__}.npz")
    rec.save_npz(npz)
    sim.stop()
    text = open(html).read()
    start = text.index("const D = ") + len("const D = ")
    with np.load(npz) as d:
        arrays = {k: d[k] for k in d.files}
    return rec, fps, text, json.loads(text[start:text.index(";\n", start)]), \
        arrays


def test_recorder_and_exports_match_jax(tmp_path):
    rec, fps, text, data, arrays = record(titan_tpu_torch, tmp_path)
    jrec, _, jtext, jdata, jarrays = record(titan_tpu, tmp_path)
    assert fps > 0
    assert rec.times == pytest.approx(jrec.times, abs=1e-12)
    assert len(rec.frames) == 6
    np.testing.assert_allclose(np.stack(rec.frames), np.stack(jrec.frames),
                               atol=1e-5, rtol=0)
    assert rec.frames[-1][:, 2].mean() < rec.frames[0][:, 2].mean()
    for key in jdata:
        if key != "frames":
            assert data[key] == jdata[key], key
    np.testing.assert_allclose(data["frames"], jdata["frames"], atol=2e-4)
    assert data["camera"] == [[12.0, -3.0, 7.0], [0.0, 0.0, 2.0]]
    assert text[:text.index("const D = ")] == jtext[:jtext.index("const D = ")]
    assert set(arrays) == set(jarrays)
    for k in ("left", "right", "s_valid", "times"):
        np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)
    np.testing.assert_allclose(arrays["frames"], jarrays["frames"], atol=1e-5)


def test_live_viewer_serves_frames_over_loopback():
    """The page, the topology and frames over HTTP while the simulation
    runs, and every recorded frame equal to the snapshot of its time."""
    V = titan_tpu_torch.Vec
    sim = new_sim(titan_tpu_torch, velocity_clamp=False)
    sim.createLattice(V(0, 0, 2), V(1, 1, 1), 3, 3, 3)
    sim.createPlane(V(0, 0, 1), 0)
    sim.setViewport(V(5, -5, 3), V(0, 0, 1), V(0, 0, 1))
    sim.setTimeStep(0.0001)
    sim.start()
    lv = LiveViewer(sim, cadence=0.01, record=True)
    try:
        # sampled at pauses first: each frame is the snapshot of its time
        for _ in range(3):
            sim.wait(0.002)
            lv._sample_once()
            sim.getAll()
            assert lv.times[-1] == sim.time()
            np.testing.assert_array_equal(
                lv.frames[-1], sim._store.pos[:27].astype(np.float32))
            sim.resume()
        lv.start()
        sim.setBreakpoint(5.0)

        def get(path):
            with urllib.request.urlopen(lv.url.rstrip("/") + path,
                                        timeout=10) as r:
                return r.read()

        page = get("/").decode()
        assert "titan-tpu live" in page and "/frame" in page
        topo = json.loads(get("/topology"))
        assert len(topo["edges"]) > 0 and len(topo["planes"]) == 1
        assert topo["camera"] == [[5.0, -5.0, 3.0], [0.0, 0.0, 1.0]]
        t0 = json.loads(get("/frame"))["t"]
        frame = None
        for _ in range(600):
            time.sleep(0.02)
            frame = json.loads(get("/frame"))
            if frame["t"] > t0:
                break
        assert frame["t"] > t0 and frame["running"] is True
        pos = np.array(frame["pos"])
        assert pos.shape == (27, 3) and np.isfinite(pos).all()
        assert lv.times == sorted(lv.times)
        assert b"titan-tpu viewer" in get("/export.html")
    finally:
        lv.stop()
        sim.stop()


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """titan_tpu/native/topology.cpp built into a temporary directory and
    bound as ``titan_tpu.native.get_lib`` binds it."""
    src = pathlib.Path(jax_native.__file__).parent / "topology.cpp"
    out = tmp_path_factory.mktemp("jax_native") / "libtitan_native.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.titan_lattice_spring_count.restype = ctypes.c_int64
    lib.titan_lattice_spring_count.argtypes = [ctypes.c_int32] * 3
    lib.titan_lattice_springs.restype = ctypes.c_int64
    lib.titan_lattice_springs.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.titan_stl_inside.restype = None
    lib.titan_stl_inside.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
    return lib


@pytest.fixture
def jax_native_on(jax_native_lib, monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", jax_native_lib)
    monkeypatch.setattr(jax_native, "_tried", True)


@pytest.mark.parametrize("dims", [(5, 5, 5), (4, 2, 3), (1, 3, 3),
                                  (41, 40, 42)])
def test_native_lattice_springs_match_numpy_and_jax(dims, jax_native_on):
    got = native.lattice_springs(*dims)
    want = builders.lattice_springs_numpy(*dims)
    jax_got = jax_native.lattice_springs(*dims)
    for a, b, c in zip(got, want, jax_got):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if np.prod(dims) >= 64_000:
        for a, b in zip(builders.lattice_springs(*dims), want):
            np.testing.assert_array_equal(a, b)


def test_native_spring_counts():
    lib = native.get_lib()
    assert lib.titan_lattice_spring_count(43, 43, 43) == 984438
    assert lib.titan_lattice_spring_count(100, 100, 100) == 12731796


def test_native_stl_inside_matches_numpy_and_jax(jax_native_on):
    tris = _box_tris([0, 0, 0], [1, 1, 1])
    pts = np.random.default_rng(3).uniform(-0.5, 1.5, size=(200, 3))
    want = np.all(pts > 0, axis=1) & np.all(pts < 1, axis=1)
    got = native.stl_inside(tris, pts, num_rays=9)
    f = stl.STLFile(header=b"", normals=np.zeros((12, 3)), tris=tris)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(f.inside(pts, num_rays=9), want)
    np.testing.assert_array_equal(
        got, jax_native.stl_inside(tris, pts, num_rays=9))


def test_energy_and_momentum_match_jax():
    jax.config.update("jax_enable_x64", True)
    try:
        got = {}
        for pkg, util in ((titan_tpu_torch, testutil),
                          (titan_tpu, jax_testutil)):
            sim = new_sim(pkg, dtype="float64")
            sim.createLattice(pkg.Vec(0, 0, 2), pkg.Vec(1, 1, 1), 3, 3, 3)
            sim.createPlane(pkg.Vec(0, 0, 1), 0)
            sim.setTimeStep(0.0001)
            sim.start()
            sim.pause(0.01)
            e0 = util.energy(sim)
            p0 = util.momentum(sim).numpy()
            sim.stop()
            got[pkg] = (e0, p0)
    finally:
        jax.config.update("jax_enable_x64", False)
    (e, p), (je, jp) = got[titan_tpu_torch], got[titan_tpu]
    assert e == pytest.approx(je, rel=1e-6)
    np.testing.assert_allclose(p, jp, rtol=1e-6, atol=1e-6 * np.abs(jp).max())
