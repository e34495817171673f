"""The port's control plane (``runtime/simulation.py``: viewport, debug
prints, ``reset``, ``compact``) against titan_tpu's.

- Every public method of ``titan_tpu.Simulation`` but ``distribute``
  (multi-device, ROADMAP A9) exists on the port's, with the same
  signature.
- ``getProjectionMatrix`` after ``setViewport`` and ``moveViewport``
  equals JAX's at atol 1e-12; ``printPositions`` and ``printSprings``
  print the same text.
- ``tests/test_compaction.py``'s cases through the port: handles,
  containers and springs remap as JAX's do; the state after a mid-run
  compaction within 2e-5 of JAX's, in f64 (XLA:CPU and PyTorch round the
  stiff f32 spring forces differently, ROADMAP queue C), over 0.06 s in
  place of 0.4 (the port's CPU chunk costs ~1.5 ms a step).
"""

import torch_threads  # noqa: F401  (before torch)

import inspect

import jax
import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch

PKGS = (titan_tpu_torch, titan_tpu)


def new_sim(pkg, **cfg):
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    return pkg.Simulation(pkg.SimConfig(**cfg))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_every_public_method_but_distribute_exists():
    public = {n for n in dir(titan_tpu.Simulation) if not n.startswith("_")}
    port = {n for n in dir(titan_tpu_torch.Simulation)
            if not n.startswith("_")}
    assert public - port == {"distribute"}
    for name in sorted(public & port):
        a = getattr(titan_tpu.Simulation, name)
        b = getattr(titan_tpu_torch.Simulation, name)
        if callable(a):
            assert inspect.signature(a) == inspect.signature(b), name


def test_projection_matrix_matches_jax():
    got = {}
    for pkg in PKGS:
        sim = new_sim(pkg)
        sim.createMass(pkg.Vec(0, 0, 0))
        default = sim.getProjectionMatrix()
        sim.setViewport(pkg.Vec(10, -3, 2), pkg.Vec(0, 1, 2),
                        pkg.Vec(0.1, 0, 1))
        before = sim.getProjectionMatrix()
        sim.moveViewport(pkg.Vec(1, 0.5, -0.25))
        got[pkg] = (default, before, sim.getProjectionMatrix(),
                    [c.copy() for c in sim._camera])
    for a, b in zip(got[titan_tpu_torch][:3], got[titan_tpu][:3]):
        assert a.shape == (4, 4)
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    for a, b in zip(got[titan_tpu_torch][3], got[titan_tpu][3]):
        np.testing.assert_array_equal(a, b)
    # the target projects to the screen centre, in front of the camera
    sim = new_sim(titan_tpu_torch)
    sim.setViewport(titan_tpu_torch.Vec(10, 0, 2),
                    titan_tpu_torch.Vec(0, 0, 2), titan_tpu_torch.Vec(0, 0, 1))
    clip = sim.getProjectionMatrix() @ np.array([0.0, 0.0, 2.0, 1.0])
    ndc = clip[:3] / clip[3]
    assert abs(ndc[0]) < 1e-12 and abs(ndc[1]) < 1e-12 and -1 < ndc[2] < 1


def test_prints_match_jax(capsys):
    out = {}
    for pkg in PKGS:
        sim = new_sim(pkg)
        sim.createCube(pkg.Vec(0, 0.5, 1), 0.5)
        a = sim.createMass(pkg.Vec(1.25, -2, 3))
        b = sim.createMass(pkg.Vec(0.1, 0.2, 0.3))
        sim.createSpring(a, b)
        sim.deleteSpring(sim.springs[3])
        capsys.readouterr()
        sim.printPositions()
        sim.printSprings()
        out[pkg] = capsys.readouterr().out
    assert out[titan_tpu_torch] == out[titan_tpu]
    assert len(out[titan_tpu].splitlines()) == 10 + 29


def test_prints_raise_after_stop():
    sim = new_sim(titan_tpu_torch)
    sim.createMass(titan_tpu_torch.Vec(0, 0, 1))
    sim.start()
    sim.stop()
    for fn in (sim.printPositions, sim.printSprings):
        with pytest.raises(RuntimeError):
            fn()


def test_reset_then_run():
    """test_control.py::test_reset through the port: a started, paused
    simulation resets to a fresh one, which builds and runs again."""
    V = titan_tpu_torch.Vec
    sim = new_sim(titan_tpu_torch)
    sim.createCube(V(0, 0, 2), 1.0)
    sim.start()
    sim.pause(0.01)
    worker = sim._worker
    sim.reset()
    assert not worker.is_alive()
    assert len(sim.masses) == 0 and sim.time() == 0.0
    assert sim._state is None
    assert not sim.running()
    m = sim.createMass(V(0, 0, 1))
    sim.start()
    sim.pause(0.01)
    sim.getAll()
    assert sim.time() == pytest.approx(0.01, abs=1e-12)
    assert m.pos[2] < 1.0
    sim.stop()


def test_fps_without_a_recorder():
    sim = new_sim(titan_tpu_torch)
    assert sim.fps() == -1.0


# ------------------------------------------------ test_compaction.py's cases
def churn(pkg):
    """test_churn_keeps_n_bounded's create/delete loop; the store size."""
    sim = new_sim(pkg, velocity_clamp=False)
    anchor = sim.createMass(pkg.Vec(0, 0, 0))
    anchor.fix()
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -1.0))
    sim.setTimeStep(0.0001)
    sim.start()
    t = 0.0
    for _ in range(6):
        t += 0.005
        sim.pause(t)
        ms = [sim.createMass(pkg.Vec(0.1 * j, 0, 1)) for j in range(40)]
        sim.resume()
        t += 0.005
        sim.pause(t)
        for m in ms:
            sim.deleteMass(m)
        sim.resume()
    sim.pause(t + 0.005)
    n = sim._store.n_masses
    sim.stop()
    return n


def test_churn_keeps_n_bounded_as_jax():
    n = churn(titan_tpu_torch)
    assert n == churn(titan_tpu)
    assert n <= 1 + 80


def remap_scene(pkg):
    """test_handles_survive_compaction, test_springs_and_containers_remap,
    test_deleting_mass_drops_its_springs_on_compact and
    test_local_constraints_remap in one store: what each handle, container
    and record reads after compact()."""
    V = pkg.Vec
    sim = new_sim(pkg, velocity_clamp=False)
    cube = sim.createCube(V(0, 0, 2), 1.0)
    keep = sim.createMass(V(1, 2, 3))
    doomed = [sim.createMass(V(10 + j, 0, 0)) for j in range(20)]
    m1 = sim.createMass(V(20, 0, 0))
    m2 = sim.createMass(V(21, 0, 0))
    c = sim.createMass(V(22, 0, 0))
    s12 = sim.createSpring(m1, m2)
    s2c = sim.createSpring(m2, c)
    m1.addConstraint(pkg.CONTACT_PLANE, V(0, 0, 1), 0.0)
    for m in doomed + [c]:
        sim.deleteMass(m)
    sim.compact()
    st = sim._store
    n, s = st.n_masses, st.n_springs
    with pytest.raises(RuntimeError, match="compacted away"):
        doomed[3].pos
    with pytest.raises(RuntimeError, match="compacted away"):
        s2c._k
    return dict(
        n=n, s=s, keep=(keep.index, list(keep.pos)),
        m=(m1.index, m2.index, s12._left.index, s12._right.index,
           s12._rest, s12.index),
        cube=(cube._mass_idx.tolist(), cube._spring_idx.tolist()),
        local=sorted(st.local.keys()), gen=sim._gen,
        store={f: getattr(st, f)[:k].copy() for f, k in (
            ("pos", n), ("valid", n), ("hole", n), ("left", s),
            ("right", s), ("rest", s), ("k", s), ("s_valid", s))})


def test_handles_and_containers_remap_as_jax():
    got, want = remap_scene(titan_tpu_torch), remap_scene(titan_tpu)
    for key in ("n", "s", "keep", "m", "cube", "local", "gen"):
        assert got[key] == want[key], key
    for f, arr in got["store"].items():
        np.testing.assert_array_equal(arr, want["store"][f], err_msg=f)
    assert got["n"] == 8 + 3 and got["s"] == 28 + 1
    assert got["local"] == [got["m"][0]]


def midrun_compaction(pkg, threshold):
    """test_trajectory_identical_after_midrun_compaction's scene in f64;
    (positions of the lattice, store size) after the run."""
    V = pkg.Vec
    sim = new_sim(pkg, velocity_clamp=False, compact_threshold=threshold,
                  dtype="float64")
    sim.createLattice(V(0, 0, 2), V(1, 1, 1), 3, 3, 3)
    sim.createPlane(V(0, 0, 1), 0)
    dead = [sim.createMass(V(50 + j, 0, 0)) for j in range(30)]
    sim.setGlobalAcceleration(V(0, 0, -9.8))
    sim.setTimeStep(0.0001)
    sim.start()
    sim.pause(0.02)
    for m in dead:
        sim.deleteMass(m)
    sim.resume()         # compacts at the re-marshal iff threshold allows
    sim.pause(0.06)
    sim.getAll()
    out = sim._store.pos[:27].copy(), sim._store.vel[:27].copy()
    n = sim._store.n_masses
    sim.stop()
    return out, n


def test_midrun_compaction_matches_jax(x64):
    for threshold, n_want in ((0.25, 27), (0.0, 57)):
        (pos, vel), n = midrun_compaction(titan_tpu_torch, threshold)
        (jpos, jvel), jn = midrun_compaction(titan_tpu, threshold)
        assert n == jn == n_want
        np.testing.assert_allclose(pos, jpos, atol=2e-5, rtol=0)
        np.testing.assert_allclose(vel, jvel, atol=2e-5, rtol=0)
        if threshold:
            compacted = pos
        else:
            np.testing.assert_allclose(pos, compacted, atol=1e-12, rtol=0)
