"""The port's public control plane against titan_tpu's.

The README demo flow (start -> wait -> getAll -> resume -> stop), a
structural edit at a pause, magnets set at start and switched on at a
pause, and the port's refusal of a CUDA config on a machine without CUDA.

Tolerances.  f32: positions 1e-5.  f32 velocities are held to 5e-3: this
scene's springs (k = 1e4, rest 1.25, m = 0.1) turn one f32 ulp of a spring
length (1.2e-7) into 1.2e-6 of velocity per step, and XLA:CPU and PyTorch
round those forces differently, so two correct f32 runs drift apart by
~1e-3 in velocity over a few hundred steps.  The same flows in f64 pin
positions and velocities to 1e-9.
"""

import torch_threads  # noqa: F401  (before torch)

import jax
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch

TOL = {"float32": dict(pos=1e-5, vel=5e-3), "float64": dict(pos=1e-9,
                                                           vel=1e-9)}


@pytest.fixture(params=["float32", "float64"])
def dtype(request):
    if request.param == "float64":
        jax.config.update("jax_enable_x64", True)
    yield request.param
    jax.config.update("jax_enable_x64", False)


def demo_scene(pkg, dtype="float32"):
    """README.md's quick-start scene (5x5x5 lattice over a plane)."""
    cfg = pkg.SimConfig(dtype=dtype, device="cpu") \
        if pkg is titan_tpu_torch else pkg.SimConfig(dtype=dtype)
    sim = pkg.Simulation(cfg)
    sim.createLattice(pkg.Vec(0, 0, 10), pkg.Vec(5, 5, 5), 5, 5, 5)
    sim.createPlane(pkg.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    return sim


def positions(sim):
    n = sim._store.n_masses
    return sim._store.pos[:n].copy(), sim._store.vel[:n].copy()


def test_readme_demo_flow_matches_jax(dtype):
    got, want = [], []
    for pkg, out in ((titan_tpu_torch, got), (titan_tpu, want)):
        sim = demo_scene(pkg, dtype)
        sim.start()
        for _ in range(3):
            sim.wait(0.01)
            sim.getAll()
            out.append((sim.time(), *positions(sim),
                        sim.masses[7].pos.numpy()))
            sim.resume()
        sim.wait(0.005)
        sim.stop()
        out.append(sim.time())
    tol = TOL[dtype]
    for g, w in zip(got[:-1], want[:-1]):
        assert g[0] == pytest.approx(w[0], abs=1e-12)
        for a, b, t in zip(g[1:], w[1:], (tol["pos"], tol["vel"], tol["pos"])):
            np.testing.assert_allclose(a, b, atol=t, rtol=t)
    assert got[-1] == pytest.approx(want[-1], abs=1e-12)
    assert got[-2][1][:, 2].min() < 7.5 - 1e-4, "the lattice did not fall"


def test_structural_edit_at_pause_remarshals(dtype):
    """Delete a mass, add a free mass and move one by hand at a pause: the
    port re-marshals in full at resume (the JAX package applies the same
    edits incrementally); both must agree afterwards."""
    got, want = [], []
    for pkg, out in ((titan_tpu_torch, got), (titan_tpu, want)):
        sim = demo_scene(pkg, dtype)
        sim.start()
        sim.wait(0.005)
        n_before = sim._shape.n_masses
        sim.deleteMass(sim.masses[3])
        sim.createMass(pkg.Vec(3.0, 0.0, 4.0))
        sim.masses[0].pos = pkg.Vec(0.1, -0.1, 7.0)
        sim.resume()
        sim.wait(0.005)
        sim.getAll()
        out.append((sim.time(), *positions(sim),
                    bool(sim._shape.all_valid), n_before))
        sim.stop()
    (tg, pg, vg, valid_g, _), (tw, pw, vw, valid_w, _) = got[0], want[0]
    assert tg == pytest.approx(tw, abs=1e-12)
    assert not valid_g and not valid_w
    tol = TOL[dtype]
    np.testing.assert_allclose(pg, pw, atol=tol["pos"], rtol=tol["pos"])
    np.testing.assert_allclose(vg, vw, atol=tol["vel"], rtol=tol["vel"])
    assert pg.shape[0] == 126
    assert abs(pg[0, 2] - 7.0) < 0.01   # the hand-set pos was kept


def test_magnets_run_at_start_and_after_push():
    """The demo scene with a magnet set before start, and with one switched
    on at a pause (pushed with set(), which flips the shape's magnet flag),
    runs through the port as through titan_tpu."""
    got, want = [], []
    for pkg, out in ((titan_tpu_torch, got), (titan_tpu, want)):
        sim = demo_scene(pkg)
        sim.masses[0].max_mag_force = 1.0
        sim.masses[1].rad = 0.05
        sim.start()
        assert sim._shape.has_magnets
        sim.wait(0.005)
        sim.getAll()
        out.append(positions(sim))
        sim.stop()

        sim = demo_scene(pkg)
        sim.start()
        sim.wait(0.002)
        assert not sim._shape.has_magnets
        sim.masses[0].rad = 0.05
        sim.masses[0].mag_scale_factor = 1.0
        sim.masses[1].max_mag_force = 1.0
        sim.set(sim.masses[0])
        sim.set(sim.masses[1])
        assert sim._shape.has_magnets
        sim.resume()
        sim.wait(0.003)
        sim.getAll()
        out.append(positions(sim))
        sim.stop()
    tol = TOL["float32"]
    for (pg, vg), (pw, vw) in zip(got, want):
        np.testing.assert_allclose(pg, pw, atol=tol["pos"], rtol=tol["pos"])
        np.testing.assert_allclose(vg, vw, atol=tol["vel"], rtol=tol["vel"])


def test_default_config_needs_cuda():
    """SimConfig() asks for the card; without one the port raises rather
    than run on the CPU."""
    if torch.cuda.is_available():
        sim = titan_tpu_torch.Simulation(titan_tpu_torch.SimConfig())
        assert sim._device.type == "cuda"
        return
    assert titan_tpu_torch.SimConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        titan_tpu_torch.Simulation(titan_tpu_torch.SimConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        titan_tpu_torch.Simulation()
