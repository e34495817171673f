"""``Simulation.distribute`` and the batched mesh in the port
(``titan_tpu_torch/runtime/simulation.py``, ``parallel/sharded.py``,
``parallel/batched.py``), held against ``titan_tpu`` and the single
device.

- The control plane over 4 CPU shards against ``titan_tpu``'s
  ``distribute`` on a 4-device CPU mesh, the same scene built in each
  package (``tests/test_halo.py``'s damped long lattice, f64, x64 on):
  start, pause, ``getAll``; an external force ``set`` at the pause and a
  resume to a breakpoint; a topology edit at a pause (a cross-link
  spring, a remainder spring); a feature flip (a spring turned
  actuated) and a uniform-breaking push (one spring's k).  The
  host stores agree within 1e-9 at every pause (the halo route, both
  packages).
- The per-shard tiled route through ``Simulation`` on the CPU (a binned
  magnet lattice past ``magnet_pallas_max``, which one device steps on the
  tiled step): bitwise the single-device ``Simulation``.
- The sharded catch-all (strict per-step external force), with its
  warning: bitwise the single-device ``Simulation``.
- ``BatchedScenes.from_simulation(mesh=)``: the env axis over 4 shards,
  bitwise the unsharded batch; an env count the shards do not divide is
  refused.
"""

import torch_threads  # noqa: F401  (before torch)

import logging

import jax
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu.parallel import make_mesh as jax_make_mesh
from titan_tpu_torch.parallel import BatchedScenes, shard_batched_state

from test_torch_halo import cpu_mesh, dist_scene

TOL_F64 = 1e-9


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _stores_close(a, b, n=None):
    n = n or a._store.n_masses
    assert b._store.n_masses == n
    for f in ("pos", "vel", "acc"):
        np.testing.assert_allclose(getattr(a._store, f)[:n],
                                   getattr(b._store, f)[:n], atol=TOL_F64,
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(a._store.rest[:a._store.n_springs],
                               b._store.rest[:b._store.n_springs],
                               atol=TOL_F64)


def test_distribute_control_plane_matches_jax(x64):
    jsim = dist_scene(titan_tpu, "float64", damping=0.3, marshal=False)
    tsim = dist_scene(titan_tpu_torch, "float64", damping=0.3, marshal=False)
    jsim.distribute(jax_make_mesh(("shard",), devices=jax.devices()[:4]))
    tsim.distribute(cpu_mesh())
    sims = (jsim, tsim)

    def run_to(t):
        for s in sims:
            s.setBreakpoint(t)
            s.resume()
            s.waitForEvent()
            s.getAll()
        assert abs(tsim.time() - t) < 1e-12
        _stores_close(tsim, jsim)

    for s in sims:
        s.start()
        s.pause(0.003)
        s.getAll()
    assert tsim._chunk.route == "halo"
    _stores_close(tsim, jsim)
    for pkg, s in zip((titan_tpu, titan_tpu_torch), sims):   # a push
        s.masses[0].setExternalForce(pkg.Vec(0.3, 0, 0))
        s.set(s.masses[0])
    run_to(0.005)
    for s in sims:               # a topology edit at the pause
        sp = s.createSpring(s.masses[3], s.masses[40])
        sp._k = 700.0
        sp.defaultLength()
    run_to(0.007)
    assert tsim._shape.has_remainder and tsim._chunk.route == "halo"
    for pkg, s in zip((titan_tpu, titan_tpu_torch), sims):
        s.springs[5]._k = 900.0                  # a uniform break
        s.set(s.springs[5])
        sp = s.springs[9]                        # a feature flip
        sp._type = pkg.ACTUATED_EXPAND
        sp._l_max = sp._rest * 1.1
        sp._rate = 0.2
        s.set(sp)
    run_to(0.009)
    assert not tsim._shape.stencil_uniform[0] and tsim._shape.has_actuated
    assert tsim._chunk.route == "halo"
    for s in sims:
        s.stop()


def test_distribute_tiled_route_through_simulation():
    def build(mesh):
        sim = dist_scene(titan_tpu_torch, magnets=True, magnet_binned=True,
                         magnet_pallas_max=64, marshal=False)
        if mesh is not None:
            sim.distribute(mesh)
        sim.start()
        sim.pause(0.002)
        sim.getAll()
        return sim
    dist, one = build(cpu_mesh()), build(None)
    assert dist._chunk.route == "halo_tiled"
    for f in ("pos", "vel", "acc"):
        assert np.array_equal(getattr(dist._store, f),
                              getattr(one._store, f)), f
    for s in (dist, one):
        s.stop()


def test_sharded_catch_all_matches_single_device(caplog):
    def build(mesh):
        sim = titan_tpu_torch.Simulation(titan_tpu_torch.SimConfig(
            device="cpu", velocity_clamp=False,
            persistent_extern_force=False))
        sim.createLattice(titan_tpu_torch.Vec(0, 0, 3),
                          titan_tpu_torch.Vec(8, 1, 1), 32, 4, 4)
        sim.masses[7].setExternalForce(titan_tpu_torch.Vec(0, 0, 50.0))
        if mesh is not None:
            sim.distribute(mesh)
        sim.setTimeStep(1e-4)
        sim.start()
        sim.pause(0.002)
        sim.getAll()
        return sim
    with caplog.at_level(logging.WARNING, logger="titan_tpu_torch"):
        dist = build(cpu_mesh())
    assert dist._chunk.route == "sharded"
    assert any("halo-exchange envelope" in r.message for r in caplog.records)
    one = build(None)
    for f in ("pos", "vel", "acc", "extern_force"):
        assert np.array_equal(getattr(dist._store, f),
                              getattr(one._store, f)), f
    for s in (dist, one):
        s.stop()


def test_batched_scenes_on_a_mesh_match_the_unsharded_batch():
    def template():
        src = titan_tpu_torch.Simulation(titan_tpu_torch.SimConfig(
            device="cpu"))
        src.createLattice(titan_tpu_torch.Vec(0, 0, 0.6),
                          titan_tpu_torch.Vec(1, 1, 1), 3, 3, 3)
        src.createPlane(titan_tpu_torch.Vec(0, 0, 1), 0, 0.4, 0.6)
        src.setTimeStep(1e-4)
        return src
    mesh = cpu_mesh()
    envs = BatchedScenes.from_simulation(template(), 8, mesh=mesh)
    flat = BatchedScenes.from_simulation(template(), 8)
    for b in (envs, flat):
        b.state.masses.vel[:, 2] = torch.linspace(-1.0, 1.0, 8)[:, None]
        b.run(20)
    assert torch.equal(envs.positions(), flat.positions())
    assert torch.equal(envs.velocities(), flat.velocities())
    blocks = shard_batched_state(envs.state, mesh, "shard")
    assert len(blocks) == 4 and blocks[1].masses.pos.shape[0] == 2
    with pytest.raises(ValueError, match="do not split"):
        BatchedScenes.from_simulation(template(), 6, mesh=mesh)
