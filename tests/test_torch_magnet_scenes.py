"""Magnet scenes through the port against the same scenes in titan_tpu.

- ``fused_chunk_plain`` (the plain version of the fused step with its
  magnet route) against ``titan_tpu.ops.step.build_chunk_fn`` on the CPU
  (the XLA step), on a 16-link RobotLink scene: the pairwise route under
  each integrator, and the binned route (the grid route forced small with
  ``magnet_binned_threshold=1, magnet_grid_threshold=1``, which takes the
  binned pass on the CPU in both packages); and a spring-less swarm.  f32,
  100 steps: positions to 1e-6, velocities to 2e-4.  The two sum the step's
  forces in another order (the fused step starts from const_f + field, the
  XLA step from the springs) and f32 rounding differs between XLA:CPU and
  PyTorch; the friction plane and the 1/r^2 pull amplify that to 3.3e-7 in
  position and 6.0e-5 in velocity for Verlet (max |v| 2.4 m/s).
- The three flows of tests/test_robotlink.py through the port's
  ``Simulation(device="cpu")`` and through titan_tpu, each held to that
  file's assertions and the two packages to each other: expand/contract
  with the time step raised from 0.1 ms to 3 ms (2,000 steps), the magnet
  pull at its 0.1 ms (500 steps), and detach.
- ``diff.grad_rollout`` on a 4-link scene in f64 routes to ``fast_rollout``
  (the adjoint's reason names the dtype) and equals ``jax.grad`` through
  ``titan_tpu.diff.rollout`` to 1e-9; the same scene in f32 routes to the
  fused adjoint, and the spring-less swarm to ``fast_rollout``.

Small tensors: torch runs these on one thread.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu import diff as jdiff
from titan_tpu.ops.step import build_chunk_fn as jax_chunk_fn
from titan_tpu.state import xla_only_shape
from titan_tpu_torch import diff as tdiff
from titan_tpu_torch.ops import fused_step
from titan_tpu_torch.ops.adjoint import adjoint_reject_reason

from test_torch_step import carry_over


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def link_scene(pkg, n_links=16, integrator="EULER", binned=False,
               dtype="float32", magnetic_force=0.02, dt=1e-4):
    """``n_links`` RobotLinks over a friction plane, built as
    scripts/tpu_robotlink_ab.py builds its scene (odd links expand, even
    ones contract), packed closer so that links interact, with a weaker
    pull so that Verlet and RK2 (no velocity clamp) stay bounded."""
    cfg = dict(integrator=getattr(pkg.Integrator, integrator), dtype=dtype)
    if binned:
        cfg.update(magnet_binned_threshold=1, magnet_grid_threshold=1)
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    rng = np.random.RandomState(0)
    links = []
    for _ in range(n_links):
        p = rng.uniform(-0.15, 0.15, 3) + [0, 0, 0.2]
        links.append(sim.createRobotLink(
            pkg.Vec(*p), pkg.Vec(*(p + [0.06, 0, 0])), 0.1, 0.08, 0.04,
            0.02, 5000.0, magnetic_force))
    for i, link in enumerate(links):
        (link.expand if i % 2 else link.contract)()
    sim.createPlane(pkg.Vec(0, 0, 1), 0, 0.4, 0.6)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    sim.setTimeStep(dt)
    sim._T = 0.0
    sim._marshal()
    return sim


def swarm_scene(n=300):
    """examples/magnetic_swarm.py at 300 particles, binned (the grid route
    forced small): no springs, drag, a plane."""
    rng = np.random.RandomState(0)
    sim = titan_tpu.Simulation(titan_tpu.SimConfig(
        magnet_binned_threshold=1, magnet_grid_threshold=1))
    spread = 0.5 * 0.14 * (n / 4.0) ** 0.5
    st = sim._store
    st.reserve_masses(n)
    st.pos[:n] = rng.uniform(-spread, spread, (n, 3))
    st.pos[:, 2] += spread + 0.05
    st.valid[:n] = True
    st.n_masses = n
    st.m[:n] = 0.1
    st.mag_rad[:n] = rng.uniform(0.01, 0.04, n)
    st.mag_stiffness[:n] = rng.uniform(50, 200, n)
    st.mag_maxf[:n] = 1e-4
    st.mag_scale[:n] = 1.0
    st.drag[:n] = 0.5
    sim.createPlane(titan_tpu.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(titan_tpu.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim


@pytest.mark.parametrize("route,integrator", [
    ("pairwise", "EULER"), ("pairwise", "VERLET"), ("pairwise", "RK2"),
    ("binned", "EULER"), ("swarm", "EULER")])
def test_fused_plain_matches_jax_chunk(route, integrator):
    if route == "swarm":
        jsim = swarm_scene()
        assert not jsim._shape.stencil_deltas
    else:
        jsim = link_scene(titan_tpu, integrator=integrator,
                          binned=route == "binned")
    assert bool(jsim._shape.magnet_binned) == (route != "pairwise")
    shape, state = carry_over(jsim)
    assert fused_step.fused_reject_reason(shape) is None
    steps = 100
    out = fused_step.fused_chunk(shape, state, steps)     # CPU: plain route
    want = jax_chunk_fn(jsim._shape)(jsim._state, jnp.int32(steps))
    n = jsim._store.n_masses
    for f, tol in (("pos", 1e-6), ("vel", 2e-4)):
        np.testing.assert_allclose(
            getattr(out.masses, f).numpy()[:, :n],
            np.asarray(getattr(want.masses, f))[:, :n], atol=tol, rtol=0,
            err_msg=f)
    np.testing.assert_allclose(out.stencil.rest.numpy(),
                               np.asarray(want.stencil.rest), atol=1e-6)
    moved = np.abs(out.masses.pos.numpy() - state.masses.pos.numpy()).max()
    assert moved > 1e-4, "the scene did not move"


def _link_flow_sim(pkg):
    """tests/test_robotlink.py::_link_sim, at a 3 ms step."""
    cfg = dict(velocity_clamp=False)
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    sim = pkg.Simulation(pkg.SimConfig(**cfg))
    link = sim.createRobotLink(pkg.Vec(0, 0, 0), pkg.Vec(0.125, 0, 0),
                               mass=0.1, max_exp_length=0.25,
                               min_exp_length=0.125, expansion_rate=0.05,
                               k=1000.0, magnetic_force=0.0)
    sim.setGlobalAcceleration(pkg.Vec(0, 0, 0))
    sim.setTimeStep(0.003)
    return sim, link


def _pair(link):
    return (np.array(list(link.ml.pos)), np.array(list(link.mr.pos)))


def test_robotlink_expand_contract_matches_jax():
    got = {}
    for pkg in (titan_tpu_torch, titan_tpu):
        sim, link = _link_flow_sim(pkg)
        assert link.expand() is True
        assert link.s._type == pkg.ACTUATED_EXPAND
        sim.start()
        out = []
        sim.pause(1.0)
        sim.getAll()
        assert link.s._rest == pytest.approx(0.175, abs=5e-3)
        out.append((link.s._rest, *_pair(link)))
        sim.resume()
        sim.pause(3.0)     # by t = 2.5 rest reaches l_max = 0.25
        sim.getAll()
        assert link.s._rest == pytest.approx(0.25, abs=5e-3)
        ml, mr = _pair(link)
        assert np.linalg.norm(mr - ml) == pytest.approx(0.25, abs=2e-2)
        out.append((link.s._rest, ml, mr))
        link.contract()
        sim.set(link.s)
        sim.resume()
        sim.pause(6.0)
        sim.getAll()
        assert link.s._rest == pytest.approx(0.125, abs=5e-3)
        assert link.contract() is False
        assert link.s._type == pkg.PASSIVE_SOFT
        out.append((link.s._rest, *_pair(link)))
        assert sim.time() == pytest.approx(6.0, abs=3e-3)
        sim.stop()
        got[pkg.__name__] = out
    for a, b in zip(got["titan_tpu_torch"], got["titan_tpu"]):
        assert a[0] == pytest.approx(b[0], abs=1e-6)
        np.testing.assert_allclose(a[1], b[1], atol=1e-5)
        np.testing.assert_allclose(a[2], b[2], atol=1e-5)


def test_robotlink_magnet_attraction_matches_jax():
    """The pull is 1/r^2 without a velocity clamp: the masses cross within
    5 ms and the flow turns chaotic after ~20 ms (the packages then part by
    metres), so the two are held together at 5 and 10 ms (to 1e-5; they
    differ by 1.8e-7) and each to the reference test's assertion at 50 ms."""
    early = []
    for pkg in (titan_tpu_torch, titan_tpu):
        cfg = dict(velocity_clamp=False)
        if pkg is titan_tpu_torch:
            cfg["device"] = "cpu"
        sim = pkg.Simulation(pkg.SimConfig(**cfg))
        l1 = sim.createRobotLink(pkg.Vec(0, 0, 0), pkg.Vec(0.05, 0, 0), 0.1,
                                 0.2, 0.05, 0.01, 1000.0, magnetic_force=0.5)
        l2 = sim.createRobotLink(pkg.Vec(0.13, 0, 0), pkg.Vec(0.18, 0, 0),
                                 0.1, 0.2, 0.05, 0.01, 1000.0,
                                 magnetic_force=0.5)
        sim.setGlobalAcceleration(pkg.Vec(0, 0, 0))
        sim.setTimeStep(0.0001)
        sim.start()
        assert sim._shape.has_magnets
        pos = []
        for t in (0.005, 0.01):
            sim.pause(t)
            sim.getAll()
            pos.append(sim._store.pos[:4].copy())
            sim.resume()
        early.append(pos)
        sim.pause(0.05)
        sim.getAll()
        # the facing tips (0.05 and 0.13, 0.08 apart, inside the 0.14 m
        # cutoff) pull together
        gap = l2.ml.pos[0] - l1.mr.pos[0]
        assert gap < 0.08
        sim.stop()
    for a, b in zip(*early):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_robotlink_detach_matches_jax():
    for pkg in (titan_tpu_torch, titan_tpu):
        sim, link = _link_flow_sim(pkg)
        link.max_mag_force = 0.5
        link.attach()
        assert link.ml.isMagnetic()
        assert link.detach() is True       # rest == min: contracted
        assert not link.ml.isMagnetic()
        assert not link.mr.isMagnetic()


def test_grad_rollout_on_magnets_routes_to_fast_rollout(x64, caplog):
    jsim = link_scene(titan_tpu, n_links=4, dtype="float64",
                      magnetic_force=1.0)
    n = jsim._store.n_masses
    jshape, jstate = jsim._shape, jsim._state
    steps = 6

    def jloss(pos, vel):
        st = dataclasses.replace(jstate, masses=dataclasses.replace(
            jstate.masses, pos=pos, vel=vel))
        out = jdiff.rollout(xla_only_shape(jshape), st, steps)
        return jnp.sum(out.masses.pos[:, :n] * out.masses.vel[:, :n])

    want = jax.grad(jloss, argnums=(0, 1))(jstate.masses.pos,
                                            jstate.masses.vel)
    shape, state = carry_over(jsim)
    # f64: outside both adjoints (the fused step is f32-only); in f32 the
    # RobotLink scene takes the fused adjoint, as on a TPU, and the
    # spring-less swarm, which neither adjoint takes, fast_rollout
    assert "float64" in adjoint_reject_reason(shape)
    f32_shape, _ = carry_over(link_scene(titan_tpu, n_links=4,
                                         magnetic_force=1.0))
    assert tdiff.grad_route(f32_shape) == ("adjoint", None)
    swarm, _ = carry_over(swarm_scene())
    route, reason = tdiff.grad_route(swarm)
    assert route == "fast" and "no stencil spring families" in reason
    pos, vel = (t.clone().requires_grad_()
                for t in (state.masses.pos, state.masses.vel))
    state = dataclasses.replace(state, masses=dataclasses.replace(
        state.masses, pos=pos, vel=vel))
    with caplog.at_level(logging.WARNING):
        out = tdiff.grad_rollout(shape, state, steps)
    assert any("fast_rollout" in r.getMessage()
               and "float64" in r.getMessage() for r in caplog.records)
    loss = torch.sum(out.masses.pos[:, :n] * out.masses.vel[:, :n])
    got = torch.autograd.grad(loss, [pos, vel])
    for name, a, b in zip(("pos", "vel"), got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9,
                                   rtol=1e-9, err_msg=name)
    assert float(torch.abs(got[0]).max()) > 0
