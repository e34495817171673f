"""Per-mass local constraints in the port against titan_tpu.

- The eager step against the JAX XLA step in f64 at 1e-9 (as
  test_torch_step.py), 20 steps of a 4^3 lattice, for each slot type alone
  (contact planes both frictionless, the record ``Mass.addConstraint``
  writes, and with friction, the record form of the per-env plane sweep)
  and all four together, under Euler, Verlet and RK2.
- ``fused_chunk_plain`` against the JAX fused Pallas chunk in interpret
  mode on the local variants of tests/test_pallas_step.py, and
  ``tiled_chunk_plain`` against the JAX tiled Pallas chunk in interpret mode
  on tests/test_pallas_tiled.py's local scene with all four slot types, at
  the tolerances tests/test_torch_fused_step.py and tests/test_torch_tiled.py
  use (pos and vel 1e-5; 5e-6 / 1e-5).  20 steps, the tiled one as a
  resident-grid segment and a tail: over 50, the local ball's stiff penalty
  carries the two f32 roundings of the spring sum to 1.7e-5 of velocity on
  one mass.  The scenes with constraint planes or directions start
  sliding, at (0.3, 0.1, 0) as the friction variants do.  From rest, a constraint plane's friction
  divides a tangential velocity of rounding size by the norm it had before
  the plane removed the normal part, so the direction it pushes in is f32
  rounding noise (5.2e-3 of velocity between the two packages after 50
  steps, 1.9e-6 when sliding); and a direction's friction acts only once
  |v| >= 1e-16, so whether a mass at rest along its tangent is "moving" is
  decided by rounding (3.7e-4 of velocity on one mass after 20 steps).
- ``Simulation`` with ``addConstraint`` before start, and an add and a
  clear at a pause, against titan_tpu.Simulation on the same calls.
The residency rules and routes are in tests/test_torch_local_routes.py.
"""

import torch_threads  # noqa: F401  (before torch)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.ops import pallas_step, pallas_tiled
from titan_tpu_torch.ops import fused_step, tiled_step
from titan_tpu_torch.ops import step as tstep

import test_pallas_step
import test_pallas_tiled
from test_torch_fused_step import interpret  # noqa: F401  (fixture)
from test_torch_simulation import TOL, demo_scene, dtype, positions  # noqa: F401
from test_torch_step import (assert_states_close, build_scene, carry_over,
                             jax_chunk_ref)

SLIDE = (0.3, 0.1, 0.0)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def add_local(sim, pkg, kinds):
    """Local constraints on a 4^3 lattice around (0, 0, 2) (z in [1.5,
    2.5]), placed as tests/test_adjoint.py places them: the contact plane
    at offset 2 acts on the lower masses from step 0, the ball holds a
    corner, constraint planes and directions act once a mass moves."""
    if "cp" in kinds:
        for i in range(6):
            sim.masses[i].addConstraint(pkg.CONTACT_PLANE,
                                        pkg.Vec(0.1, 0.2, 1.0), 2.0)
        # with friction: the record form of the per-env plane sweep
        for i in (16, 17, 20):
            nv = np.array([0.05, 0.1, 1.0])
            sim._store.local_record(i).contact_planes.append(
                (nv / np.linalg.norm(nv), 2.0, 0.3, 0.5))
    if "ball" in kinds:
        for i in range(6, 10):
            sim.masses[i].addConstraint(pkg.BALL, pkg.Vec(0.2, 0.2, 1.7),
                                        0.9)
    if "pl" in kinds:
        for i in range(10, 14):
            sim.masses[i].addConstraint(pkg.CONSTRAINT_PLANE,
                                        pkg.Vec(0.2, 0.1, 1.0), 0.3)
    if "dir" in kinds:
        for i in range(14, 18):
            sim.masses[i].addConstraint(pkg.DIRECTION,
                                        pkg.Vec(1.0, 0.2, 0.5), 0.2)


SLOTS = {"cp": ("cp",), "ball": ("ball",), "pl": ("pl",), "dir": ("dir",),
         "all": ("cp", "ball", "pl", "dir")}


@pytest.mark.parametrize("integrator", ["plain", "verlet", "rk2"])
@pytest.mark.parametrize("slots", sorted(SLOTS))
def test_eager_step_local_matches_jax_f64(slots, integrator, x64):
    jsim = build_scene(titan_tpu, integrator, "float64", marshal=False)
    add_local(jsim, titan_tpu, SLOTS[slots])
    jsim._T = 0.0
    jsim._marshal()
    assert any((jsim._shape.cap_cp, jsim._shape.cap_ball,
                jsim._shape.cap_pl, jsim._shape.cap_dir))
    shape, state = carry_over(jsim)
    out = tstep.run_eager(tstep.build_step_fn(shape), state, 20)
    want = jax_chunk_ref(jsim._shape, jsim._state, 20)
    assert_states_close(out, want, jsim._store.n_masses, atol=1e-9)


# the local variants of tests/test_pallas_step.py (its _scene's ``local``)
FUSED_LOCAL = {"local_cp": "cp", "local_cp_tilted": "cp_friction",
               "local_ball": "ball", "local_pl": "pl", "local_dir": "dir"}


def _slide(sim):
    st = sim._store
    st.vel[: st.n_masses] = SLIDE
    sim._marshal()


@pytest.mark.parametrize("variant", sorted(FUSED_LOCAL))
def test_fused_plain_local_matches_pallas_kernel(variant, interpret):  # noqa: F811
    jsim = test_pallas_step._scene(local=FUSED_LOCAL[variant])
    if variant in ("local_pl", "local_dir"):
        _slide(jsim)
    assert pallas_step.pallas_supported(jsim._shape)
    shape, state = carry_over(jsim)
    assert fused_step.fused_reject_reason(shape) is None
    steps = 20
    out = fused_step.fused_chunk(shape, state, steps)   # CPU: plain version
    want = pallas_step.build_pallas_chunk(jsim._shape)(jsim._state,
                                                       jnp.int32(steps))
    n = jsim._store.n_masses
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out.masses, f).numpy()[:, :n],
                                   np.asarray(getattr(want.masses, f))[:, :n],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    assert float(out.t) == pytest.approx(float(want.t), abs=1e-7)


def test_tiled_plain_local_matches_pallas_tiled(monkeypatch):
    """One resident-grid segment and a 4-step tail of the JAX tiled kernel
    in interpret mode, on tests/test_pallas_tiled.py's local scene with
    its four variants' slots together: its contact planes on masses 2, 99
    and 380 and a ball, a constraint plane and a direction on the next
    masses (one interpret-mode build of ~10 s here, where a case per
    variant took four)."""
    from conftest import force_tiled_interpret
    from titan_tpu import BALL, CONSTRAINT_PLANE, DIRECTION, Vec
    jsim = test_pallas_tiled._scene(local="cp")
    for i in (3, 100, 381):
        jsim.masses[i].addConstraint(BALL, Vec(0, 0, 2.5), 0.7)
        jsim.masses[i + 1].addConstraint(CONSTRAINT_PLANE, Vec(0, 0, 1), 0.3)
        jsim.masses[i + 2].addConstraint(DIRECTION, Vec(1, 0, 0), 0.2)
    _slide(jsim)
    shape, state = carry_over(jsim)
    assert (shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir) == (
        1, 1, 1, 1)
    assert tiled_step.mega_seg(shape) and \
        tiled_step.tiled_reject_reason(shape) is None
    force_tiled_interpret(monkeypatch)
    steps = tiled_step.MEGA_SEG + 4
    want = pallas_tiled.build_tiled_chunk(jsim._shape)(jsim._state,
                                                       jnp.int32(steps))
    out = tiled_step.tiled_chunk(shape, state, steps)   # CPU: plain version
    n = jsim._store.n_masses
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(out.masses, f).numpy()[:, :n],
                                   np.asarray(getattr(want.masses, f))[:, :n],
                                   atol=5e-6, rtol=1e-5, err_msg=f)


def _local_demo(pkg, dtype):
    """README's demo scene, sliding, with every slot type on a few masses
    (the lattice spans z in [7.5, 12.5])."""
    sim = demo_scene(pkg, dtype)
    st = sim._store
    st.vel[: st.n_masses] = SLIDE
    for i in range(0, 25, 5):
        sim.masses[i].addConstraint(pkg.CONTACT_PLANE, pkg.Vec(0, 0.1, 1),
                                    8.0)
    st.local_record(1).contact_planes.append(
        (np.array([0.0, 0.0, 1.0]), 8.0, 0.4, 0.6))
    sim.masses[62].addConstraint(pkg.BALL, pkg.Vec(0.2, 0, 10), 1.0)
    sim.masses[63].addConstraint(pkg.CONSTRAINT_PLANE, pkg.Vec(0, 0, 1), 0.3)
    sim.masses[100].addConstraint(pkg.DIRECTION, pkg.Vec(1, 0, 0), 0.2)
    return sim


def _compare(got, want, dtype):
    tol = TOL[dtype]
    for g, w in zip(got, want):
        assert g[0] == pytest.approx(w[0], abs=1e-12)
        np.testing.assert_allclose(g[1], w[1], atol=tol["pos"],
                                   rtol=tol["pos"])
        np.testing.assert_allclose(g[2], w[2], atol=tol["vel"],
                                   rtol=tol["vel"])


def test_simulation_local_constraints_match_jax(dtype):  # noqa: F811
    """Constraints added before start: the port takes its fused route (f32)
    or the eager step (f64), titan_tpu its XLA chunk."""
    got, want = [], []
    for pkg, out in ((titan_tpu_torch, got), (titan_tpu, want)):
        sim = _local_demo(pkg, dtype)
        sim.start()
        assert (sim._shape.cap_cp, sim._shape.cap_ball, sim._shape.cap_pl,
                sim._shape.cap_dir) == (1, 1, 1, 1)
        if pkg is titan_tpu_torch and dtype == "float32":
            assert tstep.chunk_route(sim._shape)[0] == "fused"
        for _ in range(2):
            sim.wait(0.005)
            sim.getAll()
            out.append((sim.time(), *positions(sim)))
            sim.resume()
        sim.stop()
    _compare(got, want, dtype)
    # the direction slot held mass 100 to motion along x
    assert abs(got[-1][2][100, 1]) < 1e-9 and abs(got[-1][2][100, 2]) < 1e-9


def test_constraint_edits_at_pause_match_jax(dtype):  # noqa: F811
    """An addConstraint at one pause and a clearConstraints at the next:
    the port re-marshals at resume, titan_tpu rebuilds its slots; both
    agree after each."""
    got, want = [], []
    for pkg, out in ((titan_tpu_torch, got), (titan_tpu, want)):
        sim = demo_scene(pkg, dtype)
        sim._store.vel[: sim._store.n_masses] = SLIDE
        sim.start()
        sim.wait(0.004)
        assert sim._shape.cap_pl == 0
        sim.masses[63].addConstraint(pkg.CONSTRAINT_PLANE, pkg.Vec(0, 0, 1),
                                     0.3)
        sim.masses[3].addConstraint(pkg.CONTACT_PLANE, pkg.Vec(0, 0, 1), 8.0)
        sim.resume()
        sim.wait(0.004)
        sim.getAll()
        out.append((sim.time(), *positions(sim)))
        assert (sim._shape.cap_cp, sim._shape.cap_pl) == (1, 1)
        sim.masses[63].clearConstraints()
        sim.masses[3].clearConstraints(pkg.CONTACT_PLANE)
        sim.resume()
        sim.wait(0.004)
        sim.getAll()
        out.append((sim.time(), *positions(sim)))
        sim.stop()
    _compare(got, want, dtype)
