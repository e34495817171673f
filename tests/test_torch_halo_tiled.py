"""The port's per-shard tiled route (``titan_tpu_torch/parallel/
halo_tiled.py``) against the port's single-device tiled chunk and against
``titan_tpu``.

- Over 4 CPU shards (each shard's window stepped by the plain version of
  the tiled kernels, ``halo_tiled.pass_plain``), 20 steps: bitwise the
  port's single-device ``tiled_chunk_plain`` on every scene without glue
  (Euler with and without the clamp, Verlet, RK2, damping, actuation,
  breathing, drag, deleted masses, a local constraint, a shard count that
  does not divide the mass count, so that the mass axis is padded); on
  glue scenes (remainder springs, binned magnets, both under RK2) within
  ``tests/test_torch_tiled.py``'s tolerances: pos 5e-6 / rtol 1e-5 and
  vel 5e-6 / 1e-5, and where remainder springs actuate pos 3e-5 / 1e-4,
  vel 5e-3 / 1e-3 (here the glue advances their rest step by step, the
  single-device kernel in closed form).  A magnet-only glue scene is
  bitwise: both take the same field at the same positions.
- Against ``titan_tpu``'s single-device XLA chunk (``test_torch_step.py::
  jax_chunk_ref``) over 30 steps at ``test_torch_tiled.py``'s tolerances.
- The distributed resident grid forced on (``TITAN_DIST_MEGA=1``, 2
  shards, 40 steps: two 16-step segments and a per-step tail) bitwise its
  per-step form under Euler, Verlet and RK2, and the gate's plan.
- ``halo_tiled_reject_reason`` equal to the JAX package's on the route's
  own conditions (exact-pairwise magnets, ``use_pallas``; None inside);
  where the tiled step's envelope rejects a scene, both reject it (the
  messages are each package's tiled step's).
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu.parallel import halo_tiled as jht
from titan_tpu_torch.ops import tiled_step
from titan_tpu_torch.parallel import halo_tiled, sharded
from titan_tpu_torch.state import shape_from_fields

from test_torch_halo import cpu_mesh, dist_scene
from test_torch_step import carry_over, jax_chunk_ref

STEPS = 20
# tests/test_torch_tiled.py's tiled-vs-XLA tolerances (module docstring)
POS_TOL, VEL_TOL = (5e-6, 1e-5), (5e-6, 1e-5)
ACT_POS_TOL, ACT_VEL_TOL = (3e-5, 1e-4), (5e-3, 1e-3)


def tiled_run(shape, state, steps, mesh=None):
    """The per-shard tiled route as the control plane runs it: place,
    chunk, gather."""
    mesh = mesh or cpu_mesh()
    run = halo_tiled.build_halo_tiled_chunk(shape, mesh)
    return sharded.DistributedChunk("halo_tiled", shape, mesh, "shard",
                                    run.b, run)(state, steps)


def port_scene(**kw):
    sim = dist_scene(titan_tpu_torch, **kw)
    return sim._shape, sim._state


def assert_bitwise(a, b):
    for f in ("pos", "vel", "acc", "T"):
        assert torch.equal(getattr(a.masses, f), getattr(b.masses, f)), f
    assert torch.equal(a.stencil.rest, b.stencil.rest)
    assert torch.equal(a.t, b.t)


BITWISE = {
    "euler_clamp": dict(velocity_clamp=True),
    "verlet_damped": dict(integrator="verlet", damping=0.4),
    "rk2": dict(integrator="rk2"),
    "rk2_damped_actuated": dict(integrator="rk2", damping=0.4,
                                actuated=True),
    "breathing_drag_deleted": dict(breathing=True, drag=0.3, deleted=True),
    "local_constraint_actuated": dict(local_constraint=True, actuated=True),
    "magnets_binned": dict(magnets=True, magnet_binned=True),
}


@pytest.mark.parametrize("variant", sorted(BITWISE))
def test_tiled_route_bitwise_single_device_plain(variant):
    shape, state = port_scene(**BITWISE[variant])
    assert halo_tiled.halo_tiled_reject_reason(shape, 4) is None
    got = tiled_run(shape, state, STEPS)
    want = tiled_step.tiled_chunk_plain(shape, state, STEPS)
    assert_bitwise(got, want)
    assert not torch.equal(got.masses.pos, state.masses.pos)


def test_tiled_route_pads_an_indivisible_mass_count():
    shape, state = port_scene(damping=0.2)
    mesh = cpu_mesh(3)
    h, b = halo_tiled._geometry(shape, 3)
    assert b * 3 > shape.n_masses and b >= h
    got = tiled_run(shape, state, STEPS, mesh)
    assert_bitwise(got, tiled_step.tiled_chunk_plain(shape, state, STEPS))


GLUE = {
    "remainder": (dict(remainder=True), False),
    "remainder_long_damped": (dict(remainder_long=True, damping=0.3), False),
    "rk2_remainder_actuated": (dict(integrator="rk2",
                                    remainder_actuated=True), True),
    "rk2_magnets_binned_remainder": (dict(integrator="rk2", magnets=True,
                                          magnet_binned=True,
                                          remainder=True), False),
}


@pytest.mark.parametrize("variant", sorted(GLUE))
def test_glue_scenes_match_single_device_plain(variant):
    kw, actuated = GLUE[variant]
    shape, state = port_scene(**kw)
    assert shape.has_remainder
    got = tiled_run(shape, state, STEPS)
    want = tiled_step.tiled_chunk_plain(shape, state, STEPS)
    (pa, pr), (va, vr) = ((ACT_POS_TOL, ACT_VEL_TOL) if actuated
                          else (POS_TOL, VEL_TOL))
    np.testing.assert_allclose(got.masses.pos, want.masses.pos, atol=pa,
                               rtol=pr)
    np.testing.assert_allclose(got.masses.vel, want.masses.vel, atol=va,
                               rtol=vr)
    np.testing.assert_allclose(got.springs.rest, want.springs.rest,
                               atol=1e-5)


JAX = {
    "plain": dict(),
    "rk2_damped": dict(integrator="rk2", damping=0.3),
    "magnets_binned_remainder": dict(magnets=True, magnet_binned=True,
                                     remainder=True),
}


@pytest.mark.parametrize("variant", sorted(JAX))
def test_tiled_route_matches_jax_chunk(variant):
    jsim = dist_scene(titan_tpu, **JAX[variant])
    shape, state = carry_over(jsim)
    want = jax_chunk_ref(jsim._shape, jsim._state, 30)
    got = tiled_run(shape, state, 30)
    n = jsim._store.n_masses
    for f, (a, r) in (("pos", POS_TOL), ("vel", VEL_TOL)):
        np.testing.assert_allclose(
            getattr(got.masses, f).numpy()[:, :n],
            np.asarray(getattr(want.masses, f))[:, :n], atol=a, rtol=r,
            err_msg=f)


@pytest.mark.parametrize("integrator", ["euler", "verlet", "rk2"])
def test_forced_distributed_mega_bitwise_per_step(integrator, monkeypatch):
    sim = titan_tpu_torch.Simulation(titan_tpu_torch.SimConfig(
        device="cpu", integrator=getattr(titan_tpu_torch.Integrator,
                                         integrator.upper())))
    sim.createLattice(titan_tpu_torch.Vec(0, 0, 3),
                      titan_tpu_torch.Vec(16, 0.25, 0.25), 128, 2, 2)
    sim.createPlane(titan_tpu_torch.Vec(0, 0, 1), 0, 0.2, 0.3)
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    shape, state = sim._shape, sim._state
    mesh = cpu_mesh(2)
    h, b = halo_tiled._geometry(shape, 2)
    assert halo_tiled._dist_mega_plan(shape, b, h) == (0, 0)   # the gate
    monkeypatch.setenv("TITAN_DIST_MEGA", "1")
    k, kh = halo_tiled._dist_mega_plan(shape, b, h)
    assert k == tiled_step.MEGA_SEG
    assert kh == k * h * (2 if integrator == "rk2" else 1) <= b
    mega = tiled_run(shape, state, 40, mesh)
    monkeypatch.setenv("TITAN_DIST_MEGA", "0")
    assert halo_tiled._dist_mega_plan(shape, b, h) == (0, 0)
    per_step = tiled_run(shape, state, 40, mesh)
    assert_bitwise(mega, per_step)
    assert_bitwise(mega, tiled_step.tiled_chunk_plain(shape, state, 40))


def test_halo_tiled_reject_reason_matches_jax():
    jbase = dist_scene(titan_tpu)._shape
    jpair = dist_scene(titan_tpu, magnets=True)._shape
    jbinned = dist_scene(titan_tpu, magnets=True, magnet_binned=True)._shape
    rep = dataclasses.replace
    same = [jbase, jbinned, jpair,
            rep(jbase, config=rep(jbase.config, use_pallas=False))]
    for js in same:
        want = jht.halo_tiled_reject_reason(js, 4)
        assert halo_tiled.halo_tiled_reject_reason(
            shape_from_fields(js, "cpu"), 4) == want
    assert jht.halo_tiled_reject_reason(jbase, 4) is None
    assert "exact-pairwise" in jht.halo_tiled_reject_reason(jpair, 4)
    for js in (rep(jbase, config=rep(jbase.config, dtype="float64")),
               rep(jbase, config=rep(jbase.config,
                                     persistent_extern_force=False)),
               rep(jbase, stencil_deltas=())):
        assert jht.halo_tiled_reject_reason(js, 4) is not None
        assert halo_tiled.halo_tiled_reject_reason(
            shape_from_fields(js, "cpu"), 4) is not None
