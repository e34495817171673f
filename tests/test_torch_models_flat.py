"""The port's model archetypes, flat-packed batches and per-env vmap
against titan_tpu's.

The archetypes (``models/archetypes.py``) and the flat packing
(``parallel/flat.py``) are host builders over the store: both packages get
the same calls and must give the same store arrays and local-constraint
records bit for bit (``np.array_equal``), and the same marshalled scene
shape and state.  The flat batch through ``Simulation`` and the vmapped
``BatchedScenes`` step in f32 on both sides (the port's plain versions on
the CPU against JAX's XLA step); they are held at the f32 tolerance the
other port tests use for such runs (1e-5 of position, 5e-4 of velocity:
XLA and PyTorch round the stiff spring forces differently, ROADMAP queue C).
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import titan_tpu
import titan_tpu_torch
from titan_tpu.parallel import BatchedScenes as JaxBatchedScenes
from titan_tpu.state import state_to_numpy as jax_state_to_numpy
from titan_tpu_torch.parallel import (BatchedScenes, build_batched_step,
                                      make_batched_state)
from titan_tpu_torch.state import state_to_numpy

STORE_MASS = ("pos", "vel", "acc", "extern_force", "color", "m", "T", "drag",
              "mag_rad", "mag_stiffness", "mag_maxf", "mag_scale", "fixed",
              "valid", "hole")
STORE_SPRING = ("left", "right", "s_valid", "k", "rest", "damping", "s_type",
                "omega", "l_max", "l_min", "rate")
POS_TOL, VEL_TOL = 1e-5, 5e-4
# the swept batch through Simulation: 2e-2 of velocity (measured 1.30e-2;
# 1.28e-3 with the planes' friction off).  Four of its envs start inside
# their contact plane, and a mass whose friction takes the static branch
# in one package and the kinetic one in the other moves apart in velocity
# while positions agree to 3.0e-6.
FRICTION_VEL_TOL = 2e-2


def _sim(pkg, **cfg):
    if pkg is titan_tpu_torch:
        cfg["device"] = "cpu"
    return pkg.Simulation(pkg.SimConfig(**cfg))


def _same(a, b):
    """Exact equality of two local-constraint entries (tuples of vectors
    and numbers)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), (x, y)


def assert_stores_equal(jsim, tsim):
    """Every store array of both simulations, their local-constraint
    records, containers, planes, balls, dt and gravity: bit for bit."""
    js, ts = jsim._store, tsim._store
    n, s = js.n_masses, js.n_springs
    assert (ts.n_masses, ts.n_springs) == (n, s)
    for f in STORE_MASS:
        a, b = getattr(js, f)[:n], getattr(ts, f)[:n]
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in STORE_SPRING:
        a, b = getattr(js, f)[:s], getattr(ts, f)[:s]
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert sorted(js.local) == sorted(ts.local)
    for i, rec in js.local.items():
        other = ts.local[i]
        for kind in ("contact_planes", "balls", "constraint_planes",
                     "directions"):
            a, b = getattr(rec, kind), getattr(other, kind)
            assert len(a) == len(b), (i, kind)
            for x, y in zip(a, b):
                _same(x, y)
    assert len(jsim.containers) == len(tsim.containers)
    for a, b in zip(jsim.containers, tsim.containers):
        assert np.array_equal(a._mass_idx, b._mass_idx)
        assert np.array_equal(a._spring_idx, b._spring_idx)
    for a, b in zip(jsim._planes, tsim._planes):
        _same(a, b)
    for a, b in zip(jsim._balls, tsim._balls):
        _same(a, b)
    assert (jsim._dt, list(jsim._global_acc)) == \
        (tsim._dt, list(tsim._global_acc))


def assert_marshalled_equal(jsim, tsim):
    """Both marshals give the same scene shape (every field but the config)
    and the same state arrays, exactly."""
    for sim in (jsim, tsim):
        sim._T = 0.0
        sim._marshal()
    js, ts = jsim._shape, tsim._shape
    for f in dataclasses.fields(ts):
        if f.name != "config":
            assert getattr(js, f.name) == getattr(ts, f.name), f.name
    want, got = jax_state_to_numpy(jsim._state), state_to_numpy(tsim._state)
    for name, sub in got.items():
        ref = getattr(want, name)
        if isinstance(sub, dict):
            for leaf, arr in sub.items():
                assert np.array_equal(arr, np.asarray(getattr(ref, leaf))), \
                    f"{name}.{leaf}"
        else:
            assert np.array_equal(sub, np.asarray(ref)), name


def _cloth(pkg, sim, edge):
    return pkg.models.cloth(sim, pkg.Vec(0, 0, 1), size=0.8, n=6,
                            fix_edge=edge)


ARCHETYPES = {
    "cloth_top": lambda pkg, sim: _cloth(pkg, sim, "top"),
    "cloth_left": lambda pkg, sim: _cloth(pkg, sim, "left"),
    "cloth_corners": lambda pkg, sim: _cloth(pkg, sim, "corners"),
    "rope": lambda pkg, sim: pkg.models.rope(
        sim, pkg.Vec(0, 0, 2), pkg.Vec(1, 0.3, 1.5), n=12),
    "rope_free": lambda pkg, sim: pkg.models.rope(
        sim, pkg.Vec(0, 0, 2), pkg.Vec(-1, 0, 2), n=7, fix_start=False),
    "walker": lambda pkg, sim: pkg.models.walker(sim, size=0.8, n=3),
    "quadruped": lambda pkg, sim: pkg.models.quadruped(sim),
    "tensegrity": lambda pkg, sim: pkg.models.tensegrity(
        sim, pkg.Vec(0, 0, 1)),
    "truss_tetrahedron": lambda pkg, sim: pkg.models.truss_tetrahedron(
        sim, pkg.Vec(0, 0, 1)),
}


@pytest.mark.parametrize("name", sorted(ARCHETYPES))
def test_archetype_store_matches_jax(name):
    sims = []
    for pkg in (titan_tpu, titan_tpu_torch):
        sim = _sim(pkg)
        ARCHETYPES[name](pkg, sim)
        sim.createPlane(pkg.Vec(0, 0, 1), 0, 0.5, 0.7)
        sims.append(sim)
    assert_stores_equal(*sims)
    assert_marshalled_equal(*sims)


def _template(pkg, nx=3):
    """examples/batched_rl_envs.py's env: a 3^3 lattice on a friction
    plane."""
    src = _sim(pkg)
    src.createLattice(pkg.Vec(0, 0, 0.6), pkg.Vec(1, 1, 1), nx, nx, nx)
    src.createPlane(pkg.Vec(0, 0, 1), 0, 0.4, 0.6)
    src.setGlobalAcceleration(pkg.Vec(0, 0, -9.8))
    src.setTimeStep(0.0001)
    return src


def _flat_batch(pkg, n_envs=6, sweep=True):
    """The template replicated with a spacing, a per-env k sweep, and
    per-env gravity and contact planes, each sweep issued twice (the second
    must replace the first)."""
    from importlib import import_module
    flat = import_module(pkg.__name__ + ".parallel.flat")
    big, envs = flat.replicate_scene(_template(pkg), n_envs,
                                     spacing=pkg.Vec(3, 0, 0))
    if sweep:
        for e, env in enumerate(envs):
            env.setSpringConstants(5000.0 + 1500.0 * e)
        for rep in range(2):
            flat.set_env_gravity(big, envs, [
                pkg.Vec(0.1 * rep, 0, -9.8 * (1 + 0.1 * e))
                for e in range(n_envs)])
            flat.set_env_plane(big, envs, pkg.Vec(0, 0.1, 1),
                               [0.05 * e + 0.01 * rep
                                for e in range(n_envs)], fk=0.3, fs=0.5)
    return big, envs


@pytest.mark.parametrize("sweep", [False, True], ids=["plain", "sweeps"])
def test_flat_batch_store_and_marshal_match_jax(sweep):
    (jbig, jenvs), (tbig, tenvs) = (_flat_batch(titan_tpu, sweep=sweep),
                                    _flat_batch(titan_tpu_torch, sweep=sweep))
    assert len(tenvs) == 6 and tbig.containers == tenvs
    assert_stores_equal(jbig, tbig)
    assert np.array_equal(jbig._env_gravity_delta, tbig._env_gravity_delta) \
        if sweep else not hasattr(tbig, "_env_gravity_delta")
    assert_marshalled_equal(jbig, tbig)
    if sweep:
        # one tracked slot a mass, and k no longer uniform in its families
        assert tbig._shape.cap_cp == 1
        assert not tbig._shape.stencil_uniform[0]


def test_replicate_walker_with_offsets_matches_jax():
    sims = []
    for pkg in (titan_tpu, titan_tpu_torch):
        src = _sim(pkg)
        pkg.models.walker(src, size=0.8, n=3)
        src.masses[0].addConstraint(pkg.CONTACT_PLANE, pkg.Vec(0, 0, 1), 0.02)
        src.masses[1].addConstraint(pkg.BALL, pkg.Vec(0, 0, 0.1), 0.05)
        src.createPlane(pkg.Vec(0, 0, 1), 0, 0.5, 0.7)
        from importlib import import_module
        flat = import_module(pkg.__name__ + ".parallel.flat")
        sims.append(flat.replicate_scene(src, 5,
                                         spacing=pkg.Vec(2, 0.5, 0))[0])
    assert_stores_equal(*sims)
    assert_marshalled_equal(*sims)


def test_flat_batch_through_simulation_matches_jax():
    """The swept batch through Simulation (start -> pause -> getAll ->
    resume -> pause -> getAll -> stop) on both packages: the port's fused
    route (its plain version on the CPU) against JAX's XLA step."""
    out = []
    for pkg in (titan_tpu, titan_tpu_torch):
        big, _ = _flat_batch(pkg)
        big.start()
        big.pause(0.01)
        big.resume()
        big.pause(0.02)
        big.getAll()
        n = big._store.n_masses
        out.append((big._store.pos[:n].copy(), big._store.vel[:n].copy()))
        big.stop()
    (jp, jv), (tp, tv) = out
    np.testing.assert_allclose(tp, jp, atol=POS_TOL)
    np.testing.assert_allclose(tv, jv, atol=FRICTION_VEL_TOL)
    assert np.abs(tp - _flat_batch(titan_tpu_torch)[0]._store.pos[
        :len(tp)]).max() > 1e-3      # the batch moved


def _batched_pair(n_envs=4):
    """Both packages' BatchedScenes of the template, with per-env gravity
    and initial velocities from the same numpy draws."""
    rng = np.random.RandomState(3)
    g = (rng.normal(0, 1, (n_envs, 3))
         + np.array([0, 0, -9.8])).astype(np.float32)
    out, noise = [], None
    for pkg, cls, put in ((titan_tpu, JaxBatchedScenes, jnp.asarray),
                          (titan_tpu_torch, BatchedScenes, torch.as_tensor)):
        b = cls.from_simulation(_template(pkg), n_envs=n_envs)
        vel = np.asarray(b.state.masses.vel)
        if noise is None:
            noise = rng.normal(0, 0.2, vel.shape).astype(np.float32)
        b.state = dataclasses.replace(
            b.state, g=put(g),
            masses=dataclasses.replace(b.state.masses, vel=put(vel + noise)))
        out.append(b)
    return out


def test_batched_scenes_match_jax_vmap():
    jb, tb = _batched_pair()
    jb.run(60)
    tb.run(60)
    np.testing.assert_allclose(tb.positions().numpy(),
                               np.asarray(jb.positions()), atol=POS_TOL)
    np.testing.assert_allclose(tb.velocities().numpy(),
                               np.asarray(jb.velocities()), atol=VEL_TOL)
    # the per-env globals took: every env went its own way
    z = tb.positions()[:, 2].mean(dim=1)
    assert len(set(np.round(z.numpy(), 5))) == 4


def test_batched_step_is_the_per_env_step():
    """The vmapped step is each env's own eager step (bitwise), and each
    env owns its storage."""
    from titan_tpu_torch.ops.step import build_step_fn
    sim = _template(titan_tpu_torch)
    sim._T = 0.0
    sim._marshal()
    state = make_batched_state(sim._state, 3)
    state.stencil.k[1] *= 3.0            # one env's write stays its own
    state.masses.vel[2, 2] -= 0.5
    assert float(state.stencil.k[0].max()) == float(sim._state.stencil.k.max())
    out = build_batched_step(sim._shape)(state)
    step = build_step_fn(sim._shape)
    for e in range(3):
        one = step(pytree.tree_map(lambda x: x[e], state))
        assert torch.equal(out.masses.pos[e], one.masses.pos)
        assert torch.equal(out.masses.vel[e], one.masses.vel)


def test_batched_randomize_is_seeded():
    def kick(st, seed):
        g = torch.Generator().manual_seed(seed)
        return dataclasses.replace(st, g=st.g + torch.randn(
            3, generator=g, dtype=st.g.dtype))
    runs = []
    for key in (7, 7, 8):
        b = BatchedScenes.from_simulation(_template(titan_tpu_torch), 4)
        b.randomize(kick, key)
        runs.append(b.state.g.clone())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert len(set(runs[0][:, 2].tolist())) == 4
    # the same randomized batch with its env axis over 2 shards
    from titan_tpu_torch.parallel import make_mesh
    b = BatchedScenes.from_simulation(_template(titan_tpu_torch), 4,
                                      mesh=make_mesh(devices=["cpu"] * 2))
    b.randomize(kick, 7)
    assert torch.equal(b.state.g, runs[0])
