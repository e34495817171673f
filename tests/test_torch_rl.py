"""The port's vectorized RL environments (``titan_tpu_torch.rl``) against
titan_tpu's.

Both packages build the same env from the same template; the marshalled
initial states are equal bit for bit, and each control step runs from the
same actions:

- in f64 the port's chunk is its eager step (the kernels are f32-only)
  against JAX's XLA step with x64 on: obs, reward, done and state at atol
  1e-9;
- in f32 the port takes the fused route, its plain version on the CPU
  (``fused_chunk_plain``), against JAX's XLA chunk (compiled without XLA's
  optimisation passes, ``FAST_XLA``): positions and rewards at 5e-5,
  velocities at 1e-2 and observations at 1e-3 (measured over 1,200
  steps: at most 1.3e-5 of position, 2.8e-3 of velocity and 1.9e-4 of an
  observation, all on the walkers, whose feet slide on a friction plane;
  the pushers 2.0e-6 and 1.2e-4.  XLA and PyTorch round the stiff spring
  forces differently, ROADMAP queue C, and the friction switch amplifies
  it);
- the per-env omega walker on the tiled route (``tiled_chunk_plain``),
  2,000 steps: positions at 5e-4 and velocities at 5e-2 (measured 8.1e-5
  and 1.07e-2; the fused route is as far from XLA, 6.0e-5 and 1.31e-2).
  Reading omega as one scalar per family, as the marshalled shape would,
  put envs 1-3 0.09-0.12 m off.

JAX's random keys and the port's seeds give different streams, so the
episodic tests feed both packages the same numpy noise through
``randomize``.
"""

import torch_threads  # noqa: F401  (before torch)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu import rl as jrl
from titan_tpu.ops.step import build_chunk_fn as jax_chunk_fn
from titan_tpu.state import state_to_numpy as jax_state_to_numpy
from titan_tpu_torch import rl
from titan_tpu_torch.ops import step as tstep
from titan_tpu_torch.ops import tiled_step
from titan_tpu_torch.state import state_to_numpy

from test_torch_step import FAST_XLA

POS_TOL, VEL_TOL, OBS_TOL = 5e-5, 1e-2, 1e-3
TILED_POS_TOL, TILED_VEL_TOL = 5e-4, 5e-2
F64_TOL = 1e-9
# per-env actions: the walker's omega multipliers, the pushers' forces
ACTIONS = {
    "walker_env": np.array([0.25, 1.0, 2.0, 4.0]),
    "pusher_env": np.array([[1.0, 0.0], [0.5, 0.2], [-1.0, 0.0],
                            [0.0, -1.5]]),
    "pusher2_env": np.array([[0.0, 0.0, 1.5, 0.0], [0.7, -0.4, 0.0, 0.0]]),
}


_COMPILED = {}       # JAX scene shape -> its chunk, compiled once


def fast_chunks(jenv):
    """Route the JAX env's chunk through one ``FAST_XLA`` compile per scene
    shape (the envs of one template share it)."""
    def chunk(state, n):
        n = jnp.int32(n)
        exe = _COMPILED.get(jenv.shape)
        if exe is None:
            exe = _COMPILED[jenv.shape] = jax_chunk_fn(jenv.shape).lower(
                state, n).compile(compiler_options=FAST_XLA)
        return exe(state, n)
    jenv._chunk = chunk
    return jenv


def env_pair(name, dtype="float32", control_dt=0.04, **kw):
    """(JAX env, port env on the CPU) of ``name`` with len(ACTIONS) envs."""
    n_envs = len(ACTIONS[name])
    jenv = getattr(jrl, name)(n_envs=n_envs, control_dt=control_dt,
                              config=titan_tpu.SimConfig(dtype=dtype), **kw)
    tenv = getattr(rl, name)(n_envs=n_envs, control_dt=control_dt,
                             config=titan_tpu_torch.SimConfig(
                                 dtype=dtype, device="cpu"), **kw)
    return fast_chunks(jenv), tenv


def both(x, dtype):
    return jnp.asarray(x.astype(dtype)), torch.as_tensor(x.astype(dtype))


def close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


def assert_sims_close(tsim, jsim, pos_tol, vel_tol):
    close(tsim.masses.pos, jsim.masses.pos, pos_tol, "pos")
    close(tsim.masses.vel, jsim.masses.vel, vel_tol, "vel")
    close(tsim.stencil.omega, jsim.stencil.omega, 0, "omega")
    close(tsim.masses.extern_force, jsim.masses.extern_force, 0,
          "extern_force")
    # JAX adds dt to t step by step; the port's chunks add n dt at once
    # (2.8e-6 apart in f32 after 2,000 steps)
    close(tsim.t, jsim.t, 1e-12 if pos_tol < 1e-6 else 1e-5, "t")


@pytest.fixture(scope="module")
def f32_envs():
    return {name: env_pair(name) for name in ACTIONS}


@pytest.mark.parametrize("name", sorted(ACTIONS))
def test_initial_state_and_obs_match_jax(name, f32_envs):
    jenv, tenv = f32_envs[name]
    assert tenv.steps_per_control == jenv.steps_per_control == 400
    want = jax_state_to_numpy(jenv._state0)
    for group, leaves in state_to_numpy(tenv._state0).items():
        ref = getattr(want, group)
        for leaf, arr in (leaves.items() if isinstance(leaves, dict)
                          else [(None, leaves)]):
            exp = getattr(ref, leaf) if leaf else ref
            assert np.array_equal(arr, np.asarray(exp)), (group, leaf)
    assert tenv.shape.stencil_uniform == jenv.shape.stencil_uniform
    _, jobs = jenv.reset()
    _, tobs = tenv.reset()
    close(tobs, jobs, 1e-7, "obs")
    assert np.array_equal(tenv.env_of_lane().numpy(),
                          np.asarray(jenv.env_of_lane()))


@pytest.mark.parametrize("name", sorted(ACTIONS))
def test_steps_match_jax_f32(name, f32_envs):
    jenv, tenv = f32_envs[name]
    assert tstep.chunk_route(tenv.step_shape(tenv._state0))[0] == "fused"
    ja, ta = both(ACTIONS[name], np.float32)
    js, _ = jenv.reset()
    ts, _ = tenv.reset()
    for _ in range(3):
        js, jobs, jrew = jenv.step(js, ja)
        ts, tobs, trew = tenv.step(ts, ta)
        close(tobs, jobs, OBS_TOL, "obs")
        close(trew, jrew, POS_TOL, "reward")
    assert_sims_close(ts, js, POS_TOL, VEL_TOL)
    assert float(trew.std()) > 0         # the actions told the envs apart


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", sorted(ACTIONS))
def test_steps_match_jax_f64(name, x64):
    jenv, tenv = env_pair(name, "float64", control_dt=0.005)
    ja, ta = both(ACTIONS[name], np.float64)
    js, _ = jenv.reset()
    ts, _ = tenv.reset()
    assert tstep.chunk_route(tenv.shape)[0] == "eager"
    for _ in range(2):
        js, jobs, jrew = jenv.step(js, ja)
        ts, tobs, trew = tenv.step(ts, ta)
        assert tobs.dtype == torch.float64
        close(tobs, jobs, F64_TOL, "obs")
        close(trew, jrew, F64_TOL, "reward")
    assert_sims_close(ts, js, F64_TOL, F64_TOL)


def test_episodic_api_matches_jax():
    """Truncation, a terminate predicate and auto-reset, with the same
    numpy noise fed to both packages' ``randomize``."""
    n_envs = 4
    noise = np.random.RandomState(0).normal(0, 0.05, (3, 128)).astype(
        np.float32)

    def randomize(put):
        def fn(sim, key, env):
            m = sim.masses
            return dataclasses.replace(sim, masses=dataclasses.replace(
                m, vel=m.vel + put(noise)))
        return fn

    def fell(sim, env):             # env 3's fast gait trips it first
        return env.env_means(sim.masses.pos)[0] < -0.0005

    jenv, tenv = [
        fast_chunks(e) if pkg is jrl else e for pkg, e in (
            (pkg, pkg.walker_env(
                n_envs=n_envs, control_dt=0.02, config=cfg,
                episode_length=3, terminate=fell,
                randomize=randomize(put)))
            for pkg, cfg, put in (
                (jrl, titan_tpu.SimConfig(), jnp.asarray),
                (rl, titan_tpu_torch.SimConfig(device="cpu"),
                 torch.as_tensor)))]
    ja, ta = both(ACTIONS["walker_env"], np.float32)
    js, jobs = jenv.reset(jax.random.key(0))
    ts, tobs = tenv.reset(0)
    close(tobs, jobs, 1e-7, "obs")
    assert ts.t.dtype == torch.int32 and ts.key.dtype == torch.int64
    dones = []
    for _ in range(4):
        js, jobs, jrew, jdone, jinfo = jenv.step(js, ja)
        ts, tobs, trew, tdone, tinfo = tenv.step(ts, ta)
        for k in ("terminated", "truncated"):
            assert np.array_equal(tinfo[k].numpy(), np.asarray(jinfo[k])), k
        assert np.array_equal(tdone.numpy(), np.asarray(jdone))
        assert np.array_equal(ts.t.numpy(), np.asarray(js.t))
        close(tobs, jobs, OBS_TOL, "obs")
        close(trew, jrew, POS_TOL, "reward")
        dones.append(tdone.numpy())
    dones = np.array(dones)
    # some env terminated early, and every env was done by the truncation
    assert dones[:2].any() and not dones[:2].all()
    assert dones[:3].any(axis=0).all()
    assert_sims_close(ts.sim, js.sim, POS_TOL, VEL_TOL)


def test_reset_noise_is_seeded_and_velocity_only():
    env = rl.walker_env(n_envs=3, control_dt=0.001, reset_noise=0.05,
                        episode_length=1,
                        config=titan_tpu_torch.SimConfig(device="cpu"))
    s1, _ = env.reset(7)
    s2, _ = env.reset(torch.tensor(7))
    s3, _ = env.reset(8)
    assert torch.equal(s1.sim.masses.vel, s2.sim.masses.vel)
    assert not torch.equal(s1.sim.masses.vel, s3.sim.masses.vel)
    assert torch.equal(s1.sim.masses.pos, s3.sim.masses.pos)
    # padding lanes (invalid masses) take no noise
    valid = env._state0.masses.valid
    assert torch.equal(s1.sim.masses.vel[:, ~valid],
                       env._state0.masses.vel[:, ~valid])
    # truncation at every step: each auto-reset draws fresh noise
    a = torch.ones(3)
    n1, _, _, d1, _ = env.step(s1, a)
    n2, _, _, d2, _ = env.step(n1, a)
    assert d1.all() and d2.all() and not torch.equal(n1.key, n2.key)
    assert not torch.equal(n1.sim.masses.vel, n2.sim.masses.vel)
    assert torch.equal(n2.sim.masses.pos, env._state0.masses.pos)


def test_step_is_pure(f32_envs):
    """Same inputs, same outputs; no input tensor is written; [n_envs, 1]
    actions are [n_envs] ones."""
    _, tenv = f32_envs["walker_env"]
    state, _ = tenv.reset()
    before = state_to_numpy(state)
    a = torch.tensor([0.5, 1.0, 1.5, 2.0])
    s1, o1, r1 = tenv.step(state, a)
    s2, o2, r2 = tenv.step(state, a[:, None])
    assert torch.equal(o1, o2) and torch.equal(r1, r2)
    assert torch.equal(s1.masses.pos, s2.masses.pos)
    after = state_to_numpy(state)
    for group, leaves in before.items():
        for leaf, arr in (leaves.items() if isinstance(leaves, dict)
                          else [(None, leaves)]):
            got = after[group][leaf] if leaf else after[group]
            assert np.array_equal(arr, got), (group, leaf)
    assert tenv.env_of_lane() is tenv.env_of_lane()


def test_step_shape_clears_the_fields_an_action_writes(f32_envs):
    """The walker's action writes omega: its chunks read omega per lane
    (the tiled plan carries it as a plane, not a family scalar); the
    pushers write no stencil field and keep the marshalled shape, k's
    flag and the plain-spring loop with it; a randomizer that writes k
    clears k's."""
    from titan_tpu_torch.ops.fused_step import takes_plain_spring_path
    _, walker = f32_envs["walker_env"]
    s, _ = walker.reset()
    acted = walker._apply(s, torch.ones(4), walker)
    assert walker.step_shape(s) is walker.shape
    flags = walker.step_shape(acted).stencil_uniform
    assert flags == walker.shape.stencil_uniform[:4] + (False,)
    assert "bomega" not in tiled_step._plan(walker.shape)
    assert "bomega" in tiled_step._plan(walker.step_shape(acted))
    _, pusher = f32_envs["pusher2_env"]
    s, _ = pusher.reset()
    acted = pusher._apply(s, torch.ones(2, 4), pusher)
    assert pusher.step_shape(acted) is pusher.shape
    assert takes_plain_spring_path(pusher.shape)
    stiff = dataclasses.replace(acted, stencil=dataclasses.replace(
        acted.stencil, k=acted.stencil.k * 2))
    assert not pusher.step_shape(stiff).stencil_uniform[0]
    assert not takes_plain_spring_path(pusher.step_shape(stiff))


def test_tiled_walker_per_env_omega_matches_jax(monkeypatch):
    """Per-env omega (x0.25 / 1 / 2 / 4) on the tiled route: the env
    steps through ``tiled_chunk`` (the resident budget set to 0 sends the
    4 walkers there, as 16,384 walkers go on the card) for 4 control steps
    of 500, against JAX's env on its XLA chunk."""
    monkeypatch.setattr(tstep, "RESIDENT_BUDGET", 0)
    jenv, tenv = env_pair("walker_env", control_dt=0.05)
    ja, ta = both(ACTIONS["walker_env"], np.float32)
    js, _ = jenv.reset()
    ts, _ = tenv.reset()
    assert tstep.chunk_route(tenv.shape)[0] == "tiled"
    for _ in range(4):
        js, jobs, _ = jenv.step(js, ja)
        ts, tobs, _ = tenv.step(ts, ta)
    assert_sims_close(ts, js, TILED_POS_TOL, TILED_VEL_TOL)
    close(tobs[:, :3], jobs[:, :3], TILED_POS_TOL, "obs")


def test_make_observe_matches_jax():
    obs = {pkg: pkg.make_observe(com=True, mass_indices=(0, 3, 26),
                                 contact_eps=0.05) for pkg in (jrl, rl)}
    jenv = fast_chunks(jrl.walker_env(n_envs=4, control_dt=0.02,
                                      observe=obs[jrl]))
    tenv = rl.walker_env(n_envs=4, control_dt=0.02, observe=obs[rl],
                         config=titan_tpu_torch.SimConfig(device="cpu"))
    ja, ta = both(ACTIONS["walker_env"], np.float32)
    js, jo = jenv.reset()
    ts, to = tenv.reset()
    for _ in range(3):
        js, jo, _ = jenv.step(js, ja)
        ts, to, _ = tenv.step(ts, ta)
    assert to.shape == (4, 6 + 3 * 6 + 1)
    close(to, jo, OBS_TOL, "obs")
    contact = to[:, -1].numpy()
    assert np.all(contact > 0) and np.all(contact < 1)


def test_make_observe_reused_in_a_second_env_matches_jax():
    """One ``make_observe`` callback used with a 2-env walker batch, then
    with a 3-env one (ROADMAP C7): the port cached the observed lanes by
    device only, so the second env read the first env's lanes ([3, 8]
    where JAX gives [3, 12]).  Shape and values must equal JAX's exactly
    at ``reset()``."""
    obs = {pkg: pkg.make_observe(com=False, mass_indices=[0, 5])
           for pkg in (jrl, rl)}
    for n_envs in (2, 3):
        jenv = jrl.walker_env(n_envs=n_envs, observe=obs[jrl])
        tenv = rl.walker_env(n_envs=n_envs, observe=obs[rl],
                             config=titan_tpu_torch.SimConfig(device="cpu"))
        _, jo = jenv.reset()
        _, to = tenv.reset()
        assert tuple(to.shape) == tuple(jo.shape) == (n_envs, 12)
        close(to, jo, 0, f"obs of the {n_envs}-env batch")
