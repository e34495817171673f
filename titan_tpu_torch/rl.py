"""Vectorized RL environments over the flat-packed batch fast path (the
counterpart of ``titan_tpu/rl.py``).

The reference bills itself as a simulator "for soft robotics and
reinforcement learning" (CMakeLists.txt:2-5) but ships no environment
interface -- RL users get the raw library.  This module supplies what they
actually need: a gym-style vectorized environment whose reset/step are PURE
FUNCTIONS of the state (no input tensor is written, and the same inputs give
the same outputs), with observations, rewards, done flags and auto-reset as
tensor operations on the state's device.

Design:
  - the batch is ONE flat-packed scene (parallel/flat.replicate_scene),
    stepped by ``ops/step.py::build_chunk_fn``: the fused CUDA kernel, or
    the tiled kernels past the reference's residency rule
    (``step.chunk_route``); their plain versions for state on the CPU;
  - a control step = ``steps_per_control`` physics sub-steps advanced by one
    chunk;
  - actions mutate continuous per-spring/per-mass STATE fields (never the
    scene's structure), so one scene shape serves the whole training run;
  - observations/rewards are per-env reductions computed on the device.

Per-lane stencil fields.  The marshalled shape marks a stencil field that
is uniform within every family (``SceneShape.stencil_uniform``), and the
tiled step then reads one scalar per family, taken from the family's first
lane (``ops/tiled_step.py::_plan``); the fused step's plain-spring loop
reads k so.  An action or a reset randomizer may write any stencil field
per env (the walker's writes omega), so each chunk steps with the flag of
every field whose tensor is no longer the marshalled one cleared
(``BatchedEnv.step_shape``): such a field then rides per lane on every
route, as the JAX package's XLA step reads it.  A batch that writes no
stencil field (the pushers) keeps the marshalled shape.

    env = rl.walker_env(n_envs=1024)                # on the card
    state, obs = env.reset()
    state, obs, reward = env.step(state, actions)   # actions [n_envs]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .ops.fused_step import SCALAR_ROWS
from .ops.step import build_chunk_fn


class EnvState(NamedTuple):
    """Episodic environment state: the flat-packed physics state plus
    per-env episode step counts and the seed auto-resets consume.

    ``key`` is a 0-d int64 seed tensor on the CPU (the counterpart of the
    JAX package's PRNG key): each reset splits it (``_split``) and draws
    its noise from a ``torch.Generator`` seeded from the split-off half on
    the state's device.  The stream is not JAX's: the same seed gives other
    numbers than in the JAX package.

    NOTE the physics clock ``sim.t`` is GLOBAL to the flat-packed batch (one
    scene, one time): an auto-reset env resumes with the batch's current
    breathing phase rather than phase 0.  Episode-relative time lives in
    ``t`` (control steps)."""
    sim: object             # SimState
    t: torch.Tensor         # [n_envs] int32: control steps into the episode
    key: torch.Tensor       # [] int64 seed, on the CPU


def _split(key: torch.Tensor):
    """(next key, sub key): two int64 seeds drawn from a CPU generator
    seeded with ``key`` (``jax.random.split``'s role)."""
    g = torch.Generator().manual_seed(int(key))
    nxt, sub = torch.randint(0, 2 ** 62, (2,), generator=g, dtype=torch.int64)
    return nxt, sub


class BatchedEnv:
    """A vectorized environment over ``n_envs`` flat-packed copies of a
    template scene.

    Parameters
    ----------
    template_sim : an un-started Simulation holding ONE environment's scene
        (including its planes/gravity/dt); its ``config`` names the device.
    n_envs : number of packed copies.
    control_dt : sim-seconds advanced per ``step`` call (rounded to a whole
        number of physics steps).
    apply_action : (state, action, env) -> state.  Pure; writes continuous
        state fields (e.g. stencil omega/rest scales, extern forces).
    observe : (state, env) -> obs [n_envs, ...].  Default: per-env COM
        position and velocity, [n_envs, 6].
    reward : (prev_state, state, env) -> [n_envs].  Default: per-env COM
        x-displacement over the control step.
    spacing : optional Vec offset between env copies (keep None unless
        magnets are in play; see replicate_scene).

    Episode semantics (opt-in).  Passing any of ``episode_length``,
    ``terminate``, ``reset_noise`` or ``randomize`` switches the env to the
    gym-style episodic API:

        state, obs = env.reset(0)                         # EnvState
        state, obs, reward, done, info = env.step(state, action)

    where ``done = terminated | truncated`` ([n_envs] bool), ``info`` holds
    the separate "terminated"/"truncated" flags, and done envs AUTO-RESET in
    place: their per-env physics state (pos/vel/acc/T, mutated spring rests)
    is overwritten with a freshly randomized initial state before ``obs`` is
    computed, so the returned observation is the post-reset one (the brax /
    vectorized-gym convention; correct bootstrapping uses the done flag).
    Without any of these arguments the legacy 3-tuple API is unchanged.

    episode_length : max control steps per episode; exceeding it TRUNCATES.
    terminate : (state, env) -> [n_envs] bool, checked after each control
        step (e.g. "fell over").  Non-finite per-env COM always terminates
        (divergence guard).
    reset_noise : std-dev of Gaussian velocity noise added to every valid
        mass at (auto-)reset -- the default seeded randomization.
    randomize : (sim_state, key, env) -> sim_state.  Custom randomization
        applied at (auto-)reset instead of the velocity noise; ``key`` is
        the reset's int64 seed tensor (see ``EnvState``).
    """

    def __init__(self, template_sim, n_envs: int, control_dt: float = 0.02,
                 apply_action: Optional[Callable] = None,
                 observe: Optional[Callable] = None,
                 reward: Optional[Callable] = None,
                 spacing=None,
                 episode_length: Optional[int] = None,
                 terminate: Optional[Callable] = None,
                 reset_noise: float = 0.0,
                 randomize: Optional[Callable] = None):
        from .parallel import replicate_scene

        big, _envs = replicate_scene(template_sim, n_envs, spacing=spacing)
        big._T = 0.0
        big._marshal()
        self.shape = big._shape
        self._state0 = big._state
        self.n_envs = n_envs
        self.n_per_env = template_sim._store.n_masses
        self.s_per_env = template_sim._store.n_springs
        dt = float(big._dt)
        self.steps_per_control = max(1, round(control_dt / dt))
        self.control_dt = self.steps_per_control * dt
        self._chunks = {}        # stencil_uniform flags -> chunk fn
        self._apply = apply_action or (lambda st, a, env: st)
        self._observe = observe or _com_obs
        self._reward = reward or _com_x_progress
        self.episode_length = episode_length
        self._terminate = terminate
        self.reset_noise = float(reset_noise)
        self._randomize = randomize
        self.episodic = (episode_length is not None or terminate is not None
                         or reset_noise > 0.0 or randomize is not None)
        N = self.shape.n_masses
        lane = torch.arange(N, dtype=torch.int64)
        self._env_of_lane = torch.clamp(
            lane // self.n_per_env, max=n_envs - 1).to(
                torch.int32).to(self._state0.masses.pos.device)

    # -- stepping ---------------------------------------------------------
    def step_shape(self, sim):
        """The shape a chunk from ``sim`` steps with: the marshalled one,
        with the family-uniform flag cleared for every stencil field whose
        tensor is not the marshalled one (an action or a randomizer wrote
        it, maybe per env), so that it rides per lane on every route."""
        st0, st = self._state0.stencil, sim.stencil
        flags = tuple(bool(u) and getattr(st, f) is getattr(st0, f)
                      for f, u in zip(SCALAR_ROWS,
                                      self.shape.stencil_uniform))
        if flags == self.shape.stencil_uniform:
            return self.shape
        return dataclasses.replace(self.shape, stencil_uniform=flags)

    def _chunk(self, sim, n_steps: int):
        """``n_steps`` physics steps of ``sim`` through ``build_chunk_fn``
        of its ``step_shape``."""
        shape = self.step_shape(sim)
        fn = self._chunks.get(shape.stencil_uniform)
        if fn is None:
            fn = self._chunks[shape.stencil_uniform] = build_chunk_fn(shape)
        return fn(sim, n_steps)

    # -- pure functions ---------------------------------------------------
    def _randomized_initial(self, key):
        """The initial physics state with this env's reset randomization."""
        if self._randomize is not None:
            return self._randomize(self._state0, key, self)
        if self.reset_noise > 0.0:
            m = self._state0.masses
            g = torch.Generator(device=m.vel.device).manual_seed(int(key))
            noise = self.reset_noise * torch.randn(
                m.vel.shape, generator=g, dtype=m.vel.dtype,
                device=m.vel.device)
            move = m.valid & ~m.fixed
            return dataclasses.replace(
                self._state0,
                masses=dataclasses.replace(
                    m, vel=torch.where(move, m.vel + noise, m.vel)))
        return self._state0

    def reset(self, key=None):
        """-> (state, obs).

        Legacy mode: the same deterministic initial state every call.
        Episodic mode: ``key`` (an int or int64 seed tensor, default 0)
        seeds the reset randomization and the auto-reset stream; returns an
        EnvState."""
        if not self.episodic:
            return self._state0, self._observe(self._state0, self)
        key = torch.as_tensor(0 if key is None else key, dtype=torch.int64)
        key, sub = _split(key)
        sim = self._randomized_initial(sub)
        es = EnvState(sim=sim, t=torch.zeros(
            self.n_envs, dtype=torch.int32, device=self._env_of_lane.device),
            key=key)
        return es, self._observe(sim, self)

    def _done_flags(self, sim, t_next):
        """(terminated, truncated) after a control step at episode step
        ``t_next`` (1-based)."""
        com = self.env_means(sim.masses.pos)               # [3, n_envs]
        diverged = ~torch.all(torch.isfinite(com), dim=0)
        if self._terminate is not None:
            terminated = self._terminate(sim, self) | diverged
        else:
            terminated = diverged
        if self.episode_length is not None:
            truncated = t_next >= self.episode_length
        else:
            truncated = torch.zeros_like(diverged)
        return terminated, truncated

    def _auto_reset(self, sim, fresh, done):
        """Overwrite done envs' per-env physics state with ``fresh``."""
        lane = done[self.env_of_lane()]                    # [N] bool
        m, f = sim.masses, fresh.masses
        new_m = dataclasses.replace(
            m,
            pos=torch.where(lane, f.pos, m.pos),
            vel=torch.where(lane, f.vel, m.vel),
            acc=torch.where(lane, f.acc, m.acc),
            extern_force=torch.where(lane, f.extern_force, m.extern_force),
            T=torch.where(lane, f.T, m.T))
        sim = dataclasses.replace(sim, masses=new_m)
        if self.shape.has_actuated:
            # mutated spring rests are per-env state too
            sim = dataclasses.replace(
                sim, stencil=dataclasses.replace(
                    sim.stencil,
                    rest=torch.where(lane, fresh.stencil.rest,
                                     sim.stencil.rest)))
            if self.shape.has_remainder:
                sp_lane = done[self.env_of_lane()[sim.springs.left.long()]]
                sim = dataclasses.replace(
                    sim, springs=dataclasses.replace(
                        sim.springs,
                        rest=torch.where(sp_lane, fresh.springs.rest,
                                         sim.springs.rest)))
        return sim

    def step(self, state, action):
        """Legacy mode: (state, obs, reward).
        Episodic mode: (state, obs, reward, done, info) with auto-reset
        (see class docstring)."""
        if not self.episodic:
            state = self._apply(state, action, self)
            prev = state
            state = self._chunk(state, self.steps_per_control)
            return (state, self._observe(state, self),
                    self._reward(prev, state, self))
        es = state
        sim = self._apply(es.sim, action, self)
        prev = sim
        sim = self._chunk(sim, self.steps_per_control)
        rew = self._reward(prev, sim, self)
        t_next = es.t + 1
        terminated, truncated = self._done_flags(sim, t_next)
        done = terminated | truncated
        key, sub = _split(es.key)
        fresh = self._randomized_initial(sub)
        sim = self._auto_reset(sim, fresh, done)
        t_next = torch.where(done, 0, t_next)
        obs = self._observe(sim, self)                     # post-reset
        return (EnvState(sim=sim, t=t_next, key=key), obs, rew, done,
                {"terminated": terminated, "truncated": truncated})

    # -- helpers for action/observation authors ----------------------------
    def env_means(self, x):
        """Per-env mean over the mass axis: x [..., N_padded] -> [..., n_envs].

        Padding lanes beyond n_envs * n_per_env are dropped."""
        n, e = self.n_per_env, self.n_envs
        return x[..., : e * n].reshape(*x.shape[:-1], e, n).mean(dim=-1)

    def env_of_lane(self):
        """[N_padded] int32 on the state's device: which env each mass lane
        (= stencil lane) belongs to (lanes past the packed region map to
        the last env; they are masked anyway).  Made once, at build."""
        return self._env_of_lane


def _com_obs(state, env):
    pos = env.env_means(state.masses.pos)      # [3, n_envs]
    vel = env.env_means(state.masses.vel)
    return torch.cat([pos, vel], dim=0).T      # [n_envs, 6]


def make_observe(com: bool = True, mass_indices=None,
                 contact_eps: Optional[float] = None):
    """Build an ``observe(state, env)`` callback from preset parts.

    com : include the per-env COM position + velocity (6 features).
    mass_indices : template-scene mass indices whose per-env position and
        velocity are observed (len(idx) * 6 features) -- e.g. feet and
        head of a walker.  Indices are into ONE env's masses; the same
        subset is read from every packed copy.
    contact_eps : if set, one feature per global contact plane: the
        fraction of the env's masses within ``contact_eps`` of the plane
        surface (signed distance < eps) -- cheap contact flags for
        locomotion tasks.

    Feature order: [com? 6 | masses k*6 | contacts n_planes].
    """
    idx = None if mass_indices is None else np.asarray(mass_indices,
                                                       np.int64)
    # (device, n_envs, n_per_env) -> [n_envs, k] lane tensor, made once
    # for each env shape the callback is used with
    lanes_on = {}

    def observe(state, env):
        parts = []
        pos = state.masses.pos
        if com:
            parts.append(env.env_means(pos).T)
            parts.append(env.env_means(state.masses.vel).T)
        if idx is not None:
            key = (pos.device, env.n_envs, env.n_per_env)
            lanes = lanes_on.get(key)
            if lanes is None:
                lanes = lanes_on[key] = torch.as_tensor(
                    np.arange(env.n_envs)[:, None] * env.n_per_env
                    + idx[None, :], device=pos.device)
            for field in (pos, state.masses.vel):
                sub = field[:, lanes]                     # [3, n_envs, k]
                parts.append(sub.permute(1, 2, 0).reshape(env.n_envs, -1))
        if contact_eps is not None:
            g = state.gcon
            for p in range(env.shape.n_planes):
                disp = (torch.einsum("c,cn->n", g.plane_normal[p], pos)
                        - g.plane_offset[p])
                near = (disp < contact_eps) & state.masses.valid
                parts.append(env.env_means(near.to(pos.dtype))[:, None])
        return torch.cat(parts, dim=1)

    return observe


def _com_x_progress(prev, state, env):
    return (env.env_means(state.masses.pos)[0]
            - env.env_means(prev.masses.pos)[0])   # [n_envs]


def walker_env(n_envs: int = 256, control_dt: float = 0.05, n: int = 3,
               omega: float = 6.0, k: float = 2000.0, log_actions=False,
               config=None, **episode_kwargs) -> BatchedEnv:
    """The flagship locomotion benchmark: a batch of breathing-gait walkers
    on a friction plane (models.walker physics; BASELINE config 4/5).

    Action space: [n_envs] gait-frequency multipliers, clipped to
    [0.25, 4.0] and applied to every breathing spring's omega -- continuous,
    bounded, and directly controls the gait.  Reward: COM x-progress per
    control step (walking direction is -x for this actuation pattern, so
    learning to stand still is also visible as reward ~ 0).

    ``log_actions=True``: actions are LOG frequency multipliers
    (exp-mapped before the clip).  Frequency is a geometric quantity;
    for policy networks this centers the initial (zero-mean) policy at
    multiplier 1.0, where the JAX package measured a usable reward
    gradient (its travel-vs-scale sweep: 0.25 -> +0.161 m/s, 1.0 -> -0.054,
    2.0 -> -0.024, 3.0+ -> ~0); a linear [0.25, 4] squash centers at ~2.1,
    on that plateau.

    The action writes omega per env, so each control step runs with
    omega per lane (``BatchedEnv.step_shape``).
    """
    from . import Simulation, SimConfig, Vec, models

    src = Simulation(config or SimConfig())
    models.walker(src, size=0.8, n=n, k=k, omega=omega)
    src.createPlane(Vec(0, 0, 1), 0, 0.5, 0.7)
    src.setGlobalAcceleration(Vec(0, 0, -9.8))
    src.setTimeStep(1e-4)

    def apply_action(state, action, env):
        # accept [n_envs] or [n_envs, 1] (policy networks with act_dim=1
        # emit the latter)
        om = state.stencil.omega
        scale = torch.as_tensor(action, dtype=om.dtype,
                                device=om.device).reshape(-1)
        if log_actions:
            scale = torch.exp(scale)
        scale = torch.clamp(scale, 0.25, 4.0)
        per_lane = scale[env.env_of_lane()]                # [N]
        base = env._state0.stencil.omega                   # [F, N] template
        st = dataclasses.replace(state.stencil,
                                 omega=base * per_lane[None, :])
        return dataclasses.replace(state, stencil=st)

    return BatchedEnv(src, n_envs, control_dt=control_dt,
                      apply_action=apply_action, **episode_kwargs)


def _targets(target, like: torch.Tensor) -> torch.Tensor:
    """The targets as the JAX package holds them (f32), in ``like``'s
    dtype and device."""
    return torch.tensor(target, dtype=torch.float32).to(like)


def pusher_env(n_envs: int = 256, control_dt: float = 0.05,
               target=(1.0, 0.0), f_max: float = 1.5,
               config=None, **episode_kwargs) -> BatchedEnv:
    """Classic-control flavored: push a soft cube to a target point.

    Action [n_envs, 2]: a horizontal force (fx, fy), clipped to +-f_max,
    applied as the PERSISTENT EXTERNAL FORCE on every mass of the env's
    cube (the second action mechanism next to walker_env's per-spring
    omega: per-mass continuous state).  Reward: negative COM distance to
    ``target`` in the (x, y) plane, so returns increase as envs learn to
    push toward it.
    """
    from . import Simulation, SimConfig, Vec

    src = Simulation(config or SimConfig())
    cube = src.createCube(Vec(0, 0, 0.25), 0.4)
    cube.setSpringConstants(2000.0)
    src.createPlane(Vec(0, 0, 1), 0, 0.3, 0.4)
    src.setGlobalAcceleration(Vec(0, 0, -9.8))
    src.setTimeStep(1e-4)

    def apply_action(state, action, env):
        pos = state.masses.pos
        a = torch.clamp(torch.as_tensor(action, dtype=pos.dtype,
                                        device=pos.device),
                        -f_max, f_max)                     # [n_envs, 2]
        per_lane = a[env.env_of_lane()]                    # [N, 2]
        ef = torch.cat([per_lane.T, torch.zeros_like(per_lane[:, :1]).T],
                       dim=0)                              # [3, N]
        return dataclasses.replace(
            state, masses=dataclasses.replace(state.masses,
                                              extern_force=ef))

    def reward(prev, state, env):
        com = env.env_means(state.masses.pos)              # [3, n_envs]
        tgt = _targets(target, com)
        return -torch.linalg.norm(com[:2].T - tgt[None, :], dim=1)

    return BatchedEnv(src, n_envs, control_dt=control_dt,
                      apply_action=apply_action, reward=reward,
                      **episode_kwargs)


def pusher2_env(n_envs: int = 256, control_dt: float = 0.05,
                targets=((1.0, 0.5), (-1.0, -0.5)), f_max: float = 1.5,
                config=None, **episode_kwargs) -> BatchedEnv:
    """TWO soft cubes per env, each pushed to its own target: the
    multi-dimensional-action PPO benchmark (act_dim = 4).

    Action [n_envs, 4] = (fx1, fy1, fx2, fy2), clipped to +-f_max and
    applied as the persistent external force on the corresponding cube's
    masses -- the policy must route force components to the right body
    from the observation (per-cube COM/velocity relative to its target,
    8-D), a genuine joint credit-assignment problem over 4 continuous
    action dimensions rather than two independent scalars.  Reward:
    -(dist1 + dist2), dense per control step like pusher_env.

    The cubes share no springs/magnets, so their dynamics are
    independent; the COUPLING is entirely in the shared policy network
    and the joint PPO update.
    """
    from . import Simulation, SimConfig, Vec

    src = Simulation(config or SimConfig())
    cubes = []
    for cx in (-0.35, 0.35):
        cube = src.createCube(Vec(cx, 0, 0.25), 0.4)
        cube.setSpringConstants(2000.0)
        cubes.append(cube)
    src.createPlane(Vec(0, 0, 1), 0, 0.3, 0.4)
    src.setGlobalAcceleration(Vec(0, 0, -9.8))
    src.setTimeStep(1e-4)
    n_t = src._store.n_masses
    body_t = np.zeros(n_t, np.int32)
    body_t[np.asarray(cubes[1]._mass_idx)] = 1
    idx0 = torch.as_tensor(np.asarray(cubes[0]._mass_idx))
    idx1 = torch.as_tensor(np.asarray(cubes[1]._mass_idx))
    made = {}           # the env's [N] body of each lane, made once

    def body_of_lane(env):
        bd = made.get(env)
        if bd is None:
            lane = np.arange(env.shape.n_masses, dtype=np.int64)
            bd = made[env] = torch.as_tensor(
                body_t[lane % n_t], device=env.env_of_lane().device)
        return bd

    def body_means(x, env, idx):
        """Per-env mean of x over one cube's template-mass subset."""
        e, n = env.n_envs, env.n_per_env
        per = x[..., : e * n].reshape(*x.shape[:-1], e, n)
        return per[..., idx.to(x.device)].mean(dim=-1)     # [..., e]

    def apply_action(state, action, env):
        pos = state.masses.pos
        a = torch.clamp(torch.as_tensor(action, dtype=pos.dtype,
                                        device=pos.device),
                        -f_max, f_max)                     # [n_envs, 4]
        ev = env.env_of_lane()                             # [N]
        bd = body_of_lane(env)                             # [N]
        fx = torch.where(bd == 0, a[ev, 0], a[ev, 2])
        fy = torch.where(bd == 0, a[ev, 1], a[ev, 3])
        ef = torch.stack([fx, fy, torch.zeros_like(fx)])   # [3, N]
        return dataclasses.replace(
            state, masses=dataclasses.replace(state.masses,
                                              extern_force=ef))

    def com_err(state, env):
        """[n_envs, 2, 2]: per-cube COM (x, y) minus its target."""
        pos = state.masses.pos
        tgt = _targets(targets, pos)                       # [2, 2]
        c0 = body_means(pos[:2], env, idx0).T              # [e, 2]
        c1 = body_means(pos[:2], env, idx1).T
        return torch.stack([c0 - tgt[0][None, :],
                            c1 - tgt[1][None, :]], dim=1)

    def observe(state, env):
        err = com_err(state, env)                          # [e, 2, 2]
        v0 = body_means(state.masses.vel[:2], env, idx0).T
        v1 = body_means(state.masses.vel[:2], env, idx1).T
        return torch.cat([err[:, 0], v0, err[:, 1], v1], dim=1)

    def reward(prev, state, env):
        err = com_err(state, env)
        return -(torch.linalg.norm(err[:, 0], dim=1)
                 + torch.linalg.norm(err[:, 1], dim=1))

    return BatchedEnv(src, n_envs, control_dt=control_dt,
                      apply_action=apply_action, observe=observe,
                      reward=reward, **episode_kwargs)
