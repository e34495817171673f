"""Batched multi-agent simulation: a vmap over independent scenes (the
counterpart of ``titan_tpu/parallel/batched.py``).

This module is the vmap formulation of the north-star RL configuration
(BASELINE.json config 5: "1024 vmapped independent robots with per-env
parameter sweeps"): independent scenes with fully per-env parameters,
including scene globals such as gravity, every one a leaf with a leading
env axis.  As in the JAX package, it maps the plain single-scene step
(``ops/step.py::build_step_fn`` of ``xla_only_shape``), not a kernel:
``torch.func.vmap`` over it, one chain of batched PyTorch operations a
step, counted in ``ops.step.run_eager.steps``.  That is this path's design,
not a fallback.  For identical scene topologies prefer
``parallel.replicate_scene`` (flat.py), which packs the batch into ONE
stencil scene stepped by the fused (or tiled) CUDA kernels; use this path
for per-env scene globals, or small batches.

The multi-device placement (``shard_batched_state``, a mesh) is ROADMAP
A9 and not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from ..ops.step import build_step_fn, run_eager
from ..state import SceneShape, SimState, xla_only_shape


def make_batched_state(state: SimState, n_envs: int) -> SimState:
    """Tile one scene's state into a batch with a leading env axis.

    Every env gets its own storage (a copy, not an ``expand`` view), so a
    write to one env's leaf reaches no other env.  Per-env variation
    (initial conditions, spring constants, actuation phases...) is then an
    update of the batched leaves, e.g. ``state.stencil.k[env] *= 2`` or
    ``BatchedScenes.randomize``."""
    return pytree.tree_map(
        lambda x: x.unsqueeze(0).repeat((n_envs,) + (1,) * x.dim()), state)


def build_batched_step(shape: SceneShape) -> Callable[[SimState], SimState]:
    """vmap of the single-scene step over the leading env axis."""
    return torch.func.vmap(build_step_fn(xla_only_shape(shape)))


def _env(state: SimState, e: int) -> SimState:
    """Env ``e``'s state out of a batched one."""
    return pytree.tree_map(lambda x: x[e], state)


@dataclasses.dataclass
class BatchedScenes:
    """Convenience wrapper: N independent copies of a scene, stepped together.

    Build a scene through the normal ``Simulation`` API (don't call start()),
    then wrap it:

        sim = titan.Simulation()
        sim.createLattice(...); sim.createPlane(...)
        envs = BatchedScenes.from_simulation(sim, n_envs=1024)
        envs.run(steps=1000)
        pos = envs.positions()        # [n_envs, 3, N]
    """

    shape: SceneShape
    state: SimState
    n_envs: int
    _step: Callable = None

    @classmethod
    def from_simulation(cls, sim, n_envs: int, mesh=None) -> "BatchedScenes":
        """The batch on ``sim``'s device (its ``config.device``)."""
        if mesh is not None:
            raise NotImplementedError(
                "BatchedScenes(mesh=...): sharding the env axis over devices "
                "is not ported to titan_tpu_torch yet (ROADMAP A9)")
        sim._T = 0.0
        sim._marshal()
        shape = sim._shape
        return cls(shape=shape, state=make_batched_state(sim._state, n_envs),
                   n_envs=n_envs, _step=build_batched_step(shape))

    def randomize(self, fn: Callable[[SimState, int], SimState],
                  key: int) -> None:
        """Apply a per-env randomizer ``fn(single_env_state, seed)`` to
        each env in turn.  Each env's ``seed`` (a Python int) is drawn from
        a CPU generator seeded with ``key``; ``fn`` seeds its own
        ``torch.Generator`` from it.  The stream is not JAX's."""
        g = torch.Generator().manual_seed(int(key))
        seeds = torch.randint(0, 2 ** 62, (self.n_envs,), generator=g,
                              dtype=torch.int64).tolist()
        envs = [fn(_env(self.state, e), s) for e, s in enumerate(seeds)]
        self.state = pytree.tree_map(lambda *xs: torch.stack(xs), *envs)

    def run(self, steps: int) -> None:
        self.state = run_eager(self._step, self.state, int(steps))

    def positions(self) -> torch.Tensor:
        return self.state.masses.pos

    def velocities(self) -> torch.Tensor:
        return self.state.masses.vel
