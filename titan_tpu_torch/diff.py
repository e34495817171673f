"""Differentiable simulation: gradients through the physics.

Counterpart of ``titan_tpu/diff.py``.  Uses: trajectory optimisation,
system identification (fit k / damping to observations), policy gradients
through the simulator.

    shape, state = scene(sim)                      # an un-started Simulation
    final = grad_rollout(shape, state, 200)        # differentiable
    loss = some_fn(final.masses.pos)
    grads = torch.autograd.grad(loss, [state.stencil.k])

Set ``requires_grad`` on the state's tensors to differentiate with respect
to them (``ops.adjoint.LEAVES`` lists what the adjoints differentiate: the
masses', the stencil families' and the remainder springs' parameters).  Routes:

- ``rollout``: autograd through the eager step, every input
  differentiable; ``checkpoint_every`` recomputes blocks of steps in the
  backward (``torch.utils.checkpoint``) so that long rollouts fit.
- ``fast_rollout``: per segment, the fused chunk forward and a backward
  that recomputes the segment through the eager step and differentiates it.
- ``adjoint_rollout`` (``ops/adjoint.py``): both passes on the card's
  kernels, the fused step forward, the trace replay and the reverse sweep
  of ``csrc/adjoint.cu``.
- ``tiled_adjoint_rollout`` (``ops/adjoint_tiled.py``): the same for
  scenes past the fused adjoint's residency rule (the 100^3 stress
  config): the tiled step forward that ``Simulation`` runs there, the
  trace replay and the reverse sweep of ``csrc/tiled_adjoint.cu``.
- ``grad_rollout``: the route ``grad_route`` picks, as the JAX package's
  ``grad_rollout`` picks it; ``fast_rollout`` with a one-line warning
  naming both adjoints' reasons where neither accepts the scene.

Every eager step here is built from ``xla_only_shape(shape)``: the grid
magnet kernel has no backward, so a differentiated step takes the binned
PyTorch pass instead.

The Euler velocity clamp and the contact / friction selects are piecewise
differentiable (subgradients at the switch points).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from .ops.adjoint import (LEAVES, adjoint_reject_reason,  # noqa: F401
                          adjoint_resident_bytes, adjoint_rollout,
                          adjoint_supported, leaves_of, segment_outputs,
                          state_from_outputs, with_leaves)
from .ops.adjoint_tiled import (tiled_adjoint_reject_reason,
                                tiled_adjoint_rollout)
from .ops.step import build_chunk_fn, build_step_fn, fits_fused, run_eager
from .runtime.logging import get_logger
from .state import SceneShape, SimState, xla_only_shape


def scene(sim) -> Tuple[SceneShape, SimState]:
    """Marshal an un-started Simulation into (static shape, state)."""
    sim._T = getattr(sim, "_T", 0.0) or 0.0
    sim._marshal()
    return sim._shape, sim._state


def rollout(shape: SceneShape, state: SimState, n_steps: int,
            checkpoint_every: Optional[int] = None) -> SimState:
    """``n_steps`` eager steps, differentiable; returns the final state."""
    step = build_step_fn(xla_only_shape(shape))
    if not checkpoint_every:
        return run_eager(step, state, n_steps)
    if n_steps % checkpoint_every:
        raise ValueError(f"n_steps={n_steps} not divisible by "
                         f"checkpoint_every={checkpoint_every}")
    for _ in range(n_steps // checkpoint_every):
        state = checkpoint(run_eager, step, state, checkpoint_every,
                           use_reentrant=False)
    return state


class _FastSegment(torch.autograd.Function):
    """One segment: the chunk forward (fused kernel on the card),
    backward by recomputing the segment through the eager step
    (``titan_tpu/diff.py::_fast_segment_cached``)."""

    @staticmethod
    def forward(ctx, shape, seg, chunk, state, *leaves):
        out = chunk(with_leaves(state, leaves), seg)
        ctx.shape, ctx.seg, ctx.state = shape, seg, state
        ctx.save_for_backward(*leaves)
        outs = segment_outputs(shape, out)
        ctx.mark_non_differentiable(*outs[-2:])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, gpos, gvel, gacc, grest, grem, _gT, _gt):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = run_eager(build_step_fn(xla_only_shape(ctx.shape)),
                            with_leaves(ctx.state, leaves), ctx.seg)
            grads = torch.autograd.grad(
                [out.masses.pos, out.masses.vel, out.masses.acc,
                 out.stencil.rest, out.springs.rest], leaves,
                [gpos, gvel, gacc, grest, grem], allow_unused=True)
        return (None, None, None, None) + tuple(grads)


def _fast_segments(shape: SceneShape, seg: int, state: SimState, count: int):
    """``count`` fast segments of ``seg`` steps; yields each one's output
    state."""
    chunk = build_chunk_fn(shape)
    for _ in range(count):
        state = state_from_outputs(state, _FastSegment.apply(
            shape, seg, chunk, state, *leaves_of(state)))
        yield state


def fast_rollout(shape: SceneShape, state: SimState, n_steps: int,
                 segment: Optional[int] = None) -> SimState:
    """Differentiable rollout whose forward runs the fused chunk: each
    ``segment``-step block keeps only its input state and, in the
    backward, recomputes itself through the eager step and differentiates
    that.  The backward linearises the eager recompute, whose values
    differ from the kernel's by f32 rounding."""
    seg = segment or n_steps
    if n_steps % seg:
        raise ValueError(f"n_steps={n_steps} not divisible by segment={seg}")
    for state in _fast_segments(shape, seg, state, n_steps // seg):
        pass
    return state


def grad_route(shape: SceneShape):
    """(route, reason): which differentiable rollout ``grad_rollout`` runs,
    ``"adjoint"``, ``"tiled_adjoint"`` or ``"fast"``, and for ``"fast"``
    both adjoints' reasons (else None).  As the JAX package routes
    (``titan_tpu/diff.py:154-160``): the fused adjoint where it accepts the
    scene and the scene fits the reference's rule (``step.fits_fused``:
    its remainder selectors, and ``adjoint_resident_bytes`` under
    ``RESIDENT_BUDGET``), else the tiled adjoint where it accepts the
    scene, else the fused adjoint where it accepts it (its card kernels
    have no size cap, as ``chunk_route`` keeps the fused step for large
    scenes), else ``fast_rollout``."""
    r_adj = adjoint_reject_reason(shape)
    if r_adj is None and fits_fused(shape, adjoint_resident_bytes(shape)):
        return "adjoint", None
    r_tiled = tiled_adjoint_reject_reason(shape)
    if r_tiled is None:
        return "tiled_adjoint", None
    if r_adj is None:
        return "adjoint", None
    return "fast", f"fused adjoint: {r_adj}; tiled adjoint: {r_tiled}"


def grad_rollout(shape: SceneShape, state: SimState, n_steps: int,
                 segment: Optional[int] = None, mesh=None) -> SimState:
    """The best differentiable rollout for the scene, by ``grad_route``:
    ``adjoint_rollout``, ``tiled_adjoint_rollout``, or ``fast_rollout``
    with a one-line warning naming the envelope conditions that failed.
    On the card an adjoint route runs its kernels or raises."""
    if mesh is not None:
        raise NotImplementedError(
            "grad_rollout(mesh=...): the distributed adjoint is not ported "
            "to titan_tpu_torch yet (ROADMAP A9, multi-device)")
    route, reason = grad_route(shape)
    if route == "adjoint":
        return adjoint_rollout(shape, state, n_steps, segment=segment)
    if route == "tiled_adjoint":
        return tiled_adjoint_rollout(shape, state, n_steps, segment=segment)
    get_logger().warning(
        "grad_rollout: scene outside both adjoint envelopes (%s); falling "
        "back to fast_rollout's eager-recompute backward", reason)
    return fast_rollout(shape, state, n_steps, segment=segment)


def fast_trajectory(shape: SceneShape, state: SimState, n_steps: int,
                    every: int = 1):
    """``trajectory`` with the fast forward: positions sampled every
    ``every`` steps, each block between samples a fast segment.  Returns
    (final state, positions [n_steps // every, 3, N])."""
    if n_steps % every:
        raise ValueError(f"n_steps={n_steps} not divisible by every={every}")
    traj = []
    for state in _fast_segments(shape, every, state, n_steps // every):
        traj.append(state.masses.pos)
    return state, torch.stack(traj)


def trajectory(shape: SceneShape, state: SimState, n_steps: int,
               every: int = 1):
    """Differentiable eager rollout that also returns the positions every
    ``every`` steps, stacked [n_steps // every, 3, N]."""
    if n_steps % every:
        raise ValueError(f"n_steps={n_steps} not divisible by every={every}")
    step = build_step_fn(xla_only_shape(shape))
    traj = []
    for _ in range(n_steps // every):
        state = run_eager(step, state, every)
        traj.append(state.masses.pos)
    return state, torch.stack(traj)
