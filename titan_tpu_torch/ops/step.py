"""The eager step and the chunk dispatch.

Counterpart of ``titan_tpu/ops/step.py``.  ``build_step_fn`` is the plain
PyTorch step (springs -> scatter -> mass forces -> integrate) for any scene
of this slice, in f32 or f64, on any device.  ``build_chunk_fn`` runs whole
chunks through the fused step (``ops/fused_step.py``: the CUDA kernel on the
card, its plain version on the CPU) whenever the scene is inside its
envelope, and through the eager step loop otherwise, with a warning that
names the reason.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ..config import Integrator
from ..state import MassState, SceneShape, SimState
from . import forces as F
from . import integrators as I


def _mass_forces(state: SimState, masses: MassState, f: torch.Tensor,
                 shape: SceneShape) -> Tuple[torch.Tensor, torch.Tensor]:
    """All non-spring forces in the reference order (massForcesAndUpdate,
    sim.cu:1296-1332): gravity, persistent external force, global
    planes/balls, drag.  Returns (force [3, N], velocity [3, N])."""
    cfg = shape.config
    f = f + masses.m * state.g[:, None]
    f = f + masses.extern_force
    f = F.apply_global_constraints(
        f, masses, state.gcon, shape.n_planes, shape.n_balls, cfg.normal_coeff,
        plane_friction=shape.plane_friction)
    vel = masses.vel
    if shape.has_drag:
        # -C |v|^2 v_hat == -C |v| v (reference sim.cu:1329-1332); the
        # guarded norm keeps reverse mode finite at |v| = 0
        vn = F._safe_norm(torch.sum(vel * vel, dim=0))
        f = f - masses.drag * vn * vel
    return f, vel


def check_ported(shape: SceneShape) -> None:
    """Raise for the scene features later slices of the port bring."""
    if shape.has_magnets:
        raise NotImplementedError(
            "magnets (nonzero max_mag_force or rad) are not ported to "
            "titan_tpu_torch yet; they come with the binned-magnet slice "
            "(ROADMAP A4) and the fused kernel's magnet envelope (B1)")
    if any((shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir)):
        raise NotImplementedError(
            "per-mass local constraints are not ported to titan_tpu_torch "
            "yet; they come with the fused kernel's next envelope items "
            "(ROADMAP B1)")


def build_step_fn(shape: SceneShape) -> Callable[[SimState], SimState]:
    """The plain single step for a static scene shape."""
    check_ported(shape)
    cfg = shape.config

    def spring_pass(state: SimState, masses: MassState, t):
        """Stencil families + remainder; (force, stencil rest, rem rest)."""
        f = torch.zeros_like(masses.pos)
        st_rest, rem_rest = state.stencil.rest, state.springs.rest
        if shape.stencil_deltas:
            f, st_rest = F.stencil_spring_forces(
                masses, state.stencil, shape.stencil_deltas, t, state.dt,
                shape.has_breathing, has_damping=shape.has_damping,
                all_valid=shape.all_valid)
        if shape.has_remainder:
            f_sp, rem_rest = F.spring_forces(masses, state.springs, t,
                                             state.dt, shape.has_breathing)
            f = f + F.scatter_spring_forces(f_sp, state.topo, masses.fixed,
                                            cfg.scatter)
        # spring forces are never applied to fixed masses (sim.cu:1187-1193)
        return torch.where(masses.fixed, 0.0, f), st_rest, rem_rest

    def put_rests(state: SimState, st_rest, rem_rest) -> SimState:
        return dataclasses.replace(
            state,
            stencil=dataclasses.replace(state.stencil, rest=st_rest),
            springs=dataclasses.replace(state.springs, rest=rem_rest))

    def finish(masses: MassState, pos, vel, acc, dt) -> MassState:
        """Write back the integration, freezing fixed and invalid masses
        (sim.cu:1292-1294; invalid rows are frozen too)."""
        move = masses.valid & ~masses.fixed
        new = dataclasses.replace(
            masses,
            pos=torch.where(move, pos, masses.pos),
            vel=torch.where(move, vel, masses.vel),
            acc=torch.where(move, acc, masses.acc),
            T=masses.T + torch.where(move, dt, 0.0))
        if not cfg.persistent_extern_force:
            # strict reference parity: extern_force zeroed after each step
            # for non-fixed masses (sim.cu:1365)
            new = dataclasses.replace(new, extern_force=torch.where(
                move, 0.0, masses.extern_force))
        return new

    if cfg.integrator is Integrator.RK2:
        def step(state: SimState) -> SimState:
            # reference RK2 (sim.cu:1778-1799): two spring+mass passes per
            # dt; actuated rest advances in both at the full dt rate
            masses, dt = state.masses, state.dt
            f1, st1, rem1 = spring_pass(state, masses, state.t)
            state = put_rests(state, st1, rem1)
            f1, vel1 = _mass_forces(state, masses, f1, shape)
            masses1 = dataclasses.replace(masses, vel=vel1)
            pos_h, vel_h, acc1 = I.rk2_half(masses.pos, vel1, f1, masses.m, dt)
            half = finish(masses1, pos_h, vel_h, acc1, 0.5 * dt)

            f2, st2, rem2 = spring_pass(state, half, state.t + 0.5 * dt)
            state = put_rests(state, st2, rem2)
            f2, vel2 = _mass_forces(state, half, f2, shape)
            pos, vel, acc2 = I.rk2_full(masses.pos, masses1.vel, vel2, f2,
                                        masses.m, dt)
            out = finish(dataclasses.replace(half, vel=vel2), pos, vel, acc2,
                         0.5 * dt)
            move = masses.valid & ~masses.fixed
            out = dataclasses.replace(
                out, pos=torch.where(move, out.pos, masses.pos),
                vel=torch.where(move, out.vel, masses.vel))
            return dataclasses.replace(state, masses=out, t=state.t + dt)
    else:
        def step(state: SimState) -> SimState:
            masses, dt = state.masses, state.dt
            f, st_rest, rem_rest = spring_pass(state, masses, state.t)
            state = put_rests(state, st_rest, rem_rest)
            f, vel = _mass_forces(state, masses, f, shape)
            if cfg.integrator is Integrator.VERLET:
                pos, vel, acc = I.verlet(masses.pos, vel, masses.acc, f,
                                         masses.m, dt)
            else:
                pos, vel, acc = I.euler(masses.pos, vel, f, masses.m, dt,
                                        cfg.velocity_clamp)
            return dataclasses.replace(state, masses=finish(
                masses, pos, vel, acc, dt), t=state.t + dt)

    return step


def run_eager(step, state: SimState, n_steps: int) -> SimState:
    """``n_steps`` of the eager step; counts them in ``run_eager.steps``
    (the main path must leave it at 0)."""
    for _ in range(n_steps):
        state = step(state)
    run_eager.steps += n_steps
    return state


run_eager.steps = 0


def build_chunk_fn(shape: SceneShape):
    """``chunk(state, n_steps) -> state``: n_steps of stepping.

    Scenes inside the fused step's envelope run ``fused_step.fused_chunk``
    (the CUDA kernel for state on the card, its plain version for state on
    the CPU); every other scene runs the eager step loop, with a warning
    naming the envelope condition that failed.
    """
    from .fused_step import fused_chunk, fused_reject_reason
    reason = fused_reject_reason(shape)
    if reason is None:
        return lambda state, n_steps: fused_chunk(shape, state, n_steps)
    from ..runtime.logging import get_logger
    get_logger().warning(
        "scene is outside the fused step kernel's envelope; falling back to "
        "the eager PyTorch step loop (one chain of small kernels per step, "
        "much slower on the card): %s.", reason)
    step = build_step_fn(shape)
    return lambda state, n_steps: run_eager(step, state, int(n_steps))
