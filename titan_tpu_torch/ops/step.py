"""The eager step and the chunk dispatch.

Counterpart of ``titan_tpu/ops/step.py``.  ``build_step_fn`` is the plain
PyTorch step (springs -> scatter -> magnets and mass forces -> integrate)
for any scene of this slice, in f32 or f64, on any device.
``build_chunk_fn`` runs whole chunks through the fused step
(``ops/fused_step.py``) or the tiled step (``ops/tiled_step.py``), each the
CUDA kernels on the card and their plain version on the CPU, as
``chunk_route`` picks, and through the eager step loop where neither
accepts the scene, with a warning that names the reasons.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..config import Integrator
from ..state import MassState, SceneShape, SimState
from . import forces as F
from . import integrators as I
from .magnets import (binned_magnet_forces, magnet_receiver_idx,
                      pairwise_magnet_field)
from .magnets_grid import grid_magnet_forces, grid_magnet_forces_plain


def magnet_route(shape: SceneShape, device: torch.device,
                 fused: bool = False, plain: bool = False) -> str:
    """The magnet field's route; every magnet pass of the port is picked
    here.  ``fused`` is the fused step's pass (otherwise the eager step's),
    ``plain`` the fused step's plain version.

    - ``"pairwise"``: the pairwise field kernel (``csrc/magnets.cu``), for
      the fused step on an unbinned scene;
    - ``"all_pairs"``: ``forces.magnet_forces``, its plain version, for the
      eager step on an unbinned scene on either device;
    - ``"grid"``: the grid field kernel (``csrc/magnets_grid.cu``), for the
      fused step on every binned scene on the card (it is f32 by its
      envelope, and the kernel needs no cell-cap layout and computes a
      compacted receiver set's field exactly), and for the eager step where
      the shape sets ``magnet_grid``, as ``titan_tpu/ops/step.py`` picks
      the grid kernel for its XLA step;
    - ``"grid_plain"``: the grid kernel's plain version, for the fused
      step's plain version on the card;
    - ``"binned"``: the binned PyTorch pass, for every binned scene on the
      CPU (as the JAX package off the TPU) and for the eager step on the
      card where ``magnet_grid`` is off: f64, the JAX package's kernel
      policy, or a differentiated step (``state.xla_only_shape``).

    The eager step never reaches the pairwise kernel, and reaches the grid
    kernel only through ``magnet_grid``, so a step built from
    ``xla_only_shape`` is differentiable: neither kernel has a backward."""
    if not shape.magnet_binned:
        return "pairwise" if fused and not plain else "all_pairs"
    if device.type == "cuda" and (fused or shape.magnet_grid):
        return "grid_plain" if plain else "grid"
    return "binned"


def magnet_pass(masses: MassState, shape: SceneShape,
                ridx: Optional[torch.Tensor] = None, fused: bool = False,
                plain: bool = False,
                params: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The magnet field [3, N] by ``magnet_route``.  ``ridx`` is the
    chunk's hoisted receiver set for the binned pass
    (``magnets.magnet_receiver_idx``), ``params`` the pairwise kernel's
    folded parameters (``magnets.pairwise_params``), each made once per
    chunk where the caller has it."""
    cut = shape.config.magnet_cutoff
    route = magnet_route(shape, masses.pos.device, fused, plain)
    if route == "pairwise":
        return pairwise_magnet_field(masses, cut, params)
    if route == "all_pairs":
        return F.magnet_forces(masses, cut)
    a_cells, cell_cap = shape.magnet_binned
    if route == "grid":
        return grid_magnet_forces(masses, cut, cell_cap)
    if route == "grid_plain":
        return grid_magnet_forces_plain(masses, cut, cell_cap)
    return binned_magnet_forces(masses, cut, a_cells, cell_cap,
                                receivers=shape.magnet_receivers, ridx=ridx)


def chunk_ridx(shape: SceneShape, masses: MassState):
    """The compacted receiver set of a chunk, or None: it changes only at a
    push or re-marshal, so a chunk computes it once
    (``titan_tpu/ops/step.py:232-241``)."""
    if shape.has_magnets and shape.magnet_receivers:
        return magnet_receiver_idx(masses, shape.magnet_receivers)
    return None


def _mass_forces(state: SimState, masses: MassState, f: torch.Tensor,
                 shape: SceneShape, magnet_ridx=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All non-spring forces in the reference order (massForcesAndUpdate,
    sim.cu:1296-1332): magnets, gravity, persistent external force, global
    planes/balls, local constraints, drag.  Constraint planes and
    directions mutate the velocity, which drag and the integrator read.
    Returns (force [3, N], velocity [3, N])."""
    cfg = shape.config
    if shape.has_magnets:
        # fixed masses return before the magnet pass (sim.cu:1292-1298)
        # but still act as sources
        f = f + torch.where(masses.fixed, 0.0,
                            magnet_pass(masses, shape, magnet_ridx))
    f = f + masses.m * state.g[:, None]
    f = f + masses.extern_force
    f = F.apply_global_constraints(
        f, masses, state.gcon, shape.n_planes, shape.n_balls, cfg.normal_coeff,
        plane_friction=shape.plane_friction)
    vel = masses.vel
    caps = local_caps(shape)
    if any(caps):
        f, vel = F.apply_local_constraints(f, vel, masses, state.lcon, caps,
                                           cfg.normal_coeff)
    if shape.has_drag:
        # -C |v|^2 v_hat == -C |v| v (reference sim.cu:1329-1332); the
        # guarded norm keeps reverse mode finite at |v| = 0
        vn = F._safe_norm(torch.sum(vel * vel, dim=0))
        f = f - masses.drag * vn * vel
    return f, vel


def local_caps(shape: SceneShape) -> Tuple[int, int, int, int]:
    """The per-mass local-constraint slot capacities (contact planes,
    balls, constraint planes, directions); all 0 in a scene without
    local constraints."""
    return shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir


def build_step_fn(shape: SceneShape) -> Callable[[SimState], SimState]:
    """The plain single step for a static scene shape."""
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
        def step(state: SimState, magnet_ridx=None) -> SimState:
            # reference RK2 (sim.cu:1778-1799): two spring+mass passes per
            # dt; actuated rest advances in both at the full dt rate
            masses, dt = state.masses, state.dt
            f1, st1, rem1 = spring_pass(state, masses, state.t)
            state = put_rests(state, st1, rem1)
            f1, vel1 = _mass_forces(state, masses, f1, shape, magnet_ridx)
            masses1 = dataclasses.replace(masses, vel=vel1)
            pos_h, vel_h, acc1 = I.rk2_half(masses.pos, vel1, f1, masses.m, dt)
            half = finish(masses1, pos_h, vel_h, acc1, 0.5 * dt)

            f2, st2, rem2 = spring_pass(state, half, state.t + 0.5 * dt)
            state = put_rests(state, st2, rem2)
            f2, vel2 = _mass_forces(state, half, f2, shape, magnet_ridx)
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
        def step(state: SimState, magnet_ridx=None) -> SimState:
            masses, dt = state.masses, state.dt
            f, st_rest, rem_rest = spring_pass(state, masses, state.t)
            state = put_rests(state, st_rest, rem_rest)
            f, vel = _mass_forces(state, masses, f, shape, magnet_ridx)
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


# The TPU's on-chip budget (titan_tpu/ops/pallas_step.py:44): the route
# keeps the reference's threshold between its two kernels.
RESIDENT_BUDGET = 100 * 1024 * 1024
# The TPU fused kernel's cap on its remainder-spring endpoint selectors
# (titan_tpu/ops/pallas_step.py:56): a scene past it takes the tiled
# kernel there, and so it does here.
REM_SEL_BUDGET = 16 * 1024 * 1024


def remainder_selector_bytes(shape: SceneShape) -> int:
    """Bytes of the TPU fused kernel's remainder selectors ([2S, R] row
    and [2S, 128] lane one-hots and two [2S, 128] temporaries, f32;
    ``titan_tpu/ops/pallas_step.py:78-87``); 0 without remainder springs.
    The card's kernels have no selectors: the count is a route rule."""
    if not shape.has_remainder:
        return 0
    return 4 * 2 * shape.n_springs * (shape.n_masses // 128 + 3 * 128)


def resident_bytes(shape: SceneShape) -> int:
    """Bytes the TPU's fused kernel would hold resident in VMEM for this
    scene: the port's copy of ``titan_tpu/ops/pallas_step.py:77-108``, term
    for term, the rule by which the reference sends a scene to its tiled
    kernel: seven [3, N] state planes, the [F, N] family planes, the [1, N]
    per-mass planes (minv, fixed, drag, the magnet parameters and the
    local-constraint slot rows), the body's temporaries and the remainder
    springs' endpoint selectors."""
    n, f = shape.n_masses, len(shape.stencil_deltas)
    rem = remainder_selector_bytes(shape)
    fam = 5 * f + (3 * f if shape.has_actuated else 0)
    sc = 2 + (1 if shape.has_drag else 0) + (5 if shape.has_magnets else 0)
    sc += F.local_slot_rows(local_caps(shape))
    tmp = 3 * 10 if shape.config.integrator is Integrator.RK2 else 3 * 6
    return 4 * n * (3 * 7 + fam + sc) + 4 * n * tmp + rem


def fits_fused(shape: SceneShape, nbytes: int) -> bool:
    """The reference's rule for its fused kernels: the remainder selectors
    within ``REM_SEL_BUDGET`` and ``nbytes`` (the residency of the fused
    step or adjoint) under ``RESIDENT_BUDGET``."""
    return (remainder_selector_bytes(shape) <= REM_SEL_BUDGET
            and nbytes < RESIDENT_BUDGET)


def chunk_route(shape: SceneShape):
    """(route, reason): which chunk runs the scene, ``"fused"``,
    ``"tiled"`` or ``"eager"``, and for the eager loop the reasons both
    kernels refused it (else None).  A scene takes the counterpart of the
    kernel it takes on a TPU (``titan_tpu/ops/step.py:212-230``): the
    fused step where it accepts the scene and the scene fits the
    reference's rule (``fits_fused``: its remainder selectors and
    ``resident_bytes``), else the tiled step where it accepts the scene,
    else the fused step where it accepts the scene (its card kernel has no
    size cap, so a large magnet lattice, or a remainder scene without
    stencil families, stays on a kernel), else the eager loop."""
    from .fused_step import fused_reject_reason
    from .tiled_step import tiled_reject_reason
    r_fused = fused_reject_reason(shape)
    if r_fused is None and fits_fused(shape, resident_bytes(shape)):
        return "fused", None
    r_tiled = tiled_reject_reason(shape)
    if r_tiled is None:
        return "tiled", None
    if r_fused is None:
        return "fused", None
    return "eager", f"fused step: {r_fused}; tiled step: {r_tiled}"


def build_chunk_fn(shape: SceneShape):
    """``chunk(state, n_steps) -> state``: n_steps of stepping by
    ``chunk_route``: ``fused_step.fused_chunk`` or
    ``tiled_step.tiled_chunk`` (each the CUDA kernels for state on the
    card, their plain version for state on the CPU), or the eager step
    loop, with a warning naming the envelope conditions that failed.
    """
    from . import fused_step, tiled_step
    route, reason = chunk_route(shape)
    if route == "fused":
        return lambda state, n_steps: fused_step.fused_chunk(
            shape, state, n_steps)
    if route == "tiled":
        return lambda state, n_steps: tiled_step.tiled_chunk(
            shape, state, n_steps)
    from ..runtime.logging import get_logger
    get_logger().warning(
        "scene is outside the step kernels' envelopes; falling back to the "
        "eager PyTorch step loop (one chain of small kernels per step, "
        "much slower on the card): %s.", reason)
    step = build_step_fn(shape)

    def chunk(state, n_steps):
        ridx = chunk_ridx(shape, state.masses)
        return run_eager(lambda s: step(s, magnet_ridx=ridx), state,
                         int(n_steps))
    return chunk
