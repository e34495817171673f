"""Time integration schemes (counterpart of ``titan_tpu/ops/integrators.py``).

Reference: the #ifdef RK2 / #elif VERLET / #else branches of
massForcesAndUpdate (sim.cu:1335-1363) and the RK2 double-pass step loop
(sim.cu:1778-1799).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def euler(pos: Tensor, vel: Tensor, f: Tensor, m: Tensor, dt: Tensor,
          velocity_clamp: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """Semi-implicit Euler with the reference's unit-speed clamp
    (sim.cu:1355-1362): acc = f/m; vel += acc dt; if |vel| > 1: vel /= |vel|;
    pos += vel dt."""
    acc = f / m
    vel = vel + acc * dt
    if velocity_clamp:
        sq = torch.sum(vel * vel, dim=0)
        vn = torch.sqrt(torch.where(sq > 0, sq, 1.0))
        vel = torch.where((sq > 0) & (vn > 1.0), vel / vn, vel)
    pos = pos + vel * dt
    return pos, vel, acc


def verlet(pos: Tensor, vel: Tensor, acc_prev: Tensor, f: Tensor, m: Tensor,
           dt: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The reference's 'Verlet' scheme (sim.cu:1350-1354):
    vel += 0.5 (acc_prev + f/m) dt; acc = f/m; pos += vel dt + 0.5 acc dt^2."""
    new_acc = f / m
    vel = vel + 0.5 * (acc_prev + new_acc) * dt
    pos = pos + vel * dt + 0.5 * new_acc * dt * dt
    return pos, vel, new_acc


def rk2_half(pos: Tensor, vel: Tensor, f: Tensor, m: Tensor, dt: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """RK2 first pass (sim.cu:1336-1343): midpoint predictor.  Returns
    (pos_half, vel_half, acc); the caller keeps the backups."""
    acc = f / m
    pos_h = pos + 0.5 * vel * dt
    vel_h = vel + 0.5 * acc * dt
    return pos_h, vel_h, acc


def rk2_full(backup_pos: Tensor, backup_vel: Tensor, vel_half: Tensor,
             f_half: Tensor, m: Tensor, dt: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """RK2 second pass (sim.cu:1344-1349): corrector from the backups."""
    acc = f_half / m
    pos = backup_pos + vel_half * dt
    vel = backup_vel + acc * dt
    return pos, vel, acc
