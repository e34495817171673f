"""Throughput counters and profiler hooks (the counterpart of
``titan_tpu/runtime/profiling.py``).

The reference has no profiling beyond a render-rate counter (SURVEY.md
section 5.1).  Here: steps/sec and spring-updates/sec measurement over any
simulation, plus a context manager around ``torch.profiler`` for device
traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch


@dataclasses.dataclass
class ThroughputReport:
    steps: int
    wall_s: float
    n_springs: int
    n_masses: int

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.wall_s

    @property
    def spring_updates_per_sec(self) -> float:
        return self.n_springs * self.steps_per_sec

    @property
    def mass_updates_per_sec(self) -> float:
        return self.n_masses * self.steps_per_sec

    def __str__(self):
        return (f"{self.steps} steps in {self.wall_s:.3f}s: "
                f"{self.steps_per_sec:,.0f} steps/s, "
                f"{self.spring_updates_per_sec:,.0f} spring-updates/s")


def _sync(state) -> None:
    """Wait for the device work that produced ``state``: the card's
    launches return before they finish."""
    dev = state.masses.pos.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_throughput(sim, steps: int = 1000,
                       warmup_steps: int = 100) -> ThroughputReport:
    """Time ``steps`` simulation steps on a (paused or un-started) sim.

    Runs outside the control plane on a private state copy, so the
    simulation's own clock/breakpoints are unaffected.  The chunk runs on
    the simulation's device, and the clock stops after the device has
    finished (``torch.cuda.synchronize``).
    """
    from ..ops.step import build_chunk_fn

    if sim._state is None:
        sim._T = getattr(sim, "_T", 0.0)
        sim._marshal()
    chunk = build_chunk_fn(sim._shape)
    state = chunk(sim._state, warmup_steps)
    _sync(state)
    t0 = time.perf_counter()
    state = chunk(state, steps)
    _sync(state)
    wall = time.perf_counter() - t0
    return ThroughputReport(steps=steps, wall_s=wall,
                            n_springs=sim._store.n_springs,
                            n_masses=sim._store.n_masses)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace (host and card) around a block; the
    timeline is written to ``logdir/trace.json`` (chrome://tracing,
    Perfetto) when the block ends.  ``logdir`` defaults to
    ``titan_torch_trace`` in the temporary directory."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "titan_torch_trace")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
