#!/usr/bin/env python3
"""The gradient path's forward + backward time at 43^3, two checkouts in
turns.

    python3 scripts/cuda_grad_path_ab.py OLD_ROOT NEW_ROOT

Needs one NVIDIA GPU.  Runs OLD, NEW, NEW, OLD, each in a process of its
own that imports titan_tpu_torch and chip_smoke.py from that checkout,
builds its kernels, lands chip_smoke.py's 43^3 bench scene on its plane
with fused_chunk (35,000 steps, t = 3.5 s) and then times
chip_smoke.run_grad through diff.grad_rollout (200 steps in segments of
100, forward + backward) on the host clock, median of 7, and prints one
profiled run (chip_smoke.profile_grad_path: the device's busy share and
the host-to-device copies).  Each run ends with one JSON line.  It checks
nothing and exits 0 whatever the times are.
"""

import json
import subprocess
import sys
import time

STEPS, SEG, REPS = 200, 100, 7


def one(root: str) -> None:
    import torch
    sys.path.insert(0, root)
    import chip_smoke as cs
    import titan_tpu_torch as titan
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import fused_step

    cs.build_kernels(("fused_step", "adjoint"))
    sim = cs.bench_scene(titan)
    sim._T = 0.0
    sim._marshal()
    shape = sim._shape
    state = fused_step.fused_chunk(shape, sim._state, 35000)

    def rollout(sh, st, k):
        return diff.grad_rollout(sh, st, k, segment=SEG)

    cs.run_grad(shape, state, rollout, STEPS)
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.run_grad(shape, state, rollout, STEPS)
        times.append((time.perf_counter() - t0) / STEPS * 1e6)
    cs.profile_grad_path(root, shape, state)
    print(json.dumps({"root": root, "fwd_bwd_us_per_step": sorted(times)[
        REPS // 2], "all_us_per_step": times}))


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return 0
    old, new = sys.argv[1:3]
    for root in (old, new, new, old):
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, timeout=600)
        print(out.stdout + out.stderr[-2000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
