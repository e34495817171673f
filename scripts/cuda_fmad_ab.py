#!/usr/bin/env python3
"""The fused CUDA kernel built with and without multiply-add contraction.

    python3 scripts/cuda_fmad_ab.py

Needs one NVIDIA GPU.  Builds titan_tpu_torch/csrc/fused_step.cu twice:
with the port's flags (``-fmad=false``: every multiply and add rounds on its
own, as in the plain PyTorch version) and with the same flags less
``-fmad=false`` (nvcc's default, contraction into FMA on).  For each build
it prints, per small scene of chip_smoke.py (100 steps) and for the landed
43^3 and 20^3 main-path scenes (200 steps), the max |kernel - plain| of each
field and whether it is within chip_smoke.py's tolerance.  Then it times
the 43^3 chunk from its landed state in turns (off, on, on, off) with CUDA
events.  It checks nothing and exits 0 whatever the errors are.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cuda_fmad_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import titan_tpu_torch as titan
    from titan_tpu_torch import _build
    from titan_tpu_torch.ops import fused_step

    builds = {"fmad=false": _build.NVCC_FLAGS,
              "contract": tuple(f for f in _build.NVCC_FLAGS
                                if f != "-fmad=false")}
    landed = {}
    for name, make in (("bench 43^3", cs.bench_scene),
                       ("entry 20^3", cs.entry_scene)):
        _build.NVCC_FLAGS = builds["fmad=false"]
        landed[name] = cs.drive(make(titan), name, 3.5)[1]

    scenes = [(v, *cs.variant_scene(titan, v), 100) for v in cs.VARIANTS]
    scenes += [(f"{k} landed", *landed[k], 200) for k in landed]
    for label, flags in builds.items():
        _build.NVCC_FLAGS = flags
        _build.load("fused_step")
        worst = {}
        for scene, shape, state, steps in scenes:
            got = fused_step.fused_chunk(shape, state, steps)
            want = fused_step.fused_chunk_plain(shape, state, steps)
            torch.cuda.synchronize()
            errs, bad = cs.compare(got, want, shape.has_actuated)
            for k, v in errs.items():
                if v > worst.get(k, (-1.0, ""))[0]:
                    worst[k] = (v, scene)
            print(f"[{label}] {scene}, {steps} steps: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + (f"  BEYOND TOLERANCE {bad}" if bad else "  within"))
        print(f"[{label}] largest: " + ", ".join(
            f"{k} {v:.3e} ({s})" for k, (v, s) in worst.items()))

    shape, state = landed["bench 43^3"]
    times = {k: [] for k in builds}
    for label in ("fmad=false", "contract", "contract", "fmad=false"):
        _build.NVCC_FLAGS = builds[label]
        fused_step.fused_chunk(shape, state, 200)
        torch.cuda.synchronize()
        times[label].append(cs.event_ms(
            lambda k: fused_step.fused_chunk(shape, state, k),
            cs.TIMED_STEPS) * 1e3)
    for label, us in times.items():
        print(f"[{label}] 43^3 landed: " + ", ".join(f"{u:.3f}" for u in us)
              + " us/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
