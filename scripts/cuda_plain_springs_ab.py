#!/usr/bin/env python3
"""The plain-spring loop of the fused step and of the Euler / Verlet
resident grid against their general body, in turns in one process on one
GPU.

    python3 scripts/cuda_plain_springs_ab.py [--rounds 2]

Needs one NVIDIA GPU.  Builds the fused and tiled step kernels, then on
chip_smoke.py's bench scenes times two variants of each kernel: ``general``,
the one-thread-per-mass body every scene can take (``step_body.cuh::
step_body``, ``tiled_body.cuh::tiled_mass``), and ``plain``, the same
kernel summing its families with the plain-spring loop
(``step_body.cuh::plain_family_sum``), which a scene with plain springs
and family-uniform k takes.

The fused chunk runs at 43^3 and 20^3 (2,000-step chunks) and 100^3 (100
steps); the resident grid at 100^3, Euler and Verlet (320-step chunks,
after 32 steps from rest), beside one launch per step.  Each variant is
held bitwise against the general body first.  Each round runs the variants
in order and the next round in reverse order; times are CUDA-event medians
of 3 per round, and the fused chunks also get the kernel's device time per
launch (torch.profiler).  Prints one line per variant and round, the
card's name and power limit, and checks nothing but bitwise agreement.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = ("general", "plain")


def median_ms(cs, fn, steps):
    return sorted(cs.event_ms(fn, steps, reps=1) for _ in range(3))[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import titan_tpu_torch as titan
    from titan_tpu_torch.ops import fused_step, tiled_step

    cs.build_kernels(("fused_step", "tiled_step"))
    takes = fused_step.takes_plain_spring_path

    def set_variant(src):
        """Route the fused step and the resident grid to a variant."""
        fn = takes if src == "plain" else (lambda shape: False)
        fused_step.takes_plain_spring_path = fn
        tiled_step.takes_plain_spring_path = fn

    def same(a, b):
        return all(torch.equal(getattr(a.masses, f), getattr(b.masses, f))
                   for f in ("pos", "vel", "acc"))

    def rounds(variants):
        for r in range(args.rounds):
            for v in (variants if r % 2 == 0 else variants[::-1]):
                yield r, v

    for nx, steps in ((43, 2000), (20, 2000), (cs.STRESS_NX, 100)):
        sim = cs.bench_scene(titan, nx)
        sim._T = 0.0
        sim._marshal()
        shape = sim._shape
        state = fused_step.fused_chunk(shape, sim._state, 2000 if nx < 100
                                       else 32)
        set_variant("general")
        ref = fused_step.fused_chunk(shape, state, 20)
        for r, src in rounds(VARIANTS):
            set_variant(src)
            ok = same(fused_step.fused_chunk(shape, state, 20), ref)
            ms = median_ms(cs, lambda k: fused_step.fused_chunk(
                shape, state, k), steps)
            dev = cs.profile_us(lambda: fused_step.fused_chunk(
                shape, state, 200), ["fused_step_kernel"])
            print(f"{nx}^3 fused {src} (round {r}): "
                  f"{ms * 1e3:.3f} us/step (events), device "
                  f"{dev.get('fused_step_kernel', float('nan')):.3f} "
                  f"us/launch; {'bitwise' if ok else 'DIFFERS'}", flush=True)
        if nx != cs.STRESS_NX:
            continue
        for integ in (titan.Integrator.EULER, titan.Integrator.VERLET):
            sh = cs.integrator_shape(shape, integ)
            ref = tiled_step._tiled_chunk_cuda(sh, state, 32, 0)
            for r, src in rounds(("per-step",) + VARIANTS):
                if src == "per-step":
                    ms = median_ms(cs, lambda k: tiled_step._tiled_chunk_cuda(
                        sh, state, k, 0), 64)
                    print(f"{nx}^3 {integ.name} per-step launches (round "
                          f"{r}): {ms * 1e3:.3f} us/step", flush=True)
                    continue
                set_variant(src)
                ok = same(tiled_step.tiled_chunk(sh, state, 32), ref)
                ms = median_ms(cs, lambda k: tiled_step.tiled_chunk(
                    sh, state, k), 320)
                regs = tiled_step.step_kernel_info(
                    "grid", integ, src == "plain")["registers"]
                print(f"{nx}^3 {integ.name} resident grid {src} (round {r})"
                      f": {ms * 1e3:.3f} us/step; "
                      f"{'bitwise' if ok else 'DIFFERS'} (per-step); "
                      f"{regs} registers", flush=True)
    set_variant("plain")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
