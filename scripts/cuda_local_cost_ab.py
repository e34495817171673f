#!/usr/bin/env python3
"""What the local-constraint and remainder-spring branches cost, in
checkouts timed in turns: the fused and tiled step and backward kernels on
scenes without either, and the kernels on the scenes with them.

    python3 scripts/cuda_local_cost_ab.py [--no-local] ROOT_A ROOT_B ...

Needs one NVIDIA GPU.  Runs the roots in order and then in reverse (A, B,
B, A for two), each in a process of its own that imports titan_tpu_torch
and chip_smoke.py from that checkout and builds its kernels.  A root
written ROOT@TxB builds that checkout with the plain-spring B8's block
at T threads and its __launch_bounds__ at B blocks an SM
(-DTITAN_B8_PLAIN_THREADS=T -DTITAN_B8_PLAIN_BLOCKS=B), so one call
compares B8's block shapes in turns.  Each run then times on
the card (CUDA events, median of 5): chip_smoke.py's 43^3 bench scene
through fused_chunk (2,000 steps from rest, then a 5,000-step chunk) and
the fused adjoint's backward over a 20-step trace from there; its 100^3
stress scene through the tiled chunk (one launch per step, 200 steps; and
320 steps as 20 resident-grid launches) and the tiled adjoint's backward
over a 16-step trace, per-step launches (B7; and under RK2) and one
resident-grid launch (B8), the RK2 chunk (200 steps: 12 resident-grid
launches and a tail),
the fused adjoint's trace replay at 43^3 (20 steps) and the tiled
adjoint's replay at 100^3 (one resident-grid launch of 16 steps), and
each replay kernel's device time per launch (torch.profiler over 200
steps at 43^3 and four 16-step launches at 100^3) and each backward
kernel's (torch.profiler over one call of each backward above).
Where the checkout's chip_smoke.py has ``local_scene``, also the
fused backward on its 43^3 local scene (200 steps from rest, then a
20-step trace) and B7 and B8 on its 100^3 local scene (a 16-step trace
from t = 0; not with --no-local).  Where it has ``add_links``, also its
43^3 scene with 1,024 links (the fused step over 5,000 steps after 2,000
from rest, the fused backward over a 20-step trace) and its 100^3 scene
with 512 links (per-step launches over 200 steps, B7 over a 16-step
trace).  Where the checkout has ``adjoint_tiled.bwd_kernel_info``, the
plain-spring B8's threads, registers, local bytes and blocks an SM too.
Each run ends with one JSON line.  It checks nothing and exits 0 whatever
the times are.
"""

import json
import subprocess
import sys

REPS = 5
# the backward kernels whose device time per launch each run reports
BWD_NAMES = ("bwd_force_kernel", "bwd_spring_kernel", "bwd_mid_kernel",
               "tiled_megabwd_kernel")


def one(spec: str, local: bool) -> None:
    import torch
    root, _, b8 = spec.partition("@")
    sys.path.insert(0, root)
    import chip_smoke as cs
    import titan_tpu_torch as titan
    from titan_tpu_torch import _build
    from titan_tpu_torch.ops import (adjoint, adjoint_tiled, fused_step,
                                     tiled_step)

    if b8:
        threads, blocks = b8.split("x")
        _build.NVCC_FLAGS += (f"-DTITAN_B8_PLAIN_THREADS={threads}",
                              f"-DTITAN_B8_PLAIN_BLOCKS={blocks}")
    cs.build_kernels(("fused_step", "adjoint", "tiled_step",
                      "tiled_adjoint"))
    out = {"root": spec}
    if hasattr(adjoint_tiled, "bwd_kernel_info"):
        out["b8_plain"] = adjoint_tiled.bwd_kernel_info("B8", True)

    def median_ms(fn, steps):
        return sorted(cs.event_ms(fn, steps, reps=1)
                      for _ in range(REPS))[REPS // 2]

    sim = cs.bench_scene(titan)
    sim._T = 0.0
    sim._marshal()
    shape = sim._shape
    state = fused_step.fused_chunk(shape, sim._state, 2000)
    out["fused_43_us_per_step"] = 1e3 * median_ms(
        lambda k: fused_step.fused_chunk(shape, state, k), 5000)
    out["fused_trace_43_us_per_step"] = 1e3 * median_ms(
        lambda k: adjoint.trace_run(shape, state, k), 20)
    out["fused_trace_43_device_us_per_launch"] = cs.profile_us(
        lambda: adjoint.trace_run(shape, state, 200),
        ["adjoint_trace_kernel"]).get("adjoint_trace_kernel")
    trace = adjoint.trace_run(shape, state, 20)
    cts = cs.seeded_cotangents(shape.n_masses, trace.device)
    out["fused_bwd_43_us_per_step"] = 1e3 * median_ms(
        lambda k: adjoint.bwd_run(shape, state, trace, *cts), 20)
    out["fused_bwd_43_device_us_per_launch"] = cs.profile_us(
        lambda: adjoint.bwd_run(shape, state, trace, *cts), BWD_NAMES)

    sim = cs.bench_scene(titan, cs.STRESS_NX)
    sim._T = 0.0
    sim._marshal()
    shape, state = sim._shape, sim._state
    tiled_step.tiled_chunk(shape, state, 32)
    out["tiled_100_step_us_per_launch"] = 1e3 * median_ms(
        lambda k: tiled_step._tiled_chunk_cuda(shape, state, k, 0), 200)
    out["tiled_100_mega_us_per_step"] = 1e3 * median_ms(
        lambda k: tiled_step.tiled_chunk(shape, state, k), 320)
    rk2 = cs.integrator_shape(shape, titan.Integrator.RK2)
    out["tiled_100_rk2_us_per_step"] = 1e3 * median_ms(
        lambda k: tiled_step.tiled_chunk(rk2, state, k), 200)
    inv = tiled_step.prep_tiled_inputs(shape, state)
    out["tiled_trace_100_mega_us_per_step"] = 1e3 * median_ms(
        lambda k: adjoint_tiled.tiled_trace_run(shape, state, k, inv), 16)
    out["tiled_trace_100_device_us_per_launch"] = cs.profile_us(
        lambda: adjoint_tiled.tiled_trace_run(shape, state, 64, inv),
        ["tiled_mega_kernel"]).get("tiled_mega_kernel")
    trace = adjoint_tiled.tiled_trace_run(shape, state, 16, inv)
    cts = cs.seeded_cotangents(shape.n_masses, trace.device)
    for key, sh, mega in (("b7", shape, False), ("b8", shape, True),
                          ("rk2_b7", rk2, False)):
        out[f"tiled_bwd_100_{key}_us_per_step"] = 1e3 * median_ms(
            lambda k: adjoint_tiled._tiled_bwd_cuda(
                sh, state, trace, *cts, inv, mega), 16)
        out[f"tiled_bwd_100_{key}_device_us_per_launch"] = cs.profile_us(
            lambda: adjoint_tiled._tiled_bwd_cuda(
                sh, state, trace, *cts, inv, mega), BWD_NAMES)
    del sim, shape, state, inv, trace, cts
    if hasattr(cs, "add_links"):
        sim = cs.bench_scene(titan)
        cs.add_links(sim, cs.REM_BENCH_LINKS)
        sim._T = 0.0
        sim._marshal()
        shape = sim._shape
        state = fused_step.fused_chunk(shape, sim._state, 2000)
        out["links_fused_43_us_per_step"] = 1e3 * median_ms(
            lambda k: fused_step.fused_chunk(shape, state, k), 5000)
        trace = adjoint.trace_run(shape, state, 20)
        cts = cs.seeded_cotangents(shape.n_masses, trace.device)
        out["links_fused_bwd_43_us_per_step"] = 1e3 * median_ms(
            lambda k: adjoint.bwd_run(shape, state, trace, *cts), 20)
        out["links_fused_bwd_43_device_us_per_launch"] = cs.profile_us(
            lambda: adjoint.bwd_run(shape, state, trace, *cts), BWD_NAMES)
        del sim, shape, state, trace, cts
        sim = cs.bench_scene(titan, cs.STRESS_NX)
        cs.add_links(sim, cs.REM_STRESS_LINKS)
        sim._T = 0.0
        sim._marshal()
        shape, state = sim._shape, sim._state
        out["links_tiled_100_step_us_per_launch"] = 1e3 * median_ms(
            lambda k: tiled_step._tiled_chunk_cuda(shape, state, k, 0), 200)
        inv = tiled_step.prep_tiled_inputs(shape, state)
        trace = adjoint_tiled.tiled_trace_run(shape, state, 16, inv)
        cts = cs.seeded_cotangents(shape.n_masses, trace.device)
        out["links_tiled_bwd_100_b7_us_per_step"] = 1e3 * median_ms(
            lambda k: adjoint_tiled._tiled_bwd_cuda(
                shape, state, trace, *cts, inv, False), 16)
        out["links_tiled_bwd_100_b7_device_us_per_launch"] = cs.profile_us(
            lambda: adjoint_tiled._tiled_bwd_cuda(
                shape, state, trace, *cts, inv, False), BWD_NAMES)
        del sim, shape, state, inv, trace, cts
    if local and hasattr(cs, "local_scene"):
        sim = cs.local_scene(titan, 43)
        sim._T = 0.0
        sim._marshal()
        shape = sim._shape
        state = fused_step.fused_chunk(shape, sim._state, 200)
        trace = adjoint.trace_run(shape, state, 20)
        cts = cs.seeded_cotangents(shape.n_masses, trace.device)
        out["local_fused_bwd_43_us_per_step"] = 1e3 * median_ms(
            lambda k: adjoint.bwd_run(shape, state, trace, *cts), 20)
        out["local_fused_bwd_43_device_us_per_launch"] = cs.profile_us(
            lambda: adjoint.bwd_run(shape, state, trace, *cts), BWD_NAMES)
        del sim, shape, state, trace, cts
        sim = cs.local_scene(titan, cs.STRESS_NX)
        sim._T = 0.0
        sim._marshal()
        shape, state = sim._shape, sim._state
        inv = tiled_step.prep_tiled_inputs(shape, state)
        trace = adjoint_tiled.tiled_trace_run(shape, state, 16, inv)
        cts = cs.seeded_cotangents(shape.n_masses, trace.device)
        for key, mega in (("b7", False), ("b8", True)):
            out[f"local_tiled_bwd_100_{key}_us_per_step"] = 1e3 * median_ms(
                lambda k: adjoint_tiled._tiled_bwd_cuda(
                    shape, state, trace, *cts, inv, mega), 16)
            out[f"local_tiled_bwd_100_{key}_device_us_per_launch"] = \
                cs.profile_us(lambda: adjoint_tiled._tiled_bwd_cuda(
                    shape, state, trace, *cts, inv, mega), BWD_NAMES)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def main() -> int:
    args = sys.argv[1:]
    local = "--no-local" not in args
    args = [a for a in args if a != "--no-local"]
    if args[:1] == ["--one"]:
        one(args[1], local)
        return 0
    for root in args + args[::-1]:
        out = subprocess.run([sys.executable, __file__, "--one", root]
                             + ([] if local else ["--no-local"]),
                             capture_output=True, text=True, timeout=600)
        lines = out.stdout.strip().splitlines()
        print((lines[-1] if lines else "") + "\n"
              + (out.stderr[-1500:] if out.returncode else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
