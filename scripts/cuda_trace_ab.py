#!/usr/bin/env python3
"""The fused adjoint's trace replay (csrc/adjoint.cu) in checkouts timed
in turns.

    python3 scripts/cuda_trace_ab.py ROOT_A ROOT_B ...

Needs one NVIDIA GPU.  Runs the roots in order and then in reverse (A, B,
B, A for two), each in a process of its own that imports titan_tpu_torch
and chip_smoke.py from that checkout and builds its fused step and
adjoint.  Each run, on states at t = 0 of chip_smoke.py's scenes (43^3
under Euler, Verlet and RK2; 20^3, 43^3 + local and 43^3 + 1,024 links
under Euler; 43^3 + local under RK2 too, whose replay carries the local
constraints' velocity buffer), holds the replay over 20 steps bitwise
against trace_run_plain and its last entry bitwise against the forward
chunk after 19 steps, with its launches (and those on the plain-spring
loop, where the checkout counts them), and over a 100-step segment times
its kernels' device time per step (torch.profiler over 3 calls), the
device span of one call per step (the first kernel's start to the last
kernel's end, the gaps between launches included; the least of 3) and
the wrapper's per step (CUDA events, median of 5); at 43^3 under Euler
the gradient path's forward + backward per step (diff.grad_rollout over
200 steps in segments of 100 and torch.autograd.grad; host clock, the
least of 3).  Where the checkout has adjoint.trace_kernel_info, the
kernel's registers, blocks an SM and grid too.  Each run ends with one
JSON line; it exits non-zero where a replay is not bitwise, and checks
nothing else.
"""

import json
import subprocess
import sys
import time

REPS = 5
SEG = 100
NAMES = ("adjoint_trace_kernel",)


def device_span_us(fn, names):
    """us from the start of the first to the end of the last device kernel
    whose name holds one of `names` in one fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ts = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(n in e.name for n in names)]
    return max(b for _, b in ts) - min(a for a, _ in ts) if ts else None


def one(root: str) -> int:
    import torch
    sys.path.insert(0, root)
    import chip_smoke as cs
    import titan_tpu_torch as titan
    from titan_tpu_torch import diff
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops import adjoint, fused_step

    cs.build_kernels(("fused_step", "adjoint"))
    out = {"root": root}
    ok = True

    def median_ms(fn, steps):
        return sorted(cs.event_ms(fn, steps, reps=1)
                      for _ in range(REPS))[REPS // 2]

    links = cs.bench_scene(titan, 43)
    cs.add_links(links, 1024)
    scenes = [("43", cs.bench_scene(titan, 43),
               (Integrator.EULER, Integrator.VERLET, Integrator.RK2)),
              ("20", cs.entry_scene(titan, 20), (Integrator.EULER,)),
              ("43_local", cs.local_scene(titan, 43),
               (Integrator.EULER, Integrator.RK2)),
              ("43_links", links, (Integrator.EULER,))]
    for key, sim, integs in scenes:
        shape0, state = cs.marshalled(sim)
        for integ in integs:
            shape = cs.integrator_shape(shape0, integ)
            k = f"{key}_{integ.name.lower()}"
            run = adjoint.trace_run
            run.launches = run.plain_launches = 0
            trace = adjoint.trace_run(shape, state, 20)
            out[f"{k}_launches_per_20"] = run.launches
            out[f"{k}_plain_launches_per_20"] = run.plain_launches
            want = adjoint.trace_run_plain(shape, state, 20)
            last = fused_step.fused_chunk(shape, state, 19)
            same = bool(torch.equal(trace, want)) and bool(torch.equal(
                trace[-1, :6], torch.cat([last.masses.pos,
                                          last.masses.vel])))
            out[f"{k}_bitwise"] = same
            ok &= same
            del trace, want, last
            if hasattr(adjoint, "trace_path"):
                out[f"{k}_path"] = adjoint.trace_path(shape)
            if hasattr(adjoint, "trace_kernel_info"):
                out[f"{k}_kernel_info"] = adjoint.trace_kernel_info(shape)
            adjoint.trace_run(shape, state, SEG)
            torch.cuda.synchronize()
            dev = cs.profile_device_us(lambda: [adjoint.trace_run(
                shape, state, SEG) for _ in range(3)], NAMES)
            out[f"{k}_device_us_per_step"] = sum(
                t for t, _ in dev.values()) / (3 * SEG)
            out[f"{k}_wrapper_us_per_step"] = 1e3 * median_ms(
                lambda s: adjoint.trace_run(shape, state, s), SEG)
            spans = [device_span_us(lambda: adjoint.trace_run(
                shape, state, SEG), NAMES) for _ in range(3)]
            spans = [v for v in spans if v is not None]
            out[f"{k}_span_us_per_step"] = (min(spans) / SEG if spans
                                            else None)
            torch.cuda.synchronize()
            if k == "43_euler":
                w = cs.grad_loss_weights(state)
                rollout = (lambda sh, st, n:   # noqa: E731
                           diff.grad_rollout(sh, st, n, segment=SEG))
                cs.run_grad(shape, state, rollout, 200, weights=w)
                host = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    cs.run_grad(shape, state, rollout, 200, weights=w)
                    host.append((time.perf_counter() - t0) / 200 * 1e6)
                out[f"{k}_grad_path_us_per_step"] = min(host)
        del sim, shape0, state
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0 if ok else 1


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        return one(args[1])
    rc = 0
    for root in args + args[::-1]:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, timeout=900)
        lines = out.stdout.strip().splitlines()
        print((lines[-1] if lines else "") + "\n"
              + ("" if out.returncode == 0 else
                 f"(exit {out.returncode}) {out.stderr[-3000:]}\n"),
              flush=True)
        rc |= out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
