#!/usr/bin/env python3
"""The fused adjoint's backward (csrc/adjoint.cu) and the pairwise magnet
field's transpose (csrc/magnets_adjoint.cuh) in checkouts and builds timed
in turns.

    python3 scripts/cuda_fused_bwd_ab.py [--part bwd|transpose] \
        ROOT_A[@K=V,...] ROOT_B ...

Needs one NVIDIA GPU.  Runs the roots in order and then in reverse (A, B,
B, A for two), each in a process of its own that imports titan_tpu_torch
and chip_smoke.py from that checkout and builds its fused step, adjoint
and pairwise field.  A root written ROOT@K=V[,K=V ...] builds that
checkout with -DTITAN_K=V for each pair (e.g.
FUSED_BWD_THREADS=256,FUSED_BWD_BLOCKS=3 for the plain-spring backward's
folded kernels' block and the blocks an SM their __launch_bounds__ asks
for).  Each run times, on states at t = 0 of chip_smoke.py's
scenes (43^3 under Euler, Verlet and RK2; 20^3, 43^3 + local and 43^3 +
1,024 links under Euler), the backward over a 100-step trace: its
kernels' device time per step (torch.profiler over 3 calls), the device
span of one call per step (first kernel's start to last kernel's end,
the gaps between launches included; the least of 3) and the wrapper's
per step (CUDA events, median of 5); holds it against
bwd_run_plain on a 20-step trace (bitwise under Euler and Verlet; RK2
max |d| / max |plain|); at 43^3 the gradient path's forward + backward per
step (diff.grad_rollout over 200 steps in segments of 100 and
torch.autograd.grad; host clock, the least of 3); and the transpose on
1,024 RobotLinks (2,048 masses) and a 2,048-magnet cloud 0.7 m wide: its
device time per launch (torch.profiler over 200 launches), bitwise
against the checkout's magnet_transpose_plain (in the build's slots
where the checkout has magnets.transpose_info).  --part bwd or --part
transpose times only that kernel.  Where the checkout has
adjoint.bwd_kernel_info or magnets.transpose_info, the kernels'
registers and blocks an SM too.  Each run ends with one JSON line; it
exits non-zero where a kernel is not bitwise its plain version (RK2: over
1e-4), and checks nothing else.
"""

import json
import subprocess
import sys
import time

REPS = 5
SEG = 100
BWD_NAMES = ("bwd_mid_kernel", "bwd_force_kernel", "bwd_spring_kernel",
             "bwd_fold_kernel", "bwd_fold_rk2_kernel")


def device_span_us(fn, names):
    """us from the start of the first to the end of the last device kernel
    whose name holds one of `names` in one fn() under torch.profiler: the
    time the call holds the device, the gaps between launches
    included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ts = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(n in e.name for n in names)]
    return max(b for _, b in ts) - min(a for a, _ in ts) if ts else None


def one(spec: str, part: str) -> int:
    import torch
    root, _, flags = spec.partition("@")
    sys.path.insert(0, root)
    import chip_smoke as cs
    import titan_tpu_torch as titan
    from titan_tpu_torch import _build, diff
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops import adjoint, magnets

    if flags:
        _build.NVCC_FLAGS += tuple(f"-DTITAN_{kv}" for kv in flags.split(","))
    cs.build_kernels(("fused_step", "adjoint", "magnets"))
    out = {"root": spec}
    ok = True

    def median_ms(fn, steps):
        return sorted(cs.event_ms(fn, steps, reps=1)
                      for _ in range(REPS))[REPS // 2]

    scenes = []
    if part in ("all", "bwd"):
        links = cs.bench_scene(titan, 43)
        cs.add_links(links, 1024)
        scenes = [("43", cs.bench_scene(titan, 43),
                   (Integrator.EULER, Integrator.VERLET, Integrator.RK2)),
                  ("20", cs.entry_scene(titan, 20), (Integrator.EULER,)),
                  ("43_local", cs.local_scene(titan, 43),
                   (Integrator.EULER,)),
                  ("43_links", links, (Integrator.EULER,))]
    for key, sim, integs in scenes:
        shape0, state = cs.marshalled(sim)
        for integ in integs:
            shape = cs.integrator_shape(shape0, integ)
            k = f"{key}_{integ.name.lower()}"
            rk2 = integ is Integrator.RK2
            cts = cs.seeded_cotangents(shape.n_masses, state.masses.pos.device)
            trace = adjoint.trace_run(shape, state, 20)
            got = adjoint.bwd_run(shape, state, trace, *cts)
            ref = adjoint.bwd_run_plain(shape, state, trace, *cts)
            worst = 0.0
            for name, b in ref.items():
                if name in ("pair_ok", "rem_ok"):
                    continue
                a, b = cs.masked_bars(name, got[name], b, ref)
                d = float((a - b).abs().max())
                worst = max(worst, d / max(float(b.abs().max()), 1e-30))
            out[f"{k}_bwd_max_rel"] = worst
            ok &= worst <= (1e-4 if rk2 else 0.0)
            del trace, got, ref
            trace = adjoint.trace_run(shape, state, SEG)
            run = adjoint.bwd_run
            run.launches = 0
            dev = cs.profile_device_us(lambda: [adjoint.bwd_run(
                shape, state, trace, *cts) for _ in range(3)], BWD_NAMES)
            out[f"{k}_bwd_launches_per_call"] = run.launches // 3
            out[f"{k}_bwd_device_us_per_step"] = sum(
                t for t, _ in dev.values()) / (3 * SEG)
            out[f"{k}_bwd_kernels_us_per_launch"] = {
                n: t / c for n, (t, c) in dev.items()}
            out[f"{k}_bwd_wrapper_us_per_step"] = 1e3 * median_ms(
                lambda s: adjoint.bwd_run(shape, state, trace, *cts), SEG)
            spans = [device_span_us(lambda: adjoint.bwd_run(
                shape, state, trace, *cts), BWD_NAMES) for _ in range(3)]
            spans = [v for v in spans if v is not None]
            out[f"{k}_bwd_span_us_per_step"] = (min(spans) / SEG if spans
                                                else None)
            del trace
            torch.cuda.synchronize()
            if key == "43":
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
            if (hasattr(adjoint, "bwd_kernel_info")
                    and key in ("43", "43_links")):
                plain = cs.spring_path(shape) == "plain"
                names = (("mid", "force", "fold_rk2") if rk2 else ("fold",)) \
                    if plain else (("force", "spring", "mid") if rk2
                                   else ("force", "spring"))
                out[f"{k}_bwd_kernel_info"] = {
                    n: adjoint.bwd_kernel_info(n, shape)
                    for n in names}
        del sim, shape0, state
    mags = () if part == "bwd" else (
        ("robotlink", cs.link_sim(titan, 1024)),
        ("cloud", cs.cloud_sim(titan, 2048, seed=3, spread=0.35)))
    info = (magnets.transpose_info() if hasattr(magnets, "transpose_info")
            else None)
    for key, sim in mags:
        shape, state = cs.marshalled(sim)
        m, cut = state.masses, shape.config.magnet_cutoff
        prm = magnets.pairwise_params(m)
        gf = cs.seeded_cotangents(shape.n_masses, m.pos.device, 6)[0]
        fixed = (torch.arange(shape.n_masses, device=m.pos.device) % 10
                 == 0).float()
        got = magnets.magnet_transpose(m.pos, prm, fixed, gf, cut)
        want = magnets.magnet_transpose_plain(
            m.pos, prm, fixed, gf, cut,
            **({"slots": info["slots"]} if info else {}))
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        out[f"{key}_transpose_bitwise"] = same
        ok &= same

        def launches(k):
            for _ in range(k):
                magnets.magnet_transpose(m.pos, prm, fixed, gf, cut)
        launches(20)
        torch.cuda.synchronize()
        out[f"{key}_transpose_device_us_per_launch"] = cs.profile_us(
            lambda: launches(200), ["magnet_transpose_kernel"]).get(
                "magnet_transpose_kernel")
        del sim, shape, state, m, got, want
    if info:
        out["transpose_info"] = info
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0 if ok else 1


def main() -> int:
    args = sys.argv[1:]
    part = "all"
    if args[:1] == ["--part"]:
        part, args = args[1], args[2:]
    if args[:1] == ["--one"]:
        return one(args[1], part)
    rc = 0
    for root in args + args[::-1]:
        out = subprocess.run([sys.executable, __file__, "--part", part,
                              "--one", root],
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
