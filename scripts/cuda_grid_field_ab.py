#!/usr/bin/env python3
"""The grid magnet field kernel (csrc/magnets_grid.cu) in checkouts and
builds timed in turns.

    python3 scripts/cuda_grid_field_ab.py ROOT_A[@K=V,...] ROOT_B ...

Needs one NVIDIA GPU.  Runs the roots in order and then in reverse (A, B,
B, A for two), each in a process of its own that imports titan_tpu_torch
and chip_smoke.py from that checkout and builds only its grid kernel.  A
root written ROOT@K=V[,K=V ...] builds that checkout with -DTITAN_K=V for
each pair (e.g. GRID_TILE=64,GRID_BLOCKS=8 for the kernel's tile and the
blocks an SM its __launch_bounds__ asks for).  Each run holds the kernel
bitwise against grid_magnet_forces_plain and times, on two states at t =
0 of chip_smoke.py's scenes, the 50,000-particle magnetic swarm
(swarm_sim) and the 64^3 soak (glue_sim; 262,144 masses, 10,000
magnets): the kernel's device time per launch (torch.profiler over 200
passes), a whole pass (setup and kernel; CUDA events, median of 5), the
setup alone (CUDA events, median of 5) and its host enqueue time (the
least of 5 loops of 200: the host's clock varies more than the device's),
and on the swarm the fused step's magnet route per step (fused_chunk,
CUDA events over 100 steps, host-bound; the least of 5).  Where the
checkout has magnets_grid.kernel_info, the build's tile, stage, window,
registers and blocks an SM too, and its tiles over the stage.  Each run
ends with one JSON line; it exits non-zero where a kernel is not bitwise
its plain version, and checks nothing else.
"""

import json
import subprocess
import sys
import time

REPS = 5
PASSES = 200


def one(spec: str) -> int:
    import torch
    root, _, flags = spec.partition("@")
    sys.path.insert(0, root)
    import chip_smoke as cs
    import titan_tpu_torch as titan
    from titan_tpu_torch import _build
    from titan_tpu_torch.ops import fused_step, magnets_grid

    if flags:
        _build.NVCC_FLAGS += tuple(f"-DTITAN_{kv}" for kv in flags.split(","))
    cs.build_kernels(("magnets_grid",))
    out = {"root": spec}
    if hasattr(magnets_grid, "kernel_info"):
        out["kernel"] = magnets_grid.kernel_info()

    def median_ms(fn, steps):
        return sorted(cs.event_ms(fn, steps, reps=1)
                      for _ in range(REPS))[REPS // 2]

    same = True
    for key, sim in (("swarm", cs.swarm_sim(titan)),
                     ("soak", cs.glue_sim(titan))):
        shape, state = cs.marshalled(sim)
        m, cut = state.masses, shape.config.magnet_cutoff
        cap = shape.magnet_binned[1]

        def passes(k):
            for _ in range(k):
                magnets_grid.grid_magnet_forces(m, cut, cap)

        def setups(k):
            for _ in range(k):
                magnets_grid.grid_setup(m, cut)

        got = magnets_grid.grid_magnet_forces(m, cut, cap)
        want = magnets_grid.grid_magnet_forces_plain(m, cut, cap)
        out[f"{key}_bitwise"] = bool(torch.equal(got, want))
        same &= out[f"{key}_bitwise"]
        passes(20)
        torch.cuda.synchronize()
        out[f"{key}_kernel_device_us_per_launch"] = cs.profile_us(
            lambda: passes(PASSES), ["grid_magnet_kernel"]).get(
                "grid_magnet_kernel")
        out[f"{key}_pass_us"] = 1e3 * median_ms(passes, PASSES)
        out[f"{key}_setup_us"] = 1e3 * median_ms(setups, PASSES)
        host = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            setups(PASSES)
            host.append((time.perf_counter() - t0) / PASSES * 1e6)
        out[f"{key}_setup_host_us"] = min(host)
        torch.cuda.synchronize()
        if hasattr(magnets_grid, "tiles_over_budget"):
            info = out.get("kernel", {})
            out[f"{key}_tiles_over_stage"] = magnets_grid.tiles_over_budget(
                magnets_grid.grid_setup(m, cut), cap,
                info.get("tile", magnets_grid.GRID_TILE),
                info.get("stage", magnets_grid.GRID_STAGE),
                info.get("window", magnets_grid.GRID_WINDOW))
        if key == "swarm":
            fused_step.fused_chunk(shape, state, 20)
            out["swarm_route_us_per_step"] = 1e3 * min(
                cs.event_ms(lambda k: fused_step.fused_chunk(shape, state, k),
                            100, reps=1) for _ in range(REPS))
        del sim, shape, state, m, got, want
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0 if same else 1


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        return one(args[1])
    rc = 0
    for root in args + args[::-1]:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, timeout=600)
        lines = out.stdout.strip().splitlines()
        print((lines[-1] if lines else "") + "\n"
              + ("" if out.returncode == 0 else
                 f"(exit {out.returncode}) {out.stderr[-3000:]}\n"),
              flush=True)
        rc |= out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
