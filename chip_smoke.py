#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (titan_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. build csrc/fused_step.cu with nvcc for sm_90a (build seconds, ptxas
     register report);
  2. hold the fused CUDA kernel against its plain PyTorch version
     (fused_chunk_plain) on the card over 100 steps, for one small scene per
     feature: pos/vel within 1e-5 (atol and rtol), actuated rest within
     1e-6 -- the slack is FMA contraction and summation order.  The
     static-friction scene also checks that its resting masses kept exactly
     zero tangential velocity, i.e. that the static branch ran;
  3. the main paths through the public API, each with the kernel's launch
     count and the eager step count set to 0 just before it and read just
     after: the 43^3 scene of bench.py and the 20^3 scene of
     __graft_entry__.entry(), each built with titan_tpu_torch.Simulation and
     run start -> wait -> getAll -> resume -> stop until the lattice has
     landed on its plane.  Each path must launch the kernel and run no eager
     step.  The landed state of each (in contact with its plane; the 20^3
     plane has friction) and the 43^3 scene's first 200 steps from its
     start are held against fused_chunk_plain over 200 steps;
  4. time each path's chunk with CUDA events from its landed state (kernel
     and plain version) beside the least time the card could take;
  5. print the kernels line (one entry per path), the card's name and power
     limit, and last the result line.

It imports neither JAX nor titan_tpu, and exits non-zero without printing a
result when torch.cuda.is_available() is false.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# ops a step needs, counted once per spring (diff 3, |d|^2 5, sqrt, divide,
# Hooke 2, scale 1, f 3, scatter to both ends 6) and once per mass (plane,
# integrate, clamp); a floor, sqrt and divide counted as one op
OPS_PER_SPRING, OPS_PER_MASS = 22, 25
TOL_STATE, TOL_REST = 1e-5, 1e-6
VARIANTS = ("plain", "friction", "static_friction", "ball", "damping",
            "breathing", "actuated", "drag", "deleted", "verlet", "rk2",
            "clamp_off")
TIMED_STEPS = 5000


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def variant_scene(titan, variant):
    """A 6^3 lattice exercising one feature of the kernel, marshalled on
    the card; returns (shape, state)."""
    cfg = dict(device="cuda", velocity_clamp=variant != "clamp_off")
    if variant == "verlet":
        cfg["integrator"] = titan.Integrator.VERLET
    elif variant == "rk2":
        cfg["integrator"] = titan.Integrator.RK2
    sim = titan.Simulation(titan.SimConfig(**cfg))
    # friction: inside the plane and sliding, so the kinetic branch runs;
    # static_friction: the bottom layer 1 mm inside the plane and at rest,
    # so the static branch runs until the contact pushes it out
    z = {"friction": 0.3, "static_friction": 0.499}.get(variant, 2.0)
    sim.createLattice(titan.Vec(0, 0, z), titan.Vec(1, 1, 1), 6, 6, 6)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    s, n = st.n_springs, st.n_masses
    if variant == "damping":
        st.damping[:s] = 0.5
    elif variant == "breathing":
        st.s_type[: s // 2] = titan.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[: s // 2] = 7.0
    elif variant == "actuated":
        third = s // 3
        st.s_type[:third] = titan.ACTUATED_EXPAND
        st.l_max[:third] = st.rest[:third] * 1.2
        st.rate[:third] = 0.5
        st.s_type[third:2 * third] = titan.ACTUATED_CONTRACT
        st.l_min[third:2 * third] = st.rest[third:2 * third] * 0.8
        st.rate[third:2 * third] = 0.5
    elif variant == "drag":
        st.drag[:n] = 0.3
    elif variant == "deleted":
        st.valid[[3, 17, 100]] = False
    if variant in ("friction", "static_friction"):
        sim.createPlane(titan.Vec(0, 0, 1), 0, 0.4, 0.6)
        if variant == "friction":
            st.vel[:n] = (0.3, 0.1, 0.0)
        sim.setGlobalAcceleration(titan.Vec(0.5, 0, -9.8))
    else:
        sim.createPlane(titan.Vec(0, 0, 1), 0)
        sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    if variant == "ball":
        sim.createBall(titan.Vec(0, 0, 1.0), 0.6)
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


def bench_scene(titan, nx=43):
    """bench.py's scene: 43^3 lattice, 79,507 masses, 984,438 springs."""
    sim = titan.Simulation(titan.SimConfig(host_store_dtype="float32"))
    sim.createLattice(titan.Vec(0, 0, 5), titan.Vec(4, 4, 4), nx, nx, nx)
    sim.setAllSpringConstantValues(1000.0)
    sim.setTimeStep(0.0001)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.defaultRestLengths()
    sim.createPlane(titan.Vec(0, 0, 1), 0)
    return sim


def entry_scene(titan, nx=20):
    """__graft_entry__.entry()'s scene: 20^3 lattice on a friction plane."""
    sim = titan.Simulation(titan.SimConfig())
    sim.createLattice(titan.Vec(0, 0, 5), titan.Vec(4, 4, 4), nx, nx, nx)
    sim.setAllSpringConstantValues(1000.0)
    sim.setTimeStep(0.0001)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.defaultRestLengths()
    sim.createPlane(titan.Vec(0, 0, 1), 0, 10, 10)
    return sim


def compare(got, want, actuated):
    """({field: max |kernel - plain|} over pos/vel (+ rest), failures)."""
    import torch
    errs, bad_msgs = {}, []
    pairs = [("pos", got.masses.pos, want.masses.pos, TOL_STATE),
             ("vel", got.masses.vel, want.masses.vel, TOL_STATE)]
    if actuated:
        pairs.append(("rest", got.stencil.rest, want.stencil.rest, TOL_REST))
    for name, a, b, tol in pairs:
        if not bool(torch.isfinite(a).all()):
            bad_msgs.append(f"non-finite {name}")
        d = (a - b).abs()
        errs[name] = float(d.max())
        bad = d > tol + tol * b.abs()
        if bool(bad.any()):
            bad_msgs.append(f"{name}: {int(bad.sum())} entries beyond {tol} "
                            f"(max |d| {errs[name]:.3e})")
    return errs, bad_msgs


def kernel_vs_plain(shape, state, steps, label):
    """Hold fused_chunk against fused_chunk_plain over `steps` steps from
    `state`; prints the errors, fails on disagreement, returns the max."""
    import torch
    from titan_tpu_torch.ops import fused_step
    got = fused_step.fused_chunk(shape, state, steps)
    want = fused_step.fused_chunk_plain(shape, state, steps)
    torch.cuda.synchronize()
    errs, bad = compare(got, want, shape.has_actuated)
    print(f"kernel vs plain [{label}, {steps} steps]: max |d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + (f"  FAIL {bad}" if bad else ""))
    check(not bad, f"{label}: kernel disagrees with plain: {bad}")
    return max(errs.values()), got


def contact_counts(shape, state):
    """(masses inside a plane, of which at rest tangentially) -- the latter
    take the static-friction branch on a friction plane."""
    g, m = state.gcon, state.masses
    inside = static = 0
    for p in range(shape.n_planes):
        nv = g.plane_normal[p][:, None]
        disp = (m.pos * nv).sum(0) - g.plane_offset[p]
        vp = m.vel - (m.vel * nv).sum(0) * nv
        ins = (disp < 0) & m.valid
        inside += int(ins.sum())
        static += int((ins & ((vp * vp).sum(0).sqrt() <= 1e-16)).sum())
    return inside, static


def drive(sim, name, t_land):
    """One main path through the public API: start -> wait -> getAll ->
    resume -> stop, with the kernel's launch count and the eager step count
    set to 0 just before it and read just after.  Checks the landed scene;
    returns (launches, (shape, state) at t_land)."""
    import numpy as np
    import torch
    from titan_tpu_torch.ops import fused_step
    from titan_tpu_torch.ops import step as tstep
    n = sim._store.n_masses
    z0 = sim._store.pos[:n, 2].copy()
    t0 = time.perf_counter()
    fused_step.fused_chunk.launches = 0
    tstep.run_eager.steps = 0
    sim.start()
    sim.wait(t_land)
    sim.getAll()
    landed = (sim._shape, sim._snapshot())
    pos = sim._store.pos[:n].copy()
    vel = sim._store.vel[:n].copy()
    sim.resume()
    sim.wait(0.01)
    sim.getAll()
    t_end = sim.time()
    sim.stop()
    torch.cuda.synchronize()
    launches, eager = fused_step.fused_chunk.launches, tstep.run_eager.steps
    wall = time.perf_counter() - t0
    print(f"main path {name}: fused_step launches {launches}, eager steps "
          f"{eager}")
    check(launches > 0, f"{name}: the main path never launched the kernel")
    check(eager == 0, f"{name}: the main path ran {eager} eager steps")
    check(np.isfinite(pos).all() and np.isfinite(vel).all(),
          f"{name}: non-finite state")
    check(pos.shape == (n, 3), f"{name}: state shape {pos.shape}")
    check(abs(t_end - (t_land + 0.01)) < 1e-9, f"{name}: time {t_end}")
    speed = np.sqrt((vel * vel).sum(1))
    check(speed.max() <= 1.0 + 1e-5, f"{name}: clamp broken ({speed.max()})")
    # fell from z >= 3 onto the plane (the penalty contact is elastic, so
    # the lattice may bounce a few cm) and did not pass through it
    check(-0.1 < pos[:, 2].min() < 0.2,
          f"{name}: lowest mass at z={pos[:, 2].min():.4f}")
    check(0.5 < pos[:, 2].mean() < z0.mean() - 2.0,
          f"{name}: mean z {pos[:, 2].mean():.3f} (from {z0.mean():.3f})")
    inside, static = contact_counts(*landed)
    check(inside > 0, f"{name}: no mass in contact at t={t_land}")
    print(f"main path {name}: {n} masses, t={t_end:.4f} s sim in "
          f"{wall:.2f} s wall; lowest z={pos[:, 2].min():.4f}, mean z "
          f"{z0.mean():.3f} -> {pos[:, 2].mean():.3f}, max |v|="
          f"{speed.max():.4f}; at t={t_land}: {inside} masses in contact, "
          f"{static} of them at rest tangentially")
    return launches, landed


def event_ms(fn, steps, reps=3):
    """Median ms per step of fn(steps) by CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(steps)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / steps)
    return sorted(times)[len(times) // 2]


def profile_kernel_us(fn, steps):
    """Device time per fused_step_kernel launch from torch.profiler, or None
    if the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(steps)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if "fused_step_kernel" in e.key:
            total += getattr(e, "self_device_time_total", 0.0) or 0.0
            count += e.count
    return total / count if count and total else None


def bound_ms_per_step(shape, state, n_steps):
    """The least ms per step the card could take for an n_steps chunk, and
    what bounds it.  Bytes: each input of the chunk read once and each
    output written once (the per-step state need not leave the chip), over
    the HBM rate, spread over the chunk's steps.  Operations: the springs'
    and masses' arithmetic of every step over the f32 peak."""
    n, f = shape.n_masses, len(shape.stencil_deltas)
    # read pos, vel, acc, const_f (3 each), minv, fixed and per family k,
    # rest (+ damping, breathing sign and frequency, actuation rate and
    # bound, drag when on); write pos, vel, acc (+ actuated rest)
    per_mass = (9 + 3 + 1 + 1 + 2 * f + f * shape.has_damping
                + 2 * f * shape.has_breathing + 2 * f * shape.has_actuated
                + shape.has_drag + 9 + f * shape.has_actuated)
    n_springs = int(state.stencil.mask.sum())
    t_bytes = 4 * per_mass * n / n_steps / HBM_BYTES_PER_S * 1e3
    t_ops = (OPS_PER_SPRING * n_springs + OPS_PER_MASS * n) \
        / F32_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ), t_bytes, t_ops


def time_path(name, shape, state):
    """Kernel and plain ms per step from `state`, and the bound."""
    import torch
    from titan_tpu_torch.ops import fused_step

    def run_kernel(k):
        fused_step.fused_chunk(shape, state, k)

    def run_plain(k):
        fused_step.fused_chunk_plain(shape, state, k)

    run_kernel(200)
    run_plain(2)
    torch.cuda.synchronize()
    ms = event_ms(run_kernel, TIMED_STEPS)
    plain_ms = event_ms(run_plain, 20)
    (bound_ms, bound_by), t_bytes, t_ops = bound_ms_per_step(
        shape, state, TIMED_STEPS)
    n_springs = int(state.stencil.mask.sum())
    print(f"timing {name} fused_step: {ms * 1e3:.3f} us/step, "
          f"{1e3 / ms:.0f} steps/s, {n_springs * 1e3 / ms:.4e} "
          f"spring-updates/s; bound {bound_ms * 1e3:.4f} us/step by "
          f"{bound_by} (bytes {t_bytes * 1e3:.4f} us over a {TIMED_STEPS}-"
          f"step chunk at 3.35 TB/s, ops {t_ops * 1e3:.4f} us at "
          f"67 TFLOP/s), {100 * bound_ms / ms:.2f}% of bound; plain version "
          f"{plain_ms * 1e3:.1f} us/step")
    # host cost of enqueueing a chunk short enough not to fill the launch
    # queue (a long chunk blocks on the queue and measures the device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_kernel(200)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    kern_us = profile_kernel_us(run_kernel, 500)
    print(f"{name}: host enqueue {host_us:.3f} us/step (200-step chunk, "
          f"prep included); torch.profiler: "
          + ("not measured (no device time recorded)" if kern_us is None
             else f"fused_step_kernel {kern_us:.3f} us/launch on the "
                  f"device, {100 * kern_us / (ms * 1e3):.1f}% of the "
                  f"event-timed step"))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import titan_tpu_torch as titan
    from titan_tpu_torch import _build
    from titan_tpu_torch.ops import fused_step

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, devices: "
          f"{torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    report = _build.build("fused_step", verbose=True)
    print(f"build fused_step.cu: {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    _build.load("fused_step")

    # 2. kernel vs plain, small scenes, 100 steps each
    for variant in VARIANTS:
        shape, state = variant_scene(titan, variant)
        check(fused_step.fused_reject_reason(shape) is None,
              f"{variant}: {fused_step.fused_reject_reason(shape)}")
        kernel_vs_plain(shape, state, 100, variant)
        if variant == "static_friction":
            # a few steps in, the bottom layer is still in contact and the
            # static branch has cancelled its tangential force exactly
            inside, static = contact_counts(
                shape, fused_step.fused_chunk(shape, state, 10))
            print(f"static_friction after 10 steps: {inside} masses in "
                  f"contact, {static} at rest tangentially")
            check(static > 0 and static == inside,
                  "static friction did not hold the resting masses")

    # 3. the main paths through the public API, then kernel vs plain from
    # each one's landed (contact) state; 4. timing from that state
    kernels = []
    for name, make, nx in (("bench 43^3", bench_scene, 43),
                           ("entry 20^3", entry_scene, 20)):
        launches, (shape, state) = drive(make(titan), name, 3.5)
        check(not shape.has_remainder and len(shape.stencil_deltas) == 13,
              f"{name}: the scene did not bucket into 13 families")
        err, _ = kernel_vs_plain(shape, state, 200, f"{name} landed")
        if nx == 43:
            sim = make(titan)
            sim._T = 0.0
            sim._marshal()
            check(int(sim._state.stencil.mask.sum()) == sim._store.n_springs,
                  f"{name}: springs lost in the stencil families")
            e0, _ = kernel_vs_plain(sim._shape, sim._state, 200,
                                    f"{name} from rest")
            err = max(err, e0)
        kernels.append(dict(
            name=f"fused_step ({name})", route="cuda",
            source="titan_tpu_torch/csrc/fused_step.cu",
            replaces="titan_tpu/ops/pallas_step.py:185",
            launches=launches, max_abs_err=err,
            **time_path(name, shape, state), library_ms=None))

    # 5. result lines
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
