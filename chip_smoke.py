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
  a. build csrc/adjoint.cu (the adjoint's trace and backward kernels) beside
     fused_step.cu, each by its own nvcc, started together, with ptxas
     reports;
  b. hold both adjoint kernels against their plain versions on the 12 small
     scenes over a 20-step segment: the trace bitwise against
     trace_run_plain, the backward against bwd_run_plain fed the same trace
     and seeded cotangents, within TOL_BWD of max |plain| for every output;
  c. the gradient path from each landed main-path state (43^3 and 20^3):
     diff.grad_rollout over 200 steps in segments of 100 and
     torch.autograd.grad of seeded weights . (final pos, vel) over pos,
     vel, k, rest, m, extern_force and g, with every launch count and the
     eager step count set to 0 just before and read just after; each kernel
     must launch, no eager step may run, every gradient must be finite.
     Then both adjoint kernels against their plain versions on one
     100-step segment's trace from that state;
  d. a system-id fit at 43^3 (examples/system_id.py's idea): a
     two-material k_true, 3 Adam iterations on log k, each loss over 2
     segments of 100 steps; the loss must fall;
  e. time at 43^3 and 20^3: forward + backward per step (host clock),
     each adjoint kernel's device time per step and per launch
     (torch.profiler) beside its bound and its wrapper's CUDA-event time,
     the plain versions, and fast_rollout (eager-recompute backward) at
     43^3;
  5. print the kernels line (one entry per kernel and path), the card's
     name and power limit, and last the result line.

It imports neither JAX nor titan_tpu, and exits non-zero without printing a
result when torch.cuda.is_available() is false.
"""

import json
import math
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
# backward kernel vs bwd_run_plain on one shared trace, per output:
# max |kernel - plain| / max |plain|.  The slack is summation order (RK2
# adds its two passes' gradients one after the other) amplified by the
# stiff contact over a segment.
TOL_BWD = 1e-4
# operations of one backward step on top of the forward recompute (22 per
# spring, 25 per mass): the spring transpose (fbar 3, dot 5, dbar 4, the
# length chain 10, 2 diff d2bar 9, both ends 6, gradients 3) and the
# per-mass integrator, plane and carry transposes
OPS_PER_SPRING_T, OPS_PER_MASS_T = 40, 45
SEG, GRAD_STEPS = 100, 200
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


def profile_device_us(fn, names):
    """{kernel: (device us in all, launches)} for each kernel in `names`
    from torch.profiler over fn(); a kernel with no device time recorded
    is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        for k in names:
            if k in e.key and e.count and t:
                out[k] = (t, e.count)
    return out


def profile_us(fn, names):
    """Device us per launch of each kernel in `names` (profile_device_us)."""
    return {k: t / c for k, (t, c) in profile_device_us(fn, names).items()}


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
    kern_us = profile_us(lambda: run_kernel(500),
                         ["fused_step_kernel"]).get("fused_step_kernel")
    print(f"{name}: host enqueue {host_us:.3f} us/step (200-step chunk, "
          f"prep included); torch.profiler: "
          + ("not measured (no device time recorded)" if kern_us is None
             else f"fused_step_kernel {kern_us:.3f} us/launch on the "
                  f"device, {100 * kern_us / (ms * 1e3):.1f}% of the "
                  f"event-timed step"))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)

def build_kernels(names):
    """Build each csrc/<name>.cu with its own nvcc, all started together;
    prints each build's seconds and ptxas register / spill lines."""
    from concurrent.futures import ThreadPoolExecutor
    from titan_tpu_torch import _build

    def one(name):
        t0 = time.perf_counter()
        return name, _build.build(name, verbose=True), \
            time.perf_counter() - t0
    with ThreadPoolExecutor(len(names)) as ex:
        for name, report, secs in ex.map(one, names):
            print(f"build {name}.cu: {secs:.2f} s")
            for line in report.splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    print("  ptxas:", line.strip())
            _build.load(name)


def seeded_cotangents(n, device, seed=5):
    """Three [3, n] f32 cotangents from a seeded numpy generator."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (3, n)).astype(np.float32))
            .to(device) for _ in range(3)]


def adjoint_vs_plain(shape, state, seg, label):
    """Both adjoint kernels against their plain versions from `state`: the
    trace bitwise, the backward within TOL_BWD per output on the kernel's
    trace.  Returns the trace's max |d| and the backward's max |d| and
    max |d| / max |plain|."""
    import torch
    from titan_tpu_torch.ops import adjoint
    trace = adjoint.trace_run(shape, state, seg)
    want = adjoint.trace_run_plain(shape, state, seg)
    torch.cuda.synchronize()
    dtr = float((trace - want).abs().max())
    check(torch.equal(trace, want),
          f"{label}: trace kernel differs from trace_run_plain by {dtr:.3e}")
    del want
    cts = seeded_cotangents(shape.n_masses, trace.device)
    got = adjoint.bwd_run(shape, state, trace, *cts)
    ref = adjoint.bwd_run_plain(shape, state, trace, *cts)
    torch.cuda.synchronize()
    ok = ref["pair_ok"]
    abs_err, rel, bad = 0.0, {}, []
    for key, b in ref.items():
        if key == "pair_ok":
            continue
        a = got[key]
        if key in ("k", "damping", "aratedt"):   # masked in assemble_ct
            a, b = torch.where(ok, a, 0.0), torch.where(ok, b, 0.0)
        if not bool(torch.isfinite(a).all()):
            bad.append(f"non-finite {key}")
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        rel[key] = d / max(float(b.abs().max()), 1e-30)
        if rel[key] > TOL_BWD:
            bad.append(f"{key} {rel[key]:.3e}")
    print(f"adjoint vs plain [{label}, {seg} steps]: trace bitwise; "
          f"backward max |d| / max |plain|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + (f"  FAIL {bad}" if bad else ""))
    check(not bad, f"{label}: backward kernel disagrees with plain: {bad}")
    return dtr, abs_err, max(rel.values())


def grad_leaves(state):
    """(leaves pos, vel, k, rest, m, extern_force, g requiring grad, the
    state built on them)."""
    import dataclasses
    leaves = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel, state.stencil.k,
        state.stencil.rest, state.masses.m, state.masses.extern_force,
        state.g)]
    pos, vel, k, rest, m, ext, g = leaves
    st = dataclasses.replace(
        state,
        masses=dataclasses.replace(state.masses, pos=pos, vel=vel, m=m,
                                   extern_force=ext),
        stencil=dataclasses.replace(state.stencil, k=k, rest=rest), g=g)
    return leaves, st


def grad_loss_weights(state, seed=11):
    """Seeded weights on pos and vel of the valid masses."""
    w = seeded_cotangents(state.masses.pos.shape[1], state.masses.pos.device,
                          seed)[:2]
    return [x * state.masses.valid for x in w]


def run_grad(shape, state, rollout, n_steps=GRAD_STEPS):
    """loss = weights . (final pos, vel) through `rollout`, and its
    gradients over the leaves; synchronised."""
    import torch
    leaves, st = grad_leaves(state)
    wpos, wvel = grad_loss_weights(state)
    out = rollout(shape, st, n_steps)
    loss = (torch.sum(out.masses.pos * wpos)
            + torch.sum(out.masses.vel * wvel))
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return loss, grads


def counters():
    """The objects that carry the gradient path's launch and step counts."""
    from titan_tpu_torch.ops import adjoint, fused_step
    from titan_tpu_torch.ops import step as tstep
    return (fused_step.fused_chunk, adjoint.trace_run, adjoint.bwd_run,
            tstep.run_eager)


def grad_path(name, shape, state):
    """Phase c: diff.grad_rollout + torch.autograd.grad from `state`, with
    the launch and eager counts zeroed just before and read just after;
    then both adjoint kernels against their plain versions.  Returns the
    launches of the trace and backward kernels and the errors of
    adjoint_vs_plain."""
    import torch
    from titan_tpu_torch import diff
    fwd, tr, bwd, eager = counters()
    fwd.launches = tr.launches = bwd.launches = 0
    eager.steps = 0
    t0 = time.perf_counter()
    loss, grads = run_grad(
        shape, state,
        lambda sh, st, k: diff.grad_rollout(sh, st, k, segment=SEG))
    wall = time.perf_counter() - t0
    got = (fwd.launches, tr.launches, bwd.launches, eager.steps)
    print(f"gradient path {name}: {GRAD_STEPS} steps in segments of {SEG}: "
          f"fused_step launches {got[0]}, adjoint trace launches {got[1]}, "
          f"adjoint backward launches {got[2]}, eager steps {got[3]}; "
          f"{wall:.3f} s wall (first call)")
    check(min(got[:3]) > 0, f"{name}: a kernel of the gradient path never "
          f"launched: {got}")
    check(got[3] == 0, f"{name}: the gradient path ran {got[3]} eager steps")
    names = ("pos", "vel", "k", "rest", "m", "extern_force", "g")
    for nm, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()), f"{name}: d loss / d {nm} is "
              "not finite")
    print(f"gradient path {name}: loss {float(loss.detach()):.6e}; |grad|max "
          + ", ".join(f"{nm} {float(g.abs().max()):.3e}"
                      for nm, g in zip(names, grads)))
    err = adjoint_vs_plain(shape, state, SEG, f"{name} landed")
    return got[1], got[2], err


def system_id(shape, state, iters=3, lr=0.08):
    """Phase d: fit log k to a two-material k_true from positions at two
    segment boundaries (examples/system_id.py), 3 Adam iterations through
    diff.grad_rollout.  Returns the losses."""
    import dataclasses
    import torch
    from titan_tpu_torch import diff
    mask = state.stencil.mask
    valid = state.masses.valid
    z = state.masses.pos[2]
    z_mid = (z * valid).sum() / valid.sum()
    k_true = torch.where(mask, torch.where(z > z_mid, 1800.0, 600.0), 0.0)

    def boundaries(k):
        s = dataclasses.replace(state, stencil=dataclasses.replace(
            state.stencil, k=k))
        out = []
        for _ in range(2):
            s = diff.grad_rollout(shape, s, SEG, segment=SEG)
            out.append(s.masses.pos)
        return torch.stack(out)

    with torch.no_grad():
        obs = boundaries(k_true)
    logk = torch.where(mask, 1000.0, 1.0).log().requires_grad_()
    opt = torch.optim.Adam([logk], lr=lr)
    losses = []
    for _ in range(iters):
        opt.zero_grad()
        pred = boundaries(torch.exp(logk) * mask)
        loss = ((pred - obs) ** 2 * valid).sum() / (2 * 3 * valid.sum()) * 1e4
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    print("system id 43^3: loss over 3 Adam iterations "
          + " -> ".join(f"{v:.6e}" for v in losses)
          + f" (k_true 600 / 1800 split at z = {float(z_mid):.3f}, "
          "start 1000)")
    check(all(math.isfinite(v) for v in losses), "system id: non-finite "
          "loss")
    check(losses[-1] < losses[0], f"system id: the loss did not fall: "
          f"{losses}")
    return losses


def adjoint_bound_ms(shape, state, seg):
    """The least ms per step the card could take for each adjoint kernel
    over a `seg`-step segment, and what bounds it: ((trace ms, by),
    (backward ms, by)).  Bytes: each input read once and each output
    written once; operations over the f32 peak."""
    n, f = shape.n_masses, len(shape.stencil_deltas)
    n_springs = int(state.stencil.mask.sum())
    fam = f * (2 + shape.has_damping + 2 * shape.has_breathing
               + 2 * shape.has_actuated)
    # invariants: cf 3, minv, fixed, (drag) and the family planes
    inv = 3 + 2 + shape.has_drag + fam
    trace_bytes = 4 * n * (seg * 6 + 9 + inv)
    grads = 9 + 3 + 1 + shape.has_drag + f * (
        2 + shape.has_damping + shape.has_breathing + shape.has_actuated)
    bwd_bytes = 4 * n * (seg * 6 + 9 + inv + grads)
    rk2 = 2 if shape.config.integrator.name == "RK2" else 1
    ops_fwd = rk2 * (OPS_PER_SPRING * n_springs + OPS_PER_MASS * n)
    ops_bwd = ops_fwd + rk2 * (OPS_PER_SPRING_T * n_springs
                               + OPS_PER_MASS_T * n)
    out = []
    for nbytes, ops in ((trace_bytes, ops_fwd), (bwd_bytes, ops_bwd)):
        tb = nbytes / seg / HBM_BYTES_PER_S * 1e3
        to = ops / F32_FLOPS_PER_S * 1e3
        out.append((tb, "bytes") if tb >= to else (to, "operations"))
    return out


def profile_grad_path(name, shape, state):
    """One forward + backward of the gradient path under torch.profiler:
    the device's busy share of the wall time, the adjoint kernels' share
    of the device time, host-to-device copies, and the host operations
    that take the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from titan_tpu_torch import diff
    run_grad(shape, state, lambda sh, st, k: diff.grad_rollout(
        sh, st, k, segment=SEG))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_grad(shape, state, lambda sh, st, k: diff.grad_rollout(
            sh, st, k, segment=SEG))
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, ours, h2d = 0.0, 0.0, 0
    ours_names = ("fused_step_kernel", "adjoint_trace_kernel",
                  "bwd_force_kernel", "bwd_spring_kernel", "bwd_mid_kernel")
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue       # host ops also carry their kernels' device time
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        dev += t
        if any(k in e.key for k in ours_names):
            ours += t
        if "HtoD" in e.key:
            h2d += e.count
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"profile {name} gradient path ({GRAD_STEPS} steps, forward + "
          f"backward, profiler on): wall {wall_us:.0f} us, device busy "
          f"{dev:.0f} us ({100 * dev / wall_us:.1f}%), of which the port's "
          f"kernels {ours:.0f} us; {h2d} host-to-device copies; host "
          "self time: " + ", ".join(f"{e.key} {e.self_cpu_time_total:.0f} us "
                                    f"x{e.count}" for e in host[:6]))


def time_adjoint(name, shape, state, fast=False):
    """Phase e from `state`: fwd + bwd per step through grad_rollout; each
    adjoint kernel's device time per step and per launch (profiler; the
    kernel entry's ms), its wrapper per step (CUDA events around the call,
    the host's argument staging included); the plain versions, the
    bounds, and optionally fast_rollout."""
    import torch
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import adjoint

    def host_ms(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]

    def grad_run(rollout, k):
        return lambda: run_grad(shape, state, rollout, k)

    fb_ms = host_ms(grad_run(lambda sh, st, k: diff.grad_rollout(
        sh, st, k, segment=SEG), GRAD_STEPS)) / GRAD_STEPS
    fwd_ms = host_ms(lambda: diff.adjoint_rollout(
        shape, state, GRAD_STEPS, segment=SEG)) / GRAD_STEPS
    trace = adjoint.trace_run(shape, state, SEG)
    cts = seeded_cotangents(shape.n_masses, trace.device)
    tr_wrap = event_ms(lambda k: adjoint.trace_run(shape, state, k), SEG)
    bw_wrap = event_ms(lambda k: adjoint.bwd_run(shape, state, trace, *cts),
                       SEG)
    ptr = adjoint.trace_run_plain(shape, state, 10)
    tr_plain = event_ms(lambda k: adjoint.trace_run_plain(shape, state, k),
                        10)
    bw_plain = event_ms(lambda k: adjoint.bwd_run_plain(
        shape, state, ptr, *cts), 10)
    reps = 3
    bwd_names = ("bwd_mid_kernel", "bwd_force_kernel", "bwd_spring_kernel")
    dev = profile_device_us(lambda: [(
        adjoint.trace_run(shape, state, SEG),
        adjoint.bwd_run(shape, state, trace, *cts)) for _ in range(reps)],
        ("adjoint_trace_kernel",) + bwd_names)
    per_launch = {k: t / c for k, (t, c) in dev.items()}
    # a kernel's ms: its device time per step, without the wrapper's host
    # staging; the wrapper's event time where the profiler saw nothing
    tr_ms = (dev["adjoint_trace_kernel"][0] / (reps * SEG) / 1e3
             if "adjoint_trace_kernel" in dev else tr_wrap)
    bw_ms = (sum(dev[k][0] for k in bwd_names if k in dev)
             / (reps * SEG) / 1e3
             if "bwd_force_kernel" in dev else bw_wrap)
    (tb, tby), (bb, bby) = adjoint_bound_ms(shape, state, SEG)
    print(f"timing {name} gradient path: forward + backward "
          f"{fb_ms * 1e3:.3f} us/step over {GRAD_STEPS} steps (host clock, "
          f"the host's Python, launches and allocations included; forward "
          f"alone "
          f"{fwd_ms * 1e3:.3f} us/step)")
    def src(kernel):
        return ("profiler device time" if kernel in dev else
                "NOT the device time: the profiler recorded none, so this "
                "is the wrapper's CUDA-event time")
    print(f"timing {name} adjoint_trace: {tr_ms * 1e3:.3f} us/step "
          f"({SEG}-step segment, {src('adjoint_trace_kernel')}), bound {tb * 1e3:.4f} us/step "
          f"by {tby}, {100 * tb / tr_ms:.2f}% of bound; wrapper "
          f"{tr_wrap * 1e3:.3f} us/step (CUDA events, host staging "
          f"included); plain {tr_plain * 1e3:.1f} us/step")
    print(f"timing {name} adjoint_bwd: {bw_ms * 1e3:.3f} us/step "
          f"({SEG}-step trace, {src('bwd_force_kernel')}), bound {bb * 1e3:.4f} us/step by "
          f"{bby}, {100 * bb / bw_ms:.2f}% of bound; wrapper "
          f"{bw_wrap * 1e3:.3f} us/step (CUDA events, host staging "
          f"included); plain {bw_plain * 1e3:.1f} us/step")
    print(f"{name}: torch.profiler us per launch: "
          + (", ".join(f"{k} {v:.3f}" for k, v in per_launch.items())
             if per_launch else "not measured (no device time recorded)"))
    if fast:
        profile_grad_path(name, shape, state)
        _, _, _, eager = counters()
        eager.steps = 0
        fr_ms = host_ms(grad_run(lambda sh, st, k: diff.fast_rollout(
            sh, st, k, segment=k), 20), reps=1) / 20
        print(f"timing {name} fast_rollout (fused forward, eager-recompute "
              f"backward): {fr_ms * 1e3:.1f} us/step over 20 steps "
              f"({eager.steps} eager steps), {fr_ms / fb_ms:.1f}x the "
              "adjoint's")
    return (dict(ms=tr_ms, wrapper_ms=tr_wrap, plain_ms=tr_plain,
                 bound_ms=tb, bound_by=tby),
            dict(ms=bw_ms, wrapper_ms=bw_wrap, plain_ms=bw_plain,
                 bound_ms=bb, bound_by=bby))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import titan_tpu_torch as titan
    from titan_tpu_torch.ops import fused_step

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, devices: "
          f"{torch.cuda.device_count()}")

    # 1 and a. build both sources, one nvcc each, started together
    build_kernels(("fused_step", "adjoint"))

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

    # b. the adjoint kernels against their plain versions, small scenes
    for variant in VARIANTS:
        adjoint_vs_plain(*variant_scene(titan, variant), 20, variant)

    # 3. the main paths through the public API, then kernel vs plain from
    # each one's landed (contact) state; 4. timing from that state
    kernels, landed = [], []
    for name, make, nx in (("bench 43^3", bench_scene, 43),
                           ("entry 20^3", entry_scene, 20)):
        launches, (shape, state) = drive(make(titan), name, 3.5)
        landed.append((name, shape, state))
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

    # c. the gradient path from each landed state; d. system id at 43^3;
    # e. timing
    for i, (name, shape, state) in enumerate(landed):
        tr_launches, bwd_launches, (tr_err, abs_err, rel_err) = grad_path(
            name, shape, state)
        if i == 0:
            system_id(shape, state)
        tr_t, bwd_t = time_adjoint(name, shape, state, fast=i == 0)
        for kname, line, n_launch, t in (
                ("adjoint_trace", 1283, tr_launches, tr_t),
                ("adjoint_bwd", 1384, bwd_launches, bwd_t)):
            kernels.append(dict(
                name=f"{kname} ({name})", route="cuda",
                source="titan_tpu_torch/csrc/adjoint.cu",
                replaces=f"titan_tpu/ops/adjoint.py:{line}",
                launches=n_launch,
                max_abs_err=tr_err if kname == "adjoint_trace" else abs_err,
                **({} if kname == "adjoint_trace"
                   else dict(max_rel_err=rel_err)),
                **t, library_ms=None))

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
