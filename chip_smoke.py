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
  f. build csrc/magnets.cu (pairwise field) and csrc/magnets_grid.cu (grid
     field) beside the others, all four nvcc started together;
  g. each field kernel against its plain version (forces.magnet_forces,
     magnets_grid.grid_magnet_forces_plain) at the same positions on small
     scenes -- 400 random magnets, an overflowing cell (cap 8, where the
     grid field must also be the binned pass's), deleted and
     zero-parameter sources, edge-clipped masses, a 16-link RobotLink --
     within TOL_FIELD * max |plain|;
  h. the fused step fed the plain field against fused_chunk_plain fed the
     same field, bitwise (RobotLink under Euler, Verlet and RK2; a
     2,000-particle grid swarm);
  i. each whole magnet route (field kernel + fused step) against the plain
     route over 100 steps, Euler, Verlet and RK2, within TOL_ROUTE, the
     field and step launches equal to the force passes; and a binned scene
     whose magnet_grid flag the JAX package's TPU rule turns off
     (use_pallas=False, cap 12) still on the grid kernel, no binned pass;
  j. the two magnet main paths through the public API, start -> wait ->
     getAll -> resume at 4 breakpoints -> stop, every count set to 0 just
     before and read just after: 1,024 RobotLinks (scripts/
     tpu_robotlink_ab.py's build, 2,048 masses, 0.05 s at dt 1e-5; the
     pairwise field) and examples/magnetic_swarm.py's 50,000 particles
     (0.02 s at dt 1e-5; the grid field).  The field kernel's and the step
     kernel's launches must equal the force passes, with no binned pass
     and no eager step; the swarm's mean height must fall, and in the
     RobotLink scene every mass with another link inside the cutoff must
     feel that link's field.  From each final state, the fused step fed the
     plain field against its plain version (bitwise) and the field kernel
     against its plain version, each element within TOL_FIELD * the sum of
     |terms| it adds up (the RobotLink field also with only the even, then
     only the odd, masses valid: no link partner, whose collapsed 1/r^2
     pull hides every other term);
  k. time each path: the whole route per step (CUDA events), each kernel's
     device time per launch (torch.profiler) beside its bound, the plain
     versions, and the host time of the grid setup per pass (grid_setup
     timed alone);
  l. gradient routing: diff.grad_rollout over 20 steps of a 16-link scene
     runs fast_rollout (the adjoint refuses magnets); its backward must
     launch no adjoint and no magnet kernel, run 20 eager steps and give
     finite gradients;
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


# ---------------------------------------------------------------------------
# Magnets (phases f-l): the pairwise and grid field kernels, the fused
# step's magnet route, the RobotLink and magnetic-swarm main paths
# ---------------------------------------------------------------------------

# field kernel vs its plain version at the same positions:
# max |kernel - plain| <= TOL_FIELD * max |plain| (f32 pair sums in another
# order: the pairwise kernel's 32 lane partial sums and shuffle tree)
TOL_FIELD = 2e-5
# a whole magnet route (field kernel + fused step) against the plain route
# over 100 steps: |d| <= TOL_ROUTE (1 + |plain|) on pos and vel; the
# pairwise field's other sum order, carried through 100 steps of contact
TOL_ROUTE = 1e-4
# ops of one candidate magnet pair: the test every pair needs (difference
# 3, |d|^2 5, sqrt, cutoff compare) and the force of a pair inside the
# cutoff (shell 4, pull 2, coefficient 2, accumulate 6); and the bytes per
# mass that either field must move (position and four magnet parameters
# as f32 and the validity flag as one byte read, the field written)
OPS_PAIR_TEST, OPS_PAIR_FORCE, FIELD_BYTES_PER_MASS = 10, 14, 41


def magnet_counters():
    """The objects that carry the magnet paths' launch and pass counts."""
    from titan_tpu_torch.ops import fused_step, magnets, magnets_grid
    from titan_tpu_torch.ops import step as tstep
    return dict(fused=fused_step.fused_chunk,
                pairwise=magnets.pairwise_magnet_field,
                grid=magnets_grid.grid_magnet_forces,
                binned=magnets.binned_magnet_forces,
                eager=tstep.run_eager)


def zero_magnet_counts():
    c = magnet_counters()
    for k in ("fused", "pairwise", "grid"):
        c[k].launches = 0
    c["binned"].passes = 0
    c["eager"].steps = 0


def read_magnet_counts():
    c = magnet_counters()
    return dict(fused=c["fused"].launches, pairwise=c["pairwise"].launches,
                grid=c["grid"].launches, binned=c["binned"].passes,
                eager=c["eager"].steps)


def link_sim(titan, n_links, magnetic_force=1.0, spread=1.0, z=1.2,
             dt=1e-5, **cfg):
    """``n_links`` RobotLinks as scripts/tpu_robotlink_ab.py builds them
    (seed 0, positions U(-spread, spread)^3 + (0, 0, z), link 0.06 m, mass
    0.1, lengths 0.08 / 0.04, rate 0.02, k 5000; odd links expand, even
    ones contract) over a 0.4 / 0.6 friction plane, g = -9.8."""
    import numpy as np
    rng = np.random.RandomState(0)
    sim = titan.Simulation(titan.SimConfig(device="cuda", **cfg))
    links = []
    for _ in range(n_links):
        p = rng.uniform(-spread, spread, 3) + [0, 0, z]
        links.append(sim.createRobotLink(
            titan.Vec(*p), titan.Vec(*(p + [0.06, 0, 0])), 0.1, 0.08, 0.04,
            0.02, 5000.0, magnetic_force))
    for i, link in enumerate(links):
        (link.expand if i % 2 else link.contract)()
    sim.createPlane(titan.Vec(0, 0, 1), 0, 0.4, 0.6)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.setTimeStep(dt)
    return sim


def swarm_sim(titan, n=50_000, dt=1e-5, **cfg):
    """examples/magnetic_swarm.py at ``n`` particles: the store filled as
    the example fills it (seed 0, ~4 particles per grid cell), plane z < 0,
    drag 0.5, g = -9.8."""
    import numpy as np
    rng = np.random.RandomState(0)
    sim = titan.Simulation(titan.SimConfig(
        device="cuda", host_store_dtype="float32", **cfg))
    spread = 0.5 * 0.14 * (n / 4.0) ** 0.5
    st = sim._store
    st.reserve_masses(n)
    st.pos[:n] = rng.uniform(-spread, spread, (n, 3))
    st.pos[:, 2] += spread + 0.5
    st.valid[:n] = True
    st.n_masses = n
    st.m[:n] = 0.1
    st.mag_rad[:n] = rng.uniform(0.01, 0.04, n)
    st.mag_stiffness[:n] = rng.uniform(50, 200, n)
    st.mag_maxf[:n] = 1e-4
    st.mag_scale[:n] = 1.0
    st.drag[:n] = 0.5
    sim.createPlane(titan.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.setTimeStep(dt)
    return sim


def cloud_sim(titan, n=400, seed=0, spread=1.5, edit=None):
    """tests/test_magnets_binned.py's random magnet cloud on the card."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sim = titan.Simulation(titan.SimConfig(device="cuda",
                                           magnet_binned_threshold=10**9))
    st = sim._store
    for _ in range(n):
        sim.createMass(titan.Vec(*rng.uniform(-spread, spread, 3)))
    st.mag_rad[:n] = rng.uniform(0.01, 0.05, n)
    st.mag_stiffness[:n] = rng.uniform(100, 500, n)
    st.mag_maxf[:n] = rng.uniform(0.0, 2.0, n)
    st.mag_scale[:n] = rng.choice([0.0, 1.0], n)
    if edit == "deleted_zero_param":
        st.valid[[7, 123]] = False
        for i in (3, 50, 200):
            st.mag_rad[i] = st.mag_stiffness[i] = 0.0
            st.mag_maxf[i] = st.mag_scale[i] = 0.0
        st.pos[300] = (2.5, 2.5, 0.0)
        st.mag_rad[300], st.mag_stiffness[300] = 0.06, 200.0
        st.pos[301] = (2.53, 2.5, 0.0)
        st.mag_rad[301] = st.mag_stiffness[301] = 0.0
        st.mag_maxf[301] = st.mag_scale[301] = 0.0
    elif edit == "edge":
        # clipped into the grid's edge cell, far outside its +-17.9 m span
        st.pos[:n] = np.asarray([-30.0, -30.0, 0.0]) \
            + rng.uniform(0, 0.3, (n, 3))
        st.mag_rad[:n] = 0.04
    return sim


def marshalled(sim):
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


def field_vs_plain(titan):
    """Phase g: each field kernel against its plain version at the same
    positions on small scenes.  Returns each kernel's largest max
    |kernel - plain| and largest max |kernel - plain| / max |plain|."""
    import torch
    from titan_tpu_torch.ops import forces as F
    from titan_tpu_torch.ops import magnets, magnets_grid
    cut = 0.14
    scenes = [("400 random magnets", cloud_sim(titan), 16),
              ("overflow (64 in ~one cell, cap 8)",
               cloud_sim(titan, n=64, seed=4, spread=0.01), 8),
              ("deleted and zero-parameter sources",
               cloud_sim(titan, seed=5, edit="deleted_zero_param"), 16),
              ("edge-clipped masses", cloud_sim(titan, n=96, seed=6,
                                                edit="edge"), 128),
              ("16-link RobotLink", link_sim(titan, 16, spread=0.15,
                                             z=0.2), 16)]
    worst = dict(pairwise=(0.0, 0.0), grid=(0.0, 0.0))
    for label, sim, cap in scenes:
        _, state = marshalled(sim)
        m = state.masses
        pw = magnets.pairwise_magnet_field(m, cut)
        pw_plain = F.magnet_forces(m, cut)
        gr = magnets_grid.grid_magnet_forces(m, cut, cap)
        gr_plain = magnets_grid.grid_magnet_forces_plain(m, cut, cap)
        torch.cuda.synchronize()
        out = []
        for kname, a, b in (("pairwise", pw, pw_plain),
                            ("grid", gr, gr_plain)):
            check(bool(torch.isfinite(a).all()), f"{label}: {kname} field "
                  "not finite")
            d = float((a - b).abs().max())
            scale = float(b.abs().max())
            worst[kname] = (max(worst[kname][0], d),
                            max(worst[kname][1], d / max(scale, 1e-30)))
            out.append(f"{kname} max |d| {d:.3e} of max |plain| "
                       f"{scale:.3e}")
            check(d <= TOL_FIELD * scale, f"{label}: {kname} kernel "
                  f"disagrees with its plain version: {d:.3e} > "
                  f"{TOL_FIELD} * {scale:.3e}")
            check(scale > 0, f"{label}: {kname} field is all zero")
        if cap == 8:
            # the overflow rule: the grid field is the binned pass's
            a_cells = sim._shape.n_masses
            bn = magnets.binned_magnet_forces(m, cut, a_cells, cap)
            d = float((gr_plain - bn).abs().max())
            out.append(f"grid plain vs binned pass max |d| {d:.3e}")
            check(d <= TOL_FIELD * float(bn.abs().max()),
                  f"{label}: grid plain differs from the binned pass")
        print(f"field kernels vs plain [{label}]: " + "; ".join(out)
              + f" (tolerance {TOL_FIELD} * max |plain|)")
    return worst


def fed_field_bitwise(titan):
    """Phase h: the fused step fed a given field (the plain one) against
    fused_chunk_plain fed the same field, 50 steps: bitwise."""
    import torch
    from titan_tpu_torch.ops import fused_step
    cases = []
    for integ in ("EULER", "VERLET", "RK2"):
        cases.append((f"16-link RobotLink, {integ}", link_sim(
            titan, 16, magnetic_force=0.02, spread=0.15, z=0.2, dt=1e-4,
            integrator=getattr(titan.Integrator, integ))))
    cases.append(("2,000-particle swarm, grid", swarm_sim(
        titan, 2000, dt=1e-4, magnet_binned_threshold=1,
        magnet_grid_threshold=1)))
    for label, sim in cases:
        shape, state = marshalled(sim)
        check(fused_step.fused_reject_reason(shape) is None, label)
        field = fused_step.magnet_field_fn(shape, state, plain=True)
        got = fused_step._fused_chunk_cuda(shape, state, 50, field=field)
        want = fused_step.fused_chunk_plain(shape, state, 50, field=field)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(got.masses, f),
                               getattr(want.masses, f))
                   for f in ("pos", "vel", "acc")) \
            and torch.equal(got.stencil.rest, want.stencil.rest)
        d = float((got.masses.vel - want.masses.vel).abs().max())
        print(f"fused step fed the plain field vs fused_chunk_plain fed it "
              f"[{label}, 50 steps]: {'bitwise' if same else 'DIFFERENT'}"
              f" (max |d| vel {d:.3e})")
        check(same, f"{label}: the fused step fed a field differs from its "
              "plain version")


def routes_vs_plain(titan):
    """Phase i: each whole magnet route (field kernel + fused step) against
    the plain route over 100 steps, for Euler, Verlet and RK2, and once
    for a binned scene whose magnet_grid flag the JAX package's TPU rule
    turns off (use_pallas=False, a cell cap of 12): the fused step takes
    the grid kernel all the same.  Returns the largest max |d| of each
    kernel's route."""
    import torch
    from titan_tpu_torch.ops import fused_step
    worst = {}
    cases = [(r, i) for r in ("pairwise", "grid")
             for i in ("EULER", "VERLET", "RK2")]
    cases.append(("grid, magnet_grid off", "EULER"))
    for route, integ in cases:
        kernel = route.split(",")[0]
        kw = dict(dt=1e-4, integrator=getattr(titan.Integrator, integ))
        if kernel == "pairwise":
            sim = link_sim(titan, 16, magnetic_force=0.02, spread=0.15,
                           z=0.2, **kw)
        else:
            if route != "grid":
                kw.update(use_pallas=False, magnet_cell_cap=12)
            sim = swarm_sim(titan, 2000, magnet_binned_threshold=1,
                            magnet_grid_threshold=1, **kw)
        shape, state = marshalled(sim)
        check(bool(shape.magnet_binned) == (kernel == "grid")
              and bool(shape.magnet_grid) == (route == "grid"), route)
        zero_magnet_counts()
        got = fused_step.fused_chunk(shape, state, 100)
        counts = read_magnet_counts()
        want = fused_step.fused_chunk_plain(shape, state, 100)
        torch.cuda.synchronize()
        passes = 100 * (2 if integ == "RK2" else 1)
        check(counts[kernel] == passes == counts["fused"]
              and counts["binned"] == 0,
              f"{route} {integ}: launches {counts}, {passes} passes")
        errs = []
        for f in ("pos", "vel"):
            a, b = getattr(got.masses, f), getattr(want.masses, f)
            d = (a - b).abs()
            check(bool(torch.isfinite(a).all()), f"{route}: non-finite")
            errs.append(float(d.max()))
            check(bool((d <= TOL_ROUTE * (1 + b.abs())).all()),
                  f"{route} {integ}: route differs from plain by "
                  f"{errs[-1]:.3e} in {f}")
        worst[kernel] = max(worst.get(kernel, 0.0), *errs)
        print(f"{route} route vs plain route [{integ}, 100 steps]: max "
              f"|d| pos {errs[0]:.3e}, vel {errs[1]:.3e} (tolerance "
              f"{TOL_ROUTE} (1 + |plain|)); {counts[kernel]} field and "
              f"{counts['fused']} step launches, {counts['binned']} binned "
              "passes")
    return worst


def drive_magnets(sim, name, t_total, field_kernel):
    """A magnet main path through the public API: start -> wait -> getAll
    -> resume at 4 breakpoints -> stop, with every count set to 0 just
    before and read just after.  The field kernel's and the step kernel's
    launches must equal the force passes, with no binned pass and no eager
    step.  Returns (counts, steps, the final (shape, state), the mean z
    before and after, wall s)."""
    import numpy as np
    import torch
    n = sim._store.n_masses
    z0 = float(sim._store.pos[:n, 2].mean())
    t0 = time.perf_counter()
    zero_magnet_counts()
    sim.start()
    for k in range(4):
        sim.wait(t_total / 4)
        sim.getAll()
        if k < 3:
            sim.resume()
    final = (sim._shape, sim._snapshot())
    t_end = sim.time()
    sim.stop()
    torch.cuda.synchronize()
    counts = read_magnet_counts()
    wall = time.perf_counter() - t0
    steps = int(round(t_end / sim.getTimeStep()))
    pos = sim._store.pos[:n]
    z1 = float(pos[:, 2].mean())
    other = "grid" if field_kernel == "pairwise" else "pairwise"
    print(f"main path {name}: {n} masses, {steps} steps to t={t_end:.5f} s "
          f"in {wall:.2f} s wall; launches: fused_step {counts['fused']}, "
          f"{field_kernel} field {counts[field_kernel]}, other field "
          f"kernel {counts[other]}"
          f", binned passes {counts['binned']}, eager steps "
          f"{counts['eager']}; mean z {z0:.5f} -> {z1:.5f}")
    check(abs(t_end - t_total) < 1e-9, f"{name}: time {t_end}")
    check(counts["fused"] == steps == counts[field_kernel],
          f"{name}: launches {counts} for {steps} force passes")
    check(counts["binned"] == 0 and counts["eager"] == 0,
          f"{name}: binned passes or eager steps ran: {counts}")
    check(np.isfinite(pos).all(), f"{name}: non-finite state")
    return counts, steps, final, (z0, z1), wall


def pair_terms(m, cut):
    """The plain pairwise field's terms on masses ``m`` (as
    forces.magnet_forces computes them, all N^2 at once): (sum over the
    sources of |term|, [3, N]; the receivers with a source at a nonzero
    distance inside the cutoff, [N] bool; the number of such pairs)."""
    import torch
    n = m.pos.shape[1]
    idx = torch.arange(n, device=m.pos.device)
    e = m.pos[:, :, None] - m.pos[:, None, :]
    d2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    dist = torch.sqrt(d2)
    ok = ((dist < cut) & (idx[:, None] != idx[None, :])
          & m.valid[:, None] & m.valid[None, :])
    inter = dist - (m.mag_rad[:, None] + m.mag_rad[None, :])
    shell = torch.where(inter < 0, inter.abs() * m.mag_stiffness[:, None],
                        0.0)
    attract = (m.mag_scale[None, :] * m.mag_maxf[:, None]
               / torch.clamp(d2, min=1e-12))
    coeff = torch.where(ok, (shell - attract)
                        / torch.where(dist > 0, dist, 1.0), 0.0)
    inside = ok & (d2 > 0)
    return ((e.abs() * coeff.abs()[None]).sum(2), inside.any(1),
            int(inside.sum()))


def pairwise_full_size(shape, state, name):
    """The pairwise kernel against its plain version at the RobotLink
    path's final state, each element within TOL_FIELD * the sum of |terms|
    it adds up (the rounding of a sum taken in another order): with every
    mass valid, then with only the even and only the odd masses valid, so
    that no mass has its link partner as a source (a collapsed link's
    1/r^2 pull, up to 1e12 N at the 1e-12 m^2 floor, hides every other
    term of its ends).  The physical check rides on the last two: each
    mass with a mass of another link inside the cutoff must feel a
    nonzero field, and every other mass none.  Returns (max |d|, max |d| /
    sum |terms|, masses near another link, of which feel a field, whether
    all others feel none)."""
    import dataclasses
    import torch
    from titan_tpu_torch.ops import forces as F
    from titan_tpu_torch.ops import magnets
    m = state.masses
    cut = shape.config.magnet_cutoff
    idx = torch.arange(m.pos.shape[1], device=m.pos.device)
    worst = [0.0, 0.0]
    n_near = n_felt = 0
    alone_zero = True
    for label, sel in (("every mass", m.valid),
                       ("even masses", m.valid & (idx % 2 == 0)),
                       ("odd masses", m.valid & (idx % 2 == 1))):
        mm = dataclasses.replace(m, valid=sel)
        a = magnets.pairwise_magnet_field(mm, cut)
        b = F.magnet_forces(mm, cut)
        s, near, _ = pair_terms(mm, cut)
        d = (a - b).abs()
        rel = float(torch.where(s > 0, d / torch.where(s > 0, s, 1.0),
                                0.0).max())
        worst = [max(worst[0], float(d.max())), max(worst[1], rel)]
        print(f"{name}: pairwise field kernel vs plain at the final state "
              f"[{label} valid]: max |d| {float(d.max()):.3e}, max |d| / "
              f"sum |terms| {rel:.3e} (tolerance {TOL_FIELD}) over "
              f"{int(near.sum())} receivers with a source inside the "
              f"cutoff; max |plain| {float(b.abs().max()):.3e}")
        check(bool((d <= TOL_FIELD * s).all()),
              f"{name} [{label} valid]: full-size pairwise field disagrees")
        if label != "every mass":
            felt = a.abs().amax(0) > 0
            n_near += int(near.sum())
            n_felt += int((felt & near).sum())
            alone_zero &= not bool((felt & sel & ~near).any())
    return (*worst, n_near, n_felt, alone_zero)


def grid_pairs(state, cap, cut):
    """(candidate pairs, of which at a nonzero distance inside the cutoff)
    that the grid kernel walks on this state: each valid receiver's 3 x 3
    neighbour cells, the first ``cap`` sources of each."""
    import torch
    from titan_tpu_torch.ops import magnets_grid
    G = magnets_grid.GRID_DIM
    m = state.masses
    n = m.pos.shape[1]
    cell, starts, src = magnets_grid.grid_setup(m, cut)
    starts = starts.long()
    cell = cell.long()
    real = cell < G * G
    cx, cy = cell // G, cell % G
    cand = torch.zeros((), dtype=torch.int64, device=m.pos.device)
    near = torch.zeros_like(cand)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            x, y = cx + dx, cy + dy
            ok = real & (x >= 0) & (x < G) & (y >= 0) & (y < G)
            cc = torch.where(ok, x * G + y, 0)
            s0 = starts[cc]
            cnt = torch.where(ok, torch.clamp(starts[cc + 1] - s0, max=cap),
                              0)
            cand += cnt.sum()
            for k in range(cap):
                e = m.pos - src[:3, torch.clamp(s0 + k, max=n - 1)]
                d2 = (e * e).sum(0)
                near += ((k < cnt) & (d2 > 0)
                         & (torch.sqrt(d2) < cut)).sum()
    return int(cand), int(near)


def field_bound_ms(n, candidates, inside):
    """(ms, "bytes" or "operations"): the least time of one field pass
    over ``n`` masses, ``candidates`` pairs tested of which ``inside``
    are inside the cutoff."""
    tb = FIELD_BYTES_PER_MASS * n / HBM_BYTES_PER_S * 1e3
    to = ((OPS_PAIR_TEST * candidates + OPS_PAIR_FORCE * inside)
          / F32_FLOPS_PER_S * 1e3)
    return (tb, "bytes") if tb >= to else (to, "operations")


def profile_route(name, fn, n_steps, names):
    """fn() under torch.profiler: prints the device's busy share of the
    wall time, the device time of the kernels that take the most of it, and
    the host operations that take the most host time; returns
    {kernel: (device us, launches)} for each kernel in ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, kern, out = 0.0, [], {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if e.device_type == torch.autograd.DeviceType.CUDA and t:
            dev += t
            kern.append((t, e.key, e.count))
        for k in names:
            if k in e.key and e.count and t:
                out[k] = (t, e.count)
    kern.sort(reverse=True)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"profile {name} ({n_steps} steps, profiler on): wall "
          f"{wall_us:.0f} us, device busy {dev:.0f} us "
          f"({100 * dev / wall_us:.1f}%); device time: "
          + ", ".join(f"{k[:40]} {t:.0f} us x{c}" for t, k, c in kern[:5])
          + "; host self time: "
          + ", ".join(f"{e.key} {e.self_cpu_time_total:.0f} us x{e.count}"
                      for e in host[:8]))
    return out


def time_magnet_path(name, shape, state, field_kernel, n_steps):
    """Phase k from the path's final state: ms per step of the whole route
    (CUDA events), each kernel's device time per launch (torch.profiler),
    the field's plain version, the fused step's plain version fed a fixed
    field, the bounds, and the host time of the grid setup per pass
    (``grid_setup`` enqueued alone, no synchronisation in between)."""
    import torch
    from titan_tpu_torch.ops import fused_step, magnets_grid
    from titan_tpu_torch.ops import forces as F
    cut = shape.config.magnet_cutoff
    m = state.masses
    n = shape.n_masses
    kname = ("pairwise_magnet_kernel" if field_kernel == "pairwise"
             else "grid_magnet_kernel")

    def route(k):
        fused_step.fused_chunk(shape, state, k)

    route(20)
    torch.cuda.synchronize()
    step_ms = event_ms(route, n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route(n_steps)
    host_us = (time.perf_counter() - t0) / n_steps * 1e6
    torch.cuda.synchronize()
    if field_kernel == "grid":
        t0 = time.perf_counter()
        for _ in range(n_steps):
            magnets_grid.grid_setup(m, cut)
        setup_us = (time.perf_counter() - t0) / n_steps * 1e6
        torch.cuda.synchronize()
    dev = profile_route(name, lambda: route(n_steps), n_steps,
                        ("fused_step_kernel", kname))
    per = {k: t / c for k, (t, c) in dev.items()}
    if field_kernel == "pairwise":
        plain_field = lambda k: [F.magnet_forces(m, cut)  # noqa: E731
                                 for _ in range(k)]
        n_valid = int(m.valid.sum())
        pairs, inside = n_valid * (n_valid - 1), pair_terms(m, cut)[2]
    else:
        cap = shape.magnet_binned[1]
        plain_field = lambda k: [  # noqa: E731
            magnets_grid.grid_magnet_forces_plain(m, cut, cap)
            for _ in range(k)]
        pairs, inside = grid_pairs(state, cap, cut)
    field_plain_ms = event_ms(plain_field, 2)
    fixed = fused_step.magnet_field_fn(shape, state, plain=True)(m.pos)
    fused_plain_ms = event_ms(lambda k: fused_step.fused_chunk_plain(
        shape, state, k, field=lambda pos: fixed), 5)
    field_bound = field_bound_ms(n, pairs, inside)
    (step_bound, step_by), _, _ = bound_ms_per_step(shape, state, n_steps)
    field_ms = per.get(kname, 0.0) / 1e3
    fused_ms = per.get("fused_step_kernel", 0.0) / 1e3
    print(f"timing {name}: {step_ms * 1e3:.3f} us/step for the whole route "
          f"(CUDA events, {n_steps}-step chunk; host enqueue "
          f"{host_us:.3f} us/step"
          + (f", of which the grid setup's enqueue {setup_us:.3f} us/pass"
             if field_kernel == "grid" else "") + ")")
    print(f"timing {name}: torch.profiler device time per launch: "
          + (", ".join(f"{k} {v:.3f} us" for k, v in per.items())
             if per else "not measured (no device time recorded)")
          + f"; {kname} bound {field_bound[0] * 1e3:.4f} us by "
          f"{field_bound[1]} ({pairs} candidate pairs x {OPS_PAIR_TEST} "
          f"ops + {inside} inside the cutoff x {OPS_PAIR_FORCE} more at 67 "
          f"TFLOP/s; {FIELD_BYTES_PER_MASS * n} B at 3.35 TB/s); "
          "fused_step bound "
          f"{step_bound * 1e3:.4f} us/step by {step_by}; plain field "
          f"{field_plain_ms * 1e3:.1f} us/pass, plain fused step "
          f"{fused_plain_ms * 1e3:.1f} us/step")
    check(field_ms > 0 and fused_ms > 0, f"{name}: the profiler recorded no "
          "device time for the path's kernels")
    return (dict(ms=field_ms, plain_ms=field_plain_ms,
                 bound_ms=field_bound[0], bound_by=field_bound[1],
                 candidate_pairs=pairs, pairs_inside_cutoff=inside),
            dict(ms=fused_ms, path_ms=step_ms, plain_ms=fused_plain_ms,
                 bound_ms=step_bound, bound_by=step_by,
                 host_us_per_step=host_us,
                 **({"setup_host_us_per_pass": setup_us}
                    if field_kernel == "grid" else {})))


def magnet_grad_routing(titan):
    """Phase l: diff.grad_rollout over 20 steps of a 16-link scene.  The
    adjoint refuses magnets, so it runs fast_rollout: the forward is the
    fused chunk (with the pairwise kernel), the backward recomputes the
    steps eagerly and launches no adjoint and no magnet kernel."""
    import torch
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops.adjoint import adjoint_reject_reason
    shape, state = marshalled(link_sim(titan, 16, magnetic_force=0.02,
                                       spread=0.15, z=0.2, dt=1e-4))
    check("magnets" in (adjoint_reject_reason(shape) or ""),
          "the adjoint accepts a magnet scene")
    fwd, tr, bwd, eager = counters()
    leaves, st = grad_leaves(state)
    wpos, wvel = grad_loss_weights(state)
    zero_magnet_counts()
    tr.launches = bwd.launches = 0
    out = diff.grad_rollout(shape, st, 20)
    torch.cuda.synchronize()
    f_counts = read_magnet_counts()
    f_adj = tr.launches + bwd.launches
    zero_magnet_counts()
    loss = torch.sum(out.masses.pos * wpos) + torch.sum(out.masses.vel * wvel)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    b_counts = read_magnet_counts()
    b_adj = tr.launches + bwd.launches
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"gradient routing (16-link RobotLink, grad_rollout 20 steps): "
          f"adjoint refuses ({adjoint_reject_reason(shape)}); forward: "
          f"fused_step {f_counts['fused']}, pairwise field "
          f"{f_counts['pairwise']}, adjoint {f_adj}, eager steps "
          f"{f_counts['eager']}; backward: pairwise field "
          f"{b_counts['pairwise']}, grid field {b_counts['grid']}, adjoint "
          f"{b_adj}, eager steps {b_counts['eager']}; gradients finite: "
          f"{finite}; |d loss / d pos|max {float(grads[0].abs().max()):.3e}")
    check(f_adj == 0 and b_adj == 0, "an adjoint kernel ran on a magnet "
          "scene")
    check(b_counts["pairwise"] == 0 and b_counts["grid"] == 0,
          "a magnet kernel ran inside the backward")
    check(b_counts["eager"] == 20, f"backward ran {b_counts['eager']} "
          "eager steps, not 20")
    check(finite and float(grads[0].abs().max()) > 0,
          "magnet gradients are not finite or all zero")


def magnet_phases(titan, kernels):
    """Phases g-l; appends the magnet entries to ``kernels``."""
    worst_field = field_vs_plain(titan)
    fed_field_bitwise(titan)
    worst_route = routes_vs_plain(titan)

    # j. the two main paths; k. timing from each one's final state
    paths = (("RobotLink 1,024 links", lambda: link_sim(titan, 1024), 0.05,
              "pairwise", "magnet_pairwise", "csrc/magnets.cu",
              "titan_tpu/ops/pallas_step.py:405"),
             ("magnetic swarm 50k", lambda: swarm_sim(titan), 0.02, "grid",
              "magnets_grid", "csrc/magnets_grid.cu",
              "titan_tpu/ops/magnets_grid.py:64"))
    for name, make, t_total, fk, kname, src, replaces in paths:
        sim = make()
        counts, steps, (shape, state), (z0, z1), wall = drive_magnets(
            sim, name, t_total, fk)
        if fk == "pairwise":
            check(shape.n_masses == 2048 and not shape.magnet_binned
                  and shape.stencil_deltas == (1,), f"{name}: {shape}")
            full = pairwise_full_size(shape, state, name)
            n_near, n_felt, far_ok = full[2:]
            print(f"{name}: at t={t_total} s, with link partners left out "
                  f"as sources, {n_near} masses have a mass of another "
                  f"link inside the cutoff and {n_felt} of them feel a "
                  f"field; all other masses feel none: {far_ok}")
            check(n_near > 0 and n_felt == n_near and far_ok,
                  f"{name}: cross-link fields wrong")
        else:
            check(shape.magnet_grid and shape.magnet_binned == (50000, 16)
                  and not shape.magnet_receivers
                  and not shape.stencil_deltas, f"{name}: {shape}")
            check(z1 < z0 - 1e-3, f"{name}: mean z did not fall "
                  f"({z0:.5f} -> {z1:.5f})")
            full = grid_full_size(shape, state, name)
        fed = fused_vs_fed_plain(shape, state, 20, name)
        field_t, fused_t = time_magnet_path(name, shape, state, fk,
                                            200 if fk == "pairwise" else 100)
        kernels.append(dict(
            name=f"{kname} ({name})", route="cuda",
            source=f"titan_tpu_torch/{src}", replaces=replaces,
            launches=counts[fk], max_abs_err=max(worst_field[fk][0], full[0]),
            max_rel_err=max(worst_field[fk][1], full[1]),
            route_max_abs_err=worst_route[fk], **field_t, library_ms=None))
        kernels.append(dict(
            name=f"fused_step ({name})", route="cuda",
            source="titan_tpu_torch/csrc/fused_step.cu",
            replaces="titan_tpu/ops/pallas_step.py:185",
            launches=counts["fused"], max_abs_err=fed, **fused_t,
            library_ms=None))
    magnet_grad_routing(titan)


def fused_vs_fed_plain(shape, state, steps, name):
    """The fused step against fused_chunk_plain, both fed the plain field,
    from a full-size state: must be bitwise; returns max |d|."""
    import torch
    from titan_tpu_torch.ops import fused_step
    field = fused_step.magnet_field_fn(shape, state, plain=True)
    got = fused_step._fused_chunk_cuda(shape, state, steps, field=field)
    want = fused_step.fused_chunk_plain(shape, state, steps, field=field)
    torch.cuda.synchronize()
    d = max(float((getattr(got.masses, f) - getattr(want.masses, f))
                  .abs().max()) for f in ("pos", "vel"))
    print(f"{name}: fused step vs fused_chunk_plain, both fed the plain "
          f"field, {steps} steps from the final state: max |d| {d:.3e}")
    check(d == 0.0, f"{name}: the fused step fed a field differs from "
          "its plain version")
    return d


def grid_full_size(shape, state, name):
    """The grid kernel against its plain version at the swarm path's final
    state, within TOL_FIELD * max |plain| (the two sum in the same order):
    (max |d|, max |d| / max |plain|)."""
    import torch
    from titan_tpu_torch.ops import magnets_grid
    m, cut = state.masses, shape.config.magnet_cutoff
    cap = shape.magnet_binned[1]
    a = magnets_grid.grid_magnet_forces(m, cut, cap)
    b = magnets_grid.grid_magnet_forces_plain(m, cut, cap)
    torch.cuda.synchronize()
    d, scale = float((a - b).abs().max()), float(b.abs().max())
    print(f"{name}: grid field kernel vs plain at the final state: max |d| "
          f"{d:.3e} of max |plain| {scale:.3e}")
    check(d <= TOL_FIELD * scale, f"{name}: full-size grid field disagrees")
    return d, d / max(scale, 1e-30)


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

    # 1, a and f. build every source, one nvcc each, started together
    build_kernels(("fused_step", "adjoint", "magnets", "magnets_grid"))

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

    # g-l. the magnet field kernels, the fused step's magnet route, the
    # RobotLink and magnetic-swarm main paths, gradient routing
    magnet_phases(titan, kernels)

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
