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
     step and no tiled launch.  Each scene's path through the step kernel
     is printed (the plain-spring loop or the general body, registers,
     co-resident blocks); a 13-family lattice must take the plain-spring
     loop.  The landed state of each (in contact with its plane; the 20^3
     plane has friction) and the 43^3 scene's first 200 steps from its
     start are held against fused_chunk_plain over 200 steps;
  4. time each path's chunk with CUDA events from its landed state (kernel
     and plain version) beside the least time the card could take;
  a. build csrc/adjoint.cu (the adjoint's trace and backward kernels) beside
     fused_step.cu, each by its own nvcc, started together, with ptxas
     reports;
  b. hold both adjoint kernels against their plain versions on the 12 small
     scenes and a non-uniform-k one over a 20-step segment: the trace bitwise against
     trace_run_plain, the backward against bwd_run_plain fed the same trace
     and seeded cotangents, bitwise under Euler and Verlet and within
     TOL_BWD of max |plain| for every output under RK2, its launches
     exactly adjoint.bwd_launch_count's, the damped, breathing, actuated
     and non-uniform-k scenes on the backward's general body and the
     others on its plain-spring loop (bwd_run.plain_launches);
  c. the gradient path from each landed main-path state (43^3 and 20^3):
     diff.grad_rollout over 200 steps in segments of 100 and
     torch.autograd.grad of seeded weights . (final pos, vel) over pos,
     vel, k, rest, m, extern_force and g, with every launch count and the
     eager step count set to 0 just before and read just after; each kernel
     must launch, no eager step may run, every gradient must be finite, and
     the backward's launches must be the folded sweep's exactly, all on the
     plain-spring loop (its path printed with each kernel's registers and
     blocks an SM: fused_bwd_path).
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
     the pairwise field within TOL_FIELD * max |plain|, the grid field
     bitwise, with the count of its tiles whose windows exceed the
     kernel's shared-memory stage; and the grid field bitwise on 3,000
     magnets within 0.4 m (cap 512), where some tile must exceed it
     (grid_over_budget);
  h. the fused step fed the plain field against fused_chunk_plain fed the
     same field, bitwise (RobotLink under Euler, Verlet and RK2; a
     2,000-particle grid swarm, whose grid field is held bitwise too);
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
     against its plain version: the grid field bitwise, with its tiles
     over the stage counted; the pairwise field each element within
     TOL_FIELD * the sum of |terms| it adds up (also with only the even,
     then only the odd, masses valid: no link partner, whose collapsed
     1/r^2 pull hides every other term);
  k. time each path: the whole route per step (CUDA events), each kernel's
     device time per launch (torch.profiler, taken once more where it
     recorded fewer launches than the route made, the run failing if the
     second is short too) beside its bound, the plain
     versions, the grid setup's host enqueue time and device time per pass
     (grid_setup alone; host clock, CUDA events), and the grid kernel's
     tile, stage, registers and co-resident blocks;
  l. gradient routing: diff.grad_rollout over 20 steps of a 16-link scene
     takes the fused adjoint (the field kernel in the forward and the
     replay, a magnet transpose per force pass, no eager step), and the
     spring-less 2,000-particle swarm, which neither adjoint takes,
     fast_rollout (20 eager steps in the backward, no adjoint or magnet
     kernel); finite, nonzero position and mag_maxf gradients;
  m. build csrc/tiled_step.cu (the tiled step: per-step, resident-grid and
     resident-grid RK2 kernels) beside the others, all five nvcc started
     together, with the co-resident block limit of the cooperative grids
     (the plain-spring Euler / Verlet grid's with its path, in phase o);
  n. hold the tiled kernels against tiled_chunk_plain over 100 steps,
     bitwise, on 12 scenes of 12,000 masses whose family offsets span more
     than a block (Euler with and without the clamp, Verlet, RK2, damping
     with friction, actuated, breathing, drag, a ball, non-uniform k,
     non-uniform rest, deleted masses), through the resident grids and
     their tail and through per-step launches only, and a resident-grid
     segment (16 steps) and two plus a tail (37) bitwise against per-step
     launches.  Every launch must take the scene's path
     (tiled_chunk.plain_launches, check_step_path): the damped, actuated,
     breathing and non-uniform-k scenes the general body, the others the
     plain-spring loop, on every kernel;
  o. the 100^3 stress config (bench.py with TITAN_BENCH_NX=100: 1,000,000
     masses, 12,731,796 springs) through Simulation (the path of its
     resident grid, per-step kernel and replay printed with each kernel's
     registers, local bytes and blocks an SM, and held as in phase 3;
     report_path), start -> wait ->
     getAll -> resume at 4 breakpoints -> stop, every count set to 0 just
     before and read just after: it must take the tiled route, its
     launches must be n // 16 resident-grid and n % 16 per-step launches
     per chunk of n steps, every one before the uniform break below on the
     plain-spring loop and none after it, with no fused launch and no
     eager step, and the lattice must land. At the landed pause, one spring's
     k is multiplied by 10 through Spring.set: the uniform-k flag must clear
     and the tiled chunk must follow the fused kernel, which reads the dense
     k. From the landed state, 200 steps under Euler, RK2 and Verlet against
     tiled_chunk_plain (bitwise) with their launches counted, and Euler
     against the fused kernel within TOL_CROSS;
  p. time each integrator's tiled chunk at 100^3 (CUDA events), each
     kernel's device time per launch (torch.profiler) beside its bound,
     the plain version, and the fused kernel on the same state;
  q. build csrc/tiled_adjoint.cu (the tiled adjoint's trace replay and
     backward kernels) beside the others, all six nvcc started together,
     and print the co-resident block limit of its resident-grid kernels
     (the replay's, the backward's general and plain-spring ones);
  r. on the 12 tiled scenes: the trace replay over 37 steps (two
     resident-grid segments and a tail, and per-step launches only)
     bitwise tiled_trace_run_plain, each launch on the scene's path
     (tiled_trace_run.plain_launches), and its entries 16 and 36 bitwise
     the kernel chunk's states; the per-step
     backward on 20 of those entries against tiled_bwd_run_plain, bitwise
     for Euler and Verlet, within TOL_BWD_ELEM per element for RK2; the
     resident-grid backward (Euler, Verlet) bitwise the per-step launches.
     The damped, actuated, breathing and non-uniform-k scenes must take
     the backward's general body, the others its plain-spring loop, and
     every launch must have run the path its scene takes
     (tiled_bwd_run.plain_launches); each check prints the path;
  s. the 100^3 gradient path from phase o's landed state, under Euler,
     Verlet and RK2: diff.grad_rollout over 200 steps with the default
     segment (50) and torch.autograd.grad over pos, vel, k, rest, m,
     extern_force and g, every count set to 0 just before and read just
     after.  The route must be the tiled adjoint, the forward, replay and
     backward launches exactly what the segments give, with no fused
     launch, no fused-adjoint launch and no eager step, and every gradient
     finite.  The backward's path is printed with the registers, local
     bytes and co-resident blocks of each kernel it launches (B8, or B7's
     two or three), and every backward launch must have taken the
     plain-spring loop (as on every tiled gradient path of a 13-family
     lattice: + local, + links, the soak glue).  Then phase r's checks from that state; then the tiled
     adjoint against the fused adjoint over 32 steps: both backward sweeps
     bitwise on one trace, the two forwards compared, and the gradients
     within TOL_GRAD_CROSS (Verlet) and TOL_GRAD_CROSS_CLAMP (Euler with
     the velocity clamp);
  t. time each integrator's gradient path at 100^3: forward + backward per
     step of the tiled adjoint and of the fused adjoint on the same state
     (host clock), and each tiled adjoint kernel's device time per launch
     (torch.profiler) beside its bound and its plain version;
  u. every kernel's local-constraint branch against its plain version on
     12 scenes of 12,000 masses (each slot type alone, contact planes with
     and without friction, all four, with drag; Euler, Verlet and RK2):
     the fused step over 100 steps, the fused trace over 20 and its
     backward on that trace, the tiled step over 37 steps and its
     resident-grid launches against per-step launches, the tiled replay,
     per-step and resident-grid backwards (phase r's checks); bitwise, the
     RK2 backwards within TOL_BWD_ELEM per element;
  v. bench 43^3 + local: bench.py's scene with a friction-bearing contact
     plane slot on every mass, a constraint plane on the top layer, a
     direction on one bottom edge and a ball on one side face, through
     Simulation until it lands (drive: the fused step, no tiled launch, no
     eager step), the fused step, trace and backward against their plain
     versions from the landed state, the gradient path (the fused adjoint,
     phase c's checks), and how many masses each slot type acts on;
  w. stress 100^3 + local: the same slots at 100^3 (placed to act from
     step 0) through Simulation for 2,000 Euler steps from t = 0, every
     count set to 0 just before and read just after: the tiled route, the
     resident-grid and per-step launches the chunk lengths give, no fused
     launch, no eager step; then phase r's checks and the gradient path
     (phase s's exact counts) under Euler and Verlet over 200 steps and
     under RK2 over one 50-step segment (LOCAL_RK2_GRAD_STEPS: the
     contact slots' friction grows the true gradient past f32's range by
     200 RK2 steps), and the tiled adjoint against the fused adjoint over
     32 Verlet steps within TOL_GRAD_CROSS on the same state with the
     contact slots' friction off (the friction case is printed beside it,
     with the forward and gradient differences binned by each mass's
     least sliding speed on its contact slot, slide_bins);
  x. every slot type must act on at least one mass of each path;
  y. time both paths' kernels as phases 4, e, p and t do, with the slot
     rows' bytes and operations that the run's own slots need in every
     bound (local_work);
  z1. every kernel's remainder-spring branch against its plain version
     on 12 scenes of 12,000 masses with 96 cross links each (plain,
     damped, breathing, ACTUATED expand / contract, a fixed endpoint, a
     deleted endpoint, a hub of degree 12 or more, with all four local
     slot types;
     Euler, Verlet and RK2): the fused step over 100 steps, the fused trace
     over 20 and its backward, the tiled step (per-step launches: remainder
     scenes take no resident grid) over 37, its replay and B7; bitwise, the
     RK2 backwards within TOL_BWD_ELEM per element.  And the fused step's
     per-pass magnet entry fed the plain field against its plain version
     on 64 RobotLinks with 32 links, Euler, Verlet and RK2, bitwise;
  z2. the route on the 43^3 + links shape either side of the reference's
     remainder-selector budget (S 2,048: fused step and adjoint; 2,176:
     tiled);
  z3. bench 43^3 + 1,024 links (scripts/tpu_mega_glue_breakdown.py's
     build(cross=...) pattern) through Simulation until it lands: one
     fused launch per step, no tiled launch, no eager step; from the landed
     state under Euler, Verlet and RK2 the fused step (200 steps), trace
     and backward against their plain versions, and the gradient path
     (grad_rollout over 200 steps in segments of 100, gradients over pos,
     vel, k and the links' k and rest) with exact counts on the fused
     adjoint, every gradient finite, every link's rest gradient nonzero
     and the links' k gradients not all 0; timing;
  z4. stress 100^3 + 512 links through Simulation for 2,000 Euler steps
     from t = 0: the tiled route, per-step launches only (0 resident-grid
     launches), no fused launch, no eager step; from its end state under
     Euler, Verlet and RK2 the tiled step, replay and B7 against their
     plain versions, the gradient path (the tiled adjoint, segments of 50,
     B7 only: 0 B8 launches) with z3's checks; timing;
  z5. every bound counts the run's own remainder topology (rem_work);
  z6. the magnet gradients' new branches against their plain versions on
     small scenes: the pairwise field's transpose (B5, csrc/
     magnets_adjoint.cuh) alone on a magnet cloud (deleted and
     zero-parameter masses, a tenth fixed), a dense 2,048-magnet cloud whose
     acting pairs reach every slot of sources, and on 64 RobotLinks, with the
     pairwise field kernel against its plain version in the kernel's order
     (pairwise_field_lanes), bitwise; the fused trace with magnets (B4: the
     field kernel, then the replay kernel per pass, each pass's constant
     force in the trace) bitwise trace_run_plain fed the kernel's field,
     and the backward with its transposes against bwd_run_plain (Euler,
     Verlet bitwise; RK2 per element) on 64 RobotLinks, with 32 links
     under RK2, and on a plain-spring 6^3 lattice of magnets (the
     backward's plain-spring loop unfolded: every launch on it,
     bwd_run.plain_launches); the backward's launches exactly
     adjoint.bwd_launch_count's; the tiled glue chunk (B2), replay (B6) and B7 on four
     12,000-mass lattices with 4,000 magnets and 48 links (pairwise Euler
     and RK2, binned Verlet and RK2: bitwise, RK2 and the binned vjp per
     element);
  z7. 1,024 RobotLinks (2,048 masses, in the air at t = 0) take the fused
     step and adjoint; B5 alone at full width (transpose_vs_plain) with its
     registers and blocks an SM; under Euler, Verlet and RK2 the trace and
     backward at full width against their plain versions, and
     diff.grad_rollout
     over 200 steps in segments of 100 with gradients over pos, vel and
     the four magnet parameters, every count set to 0 just before and read
     just after: exact launches (fused step, replay, backward, pairwise
     field, transpose), 0 eager, finite gradients, nonzero where the term
     acts (acting_params); timing;
  z8. scripts/tpu_soak.py's flow 6 (64^3 = 262,144 masses, 10,000
     magnets, 50 links, dt 1e-4) through Simulation for 500 steps on the
     tiled route with the grid field, every count zeroed before and read
     after (one per-step launch and one grid launch per step, nothing
     else), and the grid field bitwise its plain version at the end
     state (its tiles over the stage counted); from there under Euler,
     Verlet and RK2 the glue step, replay and B7 against their plain
     versions at full width, and the gradient
     path on the tiled adjoint over 100 steps in segments of 50 (exact
     launches, the binned vjp once per force pass, 0 resident-grid, 0 B8,
     0 eager; finite gradients, nonzero where the term acts), and once
     more under Euler over 10 steps with the magnets' mag_rad 0.06, where
     shells overlap and every magnet term must act (the soak's own shells
     never overlap, so their mag_rad and mag_stiffness gradients are 0);
     timing;
  z9. every new kernel in the kernels line with its launches, error, time,
     plain time and bound;
     every gradient path's counts include the forward's and the replay's
     plain-spring launches (fwd_plain, trace_plain: exactly what the
     segments and the scene's path give), and every profiled tiled step,
     grid and replay kernel must be the instantiation of the scene's path
     (check_profiled_path); the tiled step and replay entries of the
     kernels line carry "path";
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
# the per-mass local-constraint slots in every bound, counted on the run's
# own slots (local_work): each launch reads every slot's act row for every
# mass (4 B), and a slot's other rows (6 for a contact plane, 4 for a
# ball, a constraint plane or a direction) and its operations of one force
# pass only where its act row is set, as the kernels skip the rest (a
# contact plane with friction 45, a ball 15, a constraint plane 20, a
# direction 22); a transpose does twice a slot's forward on top of its
# recompute
LOCAL_OPS = (45, 15, 20, 22)
LOCAL_DATA_ROWS = (6, 4, 4, 4)
# a remainder spring's operations, counted at each of its two endpoints
# (rem_work): the spring evaluation (22, as a family spring's) and its
# transpose (40 more)
REM_OPS, REM_OPS_T = 22, 40
SEG, GRAD_STEPS = 100, 200
VARIANTS = ("plain", "friction", "static_friction", "ball", "damping",
            "breathing", "actuated", "drag", "deleted", "verlet", "rk2",
            "clamp_off")
# phase b's small scenes: VARIANTS and a non-uniform-k one; those of
# GENERAL_VARIANTS take the fused backward's general body (the others, and
# every 13-family main path, its plain-spring loop)
ADJOINT_VARIANTS = VARIANTS + ("nonuniform_k",)
GENERAL_VARIANTS = ("damping", "breathing", "actuated", "nonuniform_k")
# the fused backward's kernels (csrc/adjoint.cu): the general body's three
# and, on the plain-spring path, the folded launches
FUSED_BWD_NAMES = ("bwd_mid_kernel", "bwd_force_kernel", "bwd_spring_kernel",
                   "bwd_fold_kernel", "bwd_fold_rk2_kernel")
TIMED_STEPS = 5000


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def variant_scene(titan, variant):
    """A 6^3 lattice exercising one feature of the kernel, marshalled on
    the card; returns (shape, state)."""
    import numpy as np
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
    elif variant == "nonuniform_k":
        st.k[:s] *= 1.0 + 0.1 * np.random.RandomState(1).rand(s)
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
    n = sim._store.n_masses
    z0 = sim._store.pos[:n, 2].copy()
    t0 = time.perf_counter()
    zero_tiled_counts()
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
    counts = read_tiled_counts()
    launches, eager = counts["fused"], counts["eager"]
    tiled = counts["mega"] + counts["step"]
    wall = time.perf_counter() - t0
    print(f"main path {name}: fused_step launches {launches}, tiled "
          f"launches {tiled}, eager steps {eager}")
    check(launches > 0, f"{name}: the main path never launched the kernel")
    check(tiled == 0, f"{name}: the main path launched the tiled kernels")
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


def profile_device_us(fn, names, keys=None):
    """{kernel: (device us in all, launches)} for each kernel in `names`
    (summed over every profiler key that contains the name) from
    torch.profiler over fn(); a kernel with no device time recorded is
    left out.  Each profiler key is appended to the list `keys` where
    given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if keys is not None:
            keys.append(e.key)
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        for k in names:
            if k in e.key and e.count and t:
                # a template's instantiations are keys of their own
                t0, c0 = out.get(k, (0.0, 0))
                out[k] = (t0 + t, c0 + e.count)
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
    passes = 2 if shape.config.integrator.name == "RK2" else 1
    # the slot rows are read by every launch, one per force pass
    l_rows, l_ops = local_work(shape, state)
    # the remainder springs' table and rows are read once per chunk
    r_bytes, r_ops, _ = rem_work(shape, state)
    t_bytes = (4 * per_mass * n / n_steps + r_bytes / n_steps
               + 4 * l_rows * n * passes) / HBM_BYTES_PER_S * 1e3
    t_ops = (OPS_PER_SPRING * n_springs + OPS_PER_MASS * n
             + passes * (l_ops * n + r_ops)) / F32_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ), t_bytes, t_ops


def rem_work(shape, state):
    """(bytes, operations per force pass, operations per transpose) that
    the remainder springs need in one launch, from this state's own
    topology: the incidence table (D entries of 8 B per mass), each live
    spring's ends (8 B) and rows (k and rest, and damping, the breathing
    sign and frequency, the actuation rate and bound where the scene has
    them, 4 B each); each live spring is evaluated by both its endpoints,
    REM_OPS operations each, and transposed by both, REM_OPS_T more.  All
    0 without remainder springs."""
    if not shape.has_remainder:
        return 0.0, 0.0, 0.0
    sp, m = state.springs, state.masses
    live = int((sp.valid & m.valid[sp.left.long()]
                & m.valid[sp.right.long()]).sum())
    rows = 2 + shape.has_damping + 2 * shape.has_breathing \
        + 2 * shape.has_actuated
    degree = state.topo.inc_idx.shape[1] \
        if state.topo.inc_idx.shape[0] == shape.n_masses \
        else shape.max_degree
    nbytes = 8 * shape.n_masses * degree + live * (8 + 4 * rows)
    return nbytes, 2 * REM_OPS * live, 2 * REM_OPS_T * live


def local_work(shape, state):
    """(rows, operations) per mass, averaged over the scene's masses, that
    one force pass's local-constraint slots need on this state's own slots:
    every slot's act row for every mass, and a slot's other rows and
    operations only on the masses whose act row is set (slot j of a type is
    set where j < the mass's count, ops/forces.py::stage_local)."""
    lcon, n = state.lcon, shape.n_masses
    caps = (shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir)
    counts = (lcon.cp_count, lcon.ball_count, lcon.pl_count, lcon.dir_count)
    rows, ops = float(sum(caps)), 0.0
    for cap, count, data, op in zip(caps, counts, LOCAL_DATA_ROWS,
                                    LOCAL_OPS):
        for j in range(cap):
            frac = int((count > j).sum()) / n
            rows += data * frac
            ops += op * frac
    return rows, ops


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
                  f"event-timed step; launch gap (event-timed step minus "
                  f"device time) {ms * 1e3 - kern_us:.3f} us/step"))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)

def print_coop_blocks(titan):
    """The co-resident block limit (the largest cooperative grid) of every
    resident-grid kernel: the tiled step's, the tiled adjoint replay's
    (general and plain-spring) and the tiled adjoint's backward (Euler and
    Verlet; general and plain-spring)."""
    from titan_tpu_torch.ops import adjoint_tiled, tiled_step
    for integ in (titan.Integrator.EULER, titan.Integrator.VERLET,
                  titan.Integrator.RK2):
        b8 = adjoint_tiled.bwd_kernel_info("B8", True)["threads"]
        print(f"tiled resident-grid kernel ({integ.name}): "
              f"{tiled_step.coop_blocks(integ)} co-resident blocks of 256 "
              "threads (the largest cooperative grid); its trace replay "
              f"{adjoint_tiled.coop_blocks('trace', integ)}, the replay's "
              "plain-spring instantiation "
              f"{adjoint_tiled.coop_blocks('trace', integ, plain=True)} of "
              "512 threads"
              + ("" if integ is titan.Integrator.RK2 else
                 "; resident-grid backward "
                 f"{adjoint_tiled.coop_blocks('bwd', integ)}, its "
                 "plain-spring instantiation "
                 f"{adjoint_tiled.coop_blocks('bwd', integ, plain=True)} "
                 f"of {b8} threads"))


def report_path(name, shape, route):
    """Print which family loop the kernels that `route` runs on `shape`
    take (csrc/step_body.cuh::plain_family_sum or the general body), with
    each kernel's registers a thread and co-resident blocks; "fused": the
    fused step; "mega": the tiled chunk's resident grid, its per-step
    kernel (the tail's, and a link or glue scene's every launch) and the
    replay's grid and per-step kernel.  A lattice main path (13 families)
    must take the plain-spring loop on each."""
    from titan_tpu_torch.ops import fused_step, tiled_step
    plain = fused_step.takes_plain_spring_path(shape)
    if len(shape.stencil_deltas) == 13:
        check(plain, f"{name}: the {route} path does not take the "
              "plain-spring loop")
    loop = "the plain-spring loop" if plain else "the general body"
    if route == "fused":
        if not plain:
            print(f"path {name}, fused_step_kernel: the general body")
            return
        regs, per_sm = fused_step.kernel_info(shape.has_remainder)
        print(f"path {name}, fused_step_kernel: the plain-spring loop, "
              f"{regs} registers a thread, {per_sm} co-resident blocks of "
              "128 threads an SM")
        return
    integ = shape.config.integrator
    modes = ("rk2a", "rk2b") if integ.name == "RK2" else (
        integ.name.lower(),)
    parts = []
    for trace in (False, True):
        kinds = [("step", m) for m in modes]
        if tiled_step.mega_seg(shape):
            kinds.insert(0, ("grid", integ))
        for kind, mode in kinds:
            i = tiled_step.step_kernel_info(kind, mode, plain,
                                            shape.has_remainder, trace)
            if kind == "grid":
                what = (("tiled_megark2_kernel" if integ.name == "RK2"
                         else "tiled_mega_kernel") + " ("
                        + ("replay" if trace else "forward") + ")")
            else:
                what = (f"tiled_step_kernel {mode} ("
                        + ("replay" if trace else "forward") + ")")
            parts.append(f"{what} {i['threads']} threads a block, "
                         f"{i['registers']} registers and {i['local_bytes']}"
                         f" B of local memory a thread, {i['blocks_per_sm']}"
                         " blocks an SM")
    print(f"path {name}, tiled step and replay: {loop}; " + "; ".join(parts))


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


def fused_bwd_path(name, shape):
    """Print the fused backward's path on `shape` (the plain-spring loop,
    folded or not, or the general body) and, for each kernel it launches,
    its threads a block, registers and local-memory bytes a thread and
    co-resident blocks an SM; a 13-family lattice must take the loop.
    Returns "plain" or "general"."""
    from titan_tpu_torch.ops import adjoint
    path = spring_path(shape)
    plain = path == "plain"
    if len(shape.stencil_deltas) == 13:
        check(plain, f"{name}: the fused backward does not take the "
              "plain-spring loop")
    rk2 = shape.config.integrator.name == "RK2"
    fold = plain and not shape.has_magnets
    if fold:
        names = ("mid", "force", "fold_rk2") if rk2 else ("fold",)
    else:
        names = ("force", "spring") + (("mid",) if rk2 else ())
    parts = []
    for k in names:
        i = adjoint.bwd_kernel_info(k, shape)
        parts.append(f"bwd_{k}_kernel {i['threads']} threads a block, "
                     f"{i['registers']} registers and {i['local_bytes']} B "
                     f"of local memory a thread, {i['blocks_per_sm']} "
                     "blocks an SM")
    print(f"path {name}, fused backward: "
          + ("the plain-spring loop" + (", folded" if fold else "")
             if plain else "the general body") + "; " + "; ".join(parts))
    return path


def check_fused_bwd_launches(name, shape, seg, n_seg, launches, on_loop):
    """The fused backward's `launches` over `n_seg` segments of `seg` steps
    must be what adjoint.bwd_launch_count gives, and `on_loop` of them
    (bwd_run.plain_launches) all of them on the plain-spring path, none
    on the general body."""
    from titan_tpu_torch.ops import adjoint
    want, want_plain = adjoint.bwd_launch_count(shape, seg)
    check(launches == n_seg * want and on_loop == n_seg * want_plain,
          f"{name}: {launches} backward launches ({on_loop} on the "
          f"plain-spring loop), the segments give {n_seg * want} "
          f"({n_seg * want_plain})")


def adjoint_vs_plain(shape, state, seg, label):
    """Both adjoint kernels against their plain versions from `state`: the
    trace bitwise, the backward (its launches counted: check_fused_bwd_
    launches) bitwise under Euler and Verlet and within TOL_BWD per output
    under RK2 on the kernel's trace.  Returns the trace's max |d| and the
    backward's max |d| and max |d| / max |plain|."""
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
    run = adjoint.bwd_run
    run.launches = run.plain_launches = 0
    got = adjoint.bwd_run(shape, state, trace, *cts)
    launches, on_loop = run.launches, run.plain_launches
    ref = adjoint.bwd_run_plain(shape, state, trace, *cts)
    torch.cuda.synchronize()
    check_fused_bwd_launches(label, shape, seg, 1, launches, on_loop)
    rk2 = shape.config.integrator.name == "RK2"
    abs_err, rel, bad, same = 0.0, {}, [], True
    for key, b in ref.items():
        if key in ("pair_ok", "rem_ok"):
            continue
        a, b = masked_bars(key, got[key], b, ref)
        if not bool(torch.isfinite(a).all()):
            bad.append(f"non-finite {key}")
        same = same and bool(torch.equal(a, b))
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        rel[key] = d / max(float(b.abs().max()), 1e-30)
        if rel[key] > TOL_BWD:
            bad.append(f"{key} {rel[key]:.3e}")
    if not rk2 and not same:
        bad.append("not bitwise under " + shape.config.integrator.name)
    print(f"adjoint vs plain [{label}, {seg} steps]: trace bitwise; "
          f"backward ({spring_path(shape)} path, {launches} launches, "
          f"{on_loop} on the plain-spring loop) "
          + ("bitwise" if same else "max |d| / max |plain|: "
             + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
          + (f"  FAIL {bad}" if bad else ""))
    check(not bad, f"{label}: backward kernel disagrees with plain: {bad}")
    return dtr, abs_err, max(rel.values())


def masked_bars(key, a, b, ref):
    """A backward's gradient `a` and its plain version's `b`, zeroed where
    assemble_ct zeroes them: the k, damping and rate * dt of missing or
    invalid springs (``pair_ok``, the remainder's ``rem_ok``)."""
    import torch
    ok = (ref["pair_ok"] if key in ("k", "damping", "aratedt") else
          ref.get("rem_ok") if key in ("k_e", "damp_e", "aratedt_e")
          else None)
    if ok is None:
        return a, b
    return torch.where(ok, a, 0.0), torch.where(ok, b, 0.0)


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


def run_grad(shape, state, rollout, n_steps=GRAD_STEPS, weights=None):
    """loss = weights . (final pos, vel) through `rollout`, and its
    gradients over the leaves; synchronised.  ``weights`` is
    grad_loss_weights(state), made here where not given: a timed caller
    makes them outside its clock (numpy draws the [3, N] normals on the
    host, ~0.1 s each at 100^3)."""
    import torch
    leaves, st = grad_leaves(state)
    wpos, wvel = weights if weights is not None else grad_loss_weights(state)
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
    path = fused_bwd_path(name, shape)
    fwd, tr, bwd, eager = counters()
    fwd.launches = tr.launches = bwd.launches = bwd.plain_launches = 0
    eager.steps = 0
    t0 = time.perf_counter()
    loss, grads = run_grad(
        shape, state,
        lambda sh, st, k: diff.grad_rollout(sh, st, k, segment=SEG))
    wall = time.perf_counter() - t0
    got = (fwd.launches, tr.launches, bwd.launches, eager.steps)
    print(f"gradient path {name}: {GRAD_STEPS} steps in segments of {SEG}: "
          f"fused_step launches {got[0]}, adjoint trace launches {got[1]}, "
          f"adjoint backward launches {got[2]} ({bwd.plain_launches} on the "
          f"plain-spring loop, the {path} path), eager steps {got[3]}; "
          f"{wall:.3f} s wall (first call)")
    check(min(got[:3]) > 0, f"{name}: a kernel of the gradient path never "
          f"launched: {got}")
    check(got[3] == 0, f"{name}: the gradient path ran {got[3]} eager steps")
    check_fused_bwd_launches(name, shape, SEG, GRAD_STEPS // SEG, got[2],
                             bwd.plain_launches)
    names = ("pos", "vel", "k", "rest", "m", "extern_force", "g")
    for nm, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()), f"{name}: d loss / d {nm} is "
              "not finite")
    print(f"gradient path {name}: loss {float(loss.detach()):.6e}; |grad|max "
          + ", ".join(f"{nm} {float(g.abs().max()):.3e}"
                      for nm, g in zip(names, grads)))
    err = adjoint_vs_plain(shape, state, SEG, f"{name} landed")
    return got[1], got[2], err, path


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
    rk2 = 2 if shape.config.integrator.name == "RK2" else 1
    # the local-constraint slot rows, read by each force launch
    l_rows, l_ops = local_work(shape, state)
    lc = l_rows * seg * rk2
    # the remainder springs' table and rows, read once per segment, and
    # their gradients, written once (5 per live spring at most)
    r_bytes, r_ops, r_ops_t = rem_work(shape, state)
    # a magnet scene's trace holds each pass's constant force too (its
    # rows written by the field's pass, read by the backward)
    from titan_tpu_torch.ops.adjoint import trace_rows
    rows = trace_rows(shape)
    trace_bytes = 4 * n * (seg * 6 + 9 + inv + lc) + r_bytes
    grads = 9 + 3 + 1 + shape.has_drag + f * (
        2 + shape.has_damping + shape.has_breathing + shape.has_actuated)
    bwd_bytes = 4 * n * (seg * rows + 9 + inv + grads + lc) + r_bytes \
        + 5 * r_ops_t / (2 * REM_OPS_T) * 4
    ops_fwd = rk2 * (OPS_PER_SPRING * n_springs
                     + (OPS_PER_MASS + l_ops) * n + r_ops)
    ops_bwd = ops_fwd + rk2 * (OPS_PER_SPRING_T * n_springs
                               + (OPS_PER_MASS_T + 2 * l_ops) * n + r_ops_t)
    out = []
    for nbytes, ops in ((trace_bytes, ops_fwd), (bwd_bytes, ops_bwd)):
        tb = nbytes / seg / HBM_BYTES_PER_S * 1e3
        to = ops / F32_FLOPS_PER_S * 1e3
        out.append((tb, "bytes") if tb >= to else (to, "operations"))
    return out


def profile_grad_path(name, shape, state, segment=SEG):
    """One forward + backward of the gradient path (grad_rollout with
    `segment`, None for its default) under torch.profiler: the device's
    busy share of the wall time, the port's kernels' share of the device
    time, host-to-device copies, and the host operations that take the
    most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from titan_tpu_torch import diff
    w = grad_loss_weights(state)
    run_grad(shape, state, lambda sh, st, k: diff.grad_rollout(
        sh, st, k, segment=segment), weights=w)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_grad(shape, state, lambda sh, st, k: diff.grad_rollout(
            sh, st, k, segment=segment), weights=w)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, ours, h2d = 0.0, 0.0, 0
    ours_names = ("fused_step_kernel", "adjoint_trace_kernel",
                  "tiled_") + FUSED_BWD_NAMES
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

    w = grad_loss_weights(state)

    def grad_run(rollout, k):
        return lambda: run_grad(shape, state, rollout, k, weights=w)

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
        shape, state, ptr, *cts), 10, reps=1)
    reps = 3
    bwd_names = FUSED_BWD_NAMES
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
             if any(k in dev for k in bwd_names) else bw_wrap)
    bwd_key = next((k for k in bwd_names if k in dev), "bwd_force_kernel")
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
          f"({SEG}-step trace, {src(bwd_key)}), bound {bb * 1e3:.4f} us/step by "
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
        check(torch.equal(gr, gr_plain), f"{label}: the grid kernel is not "
              "bitwise its plain version")
        out = [grid_tile_report(m, cut, cap)[2]]
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
              + f" (tolerance {TOL_FIELD} * max |plain|; grid bitwise)")
    grid_over_budget(titan)
    return worst


def grid_tile_report(m, cut, cap):
    """(tiles over the stage, tiles, what to print) of one grid field
    pass on masses ``m``: the tiles whose windows hold more sources than
    the kernel's stage read them from device memory."""
    from titan_tpu_torch.ops import magnets_grid
    info = magnets_grid.kernel_info()
    over, tiles = magnets_grid.tiles_over_budget(
        magnets_grid.grid_setup(m, cut), cap, info["tile"], info["stage"],
        info["window"])
    return over, tiles, (f"grid tiles {tiles} of {info['tile']} receivers, "
                         f"{over} over the stage ({info['stage']} sources, "
                         f"{info['window']} cells a row)")


def grid_over_budget(titan):
    """Phase g's grid scene built so that windows exceed the kernel's
    stage (3,000 magnets within 0.4 m, cap 512): the kernel, reading those
    tiles' sources from device memory, bitwise its plain version, and a
    nonzero count of such tiles."""
    import torch
    from titan_tpu_torch.ops import magnets_grid
    cut, cap = 0.14, 512
    _, state = marshalled(cloud_sim(titan, n=3000, seed=7, spread=0.2))
    m = state.masses
    got = magnets_grid.grid_magnet_forces(m, cut, cap)
    want = magnets_grid.grid_magnet_forces_plain(m, cut, cap)
    torch.cuda.synchronize()
    over, tiles, what = grid_tile_report(m, cut, cap)
    same = torch.equal(got, want)
    print(f"grid field kernel vs plain [3,000 magnets within 0.4 m, cap "
          f"{cap}]: {'bitwise' if same else 'DIFFERENT'} (max |plain| "
          f"{float(want.abs().max()):.3e}); {what}")
    check(same and over > 0 and float(want.abs().max()) > 0,
          "the grid kernel over its stage: not bitwise its plain version, "
          "or no tile over the stage")


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
        if shape.magnet_binned:
            grid_bitwise(shape, state, label)
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
    cell, starts, src = magnets_grid.grid_setup(m, cut)[:3]
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
        setup_dev_us = 1e3 * event_ms(lambda k: [
            magnets_grid.grid_setup(m, cut) for _ in range(k)], n_steps)
        info = magnets_grid.kernel_info()
    # every launch recorded: the profile is taken once more where the
    # profiler dropped some (one run recorded 185 of 200, and its per-launch
    # times were half the true ones), and a second short one fails the run
    passes = 2 if shape.config.integrator.name == "RK2" else 1
    for attempt in range(2):
        dev = profile_route(name, lambda: route(n_steps), n_steps,
                            ("fused_step_kernel", kname))
        seen = {k: c for k, (_, c) in dev.items()}
        whole = all(seen.get(k) == n_steps * passes
                    for k in ("fused_step_kernel", kname))
        if whole:
            break
    print(f"timing {name}: the profiler recorded {seen} launches of "
          f"{n_steps * passes} each (profile {attempt + 1})")
    check(whole, f"{name}: the profiler recorded {seen} launches, not "
          f"{n_steps * passes} of each kernel, in two profiles")
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
             f"; the setup alone {setup_dev_us:.3f} us/pass by CUDA "
             f"events" if field_kernel == "grid" else "") + ")")
    if field_kernel == "grid":
        print(f"timing {name}: grid_magnet_kernel {info['tile']} threads a "
              f"block ({info['blocks_asked']} blocks an SM asked), stage "
              f"{info['stage']} sources and {info['window']} cells a row, "
              f"{info['registers']} registers and "
              f"{info['local_bytes']} B of local memory a thread, "
              f"{info['blocks_per_sm']} co-resident blocks an SM")
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
                 **({"setup_host_us_per_pass": setup_us,
                     "setup_us_per_pass": setup_dev_us}
                    if field_kernel == "grid" else {})))


def magnet_grad_routing(titan):
    """Phase l: gradient routing of magnet scenes.  diff.grad_rollout over
    20 steps of a 16-link RobotLink scene takes the fused adjoint (its
    magnet branches): the forward is the fused step with the pairwise
    field, the backward the replay (the field again per pass), the sweep
    and one magnet transpose per force pass, no eager step.  The
    spring-less swarm (swarm_sim at 2,000 particles), which neither
    adjoint takes, runs fast_rollout: its backward recomputes the 20 steps
    eagerly, launching no adjoint and no magnet kernel.  Both give finite
    nonzero gradients."""
    import torch
    from titan_tpu_torch import diff
    for label, sim, route in (
            ("16-link RobotLink", link_sim(titan, 16, magnetic_force=0.02,
                                           spread=0.15, z=0.2, dt=1e-4),
             "adjoint"),
            ("2,000-particle swarm", swarm_sim(titan, 2000), "fast")):
        shape, state = marshalled(sim)
        got_route, reason = diff.grad_route(shape)
        check(got_route == route, f"{label}: route {got_route} ({reason})")
        leaves, st = mag_grad_leaves(state)
        wpos, wvel = grad_loss_weights(state)
        torch.cuda.synchronize()
        zero_mag_counts()
        out = diff.grad_rollout(shape, st, 20)
        torch.cuda.synchronize()
        f_counts = read_mag_counts()
        zero_mag_counts()
        loss = torch.sum(out.masses.pos * wpos) \
            + torch.sum(out.masses.vel * wvel)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        b_counts = read_mag_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        print(f"gradient routing ({label}, grad_rollout 20 steps): route "
              f"{got_route}" + (f" ({reason})" if reason else "")
              + "; forward: " + ", ".join(f"{k} {v}" for k, v in
                                          f_counts.items() if v)
              + "; backward: " + ", ".join(f"{k} {v}" for k, v in
                                           b_counts.items() if v)
              + f"; gradients finite: {finite}; |d loss / d pos|max "
              f"{float(grads[0].abs().max()):.3e}, |d loss / d "
              f"mag_maxf|max {float(grads[4].abs().max()):.3e}")
        adj = ("fused", "adjoint_trace", "adjoint_bwd", "transpose")
        if route == "adjoint":
            check(f_counts["fused"] == 20 and f_counts["pairwise"] == 20
                  and f_counts["eager"] == 0,
                  f"{label}: forward counts {f_counts}")
            check(all(b_counts[k] > 0 for k in adj[1:])
                  and b_counts["eager"] == 0,
                  f"{label}: backward counts {b_counts}")
        else:
            check(b_counts["eager"] == 20
                  and not any(b_counts[k] for k in adj + ("pairwise",
                                                          "grid")),
                  f"{label}: backward counts {b_counts}")
        check(finite and float(grads[0].abs().max()) > 0
              and float(grads[4].abs().max()) > 0,
              f"{label}: gradients not finite or zero")


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
            full = grid_bitwise(shape, state, f"{name} at the final state")
        fed = fused_vs_fed_plain(shape, state, 20, name)
        field_t, fused_t = time_magnet_path(name, shape, state, fk,
                                            200 if fk == "pairwise" else 100)
        kernels.append(dict(
            name=f"{kname} ({name})", route="cuda",
            source=f"titan_tpu_torch/{src}", replaces=replaces,
            launches=counts[fk], max_abs_err=max(worst_field[fk][0], full[0]),
            max_rel_err=max(worst_field[fk][1], full[1]),
            route_max_abs_err=worst_route[fk], **field_t,
            **({} if fk == "pairwise" else
               dict(tiles=full[3], tiles_over_stage=full[2])),
            library_ms=None))
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


def grid_bitwise(shape, state, name):
    """The grid kernel against its plain version on `state`, bitwise (the
    two sum in the same order), with the pass's tiles: (max |d|, max |d| /
    max |plain|, tiles over the stage, tiles)."""
    import torch
    from titan_tpu_torch.ops import magnets_grid
    m, cut = state.masses, shape.config.magnet_cutoff
    cap = shape.magnet_binned[1]
    a = magnets_grid.grid_magnet_forces(m, cut, cap)
    b = magnets_grid.grid_magnet_forces_plain(m, cut, cap)
    torch.cuda.synchronize()
    d, scale = float((a - b).abs().max()), float(b.abs().max())
    same = torch.equal(a, b)
    over, tiles, what = grid_tile_report(m, cut, cap)
    print(f"{name}: grid field kernel vs plain: "
          f"{'bitwise' if same else 'DIFFERENT'} (max |d| {d:.3e} of max "
          f"|plain| {scale:.3e}); {what}")
    check(same and scale > 0, f"{name}: the grid field kernel is not "
          "bitwise its plain version")
    return d, d / max(scale, 1e-30), over, tiles


# ---------------------------------------------------------------------------
# The tiled step (phases m-p): the tiled kernels against their plain
# version, the 100^3 stress config through Simulation, timing
# ---------------------------------------------------------------------------

# tiled kernel vs fused kernel on the same state: two independent ports of
# the same physics that sum in other orders (the families, then the
# constant force; against the constant force, then the families), so they
# agree only to f32 rounding, and in contact the stiff penalty amplifies
# each one-ulp difference (scripts/cuda_fmad_ab.py measured 3.5e-4 at 43^3
# and 8.8e-3 at 20^3, on a friction plane, of velocity over 200 landed
# steps between two roundings of one kernel).  Held over CROSS_STEPS
# landed steps:
# |d| <= TOL_CROSS (1 + |fused|) on pos and vel.
TOL_CROSS, CROSS_STEPS = 2e-2, 200
# the uniform-break check: BREAK_STEPS steps after one spring's k is
# multiplied by BREAK_K at a pause, held against the fused kernel within
# TOL_BREAK, a tenth of the 200-step horizon's tolerance for a tenth of
# its steps
BREAK_STEPS, BREAK_K, TOL_BREAK = 20, 10.0, 2e-3
# the stress path's breakpoints (s): it lands at their sum, 3.5 s
STRESS_NX, STRESS_WAITS = 100, (1.0, 1.0, 1.5)
TILED_VARIANTS = ("euler", "clamp_off", "verlet", "rk2", "damping_friction",
                  "actuated", "breathing", "drag", "ball", "nonuniform_k",
                  "nonuniform_rest", "deleted")
# the scenes of TILED_VARIANTS whose tiled backward keeps the general body
# (damped, actuated, breathing or non-uniform k); the others take the
# plain-spring loop
GENERAL_BWD_VARIANTS = ("damping_friction", "actuated", "breathing",
                        "nonuniform_k")


def tiled_counters():
    """The objects carrying the stepping paths' launch and step counts."""
    from titan_tpu_torch.ops import fused_step, tiled_step
    from titan_tpu_torch.ops import step as tstep
    return tiled_step.tiled_chunk, fused_step.fused_chunk, tstep.run_eager


def zero_tiled_counts():
    tiled, fused, eager = tiled_counters()
    tiled.mega_launches = tiled.step_launches = tiled.plain_launches = 0
    fused.launches = eager.steps = 0


def read_tiled_counts():
    """The stepping counts; ``plain``: the tiled launches that took the
    plain-spring loop."""
    tiled, fused, eager = tiled_counters()
    return dict(mega=tiled.mega_launches, step=tiled.step_launches,
                plain=tiled.plain_launches, fused=fused.launches,
                eager=eager.steps)


class uncounted:
    """Leaves every stepping count as it was: for the comparisons made at a
    pause of a main path, which must not count as the path's launches."""

    def __enter__(self):
        self.saved = read_tiled_counts()

    def __exit__(self, *exc):
        tiled, fused, eager = tiled_counters()
        tiled.mega_launches, tiled.step_launches = (self.saved["mega"],
                                                    self.saved["step"])
        tiled.plain_launches = self.saved["plain"]
        fused.launches, eager.steps = self.saved["fused"], self.saved["eager"]


def tiled_variant_scene(titan, variant, device="cuda"):
    """A 30 x 20 x 20 lattice (12,000 masses; family offsets up to 421, so
    a family's partners lie more than one 256-thread block away) exercising
    one feature of the tiled kernels, marshalled on `device`; returns
    (shape, state)."""
    import numpy as np
    cfg = dict(device=device, velocity_clamp=variant != "clamp_off")
    if variant in ("verlet", "rk2"):
        cfg["integrator"] = titan.Integrator(variant)
    sim = titan.Simulation(titan.SimConfig(**cfg))
    fric = variant == "damping_friction"
    # friction: the bottom layer starts 5 mm inside the plane, sliding
    sim.createLattice(titan.Vec(0, 0, 0.995 if fric else 2.0),
                      titan.Vec(3, 2, 2), 30, 20, 20)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    s, n = st.n_springs, st.n_masses
    if fric:
        st.damping[:s] = 0.4
        st.vel[:n] = (0.3, 0.1, 0.0)
        sim.createPlane(titan.Vec(0, 0, 1), 0, 0.4, 0.6)
    else:
        sim.createPlane(titan.Vec(0, 0, 1), 0)
    if variant == "actuated":
        third = s // 3
        st.s_type[:third] = titan.ACTUATED_EXPAND
        st.l_max[:third] = st.rest[:third] * 1.2
        st.rate[:third] = 0.5
        st.s_type[third:2 * third] = titan.ACTUATED_CONTRACT
        st.l_min[third:2 * third] = st.rest[third:2 * third] * 0.8
        st.rate[third:2 * third] = 0.5
        st.l_max[:8] = st.rest[:8] * 0.9    # past the bound: never advance
    elif variant == "breathing":
        st.s_type[: s // 2] = titan.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[: s // 2] = 7.0
    elif variant == "drag":
        st.drag[:n] = 0.3
    elif variant == "ball":
        sim.createBall(titan.Vec(0, 0, 1.5), 0.8)
    elif variant == "nonuniform_k":
        st.k[:s] *= 1.0 + 0.1 * np.random.RandomState(1).rand(s)
    elif variant == "nonuniform_rest":
        st.rest[:s] *= 1.0 + 0.01 * np.random.RandomState(0).rand(s)
    elif variant == "deleted":
        st.valid[[3, 17, 1000, 7777]] = False
    sim.setGlobalAcceleration(titan.Vec(0.5 if fric else 0.0, 0, -9.8))
    sim.setTimeStep(1e-4)
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


def state_diffs(a, b, fields=("pos", "vel", "acc", "T"), rest=False):
    """{field: max |a - b|} and whether every field is bitwise equal."""
    import torch
    out, same = {}, True
    pairs = [(f, getattr(a.masses, f), getattr(b.masses, f))
             for f in fields]
    if rest:
        pairs += [("rest", a.stencil.rest, b.stencil.rest),
                  ("remainder rest", a.springs.rest, b.springs.rest)]
    for f, x, y in pairs:
        out[f] = float((x - y).abs().max())
        same = same and bool(torch.equal(x, y))
    return out, same


def launch_counts_of(run):
    """(resident-grid, per-step, plain-spring) launch counts of
    tiled_step.tiled_chunk or adjoint_tiled.tiled_trace_run."""
    return run.mega_launches, run.step_launches, run.plain_launches


def check_step_path(label, shape, run, before, trace=False):
    """The launches `run` (tiled_chunk, or tiled_trace_run with `trace`)
    made since its counts were `before` (launch_counts_of) must have
    taken the plain-spring loop as the scene's path gives: every one on
    the plain path, none on the general body
    (tiled_step.plain_launch_count).  Returns what to print."""
    from titan_tpu_torch.ops import tiled_step
    mega, step, took = (a - b for a, b in zip(launch_counts_of(run),
                                               before))
    want = tiled_step.plain_launch_count(shape, mega, step)
    path = spring_path(shape)
    check(took == want and (want > 0) == (path == "plain"),
          f"{label}: {took} of {mega + step} {'replay' if trace else 'step'}"
          f" launches took the plain-spring loop, the {path} path gives "
          f"{want}")
    return f"{took} of {mega + step} launches on the plain-spring loop"


def check_profiled_path(label, shape, keys):
    """Each tiled step, grid or replay kernel among the profiler's `keys`
    must be the instantiation of the scene's path: the plain-spring loop
    (tiled_step_kernel<MODE, REM, true, TRACE>, tiled_mega_kernel<MODE,
    true, TRACE>, tiled_megark2_kernel<true, TRACE>: a PLAIN argument
    before TRACE, true) on the plain path, forward and replay alike, and
    the general body (tiled_step_kernel<MODE, REM, TRACE>,
    tiled_mega_kernel<MODE, false, TRACE>, tiled_megark2_kernel<TRACE>)
    elsewhere.  Returns the kernels seen."""
    import re
    full = {"tiled_step_kernel": 4, "tiled_mega_kernel": 3,
            "tiled_megark2_kernel": 2}
    plain = spring_path(shape) == "plain"
    seen = set()
    for k in keys:
        m = re.search(r"(tiled_step_kernel|tiled_mega_kernel|"
                      r"tiled_megark2_kernel)<([^>]*)>", k)
        if m is None:
            continue
        args = [a.strip() for a in m.group(2).split(",")]
        took = len(args) == full[m.group(1)] and args[-2] == "true"
        want = plain
        check(took == want, f"{label}: {m.group(0)} launched where the "
              f"{spring_path(shape)} path gives the "
              + ("plain-spring loop" if want else "general body"))
        seen.add(m.group(0))
    return sorted(seen)


def tiled_vs_plain(shape, state, steps, label, bad):
    """tiled_chunk (the kernels) against tiled_chunk_plain over `steps`
    steps, bitwise on pos, vel, acc, T (and rest), and one launch per step
    throughout (the per-step kernel alone) likewise; each run's launches
    must have taken the scene's path (check_step_path).  Appends a failure
    to `bad`.  Returns the max |d| and the kernels' output."""
    import torch
    from titan_tpu_torch.ops import tiled_step
    run = tiled_step.tiled_chunk
    before = launch_counts_of(run)
    got = tiled_step.tiled_chunk(shape, state, steps)
    took = check_step_path(label, shape, run, before)
    before = launch_counts_of(run)
    per_step = tiled_step._tiled_chunk_cuda(shape, state, steps, 0)
    took_step = check_step_path(label, shape, run, before)
    want = tiled_step.tiled_chunk_plain(shape, state, steps)
    torch.cuda.synchronize()
    d, same = state_diffs(got, want, rest=shape.has_actuated)
    for f in ("pos", "vel"):
        if not bool(torch.isfinite(getattr(got.masses, f)).all()):
            same = False
            d[f"non-finite {f}"] = 1.0
    d_step, same_step = state_diffs(per_step, want, rest=shape.has_actuated)
    print(f"tiled vs plain [{label}, {steps} steps, {spring_path(shape)} "
          f"path]: " + ("bitwise" if same else "DIFFER") + "; max |d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
          + f" ({took}); per-step launches only: "
          + ("bitwise" if same_step else f"DIFFER, max |d| {d_step}")
          + f" ({took_step})")
    if not same:
        bad.append(f"{label}: kernels differ from tiled_chunk_plain: {d}")
    if not same_step:
        bad.append(f"{label}: per-step launches differ from "
                   f"tiled_chunk_plain: {d_step}")
    return max(list(d.values()) + list(d_step.values())), got


def mega_vs_steps(shape, state, label, bad):
    """A resident-grid segment (16 steps) and two segments plus a tail of 5
    (37 steps) against one launch per step (two for RK2), bitwise."""
    import torch
    from titan_tpu_torch.ops import tiled_step
    for steps in (tiled_step.MEGA_SEG, 2 * tiled_step.MEGA_SEG + 5):
        a = tiled_step.tiled_chunk(shape, state, steps)
        b = tiled_step._tiled_chunk_cuda(shape, state, steps, 0)
        torch.cuda.synchronize()
        d, same = state_diffs(a, b, rest=shape.has_actuated)
        print(f"tiled mega vs per-step launches [{label}, {steps} steps]: "
              + ("bitwise" if same else f"DIFFER, max |d| {d}"))
        if not same:
            bad.append(f"{label}: {steps} steps through resident-grid "
                       f"launches differ from per-step launches: {d}")


def tiled_small_scenes(titan):
    """Phase n: every tiled kernel against tiled_chunk_plain over 100 steps
    on the small scenes, and the resident-grid kernels bitwise their
    per-step launches.  Returns the max |kernel - plain|."""
    from titan_tpu_torch.ops import tiled_step
    bad, worst = [], 0.0
    for variant in TILED_VARIANTS:
        shape, state = tiled_variant_scene(titan, variant)
        reason = tiled_step.tiled_reject_reason(shape)
        check(reason is None, f"tiled {variant}: {reason}")
        if variant == "nonuniform_k":
            check(not shape.stencil_uniform[0], "nonuniform_k: k uniform")
        if variant == "nonuniform_rest":
            check(not shape.stencil_uniform[1], "nonuniform_rest: rest "
                  "uniform")
        err, _ = tiled_vs_plain(shape, state, 100, f"tiled {variant}", bad)
        worst = max(worst, err)
        if variant in ("euler", "verlet", "rk2", "actuated", "breathing",
                       "damping_friction", "deleted"):
            mega_vs_steps(shape, state, f"tiled {variant}", bad)
    check(not bad, "; ".join(bad))
    return worst


def lattice_deltas(nx):
    """The 13 stencil families of an nx^3 lattice (PERF.md section 4)."""
    q = nx * nx
    return (1, nx, q, nx - 1, q - 1, q - nx, q + 1, nx + 1, q + nx,
            -(q - nx + 1), q - nx - 1, q + nx - 1, q + nx + 1)


def strained_spring(sim):
    """The index of the spring furthest from its rest length."""
    import numpy as np
    st = sim._store
    s = st.n_springs
    ln = np.linalg.norm(st.pos[st.right[:s]] - st.pos[st.left[:s]], axis=1)
    return int(np.argmax(np.abs(st.rest[:s] - ln)))


def cross_check(got, want, label, tol=TOL_CROSS):
    """(max |d| on pos and vel, worst |d| / (1 + |want|)) of two ports'
    states; fails beyond `tol`."""
    worst, d = 0.0, {}
    for f in ("pos", "vel"):
        a, b = getattr(got.masses, f), getattr(want.masses, f)
        diff = (a - b).abs()
        d[f] = float(diff.max())
        worst = max(worst, float((diff / (1 + b.abs())).max()))
    print(f"{label}: max |d| pos {d['pos']:.3e}, vel {d['vel']:.3e}; worst "
          f"|d| / (1 + |fused|) {worst:.3e} (tolerance {tol:g})")
    check(worst <= tol, f"{label}: beyond {tol:g}")
    return d, worst


def uniform_break(sim, name):
    """At a pause of the stress path: multiply the most strained spring's
    k by BREAK_K through Spring.set.  The uniform-k flag must clear, the
    tiled chunk over BREAK_STEPS steps must agree with the fused kernel
    (which reads the dense k) within TOL_BREAK, the spring's two masses
    must move otherwise than without the edit, and the tiled chunk with the
    flag left set (the fault the repair removes) must disagree."""
    import dataclasses
    import torch
    from titan_tpu_torch.ops import fused_step, tiled_step
    shape0, state0 = sim._shape, sim._snapshot()
    j = strained_spring(sim)
    sp = sim.springs[j]
    k0 = float(sp._k)
    sp._k = BREAK_K * k0
    sim.set(sp)
    shape, state = sim._shape, sim._snapshot()
    check(not shape.stencil_uniform[0]
          and shape.stencil_uniform[1:] == shape0.stencil_uniform[1:],
          f"{name}: the push left stencil_uniform {shape.stencil_uniform}")
    ends = torch.tensor([int(sim._store.left[j]), int(sim._store.right[j])],
                        device=state.masses.pos.device)
    got = tiled_step.tiled_chunk(shape, state, BREAK_STEPS)
    want = fused_step.fused_chunk(shape, state, BREAK_STEPS)
    plain = tiled_step.tiled_chunk(shape0, state0, BREAK_STEPS)
    stale = tiled_step.tiled_chunk(
        dataclasses.replace(shape, stencil_uniform=shape0.stencil_uniform),
        state, BREAK_STEPS)
    torch.cuda.synchronize()
    d, _ = cross_check(got, want, f"{name} uniform break (spring {j}, k "
                       f"{k0:g} -> {BREAK_K * k0:g}), tiled vs fused over "
                       f"{BREAK_STEPS} steps", TOL_BREAK)
    moved = float((got.masses.vel[:, ends] - plain.masses.vel[:, ends])
                  .abs().max())
    stale_d = float(((stale.masses.vel - want.masses.vel).abs()
                     / (1 + want.masses.vel.abs())).max())
    print(f"{name} uniform break: the spring's masses' velocity moved "
          f"{moved:.3e} from the run without the edit; with the flag left "
          f"set the tiled chunk is {stale_d:.3e} from the fused kernel")
    check(moved > 10 * d["vel"], f"{name}: the edit did not move the "
          f"spring's masses beyond the tiled-vs-fused difference")
    check(stale_d > TOL_BREAK, f"{name}: the stale-flag run agrees with "
          "the fused kernel: the check cannot see the fault")
    return j


def drive_stress(titan, name):
    """Phase o: the 100^3 stress config through the public API: start ->
    wait -> getAll -> resume at 4 breakpoints -> stop, every count set to 0
    just before and read just after; the uniform break at the landed pause
    (uncounted).  The tiled launches must be what the chunk lengths give
    (n // 16 resident-grid and n % 16 per-step launches per chunk), with no
    fused launch and no eager step.  Returns (counts, landed (shape,
    state))."""
    import numpy as np
    import torch
    from titan_tpu_torch.ops import tiled_step
    from titan_tpu_torch.ops.step import chunk_route
    from titan_tpu_torch.runtime import simulation as rsim
    t0 = time.perf_counter()
    # bench.py::build_bench_scene(100), the 100^3 stress config
    # (TITAN_BENCH_NX=100): 1,000,000 masses, 12,731,796 springs
    sim = bench_scene(titan, STRESS_NX)
    t_build = time.perf_counter() - t0
    st = sim._store
    n = st.n_masses
    z0 = st.pos[:n, 2].copy()
    lengths, recorded, chunk_shapes = [], [], []
    built = rsim.build_chunk_fn

    def recording(shape):
        fn = built(shape)
        recorded.append(shape)

        def chunk(state, n_steps):
            lengths.append(int(n_steps))
            chunk_shapes.append(shape)
            return fn(state, n_steps)
        return chunk

    rsim.build_chunk_fn = recording
    try:
        zero_tiled_counts()
        t0 = time.perf_counter()
        sim.start()
        t_marshal = time.perf_counter() - t0
        shape = sim._shape
        n_springs = int(sim._state.stencil.mask.sum())
        print(f"main path {name}: built in {t_build:.2f} s, marshalled in "
              f"{t_marshal:.2f} s (host); {n} masses (N = "
              f"{shape.n_masses} padded), {st.n_springs} springs, "
              f"{n_springs} marshalled into {len(shape.stencil_deltas)} "
              f"families, deltas {list(shape.stencil_deltas)}, uniform "
              f"{shape.stencil_uniform}, route {chunk_route(shape)[0]}")
        check(chunk_route(shape) == ("tiled", None),
              f"{name}: route {chunk_route(shape)}")
        check(sorted(shape.stencil_deltas) == sorted(lattice_deltas(
            STRESS_NX)) and not shape.has_remainder, f"{name}: families "
            f"{shape.stencil_deltas}")
        check(n_springs == st.n_springs, f"{name}: springs lost in the "
              "stencil families")
        check(shape.stencil_uniform[0], f"{name}: k not uniform")
        report_path(name, shape, "mega")
        for k, t in enumerate(STRESS_WAITS):
            sim.wait(t)
            sim.getAll()
            if k < len(STRESS_WAITS) - 1:
                sim.resume()
        landed = (sim._shape, sim._snapshot())
        t_land = sim.time()
        pos = st.pos[:n].copy()
        vel = st.vel[:n].copy()
        with uncounted():
            j = uniform_break(sim, name)
        sim.resume()
        sim.wait(0.01)
        sim.getAll()
        t_end = sim.time()
        sim.stop()
        torch.cuda.synchronize()
    finally:
        rsim.build_chunk_fn = built
        for key in recorded:
            rsim._CHUNK_CACHE.pop(key, None)
    counts = read_tiled_counts()
    wall = time.perf_counter() - t0
    seg = tiled_step.MEGA_SEG
    want = dict(mega=sum(k // seg for k in lengths),
                step=sum(k % seg for k in lengths),
                plain=sum(tiled_step.plain_launch_count(sh, k // seg, k % seg)
                          for sh, k in zip(chunk_shapes, lengths)))
    print(f"main path {name}: {len(lengths)} chunks, {sum(lengths)} steps; "
          f"tiled resident-grid launches {counts['mega']} (chunk lengths "
          f"give {want['mega']}), tiled per-step launches {counts['step']} "
          f"(give {want['step']}), {counts['plain']} of them on the "
          f"plain-spring loop (the chunks' paths give {want['plain']}: "
          f"every launch before the uniform break, none after it), "
          f"fused_step launches {counts['fused']}, eager steps "
          f"{counts['eager']}")
    check(counts["mega"] > 0, f"{name}: no resident-grid launch")
    check(counts["mega"] == want["mega"] and counts["step"] == want["step"]
          and counts["plain"] == want["plain"] and counts["plain"] > 0,
          f"{name}: launches {counts} against the chunk lengths' {want}")
    check(counts["fused"] == 0 and counts["eager"] == 0,
          f"{name}: fused launches or eager steps on the tiled path: "
          f"{counts}")
    t_want = sum(STRESS_WAITS)
    check(abs(t_land - t_want) < 1e-9 and abs(t_end - t_want - 0.01) < 1e-9,
          f"{name}: times {t_land}, {t_end}")
    check(np.isfinite(pos).all() and np.isfinite(vel).all(),
          f"{name}: non-finite state")
    speed = np.sqrt((vel * vel).sum(1))
    check(speed.max() <= 1.0 + 1e-5, f"{name}: clamp broken ({speed.max()})")
    check(-0.1 < pos[:, 2].min() < 0.2,
          f"{name}: lowest mass at z={pos[:, 2].min():.4f}")
    check(0.5 < pos[:, 2].mean() < z0.mean() - 2.0,
          f"{name}: mean z {pos[:, 2].mean():.3f} (from {z0.mean():.3f})")
    inside, static = contact_counts(*landed)
    check(inside > 0, f"{name}: no mass in contact at t={t_land}")
    print(f"main path {name}: t={t_end:.4f} s sim in {wall:.2f} s wall; at "
          f"t={t_land}: lowest z={pos[:, 2].min():.4f}, mean z "
          f"{z0.mean():.3f} -> {pos[:, 2].mean():.3f}, max |v|="
          f"{speed.max():.4f}, {inside} masses in contact; spring {j}'s k "
          f"edited at the pause")
    return counts, landed


def integrator_shape(shape, integrator):
    import dataclasses
    return dataclasses.replace(shape, config=dataclasses.replace(
        shape.config, integrator=integrator))


def tiled_bytes_per_mass(shape, state, mode):
    """The distinct bytes per mass of one launch in `mode` ("euler",
    "verlet", "rk2a", "rk2b"; a resident-grid launch moves those of one
    step): each input read once, each output written once."""
    from titan_tpu_torch.ops import tiled_step
    f = len(shape.stencil_deltas)
    plan = tiled_step._plan(shape)
    inv = 12 + 4 + 4 + 4 * f * len(plan) + (4 if "k" not in plan else 0) \
        + 4 * shape.has_drag                  # const_f, minv, fixed, planes
    inv += 4 * local_work(shape, state)[0]    # the local-constraint slots
    state_in = {"euler": 24, "verlet": 36, "rk2a": 24, "rk2b": 48}[mode]
    state_out = {"euler": 36, "verlet": 36, "rk2a": 24, "rk2b": 36}[mode]
    return inv + state_in + state_out


def tiled_bound_ms(shape, state, mode, steps):
    """((ms, by), bytes ms, ops ms) of one launch that advances `steps`
    force passes: bytes over 3.35 TB/s, operations (22 per spring, 25 per
    mass, per pass) over 67 TFLOP/s."""
    n_springs = int(state.stencil.mask.sum())
    r_bytes, r_ops, _ = rem_work(shape, state)
    t_bytes = (tiled_bytes_per_mass(shape, state, mode) * shape.n_masses
               + r_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = steps * (OPS_PER_SPRING * n_springs + r_ops
                     + (OPS_PER_MASS + local_work(shape, state)[1])
                     * shape.n_masses) \
        / F32_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), t_bytes, t_ops


def time_tiled(name, shape, state):
    """Phase p for one integrator from `state`: ms per step of the tiled
    chunk (CUDA events; 5,000 steps for Euler and Verlet, 200 for RK2), each
    kernel's device ms per launch (torch.profiler over a 200-step chunk:
    12 resident-grid launches and a tail of 8 steps), the plain version and
    the fused kernel on the same state.  Returns {kernel name: timing}."""
    import torch
    from titan_tpu_torch.ops import fused_step, tiled_step
    rk2 = shape.config.integrator.name == "RK2"
    seg = tiled_step.MEGA_SEG
    steps = 200 if rk2 else TIMED_STEPS

    def run(k):
        tiled_step.tiled_chunk(shape, state, k)

    def run_plain(k):
        tiled_step.tiled_chunk_plain(shape, state, k)

    def run_fused(k):
        fused_step.fused_chunk(shape, state, k)

    with uncounted():
        run(200)
        run_fused(200)
        run_plain(2)
        torch.cuda.synchronize()
        ms = event_ms(run, steps)
        fused_ms = event_ms(run_fused, steps)
        plain_ms = event_ms(run_plain, 10)
        names = ["tiled_megark2_kernel" if rk2 else "tiled_mega_kernel",
                 "tiled_step_kernel"]
        keys = []
        dev = profile_device_us(lambda: run(200), names, keys)
    seen = check_profiled_path(name, shape, keys)
    print(f"path {name}: the profiler saw {seen}")
    mode = "rk2" if rk2 else shape.config.integrator.name.lower()
    print(f"timing {name} tiled chunk: {ms * 1e3:.3f} us/step over "
          f"{steps} steps (CUDA events); fused kernel on the same state "
          f"{fused_ms * 1e3:.3f} us/step; plain version "
          f"{plain_ms * 1e3:.1f} us/step")
    out = {}
    passes = 2 if rk2 else 1
    for kname, per_launch_steps in ((names[0], seg), (names[1], None)):
        if per_launch_steps and not tiled_step.mega_seg(shape):
            continue            # a scene that takes per-step launches only
        t = dev.get(kname)
        if per_launch_steps:
            (b_ms, by), t_b, t_o = tiled_bound_ms(
                shape, state, "euler" if rk2 else mode, passes * seg)
            p_ms = plain_ms * seg
        elif rk2:
            # the rk2a and rk2b launches alternate; their mean per launch
            a_, b_ = (tiled_bound_ms(shape, state, m, 1)
                      for m in ("rk2a", "rk2b"))
            t_b, t_o = (a_[1] + b_[1]) / 2, (a_[2] + b_[2]) / 2
            b_ms, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
            p_ms = plain_ms / 2
        else:
            (b_ms, by), t_b, t_o = tiled_bound_ms(shape, state, mode, 1)
            p_ms = plain_ms
        us = None if t is None else t[0] / t[1]
        print(f"timing {name} {kname}: "
              + ("not measured (no device time recorded)" if us is None else
                 f"{us:.3f} us/launch on the device ({t[1]} launches)")
              + f"; bound {b_ms * 1e3:.4f} us/launch by {by} (bytes "
              f"{t_b * 1e3:.4f} us, ops {t_o * 1e3:.4f} us)")
        plain = spring_path(shape) == "plain"
        out[kname] = dict(ms=None if us is None else us / 1e3,
                          plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                          ms_per_step=ms, fused_ms_per_step=fused_ms,
                          path="plain" if plain else "general")
    return out


def tiled_phases(titan, kernels):
    """Phases n-p; appends the tiled entries to ``kernels``.  Returns the
    landed 100^3 (shape, state)."""
    import torch
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops import fused_step, tiled_step
    worst_small = tiled_small_scenes(titan)

    name = "stress 100^3"
    counts, (shape, state) = drive_stress(titan, name)
    inside, _ = contact_counts(shape, state)
    bad = []
    err, _ = tiled_vs_plain(shape, state, CROSS_STEPS, f"{name} landed", bad)
    got = tiled_step.tiled_chunk(shape, state, CROSS_STEPS)
    want = fused_step.fused_chunk(shape, state, CROSS_STEPS)
    torch.cuda.synchronize()
    cross_check(got, want, f"{name} landed ({inside} masses in contact), "
                f"tiled vs fused over {CROSS_STEPS} steps")
    runs = {"euler": (shape, counts, err)}
    for integ in (Integrator.RK2, Integrator.VERLET):
        sh = integrator_shape(shape, integ)
        report_path(f"{name} landed, {integ.name}", sh, "mega")
        zero_tiled_counts()
        tiled_step.tiled_chunk(sh, state, CROSS_STEPS)
        torch.cuda.synchronize()
        c = read_tiled_counts()
        per = 2 if integ is Integrator.RK2 else 1
        seg = tiled_step.MEGA_SEG
        print(f"{name} landed, {integ.name}: {CROSS_STEPS} steps ran "
              f"{c['mega']} resident-grid and {c['step']} per-step launches"
              f", {c['plain']} of them on the plain-spring loop")
        check(c["mega"] == CROSS_STEPS // seg
              and c["step"] == per * (CROSS_STEPS % seg)
              and c["plain"] == tiled_step.plain_launch_count(
                  sh, c["mega"], c["step"])
              and c["fused"] == c["eager"] == 0,
              f"{name} {integ.name}: launches {c}")
        e, _ = tiled_vs_plain(sh, state, CROSS_STEPS,
                              f"{name} landed {integ.name}", bad)
        runs[integ.name.lower()] = (sh, c, e)
    check(not bad, "; ".join(bad))

    src = "titan_tpu_torch/csrc/tiled_step.cu"
    for key, (sh, c, e) in runs.items():
        t = time_tiled(f"{name} {key}", sh, state)
        rk2 = key == "rk2"
        path = name if key == "euler" else f"{name} landed, {key}, " \
            f"{CROSS_STEPS} steps"
        mega = "tiled_megark2_kernel" if rk2 else "tiled_mega_kernel"
        kernels.append(dict(
            name=f"{mega} ({path})", route="cuda", source=src,
            replaces="titan_tpu/ops/pallas_tiled.py:"
            + ("1222" if rk2 else "1134"),
            launches=c["mega"], max_abs_err=max(e, worst_small),
            **t[mega], library_ms=None))
        kernels.append(dict(
            name=f"tiled_step_kernel ({path}"
            + (", rk2a + rk2b)" if rk2 else ")"), route="cuda", source=src,
            replaces="titan_tpu/ops/pallas_tiled.py:1051",
            launches=c["step"], max_abs_err=max(e, worst_small),
            **t["tiled_step_kernel"], library_ms=None))
    return shape, state


# ---------------------------------------------------------------------------
# The tiled adjoint (phases q-t): the trace replay and both backward kernels
# against their plain versions, the 100^3 gradient path, timing
# ---------------------------------------------------------------------------

# the tiled backward (B7) against tiled_bwd_run_plain on one trace: Euler
# and Verlet bitwise (the kernels run the plain version's operations in
# its order); RK2 per element, |d| <= TOL_BWD_ELEM (|plain| + 1e-3 max
# |plain|): its two passes' gradients reach the accumulators one after the
# other where the plain version adds them first, and the floor covers
# elements that are sums of cancelling terms
TOL_BWD_ELEM = 1e-4
# the trace replay's segment (two resident-grid segments and a tail) and
# the backward's segment in the kernel-vs-plain checks
TRACE_STEPS, BWD_STEPS = 37, 20
# the tiled adjoint's gradients against the fused adjoint's on the landed
# 100^3 state over CROSS_GRAD_STEPS steps: the normalised max error of
# tests/test_adjoint_tiled.py::_check_grads,
# max |tiled - fused| / max |fused| per gradient.  TOL_GRAD_CROSS under
# Verlet.  Under Euler with the velocity clamp, TOL_GRAD_CROSS_CLAMP: the
# clamp's Jacobian jumps at |v| = 1 (identity below, a projection above),
# the landed lattice has masses sliding at the clamp speed, and a one-ulp
# difference between the two forwards' force sums puts such a mass on the
# other side of the jump, which changes its gradient by O(1); the count of
# such masses is printed.  It is the bound the two forwards are held to
# (TOL_CROSS)
TOL_GRAD_CROSS, TOL_GRAD_CROSS_CLAMP, CROSS_GRAD_STEPS = 2e-4, 2e-2, 32
GRAD_NAMES = ("pos", "vel", "k", "rest", "m", "extern_force", "g")


def adjoint_counters():
    """{name: (object, attribute)} of every launch and step count the
    tiled gradient path must read."""
    from titan_tpu_torch.ops import adjoint, adjoint_tiled, fused_step
    from titan_tpu_torch.ops import step as tstep
    from titan_tpu_torch.ops import tiled_step
    tc, tr, tb = (tiled_step.tiled_chunk, adjoint_tiled.tiled_trace_run,
                  adjoint_tiled.tiled_bwd_run)
    return {"fwd_mega": (tc, "mega_launches"),
            "fwd_step": (tc, "step_launches"),
            "fwd_plain": (tc, "plain_launches"),
            "trace_mega": (tr, "mega_launches"),
            "trace_step": (tr, "step_launches"),
            "trace_plain": (tr, "plain_launches"),
            "bwd_mega": (tb, "mega_launches"),
            "bwd_step": (tb, "step_launches"),
            "fused": (fused_step.fused_chunk, "launches"),
            "adjoint_trace": (adjoint.trace_run, "launches"),
            "adjoint_bwd": (adjoint.bwd_run, "launches"),
            "adjoint_bwd_plain": (adjoint.bwd_run, "plain_launches"),
            "eager": (tstep.run_eager, "steps")}


def zero_adjoint_counts():
    for obj, attr in adjoint_counters().values():
        setattr(obj, attr, 0)


def read_adjoint_counts():
    return {k: getattr(obj, attr)
            for k, (obj, attr) in adjoint_counters().items()}


def spring_path(shape):
    """"plain" where the tiled kernels run the plain-spring loop on
    `shape` (fused_step.takes_plain_spring_path): the per-step kernel, the
    replay and every resident grid (step_body.cuh::plain_family_sum),
    and the backward kernels B7, B8 (adjoint_body.cuh::
    plain_family_transpose); else "general"."""
    from titan_tpu_torch.ops import fused_step
    return "plain" if fused_step.takes_plain_spring_path(shape) else \
        "general"


def check_spring_path(name, shape, launches):
    """The `launches` B7 and B8 launches since tiled_bwd_run.plain_launches
    was zeroed must all have run the plain-spring loop where `shape` takes
    it, and none where it does not."""
    from titan_tpu_torch.ops import adjoint_tiled as at
    took = at.tiled_bwd_run.plain_launches
    want = launches if spring_path(shape) == "plain" else 0
    check(took == want, f"{name}: {took} of {launches} backward launches "
          f"took the plain-spring loop, the {spring_path(shape)} path gives "
          f"{want}")


def report_spring_path(name, shape):
    """Print the path of the tiled adjoint's backward on `shape` (bwd_path)
    and, for each kernel the gradient path launches (B8 where
    mega_adjoint_ok, else B7's force and spring kernels and under RK2 its
    midpoint kernel), its threads a block, registers and local-memory
    bytes a thread and co-resident blocks an SM (B8: and its cooperative
    grid).  A lattice main path (13 families) must take the plain-spring
    loop."""
    from titan_tpu_torch.ops import adjoint_tiled as at
    path = spring_path(shape)
    if len(shape.stencil_deltas) == 13:
        check(path == "plain", f"{name}: the tiled backward does not take "
              "the plain-spring loop")
    integ = shape.config.integrator
    if at.mega_adjoint_ok(shape):
        names = ("B8",)
    else:
        names = ("force", "spring") + (("mid",) if integ.name == "RK2"
                                        else ())
    parts = []
    for k in names:
        i = at.bwd_kernel_info(k, path == "plain",
                               shape.has_remainder and k != "B8")
        what = ("tiled_megabwd_kernel" if k == "B8"
                else f"bwd_{k}_kernel<TiledBwdArgs>")
        grid = (f", {at.coop_blocks('bwd', integ, plain=path == 'plain')} "
                "co-resident blocks in all" if k == "B8" else "")
        parts.append(f"{what} {i['threads']} threads a block, "
                     f"{i['registers']} registers and {i['local_bytes']} B "
                     f"of local memory a thread, {i['blocks_per_sm']} "
                     f"blocks an SM{grid}")
    print(f"path {name}, tiled backward: "
          + ("the plain-spring loop" if path == "plain" else
             "the general body") + "; " + "; ".join(parts))


def bwd_diffs(got, ref, rk2):
    """A backward kernel's gradients against its plain version's: (max
    |d|, {key: error}, bitwise, failures).  Euler and Verlet must agree
    bitwise (error max |d| / max |plain|); RK2 per element within
    TOL_BWD_ELEM (|d| / (|plain| + 1e-3 max |plain|)).  k, damping and
    aratedt (and the remainder springs' k_e, damp_e, aratedt_e) are
    compared where a spring exists, as assemble_ct masks them."""
    import torch
    abs_err, rel, bitwise, fails = 0.0, {}, True, []
    for key, b in ref.items():
        if key in ("pair_ok", "rem_ok"):
            continue
        a, b = masked_bars(key, got[key], b, ref)
        if not bool(torch.isfinite(a).all()):
            fails.append(f"non-finite {key}")
        d = (a - b).abs()
        bitwise = bitwise and bool(torch.equal(a, b))
        abs_err = max(abs_err, float(d.max()))
        scale = max(float(b.abs().max()), 1e-30)
        if rk2:
            rel[key] = float((d / (b.abs() + 1e-3 * scale)).max())
            if rel[key] > TOL_BWD_ELEM:
                fails.append(f"{key} {rel[key]:.3e}")
        else:
            rel[key] = float(d.max()) / scale
            if not torch.equal(a, b):
                fails.append(f"{key} not bitwise ({rel[key]:.3e})")
    return abs_err, rel, bitwise, fails


def trace_entries_forward(shape, state, trace, steps):
    """Whether trace entries `steps` are bitwise the kernel chunk's states
    after that many steps."""
    import torch
    from titan_tpu_torch.ops import tiled_step
    ok = True
    for s in steps:
        fwd = tiled_step.tiled_chunk(shape, state, s)
        ok = ok and bool(torch.equal(trace[s, :6], torch.cat(
            [fwd.masses.pos, fwd.masses.vel])))
    return ok


def tiled_adjoint_vs_plain(shape, state, label, bad):
    """B6 bitwise tiled_trace_run_plain over TRACE_STEPS steps, through the
    forward's launches and through per-step launches only, each launch on
    the scene's path (check_step_path), and its entries after the first
    resident-grid segment and the last bitwise the kernel chunk's states;
    B7's per-step launches against tiled_bwd_run_plain on the first
    BWD_STEPS entries (bitwise for Euler and Verlet, TOL_BWD_ELEM per
    element for RK2); B8 (Euler, Verlet) bitwise B7.  Appends failures to
    `bad`; returns (trace max |d|, backward max |d|, backward max
    relative error, B7 bitwise)."""
    import torch
    from titan_tpu_torch.ops import adjoint_tiled as at
    from titan_tpu_torch.ops import tiled_step
    rk2 = shape.config.integrator.name == "RK2"
    inv = tiled_step.prep_tiled_inputs(shape, state)
    run = at.tiled_trace_run
    before = launch_counts_of(run)
    trace = at.tiled_trace_run(shape, state, TRACE_STEPS, inv)
    took = check_step_path(label, shape, run, before, trace=True)
    before = launch_counts_of(run)
    per_step = at._tiled_trace_cuda(shape, state, TRACE_STEPS, inv, 0)
    took_step = check_step_path(label, shape, run, before, trace=True)
    want = at.tiled_trace_run_plain(shape, state, TRACE_STEPS)
    torch.cuda.synchronize()
    dtr = max(float((trace - want).abs().max()),
              float((per_step - want).abs().max()))
    same = bool(torch.equal(trace, want)) and bool(torch.equal(
        per_step, want)) and trace_entries_forward(
            shape, state, trace, (tiled_step.MEGA_SEG, TRACE_STEPS - 1))
    if not same:
        bad.append(f"{label}: trace differs from tiled_trace_run_plain by "
                   f"{dtr:.3e}, or from the forward's states")
    del want, per_step
    trace = trace[:BWD_STEPS]
    cts = seeded_cotangents(shape.n_masses, trace.device)
    at.tiled_bwd_run.plain_launches = 0
    b7 = at._tiled_bwd_cuda(shape, state, trace, *cts, inv, mega=False)
    check_spring_path(label, shape, BWD_STEPS * (5 if rk2 else 2))
    ref = at.tiled_bwd_run_plain(shape, state, trace, *cts, inv)
    torch.cuda.synchronize()
    abs_err, rel, bitwise, fails = bwd_diffs(b7, ref, rk2)
    kind = "per element" if rk2 else "max |d| / max |plain|"
    print(f"tiled adjoint vs plain [{label}]: trace ({TRACE_STEPS} steps, "
          f"{spring_path(shape)} path; {took}; per-step launches only "
          f"{took_step}) "
          + ("bitwise, entries bitwise the forward's states" if same
             else f"DIFFERS ({dtr:.3e})")
          + f"; per-step backward ({BWD_STEPS} steps, {spring_path(shape)} "
          "path) "
          + ("bitwise" if bitwise else kind + ": " + ", ".join(
              f"{k} {v:.2e}" for k, v in rel.items()))
          + (f"  FAIL {fails}" if fails else ""))
    if fails:
        bad.append(f"{label}: per-step backward kernels disagree with "
                   f"tiled_bwd_run_plain: {fails}")
    if at.mega_adjoint_ok(shape):
        at.tiled_bwd_run.plain_launches = 0
        b8 = at._tiled_bwd_cuda(shape, state, trace, *cts, inv, mega=True)
        check_spring_path(label, shape, 1)
        torch.cuda.synchronize()
        diff = [k for k in ref if k != "pair_ok"
                and not torch.equal(b8[k], b7[k])]
        print(f"tiled adjoint resident-grid backward vs per-step launches "
              f"[{label}, {spring_path(shape)} path]: "
              + ("bitwise" if not diff else f"DIFFER in {diff}"))
        if diff:
            bad.append(f"{label}: the resident-grid backward differs from "
                       f"the per-step launches in {diff}")
    return dtr, abs_err, max(rel.values()), bitwise


def tiled_adjoint_small_scenes(titan):
    """Phase r: the three kernels against their plain versions on the 12
    tiled scenes.  Returns the worst (trace, backward abs, backward rel)
    errors of the RK2 scenes (key True) and of the others (key False)."""
    bad, worst = [], {False: [0.0] * 3, True: [0.0] * 3}
    for variant in TILED_VARIANTS:
        shape, state = tiled_variant_scene(titan, variant)
        want = "general" if variant in GENERAL_BWD_VARIANTS else "plain"
        check(spring_path(shape) == want, f"tiled {variant}: the backward "
              f"takes the {spring_path(shape)} path, not the {want} one")
        e = tiled_adjoint_vs_plain(shape, state, f"tiled {variant}", bad)
        rk2 = shape.config.integrator.name == "RK2"
        worst[rk2] = [max(w, x) for w, x in zip(worst[rk2], e[:3])]
    check(not bad, "; ".join(bad))
    return worst


def expected_grad_counts(shape, n_steps):
    """The launch counts a tiled gradient rollout of n_steps must give with
    the default segment: per segment the forward's and the replay's
    resident-grid and per-step launches, and B8's one launch (Euler,
    Verlet) or B7's per-step launches (RK2); nothing else."""
    from titan_tpu_torch.ops import adjoint_tiled as at
    from titan_tpu_torch.ops import tiled_step
    seg = at.default_segment(shape, n_steps)
    n_seg = n_steps // seg
    mega, step = tiled_step.launch_counts(shape, seg, tiled_step.mega_seg(
        shape))
    want = dict.fromkeys(adjoint_counters(), 0)
    want.update(fwd_mega=n_seg * mega, fwd_step=n_seg * step,
                trace_mega=n_seg * mega, trace_step=n_seg * step,
                fwd_plain=n_seg * tiled_step.plain_launch_count(
                    shape, mega, step),
                trace_plain=n_seg * tiled_step.plain_launch_count(
                    shape, mega, step))
    if at.mega_adjoint_ok(shape):
        want["bwd_mega"] = n_seg
    else:                   # five launches per RK2 step, else two
        rk2 = shape.config.integrator.name == "RK2"
        want["bwd_step"] = n_steps * (5 if rk2 else 2)
    return seg, want


def tiled_grad_path(name, shape, state, n_steps=GRAD_STEPS):
    """Phase s for one integrator: diff.grad_rollout + torch.autograd.grad
    over n_steps steps with the default segment, every count set to 0
    just before and read just after; the counts must be exactly what the
    segments give, the gradients finite.  Returns the counts."""
    import torch
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import adjoint_tiled as at
    check(diff.grad_route(shape) == ("tiled_adjoint", None),
          f"{name}: gradient route {diff.grad_route(shape)}")
    report_spring_path(name, shape)
    seg, want = expected_grad_counts(shape, n_steps)
    zero_adjoint_counts()
    at.tiled_bwd_run.plain_launches = 0
    t0 = time.perf_counter()
    loss, grads = run_grad(shape, state, diff.grad_rollout, n_steps)
    wall = time.perf_counter() - t0
    got = read_adjoint_counts()
    print(f"gradient path {name}: {n_steps} steps in segments of {seg}: "
          + ", ".join(f"{k} {v}" for k, v in got.items())
          + f"; {wall:.3f} s wall (first call)")
    check(got == want, f"{name}: counts {got}, the segments give {want}")
    check_spring_path(name, shape, got["bwd_mega"] + got["bwd_step"])
    for nm, g in zip(GRAD_NAMES, grads):
        check(bool(torch.isfinite(g).all()), f"{name}: d loss / d {nm} is "
              "not finite")
    print(f"gradient path {name}: loss {float(loss.detach()):.6e}; |grad|max "
          + ", ".join(f"{nm} {float(g.abs().max()):.3e}"
                      for nm, g in zip(GRAD_NAMES, grads)))
    return got


def clamp_flips(shape, state, trace_a, trace_b):
    """Masses that the Euler velocity clamp catches (|v + a dt| > 1, with
    the force the backward recomputes, in the fused order) at some step of
    one trace and not at that step of the other; and the masses caught at
    some step of either."""
    import torch
    from titan_tpu_torch.ops import adjoint
    P = adjoint._prep(shape, state)
    rg, rs = adjoint.torch_rolls()
    move = P["fixed"][0] == 0
    flips = torch.zeros(shape.n_masses, dtype=torch.bool,
                        device=trace_a.device)
    ever = flips.clone()
    for s in range(trace_a.shape[0]):
        t_now = P["t0"] + s * P["dt"]
        caught = []
        for tr in (trace_a, trace_b):
            # the clamp reads the velocity the local constraints leave
            f, vm, _ = adjoint._force(tr[s, :3], tr[s, 3:], P, rg, rs,
                                      t_now, cidx=adjoint._cidx(P, s, 1.0))
            v1 = vm + f * P["minv"] * P["dt"]
            caught.append((torch.sqrt(torch.sum(v1 * v1, dim=0)) > 1.0)
                          & move)
        flips |= caught[0] != caught[1]
        ever |= caught[0] | caught[1]
    return int(flips.sum()), int(ever.sum())


def tiled_vs_fused_grads(name, shape, state, tol):
    """The tiled adjoint against the fused adjoint from the same state over
    CROSS_GRAD_STEPS steps.  First both backward sweeps on ONE trace (the
    fused forward's), which must agree bitwise: the two transposes are the
    same math on value-identical inputs.  Then the two forwards' traces
    (their sums run in other orders): the largest state difference, the
    masses whose side of a contact plane differs at some step and, under
    the Euler clamp, the masses the clamp catches in one and not the
    other.  Then the two rollouts' gradients, at `tol`.  Returns the
    gradients' max normalised error."""
    import torch
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import adjoint, adjoint_tiled
    n_steps = CROSS_GRAD_STEPS
    trace_f = adjoint.trace_run(shape, state, n_steps)
    cts = seeded_cotangents(shape.n_masses, trace_f.device)
    g_f = adjoint.bwd_run(shape, state, trace_f, *cts)
    g_t = adjoint_tiled.tiled_bwd_run(shape, state, trace_f, *cts)
    torch.cuda.synchronize()
    ok = g_f["pair_ok"]
    # k, damping and rate gradients of missing slots are masked in
    # assemble_ct (they read each side's rest there)
    masked = lambda k, x: torch.where(ok, x, 0.0) \
        if k in ("k", "damping", "aratedt") else x  # noqa: E731
    same = [k for k in g_f if k != "pair_ok"
            and not torch.equal(masked(k, g_f[k]), masked(k, g_t[k]))]
    print(f"{name}: the tiled backward and the fused backward on the fused "
          f"forward's {n_steps}-step trace: "
          + ("bitwise" if not same else f"DIFFER in {same}"))
    check(not same, f"{name}: the two backward sweeps differ on one trace "
          f"in {same}")
    del g_f, g_t
    trace_t = adjoint_tiled.tiled_trace_run(shape, state, n_steps)
    g = state.gcon
    side = []
    for tr in (trace_f, trace_t):
        inside = torch.zeros(tr.shape[0], shape.n_masses, dtype=torch.bool,
                             device=tr.device)
        for p in range(shape.n_planes):
            disp = torch.einsum("c,scn->sn", g.plane_normal[p].float(),
                                tr[:, :3]) - g.plane_offset[p]
            inside |= disp < 0
        side.append(inside)
    flips = int((side[0] != side[1]).any(dim=0).sum())
    in_contact = int(side[0].any(dim=0).sum())
    dstate = [float((trace_t[:, r] - trace_f[:, r]).abs().max())
              for r in (slice(0, 3), slice(3, 6))]
    clamp = ""
    if shape.config.velocity_clamp and shape.config.integrator.name == \
            "EULER":
        c_flips, c_ever = clamp_flips(shape, state, trace_f, trace_t)
        clamp = (f"; the velocity clamp catches {c_ever} masses at some "
                 f"step, {c_flips} of them at a step where it does not in "
                 "the other forward")
    print(f"{name}: tiled vs fused forward over {n_steps} steps: max |d| "
          f"pos {dstate[0]:.3e}, vel {dstate[1]:.3e}; {in_contact} masses "
          f"in contact at some step, {flips} of them on the other side of "
          f"the plane at some step in the other forward" + clamp)
    bins = None
    if shape.cap_cp and bool((state.lcon.cp_fk[:, 0] > 0).any()):
        bins = slide_bins(state, trace_f)
        dv = (trace_t[:, 3:6] - trace_f[:, 3:6]).norm(dim=1).amax(0)
    del trace_f, trace_t, side
    _, gt = run_grad(shape, state, diff.tiled_adjoint_rollout, n_steps)
    _, gf = run_grad(shape, state, diff.adjoint_rollout, n_steps)
    mask = state.stencil.mask
    errs = {}
    for nm, a, b in zip(GRAD_NAMES, gt, gf):
        if nm in ("k", "rest"):
            a, b = torch.where(mask, a, 0.0), torch.where(mask, b, 0.0)
        errs[nm] = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-8)
    if bins is not None:
        report_slide_bins(name, bins, dv, gt[0], gf[0])
    print(f"{name}: tiled vs fused adjoint gradients over {n_steps} steps, "
          "max |d| / max |fused|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {tol:g})")
    check(max(errs.values()) <= tol, f"{name}: tiled and fused adjoint "
          f"gradients differ beyond {tol:g}: {errs}")
    return max(errs.values())


# the bins of slide_bins: a mass's least sliding speed across its contact
# slot while inside it, in m/s
SLIDE_EDGES = (1e-4, 1e-3, 1e-2, 1e-1)


def slide_bins(state, trace):
    """Per mass, the bin by SLIDE_EDGES of the least |v_perp| (its speed
    across the normal of its first contact slot) over the steps of `trace`
    at which it is inside that slot's plane: 0 below the first edge, ...,
    len(SLIDE_EDGES) above the last; len(SLIDE_EDGES) + 1 for a mass that
    never is.  Kinetic friction pulls along v_perp / |v_perp|, whose
    derivative grows as 1 / |v_perp|."""
    import torch
    lc = state.lcon
    nrm = lc.cp_normal[:, 0, :].T.float()
    inside = (((trace[:, :3] * nrm).sum(1) - lc.cp_offset[:, 0].float() < 0)
              & (lc.cp_count > 0))
    vel = trace[:, 3:6]
    vperp = (vel - (vel * nrm).sum(1, keepdim=True) * nrm).norm(dim=1)
    vmin = torch.where(inside, vperp, math.inf).amin(0)
    edges = torch.tensor(SLIDE_EDGES, device=vmin.device)
    bins = torch.bucketize(vmin, edges)
    return torch.where(torch.isinf(vmin), len(SLIDE_EDGES) + 1, bins)


def report_slide_bins(name, bins, dv, g_tiled, g_fused):
    """Prints, per slide_bins bin, its masses, the largest difference of
    velocity between the two forwards at any step, and the largest
    difference of d loss / d pos between the two gradients (over max
    |fused|): where the two parted."""
    scale = max(float(g_fused.abs().max()), 1e-30)
    dg = (g_tiled - g_fused).norm(dim=0) / scale
    labels = ([f"|v_perp| < {SLIDE_EDGES[0]:g}"]
              + [f"{a:g}-{b:g}" for a, b in zip(SLIDE_EDGES, SLIDE_EDGES[1:])]
              + [f">= {SLIDE_EDGES[-1]:g}", "never inside its slot"])
    parts = []
    for b, label in enumerate(labels):
        sel = bins[: dg.shape[0]] == b
        cnt = int(sel.sum())
        if cnt:
            parts.append(f"{label}: {cnt} masses, forward max |d vel| "
                         f"{float(dv[sel].max()):.3e}, gradient max |d| "
                         f"{float(dg[sel].max()):.3e}")
    print(f"{name}: by the least |v_perp| on a friction contact slot "
          "(tiled vs fused; gradient of pos over max |fused|): "
          + "; ".join(parts))


def tiled_adjoint_bound_ms(shape, state, kind, steps):
    """((ms, by), bytes ms, ops ms) of one launch of `kind` covering `steps`
    steps: "trace" (a replay launch: the forward step's bytes once, see
    tiled_bytes_per_mass, plus a 24 B trace entry per mass and step; the
    forward's operations per pass), "bwd" (reversed steps: each step's
    trace entry read, the carry read and written once, the invariants and
    the per-spring bars read once and written once; per pass the force
    recompute and its transpose).  Bytes over 3.35 TB/s, operations over
    67 TFLOP/s."""
    from titan_tpu_torch.ops import adjoint_tiled as at
    from titan_tpu_torch.ops import tiled_step
    rk2 = shape.config.integrator.name == "RK2"
    passes = 2 if rk2 else 1
    n = shape.n_masses
    n_springs = int(state.stencil.mask.sum())
    mode = "euler" if rk2 else shape.config.integrator.name.lower()
    lrows, lops = local_work(shape, state)
    r_bytes, r_ops, r_ops_t = rem_work(shape, state)
    if kind == "trace":
        per_mass = tiled_bytes_per_mass(shape, state, mode) + 24 * steps
        ops = steps * passes * (OPS_PER_SPRING * n_springs + r_ops
                                + (OPS_PER_MASS + lops) * n)
    else:
        f = len(shape.stencil_deltas)
        plan = tiled_step._plan(shape)
        inv = 12 + 4 + 4 + 4 * f * len(plan) \
            + (4 if "k" not in plan else 0) + 4 * shape.has_drag \
            + 4 * lrows
        _, nb = at.bar_plan(shape)
        # the trace entry: pos and vel, and a magnet scene's per-pass cf
        per_mass = 4 * at.trace_rows(shape) * steps + 36 * 2 + inv \
            + 4 * nb * 2
        # the per-spring gradients, written once
        r_bytes += 5 * 4 * r_ops_t / (2 * REM_OPS_T)
        ops = steps * passes * (
            (OPS_PER_SPRING + OPS_PER_SPRING_T) * n_springs + r_ops + r_ops_t
            + (OPS_PER_MASS + OPS_PER_MASS_T + 3 * lops) * n)
    t_bytes = (per_mass * n + r_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), t_bytes, t_ops


def host_ms(fn, reps=3):
    """Median host ms of fn(), synchronised before and after."""
    import torch
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def time_tiled_adjoint(name, shape, state):
    """Phase t for one integrator at 100^3: forward + backward per step of
    the tiled route and of the fused adjoint on the same state (host
    clock); each kernel's device time per launch (torch.profiler) over one
    default segment, beside its bound and its plain version.  Returns
    {entry: timing}."""
    import torch
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import adjoint_tiled as at
    from titan_tpu_torch.ops import tiled_step
    rk2 = shape.config.integrator.name == "RK2"
    seg = at.default_segment(shape, GRAD_STEPS)
    k_seg = tiled_step.mega_seg(shape)
    w = grad_loss_weights(state)
    new_ms = host_ms(lambda: run_grad(shape, state, diff.grad_rollout,
                                      weights=w)) / GRAD_STEPS
    old_ms = host_ms(lambda: run_grad(shape, state, lambda sh, st, k:
                                      diff.adjoint_rollout(sh, st, k,
                                                           segment=SEG),
                                      weights=w), reps=1) / GRAD_STEPS
    inv = tiled_step.prep_tiled_inputs(shape, state)
    trace = at.tiled_trace_run(shape, state, seg, inv)
    cts = seeded_cotangents(shape.n_masses, trace.device)
    mega_ok = at.mega_adjoint_ok(shape)
    per = 5 if rk2 else 2
    passes = 2 if rk2 else 1
    # each launch kind run alone through its wrapper, for the CUDA-event
    # fallback: (fn(k) covering k launches' worth, k)
    alone = {"trace_mega": (lambda k: at._tiled_trace_cuda(
                 shape, state, k_seg, inv, k_seg), 1) if k_seg else None,
             "trace_step": (lambda k: at._tiled_trace_cuda(
                 shape, state, 1, inv, 0), passes),
             "bwd_step": (lambda k: at._tiled_bwd_cuda(
                 shape, state, trace[:1], *cts, inv, mega=False), per)}
    if mega_ok:
        alone["bwd_mega"] = (lambda k: at._tiled_bwd_cuda(
            shape, state, trace, *cts, inv, mega=True), 1)

    def measured():
        at.tiled_trace_run(shape, state, seg, inv)
        at._tiled_bwd_cuda(shape, state, trace, *cts, inv, mega=False)
        if mega_ok:
            at._tiled_bwd_cuda(shape, state, trace, *cts, inv, mega=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the window's first launches may go unrecorded: a warm-up first,
        # then the measured calls (device time per launch is their mean)
        at.tiled_trace_run(shape, state, 1, inv)
        torch.cuda.synchronize()
        for _ in range(2):
            measured()
        torch.cuda.synchronize()
    # the replay's grids only: B8 (tiled_megabwd_kernel<true>, its
    # plain-spring instantiation) also holds "mega" and "true>"
    groups = {"trace_mega": lambda k: ("tiled_mega_kernel<" in k
                                       or "tiled_megark2_kernel<" in k)
              and "true>" in k,
              "trace_step": lambda k: "tiled_step_kernel" in k
              and "true>" in k,
              "bwd_step": lambda k: "<TiledBwdArgs," in k,
              "bwd_mega": lambda k: "tiled_megabwd_kernel" in k}
    dev = {}
    seen = check_profiled_path(name, shape, [e.key for e in
                                             prof.key_averages()])
    print(f"path {name} replay: the profiler saw {seen}")
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        for g, hit in groups.items():
            if hit(e.key) and e.count and t:
                t0, c0 = dev.get(g, (0.0, 0))
                dev[g] = (t0 + t, c0 + e.count)
    p_trace = at.tiled_trace_run_plain(shape, state, 2)
    tr_plain = event_ms(lambda k: at.tiled_trace_run_plain(shape, state, k),
                        2, reps=1)
    bw_plain = event_ms(lambda k: at.tiled_bwd_run_plain(
        shape, state, p_trace, *cts, inv), 2, reps=1)
    del p_trace
    print(f"timing {name} gradient path: forward + backward "
          f"{new_ms * 1e3:.3f} us/step over {GRAD_STEPS} steps (tiled "
          f"adjoint, segments of {seg}; host clock); fused adjoint on the "
          f"same state {old_ms * 1e3:.3f} us/step (segments of {SEG})")
    out = {}
    for g, steps, plain in (("trace_mega", k_seg, tr_plain * k_seg),
                            ("trace_step", 1, tr_plain / passes),
                            ("bwd_step", 1, bw_plain / per),
                            ("bwd_mega", seg, bw_plain * seg)):
        if alone.get(g) is None:
            continue
        if g in dev:
            ms = dev[g][0] / dev[g][1] / 1e3
            how = f"on the device ({dev[g][1]} launches, torch.profiler)"
        else:
            fn, launches = alone[g]
            ms = event_ms(fn, launches)
            how = ("NOT the device time: the profiler recorded none, so this "
                   "is the wrapper's CUDA-event time, host staging included")
        kind = "trace" if g.startswith("trace") else "bwd"
        # a per-step launch covers one force pass (trace) or one of the
        # step's `per` launches (backward): its share of a step's bound
        share = passes if g == "trace_step" else (
            per if g == "bwd_step" else 1)
        (b_ms, by), t_b, t_o = tiled_adjoint_bound_ms(shape, state, kind,
                                                      steps)
        b_ms, t_b, t_o = b_ms / share, t_b / share, t_o / share
        print(f"timing {name} {g}: {ms * 1e3:.3f} us/launch {how}; bound "
              f"{b_ms * 1e3:.4f} us/launch by {by} (bytes {t_b * 1e3:.4f} "
              f"us, ops {t_o * 1e3:.4f} us), {100 * b_ms / ms:.2f}% of "
              f"bound; plain {plain * 1e3:.1f} us/launch")
        out[g] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                      fwd_bwd_ms_per_step=new_ms,
                      fused_adjoint_ms_per_step=old_ms,
                      path=spring_path(shape))
    if not rk2 and shape.config.integrator.name == "EULER":
        profile_grad_path(name, shape, state, segment=None)
    return out


def tiled_adjoint_phases(titan, kernels, shape, state):
    """Phases r-t from the landed 100^3 state of phase o; appends the
    tiled adjoint's entries to ``kernels``."""
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops import adjoint_tiled as at
    worst_small = tiled_adjoint_small_scenes(titan)
    name = "stress 100^3"
    runs = {}
    for integ in (Integrator.EULER, Integrator.VERLET, Integrator.RK2):
        sh = integrator_shape(shape, integ)
        label = f"{name} landed, {integ.name}"
        counts = tiled_grad_path(label, sh, state)
        bad = []
        e = tiled_adjoint_vs_plain(sh, state, label, bad)
        check(not bad, "; ".join(bad))
        runs[integ] = (sh, counts, e)
    cross = {integ: tiled_vs_fused_grads(
        f"{name} landed, {integ.name}", runs[integ][0], state, tol)
        for integ, tol in ((Integrator.EULER, TOL_GRAD_CROSS_CLAMP),
                           (Integrator.VERLET, TOL_GRAD_CROSS))}
    src = "titan_tpu_torch/csrc/tiled_adjoint.cu"
    for integ, (sh, counts, e) in runs.items():
        t = time_tiled_adjoint(f"{name} {integ.name}", sh, state)
        path = f"{name} gradient path, {integ.name}, {GRAD_STEPS} steps"
        worst = worst_small[integ is Integrator.RK2]
        err = dict(trace=max(e[0], worst[0]), bwd=max(e[1], worst[1]))
        for g, kname, replaces in (
                ("trace_mega",
                 "tiled_megark2_kernel<PLAIN, true> (trace replay"
                 if integ is Integrator.RK2 else
                 "tiled_mega_kernel<MODE, PLAIN, true> (trace replay",
                 "titan_tpu/ops/pallas_tiled.py:1305"),
                ("trace_step",
                 "tiled_step_kernel<MODE, REM, PLAIN, true> (trace replay",
                 "titan_tpu/ops/pallas_tiled.py:1305"),
                ("bwd_step", "bwd_force_kernel + bwd_spring_kernel"
                 + (" + bwd_mid_kernel" if integ is Integrator.RK2 else "")
                 + "<TiledBwdArgs> (per-step backward",
                 "titan_tpu/ops/adjoint_tiled.py:671"),
                ("bwd_mega", "tiled_megabwd_kernel (resident-grid backward",
                 "titan_tpu/ops/adjoint_tiled.py:906")):
            if counts[g] == 0 or g not in t:
                continue        # this integrator's path does not run it
            kernels.append(dict(
                name=f"{kname}, {path})", route="cuda", source=src,
                replaces=replaces, launches=counts[g],
                max_abs_err=err["trace" if g.startswith("trace") else "bwd"],
                **({} if g.startswith("trace") else
                   dict(max_rel_err=max(e[2], worst[2]),
                        grad_vs_fused_adjoint=cross.get(integ))),
                **{k: v for k, v in t[g].items()}, library_ms=None))


# ---------------------------------------------------------------------------
# Local constraints (phases u-y): every kernel's local-constraint branch
# against its plain version on small scenes, the 43^3 and 100^3 scenes with
# per-mass slots through Simulation, their gradient paths, timing
# ---------------------------------------------------------------------------

# phase u's scenes: (slots, integrator) on a 30 x 20 x 20 lattice
LOCAL_SCENES = (("cp", "euler"), ("cp_friction", "euler"), ("ball", "euler"),
                ("pl", "euler"), ("dir", "euler"), ("all", "euler"),
                ("all", "verlet"), ("all", "rk2"), ("cp_friction", "rk2"),
                ("pl", "rk2"), ("dir", "verlet"), ("all_drag", "euler"))
# phase w's waits (s): 1,017 and then 983 steps at dt 1e-4 from t = 0 (a
# chunk that is no multiple of 16 runs per-step launches too)
LOCAL_STRESS_WAITS = (0.1017, 0.0983)
# the 100^3 local scene's RK2 gradient path: one default segment.  Every
# mass carries a friction-bearing contact plane, and its kinetic friction
# pulls along v_perp / |v_perp|, whose derivative grows as 1 / |v_perp|
# on the masses that slide slowly: the true gradient then grows by orders
# of magnitude per segment (measured at 100^3 on the card: max |d loss /
# d pos| 1.6e16 after 50 RK2 steps, 7.7e27 after 100, past f32's range
# after 200; without the slots' friction 1.6e4 after 200).  Euler and
# Verlet stay finite over GRAD_STEPS (2.6e19 and 9.4e12)
LOCAL_RK2_GRAD_STEPS = 50
# the same friction makes phase w's tiled-vs-fused adjoint cross-check
# ill-conditioned: the two forwards sum in other orders, and the roundings
# set the direction kinetic friction pulls a slowly sliding mass in, so
# within 32 Verlet steps they part by 1.06e-3 of velocity and the
# gradients by up to 0.138 (normalised; measured on an H100).  The check
# at TOL_GRAD_CROSS runs on the same state with the contact slots'
# friction off (every slot type still acts); the friction case is printed
# beside it
SLOT_TYPES = ("contact plane", "ball", "constraint plane", "direction")


def unit(v):
    import numpy as np
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)


def add_slots(st, cp=None, ball=None, pl=None, dr=None):
    """Per-mass local-constraint records in the host store `st`, each type
    given as (mass indices, record): a contact plane (normal, offset) as
    Mass.addConstraint writes it, or (normal, offset, fk, fs) as the
    per-env plane sweep writes it; a ball (centre, radius); a constraint
    plane (normal, friction); a direction (tangent, friction)."""
    for sel, field in ((cp, "contact_planes"), (ball, "balls"),
                       (pl, "constraint_planes"), (dr, "directions")):
        if sel is not None:
            idx, rec = sel
            for i in idx.tolist():
                getattr(st.local_record(i), field).append(rec)


def small_lattice(titan, integrator):
    """A 30 x 20 x 20 lattice (12,000 masses, z in [0.2, 2.2], k 1000)
    sliding at (0.3, 0.1, -0.2) onto a 0.4 / 0.6 friction plane, dt 1e-4,
    on the card, not marshalled yet."""
    sim = titan.Simulation(titan.SimConfig(
        integrator=titan.Integrator[integrator.upper()]))
    sim.createLattice(titan.Vec(0, 0, 1.2), titan.Vec(3, 2, 2), 30, 20, 20)
    sim.setAllSpringConstantValues(1000.0)
    sim.setTimeStep(1e-4)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.createPlane(titan.Vec(0, 0, 1), 0, 0.4, 0.6)
    sim._store.vel[:sim._store.n_masses] = (0.3, 0.1, -0.2)
    return sim


def local_small_scene(titan, slots, integrator, sim=None):
    """small_lattice (or `sim`) with the slots that `slots` names: a
    contact plane at offset 0.7 on every third mass ("cp"; with friction
    0.4 / 0.6 for "cp_friction"; "all" has both, on the first and second
    third), a ball of radius 0.8 around (-1.5, 0, 1.2) on the masses at
    x < -0.5, a constraint plane (normal x, friction 0.1) on the top
    layer, a direction (0.2, 0, 1) with friction 0.2 on every seventh
    mass; "all_drag" adds drag 0.3.  Marshalled on the card; returns
    (shape, state)."""
    import numpy as np
    sim = sim or small_lattice(titan, integrator)
    st = sim._store
    n = st.n_masses
    pos = st.pos[:n]
    idx = np.arange(n)
    every = slots.startswith("all")
    nrm = unit((0, 0.05, 1))
    if slots == "cp" or every:
        add_slots(st, cp=(idx[0::3], (nrm, 0.7)))
    if slots == "cp_friction" or every:
        add_slots(st, cp=(idx[1::3] if every else idx[0::3],
                          (nrm, 0.7, 0.4, 0.6)))
    if slots == "ball" or every:
        add_slots(st, ball=(idx[pos[:, 0] < -0.5],
                            (np.array([-1.5, 0.0, 1.2]), 0.8)))
    if slots == "pl" or every:
        top = np.isclose(pos[:, 2], pos[:, 2].max())
        add_slots(st, pl=(idx[top], (unit((1, 0, 0)), 0.1)))
    if slots == "dir" or every:
        add_slots(st, dr=(idx[0::7], (unit((0.2, 0, 1)), 0.2)))
    if slots == "all_drag":
        st.drag[:n] = 0.3
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


def local_scene(titan, nx):
    """bench.py's scene at nx^3 (bench_scene) with the slots of the local
    main paths: every mass a friction-bearing contact plane in the record
    form the per-env plane sweep writes (normal (0, 0.05, 1) normalised,
    offset 0.02, or 3.02 at the lattice's bottom face at 100^3, fk 0.4, fs
    0.6); the top layer a constraint plane (normal (1, 0, 0), friction
    0.1); one bottom edge a direction (0, 0, 1) with friction 0.2; the side
    face x = -2 a ball of radius 1 around (-2, 0, 2), or (-2, 0, 3.5) at
    100^3.  At 100^3 the constraint plane's normal is tilted to (1, 0,
    0.05): so that every slot acts from step 0 there (the top layer of a
    falling lattice feels no force and moves not at all along x)."""
    import numpy as np
    sim = bench_scene(titan, nx)
    st = sim._store
    n = st.n_masses
    pos = st.pos[:n]
    idx = np.arange(n)
    stress = nx == STRESS_NX
    bottom = np.isclose(pos[:, 2], pos[:, 2].min())
    edge = bottom & np.isclose(pos[:, 1], pos[:, 1].min())
    add_slots(
        st, cp=(idx, (unit((0, 0.05, 1)), 3.02 if stress else 0.02, 0.4,
                      0.6)),
        ball=(idx[np.isclose(pos[:, 0], pos[:, 0].min())],
              (np.array([-2.0, 0.0, 3.5 if stress else 2.0]), 1.0)),
        pl=(idx[np.isclose(pos[:, 2], pos[:, 2].max())],
            (unit((1, 0, 0.05 if stress else 0)), 0.1)),
        dr=(idx[edge], (unit((0, 0, 1)), 0.2)))
    return sim


def fused_local_vs_plain(shape, state, label, bad, steps=100):
    """The fused step over `steps` steps, the adjoint's trace over
    BWD_STEPS steps and its backward on that trace against their plain
    versions: bitwise, the RK2 backward per element (bwd_diffs).  Appends
    failures to `bad`; returns (step, trace, backward) max |d|."""
    import torch
    from titan_tpu_torch.ops import adjoint, fused_step
    rk2 = shape.config.integrator.name == "RK2"
    got = fused_step.fused_chunk(shape, state, steps)
    want = fused_step.fused_chunk_plain(shape, state, steps)
    torch.cuda.synchronize()
    d, same = state_diffs(got, want, rest=shape.has_actuated)
    trace = adjoint.trace_run(shape, state, BWD_STEPS)
    twant = adjoint.trace_run_plain(shape, state, BWD_STEPS)
    torch.cuda.synchronize()
    dtr = float((trace - twant).abs().max())
    tsame = bool(torch.equal(trace, twant))
    del twant
    cts = seeded_cotangents(shape.n_masses, trace.device)
    g = adjoint.bwd_run(shape, state, trace, *cts)
    ref = adjoint.bwd_run_plain(shape, state, trace, *cts)
    torch.cuda.synchronize()
    dbw, rel, bitwise, fails = bwd_diffs(g, ref, rk2)
    print(f"fused local vs plain [{label}]: step ({steps} steps) "
          + ("bitwise" if same else f"DIFFERS {d}") + f"; trace "
          f"({BWD_STEPS} steps) " + ("bitwise" if tsame else
                                     f"DIFFERS ({dtr:.3e})")
          + "; backward " + ("bitwise" if bitwise else "per element: "
                             + ", ".join(f"{k} {v:.2e}"
                                         for k, v in rel.items()))
          + (f"  FAIL {fails}" if fails else ""))
    if not same:
        bad.append(f"{label}: fused kernel differs from plain: {d}")
    if not tsame:
        bad.append(f"{label}: trace differs from plain by {dtr:.3e}")
    if fails:
        bad.append(f"{label}: backward differs from plain: {fails}")
    return max(d.values()), dtr, dbw


def local_small_scenes(titan):
    """Phase u: on the 12 LOCAL_SCENES, the fused step, the fused trace and
    backward (fused_local_vs_plain), the tiled step over TRACE_STEPS steps
    (two resident-grid segments and a tail) and its resident-grid launches
    against per-step launches, and the tiled trace replay, per-step and
    resident-grid backwards (tiled_adjoint_vs_plain), each against its
    plain version.  Returns the worst max |d| per kernel family."""
    from titan_tpu_torch.ops import fused_step, tiled_step
    bad = []
    worst = dict(step=0.0, trace=0.0, bwd=0.0, tiled=0.0, tiled_trace=0.0,
                 tiled_bwd=0.0)
    for slots, integ in LOCAL_SCENES:
        shape, state = local_small_scene(titan, slots, integ)
        label = f"local {slots}, {integ}"
        caps = (shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir)
        check(any(caps) and fused_step.fused_reject_reason(shape) is None
              and tiled_step.tiled_reject_reason(shape) is None,
              f"{label}: caps {caps}, fused "
              f"{fused_step.fused_reject_reason(shape)}, tiled "
              f"{tiled_step.tiled_reject_reason(shape)}")
        e_step, e_tr, e_bw = fused_local_vs_plain(shape, state, label, bad)
        e_tiled, _ = tiled_vs_plain(shape, state, TRACE_STEPS, label, bad)
        mega_vs_steps(shape, state, label, bad)
        t_tr, t_bw, _, _ = tiled_adjoint_vs_plain(shape, state, label, bad)
        for k, v in (("step", e_step), ("trace", e_tr), ("bwd", e_bw),
                     ("tiled", e_tiled), ("tiled_trace", t_tr),
                     ("tiled_bwd", t_bw)):
            worst[k] = max(worst[k], v)
    check(not bad, "; ".join(bad))
    return worst


def slot_activity(shape, state):
    """{slot type: masses on which that type changes the force or the
    velocity} at `state`: the plain force pass (ops/adjoint.py::_force,
    the fused step's staging) gives the force and velocity entering each
    slot, and the slot alone is applied to them."""
    import torch
    from titan_tpu_torch.ops import adjoint
    from titan_tpu_torch.ops import forces as F
    P = adjoint._prep(shape, state)
    rg, rs = adjoint.torch_rolls()
    m = state.masses
    _, _, st = adjoint._force(m.pos, m.vel, P, rg, rs, P["t0"],
                              keep_stages=True, cidx=adjoint._cidx(P, 0, 1))
    lc, caps, nc = P["lc"], P["caps"], P["normal_coeff"]
    changed = [torch.zeros_like(m.valid) for _ in SLOT_TYPES]
    o = 0
    for j in range(caps[0]):
        f_in = st["lcp_in"][j]
        f_out = F.apply_contact_plane(f_in, m.pos, m.vel, lc[o + 1:o + 4],
                                      lc[o + 4], lc[o + 5], lc[o + 6], nc)
        changed[0] |= (lc[o] > 0.5) & (f_out != f_in).any(0)
        o += 7
    for j in range(caps[1]):
        dvec = m.pos - lc[o + 1:o + 4]
        dist = dvec.pow(2).sum(0).sqrt()
        changed[1] |= (lc[o] > 0.5) & (dist <= lc[o + 4]) & (dist > 0)
        o += 5
    for k, (cap, stage, fn) in enumerate((
            (caps[2], "lpl_in", F.apply_constraint_plane),
            (caps[3], "ldir_in", F.apply_direction))):
        for j in range(cap):
            f_in, v_in = st[stage][j]
            f_out, v_out = fn(f_in, v_in, lc[o + 1:o + 4], lc[o + 4],
                              lc[o] > 0.5)
            changed[2 + k] |= (f_out != f_in).any(0) | (v_out != v_in).any(0)
            o += 5
    return {name: int((c & m.valid).sum())
            for name, c in zip(SLOT_TYPES, changed)}


def report_activity(name, when, act):
    print(f"{name}: masses each slot type acts on at {when}: "
          + ", ".join(f"{k} {v}" for k, v in act.items()))


def local_bench_path(titan, kernels):
    """Phases v and x at 43^3: the local scene through the public API
    (drive: the fused step, 0 tiled launches, 0 eager steps), its slot
    activity at the landed state and after a timed window, the fused step,
    trace and backward against their plain versions from the landed state,
    the gradient path (the fused adjoint) and timing; appends its entries
    to ``kernels``."""
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import fused_step
    from titan_tpu_torch.ops.adjoint import adjoint_resident_bytes
    from titan_tpu_torch.ops.step import chunk_route, resident_bytes
    name = "bench 43^3 + local"
    launches, (shape, state) = drive(local_scene(titan, 43), name, 3.5)
    caps = (shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir)
    print(f"{name}: caps {caps}, route {chunk_route(shape)[0]} "
          f"(resident_bytes {resident_bytes(shape) / 1e6:.2f} MB), gradient "
          f"route {diff.grad_route(shape)[0]} (adjoint_resident_bytes "
          f"{adjoint_resident_bytes(shape) / 2 ** 20:.2f} MiB)")
    check(caps == (1, 1, 1, 1), f"{name}: caps {caps}")
    check(chunk_route(shape) == ("fused", None)
          and diff.grad_route(shape) == ("adjoint", None),
          f"{name}: routes {chunk_route(shape)}, {diff.grad_route(shape)}")
    act = slot_activity(shape, state)
    report_activity(name, "the landed state", act)
    bad = []
    err = fused_local_vs_plain(shape, state, f"{name} landed", bad, steps=200)
    check(not bad, "; ".join(bad))
    tr_launches, bwd_launches, (tr_err, abs_err, rel_err), path = \
        grad_path(name, shape, state)
    with uncounted():
        end = fused_step.fused_chunk(shape, state, TIMED_STEPS)
        act_end = slot_activity(shape, end)
        report_activity(name, f"the end of a {TIMED_STEPS}-step window",
                        act_end)
        t = time_path(name, shape, state)
    for k in SLOT_TYPES:
        check(max(act[k], act_end[k]) > 0, f"{name}: no {k} slot acted")
    kernels.append(dict(
        name=f"fused_step ({name})", route="cuda",
        source="titan_tpu_torch/csrc/fused_step.cu",
        replaces="titan_tpu/ops/pallas_step.py:185", launches=launches,
        max_abs_err=err[0], slot_masses=act, **t, library_ms=None))
    tr_t, bwd_t = time_adjoint(name, shape, state)
    for kname, line, n_launch, tm, e in (
            ("adjoint_trace", 1283, tr_launches, tr_t, max(tr_err, err[1])),
            ("adjoint_bwd", 1384, bwd_launches, bwd_t, max(abs_err, err[2]))):
        kernels.append(dict(
            name=f"{kname} ({name})", route="cuda",
            source="titan_tpu_torch/csrc/adjoint.cu",
            replaces=f"titan_tpu/ops/adjoint.py:{line}", launches=n_launch,
            max_abs_err=e, **({} if kname == "adjoint_trace"
                              else dict(max_rel_err=rel_err, path=path)),
            **tm, library_ms=None))


def drive_local_stress(titan, name):
    """Phase w: the 100^3 local scene through drive_from_rest, with its
    four slot types."""
    t0 = time.perf_counter()
    sim = local_scene(titan, STRESS_NX)

    def check_shape(shape):
        caps = (shape.cap_cp, shape.cap_ball, shape.cap_pl, shape.cap_dir)
        check(caps == (1, 1, 1, 1), f"{name}: caps {caps}")
        return f"caps {caps}"
    return drive_from_rest(sim, name, time.perf_counter() - t0, check_shape)


def drive_from_rest(sim, name, t_build, check_shape):
    """A 100^3 scene through the public API from t = 0, start -> wait ->
    getAll -> resume -> wait -> getAll -> stop at LOCAL_STRESS_WAITS (2,000
    Euler steps), every count set to 0 just before and read just after:
    the tiled route, with exactly the resident-grid and per-step launches
    the chunk lengths give (per-step launches only where the scene takes
    no resident grid), no fused launch and no eager step.  `check_shape`
    checks the marshalled shape and returns what to print of it.  Returns
    (counts, (shape, state) at the end)."""
    import numpy as np
    import torch
    from titan_tpu_torch.ops import tiled_step
    from titan_tpu_torch.ops.step import chunk_route, resident_bytes
    from titan_tpu_torch.runtime import simulation as rsim
    n = sim._store.n_masses
    lengths, recorded, chunk_shapes = [], [], []
    built = rsim.build_chunk_fn

    def recording(shape):
        fn = built(shape)
        recorded.append(shape)

        def chunk(state, n_steps):
            lengths.append(int(n_steps))
            chunk_shapes.append(shape)
            return fn(state, n_steps)
        return chunk

    rsim.build_chunk_fn = recording
    try:
        zero_tiled_counts()
        t0 = time.perf_counter()
        sim.start()
        t_marshal = time.perf_counter() - t0
        shape = sim._shape
        what = check_shape(shape)
        print(f"main path {name}: built in {t_build:.2f} s, marshalled in "
              f"{t_marshal:.2f} s (host); {n} masses, {what}, route "
              f"{chunk_route(shape)[0]} (resident_bytes "
              f"{resident_bytes(shape) / 1e6:.1f} MB)")
        check(chunk_route(shape) == ("tiled", None),
              f"{name}: route {chunk_route(shape)}")
        report_path(name, shape, "mega")
        for k, t in enumerate(LOCAL_STRESS_WAITS):
            sim.wait(t)
            sim.getAll()
            if k < len(LOCAL_STRESS_WAITS) - 1:
                sim.resume()
        end = (sim._shape, sim._snapshot())
        t_end = sim.time()
        pos = sim._store.pos[:n].copy()
        vel = sim._store.vel[:n].copy()
        sim.stop()
        torch.cuda.synchronize()
    finally:
        rsim.build_chunk_fn = built
        for key in recorded:
            rsim._CHUNK_CACHE.pop(key, None)
    counts = read_tiled_counts()
    wall = time.perf_counter() - t0
    seg = tiled_step.mega_seg(end[0])
    want = dict(mega=sum(k // seg for k in lengths) if seg else 0,
                step=sum(k % seg for k in lengths) if seg else sum(lengths))
    want["plain"] = sum(tiled_step.plain_launch_count(
        sh, k // seg if seg else 0, k % seg if seg else k)
        for sh, k in zip(chunk_shapes, lengths))
    print(f"main path {name}: {len(lengths)} chunks {lengths}, "
          f"{sum(lengths)} steps to t={t_end:.4f} in {wall:.2f} s wall; "
          f"tiled resident-grid launches {counts['mega']} (chunk lengths "
          f"give {want['mega']}), tiled per-step launches {counts['step']} "
          f"(give {want['step']}), {counts['plain']} of them on the "
          f"plain-spring loop (give {want['plain']}), fused_step launches "
          f"{counts['fused']}, eager steps {counts['eager']}")
    check(sum(lengths) >= 2000, f"{name}: {sum(lengths)} steps")
    check((counts["mega"] > 0) == bool(seg) and counts["step"] > 0,
          f"{name}: resident-grid and per-step launches {counts}")
    check(counts["mega"] == want["mega"] and counts["step"] == want["step"]
          and counts["plain"] == want["plain"],
          f"{name}: launches {counts} against the chunk lengths' {want}")
    check(counts["fused"] == 0 and counts["eager"] == 0,
          f"{name}: fused launches or eager steps on the tiled path: "
          f"{counts}")
    check(abs(t_end - sum(LOCAL_STRESS_WAITS)) < 1e-9, f"{name}: t {t_end}")
    check(np.isfinite(pos).all() and np.isfinite(vel).all(),
          f"{name}: non-finite state")
    speed = np.sqrt((vel * vel).sum(1))
    check(speed.max() <= 1.0 + 1e-5, f"{name}: clamp broken ({speed.max()})")
    return counts, end


def local_stress_path(titan, kernels):
    """Phases w-y at 100^3: the local scene through Simulation, its slot
    activity, the tiled kernels against their plain versions from its end
    state under Euler, Verlet and RK2, the gradient path under each (B6,
    then B8 or B7, exact counts; RK2 over LOCAL_RK2_GRAD_STEPS), the tiled
    adjoint against the fused adjoint over CROSS_GRAD_STEPS Verlet steps
    (held without the contact slots' friction, see LOCAL_RK2_GRAD_STEPS),
    and timing; appends the entries to ``kernels``."""
    import dataclasses
    import torch
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops import tiled_step
    name = "stress 100^3 + local"
    counts, (shape, state) = drive_local_stress(titan, name)
    act = slot_activity(shape, state)
    report_activity(name, f"t={sum(LOCAL_STRESS_WAITS):.4f}", act)
    runs, bad = {}, []
    for integ in (Integrator.EULER, Integrator.VERLET, Integrator.RK2):
        sh = integrator_shape(shape, integ)
        label = f"{name}, {integ.name}"
        with uncounted():
            e, _ = tiled_vs_plain(sh, state, TRACE_STEPS, label, bad)
            mega_vs_steps(sh, state, label, bad)
            ta = tiled_adjoint_vs_plain(sh, state, label, bad)
        if integ is Integrator.EULER:
            c = counts
        else:
            zero_tiled_counts()
            tiled_step.tiled_chunk(sh, state, CROSS_STEPS)
            torch.cuda.synchronize()
            c = read_tiled_counts()
        grad_counts = tiled_grad_path(
            label, sh, state, LOCAL_RK2_GRAD_STEPS
            if integ is Integrator.RK2 else GRAD_STEPS)
        runs[integ] = (sh, c, e, ta, grad_counts)
    check(not bad, "; ".join(bad))
    sh_v = runs[Integrator.VERLET][0]
    cross_fric = tiled_vs_fused_grads(f"{name}, VERLET", sh_v, state,
                                      math.inf)
    lc = state.lcon
    smooth = dataclasses.replace(state, lcon=dataclasses.replace(
        lc, cp_fk=torch.zeros_like(lc.cp_fk),
        cp_fs=torch.zeros_like(lc.cp_fs)))
    cross = tiled_vs_fused_grads(f"{name} without the contact slots' "
                                 "friction, VERLET", sh_v, smooth,
                                 TOL_GRAD_CROSS)
    end = tiled_step.tiled_chunk(shape, state, CROSS_STEPS)
    act_end = slot_activity(shape, end)
    report_activity(name, f"{CROSS_STEPS} steps later", act_end)
    for k in SLOT_TYPES:
        check(max(act[k], act_end[k]) > 0, f"{name}: no {k} slot acted")
    src_step = "titan_tpu_torch/csrc/tiled_step.cu"
    src_adj = "titan_tpu_torch/csrc/tiled_adjoint.cu"
    for integ, (sh, c, e, ta, gc) in runs.items():
        rk2 = integ is Integrator.RK2
        key = integ.name.lower()
        path = name if integ is Integrator.EULER else \
            f"{name}, {key}, {CROSS_STEPS} steps"
        t = time_tiled(f"{name} {key}", sh, state)
        mega = "tiled_megark2_kernel" if rk2 else "tiled_mega_kernel"
        for kname, launches, replaces in (
                (mega, c["mega"], "1222" if rk2 else "1134"),
                ("tiled_step_kernel", c["step"], "1051")):
            kernels.append(dict(
                name=f"{kname} ({path})", route="cuda", source=src_step,
                replaces=f"titan_tpu/ops/pallas_tiled.py:{replaces}",
                launches=launches, max_abs_err=e,
                **({"slot_masses": act} if integ is Integrator.EULER
                   else {}), **t[kname], library_ms=None))
        ta_t = time_tiled_adjoint(f"{name} {integ.name}", sh, state)
        gpath = (f"{name} gradient path, {integ.name}, "
                 f"{LOCAL_RK2_GRAD_STEPS if rk2 else GRAD_STEPS} steps")
        for g, kname, replaces in (
                ("trace_mega", ("tiled_megark2_kernel<PLAIN, true>" if rk2 else
                                "tiled_mega_kernel<MODE, PLAIN, true>")
                 + " (trace replay", "titan_tpu/ops/pallas_tiled.py:1305"),
                ("trace_step",
                 "tiled_step_kernel<MODE, REM, PLAIN, true> (trace replay",
                 "titan_tpu/ops/pallas_tiled.py:1305"),
                ("bwd_step", "bwd_force_kernel + bwd_spring_kernel"
                 + (" + bwd_mid_kernel" if rk2 else "")
                 + "<TiledBwdArgs> (per-step backward",
                 "titan_tpu/ops/adjoint_tiled.py:671"),
                ("bwd_mega", "tiled_megabwd_kernel (resident-grid backward",
                 "titan_tpu/ops/adjoint_tiled.py:906")):
            if gc[g] == 0 or g not in ta_t:
                continue
            kernels.append(dict(
                name=f"{kname}, {gpath})", route="cuda", source=src_adj,
                replaces=replaces, launches=gc[g],
                max_abs_err=ta[0] if g.startswith("trace") else ta[1],
                **({} if g.startswith("trace") else dict(
                    max_rel_err=ta[2],
                    **({} if integ is not Integrator.VERLET else dict(
                        grad_vs_fused_adjoint=cross,
                        grad_vs_fused_adjoint_with_friction=cross_fric)))),
                **ta_t[g], library_ms=None))


def local_phases(titan, kernels):
    """Phases u-y: the local-constraint branch of every kernel."""
    worst = local_small_scenes(titan)
    print("local small scenes: worst max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    local_bench_path(titan, kernels)
    local_stress_path(titan, kernels)


# ---------------------------------------------------------------------------
# Remainder springs (phases z1-z5): every kernel's remainder branch against
# its plain version on small scenes, the route rule, bench 43^3 + 1,024
# links and stress 100^3 + 512 links through Simulation, their gradient
# paths with per-spring gradients, timing
# ---------------------------------------------------------------------------

# phase z1's scenes on small_lattice, each with REM_SMALL_LINKS cross links
# of one kind (add_links): (kind, integrator)
REM_SCENES = (("plain", "euler"), ("damped", "euler"),
              ("breathing", "euler"), ("expand_contract", "euler"),
              ("fixed", "euler"), ("deleted", "euler"), ("hub", "euler"),
              ("damped", "verlet"), ("expand_contract", "rk2"),
              ("damped", "rk2"), ("local", "euler"), ("local", "rk2"))
REM_SMALL_LINKS = 96
# the main paths' links: scripts/tpu_mega_glue_breakdown.py's
# build(nx=43 or 100, cross=...) pattern
REM_BENCH_LINKS, REM_STRESS_LINKS = 1024, 512
# the spring leaves of the remainder gradient paths
REM_GRAD_NAMES = ("pos", "vel", "k", "springs.k", "springs.rest")


def add_links(sim, count, k=500.0):
    """`count` cross links as scripts/tpu_mega_glue_breakdown.py's
    build(cross=count) makes them: RandomState(0), one endpoint drawn in
    each half of the masses, k 500, rest the current distance.  Returns
    the links' spring indices (first, end)."""
    import numpy as np
    st = sim._store
    n = st.n_masses
    rng = np.random.RandomState(0)
    a = rng.randint(0, n // 2, count)
    b = n // 2 + rng.randint(0, n // 2, count)
    s0 = st.n_springs
    for ai, bi in zip(a, b):
        sp = sim.createSpring(sim.getMassByIndex(int(ai)),
                              sim.getMassByIndex(int(bi)))
        sp._k = k
    return s0, st.n_springs


def rem_small_scene(titan, kind, integrator):
    """small_lattice with REM_SMALL_LINKS links (add_links) of `kind`:
    "plain"; "damped" (damping 0.5); "breathing" (ACTIVE_CONTRACT_THEN_
    EXPAND, omega 7); "expand_contract" (scripts/
    tpu_adjoint_tiled_glue_check.py:66-75: half ACTUATED_EXPAND to 1.001
    rest at rate 0.6, half ACTUATED_CONTRACT to 0.5 rest at 0.8); a
    "fixed" or "deleted" endpoint of the first links; a "hub" (mass 0 with
    12 more links); "local" (local_small_scene's four slot types, "all").
    Marshalled on the card; returns (shape, state)."""
    import numpy as np
    sim = small_lattice(titan, integrator)
    st = sim._store
    s0, s1 = add_links(sim, REM_SMALL_LINKS)
    if kind == "damped":
        st.damping[s0:s1] = 0.5
    elif kind == "breathing":
        st.s_type[s0:s1] = titan.ACTIVE_CONTRACT_THEN_EXPAND
        st.omega[s0:s1] = 7.0
    elif kind == "expand_contract":
        mid = (s0 + s1) // 2
        st.s_type[s0:mid] = titan.ACTUATED_EXPAND
        st.l_max[s0:mid] = st.rest[s0:mid] * 1.001
        st.rate[s0:mid] = 0.6
        st.s_type[mid:s1] = titan.ACTUATED_CONTRACT
        st.l_min[mid:s1] = st.rest[mid:s1] * 0.5
        st.rate[mid:s1] = 0.8
    elif kind == "fixed":
        st.fixed[st.left[s0:s0 + 4]] = True
    elif kind == "deleted":
        st.valid[st.right[s0:s0 + 4]] = False
    elif kind == "hub":
        rng = np.random.RandomState(1)
        for j in rng.choice(np.arange(1, st.n_masses), 12, replace=False):
            sp = sim.createSpring(sim.getMassByIndex(0),
                                  sim.getMassByIndex(int(j)))
            sp._k = 500.0
    if kind == "local":
        return local_small_scene(titan, "all", integrator, sim=sim)
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


def rem_magnet_scene(titan, integrator):
    """link_sim's RobotLinks (64) with 32 cross links between them
    (add_links): the fused step's per-pass magnet entry with remainder
    springs.  Marshalled; returns (shape, state)."""
    sim = link_sim(titan, 64, integrator=titan.Integrator[integrator.upper()])
    add_links(sim, 32)
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


def rem_small_scenes(titan):
    """Phase z1: on the REM_SCENES, the fused step (100 steps), the fused
    trace (20) and its backward, the tiled step (per-step launches,
    TRACE_STEPS), the tiled replay and B7, each against its plain version
    (fused_local_vs_plain, tiled_vs_plain, tiled_adjoint_vs_plain: bitwise,
    RK2 backwards per element); and the fused step's per-pass magnet entry
    fed the plain field against its plain version fed the same field on
    RobotLinks with links, Euler, Verlet and RK2.  Returns the worst max
    |d| per kernel family."""
    from titan_tpu_torch.ops import fused_step, tiled_step
    bad = []
    worst = dict(step=0.0, trace=0.0, bwd=0.0, tiled=0.0, tiled_trace=0.0,
                 tiled_bwd=0.0, magnet_pass=0.0)
    for kind, integ in REM_SCENES:
        shape, state = rem_small_scene(titan, kind, integ)
        label = f"links {kind}, {integ}"
        check(shape.has_remainder and shape.max_degree >= (
            12 if kind == "hub" else 1)
              and fused_step.fused_reject_reason(shape) is None
              and tiled_step.tiled_reject_reason(shape) is None
              and tiled_step.mega_seg(shape) == 0,
              f"{label}: remainder {shape.has_remainder}, degree "
              f"{shape.max_degree}, fused "
              f"{fused_step.fused_reject_reason(shape)}, tiled "
              f"{tiled_step.tiled_reject_reason(shape)}")
        e_step, e_tr, e_bw = fused_local_vs_plain(shape, state, label, bad)
        e_tiled, _ = tiled_vs_plain(shape, state, TRACE_STEPS, label, bad)
        t_tr, t_bw, _, _ = tiled_adjoint_vs_plain(shape, state, label, bad)
        for k, v in (("step", e_step), ("trace", e_tr), ("bwd", e_bw),
                     ("tiled", e_tiled), ("tiled_trace", t_tr),
                     ("tiled_bwd", t_bw)):
            worst[k] = max(worst[k], v)
    check(not bad, "; ".join(bad))
    for integ in ("euler", "verlet", "rk2"):
        shape, state = rem_magnet_scene(titan, integ)
        check(shape.has_remainder and shape.has_magnets,
              f"RobotLinks with links: remainder {shape.has_remainder}, "
              f"magnets {shape.has_magnets}")
        worst["magnet_pass"] = max(worst["magnet_pass"], fused_vs_fed_plain(
            shape, state, 100, f"RobotLinks + 32 links, {integ}"))
    return worst


def rem_routes(shape, label):
    """Phase z2 on a marshalled 43^3 + links shape: chunk_route and
    grad_route either side of the selector budget (S 2,048 and 2,176 at
    43^3: the fused step and adjoint, then the tiled ones), as the
    reference routes them."""
    import dataclasses
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import step as tstep
    for s, want in ((2048, ("fused", "adjoint")),
                    (2176, ("tiled", "tiled_adjoint"))):
        sh = dataclasses.replace(shape, n_springs=s)
        got = (tstep.chunk_route(sh)[0], diff.grad_route(sh)[0])
        print(f"{label} route with S = {s}: selectors "
              f"{tstep.remainder_selector_bytes(sh) / 2 ** 20:.2f} MiB of "
              f"{tstep.REM_SEL_BUDGET / 2 ** 20:.0f}, resident_bytes "
              f"{tstep.resident_bytes(sh) / 1e6:.2f} MB: {got}")
        check(got == want, f"{label}, S = {s}: routes {got}, want {want}")


def rem_grad_leaves(state):
    """(leaves pos, vel, stencil k, springs k and rest requiring grad, the
    state built on them)."""
    import dataclasses
    leaves = [t.clone().requires_grad_() for t in (
        state.masses.pos, state.masses.vel, state.stencil.k, state.springs.k,
        state.springs.rest)]
    pos, vel, k, sk, srest = leaves
    st = dataclasses.replace(
        state, masses=dataclasses.replace(state.masses, pos=pos, vel=vel),
        stencil=dataclasses.replace(state.stencil, k=k),
        springs=dataclasses.replace(state.springs, k=sk, rest=srest))
    return leaves, st


def rem_grad_path(name, shape, state, segment, route):
    """diff.grad_rollout over GRAD_STEPS steps in segments of `segment` and
    torch.autograd.grad of seeded weights . (final pos, vel) over pos,
    vel, stencil k and the remainder springs' k and rest, every count set
    to 0 just before and read just after: the route must be `route`, the
    launches exactly what the segments give (the tiled route: per-step
    launches only, expected_grad_counts), no eager step, every gradient
    finite, the links' k gradients not all 0 and every link's rest
    gradient nonzero.  Returns the counts."""
    import torch
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import adjoint_tiled as at
    check(diff.grad_route(shape) == (route, None),
          f"{name}: gradient route {diff.grad_route(shape)}")
    from titan_tpu_torch.ops import adjoint
    rk2 = shape.config.integrator.name == "RK2"
    passes = 2 if rk2 else 1
    if route == "adjoint":
        fused_bwd_path(name, shape)
        n_bwd, n_plain = adjoint.bwd_launch_count(shape, segment)
        want = dict.fromkeys(adjoint_counters(), 0)
        want.update(fused=GRAD_STEPS * passes,
                    adjoint_trace=GRAD_STEPS * passes,
                    adjoint_bwd=GRAD_STEPS // segment * n_bwd,
                    adjoint_bwd_plain=GRAD_STEPS // segment * n_plain)
    else:
        seg, want = expected_grad_counts(shape, GRAD_STEPS)
        check(seg == segment, f"{name}: default segment {seg}")
        report_spring_path(name, shape)
    leaves, st = rem_grad_leaves(state)
    w = grad_loss_weights(state)
    zero_adjoint_counts()
    at.tiled_bwd_run.plain_launches = 0
    t0 = time.perf_counter()
    out = diff.grad_rollout(shape, st, GRAD_STEPS, segment=segment)
    loss = torch.sum(out.masses.pos * w[0]) + torch.sum(out.masses.vel * w[1])
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_adjoint_counts()
    print(f"gradient path {name}: {GRAD_STEPS} steps in segments of "
          f"{segment}: " + ", ".join(f"{k} {v}" for k, v in got.items())
          + f"; {wall:.3f} s wall (first call)")
    check(got == want, f"{name}: counts {got}, the segments give {want}")
    check_spring_path(name, shape, got["bwd_mega"] + got["bwd_step"])
    for nm, g in zip(REM_GRAD_NAMES, grads):
        check(bool(torch.isfinite(g).all()), f"{name}: d loss / d {nm} is "
              "not finite")
    # a link at exactly its rest length (a lattice falling as one body)
    # has d loss / d k = 0; its rest still moves the loss
    live = state.springs.valid
    check(float(grads[3].abs().max()) > 0.0
          and float(grads[4][live].abs().min()) > 0.0,
          f"{name}: the links' k gradients are all 0, or a link's rest "
          "gradient is 0")
    print(f"gradient path {name}: loss {float(loss.detach()):.6e}; |grad|max "
          + ", ".join(f"{nm} {float(g.abs().max()):.3e}"
                      for nm, g in zip(REM_GRAD_NAMES, grads)))
    return got


def rem_bench_path(titan, kernels):
    """Phases z2-z3 at 43^3: bench.py's scene with REM_BENCH_LINKS links
    through Simulation until it lands (drive: exactly one fused launch per
    step, 0 tiled launches, 0 eager steps), the route rule (rem_routes),
    the fused step (200 steps), trace and backward against their plain
    versions from the landed state under Euler, Verlet and RK2, the
    gradient path under each (the fused adjoint, segments of SEG), and
    timing; appends its entries to ``kernels``."""
    from titan_tpu_torch import diff
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops.adjoint import adjoint_resident_bytes
    from titan_tpu_torch.ops.step import (
        chunk_route, remainder_selector_bytes, resident_bytes)
    name = f"bench 43^3 + {REM_BENCH_LINKS:,} links"
    sim = bench_scene(titan, 43)
    add_links(sim, REM_BENCH_LINKS)
    launches, (shape, state) = drive(sim, name, 3.5)
    steps = round(3.51 / float(state.dt))
    print(f"{name}: {shape.n_springs} remainder springs (degree "
          f"{shape.max_degree}), route {chunk_route(shape)[0]} (selectors "
          f"{remainder_selector_bytes(shape) / 1e6:.2f} MB, resident_bytes "
          f"{resident_bytes(shape) / 1e6:.2f} MB), gradient route "
          f"{diff.grad_route(shape)[0]} (adjoint_resident_bytes "
          f"{adjoint_resident_bytes(shape) / 2 ** 20:.2f} MiB); "
          f"{launches} fused launches for {steps} steps")
    check(shape.has_remainder and shape.n_springs == REM_BENCH_LINKS,
          f"{name}: {shape.n_springs} remainder springs")
    check(launches == steps, f"{name}: {launches} fused launches for "
          f"{steps} steps")
    check(chunk_route(shape) == ("fused", None)
          and diff.grad_route(shape) == ("adjoint", None),
          f"{name}: routes {chunk_route(shape)}, {diff.grad_route(shape)}")
    rem_routes(shape, name)
    bad, errs, grad_counts = [], [], {}
    for integ in (Integrator.EULER, Integrator.VERLET, Integrator.RK2):
        sh = integrator_shape(shape, integ)
        label = f"{name} landed, {integ.name}"
        errs.append(fused_local_vs_plain(sh, state, label, bad, steps=200))
        check(not bad, "; ".join(bad))
        grad_counts[integ] = rem_grad_path(label, sh, state, SEG, "adjoint")
    err = [max(e[i] for e in errs) for i in range(3)]
    with uncounted():
        t = time_path(name, shape, state)
    kernels.append(dict(
        name=f"fused_step ({name})", route="cuda",
        source="titan_tpu_torch/csrc/fused_step.cu",
        replaces="titan_tpu/ops/pallas_step.py:185", launches=launches,
        max_abs_err=err[0], **t, library_ms=None))
    tr_t, bwd_t = time_adjoint(name, shape, state)
    c = grad_counts[Integrator.EULER]
    for kname, line, n_launch, tm, e in (
            ("adjoint_trace", 1283, c["adjoint_trace"], tr_t, err[1]),
            ("adjoint_bwd", 1384, c["adjoint_bwd"], bwd_t, err[2])):
        kernels.append(dict(
            name=f"{kname} ({name} gradient path, EULER, {GRAD_STEPS} "
            "steps)", route="cuda", source="titan_tpu_torch/csrc/adjoint.cu",
            replaces=f"titan_tpu/ops/adjoint.py:{line}", launches=n_launch,
            max_abs_err=e, **tm, **({} if kname == "adjoint_trace" else dict(
                path=spring_path(shape),
                plain_launches=c["adjoint_bwd_plain"])),
            library_ms=None))
    return shape, state


def rem_stress_path(titan, kernels):
    """Phase z4 at 100^3: bench.py's 100^3 scene with REM_STRESS_LINKS
    links through Simulation for 2,000 Euler steps from t = 0
    (drive_from_rest: the tiled route, per-step launches only, 0 fused
    launches, 0 eager steps); from its end state under Euler, Verlet and
    RK2 the tiled step (TRACE_STEPS), replay and B7 against their plain
    versions (tiled_vs_plain, tiled_adjoint_vs_plain), the launches of
    CROSS_STEPS steps, the gradient path (the tiled adjoint with B7 only,
    default segments of 50), and timing; appends the entries to
    ``kernels``."""
    import torch
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops import adjoint_tiled as at
    from titan_tpu_torch.ops import tiled_step
    from titan_tpu_torch.ops.step import remainder_selector_bytes
    name = f"stress 100^3 + {REM_STRESS_LINKS} links"
    t0 = time.perf_counter()
    sim = bench_scene(titan, STRESS_NX)
    add_links(sim, REM_STRESS_LINKS)

    def check_shape(shape):
        check(shape.has_remainder and shape.n_springs == REM_STRESS_LINKS
              and tiled_step.mega_seg(shape) == 0
              and not at.mega_adjoint_ok(shape),
              f"{name}: {shape.n_springs} remainder springs, mega_seg "
              f"{tiled_step.mega_seg(shape)}")
        return (f"{shape.n_springs} remainder springs (degree "
                f"{shape.max_degree}, selectors "
                f"{remainder_selector_bytes(shape) / 1e6:.1f} MB)")
    counts, (shape, state) = drive_from_rest(
        sim, name, time.perf_counter() - t0, check_shape)
    runs, bad = {}, []
    for integ in (Integrator.EULER, Integrator.VERLET, Integrator.RK2):
        sh = integrator_shape(shape, integ)
        label = f"{name}, {integ.name}"
        with uncounted():
            e, _ = tiled_vs_plain(sh, state, TRACE_STEPS, label, bad)
            ta = tiled_adjoint_vs_plain(sh, state, label, bad)
        if integ is Integrator.EULER:
            c = counts
        else:
            zero_tiled_counts()
            tiled_step.tiled_chunk(sh, state, CROSS_STEPS)
            torch.cuda.synchronize()
            c = read_tiled_counts()
            per = 2 if integ is Integrator.RK2 else 1
            check(c == dict(mega=0, step=per * CROSS_STEPS,
                            plain=per * CROSS_STEPS, fused=0, eager=0),
                  f"{label}: launches {c}")
        gc = rem_grad_path(f"{label} gradient path", sh, state, 50,
                           "tiled_adjoint")
        runs[integ] = (sh, c, e, ta, gc)
    check(not bad, "; ".join(bad))
    src_step = "titan_tpu_torch/csrc/tiled_step.cu"
    src_adj = "titan_tpu_torch/csrc/tiled_adjoint.cu"
    for integ, (sh, c, e, ta, gc) in runs.items():
        rk2 = integ is Integrator.RK2
        path = name if integ is Integrator.EULER else \
            f"{name}, {integ.name.lower()}, {CROSS_STEPS} steps"
        t = time_tiled(f"{name} {integ.name.lower()}", sh, state)
        kernels.append(dict(
            name=f"tiled_step_kernel ({path}"
            + (", rk2a + rk2b)" if rk2 else ")"), route="cuda",
            source=src_step, replaces="titan_tpu/ops/pallas_tiled.py:1051",
            launches=c["step"], max_abs_err=e, **t["tiled_step_kernel"],
            library_ms=None))
        ta_t = time_tiled_adjoint(f"{name} {integ.name}", sh, state)
        gpath = f"{name} gradient path, {integ.name}, {GRAD_STEPS} steps"
        for g, kname, replaces in (
                ("trace_step",
                 "tiled_step_kernel<MODE, REM, PLAIN, true> (trace replay",
                 "titan_tpu/ops/pallas_tiled.py:1305"),
                ("bwd_step", "bwd_force_kernel + bwd_spring_kernel"
                 + (" + bwd_mid_kernel" if rk2 else "")
                 + "<TiledBwdArgs> (per-step backward",
                 "titan_tpu/ops/adjoint_tiled.py:671")):
            kernels.append(dict(
                name=f"{kname}, {gpath})", route="cuda", source=src_adj,
                replaces=replaces, launches=gc[g],
                max_abs_err=ta[0] if g.startswith("trace") else ta[1],
                **({} if g.startswith("trace") else dict(max_rel_err=ta[2])),
                **ta_t[g], library_ms=None))


def remainder_phases(titan, kernels):
    """Phases z1-z5: the remainder branch of every kernel."""
    worst = rem_small_scenes(titan)
    print("remainder small scenes: worst max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    rem_bench_path(titan, kernels)
    rem_stress_path(titan, kernels)


# ---------------------------------------------------------------------------
# Magnet gradients and the tiled magnet glue (phases z6-z9): the pairwise
# field's transpose (B5), the fused trace with magnets (B4), the tiled
# step's glue (B2), its replay (B6) and split backward (B7) against their
# plain versions on small scenes; the RobotLink gradient path and the 64^3
# magnet lattice of scripts/tpu_soak.py's flow 6 through Simulation and
# grad_rollout; timing
# ---------------------------------------------------------------------------

# ops of the transpose of one pair's field term, per role, on top of the
# OPS_PAIR_FORCE of the term it recomputes (the warp of i transposes each
# pair inside the cutoff twice: i receiving from j and j receiving from
# i): gcoeff (5), the shell, safe, radius, stiffness, maxf and scale
# cotangents (14), the |d|^2 chain (5) and gd's second term (8); and the
# bytes per mass of one transpose: position, five parameters, fixed and
# gf read (48 B), gpos and the four gradients read and written (56 B)
OPS_PAIR_TRANSPOSE, TRANSPOSE_BYTES_PER_MASS = 32, 104
# the tiled glue scene (scripts/tpu_soak.py:124-153): 64^3 lattice,
# 10,000 magnets at linspace indices, 50 random links; its forward steps
# and its gradient paths (steps, segment)
GLUE_NX, GLUE_MAGNETS, GLUE_LINKS = 64, 10_000, 50
GLUE_FWD_STEPS, GLUE_GRAD_STEPS, GLUE_SEG = 500, 100, 50
# the soak magnets never overlap their shells (nearest magnets 0.106 m
# apart, mag_rad 0.01), so their mag_rad and mag_stiffness gradients are
# exact zeros; one more Euler gradient path from the same state with
# mag_rad GLUE_SHELL_RAD on the magnets (shells overlap below 0.12 m)
# runs the binned vjp's shell branch at full width, over GLUE_SHELL_STEPS
GLUE_SHELL_RAD, GLUE_SHELL_STEPS = 0.06, 10
# the RobotLink gradient path: link_sim's 1,024 links at t = 0
LINK_GRAD_LINKS = 1024
# the leaves of the magnet gradient paths
MAG_GRAD_NAMES = ("pos", "vel", "mag_rad", "mag_stiffness", "mag_maxf",
                  "mag_scale")


def mag_counters():
    """{name: (object, attribute)}: every count the magnet gradient paths
    read (adjoint_counters and the field kernels, the binned pass and the
    magnet transpose, counted by the sweeps that launch it)."""
    from titan_tpu_torch.ops import adjoint, adjoint_tiled, magnets
    from titan_tpu_torch.ops import magnets_grid
    c = adjoint_counters()
    c.update(pairwise=(magnets.pairwise_magnet_field, "launches"),
             grid=(magnets_grid.grid_magnet_forces, "launches"),
             binned=(magnets.binned_magnet_forces, "passes"),
             transpose=(adjoint.bwd_run, "mag_launches"),
             tiled_transpose=(adjoint_tiled.tiled_bwd_run, "mag_launches"))
    return c


def zero_mag_counts():
    for obj, attr in mag_counters().values():
        setattr(obj, attr, 0)


def read_mag_counts():
    return {k: getattr(obj, attr) for k, (obj, attr) in mag_counters().items()}


def transpose_vs_plain(shape, state, label, bad, seed=6, min_slots=1):
    """B5 alone: the transpose kernel against magnet_transpose_plain (in
    the built kernel's slots, magnets.transpose_info) at the state's
    positions for a seeded cotangent, with a tenth of the masses fixed,
    bitwise; and the pairwise field kernel against its plain version in
    the kernel's order (pairwise_field_lanes), bitwise.  Prints how many
    of the kernel's slots of sources hold an acting pair and how many
    acting pairs cross from a receiver's own slot to another; fails where
    fewer than `min_slots` slots hold one.  Returns max |d|."""
    import numpy as np
    import torch
    from titan_tpu_torch.ops import magnets, magnets_grid
    m = state.masses
    n, cut = shape.n_masses, shape.config.magnet_cutoff
    prm = magnets.pairwise_params(m)
    slots = magnets.transpose_info()["slots"]
    chunk = magnets.transpose_chunk(n, slots)
    d = m.pos[:, :, None] - m.pos[:, None, :]
    acts = ((d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            < magnets_grid.cutoff_threshold(cut))
    ok = prm[4] != 0
    acts &= ok[:, None] & ok[None, :]
    acts.fill_diagonal_(False)
    del d
    src_slot = torch.arange(n, device=m.pos.device) // chunk
    used = int(torch.unique(src_slot[acts.any(0)]).numel())
    cross = int((acts & (src_slot[:, None] != src_slot[None, :])).sum())
    pairs = int(acts.sum())
    del acts
    rng = np.random.RandomState(seed)
    fixed = torch.from_numpy((rng.uniform(0, 1, n) < 0.1).astype(
        np.float32)).to(m.pos.device)
    gf = seeded_cotangents(n, m.pos.device, seed)[0]
    got = magnets.magnet_transpose(m.pos, prm, fixed, gf, cut)
    want = magnets.magnet_transpose_plain(m.pos, prm, fixed, gf, cut,
                                          slots=slots)
    field = magnets.pairwise_magnet_field(m, cut, prm)
    lanes = magnets.pairwise_field_lanes(m.pos, prm, cut)
    torch.cuda.synchronize()
    d = max(float((a - b).abs().max()) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    fsame = bool(torch.equal(field, lanes))
    live = int((got[1] != 0).any(0).sum())
    print(f"magnet transpose vs plain [{label}]: "
          + ("bitwise" if same else f"DIFFERS ({d:.3e})")
          + f", {live} masses with a parameter gradient; {pairs} acting "
          f"ordered pairs, their sources in {used} of the kernel's {slots} "
          f"slots of {chunk}, {cross} of them outside the receiver's own "
          "slot; pairwise field kernel vs its plain version in the "
          "kernel's order: " + ("bitwise" if fsame else "DIFFERS"))
    if not (same and fsame) or live == 0 or used < min(min_slots, slots):
        bad.append(f"{label}: magnet transpose or field differs from plain "
                   f"(transpose {same}, field {fsame}, {live} live, "
                   f"acting pairs in {used} slots)")
    return d


def mag_fused_vs_plain(shape, state, label, bad, steps=BWD_STEPS):
    """B4 and B5 in the sweep: the fused trace of a magnet scene (field
    kernel, then the replay kernel, per pass) bitwise trace_run_plain fed
    the field kernel's field and its last entry bitwise the forward
    chunk's state; the backward (with one transpose per force pass) on
    that trace against bwd_run_plain (bwd_diffs: Euler and Verlet bitwise,
    RK2 per element), its launches and those on the plain-spring loop
    exactly adjoint.bwd_launch_count's (check_fused_bwd_launches), over
    `steps` steps.  Returns (trace, backward) max |d|."""
    import torch
    from titan_tpu_torch.ops import adjoint, fused_step
    rk2 = shape.config.integrator.name == "RK2"
    field = fused_step.magnet_field_fn(shape, state, plain=False)
    trace = adjoint.trace_run(shape, state, steps)
    want = adjoint.trace_run_plain(shape, state, steps, field=field)
    last = fused_step.fused_chunk(shape, state, steps - 1)
    torch.cuda.synchronize()
    dtr = float((trace - want).abs().max())
    tsame = bool(torch.equal(trace, want)) and bool(torch.equal(
        trace[-1, :6], torch.cat([last.masses.pos, last.masses.vel])))
    del want
    cts = seeded_cotangents(shape.n_masses, trace.device)
    run = adjoint.bwd_run
    run.launches = run.plain_launches = 0
    g = adjoint.bwd_run(shape, state, trace, *cts)
    launches, on_loop = run.launches, run.plain_launches
    ref = adjoint.bwd_run_plain(shape, state, trace, *cts)
    torch.cuda.synchronize()
    check_fused_bwd_launches(label, shape, steps, 1, launches, on_loop)
    dbw, rel, bitwise, fails = bwd_diffs(g, ref, rk2)
    live = int((ref["mag"] != 0).any(0).sum())
    print(f"fused magnet adjoint vs plain [{label}]: trace ({steps} "
          f"steps, {trace.shape[1]} rows) "
          + ("bitwise" if tsame else f"DIFFERS ({dtr:.3e})")
          + f"; backward ({spring_path(shape)} path, {launches} launches, "
          f"{on_loop} on the plain-spring loop) "
          + ("bitwise" if bitwise else "per element: "
                             + ", ".join(f"{k} {v:.2e}"
                                         for k, v in rel.items()))
          + f"; {live} masses with a magnet gradient"
          + (f"  FAIL {fails}" if fails else ""))
    if not tsame:
        bad.append(f"{label}: trace differs from plain by {dtr:.3e}")
    if fails or live == 0:
        bad.append(f"{label}: backward differs from plain: {fails} ({live} "
                   "live)")
    return dtr, dbw


def glue_lattice(titan, integrator, binned):
    """small_lattice with soak-style magnets (mag_rad 0.01, stiffness 100,
    maxf 1e-5, scale 1) on 4,000 masses at linspace indices and 48 links
    (add_links), marshalled on the card: unbinned (the pairwise field
    kernel) or binned (magnet_binned_threshold 500: the grid kernel and
    the binned pass's vjp).  Returns (shape, state)."""
    import dataclasses
    import numpy as np
    sim = small_lattice(titan, integrator)
    sim.config = dataclasses.replace(
        sim.config, magnet_binned_threshold=500 if binned else 10 ** 9)
    st = sim._store
    idx = np.linspace(0, st.n_masses - 1, 4000).astype(np.int64)
    st.mag_rad[idx] = 0.01
    st.mag_stiffness[idx] = 100.0
    st.mag_maxf[idx] = 1e-5
    st.mag_scale[idx] = 1.0
    add_links(sim, 48)
    sim._T = 0.0
    sim._marshal()
    return sim._shape, sim._state


def glue_vs_plain(shape, state, label, bad):
    """B2, B6 and B7 of a magnet scene: the tiled glue chunk (per-pass
    launches fed the field kernel's field) over TRACE_STEPS steps bitwise
    tiled_chunk_plain fed the same field; the replay bitwise
    tiled_trace_run_plain fed that field, its last entry bitwise the
    chunk's state; B7 on BWD_STEPS entries against tiled_bwd_run_plain
    (unbinned: the transpose kernel in the sweep, Euler and Verlet
    bitwise, RK2 per element; binned: the binned pass's vjp between the
    parts, per element: its autograd accumulates with atomics).  Returns
    (step, trace, backward) max |d|."""
    import torch
    from titan_tpu_torch.ops import adjoint_tiled as at
    from titan_tpu_torch.ops import fused_step, tiled_step
    rk2 = shape.config.integrator.name == "RK2"
    binned = bool(shape.magnet_binned)
    field = fused_step.magnet_field_fn(shape, state, plain=False)
    before = launch_counts_of(tiled_step.tiled_chunk)
    got = tiled_step.tiled_chunk(shape, state, TRACE_STEPS)
    took = check_step_path(label, shape, tiled_step.tiled_chunk, before)
    want = tiled_step.tiled_chunk_plain(shape, state, TRACE_STEPS,
                                        field=field)
    before = launch_counts_of(at.tiled_trace_run)
    trace = at.tiled_trace_run(shape, state, TRACE_STEPS)
    took_tr = check_step_path(label, shape, at.tiled_trace_run, before,
                              trace=True)
    tw = at.tiled_trace_run_plain(shape, state, TRACE_STEPS, field=field)
    last = tiled_step.tiled_chunk(shape, state, TRACE_STEPS - 1)
    torch.cuda.synchronize()
    d, same = state_diffs(got, want)
    dtr = float((trace - tw).abs().max())
    tsame = bool(torch.equal(trace, tw)) and bool(torch.equal(
        trace[-1, :6], torch.cat([last.masses.pos, last.masses.vel])))
    del tw
    trace = trace[:BWD_STEPS]
    inv = tiled_step.prep_tiled_inputs(shape, state)
    cts = seeded_cotangents(shape.n_masses, trace.device)
    g = at._tiled_bwd_cuda(shape, state, trace, *cts, inv, mega=False)
    ref = at.tiled_bwd_run_plain(shape, state, trace, *cts, inv)
    torch.cuda.synchronize()
    dbw, rel, bitwise, fails = bwd_diffs(g, ref, rk2 or binned)
    live = int((ref["mag"] != 0).any(0).sum())
    print(f"tiled glue vs plain [{label}, {spring_path(shape)} path]: step "
          f"({TRACE_STEPS} steps; {took}) "
          + ("bitwise" if same else f"DIFFERS {d}") + f"; trace ("
          f"{trace.shape[1]} rows; {took_tr}) "
          + ("bitwise" if tsame else f"DIFFERS ({dtr:.3e})")
          + "; backward " + ("bitwise" if bitwise else "per element: "
                             + ", ".join(f"{k} {v:.2e}"
                                         for k, v in rel.items()))
          + f"; {live} masses with a magnet gradient"
          + (f"  FAIL {fails}" if fails else ""))
    if not same:
        bad.append(f"{label}: tiled glue chunk differs from plain: {d}")
    if not tsame:
        bad.append(f"{label}: glue trace differs from plain by {dtr:.3e}")
    if fails or live == 0:
        bad.append(f"{label}: B7 differs from plain: {fails} ({live} live)")
    return max(d.values()), dtr, dbw


# the plain-spring magnet lattice's segment: its route, not its depth, is
# what phase z6 adds
MAG_LATTICE_STEPS = 6


def magnet_lattice(titan, integrator):
    """A 6^3 lattice 0.1 m apart with plain springs (k 800, family-uniform:
    the backward's plain-spring loop) whose every mass is a magnet (radius
    0.06, stiffness 100, max force 0.01, scale 1), so each face neighbour
    acts inside the 0.14 m cutoff, on the pairwise route, over a plane,
    g = -9.8, dt 1e-4.  Marshalled on the card; returns (shape, state)."""
    sim = titan.Simulation(titan.SimConfig(
        device="cuda", integrator=titan.Integrator[integrator.upper()],
        magnet_binned_threshold=10 ** 9))
    sim.createLattice(titan.Vec(0, 0, 1), titan.Vec(0.5, 0.5, 0.5), 6, 6, 6)
    sim.setAllSpringConstantValues(800.0)
    st = sim._store
    n = st.n_masses
    st.mag_rad[:n] = 0.06
    st.mag_stiffness[:n] = 100.0
    st.mag_maxf[:n] = 0.01
    st.mag_scale[:n] = 1.0
    sim.createPlane(titan.Vec(0, 0, 1), 0)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    sim.setTimeStep(1e-4)
    return marshalled(sim)


def mag_small_scenes(titan):
    """Phase z6: B5 alone on a magnet cloud (deleted and zero-parameter
    masses) and on RobotLinks; B4 and B5 in the fused sweep on RobotLinks
    (Euler, Verlet, RK2; RK2 with 32 links too; the general body) and on
    a plain-spring magnet lattice (each integrator; the plain-spring loop,
    unfolded); B2, B6 and B7 on four
    12,000-mass glue lattices (unbinned Euler and RK2, binned Verlet and
    RK2).  Returns the worst max |d| per kernel family."""
    bad = []
    worst = dict(transpose=0.0, trace=0.0, bwd=0.0, tiled=0.0,
                 tiled_trace=0.0, tiled_bwd=0.0)
    for label, (shape, state), min_slots in (
            ("cloud", marshalled(cloud_sim(titan, 400,
                                           edit="deleted_zero_param")), 1),
            ("dense cloud", marshalled(cloud_sim(
                titan, 2048, seed=3, spread=0.35,
                edit="deleted_zero_param")), 32),
            ("64 RobotLinks", marshalled(link_sim(titan, 64)), 1)):
        worst["transpose"] = max(worst["transpose"], transpose_vs_plain(
            shape, state, label, bad, min_slots=min_slots))
    for integ in ("euler", "verlet", "rk2"):
        sim = link_sim(titan, 64, magnetic_force=0.5, spread=0.3, z=0.4,
                       integrator=titan.Integrator[integ.upper()])
        for label, (shape, state) in (
                (f"64 RobotLinks, {integ}", marshalled(sim)),) + ((
                (f"RobotLinks + 32 links, {integ}",
                 rem_magnet_scene(titan, integ)),) if integ == "rk2"
                else ()):
            e = mag_fused_vs_plain(shape, state, label, bad)
            worst["trace"] = max(worst["trace"], e[0])
            worst["bwd"] = max(worst["bwd"], e[1])
        shape, state = magnet_lattice(titan, integ)
        label = f"plain-spring magnet lattice, {integ}"
        check(shape.has_magnets and not shape.magnet_binned
              and spring_path(shape) == "plain", f"{label}: the fused "
              f"backward takes the {spring_path(shape)} path")
        e = mag_fused_vs_plain(shape, state, label, bad,
                               steps=MAG_LATTICE_STEPS)
        worst["trace"] = max(worst["trace"], e[0])
        worst["bwd"] = max(worst["bwd"], e[1])
    for integ, binned in (("euler", False), ("rk2", False),
                          ("verlet", True), ("rk2", True)):
        shape, state = glue_lattice(titan, integ, binned)
        label = f"glue lattice, {'binned' if binned else 'pairwise'}, {integ}"
        check(shape.has_magnets and bool(shape.magnet_binned) == binned
              and shape.has_remainder, f"{label}: {shape}")
        e = glue_vs_plain(shape, state, label, bad)
        for k, v in zip(("tiled", "tiled_trace", "tiled_bwd"), e):
            worst[k] = max(worst[k], v)
    check(not bad, "; ".join(bad))
    print("magnet gradient small scenes: worst max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def transpose_bound_ms(state, cut):
    """(ms, "bytes" or "operations") of one magnet transpose on this state:
    every ordered pair of valid masses tested once (OPS_PAIR_TEST), each
    one inside the cutoff transposed in both roles (2 x (OPS_PAIR_FORCE +
    OPS_PAIR_TRANSPOSE)); TRANSPOSE_BYTES_PER_MASS per mass."""
    m = state.masses
    nv = int(m.valid.sum())
    inside = pair_terms(m, cut)[2]
    tb = TRANSPOSE_BYTES_PER_MASS * m.pos.shape[1] / HBM_BYTES_PER_S * 1e3
    to = ((OPS_PAIR_TEST * nv * (nv - 1)
           + 2 * (OPS_PAIR_FORCE + OPS_PAIR_TRANSPOSE) * inside)
          / F32_FLOPS_PER_S * 1e3)
    return (tb, "bytes") if tb >= to else (to, "operations")


def mag_grad_leaves(state, spring_k=False):
    """(leaves pos, vel and the four magnet parameters, with the remainder
    springs' k where ``spring_k``, requiring grad; the state built on
    them)."""
    import dataclasses
    m = state.masses
    leaves = [getattr(m, k).clone().requires_grad_() for k in MAG_GRAD_NAMES]
    st = dataclasses.replace(state, masses=dataclasses.replace(
        m, **dict(zip(MAG_GRAD_NAMES, leaves))))
    if spring_k:
        k = state.springs.k.clone().requires_grad_()
        leaves.append(k)
        st = dataclasses.replace(st, springs=dataclasses.replace(
            st.springs, k=k))
    return leaves, st


def acting_params(shape, state):
    """The magnet parameters with a term that acts on this state, over the
    pairs the field visits (all pairs, or on a binned scene the first
    ``cell_cap`` sources of each 3 x 3 neighbourhood): mag_rad where a
    shell overlaps (inter < 0) on a receiver with stiffness, mag_stiffness
    where a shell overlaps, mag_maxf where a receiver has a source with a
    scale, mag_scale where a source has a receiver with a pull.  Returns
    (names, {name: pairs})."""
    import torch
    from titan_tpu_torch.ops import magnets_grid
    m, cut = state.masses, shape.config.magnet_cutoff
    n = m.pos.shape[1]
    counts = dict.fromkeys(MAG_GRAD_NAMES[2:], 0)

    def add(ok, d2, rad_s, scale_s, idx):
        dist = torch.sqrt(d2)
        ok = ok & (dist < cut) & (d2 > 0)
        shell = ok & (dist < m.mag_rad[idx] + rad_s)
        counts["mag_rad"] += int((shell & (m.mag_stiffness[idx] != 0)).sum())
        counts["mag_stiffness"] += int(shell.sum())
        counts["mag_maxf"] += int((ok & (scale_s != 0)).sum())
        counts["mag_scale"] += int((ok & (m.mag_maxf[idx] != 0)).sum())

    if not shape.magnet_binned:
        idx = torch.arange(n, device=m.pos.device)[:, None]
        e = m.pos[:, :, None] - m.pos[:, None, :]
        ok = m.valid[:, None] & m.valid[None, :] & (idx != idx.T)
        add(ok, (e * e).sum(0), m.mag_rad[None, :], m.mag_scale[None, :],
            idx[:, 0][:, None])
    else:
        G, cap = magnets_grid.GRID_DIM, shape.magnet_binned[1]
        cell, starts, src = magnets_grid.grid_setup(m, cut)[:3]
        starts, cell = starts.long(), cell.long()
        idx = torch.arange(n, device=m.pos.device)
        real = cell < G * G
        cx, cy = cell // G, cell % G
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                x, y = cx + dx, cy + dy
                ok = real & (x >= 0) & (x < G) & (y >= 0) & (y < G)
                cc = torch.where(ok, x * G + y, 0)
                s0 = starts[cc]
                cnt = torch.where(ok, torch.clamp(starts[cc + 1] - s0,
                                                  max=cap), 0)
                for k in range(cap):
                    j = torch.clamp(s0 + k, max=n - 1)
                    e = m.pos - src[:3, j]
                    add((k < cnt) & m.valid, (e * e).sum(0), src[3, j],
                        src[4, j], idx)
    return {k for k, v in counts.items() if v}, counts


def mag_grad_counts(shape, n_steps, route):
    """The counts a magnet gradient rollout of ``n_steps`` must give: the
    fused adjoint (the field kernel once per force pass in the forward and
    once in the replay, one transpose per force pass in the sweep) or the
    tiled adjoint with per-step launches only (the grid field in the
    forward and the replay, one binned-pass vjp per force pass between
    B7's parts on a binned scene); nothing else."""
    from titan_tpu_torch.ops import adjoint
    rk2 = shape.config.integrator.name == "RK2"
    passes = 2 if rk2 else 1
    field = "grid" if shape.magnet_binned else "pairwise"
    want = dict.fromkeys(mag_counters(), 0)
    want[field] = 2 * n_steps * passes
    if route == "adjoint":
        # a magnet scene's sweep does not fold: the count of any segment
        n_bwd, n_plain = adjoint.bwd_launch_count(shape, n_steps)
        want.update(fused=n_steps * passes, adjoint_trace=n_steps * passes,
                    adjoint_bwd=n_bwd, adjoint_bwd_plain=n_plain,
                    transpose=n_steps * passes)
    else:
        plain = n_steps * passes if spring_path(shape) == "plain" else 0
        want.update(fwd_step=n_steps * passes, trace_step=n_steps * passes,
                    fwd_plain=plain, trace_plain=plain,
                    bwd_step=n_steps * (5 if rk2 else 2))
        want["binned" if shape.magnet_binned else "tiled_transpose"] = \
            n_steps * passes
    return want


def mag_grad_path(name, shape, state, n_steps, segment, route,
                  spring_k=False, every_term=False):
    """diff.grad_rollout over n_steps in segments of `segment` and
    torch.autograd.grad of seeded weights . (final pos, vel) over pos, vel
    and the four magnet parameters (and the links' k), every count set to
    0 just before and read just after: the route must be `route`, the
    counts exactly mag_grad_counts, every gradient finite and the gradient
    of each magnet parameter whose term acts at the start (acting_params)
    nonzero somewhere; with `every_term`, all four terms must act.
    Returns (counts, host s)."""
    import torch
    from titan_tpu_torch import diff
    check(diff.grad_route(shape) == (route, None),
          f"{name}: gradient route {diff.grad_route(shape)}")
    from titan_tpu_torch.ops import adjoint_tiled as at
    want = mag_grad_counts(shape, n_steps, route)
    if route != "adjoint":
        report_spring_path(name, shape)
    else:
        fused_bwd_path(name, shape)
    leaves, st = mag_grad_leaves(state, spring_k)
    w = grad_loss_weights(state)
    torch.cuda.synchronize()
    zero_mag_counts()
    at.tiled_bwd_run.plain_launches = 0
    t0 = time.perf_counter()
    out = diff.grad_rollout(shape, st, n_steps, segment=segment)
    loss = torch.sum(out.masses.pos * w[0]) + torch.sum(out.masses.vel * w[1])
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_mag_counts()
    print(f"gradient path {name}: {n_steps} steps in segments of "
          f"{segment}: " + ", ".join(f"{k} {v}" for k, v in got.items())
          + f"; {wall:.3f} s wall (first call)")
    check(got == want, f"{name}: counts {got}, the segments give {want}")
    check_spring_path(name, shape, got["bwd_mega"] + got["bwd_step"])
    names = MAG_GRAD_NAMES + (("springs.k",) if spring_k else ())
    for nm, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()), f"{name}: d loss / d {nm} is "
              "not finite")
    acting, pairs = acting_params(shape, state)
    for nm, g in zip(names[2:6], grads[2:6]):
        check(nm not in acting or float(g.abs().max()) > 0.0,
              f"{name}: d loss / d {nm} is 0 though its term acts on "
              f"{pairs[nm]} pairs")
    check(acting, f"{name}: no magnet term acts ({pairs})")
    check(not every_term or acting == set(MAG_GRAD_NAMES[2:]),
          f"{name}: not every magnet term acts ({pairs})")
    print(f"gradient path {name}: loss {float(loss.detach()):.6e}; |grad|max "
          + ", ".join(f"{nm} {float(g.abs().max()):.3e}"
                      for nm, g in zip(names, grads))
          + "; pairs on which each magnet parameter's term acts at the "
          "start: " + ", ".join(f"{k} {v}" for k, v in pairs.items()))
    return got, wall


def time_mag_adjoint(name, shape, state):
    """The fused magnet adjoint's kernels from `state`: the replay kernel's
    and the backward kernels' device time per step and the transpose's per
    launch (torch.profiler over SEG steps), their plain versions and
    bounds."""
    import torch
    from titan_tpu_torch.ops import adjoint, magnets
    cut = shape.config.magnet_cutoff
    rk2 = shape.config.integrator.name == "RK2"
    passes = 2 if rk2 else 1
    trace = adjoint.trace_run(shape, state, SEG)
    cts = seeded_cotangents(shape.n_masses, trace.device)
    bwd_names = FUSED_BWD_NAMES
    reps = 2
    dev = profile_device_us(lambda: [(
        adjoint.trace_run(shape, state, SEG),
        adjoint.bwd_run(shape, state, trace, *cts)) for _ in range(reps)],
        ("adjoint_trace_kernel", "magnet_transpose_kernel",
         "pairwise_magnet_kernel") + bwd_names)
    m = state.masses
    prm = magnets.pairwise_params(m)
    gf = cts[0]
    fixed = torch.zeros_like(m.pos[0])
    tp_wrap = event_ms(lambda k: [magnets.magnet_transpose(
        m.pos, prm, fixed, gf, cut) for _ in range(k)], 20)
    tp_plain = event_ms(lambda k: [magnets.magnet_transpose_plain(
        m.pos, prm, fixed, gf, cut) for _ in range(k)], 1, reps=1)
    tr_plain = event_ms(lambda k: adjoint.trace_run_plain(shape, state, k),
                        5, reps=1)
    ptr = adjoint.trace_run_plain(shape, state, 2)
    bw_plain = event_ms(lambda k: adjoint.bwd_run_plain(
        shape, state, ptr, *cts), 2, reps=1)
    check(all(k in dev for k in ("adjoint_trace_kernel", "bwd_force_kernel",
                                 "magnet_transpose_kernel")),
          f"{name}: the profiler recorded no device time for a kernel")
    tr_ms = dev["adjoint_trace_kernel"][0] / (reps * SEG) / 1e3
    bw_ms = sum(dev[k][0] for k in bwd_names if k in dev) / (reps * SEG) \
        / 1e3
    tp_t, tp_c = dev["magnet_transpose_kernel"]
    tp_ms = tp_t / tp_c / 1e3
    (tb, tby), (bb, bby) = adjoint_bound_ms(shape, state, SEG)
    tpb, tpby = transpose_bound_ms(state, cut)
    print(f"timing {name}: adjoint_trace_kernel {tr_ms * 1e3:.3f} us/step "
          f"(profiler; bound {tb * 1e3:.4f} by {tby}; plain "
          f"{tr_plain * 1e3:.1f}); backward kernels {bw_ms * 1e3:.3f} "
          f"us/step (bound {bb * 1e3:.4f} by {bby}; plain "
          f"{bw_plain * 1e3:.1f}, the transpose's plain version included); "
          f"magnet_transpose_kernel {tp_ms * 1e3:.3f} us/launch ({tp_c} "
          f"launches; wrapper {tp_wrap * 1e3:.3f} us, CUDA events; bound "
          f"{tpb * 1e3:.4f} us by {tpby}; plain {tp_plain * 1e3:.1f} us), "
          f"{passes} per step; pairwise field "
          + (f"{dev['pairwise_magnet_kernel'][0] / dev['pairwise_magnet_kernel'][1]:.3f} us/launch"
             if "pairwise_magnet_kernel" in dev else "not recorded"))
    return (dict(ms=tr_ms, plain_ms=tr_plain, bound_ms=tb, bound_by=tby),
            dict(ms=bw_ms, plain_ms=bw_plain, bound_ms=bb, bound_by=bby),
            dict(ms=tp_ms, wrapper_ms=tp_wrap, plain_ms=tp_plain,
                 bound_ms=tpb, bound_by=tpby))


def link_grad_phase(titan, kernels):
    """Phase z7: 1,024 RobotLinks (link_sim, 2,048 masses, in the air at t
    = 0) take the fused step and the fused adjoint; under Euler, Verlet and
    RK2 the fused trace and backward against their plain versions at full
    width (mag_fused_vs_plain), the gradient path over GRAD_STEPS steps in
    segments of SEG (mag_grad_path: exact counts, 0 eager steps, finite
    magnet gradients, every term acting and each gradient nonzero), and
    the kernels' times; appends the
    entries to ``kernels``."""
    from titan_tpu_torch import diff
    from titan_tpu_torch.config import Integrator
    from titan_tpu_torch.ops import magnets
    from titan_tpu_torch.ops import step as tstep
    name = f"RobotLink {LINK_GRAD_LINKS:,} links"
    shape, state = marshalled(link_sim(titan, LINK_GRAD_LINKS))
    z = state.masses.pos[2, :shape.n_masses]
    print(f"{name}: {shape.n_masses} masses, lowest z {float(z.min()):.4f} "
          f"m; routes {tstep.chunk_route(shape)}, {diff.grad_route(shape)}")
    check(shape.n_masses == 2 * LINK_GRAD_LINKS and not shape.magnet_binned
          and tstep.chunk_route(shape) == ("fused", None)
          and diff.grad_route(shape) == ("adjoint", None),
          f"{name}: {shape.n_masses} masses, routes")
    bad, runs = [], {}
    tp_err = transpose_vs_plain(shape, state, name, bad, min_slots=2)
    check(not bad, "; ".join(bad))
    info = magnets.transpose_info()
    print(f"{name}: magnet_transpose_kernel {info['threads']} threads a "
          f"block in clusters of {info['cluster']}, {info['slots']} slots, "
          f"{info['registers']} registers and {info['local_bytes']} B of "
          f"local memory a thread, {info['blocks_per_sm']} blocks an SM")
    for integ in (Integrator.EULER, Integrator.VERLET, Integrator.RK2):
        sh = integrator_shape(shape, integ)
        label = f"{name}, {integ.name}"
        e = mag_fused_vs_plain(sh, state, label, bad)
        check(not bad, "; ".join(bad))
        counts, wall = mag_grad_path(f"{label} gradient path", sh, state,
                                     GRAD_STEPS, SEG, "adjoint",
                                     every_term=True)
        runs[integ] = (sh, e, counts, wall)
    for integ, (sh, e, counts, wall) in runs.items():
        tr_t, bw_t, tp_t = time_mag_adjoint(f"{name} {integ.name}", sh,
                                            state)
        path = f"{name} gradient path, {integ.name}, {GRAD_STEPS} steps"
        fb = dict(fwd_bwd_s_first_call=wall)
        for kname, src, replaces, n_launch, err, t in (
                ("adjoint_trace_kernel", "csrc/adjoint.cu",
                 "titan_tpu/ops/adjoint.py:1283", counts["adjoint_trace"],
                 e[0], tr_t),
                ("bwd_force_kernel + bwd_spring_kernel"
                 + (" + bwd_mid_kernel" if integ is Integrator.RK2 else "")
                 + "<BwdChunkArgs>", "csrc/adjoint.cu",
                 "titan_tpu/ops/adjoint.py:1384", counts["adjoint_bwd"],
                 e[1], bw_t),
                ("magnet_transpose_kernel", "csrc/magnets_adjoint.cuh",
                 "titan_tpu/ops/adjoint.py:1433", counts["transpose"],
                 max(e[1], tp_err), dict(tp_t, registers=info["registers"],
                                         blocks_per_sm=info["blocks_per_sm"]
                                         ))):
            kernels.append(dict(
                name=f"{kname} ({path})", route="cuda",
                source=f"titan_tpu_torch/{src}", replaces=replaces,
                launches=n_launch, max_abs_err=err, **t, **fb,
                library_ms=None))


def glue_sim(titan):
    """scripts/tpu_soak.py's flow 6 on the card (:124-153): a 64^3 lattice
    (k 1000, default rest lengths), 10,000 magnets at linspace indices
    (mag_rad 0.01, stiffness 100, maxf 1e-5, scale 1), 50 random links
    (RandomState(3)), a frictionless plane, dt 1e-4, g = -9.8."""
    import numpy as np
    sim = titan.Simulation(titan.SimConfig(device="cuda",
                                           host_store_dtype="float32"))
    sim.createLattice(titan.Vec(0, 0, 4), titan.Vec(3, 3, 3), GLUE_NX,
                      GLUE_NX, GLUE_NX)
    sim.setAllSpringConstantValues(1000.0)
    sim.defaultRestLengths()
    st = sim._store
    n = st.n_masses
    midx = np.linspace(0, n - 1, GLUE_MAGNETS).astype(np.int64)
    st.mag_rad[midx] = 0.01
    st.mag_stiffness[midx] = 100.0
    st.mag_maxf[midx] = 1e-5
    st.mag_scale[midx] = 1.0
    rng = np.random.RandomState(3)
    for a, b in zip(rng.randint(0, n, GLUE_LINKS),
                    rng.randint(0, n, GLUE_LINKS)):
        if a != b:
            sim.createSpring(sim.masses[int(a)], sim.masses[int(b)])
    sim.createPlane(titan.Vec(0, 0, 1), 0)
    sim.setTimeStep(1e-4)
    sim.setGlobalAcceleration(titan.Vec(0, 0, -9.8))
    return sim


def drive_glue(sim, name):
    """The glue scene through the public API: start -> wait -> getAll ->
    resume at 4 breakpoints -> stop, GLUE_FWD_STEPS steps, every count set
    to 0 just before and read just after: the tiled route, one per-step
    launch and one grid field launch per step, nothing else.  Returns
    (counts, (shape, state) at the end)."""
    import numpy as np
    import torch
    from titan_tpu_torch import diff
    from titan_tpu_torch.ops import step as tstep
    n = sim._store.n_masses
    dt = sim.getTimeStep()
    torch.cuda.synchronize()
    zero_mag_counts()
    t0 = time.perf_counter()
    sim.start()
    shape = sim._shape
    print(f"main path {name}: {n} masses, {shape.n_springs} remainder "
          f"springs, magnets binned {shape.magnet_binned} (grid "
          f"{shape.magnet_grid}, receivers {shape.magnet_receivers}); "
          f"routes {tstep.chunk_route(shape)}, {diff.grad_route(shape)}; "
          f"marshalled in {time.perf_counter() - t0:.2f} s")
    check(shape.has_magnets and shape.magnet_binned and shape.magnet_grid
          and shape.has_remainder
          and tstep.chunk_route(shape) == ("tiled", None)
          and diff.grad_route(shape) == ("tiled_adjoint", None),
          f"{name}: shape or routes")
    report_path(name, shape, "mega")
    for k in range(4):
        sim.wait(GLUE_FWD_STEPS * dt / 4)
        sim.getAll()
        if k < 3:
            sim.resume()
    end = (sim._shape, sim._snapshot())
    t_end = sim.time()
    pos = sim._store.pos[:n].copy()
    sim.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_mag_counts()
    steps = int(round(t_end / dt))
    want = dict.fromkeys(mag_counters(), 0)
    want.update(fwd_step=steps, grid=steps,
                fwd_plain=steps if spring_path(shape) == "plain" else 0)
    print(f"main path {name}: {steps} steps to t={t_end:.4f} s in "
          f"{wall:.2f} s wall; " + ", ".join(f"{k} {v}"
                                             for k, v in counts.items()))
    check(steps == GLUE_FWD_STEPS, f"{name}: {steps} steps")
    check(counts == want, f"{name}: counts {counts}, want {want}")
    check(np.isfinite(pos).all(), f"{name}: non-finite state")
    return counts, end


def time_glue(name, shape, state, fb_ms):
    """The glue path's kernels from `state`: ten steps of the glue chunk,
    replay and B7 under torch.profiler (device time per launch of the
    per-step step, replay and backward kernels and of the grid field), the
    plain versions and the bounds; ``fb_ms`` is the gradient path's
    forward + backward per step (host clock, its checked run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from titan_tpu_torch.ops import adjoint_tiled as at
    from titan_tpu_torch.ops import magnets_grid, tiled_step
    rk2 = shape.config.integrator.name == "RK2"
    passes = 2 if rk2 else 1
    inv = tiled_step.prep_tiled_inputs(shape, state)
    seg = 10
    trace = at.tiled_trace_run(shape, state, seg, inv)
    cts = seeded_cotangents(shape.n_masses, trace.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        at.tiled_trace_run(shape, state, 1, inv)
        torch.cuda.synchronize()
        tiled_step.tiled_chunk(shape, state, seg)
        at.tiled_trace_run(shape, state, seg, inv)
        at._tiled_bwd_cuda(shape, state, trace, *cts, inv, mega=False)
        torch.cuda.synchronize()
    groups = {"step": lambda k: "tiled_step_kernel" in k and "false>" in k,
              "trace": lambda k: "tiled_step_kernel" in k and "true>" in k,
              "bwd": lambda k: "<TiledBwdArgs," in k,
              "grid": lambda k: "grid_magnet_kernel" in k}
    dev = {}
    seen = check_profiled_path(name, shape, [e.key for e in
                                             prof.key_averages()])
    print(f"path {name} glue: the profiler saw {seen}")
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        for g, hit in groups.items():
            if hit(e.key) and e.count and t:
                t0, c0 = dev.get(g, (0.0, 0))
                dev[g] = (t0 + t, c0 + e.count)
    m, cut, cap = state.masses, shape.config.magnet_cutoff, \
        shape.magnet_binned[1]
    # the plain versions over one step each: at 64^3 each takes seconds
    step_plain = event_ms(lambda k: tiled_step.tiled_chunk_plain(
        shape, state, k), 1, reps=1)
    tr_plain = event_ms(lambda k: at.tiled_trace_run_plain(shape, state, k),
                        1, reps=1)
    p_trace = at.tiled_trace_run_plain(shape, state, 1)
    bw_plain = event_ms(lambda k: at.tiled_bwd_run_plain(
        shape, state, p_trace, *cts, inv), 1, reps=1)
    del p_trace
    grid_plain = event_ms(lambda k: [magnets_grid.grid_magnet_forces_plain(
        m, cut, cap) for _ in range(k)], 1, reps=1)
    pairs, inside = grid_pairs(state, cap, cut)
    per = 5 if rk2 else 2
    mode = "rk2a" if rk2 else shape.config.integrator.name.lower()
    out = {}
    for g, plain, bound in (
            ("step", step_plain / passes, tiled_bound_ms(shape, state, mode,
                                                         1)[0]),
            ("trace", tr_plain / passes, tuple(
                x / passes if i == 0 else x for i, x in enumerate(
                    tiled_adjoint_bound_ms(shape, state, "trace", 1)[0]))),
            ("bwd", bw_plain / per, tuple(
                x / per if i == 0 else x for i, x in enumerate(
                    tiled_adjoint_bound_ms(shape, state, "bwd", 1)[0]))),
            ("grid", grid_plain, field_bound_ms(shape.n_masses, pairs,
                                                inside))):
        check(g in dev, f"{name}: the profiler recorded no {g} kernel")
        ms = dev[g][0] / dev[g][1] / 1e3
        print(f"timing {name} {g}: {ms * 1e3:.3f} us/launch ({dev[g][1]} "
              f"launches, torch.profiler); bound {bound[0] * 1e3:.4f} us by "
              f"{bound[1]}; plain {plain * 1e3:.1f} us/launch")
        out[g] = dict(ms=ms, plain_ms=plain, bound_ms=bound[0],
                      bound_by=bound[1], fwd_bwd_ms_per_step=fb_ms,
                      **({} if g == "grid" else
                         {"path": spring_path(shape)}))
    print(f"timing {name} gradient path: forward + backward "
          f"{fb_ms * 1e3:.3f} us/step over {GLUE_GRAD_STEPS} steps "
          f"(segments of {GLUE_SEG}; host clock, the checked run)")
    return out


def glue_phase(titan, kernels):
    """Phase z8: the 64^3 magnet lattice of scripts/tpu_soak.py's flow 6
    through Simulation for GLUE_FWD_STEPS steps on the tiled route
    (drive_glue: per-step launches and the grid field only), the grid
    field bitwise its plain version there (grid_bitwise); from its end
    state under Euler, Verlet and RK2 the glue step, replay and B7 against
    their plain versions (glue_vs_plain), the gradient path on the tiled
    adjoint over GLUE_GRAD_STEPS steps in segments of GLUE_SEG
    (mag_grad_path: exact counts, no resident-grid launch, no B8, 0 eager
    steps, finite and nonzero magnet gradients; once more under Euler
    with overlapping shells, GLUE_SHELL_RAD), and timing; appends the
    entries to ``kernels``."""
    import dataclasses
    import torch
    from titan_tpu_torch.config import Integrator
    name = f"soak {GLUE_NX}^3 + {GLUE_MAGNETS:,} magnets + {GLUE_LINKS} links"
    t0 = time.perf_counter()
    sim = glue_sim(titan)
    print(f"{name}: built in {time.perf_counter() - t0:.2f} s (host)")
    fwd, (shape, state) = drive_glue(sim, name)
    grid_full = grid_bitwise(shape, state, f"{name} at the final state")
    bad, runs = [], {}
    for integ in (Integrator.EULER, Integrator.VERLET, Integrator.RK2):
        sh = integrator_shape(shape, integ)
        label = f"{name}, {integ.name}"
        e = glue_vs_plain(sh, state, label, bad)
        check(not bad, "; ".join(bad))
        counts, wall = mag_grad_path(f"{label} gradient path", sh, state,
                                     GLUE_GRAD_STEPS, GLUE_SEG,
                                     "tiled_adjoint", spring_k=True)
        runs[integ] = (sh, e, counts, wall)
    m = state.masses
    shells = dataclasses.replace(state, masses=dataclasses.replace(
        m, mag_rad=torch.where(m.mag_rad > 0, GLUE_SHELL_RAD, 0.0)))
    mag_grad_path(f"{name}, mag_rad {GLUE_SHELL_RAD}, EULER gradient path",
                  integrator_shape(shape, Integrator.EULER), shells,
                  GLUE_SHELL_STEPS, GLUE_SHELL_STEPS, "tiled_adjoint",
                  every_term=True)
    src_step = "titan_tpu_torch/csrc/tiled_step.cu"
    src_adj = "titan_tpu_torch/csrc/tiled_adjoint.cu"
    for integ, (sh, e, counts, wall) in runs.items():
        t = time_glue(f"{name} {integ.name}", sh, state,
                      wall * 1e3 / GLUE_GRAD_STEPS)
        path = f"{name} gradient path, {integ.name}, {GLUE_GRAD_STEPS} steps"
        entries = [
            ("tiled_step_kernel<MODE, REM, PLAIN, false> (glue forward, "
             + (f"{path})" if integ is not Integrator.EULER else
                f"{name} main path, {GLUE_FWD_STEPS} steps)"),
             src_step, "titan_tpu/ops/pallas_tiled.py:1051",
             fwd["fwd_step"] if integ is Integrator.EULER
             else counts["fwd_step"], e[0], t["step"]),
            ("tiled_step_kernel<MODE, REM, PLAIN, true> (glue replay, "
             f"{path})",
             src_adj, "titan_tpu/ops/pallas_tiled.py:1305",
             counts["trace_step"], e[1], t["trace"]),
            ("bwd_force_kernel + bwd_spring_kernel"
             + (" + bwd_mid_kernel" if integ is Integrator.RK2 else "")
             + f"<TiledBwdArgs> (glue backward, {path})", src_adj,
             "titan_tpu/ops/adjoint_tiled.py:671", counts["bwd_step"], e[2],
             t["bwd"])]
        if integ is Integrator.EULER:
            entries.append((f"grid_magnet_kernel ({name} main path, "
                            f"{GLUE_FWD_STEPS} steps)",
                            "titan_tpu_torch/csrc/magnets_grid.cu",
                            "titan_tpu/ops/magnets_grid.py:64", fwd["grid"],
                            grid_full[0], dict(
                                t["grid"], tiles=grid_full[3],
                                tiles_over_stage=grid_full[2])))
        for kname, src, replaces, n_launch, err, tm in entries:
            kernels.append(dict(name=kname, route="cuda", source=src,
                                replaces=replaces, launches=n_launch,
                                max_abs_err=err, **tm, library_ms=None))


def mag_grad_phases(titan, kernels, phase_done):
    """Phases z6-z9: the magnet gradients' and the tiled glue's kernels;
    ``phase_done(label)`` after each part."""
    mag_small_scenes(titan)
    phase_done("z6")
    link_grad_phase(titan, kernels)
    phase_done("z7")
    glue_phase(titan, kernels)
    phase_done("z8-z9")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import titan_tpu_torch as titan
    from titan_tpu_torch.ops import fused_step

    t_start = time.perf_counter()

    def phase_done(label):
        # the command time is bounded: where each phase ends, for the next
        # slice's trimming
        print(f"chip_smoke: phases {label} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, devices: "
          f"{torch.cuda.device_count()}")

    # 1, a, f, m and q. build every source, one nvcc each, started
    # together
    build_kernels(("fused_step", "adjoint", "magnets", "magnets_grid",
                   "tiled_step", "tiled_adjoint"))
    print_coop_blocks(titan)
    phase_done("1, a, f, m, q (build)")

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

    phase_done("2")

    # b. the adjoint kernels against their plain versions, small scenes;
    # the damped, breathing, actuated and non-uniform-k ones on the
    # backward's general body, the others on its plain-spring loop
    for variant in ADJOINT_VARIANTS:
        shape, state = variant_scene(titan, variant)
        want = "general" if variant in GENERAL_VARIANTS else "plain"
        check(spring_path(shape) == want, f"{variant}: the fused backward "
              f"takes the {spring_path(shape)} path, not the {want} one")
        adjoint_vs_plain(shape, state, 20, variant)

    phase_done("b")

    # 3. the main paths through the public API, then kernel vs plain from
    # each one's landed (contact) state; 4. timing from that state
    kernels, landed = [], []
    for name, make, nx in (("bench 43^3", bench_scene, 43),
                           ("entry 20^3", entry_scene, 20)):
        launches, (shape, state) = drive(make(titan), name, 3.5)
        landed.append((name, shape, state))
        check(not shape.has_remainder and len(shape.stencil_deltas) == 13,
              f"{name}: the scene did not bucket into 13 families")
        report_path(name, shape, "fused")
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

    phase_done("3-4")

    # c. the gradient path from each landed state; d. system id at 43^3;
    # e. timing
    for i, (name, shape, state) in enumerate(landed):
        tr_launches, bwd_launches, (tr_err, abs_err, rel_err), path = \
            grad_path(name, shape, state)
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
                   else dict(max_rel_err=rel_err, path=path)),
                **t, library_ms=None))

    # g-l. the magnet field kernels, the fused step's magnet route, the
    # RobotLink and magnetic-swarm main paths, gradient routing
    phase_done("c-e")
    magnet_phases(titan, kernels)
    phase_done("g-l")

    # n-p. the tiled kernels, the 100^3 stress config, timing
    landed_stress = tiled_phases(titan, kernels)
    phase_done("n-p")

    # r-t. the tiled adjoint's kernels, the 100^3 gradient path, timing
    tiled_adjoint_phases(titan, kernels, *landed_stress)
    phase_done("r-t")

    # u-y. local constraints: every kernel's branch on small scenes, the
    # 43^3 and 100^3 scenes with slots, their gradient paths, timing
    local_phases(titan, kernels)
    phase_done("u-y")

    # z1-z5. remainder springs: every kernel's branch on small scenes, the
    # route rule, 43^3 + 1,024 links and 100^3 + 512 links, their gradient
    # paths with per-spring gradients, timing
    remainder_phases(titan, kernels)
    phase_done("z1-z5")

    # z6-z9. magnet gradients and the tiled magnet glue: every new branch
    # on small scenes, the RobotLink gradient path, the 64^3 magnet lattice
    # through Simulation and its gradient paths, timing
    mag_grad_phases(titan, kernels, phase_done)

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
