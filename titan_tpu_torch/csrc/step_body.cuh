// The per-mass step body shared by csrc/fused_step.cu (the forward chunk)
// and csrc/adjoint.cu (the adjoint's trace replay), so that the replay is
// bitwise the forward chunk; its spring, contact, drag and RK2 midpoint
// pieces are also what the adjoint's backward recomputes and transposes.
// Also the host-side step loop both use:
// one launch per step (two for RK2) on the caller's stream, with
// pos/vel/acc (and actuated rest) ping-ponging between output and scratch
// buffers.  What the step computes, and why it is laid out this way, is
// set out at the top of csrc/fused_step.cu.  The non-spring part of a force
// evaluation (global planes and balls, per-mass local constraints, drag) is
// contact_and_drag, which the tiled step (csrc/tiled_body.cuh) and the
// adjoints' recompute (csrc/adjoint_body.cuh) call too.

#ifndef TITAN_STEP_BODY_CUH_
#define TITAN_STEP_BODY_CUH_

#include <cstddef>

#include <cuda_runtime.h>

namespace titan {

enum Mode { kEuler = 0, kVerlet = 1, kRk2Half = 2, kRk2Full = 3 };

// The per-mass local-constraint slots of a scene: the capacity of each type
// and the stacked [L, N] slot array of titan_tpu_torch/ops/forces.py::
// stage_local (per contact plane 7 rows: act, normal xyz, offset, fk, fs;
// per ball, constraint plane and direction 5: act, vector xyz, radius or
// friction).  A slot acts where its act row is > 0.5.
struct LocalSlots {
  int cp, ball, pl, dir;
  const float* lc;  // [L, N], null when every capacity is 0
};

// The remainder springs (springs in no stencil family), as
// titan_tpu_torch/ops/forces.py::stage_remainder stages them: the incidence
// table (mass i's entries inc[i D + q], spring S = none, sign +1 at the
// right endpoint and -1 at the left), each spring's ends and its rows p
// [8, S] (REM_ROWS: k, damping, breathing sign and frequency, signed
// actuation rate and bound, rate * dt and the stop count of the closed
// form).  ACTUATED rest: the fused step advances it once per force pass
// from rest_src and writes it to rest_dst; with `closed` (the tiled step
// and the adjoints) it is rest_src + min(c, stop) rate dt after c force
// calls and nothing is written.  inc is null in a scene without them.
struct Remainder {
  int d, s;  // entries per mass (D), padded spring count (S)
  int has_damping, has_breathing, has_actuated, closed;
  const int* inc;     // [N, D]
  const float* sign;  // [N, D]
  const int* ends;    // [2, S] left, right
  const float* p;     // [8, S]
  const float* rest_src;  // [S]
  float* rest_dst;        // [S]
};
enum RemRow { kRemK, kRemDamping, kRemBsign, kRemBomega, kRemArate,
              kRemAbound, kRemAratedt, kRemSstop };

__device__ __forceinline__ float rem_row(const Remainder& r, int row, int e) {
  return r.p[static_cast<size_t>(row) * static_cast<size_t>(r.s) + e];
}

// One launch = one force evaluation + one update of every mass.
struct StepArgs {
  int n, nf, n_planes, n_balls;
  int clamp, has_damping, has_breathing, has_actuated, has_drag;
  int step;          // step index inside the chunk
  float half;        // time offset in units of dt (0.5 for the RK2 corrector)
  float normal_coeff;
  const int* deltas;     // [F]
  const float* scal;     // [2]: dt, t at chunk start
  const float* planes;   // [P, 6]: normal xyz, offset, fk, fs
  const float* balls;    // [B, 4]: center xyz, radius
  const float* cforce;   // [3, N] m g + persistent external force
  const float* minv;     // [N]
  const float* fixed;    // [N] 1 = frozen (fixed or invalid), else 0
  const float* k;        // [F, N] validity-folded
  const float* damping;  // [F, N] validity-folded
  const float* bsign;    // [F, N] -0.2 / +0.2 / 0 breathing sign
  const float* bomega;   // [F, N]
  const float* arate;    // [F, N] +rate / -rate / 0, validity-folded
  const float* abound;   // [F, N] l_max / l_min
  const float* drag;     // [N]
  LocalSlots local;
  Remainder rem;          // remainder springs (rest buffers set per pass)
  const float* rest_src;  // [F, N]
  float* rest_dst;        // [F, N] (actuated only)
  const float* fpos;  // [3, N] state the forces are evaluated at
  const float* fvel;
  const float* pos0;  // [3, N] state at the start of the step
  const float* vel0;
  const float* acc0;
  float* pos_dst;
  float* vel_dst;
  float* acc_dst;     // unused by the RK2 predictor
  // RK2 with local constraints: the predictor stores pass 1's mutated
  // velocity in v1_dst, the corrector starts from v1_src (else from vel0)
  float* v1_dst;
  const float* v1_src;
};

__device__ __forceinline__ float3 ld3(const float* a, int i, int n) {
  return make_float3(a[i], a[n + i], a[2 * n + i]);
}

__device__ __forceinline__ void st3(float* a, int i, int n, float3 v) {
  a[i] = v.x;
  a[n + i] = v.y;
  a[2 * n + i] = v.z;
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float3 add3(float3 a, float3 b) {
  return make_float3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ float3 mul3(float3 a, float s) {
  return make_float3(a.x * s, a.y * s, a.z * s);
}

// The pieces of the step that the adjoint's backward (csrc/adjoint.cu)
// recomputes too.  Both kernels call these, so the arithmetic the backward
// transposes is the forward's, operation for operation.

// Breathing: rest_eff = rest * breath_scale (sim.cu:1183-1190).
__device__ __forceinline__ float breath_scale(float bsign, float bomega,
                                              float t) {
  return 1.f + bsign * sinf(bomega * t);
}

// A spring from its left endpoint (pl, vl) to its right (pr, vr) at
// effective rest `rest`: Hooke + axial damping, reference
// computeSpringForces (sim.cu:1157-1200).  Its force on the right endpoint
// is diff * (cm * inv); the left endpoint gets the negative.
struct Spring {
  float3 diff;
  float ln, inv, ax, cm;
};

__device__ __forceinline__ Spring spring_eval(float k, float rest,
                                              int has_damping, float damping,
                                              float3 pl, float3 vl, float3 pr,
                                              float3 vr) {
  Spring q;
  q.diff = sub3(pr, pl);
  const float d2 = dot3(q.diff, q.diff);
  q.ln = d2 > 0.f ? sqrtf(d2) : 0.f;
  q.inv = q.ln > 0.f ? 1.f / q.ln : 0.f;
  q.cm = k * (rest - q.ln);
  q.ax = 0.f;
  if (has_damping) {
    q.ax = dot3(sub3(vl, vr), q.diff);
    q.cm = q.cm + (q.ax * q.inv) * damping;
  }
  return q;
}

// Contact plane pl = [normal xyz, offset, fk, fs] on a mass at (p, v),
// given the force f entering it: static / kinetic friction and the
// penalty contact (object.cu:76-109).
__device__ __forceinline__ float3 plane_force(const float* pl,
                                              float normal_coeff, float3 f,
                                              float3 p, float3 v) {
  const float3 nv = make_float3(pl[0], pl[1], pl[2]);
  const float off = pl[3], fk = pl[4], fs = pl[5];
  const float disp = dot3(p, nv) - off;
  if (!(disp < 0.f)) return f;
  if (fs > 0.f || fk > 0.f) {
    const float fn_mag = dot3(f, nv);
    const float3 vp = sub3(v, mul3(nv, dot3(v, nv)));
    const float v_norm = sqrtf(dot3(vp, vp));
    const float fn_abs = fabsf(fn_mag);
    if (v_norm > 1e-16f) {  // kinetic
      f = sub3(f, mul3(vp, fk * fn_abs / v_norm));
    } else {  // static: cancel the tangential force if friction holds
      const float3 fp = sub3(f, mul3(nv, fn_mag));
      if (fs * fn_abs > sqrtf(dot3(fp, fp))) f = sub3(f, fp);
    }
  }
  return add3(f, mul3(nv, -disp * normal_coeff));
}

// Ball of centre c and radius r on a mass at p: the radial penalty
// inside it (object.cu:56-59), nothing at its centre.
__device__ __forceinline__ float3 ball_force(float3 c, float r,
                                             float normal_coeff, float3 f,
                                             float3 p) {
  const float3 dv = sub3(p, c);
  const float dist = sqrtf(dot3(dv, dv));
  if (dist <= r && dist > 0.f) f = add3(f, mul3(dv, normal_coeff / dist));
  return f;
}

// Constraint plane of unit normal nv and friction fric on a mass with
// force f and velocity v (object.cu:118-127): the normal force and
// velocity are projected out.  The reference's quirk is kept: |v| is taken
// before the normal velocity is removed, and the friction term divides the
// updated velocity by that old norm.  Updates f and v.
__device__ __forceinline__ void constraint_plane(float3 nv, float fric,
                                                 float3& f, float3& v) {
  const float nf = dot3(f, nv);
  const float3 f2 = sub3(f, mul3(nv, nf));
  const float v_norm = sqrtf(dot3(v, v));
  if (!(v_norm >= 1e-16f)) {
    f = f2;
    return;
  }
  const float3 v2 = sub3(v, mul3(nv, dot3(v, nv)));
  const float s = fric * nf;
  f = make_float3(f2.x - v2.x * s / v_norm, f2.y - v2.y * s / v_norm,
                  f2.z - v2.z * s / v_norm);
  v = v2;
}

// Direction constraint of unit tangent t and friction fric
// (object.cu:136-144): only motion along t.  Updates f and v.
__device__ __forceinline__ void direction(float3 t, float fric, float3& f,
                                          float3& v) {
  const float3 nfv = sub3(f, mul3(t, dot3(f, t)));
  const float3 f2 = sub3(f, nfv);
  const float v_norm = sqrtf(dot3(v, v));
  if (!(v_norm >= 1e-16f)) {
    f = f2;
    return;
  }
  const float nf_norm = sqrtf(dot3(nfv, nfv));
  f = sub3(f2, mul3(t, nf_norm * fric));
  v = mul3(t, dot3(v, t));
}

// Row r of mass i in the [L, N] slot array.
__device__ __forceinline__ float slot_row(const LocalSlots& ls, int r, int i,
                                          int n) {
  return ls.lc[static_cast<size_t>(r) * static_cast<size_t>(n) + i];
}
__device__ __forceinline__ float3 slot_vec(const LocalSlots& ls, int r, int i,
                                           int n) {
  return make_float3(slot_row(ls, r, i, n), slot_row(ls, r + 1, i, n),
                     slot_row(ls, r + 2, i, n));
}

// A force and a velocity.
struct ForceVel {
  float3 f, v;
};

// The per-mass local constraints of mass i (sim.cu:1311-1326), in
// reference order: contact planes (the global plane's own code on a copy
// of the slot), balls, constraint planes, directions, from the force f and
// velocity v entering them.  Returns the force and the velocity:
// constraint planes and directions change it, and drag and the integrator
// read the changed one.  Plain version: ops/forces.py::local_slots.
__device__ __forceinline__ ForceVel local_slots(LocalSlots ls,
                                                float normal_coeff, int i,
                                                int n, float3 f, float3 p,
                                                float3 v) {
  int o = 0;
  for (int j = 0; j < ls.cp; ++j, o += 7) {
    if (!(slot_row(ls, o, i, n) > 0.5f)) continue;
    float pl[6];
    for (int c = 0; c < 6; ++c) pl[c] = slot_row(ls, o + 1 + c, i, n);
    f = plane_force(pl, normal_coeff, f, p, v);
  }
  for (int j = 0; j < ls.ball; ++j, o += 5) {
    if (!(slot_row(ls, o, i, n) > 0.5f)) continue;
    f = ball_force(slot_vec(ls, o + 1, i, n), slot_row(ls, o + 4, i, n),
                   normal_coeff, f, p);
  }
  for (int j = 0; j < ls.pl; ++j, o += 5) {
    if (!(slot_row(ls, o, i, n) > 0.5f)) continue;
    constraint_plane(slot_vec(ls, o + 1, i, n), slot_row(ls, o + 4, i, n), f,
                     v);
  }
  for (int j = 0; j < ls.dir; ++j, o += 5) {
    if (!(slot_row(ls, o, i, n) > 0.5f)) continue;
    direction(slot_vec(ls, o + 1, i, n), slot_row(ls, o + 4, i, n), f, v);
  }
  return ForceVel{f, v};
}

// local_slots out of line, its arguments by value, for the step kernels:
// inlined, its code cost them registers and time on scenes without slots
// too (scripts/cuda_local_cost_ab.py).
__device__ __noinline__ ForceVel local_constraints(LocalSlots ls,
                                                   float normal_coeff, int i,
                                                   int n, float3 f, float3 p,
                                                   float3 v) {
  return local_slots(ls, normal_coeff, i, n, f, p, v);
}

// What acts on mass i of n after the spring sum f, at (p, v): the global
// contact planes in registration order, the global balls
// (object.cu:56-59), the per-mass local constraints and quadratic drag
// -C |v| v (sim.cu:1329-1332).  Returns the force; v becomes the velocity
// the local constraints leave, which drag reads and the integrator must
// read.  `drag` is read only with has_drag.
__device__ __forceinline__ float3 contact_and_drag(
    int n_planes, const float* planes, int n_balls, const float* balls,
    const LocalSlots& local, float normal_coeff, int has_drag,
    const float* drag, int i, int n, float3 f, float3 p, float3& v) {
  for (int pi = 0; pi < n_planes; ++pi) {
    f = plane_force(planes + 6 * pi, normal_coeff, f, p, v);
  }
  for (int bi = 0; bi < n_balls; ++bi) {
    const float* b = balls + 4 * bi;
    f = ball_force(make_float3(b[0], b[1], b[2]), b[3], normal_coeff, f, p);
  }
  if (local.lc != nullptr) {
    const ForceVel fv = local_constraints(local, normal_coeff, i, n, f, p, v);
    f = fv.f;
    v = fv.v;
  }
  if (has_drag) f = sub3(f, mul3(v, drag[i] * sqrtf(dot3(v, v))));
  return f;
}

// RK2 midpoint predictor (sim.cu:1336-1343): half an Euler step from
// (p, v) with acceleration acc; a frozen mass stays.
__device__ __forceinline__ void rk2_midpoint(float3 p, float3 v, float3 acc,
                                             float dt, bool frozen,
                                             float3& ph, float3& vh) {
  if (frozen) {
    ph = p;
    vh = v;
    return;
  }
  ph = make_float3(p.x + 0.5f * v.x * dt, p.y + 0.5f * v.y * dt,
                   p.z + 0.5f * v.z * dt);
  vh = make_float3(v.x + 0.5f * acc.x * dt, v.y + 0.5f * acc.y * dt,
                   v.z + 0.5f * acc.z * dt);
}

// ACTUATED_* rest advance with the reference's one-sided clamp
// (sim.cu:1173-1181): expand while rest < l_max, contract while > l_min.
__device__ __forceinline__ float advanced_rest(const StepArgs& a, int s,
                                               float dt) {
  const float r = a.rest_src[s];
  const float ar = a.arate[s], ab = a.abound[s];
  const bool adv = (ar > 0.f && r < ab) || (ar < 0.f && r > ab);
  return adv ? r + ar * dt : r;
}

// Force of slot s on its right endpoint (the left one gets its negative).
__device__ __forceinline__ float3 spring_force(const StepArgs& a, int s,
                                               float rest, float3 pl,
                                               float3 vl, float3 pr,
                                               float3 vr, float t) {
  if (a.has_breathing) rest = rest * breath_scale(a.bsign[s], a.bomega[s], t);
  const Spring q = spring_eval(a.k[s], rest, a.has_damping,
                               a.has_damping ? a.damping[s] : 0.f, pl, vl, pr,
                               vr);
  return mul3(q.diff, q.cm * q.inv);
}

// Remainder spring e at (pos, vel), time t: its ends, their velocities
// and the forward's intermediates (its force on the right end is
// diff * (cm * inv)).  ACTUATED rest in the closed form after cidx force
// calls, or advanced once from rest_src, and then, where `own`, written to
// rest_dst.
struct RemSpring : Spring {
  int l, r;
  float3 vl, vr;
  float rest, rest_b, scale, advc;
};

__device__ __forceinline__ RemSpring rem_spring(const Remainder& r, int e,
                                                int n, const float* pos,
                                                const float* vel, float t,
                                                float dt, float cidx,
                                                bool own) {
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  RemSpring q;
  q.l = r.ends[e];
  q.r = r.ends[r.s + e];
  q.vl = r.has_damping ? ld3(vel, q.l, n) : zero;
  q.vr = r.has_damping ? ld3(vel, q.r, n) : zero;
  q.rest_b = r.rest_src[e];
  q.advc = 0.f;
  if (r.has_actuated && r.closed) {
    q.advc = fminf(cidx, rem_row(r, kRemSstop, e));
    q.rest_b = q.rest_b + q.advc * rem_row(r, kRemAratedt, e);
  } else if (r.has_actuated) {
    const float ar = rem_row(r, kRemArate, e), ab = rem_row(r, kRemAbound, e);
    const bool adv =
        (ar > 0.f && q.rest_b < ab) || (ar < 0.f && q.rest_b > ab);
    q.rest_b = adv ? q.rest_b + ar * dt : q.rest_b;
    if (own) r.rest_dst[e] = q.rest_b;
  }
  q.scale = 1.f;
  q.rest = q.rest_b;
  if (r.has_breathing) {
    q.scale = breath_scale(rem_row(r, kRemBsign, e), rem_row(r, kRemBomega, e),
                           t);
    q.rest = q.rest_b * q.scale;
  }
  static_cast<Spring&>(q) = spring_eval(
      rem_row(r, kRemK, e), q.rest, r.has_damping,
      r.has_damping ? rem_row(r, kRemDamping, e) : 0.f, ld3(pos, q.l, n),
      q.vl, ld3(pos, q.r, n), q.vr);
  return q;
}

// The remainder springs' force on mass i at (pos, vel), time t: mass i
// walks its row of the incidence table and evaluates each of its springs
// itself, from the spring's left and right ends in that order (so that
// both endpoints compute the same force), adding sign x force in row order
// from zero.  The thread of a spring's left endpoint writes its advanced
// rest.  Inlined: only the kernels' REM instantiation calls it, so scenes
// without remainder springs carry none of its code.  Plain version:
// titan_tpu_torch/ops/forces.py::remainder_sum.
__device__ __forceinline__ float3 remainder_forces(const Remainder& r, int i,
                                                   int n, const float* pos,
                                                   const float* vel, float t,
                                                   float dt, float cidx) {
  float3 acc = make_float3(0.f, 0.f, 0.f);
  for (int q = 0; q < r.d; ++q) {
    const size_t at = static_cast<size_t>(i) * r.d + q;
    const int e = r.inc[at];
    if (e >= r.s) continue;
    const float sg = r.sign[at];
    const RemSpring x = rem_spring(r, e, n, pos, vel, t, dt, cidx, sg < 0.f);
    acc = add3(acc, mul3(mul3(x.diff, x.cm * x.inv), sg));
  }
  return acc;
}

// One force evaluation and update of mass i.  With a non-null `trace`
// (the adjoint's replay), the state the forces are evaluated at is also
// written there as [pos (3 N); vel (3 N)].  REM compiles the remainder
// call in, for a scene with remainder springs: out of line behind a null
// check, its call site alone cost the other scenes' steps 2.4% (PERF.md
// section 6).
template <bool REM>
__device__ __forceinline__ void step_body(const StepArgs& a, int mode,
                                          float* trace) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n;
  if (i >= n) return;
  const float dt = a.scal[0];
  // t = t0 + step * dt (+ 0.5 dt), rounded as the plain version rounds it
  const float t_base = __fadd_rn(a.scal[1], __fmul_rn((float)a.step, dt));
  const float t = __fadd_rn(t_base, __fmul_rn(a.half, dt));
  const float3 zero = make_float3(0.f, 0.f, 0.f);

  const float3 p = ld3(a.fpos, i, n);
  float3 v = ld3(a.fvel, i, n);
  if (trace != nullptr) {
    st3(trace, i, n, p);
    st3(trace + 3 * static_cast<size_t>(n), i, n, v);
  }
  float3 f = ld3(a.cforce, i, n);

  for (int fi = 0; fi < a.nf; ++fi) {
    const int d = a.deltas[fi];
    const int base = fi * n;
    // left spring: slot (fi, i), partner i + d; this thread owns its rest
    const int s = base + i;
    const float rest_l = a.has_actuated ? advanced_rest(a, s, dt)
                                        : a.rest_src[s];
    if (a.has_actuated) a.rest_dst[s] = rest_l;
    const int j = i + d;
    if (j >= 0 && j < n) {
      const float3 vj = a.has_damping ? ld3(a.fvel, j, n) : zero;
      const float3 fs = spring_force(a, s, rest_l, p, v, ld3(a.fpos, j, n),
                                     vj, t);
      f = make_float3(f.x - fs.x, f.y - fs.y, f.z - fs.z);
    }
    // right spring: slot (fi, i - d), whose left endpoint is i - d
    const int l = i - d;
    if (l >= 0 && l < n) {
      const int sr = base + l;
      const float rest_r = a.has_actuated ? advanced_rest(a, sr, dt)
                                          : a.rest_src[sr];
      const float3 vl = a.has_damping ? ld3(a.fvel, l, n) : zero;
      const float3 fs = spring_force(a, sr, rest_r, ld3(a.fpos, l, n), vl, p,
                                     v, t);
      f = make_float3(f.x + fs.x, f.y + fs.y, f.z + fs.z);
    }
  }
  if (REM) {
    f = add3(f, remainder_forces(a.rem, i, n, a.fpos, a.fvel, t, dt, 0.f));
  }

  // from here on v is the velocity the local constraints leave
  f = contact_and_drag(a.n_planes, a.planes, a.n_balls, a.balls, a.local,
                       a.normal_coeff, a.has_drag, a.drag, i, n, f, p, v);

  const float minv = a.minv[i];
  const float3 acc = mul3(f, minv);
  const bool frozen = a.fixed[i] != 0.f;

  if (mode == kRk2Half) {
    float3 ph, vh;
    rk2_midpoint(p, v, acc, dt, frozen, ph, vh);
    st3(a.pos_dst, i, n, ph);
    st3(a.vel_dst, i, n, vh);
    if (a.v1_dst != nullptr) st3(a.v1_dst, i, n, v);
    return;
  }

  const float3 p0 = ld3(a.pos0, i, n);
  const float3 v0 = ld3(a.vel0, i, n);
  if (frozen) {
    st3(a.pos_dst, i, n, p0);
    st3(a.vel_dst, i, n, v0);
    st3(a.acc_dst, i, n, ld3(a.acc0, i, n));
    return;
  }
  float3 v2, p2;
  if (mode == kVerlet) {  // reference 'Verlet' (sim.cu:1350-1354)
    const float3 a0 = ld3(a.acc0, i, n);
    v2 = make_float3(v.x + 0.5f * (a0.x + acc.x) * dt,
                     v.y + 0.5f * (a0.y + acc.y) * dt,
                     v.z + 0.5f * (a0.z + acc.z) * dt);
    p2 = make_float3(p.x + (v2.x * dt + 0.5f * acc.x * dt * dt),
                     p.y + (v2.y * dt + 0.5f * acc.y * dt * dt),
                     p.z + (v2.z * dt + 0.5f * acc.z * dt * dt));
  } else if (mode == kRk2Full) {  // corrector from the backups (1344-1349)
    // from pass 1's mutated velocity; the position with pass 2's
    const float3 vb = a.v1_src != nullptr ? ld3(a.v1_src, i, n) : v0;
    v2 = make_float3(vb.x + acc.x * dt, vb.y + acc.y * dt, vb.z + acc.z * dt);
    p2 = make_float3(p0.x + v.x * dt, p0.y + v.y * dt, p0.z + v.z * dt);
  } else {  // Euler with the optional unit-speed clamp (sim.cu:1355-1362)
    v2 = make_float3(v.x + acc.x * dt, v.y + acc.y * dt, v.z + acc.z * dt);
    if (a.clamp) {
      const float vn = sqrtf(dot3(v2, v2));
      if (vn > 1.f) v2 = make_float3(v2.x / vn, v2.y / vn, v2.z / vn);
    }
    p2 = make_float3(p.x + v2.x * dt, p.y + v2.y * dt, p.z + v2.z * dt);
  }
  st3(a.pos_dst, i, n, p2);
  st3(a.vel_dst, i, n, v2);
  st3(a.acc_dst, i, n, acc);
}

}  // namespace titan

// Host-side arguments of one chunk; field order matches the ctypes
// structure _ChunkArgs in titan_tpu_torch/ops/fused_step.py.
struct ChunkArgs {
  int n, nf, n_planes, n_balls, n_steps, integrator;  // 0 Euler, 1 Verlet, 2 RK2
  int clamp, has_damping, has_breathing, has_actuated, has_drag, device;
  float normal_coeff;
  const int* deltas;
  const float* scal;
  const float* planes;
  const float* balls;
  const float* pos_in;
  const float* vel_in;
  const float* acc_in;
  const float* cforce;
  const float* minv;
  const float* fixed;
  const float* k;
  const float* rest_in;
  const float* damping;
  const float* bsign;
  const float* bomega;
  const float* arate;
  const float* abound;
  const float* drag;
  float* pos_out;
  float* vel_out;
  float* acc_out;
  float* pos_tmp;
  float* vel_tmp;
  float* acc_tmp;
  float* pos_half;
  float* vel_half;
  float* vel_v1;  // RK2 with local constraints: pass 1's mutated velocity
  float* rest_out;
  float* rest_tmp;
  float* rem_out;  // remainder rest (actuated): where the last pass lands
  float* rem_tmp;
  titan::LocalSlots local;
  titan::Remainder rem;  // rem.rest_src: the chunk's input remainder rest
};

namespace titan {

// The launch arguments that stay the same over a chunk: sizes, flags and
// the invariant inputs (the caller sets the step, the state buffers and
// rest).
inline StepArgs step_args(const ChunkArgs* c) {
  StepArgs a = {};
  a.n = c->n;
  a.nf = c->nf;
  a.n_planes = c->n_planes;
  a.n_balls = c->n_balls;
  a.clamp = c->clamp;
  a.has_damping = c->has_damping;
  a.has_breathing = c->has_breathing;
  a.has_actuated = c->has_actuated;
  a.has_drag = c->has_drag;
  a.normal_coeff = c->normal_coeff;
  a.deltas = c->deltas;
  a.scal = c->scal;
  a.planes = c->planes;
  a.balls = c->balls;
  a.cforce = c->cforce;
  a.minv = c->minv;
  a.fixed = c->fixed;
  a.k = c->k;
  a.damping = c->damping;
  a.bsign = c->bsign;
  a.bomega = c->bomega;
  a.arate = c->arate;
  a.abound = c->abound;
  a.drag = c->drag;
  a.local = c->local;
  a.rem = c->rem;
  return a;
}

// Enqueue c->n_steps steps on `stream`: one call of `launch(blocks,
// threads, stream, args, mode, step, first)` per force evaluation, where
// `first` marks the step's first evaluation (the one at the step's input
// state).  `launch` launches the caller's kernel and returns
// cudaGetLastError().  Returns 0, or the first CUDA error.
template <typename Launch>
int enqueue_chunk(const ChunkArgs* c, void* stream, Launch launch) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  const bool rk2 = c->integrator == 2;
  const int evals = c->n_steps * (rk2 ? 2 : 1);

  StepArgs a = step_args(c);

  const float* pos = c->pos_in;
  const float* vel = c->vel_in;
  const float* acc = c->acc_in;
  const float* rest = c->rest_in;
  const float* rem = c->rem.rest_src;
  int e = 0;  // force evaluations so far (rest advances once per evaluation)
  // evaluation e writes rest (and the remainder rest) into the buffer that
  // makes the last one land in rest_out (rem_out)
  auto to_out = [&](int ev) { return (evals - 1 - ev) % 2 == 0; };
  auto eval = [&](int mode, int s, bool first) -> cudaError_t {
    const bool out = to_out(e++);
    a.rest_src = rest;
    a.rest_dst = !c->has_actuated ? nullptr
                                  : (out ? c->rest_out : c->rest_tmp);
    a.rem.rest_src = rem;
    a.rem.rest_dst = !c->has_actuated ? nullptr
                                      : (out ? c->rem_out : c->rem_tmp);
    const cudaError_t r = launch(blocks, threads, st, a, mode, s, first);
    if (c->has_actuated) {
      rest = a.rest_dst;
      rem = a.rem.rest_dst;
    }
    return r;
  };

  for (int s = 0; s < c->n_steps; ++s) {
    const bool to_out = ((c->n_steps - 1 - s) % 2) == 0;
    float* pd = to_out ? c->pos_out : c->pos_tmp;
    float* vd = to_out ? c->vel_out : c->vel_tmp;
    float* ad = to_out ? c->acc_out : c->acc_tmp;
    a.step = s;
    a.pos0 = pos;
    a.vel0 = vel;
    a.acc0 = acc;
    a.half = 0.f;
    a.fpos = pos;
    a.fvel = vel;
    if (rk2) {
      a.pos_dst = c->pos_half;
      a.vel_dst = c->vel_half;
      a.acc_dst = nullptr;
      a.v1_dst = c->vel_v1;
      a.v1_src = nullptr;
      if ((err = eval(kRk2Half, s, true)) != cudaSuccess) return (int)err;
      a.half = 0.5f;
      a.fpos = c->pos_half;
      a.fvel = c->vel_half;
      a.v1_dst = nullptr;
      a.v1_src = c->vel_v1;
    }
    a.pos_dst = pd;
    a.vel_dst = vd;
    a.acc_dst = ad;
    const int mode = rk2 ? kRk2Full : (c->integrator == 1 ? kVerlet : kEuler);
    if ((err = eval(mode, s, !rk2)) != cudaSuccess) return (int)err;
    pos = pd;
    vel = vd;
    acc = ad;
  }
  return 0;
}

}  // namespace titan

#endif  // TITAN_STEP_BODY_CUH_
