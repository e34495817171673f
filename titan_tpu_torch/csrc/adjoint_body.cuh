// The per-mass transpose of one step, shared by csrc/adjoint.cu (the fused
// adjoint's backward, dense [F, N] parameter planes) and
// csrc/tiled_adjoint.cu (the tiled adjoint's backward, the tiled step's
// data contract: family scalars times the existence bitmask where a field
// is uniform), so that each piece of the transpose has one CUDA copy.  The
// math is titan_tpu_torch/ops/adjoint.py::backward_step /
// _force_transpose; how the sweep is split into launches is set out at the
// top of csrc/adjoint.cu.
//
// Every function is a template over the argument struct A, which holds
// the scene's flags and pointers under the same names in both kernels and
// answers the per-slot parameter reads through four accessors:
// k_at, rest_at, bsign_at and bomega_at (family fi, left mass l, slot
// s = fi N + l).  damping, aratedt and sstop are [F, N] planes in both, and
// both carry the per-mass local-constraint slots as `local`, the remainder
// springs as `rem` and their per-spring gradient accumulator as `grem`.
//
// Remainder springs.  The JAX kernel's transpose reuses its one-hot
// gather and scatter (gather^T = scatter).  Here the force phase recomputes
// the remainder sum with the closed-form ACTUATED rest, and the spring
// phase, which reads gf at every mass, walks each mass's incidence row
// again: a spring's force cotangent is gf at its right end less gf at its
// left, each endpoint's thread adds its own share of the position and
// velocity cotangents, and the left endpoint's thread alone adds the
// spring's gradients to grem, [5, S] (k, rest, damping, omega, rate * dt),
// summed over the segment's steps: no atomics, a fixed order.
//
// Magnets.  A magnet scene's trace entry holds each force pass's constant
// force (const_f + the field) after pos and vel (np rows); the sweep reads
// it in place of cforce and, where the argument struct carries the folded
// magnet parameters (mag), follows each pass's phase B with the pairwise
// field's transpose (csrc/magnets_adjoint.cuh) on that pass's gf.
// enqueue_part runs one part of a reversed step, for a caller that runs a
// binned field's transpose itself between the parts.
//
// Local constraints.  The JAX kernel stashes each slot's inputs (the force
// entering a contact plane; the force and velocity entering a constraint
// plane or direction) in VMEM for the transpose.  Here the chain is per
// mass, so each thread recomputes a slot's inputs from the force entering
// the local block (f0 through the global planes and balls) and the input
// velocity, running the slots before it again; with a few slots per mass
// that costs less than storing them.

#ifndef TITAN_ADJOINT_BODY_CUH_
#define TITAN_ADJOINT_BODY_CUH_

#include <cstddef>

#include <cuda_runtime.h>

#include "magnets_adjoint.cuh"
#include "step_body.cuh"

namespace titan_adj {

using titan::add3;
using titan::dot3;
using titan::ld3;
using titan::mul3;
using titan::st3;
using titan::sub3;

__device__ __forceinline__ float3 neg3(float3 a) {
  return make_float3(-a.x, -a.y, -a.z);
}
__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// t and the closed-form actuation call count of evaluation `call` (1, or
// 2 for the RK2 midpoint) of step t, as the plain version computes them.
template <class A>
__device__ __forceinline__ float eval_time(const A& a, int t, int call) {
  const float dt = a.scal[0];
  const float tn = a.scal[1] + (float)t * dt;
  return call == 2 ? tn + 0.5f * dt : tn;
}
template <class A>
__device__ __forceinline__ float eval_cidx(const A& a, int t, int call) {
  const float base = a.integrator == 2 ? 2.f * (float)t : (float)t;
  return base + (float)call;
}

__device__ __forceinline__ size_t slot_of(int fi, int l, int n) {
  return static_cast<size_t>(fi) * static_cast<size_t>(n) + l;
}

// One spring slot at an evaluation point: the forward's intermediates,
// with the closed-form ACTUATED rest.
struct Slot : titan::Spring {
  float rest, rest_b, scale, advc;
};

template <class A>
__device__ __forceinline__ Slot slot_eval(const A& a, int fi, int l,
                                          float3 pl, float3 vl, float3 pr,
                                          float3 vr, float t, float cidx) {
  const size_t s = slot_of(fi, l, a.n);
  Slot q;
  q.rest_b = a.rest_at(fi, l, s);
  q.advc = 0.f;
  if (a.has_actuated) {
    q.advc = fminf(cidx, a.sstop[s]);
    q.rest_b = q.rest_b + q.advc * a.aratedt[s];
  }
  q.scale = 1.f;
  q.rest = q.rest_b;
  if (a.has_breathing) {
    q.scale = titan::breath_scale(a.bsign_at(fi, l, s), a.bomega_at(fi, l, s),
                                  t);
    q.rest = q.rest_b * q.scale;
  }
  static_cast<titan::Spring&>(q) = titan::spring_eval(
      a.k_at(fi, l, s), q.rest, a.has_damping,
      a.has_damping ? a.damping[s] : 0.f, pl, vl, pr, vr);
  return q;
}

// cf + the spring families' (and with REM the remainder springs') force on
// mass i at (pos, vel).  REM, here and below, compiles the remainder calls
// in, for a scene with remainder springs (as step_body's).
template <class A, bool REM>
__device__ float3 spring_sum(const A& a, int i, const float* pos,
                             const float* vel, float3 p, float3 v, float t,
                             float cidx) {
  const int n = a.n;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 f = ld3(a.cforce, i, n);
  for (int fi = 0; fi < a.nf; ++fi) {
    const int d = a.deltas[fi];
    const int j = i + d;
    if (j >= 0 && j < n) {
      const Slot q = slot_eval(a, fi, i, p, v, ld3(pos, j, n),
                               a.has_damping ? ld3(vel, j, n) : zero, t, cidx);
      f = sub3(f, mul3(q.diff, q.cm * q.inv));
    }
    const int l = i - d;
    if (l >= 0 && l < n) {
      const Slot q = slot_eval(a, fi, l, ld3(pos, l, n),
                               a.has_damping ? ld3(vel, l, n) : zero, p, v, t,
                               cidx);
      f = add3(f, mul3(q.diff, q.cm * q.inv));
    }
  }
  if (REM) {
    f = add3(f, titan::remainder_forces(a.rem, i, n, pos, vel, t, a.scal[0],
                                        cidx));
  }
  return f;
}

// Planes, balls, local constraints and drag after the spring sum f0: the
// force the integrator consumes (the forward's own code).  v becomes the
// velocity the local constraints leave, which the integrator consumes.
template <class A>
__device__ __forceinline__ float3 stages_fwd(const A& a, int i, float3 f,
                                             float3 p, float3& v) {
  return titan::contact_and_drag(a.n_planes, a.planes, a.n_balls, a.balls,
                                 a.local, a.normal_coeff, a.has_drag, a.drag,
                                 i, a.n, f, p, v);
}

// The force entering the local block: f0 through the global planes and
// balls.
template <class A>
__device__ __forceinline__ float3 global_stages(const A& a, float3 f,
                                                float3 p, float3 v) {
  for (int pi = 0; pi < a.n_planes; ++pi) {
    f = titan::plane_force(a.planes + 6 * pi, a.normal_coeff, f, p, v);
  }
  for (int bi = 0; bi < a.n_balls; ++bi) {
    const float* b = a.balls + 4 * bi;
    f = titan::ball_force(make_float3(b[0], b[1], b[2]), b[3],
                          a.normal_coeff, f, p);
  }
  return f;
}

// The force and velocity entering local slot `stop` (slots numbered over
// all types in reference order) of mass i, from the force fl entering the
// local block and the input velocity v: the slots before it, run again
// (inlined: only the backward kernels with local constraints run it).
__device__ __forceinline__ titan::ForceVel local_inputs(
    titan::LocalSlots ls, float nc, int i, int n, float3 fl, float3 p,
    float3 v, int stop) {
  int left = stop;
  ls.cp = min(ls.cp, left);
  left -= ls.cp;
  ls.ball = min(ls.ball, left);
  left -= ls.ball;
  ls.pl = min(ls.pl, left);
  left -= ls.pl;
  ls.dir = min(ls.dir, left);
  return titan::local_slots(ls, nc, i, n, fl, p, v);
}

// Transpose of a contact plane's friction select (inside, with friction)
// at the force f entering it and velocity v: from the cotangent gf on
// the plane's friction output, returns the cotangent on f and adds the
// velocity part to gv.
__device__ __forceinline__ float3 friction_transpose(float3 nv, float fk,
                                                     float fs, float3 f,
                                                     float3 v, float3 gf,
                                                     float3& gv) {
  const float fn_mag = dot3(f, nv);
  const float3 f_n = mul3(nv, fn_mag);
  const float vdotn = dot3(v, nv);
  const float3 vp = sub3(v, mul3(nv, vdotn));
  const float v_norm = sqrtf(dot3(vp, vp));
  const bool kinetic = v_norm > 1e-16f;
  const float fn_abs = fabsf(fn_mag);
  const float safe_vn = kinetic ? v_norm : 1.f;
  const float3 f_perp = sub3(f, f_n);
  const float fp_norm = sqrtf(dot3(f_perp, f_perp));
  const bool sta_hold = fs * fn_abs > fp_norm;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  const float3 gf_kin = kinetic ? gf : zero;
  const float3 gf_sta = kinetic ? zero : gf;
  float3 g = zero;
  g = add3(g, gf_sta);                             // f_sta = f - f_perp
  const float3 gf_perp = sta_hold ? neg3(gf_sta) : zero;
  g = add3(g, gf_perp);                            // f_perp = f - f_n
  const float3 gf_n = neg3(gf_perp);
  g = add3(g, gf_kin);                             // f_kin = f - vp s
  const float s = fk * fn_abs / safe_vn;
  const float gs = -dot3(vp, gf_kin);
  float3 gv_perp = mul3(gf_kin, -s);
  const float gfn_abs = fk * gs / safe_vn;
  const float gsafe_vn = -fk * fn_abs * gs / (safe_vn * safe_vn);
  const float gv_norm = kinetic ? gsafe_vn : 0.f;
  gv_perp = add3(gv_perp, mul3(vp, v_norm > 0.f ? gv_norm / safe_vn : 0.f));
  gv = add3(gv, gv_perp);                          // vp = v - (v.n) n
  const float gvdotn = -dot3(nv, gv_perp);
  gv = add3(gv, mul3(nv, gvdotn));
  const float gfn_mag = dot3(gf_n, nv) + signf(fn_mag) * gfn_abs;
  return add3(g, mul3(nv, gfn_mag));
}

// Transpose of a ball of centre c and radius r at p for the force
// cotangent gf (which passes through): adds its position part to gp.
__device__ __forceinline__ void ball_transpose(float3 c, float r, float nc,
                                               float3 p, float3 gf,
                                               float3& gp) {
  const float3 dv = sub3(p, c);
  const float dist = sqrtf(dot3(dv, dv));
  const float safe = dist > 0.f ? dist : 1.f;
  const bool active = dist <= r && dist > 0.f;
  const float push = active ? nc / safe : 0.f;
  const float gpush = dot3(dv, gf);
  float3 gd = mul3(gf, push);
  const float gdist = active ? -nc * gpush / (safe * safe) : 0.f;
  gd = add3(gd, mul3(dv, gdist / safe));
  gp = add3(gp, gd);
}

// The cotangents local_transpose carries: on the force, on the velocity
// and the position part.
struct LocalBar {
  float3 gf, gv, gp;
};

// Transpose of the local slots of mass i of n in reverse order
// (directions, constraint planes, balls, contact planes; the plain version
// is ops/adjoint.py::_local_transpose) at the force fl entering the local
// block, position p and input velocity v: g.gf goes from the cotangent on
// the block's output force to that on fl, g.gv from the cotangent on the
// block's output velocity to that on v; the balls' and contact planes'
// position parts are added to g.gp.  Out of line, its arguments by value,
// as step_body.cuh::local_constraints is: so that scenes without slots do
// not pay for its code (scripts/cuda_local_cost_ab.py).
__device__ __noinline__ LocalBar local_transpose(titan::LocalSlots ls,
                                                    float nc, int i, int n,
                                                    float3 fl, float3 p,
                                                    float3 v, LocalBar g) {
  const int ball_base = 7 * ls.cp;
  const int pl_base = ball_base + 5 * ls.ball;
  const int dir_base = pl_base + 5 * ls.pl;
  const int q_pl = ls.cp + ls.ball, q_dir = q_pl + ls.pl;
  float3& gf = g.gf;
  float3& gv = g.gv;
  float3& gp = g.gp;
  for (int j = ls.dir - 1; j >= 0; --j) {
    const int o = dir_base + 5 * j;
    if (!(titan::slot_row(ls, o, i, n) > 0.5f)) continue;
    const float3 t = titan::slot_vec(ls, o + 1, i, n);
    const float fric = titan::slot_row(ls, o + 4, i, n);
    const titan::ForceVel in =
        local_inputs(ls, nc, i, n, fl, p, v, q_dir + j);
    const float3 nfv = sub3(in.f, mul3(t, dot3(in.f, t)));
    const float v_norm = sqrtf(dot3(in.v, in.v));
    const float nf_norm = sqrtf(dot3(nfv, nfv));
    float gnn = 0.f;
    if (v_norm >= 1e-16f) {  // v_out = t (v_in . t); f3 = f2 - |nfv| fric t
      gv = mul3(t, dot3(t, gv));
      gnn = -fric * dot3(t, gf);
    }
    // f2 = f_in - nfv, nfv = f_in - t (f_in . t)
    const float3 gnfv = sub3(mul3(nfv, nf_norm > 0.f ? gnn / nf_norm : 0.f),
                             gf);
    gf = add3(gf, sub3(gnfv, mul3(t, dot3(t, gnfv))));
  }
  for (int j = ls.pl - 1; j >= 0; --j) {
    const int o = pl_base + 5 * j;
    if (!(titan::slot_row(ls, o, i, n) > 0.5f)) continue;
    const float3 nv = titan::slot_vec(ls, o + 1, i, n);
    const float fric = titan::slot_row(ls, o + 4, i, n);
    const titan::ForceVel in =
        local_inputs(ls, nc, i, n, fl, p, v, q_pl + j);
    const float nf = dot3(in.f, nv);
    const float v_norm = sqrtf(dot3(in.v, in.v));
    float gnf = 0.f;
    if (v_norm >= 1e-16f) {  // v_out = v2c; f3 = f2 - fric nf v2c / |v_in|
      const float3 v2c = sub3(in.v, mul3(nv, dot3(in.v, nv)));
      const float s = fric / v_norm;
      const float d = dot3(v2c, gf);
      gnf = -s * d;
      const float3 gv2c = sub3(gv, mul3(gf, s * nf));
      const float gsafe = fric * nf * d / (v_norm * v_norm);
      gv = sub3(gv2c, mul3(nv, dot3(nv, gv2c)));
      gv = add3(gv, mul3(in.v, gsafe / v_norm));
    }
    // f2 = f_in - n nf, nf = f_in . n
    gnf = gnf - dot3(nv, gf);
    gf = add3(gf, mul3(nv, gnf));
  }
  for (int j = ls.ball - 1; j >= 0; --j) {
    const int o = ball_base + 5 * j;
    if (!(titan::slot_row(ls, o, i, n) > 0.5f)) continue;
    ball_transpose(titan::slot_vec(ls, o + 1, i, n),
                   titan::slot_row(ls, o + 4, i, n), nc, p, gf, gp);
  }
  for (int j = ls.cp - 1; j >= 0; --j) {
    const int o = 7 * j;
    if (!(titan::slot_row(ls, o, i, n) > 0.5f)) continue;
    const float3 nv = titan::slot_vec(ls, o + 1, i, n);
    const float off = titan::slot_row(ls, o + 4, i, n);
    const float fk = titan::slot_row(ls, o + 5, i, n);
    const float fs = titan::slot_row(ls, o + 6, i, n);
    const float disp = dot3(p, nv) - off;
    if (!(disp < 0.f)) continue;    // the plane added nothing here
    gp = add3(gp, mul3(nv, -nc * dot3(gf, nv)));
    if (!(fs > 0.f || fk > 0.f)) continue;
    // contact planes precede every velocity mutation: friction reads v
    const titan::ForceVel in = local_inputs(ls, nc, i, n, fl, p, v, j);
    gf = friction_transpose(nv, fk, fs, in.f, v, gf, gv);
  }
  return g;
}

// Transpose of the drag, local-constraint, ball and plane stages (reverse
// order) at (p, v) for the cotangents gf (on the final force; on return,
// on the spring sum) and gv (on the velocity the integrator consumed, vf,
// the one the local constraints leave; on return, on the input velocity v,
// including the stages' part).  Returns the stages' gpos part; adds the
// drag gradient to *gdrag.
template <class A>
__device__ float3 stages_transpose(const A& a, int i, float3 f0, float3 p,
                                   float3 v, float3 vf, float3& gf,
                                   float3& gv, float* gdrag) {
  const float nc = a.normal_coeff;
  float3 gp = make_float3(0.f, 0.f, 0.f);
  if (a.has_drag) {
    const float sq = dot3(vf, vf);
    const float vn = sq > 0.f ? sqrtf(sq) : 1.f;
    const float vnm = sq > 0.f ? vn : 0.f;
    const float dotv = dot3(vf, gf);
    const float w = sq > 0.f ? dotv / vn : 0.f;
    const float dr = a.drag[i];
    gv = make_float3(gv.x - dr * (vnm * gf.x + w * vf.x),
                     gv.y - dr * (vnm * gf.y + w * vf.y),
                     gv.z - dr * (vnm * gf.z + w * vf.z));
    *gdrag = -(vnm * dotv);
  }
  if (a.local.lc != nullptr) {
    const LocalBar g = local_transpose(a.local, nc, i, a.n,
                                       global_stages(a, f0, p, v), p, v,
                                       LocalBar{gf, gv, gp});
    gf = g.gf;
    gv = g.gv;
    gp = g.gp;
  }
  for (int bi = a.n_balls - 1; bi >= 0; --bi) {
    const float* b = a.balls + 4 * bi;
    ball_transpose(make_float3(b[0], b[1], b[2]), b[3], nc, p, gf, gp);
  }
  for (int pi = a.n_planes - 1; pi >= 0; --pi) {
    const float* pl = a.planes + 6 * pi;
    const float3 nv = make_float3(pl[0], pl[1], pl[2]);
    const float off = pl[3], fk = pl[4], fs = pl[5];
    const float disp = dot3(p, nv) - off;
    const bool inside = disp < 0.f;
    if (!inside) continue;    // the plane added nothing here
    const float gcontact = dot3(gf, nv);
    gp = add3(gp, mul3(nv, -nc * gcontact));
    if (!(fs > 0.f || fk > 0.f)) continue;
    // the force entering plane pi
    float3 f = f0;
    for (int q = 0; q < pi; ++q) {
      f = titan::plane_force(a.planes + 6 * q, nc, f, p, v);
    }
    // inside and with friction: the select takes the friction branch
    gf = friction_transpose(nv, fk, fs, f, v, gf, gv);
  }
  return gp;
}

// RK2: the midpoint (pos_h, vel_h) of mass i at step t from trace[t].
template <class A, bool REM>
__device__ __forceinline__ void bwd_mid_mass(const A& a, const float* pos,
                                             const float* vel, int t, int i) {
  const int n = a.n;
  const float tn = eval_time(a, t, 1);
  const float cidx = eval_cidx(a, t, 1);
  const float3 p = ld3(pos, i, n), v = ld3(vel, i, n);
  float3 v1 = v;    // pass 1's mutated velocity
  const float3 f1 =
      stages_fwd(a, i, spring_sum<A, REM>(a, i, pos, vel, p, v, tn, cidx), p,
                 v1);
  float3 ph, vh;
  titan::rk2_midpoint(p, v1, mul3(f1, a.minv[i]), a.scal[0],
                      a.fixed[i] != 0.f, ph, vh);
  st3(a.pos_h, i, n, ph);
  st3(a.vel_h, i, n, vh);
}

// Phase A of mass i at (pos, vel): pass 0 = Euler / Verlet at trace[t],
// 2 = RK2 at the midpoint, 1 = RK2 at trace[t].  Recomputes the force,
// transposes the integrator and the stages, writes the cotangent on the
// spring sum to gf[3, N] and the partial carry to gpc / gvc, accumulates
// the cf, minv and drag gradients of mass i, and (pass != 2) writes the
// carry's non-spring part.
template <class A, bool REM>
__device__ __forceinline__ void bwd_force_mass(const A& a, const float* pos,
                                               const float* vel, int t,
                                               int pass, int i, float* gf_out) {
  const int n = a.n;
  const int call = pass == 2 ? 2 : 1;
  const float tn = eval_time(a, t, call);
  const float cidx = eval_cidx(a, t, call);
  const float3 p = ld3(pos, i, n), v = ld3(vel, i, n);
  const float3 f0 = spring_sum<A, REM>(a, i, pos, vel, p, v, tn, cidx);
  float3 vf = v;    // the velocity the integrator consumed
  const float3 ff = stages_fwd(a, i, f0, p, vf);
  const float dt = a.scal[0];
  const float minv = a.minv[i];
  const float fx = a.fixed[i], nf = 1.f - fx;
  const float3 gpos2 = ld3(a.gpos, i, n);
  const float3 gvel2 = ld3(a.gvel, i, n);
  const float3 gacc2 = ld3(a.gacc, i, n);
  float3 gacc, gvm, gpos_out = gpos2, gvel_out, gacc_out;
  if (pass == 0) {
    const float3 gv2 = add3(gvel2, mul3(gpos2, dt * nf));
    gvel_out = mul3(gv2, fx);
    if (a.integrator == 1) {
      gvm = mul3(gv2, nf);
      gacc_out = add3(mul3(gacc2, fx), mul3(gv2, 0.5f * dt * nf));
      gacc = add3(add3(mul3(gacc2, nf), mul3(gv2, 0.5f * dt * nf)),
                  mul3(gpos2, 0.5f * dt * dt * nf));
    } else {
      gacc_out = mul3(gacc2, fx);
      gacc = mul3(gacc2, nf);
      const float3 gv2c = mul3(gv2, nf);
      float3 gv1 = gv2c;
      if (a.clamp) {  // transpose of v / |v| where |v| > 1
        const float3 v1 = add3(vf, mul3(mul3(ff, minv), dt));
        const float vn2 = dot3(v1, v1);
        const float vn = sqrtf(vn2 > 0.f ? vn2 : 1.f);
        if (vn2 > 0.f && vn > 1.f) {
          const float invn = 1.f / vn;
          const float dot_ = dot3(v1, gv2c);
          gv1 = sub3(mul3(gv2c, invn), mul3(v1, (invn * invn * invn) * dot_));
        }
      }
      gvm = gv1;
      gacc = add3(gacc, mul3(gv1, dt));
    }
  } else if (pass == 2) {
    gvm = mul3(gpos2, dt * nf);
    gacc = add3(mul3(gacc2, nf), mul3(gvel2, dt * nf));
  } else {
    const float3 gpos_h = ld3(a.gpc, i, n);
    const float3 gv_h = ld3(a.gvc, i, n);
    gvm = add3(add3(mul3(gvel2, nf), gv_h), mul3(gpos_h, 0.5f * dt * nf));
    gacc = mul3(gv_h, 0.5f * dt * nf);
    gpos_out = add3(gpos2, gpos_h);
    gvel_out = mul3(gvel2, fx);
    gacc_out = mul3(gacc2, fx);
  }
  float3 gf = mul3(gacc, minv);
  a.gminv[i] += dot3(gacc, ff);
  float gdrag = 0.f;
  const float3 gp =
      stages_transpose(a, i, f0, p, v, vf, gf, gvm, &gdrag);
  if (a.has_drag) a.gdrag[i] += gdrag;
  a.gcf[i] += gf.x;
  a.gcf[n + i] += gf.y;
  a.gcf[2 * n + i] += gf.z;
  st3(gf_out, i, n, gf);
  st3(a.gpc, i, n, gp);
  st3(a.gvc, i, n, gvm);
  if (pass != 2) {
    st3(a.gpos, i, n, gpos_out);
    st3(a.gvel, i, n, gvel_out);
    st3(a.gacc, i, n, gacc_out);
  }
}

// The transpose of one spring (Hooke + axial damping, at the intermediates
// q and effective rest `rest`, stiffness k, damping dmp, its ends'
// velocities vl, vr) for the force
// cotangent fbar on its right endpoint: dbar (the right endpoint's gpos
// part; the left gets its negative), adiff = abar * diff (the left
// endpoint's gvel part; the right gets its negative) and the cotangents
// of k (gk), of the effective rest (grest) and of the damping (gdamp).
struct SpringBar {
  float3 dbar, adiff;
  float gk, grest, gdamp;
};

__device__ __forceinline__ SpringBar spring_bar(const titan::Spring& q,
                                                float rest, float k,
                                                int has_damping, float dmp,
                                                float3 fbar, float3 vl,
                                                float3 vr) {
  SpringBar b;
  const float cbar = dot3(fbar, q.diff);
  b.dbar = mul3(fbar, q.cm * q.inv);
  const float magbar = cbar * q.inv;
  float invbar = cbar * q.cm;
  b.gk = magbar * (rest - q.ln);
  b.grest = magbar * k;
  float lnbar = -magbar * k;
  b.adiff = make_float3(0.f, 0.f, 0.f);
  b.gdamp = 0.f;
  if (has_damping) {
    const float axialbar = magbar * dmp;
    const float abar = axialbar * q.inv;
    invbar = invbar + axialbar * q.ax;
    b.gdamp = magbar * (q.ax * q.inv);
    b.dbar = add3(b.dbar, mul3(sub3(vl, vr), abar));
    b.adiff = mul3(q.diff, abar);
  }
  lnbar = lnbar - (q.ln > 0.f ? invbar * q.inv * q.inv : 0.f);
  const float d2bar = q.inv > 0.f ? 0.5f * lnbar * q.inv : 0.f;
  b.dbar = add3(b.dbar, make_float3(2.f * q.diff.x * d2bar,
                                    2.f * q.diff.y * d2bar,
                                    2.f * q.diff.z * d2bar));
  return b;
}

// The transpose of slot (fi, l) (left endpoint l, right r) for the force
// cotangent fbar on its right endpoint: returns dbar (the right
// endpoint's gpos part; the left gets its negative) and abar * diff (the
// left endpoint's gvel part; the right gets its negative) and, when
// `own`, adds the slot's parameter gradients.
template <class A>
__device__ __forceinline__ void slot_transpose(const A& a, int fi, int l,
                                               const Slot& q, float3 fbar,
                                               float3 vl, float3 vr, float t,
                                               bool own, float3& dbar,
                                               float3& adiff) {
  const size_t s = slot_of(fi, l, a.n);
  const SpringBar b = spring_bar(q, q.rest, a.k_at(fi, l, s), a.has_damping,
                                 a.has_damping ? a.damping[s] : 0.f, fbar,
                                 vl, vr);
  dbar = b.dbar;
  adiff = b.adiff;
  if (own) {
    float restbbar = b.grest;
    if (a.has_breathing) {  // rest_eff = rest_b * scale
      restbbar = b.grest * q.scale;
      const float scalebar = b.grest * q.rest_b;
      a.gomega[s] += scalebar * a.bsign_at(fi, l, s)
                     * cosf(a.bomega_at(fi, l, s) * t) * t;
    }
    a.gk[s] += b.gk;
    a.grest[s] += restbbar;
    if (a.has_damping) a.gdamp[s] += b.gdamp;
    if (a.has_actuated) a.garate[s] += restbbar * q.advc;
  }
}

// What remainder_transpose adds to mass i's position and velocity
// cotangents.
struct RemBar {
  float3 gp, gv;
};

// Transpose of the remainder springs' sum on mass i at (pos, vel), time t,
// closed-form rest after cidx calls, for the force cotangent gf [3, N] of
// every mass: each incident spring's cotangent is gf at its right end less
// gf at its left; mass i takes sign x its position part and -sign x its
// velocity part, in row order from zero, and, as the spring's left
// endpoint, adds its gradients to grem [5, S] (k, rest, damping, omega,
// rate * dt).  Inlined, as remainder_forces: only the REM instantiation
// of the backward kernels calls it.
__device__ __forceinline__ RemBar remainder_transpose(
    const titan::Remainder& r, int i, int n, const float* pos,
    const float* vel, const float* gf, float t, float cidx, float* grem) {
  const size_t ns = static_cast<size_t>(r.s);
  RemBar out;
  out.gp = make_float3(0.f, 0.f, 0.f);
  out.gv = out.gp;
  for (int q = 0; q < r.d; ++q) {
    const size_t at = static_cast<size_t>(i) * r.d + q;
    const int e = r.inc[at];
    if (e >= r.s) continue;
    const float sg = r.sign[at];
    const titan::RemSpring x =
        titan::rem_spring(r, e, n, pos, vel, t, 0.f, cidx, false);
    const SpringBar b = spring_bar(
        x, x.rest, titan::rem_row(r, titan::kRemK, e), r.has_damping,
        r.has_damping ? titan::rem_row(r, titan::kRemDamping, e) : 0.f,
        sub3(ld3(gf, x.r, n), ld3(gf, x.l, n)), x.vl, x.vr);
    out.gp = add3(out.gp, mul3(b.dbar, sg));
    out.gv = add3(out.gv, mul3(b.adiff, -sg));
    if (sg < 0.f) {
      float restbbar = b.grest;
      if (r.has_breathing) {
        restbbar = b.grest * x.scale;
        grem[3 * ns + e] += b.grest * x.rest_b
                            * titan::rem_row(r, titan::kRemBsign, e)
                            * cosf(titan::rem_row(r, titan::kRemBomega, e) * t)
                            * t;
      }
      grem[e] += b.gk;
      grem[ns + e] += restbbar;
      if (r.has_damping) grem[2 * ns + e] += b.gdamp;
      if (r.has_actuated) grem[4 * ns + e] += restbbar * x.advc;
    }
  }
  return out;
}

// Phase B of mass i at (pos, vel): the spring families' transpose, with
// both incident springs of each family gathered and gf read from the
// phase-A output `gf_in`, then the carry.
template <class A, bool REM>
__device__ __forceinline__ void bwd_spring_mass(const A& a, const float* pos,
                                                const float* vel, int t,
                                                int pass, int i,
                                                const float* gf_in) {
  const int n = a.n;
  const int call = pass == 2 ? 2 : 1;
  const float tn = eval_time(a, t, call);
  const float cidx = eval_cidx(a, t, call);
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  const float3 p = ld3(pos, i, n), v = ld3(vel, i, n);
  const float3 gfi = ld3(gf_in, i, n);
  float3 gp = ld3(a.gpc, i, n);
  float3 gv = ld3(a.gvc, i, n);
  for (int fi = 0; fi < a.nf; ++fi) {
    const int d = a.deltas[fi];
    float3 dbar, adiff;
    const int j = i + d;     // left spring: slot (fi, i), owned here
    if (j >= 0 && j < n) {
      const float3 vj = a.has_damping ? ld3(vel, j, n) : zero;
      const Slot q = slot_eval(a, fi, i, p, v, ld3(pos, j, n), vj, tn, cidx);
      const float3 fbar = add3(neg3(gfi), ld3(gf_in, j, n));
      slot_transpose(a, fi, i, q, fbar, v, vj, tn, true, dbar, adiff);
      gv = add3(gv, adiff);
      gp = sub3(gp, dbar);
    }
    const int l = i - d;     // right spring: slot (fi, l)
    if (l >= 0 && l < n) {
      const float3 vl = a.has_damping ? ld3(vel, l, n) : zero;
      const Slot q = slot_eval(a, fi, l, ld3(pos, l, n), vl, p, v, tn, cidx);
      const float3 fbar = add3(neg3(ld3(gf_in, l, n)), gfi);
      slot_transpose(a, fi, l, q, fbar, vl, v, tn, false, dbar, adiff);
      gv = add3(gv, neg3(adiff));
      gp = add3(gp, dbar);
    }
  }
  if (REM) {
    const RemBar rb = remainder_transpose(a.rem, i, n, pos, vel, gf_in, tn,
                                          cidx, a.grem);
    gp = add3(gp, rb.gp);
    gv = add3(gv, rb.gv);
  }
  if (pass == 2) {
    st3(a.gpc, i, n, gp);
    st3(a.gvc, i, n, gv);
  } else {
    st3(a.gpos, i, n, add3(ld3(a.gpos, i, n), gp));
    st3(a.gvel, i, n, add3(ld3(a.gvel, i, n), gv));
  }
}

// One launch of a phase, one thread per mass.
template <class A, bool REM>
__global__ void bwd_mid_kernel(A a, const float* pos, const float* vel,
                               int t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) bwd_mid_mass<A, REM>(a, pos, vel, t, i);
}
template <class A, bool REM>
__global__ void bwd_force_kernel(A a, const float* pos, const float* vel,
                                 int t, int pass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) bwd_force_mass<A, REM>(a, pos, vel, t, pass, i, a.gf);
}
template <class A, bool REM>
__global__ void bwd_spring_kernel(A a, const float* pos, const float* vel,
                                  int t, int pass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) bwd_spring_mass<A, REM>(a, pos, vel, t, pass, i, a.gf);
}

// Set the carry to the incoming cotangents and zero every gradient
// accumulator, on `st`.  Returns 0 or the first CUDA error.
template <class A>
int bwd_prologue(const A* c, cudaStream_t st) {
  cudaError_t err;
  const size_t n = static_cast<size_t>(c->n);
  const size_t v3 = 3 * n * sizeof(float);
  const size_t fam = static_cast<size_t>(c->nf) * n * sizeof(float);
  const cudaMemcpyKind d2d = cudaMemcpyDeviceToDevice;
  if ((err = cudaMemcpyAsync(c->gpos, c->gpos_in, v3, d2d, st)) ||
      (err = cudaMemcpyAsync(c->gvel, c->gvel_in, v3, d2d, st)) ||
      (err = cudaMemcpyAsync(c->gacc, c->gacc_in, v3, d2d, st))) {
    return (int)err;
  }
  float* zeroed[] = {c->gk, c->grest, c->gdamp, c->gomega, c->garate};
  for (float* p : zeroed) {
    if (p != nullptr && (err = cudaMemsetAsync(p, 0, fam, st))) return (int)err;
  }
  if ((err = cudaMemsetAsync(c->gcf, 0, v3, st)) ||
      (err = cudaMemsetAsync(c->gminv, 0, n * sizeof(float), st))) {
    return (int)err;
  }
  if (c->gdrag != nullptr &&
      (err = cudaMemsetAsync(c->gdrag, 0, n * sizeof(float), st))) {
    return (int)err;
  }
  if (c->gmag != nullptr &&
      (err = cudaMemsetAsync(c->gmag, 0, 4 * n * sizeof(float), st))) {
    return (int)err;
  }
  if (c->grem != nullptr &&
      (err = cudaMemsetAsync(c->grem, 0,
                             5 * static_cast<size_t>(c->rem.s) * sizeof(float),
                             st))) {
    return (int)err;
  }
  return 0;
}

// Which launches of reversed step t enqueue_reversed enqueues: all of
// them, or under RK2 the midpoint and pass 2 (kRk2b) or pass 1 (kRk2a),
// for a caller that runs the magnet glue's transpose between the two.
enum Part { kAll = 0, kRk2b = 1, kRk2a = 2 };

// The launches of reversed step t on `st`: two (five for RK2), with or
// without the remainder calls.  A trace entry holds c->np rows: pos, vel
// and, for a magnet scene (np 9, 12 under RK2: the layout of
// ops/fused_step.py::trace_rows), each force pass's constant
// force (const_f + that pass's magnet field), which replaces c->cforce
// for the pass.  With c->mag set, each pass's spring phase is followed by
// the pairwise field's transpose at that pass's positions
// (magnets_adjoint.cuh), which reads the pass's force cotangent gf and
// adds to the pass's position cotangent: the carry gpos, or gpc at the
// RK2 midpoint (before pass 1 reads it).  Returns 0 or the first error.
template <class A, bool REM>
int enqueue_reversed(const A* c, int t, int part, cudaStream_t st) {
  const size_t n = static_cast<size_t>(c->n);
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  const float* entry = c->trace + static_cast<size_t>(t) * c->np * n;
  const float* pos = entry;
  const float* vel = entry + 3 * n;
  A a = *c;
  if (c->np > 6) a.cforce = entry + 6 * n;
  cudaError_t err = cudaSuccess;
  auto mag_t = [&](const float* p, float* gp) {
    if (c->mag != nullptr && err == cudaSuccess) {
      err = titan_mag::launch_magnet_transpose(c->n, c->cutoff, p, c->mag,
                                               c->fixed, c->gf, gp, c->gmag,
                                               st);
    }
  };
  if (c->integrator == 2) {
    if (part != kRk2a) {
      bwd_mid_kernel<A, REM><<<blocks, threads, 0, st>>>(a, pos, vel, t);
      A a2 = a;
      if (c->np > 6) a2.cforce = entry + 9 * n;
      bwd_force_kernel<A, REM><<<blocks, threads, 0, st>>>(a2, c->pos_h,
                                                           c->vel_h, t, 2);
      bwd_spring_kernel<A, REM><<<blocks, threads, 0, st>>>(a2, c->pos_h,
                                                            c->vel_h, t, 2);
      err = cudaGetLastError();
      mag_t(c->pos_h, c->gpc);
    }
    if (part != kRk2b && err == cudaSuccess) {
      bwd_force_kernel<A, REM><<<blocks, threads, 0, st>>>(a, pos, vel, t,
                                                           1);
      bwd_spring_kernel<A, REM><<<blocks, threads, 0, st>>>(a, pos, vel, t,
                                                            1);
      err = cudaGetLastError();
      mag_t(pos, c->gpos);
    }
  } else {
    bwd_force_kernel<A, REM><<<blocks, threads, 0, st>>>(a, pos, vel, t, 0);
    bwd_spring_kernel<A, REM><<<blocks, threads, 0, st>>>(a, pos, vel, t, 0);
    err = cudaGetLastError();
    mag_t(pos, c->gpos);
  }
  return (int)err;
}

// The reverse sweep's launches on `st`: enqueue_reversed for each step
// from the last.  Returns 0 or the first CUDA error.
template <class A, bool REM>
int enqueue_sweep(const A* c, cudaStream_t st) {
  for (int t = c->seg - 1; t >= 0; --t) {
    const int rc = enqueue_reversed<A, REM>(c, t, kAll, st);
    if (rc != 0) return rc;
  }
  return 0;
}

// One part of reversed step t (Part) on `stream`, the sweep's prologue
// already run (bwd_prologue).  Returns 0 or the first CUDA error.
template <class A>
int enqueue_part(const A* c, int t, int part, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return c->rem.inc != nullptr ? enqueue_reversed<A, true>(c, t, part, st)
                               : enqueue_reversed<A, false>(c, t, part, st);
}

// Enqueue the reverse sweep over the trace ([seg, np, N]) on `stream`: two
// launches per step (five for RK2), and with c->mag one transpose per force
// pass.  Returns 0 or the first CUDA error.
template <class A>
int enqueue_bwd(const A* c, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = bwd_prologue(c, st);
  if (rc != 0) return rc;
  return c->rem.inc != nullptr ? enqueue_sweep<A, true>(c, st)
                               : enqueue_sweep<A, false>(c, st);
}

}  // namespace titan_adj

#endif  // TITAN_ADJOINT_BODY_CUH_
