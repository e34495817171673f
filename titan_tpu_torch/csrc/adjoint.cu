// The adjoint's two kernels for NVIDIA Hopper (sm_90a): the trace replay
// and the reverse sweep of one segment of a differentiable rollout.
//
// Replaces the TPU kernels titan_tpu/ops/adjoint.py::_build_trace_kernel
// (launched by build_trace_run) and ::_build_bwd_kernel (build_bwd_run).
// Their plain PyTorch versions, which the card's results are held against,
// are titan_tpu_torch/ops/adjoint.py::trace_run_plain and ::bwd_run_plain;
// the math is backward_step / _force_transpose there (sqrt + divide form).
//
// Trace.  The segment's forward, replayed one launch per step (two for
// RK2) with the step body of csrc/fused_step.cu (csrc/step_body.cuh), so
// that it is bitwise the forward chunk; the first evaluation of step t also
// writes its input (pos_t, vel_t) to trace[t] ([seg, 6, N]: pos rows, then
// vel rows).  ACTUATED rest advances step by step here, as in the forward.
//
// Backward.  One thread per mass; for each step t from seg - 1 down to 0:
//   A (bwd_force_kernel): thread i recomputes its force from trace[t]
//     with step_body.cuh's spring, contact and drag code (both incident
//     springs per family, closed-form ACTUATED rest as the JAX package's
//     transpose does), then the integrator transpose and the
//     drag, ball and plane transposes in reverse order.  It writes the
//     cotangent on the spring-sum force gf[3, N] and its partial gpos /
//     gvel, and accumulates the cf, minv and drag gradients of mass i.
//   B (bwd_spring_kernel): thread i transposes both incident springs of
//     each family, (i, i + d) and (i - d, i), with fbar = gf[right] -
//     gf[left], and finishes the carry (gpos, gvel).  The gradients of slot
//     (f, i) (k, rest, damping, omega, aratedt) belong to spring (i, i + d)
//     and only thread i writes them: no atomics, deterministic.
//   RK2 adds a launch that materialises the midpoint (pos_h, vel_h) of
//   every mass, then A/B at the midpoint (pass 2), then A/B at trace[t]
//   (pass 1): five launches per step.
// A partner index outside [0, N) (negative deltas) is a masked slot: it
// adds nothing, and its k / damping / rate gradients are masked by pair_ok
// in assemble_ct, as the TPU roll's wrapped k = 0 lanes are.  The carry is
// updated in place (each thread reads and writes only its own mass's
// entries); gf, the partial gpos / gvel and the midpoint live in scratch.
//
// Bound.  The sweep must read the trace (24 B per mass per step; a
// 100-step segment at 43^3 is 191 MB, more than the 50 MB L2) and do the
// arithmetic of a force recompute and its transpose, ~22 + ~40 operations
// per spring and ~70 per mass and step.  At 43^3 that is ~0.6 us of trace
// traffic and ~1.0 us of f32 arithmetic per step, so operations bound it.
// This first version re-reads neighbours' state and gf from L2 in both
// launches and recomputes each spring four times per step (two endpoints,
// two launches); like the forward kernel it is bound in practice by each
// thread's serial chain of gathers.  The trace kernel is the forward step
// plus a 24 B per mass store, so the 0.57 us of trace writes bound it.
//
// Rounding.  Built with -fmad=false and without --use_fast_math, as
// fused_step.cu.  The backward sums each step's RK2 pass-2 and pass-1
// gradients into its accumulators one after the other where the plain
// version adds the two first, so RK2 gradients agree to rounding, not
// bitwise.  The RK2 midpoint is the forward's (a frozen mass is selected),
// where the plain version blends x * (1 - fixed) + x0 * fixed: the two
// differ at most in the sign of a zero.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include "step_body.cuh"

// Arguments of one segment's backward, passed by value to every launch;
// field order matches the ctypes structure _BwdArgs in
// titan_tpu_torch/ops/adjoint.py.  The carry (gpos, gvel, gacc) is
// updated in place; gf, gpc, gvc, pos_h and vel_h are scratch.
struct BwdChunkArgs {
  int n, nf, n_planes, n_balls, seg, integrator;  // 0 Euler, 1 Verlet, 2 RK2
  int clamp, has_damping, has_breathing, has_actuated, has_drag, device;
  float normal_coeff;
  const int* deltas;
  const float* scal;
  const float* planes;
  const float* balls;
  const float* cforce;
  const float* minv;
  const float* fixed;
  const float* k;
  const float* rest;
  const float* damping;
  const float* bsign;
  const float* bomega;
  const float* aratedt;
  const float* sstop;
  const float* drag;
  const float* trace;
  const float* gpos_in;
  const float* gvel_in;
  const float* gacc_in;
  float* gpos;
  float* gvel;
  float* gacc;
  float* gk;
  float* grest;
  float* gdamp;
  float* gomega;
  float* garate;
  float* gcf;
  float* gminv;
  float* gdrag;
  float* gf;
  float* gpc;
  float* gvc;
  float* pos_h;
  float* vel_h;
};

namespace {

using titan::add3;
using titan::dot3;
using titan::ld3;
using titan::mul3;
using titan::st3;
using titan::sub3;

__global__ void adjoint_trace_kernel(titan::StepArgs a, int mode,
                                     float* trace) {
  titan::step_body(a, mode, trace);
}

__device__ __forceinline__ float3 neg3(float3 a) {
  return make_float3(-a.x, -a.y, -a.z);
}
__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// t and the closed-form actuation call count of evaluation `call` (1, or
// 2 for the RK2 midpoint) of step t, as the plain version computes them.
__device__ __forceinline__ float eval_time(const BwdChunkArgs& a, int t,
                                           int call) {
  const float dt = a.scal[0];
  const float tn = a.scal[1] + (float)t * dt;
  return call == 2 ? tn + 0.5f * dt : tn;
}
__device__ __forceinline__ float eval_cidx(const BwdChunkArgs& a, int t,
                                           int call) {
  const float base = a.integrator == 2 ? 2.f * (float)t : (float)t;
  return base + (float)call;
}

// One spring slot at an evaluation point: the forward's intermediates,
// with the closed-form ACTUATED rest.
struct Slot : titan::Spring {
  float rest, rest_b, scale, advc;
};

__device__ __forceinline__ Slot slot_eval(const BwdChunkArgs& a, int s,
                                          float3 pl, float3 vl, float3 pr,
                                          float3 vr, float t, float cidx) {
  Slot q;
  q.rest_b = a.rest[s];
  q.advc = 0.f;
  if (a.has_actuated) {
    q.advc = fminf(cidx, a.sstop[s]);
    q.rest_b = q.rest_b + q.advc * a.aratedt[s];
  }
  q.scale = 1.f;
  q.rest = q.rest_b;
  if (a.has_breathing) {
    q.scale = titan::breath_scale(a.bsign[s], a.bomega[s], t);
    q.rest = q.rest_b * q.scale;
  }
  static_cast<titan::Spring&>(q) = titan::spring_eval(
      a.k[s], q.rest, a.has_damping, a.has_damping ? a.damping[s] : 0.f, pl,
      vl, pr, vr);
  return q;
}

// cf + the spring families' force on mass i at (pos, vel).
__device__ float3 spring_sum(const BwdChunkArgs& a, int i, const float* pos,
                             const float* vel, float3 p, float3 v, float t,
                             float cidx) {
  const int n = a.n;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 f = ld3(a.cforce, i, n);
  for (int fi = 0; fi < a.nf; ++fi) {
    const int d = a.deltas[fi];
    const int base = fi * n;
    const int j = i + d;
    if (j >= 0 && j < n) {
      const Slot q = slot_eval(a, base + i, p, v, ld3(pos, j, n),
                               a.has_damping ? ld3(vel, j, n) : zero, t, cidx);
      f = sub3(f, mul3(q.diff, q.cm * q.inv));
    }
    const int l = i - d;
    if (l >= 0 && l < n) {
      const Slot q = slot_eval(a, base + l, ld3(pos, l, n),
                               a.has_damping ? ld3(vel, l, n) : zero, p, v, t,
                               cidx);
      f = add3(f, mul3(q.diff, q.cm * q.inv));
    }
  }
  return f;
}

// Planes, balls and drag after the spring sum f0: the force the
// integrator consumes (the forward's own code).
__device__ __forceinline__ float3 stages_fwd(const BwdChunkArgs& a, int i,
                                             float3 f, float3 p, float3 v) {
  return titan::contact_and_drag(a.n_planes, a.planes, a.n_balls, a.balls,
                                 a.normal_coeff, a.has_drag, a.drag, i, f, p,
                                 v);
}

// Transpose of the drag, ball and plane stages (reverse order) at (p, v)
// for the cotangents gf (on the final force; on return, on the spring
// sum) and gv (on the velocity; on return, including the stages' part).
// Returns the stages' gpos part; adds the drag gradient to *gdrag.
__device__ float3 stages_transpose(const BwdChunkArgs& a, int i, float3 f0,
                                   float3 p, float3 v, float3& gf,
                                   float3& gv, float* gdrag) {
  const float nc = a.normal_coeff;
  float3 gp = make_float3(0.f, 0.f, 0.f);
  if (a.has_drag) {
    const float sq = dot3(v, v);
    const float vn = sq > 0.f ? sqrtf(sq) : 1.f;
    const float vnm = sq > 0.f ? vn : 0.f;
    const float dotv = dot3(v, gf);
    const float w = sq > 0.f ? dotv / vn : 0.f;
    const float dr = a.drag[i];
    gv = make_float3(gv.x - dr * (vnm * gf.x + w * v.x),
                     gv.y - dr * (vnm * gf.y + w * v.y),
                     gv.z - dr * (vnm * gf.z + w * v.z));
    *gdrag = -(vnm * dotv);
  }
  for (int bi = a.n_balls - 1; bi >= 0; --bi) {
    const float* b = a.balls + 4 * bi;
    const float3 dv = make_float3(p.x - b[0], p.y - b[1], p.z - b[2]);
    const float dist = sqrtf(dot3(dv, dv));
    const float safe = dist > 0.f ? dist : 1.f;
    const bool active = dist <= b[3] && dist > 0.f;
    const float push = active ? nc / safe : 0.f;
    const float gpush = dot3(dv, gf);
    float3 gd = mul3(gf, push);
    const float gdist = active ? -nc * gpush / (safe * safe) : 0.f;
    gd = add3(gd, mul3(dv, gdist / safe));
    gp = add3(gp, gd);
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
    // inside and with friction: the select takes the friction branch
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
    gv_perp = add3(gv_perp,
                   mul3(vp, v_norm > 0.f ? gv_norm / safe_vn : 0.f));
    gv = add3(gv, gv_perp);                          // vp = v - (v.n) n
    const float gvdotn = -dot3(nv, gv_perp);
    gv = add3(gv, mul3(nv, gvdotn));
    const float gfn_mag = dot3(gf_n, nv) + signf(fn_mag) * gfn_abs;
    gf = add3(g, mul3(nv, gfn_mag));
  }
  return gp;
}

// RK2: the midpoint (pos_h, vel_h) of step t from trace[t].
__global__ void bwd_mid_kernel(BwdChunkArgs a, const float* pos,
                               const float* vel, int t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n;
  if (i >= n) return;
  const float tn = eval_time(a, t, 1);
  const float cidx = eval_cidx(a, t, 1);
  const float3 p = ld3(pos, i, n), v = ld3(vel, i, n);
  const float3 f1 =
      stages_fwd(a, i, spring_sum(a, i, pos, vel, p, v, tn, cidx), p, v);
  float3 ph, vh;
  titan::rk2_midpoint(p, v, mul3(f1, a.minv[i]), a.scal[0],
                      a.fixed[i] != 0.f, ph, vh);
  st3(a.pos_h, i, n, ph);
  st3(a.vel_h, i, n, vh);
}

// Launch A at (pos, vel): pass 0 = Euler / Verlet at trace[t], 2 = RK2 at
// the midpoint, 1 = RK2 at trace[t].
__global__ void bwd_force_kernel(BwdChunkArgs a, const float* pos,
                                 const float* vel, int t, int pass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n;
  if (i >= n) return;
  const int call = pass == 2 ? 2 : 1;
  const float tn = eval_time(a, t, call);
  const float cidx = eval_cidx(a, t, call);
  const float3 p = ld3(pos, i, n), v = ld3(vel, i, n);
  const float3 f0 = spring_sum(a, i, pos, vel, p, v, tn, cidx);
  const float3 ff = stages_fwd(a, i, f0, p, v);
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
        const float3 v1 = add3(v, mul3(mul3(ff, minv), dt));
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
  const float3 gp = stages_transpose(a, i, f0, p, v, gf, gvm, &gdrag);
  if (a.has_drag) a.gdrag[i] += gdrag;
  a.gcf[i] += gf.x;
  a.gcf[n + i] += gf.y;
  a.gcf[2 * n + i] += gf.z;
  st3(a.gf, i, n, gf);
  st3(a.gpc, i, n, gp);
  st3(a.gvc, i, n, gvm);
  if (pass != 2) {
    st3(a.gpos, i, n, gpos_out);
    st3(a.gvel, i, n, gvel_out);
    st3(a.gacc, i, n, gacc_out);
  }
}

// The transpose of slot s (left endpoint l, right r) for the force
// cotangent fbar on its right endpoint: returns dbar (the right endpoint's
// gpos part; the left gets its negative) and abar * diff (the left
// endpoint's gvel part; the right gets its negative) and, when `own`, adds
// the slot's parameter gradients.
__device__ __forceinline__ void slot_transpose(const BwdChunkArgs& a, int s,
                                               const Slot& q, float3 fbar,
                                               float3 vl, float3 vr,
                                               float t, bool own,
                                               float3& dbar, float3& adiff) {
  const float k = a.k[s];
  const float cbar = dot3(fbar, q.diff);
  dbar = mul3(fbar, q.cm * q.inv);
  const float magbar = cbar * q.inv;
  float invbar = cbar * q.cm;
  const float gk = magbar * (q.rest - q.ln);
  const float resteffbar = magbar * k;
  float lnbar = -magbar * k;
  adiff = make_float3(0.f, 0.f, 0.f);
  float gdamp = 0.f;
  if (a.has_damping) {
    const float axialbar = magbar * a.damping[s];
    const float abar = axialbar * q.inv;
    invbar = invbar + axialbar * q.ax;
    gdamp = magbar * (q.ax * q.inv);
    dbar = add3(dbar, mul3(sub3(vl, vr), abar));
    adiff = mul3(q.diff, abar);
  }
  lnbar = lnbar - (q.ln > 0.f ? invbar * q.inv * q.inv : 0.f);
  const float d2bar = q.inv > 0.f ? 0.5f * lnbar * q.inv : 0.f;
  dbar = add3(dbar, make_float3(2.f * q.diff.x * d2bar, 2.f * q.diff.y * d2bar,
                                2.f * q.diff.z * d2bar));
  if (own) {
    float restbbar = resteffbar;
    if (a.has_breathing) {  // rest_eff = rest_b * scale
      restbbar = resteffbar * q.scale;
      const float scalebar = resteffbar * q.rest_b;
      a.gomega[s] += scalebar * a.bsign[s] * cosf(a.bomega[s] * t) * t;
    }
    a.gk[s] += gk;
    a.grest[s] += restbbar;
    if (a.has_damping) a.gdamp[s] += gdamp;
    if (a.has_actuated) a.garate[s] += restbbar * q.advc;
  }
}

// Launch B at (pos, vel): the spring families' transpose, then the carry.
__global__ void bwd_spring_kernel(BwdChunkArgs a, const float* pos,
                                  const float* vel, int t, int pass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n;
  if (i >= n) return;
  const int call = pass == 2 ? 2 : 1;
  const float tn = eval_time(a, t, call);
  const float cidx = eval_cidx(a, t, call);
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  const float3 p = ld3(pos, i, n), v = ld3(vel, i, n);
  const float3 gfi = ld3(a.gf, i, n);
  float3 gp = ld3(a.gpc, i, n);
  float3 gv = ld3(a.gvc, i, n);
  for (int fi = 0; fi < a.nf; ++fi) {
    const int d = a.deltas[fi];
    const int base = fi * n;
    float3 dbar, adiff;
    const int j = i + d;     // left spring: slot (fi, i), owned here
    if (j >= 0 && j < n) {
      const float3 vj = a.has_damping ? ld3(vel, j, n) : zero;
      const Slot q = slot_eval(a, base + i, p, v, ld3(pos, j, n), vj, tn,
                               cidx);
      const float3 fbar = add3(neg3(gfi), ld3(a.gf, j, n));
      slot_transpose(a, base + i, q, fbar, v, vj, tn, true, dbar, adiff);
      gv = add3(gv, adiff);
      gp = sub3(gp, dbar);
    }
    const int l = i - d;     // right spring: slot (fi, l)
    if (l >= 0 && l < n) {
      const float3 vl = a.has_damping ? ld3(vel, l, n) : zero;
      const Slot q = slot_eval(a, base + l, ld3(pos, l, n), vl, p, v, tn,
                               cidx);
      const float3 fbar = add3(neg3(ld3(a.gf, l, n)), gfi);
      slot_transpose(a, base + l, q, fbar, vl, v, tn, false, dbar, adiff);
      gv = add3(gv, neg3(adiff));
      gp = add3(gp, dbar);
    }
  }
  if (pass == 2) {
    st3(a.gpc, i, n, gp);
    st3(a.gvc, i, n, gv);
  } else {
    st3(a.gpos, i, n, add3(ld3(a.gpos, i, n), gp));
    st3(a.gvel, i, n, add3(ld3(a.gvel, i, n), gv));
  }
}

}  // namespace


// Enqueue the segment's replay on `stream`, writing step t's input
// (pos_t, vel_t) to trace + t * 6 N.  Returns 0 or the first CUDA error.
extern "C" int titan_adjoint_trace(const ChunkArgs* c, float* trace,
                                   void* stream) {
  const size_t slot = 6 * static_cast<size_t>(c->n);
  return titan::enqueue_chunk(
      c, stream,
      [=](int blocks, int threads, cudaStream_t st, const titan::StepArgs& a,
          int mode, int s, bool first) -> cudaError_t {
        adjoint_trace_kernel<<<blocks, threads, 0, st>>>(
            a, mode, first ? trace + s * slot : nullptr);
        return cudaGetLastError();
      });
}

// Enqueue the reverse sweep over the trace on `stream`: two launches per
// step (five for RK2).  Returns 0 or the first CUDA error.
extern "C" int titan_adjoint_bwd(const BwdChunkArgs* c, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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

  const BwdChunkArgs a = *c;
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  for (int t = c->seg - 1; t >= 0; --t) {
    const float* pos = c->trace + static_cast<size_t>(t) * 6 * n;
    const float* vel = pos + 3 * n;
    if (c->integrator == 2) {
      bwd_mid_kernel<<<blocks, threads, 0, st>>>(a, pos, vel, t);
      bwd_force_kernel<<<blocks, threads, 0, st>>>(a, c->pos_h, c->vel_h, t,
                                                   2);
      bwd_spring_kernel<<<blocks, threads, 0, st>>>(a, c->pos_h, c->vel_h, t,
                                                    2);
      bwd_force_kernel<<<blocks, threads, 0, st>>>(a, pos, vel, t, 1);
      bwd_spring_kernel<<<blocks, threads, 0, st>>>(a, pos, vel, t, 1);
    } else {
      bwd_force_kernel<<<blocks, threads, 0, st>>>(a, pos, vel, t, 0);
      bwd_spring_kernel<<<blocks, threads, 0, st>>>(a, pos, vel, t, 0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
