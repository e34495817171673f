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
// s = fi N + l).  damping, aratedt and sstop are [F, N] planes in both.

#ifndef TITAN_ADJOINT_BODY_CUH_
#define TITAN_ADJOINT_BODY_CUH_

#include <cstddef>

#include <cuda_runtime.h>

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

// cf + the spring families' force on mass i at (pos, vel).
template <class A>
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
  return f;
}

// Planes, balls and drag after the spring sum f0: the force the
// integrator consumes (the forward's own code).
template <class A>
__device__ __forceinline__ float3 stages_fwd(const A& a, int i, float3 f,
                                             float3 p, float3 v) {
  return titan::contact_and_drag(a.n_planes, a.planes, a.n_balls, a.balls,
                                 a.normal_coeff, a.has_drag, a.drag, i, f, p,
                                 v);
}

// Transpose of the drag, ball and plane stages (reverse order) at (p, v)
// for the cotangents gf (on the final force; on return, on the spring
// sum) and gv (on the velocity; on return, including the stages' part).
// Returns the stages' gpos part; adds the drag gradient to *gdrag.
template <class A>
__device__ float3 stages_transpose(const A& a, int i, float3 f0, float3 p,
                                   float3 v, float3& gf, float3& gv,
                                   float* gdrag) {
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

// RK2: the midpoint (pos_h, vel_h) of mass i at step t from trace[t].
template <class A>
__device__ __forceinline__ void bwd_mid_mass(const A& a, const float* pos,
                                             const float* vel, int t, int i) {
  const int n = a.n;
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

// Phase A of mass i at (pos, vel): pass 0 = Euler / Verlet at trace[t],
// 2 = RK2 at the midpoint, 1 = RK2 at trace[t].  Recomputes the force,
// transposes the integrator and the stages, writes the cotangent on the
// spring sum to gf[3, N] and the partial carry to gpc / gvc, accumulates
// the cf, minv and drag gradients of mass i, and (pass != 2) writes the
// carry's non-spring part.
template <class A>
__device__ __forceinline__ void bwd_force_mass(const A& a, const float* pos,
                                               const float* vel, int t,
                                               int pass, int i, float* gf_out) {
  const int n = a.n;
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
  st3(gf_out, i, n, gf);
  st3(a.gpc, i, n, gp);
  st3(a.gvc, i, n, gvm);
  if (pass != 2) {
    st3(a.gpos, i, n, gpos_out);
    st3(a.gvel, i, n, gvel_out);
    st3(a.gacc, i, n, gacc_out);
  }
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
  const float k = a.k_at(fi, l, s);
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
      a.gomega[s] += scalebar * a.bsign_at(fi, l, s)
                     * cosf(a.bomega_at(fi, l, s) * t) * t;
    }
    a.gk[s] += gk;
    a.grest[s] += restbbar;
    if (a.has_damping) a.gdamp[s] += gdamp;
    if (a.has_actuated) a.garate[s] += restbbar * q.advc;
  }
}

// Phase B of mass i at (pos, vel): the spring families' transpose, with
// both incident springs of each family gathered and gf read from the
// phase-A output `gf_in`, then the carry.
template <class A>
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
  if (pass == 2) {
    st3(a.gpc, i, n, gp);
    st3(a.gvc, i, n, gv);
  } else {
    st3(a.gpos, i, n, add3(ld3(a.gpos, i, n), gp));
    st3(a.gvel, i, n, add3(ld3(a.gvel, i, n), gv));
  }
}

// One launch of a phase, one thread per mass.
template <class A>
__global__ void bwd_mid_kernel(A a, const float* pos, const float* vel,
                               int t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) bwd_mid_mass(a, pos, vel, t, i);
}
template <class A>
__global__ void bwd_force_kernel(A a, const float* pos, const float* vel,
                                 int t, int pass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) bwd_force_mass(a, pos, vel, t, pass, i, a.gf);
}
template <class A>
__global__ void bwd_spring_kernel(A a, const float* pos, const float* vel,
                                  int t, int pass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) bwd_spring_mass(a, pos, vel, t, pass, i, a.gf);
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
  return 0;
}

// Enqueue the reverse sweep over the trace ([seg, 6, N]) on `stream`: two
// launches per step (five for RK2).  Returns 0 or the first CUDA error.
template <class A>
int enqueue_bwd(const A* c, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = bwd_prologue(c, st);
  if (rc != 0) return rc;
  const size_t n = static_cast<size_t>(c->n);
  const A a = *c;
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  for (int t = c->seg - 1; t >= 0; --t) {
    const float* pos = c->trace + static_cast<size_t>(t) * 6 * n;
    const float* vel = pos + 3 * n;
    if (c->integrator == 2) {
      bwd_mid_kernel<A><<<blocks, threads, 0, st>>>(a, pos, vel, t);
      bwd_force_kernel<A><<<blocks, threads, 0, st>>>(a, c->pos_h, c->vel_h,
                                                      t, 2);
      bwd_spring_kernel<A><<<blocks, threads, 0, st>>>(a, c->pos_h, c->vel_h,
                                                       t, 2);
      bwd_force_kernel<A><<<blocks, threads, 0, st>>>(a, pos, vel, t, 1);
      bwd_spring_kernel<A><<<blocks, threads, 0, st>>>(a, pos, vel, t, 1);
    } else {
      bwd_force_kernel<A><<<blocks, threads, 0, st>>>(a, pos, vel, t, 0);
      bwd_spring_kernel<A><<<blocks, threads, 0, st>>>(a, pos, vel, t, 0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace titan_adj

#endif  // TITAN_ADJOINT_BODY_CUH_
