// The per-mass body of the tiled step (csrc/tiled_step.cu): one force
// evaluation of mass i and its integrate tail, for each mode of the TPU
// kernel it replaces (titan_tpu/ops/pallas_tiled.py::_build_kernel: single
// (Euler or Verlet), rk2a, rk2b).  Kept in a header so that a later trace
// kernel (the tiled adjoint's forward replay, mode megatrace) can replay it
// bitwise, as csrc/step_body.cuh serves csrc/adjoint.cu.  What the step
// computes, and why it is laid out this way, is set out at the top of
// csrc/tiled_step.cu.

#ifndef TITAN_TILED_BODY_CUH_
#define TITAN_TILED_BODY_CUH_

#include <cstddef>

#include <cuda_runtime.h>

#include "step_body.cuh"

namespace titan_tiled {

using titan::add3;
using titan::dot3;
using titan::ld3;
using titan::mul3;
using titan::st3;
using titan::sub3;

// The int32 existence bitmask holds one bit per family.
constexpr int kMaxFamilies = 32;

// kEuler and kVerlet are the TPU kernel's "single" mode; kRk2a / kRk2b its
// RK2 predictor and corrector launches.
enum Mode { kEuler = 0, kVerlet = 1, kRk2a = 2, kRk2b = 3 };

// What stays the same over a chunk; field order matches the ctypes
// structure _TiledArgs in titan_tpu_torch/ops/tiled_step.py.  A per-family
// field rides either as a scalar of `fparams` (family-uniform) or as an
// [F, N] plane; a null plane pointer selects the scalar.
struct TiledArgs {
  int n, nf, n_planes, n_balls;
  int clamp, has_damping, has_breathing, has_actuated, has_drag;
  float normal_coeff;
  int deltas[kMaxFamilies];
  const float* scal;     // [2]: dt, t at chunk start
  const float* fparams;  // [5, F]: k, rest, damping, bsign, bomega scalars
  const float* planes;   // [P, 6]: normal xyz, offset, fk, fs
  const float* balls;    // [B, 4]: center xyz, radius
  const int* bits;       // [N] bit f = family f's spring exists (uniform k)
  const float* k;        // [F, N] validity-folded, or null (uniform)
  const float* rest;     // [F, N] or null (uniform, not actuated)
  const float* aratedt;  // [F, N] signed rate * dt (actuated only)
  const float* sstop;    // [F, N] advance count at the bound (actuated)
  const float* damping;  // [F, N] validity-folded (has_damping only)
  const float* bsign;    // [F, N] or null (uniform type)
  const float* bomega;   // [F, N] or null (uniform omega)
  const float* cforce;   // [3, N] m g + persistent external force
  const float* minv;     // [N]
  const float* fixed;    // [N] 1 = frozen (fixed or invalid), else 0
  const float* drag;     // [N] (has_drag only)
  titan::LocalSlots local;  // per-mass local-constraint slots
  titan::Remainder rem;     // remainder springs (closed-form rest; read
                            // by the per-step kernels' REM instantiation)
};

// The state one force evaluation reads and its update writes.
struct StepIO {
  int step;           // absolute step index inside the chunk
  const float* pos;   // [3, N] state the forces are evaluated at
  const float* vel;
  const float* acc;   // previous acc (Verlet)
  const float* pos0;  // [3, N] state at the start of the step (rk2b)
  const float* vel0;
  float* pos_dst;
  float* vel_dst;
  float* acc_dst;     // null: acc is not written (rk2a, and Euler/RK2 mega
                      // steps before the segment's last)
  // RK2 with local constraints: rk2a stores pass 1's mutated velocity in
  // v1_dst and rk2b starts its corrector from v1 (else from vel0)
  float* v1_dst;
  const float* v1;
};

// Slot (fi, s): the spring from left mass s to right mass s + d_fi, at
// (pl, vl) and (pr, vr).  Returns its force on the right endpoint (the
// left one gets the negative), in the TPU body's operation order
// (family_forces, pallas_tiled.py:673-738, non-rsqrt branch): closed-form
// ACTUATED rest, then breathing at t, Hooke, axial damping.
__device__ __forceinline__ float3 tiled_spring(const TiledArgs& a, int fi,
                                               int s, float3 pl, float3 vl,
                                               float3 pr, float3 vr, float t,
                                               float adv_base) {
  const size_t slot = static_cast<size_t>(fi) * a.n + s;
  const int nf = a.nf;
  const float3 diff = sub3(pr, pl);
  const float d2 = dot3(diff, diff);
  const float ln = d2 > 0.f ? sqrtf(d2) : 0.f;
  const float inv = ln > 0.f ? 1.f / ln : 0.f;
  const float k = a.k != nullptr
                      ? a.k[slot]
                      : __fmul_rn(a.fparams[fi],
                                  static_cast<float>((a.bits[s] >> fi) & 1));
  float rest = a.rest != nullptr ? a.rest[slot] : a.fparams[nf + fi];
  if (a.has_actuated) {
    // rest at this evaluation: min(adv_base + 1, s_stop) advances of
    // rate * dt from the chunk's start (pallas_tiled.py:41-51)
    const float adv = fminf(adv_base + 1.f, a.sstop[slot]);
    rest = rest + adv * a.aratedt[slot];
  }
  if (a.has_breathing) {
    const float bsign = a.bsign != nullptr ? a.bsign[slot]
                                           : a.fparams[3 * nf + fi];
    const float bomega = a.bomega != nullptr ? a.bomega[slot]
                                             : a.fparams[4 * nf + fi];
    rest = rest * (1.f + bsign * sinf(bomega * t));
  }
  float mag = k * (rest - ln);
  if (a.has_damping) {
    const float axial = dot3(sub3(vl, vr), diff) * inv;
    mag = mag + axial * a.damping[slot];
  }
  return mul3(diff, mag * inv);
}

// The family sum "- left + right" from zero of mass i at (p, v), its
// partners read from device memory (pos, vel).
__device__ __forceinline__ float3 tiled_families(const TiledArgs& a, int i,
                                                 const float* pos,
                                                 const float* vel, float t,
                                                 float adv_base, float3 p,
                                                 float3 v) {
  const int n = a.n;
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  float3 fw = zero;
  for (int fi = 0; fi < a.nf; ++fi) {
    const int d = a.deltas[fi];
    const int j = i + d;
    if (j >= 0 && j < n) {
      const float3 vj = a.has_damping ? ld3(vel, j, n) : zero;
      fw = sub3(fw, tiled_spring(a, fi, i, p, v, ld3(pos, j, n), vj, t,
                                 adv_base));
    }
    const int l = i - d;
    if (l >= 0 && l < n) {
      const float3 vl = a.has_damping ? ld3(vel, l, n) : zero;
      fw = add3(fw, tiled_spring(a, fi, l, ld3(pos, l, n), vl, p, v, t,
                                 adv_base));
    }
  }
  return fw;
}

// The force on mass i at state (pos, vel), at its position p and velocity
// v, given the family sum fw: per family "- left + right" from zero (the
// TPU's fw - f + roll_scatter(f, d); tiled_families, or the plain-spring
// loop, step_body.cuh::plain_family_sum), then the constant
// force (f_acc = fw + const_f, pallas_tiled.py:740) with the remainder
// springs' sum added to it (const_f + remainder: the TPU feeds them in as
// per-step glue through its constant-force input, pallas_tiled.py:1609-
// 1640; here they run in the kernel, step_body.cuh::remainder_forces, with
// the closed-form ACTUATED rest of the families),
// then the global planes, balls, the per-mass local constraints and drag
// (mass_tail :748).  The TPU glue zeroes the remainder on fixed masses;
// a frozen mass's force reaches no output here, so it is left as it is.
// `vm` receives the velocity the local constraints leave.  A slot whose
// partner lies outside [0, N) is skipped: the TPU evaluates it with k = 0
// and adds a zero.  REM compiles the remainder call in (the per-step
// kernels of a scene with remainder springs): out of line behind a null
// check, its call site cost the resident grids and the other scenes'
// launches 13-15% (PERF.md section 6).
template <bool REM>
__device__ __forceinline__ float3 tiled_force(const TiledArgs& a, int i,
                                              const float* pos,
                                              const float* vel, float t,
                                              float adv_base, float3 p,
                                              float3 v, float3 fw,
                                              float3& vm) {
  const int n = a.n;
  float3 cf = ld3(a.cforce, i, n);
  if (REM) {
    cf = add3(cf, titan::remainder_forces(a.rem, i, n, pos, vel, t,
                                          a.scal[0], adv_base + 1.f));
  }
  const float3 f = add3(fw, cf);
  vm = v;
  return titan::contact_and_drag(a.n_planes, a.planes, a.n_balls, a.balls,
                                 a.local, a.normal_coeff, a.has_drag, a.drag,
                                 i, n, f, p, vm);
}

// x * keep + y * frozen, the TPU's arithmetic select of frozen masses
__device__ __forceinline__ float3 blend3(float3 x, float keep, float3 y,
                                         float frozen) {
  return add3(mul3(x, keep), mul3(y, frozen));
}

// One force evaluation and update of mass i in mode MODE
// (pallas_tiled.py:852-930): t and the actuation count follow the step
// index, t0 + step dt (+ dt / 2 for the corrector) and step (2 step, 2 step
// + 1 under RK2, whose rest advances once per force pass).  The update
// reads the velocity the local constraints leave (vm); frozen masses keep
// the pass's input velocity, except at the RK2 midpoint, which keeps vm.
// p is the mass's position, families(t, adv_base, v) its family sum.
template <int MODE, bool REM, class Families>
__device__ __forceinline__ void tiled_mass_with(const TiledArgs& a,
                                                const StepIO& io, int i,
                                                float3 p, Families families) {
  const int n = a.n;
  const float dt = a.scal[0];
  const float fstep = static_cast<float>(io.step);
  float t, adv_base;
  if (MODE == kRk2b) {
    t = __fadd_rn(a.scal[1], __fmul_rn(__fadd_rn(fstep, 0.5f), dt));
    adv_base = __fadd_rn(__fmul_rn(2.f, fstep), 1.f);
  } else {
    t = __fadd_rn(a.scal[1], __fmul_rn(fstep, dt));
    adv_base = MODE == kRk2a ? __fmul_rn(2.f, fstep) : fstep;
  }
  const float3 v = ld3(io.vel, i, n);
  float3 vm;
  const float3 f = tiled_force<REM>(a, i, io.pos, io.vel, t, adv_base, p, v,
                                    families(t, adv_base, v), vm);
  const float frozen = a.fixed[i];
  const float keep = 1.f - frozen;
  const float3 acc = mul3(f, a.minv[i]);

  if (MODE == kRk2a) {  // midpoint predictor (sim.cu:1336-1343)
    const float3 ph = make_float3(p.x + 0.5f * vm.x * dt,
                                  p.y + 0.5f * vm.y * dt,
                                  p.z + 0.5f * vm.z * dt);
    const float3 vh = make_float3(vm.x + 0.5f * acc.x * dt,
                                  vm.y + 0.5f * acc.y * dt,
                                  vm.z + 0.5f * acc.z * dt);
    st3(io.pos_dst, i, n, blend3(ph, keep, p, frozen));
    st3(io.vel_dst, i, n, blend3(vh, keep, vm, frozen));
    if (io.v1_dst != nullptr) st3(io.v1_dst, i, n, vm);
    return;
  }
  float3 v2, p2;
  if (MODE == kRk2b) {  // corrector from the step's input (1344-1349)
    // from pass 1's mutated velocity; the position with pass 2's
    const float3 v0 = ld3(io.vel0, i, n);
    const float3 p0 = ld3(io.pos0, i, n);
    const float3 vb = io.v1 != nullptr ? ld3(io.v1, i, n) : v0;
    v2 = blend3(make_float3(vb.x + acc.x * dt, vb.y + acc.y * dt,
                            vb.z + acc.z * dt),
                keep, v0, frozen);
    p2 = add3(p0, mul3(mul3(vm, dt), keep));
  } else if (MODE == kVerlet) {  // reference 'Verlet' (sim.cu:1350-1354)
    const float3 a0 = ld3(io.acc, i, n);
    v2 = make_float3(vm.x + 0.5f * (a0.x + acc.x) * dt,
                     vm.y + 0.5f * (a0.y + acc.y) * dt,
                     vm.z + 0.5f * (a0.z + acc.z) * dt);
    v2 = blend3(v2, keep, v, frozen);
    p2 = add3(p, mul3(make_float3(v2.x * dt + 0.5f * acc.x * dt * dt,
                                  v2.y * dt + 0.5f * acc.y * dt * dt,
                                  v2.z * dt + 0.5f * acc.z * dt * dt),
                      keep));
  } else {  // Euler with the optional unit-speed clamp (sim.cu:1355-1362)
    v2 = make_float3(vm.x + acc.x * dt, vm.y + acc.y * dt, vm.z + acc.z * dt);
    if (a.clamp) {
      const float vn = sqrtf(dot3(v2, v2));
      if (vn > 1.f) v2 = make_float3(v2.x / vn, v2.y / vn, v2.z / vn);
    }
    v2 = blend3(v2, keep, v, frozen);
    p2 = add3(p, mul3(mul3(v2, dt), keep));
  }
  st3(io.pos_dst, i, n, p2);
  st3(io.vel_dst, i, n, v2);
  // frozen masses get acc 0 here; the chunk restores their old acc
  if (io.acc_dst != nullptr) st3(io.acc_dst, i, n, mul3(acc, keep));
}

// tiled_mass_with the family sum from device memory: every kernel of a
// scene off the plain-spring path.
template <int MODE, bool REM = false>
__device__ __forceinline__ void tiled_mass(const TiledArgs& a,
                                           const StepIO& io, int i) {
  const float3 p = ld3(io.pos, i, a.n);
  tiled_mass_with<MODE, REM>(
      a, io, i, p, [&](float t, float adv_base, float3 v) {
        return tiled_families(a, i, io.pos, io.vel, t, adv_base, p, v);
      });
}

}  // namespace titan_tiled

#endif  // TITAN_TILED_BODY_CUH_
