// Fused multi-step mass-spring chunk for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel titan_tpu/ops/pallas_step.py::_build_kernel
// (launched by build_pallas_chunk): n whole steps of stencil-family springs
// (Hooke + axial damping, breathing, ACTUATED_* rest), the constant force
// (gravity + persistent external force), global contact planes with static
// and kinetic friction, balls, quadratic drag and the Euler (clamp on/off),
// Verlet or RK2 update, with fixed and invalid masses frozen.  The plain
// PyTorch version of the same function, which the card's results are held
// against, is titan_tpu_torch/ops/fused_step.py::fused_chunk_plain.
// Remainder springs, in-kernel magnets and local constraints are not in
// this kernel yet (fused_reject_reason sends such scenes to the eager step).
//
// Design.  One thread per mass.  Family f connects mass n to n + d_f; each
// thread evaluates, per family, its left spring (slot (f, i), partner i + d)
// and its right spring (slot (f, i - d)), so every spring is evaluated by
// both endpoints: no atomics, and the sum order is fixed (const force, then
// per family "- left + right", as the TPU kernel's f_acc - f + roll(f, d)).
// An index outside [0, N) is a masked slot (the TPU roll's wrap-around lanes
// carry k = 0); d may be negative.  One launch per step (two for RK2: the
// corrector reads the neighbours' half-step state), all issued on the
// caller's stream by one host call.  pos/vel/acc ping-pong between the
// output and scratch buffers so that the last step lands in the outputs and
// the inputs are never written; actuated rest ping-pongs too, because the
// right-endpoint thread must read the pre-step rest of a slot whose left
// thread writes the new one.
//
// Bound.  As one launch per step this design reads, each step, pos, vel,
// const_f (3 floats each), minv, fixed (1 each) and k, rest (13 each at
// 43^3) and writes pos, vel, acc: 184 B per mass, ~14.6 MB per step, which
// fits in the 50 MB L2 across steps.  What a chunk must move is
// far less: its inputs once and its outputs once, spread over its steps.
// So the least time per step is the arithmetic, ~22 ops per spring and
// ~25 per mass, 0.35 us per step at 43^3 at 67 TFLOP/s f32.  The kernel is
// held back by the latency of each thread's chain of ~26 gathers, not by
// bytes: its time barely changes from 8,064 to 79,616 masses.
// Next steps: more independent loads in flight per thread (restrict
// pointers, families unrolled with compile-time feature flags),
// family-uniform k/rest as scalars instead of [F, N] planes, then the chunk
// as a CUDA graph or one persistent kernel with a grid barrier per step.
//
// Rounding.  Built without --use_fast_math (sqrtf, 1/x and sinf stay IEEE)
// and with -fmad=false, so that each multiply and add rounds on its own as
// in the plain PyTorch version, and the two agree bitwise.  Built with
// contraction on, on an H100 (scripts/cuda_fmad_ab.py), the kernel left
// the 1e-5 it is held to in 6 of the 12 small scenes (up to 5.6e-5 of
// velocity after 100 steps) and in both landed main-path scenes (3.5e-4 at
// 43^3 and 8.8e-3 at 20^3 after 200 steps in contact: the stiff penalty
// contact amplifies a one-ulp difference), for a step 2.7% shorter.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include <cuda_runtime.h>

namespace {

enum Mode { kEuler = 0, kVerlet = 1, kRk2Half = 2, kRk2Full = 3 };

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

// ACTUATED_* rest advance with the reference's one-sided clamp
// (sim.cu:1173-1181): expand while rest < l_max, contract while > l_min.
__device__ __forceinline__ float advanced_rest(const StepArgs& a, int s,
                                               float dt) {
  const float r = a.rest_src[s];
  const float ar = a.arate[s], ab = a.abound[s];
  const bool adv = (ar > 0.f && r < ab) || (ar < 0.f && r > ab);
  return adv ? r + ar * dt : r;
}

// Force of slot s on its right endpoint (the left one gets its negative):
// Hooke + axial damping, reference computeSpringForces (sim.cu:1157-1200).
__device__ __forceinline__ float3 spring_force(const StepArgs& a, int s,
                                               float rest, float3 pl,
                                               float3 vl, float3 pr,
                                               float3 vr, float t) {
  const float dx = pr.x - pl.x, dy = pr.y - pl.y, dz = pr.z - pl.z;
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float ln = d2 > 0.f ? sqrtf(d2) : 0.f;
  const float inv = ln > 0.f ? 1.f / ln : 0.f;
  if (a.has_breathing) {
    rest = rest * (1.f + a.bsign[s] * sinf(a.bomega[s] * t));
  }
  float mag = a.k[s] * (rest - ln);
  if (a.has_damping) {
    const float axial =
        ((vl.x - vr.x) * dx + (vl.y - vr.y) * dy + (vl.z - vr.z) * dz) * inv;
    mag = mag + axial * a.damping[s];
  }
  const float c = mag * inv;
  return make_float3(c * dx, c * dy, c * dz);
}

__global__ void fused_step_kernel(StepArgs a, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n;
  if (i >= n) return;
  const float dt = a.scal[0];
  // t = t0 + step * dt (+ 0.5 dt), rounded as the plain version rounds it
  const float t_base = __fadd_rn(a.scal[1], __fmul_rn((float)a.step, dt));
  const float t = __fadd_rn(t_base, __fmul_rn(a.half, dt));
  const float3 zero = make_float3(0.f, 0.f, 0.f);

  const float3 p = ld3(a.fpos, i, n);
  const float3 v = ld3(a.fvel, i, n);
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

  // global contact planes in registration order (object.cu:76-109)
  for (int pi = 0; pi < a.n_planes; ++pi) {
    const float* pl = a.planes + 6 * pi;
    const float3 nv = make_float3(pl[0], pl[1], pl[2]);
    const float off = pl[3], fk = pl[4], fs = pl[5];
    const float disp = dot3(p, nv) - off;
    if (disp < 0.f) {
      if (fs > 0.f || fk > 0.f) {
        const float fn_mag = dot3(f, nv);
        const float vdotn = dot3(v, nv);
        const float3 vp = make_float3(v.x - vdotn * nv.x, v.y - vdotn * nv.y,
                                      v.z - vdotn * nv.z);
        const float v_norm = sqrtf(dot3(vp, vp));
        const float fn_abs = fabsf(fn_mag);
        if (v_norm > 1e-16f) {  // kinetic
          const float c = fk * fn_abs / v_norm;
          f = make_float3(f.x - vp.x * c, f.y - vp.y * c, f.z - vp.z * c);
        } else {  // static: cancel the tangential force if friction holds
          const float3 fp = make_float3(f.x - fn_mag * nv.x,
                                        f.y - fn_mag * nv.y,
                                        f.z - fn_mag * nv.z);
          if (fs * fn_abs > sqrtf(dot3(fp, fp))) {
            f = make_float3(f.x - fp.x, f.y - fp.y, f.z - fp.z);
          }
        }
      }
      const float c = -disp * a.normal_coeff;
      f = make_float3(f.x + c * nv.x, f.y + c * nv.y, f.z + c * nv.z);
    }
  }
  // global balls (object.cu:56-59)
  for (int bi = 0; bi < a.n_balls; ++bi) {
    const float* b = a.balls + 4 * bi;
    const float3 dv = make_float3(p.x - b[0], p.y - b[1], p.z - b[2]);
    const float dist = sqrtf(dot3(dv, dv));
    if (dist <= b[3] && dist > 0.f) {
      const float push = a.normal_coeff / dist;
      f = make_float3(f.x + dv.x * push, f.y + dv.y * push, f.z + dv.z * push);
    }
  }
  // quadratic drag -C |v| v (sim.cu:1329-1332)
  if (a.has_drag) {
    const float c = a.drag[i] * sqrtf(dot3(v, v));
    f = make_float3(f.x - c * v.x, f.y - c * v.y, f.z - c * v.z);
  }

  const float minv = a.minv[i];
  const float3 acc = make_float3(f.x * minv, f.y * minv, f.z * minv);
  const bool frozen = a.fixed[i] != 0.f;

  if (mode == kRk2Half) {  // midpoint predictor (sim.cu:1336-1343)
    if (frozen) {
      st3(a.pos_dst, i, n, p);
      st3(a.vel_dst, i, n, v);
    } else {
      st3(a.pos_dst, i, n,
          make_float3(p.x + 0.5f * v.x * dt, p.y + 0.5f * v.y * dt,
                      p.z + 0.5f * v.z * dt));
      st3(a.vel_dst, i, n,
          make_float3(v.x + 0.5f * acc.x * dt, v.y + 0.5f * acc.y * dt,
                      v.z + 0.5f * acc.z * dt));
    }
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
    v2 = make_float3(v0.x + acc.x * dt, v0.y + acc.y * dt, v0.z + acc.z * dt);
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

}  // namespace

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
  float* rest_out;
  float* rest_tmp;
};

// Enqueue n_steps steps on `stream` (one launch per step, two for RK2).
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int titan_fused_chunk(const ChunkArgs* c, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  const bool rk2 = c->integrator == 2;
  const int evals = c->n_steps * (rk2 ? 2 : 1);

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

  const float* pos = c->pos_in;
  const float* vel = c->vel_in;
  const float* acc = c->acc_in;
  const float* rest = c->rest_in;
  int e = 0;  // force evaluations so far (rest advances once per evaluation)
  // evaluation e writes rest into the buffer that makes the last one land
  // in rest_out
  auto rest_dst = [&](int ev) -> float* {
    if (!c->has_actuated) return nullptr;
    return ((evals - 1 - ev) % 2 == 0) ? c->rest_out : c->rest_tmp;
  };
  auto launch = [&](int mode) -> cudaError_t {
    a.rest_src = rest;
    a.rest_dst = rest_dst(e++);
    fused_step_kernel<<<blocks, threads, 0, st>>>(a, mode);
    if (c->has_actuated) rest = a.rest_dst;
    return cudaGetLastError();
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
      if ((err = launch(kRk2Half)) != cudaSuccess) return (int)err;
      a.half = 0.5f;
      a.fpos = c->pos_half;
      a.fvel = c->vel_half;
    }
    a.pos_dst = pd;
    a.vel_dst = vd;
    a.acc_dst = ad;
    const int mode = rk2 ? kRk2Full : (c->integrator == 1 ? kVerlet : kEuler);
    if ((err = launch(mode)) != cudaSuccess) return (int)err;
    pos = pd;
    vel = vd;
    acc = ad;
  }
  return 0;
}
