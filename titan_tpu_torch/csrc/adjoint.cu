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
//     with step_body.cuh's spring, contact, local-constraint and drag code
//     (both incident springs per family, closed-form ACTUATED rest as the
//     JAX package's transpose does), then the integrator transpose (at the
//     velocity the local constraints leave) and the drag, local-constraint,
//     ball and plane transposes in reverse order.  It writes the
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
// The plain-spring path.  A scene whose springs are plain and whose k is
// family-uniform (ops/fused_step.py::takes_plain_spring_path: every main
// path) hands the backward kscal and bits (fused_step.bits_k) and runs
// both phases in the loops compiled for it (adjoint_body.cuh:
// plain_family_sum, plain_family_transpose; rest stays the [F, N] plane),
// bitwise the general body.  Without magnets it also folds the launches:
// phase A of mass i reads only its own carry and the trace, so one launch
// runs mass i's phase B of step t and then its phase A of step t - 1, gf
// alternating between gf and gf_odd by the step's parity (B reads its
// neighbours' gf of step t, which the launch before wrote): seg + 1
// launches a segment.  Under RK2, the pass-2 spring phase with the pass-1
// force phase and the pass-1 spring phase with the next step's midpoint
// fold likewise; the pass-2 force phase reads its neighbours' midpoints
// and keeps its own launch: 3 seg + 1.  A magnet scene keeps the unfolded
// launches, since its transpose reads every mass's gf between the phases.
// The folded kernels run 128 threads a block with five blocks an SM
// asked of __launch_bounds__ (96 registers): 43^3's 79,507 masses in one
// wave.  A team of 2 or 4 lanes a mass in the Euler / Verlet fold (each
// lane some of the families, lane 0 adding their terms in family order)
// was bitwise and measured: 20^3 20.3 -> 16.1 / 13.0 us a step, 43^3
// 27.0 -> 42.2 / 60.7 (the resident warps are bound by registers there,
// and a team adds warps and runs the tail on one lane of each), and not
// kept (PERF.md section 6).
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
// Each spring is still evaluated four times a step (two endpoints, two
// phases).  On an H100 80GB HBM3 at 700 W (scripts/cuda_fused_bwd_ab.py)
// the general body took 48.9 us a 43^3 step and 40.8 at 20^3; the
// plain-spring loops 30.2 and 22.8 unfolded, the folded sweep 27.0 and
// 20.3 (PERF.md section 6).  The trace kernel is the forward step plus a
// 24 B per mass store, so the 0.57 us of trace writes bound it.
//
// Rounding.  Built with -fmad=false and without --use_fast_math, as
// fused_step.cu.  The backward sums each step's RK2 pass-2 and pass-1
// gradients into its accumulators one after the other where the plain
// version adds the two first, so RK2 gradients agree to rounding, not
// bitwise.  The RK2 midpoint is the forward's (a frozen mass is selected),
// where the plain version blends x * (1 - fixed) + x0 * fixed: the two
// differ at most in the sign of a zero.
//
// Magnets (the TPU kernels' branches :1330 and :1433).  The forward feeds
// each force pass's field through the constant force, one pass at a time
// (ops/fused_step.py::_magnet_passes); the replay runs those passes with
// this file's trace kernel (titan_adjoint_trace_pass), the caller writing
// each pass's constant force const_f + field into the trace entry beside
// (pos_t, vel_t): [seg, 9, N], [seg, 12, N] under RK2.  The backward reads
// each pass's constant force from there, and after each pass's phase B
// launches the pairwise field's transpose (B5, csrc/magnets_adjoint.cuh):
// it reads that pass's gf and adds to the pass's position cotangent (the
// carry, or the RK2 midpoint's before pass 1 reads it) and to the [4, N]
// magnet parameter gradients.
//
// The transpose (phases A and B, the RK2 midpoint) and the sweep's launch
// loop live in csrc/adjoint_body.cuh, templated over the argument struct:
// csrc/tiled_adjoint.cu runs the same code on the tiled step's inputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include "adjoint_body.cuh"

// Arguments of one segment's backward, passed by value to every launch;
// field order matches the ctypes structure _BwdArgs in
// titan_tpu_torch/ops/adjoint.py.  The carry (gpos, gvel, gacc) is
// updated in place; gf, gpc, gvc, pos_h and vel_h are scratch.
struct BwdChunkArgs {
  int n, nf, n_planes, n_balls, seg, integrator;  // 0 Euler, 1 Verlet, 2 RK2
  int clamp, has_damping, has_breathing, has_actuated, has_drag, device;
  float normal_coeff;
  int np;        // rows per trace entry: 6, or 9 / 12 with each pass's cf
  float cutoff;  // magnet cutoff (with mag)
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
  float* grem;              // [5, S] per-spring gradients (remainder)
  const float* mag;         // [5, N] folded magnet parameters, or null
  float* gmag;              // [4, N] magnet parameter gradients (with mag)
  titan::LocalSlots local;  // per-mass local-constraint slots
  titan::Remainder rem;     // remainder springs (rest_src: the segment's)
  float* gf_odd;            // [3, N] the folded sweep's second gf buffer
  // the plain-spring path (ops/fused_step.py::takes_plain_spring_path):
  // kscal[f] x bit f of bits[m] is slot (f, m)'s k; null off that path
  const float* kscal;       // [F]
  const int* bits;          // [N]

  // per-slot parameter reads of csrc/adjoint_body.cuh: dense [F, N] planes
  __device__ float k_at(int, int, size_t s) const { return k[s]; }
  __device__ float rest_at(int, int, size_t s) const { return rest[s]; }
  __device__ float bsign_at(int, int, size_t s) const { return bsign[s]; }
  __device__ float bomega_at(int, int, size_t s) const { return bomega[s]; }
  // the plain-spring loops' family scalars: row 0 k; rest is the [F, N]
  // plane
  __device__ const float* scalars(int row) const {
    return row == 0 ? kscal : nullptr;
  }
};

// The fused backward's block on the plain-spring path (chosen on an H100,
// PERF.md section 6): scripts/cuda_fused_bwd_ab.py builds other values
// with -D.
#ifndef TITAN_FUSED_BWD_THREADS
#define TITAN_FUSED_BWD_THREADS 128
#endif
// the blocks an SM the folded kernels' __launch_bounds__ asks for: five
// of 128 threads hold 43^3's 79,507 masses in one wave
#ifndef TITAN_FUSED_BWD_BLOCKS
#define TITAN_FUSED_BWD_BLOCKS 5
#endif

namespace {

template <bool REM>
__global__ void adjoint_trace_kernel(titan::StepArgs a, int mode,
                                     float* trace) {
  titan::step_body<REM>(a, mode, trace);
}

constexpr int kFusedBwdThreads = TITAN_FUSED_BWD_THREADS;
constexpr int kFusedBwdBlocks = TITAN_FUSED_BWD_BLOCKS;

// gf of reversed step s's pass in the folded sweep: a.gf for even s (and
// RK2's pass 2), a.gf_odd for odd s (and RK2's pass 1).
__device__ __forceinline__ float* gf_of(const BwdChunkArgs& a, int s) {
  return (s & 1) ? a.gf_odd : a.gf;
}

// Euler / Verlet, launch t of the folded sweep (t = seg down to 0): mass
// i's phase B of step t (where t < seg), then its phase A of step t - 1
// (where t > 0).  A reads only mass i's own carry, which its own B has
// just finished; B reads its neighbours' gf of step t, which the launch
// before wrote, and A writes gf of step t - 1 to the other buffer.
template <bool REM>
__global__ void __launch_bounds__(kFusedBwdThreads, kFusedBwdBlocks)
    bwd_fold_kernel(BwdChunkArgs a, int t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = static_cast<size_t>(a.n);
  const size_t slot = static_cast<size_t>(a.np) * n;
  if (t < a.seg) {
    const float* pos = a.trace + static_cast<size_t>(t) * slot;
    titan_adj::bwd_spring_mass<BwdChunkArgs, REM, true>(
        a, pos, pos + 3 * n, t, 0, i, gf_of(a, t));
  }
  if (t > 0) {
    const float* pos = a.trace + static_cast<size_t>(t - 1) * slot;
    titan_adj::bwd_force_mass<BwdChunkArgs, REM, true>(
        a, pos, pos + 3 * n, t - 1, 0, i, gf_of(a, t - 1));
  }
}

// RK2, the folded launches of reversed step t.  which 0: mass i's phase
// B at the midpoint (pass 2, gf from a.gf), then its phase A at trace[t]
// (pass 1, gf to a.gf_odd), which reads only the partial carry that B has
// just written.  which 1: its phase B at trace[t] (pass 1), then, where
// t > 0, its midpoint of step t - 1, which reads only the trace.
template <bool REM>
__global__ void __launch_bounds__(kFusedBwdThreads, kFusedBwdBlocks)
    bwd_fold_rk2_kernel(BwdChunkArgs a, int t, int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = static_cast<size_t>(a.n);
  const size_t slot = static_cast<size_t>(a.np) * n;
  const float* pos = a.trace + static_cast<size_t>(t) * slot;
  if (which == 0) {
    titan_adj::bwd_spring_mass<BwdChunkArgs, REM, true>(a, a.pos_h, a.vel_h,
                                                        t, 2, i, a.gf);
    titan_adj::bwd_force_mass<BwdChunkArgs, REM, true>(a, pos, pos + 3 * n,
                                                       t, 1, i, a.gf_odd);
  } else {
    titan_adj::bwd_spring_mass<BwdChunkArgs, REM, true>(a, pos, pos + 3 * n,
                                                        t, 1, i, a.gf_odd);
    if (t > 0) {
      titan_adj::bwd_mid_mass<BwdChunkArgs, REM, true>(
          a, pos - slot, pos - slot + 3 * n, t - 1, i);
    }
  }
}

// The folded sweep of a plain-spring scene without magnets on `st`, the
// prologue already enqueued: seg + 1 launches (Euler, Verlet), or the last
// step's midpoint and three a step (RK2: the pass-2 force phase, then the
// two folded launches).  The same per-mass arithmetic in the same order
// as the unfolded sweep, so the results are bitwise its.  Returns 0 or the
// first CUDA error.
template <bool REM>
int enqueue_folded(const BwdChunkArgs* c, cudaStream_t st) {
  const int threads = kFusedBwdThreads;
  const int blocks = (c->n + threads - 1) / threads;
  const BwdChunkArgs a = *c;
  cudaError_t err;
  if (c->integrator != 2) {
    for (int t = c->seg; t >= 0; --t) {
      bwd_fold_kernel<REM><<<blocks, threads, 0, st>>>(a, t);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return 0;
  }
  const size_t n = static_cast<size_t>(c->n);
  const int last = c->seg - 1;
  const float* entry =
      c->trace + static_cast<size_t>(last) * static_cast<size_t>(c->np) * n;
  titan_adj::bwd_mid_kernel<BwdChunkArgs, REM, true>
      <<<blocks, threads, 0, st>>>(a, entry, entry + 3 * n, last);
  for (int t = last; t >= 0; --t) {
    titan_adj::bwd_force_kernel<BwdChunkArgs, REM, true>
        <<<blocks, threads, 0, st>>>(a, c->pos_h, c->vel_h, t, 2);
    bwd_fold_rk2_kernel<REM><<<blocks, threads, 0, st>>>(a, t, 0);
    bwd_fold_rk2_kernel<REM><<<blocks, threads, 0, st>>>(a, t, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The fused backward's kernel `which` (1 force, 2 spring, 3 RK2 midpoint,
// 4 the folded Euler / Verlet launch, 5 the folded RK2 launch; 4 and 5 on
// the plain-spring path only).
template <bool REM>
const void* bwd_entry(int which, bool plain) {
  using titan_adj::bwd_force_kernel;
  using titan_adj::bwd_mid_kernel;
  using titan_adj::bwd_spring_kernel;
  if (which == 4) return reinterpret_cast<const void*>(bwd_fold_kernel<REM>);
  if (which == 5) {
    return reinterpret_cast<const void*>(bwd_fold_rk2_kernel<REM>);
  }
  if (plain) {
    if (which == 1) {
      return reinterpret_cast<const void*>(
          bwd_force_kernel<BwdChunkArgs, REM, true>);
    }
    if (which == 2) {
      return reinterpret_cast<const void*>(
          bwd_spring_kernel<BwdChunkArgs, REM, true>);
    }
    return reinterpret_cast<const void*>(
        bwd_mid_kernel<BwdChunkArgs, REM, true>);
  }
  if (which == 1) {
    return reinterpret_cast<const void*>(
        bwd_force_kernel<BwdChunkArgs, REM, false>);
  }
  if (which == 2) {
    return reinterpret_cast<const void*>(
        bwd_spring_kernel<BwdChunkArgs, REM, false>);
  }
  return reinterpret_cast<const void*>(
      bwd_mid_kernel<BwdChunkArgs, REM, false>);
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
        float* entry = first ? trace + s * slot : nullptr;
        if (a.rem.inc != nullptr) {
          adjoint_trace_kernel<true><<<blocks, threads, 0, st>>>(a, mode,
                                                                 entry);
        } else {
          adjoint_trace_kernel<false><<<blocks, threads, 0, st>>>(a, mode,
                                                                  entry);
        }
        return cudaGetLastError();
      });
}

// One force pass of a magnet scene's replay (the forward's
// titan_fused_pass with p->cforce = const_f + the pass's field), writing
// the step's input to p->trace where it is set (the step's first pass).
extern "C" int titan_adjoint_trace_pass(const ChunkArgs* c,
                                        const titan::PassArgs* p,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const titan::StepArgs a = titan::pass_step_args(c, p);
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rem.inc != nullptr) {
    adjoint_trace_kernel<true><<<blocks, threads, 0, st>>>(a, p->mode,
                                                           p->trace);
  } else {
    adjoint_trace_kernel<false><<<blocks, threads, 0, st>>>(a, p->mode,
                                                            p->trace);
  }
  return (int)cudaGetLastError();
}

// Enqueue the reverse sweep over the trace on `stream`.  The general body
// (c->kscal null): two launches per step (five for RK2), and with c->mag
// one magnet transpose per force pass.  The plain-spring path (c->kscal
// and c->bits set; the scene has no damping, breathing or actuation): the
// folded sweep (enqueue_folded; c->gf_odd its second gf buffer), or with
// c->mag the general body's launches in their plain-spring
// instantiation.  A plain-spring launch without bits or gf_odd, or on a
// scene with damping, breathing or actuation, is refused
// (cudaErrorInvalidValue) before anything is enqueued.  Returns 0 or the
// first CUDA error.
extern "C" int titan_adjoint_bwd(const BwdChunkArgs* c, void* stream) {
  if (c->kscal == nullptr) {
    return titan_adj::enqueue_bwd<BwdChunkArgs, false>(c, stream);
  }
  const bool fold = c->mag == nullptr;
  if (c->bits == nullptr || c->has_damping || c->has_breathing ||
      c->has_actuated || (fold && c->gf_odd == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!fold) return titan_adj::enqueue_bwd<BwdChunkArgs, true>(c, stream);
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = titan_adj::bwd_prologue(c, st);
  if (rc != 0) return rc;
  return c->rem.inc != nullptr ? enqueue_folded<true>(c, st)
                               : enqueue_folded<false>(c, st);
}

// What one kernel of the fused backward launches with (bwd_entry's
// `which`; `plain` the plain-spring instantiation, `fold` launched by the
// folded sweep at its block (enqueue_folded) rather than by the unfolded
// one at kBwdThreads (a magnet scene's), `rem` the remainder one): out[0]
// threads a block, out[1] registers a thread, out[2] local-memory bytes a
// thread (spills), out[3] co-resident blocks an SM.  Returns 0 or a CUDA
// error.
extern "C" int titan_adjoint_bwd_kernel_info(int which, int plain, int fold,
                                             int rem, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* entry = rem ? bwd_entry<true>(which, plain != 0)
                          : bwd_entry<false>(which, plain != 0);
  const int threads = fold ? kFusedBwdThreads : titan_adj::kBwdThreads;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, entry)) != cudaSuccess) {
    return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, entry, threads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm;
  return 0;
}

// B5 alone: the pairwise magnet field's transpose for one force pass at
// pos [3, N] (csrc/magnets_adjoint.cuh), adding to gpos [3, N] and gmag
// [4, N].  Returns 0 or the launch's CUDA error.
extern "C" int titan_magnet_transpose(int n, float cutoff, const float* pos,
                                      const float* params, const float* fixed,
                                      const float* gf, float* gpos,
                                      float* gmag, void* stream) {
  return (int)titan_mag::launch_magnet_transpose(
      n, cutoff, pos, params, fixed, gf, gpos, gmag,
      static_cast<cudaStream_t>(stream));
}

// What B5 launches with: out[0] threads a block, out[1] registers a
// thread, out[2] local-memory bytes a thread, out[3] co-resident blocks an
// SM (-1 where the query refuses it), out[4] its slots of sources, out[5]
// blocks a cluster.  Returns 0 or a CUDA error.
extern "C" int titan_magnet_transpose_info(int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* entry =
      reinterpret_cast<const void*>(titan_mag::magnet_transpose_kernel);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, entry)) != cudaSuccess) {
    return (int)err;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, entry, titan_mag::kMagThreads, 0) != cudaSuccess) {
    per_sm = -1;         // the query refused the cluster kernel
    cudaGetLastError();
  }
  out[0] = titan_mag::kMagThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm;
  out[4] = titan_mag::kSlots;
  out[5] = titan_mag::kCluster;
  return 0;
}
