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
  titan::LocalSlots local;  // per-mass local-constraint slots
  titan::Remainder rem;     // remainder springs (rest_src: the segment's)

  // per-slot parameter reads of csrc/adjoint_body.cuh: dense [F, N] planes
  __device__ float k_at(int, int, size_t s) const { return k[s]; }
  __device__ float rest_at(int, int, size_t s) const { return rest[s]; }
  __device__ float bsign_at(int, int, size_t s) const { return bsign[s]; }
  __device__ float bomega_at(int, int, size_t s) const { return bomega[s]; }
};

namespace {

template <bool REM>
__global__ void adjoint_trace_kernel(titan::StepArgs a, int mode,
                                     float* trace) {
  titan::step_body<REM>(a, mode, trace);
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

// Enqueue the reverse sweep over the trace on `stream`: two launches per
// step (five for RK2).  Returns 0 or the first CUDA error.
extern "C" int titan_adjoint_bwd(const BwdChunkArgs* c, void* stream) {
  return titan_adj::enqueue_bwd(c, stream);
}
