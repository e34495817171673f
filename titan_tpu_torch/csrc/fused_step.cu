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
// Remainder springs and local constraints are not in this kernel yet
// (fused_reject_reason sends such scenes to the eager step).  Magnets enter
// through the constant force: for a magnet scene the caller computes the
// field of each force pass (csrc/magnets.cu or csrc/magnets_grid.cu) and
// launches that pass alone through titan_fused_pass with cforce =
// const_f + field, so the step body has no magnet code.
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
// The per-mass body and the host-side step loop live in csrc/step_body.cuh,
// shared with the adjoint's trace replay (csrc/adjoint.cu), which must
// stay bitwise this chunk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include "step_body.cuh"

namespace {

__global__ void fused_step_kernel(titan::StepArgs a, int mode) {
  titan::step_body(a, mode, nullptr);
}

}  // namespace

// Enqueue n_steps steps on `stream` (one launch per step, two for RK2).
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int titan_fused_chunk(const ChunkArgs* c, void* stream) {
  return titan::enqueue_chunk(
      c, stream,
      [](int blocks, int threads, cudaStream_t st, const titan::StepArgs& a,
         int mode, int, bool) -> cudaError_t {
        fused_step_kernel<<<blocks, threads, 0, st>>>(a, mode);
        return cudaGetLastError();
      });
}

// One force pass with explicit buffers; field order matches the ctypes
// structure _PassArgs in titan_tpu_torch/ops/fused_step.py.
struct PassArgs {
  int step;  // step index inside the chunk
  int mode;  // titan::Mode
  const float* fpos;  // [3, N] state the forces are evaluated at
  const float* fvel;
  const float* pos0;  // [3, N] state at the start of the step
  const float* vel0;
  const float* acc0;
  const float* rest_src;  // [F, N]
  const float* cforce;    // [3, N] const_f + this pass's magnet field
  float* pos_dst;
  float* vel_dst;
  float* acc_dst;   // null for the RK2 predictor
  float* rest_dst;  // [F, N] (actuated only)
};

// Enqueue one launch of the step kernel: pass `p` of a chunk whose
// invariants are `c` (c->cforce is replaced by p->cforce).  The per-pass
// entry of magnet scenes, whose field the caller computes between passes.
// Returns 0, or the cudaError_t of the launch.
extern "C" int titan_fused_pass(const ChunkArgs* c, const PassArgs* p,
                                void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  titan::StepArgs a = titan::step_args(c);
  a.step = p->step;
  a.half = p->mode == titan::kRk2Full ? 0.5f : 0.f;
  a.cforce = p->cforce;
  a.fpos = p->fpos;
  a.fvel = p->fvel;
  a.pos0 = p->pos0;
  a.vel0 = p->vel0;
  a.acc0 = p->acc0;
  a.rest_src = p->rest_src;
  a.rest_dst = c->has_actuated ? p->rest_dst : nullptr;
  a.pos_dst = p->pos_dst;
  a.vel_dst = p->vel_dst;
  a.acc_dst = p->acc_dst;
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  fused_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, p->mode);
  return (int)cudaGetLastError();
}
