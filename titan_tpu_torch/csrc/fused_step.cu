// Fused multi-step mass-spring chunk for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel titan_tpu/ops/pallas_step.py::_build_kernel
// (launched by build_pallas_chunk): n whole steps of stencil-family springs
// (Hooke + axial damping, breathing, ACTUATED_* rest), the constant force
// (gravity + persistent external force), the remainder springs (springs in
// no stencil family, pallas_step.py:348-404), global contact planes with
// static and kinetic friction, balls, the per-mass local constraints
// (contact planes, balls, constraint planes, directions;
// pallas_step.py:494-571), quadratic drag and the Euler (clamp on/off),
// Verlet or RK2 update, with fixed and invalid masses frozen.  The plain
// PyTorch version of the same function, which the card's results are held
// against, is titan_tpu_torch/ops/fused_step.py::fused_chunk_plain.
// Magnets enter
// through the constant force: for a magnet scene the caller computes the
// field of each force pass (csrc/magnets.cu or csrc/magnets_grid.cu) and
// launches that pass alone through titan_fused_pass with cforce =
// const_f + field, so the step body has no magnet code.
//
// Design.  One thread per mass.  Family f connects mass n to n + d_f; each
// thread evaluates, per family, its left spring (slot (f, i), partner i + d)
// and its right spring (slot (f, i - d)), so every spring is evaluated by
// both endpoints: no atomics, and the sum order is fixed (const force, then
// per family "- left + right", as the TPU kernel's f_acc - f + roll(f, d),
// then the remainder sum).  Remainder springs work the same way through
// the incidence table: a thread walks its mass's row and evaluates each of
// its springs (step_body.cuh::remainder_forces, compiled into the kernel's
// REM instantiation only), where the TPU gathers and scatters through
// one-hot selectors on its matrix unit; they cost each thread D more
// gathers of 2 endpoints (a hub of high degree pads every row of the table
// to its degree).
// An index outside [0, N) is a masked slot (the TPU roll's wrap-around lanes
// carry k = 0); d may be negative.  One launch per step (two for RK2: the
// corrector reads the neighbours' half-step state), all issued on the
// caller's stream by one host call.  pos/vel/acc ping-pong between the
// output and scratch buffers so that the last step lands in the outputs and
// the inputs are never written; actuated rest ping-pongs too, because the
// right-endpoint thread must read the pre-step rest of a slot whose left
// thread writes the new one.  So does the remainder rest, in two [S]
// buffers that start equal (a padding spring has no owner thread).
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
// A scene with local constraints also reads its slot rows, 22 floats per
// mass at one slot of each type, and mutates the velocity that drag and the
// update read; RK2 then stores pass 1's mutated velocity (12 B per mass)
// for the corrector launch, which starts from it.
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

template <bool REM>
__global__ void fused_step_kernel(titan::StepArgs a, int mode) {
  titan::step_body<REM>(a, mode, nullptr);
}

// One launch, the REM instantiation where the scene has remainder
// springs; returns cudaGetLastError().
cudaError_t launch(int blocks, int threads, cudaStream_t st,
                   const titan::StepArgs& a, int mode) {
  if (a.rem.inc != nullptr) {
    fused_step_kernel<true><<<blocks, threads, 0, st>>>(a, mode);
  } else {
    fused_step_kernel<false><<<blocks, threads, 0, st>>>(a, mode);
  }
  return cudaGetLastError();
}

}  // namespace

// Enqueue n_steps steps on `stream` (one launch per step, two for RK2).
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int titan_fused_chunk(const ChunkArgs* c, void* stream) {
  return titan::enqueue_chunk(
      c, stream,
      [](int blocks, int threads, cudaStream_t st, const titan::StepArgs& a,
         int mode, int, bool) -> cudaError_t {
        return launch(blocks, threads, st, a, mode);
      });
}

// One force pass with explicit buffers (titan::PassArgs).
extern "C" int titan_fused_pass(const ChunkArgs* c, const titan::PassArgs* p,
                                void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const titan::StepArgs a = titan::pass_step_args(c, p);
  const int threads = 256;
  const int blocks = (c->n + threads - 1) / threads;
  return (int)launch(blocks, threads, static_cast<cudaStream_t>(stream), a,
                     p->mode);
}
