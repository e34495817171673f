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
// thread evaluates, per family, its left spring (slot (f, i), partner
// i + d) and its right spring (slot (f, i - d)), so every spring is
// evaluated by both endpoints: no atomics, and the sum order is fixed
// (const force, then per family "- left + right", as the TPU kernel's
// f_acc - f + roll(f, d), then the remainder sum).  Remainder springs work
// the same way through the incidence table: a thread walks its mass's row
// and evaluates each of its springs (step_body.cuh::remainder_forces,
// compiled into the kernel's REM instantiation only), where the TPU gathers
// and scatters through one-hot selectors on its matrix unit.
// Plain-spring path (a scene whose springs are plain, no damping,
// breathing or actuation, and whose k is uniform within every family: the
// main paths).  The family loop is step_body.cuh::plain_family_sum,
// compiled for plain springs only: no per-spring feature branch, no store,
// restrict pointers, k = kscal[f] times bit f of the spring's left
// endpoint's existence word (the validity-folded k plane's value; the
// plane is not read), and each spring evaluated at a partner index clamped
// into [0, N) and added only where its partner exists, so that no load
// waits on a branch.  128 threads a block.  Other scenes take the general
// body (step_body.cuh::step_body), which the adjoint's replay runs too.
// Both paths are bitwise the plain version.
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
// Bound.  What a chunk must move is its inputs once and its outputs once,
// spread over its steps, so the least time per step is the arithmetic, ~22
// ops per spring and ~25 per mass, 0.35 us per step at 43^3 at 67 TFLOP/s
// f32.  The kernel issues far more instructions than that: with IEEE
// sqrt and divide (-fmad=false, no fast math) and every spring evaluated
// by both endpoints, the general body is instruction-bound (at 100^3 its
// time per step matches ~160 issued instructions per spring evaluation),
// not bound by the latency of its gathers: the L1 cache already holds a
// block's neighbourhood.  On an H100 (PERF.md section 6, PR 9) the
// plain-spring loop cut the 43^3 step by ~28%; a launch's device time is
// ~10.5 us of the ~12.3 us step, the rest the gap between launches.
// Measured and dropped (PERF.md section 6, PR 9):
// copying each block's partner windows of pos and existence bits into
// shared memory first (cp.async; as fast at 20^3 and 100^3, 3% slower at
// 43^3), the tile's rest runs too (slower still), and splitting a mass's
// families over 2 or 4 lanes with the forces summed through shared memory
// (twice as slow).
// A scene with local constraints also reads its slot rows, 22 floats per
// mass at one slot of each type, and mutates the velocity that drag and the
// update read; RK2 then stores pass 1's mutated velocity (12 B per mass)
// for the corrector launch, which starts from it.
// Next steps: the chunk as a CUDA graph or one persistent kernel with a
// grid barrier per step (the launch gap); the plain-spring loop for damped
// scenes; fewer instructions per spring (each spring evaluated once).
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

// Threads a block of the plain-spring path (chosen on an H100: 256 was
// 8% slower at 43^3, PERF.md section 6) and of the general body.
constexpr int kPlainThreads = 128;
constexpr int kThreads = 256;

// One force pass, one thread per mass.  PLAIN: the family sum is the
// plain-spring loop (a.kscal set); otherwise the general body.
template <bool REM, bool PLAIN>
__global__ void fused_step_kernel(titan::StepArgs a, int mode) {
  if constexpr (PLAIN) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int n = a.n;
    if (i >= n) return;
    const float3 p = titan::ld3(a.fpos, i, n);
    const float3 f = titan::plain_family_sum(
        a.deltas, a.fpos, a.bits, i, n, a.nf, a.kscal, a.rest_src, nullptr,
        p, titan::ld3(a.cforce, i, n));
    titan::step_tail<REM>(a, mode, i, titan::step_clock(a), p,
                          titan::ld3(a.fvel, i, n), f);
  } else {
    titan::step_body<REM>(a, mode, nullptr);
  }
}

template <bool REM>
cudaError_t launch_one(cudaStream_t st, const titan::StepArgs& a, int mode) {
  if (a.kscal != nullptr) {
    const int blocks = (a.n + kPlainThreads - 1) / kPlainThreads;
    fused_step_kernel<REM, true><<<blocks, kPlainThreads, 0, st>>>(a, mode);
  } else {
    const int blocks = (a.n + kThreads - 1) / kThreads;
    fused_step_kernel<REM, false><<<blocks, kThreads, 0, st>>>(a, mode);
  }
  return cudaGetLastError();
}

// One launch, the REM instantiation where the scene has remainder
// springs; returns cudaGetLastError().
cudaError_t launch(cudaStream_t st, const titan::StepArgs& a, int mode) {
  return a.rem.inc != nullptr ? launch_one<true>(st, a, mode)
                              : launch_one<false>(st, a, mode);
}

}  // namespace

// Enqueue n_steps steps on `stream` (one launch per step, two for RK2).
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int titan_fused_chunk(const ChunkArgs* c, void* stream) {
  return titan::enqueue_chunk(
      c, stream,
      [](int, int, cudaStream_t st, const titan::StepArgs& a, int mode, int,
          bool) -> cudaError_t { return launch(st, a, mode); });
}

// One force pass with explicit buffers (titan::PassArgs).
extern "C" int titan_fused_pass(const ChunkArgs* c, const titan::PassArgs* p,
                                void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return (int)err;
  const titan::StepArgs a = titan::pass_step_args(c, p);
  return (int)launch(static_cast<cudaStream_t>(stream), a, p->mode);
}

// The plain-spring step kernel's registers a thread and co-resident blocks
// an SM at its block size (rem: the REM instantiation).  Returns 0 or the
// CUDA error.
extern "C" int titan_fused_kernel_info(int rem, int* regs, int* per_sm) {
  const void* fn =
      rem ? reinterpret_cast<const void*>(fused_step_kernel<true, true>)
          : reinterpret_cast<const void*>(fused_step_kernel<false, true>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fn, kPlainThreads, 0);
}
