// Tiled mass-spring chunk for NVIDIA Hopper (sm_90a): the step for scenes
// past the fused step's residency rule, such as the 100^3 stress config
// (1M masses, 12.7M springs).
//
// Replaces the TPU kernel titan_tpu/ops/pallas_tiled.py::_build_kernel in
// three of its modes: single / rk2a / rk2b (one launch per step, two for
// RK2; make_tiled_call), mega (k_seg Euler or Verlet steps in one launch;
// make_mega_call) and megark2 (the same for RK2; make_mega_rk2_call).  The
// plain PyTorch version of the same function, which the card's results are
// held against, is titan_tpu_torch/ops/tiled_step.py::tiled_chunk_plain.
// Physics: stencil-family springs (Hooke + axial damping, breathing,
// closed-form ACTUATED_* rest), the constant force, global contact planes
// with friction, balls, the per-mass local constraints (the fused step's
// device function, csrc/step_body.cuh::local_constraints, on the same
// stacked slot rows; pallas_tiled.py:789-865), drag and the Euler (clamp
// on/off), Verlet or RK2 update, fixed and invalid masses frozen.
// Remainder springs run inside the per-step launches (REM).  A magnet
// scene steps one force pass at a time (titan_tiled_pass): the caller
// computes the field at the pass's positions (csrc/magnets.cu or
// csrc/magnets_grid.cu) and launches the pass with cforce = const_f +
// field, the RK2 midpoint's between rk2a and rk2b (the TPU's per-step
// magnet glue, pallas_tiled.py:1609-1700); such a scene takes no resident
// grid.  With local constraints the RK2 predictor also
// stores pass 1's mutated velocity, which the corrector starts from (the
// TPU's megark2 cell carries it in its midpoint buffer, :898).
//
// What carries over from the TPU kernel is its data contract, not its
// layout.  A family-uniform field rides as one scalar per family (the
// TPU's SMEM scalars, here fparams), and a uniform k as that scalar times
// bit f of ONE int32 existence mask per mass, so the [F, N] k and rest
// planes the fused kernel reads every step are not read at all; fields
// that vary within a family ride as [F, N] planes.  ACTUATED rest has the
// closed form rest0 + min(s + 1, s_stop) rate dt from the chunk's start
// (pallas_tiled.py:41-51), so no rest is written during a chunk.  The force
// sums the families first, from zero, then adds the constant force
// (f_acc = fw + const_f, :740): the opposite of the fused kernel's order,
// so the two kernels agree to f32 rounding, not bitwise.
//
// What does not carry over: the TPU tiles of 32,768 masses with halo
// windows of H = max |delta| rows and their revolving two-slot DMA
// scratch, the [R, 128] row/lane rolls and the SMEM scalar refs answer
// VMEM and DMA limits the card does not have (at 100^3 the two halos alone,
// 2 x 10,101 masses x 12 B of pos, exceed a block's 227 KB of shared
// memory).  Here one thread owns one mass and gathers both incident
// springs of each family, as csrc/fused_step.cu does: deterministic, no
// atomics.
//
// Resident-grid launches.  The TPU's mega mode advances k_seg steps in one
// pallas_call over two parity buffers, relying on its grid running in
// sequence.  GPU blocks run concurrently, so tiled_mega_kernel and
// tiled_megark2_kernel are persistent cooperative kernels
// (cudaLaunchCooperativeKernel, grid no larger than the co-resident
// blocks) that pass a grid barrier (cooperative_groups::this_grid().sync())
// after every step, and after the RK2 predictor too: the barrier is what
// makes each step read the whole previous step.  State ping-pongs between
// two buffers; step 0 reads the segment's input, and with k_seg even the
// last step lands in buffer A.  A mass's per-step arithmetic is tiled_mass
// (csrc/tiled_body.cuh) in every mode, so a mega segment is bitwise its
// k_seg per-step launches.  The kernels and their launch loop live in
// csrc/tiled_chunk.cuh, which csrc/tiled_adjoint.cu instantiates again
// with trace stores for the tiled adjoint's replay.
//
// The plain-spring path (a scene whose springs are plain and whose k rides
// the existence bits, as every main path).  Each thread sums its families
// with the fused step's plain-spring loop (step_body.cuh::
// plain_family_sum: no per-spring feature branch, partner indices clamped
// into [0, N) so that no load waits on a branch) before tiled_mass's tail:
// the Euler / Verlet grid (tiled_mega_kernel<MODE, true, false>) and the
// RK2 grid (tiled_megark2_kernel<true, false>) at 512 threads a block, two
// blocks an SM, and the per-step kernel (tiled_step_kernel<MODE, REM, true,
// false>: the tail's launches, a link scene's, the glue passes) at 128
// threads a block, eight an SM, all capped at 64 registers.  Every kernel
// of another scene keeps the general body; both loops do the same
// arithmetic in the same order, so every mode stays bitwise the others.
//
// Bound.  Per step a launch reads pos (and vel, acc) and the mask, and
// writes the new state: ~84 MB at 100^3, ~25 us at 3.35 TB/s, against the
// fused kernel's k and rest planes on top (~184 MB).  What a chunk must
// move is its inputs once and its outputs once, so its least time per step
// is the arithmetic (22 operations per spring, 25 per mass at 67 TFLOP/s
// f32).  The kernels issue far more instructions than that (IEEE sqrt and
// divide, each spring evaluated by both endpoints): the general grid was
// instruction-bound and no faster per step than per-step launches; the
// plain-spring loop runs a 100^3 step in ~3/5 of a general per-step
// launch's time on an H100 (PERF.md section 6).  Measured and dropped:
// each block copying its tile's partner windows of pos and existence bits
// into shared memory (cp.async, double-buffered) before the same loop,
// 12-15% slower than reading them from device memory; staging the tile's
// 26 rest runs as well, slower still; in the per-step kernel, each spring
// with both ends in one block evaluated once and its force passed through
// shared memory, 17-27% slower (the two-phase loop's barrier and branches
// cost more than the evaluations it saves).
//
// Rounding.  Built with -fmad=false and without --use_fast_math, as
// fused_step.cu, so that it agrees bitwise with its plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include "tiled_chunk.cuh"

// The co-resident block limit of the resident-grid kernel for
// `integrator` on `device` (the largest grid a cooperative launch takes;
// plain: the grid a plain-spring scene launches, at its block size), or a
// negated cudaError_t.
extern "C" int titan_tiled_coop_blocks(int integrator, int device,
                                       int plain) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return titan_tiled::coop_blocks_of(
      plain ? titan_tiled::mega_entry<true, false>(integrator)
            : titan_tiled::mega_entry<false, false>(integrator),
      titan_tiled::mega_threads(plain != 0), device);
}

// Enqueue c->n_steps steps on `stream`: n_steps / k_seg resident-grid
// launches, then one launch per remaining step (two for RK2).  The final
// state lands in the *_out buffers; the inputs are never written.
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int titan_tiled_chunk(const TiledChunk* c, void* stream) {
  return titan_tiled::enqueue_tiled_chunk<false>(c, nullptr, stream);
}

// One resident-grid launch of c->k_seg steps starting at the chunk's step
// step0 (a distributed shard's segment over its halo'd window).  Returns 0
// or the launch's CUDA error.
extern "C" int titan_tiled_segment(const TiledChunk* c, int step0,
                                   void* stream) {
  return titan_tiled::enqueue_segment(c, step0, stream);
}

// One per-step launch of a magnet scene with its pass's constant force
// (TiledPass).  Returns 0 or the launch's CUDA error.
extern "C" int titan_tiled_pass(const TiledChunk* c,
                                const titan_tiled::TiledPass* p,
                                void* stream) {
  return titan_tiled::enqueue_tiled_pass<false>(c, p, stream);
}

// The forward's kernel info (titan_tiled::kernel_info): threads, registers,
// local bytes and co-resident blocks an SM of its per-step kernel (kind 0)
// or resident grid (kind 1).
extern "C" int titan_tiled_kernel_info(int kind, int mode, int plain, int rem,
                                       int device, int* out) {
  return titan_tiled::kernel_info<false>(kind, mode, plain, rem, device, out);
}
