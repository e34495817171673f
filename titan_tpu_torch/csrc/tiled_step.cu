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
// with friction, balls, drag and the Euler (clamp on/off), Verlet or RK2
// update, fixed and invalid masses frozen.  Remainder springs, local
// constraints and magnets are outside its envelope (tiled_reject_reason).
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
// atomics.  A block's partners at +-d are contiguous runs of masses, so
// their loads coalesce.
//
// Resident-grid launches.  The TPU's mega mode advances k_seg steps in one
// pallas_call over two parity buffers, relying on its grid running in
// sequence.  GPU blocks run concurrently, so tiled_mega_kernel and
// tiled_megark2_kernel are persistent cooperative kernels
// (cudaLaunchCooperativeKernel, grid no larger than the co-resident
// blocks) that grid-stride over the masses and pass a grid barrier
// (cooperative_groups::this_grid().sync()) after every step, and after
// the RK2 predictor too: the barrier is what makes each step read the
// whole previous step.  State ping-pongs between two buffers; step 0 reads
// the segment's input, and with k_seg even the last step lands in buffer
// A.  A mass's per-step arithmetic is tiled_mass (csrc/tiled_body.cuh) in
// every mode, so a mega segment is bitwise its k_seg per-step launches.
//
// Bound.  Per step a launch reads pos (and vel, acc) and the mask, and
// writes the new state: ~84 MB at 100^3, ~25 us at 3.35 TB/s, against the
// fused kernel's k and rest planes on top (~184 MB).  What a chunk must
// move is its inputs once and its outputs once, so its least time per step
// is the arithmetic (22 operations per spring, 25 per mass at 67 TFLOP/s
// f32).  Nothing here stages partners in shared memory yet.
//
// Rounding.  Built with -fmad=false and without --use_fast_math, as
// fused_step.cu, so that it agrees bitwise with its plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include <cooperative_groups.h>

#include "tiled_body.cuh"

namespace cg = cooperative_groups;

namespace {

using titan_tiled::StepIO;
using titan_tiled::TiledArgs;
using titan_tiled::tiled_mass;

constexpr int kThreads = 256;

template <int MODE>
__global__ void tiled_step_kernel(TiledArgs a, StepIO io) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) tiled_mass<MODE>(a, io, i);
}

// The three state buffers of one side of the ping-pong.
struct State3 {
  float* pos;
  float* vel;
  float* acc;
};

// k_seg Euler or Verlet steps, steps step0 .. step0 + k_seg - 1 of the
// chunk.  Step s reads `in` (s = 0), B (s odd) or A (s even, s > 0) and
// writes the other buffer.  Euler reads no acc and writes it on the last
// step only; Verlet reads and writes it every step.
template <int MODE>
__global__ void tiled_mega_kernel(TiledArgs a, int step0, int k_seg,
                                  State3 in, State3 buf_a, State3 buf_b) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  for (int s = 0; s < k_seg; ++s) {
    const State3 src = s == 0 ? in : (s % 2 ? buf_b : buf_a);
    const State3 dst = s % 2 ? buf_a : buf_b;
    StepIO io = {};
    io.step = step0 + s;
    io.pos = src.pos;
    io.vel = src.vel;
    io.acc = src.acc;
    io.pos_dst = dst.pos;
    io.vel_dst = dst.vel;
    io.acc_dst = (MODE == titan_tiled::kVerlet || s == k_seg - 1)
                     ? dst.acc : nullptr;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      tiled_mass<MODE>(a, io, i);
    }
    grid.sync();
  }
}

// The same for RK2: per step the predictor (state -> half), a barrier, the
// corrector (half and the step's input -> next state), a barrier.
__global__ void tiled_megark2_kernel(TiledArgs a, int step0, int k_seg,
                                     State3 in, State3 buf_a, State3 buf_b,
                                     float* pos_half, float* vel_half) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  for (int s = 0; s < k_seg; ++s) {
    const State3 src = s == 0 ? in : (s % 2 ? buf_b : buf_a);
    const State3 dst = s % 2 ? buf_a : buf_b;
    StepIO io = {};
    io.step = step0 + s;
    io.pos = src.pos;
    io.vel = src.vel;
    io.pos_dst = pos_half;
    io.vel_dst = vel_half;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      tiled_mass<titan_tiled::kRk2a>(a, io, i);
    }
    grid.sync();
    io.pos = pos_half;
    io.vel = vel_half;
    io.pos0 = src.pos;
    io.vel0 = src.vel;
    io.pos_dst = dst.pos;
    io.vel_dst = dst.vel;
    io.acc_dst = s == k_seg - 1 ? dst.acc : nullptr;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      tiled_mass<titan_tiled::kRk2b>(a, io, i);
    }
    grid.sync();
  }
}

void* mega_entry(int integrator) {
  if (integrator == 2) return reinterpret_cast<void*>(tiled_megark2_kernel);
  if (integrator == 1) {
    return reinterpret_cast<void*>(tiled_mega_kernel<titan_tiled::kVerlet>);
  }
  return reinterpret_cast<void*>(tiled_mega_kernel<titan_tiled::kEuler>);
}

// Blocks of kThreads that can be resident at once on `device` for the
// resident-grid kernel of `integrator`, or a negated cudaError_t.
int coop_blocks(int integrator, int device) {
  int sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_entry(integrator), kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

}  // namespace

// Host-side arguments of one chunk; field order matches the ctypes
// structure _TiledChunk in titan_tpu_torch/ops/tiled_step.py.
struct TiledChunk {
  TiledArgs a;
  int n_steps, k_seg, integrator, device;  // integrator: 0 Euler, 1 Verlet,
                                           // 2 RK2; k_seg 0: no mega launch
  const float* pos_in;
  const float* vel_in;
  const float* acc_in;
  float* pos_out;
  float* vel_out;
  float* acc_out;
  float* pos_tmp;
  float* vel_tmp;
  float* acc_tmp;
  float* pos_half;  // RK2 only
  float* vel_half;
};

// The co-resident block limit of the resident-grid kernel for
// `integrator` on `device` (the largest grid a cooperative launch takes),
// or a negated cudaError_t.
extern "C" int titan_tiled_coop_blocks(int integrator, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return coop_blocks(integrator, device);
}

// Enqueue c->n_steps steps on `stream`: n_steps / k_seg resident-grid
// launches, then one launch per remaining step (two for RK2).  The final
// state lands in the *_out buffers; the inputs are never written.
// Returns 0, or the cudaError_t of the first launch that failed.
extern "C" int titan_tiled_chunk(const TiledChunk* c, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TiledArgs& a = c->a;
  const bool rk2 = c->integrator == 2;
  const int n_seg = c->k_seg > 0 ? c->n_steps / c->k_seg : 0;
  const int tail = c->n_steps - n_seg * c->k_seg;
  State3 out = {c->pos_out, c->vel_out, c->acc_out};
  State3 tmp = {c->pos_tmp, c->vel_tmp, c->acc_tmp};
  State3 cur = {const_cast<float*>(c->pos_in), const_cast<float*>(c->vel_in),
                const_cast<float*>(c->acc_in)};

  if (n_seg > 0) {
    // the segments end in buffer A; the tail's step j writes out when
    // tail - 1 - j is even, so A is the buffer its first step must not
    // write: out for an even tail, tmp for an odd one
    State3 buf_a = tail % 2 == 0 ? out : tmp;
    State3 buf_b = tail % 2 == 0 ? tmp : out;
    const int limit = coop_blocks(c->integrator, c->device);
    if (limit <= 0) return limit < 0 ? -limit : cudaErrorNotSupported;
    const int want = (a.n + kThreads - 1) / kThreads;
    const int blocks = want < limit ? want : limit;
    TiledArgs args = a;
    int k_seg = c->k_seg;
    float* ph = c->pos_half;
    float* vh = c->vel_half;
    for (int seg = 0; seg < n_seg; ++seg) {
      int step0 = seg * c->k_seg;
      void* params_ee[] = {&args, &step0, &k_seg, &cur, &buf_a, &buf_b};
      void* params_rk[] = {&args, &step0, &k_seg, &cur, &buf_a, &buf_b,
                           &ph, &vh};
      err = cudaLaunchCooperativeKernel(mega_entry(c->integrator),
                                        dim3(blocks), dim3(kThreads),
                                        rk2 ? params_rk : params_ee, 0, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      cur = buf_a;
    }
  }

  const int blocks = (a.n + kThreads - 1) / kThreads;
  for (int j = 0; j < tail; ++j) {
    const State3 dst = (tail - 1 - j) % 2 == 0 ? out : tmp;
    StepIO io = {};
    io.step = n_seg * c->k_seg + j;
    io.pos = cur.pos;
    io.vel = cur.vel;
    io.acc = cur.acc;
    if (rk2) {
      io.pos_dst = c->pos_half;
      io.vel_dst = c->vel_half;
      tiled_step_kernel<titan_tiled::kRk2a><<<blocks, kThreads, 0, st>>>(a,
                                                                         io);
      if ((err = cudaGetLastError()) != cudaSuccess) {
        return static_cast<int>(err);
      }
      io.pos = c->pos_half;
      io.vel = c->vel_half;
      io.pos0 = cur.pos;
      io.vel0 = cur.vel;
    }
    io.pos_dst = dst.pos;
    io.vel_dst = dst.vel;
    io.acc_dst = dst.acc;
    if (rk2) {
      tiled_step_kernel<titan_tiled::kRk2b><<<blocks, kThreads, 0, st>>>(a,
                                                                         io);
    } else if (c->integrator == 1) {
      tiled_step_kernel<titan_tiled::kVerlet><<<blocks, kThreads, 0, st>>>(
          a, io);
    } else {
      tiled_step_kernel<titan_tiled::kEuler><<<blocks, kThreads, 0, st>>>(a,
                                                                          io);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
    cur = dst;
  }
  return 0;
}
