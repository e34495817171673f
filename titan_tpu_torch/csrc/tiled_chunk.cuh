// The tiled chunk's kernels and their host-side launch loop, shared by
// csrc/tiled_step.cu (the forward chunk) and csrc/tiled_adjoint.cu (the
// tiled adjoint's trace replay), so that the replay is the forward's own
// launches with trace stores added and stays bitwise the forward.  What the
// step computes, and why it is laid out this way, is set out at the top of
// csrc/tiled_step.cu.
//
// TRACE = true: before each step, each mass's input (pos, vel) of that step
// is also written to the trace, [steps, 6, N] (pos rows, then vel rows), as
// csrc/adjoint.cu's trace.  The step's own arithmetic is tiled_mass either
// way.

#ifndef TITAN_TILED_CHUNK_CUH_
#define TITAN_TILED_CHUNK_CUH_

#include <cooperative_groups.h>

#include "tiled_body.cuh"

namespace titan_tiled {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;

// The three state buffers of one side of the ping-pong.
struct State3 {
  float* pos;
  float* vel;
  float* acc;
};

// Trace entry `s` of a trace that starts at `trace` ([*, 6, N]).
__device__ __forceinline__ float* trace_entry(float* trace, int s, int n) {
  return trace + static_cast<size_t>(s) * 6 * static_cast<size_t>(n);
}

// Write mass i's (pos, vel) to one trace entry.
__device__ __forceinline__ void trace_store(float* entry, const float* pos,
                                            const float* vel, int i, int n) {
  st3(entry, i, n, ld3(pos, i, n));
  st3(entry + 3 * static_cast<size_t>(n), i, n, ld3(vel, i, n));
}

// One launch per step (two for RK2).  With TRACE, the step's first launch
// (single or rk2a) writes its input to `entry`.  REM: with the remainder
// springs (a scene with them takes these launches only).
template <int MODE, bool REM, bool TRACE>
__global__ void tiled_step_kernel(TiledArgs a, StepIO io, float* entry) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (TRACE && MODE != kRk2b) trace_store(entry, io.pos, io.vel, i, a.n);
  tiled_mass<MODE, REM>(a, io, i);
}

// Launch one per-step kernel, the REM instantiation where the scene has
// remainder springs; returns cudaGetLastError().
template <int MODE, bool TRACE>
cudaError_t launch_step(int blocks, cudaStream_t st, const TiledArgs& a,
                        const StepIO& io, float* entry) {
  if (a.rem.inc != nullptr) {
    tiled_step_kernel<MODE, true, TRACE><<<blocks, kThreads, 0, st>>>(
        a, io, entry);
  } else {
    tiled_step_kernel<MODE, false, TRACE><<<blocks, kThreads, 0, st>>>(
        a, io, entry);
  }
  return cudaGetLastError();
}

// k_seg Euler or Verlet steps, steps step0 .. step0 + k_seg - 1 of the
// chunk.  Step s reads `in` (s = 0), B (s odd) or A (s even, s > 0) and
// writes the other buffer.  Euler reads no acc and writes it on the last
// step only; Verlet reads and writes it every step.  With TRACE, step s
// writes its input to entry s of `trace` (the segment's first entry).
template <int MODE, bool TRACE>
__global__ void tiled_mega_kernel(TiledArgs a, int step0, int k_seg,
                                  State3 in, State3 buf_a, State3 buf_b,
                                  float* trace) {
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
    io.acc_dst = (MODE == kVerlet || s == k_seg - 1) ? dst.acc : nullptr;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      if (TRACE) {
        trace_store(trace_entry(trace, s, a.n), io.pos, io.vel, i, a.n);
      }
      tiled_mass<MODE>(a, io, i);
    }
    grid.sync();
  }
}

// The same for RK2: per step the predictor (state -> half, and with local
// constraints pass 1's mutated velocity -> vel_v1), a barrier, the
// corrector (half and the step's input -> next state), a barrier.
template <bool TRACE>
__global__ void tiled_megark2_kernel(TiledArgs a, int step0, int k_seg,
                                     State3 in, State3 buf_a, State3 buf_b,
                                     float* pos_half, float* vel_half,
                                     float* vel_v1, float* trace) {
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
    io.v1_dst = vel_v1;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      if (TRACE) {
        trace_store(trace_entry(trace, s, a.n), io.pos, io.vel, i, a.n);
      }
      tiled_mass<kRk2a>(a, io, i);
    }
    grid.sync();
    io.pos = pos_half;
    io.vel = vel_half;
    io.pos0 = src.pos;
    io.vel0 = src.vel;
    io.v1_dst = nullptr;
    io.v1 = vel_v1;
    io.pos_dst = dst.pos;
    io.vel_dst = dst.vel;
    io.acc_dst = s == k_seg - 1 ? dst.acc : nullptr;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      tiled_mass<kRk2b>(a, io, i);
    }
    grid.sync();
  }
}

template <bool TRACE>
void* mega_entry(int integrator) {
  if (integrator == 2) {
    return reinterpret_cast<void*>(tiled_megark2_kernel<TRACE>);
  }
  if (integrator == 1) {
    return reinterpret_cast<void*>(tiled_mega_kernel<kVerlet, TRACE>);
  }
  return reinterpret_cast<void*>(tiled_mega_kernel<kEuler, TRACE>);
}

// Blocks of `threads` that can be resident at once on `device` for the
// cooperative kernel `entry`, or a negated cudaError_t.
inline int coop_blocks_of(const void* entry, int threads, int device) {
  int sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, entry, threads,
                                                      0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

}  // namespace titan_tiled

// Host-side arguments of one chunk; field order matches the ctypes
// structure _TiledChunk in titan_tpu_torch/ops/tiled_step.py.
struct TiledChunk {
  titan_tiled::TiledArgs a;
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
  float* vel_v1;    // RK2 with local constraints: pass 1's mutated velocity
};

namespace titan_tiled {

// Enqueue c->n_steps steps on `stream`: n_steps / k_seg resident-grid
// launches, then one launch per remaining step (two for RK2).  The final
// state lands in the *_out buffers; the inputs are never written.  With
// TRACE, step s's input is written to trace entry s ([n_steps, 6, N]).
// Returns 0, or the cudaError_t of the first launch that failed.
template <bool TRACE>
int enqueue_tiled_chunk(const TiledChunk* c, float* trace, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TiledArgs& a = c->a;
  const bool rk2 = c->integrator == 2;
  const int n_seg = c->k_seg > 0 ? c->n_steps / c->k_seg : 0;
  const int tail = c->n_steps - n_seg * c->k_seg;
  const size_t entry = 6 * static_cast<size_t>(a.n);
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
    void* entry_fn = mega_entry<TRACE>(c->integrator);
    const int limit = coop_blocks_of(entry_fn, kThreads, c->device);
    if (limit <= 0) return limit < 0 ? -limit : cudaErrorNotSupported;
    const int want = (a.n + kThreads - 1) / kThreads;
    const int blocks = want < limit ? want : limit;
    TiledArgs args = a;
    int k_seg = c->k_seg;
    float* ph = c->pos_half;
    float* vh = c->vel_half;
    float* v1 = c->vel_v1;
    for (int seg = 0; seg < n_seg; ++seg) {
      int step0 = seg * c->k_seg;
      float* tr = TRACE ? trace + static_cast<size_t>(step0) * entry : nullptr;
      void* params_ee[] = {&args, &step0, &k_seg, &cur, &buf_a, &buf_b, &tr};
      void* params_rk[] = {&args, &step0, &k_seg, &cur, &buf_a, &buf_b,
                           &ph,   &vh,    &v1,    &tr};
      err = cudaLaunchCooperativeKernel(entry_fn, dim3(blocks),
                                        dim3(kThreads),
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
    float* tr = TRACE ? trace + static_cast<size_t>(io.step) * entry : nullptr;
    io.pos = cur.pos;
    io.vel = cur.vel;
    io.acc = cur.acc;
    if (rk2) {
      io.pos_dst = c->pos_half;
      io.vel_dst = c->vel_half;
      io.v1_dst = c->vel_v1;
      if ((err = launch_step<kRk2a, TRACE>(blocks, st, a, io, tr)) !=
          cudaSuccess) {
        return static_cast<int>(err);
      }
      io.pos = c->pos_half;
      io.vel = c->vel_half;
      io.pos0 = cur.pos;
      io.vel0 = cur.vel;
      io.v1_dst = nullptr;
      io.v1 = c->vel_v1;
    }
    io.pos_dst = dst.pos;
    io.vel_dst = dst.vel;
    io.acc_dst = dst.acc;
    if (rk2) {
      err = launch_step<kRk2b, TRACE>(blocks, st, a, io, tr);
    } else if (c->integrator == 1) {
      err = launch_step<kVerlet, TRACE>(blocks, st, a, io, tr);
    } else {
      err = launch_step<kEuler, TRACE>(blocks, st, a, io, tr);
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    cur = dst;
  }
  return 0;
}

}  // namespace titan_tiled

#endif  // TITAN_TILED_CHUNK_CUH_
