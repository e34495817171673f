// The tiled chunk's kernels and their host-side launch loop, shared by
// csrc/tiled_step.cu (the forward chunk) and csrc/tiled_adjoint.cu (the
// tiled adjoint's trace replay), so that the replay is the forward's own
// launches with trace stores added and stays bitwise the forward.  What the
// step computes, and why it is laid out this way, is set out at the top of
// csrc/tiled_step.cu.
//
// The plain-spring loop (step_body.cuh::plain_family_sum) runs wherever the
// host marks the scene's springs plain (TiledChunk::plain_springs): in the
// per-step kernel (tiled_step_kernel<MODE, REM, true, TRACE>), the Euler /
// Verlet resident grid (tiled_mega_kernel<MODE, true, TRACE>) and the RK2
// replay's grid (tiled_megark2_kernel<true, true>), forward and replay
// alike.  The forward RK2 grid (tiled_megark2_kernel<false>) and every
// kernel of a scene off that path run the general family loop
// (tiled_body.cuh::tiled_families).  Both loops do the same arithmetic in
// the same order, so every kernel stays bitwise the others.  The plain
// per-step and RK2 kernels are overloads of the general ones with a PLAIN
// argument before TRACE, so that the general instantiations keep their
// machine code; TRACE stays the last template argument (the profiler
// groups of chip_smoke.py tell the replay by it).
//
// TRACE = true: before each step, each mass's input (pos, vel) of that step
// is also written to the trace, [steps, 6, N] (pos rows, then vel rows), as
// csrc/adjoint.cu's trace.  The step's own arithmetic is tiled_mass_with
// either way.  A magnet scene's passes are launched one at a time with
// their own constant force (enqueue_tiled_pass), each writing the step's
// input to the entry the caller gives (whose rows after pos and vel hold
// each pass's constant force).

#ifndef TITAN_TILED_CHUNK_CUH_
#define TITAN_TILED_CHUNK_CUH_

#include <cooperative_groups.h>

#include "tiled_body.cuh"

namespace titan_tiled {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// the plain-spring resident grids' block (chosen on an H100: 256 threads
// ran 2-3% slower at 100^3, PERF.md section 6)
constexpr int kPlainThreads = 512;

// The plain-spring per-step kernel's block and the blocks an SM its
// __launch_bounds__ asks for (a 64-register cap at 1,024 threads an SM),
// chosen on an H100: 256 and 512 threads ran 6-8% slower at 100^3
// (PERF.md section 6); scripts/cuda_local_cost_ab.py builds the other
// shapes with -D.
#ifndef TITAN_STEP_PLAIN_THREADS
#define TITAN_STEP_PLAIN_THREADS 128
#endif
#ifndef TITAN_STEP_PLAIN_BLOCKS
#define TITAN_STEP_PLAIN_BLOCKS 8
#endif
constexpr int kStepPlainThreads = TITAN_STEP_PLAIN_THREADS;
constexpr int kStepPlainBlocks = TITAN_STEP_PLAIN_BLOCKS;

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

// tiled_mass_with the plain-spring loop (step_body.cuh::plain_family_sum):
// k = fparams[f] x bit f of the existence word, rest the [F, N] plane or
// the family's scalar.
template <int MODE, bool REM>
__device__ __forceinline__ void tiled_mass_plain(const TiledArgs& a,
                                                 const StepIO& io, int i) {
  const float3 p = ld3(io.pos, i, a.n);
  tiled_mass_with<MODE, REM>(a, io, i, p, [&](float, float, float3) {
    return titan::plain_family_sum(a.deltas, io.pos, a.bits, i, a.n, a.nf,
                                   a.fparams, a.rest, a.fparams + a.nf, p,
                                   make_float3(0.f, 0.f, 0.f));
  });
}

// One launch per step (two for RK2).  With TRACE, the step's first launch
// (single or rk2a) writes its input to `entry`.  REM: with the remainder
// springs (a scene with them takes these launches only).  The general
// body, at kThreads threads a block.
template <int MODE, bool REM, bool TRACE>
__global__ void tiled_step_kernel(TiledArgs a, StepIO io, float* entry) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (TRACE && MODE != kRk2b) trace_store(entry, io.pos, io.vel, i, a.n);
  tiled_mass<MODE, REM>(a, io, i);
}

// The same on the plain-spring path: tiled_step_kernel<MODE, REM, true,
// TRACE>, an overload whose PLAIN is always true, so that the general
// body's instantiations above keep their own machine code while this one
// gets a block and a register cap of its own (kStepPlainThreads,
// kStepPlainBlocks).
template <int MODE, bool REM, bool PLAIN, bool TRACE>
__global__ void __launch_bounds__(kStepPlainThreads, kStepPlainBlocks)
    tiled_step_kernel(TiledArgs a, StepIO io, float* entry) {
  static_assert(PLAIN, "the general body is tiled_step_kernel<MODE, REM, "
                       "TRACE>");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (TRACE && MODE != kRk2b) trace_store(entry, io.pos, io.vel, i, a.n);
  tiled_mass_plain<MODE, REM>(a, io, i);
}

// Launch one per-step kernel, the REM instantiation where the scene has
// remainder springs, the PLAIN one where `plain`; returns
// cudaGetLastError().
template <int MODE, bool TRACE>
cudaError_t launch_step(cudaStream_t st, const TiledArgs& a,
                        const StepIO& io, float* entry, bool plain) {
  const bool rem = a.rem.inc != nullptr;
  if (plain) {
    const int blocks = (a.n + kStepPlainThreads - 1) / kStepPlainThreads;
    if (rem) {
      tiled_step_kernel<MODE, true, true, TRACE>
          <<<blocks, kStepPlainThreads, 0, st>>>(a, io, entry);
    } else {
      tiled_step_kernel<MODE, false, true, TRACE>
          <<<blocks, kStepPlainThreads, 0, st>>>(a, io, entry);
    }
  } else {
    const int blocks = (a.n + kThreads - 1) / kThreads;
    if (rem) {
      tiled_step_kernel<MODE, true, TRACE><<<blocks, kThreads, 0, st>>>(
          a, io, entry);
    } else {
      tiled_step_kernel<MODE, false, TRACE><<<blocks, kThreads, 0, st>>>(
          a, io, entry);
    }
  }
  return cudaGetLastError();
}

// k_seg Euler or Verlet steps, steps step0 .. step0 + k_seg - 1 of the
// chunk.  Step s reads `in` (s = 0), B (s odd) or A (s even, s > 0) and
// writes the other buffer.  Euler reads no acc and writes it on the last
// step only; Verlet reads and writes it every step.  With TRACE (the tiled
// adjoint's replay), step s also writes its input to entry s of `trace`
// (the segment's first entry).
//
// PLAIN (a scene whose springs are plain and whose k rides the existence
// bits): the family sum is the plain-spring loop, run at kPlainThreads
// threads a block, two blocks an SM, so at most 64 registers a thread.
// Otherwise the general body at kThreads.  Either way one thread per mass,
// grid-striding over the masses.
template <int MODE, bool PLAIN, bool TRACE>
__global__ void __launch_bounds__(PLAIN ? kPlainThreads : kThreads,
                                  PLAIN ? 2 : 1)
    tiled_mega_kernel(TiledArgs a, int step0, int k_seg, State3 in,
                      State3 buf_a, State3 buf_b, float* trace) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int t = static_cast<int>(threadIdx.x);
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
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + t; i < n; i += stride) {
      if (TRACE) trace_store(trace_entry(trace, s, n), io.pos, io.vel, i, n);
      if constexpr (PLAIN) {
        const float3 p = ld3(io.pos, i, n);
        tiled_mass_with<MODE, false>(
            a, io, i, p, [&](float, float, float3) {
              return titan::plain_family_sum(
                  a.deltas, io.pos, a.bits, i, n, a.nf, a.fparams, a.rest,
                  a.fparams + a.nf, p, make_float3(0.f, 0.f, 0.f));
            });
      } else {
        tiled_mass<MODE>(a, io, i);
      }
    }
    grid.sync();
  }
}

// The same for RK2: per step the predictor (state -> half, and with local
// constraints pass 1's mutated velocity -> vel_v1), a barrier, the
// corrector (half and the step's input -> next state), a barrier.  PLAIN:
// both passes sum with the plain-spring loop.
template <bool PLAIN, bool TRACE>
__device__ __forceinline__ void megark2_steps(
    const TiledArgs& a, int step0, int k_seg, State3 in, State3 buf_a,
    State3 buf_b, float* pos_half, float* vel_half, float* vel_v1,
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
    io.pos_dst = pos_half;
    io.vel_dst = vel_half;
    io.v1_dst = vel_v1;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      if (TRACE) {
        trace_store(trace_entry(trace, s, a.n), io.pos, io.vel, i, a.n);
      }
      if constexpr (PLAIN) {
        tiled_mass_plain<kRk2a, false>(a, io, i);
      } else {
        tiled_mass<kRk2a>(a, io, i);
      }
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
      if constexpr (PLAIN) {
        tiled_mass_plain<kRk2b, false>(a, io, i);
      } else {
        tiled_mass<kRk2b>(a, io, i);
      }
    }
    grid.sync();
  }
}

// The general body (the forward RK2 grid, and the replay of a scene off
// the plain-spring path).
template <bool TRACE>
__global__ void tiled_megark2_kernel(TiledArgs a, int step0, int k_seg,
                                     State3 in, State3 buf_a, State3 buf_b,
                                     float* pos_half, float* vel_half,
                                     float* vel_v1, float* trace) {
  megark2_steps<false, TRACE>(a, step0, k_seg, in, buf_a, buf_b, pos_half,
                              vel_half, vel_v1, trace);
}

// The plain-spring loop, tiled_megark2_kernel<true, true>: the replay of a
// plain-spring scene only (the forward RK2 grid keeps the general body).
// An overload, as tiled_step_kernel's, at kPlainThreads threads a block,
// two blocks an SM.
template <bool PLAIN, bool TRACE>
__global__ void __launch_bounds__(kPlainThreads, 2)
    tiled_megark2_kernel(TiledArgs a, int step0, int k_seg, State3 in,
                         State3 buf_a, State3 buf_b, float* pos_half,
                         float* vel_half, float* vel_v1, float* trace) {
  static_assert(PLAIN && TRACE, "only the replay's RK2 grid takes the "
                                "plain-spring loop");
  megark2_steps<true, true>(a, step0, k_seg, in, buf_a, buf_b, pos_half,
                            vel_half, vel_v1, trace);
}

// Whether the resident grid of `integrator` takes the plain-spring loop on
// a scene whose springs take it (`plain`): every grid but the forward RK2
// one (row 4 keeps the general body).
__host__ __device__ constexpr bool grid_plain(bool plain, bool trace,
                                              int integrator) {
  return plain && (trace || integrator != 2);
}

// The resident-grid kernel of `integrator` (PLAIN: its plain-spring
// instantiation; the forward RK2 grid has none), and its block.
template <bool PLAIN, bool TRACE>
void* mega_entry(int integrator) {
  if (integrator == 2) {
    if constexpr (PLAIN && TRACE) {
      return reinterpret_cast<void*>(tiled_megark2_kernel<true, true>);
    } else {
      return reinterpret_cast<void*>(tiled_megark2_kernel<TRACE>);
    }
  }
  if (integrator == 1) {
    return reinterpret_cast<void*>(tiled_mega_kernel<kVerlet, PLAIN, TRACE>);
  }
  return reinterpret_cast<void*>(tiled_mega_kernel<kEuler, PLAIN, TRACE>);
}
inline int mega_threads(bool plain) {
  return plain ? kPlainThreads : kThreads;
}

// The per-step kernel of Mode `mode` (PLAIN, REM), and its block, for the
// kernel-info entry points.
template <bool REM, bool PLAIN, bool TRACE>
const void* step_entry(int mode) {
  const void* fn[4];
  if constexpr (PLAIN) {
    fn[0] = reinterpret_cast<const void*>(
        tiled_step_kernel<kEuler, REM, true, TRACE>);
    fn[1] = reinterpret_cast<const void*>(
        tiled_step_kernel<kVerlet, REM, true, TRACE>);
    fn[2] = reinterpret_cast<const void*>(
        tiled_step_kernel<kRk2a, REM, true, TRACE>);
    fn[3] = reinterpret_cast<const void*>(
        tiled_step_kernel<kRk2b, REM, true, TRACE>);
  } else {
    fn[0] = reinterpret_cast<const void*>(
        tiled_step_kernel<kEuler, REM, TRACE>);
    fn[1] = reinterpret_cast<const void*>(
        tiled_step_kernel<kVerlet, REM, TRACE>);
    fn[2] = reinterpret_cast<const void*>(
        tiled_step_kernel<kRk2a, REM, TRACE>);
    fn[3] = reinterpret_cast<const void*>(
        tiled_step_kernel<kRk2b, REM, TRACE>);
  }
  return fn[mode < 0 || mode > 3 ? 3 : mode];
}
inline int step_threads(bool plain) {
  return plain ? kStepPlainThreads : kThreads;
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

// What one kernel of the chunk launches with: out[0] threads a block,
// out[1] registers a thread, out[2] local-memory bytes a thread (spills),
// out[3] co-resident blocks an SM.  kind 0: the per-step kernel of Mode
// `mode` (REM: its remainder instantiation); kind 1: the resident grid of
// integrator `mode` (0 Euler, 1 Verlet, 2 RK2).  plain: the kernel a scene
// whose springs are plain launches (grid_plain for the grids).  Returns 0
// or a CUDA error.
template <bool TRACE>
int kernel_info(int kind, int mode, int plain, int rem, int device,
                int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* entry;
  int threads;
  if (kind == 0) {
    threads = step_threads(plain != 0);
    if (plain) {
      entry = rem ? step_entry<true, true, TRACE>(mode)
                  : step_entry<false, true, TRACE>(mode);
    } else {
      entry = rem ? step_entry<true, false, TRACE>(mode)
                  : step_entry<false, false, TRACE>(mode);
    }
  } else {
    const bool gp = grid_plain(plain != 0, TRACE, mode);
    threads = mega_threads(gp);
    entry = gp ? mega_entry<true, TRACE>(mode)
               : mega_entry<false, TRACE>(mode);
  }
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, entry)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, entry, threads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm;
  return 0;
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
  int plain_springs;  // 1: the scene's springs take the plain-spring loop
                      // (TiledArgs::bits carries k): the per-step kernel
                      // and every grid but the forward RK2 one
};

namespace titan_tiled {

// The plain-spring path reads k from the existence bits.
inline bool plain_ok(const TiledChunk* c) {
  return !c->plain_springs || c->a.bits != nullptr;
}

// Enqueue c->n_steps steps on `stream`: n_steps / k_seg resident-grid
// launches, then one launch per remaining step (two for RK2).  The final
// state lands in the *_out buffers; the inputs are never written.  With
// TRACE, step s's input is written to trace entry s ([n_steps, 6, N]).
// Returns 0, or the cudaError_t of the first launch that failed.
template <bool TRACE>
int enqueue_tiled_chunk(const TiledChunk* c, float* trace, void* stream) {
  if (!plain_ok(c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TiledArgs& a = c->a;
  const bool rk2 = c->integrator == 2;
  const bool plain = c->plain_springs != 0;
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
    const bool gp = grid_plain(plain, TRACE, c->integrator);
    void* entry_fn = gp ? mega_entry<true, TRACE>(c->integrator)
                        : mega_entry<false, TRACE>(c->integrator);
    const int threads = mega_threads(gp);
    const int limit = coop_blocks_of(entry_fn, threads, c->device);
    if (limit <= 0) return limit < 0 ? -limit : cudaErrorNotSupported;
    const int want = (a.n + threads - 1) / threads;
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
                                        dim3(threads),
                                        rk2 ? params_rk : params_ee, 0, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      cur = buf_a;
    }
  }

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
      if ((err = launch_step<kRk2a, TRACE>(st, a, io, tr, plain)) !=
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
      err = launch_step<kRk2b, TRACE>(st, a, io, tr, plain);
    } else if (c->integrator == 1) {
      err = launch_step<kVerlet, TRACE>(st, a, io, tr, plain);
    } else {
      err = launch_step<kEuler, TRACE>(st, a, io, tr, plain);
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    cur = dst;
  }
  return 0;
}

// Host-side arguments of one per-step launch of a magnet scene, which steps
// one force pass at a time with the pass's constant force (const_f + the
// magnet field the caller computed at the pass's positions, the TPU's
// per-step glue); field order matches the ctypes structure _TiledPass in
// titan_tpu_torch/ops/tiled_step.py.
struct TiledPass {
  int step, mode;        // the step's index in the chunk; Mode
  const float* cforce;   // [3, N] this pass's constant force
  const float* pos;      // [3, N] state the forces are evaluated at
  const float* vel;
  const float* acc;      // previous acc (Verlet)
  const float* pos0;     // the step's input (rk2b)
  const float* vel0;
  float* pos_dst;
  float* vel_dst;
  float* acc_dst;        // null for rk2a
  float* v1_dst;         // rk2a with local constraints
  const float* v1;       // rk2b with local constraints
  float* entry;          // TRACE: the trace entry of the step (single, rk2a)
};

// Enqueue the per-step launch p on `stream`: c's invariants with
// p->cforce, the plain-spring kernel where c->plain_springs is set.
// Returns 0 or the launch's CUDA error.
template <bool TRACE>
int enqueue_tiled_pass(const TiledChunk* c, const TiledPass* p,
                       void* stream) {
  if (!plain_ok(c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  TiledArgs a = c->a;
  a.cforce = p->cforce;
  StepIO io = {};
  io.step = p->step;
  io.pos = p->pos;
  io.vel = p->vel;
  io.acc = p->acc;
  io.pos0 = p->pos0;
  io.vel0 = p->vel0;
  io.pos_dst = p->pos_dst;
  io.vel_dst = p->vel_dst;
  io.acc_dst = p->acc_dst;
  io.v1_dst = p->v1_dst;
  io.v1 = p->v1;
  const bool plain = c->plain_springs != 0;
  switch (p->mode) {
    case kEuler:
      err = launch_step<kEuler, TRACE>(st, a, io, p->entry, plain);
      break;
    case kVerlet:
      err = launch_step<kVerlet, TRACE>(st, a, io, p->entry, plain);
      break;
    case kRk2a:
      err = launch_step<kRk2a, TRACE>(st, a, io, p->entry, plain);
      break;
    default:
      err = launch_step<kRk2b, TRACE>(st, a, io, p->entry, plain);
  }
  return static_cast<int>(err);
}

}  // namespace titan_tiled

#endif  // TITAN_TILED_CHUNK_CUH_
