// The tiled adjoint's kernels for NVIDIA Hopper (sm_90a): the trace replay
// and the reverse sweep of one segment of a differentiable rollout of a
// scene past the fused adjoint's residency rule, such as the 100^3 stress
// config (1M masses, 12.7M springs).
//
// Replaces the TPU kernels
//   - titan_tpu/ops/pallas_tiled.py::_build_kernel in mode megatrace
//     (make_megatrace_call): the trace replay (B6);
//   - titan_tpu/ops/adjoint_tiled.py::_build_bwd_tile_kernel, mode fused
//     (_make_bwd_call): the per-step tiled backward (B7);
//   - titan_tpu/ops/adjoint_tiled.py::_build_megabwd_kernel
//     (_make_megabwd_call): all of a segment's reversed steps in one
//     launch (B8).
// Their plain PyTorch versions, which the card's results are held
// against, are titan_tpu_torch/ops/adjoint_tiled.py::tiled_trace_run_plain
// and ::tiled_bwd_run_plain.
//
// B6, trace replay.  The forward tiled chunk of csrc/tiled_step.cu
// replayed through the same launches (csrc/tiled_chunk.cuh instantiated
// with TRACE = true): n // 16 cooperative resident-grid launches, then one
// launch per remaining step (two for RK2), each step's arithmetic
// tiled_mass, t and the actuation count taken from the step's index.  The
// only addition is that each step's first force evaluation stores its
// input (pos, vel) to trace[s] ([seg, 6, N], the layout csrc/adjoint.cu's
// backward reads, coalesced).  So the trace is bitwise the states the
// forward stepped through.  RK2 replays through the resident-grid RK2
// kernel too, not per step as the JAX package does (its megatrace is
// Euler/Verlet only): a resident-grid segment is bitwise its per-step
// launches either way.  A plain-spring scene's replay takes the
// plain-spring loop in every launch, the RK2 grid's included
// (tiled_megark2_kernel<true, true>; the forward's keeps the general body):
// the loop is bitwise the general body, so the trace stays the forward's.
// The trace holds no acc: the Verlet transpose is linear in the previous
// acc and never reads its value.
//
// B7, per-step backward.  The transpose of csrc/adjoint_body.cuh (the
// fused adjoint's, one CUDA copy of it) instantiated over TiledBwdArgs,
// whose per-slot reads follow the tiled step's data contract: a k that is
// uniform in its family is that family's scalar times bit f of the int32
// existence mask, a uniform rest or breathing field the family's scalar,
// everything else an [F, N] plane; cf, minv, fixed, drag and the
// local-constraint slot rows are the tiled step's own staging, so the
// local-constraint transpose (adjoint_body.cuh::local_transpose, the
// TPU's :1421 branch) is the fused adjoint's too.  Per reversed step,
// one thread per mass and no atomics: A (bwd_force_kernel) recomputes the
// force at the traced state, transposes integrator, drag, local
// constraints, balls and planes, and writes the cotangent on the spring
// sum gf; B (bwd_spring_kernel) gathers both
// incident springs of each family, finishes the carry and adds the bars
// of slot (f, i), which only thread i writes.  RK2 adds the midpoint
// launch and a second A/B pair: five launches per step.  This replaces the
// TPU kernel's halo windows: those let each tile gather instead of
// scattering into its neighbours' tiles, and one thread per mass that
// gathers both incident springs needs no halo.  Every slot gets its own
// gradient [F, N], whether its field rode as a scalar or as a plane.
//
// Magnet glue.  B6 replays a magnet scene's glue passes one at a time
// (titan_tiled_trace_pass, csrc/tiled_chunk.cuh::enqueue_tiled_pass with
// TRACE), the caller writing each pass's constant force const_f + field
// into the trace entry ([seg, 9, N], [seg, 12, N] under RK2, the JAX
// package's layout, adjoint_tiled.py:513-546).  B7 reads each pass's
// constant force from the entry; on an unbinned scene it launches the
// pairwise field's transpose (csrc/magnets_adjoint.cuh) after each pass,
// on a binned one the caller runs the binned pass's vjp between the parts
// of each reversed step (titan_tiled_bwd_begin, titan_tiled_bwd_part: the
// whole step, or under RK2 the midpoint and pass 2 (rk2b), then pass 1
// (rk2a); adjoint_tiled.py:780-803, :1182-1340).
//
// B8, resident-grid backward (Euler and Verlet).  One cooperative launch
// per segment, no larger than the co-resident blocks, grid-striding over
// the masses, runs all seg reversed steps: phase A, a grid barrier, phase
// B.  Each mass's carry, partial carry and bars are read and written by
// its owner thread only (the grid-stride mapping is the same in every
// phase), so they are updated in place, and the bars accumulate in
// reversed-step order exactly as B7's launches add them: B8 is bitwise B7.
// The only array read across masses is gf, so gf alternates between two
// buffers by the step's parity: step t - 1's phase A writes the buffer
// that step t's phase B does not read, and one barrier per step (between A
// and B) is enough.  (The TPU kernel's parity buffers hold the carry,
// because its tiles read their neighbours' carry through halo windows.)
//
// The plain-spring path.  A scene whose springs are plain and whose k is
// family-uniform (TiledBwdArgs::plain_springs, set from
// ops/fused_step.py::takes_plain_spring_path: every main path) runs both
// phases in loops compiled for it (adjoint_body.cuh: plain_family_sum,
// plain_family_transpose): no per-spring branch on the scene's features,
// on the partner's bounds or on a null k plane.  B7 takes them in its
// <TiledBwdArgs, REM, true> kernels, B8 in tiled_megabwd_kernel<true>,
// which also gets a block and a register cap of its own
// (kBwdPlainThreads, kBwdPlainBlocks): the general instantiation holds
// both phases' registers at once (108 a thread, two blocks of 256 an SM),
// fewer warps than each of B7's two kernels keeps.
//
// Bound.  A reversed step reads the trace entry (24 B per mass), the
// carry (36 B) and the invariants (the existence mask, the [F, N] rest
// plane at 100^3, const force, inverse mass, frozen mask) and writes the
// carry and the [F, N] bars (k and rest at least: 2 x 4 B per slot, read
// and written: the bars' read-modify-write over the segment is what the
// bytes are); the arithmetic is the force recompute (22 operations per
// spring, 25 per mass) and its transpose (40 per spring, 45 per mass),
// with each spring evaluated at both endpoints in both phases.  Like the
// forward kernels it is bound in practice by the instructions it executes
// (IEEE sqrt and divide, every spring evaluated twice in each phase).  The
// design's own floor in bytes is higher than that bound counts: the bars
// of every slot, k and rest [F, N], are read and written in device memory
// at every reversed step (2 planes x 13 families x 4 B x 2 a mass a step,
// ~208 MB a step at 100^3, ~62 us at 3.35 TB/s); a thread owns too many
// masses (1M over the co-resident threads) to hold them in registers.
//
// Rounding.  Built with -fmad=false and without --use_fast_math.
// Euler/Verlet: the same operations in the same order as the plain
// version, bitwise.  RK2: the pass-2 and pass-1 gradients are added to
// the accumulators one after the other, where the plain version adds the
// two first, so RK2 agrees to rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include "adjoint_body.cuh"
#include "tiled_chunk.cuh"

// Arguments of one segment's tiled backward; field order matches the
// ctypes structure _TiledBwdArgs in titan_tpu_torch/ops/adjoint_tiled.py.
// The carry (gpos, gvel, gacc) is updated in place; gf, gpc, gvc, pos_h
// and vel_h are scratch.
struct TiledBwdArgs {
  int n, nf, n_planes, n_balls, seg, integrator;  // 0 Euler, 1 Verlet, 2 RK2
  int clamp, has_damping, has_breathing, has_actuated, has_drag, device;
  float normal_coeff;
  int np;        // rows per trace entry: 6, or 9 / 12 with each pass's cf
  float cutoff;  // magnet cutoff (with mag)
  int deltas[titan_tiled::kMaxFamilies];
  const float* scal;     // [2]: dt, t at segment start
  const float* planes;   // [P, 6]
  const float* balls;    // [B, 4]
  const float* fparams;  // [5, F]: k, rest, damping, bsign, bomega scalars
  const int* bits;       // [N] existence bitmask (uniform k), or null
  const float* k;        // [F, N] validity-folded, or null (uniform)
  const float* rest;     // [F, N] or null (uniform, not actuated)
  const float* damping;  // [F, N] validity-folded (has_damping only)
  const float* bsign;    // [F, N] or null (uniform type)
  const float* bomega;   // [F, N] or null (uniform omega)
  const float* aratedt;  // [F, N] (actuated only)
  const float* sstop;    // [F, N] (actuated only)
  const float* cforce;   // [3, N]
  const float* minv;     // [N]
  const float* fixed;    // [N]
  const float* drag;     // [N] (has_drag only)
  const float* trace;    // [seg, np, N]
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
  int plain_springs;        // 1: the plain-spring path (bits carry k; no
                            // damping, breathing or actuation)

  // per-slot parameter reads of csrc/adjoint_body.cuh, as
  // csrc/tiled_body.cuh::tiled_spring reads them
  __device__ float k_at(int fi, int l, size_t s) const {
    if (k != nullptr) return k[s];
    return __fmul_rn(fparams[fi], static_cast<float>((bits[l] >> fi) & 1));
  }
  __device__ float rest_at(int fi, int, size_t s) const {
    return rest != nullptr ? rest[s] : fparams[nf + fi];
  }
  __device__ float bsign_at(int fi, int, size_t s) const {
    return bsign != nullptr ? bsign[s] : fparams[3 * nf + fi];
  }
  __device__ float bomega_at(int fi, int, size_t s) const {
    return bomega != nullptr ? bomega[s] : fparams[4 * nf + fi];
  }
};

// B8's block on the plain-spring path and the blocks an SM its
// __launch_bounds__ asks for, chosen on an H100 (PERF.md section 6);
// scripts/cuda_bwd_plain_ab.py builds the other shapes it tried with -D.
#ifndef TITAN_B8_PLAIN_THREADS
#define TITAN_B8_PLAIN_THREADS 512
#endif
#ifndef TITAN_B8_PLAIN_BLOCKS
#define TITAN_B8_PLAIN_BLOCKS 2
#endif

namespace {

using titan_tiled::kThreads;
constexpr int kBwdPlainThreads = TITAN_B8_PLAIN_THREADS;
constexpr int kBwdPlainBlocks = TITAN_B8_PLAIN_BLOCKS;

// B8: all a.seg reversed Euler or Verlet steps of a segment, gf in the
// parity buffers gf0 (even steps) and gf1 (odd steps); PLAIN: the
// plain-spring path.
template <bool PLAIN>
__global__ void __launch_bounds__(PLAIN ? kBwdPlainThreads : kThreads,
                                  PLAIN ? kBwdPlainBlocks : 1)
    tiled_megabwd_kernel(TiledBwdArgs a, float* gf0, float* gf1) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const size_t n = static_cast<size_t>(a.n);
  for (int t = a.seg - 1; t >= 0; --t) {
    const float* pos = a.trace + static_cast<size_t>(t) * 6 * n;
    const float* vel = pos + 3 * n;
    float* gf = (t & 1) ? gf1 : gf0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      titan_adj::bwd_force_mass<TiledBwdArgs, false, PLAIN>(a, pos, vel, t, 0,
                                                            i, gf);
    }
    grid.sync();
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      titan_adj::bwd_spring_mass<TiledBwdArgs, false, PLAIN>(a, pos, vel, t,
                                                             0, i, gf);
    }
  }
}

// B8's kernel and block size, on the plain-spring path or not: what its
// launch and its co-resident limit both use.
const void* b8_entry(bool plain) {
  return plain ? reinterpret_cast<const void*>(tiled_megabwd_kernel<true>)
               : reinterpret_cast<const void*>(tiled_megabwd_kernel<false>);
}
int b8_threads(bool plain) { return plain ? kBwdPlainThreads : kThreads; }

// B7's force (which 1), spring (2) or RK2 midpoint (3) kernel.
template <bool REM, bool PLAIN>
const void* b7_entry(int which) {
  if (which == 1) {
    return reinterpret_cast<const void*>(
        titan_adj::bwd_force_kernel<TiledBwdArgs, REM, PLAIN>);
  }
  if (which == 2) {
    return reinterpret_cast<const void*>(
        titan_adj::bwd_spring_kernel<TiledBwdArgs, REM, PLAIN>);
  }
  return reinterpret_cast<const void*>(
      titan_adj::bwd_mid_kernel<TiledBwdArgs, REM, PLAIN>);
}

// The plain-spring path reads k from the existence bits.
bool plain_ok(const TiledBwdArgs* c) {
  return !c->plain_springs || c->bits != nullptr;
}

}  // namespace

// The co-resident block limit on `device` of the trace replay's
// resident-grid kernel for `integrator` (kind 0) or of B8 (kind 1); with
// `plain` the instantiation a plain-spring scene launches, at its own block
// size; or a negated cudaError_t.
extern "C" int titan_tiled_adjoint_coop_blocks(int kind, int integrator,
                                               int plain, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (kind == 0) {
    const bool gp = titan_tiled::grid_plain(plain != 0, true, integrator);
    return titan_tiled::coop_blocks_of(
        gp ? titan_tiled::mega_entry<true, true>(integrator)
           : titan_tiled::mega_entry<false, true>(integrator),
        titan_tiled::mega_threads(gp), device);
  }
  return titan_tiled::coop_blocks_of(b8_entry(plain != 0),
                                     b8_threads(plain != 0), device);
}

// What one B7 or B8 kernel launches with: out[0] threads a block, out[1]
// registers a thread, out[2] local-memory bytes a thread (spills), out[3]
// co-resident blocks an SM.  which: 0 B8, 1 B7's force kernel, 2 its
// spring kernel, 3 its RK2 midpoint kernel; plain: the plain-spring
// instantiation; rem: B7's remainder instantiation.  Returns 0 or a CUDA
// error.
extern "C" int titan_tiled_bwd_kernel_info(int which, int plain, int rem,
                                           int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* entry;
  int threads = titan_adj::kBwdThreads;
  if (which == 0) {
    entry = b8_entry(plain != 0);
    threads = b8_threads(plain != 0);
  } else if (plain) {
    entry = rem ? b7_entry<true, true>(which) : b7_entry<false, true>(which);
  } else {
    entry = rem ? b7_entry<true, false>(which) : b7_entry<false, false>(which);
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

// The replay's kernel info (titan_tiled::kernel_info): threads, registers,
// local bytes and co-resident blocks an SM of its per-step kernel (kind 0)
// or resident grid (kind 1).
extern "C" int titan_tiled_trace_kernel_info(int kind, int mode, int plain,
                                             int rem, int device, int* out) {
  return titan_tiled::kernel_info<true>(kind, mode, plain, rem, device, out);
}

// B6: enqueue the replay of c->n_steps steps on `stream`, writing step
// s's input (pos, vel) to trace + s * 6 N, through the plain-spring
// kernels where c->plain_springs is set.  Returns 0 or the first CUDA
// error.
extern "C" int titan_tiled_trace(const TiledChunk* c, float* trace,
                                 void* stream) {
  return titan_tiled::enqueue_tiled_chunk<true>(c, trace, stream);
}

// B7 (mega = 0): the reverse sweep over the trace, two launches per step
// (five for RK2).  B8 (mega = 1, Euler or Verlet): the same sweep in one
// cooperative launch, gf alternating between c->gf and gf_odd.  Either
// takes the plain-spring path's kernels where c->plain_springs is set.
// Returns 0 or the first CUDA error.
extern "C" int titan_tiled_bwd(const TiledBwdArgs* c, int mega, float* gf_odd,
                               void* stream) {
  if (!plain_ok(c)) return static_cast<int>(cudaErrorInvalidValue);
  const bool plain = c->plain_springs != 0;
  if (!mega) {
    return plain ? titan_adj::enqueue_bwd<TiledBwdArgs, true>(c, stream)
                 : titan_adj::enqueue_bwd<TiledBwdArgs, false>(c, stream);
  }
  if (c->integrator == 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = titan_adj::bwd_prologue(c, st);
  if (rc != 0) return rc;
  const void* entry = b8_entry(plain);
  const int threads = b8_threads(plain);
  const int limit = titan_tiled::coop_blocks_of(entry, threads, c->device);
  if (limit <= 0) return limit < 0 ? -limit : cudaErrorNotSupported;
  const int want = (c->n + threads - 1) / threads;
  const int blocks = want < limit ? want : limit;
  TiledBwdArgs args = *c;
  float* gf0 = c->gf;
  float* gf1 = gf_odd;
  void* params[] = {&args, &gf0, &gf1};
  err = cudaLaunchCooperativeKernel(entry, dim3(blocks), dim3(threads),
                                    params, 0, st);
  return static_cast<int>(err);
}

// B6 for a magnet scene: one per-step launch of the replay with its pass's
// constant force (TiledPass), writing the step's input to p->entry on the
// step's first pass.  Returns 0 or the launch's CUDA error.
extern "C" int titan_tiled_trace_pass(const TiledChunk* c,
                                      const titan_tiled::TiledPass* p,
                                      void* stream) {
  return titan_tiled::enqueue_tiled_pass<true>(c, p, stream);
}

// B7 split around a magnet glue's transpose that the caller runs: the
// prologue (carry in, accumulators zeroed), then one part of reversed step
// t (titan_adj::Part: both phases; or under RK2 the midpoint and pass 2,
// then pass 1).  Each returns 0 or the first CUDA error.
extern "C" int titan_tiled_bwd_begin(const TiledBwdArgs* c, void* stream) {
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return titan_adj::bwd_prologue(c, static_cast<cudaStream_t>(stream));
}

extern "C" int titan_tiled_bwd_part(const TiledBwdArgs* c, int t, int part,
                                    void* stream) {
  if (!plain_ok(c)) return static_cast<int>(cudaErrorInvalidValue);
  return c->plain_springs
             ? titan_adj::enqueue_part<TiledBwdArgs, true>(c, t, part, stream)
             : titan_adj::enqueue_part<TiledBwdArgs, false>(c, t, part,
                                                            stream);
}
