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
// launches either way.  The trace holds no acc: the Verlet transpose is
// linear in the previous acc and never reads its value.
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
// Bound.  A reversed step reads the trace entry (24 B per mass), the
// carry (36 B) and the invariants (the existence mask, the [F, N] rest
// plane at 100^3, const force, inverse mass, frozen mask) and writes the
// carry and the [F, N] bars (k and rest at least: 2 x 4 B per slot, read
// and written: the bars' read-modify-write over the segment is what the
// bytes are); the arithmetic is the force recompute (22 operations per
// spring, 25 per mass) and its transpose (40 per spring, 45 per mass),
// with each spring evaluated at both endpoints in both phases.  Like the
// forward kernels it is bound in practice by each thread's chain of
// gathers.
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
  const float* trace;    // [seg, 6, N]
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

namespace {

// B8: all a.seg reversed Euler or Verlet steps of a segment, gf in the
// parity buffers gf0 (even steps) and gf1 (odd steps).
__global__ void tiled_megabwd_kernel(TiledBwdArgs a, float* gf0,
                                     float* gf1) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const size_t n = static_cast<size_t>(a.n);
  for (int t = a.seg - 1; t >= 0; --t) {
    const float* pos = a.trace + static_cast<size_t>(t) * 6 * n;
    const float* vel = pos + 3 * n;
    float* gf = (t & 1) ? gf1 : gf0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      titan_adj::bwd_force_mass<TiledBwdArgs, false>(a, pos, vel, t, 0, i,
                                                     gf);
    }
    grid.sync();
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
      titan_adj::bwd_spring_mass<TiledBwdArgs, false>(a, pos, vel, t, 0, i,
                                                      gf);
    }
  }
}

}  // namespace

using titan_tiled::kThreads;

// The co-resident block limit on `device` of the trace replay's
// resident-grid kernel for `integrator` (kind 0) or of B8 (kind 1), or a
// negated cudaError_t.
extern "C" int titan_tiled_adjoint_coop_blocks(int kind, int integrator,
                                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const void* entry =
      kind == 0 ? titan_tiled::mega_entry<true>(integrator)
                : reinterpret_cast<void*>(tiled_megabwd_kernel);
  return titan_tiled::coop_blocks_of(entry, kThreads, device);
}

// B6: enqueue the replay of c->n_steps steps on `stream`, writing step
// s's input (pos, vel) to trace + s * 6 N.  Returns 0 or the first CUDA
// error.
extern "C" int titan_tiled_trace(const TiledChunk* c, float* trace,
                                 void* stream) {
  return titan_tiled::enqueue_tiled_chunk<true>(c, trace, stream);
}

// B7 (mega = 0): the reverse sweep over the trace, two launches per step
// (five for RK2).  B8 (mega = 1, Euler or Verlet): the same sweep in one
// cooperative launch, gf alternating between c->gf and gf_odd.  Returns 0
// or the first CUDA error.
extern "C" int titan_tiled_bwd(const TiledBwdArgs* c, int mega, float* gf_odd,
                               void* stream) {
  if (!mega) return titan_adj::enqueue_bwd(c, stream);
  if (c->integrator == 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(c->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = titan_adj::bwd_prologue(c, st);
  if (rc != 0) return rc;
  void* entry = reinterpret_cast<void*>(tiled_megabwd_kernel);
  const int limit = titan_tiled::coop_blocks_of(entry, kThreads, c->device);
  if (limit <= 0) return limit < 0 ? -limit : cudaErrorNotSupported;
  const int want = (c->n + kThreads - 1) / kThreads;
  const int blocks = want < limit ? want : limit;
  TiledBwdArgs args = *c;
  float* gf0 = c->gf;
  float* gf1 = gf_odd;
  void* params[] = {&args, &gf0, &gf1};
  err = cudaLaunchCooperativeKernel(entry, dim3(blocks), dim3(kThreads),
                                    params, 0, st);
  return static_cast<int>(err);
}
