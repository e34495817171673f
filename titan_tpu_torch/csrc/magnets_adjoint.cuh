// The pairwise magnet field's transpose for NVIDIA Hopper (sm_90a): B5, the
// magnet branch of the fused adjoint's backward.
//
// Replaces the magnet transpose of the TPU kernel
// titan_tpu/ops/adjoint.py::_build_bwd_kernel (:1433; the math is
// _force_transpose :935-1017): for one force pass, the cotangent gfm of the
// pairwise field (csrc/magnets.cu) at that pass's positions, 0 on frozen
// masses, goes back to the positions and to the four per-mass parameters
// (shell radius, shell stiffness, max pull force, scale).  Its plain
// PyTorch version, in this kernel's summation order, is
// titan_tpu_torch/ops/magnets.py::magnet_transpose_plain.
//
// For a valid pair (receiver r, source s, r != s, |d| < cutoff,
// d = p_r - p_s) the field adds d coeff to r, coeff = (shell - pull) / |d|,
// shell = |inter| stiffness_r where inter = |d| - (rad_r + rad_s) < 0,
// pull = scale_s maxf_r / max(|d|^2, 1e-12).  Its transpose (pair_bar)
// gives gd, the cotangent of d, and the cotangents of inter (both radii),
// stiffness_r, maxf_r and scale_s.
//
// Design.  A pair is tested for both of its ends' rows, so the kernel
// walks receivers x sources: one cluster of kCluster blocks per tile of
// 32 receivers (one a lane), each warp of the cluster one slot q of the
// kSlots = kCluster x kWarps slots, and slot q the sources
// [q S, (q + 1) S), S = transpose_chunk(N) (ceil(N / kSlots) rounded up to
// whole pieces of 32).  A warp stages its slot 32 sources at a time in
// shared memory with cp.async (x, y, z, valid; radius, stiffness, max
// force, scale; gf and fixed as three float4 a source; the next piece's
// copies in flight while the current one is tested and the receivers'
// inputs load), tests its 32 receivers against them without branches
// (d2 < t_cut, the least float32 whose correctly rounded sqrtf is at
// least the cutoff, so the decision is exactly sqrtf(d2) < cutoff, taken
// before any square root; both valid; j != i: a 32-bit mask a lane), and
// only then transposes the hits: the warp's hits form one list in
// (receiver, source) order (a prefix sum of the masks' counts), its 32
// lanes take 32 entries at a time, each the pair's two transposes --
// (i, j), where i receives (gpos_i += gd, the radius, stiffness and maxf
// gradients of i), and (j, i), where i is the source (gpos_i -= gd, the
// radius and scale gradients of i) -- into shared memory, and each
// receiver's lane adds its own entries' terms, which are in source order.
// Each lane so sums its slot's terms in source order from zero; the
// cluster's first block then adds the kSlots partial sums of
// each receiver in slot order, reading the other blocks' shared memory
// (distributed shared memory), and adds the position part to `gpos` (the
// pass's position cotangent) and the parameter gradients to `gmag`
// [4, N] (summed over a segment's passes), each element read and written
// by one thread: deterministic, no atomics.  2,048 masses give 64
// clusters, 256 blocks, two an SM.
//
// Bound.  Each pair is tested once per ordered pair (10 operations:
// difference, |d|^2, the threshold compare) and a pair inside the cutoff
// costs both its transposes (~2 x 46 operations); the pass moves the
// position, the five parameters, fixed and gf in and gpos and gmag out.
// On an H100 80GB HBM3 at 700 W (scripts/cuda_fused_bwd_ab.py) this
// design takes 13.3 us a launch on 1,024 RobotLinks (2,048 masses, 7,728
// acting pairs) and 23.1 on a dense 2,048-magnet cloud (112,632), against
// 32.5 and 120 for the kernel before it (one warp a mass, every
// partner's inputs read from device memory, an IEEE square root before
// the cutoff test, the transposes run lane by lane inside the partner
// loop).  Probe builds put 4.5 us of the RobotLink launch in the launch,
// the loads, the first stage and the cluster's sums, 1.4 in the tests
// and 6.7 in the hits' transposes, whose IEEE divisions (16 a pair) the
// warp issues for one or two busy lanes a round; each lane transposing
// its own hits instead was 17.1, clusters of 2 or 8 blocks 16.6 and 21.8
// (PERF.md section 6).
//
// Rounding.  Built with -fmad=false and IEEE sqrt and division, so each
// term is the plain version's, summed in the same order (the plain
// version takes the slots and the chunk as arguments): bitwise.

#ifndef TITAN_MAGNETS_ADJOINT_CUH_
#define TITAN_MAGNETS_ADJOINT_CUH_

#include <cmath>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace titan_mag {

// The transpose of one pair's field term for the cotangent g on the
// receiver's field, at d = p_r - p_s (|d|^2 = d2, dist, safe, md as the
// forward computes them), inter = dist - (rad_r + rad_s).
struct PairBar {
  float3 gd;
  float ginter, gstiff, gmaxf, gscale;
};

__device__ __forceinline__ PairBar pair_bar(float3 d, float d2, float dist,
                                            float safe, float md, float inter,
                                            float stiff_r, float maxf_r,
                                            float scale_s, float3 g) {
  PairBar b;
  const float shell = inter < 0.f ? fabsf(inter) * stiff_r : 0.f;
  const float attract = scale_s * maxf_r / md;
  const float coeff = (shell - attract) / safe;
  const float gcoeff = d.x * g.x + d.y * g.y + d.z * g.z;
  const float gshell = gcoeff / safe;
  const float gattr = -gshell;
  const float gsafe = -(shell - attract) * gcoeff / (safe * safe);
  b.ginter = inter < 0.f ? -stiff_r * gshell : 0.f;
  b.gstiff = inter < 0.f ? -inter * gshell : 0.f;
  b.gmaxf = gattr * scale_s / md;
  b.gscale = gattr * maxf_r / md;
  float gdist2 = d2 > 1e-12f ? -gattr * scale_s * maxf_r / (md * md) : 0.f;
  const float gdist = b.ginter + (dist > 0.f ? gsafe : 0.f);
  gdist2 = gdist2 + (dist > 0.f ? 0.5f * gdist / dist : 0.f);
  b.gd = make_float3(coeff * g.x + 2.f * d.x * gdist2,
                     coeff * g.y + 2.f * d.y * gdist2,
                     coeff * g.z + 2.f * d.z * gdist2);
  return b;
}

// receivers' warps a block and blocks a cluster (chosen on an H100,
// PERF.md section 6).  Their product kSlots is the plain version's
// default slot count, ops/magnets.py::MAG_SLOTS, which
// tests/test_torch_fused_bwd_plain.py holds to these two lines.
constexpr int kWarps = 8;
constexpr int kCluster = 4;
constexpr int kSlots = kWarps * kCluster;
constexpr int kMagThreads = 32 * kWarps;
static_assert(kCluster >= 1 && kCluster <= 8, "a portable cluster");
static_assert(kWarps >= 7, "the first block's warps sum the 7 outputs");

// Sources a slot takes: ceil(n / kSlots) rounded up to whole pieces of 32
// (ops/magnets.py::transpose_chunk).
__host__ __device__ __forceinline__ int transpose_chunk(int n) {
  const int per = (n + kSlots - 1) / kSlots;
  return (per + 31) / 32 * 32;
}

// The least float32 t whose correctly rounded square root is at least
// `cutoff`: sqrtf(d2) < cutoff exactly when d2 < t
// (ops/magnets_grid.py::cutoff_threshold); 0 where cutoff <= 0 (no pair
// acts), NaN where it is NaN.
inline float cutoff_threshold(float cutoff) {
  if (!(cutoff > 0.f)) return cutoff <= 0.f ? 0.f : cutoff;
  float t = cutoff * cutoff;
  while (t > 0.f && std::sqrt(std::nextafter(t, 0.f)) >= cutoff) {
    t = std::nextafter(t, 0.f);
  }
  while (std::sqrt(t) < cutoff) t = std::nextafter(t, INFINITY);
  return t;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// One piece of 32 sources a warp stages: lane l copies source base + l,
// or marks it invalid past `hi`.
struct Piece {
  float4 pv[32];   // x, y, z, valid
  float4 prm[32];  // radius, stiffness, max force, scale
  float4 gfx[32];  // gf x, y, z, fixed
};

__device__ __forceinline__ void stage_piece(Piece& p, int n, int j, int hi,
                                            const float* __restrict__ pos,
                                            const float* __restrict__ prm,
                                            const float* __restrict__ fixed,
                                            const float* __restrict__ gf) {
  const int lane = threadIdx.x & 31;
  float* pv = reinterpret_cast<float*>(&p.pv[lane]);
  if (j < hi) {
    float* pp = reinterpret_cast<float*>(&p.prm[lane]);
    float* pg = reinterpret_cast<float*>(&p.gfx[lane]);
    for (int q = 0; q < 3; ++q) cp_async4(pv + q, pos + q * n + j);
    cp_async4(pv + 3, prm + 4 * n + j);
    for (int q = 0; q < 4; ++q) cp_async4(pp + q, prm + q * n + j);
    for (int q = 0; q < 3; ++q) cp_async4(pg + q, gf + q * n + j);
    cp_async4(pg + 3, fixed + j);
  } else {
    pv[3] = 0.f;
  }
}

// The two transposes of the pair (receiver i at (px, py, pz) with radius
// ri, stiffness si, max force mi, scale ci and field cotangent gi; source
// s of the staged piece): t[0, 2, 4] the receiver's gd, t[1, 3, 5] the
// source's (at -d), t[6] and t[7] their inter cotangents, t[8] and t[9]
// the receiver's stiffness and maxf cotangents, t[10] the source's scale
// cotangent (i's scale, as the source of the pair's second term).
__device__ __forceinline__ void pair_terms(const Piece& p, int s, float px,
                                           float py, float pz, float ri,
                                           float si, float mi, float ci,
                                           float3 gi, float* t) {
  const float4 q = p.pv[s], w = p.prm[s], g = p.gfx[s];
  const float3 d = make_float3(px - q.x, py - q.y, pz - q.z);
  const float d2 = d.x * d.x + d.y * d.y + d.z * d.z;
  const float dist = d2 > 0.f ? sqrtf(d2) : 0.f;
  const float safe = dist > 0.f ? dist : 1.f;
  const float md = fmaxf(d2, 1e-12f);
  const float inter = dist - (ri + w.x);
  const float keep_j = 1.f - g.w;
  const float3 gj = make_float3(g.x * keep_j, g.y * keep_j, g.z * keep_j);
  // i receives from j
  const PairBar r = pair_bar(d, d2, dist, safe, md, inter, si, mi, w.w, gi);
  // j receives from i, at -d
  const PairBar o = pair_bar(make_float3(-d.x, -d.y, -d.z), d2, dist, safe,
                             md, inter, w.y, w.z, ci, gj);
  t[0] = r.gd.x;
  t[1] = o.gd.x;
  t[2] = r.gd.y;
  t[3] = o.gd.y;
  t[4] = r.gd.z;
  t[5] = o.gd.z;
  t[6] = r.ginter;
  t[7] = o.ginter;
  t[8] = r.gstiff;
  t[9] = r.gmaxf;
  t[10] = o.gscale;
}

// pos [3, N]; prm [5, N] the folded parameters (rad, stiffness, maxf,
// scale, valid; magnets.pairwise_params); fixed [N] 1 on frozen masses;
// gf [3, N] the pass's force cotangent; thr = cutoff_threshold(cutoff).
// Adds to gpos [3, N] and gmag [4, N].
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMagThreads)
    magnet_transpose_kernel(int n, float thr, const float* __restrict__ pos,
                            const float* __restrict__ prm,
                            const float* __restrict__ fixed,
                            const float* __restrict__ gf,
                            float* __restrict__ gpos,
                            float* __restrict__ gmag) {
  __shared__ Piece stage[kWarps][2];
  __shared__ float part[kWarps][7][32];
  // one round's terms of a warp's hits
  __shared__ float terms[kWarps][32][11];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int i = (blockIdx.x / kCluster) * 32 + lane;  // this lane's receiver
  const int chunk = transpose_chunk(n);
  const int lo = min((rank * kWarps + warp) * chunk, n);
  const int hi = min(lo + chunk, n);
  const float* rad = prm;
  const float* stiff = prm + n;
  const float* maxf = prm + 2 * n;
  const float* scale = prm + 3 * n;
  const float* valid = prm + 4 * n;
  // 0 gp.x, 1 gp.y, 2 gp.z, 3 rad, 4 stiffness, 5 maxf, 6 scale
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lo < hi) {
    stage_piece(stage[warp][0], n, lo + lane, hi, pos, prm, fixed, gf);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // the receiver's inputs, loaded while the first piece is in flight (a
  // lane past n reads mass n - 1 and takes no pair)
  const int ic = min(i, n - 1);
  const bool live = i < n && valid[ic] != 0.f;
  const float px = pos[ic], py = pos[n + ic], pz = pos[2 * n + ic];
  const float ri = rad[ic], si = stiff[ic], mi = maxf[ic], ci = scale[ic];
  const float keep_i = 1.f - fixed[ic];
  const float3 gi = make_float3(gf[ic] * keep_i, gf[n + ic] * keep_i,
                                gf[2 * n + ic] * keep_i);
  for (int base = lo, b = 0; base < hi; base += 32, b ^= 1) {
    if (base + 32 < hi) {
      stage_piece(stage[warp][b ^ 1], n, base + 32 + lane, hi, pos, prm,
                  fixed, gf);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    const Piece& p = stage[warp][b];
    // the test: which of the 32 sources act on receiver i, no branch
    unsigned hits = 0u;
#pragma unroll 8
    for (int s = 0; s < 32; ++s) {
      const float4 q = p.pv[s];
      const float dx = px - q.x, dy = py - q.y, dz = pz - q.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const bool on = (d2 < thr) & (q.w != 0.f) & (base + s != i);
      hits |= static_cast<unsigned>(on) << s;
    }
    if (!live) hits = 0u;
    // the warp's hits as one list in (lane, source) order, entries
    // [pre, pre + cnt) lane's; lane l transposes entries l, l + 32, ...
    // and each receiver then adds its own entries' terms in list order,
    // which is its source order
    const int cnt = __popc(hits);
    int pre = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, pre, o);
      if (lane >= o) pre += u;
    }
    const int total = __shfl_sync(0xffffffffu, pre, 31);
    pre -= cnt;
    for (int round = 0; round < total; round += 32) {
      // entry e's receiver lane: the last lane whose first entry is at
      // or before e; its source: that lane's (e - first)-th hit
      const int e = round + lane;
      int rl = 0;
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(0xffffffffu, pre, rl + step) <= e) rl += step;
      }
      const int first = __shfl_sync(0xffffffffu, pre, rl);
      const unsigned rh = __shfl_sync(0xffffffffu, hits, rl);
      const int s = e < total ? static_cast<int>(__fns(rh, 0, e - first + 1))
                              : 0;
      const float rx = __shfl_sync(0xffffffffu, px, rl);
      const float ry = __shfl_sync(0xffffffffu, py, rl);
      const float rz = __shfl_sync(0xffffffffu, pz, rl);
      const float rr = __shfl_sync(0xffffffffu, ri, rl);
      const float rs = __shfl_sync(0xffffffffu, si, rl);
      const float rm = __shfl_sync(0xffffffffu, mi, rl);
      const float rc = __shfl_sync(0xffffffffu, ci, rl);
      const float3 rg = make_float3(__shfl_sync(0xffffffffu, gi.x, rl),
                                    __shfl_sync(0xffffffffu, gi.y, rl),
                                    __shfl_sync(0xffffffffu, gi.z, rl));
      if (e < total) {
        pair_terms(p, s, rx, ry, rz, rr, rs, rm, rc, rg, terms[warp][lane]);
      }
      __syncwarp();
      const int lo_e = max(pre, round), hi_e = min(pre + cnt, round + 32);
      for (int k = lo_e; k < hi_e; ++k) {
        const float* t = terms[warp][k - round];
        acc[0] = acc[0] + t[0] - t[1];
        acc[1] = acc[1] + t[2] - t[3];
        acc[2] = acc[2] + t[4] - t[5];
        acc[3] = acc[3] - t[6] - t[7];
        acc[4] = acc[4] + t[8];
        acc[5] = acc[5] + t[9];
        acc[6] = acc[6] + t[10];
      }
      __syncwarp();
    }
    __syncwarp();   // the piece is read: the stage after next may reuse it
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
  for (int q = 0; q < 7; ++q) part[warp][q][lane] = acc[q];
  cluster.sync();
  // the first block's warp q sums output q over the slots in order
  if (rank == 0 && warp < 7 && i < n) {
    float v[kSlots];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float* other = cluster.map_shared_rank(&part[0][0][0], r);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        v[r * kWarps + w] = other[(w * 7 + warp) * 32 + lane];
      }
    }
    float total = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) total = total + v[q];
    if (warp < 3) {
      gpos[warp * n + i] += total;
    } else {
      gmag[(warp - 3) * n + i] += total;
    }
  }
  cluster.sync();   // the other blocks' partial sums stay until read
}

// Enqueue one transpose on `st`; returns cudaGetLastError().
inline cudaError_t launch_magnet_transpose(int n, float cutoff,
                                           const float* pos, const float* prm,
                                           const float* fixed,
                                           const float* gf, float* gpos,
                                           float* gmag, cudaStream_t st) {
  const int tiles = (n + 31) / 32;
  if (tiles > 0) {
    magnet_transpose_kernel<<<tiles * kCluster, kMagThreads, 0, st>>>(
        n, cutoff_threshold(cutoff), pos, prm, fixed, gf, gpos, gmag);
  }
  return cudaGetLastError();
}

}  // namespace titan_mag

#endif  // TITAN_MAGNETS_ADJOINT_CUH_
