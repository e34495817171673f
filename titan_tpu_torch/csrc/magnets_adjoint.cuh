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
// Design.  One warp per mass i, as the forward; its 32 lanes stride over
// the partners j (lane l takes j = l, l + 32, ...) and evaluate both pairs:
// (i, j), where i receives (gpos_i += gd, the radius, stiffness and maxf
// gradients of i), and (j, i), where i is the source (gpos_i -= gd, the
// radius and scale gradients of i).  Each lane sums its share in index
// order and a fixed __shfl_xor_sync tree adds the 32 partial sums, so each
// mass's row and column are reduced by its own warp: deterministic, no
// atomics.  Lane 0 then adds the position part to `gpos` (the pass's
// position cotangent) and the parameter gradients to `gmag` [4, N] (summed
// over a segment's passes), each element read and written by one thread.
//
// Bound.  Each pair is tested once per warp that owns one of its ends
// (10 operations: difference, |d|^2, sqrt, cutoff compare) and a pair
// inside the cutoff costs both its transposes (~2 x 38 operations); the
// pass moves the position, the five parameters, fixed and gf in and gpos
// and gmag out.
//
// Rounding.  Built with -fmad=false and IEEE sqrt and division, so each
// term is the plain version's, summed in the same order.

#ifndef TITAN_MAGNETS_ADJOINT_CUH_
#define TITAN_MAGNETS_ADJOINT_CUH_

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

// pos [3, N]; prm [5, N] the folded parameters (rad, stiffness, maxf,
// scale, valid; magnets.pairwise_params); fixed [N] 1 on frozen masses;
// gf [3, N] the pass's force cotangent.  Adds to gpos [3, N] and gmag
// [4, N].
__global__ void magnet_transpose_kernel(int n, float cutoff,
                                        const float* __restrict__ pos,
                                        const float* __restrict__ prm,
                                        const float* __restrict__ fixed,
                                        const float* __restrict__ gf,
                                        float* __restrict__ gpos,
                                        float* __restrict__ gmag) {
  // the warp index is the same for all 32 lanes, so a whole warp returns
  // together and the shuffles below always see all lanes
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const float* rad = prm;
  const float* stiff = prm + n;
  const float* maxf = prm + 2 * n;
  const float* scale = prm + 3 * n;
  const float* valid = prm + 4 * n;
  // 0 gp.x, 1 gp.y, 2 gp.z, 3 rad, 4 stiffness, 5 maxf, 6 scale
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (valid[i] != 0.f) {
    const float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
    const float ri = rad[i], si = stiff[i], mi = maxf[i], ci = scale[i];
    const float keep_i = 1.f - fixed[i];
    const float3 gi = make_float3(gf[i] * keep_i, gf[n + i] * keep_i,
                                  gf[2 * n + i] * keep_i);
    for (int j = lane; j < n; j += 32) {
      if (j == i || valid[j] == 0.f) continue;
      const float3 d = make_float3(px - pos[j], py - pos[n + j],
                                   pz - pos[2 * n + j]);
      const float d2 = d.x * d.x + d.y * d.y + d.z * d.z;
      const float dist = d2 > 0.f ? sqrtf(d2) : 0.f;
      if (!(dist < cutoff)) continue;
      const float safe = dist > 0.f ? dist : 1.f;
      const float md = fmaxf(d2, 1e-12f);
      const float inter = dist - (ri + rad[j]);
      const float keep_j = 1.f - fixed[j];
      const float3 gj = make_float3(gf[j] * keep_j, gf[n + j] * keep_j,
                                    gf[2 * n + j] * keep_j);
      // i receives from j
      const PairBar r = pair_bar(d, d2, dist, safe, md, inter, si, mi,
                                 scale[j], gi);
      // j receives from i, at -d
      const PairBar s = pair_bar(make_float3(-d.x, -d.y, -d.z), d2, dist,
                                 safe, md, inter, stiff[j], maxf[j], ci, gj);
      acc[0] = acc[0] + r.gd.x - s.gd.x;
      acc[1] = acc[1] + r.gd.y - s.gd.y;
      acc[2] = acc[2] + r.gd.z - s.gd.z;
      acc[3] = acc[3] - r.ginter - s.ginter;
      acc[4] = acc[4] + r.gstiff;
      acc[5] = acc[5] + r.gmaxf;
      acc[6] = acc[6] + s.gscale;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      acc[q] = acc[q] + __shfl_xor_sync(0xffffffffu, acc[q], off);
    }
  }
  if (lane == 0) {
    gpos[i] += acc[0];
    gpos[n + i] += acc[1];
    gpos[2 * n + i] += acc[2];
#pragma unroll
    for (int q = 0; q < 4; ++q) gmag[q * n + i] += acc[3 + q];
  }
}

// Enqueue one transpose on `st`; returns cudaGetLastError().
inline cudaError_t launch_magnet_transpose(int n, float cutoff,
                                           const float* pos, const float* prm,
                                           const float* fixed,
                                           const float* gf, float* gpos,
                                           float* gmag, cudaStream_t st) {
  const int threads = 256;  // 8 masses per block
  const int blocks = (n + threads / 32 - 1) / (threads / 32);
  if (blocks > 0) {
    magnet_transpose_kernel<<<blocks, threads, 0, st>>>(n, cutoff, pos, prm,
                                                        fixed, gf, gpos, gmag);
  }
  return cudaGetLastError();
}

}  // namespace titan_mag

#endif  // TITAN_MAGNETS_ADJOINT_CUH_
