// Pairwise magnet field for NVIDIA Hopper (sm_90a).
//
// Replaces the in-kernel magnet sweep of the TPU kernel
// titan_tpu/ops/pallas_step.py::_build_kernel (:405-454), the exact O(N^2)
// pass of the reference's computeExternalMagnetForce (sim.cu:1223-1241).
// For a valid receiver i and each valid source j != i with
// |temp| < cutoff, temp = pos_i - pos_j:
//   shell:  + |inter| stiffness_i temp_hat where
//           inter = |temp| - (rad_i + rad_j) < 0
//   magnet: - scale_j max_mag_force_i / max(|temp|^2, 1e-12) temp_hat
// The plain PyTorch version, which the card's results are held against, is
// titan_tpu_torch/ops/forces.py::magnet_forces.  The field enters the fused
// step through its constant-force input (ops/fused_step.py), once per force
// pass; the step kernel itself has no magnet code.
//
// Design.  One warp per receiver; its 32 lanes stride over the sources
// (lane l takes j = l, l + 32, ...), each summing its share in index order,
// and a fixed __shfl_xor_sync tree adds the 32 partial sums.  The result is
// deterministic and needs no atomics.  Parameters arrive folded with
// validity as the TPU kernel stages them (pallas_step.py:800-808): [5, N]
// = shell radius, shell stiffness, max pull force, scale (each 0 on invalid
// masses) and the validity flag.  There is no size cap.
//
// Bound.  N(N - 1) pair tests at ~10 operations each (difference 3,
// |d|^2 5, sqrt, cutoff compare) and ~14 more for each pair inside the
// cutoff (shell 4, pull 2, coefficient 2, accumulate 6): 0.63 us per pass
// at N = 2,048 at 67 TFLOP/s f32, where ~8,000 of the 4.2M pairs lie
// inside.  The field moves 41 B per mass (position, four parameters, the
// validity flag; the field), so operations bound it.  Every warp re-reads
// all sources (from L1/L2) in a serial 64-iteration loop with branches:
// 31.5 us per launch at N = 2,048 on an H100 80GB HBM3 at 700 W
// (chip_smoke.py), 50x the bound.  Next: sources staged in shared memory
// by blocks of receivers, and more receivers per warp.
//
// Rounding.  Built with -fmad=false and IEEE sqrt and division
// (titan_tpu_torch/_build.py), so each pair's term is the plain version's;
// only the order of the sum over sources differs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include <cuda_runtime.h>

namespace {

__global__ void pairwise_magnet_kernel(int n, float cutoff,
                                       const float* __restrict__ pos,
                                       const float* __restrict__ prm,
                                       float* __restrict__ out) {
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
  float fx = 0.f, fy = 0.f, fz = 0.f;
  if (valid[i] != 0.f) {
    const float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
    const float rr = rad[i], rs = stiff[i], rm = maxf[i];
    for (int j = lane; j < n; j += 32) {
      if (j == i || valid[j] == 0.f) continue;
      const float dx = px - pos[j];
      const float dy = py - pos[n + j];
      const float dz = pz - pos[2 * n + j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float dist = d2 > 0.f ? sqrtf(d2) : 0.f;
      if (!(dist < cutoff)) continue;
      const float safe = dist > 0.f ? dist : 1.f;
      const float inter = dist - (rr + rad[j]);
      const float shell = inter < 0.f ? fabsf(inter) * rs : 0.f;
      const float attract = scale[j] * rm / fmaxf(d2, 1e-12f);
      const float coeff = (shell - attract) / safe;
      fx = fx + dx * coeff;
      fy = fy + dy * coeff;
      fz = fz + dz * coeff;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    fx = fx + __shfl_xor_sync(0xffffffffu, fx, off);
    fy = fy + __shfl_xor_sync(0xffffffffu, fy, off);
    fz = fz + __shfl_xor_sync(0xffffffffu, fz, off);
  }
  if (lane == 0) {
    out[i] = fx;
    out[n + i] = fy;
    out[2 * n + i] = fz;
  }
}

}  // namespace

// field [3, N] from pos [3, N] and the folded parameters [5, N], on
// `stream`.  Returns 0, or the cudaError_t of the launch.
extern "C" int titan_pairwise_magnet(int n, float cutoff, const float* pos,
                                     const float* params, float* field,
                                     void* stream) {
  const int threads = 256;  // 8 receivers per block
  const int blocks = (n + threads / 32 - 1) / (threads / 32);
  if (blocks > 0) {
    pairwise_magnet_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        n, cutoff, pos, params, field);
  }
  return (int)cudaGetLastError();
}
