// Dense-grid magnet field for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel titan_tpu/ops/magnets_grid.py::_grid_kernel (:64),
// launched by grid_magnet_forces (:139): the magnet field of every mass from
// the sources in its 3 x 3 neighbourhood on a 256 x 256 grid of
// cutoff-sized cells (reference computeExternalMagnetForcesOG,
// sim.cu:1250-1281, pair physics computeExternalMagnetForce,
// sim.cu:1223-1241).  The plain PyTorch version, which the card's results
// are held against, is
// titan_tpu_torch/ops/magnets_grid.py::grid_magnet_forces_plain.
//
// Design.  The setup runs in PyTorch on the card (ops/magnets_grid.py
// grid_setup): each mass's cell id, one stable sort by cell id, the start
// of each cell's run in the sorted order, and the source fields gathered
// into that order, so a cell's sources are contiguous.  Then one thread per
// receiver, in the original mass order, walks the 3 x 3 neighbour cells
// that lie on the grid, in (dx, dy) order, and in each the first
// `cell_cap` sources of the cell in sorted order, accumulating in that
// fixed order: deterministic, no atomics, no slot table.  A source beyond
// the cap acts on nothing but still receives, which is the JAX package's
// overflow branch (titan_tpu/ops/magnets.py:156-163); with no overflow it is
// every valid mass, its grid branch.  So one rule serves both branches of
// its lax.cond (magnets_grid.py:245) and the host never reads an overflow
// count.  Invalid masses carry the sentinel cell (>= G*G): they sort after
// every real cell, so they are no source, and they receive 0.  Coincident
// pairs (the self pair among them) contribute nothing.
//
// Bound.  The candidate pairs that the neighbourhoods hold (~36 per mass at
// ~4 masses per cell) at ~10 operations each to test, and ~14 more for the
// few inside the cutoff, against the 41 B per mass the field must move
// (position, four magnet parameters, the validity flag; the field): 0.61
// us per pass at 50k masses on an H100, by bytes.  The threads of a warp
// are receivers in different cells, so each candidate cell is its own
// scattered read: 26.6-27.0 us per launch at 50k masses on an H100 80GB
// HBM3 at 700 W (chip_smoke.py), ~44x the bound.  Next: one block per cell
// row with its 3 x 3 sources staged in shared memory.
//
// Rounding.  Built with -fmad=false and IEEE sqrt and division
// (titan_tpu_torch/_build.py); the plain version sums in the same order, so
// the two agree bitwise.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kGrid = 256;  // ops/magnets.py GRID_DIM

__global__ void grid_magnet_kernel(int n, int cap, float cutoff,
                                   const int* __restrict__ cell,
                                   const int* __restrict__ starts,
                                   const float* __restrict__ src,
                                   const float* __restrict__ pos,
                                   const float* __restrict__ rad,
                                   const float* __restrict__ stiff,
                                   const float* __restrict__ maxf,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  const int c = cell[i];
  if (c < kGrid * kGrid) {
    const int cx = c / kGrid, cy = c % kGrid;
    const float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
    const float rr = rad[i], rs = stiff[i], rm = maxf[i];
    for (int dx = -1; dx <= 1; ++dx) {
      const int x = cx + dx;
      if (x < 0 || x >= kGrid) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int y = cy + dy;
        if (y < 0 || y >= kGrid) continue;
        const int cc = x * kGrid + y;
        const int s0 = starts[cc];
        const int s1 = min(starts[cc + 1], s0 + cap);
        for (int s = s0; s < s1; ++s) {
          const float ex = px - src[s];
          const float ey = py - src[n + s];
          const float ez = pz - src[2 * n + s];
          const float d2 = ex * ex + ey * ey + ez * ez;
          if (!(d2 > 0.f)) continue;
          const float dist = sqrtf(d2);
          if (!(dist < cutoff)) continue;
          const float inter = dist - (rr + src[3 * n + s]);
          const float shell = inter < 0.f ? fabsf(inter) * rs : 0.f;
          const float attract = src[4 * n + s] * rm / fmaxf(d2, 1e-12f);
          const float coeff = (shell - attract) / dist;
          fx = fx + ex * coeff;
          fy = fy + ey * coeff;
          fz = fz + ez * coeff;
        }
      }
    }
  }
  out[i] = fx;
  out[n + i] = fy;
  out[2 * n + i] = fz;
}

}  // namespace

// field [3, N] on `stream`.  cell [N] and starts [G*G + 1] int32, src [5, N]
// (x, y, z, shell radius, scale in cell order; ops/magnets_grid.py
// grid_setup); pos [3, N]; rad, stiffness, max_mag_force [N].  Returns 0, or
// the cudaError_t of the launch.
extern "C" int titan_grid_magnet(int n, int cell_cap, float cutoff,
                                 const int* cell, const int* starts,
                                 const float* src, const float* pos,
                                 const float* rad, const float* stiffness,
                                 const float* max_mag_force, float* field,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    grid_magnet_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        n, cell_cap, cutoff, cell, starts, src, pos, rad, stiffness,
        max_mag_force, field);
  }
  return (int)cudaGetLastError();
}
