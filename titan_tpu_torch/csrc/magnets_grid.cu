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
// What it computes.  Each valid receiver sums over its clamped 3 x 3
// neighbour cells in (dx, dy) order, and in each over the first `cell_cap`
// sources of the cell in the stable sort by cell id, in that order, with a
// fixed per-pair arithmetic: deterministic, no atomics.  A source beyond
// the cap acts on nothing but still receives, which is the JAX package's
// overflow branch (titan_tpu/ops/magnets.py:156-163); with no overflow it
// is every valid mass, its grid branch.  So one rule serves both branches
// of its lax.cond (magnets_grid.py:245) and the host never reads an
// overflow count.  Invalid masses carry the sentinel cell (>= G*G): they
// sort after every real cell, so they are no source, and they receive 0.
// Coincident pairs (the self pair among them) contribute nothing.
//
// Design.  The setup runs in PyTorch on the card (ops/magnets_grid.py
// grid_setup): each mass's cell id, one stable sort by cell id (the sorted
// ids and the permutation), the start of each cell's run and of each grid
// row's run in the sorted order (one searchsorted), and the source fields
// and the receivers' stiffness and max force gathered into that order.
// The kernel works on the receivers in sorted order, one block per tile of
// up to kTile consecutive receivers of one grid row x; the invalid masses
// form a last row that receives 0.  Each block finds its tile from the row
// starts (tiles per row, a block scan), so the host builds no tile table;
// the launch is a fixed upper bound of blocks (ceil(N / kTile) + G + 1)
// and spare ones exit.  The tile's cells span y in [ya, yb] of row x, so
// its candidates are each cell's first `cell_cap` sources in rows x - 1 ..
// x + 1, cells ya - 1 .. yb + 1: the block loads those rows' cell starts
// beside its receivers' inputs, then stages the candidates into shared
// memory with cp.async (x, y, z, radius as one float4, the scale beside
// it), cell after cell, so a receiver's three cells of one row are one
// run.  Each thread walks its three runs, 32 sources at a time: first a
// branch-free test of which act (d2 < t_cut, the least float32 whose
// correctly rounded sqrtf is at least the cutoff, which the wrapper
// computes: sqrtf is monotone, so the decision is exactly the plain
// version's sqrtf(d2) < cutoff, taken before any square root), then the
// force of those alone, in order.  A tile whose window is wider than
// kWindow cells a row or holds more than kStage sources walks the same
// candidates in device memory instead (tiles_over_budget in
// ops/magnets_grid.py counts such tiles).  Each thread writes its field to
// the receiver's own column (a unique scatter through the permutation).
//
// Bound.  The candidate pairs that the neighbourhoods hold at ~10
// operations each to test, and ~14 more for the pairs inside the cutoff,
// against the 41 B per mass the field must move (position, four magnet
// parameters, the validity flag; the field): 0.61 us per pass at 50k
// masses on an H100 (by bytes), 5.43 us on the 64^3 soak (by operations).
// On an H100 80GB HBM3 at 700 W (scripts/cuda_grid_field_ab.py) this
// design takes 11.7 us a launch at 50k masses and 45.3 us on the soak,
// against 26.6-26.9 and 101.5-101.7 for the kernel before it (one thread
// per receiver in mass order, each candidate cell a scattered chain of
// loads).  What is left is latency: the swarm fills the card with one
// wave of ~3 warps a scheduler, each block four dependent round trips to
// device memory (the row starts, the receivers and cell starts, the
// stage) before its walk; on the soak, half the warps hold receivers that
// some source acts on, whose force (an IEEE square root and two
// divisions) runs lane by lane.  Tiles of 64 and 256 receivers, 12 or 16
// blocks an SM and an unroll of 1 or 8 were measured and not kept
// (PERF.md section 6).
//
// Rounding.  Built with -fmad=false and IEEE sqrt and division
// (titan_tpu_torch/_build.py); the plain version sums in the same order, so
// the two agree bitwise.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (titan_tpu_torch/_build.py).

#include <cuda_runtime.h>

// receivers a tile (threads a block), blocks an SM that __launch_bounds__
// asks for, and sources a block stages (a tile of 256 needs 1,024 on the
// swarm); scripts/cuda_grid_field_ab.py builds other values with -D
#ifndef TITAN_GRID_TILE
#define TITAN_GRID_TILE 128
#endif
#ifndef TITAN_GRID_BLOCKS
#define TITAN_GRID_BLOCKS 8
#endif
#ifndef TITAN_GRID_STAGE
#define TITAN_GRID_STAGE 512
#endif

namespace {

constexpr int kGrid = 256;             // ops/magnets.py GRID_DIM
constexpr int kRows = kGrid + 1;       // the grid's rows and the invalid row
constexpr int kTile = TITAN_GRID_TILE;
constexpr int kStage = TITAN_GRID_STAGE;
constexpr int kWindow = 96;            // window cells a grid row, at most
constexpr int kWin = 3 * kWindow;      // window cells a block stages
static_assert(kTile % 32 == 0 && kTile <= 1024, "a tile is whole warps");
static_assert(kWin >= kRows, "the row scan reuses the window's table");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Exclusive prefix sum of v[0 .. len) in place, and v[len] = the total
// (len <= kWin), by the block's kTile threads; returns the total.  Starts
// and ends with a barrier.
__device__ int block_scan(int* v, int len, int* warp_sum) {
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (len + kTile - 1) / kTile;
  const int b = min(t * per, len), e = min(b + per, len);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += v[i];
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int run = inc - sum, total = 0;
  for (int w = 0; w < kTile / 32; ++w) {
    if (w < warp) run += warp_sum[w];
    total += warp_sum[w];
  }
  for (int i = b; i < e; ++i) {
    const int x = v[i];
    v[i] = run;
    run += x;
  }
  if (t == 0) v[len] = total;
  __syncthreads();
  return total;
}

// Whether source (sx, sy, sz) acts on a receiver at (px, py, pz): at a
// nonzero distance inside the cutoff, decided on d2 < t_cut, which is
// sqrtf(d2) < cutoff, before the square root.
__device__ __forceinline__ bool inside(float px, float py, float pz,
                                       float t_cut, float sx, float sy,
                                       float sz) {
  const float ex = px - sx;
  const float ey = py - sy;
  const float ez = pz - sz;
  const float d2 = ex * ex + ey * ey + ez * ez;
  return d2 > 0.f && d2 < t_cut;
}

// One candidate source (sx, sy, sz, shell radius sr, scale sc) added to a
// receiver's field f, in the plain version's arithmetic.
__device__ __forceinline__ void add_pair(float3& f, float px, float py,
                                         float pz, float rr, float rs,
                                         float rm, float t_cut, float sx,
                                         float sy, float sz, float sr,
                                         float sc) {
  const float ex = px - sx;
  const float ey = py - sy;
  const float ez = pz - sz;
  const float d2 = ex * ex + ey * ey + ez * ez;
  // d2 < t_cut is sqrtf(d2) < cutoff, decided before the square root
  if (!(d2 > 0.f && d2 < t_cut)) return;
  const float dist = sqrtf(d2);
  const float inter = dist - (rr + sr);
  const float shell = inter < 0.f ? fabsf(inter) * rs : 0.f;
  const float attract = sc * rm / fmaxf(d2, 1e-12f);
  const float coeff = (shell - attract) / dist;
  f.x = f.x + ex * coeff;
  f.y = f.y + ey * coeff;
  f.z = f.z + ez * coeff;
}

__global__ void __launch_bounds__(kTile, TITAN_GRID_BLOCKS)
    grid_magnet_kernel(int n, int cap, float t_cut,
                       const int* __restrict__ csort,
                       const long long* __restrict__ order,
                       const int* __restrict__ starts,
                       const int* __restrict__ rows,
                       const float* __restrict__ src,
                       float* __restrict__ out) {
  __shared__ int row_start[kRows + 1];  // rows, and n after the last
  // the cell starts of grid rows x - 1, x, x + 1 (starts[xr * G + y])
  __shared__ int row_cells[3][kGrid + 1];
  // tiles per row, then the window's per-cell offsets into the stage
  __shared__ int tab[kWin + 1];
  __shared__ int cell_y[kTile];         // each receiver's cell y
  __shared__ int warp_sum[kTile / 32];
  __shared__ int tile_row, tile_first;
  __shared__ float4 stage[kStage];      // x, y, z, shell radius
  __shared__ float stage_sc[kStage];
  const int t = threadIdx.x;
  const int b = blockIdx.x;

  // 1. the tile: tile b of the row-major order, kTile receivers a tile
  //    (the row's last one shorter), row_start[x] .. row_start[x + 1]
  //    row x's receivers
  for (int x = t; x <= kRows; x += kTile) {
    row_start[x] = x < kRows ? rows[x] : n;
  }
  __syncthreads();
  for (int x = t; x < kRows; x += kTile) {
    tab[x] = (row_start[x + 1] - row_start[x] + kTile - 1) / kTile;
  }
  const int tiles = block_scan(tab, kRows, warp_sum);
  if (b >= tiles) return;
  for (int x = t; x < kRows; x += kTile) {
    if (tab[x] <= b && b < tab[x + 1]) {
      tile_row = x;
      tile_first = row_start[x] + (b - tab[x]) * kTile;
    }
  }
  __syncthreads();
  const int x = tile_row;
  const int first = tile_first;
  const int last = min(first + kTile, row_start[x + 1]);
  const int j = first + t;
  const bool mine = j < last;
  const long long i = mine ? order[j] : 0;
  if (x == kGrid) {                     // invalid masses receive 0
    if (mine) {
      out[i] = 0.f;
      out[n + i] = 0.f;
      out[2 * static_cast<long long>(n) + i] = 0.f;
    }
    return;
  }
  // the three rows' cell starts and the receiver's own inputs, loaded
  // together
  for (int c = t; c < 3 * (kGrid + 1); c += kTile) {
    const int r = c / (kGrid + 1), y = c - r * (kGrid + 1);
    const int xr = x - 1 + r;
    if (xr >= 0 && xr < kGrid) row_cells[r][y] = starts[xr * kGrid + y];
  }
  int cy = 0;
  float px = 0.f, py = 0.f, pz = 0.f, rr = 0.f, rs = 0.f, rm = 0.f;
  if (mine) {
    cy = csort[j] % kGrid;
    px = src[j];
    py = src[n + j];
    pz = src[2 * static_cast<long long>(n) + j];
    rr = src[3 * static_cast<long long>(n) + j];
    rs = src[5 * static_cast<long long>(n) + j];
    rm = src[6 * static_cast<long long>(n) + j];
    cell_y[t] = cy;
  }
  __syncthreads();

  // 2. the window: rows x - 1 .. x + 1, cells ylo .. yhi, each cell's
  //    first `cap` sources, staged cell after cell where they fit
  const int ylo = max(cell_y[0] - 1, 0);
  const int yhi = min(cell_y[last - first - 1] + 1, kGrid - 1);
  const int nw = yhi - ylo + 1;
  bool fits = nw <= kWindow;
  if (fits) {
    for (int w = t; w < 3 * nw; w += kTile) {
      const int r = w / nw, xr = x - 1 + r, y = ylo + w - r * nw;
      tab[w] = xr >= 0 && xr < kGrid
                   ? min(row_cells[r][y + 1] - row_cells[r][y], cap)
                   : 0;
    }
    fits = block_scan(tab, 3 * nw, warp_sum) <= kStage;
  }
  if (fits) {
    const int staged = tab[3 * nw];
    for (int k = t; k < staged; k += kTile) {
      int lo = 0, hi = 3 * nw - 1;      // the last cell whose offset <= k
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tab[mid] <= k) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int r = lo / nw;
      const float* s = src + row_cells[r][ylo + lo - r * nw] + (k - tab[lo]);
      cp_async4(&stage[k].x, s);
      cp_async4(&stage[k].y, s + n);
      cp_async4(&stage[k].z, s + 2 * static_cast<long long>(n));
      cp_async4(&stage[k].w, s + 3 * static_cast<long long>(n));
      cp_async4(&stage_sc[k], s + 4 * static_cast<long long>(n));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (!mine) return;

  // 3. the receiver's walk over its 3 x 3 cells, in (dx, dy) order: a
  //    row's three cells are one run of the stage
  float3 f = make_float3(0.f, 0.f, 0.f);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, kGrid - 1);
  for (int r = 0; r < 3; ++r) {
    const int xr = x - 1 + r;
    if (xr < 0 || xr >= kGrid) continue;
    if (fits) {
      // the run's sources 32 at a time: first which act (no branch), then
      // those alone, in order
      const int k1 = tab[r * nw + y1 - ylo + 1];
      for (int k0 = tab[r * nw + y0 - ylo]; k0 < k1; k0 += 32) {
        const int kn = min(k1 - k0, 32);
        unsigned hit = 0u;
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          const float4 q = stage[k0 + k];
          hit |= static_cast<unsigned>(
                     inside(px, py, pz, t_cut, q.x, q.y, q.z))
                 << k;
        }
        while (hit != 0u) {
          const int k = k0 + __ffs(hit) - 1;
          hit &= hit - 1u;
          const float4 q = stage[k];
          add_pair(f, px, py, pz, rr, rs, rm, t_cut, q.x, q.y, q.z, q.w,
                   stage_sc[k]);
        }
      }
    } else {
      for (int y = y0; y <= y1; ++y) {
        const int s0 = row_cells[r][y];
        const int s1 = min(row_cells[r][y + 1], s0 + cap);
        for (int s = s0; s < s1; ++s) {
          add_pair(f, px, py, pz, rr, rs, rm, t_cut, src[s], src[n + s],
                   src[2 * static_cast<long long>(n) + s],
                   src[3 * static_cast<long long>(n) + s],
                   src[4 * static_cast<long long>(n) + s]);
        }
      }
    }
  }
  out[i] = f.x;
  out[n + i] = f.y;
  out[2 * static_cast<long long>(n) + i] = f.z;
}

}  // namespace

// field [3, N] on `stream`.  csort [N] int32 (the cell ids in sorted
// order), order [N] int64 (the sort's permutation), starts [G*G + 1] and
// rows [G + 1] int32 (where each cell's and each grid row's run starts in
// sorted order), src [7, N] (x, y, z, shell radius, scale, stiffness,
// max force in sorted order; ops/magnets_grid.py grid_setup); t_cut the
// least float32 whose sqrtf is at least the cutoff.  Returns 0, or the
// cudaError_t of the launch.
extern "C" int titan_grid_magnet(int n, int cell_cap, float t_cut,
                                 const int* csort, const long long* order,
                                 const int* starts, const int* rows,
                                 const float* src, float* field,
                                 void* stream) {
  if (n > 0) {
    const int blocks = (n + kTile - 1) / kTile + kRows;
    grid_magnet_kernel<<<blocks, kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        n, cell_cap, t_cut, csort, order, starts, rows, src, field);
  }
  return static_cast<int>(cudaGetLastError());
}

// The build's tile (receivers a block), blocks an SM asked for, stage
// (sources a block holds) and window (cells a grid row a block stages):
// out[0..3].  Its registers a thread, local bytes a thread and co-resident
// blocks an SM on `device`: out[4..6].  Returns 0 or a CUDA error.
extern "C" int titan_grid_kernel_info(int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, grid_magnet_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grid_magnet_kernel, kTile, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kTile;
  out[1] = TITAN_GRID_BLOCKS;
  out[2] = kStage;
  out[3] = kWindow;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  out[6] = per_sm;
  return 0;
}
