// The stencil bounding box of a block's points, and the scatter's index
// rule, shared by the kernels that accumulate or gather through a
// shared-memory tile of that box (K2 and K3 in transfer.cu, K4 in
// splat.cu).

#pragma once

#include <cuda_runtime.h>

// Every thread calls box_warps (per warp, the min and max base of each
// axis over its live points), then, after a __syncthreads, box_of.
template <int kWarps>
struct BoxScratch {
  int lo[3][kWarps], hi[3][kWarps];
};

struct Box {
  int lo[3], ext[3];   // corner and extents (capped at 2^20 per axis)
  long long cells;     // product of the capped extents; 0: no live point
  bool inside;         // within [0, G)^3 on every axis
};

template <int kWarps>
__device__ __forceinline__ void box_warps(const int base[3], bool live,
                                          BoxScratch<kWarps>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int a = 0; a < 3; ++a) {
    const int lo = __reduce_min_sync(0xffffffffu, live ? base[a]
                                                       : 0x7fffffff);
    const int hi = __reduce_max_sync(0xffffffffu, live ? base[a]
                                                       : -0x7fffffff - 1);
    if (lane == 0) {
      s.lo[a][warp] = lo;
      s.hi[a][warp] = hi;
    }
  }
}

// The box of the per-axis min (lo) and max (hi) base of a block's live
// points.
__device__ __forceinline__ Box make_box(const int lo[3], const int hi[3],
                                        int G) {
  Box b;
  b.cells = 1;
  b.inside = true;
  for (int a = 0; a < 3; ++a) {
    const long long ext = static_cast<long long>(hi[a]) - lo[a] + 3;
    // capped before the product, which three extents of up to 2^32 (bases
    // far outside the grid) would overflow; no live point: ext < 0, 0 cells
    const long long capped = max(min(ext, 1LL << 20), 0LL);
    b.cells *= capped;
    b.lo[a] = lo[a];
    b.ext[a] = static_cast<int>(capped);
    b.inside = b.inside && lo[a] >= 0 && lo[a] + ext <= G;
  }
  return b;
}

// The box from the warps' entries.
template <int kWarps>
__device__ __forceinline__ Box box_of(const BoxScratch<kWarps>& s, int G) {
  int lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = s.lo[a][0];
    hi[a] = s.hi[a][0];
    for (int w = 1; w < kWarps; ++w) {
      lo[a] = min(lo[a], s.lo[a][w]);
      hi[a] = max(hi[a], s.hi[a][w]);
    }
  }
  return make_box(lo, hi, G);
}

// The scatter's index rule of the JAX package (.at[].add(mode="drop")):
// the cell of grid coordinates (gi, gj, gk), a flat index in [-G^3, 0)
// wrapped to flat + G^3, or -1 where it is dropped.
__device__ __forceinline__ long long grid_cell(int gi, int gj, int gk,
                                               int G) {
  const long long n_cells = static_cast<long long>(G) * G * G;
  const long long flat =
      (static_cast<long long>(gi) * G + gj) * G + gk;
  const long long cell = flat < 0 ? flat + n_cells : flat;
  return (cell < 0 || cell >= n_cells) ? -1 : cell;
}
