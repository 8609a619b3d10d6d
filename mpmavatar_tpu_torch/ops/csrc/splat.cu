// K4: w-weighted quadratic B-spline splat of point values plus a weight
// channel onto the dense grid — the body-mesh collider's face velocity +
// normal (CH = 6) and the joint-pin mover's prescribed velocity (CH = 3).
//
// Replaces: mpmavatar_tpu/ops/pallas_transfer.py::splat_columns_fused
// (inline kernel over _splat_math), with the contract of
// mpmavatar_tpu/core/stepping.py::rasterize_to_grid minus the column
// bins.  Plain PyTorch twin: ops/splat.py::splat_plain.
//
//   grid_vals[cell, c] += w * values[p, c],   grid_w[cell] += w,
// w the 27-node stencil weight of point p.  With the bounds check (the
// reference's, asymmetric: every axis of base in [0, G-3)) a point outside
// it contributes nothing; without it, the scatter's index rule of the JAX
// package applies (a flat index in [-G^3, 0) wraps, the rest outside
// [0, G^3) is dropped).
//
// Bound on an H100: memory.  The dense outputs ((CH+1) floats per cell:
// 58.7 MB at G = 128 and CH = 6, 437.5 MB at G = 250) are written once by
// the wrapper's zero fill, and the kernel reads (3 + CH) floats per point;
// the bound counts both (~0.0178 ms at 128^3 and CH = 6).  The fill alone
// runs at ~90% of it, so what the kernel adds decides the share.
//
// The first design (PRs 2-11) ran one thread per (point, stencil node)
// and added 27 (CH+1) float atomics per point straight into the grid: at
// the posed body's 20,736 faces on 128^3, 0.0778 ms (the fill 0.0206) of a
// 0.0178 ms bound, 23%; 20,000 uncontended random points read 28-33%, so
// the cost was the volume of global atomics, not their contention
// (chip_smoke.py phase 4; H100 80GB HBM3, 700 W).
//
// Design: K2's shared-memory tile, per warp.  splat_kernel takes one
// point per thread, and each warp works alone on its 32 points: it
// reduces their stencil bounding box (min/max of base per axis, plus 3);
// where the box's CH + 1 channels fit the warp's tile (kTileFloats floats
// of dynamic shared memory, channel-major: 768 cells at CH = 6), it adds
// its 27 nodes per point into the tile, then sends each nonzero tile cell
// to the grid once.  A collider's faces come in mesh order: 32
// consecutive faces of the posed body's UV sphere lie on one ring, a box
// of ~270 cells (at most ~750), so the grid sees ~6x fewer cells than
// points x 27 (95k against 560k for the whole splat).  A warp whose box
// does not fit (points in random order, a run across distant parts of
// the mesh) adds its nodes straight into the grid.  Both branches apply
// the index rule (the tile one when it flushes).  The optional
// branch_counts (int32 [2]) counts the warps of each branch.
//
// No atomics in the tile.  At one node (i, j, k), two lanes write one
// tile cell only if their points share a base cell, and then at every
// node: each warp groups its lanes by base cell once
// (__match_any_sync), sums each group's values over the lanes by
// shuffles (ceil(log2 size) rounds, nine nodes at a time), and the
// group's lowest lane adds the sum with a plain load and store; a
// __syncwarp separates the nodes.  The UV sphere's pole rings put up to
// 1,204 points on one base cell, which a shared-memory atomic would
// serialise.
//
// The tile holds floats, not K2's int32 fixed point: K5 treats a cell as
// covered where grid_w > 1e-15 and divides acc / grid_w there, and a
// product of three outer stencil weights is often far below the quantum of
// a block-scaled int32 (~1e-7 of the block's largest sum), so a cell that
// only stencil tails reach would come out uncovered or with acc / w badly
// quantised.  Float sums keep relative precision, as the first design's
// atomics did; only the order of the additions differs from the twin's.
//
// splat_direct_kernel, one thread per (point, node) straight into the
// grid as the first design, takes the launches with more than 7 value
// channels and those with fewer points than ops/splat.py's
// TILE_MIN_POINTS (8,192): a few warps per SM cannot hide
// the tile's chain of 27 nodes, which then is the kernel's time (the joint
// points: 384, the material trainer's mover: 183, the bench collider:
// 4,512 faces).  Both kernels send a cell's CH + 1 channels with Hopper's
// vector atomics (float4 / float2 red into the row where it is 16- /
// 8-byte aligned, scalars elsewhere, and grid_w's scalar): 3 atomics per
// cell at CH = 6 and CH = 3 instead of 7 and 4.
//
// Measured (ab_kernel_times.py, CUDA-graph replays; copies of the tree
// with the edit named; the posed body's faces at 128^3 unless said; H100
// 80GB HBM3, 700 W), with the fill in every time:
//   - kept, step by step: per-warp tiles with a shuffle pass per node
//     0.0377 ms; nine nodes per pass 0.0365; one fill of both outputs in
//     place of two (0.0196 against 0.0205 ms alone) 0.0352; each node's
//     loads before its stores 0.0334 (53% of the bound; without it the
//     compiler chains the kV read-modify-writes, which may alias);
//   - the tile kernel at every size: the joint points 0.0244 against
//     0.0143 with the direct kernel, the bench collider 0.0376 against
//     0.0269;
//   - a block tile (256 points x 3 threads, 192 KB) added into with
//     shared-memory float atomics, which Hopper runs as compare-and-swap
//     loops (ATOMS.CAST.SPIN): 0.0497 ms after the same grouping by base
//     cell, 0.1911 without it (the poles);
//   - binning a block's points by base cell in shared memory (count,
//     scan, place) and gathering each box cell from its 27 neighbour
//     bins, no atomics: 0.0586 ms, its divergent, latency-bound loops the
//     kernel's time (0.0591 with no global atomic at all); one run per
//     (di, dj, dk) in place of one per (di, dj): 0.1238;
//   - a warp tile of 11.5 KB (no opt-in above 48 KB): 0.0409, more warps
//     fall back; 28 KB: 0.0387;
//   - scalar atomics in place of vector ones: 20,000 random points 0.0711
//     ms against 0.0476 (the binned design's flush ran as fast either
//     way).

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "stencil_box.cuh"

namespace {

constexpr int kWarps = 4;                    // per block
constexpr int kThreads = 32 * kWarps;        // one point each
constexpr int kTileFloats = 5376;            // a warp's tile: 21 KB
constexpr size_t kSmem = sizeof(float) * kTileFloats * kWarps;
constexpr int kDirectThreads = 256;          // the direct kernel's block

// Quadratic B-spline weights of one axis for fx = grid_pos - base.
__device__ __forceinline__ void axis_weights(float fx, float w[3]) {
  const float wa = 1.5f - fx, wb = fx - 1.0f, wc = fx - 0.5f;
  w[0] = 0.5f * wa * wa;
  w[1] = 0.75f - wb * wb;
  w[2] = 0.5f * wc * wc;
}

// v summed over the lanes of `peers` (this lane's group, from
// __match_any_sync) into the group's lowest lane: each round a remaining
// lane adds the next remaining one above it, and the lanes at odd ranks
// leave.  Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, float v[N]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above) - 1;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float t = __shfl_sync(0xffffffffu, v[c], next < 0 ? lane : next);
      if (next >= 0) v[c] += t;
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
}

// Channels C.. of a cell's row added into the grid, C at byte A (mod 16)
// of a 16-byte line: a float4 atomic where 4 channels start on a 16-byte
// boundary, a float2 where 2 start on an 8-byte one, else a scalar (all
// indices compile-time, so v stays in registers).
template <int CH, int C, int A>
__device__ __forceinline__ void red_row(float* row, const float v[]) {
  if constexpr (C < CH) {
    if constexpr (A == 0 && C + 4 <= CH) {
      atomicAdd(reinterpret_cast<float4*>(row + C),
                make_float4(v[C], v[C + 1], v[C + 2], v[C + 3]));
      red_row<CH, C + 4, 0>(row, v);
    } else if constexpr (A % 8 == 0 && C + 2 <= CH) {
      atomicAdd(reinterpret_cast<float2*>(row + C),
                make_float2(v[C], v[C + 1]));
      red_row<CH, C + 2, (A + 8) % 16>(row, v);
    } else {
      atomicAdd(row + C, v[C]);
      red_row<CH, C + 1, (A + 4) % 16>(row, v);
    }
  }
}

// One cell's CH values and weight added into the grid: the row of cell c
// starts at byte 4 CH c of grid_vals (16-byte aligned), so at CH = 6 and
// CH = 3 a cell takes 2 vector or scalar atomics and grid_w's scalar.
template <int CH>
__device__ __forceinline__ void red_cell(float* __restrict__ grid_vals,
                                         float* __restrict__ grid_w,
                                         long long cell, const float v[]) {
  float* row = grid_vals + cell * CH;
  switch ((CH * cell) & 3) {      // the row's start, in floats mod 4
    case 0: red_row<CH, 0, 0>(row, v); break;
    case 1: red_row<CH, 0, 4>(row, v); break;
    case 2: red_row<CH, 0, 8>(row, v); break;
    default: red_row<CH, 0, 12>(row, v); break;
  }
  atomicAdd(grid_w + cell, v[CH]);
}

// K4 through warp tiles for CH value channels (1 to 7).  One thread per
// point; each warp works alone on its 32 points.
template <int CH>
__global__ void __launch_bounds__(kThreads, 2) splat_kernel(
    const float* __restrict__ points, const float* __restrict__ values,
    int n, int G, float inv_dx, int bounds_check,
    float* __restrict__ grid_vals, float* __restrict__ grid_w,
    int* __restrict__ branch_counts) {
  constexpr int kV = CH + 1;                 // channels per node
  extern __shared__ float smem[];            // kWarps tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (p - lane >= n) return;                 // the warp holds no point
  int base[3] = {0, 0, 0};
  float w[3][3] = {}, val[CH] = {};
  bool live = p < n;
  if (live) {
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // rounded as the plain version rounds it: a multiply contracted
      // into the subtractions below would move fx by up to half an ulp
      // of x * inv_dx (~4e-6 at G = 200, where inv_dx = 100 is not a
      // power of two) and the floor at ties
      const float gp = __fmul_rn(points[3 * p + a], inv_dx);
      base[a] = static_cast<int>(floorf(gp - 0.5f));
      axis_weights(gp - static_cast<float>(base[a]), w[a]);
      inside = inside && base[a] >= 0 && base[a] < G - 3;
    }
    live = !bounds_check || inside;
  }
  if (live)
#pragma unroll
    for (int c = 0; c < CH; ++c) val[c] = values[p * CH + c];

  // the warp's stencil box
  int lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __reduce_min_sync(0xffffffffu, live ? base[a] : 0x7fffffff);
    hi[a] = __reduce_max_sync(0xffffffffu, live ? base[a] : -0x7fffffff - 1);
  }
  const Box box = make_box(lo, hi, G);
  const bool use_tile = box.cells > 0 && box.cells * kV <= kTileFloats;
  if (lane == 0 && branch_counts != nullptr)
    atomicAdd(branch_counts + (use_tile ? 0 : 1), 1);

  if (use_tile) {
    float* tile = smem + warp * kTileFloats;   // kV x box cells
    const int e1 = box.ext[1], e2 = box.ext[2];
    const int cells = static_cast<int>(box.cells);
    for (int f = lane; f < kV * cells; f += 32) tile[f] = 0.0f;
    __syncwarp();
    // lanes with the same base add into the same cells at every node:
    // their sum goes in through the group's lowest lane, so that at one
    // node no two lanes write one cell
    const int key = live ? ((base[0] - lo[0]) * e1 + base[1] - lo[1]) * e2
                               + base[2] - lo[2]
                         : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const bool grouped = __any_sync(0xffffffffu, peers != (1u << lane));
    const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
    // nine nodes (i, j, k) at a time: their group sums in one pass of
    // shuffles, then one node after another into the tile
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float v[9 * kV];
#pragma unroll
      for (int jk = 0; jk < 9; ++jk) {
        const float wt = w[0][i] * w[1][jk / 3] * w[2][jk % 3];
#pragma unroll
        for (int c = 0; c < CH; ++c) v[kV * jk + c] = wt * val[c];
        v[kV * jk + CH] = wt;
      }
      if (grouped) reduce_peers<9 * kV>(peers, v);
#pragma unroll
      for (int jk = 0; jk < 9; ++jk) {
        if (live && leader) {
          // all loads before all stores: the compiler cannot tell that
          // the channels do not alias, and would else chain kV round trips
          float* t = tile + key + (i * e1 + jk / 3) * e2 + jk % 3;
          float old[kV];
#pragma unroll
          for (int c = 0; c < kV; ++c) old[c] = t[c * cells];
#pragma unroll
          for (int c = 0; c < kV; ++c)
            t[c * cells] = old[c] + v[kV * jk + c];
        }
        __syncwarp();                        // before the next node's reads
      }
    }
    const int e12 = e1 * e2;
    for (int c0 = lane; c0 < cells; c0 += 32) {
      float v[kV];
      bool nonzero = false;
#pragma unroll
      for (int c = 0; c < kV; ++c) {
        v[c] = tile[c * cells + c0];
        nonzero = nonzero || v[c] != 0.0f;
      }
      if (!nonzero) continue;
      const int li = c0 / e12, lj = (c0 - li * e12) / e2;
      const int lk = c0 - li * e12 - lj * e2;
      const long long cell = grid_cell(lo[0] + li, lo[1] + lj, lo[2] + lk,
                                       G);
      if (cell >= 0) red_cell<CH>(grid_vals, grid_w, cell, v);
    }
    return;
  }

  if (!live) return;                         // straight into the grid
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const long long cell =
            grid_cell(base[0] + i, base[1] + j, base[2] + k, G);
        if (cell < 0) continue;
        const float wt = w[0][i] * w[1][j] * w[2][k];
        float v[kV];
#pragma unroll
        for (int c = 0; c < CH; ++c) v[c] = wt * val[c];
        v[CH] = wt;
        red_cell<CH>(grid_vals, grid_w, cell, v);
      }
}

// K4 straight into the grid, one thread per (point, stencil node), for
// inputs too few to fill the card with warps and for more than 7 value
// channels (CH = 0: a runtime `ch`, scalar atomics): the same sums as the
// tile kernel's direct branch.  branch_counts: every 32 points direct.
template <int CH>
__global__ void __launch_bounds__(kDirectThreads) splat_direct_kernel(
    const float* __restrict__ points, const float* __restrict__ values,
    int n, int ch, int G, float inv_dx, int bounds_check,
    float* __restrict__ grid_vals, float* __restrict__ grid_w,
    int* __restrict__ branch_counts) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kDirectThreads + threadIdx.x;
  if (tid >= 27LL * n) return;
  const long long p = tid / 27;
  const int node = static_cast<int>(tid % 27);
  if (node == 0 && p % 32 == 0 && branch_counts != nullptr)
    atomicAdd(branch_counts + 1, 1);
  const int off[3] = {node / 9, (node / 3) % 3, node % 3};
  int base[3];
  float wt = 1.0f;
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float gp = __fmul_rn(points[3 * p + a], inv_dx);   // as above
    base[a] = static_cast<int>(floorf(gp - 0.5f));
    float wa[3];
    axis_weights(gp - static_cast<float>(base[a]), wa);
    wt *= off[a] == 0 ? wa[0] : (off[a] == 1 ? wa[1] : wa[2]);
    inside = inside && base[a] >= 0 && base[a] < G - 3;
  }
  if (bounds_check && !inside) return;
  const long long cell =
      grid_cell(base[0] + off[0], base[1] + off[1], base[2] + off[2], G);
  if (cell < 0) return;
  if constexpr (CH > 0) {
    float v[CH + 1];
#pragma unroll
    for (int c = 0; c < CH; ++c) v[c] = wt * values[p * CH + c];
    v[CH] = wt;
    red_cell<CH>(grid_vals, grid_w, cell, v);
  } else {
    for (int c = 0; c < ch; ++c)
      atomicAdd(grid_vals + cell * ch + c, wt * values[p * ch + c]);
    atomicAdd(grid_w + cell, wt);
  }
}

// the tile kernel's dynamic shared memory, above 48 KB only after opting in
template <int CH>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(splat_kernel<CH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
}

template <int CH>
int launch_tiled(const float* points, const float* values, int n, int G,
                 float inv_dx, int bounds_check, float* grid_vals,
                 float* grid_w, int* branch_counts, cudaStream_t stream) {
  const cudaError_t err = allow_smem<CH>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  splat_kernel<CH><<<blocks, kThreads, kSmem, stream>>>(
      points, values, n, G, inv_dx, bounds_check, grid_vals, grid_w,
      branch_counts);
  return static_cast<int>(cudaGetLastError());
}

template <int CH>
int launch_direct(const float* points, const float* values, int n, int ch,
                  int G, float inv_dx, int bounds_check, float* grid_vals,
                  float* grid_w, int* branch_counts, cudaStream_t stream) {
  const long long work = 27LL * n;
  const int blocks =
      static_cast<int>((work + kDirectThreads - 1) / kDirectThreads);
  splat_direct_kernel<CH><<<blocks, kDirectThreads, 0, stream>>>(
      points, values, n, ch, G, inv_dx, bounds_check, grid_vals, grid_w,
      branch_counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tiled: the warp-tile kernel (1 to 7 channels), else the direct kernel;
// the wrapper picks by the number of points
extern "C" int launch_splat(const float* points, const float* values, int n,
                            int ch, int G, float inv_dx, int bounds_check,
                            int tiled, float* grid_vals, float* grid_w,
                            int* branch_counts, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (ch) {
#define SPLAT_CASE(C)                                                      \
  case C:                                                                  \
    return tiled ? launch_tiled<C>(points, values, n, G, inv_dx,           \
                                   bounds_check, grid_vals, grid_w,        \
                                   branch_counts, s)                       \
                 : launch_direct<C>(points, values, n, ch, G, inv_dx,      \
                                    bounds_check, grid_vals, grid_w,       \
                                    branch_counts, s);
    SPLAT_CASE(1) SPLAT_CASE(2) SPLAT_CASE(3) SPLAT_CASE(4) SPLAT_CASE(5)
    SPLAT_CASE(6) SPLAT_CASE(7)
#undef SPLAT_CASE
    default:
      return launch_direct<0>(points, values, n, ch, G, inv_dx, bounds_check,
                              grid_vals, grid_w, branch_counts, s);
  }
}

// registers, spilled bytes, shared bytes and resident blocks per SM of
// the tile kernel at CH = 6 (the collider) and CH = 3 (the mover), as
// built
extern "C" int splat_info(int ch, int* info) {
  const cudaError_t err = ch == 6 ? allow_smem<6>() : allow_smem<3>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernel = ch == 6
      ? reinterpret_cast<const void*>(splat_kernel<6>)
      : reinterpret_cast<const void*>(splat_kernel<3>);
  return kernel_attributes(kernel, kThreads, kSmem, info);
}
