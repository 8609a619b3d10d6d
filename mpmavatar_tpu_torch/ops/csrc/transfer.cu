// K2 (P2G) and K3 (G2P): APIC transfers between particles and the dense
// grid over the 27-node quadratic B-spline stencil.
//
// Replaces: mpmavatar_tpu/ops/pallas_transfer.py::_p2g_pallas (math in
// _p2g_math; contract of p2g_columns_fused / core/stepping.py::p2g) and
// ::_g2p_pallas (math in _g2p_math; contract of g2p_columns_fused /
// stepping.gather_quantities).  The TPU kernels pack particles into
// (x, y) column bins so the MXU can do the transfer without atomics; on
// Hopper the port keeps the contract and drops that layout.  Plain
// PyTorch twins: ops/transfer.py::p2g_plain / g2p_plain.
//
// Grid layout: flat x-major, cell (i, j, k) -> (i*G + j)*G + k, velocity
// (G^3, 3) channel-last, mass (G^3,).
//
// P2G bound on an H100: its ~80 B per particle of input and the 16 B per
// cell of dense output (~42 MB at P = 99,737, G = 128) take ~13 us at
// 3.35 TB/s.  The first design (one thread per particle, 27 x 4 = 108
// float atomicAdds per particle straight into the zeroed dense grid, ~10.8
// M per substep) ran at 0.1047 ms, 12% of that bound, on an H100 80GB
// HBM3 at 700 W: the atomics serialise where neighbouring particles hit
// the same cells, and on a cloth they always do.
//
// Design: accumulate in shared memory, send each cell to the grid once
// per block.  A block of kP2GThreads threads takes as many consecutive
// particles, one each, and reduces their stencil bounding box (min/max of
// base per axis, plus 3).  Where the box fits a tile of kTileCells cells
// (4 channels of int32: 32 KB), the block adds every stencil node into
// the tile with shared-memory atomics, then adds each nonzero tile cell
// into the grid with one global atomic per channel.  On the cloth, whose
// particles come in mesh order, 128 consecutive particles lie on one or
// two rows of the mesh: their box is a few hundred to ~900 cells, so the
// grid sees a few atomics per particle instead of 108.  A block whose box
// does not fit (particles in random order, such as the bench's sand
// block, or a run that spans two distant rows of the mesh) adds its nodes
// straight into the grid, as the first design did; both branches apply
// the index rule below, the tile one when it flushes.  The optional
// branch_counts (int32 [2]) counts the blocks of each branch.
//
// The tile holds fixed point, not float: on the H100 a float tile of the
// same shape, added into with float shared-memory atomics, ran markedly
// slower than int32 atomics into this one.  Each
// block scales channel a by 2^31 / (kP2GThreads * 1.001 * m_a), m_a the
// largest bound of a node value over its particles (p2g_bound), so no
// cell's sum can overflow and one unit is ~6e-8 m_a: below the float
// rounding the plain version's sums carry.  Within a block the sums are
// exact, so only the order of the flushes' global atomics varies.
// Kept over warp aggregation (__match_any_sync on the flat cell per
// stencil node, one atomic per distinct cell per warp): 32 consecutive
// particles of the cloth still span ~10 cells along a mesh row, so a warp
// saves ~3x of the global atomics, where a block's tile saves more.
//
// G2P bound: memory — 12 B of position in, 84 B out per particle, plus the
// grid cells the stencils touch (~9.6 MB at P = 99,737: ~2.9 us at 3.35
// TB/s); its ~1,900 FP32 operations per particle take about as long.  The
// first design (one thread per particle, 81 scalar gathers of grid_v and
// 21 scalar stores at 12 B and 36 B strides) ran at 0.0195 ms, 15% of
// that bound, on an H100 80GB HBM3 at 700 W.
//
// Design: the gather twin of K2's tile.  A block of kG2PThreads
// consecutive particles copies its positions' slab into shared memory
// (staging.cuh) and reduces its stencil bounding box as K2 does (box_warps,
// box_of).  Where the box fits a tile of kG2PTileCells cells and lies
// inside [0, G)^3 — so that no stencil node reaches the clip of flat
// indices, which would read another cell than its (i, j, k) — the block
// copies the box's z-runs of grid_v into the tile with asynchronous
// copies and gathers its 27 nodes from there; any other block (particles
// in random order, such as the bench's sand, a run across two distant
// rows of the mesh, a box at the grid's faces) gathers straight from
// grid_v as the first design did.  Both branches take the nodes in the
// same order and sum them alike, so they agree bit for bit; no atomics.
// The 21 outputs per particle are staged through the same shared memory
// and leave in 16-byte vectors.  The optional branch_counts (int32 [2])
// counts the blocks of each branch.  Kept by timing (graph replays at the
// cloth drop's shape, a script not in the repo): 256 threads and at most
// 80 registers (3 blocks per SM, the 390 blocks one wave) over 128
// threads at 6 blocks; the loops unrolled (the weights stay in registers
// where the first design kept them on the stack); cp.async over
// synchronous loads; a box per block over a box per warp with a tile each
// (at 128^3 a warp that wraps from one mesh row to the next has a box of
// ~730 cells, so either a sixth of the warps gather straight from the grid
// or the tiles take twice the shared memory, and both ran slower).  Not
// kept: per-warp tiles as a fallback for the blocks whose box does not fit
// (the cloth drop's two blocks that straddle distant runs of the mesh) —
// the same particles reordered so that no block straddles ran no faster.
// The time is the one wave's phases one after the other: the positions
// in, the box, the tile, the 27 nodes, the outputs out.

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "staging.cuh"
#include "stencil_box.cuh"

namespace {

// Quadratic B-spline weights w[o] and derivatives dw[o] (unscaled) of one
// axis, for fx = grid_pos - base in [0.5, 1.5).
__device__ __forceinline__ void axis_weights(float fx, float w[3],
                                             float dw[3]) {
  const float wa = 1.5f - fx, wb = fx - 1.0f, wc = fx - 0.5f;
  w[0] = 0.5f * wa * wa;
  w[1] = 0.75f - wb * wb;
  w[2] = 0.5f * wc * wc;
  dw[0] = fx - 1.5f;
  dw[1] = -2.0f * (fx - 1.0f);
  dw[2] = fx - 0.5f;
}

constexpr int kP2GThreads = 128;     // one particle per thread
constexpr int kP2GMinBlocks = 8;     // blocks per SM: <= 64 registers
constexpr int kTileCells = 2048;     // K2: x 4 channels x 4 B = 32 KB
constexpr int kG2PThreads = 256;     // one particle per thread
constexpr int kG2PMinBlocks = 3;     // <= 80 registers
constexpr int kG2PTileCells = 2048;  // K3: x 3 channels x 4 B = 24 KB

// One particle's quadratic B-spline stencil: base node, fractional
// position and per-axis weights and derivatives (w[axis][offset]).
struct Stencil {
  int base[3];
  float fx[3], w[3][3], dw[3][3];
};

__device__ __forceinline__ void stencil_at(float x0, float x1, float x2,
                                           float inv_dx, Stencil& q) {
  const float pos[3] = {x0, x1, x2};
  for (int a = 0; a < 3; ++a) {
    // rounded, as the plain versions and JAX round it: contracted into the
    // floor's and fx's subtractions (an FMA) it moves fx by up to half an
    // ulp of x / dx (~8e-6 at 250^3, where 1 / dx = 125 makes the product
    // inexact) and a base at a rounding tie by one cell
    const float gp = __fmul_rn(pos[a], inv_dx);
    q.base[a] = static_cast<int>(floorf(gp - 0.5f));
    q.fx[a] = gp - static_cast<float>(q.base[a]);
    axis_weights(q.fx[a], q.w[a], q.dw[a]);
  }
}

// One particle's stencil and attributes, in registers.
struct P2GParticle : Stencil {
  float s, ms, vp[3], cm[9], sm[9];   // sm: stress, or vforce in sm[0..2]
  bool vertex;
};

__device__ __forceinline__ void p2g_load(
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ c_eff, const float* __restrict__ mass,
    const float* __restrict__ sel, const float* __restrict__ stress,
    const float* __restrict__ vforce, int p, int n_nonvertex, float inv_dx,
    P2GParticle& q) {
  stencil_at(x[3 * p], x[3 * p + 1], x[3 * p + 2], inv_dx, q);
  q.s = sel[p];
  q.ms = mass[p] * q.s;
  for (int a = 0; a < 3; ++a) q.vp[a] = v[3 * p + a];
  for (int k = 0; k < 9; ++k) q.cm[k] = c_eff[9 * p + k];
  q.vertex = p >= n_nonvertex;
  if (q.vertex) {
    for (int a = 0; a < 3; ++a) q.sm[a] = vforce[3 * (p - n_nonvertex) + a];
  } else {
    for (int k = 0; k < 9; ++k) q.sm[k] = stress[9 * p + k];
  }
}

// Stencil node (i, j, k) of particle q: out = (momentum + force, mass).
__device__ __forceinline__ void p2g_node(const P2GParticle& q, int i, int j,
                                         int k, float inv_dx, float dx,
                                         float out[4]) {
  const float wt = q.w[0][i] * q.w[1][j] * q.w[2][k];
  const float dpos[3] = {(i - q.fx[0]) * dx, (j - q.fx[1]) * dx,
                         (k - q.fx[2]) * dx};
  float force[3];
  if (q.vertex) {
    for (int a = 0; a < 3; ++a) force[a] = wt * q.sm[a];
  } else {
    const float gw[3] = {q.dw[0][i] * q.w[1][j] * q.w[2][k] * inv_dx,
                         q.w[0][i] * q.dw[1][j] * q.w[2][k] * inv_dx,
                         q.w[0][i] * q.w[1][j] * q.dw[2][k] * inv_dx};
    for (int a = 0; a < 3; ++a)
      force[a] = -(q.sm[3 * a] * gw[0] + q.sm[3 * a + 1] * gw[1]
                   + q.sm[3 * a + 2] * gw[2]);
  }
  const float mw = wt * q.ms;
  for (int a = 0; a < 3; ++a) {
    const float mom = q.vp[a] + (q.cm[3 * a] * dpos[0]
                                 + q.cm[3 * a + 1] * dpos[1]
                                 + q.cm[3 * a + 2] * dpos[2]);
    out[a] = mw * mom + q.s * force[a];
  }
  out[3] = mw;
}

// An upper bound of |p2g_node(q, ...)[a]| over the 27 nodes, per channel:
// w <= 1, |o - fx| <= 1.5, |dw| <= 1 and w <= 0.75 in grad w.
__device__ __forceinline__ void p2g_bound(const P2GParticle& q, float inv_dx,
                                          float dx, float b[4]) {
  for (int a = 0; a < 3; ++a) {
    const float c = fabsf(q.cm[3 * a]) + fabsf(q.cm[3 * a + 1])
                    + fabsf(q.cm[3 * a + 2]);
    const float f = q.vertex
        ? fabsf(q.sm[a])
        : 0.5625f * inv_dx * (fabsf(q.sm[3 * a]) + fabsf(q.sm[3 * a + 1])
                              + fabsf(q.sm[3 * a + 2]));
    b[a] = fabsf(q.ms) * (fabsf(q.vp[a]) + 1.5f * dx * c) + fabsf(q.s) * f;
  }
  b[3] = fabsf(q.ms);
}

__device__ __forceinline__ void add_cell(float* __restrict__ grid_v,
                                         float* __restrict__ grid_m,
                                         long long cell, const float val[4]) {
  for (int a = 0; a < 3; ++a) atomicAdd(grid_v + 3 * cell + a, val[a]);
  atomicAdd(grid_m + cell, val[3]);
}

// The 27 nodes of particle q into a channel-major fixed-point tile
// (channel a of cell c at t[a * kTileCells + c], in units of 1 / scale[a])
// whose box starts at lo, e1 x e2 cells on axes 1 and 2.
__device__ __forceinline__ void tile_add(int* t, const int lo[3], int e1,
                                         int e2, const P2GParticle& q,
                                         float inv_dx, float dx,
                                         const float scale[4]) {
  const int o0 = q.base[0] - lo[0], o1 = q.base[1] - lo[1],
            o2 = q.base[2] - lo[2];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) {
        float val[4];
        p2g_node(q, i, j, k, inv_dx, dx, val);
        int* c = t + ((o0 + i) * e1 + o1 + j) * e2 + o2 + k;
        for (int a = 0; a < 4; ++a)
          atomicAdd(c + a * kTileCells, __float2int_rn(val[a] * scale[a]));
      }
}

// Cells c0, c0 + step, ... < cells of such a tile into the grid, one
// global atomic per channel of each nonzero cell, by the index rule.
__device__ __forceinline__ void tile_flush(const int* t, const int lo[3],
                                           int e1, int e2, int cells, int c0,
                                           int step, const float scale[4],
                                           int G, float* __restrict__ grid_v,
                                           float* __restrict__ grid_m) {
  for (int c = c0; c < cells; c += step) {
    const int raw[4] = {t[c], t[kTileCells + c], t[2 * kTileCells + c],
                        t[3 * kTileCells + c]};
    if (raw[0] == 0 && raw[1] == 0 && raw[2] == 0 && raw[3] == 0) continue;
    const int lk = c % e2, lj = (c / e2) % e1, li = c / (e2 * e1);
    const long long cell = grid_cell(lo[0] + li, lo[1] + lj, lo[2] + lk, G);
    if (cell < 0) continue;
    float val[4];
    for (int a = 0; a < 4; ++a)
      val[a] = static_cast<float>(raw[a]) / scale[a];
    add_cell(grid_v, grid_m, cell, val);
  }
}

// The 27 nodes of particle q straight into the grid.
__device__ __forceinline__ void direct_add(const P2GParticle& q, int G,
                                           float inv_dx, float dx,
                                           float* __restrict__ grid_v,
                                           float* __restrict__ grid_m) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) {
        const long long cell =
            grid_cell(q.base[0] + i, q.base[1] + j, q.base[2] + k, G);
        if (cell < 0) continue;
        float val[4];
        p2g_node(q, i, j, k, inv_dx, dx, val);
        add_cell(grid_v, grid_m, cell, val);
      }
}

// K2.  Contract: stress (n_nonvertex, 3, 3) and vforce (n - n_nonvertex,
// 3) arrive multiplied by dt (traditional stress also by vol); the kernel
// applies mass*sel to the momentum and sel to the force terms, so
//   grid_v += w*mass*sel*(v + C_eff (o - fx) dx) + sel*F,
//   F = -stress . grad w (non-vertex)  or  w * vforce (vertex),
//   grid_m += w*mass*sel,
// with the scatter's index rule of the JAX package (.at[].add(mode=
// "drop")): a flat index in [-G^3, 0) wraps to flat + G^3, and what still
// lies outside [0, G^3) is dropped.
__global__ void __launch_bounds__(kP2GThreads, kP2GMinBlocks) p2g_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ c_eff, const float* __restrict__ mass,
    const float* __restrict__ sel, const float* __restrict__ stress,
    const float* __restrict__ vforce, int n, int n_nonvertex, int G,
    float inv_dx, float dx, float* __restrict__ grid_v,
    float* __restrict__ grid_m, int* __restrict__ branch_counts) {
  constexpr int kWarps = kP2GThreads / 32;
  extern __shared__ int tile[];                  // 4 x kTileCells
  __shared__ BoxScratch<kWarps> s_scratch;
  __shared__ int s_bound[4][kWarps];
  __shared__ int s_box[3], s_ext[3], s_use_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kP2GThreads + threadIdx.x;
  const bool live = p < n;
  P2GParticle q;
  if (live)
    p2g_load(x, v, c_eff, mass, sel, stress, vforce, p, n_nonvertex, inv_dx,
             q);

  // the block's stencil bounding box, and the largest node value of its
  // particles per channel (non-negative floats order as their bits)
  float b[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) p2g_bound(q, inv_dx, dx, b);
  box_warps(q.base, live, s_scratch);
  for (int a = 0; a < 4; ++a) {
    const int m = __reduce_max_sync(0xffffffffu, __float_as_int(b[a]));
    if (lane == 0) s_bound[a][warp] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const Box box = box_of(s_scratch, G);
    for (int a = 0; a < 3; ++a) {
      s_box[a] = box.lo[a];
      s_ext[a] = box.ext[a];
    }
    s_use_tile = box.cells <= kTileCells;
    if (branch_counts != nullptr)
      atomicAdd(branch_counts + (s_use_tile ? 0 : 1), 1);
  }
  __syncthreads();

  if (!s_use_tile) {                       // straight into the grid
    if (live) direct_add(q, G, inv_dx, dx, grid_v, grid_m);
    return;
  }
  // the tile's fixed point: a cell sums at most kP2GThreads node values,
  // each at most the block's bound, so |sum| * scale < 2^31
  float scale[4];
  for (int a = 0; a < 4; ++a) {
    float m = 0.f;
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, __int_as_float(s_bound[a][w]));
    scale[a] = 2147483648.f / (kP2GThreads * 1.001f * fmaxf(m, 1e-30f));
  }
  const int lo[3] = {s_box[0], s_box[1], s_box[2]};
  const int e1 = s_ext[1], e2 = s_ext[2];
  const int cells = s_ext[0] * e1 * e2;
  for (int c = threadIdx.x; c < cells; c += kP2GThreads)
    for (int a = 0; a < 4; ++a) tile[a * kTileCells + c] = 0;
  __syncthreads();
  if (live) tile_add(tile, lo, e1, e2, q, inv_dx, dx, scale);
  __syncthreads();
  tile_flush(tile, lo, e1, e2, cells, threadIdx.x, kP2GThreads, scale, G,
             grid_v, grid_m);
}

// One stencil node's terms of K3 for particle q: g the node's velocity.
__device__ __forceinline__ void g2p_node(const Stencil& q, int i, int j,
                                         int k, const float g[3],
                                         float inv_dx, float nv[3],
                                         float nc[9], float gv[9]) {
  const float wt = q.w[0][i] * q.w[1][j] * q.w[2][k];
  const float wc = wt * inv_dx * 4.0f;
  const float dpos[3] = {i - q.fx[0], j - q.fx[1], k - q.fx[2]};
  const float gw[3] = {q.dw[0][i] * q.w[1][j] * q.w[2][k] * inv_dx,
                       q.w[0][i] * q.dw[1][j] * q.w[2][k] * inv_dx,
                       q.w[0][i] * q.w[1][j] * q.dw[2][k] * inv_dx};
  for (int a = 0; a < 3; ++a) {
    nv[a] += wt * g[a];
    for (int b = 0; b < 3; ++b) {
      nc[3 * a + b] += wc * g[a] * dpos[b];
      gv[3 * a + b] += g[a] * gw[b];
    }
  }
}

// K3.  new_v = sum w v;  new_C = 4 inv_dx sum w v (o - fx)^T (unitless
// offset);  grad_v = sum v (grad w)^T; stencil indices clipped to
// [0, G^3 - 1].  Per block: positions in, the box test, the gathers (from
// the block's shared-memory tile of grid_v, or straight from grid_v), the
// outputs staged out; the node order and sums are the same in both
// branches, so they agree bit for bit.
__global__ void __launch_bounds__(kG2PThreads, kG2PMinBlocks) g2p_kernel(
    const float* __restrict__ x, const float* __restrict__ grid_v, int n,
    int G, float inv_dx, float* __restrict__ new_v,
    float* __restrict__ new_c, float* __restrict__ grad_v,
    int* __restrict__ branch_counts) {
  constexpr int kWarps = kG2PThreads / 32;
  // in turn: the positions' slab, the tile (3 x kG2PTileCells, cell-major
  // as grid_v), the outputs' slabs (new_v, new_C, grad_v)
  extern __shared__ __align__(16) float smem[];
  __shared__ BoxScratch<kWarps> s_scratch;
  const long long p0 = static_cast<long long>(blockIdx.x) * kG2PThreads;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kG2PThreads), n - p0));
  const int t = threadIdx.x;
  const bool live = t < rows;
  staging::load_async<kG2PThreads>(smem, x + 3 * p0, 3 * rows);
  staging::wait_copies();
  __syncthreads();
  Stencil q;
  if (live)
    stencil_at(smem[3 * t], smem[3 * t + 1], smem[3 * t + 2], inv_dx, q);
  box_warps(q.base, live, s_scratch);
  __syncthreads();
  // every thread reduces the warps' boxes (broadcast reads): no serial
  // section, no further barrier.  The tile holds the box's cells by their
  // (i, j, k); the clip of flat indices leaves those of a box inside the
  // grid as they are
  const Box box = box_of(s_scratch, G);
  const bool use_tile = box.inside && box.cells <= kG2PTileCells;
  if (t == 0 && branch_counts != nullptr)
    atomicAdd(branch_counts + (use_tile ? 0 : 1), 1);

  float nv[3] = {0.f, 0.f, 0.f}, nc[9] = {0.f}, gv[9] = {0.f};
  if (use_tile) {
    // each warp copies whole z-runs of the box (3 e2 contiguous floats of
    // grid_v per (i, j)), its lanes on consecutive floats
    const int e1 = box.ext[1], e2 = box.ext[2], run = 3 * e2;
    const int warp = t >> 5, lane = t & 31;
    for (int r = warp; r < box.ext[0] * e1; r += kWarps) {
      const int li = r / e1, lj = r - li * e1;
      const float* src = grid_v + 3 * ((static_cast<long long>(
          box.lo[0] + li) * G + box.lo[1] + lj) * G + box.lo[2]);
      for (int f = lane; f < run; f += 32)
        staging::copy4(smem + r * run + f, src + f);
    }
    staging::wait_copies();
    __syncthreads();
    if (live) {
      const int o0 = q.base[0] - box.lo[0], o1 = q.base[1] - box.lo[1],
                o2 = q.base[2] - box.lo[2];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float* c = smem + 3 * (((o0 + i) * e1 + o1 + j) * e2
                                         + o2 + k);
            const float g[3] = {c[0], c[1], c[2]};
            g2p_node(q, i, j, k, g, inv_dx, nv, nc, gv);
          }
    }
  } else if (live) {
    const long long last = static_cast<long long>(G) * G * G - 1;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          long long flat = (static_cast<long long>(q.base[0] + i) * G
                            + (q.base[1] + j)) * G + (q.base[2] + k);
          flat = flat < 0 ? 0 : (flat > last ? last : flat);
          const float g[3] = {__ldg(grid_v + 3 * flat),
                              __ldg(grid_v + 3 * flat + 1),
                              __ldg(grid_v + 3 * flat + 2)};
          g2p_node(q, i, j, k, g, inv_dx, nv, nc, gv);
        }
  }
  __syncthreads();                       // the tile is read: stage outputs
  float* s_v = smem;
  float* s_c = smem + 3 * kG2PThreads;
  float* s_g = smem + 12 * kG2PThreads;
  if (live) {
    for (int a = 0; a < 3; ++a) s_v[3 * t + a] = nv[a];
    for (int k = 0; k < 9; ++k) {
      s_c[9 * t + k] = nc[k];
      s_g[9 * t + k] = gv[k];
    }
  }
  __syncthreads();
  staging::store<kG2PThreads>(new_v + 3 * p0, s_v, 3 * rows);
  staging::store<kG2PThreads>(new_c + 9 * p0, s_c, 9 * rows);
  staging::store<kG2PThreads>(grad_v + 9 * p0, s_g, 9 * rows);
}

// the shared memory K3 asks for at launch: the tile, which outsizes the
// positions' and the outputs' slabs
constexpr size_t kG2PSmem = 3 * sizeof(float) * kG2PTileCells;
static_assert(kG2PSmem >= 21 * sizeof(float) * kG2PThreads,
              "the outputs' slabs must fit the tile's shared memory");
constexpr size_t kP2GSmem = 4 * sizeof(int) * kTileCells;   // < 48 KB

}  // namespace

extern "C" int launch_p2g(const float* x, const float* v, const float* c_eff,
                          const float* mass, const float* sel,
                          const float* stress, const float* vforce, int n,
                          int n_nonvertex, int G, float inv_dx, float dx,
                          float* grid_v, float* grid_m, int* branch_counts,
                          void* stream) {
  const int blocks = (n + kP2GThreads - 1) / kP2GThreads;
  p2g_kernel<<<blocks, kP2GThreads, kP2GSmem,
               static_cast<cudaStream_t>(stream)>>>(
      x, v, c_eff, mass, sel, stress, vforce, n, n_nonvertex, G, inv_dx, dx,
      grid_v, grid_m, branch_counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_g2p(const float* x, const float* grid_v, int n, int G,
                          float inv_dx, float* new_v, float* new_c,
                          float* grad_v, int* branch_counts, void* stream) {
  const int blocks = (n + kG2PThreads - 1) / kG2PThreads;
  g2p_kernel<<<blocks, kG2PThreads, kG2PSmem,
               static_cast<cudaStream_t>(stream)>>>(
      x, grid_v, n, G, inv_dx, new_v, new_c, grad_v, branch_counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2g_info(int* info) {
  return kernel_attributes(reinterpret_cast<const void*>(p2g_kernel),
                           kP2GThreads, kP2GSmem, info);
}

extern "C" int g2p_info(int* info) {
  return kernel_attributes(reinterpret_cast<const void*>(g2p_kernel),
                           kG2PThreads, kG2PSmem, info);
}
