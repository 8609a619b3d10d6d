// Shared by K6 (composite.cu) and K7 (composite_bwd.cu): the per-pixel
// evaluation of one gaussian, and the block's own gather of its work
// item.  A work item is a row of C instance ids into the packed table
// (rows [mean_x, mean_y, conic_a, conic_b, conic_c, colour_0..nc-1,
// opacity], 6 + nc floats each, row-major); an id equal to `sentinel`
// marks an empty slot.
//
// The sentinel's row (means -1e6, conic 0, opacity 0) has power 0 and
// alpha 0 < 1/255 at every pixel, so the cutoff zeroes it: skipping it
// leaves the segment and every gradient exactly as they are.

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kMaxNc = 8;
constexpr float kAlphaMin = 1.0f / 255.0f;

struct Eval {
  float dx, dy, e, raw, alpha;
};

// one (gaussian, pixel) evaluation:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  (dx, dy) = pixel - mean
//   alpha = min(0.99, o exp(min(power, 0))), 0 where power > 0 or
//           alpha < 1/255
__device__ __forceinline__ Eval evaluate(float px, float py, float mx,
                                         float my, float a, float b,
                                         float c, float o) {
  Eval v;
  v.dx = px - mx;
  v.dy = py - my;
  const float power = -0.5f * (a * v.dx * v.dx + c * v.dy * v.dy)
                      - b * v.dx * v.dy;
  v.e = expf(fminf(power, 0.0f));
  v.raw = o * v.e;
  v.alpha = fminf(0.99f, v.raw);
  if (power > 0.0f || v.alpha < kAlphaMin) v.alpha = 0.0f;
  return v;
}

// Loads the item's C ids, keeps the live ones (id != sentinel) in depth
// order in s_id and gathers their rows into par[r * C + j] (row r of the
// j-th live gaussian).  Warp 0 compacts: one ballot per 32 slots, each
// live lane writing at the count of live lanes before it (a prefix over
// the slots, 32 at a time).  Returns the number of live slots to every
// thread; ends with a barrier.
__device__ __forceinline__ int gather_live(const long long* __restrict__ ids,
                                           int C, long long sentinel,
                                           const float* __restrict__ packed,
                                           int rows, long long* s_id,
                                           float* par) {
  __shared__ int s_n;
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < C; base += 32) {
      const int c = base + static_cast<int>(lane);
      const long long id = c < C ? ids[c] : sentinel;
      const bool live = id != sentinel;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) s_id[n + __popc(mask & ((1u << lane) - 1u))] = id;
      n += __popc(mask);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  const int n = s_n;
  for (int i = threadIdx.x; i < n * rows; i += blockDim.x) {
    const int j = i / rows;
    const int r = i - j * rows;
    par[r * C + j] = packed[s_id[j] * rows + r];
  }
  __syncthreads();
  return n;
}

// dynamic shared memory of the ids and the gathered rows (the ids first:
// 8-byte aligned)
__host__ __device__ constexpr size_t gather_bytes(int C, int rows) {
  return sizeof(long long) * static_cast<size_t>(C)
         + sizeof(float) * static_cast<size_t>(rows) * C;
}

}  // namespace composite
