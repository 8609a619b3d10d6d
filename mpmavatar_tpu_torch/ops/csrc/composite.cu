// K6: segment compositing of the rasterizer's worklist.  One work item is
// C depth-ordered instances (C = 32, or 128 for the big-splat shape) of
// the packed parameter table against the 256 pixels of a 16x16 tile; per
// pixel, with alpha as composite_common.cuh evaluates it,
//
//   seg_c[k] = sum_c col[k, c] alpha_c prod_{c' < c} (1 - alpha_c')
//   seg_t    = prod_c (1 - alpha_c)
//
// Replaces: mpmavatar_tpu/render/pallas_composite.py::_seg_pallas (the
// forward of segment_composite, math in _seg_math), together with the
// XLA gather packed[ids] in front of it (mpmavatar_tpu/render/
// rasterizer.py::_composite_worklist), which the TPU needed to lay the
// item out as one (6 + nc, C) VMEM block.  Plain PyTorch twin:
// ops/composite.py::segment_composite_gather_plain.
//
// Layout: packed (rows, 6 + nc) row-major; ids (W, C) int64, `sentinel`
// marking an empty slot; pix0 (W, 2) the tile's first pixel (x, y); out
// (W, nc + 1, 256), pixel p = 16 y + x.
//
// Bound on an H100, recounted on what the data needs: bytes -- the ids
// (8 C per item), the live rows gathered (4 (6 + nc) per live slot), the
// tile origins (8 per item) and the segments out (4 (nc + 1) 256 per
// item); FP32 operations -- ~20 per (live gaussian, pixel), expf
// included.  The worklists are mostly sentinels (the avatar's phase 1:
// 27,377 live of 189,504 slots; phase 2's items past n_items hold nothing
// else), so the bytes bound it, and most of them are the segments out.
//
// Design: one block per item and one thread per pixel.  The block loads
// its own ids, keeps the live ones in depth order and gathers only their
// rows into shared memory (composite_common.cuh); every thread walks the
// n_live gaussians front to back with its transmittance and colour sums
// in registers, so the instances never pass through device memory as a
// (W, C, 6 + nc) copy.  An item with no live slot writes colour 0 and
// transmittance 1.  The TPU's doubling cumulative product and its colour
// matmul were layout for the MXU: a sequential product is the same
// function within rounding.  No per-pixel early stop: the function has
// none (the rasterizer's stop_eps is tile-granular and outside the
// kernel).

#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace composite;

namespace {

__global__ void __launch_bounds__(kPix)
composite_kernel(const float* __restrict__ packed,
                 const long long* __restrict__ ids,
                 const float* __restrict__ pix0, int C, int nc,
                 long long sentinel, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = 6 + nc;
  long long* s_id = reinterpret_cast<long long*>(smem);
  float* par = reinterpret_cast<float*>(s_id + C);     // rows x C
  const long long item = blockIdx.x;
  const int n = gather_live(ids + item * C, C, sentinel, packed, rows, s_id,
                            par);

  const float* mx = par;
  const float* my = par + C;
  const float* ca = par + 2 * C;
  const float* cb = par + 3 * C;
  const float* cc = par + 4 * C;
  const float* col = par + 5 * C;
  const float* op = par + (5 + nc) * C;

  const int p = threadIdx.x;
  const float px = pix0[2 * item] + static_cast<float>(p % kTile);
  const float py = pix0[2 * item + 1] + static_cast<float>(p / kTile);
  float acc[kMaxNc];
#pragma unroll
  for (int k = 0; k < kMaxNc; ++k) acc[k] = 0.0f;
  float trans = 1.0f;
  for (int c = 0; c < n; ++c) {
    const float alpha =
        evaluate(px, py, mx[c], my[c], ca[c], cb[c], cc[c], op[c]).alpha;
    const float w = alpha * trans;
#pragma unroll
    for (int k = 0; k < kMaxNc; ++k)
      if (k < nc) acc[k] += col[k * C + c] * w;
    trans *= 1.0f - alpha;
  }
  float* dst = out + item * (nc + 1) * kPix;
#pragma unroll
  for (int k = 0; k < kMaxNc; ++k)
    if (k < nc) dst[k * kPix + p] = acc[k];
  dst[nc * kPix + p] = trans;
}

}  // namespace

extern "C" int launch_composite(const float* packed, const long long* ids,
                                const float* pix0, int W, int C, int nc,
                                long long sentinel, float* out,
                                void* stream) {
  const size_t smem = gather_bytes(C, 6 + nc);
  composite_kernel<<<W, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, ids, pix0, C, nc, sentinel, out);
  return static_cast<int>(cudaGetLastError());
}

// registers per thread, local (spilled) bytes per thread and resident
// blocks per SM at this C and nc, as built
extern "C" int composite_info(int C, int nc, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, composite_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, composite_kernel, kPix, gather_bytes(C, 6 + nc));
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = blocks;
  return static_cast<int>(err);
}
