// K6: segment compositing of the rasterizer's worklist.  One work item is
// C depth-ordered gaussians (C = 32, or 128 for the big-splat shape)
// against the 256 pixels of a 16x16 tile; per pixel
//
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  (dx, dy) = pixel - mean
//   alpha = min(0.99, o exp(min(power, 0))), 0 where power > 0 or
//           alpha < 1/255
//   seg_c[k] = sum_c col[k, c] alpha_c prod_{c' < c} (1 - alpha_c')
//   seg_t    = prod_c (1 - alpha_c)
//
// Replaces: mpmavatar_tpu/render/pallas_composite.py::_seg_pallas (the
// forward of segment_composite, math in _seg_math).  Plain PyTorch twin:
// ops/composite.py::segment_composite_plain.
//
// Layout (as the TPU kernel's): pg (W, 6 + nc, C) rows [mean_x, mean_y,
// conic_a, conic_b, conic_c, colour_0..nc-1, opacity]; pix0 (W, 2) the
// tile's first pixel (x, y); out (W, nc + 1, 256), pixel p = 16 y + x.
//
// Bound on an H100: FP32 operations, ~20 per (item, gaussian, pixel) with
// the IEEE expf, against (6 + nc) C + 2 floats in and (nc + 1) 256 out
// per item (at C = 32, nc = 3: 1.16 KB in, 4 KB out for 164 k
// operations).  Design: one block per item and one thread per pixel.  The
// item's parameters go to shared memory once (at most (6 + 8) x 512
// floats); every thread walks the C gaussians front to back with its
// transmittance and colour sums in registers, so nothing but the inputs
// and the segments touches device memory.  The TPU's doubling cumulative
// product and its colour matmul were layout for the MXU: a sequential
// product is the same function within rounding.  No per-pixel early stop:
// the function has none (the rasterizer's stop_eps is tile-granular and
// outside the kernel), and an item of sentinels (opacity 0) still writes
// colour 0 and transmittance 1.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kMaxNc = 8;
constexpr float kAlphaMin = 1.0f / 255.0f;

__global__ void __launch_bounds__(kPix)
composite_kernel(const float* __restrict__ pg, const float* __restrict__ pix0,
                 int C, int nc, float* __restrict__ out) {
  extern __shared__ float s[];          // (6 + nc) x C parameters
  const long long item = blockIdx.x;
  const int n_par = (6 + nc) * C;
  const float* src = pg + item * n_par;
  for (int i = threadIdx.x; i < n_par; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  const float* mx = s;
  const float* my = s + C;
  const float* ca = s + 2 * C;
  const float* cb = s + 3 * C;
  const float* cc = s + 4 * C;
  const float* col = s + 5 * C;
  const float* op = s + (5 + nc) * C;

  const int p = threadIdx.x;
  const float px = pix0[2 * item] + static_cast<float>(p % kTile);
  const float py = pix0[2 * item + 1] + static_cast<float>(p / kTile);
  float acc[kMaxNc];
#pragma unroll
  for (int k = 0; k < kMaxNc; ++k) acc[k] = 0.0f;
  float trans = 1.0f;
  for (int c = 0; c < C; ++c) {
    const float dx = px - mx[c];
    const float dy = py - my[c];
    const float power =
        -0.5f * (ca[c] * dx * dx + cc[c] * dy * dy) - cb[c] * dx * dy;
    float alpha = fminf(0.99f, op[c] * expf(fminf(power, 0.0f)));
    if (power > 0.0f || alpha < kAlphaMin) alpha = 0.0f;
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

extern "C" int launch_composite(const float* pg, const float* pix0, int W,
                                int C, int nc, float* out, void* stream) {
  const size_t smem = static_cast<size_t>(6 + nc) * C * sizeof(float);
  composite_kernel<<<W, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
      pg, pix0, C, nc, out);
  return static_cast<int>(cudaGetLastError());
}
