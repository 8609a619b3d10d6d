// K7: the VJP of K6 (segment compositing).  Per work item (C depth-ordered
// gaussians against the 256 pixels of a 16x16 tile) and pixel, with the
// forward of composite.cu
//
//   alpha_c = min(0.99, o exp(min(power, 0))), 0 where power > 0 or
//             alpha < 1/255
//   T_c     = prod_{j < c} (1 - alpha_j)
//   out_k   = sum_c col[k, c] alpha_c T_c,   out_T = T_C
//
// and the cotangent g (g_k per colour, g_T on the transmittance):
//
//   G_c = sum_k g_k col[k, c]
//   S_C = g_T,  S_c = G_c alpha_c + (1 - alpha_c) S_{c+1}   (back to front)
//   d alpha_c  = T_c (G_c - S_{c+1}),   d col[k, c] += g_k alpha_c T_c
//
// then, where alpha is not cut and o e <= 0.99 (e = exp(min(power, 0))):
// d o = d alpha e, dpow = d alpha o e, d mean_x = dpow (a dx + b dy),
// d mean_y = dpow (c dy + b dx), d a = -dpow dx^2 / 2, d c = -dpow dy^2 / 2,
// d b = -dpow dx dy; each (row, gaussian) summed over the item's pixels.
// The recurrence needs no division: T_c is recomputed front to back, never
// recovered as T_{c+1} / (1 - alpha_c) (T underflows after a few dozen
// alphas near 0.99).
//
// Replaces: mpmavatar_tpu/render/pallas_composite.py::_seg_bwd_pallas (the
// custom-VJP backward of segment_composite, jax.vjp over _seg_math inside
// the kernel).  Plain PyTorch twin: ops/composite.py::
// segment_composite_vjp_plain (autograd over segment_composite_plain).
//
// Layout: pg (W, 6 + nc, C) rows [mean_x, mean_y, conic_a, conic_b,
// conic_c, colour_0..nc-1, opacity]; pix0 (W, 2); g (W, nc + 1, 256);
// dpg (W, 6 + nc, C), the layout of pg.
//
// Bound on an H100, counted on what the data needs: FP32 operations, ~20
// per (item, live gaussian, pixel) to evaluate alpha and ~50 more where
// alpha passes both cutoffs (the walk back, the parameter gradients and
// their sums), against (6 + nc) C + 2 floats in and (6 + nc) C floats out
// per item, and the (nc + 1) 256-float cotangent in per item that holds a
// live gaussian (elsewhere the result is 0 whatever g is).
// Design: one block per
// item and one thread per pixel, as K6.  The item's parameters go to
// shared memory once.  The gaussians are taken in segments of kSeg = 32:
// a first front-to-back pass keeps each pixel's transmittance at every
// segment start (shared memory, skipped when C <= 32); then, segment by
// segment from the back, a thread recomputes its 32 transmittances into
// registers and walks the segment back to front with S in a register.
// Each per-gaussian gradient is summed over the warp's 32 pixels with
// shuffles (skipped when no pixel of the warp sees the gaussian, the
// common case) into per-warp partials in shared memory, then over the 8
// warps in a fixed order: no atomics, the result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kMaxNc = 8;
constexpr int kSeg = 32;
constexpr float kAlphaMin = 1.0f / 255.0f;

struct Eval {
  float dx, dy, e, raw, alpha;
};

// one (gaussian, pixel) evaluation, as composite.cu computes it
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ pg,
                     const float* __restrict__ pix0,
                     const float* __restrict__ g, int C, int nc,
                     float* __restrict__ dpg) {
  extern __shared__ float s[];
  const int rows = 6 + nc;
  const int n_seg = (C + kSeg - 1) / kSeg;
  float* par = s;                          // rows x C parameters
  float* t_start = par + rows * C;         // n_seg x 256 segment-start T
  float* part = t_start + n_seg * kPix;    // kWarps x rows x kSeg partials
  const long long item = blockIdx.x;
  const float* src = pg + item * rows * C;
  for (int i = threadIdx.x; i < rows * C; i += kPix) par[i] = src[i];
  __syncthreads();

  const float* mx = par;
  const float* my = par + C;
  const float* ca = par + 2 * C;
  const float* cb = par + 3 * C;
  const float* cc = par + 4 * C;
  const float* col = par + 5 * C;
  const float* op = par + (5 + nc) * C;

  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = pix0[2 * item] + static_cast<float>(p % kTile);
  const float py = pix0[2 * item + 1] + static_cast<float>(p / kTile);
  const float* gi = g + item * (nc + 1) * kPix;
  float gk[kMaxNc];
#pragma unroll
  for (int k = 0; k < kMaxNc; ++k) gk[k] = k < nc ? gi[k * kPix + p] : 0.0f;
  float S = gi[nc * kPix + p];             // S_C = g_T

  // pass 1: this pixel's transmittance at every segment start
  float T = 1.0f;
  for (int si = 0; si < n_seg; ++si) {
    t_start[si * kPix + p] = T;
    if (si == n_seg - 1) break;
    for (int c = si * kSeg; c < (si + 1) * kSeg; ++c)
      T *= 1.0f - evaluate(px, py, mx[c], my[c], ca[c], cb[c], cc[c],
                           op[c]).alpha;
  }

  // pass 2: segments from the back, each walked back to front
  float* dst_item = dpg + item * rows * C;
  for (int si = n_seg - 1; si >= 0; --si) {
    const int c0 = si * kSeg;
    float tj[kSeg];
    T = t_start[si * kPix + p];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      tj[j] = T;
      const int c = c0 + j;
      if (c < C)
        T *= 1.0f - evaluate(px, py, mx[c], my[c], ca[c], cb[c], cc[c],
                             op[c]).alpha;
    }
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {
      const int c = c0 + j;
      if (c >= C) continue;                // the same for the whole block
      const Eval v = evaluate(px, py, mx[c], my[c], ca[c], cb[c], cc[c],
                              op[c]);
      float G = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxNc; ++k)
        if (k < nc) G += gk[k] * col[k * C + c];
      const float dalpha = tj[j] * (G - S);
      S = G * v.alpha + (1.0f - v.alpha) * S;
      const bool live = v.alpha > 0.0f;
      float* dst = part + warp * rows * kSeg + j;     // part[warp][r][j]
      if (__any_sync(0xffffffffu, live)) {
        const float w = live ? v.alpha * tj[j] : 0.0f;
        // d alpha passes the 0.99 clamp only below it (at the tie too, as
        // torch.clamp_max's gradient does)
        const float da = (live && v.raw <= 0.99f) ? dalpha : 0.0f;
        const float dx = live ? v.dx : 0.0f;
        const float dy = live ? v.dy : 0.0f;
        const float dpow = da * v.raw;
        const float r0 = warp_sum(dpow * (ca[c] * dx + cb[c] * dy));
        const float r1 = warp_sum(dpow * (cc[c] * dy + cb[c] * dx));
        const float r2 = warp_sum(-0.5f * dpow * dx * dx);
        const float r3 = warp_sum(-dpow * dx * dy);
        const float r4 = warp_sum(-0.5f * dpow * dy * dy);
        const float ro = warp_sum(da * v.e);
        if (lane == 0) {
          dst[0] = r0;
          dst[kSeg] = r1;
          dst[2 * kSeg] = r2;
          dst[3 * kSeg] = r3;
          dst[4 * kSeg] = r4;
          dst[(5 + nc) * kSeg] = ro;
        }
#pragma unroll
        for (int k = 0; k < kMaxNc; ++k) {
          if (k < nc) {
            const float rk = warp_sum(gk[k] * w);
            if (lane == 0) dst[(5 + k) * kSeg] = rk;
          }
        }
      } else if (lane == 0) {
        for (int r = 0; r < rows; ++r) dst[r * kSeg] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * kSeg; i += kPix) {
      const int r = i / kSeg;
      const int j = i % kSeg;
      if (c0 + j < C) {
        float sum = 0.0f;
        for (int w = 0; w < kWarps; ++w) sum += part[(w * rows + r) * kSeg + j];
        dst_item[r * C + c0 + j] = sum;
      }
    }
    __syncthreads();                       // the partials are reused
  }
}

}  // namespace

extern "C" int launch_composite_bwd(const float* pg, const float* pix0,
                                    const float* g, int W, int C, int nc,
                                    float* dpg, void* stream) {
  const int rows = 6 + nc;
  const int n_seg = (C + kSeg - 1) / kSeg;
  const size_t smem = sizeof(float)
      * (static_cast<size_t>(rows) * C + static_cast<size_t>(n_seg) * kPix
         + static_cast<size_t>(kWarps) * rows * kSeg);
  if (smem > 48 * 1024) {          // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_bwd_kernel<<<W, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
      pg, pix0, g, C, nc, dpg);
  return static_cast<int>(cudaGetLastError());
}
