// K7: the VJP of K6 (segment compositing) with respect to the packed
// parameter table.  Per work item (C depth-ordered instances of the table
// against the 256 pixels of a 16x16 tile) and pixel, with the forward of
// composite.cu
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
// d b = -dpow dx dy; each (row, gaussian) summed over the item's pixels
// and added into the gaussian's row of d packed.  The recurrence needs no
// division: T_c is recomputed front to back, never recovered as
// T_{c+1} / (1 - alpha_c) (T underflows after a few dozen alphas near
// 0.99).
//
// Replaces: mpmavatar_tpu/render/pallas_composite.py::_seg_bwd_pallas (the
// custom-VJP backward of segment_composite, jax.vjp over _seg_math inside
// the kernel), together with the backward of the XLA gather packed[ids]
// in front of it (a scatter-add onto the table's rows).  Plain PyTorch
// twin: ops/composite.py::segment_composite_gather_vjp_plain (autograd
// over segment_composite_gather_plain).
//
// Layout: packed (rows, 6 + nc) row-major; ids (W, C) int64, `sentinel`
// marking an empty slot; pix0 (W, 2); g (W, nc + 1, 256); dpacked, the
// layout of packed, zero-filled by the wrapper.  The sentinel's row is
// never written, so its gradient is exactly 0.
//
// Bound on an H100, recounted on what the data needs: bytes -- the ids (8
// C per item), the live rows gathered (4 (6 + nc) per live slot), the tile
// origins (8 per item), the cotangent (4 (nc + 1) 256) only for the items
// that hold a live slot (elsewhere nothing reaches d packed, whatever g
// is), d packed read and written once per live slot (8 (6 + nc)) and its
// zero fill (4 (6 + nc) per row); FP32 operations -- ~20 per (live
// gaussian, pixel) to evaluate alpha (expf included) and ~50 more per
// evaluation that passes both cutoffs (the walk back, the parameter
// gradients and their sums).
//
// Design: one block per item and one thread per pixel, as K6, with K6's
// gather (composite_common.cuh): only the live slots are walked, and an
// item with none returns before it reads g.  The n_live gaussians are
// taken in segments of kSeg = 8: a first front-to-back pass keeps each
// pixel's transmittance at every segment start after the first in shared
// memory; then, segment by segment from the back, a thread recomputes its
// 8 transmittances and alphas into registers and walks the segment back
// to front with S in a register.  A warp none of whose pixels the
// gaussian reaches (alpha 0 leaves S as it is) skips the step; the others
// sum the 6 + nc gradients over their 32 pixels together, in 16 shuffles
// by a transposing butterfly (not 5 per gradient), into per-warp partials
// in shared memory, then over the 8 warps in a fixed order: the block's
// sums are deterministic.  __launch_bounds__(256, 4) holds the kernel to
// 64 registers (60 as built, no spills): four blocks per SM at C = 32;
// deeper register segments or per-gradient sums need more registers and
// fit fewer blocks.  Each nonzero (live slot, row) sum is then
// added into d packed[id] with one atomicAdd.  A gaussian reaches at most
// max_tiles_per_gauss (36) tiles, so contention is low; the order of
// those adds, and so the rounding of a row summed over several items,
// changes from run to run.  Under the per-slot contract (ids = arange,
// every slot its own row) each entry gets at most one add onto zero and
// the result is deterministic.

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "composite_common.cuh"

using namespace composite;

namespace {

constexpr int kSeg = 8;
constexpr int kMinBlocks = 4;

constexpr int kSums = 16;    // the 6 + kMaxNc = 14 gradients, padded

// Sums each of v's 16 values over the warp's 32 lanes in 16 shuffles (not
// 16 x 5): a butterfly that transposes as it adds.  At each of the first
// four steps a lane keeps half of its values and adds its partner's
// partial sums of that half, so that after them lane l carries a partial
// sum of value l >> 1; the last step adds the two lanes that share it.
// Returns the sum of value lane >> 1, added in the same order in every
// warp.
__device__ __forceinline__ float warp_sums(float (&v)[kSums], int lane) {
#pragma unroll
  for (int half = kSums / 2; half >= 1; half >>= 1) {
    const bool upper = lane & (2 * half);
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * half);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__global__ void __launch_bounds__(kPix, kMinBlocks)
composite_bwd_kernel(const float* __restrict__ packed,
                     const long long* __restrict__ ids,
                     const float* __restrict__ pix0,
                     const float* __restrict__ g, int C, int nc,
                     long long sentinel, float* __restrict__ dpacked) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = 6 + nc;
  long long* s_id = reinterpret_cast<long long*>(smem);
  float* par = reinterpret_cast<float*>(s_id + C);      // rows x C
  float* t_start = par + rows * C;      // (segments - 1) x 256: T at starts
  float* part = t_start + ((C + kSeg - 1) / kSeg - 1) * kPix;
  const long long item = blockIdx.x;
  const int n = gather_live(ids + item * C, C, sentinel, packed, rows, s_id,
                            par);
  if (n == 0) return;                   // nothing reaches d packed

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
  float S = gi[nc * kPix + p];             // S_n = g_T

  // pass 1: this pixel's transmittance at the start of segments 1, 2, ...
  const int n_seg = (n + kSeg - 1) / kSeg;
  float T = 1.0f;
  for (int c = 0; c < (n_seg - 1) * kSeg; ++c) {
    T *= 1.0f - evaluate(px, py, mx[c], my[c], ca[c], cb[c], cc[c],
                         op[c]).alpha;
    if ((c + 1) % kSeg == 0) t_start[((c + 1) / kSeg - 1) * kPix + p] = T;
  }

  // pass 2: segments from the back, each walked back to front
  for (int si = n_seg - 1; si >= 0; --si) {
    const int c0 = si * kSeg;
    float tj[kSeg], aj[kSeg];               // T_c and alpha_c
    T = si > 0 ? t_start[(si - 1) * kPix + p] : 1.0f;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      tj[j] = T;
      const int c = c0 + j;
      aj[j] = c < n ? evaluate(px, py, mx[c], my[c], ca[c], cb[c], cc[c],
                               op[c]).alpha
                    : 0.0f;
      T *= 1.0f - aj[j];
    }
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {
      const int c = c0 + j;
      if (c >= n) continue;                // the same for the whole block
      // a pixel with alpha 0 leaves S as it is and gets no gradient: a
      // warp of such pixels skips the gaussian
      const float alpha = aj[j];
      const bool live = alpha > 0.0f;
      float sum = 0.0f;
      if (__any_sync(0xffffffffu, live)) {
        const Eval ev = evaluate(px, py, mx[c], my[c], ca[c], cb[c], cc[c],
                                 op[c]);
        float G = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxNc; ++k)
          if (k < nc) G += gk[k] * col[k * C + c];
        const float dalpha = tj[j] * (G - S);
        S = G * alpha + (1.0f - alpha) * S;
        const float w = alpha * tj[j];
        // d alpha passes the 0.99 clamp only below it (at the tie too, as
        // torch.clamp_max's gradient does)
        const float da = (live && ev.raw <= 0.99f) ? dalpha : 0.0f;
        const float dx = live ? ev.dx : 0.0f;
        const float dy = live ? ev.dy : 0.0f;
        const float dpow = da * ev.raw;
        // value i of row i (means, conic), 5 + nc (opacity) at i = 5,
        // i - 1 (colours) from i = 6
        float v[kSums];
        v[0] = dpow * (ca[c] * dx + cb[c] * dy);
        v[1] = dpow * (cc[c] * dy + cb[c] * dx);
        v[2] = -0.5f * dpow * dx * dx;
        v[3] = -dpow * dx * dy;
        v[4] = -0.5f * dpow * dy * dy;
        v[5] = da * ev.e;
#pragma unroll
        for (int k = 0; k < kMaxNc; ++k) v[6 + k] = gk[k] * w;
        v[14] = v[15] = 0.0f;
        sum = warp_sums(v, lane);
      }
      const int i = lane >> 1;              // part[warp][row of i][j]
      if (!(lane & 1) && i < rows)
        part[(warp * rows + (i < 5 ? i : i == 5 ? 5 + nc : i - 1)) * kSeg
             + j] = sum;
    }
    __syncthreads();
    // the 8 warps' partials in a fixed order, then one add per nonzero
    // (live slot, row) into d packed; neighbouring threads take
    // neighbouring rows of one gaussian
    for (int i = threadIdx.x; i < kSeg * rows; i += kPix) {
      const int j = i / rows;
      const int r = i - j * rows;
      if (c0 + j < n) {
        float sum = 0.0f;
        for (int w = 0; w < kWarps; ++w) sum += part[(w * rows + r) * kSeg + j];
        if (sum != 0.0f) atomicAdd(dpacked + s_id[c0 + j] * rows + r, sum);
      }
    }
    __syncthreads();                       // the partials are reused
  }
}

size_t bwd_smem(int C, int nc) {
  const int rows = 6 + nc;
  const int n_seg = (C + kSeg - 1) / kSeg;
  return gather_bytes(C, rows)
         + sizeof(float) * (static_cast<size_t>(n_seg - 1) * kPix
                            + static_cast<size_t>(kWarps) * rows * kSeg);
}

cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;   // above only after opting in
  return cudaFuncSetAttribute(composite_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int launch_composite_bwd(const float* packed, const long long* ids,
                                    const float* pix0, const float* g, int W,
                                    int C, int nc, long long sentinel,
                                    float* dpacked, void* stream) {
  const size_t smem = bwd_smem(C, nc);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_bwd_kernel<<<W, kPix, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, ids, pix0, g, C, nc, sentinel, dpacked);
  return static_cast<int>(cudaGetLastError());
}

// registers, spilled bytes, shared bytes and resident blocks per SM at
// this C and nc, as built
extern "C" int composite_bwd_info(int C, int nc, int* info) {
  const size_t smem = bwd_smem(C, nc);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_attributes(
      reinterpret_cast<const void*>(composite_bwd_kernel), kPix, smem, info);
}
