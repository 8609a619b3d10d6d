// K4: w-weighted quadratic B-spline splat of point values plus a weight
// channel onto the dense grid — the body-mesh collider's face velocity +
// normal (CH = 6) and the joint-pin mover's prescribed velocity (CH = 3).
//
// Replaces: mpmavatar_tpu/ops/pallas_transfer.py::splat_columns_fused
// (inline kernel over _splat_math), with the contract of
// mpmavatar_tpu/core/stepping.py::rasterize_to_grid minus the column
// bins.  Plain
// PyTorch twin: ops/splat.py::splat_plain.
//
//   grid_vals[cell, c] += w * values[p, c],   grid_w[cell] += w,
// w the 27-node stencil weight of point p.  With the bounds check (the
// reference's, asymmetric: every axis of base in [0, G-3)) a point outside
// it contributes nothing; without it, the scatter's index rule of the JAX
// package applies (a flat index in [-G^3, 0) wraps, the rest outside
// [0, G^3) is dropped).
//
// Bound on an H100: memory, and not in this kernel: the dense outputs
// ((CH+1) floats per cell: 58.7 MB at G = 128 and CH = 6, 437.5 MB at
// G = 250) are zeroed by the wrapper, while this kernel reads
// (3 + CH) floats per point and adds into 27 (CH+1) floats per point
// (~4,512 collider faces, ~384 joint points on the bench's path).
// Design: one thread per (point, stencil node), so the few thousand
// points still fill the card; atomicAdd straight into the zeroed grid.

#include <cuda_runtime.h>

namespace {

// Quadratic B-spline weight of offset o (0, 1, 2) for fx = grid_pos - base.
__device__ __forceinline__ float bspline_weight(float fx, int o) {
  if (o == 0) {
    const float wa = 1.5f - fx;
    return 0.5f * wa * wa;
  }
  if (o == 1) {
    const float wb = fx - 1.0f;
    return 0.75f - wb * wb;
  }
  const float wc = fx - 0.5f;
  return 0.5f * wc * wc;
}

__global__ void splat_kernel(const float* __restrict__ points,
                             const float* __restrict__ values, int n, int ch,
                             int G, float inv_dx, int bounds_check,
                             float* __restrict__ grid_vals,
                             float* __restrict__ grid_w) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= 27LL * n) return;
  const int p = static_cast<int>(tid / 27);
  const int node = static_cast<int>(tid % 27);
  const int off[3] = {node / 9, (node / 3) % 3, node % 3};
  int base[3];
  float wa[3];
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    // rounded as the plain version rounds it: a multiply contracted
    // into the subtractions below would move fx by up to half an ulp
    // of x * inv_dx (~4e-6 at G = 200, where inv_dx = 100 is not a
    // power of two) and the floor at ties
    const float gp = __fmul_rn(points[3 * p + a], inv_dx);
    base[a] = static_cast<int>(floorf(gp - 0.5f));
    wa[a] = bspline_weight(gp - static_cast<float>(base[a]), off[a]);
    inside = inside && base[a] >= 0 && base[a] < G - 3;
  }
  if (bounds_check && !inside) return;
  const long long n_cells = static_cast<long long>(G) * G * G;
  const long long flat =
      (static_cast<long long>(base[0] + off[0]) * G + (base[1] + off[1])) * G
      + (base[2] + off[2]);
  const long long cell = flat < 0 ? flat + n_cells : flat;
  if (cell < 0 || cell >= n_cells) return;
  const float w = wa[0] * wa[1] * wa[2];
  for (int c = 0; c < ch; ++c)
    atomicAdd(grid_vals + cell * ch + c, w * values[static_cast<long long>(p)
                                                    * ch + c]);
  atomicAdd(grid_w + cell, w);
}

}  // namespace

extern "C" int launch_splat(const float* points, const float* values, int n,
                            int ch, int G, float inv_dx, int bounds_check,
                            float* grid_vals, float* grid_w, void* stream) {
  const int threads = 256;
  const long long work = 27LL * n;
  const int blocks = static_cast<int>((work + threads - 1) / threads);
  splat_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, values, n, ch, G, inv_dx, bounds_check, grid_vals, grid_w);
  return static_cast<int>(cudaGetLastError());
}
