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
// 3.35 TB/s; what limits it in practice is the 27 x 4 = 108 float
// atomicAdds per particle (~10.8 M per substep), serialised where
// neighbouring particles hit the same cells.  Design: one thread per
// particle, the stencil weights in registers, atomics straight into the
// zeroed dense grid (binning or shared-memory accumulation is later work).
//
// G2P bound: memory — 12 B of position in, 84 B out per particle, plus the
// grid cells the stencils touch.  Design: one thread per particle gathering
// 27 x 3 floats (neighbouring particles share cells, so L1/L2 absorb the
// re-reads).

#include <cuda_runtime.h>

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

// K2.  Contract: stress (n_nonvertex, 3, 3) and vforce (n - n_nonvertex,
// 3) arrive multiplied by dt (traditional stress also by vol); the kernel
// applies mass*sel to the momentum and sel to the force terms, so
//   grid_v += w*mass*sel*(v + C_eff (o - fx) dx) + sel*F,
//   F = -stress . grad w (non-vertex)  or  w * vforce (vertex),
//   grid_m += w*mass*sel,
// with the scatter's index rule of the JAX package (.at[].add(mode=
// "drop")): a flat index in [-G^3, 0) wraps to flat + G^3, and what still
// lies outside [0, G^3) is dropped.
__global__ void p2g_kernel(const float* __restrict__ x,
                           const float* __restrict__ v,
                           const float* __restrict__ c_eff,
                           const float* __restrict__ mass,
                           const float* __restrict__ sel,
                           const float* __restrict__ stress,
                           const float* __restrict__ vforce, int n,
                           int n_nonvertex, int G, float inv_dx, float dx,
                           float* __restrict__ grid_v,
                           float* __restrict__ grid_m) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int base[3];
  float fx[3], w[3][3], dw[3][3];  // w[axis][offset]
  for (int a = 0; a < 3; ++a) {
    const float gp = x[3 * p + a] * inv_dx;
    base[a] = static_cast<int>(floorf(gp - 0.5f));
    fx[a] = gp - static_cast<float>(base[a]);
    axis_weights(fx[a], w[a], dw[a]);
  }
  const float s = sel[p];
  const float ms = mass[p] * s;
  float vp[3], cm[9];
  for (int a = 0; a < 3; ++a) vp[a] = v[3 * p + a];
  for (int k = 0; k < 9; ++k) cm[k] = c_eff[9 * p + k];
  const bool vertex = p >= n_nonvertex;
  float sm[9], fv[3];
  if (vertex) {
    for (int a = 0; a < 3; ++a) fv[a] = vforce[3 * (p - n_nonvertex) + a];
  } else {
    for (int k = 0; k < 9; ++k) sm[k] = stress[9 * p + k];
  }
  const long long n_cells = static_cast<long long>(G) * G * G;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      for (int k = 0; k < 3; ++k) {
        const long long flat =
            (static_cast<long long>(base[0] + i) * G + (base[1] + j)) * G
            + (base[2] + k);
        const long long cell = flat < 0 ? flat + n_cells : flat;
        if (cell < 0 || cell >= n_cells) continue;
        const float wt = w[0][i] * w[1][j] * w[2][k];
        const float dpos[3] = {(i - fx[0]) * dx, (j - fx[1]) * dx,
                               (k - fx[2]) * dx};
        float force[3];
        if (vertex) {
          for (int a = 0; a < 3; ++a) force[a] = wt * fv[a];
        } else {
          const float gw[3] = {dw[0][i] * w[1][j] * w[2][k] * inv_dx,
                               w[0][i] * dw[1][j] * w[2][k] * inv_dx,
                               w[0][i] * w[1][j] * dw[2][k] * inv_dx};
          for (int a = 0; a < 3; ++a)
            force[a] = -(sm[3 * a] * gw[0] + sm[3 * a + 1] * gw[1]
                         + sm[3 * a + 2] * gw[2]);
        }
        const float mw = wt * ms;
        for (int a = 0; a < 3; ++a) {
          const float mom = vp[a] + (cm[3 * a] * dpos[0]
                                     + cm[3 * a + 1] * dpos[1]
                                     + cm[3 * a + 2] * dpos[2]);
          atomicAdd(grid_v + 3 * cell + a, mw * mom + s * force[a]);
        }
        atomicAdd(grid_m + cell, mw);
      }
    }
  }
}

// K3.  new_v = sum w v;  new_C = 4 inv_dx sum w v (o - fx)^T (unitless
// offset);  grad_v = sum v (grad w)^T; stencil indices clipped to
// [0, G^3 - 1].
__global__ void g2p_kernel(const float* __restrict__ x,
                           const float* __restrict__ grid_v, int n, int G,
                           float inv_dx, float* __restrict__ new_v,
                           float* __restrict__ new_c,
                           float* __restrict__ grad_v) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int base[3];
  float fx[3], w[3][3], dw[3][3];
  for (int a = 0; a < 3; ++a) {
    const float gp = x[3 * p + a] * inv_dx;
    base[a] = static_cast<int>(floorf(gp - 0.5f));
    fx[a] = gp - static_cast<float>(base[a]);
    axis_weights(fx[a], w[a], dw[a]);
  }
  const long long last = static_cast<long long>(G) * G * G - 1;
  float nv[3] = {0.f, 0.f, 0.f}, nc[9] = {0.f}, gv[9] = {0.f};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      for (int k = 0; k < 3; ++k) {
        long long flat =
            (static_cast<long long>(base[0] + i) * G + (base[1] + j)) * G
            + (base[2] + k);
        flat = flat < 0 ? 0 : (flat > last ? last : flat);
        const float g[3] = {grid_v[3 * flat], grid_v[3 * flat + 1],
                            grid_v[3 * flat + 2]};
        const float wt = w[0][i] * w[1][j] * w[2][k];
        const float wc = wt * inv_dx * 4.0f;
        const float dpos[3] = {i - fx[0], j - fx[1], k - fx[2]};
        const float gw[3] = {dw[0][i] * w[1][j] * w[2][k] * inv_dx,
                             w[0][i] * dw[1][j] * w[2][k] * inv_dx,
                             w[0][i] * w[1][j] * dw[2][k] * inv_dx};
        for (int a = 0; a < 3; ++a) {
          nv[a] += wt * g[a];
          for (int b = 0; b < 3; ++b) {
            nc[3 * a + b] += wc * g[a] * dpos[b];
            gv[3 * a + b] += g[a] * gw[b];
          }
        }
      }
    }
  }
  for (int a = 0; a < 3; ++a) new_v[3 * p + a] = nv[a];
  for (int k = 0; k < 9; ++k) {
    new_c[9 * p + k] = nc[k];
    grad_v[9 * p + k] = gv[k];
  }
}

}  // namespace

extern "C" int launch_p2g(const float* x, const float* v, const float* c_eff,
                          const float* mass, const float* sel,
                          const float* stress, const float* vforce, int n,
                          int n_nonvertex, int G, float inv_dx, float dx,
                          float* grid_v, float* grid_m, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  p2g_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, v, c_eff, mass, sel, stress, vforce, n, n_nonvertex, G, inv_dx, dx,
      grid_v, grid_m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_g2p(const float* x, const float* grid_v, int n, int G,
                          float inv_dx, float* new_v, float* new_c,
                          float* grad_v, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  g2p_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, grid_v, n, G, inv_dx, new_v, new_c, grad_v);
  return static_cast<int>(cudaGetLastError());
}
