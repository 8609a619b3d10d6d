// K1: fused cloth stress — QR of the direction matrix, the anisotropic
// return map on R's third column, and the QR-form anisotropic Kirchhoff
// stress with per-corner internal forces, one pass per element.
//
// Replaces: mpmavatar_tpu/ops/pallas_stress.py::_stress_pallas (math in
// _stress_math); contract of cloth_stress_fused.  Plain PyTorch twin:
// ops/stress.py::cloth_stress_plain.
//
// Bound on an H100: memory.  Per element it reads d (9), R_inv (3), vol,
// sel, mu, lam, gamma, kappa (72 B) and writes new_d (9), stress (9) and
// f1/f2/f3 (9) (108 B): ~12 MB at E = 66,248, against ~300 FP32
// operations per element.
//
// Design: one thread per element, its arithmetic in registers; the I/O
// staged through shared memory (staging.cuh).  The first design read each
// thread's rows of d and R_inv as 12 scalars at 36 B and 12 B strides and
// wrote its 27 outputs as scalars at a 36 B stride: each warp-wide access
// spanned ~36 sectors, and it ran at 0.0212 ms, 17% of the bound (H100
// 80GB HBM3, 700 W).  Now a block of kStressThreads elements copies its
// contiguous slabs of d and R_inv into shared memory with asynchronous
// 16-byte copies (cp.async: every copy in flight before the block waits),
// each thread reads its rows there (strides 9 and 3 are odd: no bank
// conflicts), writes its mapped column of d back into the same slab (which
// becomes new_d: each thread touches only its own row) and its stress and
// forces into two more slabs, and the block writes the three slabs out in
// 16-byte vectors.  The six per-element scalars are coalesced as they are.
// Kept by timing (graph replays at E = 66,248): 128 elements per block
// (64 ran slower, 256 no faster), cp.async over synchronous vector loads
// (a few percent faster).  At E = 66,248 the 518 blocks are one partial
// wave (10 blocks of 128 fit an SM), so the time is the three phases'
// latency, load, arithmetic, store, one after the other.

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "staging.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr int kStressThreads = 128;  // elements per block, one per thread

__global__ void __launch_bounds__(kStressThreads) cloth_stress_kernel(
    const float* __restrict__ d, const float* __restrict__ r_inv,
    const float* __restrict__ vol, const float* __restrict__ sel,
    const float* __restrict__ mu, const float* __restrict__ lam,
    const float* __restrict__ gamma, const float* __restrict__ kappa,
    const float* __restrict__ friction, float* __restrict__ new_d,
    float* __restrict__ stress, float* __restrict__ forces, int n) {
  // d in, then new_d out; R_inv; stress; forces (row-major slabs)
  __shared__ __align__(16) float s_d[9 * kStressThreads];
  __shared__ __align__(16) float s_r[3 * kStressThreads];
  __shared__ __align__(16) float s_s[9 * kStressThreads];
  __shared__ __align__(16) float s_f[9 * kStressThreads];
  const long long e0 = static_cast<long long>(blockIdx.x) * kStressThreads;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kStressThreads), n - e0));
  const int t = threadIdx.x;
  const bool live = t < rows;
  const long long e = e0 + t;
  float vl = 0.f, sl = 0.f, mu_e = 0.f, lam_e = 0.f, gam = 0.f, kap = 0.f;
  if (live) {
    vl = vol[e];
    sl = sel[e];
    mu_e = mu[e];
    lam_e = lam[e];
    gam = gamma[e];
    kap = kappa[e];
  }
  const float fric = friction[0];
  staging::load_async<kStressThreads>(s_d, d + 9 * e0, 9 * rows);
  staging::load_async<kStressThreads>(s_r, r_inv + 3 * e0, 3 * rows);
  staging::wait_copies();
  __syncthreads();
  if (live) {
    float dm[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) dm[k] = s_d[9 * t + k];  // d[i*3+j] = d_ij
    const float i11 = s_r[3 * t], i12 = s_r[3 * t + 1], i22 = s_r[3 * t + 2];

    const float d1[3] = {dm[0], dm[3], dm[6]};
    const float d2[3] = {dm[1], dm[4], dm[7]};
    const float d3[3] = {dm[2], dm[5], dm[8]};

    // ---- QR (qr3_pos) ---------------------------------------------------
    const float r11 = sqrtf(d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2]
                            + 1e-24f);
    const float inv_r11 = 1.0f / fmaxf(r11, kEps);
    float q1[3], q2[3], q3[3], u2[3];
    for (int i = 0; i < 3; ++i) q1[i] = d1[i] * inv_r11;
    const float r12 = q1[0] * d2[0] + q1[1] * d2[1] + q1[2] * d2[2];
    for (int i = 0; i < 3; ++i) u2[i] = d2[i] - r12 * q1[i];
    const float r22 = sqrtf(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]
                            + 1e-24f);
    const float inv_r22 = 1.0f / fmaxf(r22, kEps);
    for (int i = 0; i < 3; ++i) q2[i] = u2[i] * inv_r22;
    q3[0] = q1[1] * q2[2] - q1[2] * q2[1];
    q3[1] = q1[2] * q2[0] - q1[0] * q2[2];
    q3[2] = q1[0] * q2[1] - q1[1] * q2[0];
    const float r13 = q1[0] * d3[0] + q1[1] * d3[1] + q1[2] * d3[2];
    const float r23 = q2[0] * d3[0] + q2[1] * d3[1] + q2[2] * d3[2];
    const float r33 = q3[0] * d3[0] + q3[1] * d3[1] + q3[2] * d3[2];

    // ---- return map on column 3 (map_r_col3) ----------------------------
    const bool separated = r33 > 1.0f;
    const float fn = kap * (1.0f - r33) * (1.0f - r33);
    const float ff = gam * sqrtf(r13 * r13 + r23 * r23 + 1e-24f);
    const bool slipping = ff > fric * fn;
    const float scale = fric * fn / (slipping ? ff : 1.0f);
    const float m13 = separated ? r13 : (slipping ? r13 * scale : r13);
    const float m23 = separated ? r23 : (slipping ? r23 * scale : r23);
    const float m33 = separated ? 1.0f : r33;
    // selection == 0 applies the map; others keep the original column
    const bool use = sl > 0.5f;
    const float n13 = use ? m13 : r13;
    const float n23 = use ? m23 : r23;
    const float n33 = use ? m33 : r33;
    float nd3[3];
    for (int i = 0; i < 3; ++i)
      nd3[i] = use ? q1[i] * n13 + q2[i] * n23 + q3[i] * n33 : d3[i];

    // ---- anisotropic stress on the mapped R (anisotropic_stress_qr) -----
    const float f11 = r11 * i11;
    const float f12 = r11 * i12 + r12 * i22;
    const float f22 = r22 * i22;
    const float x = f11 + f22;
    const float y = -f12;  // f21 = 0
    const float psc = rsqrtf(fmaxf(x * x + y * y, kEps));
    const float c = x * psc, s = y * psc;
    const float j = f11 * f22;
    const float two_mu = 2.0f * mu_e;
    const float k11 = two_mu * (f11 - c) + lam_e * (j - 1.0f) * f22;
    const float k12 = two_mu * (f12 + s);
    const float k22 = two_mu * (f22 - c) + lam_e * (j - 1.0f) * f11;
    const float dr13 = gam * n13;
    const float dr23 = gam * n23;
    const float dr33 = n33 > 1.0f ? 0.0f : -kap * (1.0f - n33) * (1.0f - n33);

    // k3 = DR @ RiDT (DR upper-, RiDT lower-triangular), symmetric part
    const float k300 = k11 * f11 + k12 * f12 + dr13 * n13;
    const float k301 = k12 * f22 + dr13 * n23;
    const float k302 = dr13 * n33;
    const float k311 = k22 * f22 + dr23 * n23;
    const float k312 = dr23 * n33;
    const float k322 = dr33 * n33;
    const float ks[3][3] = {{k300, k301, k302}, {k301, k311, k312},
                            {k302, k312, k322}};

    // inverse of RiDT = [[f11,0,0],[f12,f22,0],[n13,n23,n33]]
    const float det = f11 * f22 * n33;
    const float invdet = 1.0f / (fabsf(det) > kEps ? det : kEps);
    const float l00 = f22 * n33 * invdet;
    const float l10 = -f12 * n33 * invdet;
    const float l11 = f11 * n33 * invdet;
    const float l20 = (f12 * n23 - n13 * f22) * invdet;
    const float l21 = -f11 * n23 * invdet;
    const float l22 = f11 * f22 * invdet;

    float m[3][3];
    for (int i = 0; i < 3; ++i) {
      m[i][0] = ks[i][0] * l00 + ks[i][1] * l10 + ks[i][2] * l20;
      m[i][1] = ks[i][1] * l11 + ks[i][2] * l21;
      m[i][2] = ks[i][2] * l22;
    }
    // P = Q @ M with Q's columns (q1, q2, q3); p_col[jc][i] = P_i,jc
    float p[3][3];
    for (int i = 0; i < 3; ++i)
      for (int jc = 0; jc < 3; ++jc)
        p[jc][i] = q1[i] * m[0][jc] + q2[i] * m[1][jc] + q3[i] * m[2][jc];

    // unselected elements get zero stress and forces (a multiply, as the
    // reference kernel does, so a NaN stays visible)
    for (int i = 0; i < 3; ++i) {
      const float f2 = -vl * (i11 * p[0][i] + i12 * p[1][i]);
      const float f3 = -vl * i22 * p[1][i];
      const float f1 = -(f2 + f3);
      s_f[9 * t + i] = f1 * sl;
      s_f[9 * t + 3 + i] = f2 * sl;
      s_f[9 * t + 6 + i] = f3 * sl;
      for (int jc = 0; jc < 3; ++jc)
        s_s[9 * t + 3 * i + jc] = vl * p[2][i] * nd3[jc] * sl;
      s_d[9 * t + 3 * i + 2] = nd3[i];  // columns 1 and 2 stay as read
    }
  }
  __syncthreads();
  staging::store<kStressThreads>(new_d + 9 * e0, s_d, 9 * rows);
  staging::store<kStressThreads>(stress + 9 * e0, s_s, 9 * rows);
  staging::store<kStressThreads>(forces + 9 * e0, s_f, 9 * rows);
}

}  // namespace

extern "C" int launch_cloth_stress(
    const float* d, const float* r_inv, const float* vol, const float* sel,
    const float* mu, const float* lam, const float* gamma,
    const float* kappa, const float* friction, float* new_d, float* stress,
    float* forces, int n, void* stream) {
  const int blocks = (n + kStressThreads - 1) / kStressThreads;
  cloth_stress_kernel<<<blocks, kStressThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      d, r_inv, vol, sel, mu, lam, gamma, kappa, friction, new_d, stress,
      forces, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cloth_stress_info(int* info) {
  return kernel_attributes(reinterpret_cast<const void*>(cloth_stress_kernel),
                           kStressThreads, 0, info);
}
