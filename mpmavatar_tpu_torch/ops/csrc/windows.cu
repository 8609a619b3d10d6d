// The release windows: every registered particle impulse and velocity
// modifier of a substep in one launch, one thread per particle.
//
// Replaces no TPU kernel.  It is the glue of
// core/stepping.py::_pre_p2g_velocity fused for launch cost: the JAX
// package (mpmavatar_tpu/core/stepping.py::p2g2p, its pre-P2G loop) and
// the port's plain loop (ops/windows.py::windows_plain) launch ~6 small
// kernels per window per substep over every particle, ~300 launches a
// substep for the zero-shot demo's 50 release windows, though none of them
// holds the demo's time.  Plain PyTorch twin: ops/windows.py::windows_plain.
//
// Arithmetic contract: the plain loop's, operation for operation, with the
// rounding of each operation explicit (__fdiv_rn, __fmul_rn, __fadd_rn) so
// that no FMA contraction changes a bit:
// - window w is live where start_w <= t < end_w in float32 (the loop
//   compares the frame's float32 time with the device scalars);
// - for each membership bit of the particle, in registration order
//   (impulses, then velocity modifiers), a live window applies: an impulse
//   adds (force / mass) * dt or force * dt to v, a velocity modifier stores
//   its velocity, a rotation modifier stores the cylinder field of
//   core/stepping.py's loop (each sum over 3 in the order torch.sum takes
//   it on the card, dot3 below; acosf, sinf and cosf as torch calls them).
//
// Bound on an H100: memory.  Per particle it reads v (12 B) and, while any
// window is live, its membership words (4 B per 32 windows), and writes the
// new v (12 B); x (12 B) only under a live rotation modifier, the mass
// (4 B) only under a live impulse that scales by mass.  For the demo's
// 200,101 particles and 50 windows that is 200,101 x (12 + 12 + 8) B ~
// 6.4 MB, ~1.9 us at 3.35 TB/s (4.8 MB, ~1.4 us, while no window is live:
// no block reads the words then).
//
// Design: the window table (kRow floats per window) and each window's
// liveness as bit words sit in shared memory; each block loads the table
// and decides each window's liveness once.  A particle ANDs its membership
// words (stored word-major, (n_words, n): coalesced) with the live words
// and walks the set bits, so a dead window costs one compare per block.
// The output is a new v: the state stays functional for remat and autograd.
// The time comes by value, or from a float32 device scalar where t_p is not
// null (a captured substep, whose clock advances on the device).

#include <cuda_runtime.h>

#include "attributes.cuh"

namespace {

constexpr int kThreads = 256;
// one table row: kind, start, end, force or velocity (3), and for a
// rotation modifier point (3), normal (3), horizontal axes 1 and 2 (3
// each), rotation scale, translation scale
constexpr int kRow = 20;
// the table of kMaxWindows windows and their live words fit the 48 KB of
// dynamic shared memory a launch gets without opting in
constexpr int kMaxWindows = 512;
enum Kind { kImpulseByMass = 0, kImpulse = 1, kVelocity = 2, kRotation = 3 };

// torch.sum of a product over a last dimension of 3 on CUDA: its reduction
// gives the row two threads, one summing elements 0 and 2, the other
// element 1, and adds the second's sum to the first's
__device__ __forceinline__ float dot3(const float a[3], const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[2], b[2])),
                   __fmul_rn(a[1], b[1]));
}

// core/stepping.py's rotation field at position p, row r the window's
__device__ __forceinline__ void rotation(const float* r, const float* p,
                                         float v[3]) {
  const float* point = r + 6;
  const float* normal = r + 9;
  const float* h1 = r + 12;
  const float* h2 = r + 15;
  const float rs = r[18], ts = r[19];
  float off[3], rad[3];
  for (int i = 0; i < 3; ++i) off[i] = __fsub_rn(p[i], point[i]);
  const float axial = dot3(off, normal);
  for (int i = 0; i < 3; ++i)
    rad[i] = __fsub_rn(off[i], __fmul_rn(axial, normal[i]));
  const float hd = __fsqrt_rn(__fadd_rn(dot3(rad, rad), 1e-20f));
  const float cosine = __fdiv_rn(dot3(off, h1), hd);
  float theta = acosf(fminf(fmaxf(cosine, -1.0f), 1.0f));
  theta = dot3(off, h2) > 0.0f ? theta : -theta;
  const float a = __fmul_rn(__fmul_rn(-hd, sinf(theta)), rs);
  const float b = __fmul_rn(__fmul_rn(hd, cosf(theta)), rs);
  for (int i = 0; i < 3; ++i)
    v[i] = __fadd_rn(__fadd_rn(__fmul_rn(a, h1[i]), __fmul_rn(b, h2[i])),
                     __fmul_rn(ts, normal[i]));
}

__global__ void __launch_bounds__(kThreads)
    windows_kernel(const float* __restrict__ v, const float* __restrict__ x,
                   const float* __restrict__ mass,
                   const unsigned* __restrict__ member,
                   const float* __restrict__ table, int n_windows,
                   int n_words, int n, float t_v, float dt,
                   const float* __restrict__ t_p, float* __restrict__ out) {
  extern __shared__ float rows[];   // n_windows rows, then n_words words
  const float t = t_p != nullptr ? *t_p : t_v;
  unsigned* live = reinterpret_cast<unsigned*>(rows + n_windows * kRow);
  for (int i = threadIdx.x; i < n_windows * kRow; i += kThreads)
    rows[i] = table[i];
  for (int k = threadIdx.x; k < n_words; k += kThreads) live[k] = 0u;
  __syncthreads();
  for (int w = threadIdx.x; w < n_windows; w += kThreads) {
    const float* r = rows + w * kRow;
    if (r[1] <= t && t < r[2]) atomicOr(&live[w >> 5], 1u << (w & 31));
  }
  __syncthreads();
  bool any = false;
  for (int k = 0; k < n_words; ++k) any |= live[k] != 0u;

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  float vp[3] = {v[3 * p], v[3 * p + 1], v[3 * p + 2]};
  if (any) {
    for (int k = 0; k < n_words; ++k) {
      unsigned bits = member[static_cast<size_t>(k) * n + p] & live[k];
      while (bits) {
        const int w = 32 * k + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float* r = rows + w * kRow;
        switch (static_cast<int>(r[0])) {
          case kImpulseByMass: {
            const float m = mass[p];
            for (int i = 0; i < 3; ++i)
              vp[i] = __fadd_rn(vp[i],
                                __fmul_rn(__fdiv_rn(r[3 + i], m), dt));
            break;
          }
          case kImpulse:
            for (int i = 0; i < 3; ++i)
              vp[i] = __fadd_rn(vp[i], __fmul_rn(r[3 + i], dt));
            break;
          case kVelocity:
            for (int i = 0; i < 3; ++i) vp[i] = r[3 + i];
            break;
          default: {   // kRotation
            const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
            rotation(r, xp, vp);
          }
        }
      }
    }
  }
  for (int i = 0; i < 3; ++i) out[3 * p + i] = vp[i];
}

size_t shared_bytes(int n_windows) {
  return sizeof(float) * n_windows * kRow
         + sizeof(unsigned) * ((n_windows + 31) / 32);
}

}  // namespace

extern "C" int launch_windows(const float* v, const float* x,
                              const float* mass, const unsigned* member,
                              const float* table, int n_windows, int n_words,
                              int n, float t, float dt, const float* t_p,
                              float* out, void* stream) {
  if (n_windows > kMaxWindows || n_words != (n_windows + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  windows_kernel<<<blocks, kThreads, shared_bytes(n_windows),
                   static_cast<cudaStream_t>(stream)>>>(
      v, x, mass, member, table, n_windows, n_words, n, t, dt, t_p, out);
  return static_cast<int>(cudaGetLastError());
}

// at `n_windows` windows
extern "C" int windows_info(int n_windows, int* info) {
  return kernel_attributes(reinterpret_cast<const void*>(windows_kernel),
                           kThreads, shared_bytes(n_windows), info);
}
