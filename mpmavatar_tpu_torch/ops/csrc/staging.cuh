// Staging of a block's contiguous slab of a row-major (n, w) float array
// through shared memory, so that per-row kernels (one thread per row of w
// floats, w = 3 or 9) read and write device memory in coalesced 16-byte
// vectors instead of strided scalars (a warp's scalar load at a 36-byte
// stride spans 36 sectors where a coalesced one spans 4).
//
// A block of kThreads rows owns floats [w * r0, w * (r0 + m)) of the
// array, m = min(kThreads, n - r0).  With kThreads a multiple of 4 a slab
// starts on a 16-byte boundary whenever the array does; where it does not
// (a tensor that is a view at an odd offset), or for the last slab's
// floats past the last whole vector, the copy takes scalars.  The shared
// buffer must be 16-byte aligned.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace staging {

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Asynchronous copies of 4 or 16 bytes from device memory into shared
// memory (cp.async): a thread issues all of its copies without waiting for
// any, then wait_copies() waits for them; a __syncthreads() after it makes
// every thread's copies visible to the block.
__device__ __forceinline__ void copy4(float* s, const float* g) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void copy16(float* s, const float* g) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// count floats from g (device memory) into s (shared), by every thread of
// a block of kThreads, as asynchronous copies (wait_copies() and a
// __syncthreads() before s is read)
template <int kThreads>
__device__ __forceinline__ void load_async(float* s,
                                           const float* __restrict__ g,
                                           int count) {
  int done = 0;
  if (aligned16(g)) {
    const int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      copy16(s + 4 * i, g + 4 * i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads)
    copy4(s + i, g + i);
}

// count floats from s (shared) out to g (device memory), by every thread
// of a block of kThreads, in 16-byte stores where g is aligned
template <int kThreads>
__device__ __forceinline__ void store(float* __restrict__ g, const float* s,
                                      int count) {
  int done = 0;
  if (aligned16(g)) {
    const int n4 = count >> 2;
    float4* g4 = reinterpret_cast<float4*>(g);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (int i = threadIdx.x; i < n4; i += kThreads) g4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) g[i] = s[i];
}

}  // namespace staging
