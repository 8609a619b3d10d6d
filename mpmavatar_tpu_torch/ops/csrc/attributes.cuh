// What a kernel was built into, for the wrappers' kernel_info queries.

#pragma once

#include <cuda_runtime.h>

// registers per thread, local (spilled) bytes per thread, shared bytes per
// block and resident blocks per SM of `kernel` as built, at `threads` per
// block and `dynamic_smem` bytes of dynamic shared memory: info[0..3]
inline int kernel_attributes(const void* kernel, int threads,
                             size_t dynamic_smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, dynamic_smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes + dynamic_smem);
  info[3] = blocks;
  return static_cast<int>(err);
}
