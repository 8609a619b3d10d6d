// Error strings for the status codes the launch functions return.
#include <cuda_runtime.h>

extern "C" const char* mpm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
