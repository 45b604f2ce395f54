// Shared by every kernel source: each source is built into its own shared
// library, and each library exports this lookup for the Python wrapper.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* nerfacc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
