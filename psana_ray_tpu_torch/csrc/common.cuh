// Shared helpers for the port's kernels: the C error-string entry point
// and SiLU. Every library built from csrc/ includes this once.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float silu_f32(float v) {
  return v / (1.0f + expf(-v));
}
