// Helpers shared by every kernel source of the port.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Inputs are f32 (dtype code 0) or bf16 (dtype code 1); arithmetic is f32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

}  // namespace repro

// Every C entry point returns a cudaError_t as int; the Python wrapper
// raises with this text when it is not 0.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
