// Shared by the kernel sources of repro_torch. Each source is built into
// its own shared library with a plain C interface (no PyTorch headers) and
// loaded with ctypes; pointers and the stream arrive as integers from
// tensor.data_ptr() and torch.cuda.current_stream().cuda_stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Every launcher returns cudaGetLastError() right after its launches
// (0 = cudaSuccess); the Python wrapper raises on anything else, with
// this string.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

// The kernels run on PyTorch's stream; this library has its own CUDA
// runtime instance, so it selects the tensors' device itself.
inline int select_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

// The masked score of the JAX attention kernels (not -inf: a row whose
// every score is masked still gets exp(NEG_INF - NEG_INF) = 1 weights).
constexpr float kNegInf = -2.0e38f;

// Four consecutive elements as floats (16 bytes of float32 or 8 of bf16;
// the address must be aligned to that size).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

}  // namespace repro
