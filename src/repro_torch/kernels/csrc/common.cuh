// Shared by the kernel sources of repro_torch. Each source is built into
// its own shared library with a plain C interface (no PyTorch headers) and
// loaded with ctypes; pointers and the stream arrive as integers from
// tensor.data_ptr() and torch.cuda.current_stream().cuda_stream.
#pragma once

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

}  // namespace repro
