// The plain C interface shared by every zkrollup_torch kernel library.
//
// Each source of csrc/ (fields.cu, g1.cu, g2.cu, alu.cu) is compiled by its
// own nvcc into its own shared library, so the four build in parallel. Each
// library links its own CUDA runtime, so each carries these two functions:
// the wrapper sets the current device of the library it launches from.
// Every launch function returns cudaGetLastError() after its launch;
// pointers and the stream are passed as void*.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace zkt {

inline unsigned blocks_for(int64_t n, int threads) {
  return unsigned((n + threads - 1) / threads);
}

}  // namespace zkt

extern "C" {

int zkt_set_device(int device) { return int(cudaSetDevice(device)); }

const char* zkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
