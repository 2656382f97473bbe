// Shared helpers for the hand-written Hopper kernels of foundpose_torch.
//
// Every kernel here is bound to Python through a plain C entry point
// (ctypes): pointers arrive as void*, the stream as a void* holding a
// cudaStream_t, and each entry point returns cudaGetLastError() after its
// launches so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FP_EXPORT extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

namespace fp {

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bytes rounded up to a multiple of 128, so that every buffer carved out of
// dynamic shared memory keeps the 16-byte alignment of cp.async and ldmatrix.
__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace fp
