// Shared helpers of the port's attention kernels (plain C interface,
// loaded with ctypes; see kernels/runtime.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// finite "minus infinity" of the reference kernels: masked logits take this
// value and masked probabilities are zeroed explicitly, so a fully masked
// tile adds nothing to the softmax
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage a (rows x d) tile of a strided source (row stride `src_stride`
// elements, row r at src + r * src_stride) into shared memory as f32 (row
// stride `dst_stride`); source rows >= n are zero-filled.  Each thread
// issues kBatch independent loads before its stores, so a block keeps
// blockDim * kBatch loads in flight instead of one per thread.
template <int kBatch, typename T>
__device__ __forceinline__ void stage_tile(float* dst, int dst_stride,
                                           const T* src, long long src_stride,
                                           int rows, int n, int d) {
  const int total = rows * d;
  for (int base = threadIdx.x; base < total; base += blockDim.x * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      const int r = i / d;
      v[u] = (i < total && r < n)
                 ? to_f(src[(long long)r * src_stride + (i - r * d)])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      const int r = i / d;
      if (i < total) dst[r * dst_stride + (i - r * d)] = v[u];
    }
  }
}

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// error code a launcher returns for a shape it was not built for
constexpr int kUnsupportedShape = -1;

}  // namespace repro
