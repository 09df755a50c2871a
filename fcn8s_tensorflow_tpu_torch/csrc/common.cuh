// Shared helpers for the hand-written Hopper kernels of this package.
//
// Every kernel is exposed through a plain C entry point (no PyTorch headers),
// compiled by kernels/build.py with nvcc for sm_90a and loaded with ctypes.
// Each entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace fcn8s {

// dtype codes shared with the Python wrappers (ops/pool.py, ops/kernels.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kUInt8 = 2, kInt32 = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// fp32 -> T, rounding to nearest even (what PyTorch's .to(torch.bfloat16) does)
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;

// Block-wide sum of one float per thread; the result is valid in thread 0.
// Fixed reduction order, so a launch with the same grid is bit-reproducible.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace fcn8s
