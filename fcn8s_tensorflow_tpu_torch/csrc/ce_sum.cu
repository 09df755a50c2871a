// K1 forward: per-sample-weighted softmax cross-entropy sum.
//
// Replaces the Pallas kernel `_lse_sum_kernel` (fcn8s_tensorflow_tpu/ops/
// pallas_kernels.py, via `_ce_sample_impl` and `softmax_cross_entropy_pallas`)
// together with the XLA label pick that the TPU kept outside it:
//
//   S = sum_p mask[p / pps] * (lse_p - pick_p),
//   lse_p = log sum_c exp(logits[p, c]),  pick_p = logits[p, label_p] or 0
//   when label_p lies outside [0, C).
//
// Bound: bytes. Each pixel's C logits are read once (168 MB of bf16 at batch
// 8 x 512x1024 x 20 classes) for about 2C flops and C exponentials. The TPU
// kept the pick outside the kernel only because an (N, 1) label input padded
// to 128 lanes; here the compact uint8 labels are read in the same pass.
// Design: one thread per pixel row with an online (max-shifted) log-sum-exp
// in fp32; neighbouring threads read neighbouring rows, so a warp's loads
// fall on a few contiguous lines that L1 serves across the C iterations.
//
// The sum across blocks is deterministic: each block writes its partial to a
// scratch buffer the wrapper allocates, then one block adds the partials in a
// fixed order in double precision. No float atomics, so the eval loss is
// identical from run to run.
#include "common.cuh"

namespace fcn8s {
namespace {

template <typename T, typename L, typename I>
__global__ void __launch_bounds__(kThreads)
ce_partial_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                  const float* __restrict__ mask, float* __restrict__ partials, I p, int c,
                  I pps) {
  float acc = 0.f;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < p; i += stride) {
    const T* row = logits + i * static_cast<I>(c);
    const int label = static_cast<int>(labels[i]);
    float m = -INFINITY, s = 0.f, pick = 0.f;
    for (int j = 0; j < c; ++j) {
      const float v = to_float(row[j]);
      if (j == label) pick = v;
      if (v > m) {
        s = s * expf(m - v) + 1.f;
        m = v;
      } else {
        s += expf(v - m);
      }
    }
    acc += mask[i / pps] * (m + logf(s) - pick);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
ce_final_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ double buf[kThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = static_cast<float>(buf[0]);
}

template <typename T, typename L>
void launch(const void* logits, const void* labels, const float* mask, float* partials,
            int n_blocks, int64_t p, int c, int64_t pps, cudaStream_t stream) {
  const T* lg = static_cast<const T*>(logits);
  const L* lb = static_cast<const L*>(labels);
  if (p * c + static_cast<int64_t>(kThreads) * n_blocks < (int64_t{1} << 31)) {
    ce_partial_kernel<T, L, uint32_t><<<n_blocks, kThreads, 0, stream>>>(
        lg, lb, mask, partials, static_cast<uint32_t>(p), c, static_cast<uint32_t>(pps));
  } else {
    ce_partial_kernel<T, L, int64_t><<<n_blocks, kThreads, 0, stream>>>(lg, lb, mask, partials,
                                                                        p, c, pps);
  }
}

}  // namespace
}  // namespace fcn8s

// logits: (p, c) contiguous; labels: (p,); mask: (p / pps,) float32;
// partials: n_blocks float32 of scratch; out: one float32 (S above).
extern "C" int fcn8s_ce_sum_per_sample(const void* logits, const void* labels, const void* mask,
                                       void* partials, void* out, int n_blocks, int64_t p,
                                       int c, int64_t pps, int logit_dtype, int label_dtype,
                                       void* stream) {
  using namespace fcn8s;
  if (p <= 0 || c <= 0 || pps <= 0 || p % pps || n_blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* part = static_cast<float*>(partials);
  if (logit_dtype == kBFloat16 && label_dtype == kUInt8)
    launch<__nv_bfloat16, uint8_t>(logits, labels, m, part, n_blocks, p, c, pps, s);
  else if (logit_dtype == kBFloat16 && label_dtype == kInt32)
    launch<__nv_bfloat16, int32_t>(logits, labels, m, part, n_blocks, p, c, pps, s);
  else if (logit_dtype == kFloat32 && label_dtype == kUInt8)
    launch<float, uint8_t>(logits, labels, m, part, n_blocks, p, c, pps, s);
  else if (logit_dtype == kFloat32 && label_dtype == kInt32)
    launch<float, int32_t>(logits, labels, m, part, n_blocks, p, c, pps, s);
  else
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_final_kernel<<<1, kThreads, 0, s>>>(part, n_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
