// K1 and K3 forward: weighted softmax cross-entropy sums.
//
// One row loop serves both Pallas kernels of fcn8s_tensorflow_tpu/ops/
// pallas_kernels.py, templated on where a pixel's weight comes from:
//   K1 `_lse_sum_kernel` (via `_ce_sample_impl`), together with the XLA label
//      pick that the TPU kept outside it: a per-sample weight mask[p / pps];
//   K3 `_ce_fwd_kernel` (via `_ce_sum_impl`): a per-pixel fp32 weight w[p]
//      (class weights, ignore_label).
//
//   S = sum_p weight_p * (lse_p - pick_p),
//   lse_p = log sum_c exp(logits[p, c]),  pick_p = logits[p, label_p] or 0
//   when label_p lies outside [0, C).
//
// Bound: bytes. Each pixel's C logits are read once (168 MB of bf16 at batch
// 8 x 1024x512 x 20 classes; K3 adds 17 MB of fp32 weights) for about 2C
// flops and C exponentials. The TPU kept the pick outside K1, and padded K3's
// classes and per-pixel inputs to 128 lanes, only because of its tiling; here
// the compact labels and weights are read in the same pass. Design: one
// thread per pixel row with an online (max-shifted) log-sum-exp in fp32;
// neighbouring threads read neighbouring rows, so a warp's loads fall on a
// few contiguous lines that L1 serves across the C iterations.
//
// The sum across blocks is deterministic: each block writes its partial to a
// scratch buffer the wrapper allocates, then one block adds the partials in a
// fixed order in double precision. No float atomics, so the loss is
// identical from run to run.
#include "common.cuh"

namespace fcn8s {
namespace {

template <bool kPerPixel, typename T, typename L, typename I>
__global__ void __launch_bounds__(kThreads)
ce_partial_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                  const float* __restrict__ weights, float* __restrict__ partials, I p, int c,
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
    const float weight = kPerPixel ? weights[i] : weights[i / pps];
    acc += weight * (m + logf(s) - pick);
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

template <bool kPerPixel, typename T, typename L>
void launch(const void* logits, const void* labels, const float* weights, float* partials,
            int n_blocks, int64_t p, int c, int64_t pps, cudaStream_t stream) {
  const T* lg = static_cast<const T*>(logits);
  const L* lb = static_cast<const L*>(labels);
  if (p * c + static_cast<int64_t>(kThreads) * n_blocks < (int64_t{1} << 31)) {
    ce_partial_kernel<kPerPixel, T, L, uint32_t><<<n_blocks, kThreads, 0, stream>>>(
        lg, lb, weights, partials, static_cast<uint32_t>(p), c, static_cast<uint32_t>(pps));
  } else {
    ce_partial_kernel<kPerPixel, T, L, int64_t><<<n_blocks, kThreads, 0, stream>>>(
        lg, lb, weights, partials, p, c, pps);
  }
}

template <bool kPerPixel>
int run(const void* logits, const void* labels, const void* weights, void* partials, void* out,
        int n_blocks, int64_t p, int c, int64_t pps, int logit_dtype, int label_dtype,
        void* stream) {
  if (p <= 0 || c <= 0 || pps <= 0 || p % pps || n_blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(weights);
  float* part = static_cast<float*>(partials);
  if (logit_dtype == kBFloat16 && label_dtype == kUInt8)
    launch<kPerPixel, __nv_bfloat16, uint8_t>(logits, labels, wt, part, n_blocks, p, c, pps, s);
  else if (logit_dtype == kBFloat16 && label_dtype == kInt32)
    launch<kPerPixel, __nv_bfloat16, int32_t>(logits, labels, wt, part, n_blocks, p, c, pps, s);
  else if (logit_dtype == kFloat32 && label_dtype == kUInt8)
    launch<kPerPixel, float, uint8_t>(logits, labels, wt, part, n_blocks, p, c, pps, s);
  else if (logit_dtype == kFloat32 && label_dtype == kInt32)
    launch<kPerPixel, float, int32_t>(logits, labels, wt, part, n_blocks, p, c, pps, s);
  else
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_final_kernel<<<1, kThreads, 0, s>>>(part, n_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fcn8s

// K1. logits: (p, c) contiguous; labels: (p,); mask: (p / pps,) float32;
// partials: n_blocks float32 of scratch; out: one float32 (S above).
extern "C" int fcn8s_ce_sum_per_sample(const void* logits, const void* labels, const void* mask,
                                       void* partials, void* out, int n_blocks, int64_t p,
                                       int c, int64_t pps, int logit_dtype, int label_dtype,
                                       void* stream) {
  return fcn8s::run<false>(logits, labels, mask, partials, out, n_blocks, p, c, pps, logit_dtype,
                           label_dtype, stream);
}

// K3. As K1 with weights: (p,) float32, one per pixel.
extern "C" int fcn8s_ce_sum_weighted(const void* logits, const void* labels, const void* weights,
                                     void* partials, void* out, int n_blocks, int64_t p, int c,
                                     int logit_dtype, int label_dtype, void* stream) {
  return fcn8s::run<true>(logits, labels, weights, partials, out, n_blocks, p, c, 1, logit_dtype,
                          label_dtype, stream);
}
