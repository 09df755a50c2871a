// CE grad: the backward of K1 and K3, fused into one pass.
//
//   dlogits[p, c] = (softmax(logits_p)_c - [c == label_p]) * w_p * g
//
// The hand-written form of the two custom-VJP bodies of fcn8s_tensorflow_tpu/
// ops/pallas_kernels.py, `_ce_sum_sample_bwd` (w_p = mask[p / pps]) and
// `_ce_sum_bwd` (w_p a per-pixel weight). On the TPU these had no
// `pallas_call`: XLA fused them into one pass. In eager PyTorch the same
// formula in plain ops would write an fp32 softmax of the whole logits tensor
// (336 MB at batch 8 x 1024x512 x 20) and read it back several times; this
// kernel reads the logits once and writes the gradient once, in the logits'
// dtype, with the arithmetic in fp32. A label outside [0, C) one-hots to
// zeros. A pixel whose weight is 0 gets exact zeros without its row being
// read. g, the upstream gradient of the sum, is read from device memory, so
// the backward never waits for the host.
//
// Bound: bytes. It reads 168 MB of bf16 logits and writes 168 MB at the
// train shape. Design: one thread per pixel row, the same as K1: the first
// pass over the row takes the online max and exponential sum, the second
// (served by L1) writes (exp(v - m) / s - onehot) * w * g.
#include "common.cuh"

namespace fcn8s {
namespace {

template <bool kPerPixel, typename T, typename L, typename I>
__global__ void __launch_bounds__(kThreads)
ce_grad_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
               const float* __restrict__ weights, const float* __restrict__ g,
               T* __restrict__ dlogits, I p, int c, I pps) {
  const float scale = *g;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < p; i += stride) {
    T* out = dlogits + i * static_cast<I>(c);
    const float weight = kPerPixel ? weights[i] : weights[i / pps];
    if (weight == 0.f) {
      const T zero = from_float<T>(0.f);
      for (int j = 0; j < c; ++j) out[j] = zero;
      continue;
    }
    const T* row = logits + i * static_cast<I>(c);
    float m = -INFINITY, s = 0.f;
    for (int j = 0; j < c; ++j) {
      const float v = to_float(row[j]);
      if (v > m) {
        s = s * expf(m - v) + 1.f;
        m = v;
      } else {
        s += expf(v - m);
      }
    }
    const int label = static_cast<int>(labels[i]);
    for (int j = 0; j < c; ++j) {
      const float d = expf(to_float(row[j]) - m) / s - (j == label ? 1.f : 0.f);
      out[j] = from_float<T>(d * weight * scale);
    }
  }
}

template <bool kPerPixel, typename T, typename L>
void launch(const void* logits, const void* labels, const float* weights, const float* g,
            void* dlogits, int64_t p, int c, int64_t pps, cudaStream_t stream) {
  const int64_t blocks = (p + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20));
  const T* lg = static_cast<const T*>(logits);
  const L* lb = static_cast<const L*>(labels);
  T* out = static_cast<T*>(dlogits);
  if (p * c + static_cast<int64_t>(kThreads) * grid * c < (int64_t{1} << 31)) {
    ce_grad_kernel<kPerPixel, T, L, uint32_t><<<grid, kThreads, 0, stream>>>(
        lg, lb, weights, g, out, static_cast<uint32_t>(p), c, static_cast<uint32_t>(pps));
  } else {
    ce_grad_kernel<kPerPixel, T, L, int64_t><<<grid, kThreads, 0, stream>>>(
        lg, lb, weights, g, out, p, c, pps);
  }
}

template <bool kPerPixel>
void dispatch(const void* logits, const void* labels, const float* weights, const float* g,
              void* dlogits, int64_t p, int c, int64_t pps, int logit_dtype, int label_dtype,
              cudaStream_t s, bool* ok) {
  *ok = true;
  if (logit_dtype == kBFloat16 && label_dtype == kUInt8)
    launch<kPerPixel, __nv_bfloat16, uint8_t>(logits, labels, weights, g, dlogits, p, c, pps, s);
  else if (logit_dtype == kBFloat16 && label_dtype == kInt32)
    launch<kPerPixel, __nv_bfloat16, int32_t>(logits, labels, weights, g, dlogits, p, c, pps, s);
  else if (logit_dtype == kFloat32 && label_dtype == kUInt8)
    launch<kPerPixel, float, uint8_t>(logits, labels, weights, g, dlogits, p, c, pps, s);
  else if (logit_dtype == kFloat32 && label_dtype == kInt32)
    launch<kPerPixel, float, int32_t>(logits, labels, weights, g, dlogits, p, c, pps, s);
  else
    *ok = false;
}

}  // namespace
}  // namespace fcn8s

// logits, dlogits: (p, c) contiguous, same dtype; labels: (p,); g: one float32.
// per_pixel = 0: weights (p / pps,) float32, one per sample (K1's mask);
// per_pixel = 1: weights (p,) float32, one per pixel (K3's), pps unused.
extern "C" int fcn8s_ce_grad(const void* logits, const void* labels, const void* weights,
                             const void* g, void* dlogits, int64_t p, int c, int64_t pps,
                             int per_pixel, int logit_dtype, int label_dtype, void* stream) {
  using namespace fcn8s;
  if (p <= 0 || c <= 0 || (!per_pixel && (pps <= 0 || p % pps))) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(weights);
  const float* gp = static_cast<const float*>(g);
  bool ok;
  if (per_pixel)
    dispatch<true>(logits, labels, wt, gp, dlogits, p, c, 1, logit_dtype, label_dtype, s, &ok);
  else
    dispatch<false>(logits, labels, wt, gp, dlogits, p, c, pps, logit_dtype, label_dtype, s, &ok);
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
