// K5: streaming confusion matrix, accumulated in place.
//
// Replaces the Pallas kernel `_confmat_kernel` (fcn8s_tensorflow_tpu/ops/
// pallas_kernels.py, via `confusion_matrix_pallas`), which built one-hot
// chunks in VMEM and counted them with MXU dots. On the card the same counts
// are a 2-D histogram: conf[gt, pred] += 1 for every pixel whose ids lie in
// [0, C) and whose sample's mask entry is not 0.
//
// Bound: bytes and atomic throughput. Each pixel reads its two ids (5 bytes
// with uint8 labels and int32 predictions) and adds one to a bin. Design:
// while the C x C int32 bins fit in 48 KB of shared memory each block keeps
// its own copy, so the per-pixel atomics stay on the SM, and adds its
// non-zero bins to the global matrix once at the end; above that size the
// pixels add to the global matrix directly. Integer counts, so the order of
// the atomics does not change the result.
#include "common.cuh"

namespace fcn8s {
namespace {

template <typename TP, typename TG, bool kShared>
__global__ void __launch_bounds__(kThreads)
confmat_kernel(const TP* __restrict__ pred, const TG* __restrict__ gt,
               const float* __restrict__ mask, int* __restrict__ conf, int64_t p, int c,
               int64_t pps) {
  extern __shared__ int bins[];
  const int cc = c * c;
  if (kShared) {
    for (int k = threadIdx.x; k < cc; k += kThreads) bins[k] = 0;
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < p;
       i += stride) {
    const int64_t g = static_cast<int64_t>(gt[i]);
    const int64_t q = static_cast<int64_t>(pred[i]);
    if (g < 0 || g >= c || q < 0 || q >= c || mask[i / pps] == 0.f) continue;
    const int bin = static_cast<int>(g) * c + static_cast<int>(q);
    if (kShared) atomicAdd(&bins[bin], 1);
    else atomicAdd(&conf[bin], 1);
  }
  if (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < cc; k += kThreads)
      if (bins[k]) atomicAdd(&conf[k], bins[k]);
  }
}

template <typename TP, typename TG>
void launch(const void* pred, const void* gt, const float* mask, int* conf, int64_t p, int c,
            int64_t pps, cudaStream_t stream) {
  const int64_t blocks = (p + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 1024 ? blocks : 1024);
  const size_t smem = static_cast<size_t>(c) * c * sizeof(int);
  const TP* pr = static_cast<const TP*>(pred);
  const TG* gr = static_cast<const TG*>(gt);
  if (smem <= 48 * 1024)
    confmat_kernel<TP, TG, true><<<grid, kThreads, smem, stream>>>(pr, gr, mask, conf, p, c, pps);
  else
    confmat_kernel<TP, TG, false><<<grid, kThreads, 0, stream>>>(pr, gr, mask, conf, p, c, pps);
}

}  // namespace
}  // namespace fcn8s

// pred, gt: (p,) ids; mask: (p / pps,) float32; conf: (c, c) int32, rows = gt,
// cols = pred, added to in place.
extern "C" int fcn8s_confmat_accumulate(const void* pred, const void* gt, const void* mask,
                                        void* conf, int64_t p, int c, int64_t pps,
                                        int pred_dtype, int gt_dtype, void* stream) {
  using namespace fcn8s;
  if (p <= 0 || c <= 0 || pps <= 0 || p % pps) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  int* cf = static_cast<int*>(conf);
  if (pred_dtype == kInt32 && gt_dtype == kUInt8)
    launch<int32_t, uint8_t>(pred, gt, m, cf, p, c, pps, s);
  else if (pred_dtype == kInt32 && gt_dtype == kInt32)
    launch<int32_t, int32_t>(pred, gt, m, cf, p, c, pps, s);
  else if (pred_dtype == kUInt8 && gt_dtype == kUInt8)
    launch<uint8_t, uint8_t>(pred, gt, m, cf, p, c, pps, s);
  else if (pred_dtype == kUInt8 && gt_dtype == kInt32)
    launch<uint8_t, int32_t>(pred, gt, m, cf, p, c, pps, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
