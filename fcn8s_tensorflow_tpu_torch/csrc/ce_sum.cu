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
// the compact labels and weights are read in the same pass. Design
// (row_tiles.cuh, shared with the CE grad): tiles of whole rows, with their
// labels and (K3) weights beside them, reach shared memory by 16-byte
// cp.async copies, three stages deep, so the next tiles' copies overlap the
// current tile's math; a thread takes its rows from shared memory in 8- or
// 16-byte words with an online (max-shifted) log-sum-exp in fp32.
//
// The sum across blocks is deterministic: each block adds its rows in a fixed
// order and writes its partial to a scratch buffer the wrapper allocates, then
// one block adds the partials in a fixed order in double precision. The grid
// and the tile are functions of the shape and dtype alone (ops/kernels.py
// `ce_tiling`), and no float atomics are used, so the loss is identical from
// run to run.
#include "row_tiles.cuh"

namespace fcn8s {
namespace {

template <bool kPerPixel, int kRowBytes, typename T, typename L>
__global__ void __launch_bounds__(kThreads)
ce_partial_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                  const float* __restrict__ weights, float* __restrict__ partials, int64_t p,
                  int c, int64_t pps, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLayout lay(rows, c, sizeof(T), sizeof(L),
                       kPerPixel ? staged_bytes(rows, sizeof(float)) : 0, false);
  auto x_tile = [&](int s) { return reinterpret_cast<T*>(smem + s * lay.stage); };
  auto l_tile = [&](int s) { return reinterpret_cast<L*>(smem + s * lay.stage + lay.logits); };
  auto w_tile = [&](int s) {
    return reinterpret_cast<float*>(smem + s * lay.stage + lay.logits + lay.labels);
  };
  const int x_lead = lead_of<T>(logits), l_lead = lead_of<L>(labels);
  const int w_lead = kPerPixel ? lead_of<float>(weights) : 0;
  const int64_t tiles = (p + rows - 1) / rows;
  float acc = 0.f;

  auto issue = [&](int64_t t, int s) {
    const int64_t r0 = t * rows;
    const int64_t r1 = min(r0 + rows, p);
    stage_async(x_tile(s), logits, r0 * c, r1 * c);
    stage_async(l_tile(s), labels, r0, r1);
    if (kPerPixel) stage_async(w_tile(s), weights, r0, r1);
  };

  auto consume = [&](int64_t t, int s) {
    const int64_t r0 = t * rows;
    const int n = static_cast<int>(min(static_cast<int64_t>(rows), p - r0));
    const T* x = x_tile(s) + x_lead;
    const L* lab = l_tile(s) + l_lead;
    const float* w = w_tile(s) + w_lead;
    const SampleWeight sample_weight(weights, pps, r0, n);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const T* row = x + r * c;
      const float2 ms = row_max_sumexp<kRowBytes>(row, c);
      const int label = static_cast<int>(lab[r]);
      const float pick = label >= 0 && label < c ? to_float(row[label]) : 0.f;
      const float weight = kPerPixel ? w[r] : sample_weight(r0 + r);
      acc += weight * (ms.x + logf(ms.y) - pick);
    }
  };

  pipeline_tiles(tiles, issue, consume);
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

template <bool kPerPixel, int kRowBytes, typename T, typename L>
int launch(const void* logits, const void* labels, const float* weights, float* partials,
           int n_blocks, int64_t p, int c, int64_t pps, int rows, cudaStream_t stream) {
  const TileLayout lay(rows, c, sizeof(T), sizeof(L),
                       kPerPixel ? staged_bytes(rows, sizeof(float)) : 0, false);
  auto kernel = ce_partial_kernel<kPerPixel, kRowBytes, T, L>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_blocks, kThreads, lay.total, stream>>>(static_cast<const T*>(logits),
                                                    static_cast<const L*>(labels), weights,
                                                    partials, p, c, pps, rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPerPixel, typename T, typename L>
int by_width(const void* logits, const void* labels, const float* weights, float* partials,
             int n_blocks, int64_t p, int c, int64_t pps, int rows, cudaStream_t s) {
  switch (row_word_bytes(c * sizeof(T), lead_of<char>(logits), lead_of<char>(logits))) {
    case 16: return launch<kPerPixel, 16, T, L>(logits, labels, weights, partials, n_blocks, p, c, pps, rows, s);
    case 8: return launch<kPerPixel, 8, T, L>(logits, labels, weights, partials, n_blocks, p, c, pps, rows, s);
    case 4: return launch<kPerPixel, 4, T, L>(logits, labels, weights, partials, n_blocks, p, c, pps, rows, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<kPerPixel, 2, T, L>(logits, labels, weights, partials, n_blocks, p, c, pps, rows, s);
      return cudaErrorInvalidValue;
  }
}

template <bool kPerPixel>
int run(const void* logits, const void* labels, const void* weights, void* partials, void* out,
        int n_blocks, int64_t p, int c, int64_t pps, int rows, int logit_dtype, int label_dtype,
        void* stream) {
  if (p <= 0 || c <= 0 || pps <= 0 || p % pps || n_blocks <= 0 || rows <= 0 ||
      rows % kTileRowMultiple || rows > kMaxTileRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(weights);
  float* part = static_cast<float*>(partials);
  int rc;
  if (logit_dtype == kBFloat16 && label_dtype == kUInt8)
    rc = by_width<kPerPixel, __nv_bfloat16, uint8_t>(logits, labels, wt, part, n_blocks, p, c, pps, rows, s);
  else if (logit_dtype == kBFloat16 && label_dtype == kInt32)
    rc = by_width<kPerPixel, __nv_bfloat16, int32_t>(logits, labels, wt, part, n_blocks, p, c, pps, rows, s);
  else if (logit_dtype == kFloat32 && label_dtype == kUInt8)
    rc = by_width<kPerPixel, float, uint8_t>(logits, labels, wt, part, n_blocks, p, c, pps, rows, s);
  else if (logit_dtype == kFloat32 && label_dtype == kInt32)
    rc = by_width<kPerPixel, float, int32_t>(logits, labels, wt, part, n_blocks, p, c, pps, rows, s);
  else
    return cudaErrorInvalidValue;
  if (rc != cudaSuccess) return rc;
  ce_final_kernel<<<1, kThreads, 0, s>>>(part, n_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fcn8s

// K1. logits: (p, c) contiguous; labels: (p,); mask: (p / pps,) float32;
// partials: n_blocks float32 of scratch; out: one float32 (S above); rows:
// pixel rows a tile (a multiple of 16).
extern "C" int fcn8s_ce_sum_per_sample(const void* logits, const void* labels, const void* mask,
                                       void* partials, void* out, int n_blocks, int64_t p,
                                       int c, int64_t pps, int rows, int logit_dtype,
                                       int label_dtype, void* stream) {
  return fcn8s::run<false>(logits, labels, mask, partials, out, n_blocks, p, c, pps, rows,
                           logit_dtype, label_dtype, stream);
}

// K3. As K1 with weights: (p,) float32, one per pixel.
extern "C" int fcn8s_ce_sum_weighted(const void* logits, const void* labels, const void* weights,
                                     void* partials, void* out, int n_blocks, int64_t p, int c,
                                     int rows, int logit_dtype, int label_dtype, void* stream) {
  return fcn8s::run<true>(logits, labels, weights, partials, out, n_blocks, p, c, 1, rows,
                          logit_dtype, label_dtype, stream);
}
