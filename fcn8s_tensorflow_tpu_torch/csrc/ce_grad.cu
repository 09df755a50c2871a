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
// zeros. A pixel whose weight is 0 gets exact zeros, and a tile whose pixels
// all weigh 0 (a masked-out sample is whole tiles) is not read at all, only
// zero-filled. g, the upstream gradient of the sum, is read from device
// memory, so the backward never waits for the host.
//
// Bound: bytes. It reads 168 MB of bf16 logits and writes 168 MB at the
// train shape. Design (row_tiles.cuh): tiles of whole rows reach shared
// memory by 16-byte cp.async copies, three stages deep, so a tile's copy
// overlaps the math of the tiles before it. A thread takes a row from shared
// memory in 8- or 16-byte words: the first pass takes the online max and
// exponential sum (branch-free, about one SFU exponential per element), the
// second writes exp(v - m) / s * w * g into an output tile and then the
// label's entry, (exp(v_label - m) / s - 1) * w * g; the block stores the
// tile as 16-byte lines. A tile's weights, read into registers one tile
// ahead, decide whether its copy is issued at all.
#include "row_tiles.cuh"

namespace fcn8s {
namespace {

template <bool kPerPixel, int kRowBytes, typename T, typename L>
__global__ void __launch_bounds__(kThreads)
ce_grad_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
               const float* __restrict__ weights, const float* __restrict__ g,
               T* __restrict__ dlogits, int64_t p, int c, int64_t pps, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPer = kRowBytes / sizeof(T);
  const TileLayout lay(rows, c, sizeof(T), sizeof(L), rows * sizeof(float), true);
  auto x_tile = [&](int s) { return reinterpret_cast<T*>(smem + s * lay.stage); };
  auto l_tile = [&](int s) { return reinterpret_cast<L*>(smem + s * lay.stage + lay.logits); };
  auto w_tile = [&](int s) {
    return reinterpret_cast<float*>(smem + s * lay.stage + lay.logits + lay.labels);
  };
  T* out_tile = reinterpret_cast<T*>(smem + kStages * lay.stage);
  const int x_lead = lead_of<T>(logits), l_lead = lead_of<L>(labels);
  const int o_lead = lead_of<T>(dlogits);
  const float scale = *g;
  const int64_t tiles = (p + rows - 1) / rows;

  // A tile's weights decide whether its copy is issued; they are loaded into
  // registers one tile ahead, so the issue never waits for them.
  constexpr int kRowsPerThread = kMaxTileRows / kThreads;
  float w_next[kRowsPerThread];
  auto fetch_weights = [&](int64_t t) {
    if (t >= tiles) return;
    const int64_t r0 = t * rows;
    const int n = static_cast<int>(min(static_cast<int64_t>(rows), p - r0));
    if (kPerPixel) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = threadIdx.x + i * kThreads;
        w_next[i] = r < n ? weights[r0 + r] : 0.f;
      }
    } else {
      const SampleWeight weight(weights, pps, r0, n);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = threadIdx.x + i * kThreads;
        w_next[i] = r < n ? weight(r0 + r) : 0.f;
      }
    }
  };
  fetch_weights(blockIdx.x);

  auto issue = [&](int64_t t, int s) {
    const int64_t r0 = t * rows;
    const int n = static_cast<int>(min(static_cast<int64_t>(rows), p - r0));
    float* w = w_tile(s);
    int any = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = threadIdx.x + i * kThreads;
      if (r < n) w[r] = w_next[i];
      any |= w_next[i] != 0.f;
    }
    fetch_weights(t + gridDim.x);  // the block's next tile
    if (__syncthreads_or(any)) {  // an all-zero tile is neither read nor waited for
      stage_async(x_tile(s), logits, r0 * c, (r0 + n) * c);
      stage_async(l_tile(s), labels, r0, r0 + n);
    }
  };

  auto consume = [&](int64_t t, int s) {
    const int64_t r0 = t * rows;
    const int n = static_cast<int>(min(static_cast<int64_t>(rows), p - r0));
    const T* x = x_tile(s) + x_lead;
    const L* lab = l_tile(s) + l_lead;
    const float* w = w_tile(s);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      T* out = out_tile + o_lead + r * c;
      const T* row = x + r * c;
      if (w[r] == 0.f) {
        zero_row<kRowBytes>(out, c);
        continue;
      }
      const float2 ms = row_max_sumexp<kRowBytes>(row, c);
      const float m = ms.x, inv = 1.f / ms.y, wg = w[r] * scale, pwg = inv * wg;
      map_words<kRowBytes>(row, out, c, [&](const float* v, float* o) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) o[q] = exp_shifted(v[q], m) * pwg;
      });
      const int label = static_cast<int>(lab[r]);
      if (label >= 0 && label < c)  // the one-hot term, in place of the label's entry
        out[label] = from_float<T>((exp_shifted(to_float(row[label]), m) * inv - 1.f) * wg);
    }
    __syncthreads();
    store_tile(dlogits, out_tile, r0 * c, (r0 + n) * c);
  };

  pipeline_tiles(tiles, issue, consume);
}

template <bool kPerPixel, int kRowBytes, typename T, typename L>
int launch(const void* logits, const void* labels, const float* weights, const float* g,
           void* dlogits, int64_t p, int c, int64_t pps, int rows, int blocks,
           cudaStream_t stream) {
  const TileLayout lay(rows, c, sizeof(T), sizeof(L), rows * sizeof(float), true);
  auto kernel = ce_grad_kernel<kPerPixel, kRowBytes, T, L>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, lay.total, stream>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), weights, g,
      static_cast<T*>(dlogits), p, c, pps, rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPerPixel, typename T, typename L>
int by_width(const void* logits, const void* labels, const float* weights, const float* g,
             void* dlogits, int64_t p, int c, int64_t pps, int rows, int blocks,
             cudaStream_t s) {
  const int width = row_word_bytes(c * sizeof(T), lead_of<char>(logits),
                                   lead_of<char>(dlogits));
  switch (width) {
    case 16: return launch<kPerPixel, 16, T, L>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
    case 8: return launch<kPerPixel, 8, T, L>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
    case 4: return launch<kPerPixel, 4, T, L>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<kPerPixel, 2, T, L>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
      return cudaErrorInvalidValue;
  }
}

template <bool kPerPixel>
int dispatch(const void* logits, const void* labels, const float* weights, const float* g,
             void* dlogits, int64_t p, int c, int64_t pps, int rows, int blocks, int logit_dtype,
             int label_dtype, cudaStream_t s) {
  if (logit_dtype == kBFloat16 && label_dtype == kUInt8)
    return by_width<kPerPixel, __nv_bfloat16, uint8_t>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
  if (logit_dtype == kBFloat16 && label_dtype == kInt32)
    return by_width<kPerPixel, __nv_bfloat16, int32_t>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
  if (logit_dtype == kFloat32 && label_dtype == kUInt8)
    return by_width<kPerPixel, float, uint8_t>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
  if (logit_dtype == kFloat32 && label_dtype == kInt32)
    return by_width<kPerPixel, float, int32_t>(logits, labels, weights, g, dlogits, p, c, pps, rows, blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fcn8s

// logits, dlogits: (p, c) contiguous, same dtype; labels: (p,); g: one float32.
// per_pixel = 0: weights (p / pps,) float32, one per sample (K1's mask);
// per_pixel = 1: weights (p,) float32, one per pixel (K3's), pps unused.
// rows: pixel rows a tile (a multiple of 16); blocks: the grid.
extern "C" int fcn8s_ce_grad(const void* logits, const void* labels, const void* weights,
                             const void* g, void* dlogits, int64_t p, int c, int64_t pps,
                             int per_pixel, int rows, int blocks, int logit_dtype,
                             int label_dtype, void* stream) {
  using namespace fcn8s;
  if (p <= 0 || c <= 0 || (!per_pixel && (pps <= 0 || p % pps)) || rows <= 0 ||
      rows % kTileRowMultiple || rows > kMaxTileRows || blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(weights);
  const float* gp = static_cast<const float*>(g);
  if (per_pixel)
    return dispatch<true>(logits, labels, wt, gp, dlogits, p, c, 1, rows, blocks, logit_dtype,
                          label_dtype, s);
  return dispatch<false>(logits, labels, wt, gp, dlogits, p, c, pps, rows, blocks, logit_dtype,
                         label_dtype, s);
}
