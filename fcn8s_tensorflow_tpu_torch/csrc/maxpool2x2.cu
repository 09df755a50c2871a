// K4f: 2x2 / stride-2 max pool over NHWC memory, forward only.
//
// Replaces the primal-only Pallas kernel `_fwd_only_kernel`
// (fcn8s_tensorflow_tpu/ops/pallas_pool.py), which the JAX package reached
// through `max_pool_2x2_pallas`; here it serves all five VGG-16 pools.
//
// Bound: bytes. Each output element costs four input reads and one write and
// no arithmetic worth counting (pool1 at batch 8 x 512x1024 reads 537 MB of
// bf16). Design: one thread per output pixel and 16-byte run of channels,
// so a warp reads whole 128-byte lines of the channel-minor input with
// vectorised loads; the TPU kernel's row-pair view and lane split have no
// counterpart because the card pads no lanes. Indexing is 32-bit when the
// tensor allows it (integer division is the only other cost).
//
// Semantics: lax.max, so NaN propagates (`v > m || isnan(v)`, never fmaxf);
// ties keep the earlier element in window order (r0,w0),(r0,w1),(r1,w0),(r1,w1),
// the order F.max_pool2d also scans, so the result is bit-identical to it.
#include "common.cuh"

namespace fcn8s {
namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T>
__device__ __forceinline__ T max_nan(T m, T v) {
  const float fm = to_float(m), fv = to_float(v);
  return (fv > fm || isnan(fv)) ? v : m;
}

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
maxpool2x2_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y, I n_out, I ho, I wo,
                       I cv, I w, I c) {
  using P = Pack<T, V>;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < n_out; i += stride) {
    const I k = i % cv;  // which run of V channels
    const I pix = i / cv;
    const I ox = pix % wo;
    const I t = pix / wo;
    const I oy = t % ho;
    const I n = t / ho;
    const I base = ((n * 2 * ho + 2 * oy) * w + 2 * ox) * c + k * V;
    const P a = *reinterpret_cast<const P*>(x + base);
    const P b = *reinterpret_cast<const P*>(x + base + c);
    const P d = *reinterpret_cast<const P*>(x + base + w * c);
    const P e = *reinterpret_cast<const P*>(x + base + w * c + c);
    P out;
#pragma unroll
    for (int j = 0; j < V; ++j) out.v[j] = max_nan(max_nan(max_nan(a.v[j], b.v[j]), d.v[j]), e.v[j]);
    *reinterpret_cast<P*>(y + i * V) = out;
  }
}

template <typename T, int V, typename I>
void launch(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c,
            cudaStream_t stream) {
  const int64_t ho = h / 2, wo = w / 2, cv = c / V;
  const int64_t n_out = n * ho * wo * cv;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
  maxpool2x2_nhwc_kernel<T, V, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<I>(n_out), static_cast<I>(ho),
      static_cast<I>(wo), static_cast<I>(cv), static_cast<I>(w), static_cast<I>(c));
}

template <typename T>
void dispatch(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c,
              cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = c % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  // 32-bit indices while every input offset (and the grid-stride overshoot) fits
  const bool small = n * h * w * c + static_cast<int64_t>(kThreads) * (1 << 20) < (int64_t{1} << 31);
  if (vec && small) launch<T, kVec, uint32_t>(x, y, n, h, w, c, stream);
  else if (vec) launch<T, kVec, int64_t>(x, y, n, h, w, c, stream);
  else if (small) launch<T, 1, uint32_t>(x, y, n, h, w, c, stream);
  else launch<T, 1, int64_t>(x, y, n, h, w, c, stream);
}

}  // namespace
}  // namespace fcn8s

// x: (n, h, w, c) contiguous, h and w even; y: (n, h/2, w/2, c) contiguous.
extern "C" int fcn8s_maxpool2x2_nhwc(const void* x, void* y, int64_t n, int64_t h, int64_t w,
                                     int64_t c, int dtype, void* stream) {
  using namespace fcn8s;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || h % 2 || w % 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) dispatch<float>(x, y, n, h, w, c, s);
  else if (dtype == kBFloat16) dispatch<__nv_bfloat16>(x, y, n, h, w, c, s);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
