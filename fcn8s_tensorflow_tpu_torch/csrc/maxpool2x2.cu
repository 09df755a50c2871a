// K4f, K4a, K4b: 2x2 / stride-2 max pool over NHWC memory, forward and backward.
//
// Replaces the Pallas kernels of fcn8s_tensorflow_tpu/ops/pallas_pool.py that
// back `max_pool_2x2_pallas`:
//   K4f `_fwd_only_kernel` - the primal-only forward (inference, eval);
//   K4a `_fwd_kernel`      - the forward of the custom VJP, which also writes
//                            a 2-bit first-max code per output element;
//   K4b `_bwd_kernel`      - the backward, which routes dy to the coded
//                            position without re-reading x.
// Here they serve all five VGG-16 pools: K4f under no_grad, K4a/K4b under
// autograd (ops/pool.py).
//
// Bound: bytes. No arithmetic worth counting: at batch 8 x 1024x512, pool1
// reads 537 MB of bf16 in K4f/K4a (K4a also writes 134 MB of y and 67 MB of
// code), and K4b reads 201 MB (dy and code) and writes 537 MB of dx. Design:
// one thread per output pixel and 16-byte run of channels, so a warp reads
// and writes whole 128-byte lines of the channel-minor tensors with vector
// loads; the code is one byte per channel (uint8, where the TPU had to keep
// it in the input dtype because Mosaic rejected the int8 relayout), so a
// thread's code is one 8-byte (bf16) or 4-byte (fp32) access. K4b writes every
// element of dx, the routed dy or zero, so no memset precedes it. The TPU
// kernels' row-pair view and lane split have no counterpart: the card pads no
// lanes. Indexing is 32-bit when the tensor allows it (integer division is
// the only other cost).
//
// Semantics: lax.max, so NaN propagates (`v > m || isnan(v)`, never fmaxf);
// ties keep the earlier element in window order (r0,w0),(r0,w1),(r1,w0),(r1,w1),
// the first-max rule of lax.select_and_scatter and of F.max_pool2d, so y, the
// code and dx are bit-identical to both.
#include "common.cuh"

namespace fcn8s {
namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

enum class Mode { kFwd, kFwdCode, kBwd };

// whether v replaces the running max m in window order
template <typename T>
__device__ __forceinline__ bool takes(T m, T v) {
  const float fm = to_float(m), fv = to_float(v);
  return fv > fm || isnan(fv);
}

// kFwd:     src = x,  dst = y
// kFwdCode: src = x,  dst = y, code_out = code
// kBwd:     src = dy, code_in = code, dst = dx
template <Mode M, typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const T* __restrict__ src, const uint8_t* __restrict__ code_in, T* __restrict__ dst,
            uint8_t* __restrict__ code_out, I n_out, I ho, I wo, I cv, I w, I c) {
  using P = Pack<T, V>;
  using Q = Pack<uint8_t, V>;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < n_out; i += stride) {
    const I k = i % cv;  // which run of V channels
    const I pix = i / cv;
    const I ox = pix % wo;
    const I t = pix / wo;
    const I oy = t % ho;
    const I n = t / ho;
    // offset of the window's first element in the full-resolution tensor
    const I base = ((n * 2 * ho + 2 * oy) * w + 2 * ox) * c + k * V;
    const I off[4] = {base, base + c, base + w * c, base + w * c + c};
    if constexpr (M == Mode::kBwd) {
      const P g = *reinterpret_cast<const P*>(src + i * V);
      const Q q = *reinterpret_cast<const Q*>(code_in + i * V);
      const T zero = from_float<T>(0.f);
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        P out;
#pragma unroll
        for (int j = 0; j < V; ++j) out.v[j] = q.v[j] == tap ? g.v[j] : zero;
        *reinterpret_cast<P*>(dst + off[tap]) = out;
      }
    } else {
      P win[4];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) win[tap] = *reinterpret_cast<const P*>(src + off[tap]);
      P out;
      Q q;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        T m = win[0].v[j];
        uint8_t arg = 0;
#pragma unroll
        for (int tap = 1; tap < 4; ++tap) {
          if (takes(m, win[tap].v[j])) {
            m = win[tap].v[j];
            arg = static_cast<uint8_t>(tap);
          }
        }
        out.v[j] = m;
        q.v[j] = arg;
      }
      *reinterpret_cast<P*>(dst + i * V) = out;
      if constexpr (M == Mode::kFwdCode) *reinterpret_cast<Q*>(code_out + i * V) = q;
    }
  }
}

template <Mode M, typename T, int V, typename I>
void launch(const void* src, const void* code_in, void* dst, void* code_out, int64_t n,
            int64_t h, int64_t w, int64_t c, cudaStream_t stream) {
  const int64_t ho = h / 2, wo = w / 2, cv = c / V;
  const int64_t n_out = n * ho * wo * cv;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
  pool_kernel<M, T, V, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const uint8_t*>(code_in), static_cast<T*>(dst),
      static_cast<uint8_t*>(code_out), static_cast<I>(n_out), static_cast<I>(ho),
      static_cast<I>(wo), static_cast<I>(cv), static_cast<I>(w), static_cast<I>(c));
}

// h, w: the full-resolution (pool input) dims
template <Mode M, typename T>
void dispatch(const void* src, const void* code_in, void* dst, void* code_out, int64_t n,
              int64_t h, int64_t w, int64_t c, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t data = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  const uintptr_t code = reinterpret_cast<uintptr_t>(code_in) |
                         reinterpret_cast<uintptr_t>(code_out);  // 0 for kFwd
  const bool vec = c % kVec == 0 && data % 16 == 0 && code % kVec == 0;
  // 32-bit indices while every offset (and the grid-stride overshoot) fits
  const bool small = n * h * w * c + static_cast<int64_t>(kThreads) * (1 << 20) < (int64_t{1} << 31);
  if (vec && small) launch<M, T, kVec, uint32_t>(src, code_in, dst, code_out, n, h, w, c, stream);
  else if (vec) launch<M, T, kVec, int64_t>(src, code_in, dst, code_out, n, h, w, c, stream);
  else if (small) launch<M, T, 1, uint32_t>(src, code_in, dst, code_out, n, h, w, c, stream);
  else launch<M, T, 1, int64_t>(src, code_in, dst, code_out, n, h, w, c, stream);
}

template <Mode M>
int run(const void* src, const void* code_in, void* dst, void* code_out, int64_t n, int64_t h,
        int64_t w, int64_t c, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || h % 2 || w % 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) dispatch<M, float>(src, code_in, dst, code_out, n, h, w, c, s);
  else if (dtype == kBFloat16) dispatch<M, __nv_bfloat16>(src, code_in, dst, code_out, n, h, w, c, s);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fcn8s

// K4f. x: (n, h, w, c) contiguous, h and w even; y: (n, h/2, w/2, c) contiguous.
extern "C" int fcn8s_maxpool2x2_nhwc(const void* x, void* y, int64_t n, int64_t h, int64_t w,
                                     int64_t c, int dtype, void* stream) {
  using namespace fcn8s;
  return run<Mode::kFwd>(x, nullptr, y, nullptr, n, h, w, c, dtype, stream);
}

// K4a. As K4f, plus code: (n, h/2, w/2, c) uint8 in 0..3, the window position
// of the first maximum.
extern "C" int fcn8s_maxpool2x2_code_nhwc(const void* x, void* y, void* code, int64_t n,
                                          int64_t h, int64_t w, int64_t c, int dtype,
                                          void* stream) {
  using namespace fcn8s;
  return run<Mode::kFwdCode>(x, nullptr, y, code, n, h, w, c, dtype, stream);
}

// K4b. dy, code: (n, h/2, w/2, c) contiguous; dx: (n, h, w, c) contiguous,
// every element written.
extern "C" int fcn8s_maxpool2x2_bwd_nhwc(const void* dy, const void* code, void* dx, int64_t n,
                                         int64_t h, int64_t w, int64_t c, int dtype,
                                         void* stream) {
  using namespace fcn8s;
  return run<Mode::kBwd>(dy, code, dx, nullptr, n, h, w, c, dtype, stream);
}
