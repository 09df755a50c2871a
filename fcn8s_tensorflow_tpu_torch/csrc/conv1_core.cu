// KB: the conv1_2-core calibration kernel.
//
// Replaces the Pallas kernel `kernel2` of benchmarks/conv1_block_calibration.py
// (the same body with the halo inside the block is `kernel`). Per 8-row tile
// it emulates conv1_2's forward core as matrix products:
//
//   out[r] = relu( sum_{ky<3} [a || a] @ w128[ky] + a @ w64[ky] ),
//   a = x[(r + ky) mod R]   (a (W, 64) bf16 slab),
//
// bf16 products, fp32 accumulation, rounded to bf16 once after the ReLU. The
// row index wraps mod R: the TPU script fed each tile's halo from
// roll(x, -8, 0), so the last tile reads rows 0 and 1.
//
// Bound: tensor-core operations. Each output pixel needs 64 x 576 MACs (K =
// 192 per tap: 128 for [a || a], 64 for a) against 256 bytes of input and
// output, ~290 FLOP per byte, at the H100's bf16 ridge. Design (a simple,
// right first version; wgmma and TMA are later work):
//
// * persistent blocks, one per SM: each stages the three taps' weights,
//   [w128[ky]; w64[ky]] as a (192, 64) bf16 matrix per tap (83 KB with row
//   padding), in shared memory ONCE, then walks over (8-row tile x 32-pixel
//   strip) work items;
// * per item the 10 halo rows of the strip (46 KB) are staged in shared
//   memory with 16-byte loads, zero-filled past W;
// * 8 warps, one per output row of the tile; each holds the 32 pixels x 64
//   channels of its row in 8 fp32 WMMA accumulators (bf16 16x16x16
//   fragments). The A fragment of a 16-channel slice of a is loaded once and
//   multiplied by the three 16-row weight slices that read it (w128's upper
//   and lower half, w64): the [a || a] concatenation is never built;
// * the epilogue goes through a per-warp fp32 scratch tile, applies the ReLU
//   and stores bf16 with 16-byte stores, masking pixels past W.
//
// The weights are never pre-added (w128[:64] + w128[64:] in bf16 would round
// differently): every product is bf16 x bf16 into the fp32 accumulator.
#include <mma.h>

#include "common.cuh"

namespace fcn8s {
namespace {

using namespace nvcuda;

constexpr int kC = 64;             // channels in and out
constexpr int kTH = 8;             // output rows per tile
constexpr int kHalo = kTH + 2;     // input rows per tile
constexpr int kStrip = 32;         // pixels per work item
constexpr int kK = 3 * kC;         // 192: the K of one tap
constexpr int kLd = kC + 8;        // bf16 row stride in shared memory (144 B: no bank conflicts)
constexpr int kLdAcc = kC + 4;     // fp32 row stride of the epilogue scratch
constexpr int kWarps = kTH;        // one warp per output row
constexpr int kBlock = kWarps * 32;

constexpr size_t kWBytes = size_t(3) * kK * kLd * sizeof(__nv_bfloat16);         // 82,944
constexpr size_t kXBytes = size_t(kHalo) * kStrip * kLd * sizeof(__nv_bfloat16);  // 46,080
constexpr size_t kAccBytes = size_t(kWarps) * 16 * kLdAcc * sizeof(float);        // 34,816
constexpr size_t kSmemBytes = kWBytes + kXBytes + kAccBytes;                      // 163,840

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kBlock, 1)
conv1_core_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w128,
                  const __nv_bfloat16* __restrict__ w64, __nv_bfloat16* __restrict__ out,
                  int64_t rows, int width, int strips, int64_t items) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);              // [3][kK][kLd]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + kWBytes);    // [kHalo][kStrip][kLd]
  float* acc_s = reinterpret_cast<float*>(smem + kWBytes + kXBytes);       // [kWarps][16][kLdAcc]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the weights, once per block: row k of tap ky is w128[ky][k] for k < 128,
  // w64[ky][k - 128] after; 8 bf16 (16 bytes) per load
  constexpr int kVec = 8, kRowVecs = kC / kVec;
  for (int i = tid; i < 3 * kK * kRowVecs; i += kBlock) {
    const int ky = i / (kK * kRowVecs), k = (i / kRowVecs) % kK, v = i % kRowVecs;
    const __nv_bfloat16* src = k < 2 * kC ? w128 + (int64_t(ky) * 2 * kC + k) * kC
                                          : w64 + (int64_t(ky) * kC + (k - 2 * kC)) * kC;
    *reinterpret_cast<uint4*>(ws + (ky * kK + k) * kLd + v * kVec) =
        *reinterpret_cast<const uint4*>(src + v * kVec);
  }

  float* scratch = acc_s + warp * 16 * kLdAcc;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t tile = item / strips;
    const int w0 = static_cast<int>(item % strips) * kStrip;
    __syncthreads();  // the previous item's warps are done with xs (and the weights are in)
    for (int i = tid; i < kHalo * kStrip * kRowVecs; i += kBlock) {
      const int j = i / (kStrip * kRowVecs), p = (i / kRowVecs) % kStrip, v = i % kRowVecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (w0 + p < width) {
        const int64_t row = (tile * kTH + j) % rows;  // the halo wraps mod R
        val = *reinterpret_cast<const uint4*>(x + (row * width + w0 + p) * kC + v * kVec);
      }
      *reinterpret_cast<uint4*>(xs + (j * kStrip + p) * kLd + v * kVec) = val;
    }
    __syncthreads();

    FragC acc[2][kC / 16];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < kC / 16; ++n) wmma::fill_fragment(acc[h][n], 0.f);
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      const __nv_bfloat16* arow = xs + (warp + ky) * kStrip * kLd;
      const __nv_bfloat16* wtap = ws + ky * kK * kLd;
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        FragA a[2];
        wmma::load_matrix_sync(a[0], arow + kk * 16, kLd);
        wmma::load_matrix_sync(a[1], arow + 16 * kLd + kk * 16, kLd);
#pragma unroll
        for (int part = 0; part < 3; ++part) {  // w128[:64], w128[64:], w64: each reads a
          const __nv_bfloat16* wk = wtap + (part * kC + kk * 16) * kLd;
#pragma unroll
          for (int n = 0; n < kC / 16; ++n) {
            FragB b;
            wmma::load_matrix_sync(b, wk + n * 16, kLd);
            wmma::mma_sync(acc[0][n], a[0], b, acc[0][n]);
            wmma::mma_sync(acc[1][n], a[1], b, acc[1][n]);
          }
        }
      }
    }

    // epilogue: 16 pixels x 64 channels at a time through the scratch tile
    const int64_t out_row = tile * kTH + warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int n = 0; n < kC / 16; ++n)
        wmma::store_matrix_sync(scratch + n * 16, acc[h][n], kLdAcc, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 16 * kRowVecs; i += 32) {
        const int p = i / kRowVecs, v = i % kRowVecs;
        const int col = w0 + h * 16 + p;
        if (col < width) {
          __align__(16) __nv_bfloat16 o[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float s = scratch[p * kLdAcc + v * kVec + e];
            o[e] = __float2bfloat16_rn(s < 0.f ? 0.f : s);  // relu; a NaN passes, as jnp.maximum's
          }
          *reinterpret_cast<uint4*>(out + (out_row * width + col) * kC + v * kVec) =
              *reinterpret_cast<const uint4*>(o);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace
}  // namespace fcn8s

// x: (rows, width, 64) bf16, rows a multiple of 8; w128: (3, 128, 64) bf16;
// w64: (3, 64, 64) bf16; out: (rows, width, 64) bf16. All contiguous, 16-byte
// aligned.
extern "C" int fcn8s_conv1_core(const void* x, const void* w128, const void* w64, void* out,
                                int64_t rows, int width, void* stream) {
  using namespace fcn8s;
  if (rows <= 0 || rows % kTH || width <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv1_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (width + kStrip - 1) / kStrip;
  const int64_t items = rows / kTH * strips;
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  conv1_core_kernel<<<grid, kBlock, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w128),
      static_cast<const __nv_bfloat16*>(w64), static_cast<__nv_bfloat16*>(out), rows, width,
      strips, items);
  return static_cast<int>(cudaGetLastError());
}
