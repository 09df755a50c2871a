// KB: the conv1_2-core calibration kernel, on wgmma fed by TMA.
//
// Replaces the Pallas kernel `kernel2` of benchmarks/conv1_block_calibration.py
// (the same body with the halo inside the block is `kernel`). It emulates
// conv1_2's forward core as matrix products, for every output row r:
//
//   out[r] = relu( sum_{ky<3} [a || a] @ w128[ky] + a @ w64[ky] ),
//   a = x[(r + ky) mod R]   (a (W, 64) bf16 slab),
//
// bf16 products, fp32 accumulation, rounded to bf16 once after the ReLU. The
// row index wraps mod R: the TPU script fed each tile's halo from
// roll(x, -8, 0), so the last rows read rows 0 and 1.
//
// Bound: each output pixel needs 64 x 576 MACs against 256 bytes of input and
// output, ~290 FLOP per byte: the H100's bf16 ridge. So the copies have to
// overlap the products, or the floor is the sum of the two bounds. Design:
//
// * persistent blocks, one per SM, each walking work items of (a 128-pixel
//   column strip) x (a run of consecutive output rows); ops/conv1_core.py's
//   `work_split` picks the run length so that the items about fill the SMs.
//   Each input row of a strip is loaded ONCE and serves its three output rows
//   (taps 0, 1 and 2), so a run of n rows reads n + 2 input rows;
// * one producer thread (in a warpgroup of its own, which hands its registers
//   to the consumers with setmaxnreg) keeps TMA loads of input-row strips in
//   flight through a ring of kStages stages, each with a `full` and an `empty`
//   mbarrier. The 3-D
//   tensor map over (R, W, 64) and its 128-byte swizzle make one pixel's 64
//   channels one 128-byte row of the canonical K-major A tile; its box
//   zero-fills pixels past W, and the halo's wrap is the row coordinate mod R;
// * the weights are staged once per block as three B operands, one per part
//   (w128[ky][:64], w128[ky][64:], w64[ky]), each (192 x 64): the three taps
//   side by side along N, K-major and 128-byte swizzled (72 KB in all);
// * two consumer warpgroups, each on 64 pixels of the strip, issue
//   wgmma.mma_async m64n192k16 with both operands in shared memory: per input
//   row 3 parts x 4 k16 steps, all into one 96-register accumulator D whose
//   three 64-column blocks are the row's taps 0, 1 and 2. After row i, block
//   2 holds output row i - 2 complete; the blocks then shift (2 <- 1 <- 0, 0
//   <- 0), so each output row adds its three taps in the accumulator itself;
// * the epilogue applies the ReLU and rounds to bf16 in registers, and the
//   row is written to a swizzled shared tile and stored by TMA (which clips
//   past W) while the next row's products run.
//
// The weights are never pre-added (w128[:64] + w128[64:] in bf16 would round
// differently): every product is bf16 x bf16 into the fp32 accumulator; only
// the order of the fp32 sums differs from the plain twin's.
#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is looked up at run time

#include <climits>

#include "common.cuh"

namespace fcn8s {
namespace {

constexpr int kC = 64;                         // channels in and out
constexpr int kTH = 8;                         // the calibration's row tile (R is a multiple)
constexpr int kStrip = 128;                    // pixels a work item (ops/conv1_core.py STRIP)
constexpr int kConsumers = 2;                  // consumer warpgroups, 64 pixels each
constexpr int kHalf = kStrip / kConsumers;     // 64: wgmma's M
constexpr int kStages = 6;                     // input rows in flight
constexpr int kN = 3 * kC;                     // 192: the three taps side by side
constexpr uint32_t kRowBytes = kC * 2;         // 128: one pixel's channels = one swizzle row
constexpr uint32_t kTileBytes = kStrip * kRowBytes;  // 16,384: one input row of a strip
constexpr uint32_t kPartBytes = kN * kRowBytes;      // 24,576: one part's B
constexpr uint32_t kWBytes = 3 * kPartBytes;         // 73,728
constexpr uint32_t kOutBytes = kHalf * kRowBytes;    // 8,192: one warpgroup's output row
constexpr uint32_t kOutBufs = 2;
constexpr uint32_t kSmemBytes = kStages * kTileBytes + kWBytes + kConsumers * kOutBufs * kOutBytes +
                                2 * kStages * 8 + 1024;  // + the barriers, + room to align to 1 KB
constexpr int kThreadsKB = (kConsumers + 1) * 128;      // + the producer warpgroup
// setmaxnreg: 2 x 128 x 232 + 128 x 40 registers fit in the SM's 64 K
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// --- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// The spin loop lives inside the asm block, so the compiler sees no divergent
// branch around the wgmma that follows (one would make it serialise them).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this layout).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// Pin the accumulator to its registers across the asynchronous wgmma.
__device__ __forceinline__ void fence_operands(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define KB_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 192, fp32) += A (64 x 16, bf16) @ B (16 x 192, bf16), both from shared memory.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}"
      : KB_F8(0), KB_F8(8), KB_F8(16), KB_F8(24), KB_F8(32), KB_F8(40), KB_F8(48), KB_F8(56),
        KB_F8(64), KB_F8(72), KB_F8(80), KB_F8(88)
      : "l"(a), "l"(b), "r"(1));
}

#undef KB_F8

// --- the kernel -------------------------------------------------------------

// One finished output row of a warpgroup (64 pixels x 64 channels, bf16 pairs
// in the accumulator's fragment order) to shared memory, then to device
// memory by TMA. Thread 0 of the warpgroup owns the bulk stores, so it waits
// until the store that last read this buffer is done with it.
__device__ __forceinline__ void store_row(const uint32_t (&packed)[16], uint32_t buf_addr,
                                          const CUtensorMap* out_map, int px, int row, int wg,
                                          int t) {
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kOutBufs - 1) : "memory");
  named_barrier(1 + wg);
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int v2 = 0; v2 < 8; ++v2)
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) {
      // pixel m, channels 8 * v2 + 2 * (lane % 4) + {0, 1}
      const int m = 16 * warp + lane / 4 + 8 * v1;
      const uint32_t addr = buf_addr + m * kRowBytes + ((v2 ^ (m & 7)) << 4) + (lane & 3) * 4;
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(packed[2 * v2 + v1]) : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA unit
  named_barrier(1 + wg);
  if (t == 0) tma_store(out_map, buf_addr, 0, px, row);
}

__global__ void __launch_bounds__(kThreadsKB, 1)
conv1_core_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap out_map,
                  const __nv_bfloat16* __restrict__ w128, const __nv_bfloat16* __restrict__ w64,
                  int rows, int width, int run_rows, int strips, int items) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every tile to that
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t tiles = base;                                     // [kStages][kStrip][128 B]
  const uint32_t wsm = tiles + kStages * kTileBytes;               // [3 parts][192][128 B]
  const uint32_t outs = wsm + kWBytes;                             // [2][kOutBufs][64][128 B]
  const uint32_t full = outs + kConsumers * kOutBufs * kOutBytes;  // kStages mbarriers
  const uint32_t empty = full + kStages * 8;                       // kStages mbarriers
  const int tid = threadIdx.x;

  // the weights, once per block: row n' = ky * 64 + n, column k of part q is
  // w128[ky][q * 64 + k][n] (q < 2) or w64[ky][k][n] (q = 2), 16-byte chunks
  // swizzled as the TMA unit swizzles a tile
  unsigned char* wp = smem_raw + (wsm - raw);
  for (int i = tid; i < 3 * 3 * kC * kC; i += kThreadsKB) {
    const int n = i % kC, k = (i / kC) % kC, ky = (i / (kC * kC)) % 3, q = i / (3 * kC * kC);
    const __nv_bfloat16 v = q < 2 ? w128[(ky * 2 * kC + q * kC + k) * kC + n]
                                  : w64[(ky * kC + k) * kC + n];
    const int row = ky * kC + n;
    *reinterpret_cast<__nv_bfloat16*>(wp + q * kPartBytes + row * kRowBytes +
                                      (((k >> 3) ^ (row & 7)) << 4) + (k & 7) * 2) = v;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty + 8 * s, kConsumers * 128);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the weights, for wgmma
  __syncthreads();

  // warpgroup index, broadcast so the compiler knows it is uniform in a warp
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers) {
    // the producer: one thread walks the same items and rows as the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers * 128) {
      int s = 0;
      uint32_t ph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int w0 = (item % strips) * kStrip, r0 = (item / strips) * run_rows;
        const int n_in = min(run_rows, rows - r0) + 2;
        int r = r0;
        for (int j = 0; j < n_in; ++j) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, kTileBytes);
          tma_load(tiles + s * kTileBytes, &x_map, full + 8 * s, 0, w0, r);
          r = r + 1 == rows ? 0 : r + 1;  // the halo wraps mod R
          if (++s == kStages) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int t = tid % 128;
    const uint32_t a_off = wg * kHalf * kRowBytes;  // this warpgroup's 64 pixels of a tile
    const uint64_t b0 = sw128_desc(wsm), b1 = sw128_desc(wsm + kPartBytes),
                   b2 = sw128_desc(wsm + 2 * kPartBytes);
    float d[96];
    uint32_t packed[16];
    bool pending = false;
    int pend_px = 0, pend_row = 0;
    uint32_t buf = 0;
    int s = 0;
    uint32_t ph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int w0 = (item % strips) * kStrip, r0 = (item / strips) * run_rows;
      const int n_in = min(run_rows, rows - r0) + 2;
      const int px = w0 + wg * kHalf;
#pragma unroll
      for (int i = 0; i < 96; ++i) d[i] = 0.f;
      for (int j = 0; j < n_in; ++j) {
        mbar_wait(full + 8 * s, ph);
        const uint64_t a = sw128_desc(tiles + s * kTileBytes + a_off);
        fence_operands(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // a k16 step is 32 bytes further into the swizzled rows
          wgmma_m64n192k16(d, a + 2 * kk, b0 + 2 * kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n192k16(d, a + 2 * kk, b1 + 2 * kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n192k16(d, a + 2 * kk, b2 + 2 * kk);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (pending) {  // the previous row's store overlaps these products
          store_row(packed, outs + (wg * kOutBufs + buf) * kOutBytes, &out_map, pend_px, pend_row,
                    wg, t);
          buf ^= 1;
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_operands(d);
        mbar_arrive(empty + 8 * s);
        if (++s == kStages) { s = 0; ph ^= 1; }
        // block 2 is output row r0 + j - 2, complete from j = 2 on; packed on
        // every row, so that no accumulator is read on a branch
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float lo = d[64 + 2 * i], hi = d[64 + 2 * i + 1];
          // relu; a NaN passes, as jnp.maximum's does
          const __nv_bfloat162 v = __floats2bfloat162_rn(lo < 0.f ? 0.f : lo, hi < 0.f ? 0.f : hi);
          packed[i] = *reinterpret_cast<const uint32_t*>(&v);
        }
        pending = j >= 2 && px < width;  // a half strip wholly past W stores nothing
        pend_px = px;
        pend_row = r0 + j - 2;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          d[64 + i] = d[32 + i];
          d[32 + i] = d[i];
          d[i] = 0.f;
        }
      }
    }
    if (pending)
      store_row(packed, outs + (wg * kOutBufs + buf) * kOutBytes, &out_map, pend_px, pend_row, wg,
                t);
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// --- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime already loaded: no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over an (R, W, 64) bf16 tensor with boxes of (1 row, `pixels`, 64).
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int64_t rows, int width,
            uint32_t pixels, CUtensorMapL2promotion l2) {
  const cuuint64_t dims[3] = {kC, static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {kRowBytes, static_cast<cuuint64_t>(width) * kRowBytes};
  const cuuint32_t box[3] = {kC, pixels, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace fcn8s

// x: (rows, width, 64) bf16, rows a multiple of 8; w128: (3, 128, 64) bf16;
// w64: (3, 64, 64) bf16; out: (rows, width, 64) bf16. All contiguous, 16-byte
// aligned. Work items are (128-pixel strip) x (run of `run_rows` output
// rows), item = run * strips + strip, walked by `grid` persistent blocks.
extern "C" int fcn8s_conv1_core(const void* x, const void* w128, const void* w64, void* out,
                                int64_t rows, int width, int64_t run_rows, int grid,
                                void* stream) {
  using namespace fcn8s;
  if (rows <= 0 || rows % kTH || rows > INT_MAX || width <= 0 || run_rows <= 0 || grid <= 0)
    return cudaErrorInvalidValue;
  const int64_t strips = (width + kStrip - 1) / kStrip, runs = (rows + run_rows - 1) / run_rows;
  if (strips * runs > INT_MAX) return cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, out_map;
  if (!encode(enc, &x_map, x, rows, width, kStrip, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode(enc, &out_map, out, rows, width, kHalf, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv1_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv1_core_kernel<<<grid, kThreadsKB, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, out_map, static_cast<const __nv_bfloat16*>(w128),
      static_cast<const __nv_bfloat16*>(w64), static_cast<int>(rows), width,
      static_cast<int>(run_rows), static_cast<int>(strips), static_cast<int>(strips * runs));
  return static_cast<int>(cudaGetLastError());
}
