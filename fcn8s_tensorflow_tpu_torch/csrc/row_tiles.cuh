// Row tiles: the shared-memory pipeline of the CE kernels (ce_sum.cu, K1 and
// K3; ce_grad.cu).
//
// A (P, C) row-major tensor is read as a byte stream: a block takes a tile of
// `rows` whole rows (rows a multiple of 16, so a tile of bf16 or fp32 logits
// and of uint8 or int32 labels starts on a 16-byte line of a 16-byte-aligned
// tensor) and copies it into shared memory with 16-byte `cp.async.cg` copies,
// neighbouring threads on neighbouring lines. A block owns tiles blockIdx.x,
// + gridDim.x, ...; a ring of kStages stages keeps the next tiles' copies in
// flight while it computes on the current one. A thread then works on whole
// rows in shared memory, reading (and writing) them kRowBytes at a time.
//
// Alignment: an element e of a tensor g lands at smem[e - e0 + lead_of(g)],
// its position in its 16-byte line of device memory, so a tensor whose base is
// not 16-byte aligned (a view such as logits[1:]) still moves as whole lines;
// the partial first and last line of a tile (the tensor's misaligned head, its
// ragged end) are copied element by element.
#pragma once

#include "common.cuh"

namespace fcn8s {

constexpr int kStages = 3;
constexpr int kTileRowMultiple = 16;
constexpr int kMaxTileRows = 1024;  // ops/kernels.py `_CE_TILE_ROWS`

// Elements before `p` in its 16-byte line of device memory.
template <typename E>
__host__ __device__ __forceinline__ int lead_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(E));
}

// Shared memory for n staged elements: the lead and a ragged end add at most
// one 16-byte line beyond n rounded up to whole lines.
__host__ __device__ constexpr int staged_bytes(int n, int elem_size) {
  return (n * elem_size + 15) / 16 * 16 + 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying g[e0, e1) into smem (g[e] to smem[e - e0 + lead_of<E>(g)]);
// e0 is a multiple of a 16-byte line's elements. Whole lines go by cp.async
// (the caller commits the group), the partial first and last lines by plain
// loads. Every thread of the block calls it.
template <typename E>
__device__ __forceinline__ void stage_async(E* smem, const E* g, int64_t e0, int64_t e1) {
  constexpr int kLine = 16 / sizeof(E);
  const int lead = lead_of<E>(g);
  const E* base = g + (e0 - lead);  // 16-byte aligned
  const int n = static_cast<int>(e1 - e0) + lead;
  for (int k0 = threadIdx.x * kLine; k0 < n; k0 += blockDim.x * kLine) {
    if (k0 >= lead && k0 + kLine <= n) {
      cp_async16(smem + k0, base + k0);
    } else {
      for (int k = max(k0, lead); k < min(k0 + kLine, n); ++k) smem[k] = base[k];
    }
  }
}

// Store smem back to g[e0, e1), laid out as stage_async lays it out: whole
// 16-byte lines as one vector store each, the partial ones element by element.
// Every thread of the block calls it, after a barrier behind the tile's writes.
template <typename E>
__device__ __forceinline__ void store_tile(E* g, const E* smem, int64_t e0, int64_t e1) {
  constexpr int kLine = 16 / sizeof(E);
  const int lead = lead_of<E>(g);
  E* base = g + (e0 - lead);
  const int n = static_cast<int>(e1 - e0) + lead;
  for (int k0 = threadIdx.x * kLine; k0 < n; k0 += blockDim.x * kLine) {
    if (k0 >= lead && k0 + kLine <= n) {
      *reinterpret_cast<uint4*>(base + k0) = *reinterpret_cast<const uint4*>(smem + k0);
    } else {
      for (int k = max(k0, lead); k < min(k0 + kLine, n); ++k) base[k] = smem[k];
    }
  }
}

// Walk this block's tiles through the ring: issue(t, stage) starts tile t's
// copies into `stage`, consume(t, stage) runs once they have landed. Every
// thread of the block takes part; both callbacks may hold barriers.
template <typename Issue, typename Consume>
__device__ __forceinline__ void pipeline_tiles(int64_t tiles, Issue issue, Consume consume) {
  const int64_t step = gridDim.x;
  int64_t next = blockIdx.x;
  for (int s = 0; s < kStages - 1; ++s, next += step) {
    if (next < tiles) issue(next, s);
    cp_async_commit();
  }
  int stage = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += step, next += step) {
    // the stage consumed last, freed by the barrier that ended it
    if (next < tiles) issue(next, (stage + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t's group has landed, for this thread
    __syncthreads();               // ... and for every thread
    consume(t, stage);
    __syncthreads();
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();
}

// Shared-memory layout of one block: kStages stages of [logits | labels |
// weights], then an output tile of logits' size. Offsets in bytes, each a
// multiple of 16.
struct TileLayout {
  int logits, labels, weights, stage, out, total;
  __host__ __device__ TileLayout(int rows, int c, int logit_size, int label_size,
                                 int weight_bytes, bool with_out)
      : logits(staged_bytes(rows * c, logit_size)),
        labels(staged_bytes(rows, label_size)),
        weights(weight_bytes),
        stage(logits + labels + weights),
        out(with_out ? logits : 0),
        total(kStages * stage + out) {}
};

// a / b for a >= 0, b > 0: in 32 bits where both fit (a 64-bit division is
// some 70 instructions).
__device__ __forceinline__ int64_t div_rows(int64_t a, int64_t b) {
  if (((a | b) >> 32) == 0) return static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
  return a / b;
}

// The weight of a row when rows take their sample's weight mask[row / pps]:
// one read a tile where the tile lies in one sample (pps >= rows makes that
// the rule).
struct SampleWeight {
  const float* mask;
  int64_t pps, first;
  bool one;
  float w_first;
  __device__ __forceinline__ SampleWeight(const float* m, int64_t pps_, int64_t r0, int n)
      : mask(m), pps(pps_), first(div_rows(r0, pps_)) {
    one = first == div_rows(r0 + n - 1, pps_);
    w_first = mask[first];
  }
  __device__ __forceinline__ float operator()(int64_t row) const {
    return one ? w_first : mask[div_rows(row, pps)];
  }
};

// A row in shared memory, read and written kRowBytes at a time; the row's
// address and its length in bytes are multiples of kRowBytes (the launcher
// picks the widest that divides both, so a warp's accesses spread over the
// banks: at 40-byte bf16 rows, 8-byte words meet no bank conflict).
template <int kRowBytes> struct RowWord;
template <> struct RowWord<16> { using type = uint4; };
template <> struct RowWord<8> { using type = uint2; };
template <> struct RowWord<4> { using type = unsigned; };
template <> struct RowWord<2> { using type = unsigned short; };

// f(j0, v) for each word of the row, in order: v[q] = row[j0 + q] as float,
// q < kRowBytes / sizeof(T).
template <int kRowBytes, typename T, typename F>
__device__ __forceinline__ void for_each_word(const T* row, int c, F f) {
  using Word = typename RowWord<kRowBytes>::type;
  constexpr int kPer = kRowBytes / sizeof(T);
  const Word* words = reinterpret_cast<const Word*>(row);
  for (int k = 0; k < c / kPer; ++k) {
    const Word w = words[k];
    const T* e = reinterpret_cast<const T*>(&w);
    float v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) v[q] = to_float(e[q]);
    f(k * kPer, v);
  }
}

// For each word of the row: f(v, o) maps its values v[q] (as float) to o[q],
// which are stored, rounded to T, at the same place of `out`.
template <int kRowBytes, typename T, typename F>
__device__ __forceinline__ void map_words(const T* row, T* out, int c, F f) {
  using Word = typename RowWord<kRowBytes>::type;
  constexpr int kPer = kRowBytes / sizeof(T);
  Word* outs = reinterpret_cast<Word*>(out);
  for_each_word<kRowBytes>(row, c, [&](int j0, const float* v) {
    float o[kPer];
    f(v, o);
    Word w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int q = 0; q < kPer; ++q) e[q] = from_float<T>(o[q]);
    outs[j0 / kPer] = w;
  });
}

template <int kRowBytes, typename T>
__device__ __forceinline__ void zero_row(T* out, int c) {
  using Word = typename RowWord<kRowBytes>::type;
  Word* outs = reinterpret_cast<Word*>(out);
  for (int k = 0; k < c * static_cast<int>(sizeof(T)) / kRowBytes; ++k) outs[k] = Word{};
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU in one instruction (relative error ~2^-22; 0 at -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(v - m) as 2^((v - m) log2(e)): exact 1 at v = m, so softmax - 1 at a
// row's max keeps the precision that expf would give it.
__device__ __forceinline__ float exp_shifted(float v, float m) {
  return ex2((v - m) * kLog2e);
}

// The online (max-shifted) log-sum-exp of a row in fp32, a word at a time:
// returns (m, s) with m the row's max and s = sum_j exp(row[j] - m), so
// lse = m + log(s). A word rescales the running sum once, by its own max,
// so there is no branch and about one exponential per element.
template <int kRowBytes, typename T>
__device__ __forceinline__ float2 row_max_sumexp(const T* row, int c) {
  constexpr int kPer = kRowBytes / sizeof(T);
  float m = -INFINITY, s = 0.f;
  for_each_word<kRowBytes>(row, c, [&](int, const float* v) {
    float mc = m;
#pragma unroll
    for (int q = 0; q < kPer; ++q) mc = fmaxf(mc, v[q]);
    float acc = s * exp_shifted(m, mc);
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc += exp_shifted(v[q], mc);
    s = acc;
    m = mc;
  });
  return make_float2(m, s);
}

// The widest access (16, 8, 4 or 2 bytes) that divides a row's length and
// both leads (in bytes): the word a thread moves its rows by.
__host__ __forceinline__ int row_word_bytes(int row_bytes, int lead_bytes, int out_lead_bytes) {
  int w = 16;
  while (w > 2 && (row_bytes % w || lead_bytes % w || out_lead_bytes % w)) w /= 2;
  return w;
}

}  // namespace fcn8s
