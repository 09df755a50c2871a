// K5: streaming confusion matrix, accumulated in place.
//
// Replaces the Pallas kernel `_confmat_kernel` (fcn8s_tensorflow_tpu/ops/
// pallas_kernels.py, via `confusion_matrix_pallas`), which built one-hot
// chunks in VMEM and counted them with MXU dots. On the card the same counts
// are a 2-D histogram: conf[gt, pred] += 1 for every pixel whose ids lie in
// [0, C) and whose sample's mask entry is not 0.
//
// Bound: bytes. Each live pixel reads its two ids (5 bytes with uint8 labels
// and int32 predictions) and adds one to a bin. What stands in the way is the
// adds: eval ids are spatially coherent and mostly pred == gt, so a warp's
// neighbouring pixels hit one bin, and one shared atomic per pixel becomes a
// 32-way serialised add. Design:
//
// * each thread takes 16 consecutive pixels at a time: one 16-byte load of
//   uint8 ids or four of int32 ids per stream. A head that leaves a stream
//   unaligned (a `labels[1:]` view) goes element by element; so does a stream
//   that cannot be aligned together with the other one;
// * the mask is read once per 16 pixels when they lie in one sample, and a
//   masked-out sample's ids are not read at all;
// * a thread adds up runs of equal bins in a register and issues one atomic a
//   run: on coherent ids that removes nearly all of them. The atomics go to
//   per-warp copies of the bins in shared memory (as many as fit in 48 KB),
//   so random ids collide only inside a warp; above that size they go to the
//   global matrix directly;
// * one 1024-thread block per SM (at most), so the final flush of the copies
//   is at most SMs x C^2 global adds of non-zero bins.
//
// Integer counts: the order of the atomics does not change the result.
#include "common.cuh"

namespace fcn8s {
namespace {

constexpr int kConfThreads = 1024;
constexpr int kConfWarps = kConfThreads / 32;
constexpr int kVec = 16;                    // pixels a thread takes at a time
constexpr int kBinBytes = 48 * 1024;        // shared memory for the bin copies

template <typename T>
__device__ __forceinline__ void load16(const T* p, bool vec, int (&v)[kVec]);

template <>
__device__ __forceinline__ void load16<uint8_t>(const uint8_t* p, bool vec, int (&v)[kVec]) {
  if (vec) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = (w[k / 4] >> (8 * (k % 4))) & 0xFFu;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = p[k];
  }
}

template <>
__device__ __forceinline__ void load16<int32_t>(const int32_t* p, bool vec, int (&v)[kVec]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < kVec / 4; ++k) {
      const int4 u = __ldcs(reinterpret_cast<const int4*>(p) + k);
      v[4 * k] = u.x, v[4 * k + 1] = u.y, v[4 * k + 2] = u.z, v[4 * k + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = p[k];
  }
}

// conf[g, q]'s index, or -1 for an id outside [0, c)
__device__ __forceinline__ int bin_of(int g, int q, int c) {
  return static_cast<unsigned>(g) < static_cast<unsigned>(c) &&
                 static_cast<unsigned>(q) < static_cast<unsigned>(c)
             ? g * c + q
             : -1;
}

// A thread's run of equal bins, added to `bins` once per run.
struct Run {
  int bin = -1, n = 0;
  __device__ __forceinline__ void add(int b, int* bins) {
    if (b == bin) {
      ++n;
    } else {
      if (n) atomicAdd(bins + bin, n);
      bin = b;
      n = 1;
    }
  }
  __device__ __forceinline__ void flush(int* bins) {
    if (n) atomicAdd(bins + bin, n);
  }
};

template <typename TP, typename TG, bool kShared>
__global__ void __launch_bounds__(kConfThreads)
confmat_kernel(const TP* __restrict__ pred, const TG* __restrict__ gt,
               const float* __restrict__ mask, int* __restrict__ conf, int64_t p, int c,
               int64_t pps, int64_t head, int copies, bool vec_pred, bool vec_gt) {
  __shared__ int shared_bins[kBinBytes / sizeof(int)];
  const int cc = c * c, tid = threadIdx.x;
  int* bins = conf;
  if (kShared) {
    for (int k = tid; k < copies * cc; k += kConfThreads) shared_bins[k] = 0;
    __syncthreads();
    bins = shared_bins + (tid / 32 % copies) * cc;
  }
  Run run;
  const int64_t nvec = (p - head) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kConfThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kConfThreads + tid; v < nvec; v += stride) {
    const int64_t i0 = head + v * kVec;
    const int64_t s0 = i0 / pps, s1 = (i0 + kVec - 1) / pps;
    const bool one_sample = s0 == s1;
    if (one_sample && mask[s0] == 0.f) continue;  // a masked-out sample: nothing to read
    int g[kVec], q[kVec];
    load16(gt + i0, vec_gt, g);
    load16(pred + i0, vec_pred, q);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int b = bin_of(g[k], q[k], c);
      if (b >= 0 && (one_sample || mask[(i0 + k) / pps] != 0.f)) run.add(b, bins);
    }
  }
  if (blockIdx.x == 0) {  // the unaligned head and the tail: fewer than 16 pixels each
    const int64_t tail0 = head + nvec * kVec;
    const int64_t i = tid < kVec ? tid : tail0 + tid - kVec;
    if ((tid < kVec && i < head) || (tid >= kVec && tid < 2 * kVec && i < p)) {
      const int b = bin_of(static_cast<int>(gt[i]), static_cast<int>(pred[i]), c);
      if (b >= 0 && mask[i / pps] != 0.f) run.add(b, bins);
    }
  }
  run.flush(bins);
  if (kShared) {
    __syncthreads();
    for (int k = tid; k < cc; k += kConfThreads) {
      int sum = 0;
      for (int j = 0; j < copies; ++j) sum += shared_bins[j * cc + k];
      if (sum) atomicAdd(conf + k, sum);
    }
  }
}

bool aligned16(const void* ptr, int64_t offset_bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) + offset_bytes) % 16 == 0;
}

template <typename TP, typename TG>
int launch(const void* pred, const void* gt, const float* mask, int* conf, int64_t p, int c,
           int64_t pps, cudaStream_t stream) {
  // the head: the fewest pixels after which both streams sit on 16-byte lines;
  // where none exists, the head aligns the predictions and the labels go
  // element by element
  int64_t head = -1;
  for (int64_t h = 0; h < kVec && head < 0; ++h)
    if (aligned16(pred, h * sizeof(TP)) && aligned16(gt, h * sizeof(TG))) head = h;
  const bool both = head >= 0;
  for (int64_t h = 0; h < kVec && head < 0; ++h)
    if (aligned16(pred, h * sizeof(TP))) head = h;
  if (head < 0) head = 0;
  const bool vec_pred = aligned16(pred, head * sizeof(TP));
  const bool vec_gt = both || aligned16(gt, head * sizeof(TG));
  head = head < p ? head : p;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nvec = (p - head) / kVec;
  const int64_t want = (nvec + kConfThreads - 1) / kConfThreads;
  const unsigned grid = static_cast<unsigned>(want < 1 ? 1 : want < sms ? want : sms);
  const int64_t fit = kBinBytes / (static_cast<int64_t>(c) * c * sizeof(int));
  const int copies = static_cast<int>(fit < kConfWarps ? fit : kConfWarps);
  const TP* pr = static_cast<const TP*>(pred);
  const TG* gr = static_cast<const TG*>(gt);
  if (copies > 0)
    confmat_kernel<TP, TG, true><<<grid, kConfThreads, 0, stream>>>(
        pr, gr, mask, conf, p, c, pps, head, copies, vec_pred, vec_gt);
  else
    confmat_kernel<TP, TG, false><<<grid, kConfThreads, 0, stream>>>(
        pr, gr, mask, conf, p, c, pps, head, 0, vec_pred, vec_gt);
  return static_cast<int>(cudaGetLastError());
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
    return launch<int32_t, uint8_t>(pred, gt, m, cf, p, c, pps, s);
  if (pred_dtype == kInt32 && gt_dtype == kInt32)
    return launch<int32_t, int32_t>(pred, gt, m, cf, p, c, pps, s);
  if (pred_dtype == kUInt8 && gt_dtype == kUInt8)
    return launch<uint8_t, uint8_t>(pred, gt, m, cf, p, c, pps, s);
  if (pred_dtype == kUInt8 && gt_dtype == kInt32)
    return launch<uint8_t, int32_t>(pred, gt, m, cf, p, c, pps, s);
  return cudaErrorInvalidValue;
}
