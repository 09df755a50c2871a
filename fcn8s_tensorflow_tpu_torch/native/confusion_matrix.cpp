// Host-side confusion-matrix kernel for offline benchmark evaluation.
// The port's copy of fcn8s_tensorflow_tpu/native/confusion_matrix.cpp.
//
// Native equivalent of the reference's Cython extension
// (cityscapesscripts/evaluation/addToConfusionMatrix_impl.c:3-17):
// accumulate conf[gt*dim + pred] += 1 over a prediction/GT uint8 image pair.
// Improvements over the reference kernel:
//   * multi-threaded variant with per-thread local matrices reduced at the
//     end (the Cython kernel is single-threaded);
//   * fused label validation (the reference's Python fallback checks labels
//     pixel-by-pixel in Python when the C path is unavailable);
//   * uint64 counters throughout (safe for arbitrarily many 2MP images).
//
// Built with g++ as a plain shared library at first use, and bound from
// Python via ctypes, by evaluation/confmat.py. No Python.h dependency, so it
// compiles anywhere g++ exists.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Single-threaded linear pass.
void confusion_matrix_u8(const uint8_t* gt, const uint8_t* pred, uint64_t n,
                         uint32_t dim, uint64_t* conf) {
  for (uint64_t i = 0; i < n; ++i) {
    conf[static_cast<uint64_t>(gt[i]) * dim + pred[i]] += 1;
  }
}

// Multi-threaded: per-thread local matrices, reduced at the end. Worth it
// for whole-dataset evaluation (500 val images x 2MP); the matrices are
// small (dim<=256 -> 512KB u64) so the reduction is negligible.
void confusion_matrix_u8_mt(const uint8_t* gt, const uint8_t* pred, uint64_t n,
                            uint32_t dim, uint64_t* conf, int32_t n_threads) {
  if (n_threads <= 1 || n < (1u << 20)) {
    confusion_matrix_u8(gt, pred, n, dim, conf);
    return;
  }
  const uint64_t cells = static_cast<uint64_t>(dim) * dim;
  std::vector<std::vector<uint64_t>> locals(
      n_threads, std::vector<uint64_t>(cells, 0));
  std::vector<std::thread> threads;
  const uint64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const uint64_t lo = static_cast<uint64_t>(t) * chunk;
    const uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi, t]() {
      uint64_t* local = locals[t].data();
      for (uint64_t i = lo; i < hi; ++i) {
        local[static_cast<uint64_t>(gt[i]) * dim + pred[i]] += 1;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (auto& local : locals) {
    for (uint64_t c = 0; c < cells; ++c) conf[c] += local[c];
  }
}

// Returns the index of the first ground-truth pixel whose label is not
// marked valid in the 256-entry LUT, or -1 if all labels are known
// (the reference's per-pixel "Unknown label" check,
// evalPixelLevelSemanticLabeling.py:588-590, hoisted out of Python).
int64_t validate_labels_u8(const uint8_t* gt, uint64_t n,
                           const uint8_t* valid_lut) {
  for (uint64_t i = 0; i < n; ++i) {
    if (!valid_lut[gt[i]]) return static_cast<int64_t>(i);
  }
  return -1;
}

// Instance-weighted tp/fn accumulation for one instance mask
// (reference evalPixelLevelSemanticLabeling.py:595-625, the per-instance
// hot loop): counts pixels where inst == inst_id and pred == label_id.
void instance_tp_size_u8(const uint8_t* pred, const int32_t* inst, uint64_t n,
                         int32_t inst_id, uint8_t label_id, uint64_t* out_tp,
                         uint64_t* out_size) {
  uint64_t tp = 0, size = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (inst[i] == inst_id) {
      ++size;
      if (pred[i] == label_id) ++tp;
    }
  }
  *out_tp = tp;
  *out_size = size;
}

}  // extern "C"
