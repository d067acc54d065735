// Fused histogram (kernel B1), f32 and bf16 modes: bins u8 [n, F] x stats
// f32 [n, S] x segment i32 [n] -> f32 [K, F, B, S].  Segments outside
// [0, K) contribute nothing.  bf16 mode rounds each statistic to bf16
// (nearest even) and sums in f64; f32 mode sums the f32 statistics in f64;
// each cell is rounded to f32 once.
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// hist_fused_pallas (body _fused_kernel), which folded the segments into a
// one-hot MXU matmul over every row and, in f32 mode, approximated f32 with
// two hi/lo bf16 passes.  Here f32 is true f32, the sum order is fixed,
// and a call of K > 1 segments partitions its rows by segment first, so it
// costs in proportion to the rows of its segments (the strict grower's
// two-segment calls hold ~6 % of n on average): see hist_rows.cuh for the
// design, what bounds it and what it does about that.
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include "hist_rows.cuh"

extern "C" {

// K == 1: items of R rows in `slots` row ranges, no partition (counts,
// items, item_first, item_count, sizes and list unused).  K > 1: the
// partition's scratch (i32): counts [K, C], items int4 [slots], item_first
// and item_count [K], sizes [1], list [n]; R is the least item size and the
// scan sizes the items for `target` blocks.  partial: f64 [slots, F, B, S];
// out: f32 [K, F, B, S].
int hist_fused_launch(const void* bins, long long n, int F,
                      const void* stats, int S, const void* seg, int K,
                      int B, int bf16, int fg, int R, int slots, int target,
                      int bulk, void* counts, void* items, void* item_first,
                      void* item_count, void* sizes, void* list,
                      void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 2147483647LL || K < 1 || fg < 1) return (int)cudaErrorInvalidValue;
  const int groups = (F + fg - 1) / fg;
  hr::Shape sh{n, F, S, K, B, bf16, fg, groups, bulk && K == 1, R, slots};
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  const float* x = static_cast<const float*>(stats);
  const int* sg = static_cast<const int*>(seg);
  if (K == 1) {
    return (int)hr::histogram<hr::b1>(b, x, sg, nullptr, nullptr, nullptr, nullptr,
                              sh, static_cast<double*>(partial),
                              static_cast<float*>(out), st);
  }
  const int C = (int)((n + rowpart::kPartRows - 1) / rowpart::kPartRows);
  const rowpart::SegArray segs{sg, (int)n, K};
  const rowpart::Part part{(int)n, K, C, R, slots, target, groups,
                           hr::kTile};
  int* ls = static_cast<int*>(list);
  int4* it = static_cast<int4*>(items);
  int* first = static_cast<int*>(item_first);
  int* count = static_cast<int*>(item_count);
  cudaError_t err = rowpart::partition(segs, segs, part, 1,
                                       static_cast<int*>(counts), it, first,
                                       count, static_cast<int*>(sizes), ls,
                                       st);
  if (err != cudaSuccess) return (int)err;
  return (int)hr::histogram<hr::b1>(b, x, sg, ls, it, first, count, sh,
                            static_cast<double*>(partial),
                            static_cast<float*>(out), st);
}

const char* hist_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_fused_tile_rows() { return hr::kTile; }

int hist_fused_part_rows() { return rowpart::kPartRows; }

long long hist_fused_smem_bytes(int F, int S, int B, int fg, int bulk) {
  hr::Shape sh{0, F, S, 1, B, 0, fg, 1, bulk, 0, 1};
  return (long long)hr::smem_bytes(sh);
}

}  // extern "C"
