// One wave of the wave grower (kernel B2): route every row of the W
// splitting leaves to its child and histogram the rows that went to their
// split's smaller ("direct") child, by wave rank.
//
// For row r with leaf = row_leaf[r] and slot = slot_of_node[leaf] (the wave
// rank, -1 when the leaf does not split):
//   go_left = bins[r, feat[slot]] <= thr[slot]
//   new_row_leaf[r] = n_nodes + 2*slot + (go_left ? 0 : 1)   (leaf if -1)
//   the row adds to segment `slot` iff go_left == direct_left[slot].
// Output: direct_hist f32 [W, F, B, 3] and new_row_leaf i32 [n].
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// hist_partition_fused_pallas (bodies _fused_part_kernel and
// _fused_part_kernel_mb).  The TPU's single- and multi-block variants, the
// per-row [8, n] one-hot field lookup, the transposed operands and the
// bf16-exactness gate max(F, 2W, B) <= 256 were TPU workarounds: here one
// kernel serves every F.  The routing is the partition's count pass
// (row_partition.cuh): a warp routes 1,024 consecutive rows, reading each
// row's leaf, its slot and its split code once, writes the new leaf id and
// the row's segment (-1 when it adds nothing) and counts the direct rows
// per slot, so the wave's direct rows are partitioned without a further
// pass over n; the scan and the scatter follow, then B1's histogram passes
// over the direct rows alone (hist_rows.cuh, which says what bounds them
// and what the design does about it).  The routing adds 13 bytes per row
// read (row_leaf, its slot, the split code) and 8 written.
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include "hist_rows.cuh"

namespace b2 {

// the count pass's segment of row r: routes it on the way
struct Route {
  const uint8_t* bins;
  int F;
  const int* row_leaf;
  const int* slot_of_node;
  int capacity;
  const int* feat;
  const int* thr;
  const uint8_t* direct_left;
  int n_nodes;
  int* seg;
  int* new_row_leaf;

  struct Row {
    int k;       // the row's segment, -1 when it adds nothing
    int leaf;    // its new leaf
  };

  __device__ __forceinline__ Row load(int, int r) const {
    const int leaf = row_leaf[r];
    const int slot =
        (leaf >= 0 && leaf < capacity) ? __ldg(slot_of_node + leaf) : -1;
    if (slot < 0) return Row{-1, leaf};
    const int v = bins[(long long)r * F + __ldg(feat + slot)];
    const bool go_left = v <= __ldg(thr + slot);
    const int k = (go_left == (__ldg(direct_left + slot) != 0)) ? slot : -1;
    return Row{k, n_nodes + 2 * slot + (go_left ? 0 : 1)};
  }
  __device__ __forceinline__ static int segment(const Row& v) { return v.k; }
  __device__ __forceinline__ void store(int, int r, const Row& v) const {
    new_row_leaf[r] = v.leaf;
    seg[r] = v.k;
  }
};

// the scatter's segment of row r: the route's
struct Routed : rowpart::SegArray {};

}  // namespace b2

extern "C" {

// Scratch (i32): seg [n], counts [W, C], items int4 [slots], item_first and
// item_count [W], sizes [1], list [n]; partial f64 [slots, F, B, 3].
// hist_out: f32 [W, F, B, 3]; new_row_leaf: i32 [n].  R is the least item
// size; the scan sizes the items for `target` blocks.
int hist_partition_launch(const void* bins, int n, int F, const void* stats,
                          const void* row_leaf, const void* slot_of_node,
                          int capacity, const void* feat, const void* thr,
                          const void* direct_left, int W, int n_nodes, int B,
                          int bf16, int fg, int R, int slots, int target,
                          void* seg, void* counts, void* items,
                          void* item_first, void* item_count, void* sizes,
                          void* list, void* partial, void* hist_out,
                          void* new_row_leaf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W < 1 || fg < 1) return (int)cudaErrorInvalidValue;
  const int groups = (F + fg - 1) / fg;
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  int* sg = static_cast<int*>(seg);
  const b2::Route route{b, F, static_cast<const int*>(row_leaf),
                    static_cast<const int*>(slot_of_node), capacity,
                    static_cast<const int*>(feat),
                    static_cast<const int*>(thr),
                    static_cast<const uint8_t*>(direct_left), n_nodes, sg,
                    static_cast<int*>(new_row_leaf)};
  const int C = (n + rowpart::kPartRows - 1) / rowpart::kPartRows;
  const rowpart::Part part{n, W, C, R, slots, target, groups, hr::kTile};
  int* ls = static_cast<int*>(list);
  int4* it = static_cast<int4*>(items);
  int* first = static_cast<int*>(item_first);
  int* count = static_cast<int*>(item_count);
  cudaError_t err = rowpart::partition(
      route, b2::Routed{{sg, n, W}}, part, 1, static_cast<int*>(counts),
      it, first, count, static_cast<int*>(sizes), ls, st);
  if (err != cudaSuccess) return (int)err;
  const hr::Shape sh{n, F, 3, W, B, bf16, fg, groups, 0, R, slots};
  return (int)hr::histogram<hr::b2>(b, static_cast<const float*>(stats), sg, ls, it,
                            first, count, sh, static_cast<double*>(partial),
                            static_cast<float*>(hist_out), st);
}

const char* hist_partition_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_partition_tile_rows() { return hr::kTile; }

}  // extern "C"
