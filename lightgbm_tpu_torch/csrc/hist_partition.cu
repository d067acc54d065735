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
// kernel serves every F.  route_kernel, one thread per row, reads the row's
// leaf, its slot and its split code once and writes the new leaf id and the
// row's segment (-1 when it adds nothing); the histogram passes of B1
// (hist_common.cuh) then run over those segments, so the chain of dependent
// loads is paid once per wave and not once per feature block.  The routing
// adds about 13 bytes per row read (row_leaf, its slot, the split code) and
// 8 written.
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include "hist_common.cuh"

namespace {

__global__ void route_kernel(const uint8_t* __restrict__ bins, int n, int F,
                             const int* __restrict__ row_leaf,
                             const int* __restrict__ slot_of_node,
                             int capacity, const int* __restrict__ feat,
                             const int* __restrict__ thr,
                             const uint8_t* __restrict__ direct_left,
                             int n_nodes, int* __restrict__ seg,
                             int* __restrict__ new_row_leaf) {
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int leaf = row_leaf[r];
    const int slot =
        (leaf >= 0 && leaf < capacity) ? __ldg(slot_of_node + leaf) : -1;
    if (slot < 0) {
      new_row_leaf[r] = leaf;
      seg[r] = -1;
      continue;
    }
    const int v = bins[r * F + __ldg(feat + slot)];
    const bool go_left = v <= __ldg(thr + slot);
    new_row_leaf[r] = n_nodes + 2 * slot + (go_left ? 0 : 1);
    seg[r] = (go_left == (__ldg(direct_left + slot) != 0)) ? slot : -1;
  }
}

}  // namespace

extern "C" {

// seg: scratch i32 [n]; partial: scratch f32 [n_chunks, F, W*3, B];
// hist_out: f32 [W, F, B, 3]; new_row_leaf: i32 [n]
int hist_partition_launch(const void* bins, int n, int F, const void* stats,
                          const void* row_leaf, const void* slot_of_node,
                          int capacity, const void* feat, const void* thr,
                          const void* direct_left, int W, int n_nodes, int B,
                          int bf16, int rows_per_chunk, int n_chunks,
                          int seg_group, void* seg, void* partial,
                          void* hist_out, void* new_row_leaf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long want = ((long long)n + threads - 1) / threads;
  const int blocks = (int)(want > 65535 ? 65535 : (want < 1 ? 1 : want));
  route_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const uint8_t*>(bins), n, F,
      static_cast<const int*>(row_leaf),
      static_cast<const int*>(slot_of_node), capacity,
      static_cast<const int*>(feat), static_cast<const int*>(thr),
      static_cast<const uint8_t*>(direct_left), n_nodes,
      static_cast<int*>(seg), static_cast<int*>(new_row_leaf));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist::Shape sh{n, F, 3, W, B, rows_per_chunk, seg_group, bf16};
  return hist::launch(static_cast<const uint8_t*>(bins),
                      static_cast<const float*>(stats),
                      static_cast<const int*>(seg), sh, n_chunks,
                      static_cast<float*>(partial),
                      static_cast<float*>(hist_out), st);
}

const char* hist_partition_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_partition_tile_rows() { return hist::kTileRows; }

long long hist_partition_smem_bytes(int B, int seg_group) {
  hist::Shape sh{0, 0, 3, 0, B, 0, seg_group, 0};
  return (long long)hist::smem_bytes(sh);
}

}  // extern "C"
