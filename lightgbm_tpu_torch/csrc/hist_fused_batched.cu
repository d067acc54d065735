// Batched fused histogram (kernel B5): bins u8 [n, F] shared by E elements
// x stats f32 [E, n, S] x segment i32 [E, n] -> f32 [E, K, F, B, S].
// Segments outside [0, K) contribute nothing.  bf16 mode rounds each
// statistic to bf16 (nearest even) and sums in f32; f32 mode sums the f32
// statistics in f32.
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// hist_fused_pallas_batched (body _fused_kernel over an element grid axis),
// which folded each element's segment one-hot into an MXU matmul in VMEM so
// the [n, E*K*S] segstats operand never reached HBM and, in f32 mode,
// approximated f32 with two hi/lo bf16 passes.  Its callers are the waves
// of the batched wave grower (fused cross-validation at >= 2^19 rows: the
// folds; multiclass: the classes), with K = the wave width (42 by default)
// and S = 3.  Here f32 is true f32 and the sum order is fixed.
//
// Design: hist_common.cuh's two passes with an element axis.  One block
// per (row chunk, feature, element x segment group) stages the element's
// statistics and segments for a tile of rows beside the shared bins tile
// (re-read per element, as the TPU kernel re-read its bins block: the bins
// are n*F bytes against the element's 4*n*(S + 1)), sorts the tile by bin
// and sums each (segment, bin) cell of its group in row order with Kahan
// compensation; a second pass sums the partials [E, chunks, F, K*S, B] of
// each cell in chunk order.  No float atomics: two launches are bit-equal.
// Segment groups of 14 (at S = 3, B = 256) keep a block's partial and its
// compensation within half an SM's shared memory, as for B2.
//
// What bounds it on the H100: the bytes are few (bins once, n*F; each
// element's statistics and segments once, E*n*16 bytes; the output
// E*K*F*B*S*4), so, as for B1 and B2, the per-row work of the sort and the
// walk and its latency bound it; PERF.md holds its times beside the bound.
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include "hist_common.cuh"

extern "C" {

// partial: scratch f32 [E, n_chunks, F, K*S, B]; out: f32 [E, K, F, B, S]
int hist_fused_batched_launch(const void* bins, int n, int F,
                              const void* stats, int S, const void* seg,
                              int E, int K, int B, int bf16,
                              int rows_per_chunk, int n_chunks, int seg_group,
                              void* partial, void* out, void* stream) {
  hist::Shape sh{n, F, S, K, B, rows_per_chunk, seg_group, bf16, S, E};
  return hist::launch(static_cast<const uint8_t*>(bins),
                      static_cast<const float*>(stats),
                      static_cast<const int*>(seg), sh, n_chunks,
                      static_cast<float*>(partial), static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}

const char* hist_fused_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_fused_batched_tile_rows() { return hist::kTileRows; }

long long hist_fused_batched_smem_bytes(int S, int B, int seg_group) {
  hist::Shape sh{0, 0, S, 0, B, 0, seg_group, 0, S, 1};
  return (long long)hist::smem_bytes(sh);
}

}  // extern "C"
