// Fused histogram (kernel B1): bins u8 [n, F] x stats f32 [n, S] x segment
// i32 [n] -> f32 [K, F, B, S].  Segments outside [0, K) contribute nothing.
// bf16 mode rounds each statistic to bf16 (nearest even) and sums in f32;
// f32 mode sums the f32 statistics in f32.
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// hist_fused_pallas (body _fused_kernel), which folded the segments into a
// one-hot MXU matmul and, in f32 mode, approximated f32 with two hi/lo bf16
// passes.  Here f32 is true f32 and the sum order is fixed (see
// hist_common.cuh for the design, what bounds it and what it does about it).
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include "hist_common.cuh"

extern "C" {

// partial: scratch f32 [n_chunks, F, K*S, B]; out: f32 [K, F, B, S]
int hist_fused_launch(const void* bins, int n, int F, const void* stats,
                      int S, const void* seg, int K, int B, int bf16,
                      int rows_per_chunk, int n_chunks, int seg_group,
                      void* partial, void* out, void* stream) {
  hist::Shape sh{n, F, S, K, B, rows_per_chunk, seg_group, bf16};
  return hist::launch(static_cast<const uint8_t*>(bins),
                      static_cast<const float*>(stats),
                      static_cast<const int*>(seg), sh, n_chunks,
                      static_cast<float*>(partial), static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}

const char* hist_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_fused_tile_rows() { return hist::kTileRows; }

long long hist_fused_smem_bytes(int S, int B, int seg_group) {
  hist::Shape sh{0, 0, S, 0, B, 0, seg_group, 0};
  return (long long)hist::smem_bytes(sh);
}

}  // extern "C"
