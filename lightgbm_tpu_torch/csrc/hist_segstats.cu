// Segstats histogram (kernel B6): bins u8 [n, F] x pre-folded statistics
// f32 [n, Kc] -> f32 [F, B, Kc].  bf16 mode rounds each statistic to bf16
// (nearest even) and sums in f32; f32 mode sums the f32 statistics in f32.
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// hist_from_segstats_pallas (body _hist_kernel), which contracted a one-hot
// [B, chunk] tile against the [chunk, Kc] statistics on the MXU with the
// [F, B, Kc] accumulator resident in VMEM.  Its caller is every batched
// histogram: fused cross-validation folds configs x folds x segments x
// statistics into Kc channels (240 in an 8-config sweep bucket of the
// strict grower, 1,080 in a 36-config hyper-batch).
//
// What bounds it on the H100: the bytes (the n x Kc statistics are read
// once, 44 MB at 45,800 rows x 240 channels), not the n*F*Kc adds.  A
// [Kc, B] partial and its Kahan compensation do not fit one block's shared
// memory past ~20 channels, so each block owns a (row chunk, feature,
// channel group) and stages only its group's channels (hist_common.cuh);
// the price is that every channel group sorts the tile again and every
// feature re-reads the statistics, which the L2 mostly absorbs at the
// sweep's shapes.  Sums are Kahan-compensated f32 in a fixed order, so two
// launches are bit-equal.
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include "hist_common.cuh"

extern "C" {

// partial: scratch f32 [n_chunks, F, Kc, B]; out: f32 [F, B, Kc]
int hist_segstats_launch(const void* bins, int n, int F, const void* segstats,
                         int Kc, int B, int bf16, int rows_per_chunk,
                         int n_chunks, int ch_group, void* partial, void* out,
                         void* stream) {
  hist::Shape sh{n, F, Kc, 1, B, rows_per_chunk, 1, bf16, ch_group};
  return hist::launch(static_cast<const uint8_t*>(bins),
                      static_cast<const float*>(segstats), nullptr, sh,
                      n_chunks, static_cast<float*>(partial),
                      static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream), /*wide=*/true);
}

const char* hist_segstats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_segstats_tile_rows() { return hist::kTileRows; }

long long hist_segstats_smem_bytes(int B, int ch_group) {
  hist::Shape sh{0, 0, ch_group, 0, B, 0, 1, 0, ch_group};
  return (long long)hist::smem_bytes(sh);
}

}  // extern "C"
