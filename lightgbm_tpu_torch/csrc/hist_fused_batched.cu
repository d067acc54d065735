// Batched fused histogram (kernel B5): bins u8 [n, F] shared by E elements
// x stats f32 [E, n, S] x segment i32 [E, n] -> f32 [E, K, F, B, S].
// Segments outside [0, K) contribute nothing.  bf16 mode rounds each
// statistic to bf16 (nearest even) and sums in f64; f32 mode sums the f32
// statistics in f64.  Each output cell is rounded to f32 once.
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// hist_fused_pallas_batched (body _fused_kernel over an element grid axis),
// which folded each element's segment one-hot into an MXU matmul in VMEM so
// the [n, E*K*S] segstats operand never reached HBM.  Its callers are the
// waves of the batched wave grower (fused cross-validation at >= 2^19 rows:
// the folds; multiclass: the classes), with K = the wave width (42 by
// default) and S = 3.
//
// Design: the rows are partitioned by segment first, as LightGBM's own GPU
// learner keeps rows by leaf, so that each row is read once per (element,
// feature group) and no tile is sorted.
//
//   1. partition (row_partition.cuh, shared with B1 and B2): a stable
//      counting sort of each element's rows by segment into work items of
//      at most R positions.  Out-of-range rows are dropped here.
//   2. gather: each element's direct rows, in partition order, as
//      feature-major codes [E, F, n] and mode-rounded statistics [E, n, S],
//      so that the histogram pass reads contiguous bytes.
//   3. histogram: a block owns one item (element, segment, positions
//      [p0, p1)) and a feature group, a warp per feature.  It stages a tile
//      of the item's statistics in shared memory and accumulates into an
//      f64 [F_g, B, S] histogram there: a warp loads its feature's codes of
//      32 positions at a time (several loads ahead), __match_any_sync
//      groups equal codes and the group's leader adds the group's values,
//      in lane order, into its cell.  Every cell's adds run in a fixed
//      order, with no float atomics, so two launches are bit-equal.  The
//      item's histogram goes to an f64 partial.
//   4. reduce: each output cell sums, in item order, the partials of its
//      segment's items and rounds once to f32.  f64 sums of the ~10^6
//      values of a cell stay far inside 1e-6 * sum|x|, and are exact on
//      dyadic statistics.
//
// What bounds it on the H100: the bytes are few (the direct rows' codes
// and statistics gathered once and read once per feature group, the
// segments twice, the f64 partials of the items), so the shared-memory
// adds and their latency bound it.  Feature groups of up to 8 (a warp
// each) keep a block's f64 histogram small enough for four blocks per SM.

// Plain C interface, bound with ctypes by kernels/histogram.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_partition.cuh"

namespace b5 {

constexpr int kThreads = 256;           // gather and histogram blocks
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;              // positions staged per tile
constexpr int kNoCode = 0x100;          // code of a lane past the tile
constexpr int kAhead = 4;               // code loads a warp keeps in flight

// f32 -> bf16 -> f32, round to nearest even (torch's and XLA's rounding;
// a NaN becomes the positive quiet NaN)
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) {
    return (u & 0x007fffffu) ? __uint_as_float(0x7fc00000u) : x;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

struct Shape {
  int n;       // rows
  int F;       // features
  int S;       // statistics per row
  int K;       // segments
  int B;       // bins
  int bf16;    // 1: round each statistic to bf16 first
  int R;       // positions per work item
  int cap;     // work-item slots per element
  int fg;      // features per block (feature group)
  int C;       // partition chunks of rowpart::kPartRows rows
};

// dynamic shared memory of a histogram block: the f64 histogram [fg, B, S]
// and the tile's statistics [kTile, S]
__host__ __device__ inline size_t hist_smem_bytes(int S, int B, int fg) {
  return sizeof(double) * (size_t)fg * B * S +
         sizeof(float) * (size_t)kTile * S;
}

// codes [E, F, n] (feature-major) and statistics [E, n, S] (mode-rounded)
// of each element's direct rows in partition order; a thread a position
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint8_t* __restrict__ bins,
              const float* __restrict__ stats, const int* __restrict__ order,
              const int* __restrict__ sizes, Shape sh,
              uint8_t* __restrict__ codes, float* __restrict__ sorted) {
  const int e = blockIdx.y, p0 = blockIdx.x * kThreads;
  const int m = sizes[e];
  if (p0 >= m) return;
  __shared__ int s_row[kThreads];
  const int F = sh.F, S = sh.S, tid = threadIdx.x;
  const int rows = min(kThreads, m - p0);
  if (tid < rows) {
    const int r = order[(size_t)e * sh.n + p0 + tid];
    s_row[tid] = r;
    const uint8_t* src = bins + (size_t)r * F;
    uint8_t* cd = codes + (size_t)e * F * sh.n + p0 + tid;
    for (int f = 0; f < F; ++f) cd[(size_t)f * sh.n] = src[f];
  }
  __syncthreads();
  const float* st = stats + (size_t)e * sh.n * S;
  float* dst = sorted + ((size_t)e * sh.n + p0) * S;
  for (int i = tid; i < rows * S; i += kThreads) {
    const int p = i / S, c = i - p * S;
    const float v = st[(size_t)s_row[p] * S + c];
    dst[i] = sh.bf16 ? round_bf16(v) : v;
  }
}

// partial [E * cap, F, B, S] (f64): the histogram of one item's rows over
// one feature group
__global__ void __launch_bounds__(kThreads)
hist_item_kernel(const uint8_t* __restrict__ codes,
                 const float* __restrict__ sorted,
                 const int4* __restrict__ items, Shape sh,
                 double* __restrict__ partial) {
  const int4 it = items[blockIdx.x];
  if (it.x < 0) return;                            // an unused slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = sh.S, B = sh.B, F = sh.F;
  const int e = blockIdx.x / sh.cap;
  const int f0 = blockIdx.y * sh.fg, fg = min(sh.fg, F - f0);
  double* hist = reinterpret_cast<double*>(smem_raw);      // [fg, B, S]
  float* s_stat = reinterpret_cast<float*>(hist + (size_t)sh.fg * B * S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cells = fg * B * S;
  for (int i = tid; i < cells; i += kThreads) hist[i] = 0.0;
  const float* st = sorted + (size_t)e * sh.n * S;
  for (int t0 = it.y; t0 < it.z; t0 += kTile) {
    const int rows = min(kTile, it.z - t0);
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < rows * S; i += kThreads) {
      s_stat[i] = st[(size_t)t0 * S + i];
    }
    __syncthreads();
    // a warp per feature: equal codes of 32 positions sum in lane order
    // and their leader alone adds the sum into the cell
    for (int j = warp; j < fg; j += kWarps) {
      const uint8_t* cj = codes + ((size_t)e * F + f0 + j) * sh.n + t0;
      double* hj = hist + (size_t)j * B * S;
      for (int g0 = 0; g0 < rows; g0 += 32 * kAhead) {
        int code[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int r = g0 + u * 32 + lane;
          code[u] = r < rows ? (int)cj[r] : kNoCode;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int g = g0 + u * 32;
          // past the tile every lane holds kNoCode: one group, no adds
          const unsigned peers = __match_any_sync(0xffffffffu, code[u]);
          if (code[u] < B && lane == __ffs(peers) - 1) {
            for (int c = 0; c < S; ++c) {
              double sum = 0.0;
              for (unsigned m = peers; m; m &= m - 1) {
                sum += (double)s_stat[(g + __ffs(m) - 1) * S + c];
              }
              hj[code[u] * S + c] += sum;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  double* dst = partial + ((size_t)blockIdx.x * F + f0) * B * S;
  for (int i = tid; i < cells; i += kThreads) dst[i] = hist[i];
}

// out [E, K, F, B, S]: each cell sums its segment's items in item order
__global__ void reduce_kernel(const double* __restrict__ partial,
                              const int* __restrict__ item_first,
                              const int* __restrict__ item_count, Shape sh,
                              int EK, float* __restrict__ out) {
  const size_t fbs = (size_t)sh.F * sh.B * sh.S;
  for (int ek = blockIdx.y; ek < EK; ek += gridDim.y) {
    const int first = item_first[ek], count = item_count[ek];
    for (size_t cell = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
         cell < fbs; cell += (size_t)gridDim.x * blockDim.x) {
      double sum = 0.0;
      for (int j = 0; j < count; ++j) {
        sum += partial[(size_t)(first + j) * fbs + cell];
      }
      out[(size_t)ek * fbs + cell] = (float)sum;
    }
  }
}

}  // namespace b5

extern "C" {

// Scratch (int32 unless named): counts [E, K, C]; order [E, n]; items
// int4 [E * cap]; item_first, item_count [E, K]; sizes [E]; codes u8
// [E, F, n]; sorted f32 [E, n, S]; partial f64 [E * cap, F, B, S].
// out: f32 [E, K, F, B, S].
int hist_fused_batched_launch(const void* bins, int n, int F,
                              const void* stats, int S, const void* seg,
                              int E, int K, int B, int bf16, int R, int cap,
                              int fg, int C, void* counts, void* order,
                              void* items, void* item_first, void* item_count,
                              void* sizes, void* codes, void* sorted,
                              void* partial, void* out, void* stream) {
  using namespace b5;
  Shape sh{n, F, S, K, B, bf16, R, cap, fg, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  if (E > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t hsmem = hist_smem_bytes(S, B, fg);
  cudaError_t err = cudaFuncSetAttribute(
      hist_item_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)hsmem);
  if (err != cudaSuccess) return (int)err;
  int* sz = static_cast<int*>(sizes);
  const rowpart::SegArray segs{sg, n, K};
  const rowpart::Part part{n, K, C, R, cap, 0, 1, 1};
  err = rowpart::partition(segs, segs, part, E, static_cast<int*>(counts),
                           static_cast<int4*>(items),
                           static_cast<int*>(item_first),
                           static_cast<int*>(item_count), sz,
                           static_cast<int*>(order), st);
  if (err != cudaSuccess) return (int)err;
  dim3 ggrid((n + kThreads - 1) / kThreads, E);
  gather_kernel<<<ggrid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(bins), static_cast<const float*>(stats),
      static_cast<const int*>(order), sz, sh, static_cast<uint8_t*>(codes),
      static_cast<float*>(sorted));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 hgrid((unsigned)E * cap, (F + fg - 1) / fg);
  hist_item_kernel<<<hgrid, kThreads, hsmem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(sorted),
      static_cast<const int4*>(items), sh, static_cast<double*>(partial));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t fbs = (size_t)F * B * S;
  const size_t want = (fbs + 255) / 256;
  const int ek = E * K;
  dim3 rgrid((unsigned)(want > 1024 ? 1024 : want),
             (unsigned)(ek > 65535 ? 65535 : ek));
  reduce_kernel<<<rgrid, 256, 0, st>>>(
      static_cast<const double*>(partial),
      static_cast<const int*>(item_first),
      static_cast<const int*>(item_count), sh, ek, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* hist_fused_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_fused_batched_tile_rows() { return b5::kTile; }

int hist_fused_batched_part_rows() { return rowpart::kPartRows; }

long long hist_fused_batched_smem_bytes(int S, int B, int fg) {
  return (long long)b5::hist_smem_bytes(S, B, fg);
}

}  // extern "C"
