// Shared device code of the histogram kernels B1 (hist_fused.cu) and B2
// (hist_partition.cu).  (B5 and B6 have their own device code in
// hist_fused_batched.cu and hist_segstats.cu.)
//
// Both build f32 histograms [K, F, B, S] of per-row statistics over
// (segment, feature, bin) with a FIXED summation order, so two launches on
// the same input give bit-equal output (no float atomics):
//
//   pass 1, hist_partial_kernel: one block of 256 threads per (row chunk,
//     feature, segment group).  The block stages a tile of its chunk's rows
//     in shared memory (the row's code for this feature and its segment
//     packed in one int "key", and its statistics), sorts the tile's rows
//     by bin with a stable counting sort, and then one thread per bin walks
//     only that bin's rows, in row order, adding into its cells of a shared
//     [group * S, B] partial.  The partial goes to scratch
//     [chunks, F, K*S, B].
//   pass 2, hist_reduce_kernel: each output cell sums its chunks' partials in
//     chunk order.
//
// Every sum is f32 arithmetic with Kahan compensation (a second shared
// [KS, B] array holds the running compensation), so a cell's error stays
// within a few f32 ulps of its sum of |x| however many rows it collects: a
// plain running f32 sum over the ~4,000 rows of a root-histogram cell drifts
// by ~1e-6 of it.
//
// What bounds it on the H100: the bytes are few (the inputs are read once,
// n*(F + 4*S + 4) bytes, about 45 MB at 1M rows x 28 features), so the
// limit is the per-row work and its latency.  The first version had every
// thread look at every row (n*F*B compares, 7.2e9 at the north-star root);
// the counting sort makes the work per row constant: each warp ranks its 32
// rows by bin with one __match_any_sync, and each thread then touches only
// the rows of its own bin.  Rows that add nothing (other segments, codes
// >= B) are never placed, which compacts a wave's tile to its direct rows.
// The sort's order is warp-major over contiguous row ranges, so a bin's
// rows keep their row order and the sums stay deterministic.
//
// Rows come with their segment ids (B1: the caller's; B2: the wave's row
// partition, computed once per wave by route_kernel in hist_partition.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hist {

constexpr int kTileRows = 1024;        // rows staged per shared-memory tile
constexpr int kThreads = 256;          // the sort's count pass: a bin each
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kMaxBins = 256;
static_assert(kThreads == kMaxBins, "the count pass gives thread b bin b");
static_assert(kRowsPerWarp % 32 == 0, "a warp ranks whole groups of 32");
constexpr int kNoRow = 0x100;          // key of a row that adds nothing
constexpr int kCodeMask = 0x1ff;       // key & kCodeMask == bin code
constexpr int kSegShift = 9;           // key >> kSegShift == local segment

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
  int n;             // rows
  int F;             // features (columns of bins)
  int S;             // statistics per row
  int K;             // segments
  int B;             // bins
  int rows_per_chunk;
  int seg_group;     // segments per block
  int bf16;          // 1: round each statistic to bf16 first
};

// blocks along gridDim.z: segment groups
__host__ __device__ inline int seg_groups(const Shape& s) {
  return (s.K + s.seg_group - 1) / s.seg_group;
}

// staged keys and statistics, the sort's per-warp counts, bin starts and
// totals and its row order, the partial and its compensation
__host__ __device__ inline size_t smem_bytes(const Shape& s) {
  return sizeof(int) * ((size_t)kTileRows + (size_t)kWarps * kMaxBins +
                        2 * (size_t)kMaxBins) +
         sizeof(float) * ((size_t)kTileRows * s.S +
                          2 * (size_t)s.seg_group * s.S * s.B) +
         sizeof(unsigned short) * kTileRows;
}

// sum += x with Kahan compensation `comp` (f32 arithmetic throughout; no
// multiply, so nothing contracts into an FMA)
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const uint8_t* __restrict__ bins,
                    const float* __restrict__ stats,
                    const int* __restrict__ seg, Shape sh,
                    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = sh.S, B = sh.B;
  const int chunk = blockIdx.x, f = blockIdx.y, group = blockIdx.z;
  const int g0 = group * sh.seg_group;
  const int g_count = min(sh.seg_group, sh.K - g0);
  const int ks = g_count * S;                 // partial rows of this block
  int* s_key = reinterpret_cast<int*>(smem_raw);          // [kTileRows]
  int* s_wcnt = s_key + kTileRows;            // [kWarps, kMaxBins]
  int* s_start = s_wcnt + kWarps * kMaxBins;  // [kMaxBins] first sorted slot
  int* s_total = s_start + kMaxBins;          // [kMaxBins] rows of the bin
  float* s_stat = reinterpret_cast<float*>(s_total + kMaxBins);
  float* acc = s_stat + kTileRows * S;
  float* comp = acc + (size_t)sh.seg_group * S * B;
  unsigned short* s_order = reinterpret_cast<unsigned short*>(
      comp + (size_t)sh.seg_group * S * B);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;

  for (int i = tid; i < ks * B; i += kThreads) {
    acc[i] = 0.0f;
    comp[i] = 0.0f;
  }

  const long long row0 = (long long)chunk * sh.rows_per_chunk;
  const long long row1 = min((long long)sh.n, row0 + sh.rows_per_chunk);
  for (long long t0 = row0; t0 < row1; t0 += kTileRows) {
    const int rows = (int)min((long long)kTileRows, row1 - t0);
    __syncthreads();                          // the previous tile is done
    // stage: keys (segment and code of rows that add something), stats
    for (int i = tid; i < kTileRows; i += kThreads) {
      int key = kNoRow;
      if (i < rows) {
        const long long r = t0 + i;
        // out of range: no row; no segment ids: every row in segment 0
        const int sg = (seg ? seg[r] : 0) - g0;
        const int code = (int)bins[r * sh.F + f];
        if (sg >= 0 && sg < g_count && code < B) {
          key = (sg << kSegShift) | code;
        }
      }
      s_key[i] = key;
    }
    for (int i = tid; i < rows * S; i += kThreads) {
      const float v = stats[t0 * S + i];
      s_stat[i] = sh.bf16 ? round_bf16(v) : v;
    }
    for (int i = tid; i < kWarps * kMaxBins; i += kThreads) s_wcnt[i] = 0;
    __syncthreads();
    // count: each warp ranks its rows 32 at a time; the leader of each
    // group of equal codes adds the group's size to the warp's count
    int* wcnt = s_wcnt + warp * kMaxBins;
    for (int sub = 0; sub < kRowsPerWarp; sub += 32) {
      const int code = s_key[warp * kRowsPerWarp + sub + lane] & kCodeMask;
      const unsigned peers = __match_any_sync(0xffffffffu, code);
      if (code < kMaxBins && lane == __ffs(peers) - 1) {
        wcnt[code] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    // per bin: the warps' offsets within the bin, and the bin's total
    {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_wcnt[w * kMaxBins + tid];
        s_wcnt[w * kMaxBins + tid] = run;
        run += c;
      }
      s_total[tid] = run;
    }
    __syncthreads();
    // bin starts: an exclusive scan of the totals by warp 0 (8 bins a lane)
    if (warp == 0) {
      int local[kMaxBins / 32];
      int sum = 0;
      for (int j = 0; j < kMaxBins / 32; ++j) {
        local[j] = sum;
        sum += s_total[lane * (kMaxBins / 32) + j];
      }
      int incl = sum;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const int base = incl - sum;
      for (int j = 0; j < kMaxBins / 32; ++j) {
        s_start[lane * (kMaxBins / 32) + j] = base + local[j];
      }
    }
    __syncthreads();
    // scatter: the same ranking again, now writing each row's slot
    for (int sub = 0; sub < kRowsPerWarp; sub += 32) {
      const int r = warp * kRowsPerWarp + sub + lane;
      const int code = s_key[r] & kCodeMask;
      const unsigned peers = __match_any_sync(0xffffffffu, code);
      if (code < kMaxBins) {
        s_order[s_start[code] + wcnt[code] + __popc(peers & below)] =
            (unsigned short)r;
      }
      __syncwarp();
      if (code < kMaxBins && lane == __ffs(peers) - 1) {
        wcnt[code] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    // accumulate, each cell's rows in row order: thread b walks its bin's
    // rows for every channel
    const int b = tid;
    if (b < B) {
      const int end = s_start[b] + s_total[b];
      for (int i = s_start[b]; i < end; ++i) {
        const int r = s_order[i];
        const int off = (s_key[r] >> kSegShift) * S * B + b;
        const float* st = s_stat + r * S;
        for (int c = 0; c < S; ++c) {
          kahan_add(acc[off + c * B], comp[off + c * B], st[c]);
        }
      }
    }
  }
  __syncthreads();
  // partial [chunks, F, K*S, B]: this block's rows [g0*S, g0*S + ks)
  const size_t KS = (size_t)sh.K * S;
  float* dst = partial + ((size_t)chunk * sh.F + f) * KS * B +
               (size_t)g0 * S * B;
  for (int i = tid; i < ks * B; i += kThreads) dst[i] = acc[i];
}

// out [K, F, B, S][k, f, b, s] = (Kahan) sum over chunks c, in order, of
// partial [c, f, k*S + s, b]; one thread per cell, b fastest in the index
// so the partial reads coalesce.
__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   int n_chunks, Shape sh,
                                   float* __restrict__ out) {
  const int S = sh.S, B = sh.B, F = sh.F;
  const size_t KS = (size_t)sh.K * S;
  const size_t cells = (size_t)F * KS * B;   // one chunk's partial
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < cells;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i % B);
    const size_t fks = i / B;
    const int kss = (int)(fks % KS);
    const int f = (int)(fks / KS);
    const float* src = partial + i;
    float sum = 0.0f, comp = 0.0f;
    for (int c = 0; c < n_chunks; ++c) kahan_add(sum, comp, src[c * cells]);
    const int k = kss / S, s = kss % S;
    out[(((size_t)k * F + f) * B + b) * S + s] = sum;
  }
}

// Launch both passes on `stream`; returns the first CUDA error (0 if none).
inline int launch(const uint8_t* bins, const float* stats, const int* seg,
                  const Shape& sh, int n_chunks, float* partial, float* out,
                  cudaStream_t stream) {
  const int groups = seg_groups(sh);
  if (groups > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(sh);
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, sh.F, (unsigned)groups);
  hist_partial_kernel<<<grid, kThreads, smem, stream>>>(bins, stats, seg, sh,
                                                        partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t cells = (size_t)sh.F * sh.K * sh.S * sh.B;
  const int rthreads = 256;
  const size_t want = (cells + rthreads - 1) / rthreads;
  const int rblocks = want > 65535 ? 65535 : (want < 1 ? 1 : (int)want);
  hist_reduce_kernel<<<rblocks, rthreads, 0, stream>>>(
      partial, n_chunks, sh, out);
  return (int)cudaGetLastError();
}

}  // namespace hist
