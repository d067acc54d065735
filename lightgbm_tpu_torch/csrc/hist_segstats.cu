// Segstats histogram (kernel B6): bins u8 [n, F] x pre-folded statistics
// f32 [n, Kc] -> f32 [F, B, Kc].  bf16 mode rounds each statistic to bf16
// (nearest even) and sums in f64; f32 mode sums the f32 statistics in f64.
// Each output cell is rounded to f32 once.
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// hist_from_segstats_pallas (body _hist_kernel), which contracted a one-hot
// [B, chunk] tile against the [chunk, Kc] statistics on the MXU with the
// [F, B, Kc] accumulator resident in VMEM.  Its callers are the batched
// histograms of narrow calls: fused cross-validation folds configs x folds
// x segments x statistics into Kc channels (30 in the example's cv(), 240
// in an 8-config sweep bucket of the strict grower, 1,080 in a 36-config
// hyper-batch; 15 and 21 at the roots of north-star cv() and multiclass).
//
// Design: one block per (row chunk, feature, set of channel groups).
//
//   1. It sorts the chunk's rows (up to 8,192) by bin ONCE, with a stable
//      counting sort (each warp ranks its rows 32 at a time with
//      __match_any_sync), and keeps the order in shared memory for all its
//      channel groups.  Rows with a code >= B are never placed.
//   2. For each channel group of 32 channels, a lane per channel: the
//      chunk's sorted positions are cut into 8 equal ranges, a warp each,
//      so a heavy bin (an ordinal feature with a few codes) spreads over
//      the warps instead of one thread walking it.  A warp walks its range
//      in order, reading each row's 32 channels straight from global
//      memory (one 128-byte line a position, several in flight), and sums
//      each run of equal bins in f64.  The warp in whose range a bin's run
//      starts stores the run's sum straight into the chunk's f64 partial
//      [chunks, F, B, Kc]; a run continued from the previous range is added
//      there afterwards, in warp order, and bins without rows get 0.  The
//      order is fixed: no float atomics, two launches are bit-equal.
//   3. A reduce pass sums each cell's chunks in chunk order and rounds once
//      to f32 (exact on dyadic statistics).
//
// What bounds it on the H100: not the bytes (the n x Kc statistics once,
// re-read per feature from the L2) nor the n * F * Kc adds, but the walk's
// load latency; with no partial in shared memory a block needs only the
// sort's tables, so many blocks share an SM to hide it.

// Plain C interface, bound with ctypes by kernels/histogram.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace b6 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 256;
constexpr int kLanes = 32;              // channels per group: a lane each
constexpr int kMaxChunkRows = 8192;     // rows sorted by one block
constexpr int kUnroll = 16;             // positions loaded ahead in the walk
constexpr int kNoRow = 0x100;           // key of a row that adds nothing
static_assert(kThreads == kMaxBins, "the count pass gives thread b bin b");

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
  int n;               // rows
  int F;               // features
  int Kc;              // channels
  int B;               // bins
  int bf16;            // 1: round each statistic to bf16 first
  int rows_per_chunk;  // a multiple of kWarps * 32, at most kMaxChunkRows
  int groups_per_set;  // channel groups of 32 per block
};

// keys and sorted positions [R] (u16 each), the sort's per-warp counts,
// bin starts and totals, the warps' continued runs [kWarps, 32] and their
// bins
__host__ __device__ inline size_t smem_bytes(int rows_per_chunk) {
  return 2 * sizeof(unsigned short) * (size_t)rows_per_chunk +
         sizeof(int) * ((size_t)kWarps * kMaxBins + 2 * kMaxBins) +
         sizeof(double) * (kWarps * kLanes) + sizeof(int) * (kWarps + 1);
}

__global__ void __launch_bounds__(kThreads)
hist_chunk_kernel(const uint8_t* __restrict__ bins,
                  const float* __restrict__ segstats, Shape sh,
                  double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = sh.rows_per_chunk, B = sh.B, Kc = sh.Kc;
  const int chunk = blockIdx.x, f = blockIdx.y;
  double* head = reinterpret_cast<double*>(smem_raw);      // [kWarps, 32]
  int* s_wcnt = reinterpret_cast<int*>(head + kWarps * kLanes);
  int* s_start = s_wcnt + kWarps * kMaxBins;
  int* s_total = s_start + kMaxBins;
  int* head_bin = s_total + kMaxBins;                       // [kWarps]
  int* s_placed = head_bin + kWarps;
  unsigned short* s_key = reinterpret_cast<unsigned short*>(s_placed + 1);
  unsigned short* s_pos = s_key + R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long row0 = (long long)chunk * R;
  const int rows = (int)min((long long)R, (long long)sh.n - row0);
  const int per_warp = R / kWarps;

  // 1. sort the chunk's rows by bin
  for (int i = tid; i < R; i += kThreads) {
    int key = kNoRow;
    if (i < rows) {
      const int code = (int)bins[(row0 + i) * sh.F + f];
      if (code < B) key = code;
    }
    s_key[i] = (unsigned short)key;
  }
  for (int i = tid; i < kWarps * kMaxBins; i += kThreads) s_wcnt[i] = 0;
  __syncthreads();
  int* wcnt = s_wcnt + warp * kMaxBins;
  for (int sub = 0; sub < per_warp; sub += 32) {
    const int code = s_key[warp * per_warp + sub + lane];
    const unsigned peers = __match_any_sync(0xffffffffu, code);
    if (code < kMaxBins && lane == __ffs(peers) - 1) {
      wcnt[code] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
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
    if (lane == 31) *s_placed = incl;
  }
  __syncthreads();
  for (int sub = 0; sub < per_warp; sub += 32) {
    const int r = warp * per_warp + sub + lane;
    const int code = s_key[r];
    const unsigned peers = __match_any_sync(0xffffffffu, code);
    if (code < kMaxBins) {
      s_pos[s_start[code] + wcnt[code] + __popc(peers & below)] =
          (unsigned short)r;
    }
    __syncwarp();
    if (code < kMaxBins && lane == __ffs(peers) - 1) {
      wcnt[code] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();

  // 2. every channel group of this block's set over the same order
  const int placed = *s_placed;
  const int pa = (int)((long long)placed * warp / kWarps);
  const int pb = (int)((long long)placed * (warp + 1) / kWarps);
  const float* ss = segstats + row0 * Kc;
  const int n_groups = (Kc + kLanes - 1) / kLanes;
  const int g0 = blockIdx.z * sh.groups_per_set;
  const int g1 = min(n_groups, g0 + sh.groups_per_set);
  double* dst = partial + ((size_t)chunk * sh.F + f) * B * Kc;
  for (int g = g0; g < g1; ++g) {
    const int c = g * kLanes + lane;
    const bool live = c < Kc;
    // bins without rows in this chunk
    for (int i = tid; i < B * kLanes; i += kThreads) {
      const int b = i / kLanes, cc = g * kLanes + (i - b * kLanes);
      if (s_total[b] == 0 && cc < Kc) dst[(size_t)b * Kc + cc] = 0.0;
    }
    if (tid < kWarps) head_bin[tid] = -1;
    __syncthreads();
    int cur = -1;
    bool owner = false;
    double sum = 0.0;
    for (int p = pa; p < pb; p += kUnroll) {
      float v[kUnroll];
      int bn[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = p + u;
        bn[u] = -1;
        v[u] = 0.0f;
        if (q < pb) {
          const int r = s_pos[q];
          bn[u] = s_key[r];
          if (live) v[u] = ss[(size_t)r * Kc + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (bn[u] < 0) continue;
        if (bn[u] != cur) {
          if (cur >= 0) {
            if (!owner) {
              head[warp * kLanes + lane] = sum;
              if (lane == 0) head_bin[warp] = cur;
            } else if (live) {
              dst[(size_t)cur * Kc + c] = sum;
            }
          }
          const int q = p + u;
          cur = bn[u];
          owner = q == 0 || s_key[s_pos[q - 1]] != cur;
          sum = 0.0;
        }
        sum += (double)(sh.bf16 ? round_bf16(v[u]) : v[u]);
      }
    }
    if (cur >= 0) {
      if (!owner) {
        head[warp * kLanes + lane] = sum;
        if (lane == 0) head_bin[warp] = cur;
      } else if (live) {
        dst[(size_t)cur * Kc + c] = sum;
      }
    }
    __syncthreads();
    // runs continued from the previous warp's range, in warp order, after
    // their bins' owners stored theirs
    if (warp == 0 && live) {
      for (int w = 0; w < kWarps; ++w) {
        const int b = head_bin[w];
        if (b >= 0) dst[(size_t)b * Kc + c] += head[w * kLanes + lane];
      }
    }
    __syncthreads();
  }
}

// out [F, B, Kc][cell] = sum over chunks, in order, of partial [chunk][cell]
__global__ void reduce_kernel(const double* __restrict__ partial,
                              int n_chunks, size_t cells,
                              float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < cells;
       i += (size_t)gridDim.x * blockDim.x) {
    double sum = 0.0;
    for (int c = 0; c < n_chunks; ++c) sum += partial[c * cells + i];
    out[i] = (float)sum;
  }
}

}  // namespace b6

extern "C" {

// partial: scratch f64 [n_chunks, F, B, Kc]; out: f32 [F, B, Kc]
int hist_segstats_launch(const void* bins, int n, int F, const void* segstats,
                         int Kc, int B, int bf16, int rows_per_chunk,
                         int n_chunks, int groups_per_set, int n_sets,
                         void* partial, void* out, void* stream) {
  using namespace b6;
  if (rows_per_chunk % (kWarps * 32) != 0 || rows_per_chunk > kMaxChunkRows ||
      F > 65535 || n_sets > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Shape sh{n, F, Kc, B, bf16, rows_per_chunk, groups_per_set};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(rows_per_chunk);
  cudaError_t err = cudaFuncSetAttribute(
      hist_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, F, n_sets);
  hist_chunk_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(bins), static_cast<const float*>(segstats),
      sh, static_cast<double*>(partial));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t cells = (size_t)F * B * Kc;
  const size_t want = (cells + 255) / 256;
  reduce_kernel<<<(unsigned)(want > 65535 ? 65535 : want), 256, 0, st>>>(
      static_cast<const double*>(partial), n_chunks, cells,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* hist_segstats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_segstats_max_chunk_rows() { return b6::kMaxChunkRows; }

long long hist_segstats_smem_bytes(int rows_per_chunk) {
  return (long long)b6::smem_bytes(rows_per_chunk);
}

}  // extern "C"
