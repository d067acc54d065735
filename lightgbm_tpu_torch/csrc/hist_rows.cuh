// Shared device code of the histogram kernels B1 in f32/bf16 mode
// (hist_fused.cu) and B2 (hist_partition.cu): f32 histograms [K, F, B, S]
// of per-row statistics over (segment, feature, bin), every cell summed in
// a fixed order (no float atomics), so two launches on the same input give
// bit-equal output.
//
// The rows are partitioned by segment first (row_partition.cuh, shared
// with B5), as LightGBM's own GPU learner keeps rows by leaf, so a call
// costs in proportion to the rows of its segments and not to n:
//
//   partition (K > 1): a stable count, scan and scatter of the rows of
//     segments [0, K) into a row list grouped by segment, cut into work
//     items sized on the device from the rows found (about one round of
//     resident blocks whatever share of n the segments hold).  B2's count
//     routes the rows of the wave on the way.  A one-segment call (a root)
//     builds no list: its items are row ranges, and rows of other segments
//     are skipped.
//   hist_rows_kernel: a block owns one work item and one feature group, a
//     warp per feature.  A two-stage ring of shared-memory tiles is filled
//     by asynchronous copies while the warps add the previous tile: at a
//     root whose features fit one block, one cp.async.bulk each brings a
//     tile's contiguous [rows, F] codes, [rows, S] statistics and segment
//     ids (an mbarrier counts the bytes); a row list (or a root of several
//     feature groups) is gathered with 4-byte cp.async.  In bf16 mode the
//     staged statistics are rounded to bf16 once.  Each warp takes 32 rows
//     at a time; the lanes of equal codes (one ballot per bit of the code)
//     are summed in lane order by the first of them, in f64, and that sum
//     is added into the warp's own f64 cells of a shared [fg, B, S]
//     histogram that no other warp writes.
//   finish: a segment of one item was written by its blocks as f32; the
//     partials (f64) of a segment of several items are summed in item
//     order and rounded once to f32; a segment of no rows gets zeros.
//
// f64 sums of f32 values are exact on dyadic statistics and stay far
// inside 1e-6 * sum|x| of a cell; the result is rounded once, as the plain
// version (hist_fused_plain: f64, rounded once) does.
//
// What bounds it on the H100: not the bytes (4n for the partition, then
// (F + 4S) per row of the call's segments and the histograms, 45 MB at the
// north-star root, 0.013 ms at 3.35 TB/s) but the shared-memory adds: per
// (32 rows, feature) a dozen instructions of grouping and three f64
// read-modify-writes into cells that random codes spread over the banks;
// then the flush of one f64 histogram per (item, feature group).  The
// first design (per-tile counting sorts of every row of a chunk for every
// feature and segment group, Kahan f32 partials [chunks, F, K*S, B] and a
// second pass) read each row's statistics once per (feature, segment
// group) whatever the segments held; this one reads them once per feature
// group and only for the rows of the call's segments.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_partition.cuh"

namespace hr {

constexpr int kTile = 256;             // rows per ring stage
constexpr int kStages = 2;
constexpr int kMaxWarps = 32;          // features per block, a warp each
constexpr int kMaxS = 8;               // statistics (a kernel instance each)
constexpr int kIssueAhead = 4;         // row-list loads a thread batches

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

// the callers, whose instances of the kernels carry their names (a
// profile tells B1's passes from B2's)
struct b1 {};
struct b2 {};

struct Shape {
  long long n;   // rows
  int F;         // features (columns of bins)
  int S;         // statistics per row
  int K;         // segments
  int B;         // bins
  int bf16;      // 1: round each statistic to bf16 first
  int fg;        // features per block (a warp each)
  int groups;    // feature groups: ceil(F / fg)
  int bulk;      // 1: full tiles of a one-segment call by cp.async.bulk
  int R;         // one segment: rows per item
  int slots;     // item slots (blocks per feature group)
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// bytes of a gathered row's codes: the 4-byte words that cover fg codes
// starting at any byte of a word, an odd number of them (conflict-free
// reads of one code per row by 32 lanes)
__host__ __device__ inline int gather_pitch(int fg) {
  return 4 * (((fg + 6) / 4) | 1);
}

__host__ __device__ inline size_t code_bytes(const Shape& s) {
  const int p = gather_pitch(s.fg);
  return (size_t)kTile * (s.bulk && s.F > p ? s.F : p);
}

// a stage: codes [kTile, pitch] u8, statistics [kTile, S] f32, segment ids
// [kTile] i32, the gathered rows' first-code offsets [kTile] u8
__host__ __device__ inline size_t stage_bytes(const Shape& s) {
  return align16(align16(code_bytes(s)) + align16(4 * (size_t)kTile * s.S) +
                 4 * (size_t)kTile + kTile);
}

// the f64 histogram, the ring and its two mbarriers
__host__ __device__ inline size_t smem_bytes(const Shape& s) {
  return align16(8 * (size_t)s.fg * s.B * s.S) + kStages * stage_bytes(s) +
         16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one bulk copy global -> shared, its bytes counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// grid (item slots, feature groups), fg warps.  list == nullptr: one
// segment, slot x holds rows [x R, x R + R) and rows whose seg is not 0
// are skipped; else items int4 [slots] = (segment, p0, p1, -) positions in
// list, segment -1 unused, and item_count [K] the items of each segment.
// A segment of one item writes out f32 [K, F, B, S]; else its items write
// partial f64 [slots, F, B, S].
template <class Caller, int S>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
hist_rows_kernel(const uint8_t* __restrict__ bins,
                 const float* __restrict__ stats,
                 const int* __restrict__ seg, const int* __restrict__ list,
                 const int4* __restrict__ items,
                 const int* __restrict__ item_count, Shape sh,
                 double* __restrict__ partial, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B = sh.B, F = sh.F;
  const int slot = blockIdx.x;
  int k = 0;
  long long p0, p1;
  bool direct;
  if (list == nullptr) {
    p0 = (long long)slot * sh.R;
    p1 = min(sh.n, p0 + sh.R);
    direct = sh.slots == 1;
  } else {
    const int4 it = items[slot];
    if (it.x < 0) return;                          // an unused slot
    k = it.x;
    p0 = it.y;
    p1 = it.z;
    direct = item_count[k] == 1;
  }
  const int f0 = blockIdx.y * sh.fg;
  const int fc = min(sh.fg, F - f0);               // features of the block
  double* hist = reinterpret_cast<double*>(smem_raw);          // [fc, B, S]
  unsigned char* ring =
      smem_raw + align16(8 * (size_t)sh.fg * B * S);
  const size_t stage = stage_bytes(sh);
  const size_t cbytes = align16(code_bytes(sh));
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kStages * stage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  const int cells = fc * B * S;
  for (int i = tid; i < cells; i += nthreads) hist[i] = 0.0;
  if (tid == 0 && sh.bulk) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int pitch = gather_pitch(sh.fg), pw = pitch / 4;
  const long long code_total = sh.n * F;   // bytes of bins
  const int ntiles = (int)((p1 - p0 + kTile - 1) / kTile);
  const bool one_seg = list == nullptr;
  auto rows_of = [&](int t) {
    return (int)min((long long)kTile, p1 - p0 - (long long)t * kTile);
  };
  auto bulk_of = [&](int t) {
    return sh.bulk && one_seg && rows_of(t) == kTile;
  };
  auto codes_of = [&](int st) { return ring + st * stage; };
  auto stats_of = [&](int st) {
    return reinterpret_cast<float*>(ring + st * stage + cbytes);
  };
  auto segs_of = [&](int st) {
    return reinterpret_cast<int*>(ring + st * stage + cbytes +
                                  align16(4 * (size_t)kTile * S));
  };
  auto offs_of = [&](int st) {
    return reinterpret_cast<uint8_t*>(segs_of(st) + kTile);
  };

  // fill stage st with tile t
  auto issue = [&](int t, int st) {
    const long long t0 = p0 + (long long)t * kTile;
    const int rows = rows_of(t);
    uint8_t* codes = codes_of(st);
    float* st_s = stats_of(st);
    int* sg_s = segs_of(st);
    if (bulk_of(t)) {
      if (tid == 0) {
        uint64_t* bar = bars + st;
        const uint32_t cb = (uint32_t)kTile * F, sb = 4u * kTile * S,
                       gb = 4u * kTile;
        mbar_expect(bar, cb + sb + gb);
        bulk_copy(codes, bins + t0 * F, cb, bar);
        bulk_copy(st_s, stats + t0 * S, sb, bar);
        bulk_copy(sg_s, seg + t0, gb, bar);
      }
      return;
    }
    uint8_t* offs = offs_of(st);
    const int words = pw + S + (one_seg ? 1 : 0);
    const int total = rows * words;
    for (int i0 = tid; i0 < total; i0 += kIssueAhead * nthreads) {
      // the rows of kIssueAhead copies loaded before any copy is issued
      long long rs[kIssueAhead];
#pragma unroll
      for (int u = 0; u < kIssueAhead; ++u) {
        const int i = i0 + u * nthreads;
        const int t_ = i / words;
        rs[u] = i >= total ? 0 : (one_seg ? t0 + t_
                                          : (long long)list[t0 + t_]);
      }
#pragma unroll
      for (int u = 0; u < kIssueAhead; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= total) continue;
        const int t_ = i / words, w = i - t_ * words;
        const long long r = rs[u];
        if (w < pw) {
          const long long b0 = r * F + f0;          // the group's first code
          const int off = (int)(b0 & 3);
          if (w == 0) offs[t_] = (uint8_t)off;
          if (4 * w >= off + fc) continue;          // past the group's codes
          const long long word = (b0 >> 2) + w;
          uint8_t* dst = codes + t_ * pitch + 4 * w;
          if (4 * word + 4 <= code_total) {
            cp_async4(dst, bins + 4 * word);
          } else {                                  // the last bytes of bins
            for (int b = 0; b < 4; ++b) {
              const long long at = 4 * word + b;
              dst[b] = at < code_total ? bins[at] : 0;
            }
          }
        } else if (w < pw + S) {
          cp_async4(st_s + t_ * S + (w - pw), stats + r * S + (w - pw));
        } else {
          cp_async4(sg_s + t_, seg + r);
        }
      }
    }
  };

  const int j = warp;                    // this warp's feature: f0 + j
  double* hj = hist + (size_t)j * B * S;
  uint32_t parity = 0;                   // bit st: stage st's next phase
  issue(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) issue(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();                // this thread's copies of tile t
    const bool bulk = bulk_of(t);
    if (bulk) {
      mbar_wait(bars + st, (parity >> st) & 1u);
      parity ^= 1u << st;
    }
    __syncthreads();
    const int rows = rows_of(t);
    float* st_s = stats_of(st);
    if (sh.bf16) {
      for (int i = tid; i < rows * S; i += nthreads) {
        st_s[i] = round_bf16(st_s[i]);
      }
      __syncthreads();
    }
    if (j < fc) {
      const uint8_t* codes = codes_of(st);
      const uint8_t* offs = offs_of(st);
      const int* sg_s = segs_of(st);
      const int row_pitch = bulk ? F : pitch;
      for (int g = 0; g < rows; g += 32) {
        const int tl = g + lane;
        int code = -1;
        if (tl < rows && (!one_seg || sg_s[tl] == 0)) {
          const int c =
              codes[tl * row_pitch + (bulk ? f0 : (int)offs[tl]) + j];
          if (c < B) code = c;
        }
        const unsigned valid = __ballot_sync(0xffffffffu, code >= 0);
        if (valid == 0u) continue;
        // codes < B <= 256: eight bits name them
        unsigned peers = valid;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const bool one = (code >> b) & 1;
          const unsigned bal = __ballot_sync(0xffffffffu, one);
          peers &= one ? bal : ~bal;
        }
        if (code >= 0 && lane == __ffs(peers) - 1) {
          double sum[S];
#pragma unroll
          for (int c = 0; c < S; ++c) sum[c] = 0.0;
          for (unsigned m = peers; m; m &= m - 1) {
            const float* v = st_s + (g + __ffs(m) - 1) * S;
#pragma unroll
            for (int c = 0; c < S; ++c) sum[c] += (double)v[c];
          }
          double* cell = hj + code * S;
#pragma unroll
          for (int c = 0; c < S; ++c) cell[c] += sum[c];
        }
        // the next step's leaders, other lanes, read these cells
        __syncwarp();
      }
    }
    // the stage is consumed before the next issue refills it; generic
    // writes to it come before a bulk copy's
    if (sh.bulk) fence_proxy_async();
    __syncthreads();
  }

  // the block's cells are consecutive in out [K, F, B, S] and partial
  if (direct) {
    float* dst = out + ((size_t)k * F + f0) * B * S;
    for (int i = tid; i < cells; i += nthreads) dst[i] = (float)hist[i];
  } else {
    double* dst = partial + ((size_t)slot * F + f0) * B * S;
    for (int i = tid; i < cells; i += nthreads) dst[i] = hist[i];
  }
}

// out [K, F, B, S] of the segments not written directly: the sum of their
// items' partials in item order, rounded once (zeros without items).
// item_first == nullptr: one segment whose items are slots [0, slots).
template <class Caller>
__global__ void finish_kernel(const double* __restrict__ partial,
                              const int* __restrict__ item_first,
                              const int* __restrict__ item_count, Shape sh,
                              float* __restrict__ out) {
  const long long fbs = (long long)sh.F * sh.B * sh.S;
  const long long total = (long long)sh.K * fbs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i / fbs);
    const long long cell = i - k * fbs;
    const int first = item_first ? item_first[k] : 0;
    const int count = item_first ? item_count[k] : sh.slots;
    if (count == 1) continue;
    double sum = 0.0;
    for (int j = 0; j < count; ++j) sum += partial[(first + j) * fbs + cell];
    out[i] = (float)sum;
  }
}

inline int grid_1d(long long work, int threads) {
  const long long want = (work + threads - 1) / threads;
  return want > 65535 ? 65535 : (want < 1 ? 1 : (int)want);
}

template <class Caller, int S>
inline cudaError_t launch_rows(const uint8_t* bins, const float* stats,
                               const int* seg, const int* list,
                               const int4* items, const int* item_count,
                               const Shape& sh, double* partial, float* out,
                               cudaStream_t st) {
  const size_t smem = smem_bytes(sh);
  cudaError_t err = cudaFuncSetAttribute(
      hist_rows_kernel<Caller, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sh.slots, sh.groups);
  hist_rows_kernel<Caller, S><<<grid, sh.fg * 32, smem, st>>>(
      bins, stats, seg, list, items, item_count, sh, partial, out);
  return cudaGetLastError();
}

// The histogram and finish passes on `stream` (the partition, for a list,
// ran before).  Returns the first CUDA error.
template <class Caller>
inline cudaError_t histogram(const uint8_t* bins, const float* stats,
                             const int* seg, const int* list,
                             const int4* items, const int* item_first,
                             const int* item_count, const Shape& sh,
                             double* partial, float* out, cudaStream_t st) {
  if (sh.fg < 1 || sh.fg > kMaxWarps || sh.S < 1 || sh.S > kMaxS ||
      sh.groups > 65535 || sh.slots < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  switch (sh.S) {
#define HR_LAUNCH(NS)                                                      \
  case NS:                                                                 \
    err = launch_rows<Caller, NS>(bins, stats, seg, list, items,           \
                                  item_count, sh, partial, out, st);      \
    break;
    HR_LAUNCH(1) HR_LAUNCH(2) HR_LAUNCH(3) HR_LAUNCH(4)
    HR_LAUNCH(5) HR_LAUNCH(6) HR_LAUNCH(7) HR_LAUNCH(8)
#undef HR_LAUNCH
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  if (list == nullptr && sh.slots == 1) return cudaSuccess;
  const long long cells = (long long)sh.K * sh.F * sh.B * sh.S;
  finish_kernel<Caller><<<grid_1d(cells, 256), 256, 0, st>>>(
      partial, list == nullptr ? nullptr : item_first, item_count, sh, out);
  return cudaGetLastError();
}

}  // namespace hr
