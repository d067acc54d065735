// Fused histogram, int8 mode (kernel B1's quantized mode): bins u8 [n, F] x
// stats f32 [n, S] x segment i32 [n] -> f32 [K, F, B, S].  Segments outside
// [0, K) contribute nothing.
//
// The contract (the port of lightgbm_tpu/ops/histogram_pallas.py
// hist_fused_pallas with hist_dtype="int8": its quantization, the int8 body
// of _fused_kernel and the rescale):
//   scale[s] = max(max_i |stats[i, s]|, 1e-30) / 127       (over all n rows)
//   q[i, s]  = clip(floor(stats[i, s] / scale[s] + r_i), -127, 127),
//              r_i = (((i * 2654435761 + 974711) mod 2^32) >> 9) / 2^23
//   out      = f32(int32 sum of q per (segment, feature, bin, s)) * scale[s]
// The TPU kernel folded the quantized rows into a one-hot int8 MXU
// contraction over a transposed [F, n] layout in chunks of at most 512
// rows: the TPU has no scatter.  Hopper has fast shared-memory integer
// atomics, so the histogram is a scatter here.  A one-hot IMMA/wgmma
// product was not taken: at S = 3 it spends B compares per (row, feature)
// to place three values and pads the product's N from 3 to 8.
//
// The passes, on one stream (the redesign; the first design quantized all
// n rows into an int8 scratch, took the maxima with a torch abs/amax pair,
// and added a wave's rows one global atomic per (row, feature, channel)):
//   amax_kernel: the channel maxima in one pass over stats, no |x|
//     temporary: each thread keeps the largest bit pattern of |x| of one
//     channel (non-negative floats order as their bits), then a shared and
//     a global integer atomicMax.  scale follows with the plain version's
//     IEEE steps, so it is quantize_int8's bit for bit (an all-zero channel
//     takes the 1e-30 floor).
//   count / scan / scatter (calls of K > 1 segments only): each block counts
//     its rows per segment in shared memory and adds the counts into global
//     ones; one block scans them into each segment's start, sizes the work
//     items from the rows it found (about one round of resident blocks,
//     at least INT8_ROWS_PER_CELL rows per bin) and cuts each segment into
//     items (slots past the last are marked unused: the host never reads
//     the counts); each block counts again, reserves one range per segment
//     with a global atomicAdd and writes its rows' indices there.  The
//     order inside a segment is free: the sums are integers.  A one-segment
//     call (a root) skips the list: its items are row ranges, and rows of
//     other segments are skipped.
//   int8_hist_kernel: one block per (item, feature group) holds an int32
//     histogram [fg, B, S] of its item's one segment in shared memory.  A
//     lane takes a row, quantizes its S statistics in registers with the
//     plain version's IEEE steps (__fdiv_rn, __fadd_rn, floorf; the source
//     is built with -fmad=false), and per feature adds them into the shared
//     histogram with integer atomics.  The block then adds its non-zero
//     cells into the global int32 accumulator [K, F, B, S] (consecutive
//     cells, one reduction each); a segment of one item writes its f32
//     cells directly and the finalize skips it.  Lanes with equal codes are
//     not first summed across the warp (__match_any_sync,
//     __reduce_add_sync): on an H100 that made the call 16x slower (2.16
//     against 0.13 ms at the north-star root), and a warp whose 32 rows
//     share one bin costs no more than random codes without it (PERF.md).
//   finalize_kernel: out = __int2float_rn(acc) * scale, rounded to nearest,
//     for segments of more than one item.
// Integer sums do not depend on their order, so kernel and plain version
// agree bit for bit.  Every partial sum of a cell is a sum of at most n
// terms of magnitude <= 127, so for n <= 2^31 / 127 = 16,909,320 (the
// wrapper refuses more) no intermediate leaves the int32 range.
//
// What bounds it on the H100: not the bytes (n * (4S + 4) for the maxima
// and the list, then (F + 4S + 4) per row of the call's segments, about
// 44 MB at the north-star root, 0.013 ms at 3.35 TB/s) but the shared
// atomics: one per (row, feature, channel), about 3 lanes per clock per SM
// at the north-star root (lanes of random codes conflict on banks), then
// the flush of the shared histograms (items x F x B x S reductions into
// L2), then five small passes of a few microseconds each.
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace i8 {

constexpr int kThreads = 512;          // histogram and partition blocks
constexpr int kScanThreads = 1024;
constexpr int kMaxS = 8;               // channels quantized in registers
constexpr int kItemCols = 3;           // item table: segment, begin, end
constexpr uint32_t kHashMul = 2654435761u;
constexpr uint32_t kHashAdd = 974711u;

__device__ __forceinline__ float channel_scale(uint32_t amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits), 1e-30f), 127.0f);
}

// q of one statistic: the plain version's quantize_int8, op by op
__device__ __forceinline__ int quantize(float x, float scale, long long i) {
  const uint32_t h = (uint32_t)i * kHashMul + kHashAdd;
  // (h >> 9) < 2^23 is exact in f32, and so is the division by 2^23
  const float r = __fdiv_rn((float)(h >> 9), 8388608.0f);
  const float t = __fadd_rn(__fdiv_rn(x, scale), r);
  return (int)fminf(fmaxf(floorf(t), -127.0f), 127.0f);
}

// grid * kThreads is a multiple of S, so a thread's elements share one
// channel; amax_bits: u32 [S], zeroed by the launcher
__global__ void __launch_bounds__(kThreads)
amax_kernel(const float* __restrict__ stats, long long total, int S,
            uint32_t* __restrict__ amax_bits) {
  __shared__ uint32_t s_max[kMaxS];
  if (threadIdx.x < S) s_max[threadIdx.x] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  const long long e0 = blockIdx.x * (long long)kThreads + threadIdx.x;
  uint32_t m = 0u;
  for (long long e = e0; e < total; e += stride) {
    m = max(m, __float_as_uint(stats[e]) & 0x7fffffffu);
  }
  if (e0 < total) atomicMax(s_max + (int)(e0 % S), m);
  __syncthreads();
  if (threadIdx.x < S) atomicMax(amax_bits + threadIdx.x, s_max[threadIdx.x]);
}

// counts: i32 [K], zeroed by the launcher; dynamic shared i32 [K]
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ seg, long long n, int K,
             long long rows_per_block, int* __restrict__ counts) {
  extern __shared__ int s_cnt[];
  for (int k = threadIdx.x; k < K; k += kThreads) s_cnt[k] = 0;
  __syncthreads();
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const int k = seg[r];
    if (k >= 0 && k < K) atomicAdd(s_cnt + k, 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    if (s_cnt[k]) atomicAdd(counts + k, s_cnt[k]);
  }
}

// one block: the item size R = max(min_rows, the call's rows x f_groups /
// target, rounded up to 32), so that the call's items make about target
// blocks however few of the n rows its segments hold; cursor[k] = start of
// segment k in the row list; seg_items[k] = its items; items [slots, 3] =
// (segment, begin, end), segment -1 unused
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int K, int min_rows,
            int f_groups, int target, int slots, int* __restrict__ cursor,
            int* __restrict__ seg_items, int* __restrict__ items) {
  __shared__ int s_rows[kScanThreads], s_items[kScanThreads];
  __shared__ int s_R;
  const int t = threadIdx.x;
  const int per = (K + kScanThreads - 1) / kScanThreads;
  const int k0 = min(K, t * per), k1 = min(K, k0 + per);
  int rows = 0;
  for (int k = k0; k < k1; ++k) rows += counts[k];
  s_rows[t] = rows;
  __syncthreads();
  // inclusive Hillis-Steele scan of the rows
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int a = t >= d ? s_rows[t - d] : 0;
    __syncthreads();
    s_rows[t] += a;
    __syncthreads();
  }
  if (t == 0) {
    const long long total = s_rows[kScanThreads - 1];
    long long r = (total * f_groups + target - 1) / target;
    r = ((r + 31) / 32) * 32;
    s_R = (int)(r > min_rows ? r : min_rows);
  }
  __syncthreads();
  const int R = s_R;
  int its = 0;
  for (int k = k0; k < k1; ++k) its += (counts[k] + R - 1) / R;
  s_items[t] = its;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int b = t >= d ? s_items[t - d] : 0;
    __syncthreads();
    s_items[t] += b;
    __syncthreads();
  }
  int row = s_rows[t] - rows, slot = s_items[t] - its;
  const int used = s_items[kScanThreads - 1];
  for (int k = k0; k < k1; ++k) {
    const int c = counts[k];
    cursor[k] = row;
    const int nk = (c + R - 1) / R;
    seg_items[k] = nk;
    // slots >= v / R + K >= the items (R >= v * f_groups / target): the
    // guard only keeps a broken plan inside the table
    for (int j = 0; j < nk && slot < slots; ++j, ++slot) {
      items[slot * kItemCols + 0] = k;
      items[slot * kItemCols + 1] = row + j * R;
      items[slot * kItemCols + 2] = row + min(c, (j + 1) * R);
    }
    row += c;
  }
  for (int s = used + t; s < slots; s += kScanThreads) {
    items[s * kItemCols + 0] = -1;
  }
}

// rows_per_block as in count_kernel; dynamic shared i32 [2K]
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ seg, long long n, int K,
               long long rows_per_block, int* __restrict__ cursor,
               int* __restrict__ list) {
  extern __shared__ int s_cnt[];
  int* s_base = s_cnt + K;
  for (int k = threadIdx.x; k < K; k += kThreads) s_cnt[k] = 0;
  __syncthreads();
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const int k = seg[r];
    if (k >= 0 && k < K) atomicAdd(s_cnt + k, 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    s_base[k] = s_cnt[k] ? atomicAdd(cursor + k, s_cnt[k]) : 0;
    s_cnt[k] = 0;
  }
  __syncthreads();
  for (long long r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const int k = seg[r];
    if (k >= 0 && k < K) list[s_base[k] + atomicAdd(s_cnt + k, 1)] = (int)r;
  }
}

// grid (item slots, feature groups); dynamic shared i32 [fg, B, S].
// list == nullptr: the one-segment mode, item x = rows [x R, x R + R)
__global__ void __launch_bounds__(kThreads)
int8_hist_kernel(const uint8_t* __restrict__ bins, long long n, int F,
                 const float* __restrict__ stats, int S,
                 const int* __restrict__ seg, int B, int R, int feat_group,
                 const uint32_t* __restrict__ amax_bits,
                 const int* __restrict__ items,
                 const int* __restrict__ seg_items,
                 const int* __restrict__ list, int* __restrict__ acc,
                 float* __restrict__ out) {
  extern __shared__ int s_hist[];
  __shared__ float s_scale[kMaxS];
  int k = 0;
  long long p0, p1;
  bool direct;
  if (list == nullptr) {
    p0 = (long long)blockIdx.x * R;
    p1 = min(n, p0 + R);
    direct = gridDim.x == 1;
  } else {
    const int* it = items + (size_t)blockIdx.x * kItemCols;
    k = it[0];
    if (k < 0) return;                  // an unused item slot
    p0 = it[1];
    p1 = it[2];
    direct = seg_items[k] == 1;
  }
  const int f0 = blockIdx.y * feat_group;
  const int fc = min(feat_group, F - f0);
  const int cells = fc * B * S;
  for (int i = threadIdx.x; i < cells; i += kThreads) s_hist[i] = 0;
  if (threadIdx.x < S) {
    s_scale[threadIdx.x] = channel_scale(amax_bits[threadIdx.x]);
  }
  __syncthreads();

  for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) {
    const long long r = list == nullptr ? p : (long long)list[p];
    if (list == nullptr && seg[r] != 0) continue;     // another segment
    int q[kMaxS];
#pragma unroll
    for (int c = 0; c < kMaxS; ++c) {
      q[c] = c < S ? quantize(stats[r * S + c], s_scale[c], r) : 0;
    }
    const uint8_t* codes = bins + r * F + f0;
    for (int fl = 0; fl < fc; ++fl) {
      const int code = (int)codes[fl];
      if (code >= B) continue;
      int* cell = s_hist + (fl * B + code) * S;
#pragma unroll
      for (int c = 0; c < kMaxS; ++c) {
        if (c < S && q[c] != 0) atomicAdd(cell + c, q[c]);
      }
    }
  }
  __syncthreads();
  // the block's cells are consecutive in acc [K, F, B, S] and out
  const long long base = ((long long)k * F + f0) * B * S;
  if (direct) {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      out[base + i] = __fmul_rn(__int2float_rn(s_hist[i]), s_scale[i % S]);
    }
  } else {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const int v = s_hist[i];
      if (v != 0) atomicAdd(acc + base + i, v);
    }
  }
}

// seg_items == nullptr: the one-segment mode (direct = one item)
__global__ void finalize_kernel(const int* __restrict__ acc, long long cells,
                                long long seg_cells, int S,
                                const uint32_t* __restrict__ amax_bits,
                                const int* __restrict__ seg_items,
                                bool direct, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += (long long)gridDim.x * blockDim.x) {
    const bool skip = seg_items ? seg_items[i / seg_cells] == 1 : direct;
    if (skip) continue;
    const int c = (int)(i % S);
    out[i] = __fmul_rn(__int2float_rn(acc[i]), channel_scale(amax_bits[c]));
  }
}

int grid_1d(long long work, int threads) {
  const long long want = (work + threads - 1) / threads;
  return want > 65535 ? 65535 : (want < 1 ? 1 : (int)want);
}

size_t hist_smem(int S, int B, int feat_group) {
  return sizeof(int) * (size_t)feat_group * S * B;
}

}  // namespace i8

extern "C" {

// scratch (i32): amax [S] (as u32 bits), counts [K], cursor [K],
// seg_items [K], items [slots, 3], list [n]; acc i32 [K, F, B, S]; out f32
// [K, F, B, S].  K == 1 takes the one-segment mode (no list; items of R
// rows, slots = ceil(n / R)); else R is the least item size, the scan
// picks the size for target blocks, and slots = min(ceil(n / R),
// ceil(target / f_groups)) + K bounds the items.
// part_blocks: blocks of the count and scatter passes.
int hist_fused_int8_launch(const void* bins, long long n, int F,
                           const void* stats, int S, const void* seg, int K,
                           int B, int R, int feat_group, int slots,
                           int target, int part_blocks, void* amax,
                           void* counts, void* cursor, void* seg_items,
                           void* items, void* list, void* acc, void* out,
                           void* stream) {
  using namespace i8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > kMaxS || feat_group < 1 || R < 1 || slots < 1 ||
      target < 1 || part_blocks < 1 || (K > 1 && slots <= K)) {
    return (int)cudaErrorInvalidValue;
  }
  const int f_groups = (F + feat_group - 1) / feat_group;
  if (f_groups > 65535 || slots > 2147483647 / kItemCols) {
    return (int)cudaErrorInvalidConfiguration;
  }
  uint32_t* am = static_cast<uint32_t*>(amax);
  cudaError_t err = cudaMemsetAsync(am, 0, sizeof(uint32_t) * S, st);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)K * F * B * S;
  err = cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)cells, st);
  if (err != cudaSuccess) return (int)err;
  const float* stt = static_cast<const float*>(stats);
  {
    // a grid whose thread count is a multiple of S
    int g = grid_1d(n * S, kThreads);
    g = g < 1024 ? g : 1024;
    g = ((g + S - 1) / S) * S;
    amax_kernel<<<g, kThreads, 0, st>>>(stt, n * S, S, am);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int* sg = static_cast<const int*>(seg);
  int* cnt = static_cast<int*>(counts);
  int* cur = static_cast<int*>(cursor);
  int* si = static_cast<int*>(seg_items);
  int* it = static_cast<int*>(items);
  int* ls = static_cast<int*>(list);
  if (K > 1) {
    const long long per = (n + part_blocks - 1) / part_blocks;
    const size_t psmem = sizeof(int) * 2 * (size_t)K;
    err = cudaFuncSetAttribute(count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)psmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(scatter_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)psmem);
    }
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)K, st);
    if (err != cudaSuccess) return (int)err;
    count_kernel<<<part_blocks, kThreads, sizeof(int) * (size_t)K, st>>>(
        sg, n, K, per, cnt);
    scan_kernel<<<1, kScanThreads, 0, st>>>(cnt, K, R, f_groups, target,
                                            slots, cur, si, it);
    scatter_kernel<<<part_blocks, kThreads, psmem, st>>>(sg, n, K, per, cur,
                                                         ls);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    slots = (int)((n + R - 1) / R);
    ls = nullptr;
    si = nullptr;
  }
  const size_t smem = hist_smem(S, B, feat_group);
  const dim3 grid(slots, f_groups);
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  int* a = static_cast<int*>(acc);
  float* o = static_cast<float*>(out);
  err = cudaFuncSetAttribute(int8_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int8_hist_kernel<<<grid, kThreads, smem, st>>>(b, n, F, stt, S, sg, B, R,
                                                 feat_group, am, it, si, ls,
                                                 a, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<grid_1d(cells, 256), 256, 0, st>>>(
      a, cells, (long long)F * B * S, S, am, si, slots == 1, o);
  return (int)cudaGetLastError();
}

const char* hist_fused_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_fused_int8_threads() { return i8::kThreads; }

int hist_fused_int8_max_channels() { return i8::kMaxS; }

long long hist_fused_int8_smem_bytes(int S, int B, int feat_group) {
  return (long long)i8::hist_smem(S, B, feat_group);
}

}  // extern "C"
