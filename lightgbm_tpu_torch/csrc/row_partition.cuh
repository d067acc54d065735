// Stable partition of rows by segment: the first passes of the histogram
// kernels B1 (hist_fused.cu, calls of more than one segment), B2
// (hist_partition.cu) and B5 (hist_fused_batched.cu, one partition per
// element), as LightGBM's own GPU learner keeps rows by leaf.
//
//   count:   a block takes kPartRows consecutive rows, a thread a row (the
//            most loads in flight: B2's count routes each row first, a
//            chain of four dependent loads), and counts them per segment
//            in shared memory: the first of the lanes whose segment equals
//            its own (its peers, see peers_of) adds their number.  Rows
//            outside [0, K) are not counted.
//   scan:    one block per element turns the counts [E, K, C] into offsets
//            in (segment, chunk) order, so a segment's rows keep their row
//            order (a warp per segment scans its chunks with coalesced
//            loads, then the segment totals are scanned), and cuts each
//            segment into work items of R positions.  R is either the
//            caller's (B5) or sized here from the rows found, so that the
//            items make about `target` blocks (one round of resident
//            blocks) over `groups` feature groups whatever share of n the
//            segments hold: R >= rows * groups / t, t = max(target - K,
//            target / 2) (each segment's last item may be short), rounded
//            up to a tile, at least the caller's R.  Then sum_k ceil(rows_k
//            / R) <= t / groups + K bounds the items, and the caller sizes
//            the item slots so.  Unused slots get segment -1.
//   scatter: a warp per chunk loads its rows' segments at once, then
//            writes each row's index at its offset plus its rank among its
//            peers.
//
// The row order inside a segment is the row order, so a sum over the list
// in item order is deterministic.  Each row's segment is read twice (count
// and scatter); the second read is of an array that the first has just
// brought into L2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rowpart {

constexpr int kThreads = 256;           // scatter blocks
constexpr int kWarps = kThreads / 32;
constexpr int kPartRows = 1024;         // rows of a chunk: a count block
                                        // (a thread each), a scatter warp
constexpr int kScanThreads = 1024;      // one scan block per element
constexpr int kScanAhead = 8;           // count loads a scanning warp keeps
constexpr int kAhead = kPartRows / 32;  // a scatter warp loads its whole
                                        // chunk before using it

struct Part {
  int n;        // rows of an element
  int K;        // segments
  int C;        // chunks of kPartRows rows
  int R;        // positions per work item (the least when target > 0)
  int cap;      // item slots per element
  int target;   // > 0: size R on the device for about this many blocks
  int groups;   // blocks per work item (feature groups)
  int tile;     // a device-sized R is a multiple of this
};

// bits of a key in [0, K]; the key K marks a row outside the segments
__host__ __device__ inline int key_bits(int K) {
  int b = 0;
  while (b < 31 && (1 << b) <= K) ++b;
  return b;
}

// the lanes whose key equals this lane's: one ballot per key bit for keys
// of at most two bits (the strict grower's two segments), else
// __match_any_sync (faster than the ballots for B5's and B2's 42
// segments on the H100, PERF.md)
__device__ __forceinline__ unsigned peers_of(int key, int bits) {
  if (bits > 2) return __match_any_sync(0xffffffffu, key);
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool one = (key >> b) & 1;
    const unsigned bal = __ballot_sync(0xffffffffu, one);
    peers &= one ? bal : ~bal;
  }
  return peers;
}

// segment ids in memory, [E, n].  A segment source loads a row (pure
// loads, so that a warp keeps kAhead rows' loads in flight), gives its
// segment (-1: outside [0, K)) and may store what it computed.
struct SegArray {
  const int* seg;
  int n, K;
  using Row = int;
  __device__ __forceinline__ Row load(int e, int r) const {
    const int k = seg[(size_t)e * n + r];
    return (k >= 0 && k < K) ? k : -1;
  }
  __device__ __forceinline__ static int segment(Row v) { return v; }
  __device__ __forceinline__ void store(int, int, Row) const {}
};

// counts [E, K, C]: rows of chunk c in segment k.  A block of kPartRows
// threads takes a chunk, a thread a row (the most loads in flight: B2's
// routing is a chain of four dependent loads per row); each warp's peers
// add their number into the block's shared counts with one integer atomic
// (counts do not depend on the order).  Every row is loaded and stored
// once.
template <class SegOf>
__global__ void __launch_bounds__(kPartRows)
count_kernel(SegOf seg_of, Part p, int* __restrict__ counts) {
  extern __shared__ int s_cnt[];                   // [K]
  const int e = blockIdx.y, K = p.K, c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < K; k += kPartRows) s_cnt[k] = 0;
  __syncthreads();
  const int r = c * kPartRows + threadIdx.x;
  int k = -1;
  if (r < p.n) {
    const typename SegOf::Row v = seg_of.load(e, r);
    seg_of.store(e, r, v);
    k = SegOf::segment(v);
  }
  const unsigned peers = peers_of(k < 0 ? K : k, key_bits(K));
  if (k >= 0 && lane == __ffs(peers) - 1) atomicAdd(s_cnt + k, __popc(peers));
  __syncthreads();
  for (int kk = threadIdx.x; kk < K; kk += kPartRows) {
    counts[((size_t)e * K + kk) * p.C + c] = s_cnt[kk];
  }
}

// exclusive scan of data[0, len) in place by the whole block, in index
// order; returns the total
__device__ inline int block_scan(int* data, int len, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (len + kScanThreads - 1) / kScanThreads;
  const int a = min(len, tid * per), b = min(len, a + per);
  int sum = 0;
  for (int i = a; i < b; ++i) sum += data[i];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = s_warp[lane];
    int w = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    s_warp[lane] = w - v;
    if (lane == 31) s_warp[32] = w;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - sum;
  for (int i = a; i < b; ++i) {
    const int t = data[i];
    data[i] = run;
    run += t;
  }
  const int total = s_warp[32];
  __syncthreads();
  return total;
}

// one block per element: counts -> offsets [E, K, C] (in place), the
// element's rows in a segment (sizes [E]), the work items (segment, p0,
// p1, 0) of each segment in item slots [e * cap, (e + 1) * cap) (unused
// slots get segment -1), and per (element, segment) the first item slot
// and the number of items.  (Instantiated per caller's count, so that a
// profile names it.)
template <class CountOf>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, Part p, int4* __restrict__ items,
            int* __restrict__ item_first, int* __restrict__ item_count,
            int* __restrict__ sizes) {
  __shared__ int s_warp[33];
  __shared__ int s_R;
  const int e = blockIdx.x, K = p.K, C = p.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* offs = counts + (size_t)e * K * C;
  int* first = item_first + (size_t)e * K;
  int* cnt = item_count + (size_t)e * K;
  // each segment's chunks scanned by one warp, 32 coalesced counts at a
  // time (kScanAhead loads in flight); its total parked in first[k]
  for (int k = warp; k < K; k += kScanThreads / 32) {
    int* row = offs + (size_t)k * C;
    int carry = 0;
    for (int c0 = 0; c0 < C; c0 += 32 * kScanAhead) {
      int v[kScanAhead];
#pragma unroll
      for (int u = 0; u < kScanAhead; ++u) {
        const int c = c0 + u * 32 + lane;
        v[u] = c < C ? row[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanAhead; ++u) {
        int incl = v[u];
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += up;
        }
        const int c = c0 + u * 32 + lane;
        if (c < C) row[c] = carry + incl - v[u];
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    if (lane == 0) first[k] = carry;
  }
  __syncthreads();
  // the segments' starts, added to their chunks' offsets (kScanAhead
  // loads in flight)
  const int total = block_scan(first, K, s_warp);
  const long long kc = (long long)K * C;
  for (long long i0 = tid; i0 < kc; i0 += kScanAhead * kScanThreads) {
    int v[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      const long long i = i0 + (long long)u * kScanThreads;
      v[u] = i < kc ? offs[i] + first[i / C] : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      const long long i = i0 + (long long)u * kScanThreads;
      if (i < kc) offs[i] = v[u];
    }
  }
  __syncthreads();
  if (tid == 0) {
    sizes[e] = total;
    long long R = p.R;
    if (p.target > 0) {
      // each segment's last item may be short: the blocks of full items
      // are sized for what the K short ones leave of the round
      const int t = max(p.target - K, (p.target + 1) / 2);
      long long r = ((long long)total * p.groups + t - 1) / t;
      r = (r + p.tile - 1) / p.tile * p.tile;
      R = r > R ? r : R;
    }
    s_R = (int)R;
  }
  __syncthreads();
  const int R = s_R;
  for (int k = tid; k < K; k += kScanThreads) {
    const int start = offs[(size_t)k * C];
    const int end = k + 1 < K ? offs[(size_t)(k + 1) * C] : total;
    const int c = (end - start + R - 1) / R;
    cnt[k] = c;
    first[k] = c;
  }
  __syncthreads();
  block_scan(first, K, s_warp);
  int4* it = items + (size_t)e * p.cap;
  for (int i = tid; i < p.cap; i += kScanThreads) {
    it[i] = make_int4(-1, 0, 0, 0);
  }
  __syncthreads();
  for (int k = tid; k < K; k += kScanThreads) {
    const int start = offs[(size_t)k * C];
    const int end = k + 1 < K ? offs[(size_t)(k + 1) * C] : total;
    const int f = first[k];
    // the slots bound the items (see above): the guard only keeps a
    // broken plan inside the table
    for (int j = 0; j < cnt[k] && f + j < p.cap; ++j) {
      const int p0 = start + j * R;
      it[f + j] = make_int4(k, p0, min(end, p0 + R), 0);
    }
    first[k] = e * p.cap + f;
  }
}

// order [E, n]: position -> row, segment-major, row order within a segment
template <class SegOf>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(SegOf seg_of, Part p, const int* __restrict__ offs,
               int* __restrict__ order) {
  extern __shared__ int s_run[];                   // [kWarps, K]
  const int e = blockIdx.y, K = p.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= p.C) return;
  const unsigned below = (1u << lane) - 1u;
  int* run = s_run + warp * K;
  for (int k = lane; k < K; k += 32) {
    run[k] = offs[((size_t)e * K + k) * p.C + c];
  }
  __syncwarp();
  const int bits = key_bits(K);
  int* ord = order + (size_t)e * p.n;
  const int r0 = c * kPartRows, r1 = min(p.n, r0 + kPartRows);
  for (int base = r0; base < r1; base += 32 * kAhead) {
    typename SegOf::Row v[kAhead] = {};
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = base + u * 32 + lane;
      if (r < r1) v[u] = seg_of.load(e, r);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = base + u * 32 + lane;
      const int k = r < r1 ? SegOf::segment(v[u]) : -1;
      const unsigned peers = peers_of(k < 0 ? K : k, bits);
      if (k >= 0) ord[run[k] + __popc(peers & below)] = r;
      __syncwarp();
      if (k >= 0 && lane == __ffs(peers) - 1) run[k] += __popc(peers);
      __syncwarp();
    }
  }
}

// The three passes on `stream` over E elements: counts (scratch [E, K,
// C]), items int4 [E * cap], item_first and item_count [E, K], sizes [E],
// order [E, n].  count_of runs in the count (it may compute and store the
// segments), scatter_of reads them.  Returns the first CUDA error.
template <class CountOf, class ScatterOf>
inline cudaError_t partition(CountOf count_of, ScatterOf scatter_of,
                             const Part& p, int E, int* counts, int4* items,
                             int* item_first, int* item_count, int* sizes,
                             int* order, cudaStream_t st) {
  const size_t csmem = sizeof(int) * (size_t)p.K;
  const size_t smem = sizeof(int) * (size_t)kWarps * p.K;
  cudaError_t err = cudaFuncSetAttribute(
      count_kernel<CountOf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)csmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scatter_kernel<ScatterOf>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.C + kWarps - 1) / kWarps, E);
  count_kernel<CountOf><<<dim3(p.C, E), kPartRows, csmem, st>>>(
      count_of, p, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<CountOf><<<E, kScanThreads, 0, st>>>(
      counts, p, items, item_first, item_count, sizes);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<ScatterOf><<<grid, kThreads, smem, st>>>(scatter_of, p,
                                                          counts, order);
  return cudaGetLastError();
}

}  // namespace rowpart
