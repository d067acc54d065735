// Forest prediction over binned rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/predict.py:predict_forest_pallas
// (body _forest_kernel): every row walks every tree of one class for at most
// depth_cap levels, compares its stored bin code with the node's threshold as
// integers (code <= thr goes left), and sums leaf * scale_t over the trees of
// the staged window [t0, t1) in f32, one tree after another in tree order.
// The caller (lightgbm_tpu_torch/kernels/predict.py) applies
// init + learning_rate * sum.
//
// The TPU kernel gathers through one-hot contractions over [Tc, Mp, R],
// transposes the bins to [Fp, n] f32 and puts rows on the 128-lane axis,
// because a TPU has no gather from VMEM.  None of that is needed here:
//
// - one thread per row, kRows rows per block; the block first stages its rows'
//   bin codes ([kRows, F] uint8) in shared memory when the tile fits
//   kStagedCodesLimit bytes (F <= 256); wider rows are read from global
//   memory (through L1), so the column count has no limit;
// - the block walks the window's trees in chunks of tc trees: all threads copy
//   the chunk's node tables into shared memory with 16-byte cp.async copies,
//   in their storage dtypes (int16 indices, uint8 thresholds and int8/bf16
//   leaves stay compact), then every thread walks the chunk's trees with
//   direct indexed loads, kTreesInFlight trees interleaved so that their
//   dependent loads overlap;
// - leaves and dead slots self-loop, so the walks stop as soon as a step
//   leaves every node unchanged: the answer equals that of depth_cap fixed
//   steps;
// - each thread owns its row's sum, so the order of the sum is fixed and no
//   atomics are needed.  __fmul_rn/__fadd_rn keep nvcc from contracting the
//   multiply-add into an FMA, so the sum rounds as the plain PyTorch version
//   (ops/predict.py:forest_sums_plain) rounds.
//
// What bounds it: the device-memory bytes are small (n * (F + 4) plus the
// tables, which every block re-reads from L2).  The work is the node visits,
// about n * trees * depth dependent shared-memory loads and integer compares,
// so the bound is the issue rate and the latency of that pointer chase, and
// at small buckets the staging of the tables and the launch latency.  One
// thread per row gives few warps per SM at the serving buckets (16384 rows
// are 4 warps per SM); splitting trees across blocks, double-buffered or TMA
// staging and tuning are later work.
//
// Launch contract: the C entry points launch on the given stream, never
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;
constexpr int kTreesInFlight = 8;  // trees one thread walks at once
constexpr int kStagedCodesLimit = 32 * 1024;  // bytes of a staged code tile

__host__ __device__ inline bool stages_codes(int num_features) {
  return static_cast<size_t>(kRows) * num_features <= kStagedCodesLimit;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared-memory layout of one block; kernels/predict.py:smem_bytes mirrors
// `total` to choose tc.
template <typename IdxT, typename ThrT, typename LeafT>
struct Layout {
  size_t scale, feat, left, right, leaf, thr, total;
  __host__ __device__ Layout(int num_features, int tc, int mp) {
    const size_t nodes = static_cast<size_t>(tc) * mp;
    scale = stages_codes(num_features)
                ? align16(static_cast<size_t>(kRows) * num_features)
                : 0;
    feat = scale + align16(static_cast<size_t>(tc) * sizeof(float));
    left = feat + align16(nodes * sizeof(IdxT));
    right = left + align16(nodes * sizeof(IdxT));
    leaf = right + align16(nodes * sizeof(IdxT));
    thr = leaf + align16(nodes * sizeof(LeafT));
    total = thr + align16(nodes * sizeof(ThrT));
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

// Asynchronous global -> shared copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) by all threads of the block, 16 bytes per
// cp.async; the caller commits and waits.
__device__ __forceinline__ void stage_async(void* dst, const void* src,
                                            size_t bytes) {
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  for (size_t off = static_cast<size_t>(threadIdx.x) * 16; off < bytes;
       off += static_cast<size_t>(blockDim.x) * 16) {
    __pipeline_memcpy_async(d + off, g + off, 16);
  }
}

// kStagedCodes: the block's codes sit in shared memory (stages_codes), so
// the walk's code loads are shared-memory loads; otherwise they are global.
template <typename IdxT, typename ThrT, typename LeafT, bool kStagedCodes>
__global__ void __launch_bounds__(kRows)
forest_kernel(const uint8_t* __restrict__ bins, int n, int num_features,
              const IdxT* __restrict__ feat, const ThrT* __restrict__ thr,
              const IdxT* __restrict__ left, const IdxT* __restrict__ right,
              const LeafT* __restrict__ leaf,
              const float* __restrict__ scale, int mp, int t0, int t1,
              int depth_cap, int tc, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<IdxT, ThrT, LeafT> lay(num_features, tc, mp);
  uint8_t* s_bins = smem;
  float* s_scale = reinterpret_cast<float*>(smem + lay.scale);
  IdxT* s_feat = reinterpret_cast<IdxT*>(smem + lay.feat);
  IdxT* s_left = reinterpret_cast<IdxT*>(smem + lay.left);
  IdxT* s_right = reinterpret_cast<IdxT*>(smem + lay.right);
  LeafT* s_leaf = reinterpret_cast<LeafT*>(smem + lay.leaf);
  ThrT* s_thr = reinterpret_cast<ThrT*>(smem + lay.thr);

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const uint8_t* g_bins = bins + static_cast<size_t>(row0) * num_features;
  if (kStagedCodes) {
    for (int i = threadIdx.x; i < rows * num_features; i += blockDim.x) {
      s_bins[i] = g_bins[i];
    }
  }
  const bool active = threadIdx.x < rows;
  // dereferenced only by active threads
  const uint8_t* my_bins =
      (kStagedCodes ? s_bins : g_bins) +
      static_cast<size_t>(threadIdx.x) * num_features;

  float acc = 0.0f;
  for (int c0 = t0; c0 < t1; c0 += tc) {
    const int nt = min(tc, t1 - c0);
    const size_t nodes = static_cast<size_t>(nt) * mp;
    const size_t g0 = static_cast<size_t>(c0) * mp;
    __syncthreads();  // the previous chunk is consumed; bins are staged
    stage_async(s_feat, feat + g0, nodes * sizeof(IdxT));
    stage_async(s_left, left + g0, nodes * sizeof(IdxT));
    stage_async(s_right, right + g0, nodes * sizeof(IdxT));
    stage_async(s_leaf, leaf + g0, nodes * sizeof(LeafT));
    stage_async(s_thr, thr + g0, nodes * sizeof(ThrT));
    __pipeline_commit();
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      s_scale[i] = scale[c0 + i];
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    if (active) {
      // kTreesInFlight independent walks interleaved per thread, so their
      // dependent shared-memory loads overlap; the sum still runs in tree
      // order
      for (int k = 0; k < nt; k += kTreesInFlight) {
        const int ng = min(kTreesInFlight, nt - k);
        int base[kTreesInFlight], node[kTreesInFlight];
#pragma unroll
        for (int g = 0; g < kTreesInFlight; ++g) {
          // lanes past the chunk's end walk its last tree again; their
          // results are dropped
          base[g] = (k + min(g, ng - 1)) * mp;
          node[g] = 0;
        }
        for (int d = 0; d < depth_cap; ++d) {
          // one level of every walk, load by load, so the loads of the
          // kTreesInFlight walks issue back to back
          int f[kTreesInFlight], code[kTreesInFlight];
#pragma unroll
          for (int g = 0; g < kTreesInFlight; ++g) {
            f[g] = static_cast<int>(s_feat[base[g] + node[g]]);
          }
#pragma unroll
          for (int g = 0; g < kTreesInFlight; ++g) {
            code[g] = static_cast<unsigned>(f[g]) <
                              static_cast<unsigned>(num_features)
                          ? static_cast<int>(my_bins[f[g]])
                          : 0;
          }
          bool moved = false;
#pragma unroll
          for (int g = 0; g < kTreesInFlight; ++g) {
            const int at = base[g] + node[g];
            const int nxt = code[g] <= static_cast<int>(s_thr[at])
                                ? static_cast<int>(s_left[at])
                                : static_cast<int>(s_right[at]);
            moved |= nxt != node[g];
            node[g] = nxt;
          }
          if (!moved) break;  // every walk sits on a leaf: a fixpoint
        }
#pragma unroll
        for (int g = 0; g < kTreesInFlight; ++g) {
          if (g < ng) {
            acc = __fadd_rn(acc,
                            __fmul_rn(to_float(s_leaf[(k + g) * mp + node[g]]),
                                      s_scale[k + g]));
          }
        }
      }
    }
  }
  if (active) out[row0 + threadIdx.x] = acc;
}

template <typename IdxT, typename ThrT, typename LeafT>
int launch(const void* bins, int n, int num_features, const void* feat,
           const void* thr, const void* left, const void* right,
           const void* leaf, const void* scale, int mp, int t0, int t1,
           int depth_cap, int tc, void* out, void* stream) {
  const Layout<IdxT, ThrT, LeafT> lay(num_features, tc, mp);
  auto kern = stages_codes(num_features)
                  ? forest_kernel<IdxT, ThrT, LeafT, true>
                  : forest_kernel<IdxT, ThrT, LeafT, false>;
  if (lay.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(lay.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + kRows - 1) / kRows);
  kern<<<grid, kRows, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), n, num_features,
      static_cast<const IdxT*>(feat), static_cast<const ThrT*>(thr),
      static_cast<const IdxT*>(left), static_cast<const IdxT*>(right),
      static_cast<const LeafT*>(leaf), static_cast<const float*>(scale), mp,
      t0, t1, depth_cap, tc, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PREDICT_FOREST_ENTRY(NAME, IDX, THR, LEAF)                           \
  extern "C" int NAME(const void* bins, int n, int num_features,             \
                      const void* feat, const void* thr, const void* left,   \
                      const void* right, const void* leaf, const void* scale, \
                      int mp, int t0, int t1, int depth_cap, int tc,          \
                      void* out, void* stream) {                              \
    return launch<IDX, THR, LEAF>(bins, n, num_features, feat, thr, left,    \
                                  right, leaf, scale, mp, t0, t1, depth_cap, \
                                  tc, out, stream);                          \
  }

PREDICT_FOREST_ENTRY(predict_forest_f32, int32_t, int32_t, float)
PREDICT_FOREST_ENTRY(predict_forest_bf16, int16_t, uint8_t, __nv_bfloat16)
PREDICT_FOREST_ENTRY(predict_forest_int8, int16_t, uint8_t, int8_t)

extern "C" int predict_forest_rows_per_block() { return kRows; }

extern "C" int predict_forest_staged_codes_limit() {
  return kStagedCodesLimit;
}

extern "C" const char* predict_forest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
