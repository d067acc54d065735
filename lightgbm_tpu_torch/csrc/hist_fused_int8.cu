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
// rows; those are the TPU's workarounds and are not carried over.  The
// channel maxima come in from the wrapper (one torch amax, as the reference
// computes them outside its pallas_call too).
//
// Three passes on one stream:
//   quantize_kernel: one thread per (row, channel) element: q as int8
//     [n, S], with IEEE division and addition (__fdiv_rn, __fadd_rn) and
//     floorf, so q is the plain version's bit for bit (compiled with
//     -fmad=false like split_iter.cu, though no multiply-add occurs).
//   int8_hist_kernel: one block of kThreads per (row chunk, feature group,
//     segment group), a thread per row: it reads the row's segment, skips
//     rows of other segments, then walks the row's codes of the group's
//     features (contiguous bytes, so a warp's loads cover whole lines
//     across the walk) and adds the row's q per channel with integer
//     atomicAdd into an int32 histogram [segments, features, S, B] in
//     shared memory, whose non-zero cells the block then adds into a
//     global int32 accumulator [K, F, B, S].  A block's histogram holds
//     every segment of the call (blocks of one segment each left most
//     threads idle on other segments' rows).  This mode serves calls of at
//     most two segments (kernels/histogram.py plan_int8: the roots, the
//     strict grower), whose rows crowd few cells; wider calls (waves) take
//     the global mode (seg_group = 0, int8_hist_global_kernel): every add
//     goes straight to the global accumulator, S threads to a row.  (On an
//     H100, against v1's block per single feature with shared histograms
//     everywhere: root 0.25 -> 0.17 ms, a 42-segment wave 0.53 -> 0.25;
//     PERF.md.)
//   finalize_kernel: out = __int2float_rn(acc) * scale, rounded to nearest.
// Integer sums do not depend on their order, so unlike the f32 kernels
// (hist_common.cuh) this needs no sort and no chunk-ordered partials and is
// still deterministic: kernel and plain version agree bit for bit.  Every
// partial sum of a cell is a sum of at most n terms of magnitude <= 127, so
// for n <= 2^31 / 127 = 16,909,320 (the wrapper refuses more) no
// intermediate, in shared or global memory, leaves the int32 range.
//
// What bounds it on the H100: the bytes are few (n * (F + 4S + 4) read once,
// about 44 MB at the north-star root, 0.013 ms at 3.35 TB/s), so the limit
// is the per-row work: an atomic per (row, feature, channel), which contend
// when many rows of a warp land in one bin.  A one-hot int8 tensor-core
// contraction (IMMA/wgmma) is the candidate for a later redesign.
//
// Plain C interface, bound with ctypes by kernels/histogram.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr uint32_t kHashMul = 2654435761u;
constexpr uint32_t kHashAdd = 974711u;

__device__ __forceinline__ float channel_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
}

__global__ void quantize_kernel(const float* __restrict__ stats, long long n,
                                int S, const float* __restrict__ amax,
                                int8_t* __restrict__ q) {
  const long long total = n * S;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / S;
    const int c = (int)(e - i * S);
    const uint32_t h = (uint32_t)i * kHashMul + kHashAdd;
    // (h >> 9) < 2^23 is exact in f32, and so is the division by 2^23
    const float r = __fdiv_rn((float)(h >> 9), 8388608.0f);
    const float t = __fadd_rn(__fdiv_rn(stats[e], channel_scale(amax[c])), r);
    const float v = fminf(fmaxf(floorf(t), -127.0f), 127.0f);
    q[e] = (int8_t)(int)v;
  }
}

// grid (n_chunks, feature groups, segment groups); dynamic shared int32
// [seg_group, feat_group, S, B]
__global__ void __launch_bounds__(kThreads)
int8_hist_kernel(const uint8_t* __restrict__ bins, long long n, int F,
                 const int8_t* __restrict__ q, int S,
                 const int* __restrict__ seg, int K, int B,
                 long long rows_per_chunk, int seg_group, int feat_group,
                 int* __restrict__ acc) {
  extern __shared__ int s_hist[];
  const int f0 = blockIdx.y * feat_group;
  const int f_count = min(feat_group, F - f0);
  const int g0 = blockIdx.z * seg_group;
  const int g_count = min(seg_group, K - g0);
  const int cells = g_count * f_count * S * B;
  for (int i = threadIdx.x; i < cells; i += kThreads) s_hist[i] = 0;
  __syncthreads();

  const long long row0 = blockIdx.x * rows_per_chunk;
  const long long row1 = min(n, row0 + rows_per_chunk);
  for (long long r = row0 + threadIdx.x; r < row1; r += kThreads) {
    const int sg = seg[r] - g0;
    if (sg < 0 || sg >= g_count) continue;
    const int8_t* qr = q + r * S;
    const uint8_t* codes = bins + r * F + f0;
    for (int fl = 0; fl < f_count; ++fl) {
      const int code = (int)codes[fl];
      if (code >= B) continue;
      for (int c = 0; c < S; ++c) {
        const int v = (int)qr[c];
        if (v != 0) {
          atomicAdd(s_hist + ((sg * f_count + fl) * S + c) * B + code, v);
        }
      }
    }
  }
  __syncthreads();
  // acc [K, F, B, S]: this block's cells (segments g0.., features f0..)
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int v = s_hist[i];
    if (v == 0) continue;
    const int b = i % B;
    int rest = i / B;
    const int c = rest % S;
    rest /= S;
    const int fl = rest % f_count, k = rest / f_count;
    atomicAdd(acc + (((long long)(g0 + k) * F + f0 + fl) * B + b) * S + c,
              v);
  }
}

// the global mode, grid (n_chunks): S neighbouring threads take one row,
// a channel each, so a warp's atomics for one feature land on the row's S
// adjacent cells of acc [K, F, B, S] (a third of the L2 sectors a thread
// per row would touch)
__global__ void __launch_bounds__(kThreads)
int8_hist_global_kernel(const uint8_t* __restrict__ bins, long long n,
                        int F, const int8_t* __restrict__ q, int S,
                        const int* __restrict__ seg, int K, int B,
                        long long rows_per_chunk, int* __restrict__ acc) {
  const int per_pass = kThreads / S;          // rows per pass of the block
  const int lr = threadIdx.x / S, c = threadIdx.x - lr * S;
  if (lr >= per_pass) return;
  const long long row0 = blockIdx.x * rows_per_chunk;
  const long long row1 = min(n, row0 + rows_per_chunk);
  for (long long r = row0 + lr; r < row1; r += per_pass) {
    const int sg = seg[r];
    if (sg < 0 || sg >= K) continue;
    const int v = (int)q[r * S + c];
    if (v == 0) continue;
    const uint8_t* codes = bins + r * F;
    int* cells = acc + (long long)sg * F * B * S + c;
    for (int f = 0; f < F; ++f) {
      const int code = (int)codes[f];
      if (code < B) atomicAdd(cells + ((long long)f * B + code) * S, v);
    }
  }
}

__global__ void finalize_kernel(const int* __restrict__ acc, long long cells,
                                int S, const float* __restrict__ amax,
                                float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % S);
    out[i] = __fmul_rn(__int2float_rn(acc[i]), channel_scale(amax[c]));
  }
}

int grid_1d(long long work, int threads) {
  const long long want = (work + threads - 1) / threads;
  return want > 65535 ? 65535 : (want < 1 ? 1 : (int)want);
}

// seg_group 0: the global mode (no shared histogram)
size_t smem_bytes(int S, int B, int seg_group, int feat_group) {
  return sizeof(int) * (size_t)seg_group * feat_group * S * B;
}

}  // namespace

extern "C" {

// amax: f32 [S] channel maxima of |stats| over all n rows; q: scratch int8
// [n, S]; acc: scratch int32 [K, F, B, S]; out: f32 [K, F, B, S];
// seg_group, feat_group: segments and features of a block's shared
// histogram; seg_group 0 for the global mode
int hist_fused_int8_launch(const void* bins, long long n, int F,
                           const void* stats, int S, const void* seg, int K,
                           int B, const void* amax, long long rows_per_chunk,
                           int n_chunks, int seg_group, int feat_group,
                           void* q, void* acc, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = seg_group > 0;
  if ((shared && feat_group < 1) || S > kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = shared ? (K + seg_group - 1) / seg_group : 1;
  const int f_groups = shared ? (F + feat_group - 1) / feat_group : 1;
  if (groups > 65535 || f_groups > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = smem_bytes(S, B, seg_group, feat_group);
  cudaError_t err = cudaSuccess;
  if (shared) {
    err = cudaFuncSetAttribute(int8_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)K * F * B * S;
  err = cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)cells, st);
  if (err != cudaSuccess) return (int)err;
  quantize_kernel<<<grid_1d(n * S, 256), 256, 0, st>>>(
      static_cast<const float*>(stats), n, S,
      static_cast<const float*>(amax), static_cast<int8_t*>(q));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const int* sg = static_cast<const int*>(seg);
  int* a = static_cast<int*>(acc);
  if (shared) {
    dim3 grid(n_chunks, f_groups, groups);
    int8_hist_kernel<<<grid, kThreads, smem, st>>>(
        b, n, F, qq, S, sg, K, B, rows_per_chunk, seg_group, feat_group, a);
  } else {
    int8_hist_global_kernel<<<n_chunks, kThreads, 0, st>>>(
        b, n, F, qq, S, sg, K, B, rows_per_chunk, a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<grid_1d(cells, 256), 256, 0, st>>>(
      static_cast<const int*>(acc), cells, S,
      static_cast<const float*>(amax), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* hist_fused_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hist_fused_int8_threads() { return kThreads; }

long long hist_fused_int8_smem_bytes(int S, int B, int seg_group,
                                     int feat_group) {
  return (long long)smem_bytes(S, B, seg_group, feat_group);
}

}  // extern "C"
