// One strict best-first split iteration (kernel B3), one block per batch
// element:
//
//   inputs   hist  f32 [E, 2, F, B, 3]  both children's (grad, hess, count)
//                                       histograms, in the grower's layout;
//            table f32 [E, cap, 24]     the packed node table
//                                       (models/tree.py _PK);
//            fmask f32 [E, F]           the tree's feature mask;
//            aux   f32 [E, 8]           [leaf, feat, thr, active, 0...]: the
//                                       pick this iteration splits;
//            scal  f32 [E, 16]          [l1, l2, min_data, min_hess,
//                                       min_gain, max_delta_step,
//                                       path_smooth, max_depth, n_nodes, 0..]
//   outputs  table' (a copy of table with the split leaf's row and the two
//            children's rows written when active) and aux' (the next pick).
//
// Per element: the cumulative-sum gain scan of both children, validity
// (min_data, min_hess, min_gain, feature mask, depth), the first-occurrence
// flat argmax over (feature, bin), the winner's gathers, the three row
// writes, and the next pick over the updated table (the lowest leaf index
// among the maximal candidate gains).
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram_pallas.py
// split_iter_pallas (body _split_iter_kernel), which kept the whole
// iteration in VMEM with the histograms bins-minor [2, F, 3, B] (a TPU
// lane-padding workaround not copied here).
//
// Bit-exactness with the plain version (models/tree.py split_iter_plain):
// a one-ulp difference in a gain can swap a near-tied winner and change the
// tree, so every operation is the plain version's, in its order:
//   * the prefix sums add as ops/split.py prefix_sum does (XLA's CPU scan):
//     a running sum inside each block of 16 bins (the last block padded
//     with zeros), a running sum of the block totals, and that sum of the
//     preceding blocks added to every bin (B > 16 only; B <= 256 keeps the
//     block totals to one level);
//   * the gain follows split_gain_scan / leaf_objective_at /
//     constrained_leaf_output in their "kernel" rounding (ops/split.py) op
//     by op with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc
//     never contracts (the source is also built with -fmad=false); the two
//     fused multiply-adds of that rounding (path smoothing's
//     fma(w, f, parent*(1 - f)) for the stored outputs and
//     fma(parent, 1 - f, w*f) inside the gain, and the objective's
//     fma(Y, w, G*w)) are the
//     plain version's fma(): the f32 product exact in f64, one f64 add, one
//     rounding to f32;
//   * the winner's statistics are gathered as the reference kernel gathers
//     them, a sum of where(hit, x, 0.0), so -0.0 comes out as +0.0;
//   * indices (node ids, features, bins) are exact in the f32 table.
//
// What bounds it on the H100: bytes.  Per element it reads the two
// histograms (2 x F x B x 3 floats, 172 KB at F = 28, B = 256) and the
// table, and writes the table; the arithmetic is a few dozen flops per
// (child, feature, bin).  One block per element keeps it simple; the
// histograms are read twice (block totals, then the scan), the second time
// mostly from L2.
//
// Plain C interface, bound with ctypes by kernels/split_iter.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace si {

// the packed table's columns (models/tree.py _PK)
enum Col {
  SPLIT_FEAT = 0, SPLIT_BIN = 1, LEFT = 2, RIGHT = 3, LEAF_VALUE = 4,
  IS_LEAF = 5, COUNT = 6, SPLIT_GAIN = 7, DEPTH = 8, CAND_GAIN = 9,
  CAND_FEAT = 10, CAND_BIN = 11, CAND_LG = 12, CAND_LH = 13, CAND_LC = 14,
  CAND_RG = 15, CAND_RH = 16, CAND_RC = 17, CAND_WL = 18, CAND_WR = 19,
  BOUND_LO = 20, BOUND_HI = 21, CAND_CAT = 22, PM = 23, NC = 24
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlk = 16;          // ops/split.py _SCAN_BLOCK
constexpr int kMaxBins = 256;     // one level of block totals
constexpr int kScal = 16;
constexpr int kAux = 8;
constexpr int kNoIdx = 0x7fffffff;

struct Reg {
  float l1, l2, min_data, min_hess, min_gain, mds, ps;
};

// ops/split.py fma(): a*b + c with the product exact in f64, one rounding
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b),
                                     (double)c));
}

// torch.maximum / torch.minimum: a NaN operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

// ops/split.py leaf_output: -threshold_l1(g, l1) / (h + l2 + 1e-15)
__device__ __forceinline__ float leaf_output(float g, float h, const Reg& r) {
  const float sgn = (float)((0.0f < g) - (g < 0.0f));     // torch.sign
  const float d = __fsub_rn(fabsf(g), r.l1);
  const float c = d < 0.0f ? 0.0f : d;                    // clamp(min=0)
  const float t = __fmul_rn(sgn, c);
  const float den = __fadd_rn(__fadd_rn(h, r.l2), 1e-15f);
  return __fdiv_rn(-t, den);
}

// ops/split.py constrained_leaf_output with per-element switches; path
// smoothing in the "kernel" rounding fma(w, f, parent*(1 - f)) for the
// stored outputs, in the "scan" rounding fma(parent, 1 - f, w*f) for the
// outputs inside the gain (kScan), as split_gain_scan takes them
template <bool kScan = false>
__device__ __forceinline__ float constrained_out(float g, float h, float cnt,
                                                 const Reg& r, float lo,
                                                 float hi, float parent) {
  float w = leaf_output(g, h, r);
  if (r.ps > 0.0f) {
    const float factor = __fdiv_rn(cnt, __fadd_rn(cnt, tmax(r.ps, 1e-30f)));
    const float one_m = __fsub_rn(1.0f, factor);
    w = kScan ? fma_f64(parent, one_m, __fmul_rn(w, factor))
              : fma_f64(w, factor, __fmul_rn(parent, one_m));
  }
  const float cap = r.mds > 0.0f ? r.mds : INFINITY;
  const float lo_t = tmax(lo, -cap);
  const float hi_t = tmin(hi, cap);
  return tmin(tmax(w, lo_t), hi_t);
}

// ops/split.py leaf_objective_at ("kernel" rounding):
// -2 * (fma(Y, w, G*w) + l1*|w|), Y = 0.5*(H + l2)*w
__device__ __forceinline__ float objective_at(float w, float g, float h,
                                              const Reg& r) {
  const float y = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(h, r.l2)), w);
  const float s = fma_f64(y, w, __fmul_rn(g, w));
  const float c = __fmul_rn(r.l1, fabsf(w));
  return __fmul_rn(-2.0f, __fadd_rn(s, c));
}

// (gain, index) order of the first-occurrence argmax
__device__ __forceinline__ bool better(float g1, int i1, float g2, int i2) {
  return g1 > g2 || (g1 == g2 && i1 < i2);
}

__global__ void __launch_bounds__(kThreads)
split_iter_kernel(const float* __restrict__ hist,
                  const float* __restrict__ table,
                  const float* __restrict__ fmask,
                  const float* __restrict__ aux,
                  const float* __restrict__ scal, int F, int B, int cap,
                  float* __restrict__ out_table, float* __restrict__ out_aux) {
  extern __shared__ float smem[];
  const int nb = (B + kBlk - 1) / kBlk;
  float* s_before = smem;                       // [2F, nb, 3]
  float* s_total = s_before + 2 * F * nb * 3;   // [2F, 3]
  __shared__ float s_row[NC];
  __shared__ float s_red_g[2][kWarps];
  __shared__ int s_red_i[2][kWarps];
  __shared__ float s_best[2];
  __shared__ float s_win[2][10];
  __shared__ float s_pick_g[kWarps];
  __shared__ int s_pick_i[kWarps];

  const int e = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* H = hist + (size_t)e * 2 * F * B * 3;
  const float* T = table + (size_t)e * cap * NC;
  float* TO = out_table + (size_t)e * cap * NC;
  const float* sc = scal + (size_t)e * kScal;
  const Reg r{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6]};
  const float max_depth = sc[7];
  const int n_nodes = (int)sc[8];
  const float* ax = aux + (size_t)e * kAux;
  const int leaf = (int)ax[0];
  const bool active = ax[3] > 0.0f;
  const float* fm = fmask + (size_t)e * F;

  if (tid < NC) s_row[tid] = T[(size_t)leaf * NC + tid];
  for (int i = tid; i < cap * NC; i += kThreads) TO[i] = T[i];

  // 1. per (child, feature, block of 16 bins): the block's running-sum
  //    total (zero padding past B included) and, for the block holding bin
  //    B - 1, the running sum at B - 1
  const int lanes = 2 * F * nb;
  for (int l = tid; l < lanes; l += kThreads) {
    const int blk = l % nb, cf = l / nb;
    const float* hp = H + (size_t)cf * B * 3;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int j = 0; j < kBlk; ++j) {
      const int b = blk * kBlk + j;
      if (nb == 1 && b >= B) break;             // B <= 16: no padding
      const float v0 = b < B ? hp[b * 3 + 0] : 0.0f;
      const float v1 = b < B ? hp[b * 3 + 1] : 0.0f;
      const float v2 = b < B ? hp[b * 3 + 2] : 0.0f;
      if (j == 0) {
        a0 = v0; a1 = v1; a2 = v2;
      } else {
        a0 = __fadd_rn(a0, v0); a1 = __fadd_rn(a1, v1); a2 = __fadd_rn(a2, v2);
      }
      if (b == B - 1) {
        s_total[cf * 3 + 0] = a0;
        s_total[cf * 3 + 1] = a1;
        s_total[cf * 3 + 2] = a2;
      }
    }
    float* t = s_before + ((size_t)cf * nb + blk) * 3;
    t[0] = a0; t[1] = a1; t[2] = a2;
  }
  __syncthreads();

  // 2. per (child, feature): the running sum of the block totals, shifted
  //    into each block's "before" sum (0 for the first block), and the
  //    feature's total = its cumulative sum at bin B - 1
  if (nb > 1) {
    for (int cf = tid; cf < 2 * F; cf += kThreads) {
      float inc[3] = {0.0f, 0.0f, 0.0f};
      for (int blk = 0; blk < nb; ++blk) {
        float* t = s_before + ((size_t)cf * nb + blk) * 3;
        for (int s = 0; s < 3; ++s) {
          const float tot = t[s];
          t[s] = blk == 0 ? 0.0f : inc[s];
          inc[s] = blk == 0 ? tot : __fadd_rn(inc[s], tot);
        }
      }
      const float* last = s_before + ((size_t)cf * nb + nb - 1) * 3;
      for (int s = 0; s < 3; ++s)
        s_total[cf * 3 + s] = __fadd_rn(s_total[cf * 3 + s], last[s]);
    }
  }
  __syncthreads();

  // 3. the gain scan: every lane re-runs its block's sums, adds the sum
  //    before it and scores its 16 bins; each thread keeps its best
  //    (gain, flat index) per child
  const float child_depth = __fadd_rn(s_row[DEPTH], 1.0f);
  const bool depth_ok = (max_depth <= 0.0f) || (child_depth < max_depth);
  const float lo = s_row[BOUND_LO], hi = s_row[BOUND_HI];
  float best_g[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {kNoIdx, kNoIdx};
  for (int l = tid; l < lanes; l += kThreads) {
    const int blk = l % nb, cf = l / nb;
    const int c = cf / F, f = cf - c * F;
    const float* hp = H + (size_t)cf * B * 3;
    const float* bf = s_before + ((size_t)cf * nb + blk) * 3;
    const float tg = s_total[cf * 3 + 0], th = s_total[cf * 3 + 1];
    const float tc = s_total[cf * 3 + 2];
    const float p_out = s_row[c == 0 ? CAND_WL : CAND_WR];
    const float parent_obj = objective_at(p_out, tg, th, r);
    const bool usable = fm[f] > 0.0f && depth_ok;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    const int b_end = min(B, (blk + 1) * kBlk);
    for (int b = blk * kBlk; b < b_end; ++b) {
      const float v0 = hp[b * 3 + 0], v1 = hp[b * 3 + 1], v2 = hp[b * 3 + 2];
      if (b == blk * kBlk) {
        a0 = v0; a1 = v1; a2 = v2;
      } else {
        a0 = __fadd_rn(a0, v0); a1 = __fadd_rn(a1, v1); a2 = __fadd_rn(a2, v2);
      }
      float lg = a0, lh = a1, lc = a2;
      if (nb > 1) {
        lg = __fadd_rn(a0, bf[0]); lh = __fadd_rn(a1, bf[1]);
        lc = __fadd_rn(a2, bf[2]);
      }
      const float rg = __fsub_rn(tg, lg), rh = __fsub_rn(th, lh);
      const float rc = __fsub_rn(tc, lc);
      const float wl = constrained_out<true>(lg, lh, lc, r, lo, hi, p_out);
      const float wr = constrained_out<true>(rg, rh, rc, r, lo, hi, p_out);
      float gain = __fsub_rn(__fadd_rn(objective_at(wl, lg, lh, r),
                                       objective_at(wr, rg, rh, r)),
                             parent_obj);
      const bool valid = lc >= r.min_data && rc >= r.min_data &&
                         lh >= r.min_hess && rh >= r.min_hess &&
                         gain > r.min_gain && usable;
      if (!valid) gain = -INFINITY;
      const int idx = f * B + b;
      if (better(gain, idx, best_g[c], best_i[c])) {
        best_g[c] = gain;
        best_i[c] = idx;
      }
    }
  }
  for (int c = 0; c < 2; ++c) {
    float g = best_g[c];
    int i = best_i[c];
    for (int d = 16; d > 0; d >>= 1) {
      const float g2 = __shfl_down_sync(0xffffffffu, g, d);
      const int i2 = __shfl_down_sync(0xffffffffu, i, d);
      if (better(g2, i2, g, i)) { g = g2; i = i2; }
    }
    if (lane == 0) { s_red_g[c][warp] = g; s_red_i[c][warp] = i; }
  }
  __syncthreads();
  if (tid < 2) {
    const int c = tid;
    float g = s_red_g[c][0];
    int i = s_red_i[c][0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_red_g[c][w], s_red_i[c][w], g, i)) {
        g = s_red_g[c][w];
        i = s_red_i[c][w];
      }
    }
    // every candidate -inf: index 0, as a first-occurrence argmax gives
    if (i == kNoIdx) i = 0;
    s_best[c] = g;
    // 4. the winner's gathers, recomputed in the scan's order
    const int f = i / B, b = i - f * B;
    const int cf = c * F + f, blk = b / kBlk;
    const float* hp = H + (size_t)cf * B * 3;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int bb = blk * kBlk; bb <= b; ++bb) {
      if (bb == blk * kBlk) {
        a0 = hp[bb * 3 + 0]; a1 = hp[bb * 3 + 1]; a2 = hp[bb * 3 + 2];
      } else {
        a0 = __fadd_rn(a0, hp[bb * 3 + 0]);
        a1 = __fadd_rn(a1, hp[bb * 3 + 1]);
        a2 = __fadd_rn(a2, hp[bb * 3 + 2]);
      }
    }
    if (nb > 1) {
      const float* bf = s_before + ((size_t)cf * nb + blk) * 3;
      a0 = __fadd_rn(a0, bf[0]); a1 = __fadd_rn(a1, bf[1]);
      a2 = __fadd_rn(a2, bf[2]);
    }
    const float tg = s_total[cf * 3 + 0], th = s_total[cf * 3 + 1];
    const float tc = s_total[cf * 3 + 2];
    const float p_out = s_row[c == 0 ? CAND_WL : CAND_WR];
    const float rg = __fsub_rn(tg, a0), rh = __fsub_rn(th, a1);
    const float rc = __fsub_rn(tc, a2);
    float* w = s_win[c];
    w[0] = (float)f; w[1] = (float)b;
    w[2] = a0; w[3] = a1; w[4] = a2; w[5] = rg; w[6] = rh; w[7] = rc;
    w[8] = constrained_out(a0, a1, a2, r, lo, hi, p_out);
    w[9] = constrained_out(rg, rh, rc, r, lo, hi, p_out);
    for (int k = 2; k < 10; ++k) w[k] = __fadd_rn(w[k], 0.0f);   // -0 -> +0
  }
  __syncthreads();   // the table copy and the winners are complete

  // 5. the three row writes
  if (active && tid < NC) {
    const int col = tid;
    float v = s_row[col];
    if (col == SPLIT_FEAT) v = s_row[CAND_FEAT];
    else if (col == SPLIT_BIN) v = s_row[CAND_BIN];
    else if (col == LEFT) v = (float)n_nodes;
    else if (col == RIGHT) v = (float)(n_nodes + 1);
    else if (col == IS_LEAF) v = 0.0f;
    else if (col == SPLIT_GAIN) v = s_row[CAND_GAIN];
    TO[(size_t)leaf * NC + col] = v;
  } else if (active && tid >= 32 && tid < 32 + 2 * NC) {
    const int c = (tid - 32) / NC, col = (tid - 32) % NC;
    const float* w = s_win[c];
    const float bg = s_best[c];
    float v = 0.0f;
    switch (col) {
      case SPLIT_FEAT: case LEFT: case RIGHT: v = -1.0f; break;
      case LEAF_VALUE: v = s_row[c == 0 ? CAND_WL : CAND_WR]; break;
      case IS_LEAF: v = 1.0f; break;
      case COUNT: v = s_row[c == 0 ? CAND_LC : CAND_RC]; break;
      case DEPTH: v = child_depth; break;
      case CAND_GAIN: v = bg; break;
      case CAND_FEAT: v = w[0]; break;
      case CAND_BIN: v = w[1]; break;
      case CAND_LG: v = w[2]; break;
      case CAND_LH: v = w[3]; break;
      case CAND_LC: v = w[4]; break;
      case CAND_RG: v = w[5]; break;
      case CAND_RH: v = w[6]; break;
      case CAND_RC: v = w[7]; break;
      case CAND_WL: v = w[8]; break;
      case CAND_WR: v = w[9]; break;
      case BOUND_LO: v = lo; break;
      case BOUND_HI: v = hi; break;
      case PM: v = tmin(s_row[PM], bg); break;
      default: v = 0.0f;   // SPLIT_BIN, SPLIT_GAIN, CAND_CAT
    }
    TO[(size_t)(n_nodes + c) * NC + col] = v;
  }
  __syncthreads();

  // 6. the next pick over the updated table
  float g = -INFINITY;
  int i = kNoIdx;
  for (int node = tid; node < cap; node += kThreads) {
    const float* row = TO + (size_t)node * NC;
    const float gn = row[IS_LEAF] > 0.5f ? row[CAND_GAIN] : -INFINITY;
    if (better(gn, node, g, i)) { g = gn; i = node; }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const float g2 = __shfl_down_sync(0xffffffffu, g, d);
    const int i2 = __shfl_down_sync(0xffffffffu, i, d);
    if (better(g2, i2, g, i)) { g = g2; i = i2; }
  }
  if (lane == 0) { s_pick_g[warp] = g; s_pick_i[warp] = i; }
  __syncthreads();
  if (tid == 0) {
    g = s_pick_g[0];
    i = s_pick_i[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_pick_g[w], s_pick_i[w], g, i)) {
        g = s_pick_g[w];
        i = s_pick_i[w];
      }
    }
    if (i == kNoIdx) i = 0;
    float* ao = out_aux + (size_t)e * kAux;
    ao[0] = (float)i;
    ao[1] = TO[(size_t)i * NC + CAND_FEAT];
    ao[2] = TO[(size_t)i * NC + CAND_BIN];
    ao[3] = (active && isfinite(g)) ? 1.0f : 0.0f;
    for (int k = 4; k < kAux; ++k) ao[k] = 0.0f;
  }
}

inline size_t smem_bytes(int F, int B) {
  const int nb = (B + kBlk - 1) / kBlk;
  return sizeof(float) * ((size_t)2 * F * nb * 3 + (size_t)2 * F * 3);
}

}  // namespace si

extern "C" {

int split_iter_launch(const void* hist, const void* table, const void* fmask,
                      const void* aux, const void* scal, int E, int F, int B,
                      int cap, void* out_table, void* out_aux, void* stream) {
  if (B < 1 || B > si::kMaxBins || cap < 1 || F < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = si::smem_bytes(F, B);
  cudaError_t err = cudaFuncSetAttribute(
      si::split_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  si::split_iter_kernel<<<E, si::kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(table),
      static_cast<const float*>(fmask), static_cast<const float*>(aux),
      static_cast<const float*>(scal), F, B, cap,
      static_cast<float*>(out_table), static_cast<float*>(out_aux));
  return (int)cudaGetLastError();
}

const char* split_iter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int split_iter_table_columns() { return si::NC; }

long long split_iter_smem_bytes(int F, int B) {
  return (long long)si::smem_bytes(F, B);
}

}  // extern "C"
