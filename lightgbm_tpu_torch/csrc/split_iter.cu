// One strict best-first split iteration (kernel B3), one thread block
// cluster per batch element:
//
//   inputs   hist  f32 [E, 2, F, B, 3]  both children's (grad, hess, count)
//                                       histograms, in the grower's layout;
//            table f32 [E, cap, 24]     the packed node table
//                                       (models/tree.py _PK), UPDATED IN
//                                       PLACE;
//            fmask f32 [E, F]           the tree's feature mask;
//            aux   f32 [E, 8]           [leaf, feat, thr, active, 0...]: the
//                                       pick this iteration splits;
//            scal  f32 [E, 16]          [l1, l2, min_data, min_hess,
//                                       min_gain, max_delta_step,
//                                       path_smooth, max_depth, n_nodes, 0..]
//   outputs  table (the split leaf's row and the two children's rows
//            written when active, every other row untouched) and aux' (the
//            next pick).
//
// Per element: the cumulative-sum gain scan of both children, validity
// (min_data, min_hess, min_gain, feature mask, depth), the first-occurrence
// flat argmax over (feature, bin), the winner's statistics, the three row
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
//     a running sum inside each block of 16 bins, a running sum of the
//     block totals, and that sum of the preceding blocks added to every bin
//     (B > 16 only; B <= 256 keeps the block totals to one level);
//   * the gain follows split_gain_scan / leaf_objective_at /
//     constrained_leaf_output in their "kernel" rounding (ops/split.py) op
//     by op with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc
//     never contracts (the source is also built with -fmad=false); the two
//     fused multiply-adds of that rounding (path smoothing's
//     fma(w, f, parent*(1 - f)) for the stored outputs and
//     fma(parent, 1 - f, w*f) inside the gain, and the objective's
//     fma(Y, w, G*w)) are the plain version's fma(): the f32 product exact
//     in f64, one f64 add, one rounding to f32;
//   * the winner's statistics come out as the reference kernel gathers
//     them, a sum of where(hit, x, 0.0), so -0.0 comes out as +0.0;
//   * indices (node ids, features, bins) are exact in the f32 table.
//
// The design (the redesign; the first design ran one 256-thread block per
// element, each lane walking 16 bins in series through the gain, a serial
// re-gather of the winner, and a copy of the whole table per call):
//   1. a cluster of C blocks (C from E and F, kernels/split_iter.py
//      plan_split_iter: a small batch spreads over more SMs) shares an
//      element; each block takes a contiguous share of its 2F (child,
//      feature) pairs and copies their histograms into shared memory;
//   2. lanes (pair, block of 16 bins) replace each bin by its running sum
//      inside the block, the same adds in the same order;
//   3. a thread per pair scans the block totals (B > 16) and scores the
//      pair's parent objective;
//   4. a thread per (pair, bin) scores its bin from the stored prefixes: the
//      16- to 64-deep chains of divisions become parallel work; each thread
//      keeps its best (gain, flat index) per child, a shuffle tree and the
//      block reduce them (the first-occurrence argmax is associative); the
//      block's winner's statistics are its stored prefixes (the same adds
//      as the reference's gather), so nothing is re-gathered;
//   5. the cluster's first block reads every block's winners through
//      distributed shared memory (a thread per (child, block)), reduces
//      them in block order, writes the three rows into the table in place
//      (the only caller, the strict grower, drops the old table) and makes
//      the next pick from the rows it read ahead at the start, with the
//      children's new values, each candidate carrying its feature and bin.
//
// What bounds it on the H100: latency, not bytes.  Per element it reads
// the two histograms (2 x F x B x 3 floats: 36.9 KB at F = 6, 172 KB at
// F = 28, B = 256), the leaf's row and four columns of the table, and
// writes three rows and aux: at E = 40, F = 6 about 1.5 MB, 0.5 us at
// 3.35 TB/s.  The arithmetic is a few dozen flops per (child, feature,
// bin).  What is left is a chain of dependent steps: the launch (an empty
// kernel alone takes about 2.3 us), the loads of aux, then the leaf's row,
// then the histograms, the two 16-deep running sums, five block barriers
// and two cluster barriers, the reductions and the writes; without the
// scoring the kernel is only about 10 % faster (PERF.md).
//
// Plain C interface, bound with ctypes by kernels/split_iter.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace si {

// the packed table's columns (models/tree.py _PK)
enum Col {
  SPLIT_FEAT = 0, SPLIT_BIN = 1, LEFT = 2, RIGHT = 3, LEAF_VALUE = 4,
  IS_LEAF = 5, COUNT = 6, SPLIT_GAIN = 7, DEPTH = 8, CAND_GAIN = 9,
  CAND_FEAT = 10, CAND_BIN = 11, CAND_LG = 12, CAND_LH = 13, CAND_LC = 14,
  CAND_RG = 15, CAND_RH = 16, CAND_RC = 17, CAND_WL = 18, CAND_WR = 19,
  BOUND_LO = 20, BOUND_HI = 21, CAND_CAT = 22, PM = 23, NC = 24
};

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;
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


// one child's best split as a block found it
struct Winner {
  float g;
  int i;
  float w[10];   // feat, bin, lg, lh, lc, rg, rh, rc, wl, wr
};

__global__ void __launch_bounds__(kThreads)
split_iter_kernel(const float* __restrict__ hist, float* __restrict__ table,
                  const float* __restrict__ fmask,
                  const float* __restrict__ aux,
                  const float* __restrict__ scal, int F, int B, int cap,
                  int pairs_per_block, int chunk,
                  float* __restrict__ out_aux) {
  extern __shared__ float smem[];
  const int nb = (B + kBlk - 1) / kBlk;
  const int P = chunk;
  float* s_run = smem;                          // [P, B, 3]
  float* s_before = s_run + P * B * 3;          // [P, nb, 3]
  float* s_total = s_before + P * nb * 3;       // [P, 3]
  float* s_pobj = s_total + P * 3;              // [P]
  __shared__ float s_row[NC];
  __shared__ float s_red_g[2][kWarps];
  __shared__ int s_red_i[2][kWarps];
  __shared__ Winner s_win[2];
  __shared__ Winner s_all[2][kMaxCluster];
  __shared__ float s_pick_g[kWarps], s_pick_f[kWarps], s_pick_b[kWarps];
  __shared__ int s_pick_i[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int e = blockIdx.x / csize, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int first = rank * pairs_per_block;    // this block's pairs
  const int end = min(2 * F, first + pairs_per_block);
  float* T = table + (size_t)e * cap * NC;
  const float* sc = scal + (size_t)e * kScal;
  const Reg r{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6]};
  const float max_depth = sc[7];
  const int n_nodes = (int)sc[8];
  const float* ax = aux + (size_t)e * kAux;
  const int leaf = (int)ax[0];
  const bool active = ax[3] > 0.0f;
  const float* fm = fmask + (size_t)e * F;

  if (tid < NC) s_row[tid] = T[(size_t)leaf * NC + tid];
  // the pick's columns of one node per thread, read ahead (block 0)
  float pre_leaf = 0.0f, pre_gain = 0.0f, pre_feat = 0.0f, pre_bin = 0.0f;
  if (rank == 0 && tid < cap) {
    pre_leaf = T[(size_t)tid * NC + IS_LEAF];
    pre_gain = T[(size_t)tid * NC + CAND_GAIN];
    pre_feat = T[(size_t)tid * NC + CAND_FEAT];
    pre_bin = T[(size_t)tid * NC + CAND_BIN];
  }
  if (tid < 2) { s_win[tid].g = -INFINITY; s_win[tid].i = kNoIdx; }
  __syncthreads();
  const float child_depth = __fadd_rn(s_row[DEPTH], 1.0f);
  const bool depth_ok = (max_depth <= 0.0f) || (child_depth < max_depth);
  const float lo = s_row[BOUND_LO], hi = s_row[BOUND_HI];

  // the block's pairs in chunks that fit its shared memory (one chunk
  // unless F is large)
  for (int pair0 = first; pair0 < end; pair0 += P) {
  const int np = min(P, end - pair0);
  const float* H = hist + ((size_t)e * 2 * F + pair0) * B * 3;
  // 1. the chunk's histograms, contiguous, into shared memory
  __syncthreads();
  for (int i = tid; i < np * B * 3; i += kThreads) s_run[i] = H[i];
  __syncthreads();

  // 2. per (pair, block of 16 bins): the running sum inside the block,
  //    stored in place; the block's total (zero padding past B included)
  //    and, at bin B - 1, the pair's running sum there
  const int lanes = np * nb;
  for (int l = tid; l < lanes; l += kThreads) {
    const int blk = l % nb, p = l / nb;
    float* hp = s_run + (size_t)p * B * 3;
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
      if (b < B) {
        hp[b * 3 + 0] = a0; hp[b * 3 + 1] = a1; hp[b * 3 + 2] = a2;
      }
      if (b == B - 1) {
        s_total[p * 3 + 0] = a0;
        s_total[p * 3 + 1] = a1;
        s_total[p * 3 + 2] = a2;
      }
    }
    float* t = s_before + ((size_t)p * nb + blk) * 3;
    t[0] = a0; t[1] = a1; t[2] = a2;
  }
  __syncthreads();

  // 3. per pair: the running sum of the block totals, shifted into each
  //    block's "before" sum (0 for the first block), the pair's total = its
  //    cumulative sum at bin B - 1, and its parent objective
  for (int p = tid; p < np; p += kThreads) {
    if (nb > 1) {
      float inc[3] = {0.0f, 0.0f, 0.0f};
      for (int blk = 0; blk < nb; ++blk) {
        float* t = s_before + ((size_t)p * nb + blk) * 3;
        for (int s = 0; s < 3; ++s) {
          const float tot = t[s];
          t[s] = blk == 0 ? 0.0f : inc[s];
          inc[s] = blk == 0 ? tot : __fadd_rn(inc[s], tot);
        }
      }
      const float* last = s_before + ((size_t)p * nb + nb - 1) * 3;
      for (int s = 0; s < 3; ++s)
        s_total[p * 3 + s] = __fadd_rn(s_total[p * 3 + s], last[s]);
    }
    const int c = (pair0 + p) / F;
    s_pobj[p] = objective_at(s_row[c == 0 ? CAND_WL : CAND_WR],
                             s_total[p * 3 + 0], s_total[p * 3 + 1], r);
  }
  __syncthreads();

  // 4. the gain scan, a thread per (pair, bin); each thread keeps its best
  //    (gain, flat index) per child
  float best_g[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {kNoIdx, kNoIdx};
  for (int cell = tid; cell < np * B; cell += kThreads) {
    const int p = cell / B, b = cell - p * B;
    const int cf = pair0 + p;
    const int c = cf / F, f = cf - c * F;
    const float* run = s_run + (size_t)cell * 3;
    float lg = run[0], lh = run[1], lc = run[2];
    if (nb > 1) {
      const float* bf = s_before + ((size_t)p * nb + b / kBlk) * 3;
      lg = __fadd_rn(lg, bf[0]); lh = __fadd_rn(lh, bf[1]);
      lc = __fadd_rn(lc, bf[2]);
    }
    const float tg = s_total[p * 3 + 0], th = s_total[p * 3 + 1];
    const float tc = s_total[p * 3 + 2];
    const float p_out = s_row[c == 0 ? CAND_WL : CAND_WR];
    const float rg = __fsub_rn(tg, lg), rh = __fsub_rn(th, lh);
    const float rc = __fsub_rn(tc, lc);
    const float wl = constrained_out<true>(lg, lh, lc, r, lo, hi, p_out);
    const float wr = constrained_out<true>(rg, rh, rc, r, lo, hi, p_out);
    float gain = __fsub_rn(__fadd_rn(objective_at(wl, lg, lh, r),
                                     objective_at(wr, rg, rh, r)),
                           s_pobj[p]);
    const bool valid = lc >= r.min_data && rc >= r.min_data &&
                       lh >= r.min_hess && rh >= r.min_hess &&
                       gain > r.min_gain && fm[f] > 0.0f && depth_ok;
    if (!valid) gain = -INFINITY;
    const int idx = f * B + b;
    if (better(gain, idx, best_g[c], best_i[c])) {
      best_g[c] = gain;
      best_i[c] = idx;
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
    Winner& win = s_win[c];
    if (better(g, i, win.g, win.i)) {
      win.g = g;
      win.i = i;
      // the block's winner: its stored prefixes
      const int f = i / B, b = i - f * B;
      const int p = c * F + f - pair0;
      const float* run = s_run + ((size_t)p * B + b) * 3;
      float a0 = run[0], a1 = run[1], a2 = run[2];
      if (nb > 1) {
        const float* bf = s_before + ((size_t)p * nb + b / kBlk) * 3;
        a0 = __fadd_rn(a0, bf[0]); a1 = __fadd_rn(a1, bf[1]);
        a2 = __fadd_rn(a2, bf[2]);
      }
      const float tg = s_total[p * 3 + 0], th = s_total[p * 3 + 1];
      const float tc = s_total[p * 3 + 2];
      const float p_out = s_row[c == 0 ? CAND_WL : CAND_WR];
      const float rg = __fsub_rn(tg, a0), rh = __fsub_rn(th, a1);
      const float rc = __fsub_rn(tc, a2);
      float* w = win.w;
      w[0] = (float)f; w[1] = (float)b;
      w[2] = a0; w[3] = a1; w[4] = a2; w[5] = rg; w[6] = rh; w[7] = rc;
      w[8] = constrained_out(a0, a1, a2, r, lo, hi, p_out);
      w[9] = constrained_out(rg, rh, rc, r, lo, hi, p_out);
      for (int k = 2; k < 10; ++k) w[k] = __fadd_rn(w[k], 0.0f);  // -0 -> +0
    }
  }
  }  // chunks
  // 5. the cluster's first block takes every block's winners, a thread per
  //    (child, block), then reduces them in block order
  cluster.sync();
  if (rank == 0 && tid < 2 * kMaxCluster) {
    const int c = tid / kMaxCluster, q = tid % kMaxCluster;
    if (q < csize) s_all[c][q] = *cluster.map_shared_rank(&s_win[c], q);
  }
  cluster.sync();       // no block leaves while its winners may be read
  if (rank != 0) return;
  if (tid < 2) {
    const int c = tid;
    Winner best = s_all[c][0];
    for (int q = 1; q < csize; ++q) {
      if (better(s_all[c][q].g, s_all[c][q].i, best.g, best.i)) {
        best = s_all[c][q];
      }
    }
    s_win[c] = best;
  }
  __syncthreads();

  // the three row writes, in place
  if (active && tid < NC) {
    const int col = tid;
    float v = s_row[col];
    if (col == SPLIT_FEAT) v = s_row[CAND_FEAT];
    else if (col == SPLIT_BIN) v = s_row[CAND_BIN];
    else if (col == LEFT) v = (float)n_nodes;
    else if (col == RIGHT) v = (float)(n_nodes + 1);
    else if (col == IS_LEAF) v = 0.0f;
    else if (col == SPLIT_GAIN) v = s_row[CAND_GAIN];
    T[(size_t)leaf * NC + col] = v;
  } else if (active && tid >= 32 && tid < 32 + 2 * NC &&
             n_nodes + (tid - 32) / NC < cap) {
    const int c = (tid - 32) / NC, col = (tid - 32) % NC;
    const float* w = s_win[c].w;
    const float bg = s_win[c].g;
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
    T[(size_t)(n_nodes + c) * NC + col] = v;
  }

  // 6. the next pick over the updated table: the rows read ahead, with the
  //    two children's new values (the leaf row keeps its candidate
  //    columns), each candidate carrying its feature and bin, so nothing
  //    is read back after the writes
  float g = -INFINITY, gf = 0.0f, gb = 0.0f;
  int i = kNoIdx;
  for (int node = tid; node < cap; node += kThreads) {
    const bool ahead = node == tid;
    const float* row = T + (size_t)node * NC;
    float is_leaf = ahead ? pre_leaf : row[IS_LEAF];
    float gain = ahead ? pre_gain : row[CAND_GAIN];
    float feat = ahead ? pre_feat : row[CAND_FEAT];
    float bin = ahead ? pre_bin : row[CAND_BIN];
    if (active) {
      if (node == leaf) {
        is_leaf = 0.0f;
      } else if (node == n_nodes || node == n_nodes + 1) {
        const Winner& w = s_win[node - n_nodes];
        is_leaf = 1.0f;
        gain = w.g;
        feat = w.w[0];
        bin = w.w[1];
      }
    }
    const float gn = is_leaf > 0.5f ? gain : -INFINITY;
    if (better(gn, node, g, i)) { g = gn; i = node; gf = feat; gb = bin; }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const float g2 = __shfl_down_sync(0xffffffffu, g, d);
    const int i2 = __shfl_down_sync(0xffffffffu, i, d);
    const float f2 = __shfl_down_sync(0xffffffffu, gf, d);
    const float b2 = __shfl_down_sync(0xffffffffu, gb, d);
    if (better(g2, i2, g, i)) { g = g2; i = i2; gf = f2; gb = b2; }
  }
  if (lane == 0) {
    s_pick_g[warp] = g; s_pick_i[warp] = i;
    s_pick_f[warp] = gf; s_pick_b[warp] = gb;
  }
  __syncthreads();
  if (tid == 0) {
    g = s_pick_g[0];
    i = s_pick_i[0];
    gf = s_pick_f[0];
    gb = s_pick_b[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_pick_g[w], s_pick_i[w], g, i)) {
        g = s_pick_g[w];
        i = s_pick_i[w];
        gf = s_pick_f[w];
        gb = s_pick_b[w];
      }
    }
    float* ao = out_aux + (size_t)e * kAux;
    ao[0] = (float)i;
    ao[1] = gf;
    ao[2] = gb;
    ao[3] = (active && isfinite(g)) ? 1.0f : 0.0f;
    for (int k = 4; k < kAux; ++k) ao[k] = 0.0f;
  }
}

inline size_t smem_bytes(int B, int chunk) {
  const int nb = (B + kBlk - 1) / kBlk;
  const size_t p = (size_t)chunk;
  return sizeof(float) * (p * B * 3 + p * nb * 3 + p * 3 + p);
}

}  // namespace si

extern "C" {

// cluster: blocks per element (1..8), each taking ceil(2F / cluster)
// (child, feature) pairs, chunk of them at a time; table is updated in place
int split_iter_launch(const void* hist, void* table, const void* fmask,
                      const void* aux, const void* scal, int E, int F, int B,
                      int cap, int cluster, int chunk, void* out_aux,
                      void* stream) {
  if (B < 1 || B > si::kMaxBins || cap < 1 || F < 1 || cluster < 1 ||
      cluster > si::kMaxCluster || cluster > 2 * F || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = (2 * F + cluster - 1) / cluster;
  const size_t smem = si::smem_bytes(B, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      si::split_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(E * cluster);
  cfg.blockDim = dim3(si::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, si::split_iter_kernel,
                           static_cast<const float*>(hist),
                           static_cast<float*>(table),
                           static_cast<const float*>(fmask),
                           static_cast<const float*>(aux),
                           static_cast<const float*>(scal), F, B, cap, per,
                           chunk, static_cast<float*>(out_aux));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* split_iter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int split_iter_table_columns() { return si::NC; }

int split_iter_max_cluster() { return si::kMaxCluster; }

long long split_iter_smem_bytes(int B, int chunk) {
  return (long long)si::smem_bytes(B, chunk);
}

}  // extern "C"
