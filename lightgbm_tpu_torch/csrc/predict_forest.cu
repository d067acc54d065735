// Forest prediction over binned rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/predict.py:predict_forest_pallas
// (body _forest_kernel): every row walks every tree of the window [t0, t1)
// of one class for at most depth_cap levels, compares its stored bin code
// with the node's threshold as integers (code <= thr goes left; a split
// feature outside [0, F) reads code 0), and sums leaf * scale_t over the
// trees in f32, one tree after another in tree order.  The caller
// (lightgbm_tpu_torch/kernels/predict.py) applies init + learning_rate * sum.
//
// The TPU kernel gathers through one-hot contractions over [Tc, Mp, R] and
// transposes the bins to [Fp, n] f32 because a TPU has no gather from VMEM.
// On the card the work is a pointer chase, and the design is about many
// chases in flight, few loads each, and tables read from L2 few times:
//
// - node records (kernels/predict.py:build_node_tables, built once per
//   ForestSoA and cached beside it): one 8-byte word per node slot.  A
//   slot the walk never leaves (a leaf or a dead slot) holds kLeafFlag and
//   its leaf * scale_t bits; any other holds the left child in bits
//   [0, 18), the right child in [18, 36), the threshold in [36, 44) and
//   the split feature in [44, 63) (kFeatNone: outside [0, F) whatever F
//   is).  A level of a walk is two dependent loads, the record and the
//   row's code, where the SoA tables took four, and the leaf's value comes
//   with its record.  Thresholds below 0 (always right) are stored as 255
//   with the right child in both fields; at or above 255 as 255.  A second
//   table, leaf * scale_t in f32 for every slot, serves walks cut short by
//   depth_cap.  Both are multiplied as the plain version multiplies.
// - a walk is one row through one tree.  The grid is row tiles x a cluster
//   of C <= 8 blocks; in round k block q walks every row of its tile
//   through `trees` trees from t0 + (k C + q) trees on, so n x W walks are
//   in flight (1.6 M at 16,384 rows and 100 trees; 100 at one row) and a
//   one-row launch waits for one tree's depth, not 100 serial walks.  A
//   thread takes walks w, w + threads, ...; lanes are consecutive rows of
//   one tree, so the top levels' records are one broadcast load.
// - a block stages its tile's codes ([rows, F] uint8) in shared memory
//   while they fit kStagedCodesLimit bytes, else reads them through L1;
//   and the first `prefix` slots of each of its trees (the top levels: the
//   layout is depth-major), one cp.async.bulk on an mbarrier for whole
//   trees, the next round's issued while this round is folded (a second
//   buffer, filled during the walks, was slower: PERF.md).  Deeper
//   slots are read with __ldg through L2, so a tree of any size walks; a
//   launch of whole trees takes an instance with no such branch.  The
//   forest is read from L2 once per tile, not once per 128 rows.
// - each walk's value goes to the shared memory of the block that owns its
//   row (the tile's rows are split among the cluster's blocks), through
//   distributed shared memory, once every block of the cluster has started
//   (a cluster barrier arrived at on entry and waited on after each
//   thread's first walk); after a cluster barrier each owner adds its
//   rows' values of every block in tree order with __fadd_rn.  No float
//   atomics: the sum rounds as forest_sums_plain (ops/predict.py) rounds,
//   bit for bit.
//
// What bounds it: device-memory bytes are small (n (F + 4) and the 8-byte
// records the walks reach, once).  The work is the node visits, two dependent shared-memory loads
// each, so the bound is the issue rate of those loads (one warp-wide load
// per clock per SM; random records conflict in the banks) and a warp's
// wait for its deepest lane; at small buckets the launch, the staging and
// one walk's depth.

// Launch contract: the C entry point launches on the given stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace pf {

constexpr int kMaxCluster = 8;
constexpr int kMaxThreads = 512;  // threads of a block at most
constexpr int kStagedCodesLimit = 32 * 1024;  // bytes of a staged code tile
constexpr size_t kSmemLimit = 232448;         // opt-in shared memory, bytes
constexpr int kSlotBits = 18;
constexpr unsigned long long kSlotMask = (1ull << kSlotBits) - 1;
constexpr int kThrShift = 36;
constexpr int kFeatShift = 44;
constexpr int kFeatNone = (1 << 19) - 1;
constexpr unsigned long long kLeafFlag = 1ull << 63;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one block: [codes rows*F u8, if staged] [values of
// the rows it owns, cluster*trees*ceil(rows/cluster) f32] [records
// trees*prefix u64] [mbarrier]; kernels/predict.py:smem_bytes mirrors it.
__host__ __device__ inline size_t codes_bytes(int rows, int F, int staged) {
  return staged ? align16(static_cast<size_t>(rows) * F) : 0;
}
__host__ __device__ inline size_t values_bytes(int rows, int trees,
                                               int cluster) {
  return align16(4 * static_cast<size_t>(cluster) * trees *
                 ((rows + cluster - 1) / cluster));
}
__host__ __device__ inline size_t records_bytes(int trees, int prefix) {
  return align16(8 * static_cast<size_t>(trees) * prefix);
}
__host__ __device__ inline size_t smem_bytes(int rows, int F, int trees,
                                             int prefix, int staged,
                                             int cluster) {
  return codes_bytes(rows, F, staged) + values_bytes(rows, trees, cluster) +
         records_bytes(trees, prefix) + 16;
}

struct Shape {
  long long n;
  int F, mp, t0, t1, depth_cap;
  int rows, trees, prefix;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// every thread of the cluster: arrive (no memory ordering) ...
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// ... and wait until every thread of every block has arrived
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

// kStagedCodes: the tile's codes sit in shared memory, else walks read
// them from global memory through L1.  kWhole: every slot of a block's
// trees is staged (prefix == mp), so no walk reads a record from L2.
template <bool kStagedCodes, bool kWhole>
__global__ void __launch_bounds__(kMaxThreads)
    forest_kernel(const uint8_t* __restrict__ bins,
                  const unsigned long long* __restrict__ rec,
                  const float* __restrict__ leafv, float* __restrict__ out,
                  Shape s) {
  // distributed shared memory is written only once every block of the
  // cluster has started: each thread arrives here and waits after its
  // first walk, before its first store to another block, so the barrier
  // overlaps the staging and that walk
  cluster_arrive_relaxed();
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int R = s.rows, F = s.F, mp = s.mp, G = s.trees, P = s.prefix;
  const long long row0 = static_cast<long long>(blockIdx.x / C) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R),
                                        s.n - row0));
  uint8_t* s_codes = smem;
  float* s_val =
      reinterpret_cast<float*>(smem + codes_bytes(R, F, kStagedCodes));
  unsigned long long* s_rec = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<unsigned char*>(s_val) + values_bytes(R, G, C));
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(s_rec) + records_bytes(G, P));
  const int tid = threadIdx.x, nth = blockDim.x;
  const int W = s.t1 - s.t0;
  const int rounds = W > 0 ? (W + C * G - 1) / (C * G) : 0;
  auto first = [&](int k, int rank) { return s.t0 + (k * C + rank) * G; };
  auto count = [&](int k, int rank) {
    return max(0, min(G, s.t1 - first(k, rank)));
  };
  // tid 0: the record prefixes of this block's trees of round k
  auto issue = [&](int k) {
    const int tn = count(k, q);
    if (P == 0 || tn == 0) return;
    const unsigned long long* src =
        rec + static_cast<size_t>(first(k, q)) * mp;
    const uint32_t bytes = 8u * static_cast<uint32_t>(P);
    mbar_expect(bar, bytes * static_cast<uint32_t>(tn));
    if (P == mp) {                      // whole trees: one contiguous copy
      bulk_copy(s_rec, src, bytes * static_cast<uint32_t>(tn), bar);
    } else {
      for (int j = 0; j < tn; ++j) {
        bulk_copy(s_rec + static_cast<size_t>(j) * P,
                  src + static_cast<size_t>(j) * mp, bytes, bar);
      }
    }
  };

  if (tid == 0 && P > 0) mbar_init(bar);
  __syncthreads();
  if (tid == 0 && rounds > 0) issue(0);
  const uint8_t* g_codes = bins + row0 * F;
  if (kStagedCodes) {
    const size_t nbytes = static_cast<size_t>(rows) * F;
    size_t done = 0;
    if ((reinterpret_cast<uintptr_t>(g_codes) & 15) == 0) {
      const size_t n16 = nbytes / 16;
      const uint4* src = reinterpret_cast<const uint4*>(g_codes);
      uint4* dst = reinterpret_cast<uint4*>(s_codes);
      for (size_t i = tid; i < n16; i += nth) dst[i] = __ldg(src + i);
      done = n16 * 16;
    }
    for (size_t i = done + tid; i < nbytes; i += nth) s_codes[i] = g_codes[i];
  }
  __syncthreads();

  const uint8_t* codes = kStagedCodes ? s_codes : g_codes;
  const int fcap = min(F, kFeatNone);
  // the tile's rows are split among the cluster's blocks: block q owns
  // rows [q per, q per + per) and holds their values of a round,
  // [cluster * trees][per] f32, tree i = rank * trees + j
  const int per = (rows + C - 1) / C;
  const bool owner = tid < per && q * per + tid < rows;
  float acc = 0.0f;
  uint32_t parity = 0;
  for (int k = 0; k < rounds; ++k) {
    const int tb = first(k, q), tn = count(k, q);
    if (P > 0 && tn > 0) {
      mbar_wait(bar, parity);
      parity ^= 1u;
    }
    // walk w = j rows + r is row r through tree tb + j: at most depth_cap
    // steps, ending at a leaf's record (which holds its value)
    auto walk = [&](int w) {
      const int j = w / rows, r = w - j * rows;
      const unsigned long long* srec = s_rec + static_cast<size_t>(j) * P;
      const unsigned long long* grec =
          rec + static_cast<size_t>(tb + j) * mp;
      const uint8_t* my = codes + static_cast<size_t>(r) * F;
      int node = 0;
      for (int d = 0; d < s.depth_cap; ++d) {
        const unsigned long long x =
            (kWhole || node < P) ? srec[node] : __ldg(grec + node);
        if (x & kLeafFlag) return __uint_as_float(static_cast<uint32_t>(x));
        const int f = static_cast<int>((x >> kFeatShift) & kFeatNone);
        int code = 0;
        if (f < fcap) code = kStagedCodes ? my[f] : __ldg(my + f);
        const int thr = static_cast<int>((x >> kThrShift) & 0xFFu);
        node = static_cast<int>(code <= thr ? (x & kSlotMask)
                                            : ((x >> kSlotBits) & kSlotMask));
      }
      // depth_cap steps taken: a walk cut short (or depth_cap 0)
      return __ldg(leafv + static_cast<size_t>(tb + j) * mp + node);
    };
    // its value goes to the owner of row r
    auto store = [&](int w, float v) {
      const int j = w / rows, r = w - j * rows;
      const int o = r / per;
      cluster.map_shared_rank(s_val, o)[(q * G + j) * per + r - o * per] = v;
    };
    const int walks = rows * tn;
    int w = tid;
    if (k == 0) {
      // each thread's first walk runs while the cluster barrier completes
      const float v = w < walks ? walk(w) : 0.0f;
      cluster_wait();
      if (w < walks) store(w, v);
      w += nth;
    }
    for (; w < walks; w += nth) store(w, walk(w));
    // every value of the round is with its owner, and this block's record
    // prefixes are consumed
    cluster.sync();
    if (tid == 0 && k + 1 < rounds) issue(k + 1);
    if (owner) {
      const float* v = s_val + tid;
      for (int i = 0; i < C * G; i += G) {
        const int nq = count(k, i / G);
        int j = 0;
        for (; j + 8 <= nq; j += 8) {  // eight loads in flight, then adds
          float b[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) b[u] = v[(i + j + u) * per];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, b[u]);
        }
        for (; j < nq; ++j) acc = __fadd_rn(acc, v[(i + j) * per]);
      }
    }
    // the values are added before the next round's land (no store follows
    // the last round's barrier)
    if (k + 1 < rounds) cluster.sync();
  }
  if (rounds == 0) cluster_wait();
  if (owner) out[row0 + q * per + tid] = acc;
}

constexpr int kCachedDevices = 16;

// One instance's launch.  The opt-in above 48 KB of shared memory is set
// once per device and size rather than at every launch (host time on the
// serving path).
template <bool kStagedCodes, bool kWhole>
cudaError_t launch_as(cudaLaunchConfig_t* cfg, const uint8_t* bins,
                      const unsigned long long* rec, const float* leafv,
                      float* out, Shape s) {
  static std::atomic<size_t> allowed[kCachedDevices];
  const size_t smem = cfg->dynamicSmemBytes;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const bool cached = dev >= 0 && dev < kCachedDevices;
    size_t cur = cached ? allowed[dev].load() : 0;
    if (smem > cur) {
      e = cudaFuncSetAttribute(forest_kernel<kStagedCodes, kWhole>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      while (cached && smem > cur &&
             !allowed[dev].compare_exchange_weak(cur, smem)) {
      }
    }
  }
  return cudaLaunchKernelEx(cfg, forest_kernel<kStagedCodes, kWhole>, bins,
                            rec, leafv, out, s);
}

}  // namespace pf

extern "C" {

// One launch over trees [t0, t1) of node records rec / leaf values leafv
// ([Tp, mp] each) for bins [n, F]; the plan (kernels/predict.py:plan) gives
// rows, cluster, trees, prefix, staged_codes and threads, and is checked
// here.
int predict_forest_launch(const void* bins, long long n, int F,
                          const void* rec, const void* leafv, int mp, int t0,
                          int t1, int depth_cap, int rows, int cluster,
                          int trees, int prefix, int staged_codes,
                          int threads, void* out, void* stream) {
  if (n < 1 || F < 1 || mp < 1 || mp > (1 << pf::kSlotBits) || t0 < 0 ||
      t1 < t0 || depth_cap < 0 || rows < 1 || cluster < 1 ||
      cluster > pf::kMaxCluster || trees < 1 || prefix < 0 ||
      prefix > mp || (prefix & 1) || (prefix > 0 && (mp & 1)) ||
      threads < 32 || threads > pf::kMaxThreads || threads % 32 != 0 ||
      (rows + cluster - 1) / cluster > threads ||
      (staged_codes &&
       static_cast<long long>(rows) * F > pf::kStagedCodesLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = pf::smem_bytes(rows, F, trees, prefix,
                                     staged_codes ? 1 : 0, cluster);
  if (smem > pf::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + rows - 1) / rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const pf::Shape s{n, F, mp, t0, t1, depth_cap, rows, trees, prefix};
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* r = static_cast<const unsigned long long*>(rec);
  const auto* l = static_cast<const float*>(leafv);
  auto* o = static_cast<float*>(out);
  const bool whole = prefix == mp;
  const cudaError_t err =
      staged_codes
          ? (whole ? pf::launch_as<true, true>(&cfg, b, r, l, o, s)
                   : pf::launch_as<true, false>(&cfg, b, r, l, o, s))
          : (whole ? pf::launch_as<false, true>(&cfg, b, r, l, o, s)
                   : pf::launch_as<false, false>(&cfg, b, r, l, o, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

long long predict_forest_smem_bytes(int rows, int F, int trees, int prefix,
                                    int staged_codes, int cluster) {
  return static_cast<long long>(pf::smem_bytes(
      rows, F, trees, prefix, staged_codes ? 1 : 0, cluster));
}

// the constants kernels/predict.py mirrors, in this order
int predict_forest_constant(int which) {
  switch (which) {
    case 0: return pf::kMaxCluster;
    case 1: return pf::kMaxThreads;
    case 2: return pf::kStagedCodesLimit;
    case 3: return static_cast<int>(pf::kSmemLimit);
    case 4: return pf::kSlotBits;
    case 5: return pf::kThrShift;
    case 6: return pf::kFeatShift;
    case 7: return pf::kFeatNone;
    default: return -1;
  }
}

const char* predict_forest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
