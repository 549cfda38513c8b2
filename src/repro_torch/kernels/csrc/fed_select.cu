// fed_select: the F3AST per-round selection step in one launch (Alg. 1
// lines 4, 5 and 9), for sm_90a.
//
//   mask  = top-min(K_t, |avail|) clients by score, stable (score, id) order
//   new_r = (1 - beta) r + beta * mask                     (rate EMA)
//   w     = weight rule on the cohort (unbiased, unbiased_frozen, uniform,
//           fedavg)
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fed_select.py:
// _select_pallas (body _select_kernel) and _mask_pallas (body _mask_kernel).
// The oracle is repro_torch/kernels/ref.py (fed_select_ref,
// topk_threshold_mask), which is bitwise the JAX package's.
//
// What bounds it on the H100: bytes.  Each of the N clients needs its score
// and avail flag read and, for the full step, r and p read and mask, new_r
// and w written: 22 bytes a client, ~7 us at N = 2^20 over 3.35 TB/s.  The
// cut is four dependent radix passes, so what stands between a kernel and
// that bound is the cost of each dependency: this file pays one launch a
// call and nothing else (no memset, no second kernel).
//
// The cut is a threshold, not a sort.
//   1. Scores map to order-preserving uint32 keys (unavailable -> -1e30,
//      -0.0 canonicalised to +0.0, since the reference compares with > and
//      ==).  A thread holds the keys of 4 consecutive ids per tile of
//      4 x blockDim ids, read once (16-byte loads) and kept in registers.
//   2. thr, the k_eff-th largest key, comes from a radix select: four 8-bit
//      passes, each a histogram in shared memory (one atomic a key: on the
//      H100 that beats aggregating a warp's equal bins first, even with
//      heavy ties) from which a warp picks the digit.
//      The first pass counts |avail|, so k_eff = min(k, |avail|) is known at
//      the first pick.  k is read from device memory: no host sync.
//   3. mask = gt | (eq & tie_rank < k_eff - g), with g = #{key > thr}.
//      k_eff - g needs no count: it is the rank the select has left after
//      its last pick (each pick subtracts the keys above its digit).  Ties
//      are ranked in id order by a block scan of the threads' tie counts
//      (four tiles at once, packed in 16-bit fields of a 64-bit scan).
//      The EMA and the weights follow in the same pass; uniform and fedavg
//      first need |S| or the cohort's sum of p, reduced in a fixed order.
// Two paths, one source:
//   small (N <= kSmallMax): one block of up to 1024 threads; every key in
//      registers, every reduction in shared memory, no workspace.
//   large: one cooperative launch of one 1024-thread block per SM (as many
//      as the occupancy query allows and the data needs).  Each block owns
//      a contiguous range of ids; the passes merge the blocks' histograms
//      into a global one with atomics and a grid sync, after which every
//      block picks the digit itself.  In the last pass each block also
//      publishes its own histogram: its count in thr's bin is its tie count
//      (less its unavailable clients when thr is their key), so a tie's
//      rank adds the earlier blocks' counts with no further grid sync.
//      Block 0 zeroes the workspace's counters before the first of the
//      five grid syncs (six for uniform and fedavg): no memset launch.
//      Keys of the first kLargeCache tiles stay in registers; later tiles
//      are read again from L2 (scores + avail of N <= 2^23 fit in its
//      50 MB).
// Bit parity: the EMA is __fmaf_rn(1 - beta, r, beta * m), which is what
// the jitted reference computes; this file is compiled with --fmad=false so
// that nothing else is contracted, and divisions are __fdiv_rn.  The fedavg
// sum is taken in a fixed order (bitwise run to run, not the reference's
// order: rtol 1e-5).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;      // threads a block, at most
constexpr int kItems = 4;           // consecutive ids a thread holds a tile
constexpr int kSmallTiles = 4;      // small path: 16,384 keys in registers
constexpr int kLargeCache = 2;      // large path: tiles kept in registers
// The crossover: at and below it, the one-block path (chip_select_ablation
// times both paths around it: on the H100 the one block is the faster up to
// N = 8,192 and the two are level at 16,384).
constexpr int kSmallMax = 8192;
constexpr int kSmallCap = kThreads * kItems * kSmallTiles;

// Large-path workspace, in 32-bit words: a histogram per pass and |avail|
// (zeroed in the kernel), then per block its last-pass histogram and its
// count of unavailable clients (kPublished words), then per block its
// cohort size.
constexpr int kNAvail = 4 * 256;
constexpr int kZeroed = kNAvail + 1;
constexpr int kPublished = 256 + 1;

constexpr float kNeg = -1e30f;
constexpr float kRMin = 1e-3f;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kMaskOnly = 0, kUnbiased = 1, kUnbiasedFrozen = 2, kUniform = 3,
            kFedavg = 4 };

struct Params {
  const float* scores;
  const uint8_t* avail;
  const int* k_ptr;          // the budget in device memory, or null:
  int k_value;               // then this value
  const float* r;
  const float* p;
  const float* rw;
  uint8_t* mask;
  float* new_r;
  float* w;
  int n;
  float beta;
  float one_minus_beta;
  int mode;
  int tiles;                 // tiles of 4 x blockDim ids a block owns
  int vec;                   // every array aligned for 16- / 4-byte access
  uint32_t* ws;              // large path only
  float* ws_f;
};

__device__ __forceinline__ uint32_t order_key(float s, bool avail) {
  uint32_t u = __float_as_uint(avail ? s : kNeg);
  if (u == 0x80000000u) u = 0u;  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// First id of this thread's 4 in tile t of its block.
__device__ __forceinline__ int64_t first_id(const Params& a, int t) {
  return (static_cast<int64_t>(blockIdx.x) * a.tiles + t)
         * (kItems * blockDim.x) + kItems * threadIdx.x;
}

__device__ __forceinline__ bool whole(const Params& a, int64_t i0) {
  return a.vec && i0 + kItems <= a.n;
}

__device__ __forceinline__ void load4(const float* x, const Params& a,
                                      int64_t i0, float (&v)[kItems]) {
  if (whole(a, i0)) {
    const float4 f = *reinterpret_cast<const float4*>(x + i0);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = i0 + j < a.n ? x[i0 + j] : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* x, const Params& a, int64_t i0,
                                       const float (&v)[kItems]) {
  if (whole(a, i0)) {
    *reinterpret_cast<float4*>(x + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) if (i0 + j < a.n) x[i0 + j] = v[j];
  }
}

// The keys of this thread's 4 ids of tile t; bit j of *av: id j available.
__device__ __forceinline__ void load_keys(const Params& a, int t,
                                          uint32_t (&key)[kItems],
                                          uint32_t* av) {
  const int64_t i0 = first_id(a, t);
  float s[kItems];
  load4(a.scores, a, i0, s);
  uint32_t bytes = 0u;
  if (whole(a, i0)) {
    bytes = *reinterpret_cast<const uint32_t*>(a.avail + i0);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (i0 + j < a.n) bytes |= static_cast<uint32_t>(a.avail[i0 + j])
                                 << (8 * j);
  }
  *av = 0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool ok = ((bytes >> (8 * j)) & 0xFFu) != 0u;
    key[j] = order_key(s[j], ok);
    *av |= (ok ? 1u : 0u) << j;
  }
}

// The keys of the first kCache tiles, held in registers; later tiles are
// read again where they are needed.
template <int kCache>
struct Keys {
  uint32_t key[kCache][kItems];
  uint32_t av;

  __device__ void load(const Params& a) {
    av = 0u;
#pragma unroll
    for (int c = 0; c < kCache; ++c) {
      uint32_t bits = 0u;
      if (c < a.tiles) {
        load_keys(a, c, key[c], &bits);
      } else {
#pragma unroll
        for (int j = 0; j < kItems; ++j) key[c][j] = 0u;
      }
      av |= bits << (kItems * c);
    }
  }

  __device__ __forceinline__ void get(const Params& a, int t,
                                      uint32_t (&k)[kItems],
                                      uint32_t* bits) const {
    if (t >= kCache) {
      load_keys(a, t, k, bits);
      return;
    }
#pragma unroll
    for (int c = 0; c < kCache; ++c) {
      if (c == t) {
#pragma unroll
        for (int j = 0; j < kItems; ++j) k[j] = key[c][j];
        *bits = (av >> (kItems * c)) & 0xFu;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Block-wide primitives (every thread of the block calls them)
// ---------------------------------------------------------------------------

// Sum over the block in a fixed order (a warp tree, then a tree over the
// warps' sums); every thread gets the result.
template <typename T, typename Add>
__device__ T block_sum(T v, Add add) {
  __shared__ T sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(kFull, v, o));
  if (lane == 0) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T x = lane < nwarps ? sums[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = add(x, __shfl_down_sync(kFull, x, o));
    if (lane == 0) sums[0] = x;
  }
  __syncthreads();
  const T out = sums[0];
  __syncthreads();
  return out;
}

struct AddInt {
  template <typename T>
  __device__ __forceinline__ T operator()(T x, T y) const { return x + y; }
};
struct AddF32 {
  __device__ __forceinline__ float operator()(float x, float y) const {
    return __fadd_rn(x, y);
  }
};

// Exclusive scan over the block in thread order; *total gets the sum.
__device__ uint64_t block_exclusive_scan(uint64_t v, uint64_t* total) {
  __shared__ uint64_t sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  uint64_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint64_t x = lane < nwarps ? sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    sums[lane] = x;
  }
  __syncthreads();
  const uint64_t off = warp > 0 ? sums[warp - 1] : 0u;
  *total = sums[nwarps - 1];
  __syncthreads();
  return off + incl - v;
}

// Warp 0: the digit holding the k_rem-th largest key (1-based) among the
// 256 counts, counting from digit 255 down; ORs it into *prefix at `shift`
// and leaves the rank left within that digit in *k_rem_out.  Lane l looks
// at digits 255 - 8l down to 248 - 8l.  With k_rem == 0 it picks 255, so a
// cut of 0 keeps thr = 0xFFFFFFFF and selects nothing (as the reference).
__device__ void pick_digit(const uint32_t* hist, uint32_t k_rem, int shift,
                           uint32_t* prefix, uint32_t* k_rem_out) {
  const int lane = threadIdx.x & 31;
  const int top = 255 - 8 * lane;
  uint32_t h[8], c = 0u;                 // in registers: one load latency
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = hist[top - i];
    c += h[i];
  }
  uint32_t incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned hit = __ballot_sync(kFull, incl >= k_rem);
  if (lane == (hit ? __ffs(hit) - 1 : 31)) {
    uint32_t cum = incl - c;
    int i = 0;                           // the lane's last digit if no other
#pragma unroll
    for (; i < 7; ++i) {
      if (cum + h[i] >= k_rem) break;
      cum += h[i];
    }
    *prefix |= static_cast<uint32_t>(top - i) << shift;
    *k_rem_out = k_rem - cum;
  }
}

// ---------------------------------------------------------------------------
// The kernel: kGrid selects the cooperative large path
// ---------------------------------------------------------------------------

template <int kCache, bool kGrid>
__global__ void __launch_bounds__(kThreads)
fed_select_kernel(const Params a) {
  __shared__ uint32_t hist[256];
  __shared__ uint32_t s_prefix, s_krem, s_navail;
  __shared__ int s_k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid == 0) {
    s_k = a.k_ptr ? *a.k_ptr : a.k_value;   // read early, used at the pick
    s_prefix = 0u;
    s_navail = 0u;
  }
  Keys<kCache> keys;
  keys.load(a);
  uint32_t block_unavail = 0u;           // thread 0: this block's, for later

  // --- the radix select: thr = the k_eff-th largest key --------------------
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hmask = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    const uint32_t prefix = s_prefix;
    uint32_t n_avail = 0u;
    for (int t = 0; t < a.tiles; ++t) {
      uint32_t k[kItems], av;
      keys.get(a, t, k, &av);
      const int64_t i0 = first_id(a, t);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (i0 + j < a.n && (k[j] & hmask) == prefix)
          atomicAdd(&hist[(k[j] >> shift) & 0xFFu], 1u);
      n_avail += __popc(av);
    }
    if (pass == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        n_avail += __shfl_down_sync(kFull, n_avail, o);
      if (lane == 0 && n_avail) atomicAdd(&s_navail, n_avail);
    }
    __syncthreads();
    if constexpr (kGrid) {
      cg::grid_group grid = cg::this_grid();
      uint32_t* global_hist = a.ws + 256 * pass;
      if (pass == 0) {
        if (blockIdx.x == 0)
          for (int i = tid; i < kZeroed; i += blockDim.x) a.ws[i] = 0u;
        if (tid == 0) {
          const int64_t span = static_cast<int64_t>(a.tiles) * kItems
                               * blockDim.x;
          const int64_t left = a.n - blockIdx.x * span;
          block_unavail = static_cast<uint32_t>(
              left < 0 ? 0 : (left < span ? left : span)) - s_navail;
        }
        grid.sync();
      }
      if (pass == 3) {                   // published for the tie ranks
        uint32_t* mine = a.ws + kZeroed + kPublished * blockIdx.x;
        for (int i = tid; i < 256; i += blockDim.x) mine[i] = hist[i];
        if (tid == 0) mine[256] = block_unavail;
      }
      for (int i = tid; i < 256; i += blockDim.x)
        if (hist[i]) atomicAdd(&global_hist[i], hist[i]);
      if (pass == 0 && tid == 0 && s_navail) atomicAdd(&a.ws[kNAvail], s_navail);
      grid.sync();
      for (int i = tid; i < 256; i += blockDim.x)
        hist[i] = __ldcg(&global_hist[i]);
      if (pass == 0 && tid == 0) s_navail = __ldcg(&a.ws[kNAvail]);
      __syncthreads();
    }
    if (tid < 32) {
      uint32_t k_rem;
      if (pass == 0) {                   // k_eff = min(k, |avail|)
        const uint32_t kk = s_k > 0 ? static_cast<uint32_t>(s_k) : 0u;
        k_rem = kk < s_navail ? kk : s_navail;
      } else {
        k_rem = s_krem;
      }
      pick_digit(hist, k_rem, shift, &s_prefix, &s_krem);
    }
    __syncthreads();
  }
  const uint32_t thr = s_prefix;

  // k_eff - g: the rank left within thr's bin after the last pick
  const int quota = static_cast<int>(s_krem);
  uint32_t rank0 = 0u;        // available ties in the blocks before this one
  if constexpr (kGrid) {
    const uint32_t unavail_key = order_key(kNeg, false);
    uint32_t before = 0u;
    for (int b = tid; b < static_cast<int>(blockIdx.x); b += blockDim.x) {
      const uint32_t* row = a.ws + kZeroed + kPublished * b;
      before += __ldcg(&row[thr & 0xFFu])
                - (thr == unavail_key ? __ldcg(&row[256]) : 0u);
    }
    rank0 = block_sum(before, AddInt());
  }

  // --- mask, the EMA and the per-client weights ------------------------------
  uint32_t n_sel = 0u;
  float p_sel = 0.0f;
  for (int t0 = 0; t0 < a.tiles; t0 += 4) {
    // four tiles' tie counts in 16-bit fields: one scan ranks them all
    uint64_t packed = 0u;
    for (int t = t0; t < t0 + 4 && t < a.tiles; ++t) {
      uint32_t k[kItems], av, c = 0u;
      keys.get(a, t, k, &av);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        c += (((av >> j) & 1u) && k[j] == thr) ? 1u : 0u;
      packed |= static_cast<uint64_t>(c) << (16 * (t - t0));
    }
    uint64_t totals;
    const uint64_t mine = block_exclusive_scan(packed, &totals);
    for (int t = t0; t < t0 + 4 && t < a.tiles; ++t) {
      const int f = 16 * (t - t0);
      int rank = static_cast<int>(rank0 + ((mine >> f) & 0xFFFFu));
      rank0 += static_cast<uint32_t>((totals >> f) & 0xFFFFu);
      uint32_t k[kItems], av;
      keys.get(a, t, k, &av);
      const int64_t i0 = first_id(a, t);
      bool sel[kItems];
      uint32_t m4 = 0u;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const bool ok = (av >> j) & 1u;
        const bool is_eq = ok && k[j] == thr;
        sel[j] = ok && (k[j] > thr || (is_eq && rank < quota));
        rank += is_eq ? 1 : 0;
        m4 |= (sel[j] ? 1u : 0u) << (8 * j);
      }
      if (whole(a, i0)) {
        *reinterpret_cast<uint32_t*>(a.mask + i0) = m4;
      } else {
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          if (i0 + j < a.n) a.mask[i0 + j] = sel[j] ? 1 : 0;
      }
      if (a.mode == kMaskOnly) continue;
      float r[kItems], nr[kItems], pv[kItems], wv[kItems];
      load4(a.r, a, i0, r);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        nr[j] = __fmaf_rn(a.one_minus_beta, r[j],
                          __fmul_rn(a.beta, sel[j] ? 1.0f : 0.0f));
      store4(a.new_r, a, i0, nr);
      if (a.mode == kUniform) {
#pragma unroll
        for (int j = 0; j < kItems; ++j) n_sel += sel[j] ? 1u : 0u;
        continue;
      }
      load4(a.p, a, i0, pv);
      if (a.mode == kFedavg) {
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          if (sel[j] && i0 + j < a.n) p_sel = __fadd_rn(p_sel, pv[j]);
        continue;
      }
      if (a.mode == kUnbiasedFrozen) load4(a.rw, a, i0, nr);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        wv[j] = sel[j] ? __fdiv_rn(pv[j], fmaxf(nr[j], kRMin)) : 0.0f;
      store4(a.w, a, i0, wv);
    }
  }
  if (a.mode != kUniform && a.mode != kFedavg) return;

  // --- uniform / fedavg: |S| or the cohort's sum of p, then the weights -----
  n_sel = block_sum(n_sel, AddInt());
  p_sel = block_sum(p_sel, AddF32());
  if constexpr (kGrid) {
    cg::grid_group grid = cg::this_grid();
    uint32_t* block_sel = a.ws + kZeroed + kPublished * gridDim.x;
    if (tid == 0) {
      block_sel[blockIdx.x] = n_sel;
      a.ws_f[blockIdx.x] = p_sel;
    }
    grid.sync();
    uint32_t c = 0u;
    float s = 0.0f;
    for (int b = tid; b < static_cast<int>(gridDim.x); b += blockDim.x) {
      c += __ldcg(&block_sel[b]);
      s = __fadd_rn(s, __ldcg(&a.ws_f[b]));
    }
    n_sel = block_sum(c, AddInt());
    p_sel = block_sum(s, AddF32());
  }
  const float scale = a.mode == kUniform
      ? __fdiv_rn(1.0f, fmaxf(static_cast<float>(n_sel), 1.0f))
      : fmaxf(p_sel, 1e-12f);
  for (int t = 0; t < a.tiles; ++t) {
    const int64_t i0 = first_id(a, t);
    float pv[kItems], wv[kItems];
    if (a.mode == kFedavg) load4(a.p, a, i0, pv);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool sel = i0 + j < a.n && a.mask[i0 + j] != 0;
      wv[j] = !sel ? 0.0f
                   : (a.mode == kUniform ? scale : __fdiv_rn(pv[j], scale));
    }
    store4(a.w, a, i0, wv);
  }
}

// The cooperative path's grid: one block a co-resident slot, on every SM.
int large_grid_max() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fed_select_kernel<kLargeCache, true>, kThreads, 0)
        != cudaSuccess) return 0;
    blocks = sms * per_sm;
  }
  return blocks;
}

inline bool aligned(const void* x, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(x) & (to - 1)) == 0;
}

}  // namespace

extern "C" {

// The small path's largest N (the crossover), and the largest it can take.
int fed_select_small_max(void) { return kSmallMax; }
int fed_select_small_cap(void) { return kSmallCap; }

// Workspace the large path needs (the small one needs none): 32-bit words
// and floats; -1 if the device cannot be queried.
int fed_select_workspace_words(void) {
  const int blocks = large_grid_max();
  return blocks > 0 ? kZeroed + (kPublished + 1) * blocks : -1;
}
int fed_select_workspace_floats(void) {
  const int blocks = large_grid_max();
  return blocks > 0 ? blocks : -1;
}

// mode: 0 mask only, 1 unbiased, 2 unbiased_frozen, 3 uniform, 4 fedavg.
// k points to one int32 in device memory, or is null and k_value is the
// budget.  r/p/rw/new_r/w may be null where the mode does not read or
// write them; ws/ws_f may be null on the small path.  path: 0 by N (small
// at N <= fed_select_small_max()), 1 small (N <= fed_select_small_cap()),
// 2 large.  One launch; returns a cudaError_t.
int fed_select_launch(const float* scores, const uint8_t* avail, const int* k,
                      int k_value, const float* r, const float* p,
                      const float* rw, uint8_t* mask, float* new_r, float* w,
                      int n, float beta, float one_minus_beta, int mode,
                      uint32_t* ws, float* ws_f, int path, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || path < 0 || path > 2) return cudaErrorInvalidValue;
  const bool small = path == 1 || (path == 0 && n <= kSmallMax);
  if (small && n > kSmallCap) return cudaErrorInvalidValue;
  Params a{scores, avail, k, k_value, r, p, rw, mask, new_r, w, n, beta,
           one_minus_beta, mode, 0, 0, ws, ws_f};
  a.vec = aligned(scores, 16) && aligned(avail, 4) && aligned(mask, 4)
          && aligned(r, 16) && aligned(p, 16) && aligned(rw, 16)
          && aligned(new_r, 16) && aligned(w, 16);
  if (small) {
    int threads = (n + kItems - 1) / kItems;
    threads = threads < kThreads ? (threads + 31) / 32 * 32 : kThreads;
    a.tiles = (n + kItems * threads - 1) / (kItems * threads);
    fed_select_kernel<kSmallTiles, false><<<1, threads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int grid_max = large_grid_max();
  if (grid_max <= 0 || ws == nullptr || ws_f == nullptr)
    return cudaErrorInvalidValue;
  const int64_t tiles = (static_cast<int64_t>(n) + kItems * kThreads - 1)
                        / (kItems * kThreads);
  a.tiles = static_cast<int>((tiles + grid_max - 1) / grid_max);
  const int blocks = static_cast<int>((tiles + a.tiles - 1) / a.tiles);
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fed_select_kernel<kLargeCache, true>),
      dim3(blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
