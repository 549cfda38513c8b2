// fed_select: the F3AST per-round selection step in one call (Alg. 1
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
// and w written: 22 bytes per client, ~7 us at N = 2^20 over 3.35 TB/s.  At
// the main path's N = 100 it is bound by its ~13 launches instead.
//
// Design.  The TPU kernel sorts the whole client axis in one VMEM block with
// a bitonic network.  Nothing here needs a sort: the cut is a threshold.
//   1. Scores map to order-preserving uint32 keys (unavailable -> -1e30,
//      -0.0 canonicalised to +0.0, since the reference compares with > and
//      ==).  Keys are recomputed from the scores on each pass, never stored.
//   2. thr, the k_eff-th largest key, comes from a radix select: four 8-bit
//      passes, each a grid-stride histogram in shared memory merged into
//      global memory with atomics, then a one-block pick of the digit.  The
//      first pass also counts |avail|, so k_eff = min(k, |avail|) is known
//      at the first pick.  k is read from device memory: no host sync.
//   3. g = #{key > thr} and per-tile tie counts, one block per tile of 1024
//      consecutive ids; a one-block scan turns tie counts into offsets.
//   4. The final pass recomputes keys, ranks ties in id order (block scan +
//      tile offset) and writes mask = gt | (eq & tie_rank < k_eff - g),
//      then the EMA and the weights elementwise.  uniform and fedavg need
//      |S| or the cohort's sum of p: per-tile partials, a one-block
//      reduction in a fixed order, and an elementwise weights pass.
// Bit parity: the EMA is __fmaf_rn(1 - beta, r, beta * m), which is what
// the jitted reference computes; this file is compiled with --fmad=false so
// that nothing else is contracted, and divisions are __fdiv_rn.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kHistBlocksMax = 132 * 8;
constexpr int kScanThreads = 1024;

// Workspace layout, in 32-bit words.
constexpr int kNAvail = 0;
constexpr int kKEff = 1;
constexpr int kKRem = 2;
constexpr int kPrefix = 3;
constexpr int kGt = 4;
constexpr int kNSel = 5;
constexpr int kHist = 8;
constexpr int kHeader = kHist + 256;  // then nblk tie counts, nblk cohort counts

constexpr float kNeg = -1e30f;
constexpr float kRMin = 1e-3f;

enum Mode { kMaskOnly = 0, kUnbiased = 1, kUnbiasedFrozen = 2, kUniform = 3,
            kFedavg = 4 };

__device__ __forceinline__ uint32_t order_key(float s, bool avail) {
  uint32_t u = __float_as_uint(avail ? s : kNeg);
  if (u == 0x80000000u) u = 0u;  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Exclusive block scan of one value per thread; *total gets the block sum.
// Must be called by every thread of the block.
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  uint32_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t x = lane < nwarps ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    warp_sums[lane] = x;
  }
  __syncthreads();
  const uint32_t off = warp > 0 ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return off + incl - v;
}

// Block sum of a float in a fixed order (thread 0 gets the result).
__device__ float block_sum_f32(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (warp == 0) {
    s = lane < nwarps ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
  }
  __syncthreads();
  return s;
}

// One radix pass: histogram of the digit at `shift` over the keys whose
// higher digits equal the prefix picked so far.  The first pass also counts
// the available clients.
__global__ void hist_kernel(const float* __restrict__ scores,
                            const uint8_t* __restrict__ avail, int n,
                            uint32_t* ws, int shift, int first) {
  __shared__ uint32_t h[256];
  __shared__ uint32_t n_avail;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0u;
  if (threadIdx.x == 0) n_avail = 0u;
  __syncthreads();
  const uint32_t hmask = shift >= 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
  const uint32_t prefix = ws[kPrefix] & hmask;
  uint32_t mine = 0u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const bool a = avail[i] != 0;
    mine += a ? 1u : 0u;
    const uint32_t key = order_key(scores[i], a);
    if ((key & hmask) == prefix) atomicAdd(&h[(key >> shift) & 0xFFu], 1u);
  }
  if (first) {
    for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, o);
    if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&n_avail, mine);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (h[i]) atomicAdd(&ws[kHist + i], h[i]);
  if (first && threadIdx.x == 0 && n_avail) atomicAdd(&ws[kNAvail], n_avail);
}

// Pick the digit holding the k_rem-th largest key; clear the histogram.
// With k_eff == 0 every pick takes digit 255, so thr = 0xFFFFFFFF and the
// final pass selects nothing (as the reference does).
__global__ void pick_kernel(uint32_t* ws, const int* __restrict__ k_ptr,
                            int shift) {
  __shared__ uint32_t h[256];
  const int t = threadIdx.x;
  h[t] = ws[kHist + t];
  ws[kHist + t] = 0u;
  __syncthreads();
  if (t != 0) return;
  uint32_t k_rem;
  if (shift == 24) {
    const int k = *k_ptr;
    const uint32_t kk = k > 0 ? static_cast<uint32_t>(k) : 0u;
    k_rem = kk < ws[kNAvail] ? kk : ws[kNAvail];
    ws[kKEff] = k_rem;
  } else {
    k_rem = ws[kKRem];
  }
  uint32_t cum = 0u;
  int d = 255;
  for (; d > 0; --d) {
    if (cum + h[d] >= k_rem) break;
    cum += h[d];
  }
  ws[kPrefix] |= static_cast<uint32_t>(d) << shift;
  ws[kKRem] = k_rem - cum;
}

// g = #{key > thr} over all lanes, and each tile's count of available ties.
__global__ void count_kernel(const float* __restrict__ scores,
                             const uint8_t* __restrict__ avail, int n,
                             uint32_t* ws) {
  const uint32_t thr = ws[kPrefix];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  uint32_t gt = 0u, eq = 0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i < n) {
      const bool a = avail[i] != 0;
      const uint32_t key = order_key(scores[i], a);
      gt += key > thr ? 1u : 0u;
      eq += (key == thr && a) ? 1u : 0u;
    }
  }
  uint32_t gt_total, eq_total;
  block_exclusive_scan(gt, &gt_total);
  block_exclusive_scan(eq, &eq_total);
  if (threadIdx.x == 0) {
    if (gt_total) atomicAdd(&ws[kGt], gt_total);
    ws[kHeader + blockIdx.x] = eq_total;
  }
}

// Exclusive scan of the per-tile tie counts, in place (one block).
__global__ void scan_kernel(uint32_t* ws, int nblk) {
  uint32_t carry = 0u;
  for (int lo = 0; lo < nblk; lo += blockDim.x) {
    const int i = lo + threadIdx.x;
    const uint32_t v = i < nblk ? ws[kHeader + i] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive_scan(v, &total);
    if (i < nblk) ws[kHeader + i] = carry + ex;
    carry += total;
  }
}

__global__ void final_kernel(const float* __restrict__ scores,
                             const uint8_t* __restrict__ avail,
                             const float* __restrict__ r,
                             const float* __restrict__ p,
                             const float* __restrict__ rw,
                             uint8_t* __restrict__ mask,
                             float* __restrict__ new_r,
                             float* __restrict__ w, int n, float beta,
                             float one_minus_beta, int mode, uint32_t* ws,
                             float* ws_f, int nblk) {
  const uint32_t thr = ws[kPrefix];
  const int quota = static_cast<int>(ws[kKEff]) - static_cast<int>(ws[kGt]);
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  uint32_t key[kItems];
  bool av[kItems];
  uint32_t eq = 0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    av[j] = i < n && avail[i] != 0;
    key[j] = i < n ? order_key(scores[i], av[j]) : 0u;
    eq += (i < n && av[j] && key[j] == thr) ? 1u : 0u;
  }
  uint32_t tile_ties;
  int rank = static_cast<int>(ws[kHeader + blockIdx.x]
                              + block_exclusive_scan(eq, &tile_ties));
  uint32_t n_sel = 0u;
  float p_sel = 0.0f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i >= n) continue;
    const bool is_eq = av[j] && key[j] == thr;
    const bool sel = av[j] && (key[j] > thr || (is_eq && rank < quota));
    if (is_eq) ++rank;
    mask[i] = sel ? 1 : 0;
    if (mode == kMaskOnly) continue;
    const float m = sel ? 1.0f : 0.0f;
    const float nr = __fmaf_rn(one_minus_beta, r[i], __fmul_rn(beta, m));
    new_r[i] = nr;
    if (mode == kUnbiased) {
      w[i] = sel ? __fdiv_rn(p[i], fmaxf(nr, kRMin)) : 0.0f;
    } else if (mode == kUnbiasedFrozen) {
      w[i] = sel ? __fdiv_rn(p[i], fmaxf(rw[i], kRMin)) : 0.0f;
    } else if (sel) {
      n_sel += 1u;
      p_sel = __fadd_rn(p_sel, p[i]);
    }
  }
  if (mode == kUniform || mode == kFedavg) {
    uint32_t sel_total;
    block_exclusive_scan(n_sel, &sel_total);
    const float p_total = block_sum_f32(p_sel);
    if (threadIdx.x == 0) {
      ws[kHeader + nblk + blockIdx.x] = sel_total;
      ws_f[blockIdx.x] = p_total;
    }
  }
}

// |S| and the cohort's sum of p from the per-tile partials, in a fixed
// order (one block): thread t sums tiles t, t + 1024, ... then a tree.
__global__ void reduce_kernel(uint32_t* ws, float* ws_f, int nblk) {
  uint32_t c = 0u;
  float s = 0.0f;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
    c += ws[kHeader + nblk + i];
    s = __fadd_rn(s, ws_f[i]);
  }
  uint32_t c_total;
  block_exclusive_scan(c, &c_total);
  const float s_total = block_sum_f32(s);
  if (threadIdx.x == 0) {
    ws[kNSel] = c_total;
    ws_f[nblk] = s_total;
  }
}

__global__ void weights_kernel(const uint8_t* __restrict__ mask,
                               const float* __restrict__ p,
                               float* __restrict__ w, int n, int mode,
                               const uint32_t* ws, const float* ws_f,
                               int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool sel = mask[i] != 0;
  if (mode == kUniform) {
    const float count = static_cast<float>(ws[kNSel]);
    w[i] = sel ? __fdiv_rn(1.0f, fmaxf(count, 1.0f)) : 0.0f;
  } else {
    w[i] = sel ? __fdiv_rn(p[i], fmaxf(ws_f[nblk], 1e-12f)) : 0.0f;
  }
}

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// Workspace sizes the wrapper allocates: 32-bit words and floats.
int fed_select_workspace_words(int n) { return kHeader + 2 * num_tiles(n); }
int fed_select_workspace_floats(int n) { return num_tiles(n) + 1; }

// mode: 0 mask only, 1 unbiased, 2 unbiased_frozen, 3 uniform, 4 fedavg.
// k points to one int32 in device memory.  r/p/rw/new_r/w may be null where
// the mode does not read or write them.  Returns a cudaError_t.
int fed_select_launch(const float* scores, const uint8_t* avail, const int* k,
                      const float* r, const float* p, const float* rw,
                      uint8_t* mask, float* new_r, float* w, int n,
                      float beta, float one_minus_beta, int mode,
                      uint32_t* ws, float* ws_f, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nblk = num_tiles(n);
  cudaError_t err = cudaMemsetAsync(ws, 0, kHeader * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int hist_blocks = (n + kThreads - 1) / kThreads;
  if (hist_blocks > kHistBlocksMax) hist_blocks = kHistBlocksMax;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    hist_kernel<<<hist_blocks, kThreads, 0, stream>>>(scores, avail, n, ws,
                                                       shift, pass == 0);
    pick_kernel<<<1, 256, 0, stream>>>(ws, k, shift);
  }
  count_kernel<<<nblk, kThreads, 0, stream>>>(scores, avail, n, ws);
  scan_kernel<<<1, kScanThreads, 0, stream>>>(ws, nblk);
  final_kernel<<<nblk, kThreads, 0, stream>>>(scores, avail, r, p, rw, mask,
                                              new_r, w, n, beta,
                                              one_minus_beta, mode, ws, ws_f,
                                              nblk);
  if (mode == kUniform || mode == kFedavg) {
    reduce_kernel<<<1, kScanThreads, 0, stream>>>(ws, ws_f, nblk);
    weights_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        mask, p, w, n, mode, ws, ws_f, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
