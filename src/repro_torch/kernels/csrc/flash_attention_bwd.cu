// flash_attention_bwd: the gradient of flash_attention (dQ, dK, dV), for
// sm_90a.
//
// With s[i, j] = cap(q_i . k_j / sqrt(hd)) (cap(x) = softcap tanh(x /
// softcap) when softcap > 0), the forward's row log-sum-exp lse_i and its
// output o, the FlashAttention-2 backward is
//
//   P = exp(s - lse) (0 where masked),   D_i = sum_d do[i, d] o[i, d],
//   dV_j = sum_i P[i, j] do_i,           dP[i, j] = do_i . v_j,
//   dS = P (dP - D) (1 - tanh^2 under the cap) / sqrt(hd),
//   dQ_i = sum_j dS[i, j] k_j,           dK_j = sum_i dS[i, j] q_i,
//
// dK and dV summed over the G = H / KV query heads that share a KV head.
// q, k, v, o and do are float32 or bf16; every sum is float32; dq, dk and
// dv are written in the inputs' dtype.  The masks are the forward's (causal
// j <= i, window j > i - window, ragged edges), on positions counted from 0
// in q and in k.
//
// Replaces no Pallas kernel: the TPU kernel of src/repro/kernels/
// flash_attention.py:77 has no backward, and the JAX package trains by
// jax.grad of the pure-jnp sdpa (src/repro/models/layers.py:157).  The port
// computes that gradient here, since its attention on the card is the
// forward kernel.  The oracle is repro_torch/kernels/ref.py::sdpa_bwd.
//
// What bounds it on the H100: operations.  At llama3.2-1b's training layer
// (B = 1, S = 4096, H = 32, KV = 8, hd = 64, causal) the gradient needs
// five products of 2 H hd S (S + 1) / 2 flops each, 172 GFLOP, on 42 MB:
// the least time is 0.174 ms at the bf16 tensor-core rate.
//
// Three passes, no atomics, so two runs give the same bits.  FlashAttention-
// 2's single pass adds dQ across key tiles with float32 atomics, whose order
// changes from run to run; a dQ buffer per key tile would take gigabytes at
// S = 4096.  A second pass costs two products (S and dP formed again), not
// an order of summation.  Two routes, chosen in flash_attention_bwd_launch
// by dtype; both first run flash_bwd_delta: D, one warp a (position, head).
//
// * bf16: the tensor cores (namespace tc), mma.sync m16n8k16 with bf16
//   operands and float32 sums, 4 warps a block.  Tiles are bf16 in the
//   forward's XOR-swizzled shared-memory layout, staged by 16-byte cp.async
//   copies (zero-filled past the ends) and double-buffered, so the next
//   tile is in flight while the block computes; ldmatrix (.trans) reads
//   them.  Scores never leave registers: the m16n8k16 C layout is its A
//   layout, so P and dS go from the score accumulators straight into the
//   gradient products, as the forward's P does.
//   - flash_bwd_dkdv_mma: one block a (64 keys, KV head, batch), 16 keys a
//     warp.  K and V are staged once (held as A fragments at hd <= 64).  A
//     loop over the G heads of the group and the 64-query tiles that can
//     see these keys (Q, dO, lse and D double-buffered) forms the
//     transposed scores S^T = K Q^T and dP^T = V dO^T of 16 queries at a
//     time, then P^T and dS^T, and adds dV += P^T dO, dK += dS^T Q with dO
//     and Q read by ldmatrix.trans.  dK and dV stay float32 in registers
//     and are written once.  At hd 256 those would be 256 registers a
//     thread, so there the hd columns are split between two blocks, each
//     forming the same scores (kParts).
//   - flash_bwd_dq_mma: the forward's block, 64 rows of (position, query
//     head of the group) taken position-major, one KV head, the longest
//     rows first; Q and dO held as A fragments at hd <= 128 (read from
//     shared memory at hd 256); K and V double-buffered.  S = Q K^T and
//     dP = dO V^T of 16 keys at a time, dS, and dQ += dS K with K read by
//     ldmatrix.trans, as the forward reads V.
//   Why P and dS are split: the gradient products take bf16 operands, and
//   rounding P and dS to bf16 once (the usual tensor-core design) moves
//   3.5-7.1% of the dV, dK and dQ lanes at llama's layer by more than one
//   bf16 step from the plain version, which rounds one float32 result
//   once (chip_flash_bwd_ablation.py, variant no_lo); the port holds every
//   bf16 lane within that step (tests/test_torch_flash_bwd_split.py
//   emulates both).  So each is split into hi = bf16(x) and lo = bf16(x -
//   hi), carried to ~2^-17 of itself, and both halves are multiplied: ten
//   products in place of the five the gradient needs.
//   The sums: the tensor cores add in float32 with truncation, so a sum
//   of thousands of steps kept in the mma accumulator drifts one way.  At
//   llama's layer that put one lane of dV past the one-step limit, and
//   without the causal mask three of dK and one of dV, with 0.4-1.7% of
//   the lanes off the correctly rounded gradient (the plain version's
//   float32 sums: 0.07-0.12%).  So each hi + lo pair of products is summed
//   by the tensor cores from zero, one m16n8k16 tile at a time, and added
//   to the float32 total by the float32 unit, which rounds to nearest
//   (mma_split_add): no lane past the limit, 0.25% off
//   (chip_flash_bwd_ablation.py, variant in_accumulator).  exp is the
//   forward's ex2.approx (exp_sfu); the soft-cap and the mask each sit in
//   a branch around a whole loop, and steps that the mask hides from a
//   whole warp are skipped.  What keeps it from the bound: the ten
//   products, mma.sync itself (Hopper's full rate needs wgmma) and the
//   scalar work on each score between the products.
//   Tiles: 4 warps a block, 16 keys (dK/dV) or 16 fold rows (dQ) a warp,
//   score steps of 16; ptxas (-Xptxas -v, sm_90a) gives dkdv_mma / dq_mma
//   107 / 88 registers at hd 16, 154 / 114 at 32, 242 / 166 at 64 (no
//   spill), 255 / 254 at 128 (4 bytes spilled by dkdv), 255 / 255 at 256
//   (4 and 16 bytes spilled); shared memory 13, 25, 49, 97 and 193 KB a
//   dkdv block, 12, 24, 48, 96 and 192 KB a dq block.  (Steps of 32:
//   chip_flash_bwd_ablation.py, variant steps32.)
// * float32: the CUDA cores (flash_bwd_dkdv, flash_bwd_dq); TF32 would not
//   hold the float32 limit (1e-5 of the largest gradient).  dkdv: one block
//   a (tile of BK keys, KV head, batch).  K and V are staged once; a loop
//   over the group's G query heads and, inside, over the tiles of BQ query
//   positions that can see these keys forms S and dP for the (BQ x BK)
//   tile, then P and dS, and adds P^T do and dS^T q into dV and dK held in
//   registers.  dq: one block a (tile of BQ positions, query head, batch),
//   the longest rows first; a loop over the key tiles the rows can see
//   forms S, dP and dS again and adds dS k into dQ: seven products.
//   Tiles are float32 in shared memory, rows padded by 4 floats so that
//   16-byte reads of 8 different rows fall in 8 different bank groups.  S
//   and dP: each thread holds (BQ / 16) x (BK / 16) scores of a 16 x 16
//   thread grid, contracted over hd in 16-byte steps.  dV, dK and dQ: each
//   thread holds 4 adjacent columns of a few rows; the tile's P or dS is
//   read one scalar per row and the operand rows 16 bytes at a time.  The
//   tiles per head dim (Tiles below) keep each block at or under 112 KB of
//   shared memory and 128 registers a thread, so two blocks fit on an SM;
//   at hd = 256 a dK/dV block takes 16 keys and a query tile 32 positions.
//   It runs at up to 67 TFLOP/s, far from the bf16 bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const void* q; const void* k; const void* v; const void* o;
  const void* dout;
  const float* lse;                  // (B, H, Sq)
  float* delta;                      // (B, H, Sq), written by pass 1
  void* dq; void* dk; void* dv;      // contiguous, the inputs' dtype
  int Sq, Skv, H, KV, G;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// BK keys a dK/dV block, BQ query positions a tile.
template <int HD> struct Tiles;
template <> struct Tiles<16> { static constexpr int BK = 64, BQ = 64; };
template <> struct Tiles<32> { static constexpr int BK = 64, BQ = 64; };
template <> struct Tiles<64> { static constexpr int BK = 64, BQ = 64; };
template <> struct Tiles<128> { static constexpr int BK = 32, BQ = 32; };
template <> struct Tiles<256> { static constexpr int BK = 16, BQ = 32; };

template <int HD>
constexpr int kLdh = HD + 4;         // a staged row of hd floats

// ---------------------------------------------------------------------------
// Pass 1: D = rowsum(do * o)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const Args a, int64_t rows, int hd) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32)
                      + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;           // whole warps leave together
  // row = (b * Sq + i) * H + h of the contiguous (B, Sq, H, hd) o and do
  const T* o = static_cast<const T*>(a.o) + row * hd;
  const T* d = static_cast<const T*>(a.dout) + row * hd;
  float acc = 0.0f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(ld(o + c), ld(d + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % a.H);
    const int64_t bi = row / a.H;
    const int i = static_cast<int>(bi % a.Sq);
    const int64_t b = bi / a.Sq;
    a.delta[(b * a.H + h) * a.Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// Shared pieces of passes 2 and 3
// ---------------------------------------------------------------------------

// Rows [r0, r0 + R) of a (B, S, heads, HD) tensor at head h, as float32
// rows of kLdh<HD> in shared memory; rows past S are zeros.
template <int HD, int R, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t sb, int64_t ss, int64_t sh,
                                          int b, int h, int r0, int S) {
  for (int idx = threadIdx.x; idx < R * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const int pos = r0 + r;
    dst[r * kLdh<HD> + c] =
        pos < S ? ld(src + b * sb + pos * ss + h * sh + c) : 0.0f;
  }
}

// The (BQ x BK) tile's products of rows of A and B over hd: thread
// (ti, tj) of the 16 x 16 grid holds rows ti + 16 r and keys tj + 16 c.
template <int HD, int RI, int RJ>
__device__ __forceinline__ void row_dots(const float* A, const float* Bm,
                                         int ti, int tj,
                                         float (&out)[RI][RJ]) {
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) out[r][c] = 0.0f;
#pragma unroll 1
  for (int d = 0; d < HD; d += 4) {
    float4 av[RI], bv[RJ];
#pragma unroll
    for (int r = 0; r < RI; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + (ti + 16 * r) * kLdh<HD>
                                               + d);
#pragma unroll
    for (int c = 0; c < RJ; ++c)
      bv[c] = *reinterpret_cast<const float4*>(Bm + (tj + 16 * c) * kLdh<HD>
                                               + d);
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        float x = out[r][c];
        x = fmaf(av[r].x, bv[c].x, x);
        x = fmaf(av[r].y, bv[c].y, x);
        x = fmaf(av[r].z, bv[c].z, x);
        out[r][c] = fmaf(av[r].w, bv[c].w, x);
      }
  }
}

// P and dS (scaled by 1 / sqrt(hd)) at one (query position, key) from the
// raw score s = q . k and dp = do . v.
__device__ __forceinline__ float grad_score(const Args& a, float s, float dp,
                                           float lse, float D, int qpos,
                                           int kpos, float* p_out) {
  bool keep = qpos < a.Sq && kpos < a.Skv;
  if (a.causal) keep = keep && kpos <= qpos;
  if (a.window > 0) keep = keep && kpos > qpos - a.window;
  float x = s * a.scale, t = 0.0f;
  if (a.softcap > 0.0f) {
    t = tanhf(x / a.softcap);
    x = a.softcap * t;
  }
  const float p = keep ? expf(x - lse) : 0.0f;
  float ds = p * (dp - D);
  if (a.softcap > 0.0f) ds *= 1.0f - t * t;
  *p_out = p;
  return ds * a.scale;
}

// lse and D of the tile's rows (0 past Sq, where every score is masked).
template <int BQ>
__device__ __forceinline__ void load_row_stats(const Args& a, float* lse_s,
                                               float* D_s, int b, int h,
                                               int q0) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int pos = q0 + r;
    const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.Sq + pos;
    lse_s[r] = pos < a.Sq ? a.lse[at] : 0.0f;
    D_s[r] = pos < a.Sq ? a.delta[at] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Pass 2: dK and dV
// ---------------------------------------------------------------------------

template <int HD>
constexpr int kLdk = Tiles<HD>::BK % 32 == 0 ? Tiles<HD>::BK + 16
                                             : Tiles<HD>::BK + 32;

template <int HD>
constexpr int dkdv_smem_bytes() {
  constexpr int BK = Tiles<HD>::BK, BQ = Tiles<HD>::BQ;
  return 4 * (2 * BK * kLdh<HD> + 2 * BQ * kLdh<HD> + 2 * BQ * kLdk<HD>
              + 2 * BQ);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv(const Args a) {
  constexpr int BK = Tiles<HD>::BK, BQ = Tiles<HD>::BQ;
  constexpr int LDH = kLdh<HD>, LDK = kLdk<HD>;
  constexpr int RI = BQ / 16, RJ = BK / 16;
  constexpr int TC = HD / 4, TK = kThreads / TC, JJ = BK / TK;
  static_assert(JJ >= 1 && BK % TK == 0, "tile");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LDH;
  float* Qs = Vs + BK * LDH;
  float* dOs = Qs + BQ * LDH;
  float* Ps = dOs + BQ * LDH;
  float* dSs = Ps + BQ * LDK;
  float* lse_s = dSs + BQ * LDK;
  float* D_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;      // S and dP
  const int tc = tid % TC, tk = tid / TC;      // dK and dV
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int64_t osb = static_cast<int64_t>(a.Sq) * a.H * HD,
                oss = static_cast<int64_t>(a.H) * HD;

  load_rows<HD, BK>(Ks, static_cast<const T*>(a.k), a.ksb, a.kss, a.ksh, b,
                    kvh, k0, a.Skv);
  load_rows<HD, BK>(Vs, static_cast<const T*>(a.v), a.vsb, a.vss, a.vsh, b,
                    kvh, k0, a.Skv);

  // the query tiles some row of which sees one of these keys
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
  int q_end = a.Sq;
  if (a.window > 0) q_end = min(q_end, k0 + BK - 1 + a.window);

  float dk[JJ][4], dv[JJ][4];
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[jj][e] = dv[jj][e] = 0.0f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();               // the last tile is consumed
      load_rows<HD, BQ>(Qs, q, a.qsb, a.qss, a.qsh, b, h, q0, a.Sq);
      load_rows<HD, BQ>(dOs, dout, osb, oss, HD, b, h, q0, a.Sq);
      load_row_stats<BQ>(a, lse_s, D_s, b, h, q0);
      __syncthreads();

      float s[RI][RJ], dp[RI][RJ];
      row_dots<HD, RI, RJ>(Qs, Ks, ti, tj, s);
      row_dots<HD, RI, RJ>(dOs, Vs, ti, tj, dp);
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          float p;
          const float ds = grad_score(a, s[r][c], dp[r][c], lse_s[i], D_s[i],
                                      q0 + i, k0 + j, &p);
          Ps[i * LDK + j] = p;
          dSs[i * LDK + j] = ds;
        }
      __syncthreads();

#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float4 gv = *reinterpret_cast<const float4*>(dOs + i * LDH
                                                           + 4 * tc);
        const float4 qv = *reinterpret_cast<const float4*>(Qs + i * LDH
                                                           + 4 * tc);
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj) {
          const float p = Ps[i * LDK + tk + TK * jj];
          const float ds = dSs[i * LDK + tk + TK * jj];
          dv[jj][0] = fmaf(p, gv.x, dv[jj][0]);
          dv[jj][1] = fmaf(p, gv.y, dv[jj][1]);
          dv[jj][2] = fmaf(p, gv.z, dv[jj][2]);
          dv[jj][3] = fmaf(p, gv.w, dv[jj][3]);
          dk[jj][0] = fmaf(ds, qv.x, dk[jj][0]);
          dk[jj][1] = fmaf(ds, qv.y, dk[jj][1]);
          dk[jj][2] = fmaf(ds, qv.z, dk[jj][2]);
          dk[jj][3] = fmaf(ds, qv.w, dk[jj][3]);
        }
      }
    }
  }

  // dk and dv are contiguous (B, Skv, KV, hd).
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj) {
    const int kp = k0 + tk + TK * jj;
    if (kp >= a.Skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * a.Skv + kp) * a.KV + kvh)
                       * HD + 4 * tc;
    T* dkp = static_cast<T*>(a.dk) + at;
    T* dvp = static_cast<T*>(a.dv) + at;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st(dkp + e, dk[jj][e]);
      st(dvp + e, dv[jj][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: dQ
// ---------------------------------------------------------------------------

template <int HD>
constexpr int kLdq = Tiles<HD>::BQ + 1;  // dS is staged key-major

template <int HD>
constexpr int dq_smem_bytes() {
  constexpr int BK = Tiles<HD>::BK, BQ = Tiles<HD>::BQ;
  return 4 * (2 * BQ * kLdh<HD> + 2 * BK * kLdh<HD> + BK * kLdq<HD>
              + 2 * BQ);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq(const Args a, int n_tiles) {
  constexpr int BK = Tiles<HD>::BK, BQ = Tiles<HD>::BQ;
  constexpr int LDH = kLdh<HD>, LDQ = kLdq<HD>;
  constexpr int RI = BQ / 16, RJ = BK / 16;
  constexpr int TC = HD / 4, TI = kThreads / TC, II = BQ / TI;
  static_assert(II >= 1 && BQ % TI == 0, "tile");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LDH;
  float* Ks = dOs + BQ * LDH;
  float* Vs = Ks + BK * LDH;
  float* dSt = Vs + BK * LDH;
  float* lse_s = dSt + BK * LDQ;
  float* D_s = lse_s + BQ;

  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int q0 = tile * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;      // S and dP
  const int tc = tid % TC, tr = tid / TC;      // dQ
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_rows<HD, BQ>(Qs, static_cast<const T*>(a.q), a.qsb, a.qss, a.qsh, b,
                    h, q0, a.Sq);
  load_rows<HD, BQ>(dOs, static_cast<const T*>(a.dout),
                    static_cast<int64_t>(a.Sq) * a.H * HD,
                    static_cast<int64_t>(a.H) * HD, HD, b, h, q0, a.Sq);
  load_row_stats<BQ>(a, lse_s, D_s, b, h, q0);

  // the key tiles some row of this tile can see
  int k_begin = 0, k_end = a.Skv;
  if (a.causal) k_end = min(k_end, min(q0 + BQ, a.Sq));
  if (a.window > 0) k_begin = (max(0, q0 - a.window + 1) / BK) * BK;

  float acc[II][4];
#pragma unroll
  for (int r = 0; r < II; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                 // the last tile is consumed
    load_rows<HD, BK>(Ks, k, a.ksb, a.kss, a.ksh, b, kvh, k0, a.Skv);
    load_rows<HD, BK>(Vs, v, a.vsb, a.vss, a.vsh, b, kvh, k0, a.Skv);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
    row_dots<HD, RI, RJ>(Qs, Ks, ti, tj, s);
    row_dots<HD, RI, RJ>(dOs, Vs, ti, tj, dp);
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        const int i = ti + 16 * r, j = tj + 16 * c;
        float p;
        dSt[j * LDQ + i] = grad_score(a, s[r][c], dp[r][c], lse_s[i], D_s[i],
                                      q0 + i, k0 + j, &p);
      }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + j * LDH
                                                         + 4 * tc);
#pragma unroll
      for (int r = 0; r < II; ++r) {
        const float ds = dSt[j * LDQ + tr + TI * r];
        acc[r][0] = fmaf(ds, kv.x, acc[r][0]);
        acc[r][1] = fmaf(ds, kv.y, acc[r][1]);
        acc[r][2] = fmaf(ds, kv.z, acc[r][2]);
        acc[r][3] = fmaf(ds, kv.w, acc[r][3]);
      }
    }
  }

  // dq is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int r = 0; r < II; ++r) {
    const int pos = q0 + tr + TI * r;
    if (pos >= a.Sq) continue;
    T* out = static_cast<T*>(a.dq)
             + ((static_cast<int64_t>(b) * a.Sq + pos) * a.H + h) * HD
             + 4 * tc;
#pragma unroll
    for (int e = 0; e < 4; ++e) st(out + e, acc[r][e]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;   // keys (dK/dV) or fold rows (dQ) a block
constexpr int kSub = 16;             // queries (dK/dV) or keys (dQ) a score step
constexpr int kSubNT = kSub / 8;     // its 8-column tiles of scores per warp

// exp(x) as 2^(x log2 e) on the special-function unit, the forward's
// exp_sfu (flash_attention.cu): within ~2^-22 of expf, relative.  Each
// source keeps its own, which its ablation script edits.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// At hd 256 a warp's dK and dV for 16 keys would be 2 x 128 float32
// registers a thread, past the 255 it may have: there the block's keys'
// hd columns are split between two blocks (kParts), each of which forms
// the same scores and adds into its own half of the columns.
template <int HD>
constexpr int kParts = HD > 128 ? 2 : 1;

// K and V (dK/dV pass) are held as A fragments in registers up to hd 64;
// Q and dO (dQ pass) up to hd 128.  Above, ldmatrix reads them from
// shared memory at each k-step.
template <int HD>
constexpr bool kKVInRegisters = HD <= 64;
template <int HD>
constexpr bool kQInRegisters = HD <= 128;

template <int HD>
constexpr int kMinBlocks = HD <= 128 ? 2 : 1;

template <int HD>
constexpr uint32_t kTileBytes = kTile * HD * 2;

// K, V; Q and dO double-buffered; the query tiles' lse and D, two each.
template <int HD>
constexpr int dkdv_smem_bytes() {
  return 6 * kTileBytes<HD> + 4 * kTile * 4;
}

// Q and dO; K and V double-buffered.
template <int HD>
constexpr int dq_smem_bytes() {
  return 6 * kTileBytes<HD>;
}

// The masks at one score: key kp seen from query position pos.
__device__ __forceinline__ bool visible(const Args& a, int kp, int pos) {
  return (!a.causal || kp <= pos) && (a.window <= 0 || kp > pos - a.window);
}

// P = exp(x - lse) and dS = P (dP - D) (1 - tanh^2 under the cap) scale of
// one score, from s = q . k and dp = do . v; P into s, dS into dp.
__device__ __forceinline__ void grad_scores_capped(const Args& a, float& s,
                                                   float& dp, float lse,
                                                   float D) {
  const float t = tanhf(s * a.scale / a.softcap);
  const float p = exp_sfu(a.softcap * t - lse);
  s = p;
  dp = p * (dp - D) * (1.0f - t * t) * a.scale;
}
__device__ __forceinline__ void grad_scores(const Args& a, float& s,
                                            float& dp, float lse, float D) {
  const float p = exp_sfu(s * a.scale - lse);
  s = p;
  dp = p * (dp - D) * a.scale;
}

// The four A registers of one 16-column k-step kk of a (16 x 8 n) tile
// held in the m16n8k16 C layout, each float32 split into bf16 hi + lo.
template <int NT>
__device__ __forceinline__ void split_a(const float (&c)[NT][4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c[2 * kk][0], c[2 * kk][1], &hi[0], &lo[0]);
  split(c[2 * kk][2], c[2 * kk][3], &hi[1], &lo[1]);
  split(c[2 * kk + 1][0], c[2 * kk + 1][1], &hi[2], &lo[2]);
  split(c[2 * kk + 1][2], c[2 * kk + 1][3], &hi[3], &lo[3]);
}

// c += a_hi b + a_lo b for one m16n8k16 tile.  The tensor cores add in
// float32 with truncation, so a long sum kept in the accumulator drifts
// (see the note on the sums above): the pair is summed from zero and
// added to c by the float32 unit, rounding to nearest.
__device__ __forceinline__ void mma_split_add(float (&c)[4],
                                              const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4],
                                              uint32_t b0, uint32_t b1) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(t, hi, b0, b1);
  mma_bf16(t, lo, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// Pass 2: dK and dV.  One block a (64 keys, KV head, batch[, column part]),
// 16 keys a warp.  The transposed scores S^T = K Q^T and dP^T = V dO^T
// of 16 queries at a time, then dV += P^T_hi dO + P^T_lo dO and
// dK += dS^T_hi Q + dS^T_lo Q, over the G query heads of the group and the
// 64-query tiles that can see these keys.
template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
flash_bwd_dkdv_mma(const Args a, int B) {
  constexpr int kChunks = HD / 8;
  constexpr int kSteps = HD / 16;    // k-steps of S^T and dP^T
  constexpr int kCols = HD / kParts<HD>;
  constexpr int kOut = kCols / 8;    // 8-column tiles of dK and dV
  constexpr uint32_t kBytes = kTileBytes<HD>;
  using Sw = Swizzle<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_u32(smem);
  const uint32_t s_v = s_k + kBytes;
  const uint32_t s_q = s_v + kBytes;           // two buffers
  const uint32_t s_do = s_q + 2 * kBytes;      // two buffers
  float* lse_s = reinterpret_cast<float*>(smem + 6 * kBytes);  // [2][kTile]
  float* D_s = lse_s + 2 * kTile;                              // [2][kTile]

  // Blocks in launch order: every (part, KV head, batch) of the first key
  // tile (the one most query tiles see under the causal mask), then of the
  // next.
  const int per_tile = kParts<HD> * a.KV * B;
  const int k0 = static_cast<int>(blockIdx.x) / per_tile * kTile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int col0 = rest % kParts<HD> * kCols;
  rest /= kParts<HD>;
  const int kvh = rest % a.KV, b = rest / a.KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);

  // Each thread copies one 16-byte column chunk of every kRowStep-th row.
  constexpr int kRowStep = kThreads / kChunks;
  const int lr = tid / kChunks, lc = tid % kChunks;
  {
    const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k)
                              + b * a.ksb + kvh * a.ksh + lc * 8;
    const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v)
                              + b * a.vsb + kvh * a.vsh + lc * 8;
#pragma unroll
    for (int r = lr; r < kTile; r += kRowStep) {
      const int kp = k0 + r;
      const bool in = kp < a.Skv;
      const int64_t kr = in ? kp : 0;
      cp_async16(s_k + Sw::off(r, lc), kg + kr * a.kss, in ? 16 : 0);
      cp_async16(s_v + Sw::off(r, lc), vg + kr * a.vss, in ? 16 : 0);
    }
  }
  cp_async_commit();

  // The query tiles some row of which sees one of these keys, for each of
  // the G heads: iteration it is head it / n_qt, tile it % n_qt.
  const int q_begin = a.causal ? k0 : 0;
  int q_end = a.Sq;
  if (a.window > 0) q_end = min(q_end, k0 + kTile - 1 + a.window);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kTile - 1) / kTile
                                   : 0;
  const int n_it = a.G * n_qt;
  // q and do rows past Sq are zeros and their lse and D 0, so every score
  // there is finite and adds exactly 0 to dK and dV: no mask needed.
  auto load_q = [&](int it, int buf) {
    const int h = kvh * a.G + it / n_qt;
    const int q0 = q_begin + it % n_qt * kTile;
    const __nv_bfloat16* qg = q + b * a.qsb + h * a.qsh + lc * 8;
    const __nv_bfloat16* dg = dout
        + (static_cast<int64_t>(b) * a.Sq * a.H + h) * HD + lc * 8;
#pragma unroll
    for (int r = lr; r < kTile; r += kRowStep) {
      const int pos = q0 + r;
      const bool in = pos < a.Sq;
      const int64_t pr = in ? pos : 0;
      const uint32_t dst = buf * kBytes + Sw::off(r, lc);
      cp_async16(s_q + dst, qg + pr * a.qss, in ? 16 : 0);
      cp_async16(s_do + dst, dg + pr * a.H * HD, in ? 16 : 0);
    }
    if (tid < kTile) {
      const int pos = q0 + tid;
      const bool in = pos < a.Sq;
      const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.Sq
                         + (in ? pos : 0);
      cp_async4(smem_u32(lse_s + buf * kTile + tid), a.lse + at, in ? 4 : 0);
      cp_async4(smem_u32(D_s + buf * kTile + tid), a.delta + at, in ? 4 : 0);
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait<1>();                // K and V have landed
  __syncthreads();

  // The A fragment of the warp's 16 keys of K or V at k-step kk.
  auto kv_frag_addr = [&](uint32_t base, int kk) {
    return base + Sw::off(warp * 16 + lane % 16, 2 * kk + lane / 16);
  };
  constexpr int kKVRegSteps = kKVInRegisters<HD> ? kSteps : 1;
  uint32_t kf[kKVRegSteps][4], vf[kKVRegSteps][4];
  if constexpr (kKVInRegisters<HD>) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      ldsm_x4(kv_frag_addr(s_k, kk), kf[kk]);
      ldsm_x4(kv_frag_addr(s_v, kk), vf[kk]);
    }
  }

  // This thread's keys kp_a and kp_b = kp_a + 8; the warp's kw_lo..kw_hi.
  const int kw_lo = k0 + warp * 16, kw_hi = kw_lo + 15;
  const int kp_a = kw_lo + g, kp_b = kp_a + 8;

  float dk[kOut][4], dv[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_begin + it % n_qt * kTile;
    if (it + 1 < n_it) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t qb = s_q + (it & 1) * kBytes;
    const uint32_t db = s_do + (it & 1) * kBytes;
    const float* lse_t = lse_s + (it & 1) * kTile;
    const float* D_t = D_s + (it & 1) * kTile;

#pragma unroll 1
    for (int sub = 0; sub < kTile / kSub; ++sub) {
      const int qs = q0 + sub * kSub;  // the step's first query position
      // A step that hides all the warp's keys from all its queries adds
      // nothing.
      if ((a.causal && qs + kSub - 1 < kw_lo)
          || (a.window > 0 && kw_hi <= qs - a.window))
        continue;

      float s[kSubNT][4], dp[kSubNT][4];
#pragma unroll
      for (int n = 0; n < kSubNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t(&ka)[4] = kf[kKVInRegisters<HD> ? kk : 0];
        uint32_t(&va)[4] = vf[kKVInRegisters<HD> ? kk : 0];
        if constexpr (!kKVInRegisters<HD>) {
          ldsm_x4(kv_frag_addr(s_k, kk), ka);
          ldsm_x4(kv_frag_addr(s_v, kk), va);
        }
#pragma unroll
        for (int jp = 0; jp < kSubNT / 2; ++jp) {
          const uint32_t off = Sw::off(sub * kSub + 16 * jp + lane % 8
                                       + 8 * (lane / 16),
                                       2 * kk + (lane / 8) % 2);
          uint32_t f[4];
          ldsm_x4(qb + off, f);
          mma_bf16(s[2 * jp], ka, f[0], f[1]);
          mma_bf16(s[2 * jp + 1], ka, f[2], f[3]);
          ldsm_x4(db + off, f);
          mma_bf16(dp[2 * jp], va, f[0], f[1]);
          mma_bf16(dp[2 * jp + 1], va, f[2], f[3]);
        }
      }

      // P^T into s, dS^T into dp.  Element e of n-tile n: key e < 2 ?
      // kp_a : kp_b, query qs + 8 n + 2 t + (e & 1).  The soft-cap and the
      // mask each sit in a branch around a whole loop.
      float2 lse2[kSubNT], D2[kSubNT];
#pragma unroll
      for (int n = 0; n < kSubNT; ++n) {
        lse2[n] = *reinterpret_cast<const float2*>(lse_t + sub * kSub
                                                   + 8 * n + 2 * t);
        D2[n] = *reinterpret_cast<const float2*>(D_t + sub * kSub + 8 * n
                                                 + 2 * t);
      }
      if (a.softcap > 0.0f) {
#pragma unroll
        for (int n = 0; n < kSubNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            grad_scores_capped(a, s[n][e], dp[n][e],
                               e & 1 ? lse2[n].y : lse2[n].x,
                               e & 1 ? D2[n].y : D2[n].x);
      } else {
#pragma unroll
        for (int n = 0; n < kSubNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            grad_scores(a, s[n][e], dp[n][e], e & 1 ? lse2[n].y : lse2[n].x,
                        e & 1 ? D2[n].y : D2[n].x);
      }
      if ((a.causal && qs < kw_hi)
          || (a.window > 0 && kw_lo <= qs + kSub - 1 - a.window)) {
#pragma unroll
        for (int n = 0; n < kSubNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(a, e < 2 ? kp_a : kp_b, qs + 8 * n + 2 * t + (e & 1)))
              s[n][e] = dp[n][e] = 0.0f;
      }

      // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q over the
      // step's 16 queries; dO and Q are read by ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_a(s, kk, ph, pl);
        split_a(dp, kk, dh, dl);
        const int r = sub * kSub + 16 * kk + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
        for (int np = 0; np < kOut / 2; ++np) {
          const uint32_t off = Sw::off(r, col0 / 8 + 2 * np + lane / 16);
          uint32_t f[4];
          ldsm_x4_trans(db + off, f);
          mma_split_add(dv[2 * np], ph, pl, f[0], f[1]);
          mma_split_add(dv[2 * np + 1], ph, pl, f[2], f[3]);
          ldsm_x4_trans(qb + off, f);
          mma_split_add(dk[2 * np], dh, dl, f[0], f[1]);
          mma_split_add(dk[2 * np + 1], dh, dl, f[2], f[3]);
        }
      }
    }
    __syncthreads();                 // this buffer is consumed
  }
  cp_async_wait<0>();

  // dk and dv are contiguous (B, Skv, KV, hd).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kp_b : kp_a;
    if (kp >= a.Skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * a.Skv + kp) * a.KV + kvh)
                       * HD + col0 + 2 * t;
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + at;
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + at;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * n) = __floats2bfloat162_rn(
          dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * n) = __floats2bfloat162_rn(
          dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// Pass 3: dQ.  The forward's block: 64 rows of (query position, query head
// of the group) taken position-major, one KV head, one batch, 16 rows a
// warp, the longest rows first.  S = Q K^T and dP = dO V^T of 16 keys at a
// time, then dQ += dS_hi K + dS_lo K, over the K/V tiles the rows can see.
template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
flash_bwd_dq_mma(const Args a, int n_tiles, int B) {
  constexpr int kChunks = HD / 8;
  constexpr int kSteps = HD / 16;    // k-steps of S and dP
  constexpr int kOut = HD / 8;       // 8-column tiles of dQ
  constexpr uint32_t kBytes = kTileBytes<HD>;
  using Sw = Swizzle<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_do = s_q + kBytes;
  const uint32_t s_k = s_do + kBytes;          // two buffers
  const uint32_t s_v = s_k + 2 * kBytes;       // two buffers

  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.KV * B);
  const int rest = static_cast<int>(blockIdx.x) % (a.KV * B);
  const int kvh = rest % a.KV, b = rest / a.KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = a.G;
  const int n_rows = a.Sq * G;
  const int row0 = tile * kTile;

  // The first K/V tile some row can see, and the end of the keys they see.
  const int q_lo = row0 / G, q_hi = min((row0 + kTile - 1) / G, a.Sq - 1);
  int k_begin = 0, k_end = a.Skv;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window > 0) k_begin = max(0, q_lo - a.window + 1) / kTile * kTile;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile
                                   : 0;

  // Stage Q and dO (rows past the end are zeros).
  constexpr int kRowStep = kThreads / kChunks;
  const int lr = tid / kChunks, lc = tid % kChunks;
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);
#pragma unroll
    for (int r = lr; r < kTile; r += kRowStep) {
      const int gr = row0 + r;
      const bool in = gr < n_rows;
      const int pos = in ? gr / G : 0, h = kvh * G + (in ? gr % G : 0);
      cp_async16(s_q + Sw::off(r, lc),
                 q + b * a.qsb + pos * a.qss + h * a.qsh + lc * 8,
                 in ? 16 : 0);
      cp_async16(s_do + Sw::off(r, lc),
                 dout + ((static_cast<int64_t>(b) * a.Sq + pos) * a.H + h)
                        * HD + lc * 8,
                 in ? 16 : 0);
    }
  }
  cp_async_commit();

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k)
                            + b * a.ksb + kvh * a.ksh + lc * 8;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v)
                            + b * a.vsb + kvh * a.vsh + lc * 8;
  auto load_kv = [&](int kt, int buf) {
#pragma unroll
    for (int r = lr; r < kTile; r += kRowStep) {
      const int kp = kt + r;
      const bool in = kp < a.Skv;
      const int64_t kr = in ? kp : 0;
      const uint32_t dst = buf * kBytes + Sw::off(r, lc);
      cp_async16(s_k + dst, kg + kr * a.kss, in ? 16 : 0);
      cp_async16(s_v + dst, vg + kr * a.vss, in ? 16 : 0);
    }
  };
  if (n_kt > 0) load_kv(k_begin, 0);
  cp_async_commit();

  // This thread's rows r_a = wr0 + g and r_b = r_a + 8 of the warp's; past
  // the end lse and D are 0 (the rows are not written).
  const int wr0 = row0 + warp * 16;
  const int gr_a = wr0 + g, gr_b = gr_a + 8;
  const int pos_a = gr_a / G, pos_b = gr_b / G;
  const int wq_lo = wr0 / G, wq_hi = (wr0 + 15) / G;
  float lse_a = 0.0f, lse_b = 0.0f, D_a = 0.0f, D_b = 0.0f;
  if (gr_a < n_rows) {
    const int64_t at = (static_cast<int64_t>(b) * a.H + kvh * G + gr_a % G)
                       * a.Sq + pos_a;
    lse_a = a.lse[at];
    D_a = a.delta[at];
  }
  if (gr_b < n_rows) {
    const int64_t at = (static_cast<int64_t>(b) * a.H + kvh * G + gr_b % G)
                       * a.Sq + pos_b;
    lse_b = a.lse[at];
    D_b = a.delta[at];
  }

  cp_async_wait<1>();                // Q and dO have landed
  __syncthreads();

  // The A fragment of the warp's 16 rows of Q or dO at k-step kk.
  auto row_frag_addr = [&](uint32_t base, int kk) {
    return base + Sw::off(warp * 16 + lane % 16, 2 * kk + lane / 16);
  };
  constexpr int kQRegSteps = kQInRegisters<HD> ? kSteps : 1;
  uint32_t qf[kQRegSteps][4], df[kQRegSteps][4];
  if constexpr (kQInRegisters<HD>) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      ldsm_x4(row_frag_addr(s_q, kk), qf[kk]);
      ldsm_x4(row_frag_addr(s_do, kk), df[kk]);
    }
  }

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int kt = k_begin + it * kTile;
    if (it + 1 < n_kt) {
      load_kv(kt + kTile, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kb = s_k + (it & 1) * kBytes;
    const uint32_t vb = s_v + (it & 1) * kBytes;

#pragma unroll 1
    for (int sub = 0; sub < kTile / kSub; ++sub) {
      const int ks = kt + sub * kSub;  // the step's first key
      // A step that hides every key from all the warp's rows adds nothing.
      if ((a.causal && ks > wq_hi)
          || (a.window > 0 && ks + kSub - 1 <= wq_lo - a.window))
        continue;

      float s[kSubNT][4], dp[kSubNT][4];
#pragma unroll
      for (int n = 0; n < kSubNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t(&qa)[4] = qf[kQInRegisters<HD> ? kk : 0];
        uint32_t(&da)[4] = df[kQInRegisters<HD> ? kk : 0];
        if constexpr (!kQInRegisters<HD>) {
          ldsm_x4(row_frag_addr(s_q, kk), qa);
          ldsm_x4(row_frag_addr(s_do, kk), da);
        }
#pragma unroll
        for (int jp = 0; jp < kSubNT / 2; ++jp) {
          const uint32_t off = Sw::off(sub * kSub + 16 * jp + lane % 8
                                       + 8 * (lane / 16),
                                       2 * kk + (lane / 8) % 2);
          uint32_t f[4];
          ldsm_x4(kb + off, f);
          mma_bf16(s[2 * jp], qa, f[0], f[1]);
          mma_bf16(s[2 * jp + 1], qa, f[2], f[3]);
          ldsm_x4(vb + off, f);
          mma_bf16(dp[2 * jp], da, f[0], f[1]);
          mma_bf16(dp[2 * jp + 1], da, f[2], f[3]);
        }
      }

      // dS into dp.  Element e of n-tile n: row e < 2 ? r_a : r_b, key
      // ks + 8 n + 2 t + (e & 1).  Keys past Skv are masked here: their
      // zero-filled K and V give finite scores only while lse is.
      if (a.softcap > 0.0f) {
#pragma unroll
        for (int n = 0; n < kSubNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            grad_scores_capped(a, s[n][e], dp[n][e], e < 2 ? lse_a : lse_b,
                               e < 2 ? D_a : D_b);
      } else {
#pragma unroll
        for (int n = 0; n < kSubNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            grad_scores(a, s[n][e], dp[n][e], e < 2 ? lse_a : lse_b,
                        e < 2 ? D_a : D_b);
      }
      if (ks + kSub > a.Skv || (a.causal && ks + kSub - 1 > wq_lo)
          || (a.window > 0 && ks <= wq_hi - a.window)) {
#pragma unroll
        for (int n = 0; n < kSubNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = ks + 8 * n + 2 * t + (e & 1);
            if (kp >= a.Skv || !visible(a, kp, e < 2 ? pos_a : pos_b))
              dp[n][e] = 0.0f;
          }
      }

      // dQ += dS_hi K + dS_lo K over the step's 16 keys; K is
      // read by ldmatrix.trans, as the forward reads V.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t dh[4], dl[4];
        split_a(dp, kk, dh, dl);
        const int r = sub * kSub + 16 * kk + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
        for (int np = 0; np < kOut / 2; ++np) {
          uint32_t f[4];
          ldsm_x4_trans(kb + Sw::off(r, 2 * np + lane / 16), f);
          mma_split_add(acc[2 * np], dh, dl, f[0], f[1]);
          mma_split_add(acc[2 * np + 1], dh, dl, f[2], f[3]);
        }
      }
    }
    __syncthreads();                 // this buffer is consumed
  }
  cp_async_wait<0>();

  // dq is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gr = half ? gr_b : gr_a;
    if (gr >= n_rows) continue;
    const int pos = gr / G, h = kvh * G + gr % G;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq)
        + ((static_cast<int64_t>(b) * a.Sq + pos) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < kOut; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

template <int HD>
int launch(const Args& a, int B, cudaStream_t s) {
  const int64_t n_ktiles = (a.Skv + kTile - 1) / kTile;
  const int64_t n_tiles = (static_cast<int64_t>(a.Sq) * a.G + kTile - 1)
                          / kTile;
  const int64_t kv_blocks = n_ktiles * kParts<HD> * a.KV * B;
  const int64_t q_blocks = n_tiles * a.KV * B;
  if (kv_blocks > INT32_MAX || q_blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kv_bytes = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kv_blocks > 0) {
    flash_bwd_dkdv_mma<HD><<<static_cast<unsigned>(kv_blocks), kThreads,
                             kv_bytes, s>>>(a, B);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  constexpr int q_bytes = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dq_mma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_blocks > 0) {
    flash_bwd_dq_mma<HD><<<static_cast<unsigned>(q_blocks), kThreads,
                           q_bytes, s>>>(a, static_cast<int>(n_tiles), B);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// D first (both routes), then dK/dV and dQ: the CUDA-core kernels for
// float32, the tensor-core ones for bf16.
template <typename T>
int launch_delta(const Args& a, int B, int hd, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(B) * a.Sq * a.H;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    flash_bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                         s>>>(a, rows, hd);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

template <int HD>
int launch_f32(const Args& a, int B, cudaStream_t s) {
  using T = float;
  constexpr int BK = Tiles<HD>::BK, BQ = Tiles<HD>::BQ;
  const int64_t n_keys = (a.Skv + BK - 1) / BK;
  const int64_t n_tiles = (a.Sq + BQ - 1) / BQ;
  if (n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  constexpr int kv_bytes = dkdv_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_keys > 0) {
    flash_bwd_dkdv<HD, T><<<dim3(static_cast<unsigned>(n_keys), a.KV, B),
                            kThreads, kv_bytes, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  constexpr int q_bytes = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(flash_bwd_dq<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 0) {
    flash_bwd_dq<HD, T><<<dim3(static_cast<unsigned>(n_tiles), a.H, B),
                          kThreads, q_bytes, s>>>(
        a, static_cast<int>(n_tiles));
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

template <int HD>
int launch(bool tensor_cores, const Args& a, int B, cudaStream_t s) {
  const int err = tensor_cores ? launch_delta<__nv_bfloat16>(a, B, HD, s)
                               : launch_delta<float>(a, B, HD, s);
  if (err != 0) return err;
  return tensor_cores ? tc::launch<HD>(a, B, s) : launch_f32<HD>(a, B, s);
}

int dispatch(bool tensor_cores, const Args& a, int B, int hd,
             cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(tensor_cores, a, B, s);
    case 32: return launch<32>(tensor_cores, a, B, s);
    case 64: return launch<64>(tensor_cores, a, B, s);
    case 128: return launch<128>(tensor_cores, a, B, s);
    case 256: return launch<256>(tensor_cores, a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 route's 16-byte copies: base pointers 16-byte aligned, strides
// along batch, sequence and head multiples of 8 elements.
bool aligned16(const void* p, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0
         && ss % 8 == 0 && sh % 8 == 0;
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd), each with unit stride along
// hd and the given element strides along batch, sequence and head; o, do,
// dq (B, Sq, H, hd) and dk, dv (B, Skv, KV, hd) contiguous in q's dtype;
// lse and the scratch delta contiguous float32 (B, H, Sq).  dtype 0 =
// float32, 1 = bf16; hd in {16, 32, 64, 128, 256}.  Three kernels on
// ``stream``; returns a cudaError_t.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int dtype, int B, int Sq,
                               int Skv, int H, int KV, int hd, int64_t qsb,
                               int64_t qss, int64_t qsh, int64_t ksb,
                               int64_t kss, int64_t ksh, int64_t vsb,
                               int64_t vss, int64_t vsh, int causal,
                               int window, float softcap, float scale,
                               void* stream) {
  if (KV <= 0 || H % KV != 0 || B > 65535 || H > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, Sq, Skv, H, KV,
               H / KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
               window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch(false, a, B, hd, s);
  if (dtype == 1) {
    if (!aligned16(q, qsb, qss, qsh) || !aligned16(k, ksb, kss, ksh)
        || !aligned16(v, vsb, vss, vsh) || !aligned16(dout, 0, 0, 0))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return dispatch(true, a, B, hd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
