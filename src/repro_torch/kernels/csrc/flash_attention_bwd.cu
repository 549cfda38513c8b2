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
// q, k, v, o and do are float32 or bf16; every product and sum is float32
// on the CUDA cores; dq, dk and dv are written in the inputs' dtype.  The
// masks are the forward's (causal j <= i, window j > i - window, ragged
// edges), on positions counted from 0 in q and in k.
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
// the least time is 0.174 ms at the bf16 tensor-core rate.  This kernel
// does seven (S and dP are formed again in the dQ pass) on the CUDA cores
// in float32 (67 TFLOP/s at most): it is simple and deterministic, not
// fast.  A tensor-core version is later work.
//
// Three passes, no atomics, so two runs give the same bits:
//   1. flash_bwd_delta: D, one warp a (position, head) row.
//   2. flash_bwd_dkdv: one block a (tile of BK keys, KV head, batch).  K
//      and V are staged once; a loop over the group's G query heads and,
//      inside, over the tiles of BQ query positions that can see these
//      keys forms S and dP for the (BQ x BK) tile, then P and dS, and adds
//      P^T do and dS^T q into dV and dK held in registers.
//   3. flash_bwd_dq: one block a (tile of BQ positions, query head,
//      batch), the longest rows first; a loop over the key tiles the rows
//      can see forms S, dP and dS again and adds dS k into dQ.
// Tiles are float32 in shared memory, rows padded by 4 floats so that
// 16-byte reads of 8 different rows fall in 8 different bank groups.  S
// and dP: each thread holds (BQ / 16) x (BK / 16) scores of a 16 x 16
// thread grid, contracted over hd in 16-byte steps.  dV, dK and dQ: each
// thread holds 4 adjacent columns of a few rows; the tile's P or dS is
// read one scalar per row and the operand rows 16 bytes at a time.  The
// tiles per head dim (Tiles below) keep each block at or under 112 KB of
// shared memory and 128 registers a thread, so two blocks fit on an SM;
// at hd = 256 a dK/dV block takes 16 keys and a query tile 32 positions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// Launch
// ---------------------------------------------------------------------------

template <int HD, typename T>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr int BK = Tiles<HD>::BK, BQ = Tiles<HD>::BQ;
  const int64_t rows = static_cast<int64_t>(B) * a.Sq * a.H;
  const int64_t n_keys = (a.Skv + BK - 1) / BK;
  const int64_t n_tiles = (a.Sq + BQ - 1) / BQ;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > INT32_MAX || n_tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (rows > 0) {
    flash_bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                         s>>>(a, rows, HD);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
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

template <typename T>
int dispatch(const Args& a, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, T>(a, B, s);
    case 32: return launch<32, T>(a, B, s);
    case 64: return launch<64, T>(a, B, s);
    case 128: return launch<128, T>(a, B, s);
    case 256: return launch<256, T>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype == 0) return dispatch<float>(a, B, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
