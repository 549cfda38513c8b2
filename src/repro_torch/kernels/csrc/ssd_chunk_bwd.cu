// ssd_chunk_bwd: the gradient of the ssd_chunk kernel (the Mamba-2 SSD
// intra-chunk dual form, arXiv:2405.21060), for sm_90a.  Per (batch b,
// chunk c, head h), with Q positions, xdt_j = dt_j x_j, cum_i = sum_{r <= i}
// dt_r A, L_ij = exp(cum_i - cum_j) for j <= i (else 0), S = C B^T,
// M = S o L and w_j = exp(cum_{Q-1} - cum_j), the forward is
//
//   y = M xdt,  state = sum_j B_j (w_j xdt_j)^T,  decay = exp(cum_{Q-1}),
//
// and against dy (Q x P), dstate (N x P) and ddecay its gradient is
//
//   d(xdt) = M^T dy + w o U,  U = B dstate,   dw_j = U_j . xdt_j,
//   dM = dy xdt^T,  G = dM o M,  D = sum_h dM o L  (the gradient of S),
//   dcum_k = sum_j G_kj - sum_i G_ik - dw_k w_k
//            (+ sum_j dw_j w_j + ddecay decay at k = Q-1),
//   da_r = sum_{k >= r} dcum_k, whose G part is sum_{i >= r > j} G_ij,
//   ddt = da A + sum_p d(xdt) x,  dx = d(xdt) dt,  dA = sum da dt,
//   dC = D B,  dB = D^T C + sum_h (w o xdt) dstate^T.
//
// x, Bm and Cm are float32 or bf16 and read through their strides (unit
// stride along the last axis), as the forward reads them; dt is float32;
// A is float32, one row of H for every batch row (batch stride 0) or one
// row per batch row (the cohort's folded batch, whose clients' A differ
// from their second local step on).  dy, dstate and ddecay are float32 and
// contiguous; a null dstate or ddecay is a zero gradient.  dx, dBm and dCm
// are accumulated in float32 and rounded once to the input's dtype; ddt and
// dA are float32.  cum is the forward's left-to-right float32 sum.  Any Q
// and N up to 128 and P up to 64 are taken (the shared memory of the scan
// pass below bounds P).
//
// Replaces no Pallas kernel: the TPU kernel (src/repro/kernels/ssd_chunk.py)
// has no backward, and the JAX package trains by differentiating its plain
// src/repro/models/ssm.py::_ssd_chunked.  It is here because the port's
// forward is a ctypes call that autograd cannot see through, and a plain
// backward on the card would hide the kernel.  The oracle is
// repro_torch/kernels/ref.py::ssd_chunk_bwd.
//
// What bounds it on the H100: bytes.  At mamba2-2.7b's training layer as
// the cohort folds it (B = 2, nc = 32, Q = 128, H = 80, P = 64, N = 128,
// bf16 inputs) its ~0.51 GB of traffic takes 0.15 ms at 3.35 TB/s, and the
// products it needs, ~33 GFLOP (S, D^T C and D B once per chunk on the
// lower triangle; per head dM and M^T dy on the lower triangle, U and
// (w o xdt) dstate^T in full), 0.033 ms at the bf16 tensor cores' 989
// TFLOP/s.  This first version keeps every product in float32 on the CUDA
// cores (each thread a 4 x 4 tile, 16-byte shared-memory loads), the
// simple design that is right, where the products alone take 0.49 ms at
// 67 TFLOP/s; the tensor cores are later work.
//
// Shared memory is what shapes it: at Q = N = 128 float32 copies of S, one
// head's L (as M), B and C alone pass the 227 KB a block may hold.  So the
// work is cut in four launches, none with atomics, each sum in a fixed
// order (reruns are bitwise, and strided and contiguous inputs give the
// same bits):
//
//  1. states pass, one block per (8 heads, chunk, batch): B staged once;
//     per head U = B dstate (w o U to a float32 workspace, dw_j from it),
//     and (w o xdt) dstate^T summed over the block's heads in registers,
//     written as the block's partial of dB.
//  2. scan pass, one block per (8 heads, chunk, batch): S = C B^T once on
//     the lower-triangular 4 x 4 tiles, packed (row i holds columns up to
//     4 floor(i / 4) + 3); per head dM on the same tiles, giving M (kept
//     packed for M^T dy), D += dM o L (summed over the block's heads in
//     shared memory, each tile owned by one thread) and G's row and column
//     sums per tile; then d(xdt) = M^T dy + w o U, dx, and sum_p d(xdt) x.
//     G's part of da is summed as the block i >= r > j of G from the
//     tiles' row and column sums (and the diagonal tile's elements), not
//     as the reverse sum of row sums minus column sums, which cancel in
//     float32 (as the plain version sums it).  The reverse sum of dcum's
//     other terms runs at the end, one lane a head.  Writes D as the
//     block's partial, and dA's per (b, c, h).
//  3. B and C pass, one block per (chunk, batch): sums the partials of D in
//     head-group order, then dC = D B and dB = D^T C + the states pass's
//     partials, rounded once.
//  4. dA: per batch row (A per row) or over the batch, chunks in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQN = 128;        // Q and N
constexpr int kMaxP = 64;          // P
constexpr int kThreads = 512;
constexpr int kHeads = 8;          // heads a block (states and scan passes)

struct Args {
  const void* x; const float* dt; const float* A;
  const void* bm; const void* cm;
  const float* dy; const float* dst; const float* ddec;   // dst, ddec: null = 0
  void* dx; float* ddt; float* dA; void* dbm; void* dcm;
  // workspace (float32): w o U (B, nc, H, Q, P) and dw (B, nc, H, Q) when
  // dst is given; the partials of dB's states term (groups, B, nc, Q, N),
  // of D (groups, B, nc, tri_off(round4(Q))) and of dA (B, nc, H)
  float* wu; float* dw; float* dbx; float* dpart; float* dapart;
  int B, nc, Q, H, P, N, groups;
  int64_t xsb, xsc, xsq, xsh;   // x strides (b, c, q, h); unit along P
  int64_t dsb, dsc, dsq;        // dt strides (b, c, q); unit along H
  int64_t bsb, bsc, bsq;        // Bm strides (b, c, q); unit along N
  int64_t csb, csc, csq;        // Cm strides
  int64_t asb;                  // A's batch stride (0: one A for all rows)
  int a_rows;                   // dA per batch row (1) or over the batch (0)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Offset of row i in the packed lower triangle: row 4a + r holds 4(a + 1)
// columns, so it starts at 4(a + 1)(2a + r).  tri_off(Qp) is the size.
__host__ __device__ __forceinline__ int tri_off(int i) {
  const int a = i >> 2, r = i & 3;
  return 4 * (a + 1) * (2 * a + r);
}

// Tile t of the row-major lower triangle of 4 x 4 tiles: (it, jt), jt <= it.
__device__ __forceinline__ void tri_tile(int t, int* it, int* jt) {
  int r = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  *it = r;
  *jt = t - r * (r + 1) / 2;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// acc[k][p] += sum_l a[k].l * x[l].p, l in order
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&x)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ak[4] = {a[k].x, a[k].y, a[k].z, a[k].w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      acc[k][0] = fmaf(ak[l], x[l].x, acc[k][0]);
      acc[k][1] = fmaf(ak[l], x[l].y, acc[k][1]);
      acc[k][2] = fmaf(ak[l], x[l].z, acc[k][2]);
      acc[k][3] = fmaf(ak[l], x[l].w, acc[k][3]);
    }
  }
}

// acc[k][l] += a.k * x.l: one step of a product over a shared index
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 x) {
  const float ak[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[k][0] = fmaf(ak[k], x.x, acc[k][0]);
    acc[k][1] = fmaf(ak[k], x.y, acc[k][1]);
    acc[k][2] = fmaf(ak[k], x.z, acc[k][2]);
    acc[k][3] = fmaf(ak[k], x.w, acc[k][3]);
  }
}

// Stage rows x cols of a (row stride rs, unit column stride) matrix into
// shared memory with leading dimension ld, zeros past n_rows and n_cols.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t rs, int n_rows, int n_cols,
                                      int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, q = idx % cols;
    dst[r * ld + q] = r < n_rows && q < n_cols ? to_f32(src[r * rs + q])
                                               : 0.0f;
  }
}

// dt of head h of chunk (b, c) and its cum, left to right as the forward
// sums it; padded positions take dt 0 and repeat the last cum, so every
// exp stays finite.  cum is written by one thread: call __syncthreads()
// between stage_dt and cum_of.
__device__ __forceinline__ void stage_dt(float* dts, const Args& a, int b,
                                         int c, int h, int Qp) {
  for (int j = threadIdx.x; j < Qp; j += kThreads)
    dts[j] = j < a.Q ? a.dt[b * a.dsb + c * a.dsc + j * a.dsq + h] : 0.0f;
}
__device__ __forceinline__ float a_of(const Args& a, int b, int h) {
  return a.A[b * a.asb + h];
}
__device__ __forceinline__ void cum_of(float* cum, const float* dts,
                                       float Ah, int Q, int Qp) {
  float s = 0.0f;
  for (int j = 0; j < Q; ++j) {
    s = __fadd_rn(s, __fmul_rn(dts[j], Ah));
    cum[j] = s;
  }
  for (int j = Q; j < Qp; ++j) cum[j] = s;
}

// ---------------------------------------------------------------------------
// 1. states pass
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int states_smem_floats(int Qp, int Np,
                                                           int Pp) {
  return Qp * (Np + 4)          // B [j][n]
       + (Qp + Np) * (Pp + 4)   // xdt [j][p], dstate [n][p]
       + Qp * (Pp / 4)          // U . xdt partials [j][p tile]
       + 3 * Qp;                // dt, cum, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_states_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int Q = a.Q, N = a.N, P = a.P;
  const int Qp = round4(Q), Np = round4(N), Pp = round4(P);
  const int Qt = Qp / 4, Nt = Np / 4, Pt = Pp / 4;
  const int ldb = Np + 4, ldx = Pp + 4;
  float* Bs = reinterpret_cast<float*>(smem4);
  float* Xs = Bs + Qp * ldb;
  float* Ds = Xs + Qp * ldx;
  float* part = Ds + Np * ldx;
  float* dts = part + Qp * Pt;
  float* cum = dts + Qp;
  float* w = cum + Qp;

  const int g = blockIdx.x, h0 = g * kHeads, nh = min(kHeads, a.H - h0);
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int64_t bc = static_cast<int64_t>(b) * a.nc + c;
  const T* x = static_cast<const T*>(a.x);

  stage(Bs, ldb, static_cast<const T*>(a.bm) + b * a.bsb + c * a.bsc,
        a.bsq, Q, N, Qp, Np);
  // sum over the block's heads of (w o xdt) dstate^T: tiles tid and
  // tid + kThreads of the (Qt x Nt) grid, kept by this thread throughout
  float vacc[2][4][4] = {};

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    stage_dt(dts, a, b, c, h, Qp);
    __syncthreads();          // dt is in; the last head's reads are done
    if (tid == 0) cum_of(cum, dts, a_of(a, b, h), Q, Qp);
    for (int idx = tid; idx < Qp * Pp; idx += kThreads) {
      const int j = idx / Pp, p = idx % Pp;
      Xs[j * ldx + p] = j < Q && p < P
          ? to_f32(x[b * a.xsb + c * a.xsc + j * a.xsq + h * a.xsh + p])
                * dts[j]
          : 0.0f;
    }
    stage(Ds, ldx, a.dst + (bc * a.H + h) * N * P, P, N, P, Np, Pp);
    __syncthreads();
    for (int j = tid; j < Qp; j += kThreads) w[j] = expf(cum[Q - 1] - cum[j]);
    __syncthreads();

    // U = B dstate, a 4 x 4 tile (rows j, columns p) each
    for (int t = tid; t < Qt * Pt; t += kThreads) {
      const int jt = t / Pt, pt = t % Pt;
      float acc[4][4] = {};
      for (int n = 0; n < Np; n += 4) {
        float4 br[4], dr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          br[k] = ld4(Bs + (4 * jt + k) * ldb + n);
          dr[k] = ld4(Ds + (n + k) * ldx + 4 * pt);
        }
        fma4x4(acc, br, dr);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jt + k;
        const float4 xr = ld4(Xs + j * ldx + 4 * pt);
        part[j * Pt + pt] = dot4(make_float4(acc[k][0], acc[k][1], acc[k][2],
                                             acc[k][3]), xr, 0.0f);
        if (j >= Q) continue;
        float* out = a.wu + ((bc * a.H + h) * Q + j) * P;
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (4 * pt + l < P) out[4 * pt + l] = w[j] * acc[k][l];
      }
    }
    // (w o xdt) dstate^T, summed over the heads into vacc
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = tid + r * kThreads;
      if (t >= Qt * Nt) break;
      const int jt = t / Nt, nt = t % Nt;
      float v[4][4] = {};
      for (int p = 0; p < Pp; p += 4) {
        float4 xr[4], dr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          xr[k] = ld4(Xs + (4 * jt + k) * ldx + p);
          dr[k] = ld4(Ds + (4 * nt + k) * ldx + p);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) v[k][l] = dot4(xr[k], dr[l], v[k][l]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l)
          vacc[r][k][l] = fmaf(w[4 * jt + k], v[k][l], vacc[r][k][l]);
    }
    __syncthreads();          // the partials of dw are in
    for (int j = tid; j < Q; j += kThreads) {
      float s = 0.0f;
      for (int pt = 0; pt < Pt; ++pt) s += part[j * Pt + pt];
      a.dw[(bc * a.H + h) * Q + j] = s;
    }
  }

  float* out = a.dbx + ((static_cast<int64_t>(g) * a.B + b) * a.nc + c)
                       * Q * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tid + r * kThreads;
    if (t >= Qt * Nt) break;
    const int jt = t / Nt, nt = t % Nt;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int j = 4 * jt + k, n = 4 * nt + l;
        if (j < Q && n < N) out[j * N + n] = vacc[r][k][l];
      }
  }
}

// ---------------------------------------------------------------------------
// 2. scan pass
// ---------------------------------------------------------------------------

// The per-head region: M (packed), xdt and dy [j][p], G's sums per tile
// [k][slot] and the partials of sum_p d(xdt) x [j][p tile].  At the start
// it holds B and C, from which S is formed.
__host__ __device__ __forceinline__ int region_floats(int Qp, int Np,
                                                      int Pp) {
  const int bc = 2 * Qp * (Np + 4);
  const int head = tri_off(Qp) + 2 * Qp * (Pp + 4) + Qp * (Qp / 4 + 1)
                   + Qp * (Pp / 4);
  return bc > head ? bc : head;
}

__host__ __device__ __forceinline__ int scan_smem_floats(int Qp, int Np,
                                                         int Pp) {
  return 2 * tri_off(Qp)              // S, D (packed)
       + region_floats(Qp, Np, Pp)
       + 5 * kHeads * Qp              // cum, dt, G's da, sum_p d(xdt) x, dw w
       + 3 * Qp;                      // dw, column sums, diagonal blocks
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_scan_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int Q = a.Q, N = a.N, P = a.P;
  const int Qp = round4(Q), Np = round4(N), Pp = round4(P);
  const int Qt = Qp / 4, Pt = Pp / 4, ldb = Np + 4, ldx = Pp + 4;
  const int tri = tri_off(Qp), ntri = Qt * (Qt + 1) / 2, lg = Qt + 1;
  float* Sp = reinterpret_cast<float*>(smem4);
  float* Dp = Sp + tri;
  float* region = Dp + tri;
  float* Bs = region;
  float* Cs = region + Qp * ldb;
  float* Mp = region;
  float* Xs = Mp + tri;
  float* Ys = Xs + Qp * ldx;
  // G's sums: row k, slot jt <= k / 4 the row sum of tile (k / 4, jt);
  // slot it + 1, it >= k / 4, the column sum of tile (it, k / 4)
  float* RG = Ys + Qp * ldx;
  float* xpart = RG + Qp * lg;
  float* cum = region + region_floats(Qp, Np, Pp);   // [kHeads][Qp] each
  float* dts = cum + kHeads * Qp;
  float* dag = dts + kHeads * Qp;                    // G's part of da
  float* xs = dag + kHeads * Qp;
  float* dww = xs + kHeads * Qp;
  float* dwv = dww + kHeads * Qp;                    // [Qp] each
  float* colw = dwv + Qp;     // column j: G summed over the tiles below j's
  float* diag = colw + Qp;    // sum_{i >= r > j} G_ij inside r's own tile

  const int g = blockIdx.x, h0 = g * kHeads, nh = min(kHeads, a.H - h0);
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int64_t bc = static_cast<int64_t>(b) * a.nc + c;
  const T* x = static_cast<const T*>(a.x);
  T* dx = static_cast<T*>(a.dx);
  const bool states = a.dst != nullptr;

  stage(Bs, ldb, static_cast<const T*>(a.bm) + b * a.bsb + c * a.bsc,
        a.bsq, Q, N, Qp, Np);
  stage(Cs, ldb, static_cast<const T*>(a.cm) + b * a.csb + c * a.csc,
        a.csq, Q, N, Qp, Np);
  for (int e = tid; e < tri; e += kThreads) Dp[e] = 0.0f;
  __syncthreads();
  for (int t = tid; t < ntri; t += kThreads) {
    int it, jt;
    tri_tile(t, &it, &jt);
    float acc[4][4] = {};
    for (int n = 0; n < Np; n += 4) {
      float4 cr[4], br[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cr[k] = ld4(Cs + (4 * it + k) * ldb + n);
        br[k] = ld4(Bs + (4 * jt + k) * ldb + n);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[k][l] = dot4(cr[k], br[l], acc[k][l]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(Sp + tri_off(4 * it + k) + 4 * jt) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
  __syncthreads();            // S is formed: B and C are no longer needed

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    float* cu = cum + hh * Qp;
    float* dd = dts + hh * Qp;
    stage_dt(dd, a, b, c, h, Qp);
    for (int j = tid; j < Qp; j += kThreads)
      dwv[j] = states && j < Q ? a.dw[(bc * a.H + h) * Q + j] : 0.0f;
    __syncthreads();          // dt is in; the last head's reads are done
    if (tid == 0) cum_of(cu, dd, a_of(a, b, h), Q, Qp);
    for (int idx = tid; idx < Qp * Pp; idx += kThreads) {
      const int j = idx / Pp, p = idx % Pp;
      Xs[j * ldx + p] = j < Q && p < P
          ? to_f32(x[b * a.xsb + c * a.xsc + j * a.xsq + h * a.xsh + p])
                * dd[j]
          : 0.0f;
    }
    stage(Ys, ldx, a.dy + (bc * Q * a.H + h) * P,
          static_cast<int64_t>(a.H) * P, Q, P, Qp, Pp);
    __syncthreads();

    // dM = dy xdt^T on the lower-triangular tiles; M, D and G's sums
    for (int t = tid; t < ntri; t += kThreads) {
      int it, jt;
      tri_tile(t, &it, &jt);
      float dm[4][4] = {};
      for (int p = 0; p < Pp; p += 4) {
        float4 yr[4], xr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          yr[k] = ld4(Ys + (4 * it + k) * ldx + p);
          xr[k] = ld4(Xs + (4 * jt + k) * ldx + p);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) dm[k][l] = dot4(yr[k], xr[l], dm[k][l]);
      }
      float rs[4] = {}, cs[4] = {}, gv[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * it + k;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int j = 4 * jt + l, e = tri_off(i) + j;
          gv[k][l] = 0.0f;
          if (j <= i) {
            const float L = expf(cu[i] - cu[j]);
            const float m = Sp[e] * L;
            gv[k][l] = dm[k][l] * m;
            Mp[e] = m;
            Dp[e] = fmaf(dm[k][l], L, Dp[e]);
            rs[k] += gv[k][l];
            cs[l] += gv[k][l];
          } else {
            Mp[e] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        RG[(4 * it + k) * lg + jt] = rs[k];
        RG[(4 * jt + k) * lg + it + 1] = cs[k];
      }
      if (it == jt) {
        // r = 4 it + m: sum over i >= r > j inside the tile
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float s = 0.0f;
#pragma unroll
          for (int k = m; k < 4; ++k)
#pragma unroll
            for (int l = 0; l < m; ++l) s += gv[k][l];
          diag[4 * it + m] = s;
        }
      }
    }
    __syncthreads();

    // Row i: its row sums' exclusive prefix over the tile columns, in
    // place (slot jt <- the sum over tiles jt' < jt); column j: its column
    // sums over the tiles below j's own.  And w's term of dcum.
    for (int i = tid; i < Qp; i += kThreads) {
      const int it = i / 4;
      float run = 0.0f;
      for (int q = 0; q <= it; ++q) {
        const float v = RG[i * lg + q];
        RG[i * lg + q] = run;
        run += v;
      }
      float below = 0.0f;
      for (int q = it + 2; q <= Qt; ++q) below += RG[i * lg + q];
      colw[i] = below;
      if (i < Q) dww[hh * Qp + i] = dwv[i] * expf(cu[Q - 1] - cu[i]);
    }
    // d(xdt) = M^T dy + w o U, a 4 x 4 tile (rows j, columns p) each
    for (int t = tid; t < Qt * Pt; t += kThreads) {
      const int jt = t / Pt, pt = t % Pt;
      float acc[4][4] = {};
      for (int i = 4 * jt; i < Qp; ++i)
        outer4(acc, ld4(Mp + tri_off(i) + 4 * jt), ld4(Ys + i * ldx + 4 * pt));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jt + k;
        if (j >= Q) break;
        const int64_t row = (bc * Q + j) * a.H + h;
        const T* xr = x + b * a.xsb + c * a.xsc + j * a.xsq + h * a.xsh;
        const float* ur = a.wu + ((bc * a.H + h) * Q + j) * P;
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int p = 4 * pt + l;
          if (p >= P) break;
          const float v = states ? acc[k][l] + ur[p] : acc[k][l];
          s = fmaf(v, to_f32(xr[p]), s);
          dx[row * P + p] = from_f32<T>(v * dd[j]);
        }
        xpart[j * Pt + pt] = s;
      }
    }
    __syncthreads();          // the partials of sum_p d(xdt) x are in
    for (int j = tid; j < Q; j += kThreads) {
      float s = 0.0f;
      for (int pt = 0; pt < Pt; ++pt) s += xpart[j * Pt + pt];
      xs[hh * Qp + j] = s;
      // G over i >= r > j, r = j: rows i >= r over the tile columns left
      // of r's, then the columns of r's tile left of r below its tile,
      // then r's own tile
      const int rt = j / 4;
      float g = 0.0f;
      for (int i = j; i < Qp; ++i) g += RG[i * lg + rt];
      for (int c = 4 * rt; c < j; ++c) g += colw[c];
      dag[hh * Qp + j] = g + diag[j];
    }
  }
  __syncthreads();

  // dcum's terms at the chunk's end, its reverse sum, ddt and dA: one lane
  // a head, positions in order
  if (tid < nh) {
    const int hh = tid, h = h0 + hh;
    const float* cu = cum + hh * Qp;
    const float* dd = dts + hh * Qp;
    const float Ah = a_of(a, b, h);
    float tot = 0.0f;
    for (int k = 0; k < Q; ++k) tot += dww[hh * Qp + k];
    float last = tot - dww[hh * Qp + Q - 1];
    if (a.ddec != nullptr)
      last += a.ddec[bc * a.H + h] * expf(cu[Q - 1]);
    float run = 0.0f, dA = 0.0f;
    for (int j = Q - 1; j >= 0; --j) {
      run += j == Q - 1 ? last : -dww[hh * Qp + j];
      const float da = run + dag[hh * Qp + j];
      a.ddt[(bc * Q + j) * a.H + h] = da * Ah + xs[hh * Qp + j];
      dA = fmaf(da, dd[j], dA);
    }
    a.dapart[bc * a.H + h] = dA;
  }
  float* dpart = a.dpart + ((static_cast<int64_t>(g) * a.B + b) * a.nc + c)
                           * tri;
  for (int e = tid; e < tri; e += kThreads) dpart[e] = Dp[e];
}

// ---------------------------------------------------------------------------
// 3. B and C pass
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int bc_smem_floats(int Qp, int Np) {
  return tri_off(Qp) + 2 * Qp * (Np + 4);      // D (packed), B, C
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_bc_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int Q = a.Q, N = a.N;
  const int Qp = round4(Q), Np = round4(N), Qt = Qp / 4, Nt = Np / 4;
  const int ldb = Np + 4, tri = tri_off(Qp);
  float* Dp = reinterpret_cast<float*>(smem4);
  float* Bs = Dp + tri;
  float* Cs = Bs + Qp * ldb;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int64_t bc = static_cast<int64_t>(b) * a.nc + c;
  const int64_t stride_g = static_cast<int64_t>(a.B) * a.nc;

  for (int e = tid; e < tri; e += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < a.groups; ++g) s += a.dpart[(g * stride_g + bc) * tri + e];
    Dp[e] = s;
  }
  stage(Bs, ldb, static_cast<const T*>(a.bm) + b * a.bsb + c * a.bsc,
        a.bsq, Q, N, Qp, Np);
  stage(Cs, ldb, static_cast<const T*>(a.cm) + b * a.csb + c * a.csc,
        a.csq, Q, N, Qp, Np);
  __syncthreads();

  T* dcm = static_cast<T*>(a.dcm) + bc * Q * N;
  T* dbm = static_cast<T*>(a.dbm) + bc * Q * N;
  for (int t = tid; t < Qt * Nt; t += kThreads) {
    const int rt = t / Nt, nt = t % Nt;
    // dC_i = sum_{j <= i} D_ij B_j, rows i of tile rt
    float acc[4][4] = {};
    for (int j = 0; j < 4 * rt + 4; j += 4) {
      float4 dr[4], br[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dr[k] = ld4(Dp + tri_off(4 * rt + k) + j);
        br[k] = ld4(Bs + (j + k) * ldb + 4 * nt);
      }
      fma4x4(acc, dr, br);
    }
    // dB_j = sum_{i >= j} D_ij C_i + the states' term, rows j of tile rt
    float acb[4][4] = {};
    for (int i = 4 * rt; i < Qp; ++i)
      outer4(acb, ld4(Dp + tri_off(i) + 4 * rt), ld4(Cs + i * ldb + 4 * nt));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * rt + k;
      if (r >= Q) break;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int n = 4 * nt + l;
        if (n >= N) break;
        float vb = acb[k][l];
        if (a.dst != nullptr)
          for (int g = 0; g < a.groups; ++g)
            vb += a.dbx[(g * stride_g + bc) * Q * N + r * N + n];
        dcm[r * N + n] = from_f32<T>(acc[k][l]);
        dbm[r * N + n] = from_f32<T>(vb);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dA
// ---------------------------------------------------------------------------

__global__ void ssd_bwd_a_kernel(const Args a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (a.a_rows) {
    if (idx >= a.B * a.H) return;
    const int b = idx / a.H, h = idx % a.H;
    float s = 0.0f;
    for (int c = 0; c < a.nc; ++c)
      s += a.dapart[(static_cast<int64_t>(b) * a.nc + c) * a.H + h];
    a.dA[idx] = s;
  } else {
    if (idx >= a.H) return;
    float s = 0.0f;
    for (int64_t bc = 0; bc < static_cast<int64_t>(a.B) * a.nc; ++bc)
      s += a.dapart[bc * a.H + idx];
    a.dA[idx] = s;
  }
}

int smem_attr(const void* fn, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int launch(const Args& a, cudaStream_t s) {
  const int Qp = round4(a.Q), Np = round4(a.N), Pp = round4(a.P);
  const dim3 grid(a.groups, a.nc, a.B);
  int err;
  if (a.dst != nullptr) {
    const int bytes = states_smem_floats(Qp, Np, Pp) * 4;
    if ((err = smem_attr(reinterpret_cast<const void*>(
             &ssd_bwd_states_kernel<T>), bytes)))
      return err;
    ssd_bwd_states_kernel<T><<<grid, kThreads, bytes, s>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  int bytes = scan_smem_floats(Qp, Np, Pp) * 4;
  if ((err = smem_attr(reinterpret_cast<const void*>(&ssd_bwd_scan_kernel<T>),
                       bytes)))
    return err;
  ssd_bwd_scan_kernel<T><<<grid, kThreads, bytes, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  bytes = bc_smem_floats(Qp, Np) * 4;
  if ((err = smem_attr(reinterpret_cast<const void*>(&ssd_bwd_bc_kernel<T>),
                       bytes)))
    return err;
  ssd_bwd_bc_kernel<T><<<dim3(a.nc, a.B), kThreads, bytes, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int outs = a.a_rows ? a.B * a.H : a.H;
  ssd_bwd_a_kernel<<<(outs + 255) / 256, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

struct Workspace {
  int64_t wu, dw, dbx, dpart, dapart, total;
};

Workspace workspace(int B, int nc, int Q, int H, int P, int N,
                    int has_states) {
  const int64_t groups = (H + kHeads - 1) / kHeads;
  const int64_t bch = static_cast<int64_t>(B) * nc * H;
  Workspace w;
  w.wu = 0;
  w.dw = w.wu + (has_states ? bch * Q * P : 0);
  w.dbx = w.dw + (has_states ? bch * Q : 0);
  w.dpart = w.dbx + (has_states ? groups * B * nc * Q * N : 0);
  w.dapart = w.dpart + groups * B * nc * tri_off(round4(Q));
  w.total = w.dapart + bch;
  return w;
}

}  // namespace

extern "C" {

// Floats of float32 workspace that ssd_chunk_bwd_launch needs.
int64_t ssd_chunk_bwd_workspace_floats(int B, int nc, int Q, int H, int P,
                                       int N, int has_states) {
  return workspace(B, nc, Q, H, P, N, has_states).total;
}

// x (B, nc, Q, H, P), Bm and Cm (B, nc, Q, N) in the given dtype (0 =
// float32, 1 = bf16), dt (B, nc, Q, H) float32, each with unit stride along
// its last axis and the given element strides along the others; A float32
// with batch stride asb and unit stride along H.  dy (B, nc, Q, H, P),
// dstate (B, nc, H, N, P) and ddecay (B, nc, H) float32 and contiguous
// (dstate and ddecay may be null).  dx (x's dtype, shape and contiguous),
// ddt (B, nc, Q, H) float32, dBm and dCm (Bm's dtype, (B, nc, Q, N)) and dA
// ((B, H) if a_rows, else (H,)) float32 are written; ws holds
// ssd_chunk_bwd_workspace_floats floats.  1 <= Q, N <= 128, 1 <= P <= 64.
// Returns a cudaError_t.
int ssd_chunk_bwd_launch(const void* x, const void* dt, const void* A,
                         const void* bm, const void* cm, const void* dy,
                         const void* dst, const void* ddec, void* dx,
                         void* ddt, void* dA, void* dbm, void* dcm, void* ws,
                         int dtype, int B, int nc, int Q, int H, int P, int N,
                         int64_t xsb, int64_t xsc, int64_t xsq, int64_t xsh,
                         int64_t dsb, int64_t dsc, int64_t dsq, int64_t bsb,
                         int64_t bsc, int64_t bsq, int64_t csb, int64_t csc,
                         int64_t csq, int64_t asb, int a_rows, void* stream) {
  if (Q < 1 || Q > kMaxQN || N < 1 || N > kMaxQN || P < 1 || P > kMaxP
      || H < 1 || nc < 1 || B < 1 || nc > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Workspace w = workspace(B, nc, Q, H, P, N, dst != nullptr);
  float* f = static_cast<float*>(ws);
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               bm, cm, static_cast<const float*>(dy),
               static_cast<const float*>(dst),
               static_cast<const float*>(ddec), dx, static_cast<float*>(ddt),
               static_cast<float*>(dA), dbm, dcm, f + w.wu, f + w.dw,
               f + w.dbx, f + w.dpart, f + w.dapart, B, nc, Q, H, P, N,
               (H + kHeads - 1) / kHeads, xsb, xsc, xsq, xsh, dsb, dsc, dsq,
               bsb, bsc, bsq, csb, csc, csq, asb, a_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
