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
// bf16 inputs) its ~0.51 GB of traffic takes 0.154 ms at 3.35 TB/s, and the
// products it needs, ~33 GFLOP (S, D^T C and D B once per chunk on the
// lower triangle; per head dM and M^T dy on the lower triangle, U and
// (w o xdt) dstate^T in full), 0.033 ms at the bf16 tensor cores' 989
// TFLOP/s.  No atomics anywhere: every sum runs in a fixed order, so reruns
// are bitwise and strided and contiguous inputs give the same bits.  Two
// routes, chosen in ssd_chunk_bwd_launch by dtype.
//
// * bf16: the tensor cores (namespace tc), three launches.
//   1. ssd_bwd_kernel_mma, one block per (8 heads, chunk, batch row), 8
//      warps, one block an SM.  B and C are staged in bf16 by cp.async
//      into the XOR-swizzled layout the forward uses; S^T = B C^T runs once
//      a block on the 36 tiles j <= i of 16 x 16 (mma.sync m16n8k16, exact
//      bf16 products summed in float32) and stays in shared memory as
//      float32 fragments.  cum is the forward's left-to-right float32 sum,
//      one lane a head for all the block's heads at once (a parallel scan
//      would reorder the sum, and L would no longer be the forward's).
//      Per head, with the next head's x (bf16) double-buffered and dstate
//      and dy staged as float32 by cp.async while the block computes, then
//      split in place into bf16 hi + lo:
//        - states: U = B dstate (B exact, dstate hi + lo), d(xdt) = w o U
//          and dw_j; then w_j dt_j (x dstate^T)_jn (x exact, dstate hi +
//          lo) summed over the block's heads in registers (dB's states
//          term, 64 a thread);
//        - scan, in the transposed frame, warp w on the tiles (j strip,
//          i strip >= j strip) of its strip of j (warps w and w + 4, one
//          SM sub-partition, hold strips s and 7 - s: 9 tiles): dM^T =
//          dt_j (x dy^T) with x exact and dy hi + lo; M^T = S^T o L^T
//          formed in registers (exp on the special function unit, only for
//          i >= j), G = dM o M and D^T += dM o L element by element in
//          float32 (D^T over the block's heads in shared memory, each tile
//          owned by one warp); M^T dy with M split hi + lo and dy hi + lo,
//          of which hi.hi, hi.lo and lo.hi are formed, accumulated onto
//          d(xdt) (the accumulator layout of M^T is the next product's A
//          layout, so M never leaves registers); dx and sum_p d(xdt) x;
//        - G's part of da as the block i >= r > j of G, from each tile's
//          column sums (rows below r's strip), its row sums (r's strip
//          left of r) and the diagonal tile's elements, never as row sums
//          minus column sums; dcum's states and decay terms summed from the
//          left (sum_{j < r} dw_j w_j + ddecay decay, one value with the
//          plain version's right-to-left form); ddt and the block's part of
//          dA, one warp a strip.
//      Writes D^T's and dB's states partials (float32) per head group.
//   2. ssd_bwd_bc_kernel_mma, two blocks per (chunk, batch row): the
//      groups' partials of D summed in group order and split into bf16 hi
//      + lo; dC = D B (one block) and dB = D^T C + the states' partials
//      (the other), B and C exact, D^T by ldmatrix.trans of D.
//   3. ssd_bwd_a_kernel: dA per batch row (A per row) or over the batch.
//   Q, N and P are zero-padded to 16 in shared memory (P to 64 and N to 128
//   whole, so the unrolled loops over them run without a test between
//   steps, which lets the compiler hoist the next shared-memory read over
//   the current products).
//   The splits: ddt and dA are float32 outputs held to 1e-4 of the lane
//   plus 1e-4 of the largest magnitude, and they sum dM, M^T dy, U and G
//   over many terms.  tests/test_torch_ssd_bwd_numerics.py emulates this
//   route's arithmetic on the CPU: one bf16 dy, one bf16 M (M^T dy's lo.hi
//   dropped), hi.lo dropped, one bf16 dstate and one bf16 D each put lanes
//   over (on the card too: chip_ssd_bwd_ablation.py's dy_single, m_single,
//   no_hi_lo, dstate_single and d_single), while the three products of
//   M^T dy keep the worst ddt lane at 3-6% of its limit on the card.  M's
//   third term, which the forward's M' needs, and the lo.lo product are
//   below that: kept, they take the worst ddt lane from 3.3% of its limit
//   to 2.9% and 2.3%, at +0.01-0.03 ms and within 0.01 ms (m_three and
//   lo_lo).  Each split pair, and M^T dy's three products, is summed by
//   the tensor cores from zero and added to its running float32 sum by the
//   float32 unit (the tensor cores' float32 adds truncate:
//   flash_attention_bwd.cu); a tile's dM^T is at most 4 steps of 16 from
//   zero for each term.
//   The exponential: L_ij is ex2.approx.ftz of (cum_i - cum_j) log2 e on
//   the special function unit (exp_sfu), where the forward's L and this
//   kernel's w and decay take the accurate expf; so the L differentiated
//   here may differ from the forward's in its last bits (the product's
//   rounding and ex2.approx's ~2 ulp).  The CPU emulation models the
//   product's rounding but not ex2.approx's own error: chip_smoke.py's
//   ssd_backward cases on the card hold that, and expf in its place costs
//   ~0.1 ms (chip_ssd_bwd_ablation.py's ``expf``).
//   Shared memory of ssd_bwd_kernel_mma at the largest shape (bytes): B
//   32,768; C, then S^T, 36,864; D^T 36,864; x 2 x 16,384; dy 32,768 and
//   dstate 32,768 (float32, then their hi and lo halves); cum, dt and w of
//   8 heads 12,288; one head's sums of G, its dw w and sum_p d(xdt) x, the
//   diagonal tiles of G, A and the decay terms 14,144: 231,232 of the
//   232,448 a block may hold.  So neither a second block an SM nor the
//   x/dy/dstate double buffers of the next head fit, and the kernel runs 8
//   warps an SM at 255 registers: the time goes to the latency of its
//   dependent mma.sync, shared-memory and shuffle chains more than to
//   bytes or products (chip_ssd_bwd_ablation.py: no_reads, no_states,
//   no_scan).
// * float32: the CUDA cores (the states, scan and bc kernels below, with
//   ssd_bwd_a_kernel); TF32 would not hold 1e-4.  Every product in float32,
//   each thread a 4 x 4 tile fed by 16-byte shared-memory loads (~2 bytes
//   of shared memory an FMA).  At Q = N = 128 float32 copies of S, one
//   head's L (as M), B and C alone pass the 227 KB a block may hold, so
//   the work is cut in four launches:
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
//  The kernels are templates over the input type, instantiated here for
//  float32 only (chip_ssd_bwd_ablation.py's ``parent`` instantiates them
//  for bf16 in its copy of this file, to time the design the tensor-core
//  route replaced).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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
  int vec_x, vec_bc, vec_f;     // 16-byte copies allowed (bf16 route)
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStrips = kMaxQN / 16;                 // 16-row strips of Q
constexpr int kTri = kStrips * (kStrips + 1) / 2;    // 16 x 16 tiles, j <= i
constexpr int kTriPerWarp = (kTri + kWarps - 1) / kWarps;
constexpr int kKP = kMaxP / 16;                      // 16-wide steps of P
constexpr int kPT = kMaxP / 8;                       // 8-column tiles of P
constexpr int kNT = kMaxQN / 8;                      // 8-column tiles of N
constexpr int kTileBytes = 32 * 8 * 4;     // a float32 16 x 16 tile, fragments
constexpr int kBcBytes = kMaxQN * kMaxQN * 2;        // B or C, bf16
constexpr int kSBytes = kTri * kTileBytes;           // S^T or D^T
constexpr int kHalf = kMaxQN * kMaxP * 2;            // a (Q | N) x P bf16 tile
constexpr int kRawBytes = 2 * kHalf;      // its float32, or its hi and lo
constexpr int kVecFloats = kHeads * kMaxQN;          // cum, dt or w
constexpr int kScratchFloats = kMaxQN * kStrips      // E
                               + 3 * kMaxQN          // cb, dww, xs
                               + kHeads * kStrips    // dA by strip
                               + kStrips * 256       // diagonal tiles of G
                               + 2 * kHeads;         // A, ddecay decay
constexpr int kSmemBytes = kBcBytes + 2 * kSBytes + 2 * kHalf
                           + 2 * kRawBytes
                           + (3 * kVecFloats + kScratchFloats) * 4;
// D hi, D lo, B, C; dB's states partials summed (float32)
constexpr int kBcSmemBytes = 4 * kBcBytes + kMaxQN * kMaxQN * 4;
static_assert(kSBytes >= kBcBytes, "C is staged where S^T is kept");
static_assert(kSmemBytes <= 232448, "one block an SM");
static_assert(kWarps == kStrips, "a warp a strip");

// tensor_core.cuh's swizzled rows: B, C and D rows are 256 bytes (N, Q <=
// 128), x, dy and dstate rows 128 bytes (P <= 64).
__device__ __forceinline__ uint32_t swz16(int r, int c) {
  return Swizzle<kMaxQN>::off(r, c);
}
__device__ __forceinline__ uint32_t swz8(int r, int c) {
  return Swizzle<kMaxP>::off(r, c);
}

// Copy `rows` rows of kMaxP floats of a float32 matrix (row stride ld
// floats, unit column stride; n_rows x n_cols real, zeros past them) by
// cp.async to shared memory at dst, row stride kMaxP floats: 16 bytes a
// copy with vec (n_cols and ld multiples of 4, src 16-byte aligned), else
// 4.  Row widths are constants, so no index needs a division.
__device__ __forceinline__ void stage_f32(uint32_t dst, const float* src,
                                          int ld, int n_rows, int n_cols,
                                          int rows, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (kMaxP / 4); idx += kThreads) {
      const int r = idx / (kMaxP / 4), q = 4 * (idx % (kMaxP / 4));
      const bool in = r < n_rows && q < n_cols;
      cp_async16(dst + idx * 16, in ? src + r * ld + q : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kMaxP; idx += kThreads) {
      const int r = idx / kMaxP, q = idx % kMaxP;
      const bool in = r < n_rows && q < n_cols;
      cp_async4(dst + idx * 4, in ? src + r * ld + q : src, in ? 4 : 0);
    }
  }
}

// The float32 tile at off (rows x kMaxP), in place, as bf16 hi = bf16(v)
// at off and lo = bf16(v - hi) at off + kHalf, each in the swz8 layout.
// Reads, syncs, writes: the caller syncs after.
__device__ __forceinline__ void split_tile(unsigned char* smem, uint32_t off,
                                           int rows) {
  constexpr int kItems = kMaxQN * (kMaxP / 8) / kThreads;
  constexpr int chunks = kMaxP / 8;                // 8 columns each
  float4 v[kItems][2];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    if (idx < rows * chunks) {
      const float4* p = reinterpret_cast<const float4*>(smem + off) + 2 * idx;
      v[k][0] = p[0];
      v[k][1] = p[1];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    if (idx < rows * chunks) {
      const int r = idx / chunks, ch = idx % chunks;
      uint32_t hi[4], lo[4];
      split(v[k][0].x, v[k][0].y, &hi[0], &lo[0]);
      split(v[k][0].z, v[k][0].w, &hi[1], &lo[1]);
      split(v[k][1].x, v[k][1].y, &hi[2], &lo[2]);
      split(v[k][1].z, v[k][1].w, &hi[3], &lo[3]);
      *reinterpret_cast<uint4*>(smem + off + swz8(r, ch)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(smem + off + kHalf + swz8(r, ch)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// c += a (bh + bl), the pair summed by the tensor cores from zero and added
// to c by the float32 unit (the tensor cores' float32 adds truncate).
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(s, a, bh0, bh1);
  mma_bf16(s, a, bl0, bl1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];
}
// c += (ah + al) b, the same way
__device__ __forceinline__ void mma2a(float (&c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t b0,
                                      uint32_t b1) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(s, ah, b0, b1);
  mma_bf16(s, al, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];
}
// c += ah bh + ah bl + al bh (al bl is below what the limits see)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(s, ah, bh0, bh1);
  mma_bf16(s, ah, bl0, bl1);
  mma_bf16(s, al, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];
}

__device__ __forceinline__ float warp_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}
// v[r], r < 16, summed over the warp's 32 lanes; lane l (and l + 16) gets
// the sum of v[l & 15]: each step keeps the half of the values its lane
// bit selects and adds its partner's copy of that half.
template <int W>
__device__ __forceinline__ void scatter_step(float (&v)[16]) {
  const bool up = threadIdx.x & W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float keep = up ? v[k + W] : v[k];
    const float send = up ? v[k] : v[k + W];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}
__device__ __forceinline__ float reduce_scatter16(float (&v)[16]) {
  scatter_step<8>(v);
  scatter_step<4>(v);
  scatter_step<2>(v);
  scatter_step<1>(v);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// Over the 16 lanes l of each half warp: the sum of v over lanes l' < l
// (exclusive) or l' >= l (suffix), in a fixed order.
__device__ __forceinline__ float prefix16(float v) {
  const int l = threadIdx.x & 15;
  float s = __shfl_up_sync(0xffffffffu, v, 1);
  s = l == 0 ? 0.0f : s;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = 1 << k;
    const float u = __shfl_up_sync(0xffffffffu, s, o);
    if (l >= o) s += u;
  }
  return s;
}
__device__ __forceinline__ float suffix16(float v) {
  const int l = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = 1 << k;
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (l + o < 16) v += u;
  }
  return v;
}

// Element e of a lane's 16 x 16 accumulator tile (two m16n8 tiles): row
// g + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 t + (e & 1).
__device__ __forceinline__ int frag_row(int g, int e) {
  return g + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int t, int e) {
  return 8 * (e >> 2) + 2 * t + (e & 1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// exp(x) as 2^(x log2 e) on the special function unit (ex2.approx: 2 ulp)
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ float2 ldx2(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The tile (strip jt of j, strip it of i), it >= jt, of the triangle's
// row-major order tt = it (it + 1) / 2 + jt.
__device__ __forceinline__ void tri_pos(int tt, int* it, int* jt) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= tt) ++r;
  *it = r;
  *jt = tt - r * (r + 1) / 2;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel_mma(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr uint32_t o_b = 0;                      // B [j][n]
  constexpr uint32_t o_s = o_b + kBcBytes;         // C [i][n], then S^T
  constexpr uint32_t o_d = o_s + kSBytes;          // D^T over the heads
  constexpr uint32_t o_x = o_d + kSBytes;          // x [j][p], two buffers
  constexpr uint32_t o_y = o_x + 2 * kHalf;        // dy [i][p]
  constexpr uint32_t o_z = o_y + kRawBytes;        // dstate [n][p]
  // [head][j] each: cum, dt and w_j = exp(cum_{Q-1} - cum_j)
  float* cum = reinterpret_cast<float*>(smem + o_z + kRawBytes);
  float* dts = cum + kVecFloats;
  float* wv = dts + kVecFloats;
  // one head's sums of G = dM o M: E[i][jt] = sum of row i over the tile
  // (jt, i's strip), jt below i's strip; cb[j] = column j over the tiles
  // below j's; gdiag: G^T of each strip's diagonal tile, as fragments
  float* E = wv + kVecFloats;
  float* cb = E + kMaxQN * kStrips;
  float* dww = cb + kMaxQN;                        // dw_j w_j
  float* xs = dww + kMaxQN;                        // sum_p d(xdt) x
  float* dAs = xs + kMaxQN;                        // [head][strip]
  float* gdiag = dAs + kHeads * kStrips;           // [strip][256]
  float* ahd = gdiag + kStrips * 256;  // A of each head, ddecay decay
  const uint32_t sb = smem_u32(smem);

  const int Q = a.Q, N = a.N, P = a.P;
  // P and N are zero-padded to the full 64 and 128 in shared memory, so
  // the unrolled loops over them run whole, without a test between steps
  const int nQ = (Q + 15) / 16, nN = (N + 15) / 16, Qp = 16 * nQ;
  const int grp = blockIdx.x, h0 = grp * kHeads, nh = min(kHeads, a.H - h0);
  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t bc = static_cast<int64_t>(b) * a.nc + c;
  const bool states = a.dst != nullptr;
  // warp w < 4 takes strip w, warp w >= 4 strip 11 - w: an SM sub-partition
  // (warps w and w + 4) then holds strips s and 7 - s, 9 scan tiles
  const int sj = warp < kWarps / 2 ? warp : kWarps + kWarps / 2 - 1 - warp;
  const bool live = sj < nQ;
  const int jA = 16 * sj + g, jB = jA + 8;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(a.bm);
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(a.cm);
  __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(a.dx);
  const bool vec_x = a.vec_x != 0, vec_bc = a.vec_bc != 0;
  const bool vec_f = a.vec_f != 0;

  // B and C (zeros past Q and N), the first head's x and dstate
  {
    const __nv_bfloat16* bb = bm + b * a.bsb + c * a.bsc;
    const __nv_bfloat16* cc = cm + b * a.csb + c * a.csc;
    const int bsq = static_cast<int>(a.bsq), csq = static_cast<int>(a.csq);
    for (int idx = tid; idx < Qp * 16; idx += kThreads) {
      const int r = idx / 16, ch = idx % 16;
      stage16(smem, o_b + swz16(r, ch), bb + r * bsq + 8 * ch, r < Q,
              N - 8 * ch, vec_bc, bm);
      stage16(smem, o_s + swz16(r, ch), cc + r * csq + 8 * ch, r < Q,
              N - 8 * ch, vec_bc, cm);
    }
  }
  cp_async_commit();
  auto stage_x = [&](int hh, int buf) {
    const __nv_bfloat16* xh = x + b * a.xsb + c * a.xsc + (h0 + hh) * a.xsh;
    const int xsq = static_cast<int>(a.xsq);
    for (int idx = tid; idx < Qp * 8; idx += kThreads) {
      const int r = idx / 8, ch = idx % 8;
      stage16(smem, o_x + buf * kHalf + swz8(r, ch), xh + r * xsq + 8 * ch,
              r < Q, P - 8 * ch, vec_x, x);
    }
  };
  auto stage_dst = [&](int hh) {
    if (states)
      stage_f32(sb + o_z, a.dst + (bc * a.H + h0 + hh) * N * P, P, N, P,
                kMaxQN, vec_f);
  };
  stage_x(0, 0);
  cp_async_commit();
  stage_dst(0);
  cp_async_commit();

  // dt of the block's heads, position-major (neighbouring threads read
  // neighbouring heads); zeros in the padding.  D^T starts at zero.
  for (int idx = tid; idx < Qp * kHeads; idx += kThreads) {
    const int j = idx / kHeads, hh = idx % kHeads;
    dts[hh * kMaxQN + j] =
        j < Q && hh < nh ? a.dt[b * a.dsb + c * a.dsc + j * a.dsq + h0 + hh]
                         : 0.0f;
  }
  for (int e = tid; e < kSBytes / 16; e += kThreads)
    reinterpret_cast<float4*>(smem + o_d)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait<2>();                              // B and C have landed
  __syncthreads();

  // cum, one lane a head, left to right as the forward sums it (padded
  // positions repeat the last value, so every exp stays finite)
  if (warp == kWarps - 1 && lane < nh) {
    const float Ah = a_of(a, b, h0 + lane);
    const float* d = dts + lane * kMaxQN;
    float* cu = cum + lane * kMaxQN;
    float s = 0.0f;
    for (int j = 0; j < Q; ++j) {
      s = __fadd_rn(s, __fmul_rn(d[j], Ah));
      cu[j] = s;
    }
    for (int j = Q; j < Qp; ++j) cu[j] = s;
    ahd[lane] = Ah;
    ahd[kHeads + lane] =
        a.ddec != nullptr ? a.ddec[bc * a.H + h0 + lane] * expf(s) : 0.0f;
  }

  // S^T = B C^T on the tiles (jt, it), it >= jt: tile tt to warp
  // tt % kWarps, kept in registers until C is read
  const int n_tri = nQ * (nQ + 1) / 2;
  {
    float sacc[kTriPerWarp][2][4];
#pragma unroll
    for (int k = 0; k < kTriPerWarp; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[k][0][e] = sacc[k][1][e] = 0.0f;
      const int tt = warp + kWarps * k;
      if (tt < n_tri) {
        int it, jt;
        tri_pos(tt, &it, &jt);
        for (int kk = 0; kk < nN; ++kk) {
          uint32_t af[4], bf[4];
          ldsm_x4(sb + o_b + swz16(16 * jt + lane % 16, 2 * kk + lane / 16),
                  af);
          ldsm_x4(sb + o_s + swz16(16 * it + lane % 8 + 8 * (lane / 16),
                                   2 * kk + (lane / 8) % 2), bf);
          mma_bf16(sacc[k][0], af, bf[0], bf[1]);
          mma_bf16(sacc[k][1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                               // C is read; cum is in
#pragma unroll
    for (int k = 0; k < kTriPerWarp; ++k) {
      const int tt = warp + kWarps * k;
      if (tt < n_tri) {
        float4* dst = reinterpret_cast<float4*>(smem + o_s) + 64 * tt + lane;
        dst[0] = make_float4(sacc[k][0][0], sacc[k][0][1], sacc[k][0][2],
                             sacc[k][0][3]);
        dst[32] = make_float4(sacc[k][1][0], sacc[k][1][1], sacc[k][1][2],
                              sacc[k][1][3]);
      }
    }
  }
  for (int idx = tid; idx < nh * Qp; idx += kThreads) {
    const int hh = idx / Qp, j = idx % Qp;
    const float* cu = cum + hh * kMaxQN;
    wv[hh * kMaxQN + j] = expf(cu[Q - 1] - cu[j]);
  }

  // (w o xdt) dstate^T of rows jA and jB, summed over the block's heads
  float dbs[kNT][4];
#pragma unroll
  for (int q = 0; q < kNT; ++q) dbs[q][0] = dbs[q][1] = dbs[q][2] = dbs[q][3] = 0.0f;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const uint32_t xo = o_x + (hh & 1) * kHalf;
    const float* cu = cum + hh * kMaxQN;
    const float* dd = dts + hh * kMaxQN;
    const float* ww = wv + hh * kMaxQN;
    cp_async_wait<0>();
    __syncthreads();          // x and dstate are in; the last head is done
    if (states) split_tile(smem, o_z, kMaxQN);
    stage_f32(sb + o_y, a.dy + (bc * Q * a.H + h) * P, a.H * P, Q, P, Qp,
              vec_f);
    cp_async_commit();
    if (hh + 1 < nh) stage_x(hh + 1, (hh + 1) & 1);
    cp_async_commit();
    __syncthreads();          // dstate's hi and lo are in

    const float djA = dd[jA], djB = dd[jB], wA = ww[jA], wB = ww[jB];
    float dxa[kPT][4];        // d(xdt) of rows jA, jB
#pragma unroll
    for (int q = 0; q < kPT; ++q) dxa[q][0] = dxa[q][1] = dxa[q][2] = dxa[q][3] = 0.0f;
    if (live && states) {
      // U = B dstate (dstate hi + lo), rows jA, jB
      for (int kk = 0; kk < nN; ++kk) {
        uint32_t af[4];
        ldsm_x4(sb + o_b + swz16(16 * sj + lane % 16, 2 * kk + lane / 16), af);
#pragma unroll
        for (int np = 0; np < kKP; ++np) {
          uint32_t zh[4], zl[4];
          const uint32_t zo = swz8(16 * kk + lane % 8 + 8 * ((lane / 8) % 2),
                                   2 * np + lane / 16);
          ldsm_x4_trans(sb + o_z + zo, zh);
          ldsm_x4_trans(sb + o_z + kHalf + zo, zl);
          mma2(dxa[2 * np], af, zh[0], zh[1], zl[0], zl[1]);
          mma2(dxa[2 * np + 1], af, zh[2], zh[3], zl[2], zl[3]);
        }
      }
      // dw_j = xdt_j . U_j, then d(xdt) = w o U
      float sA = 0.0f, sB = 0.0f;
#pragma unroll
      for (int q = 0; q < kPT; ++q) {
        const float2 xA = ldx2(smem + xo + swz8(jA, q) + 4 * t);
        const float2 xB = ldx2(smem + xo + swz8(jB, q) + 4 * t);
        sA = fmaf(dxa[q][0], xA.x, sA);
        sA = fmaf(dxa[q][1], xA.y, sA);
        sB = fmaf(dxa[q][2], xB.x, sB);
        sB = fmaf(dxa[q][3], xB.y, sB);
        dxa[q][0] *= wA;
        dxa[q][1] *= wA;
        dxa[q][2] *= wB;
        dxa[q][3] *= wB;
      }
      sA = quad_sum(sA);
      sB = quad_sum(sB);
      if (t == 0) {
        dww[jA] = sA * djA * wA;
        dww[jB] = sB * djB * wB;
      }
      // (w o xdt) dstate^T = w_j dt_j (x dstate^T)_jn, x exact
      const float vA = wA * djA, vB = wB * djB;
      uint32_t xa[kKP][4];    // x of the strip, A fragments
#pragma unroll
      for (int kp = 0; kp < kKP; ++kp)
        ldsm_x4(sb + xo + swz8(16 * sj + lane % 16, 2 * kp + lane / 16),
                xa[kp]);
#pragma unroll
      for (int nt = 0; nt < kStrips; ++nt) {
        float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float l0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, l1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kp = 0; kp < kKP; ++kp) {
          uint32_t zh[4], zl[4];
          const uint32_t zo = swz8(16 * nt + lane % 8 + 8 * (lane / 16),
                                   2 * kp + (lane / 8) % 2);
          ldsm_x4(sb + o_z + zo, zh);
          ldsm_x4(sb + o_z + kHalf + zo, zl);
          mma_bf16(s0, xa[kp], zh[0], zh[1]);
          mma_bf16(l0, xa[kp], zl[0], zl[1]);
          mma_bf16(s1, xa[kp], zh[2], zh[3]);
          mma_bf16(l1, xa[kp], zl[2], zl[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s0[e] += l0[e];
          s1[e] += l1[e];
        }
        dbs[2 * nt][0] = fmaf(vA, s0[0], dbs[2 * nt][0]);
        dbs[2 * nt][1] = fmaf(vA, s0[1], dbs[2 * nt][1]);
        dbs[2 * nt][2] = fmaf(vB, s0[2], dbs[2 * nt][2]);
        dbs[2 * nt][3] = fmaf(vB, s0[3], dbs[2 * nt][3]);
        dbs[2 * nt + 1][0] = fmaf(vA, s1[0], dbs[2 * nt + 1][0]);
        dbs[2 * nt + 1][1] = fmaf(vA, s1[1], dbs[2 * nt + 1][1]);
        dbs[2 * nt + 1][2] = fmaf(vB, s1[2], dbs[2 * nt + 1][2]);
        dbs[2 * nt + 1][3] = fmaf(vB, s1[3], dbs[2 * nt + 1][3]);
      }
    } else if (live && t == 0) {
      dww[jA] = 0.0f;
      dww[jB] = 0.0f;
    }
    cp_async_wait<1>();
    __syncthreads();          // dy is in; dstate is read
    if (hh + 1 < nh) stage_dst(hh + 1);
    cp_async_commit();
    split_tile(smem, o_y, Qp);
    __syncthreads();          // dy's hi and lo are in

    // The scan over the tiles (st, it), it >= st, of strip st in the
    // transposed frame (rows j of the strip, columns i): D^T, E and the
    // diagonal tile's G written, d(xdt) added to acc and G's row sums over
    // the tiles right of the diagonal to ra and rb.
    auto scan = [&](int st, float (&acc)[kPT][4], float& ra, float& rb) {
      const int ja = 16 * st + g, jb = ja + 8;
      const float cja = cu[ja], cjb = cu[jb], dja = dd[ja], djb = dd[jb];
#pragma unroll 1
      for (int it = st; it < nQ; ++it) {
        const int tt = it * (it + 1) / 2 + st;
        // dM^T = dt_j (x dy^T)_ji, dy hi + lo: P / 16 <= 4 steps, each
        // term's products summed from zero
        float d2[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        float d2l[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int kp = 0; kp < kKP; ++kp) {
          uint32_t xf[4], yh[4], yl[4];
          const uint32_t yo = swz8(16 * it + lane % 8 + 8 * (lane / 16),
                                   2 * kp + (lane / 8) % 2);
          ldsm_x4(sb + xo + swz8(16 * st + lane % 16, 2 * kp + lane / 16), xf);
          ldsm_x4(sb + o_y + yo, yh);
          ldsm_x4(sb + o_y + kHalf + yo, yl);
          mma_bf16(d2[0], xf, yh[0], yh[1]);
          mma_bf16(d2l[0], xf, yl[0], yl[1]);
          mma_bf16(d2[1], xf, yh[2], yh[3]);
          mma_bf16(d2l[1], xf, yl[2], yl[3]);
        }
        const float4* S4 = reinterpret_cast<const float4*>(smem + o_s) + 64 * tt;
        float4* D4 = reinterpret_cast<float4*>(smem + o_d) + 64 * tt;
        const float4 sl = S4[lane], sh = S4[32 + lane];
        const float4 dl = D4[lane], dh = D4[32 + lane];
        const float2 c01 = ld2(cu + 16 * it + 2 * t);
        const float2 c89 = ld2(cu + 16 * it + 2 * t + 8);
        const float sv[8] = {sl.x, sl.y, sl.z, sl.w, sh.x, sh.y, sh.z, sh.w};
        const float ci[4] = {c01.x, c01.y, c89.x, c89.y};
        float dv[8] = {dl.x, dl.y, dl.z, dl.w, dh.x, dh.y, dh.z, dh.w};
        float m[8], gv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool hi_row = (e >> 1) & 1;
          const float dm = (d2[e >> 2][e & 3] + d2l[e >> 2][e & 3])
                           * (hi_row ? djb : dja);
          const bool keep = it > st || frag_col(t, e) >= frag_row(g, e);
          const float arg = keep ? ci[(e & 1) + 2 * (e >> 2)]
                                   - (hi_row ? cjb : cja) : 0.0f;
          const float L = keep ? exp_sfu(arg) : 0.0f;
          m[e] = sv[e] * L;
          gv[e] = dm * m[e];
          dv[e] = fmaf(dm, L, dv[e]);
        }
        D4[lane] = make_float4(dv[0], dv[1], dv[2], dv[3]);
        D4[32 + lane] = make_float4(dv[4], dv[5], dv[6], dv[7]);
        if (it > st) {
          // E[i][st]: the tile's G summed over its rows j, for each i
          float cs[4] = {gv[0] + gv[2], gv[1] + gv[3], gv[4] + gv[6],
                         gv[5] + gv[7]};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 4);
            cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 8);
            cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 16);
          }
          if (g == 0) {
            const int i0 = 16 * it + 2 * t;
            E[i0 * kStrips + st] = cs[0];
            E[(i0 + 1) * kStrips + st] = cs[1];
            E[(i0 + 8) * kStrips + st] = cs[2];
            E[(i0 + 9) * kStrips + st] = cs[3];
          }
          ra += (gv[0] + gv[1]) + (gv[4] + gv[5]);
          rb += (gv[2] + gv[3]) + (gv[6] + gv[7]);
        } else {
          float4* gd = reinterpret_cast<float4*>(gdiag) + 64 * st + lane;
          gd[0] = make_float4(gv[0], gv[1], gv[2], gv[3]);
          gd[32] = make_float4(gv[4], gv[5], gv[6], gv[7]);
        }
        // d(xdt) += M^T dy: M hi + lo, dy hi + lo, three products
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) split(m[2 * k], m[2 * k + 1], &mh[k], &ml[k]);
#pragma unroll
        for (int np = 0; np < kKP; ++np) {
          uint32_t yh[4], yl[4];
          const uint32_t yo = swz8(16 * it + lane % 8 + 8 * ((lane / 8) % 2),
                                   2 * np + lane / 16);
          ldsm_x4_trans(sb + o_y + yo, yh);
          ldsm_x4_trans(sb + o_y + kHalf + yo, yl);
          mma3(acc[2 * np], mh, ml, yh[0], yh[1], yl[0], yl[1]);
          mma3(acc[2 * np + 1], mh, ml, yh[2], yh[3], yl[2], yl[3]);
        }
      }
    };
    // Strip st's cb, dx = d(xdt) dt and sum_p d(xdt) x.
    auto finish = [&](int st, const float (&acc)[kPT][4], float ra, float rb) {
      const int ja = 16 * st + g, jb = ja + 8;
      const float dja = dd[ja], djb = dd[jb];
      ra = quad_sum(ra);
      rb = quad_sum(rb);
      if (t == 0) {
        cb[ja] = ra;
        cb[jb] = rb;
      }
      float sa = 0.0f, sbx = 0.0f;
      const int64_t rowa = (bc * Q + ja) * a.H + h, rowb = (bc * Q + jb) * a.H + h;
#pragma unroll
      for (int q = 0; q < kPT; ++q) {
        const int col = 8 * q + 2 * t;
        const float2 xA = ldx2(smem + xo + swz8(ja, q) + 4 * t);
        const float2 xB = ldx2(smem + xo + swz8(jb, q) + 4 * t);
        sa = fmaf(acc[q][0], xA.x, sa);
        sa = fmaf(acc[q][1], xA.y, sa);
        sbx = fmaf(acc[q][2], xB.x, sbx);
        sbx = fmaf(acc[q][3], xB.y, sbx);
        if (col >= P) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if ((half ? jb : ja) >= Q) continue;
          const float dj = half ? djb : dja;
          __nv_bfloat16* out = dx + (half ? rowb : rowa) * P + col;
          const float v0 = acc[q][2 * half] * dj, v1 = acc[q][2 * half + 1] * dj;
          if ((P & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
          } else {
            out[0] = __float2bfloat16_rn(v0);
            if (col + 1 < P) out[1] = __float2bfloat16_rn(v1);
          }
        }
      }
      sa = quad_sum(sa);
      sbx = quad_sum(sbx);
      if (t == 0) {
        xs[ja] = sa;
        xs[jb] = sbx;
      }
    };

    if (live) {
      float rsA = 0.0f, rsB = 0.0f;
      scan(sj, dxa, rsA, rsB);
      finish(sj, dxa, rsA, rsB);
    }
    __syncthreads();          // every strip's sums of G, dww and xs are in

    if (live) {
      // da_r for the strip's positions r = 16 sj + l: G's block
      // i >= r > j, as (rows below the strip) + (rows of the strip from r)
      // over the tile columns left of it, + the strip's columns left of r
      // below it, + inside the diagonal tile; then the states' and the
      // decay's terms of dcum summed from r to the end, which are
      // sum_{j < r} dw_j w_j + ddecay decay.
      const int l = lane & 15, r = 16 * sj + l;
      float below = 0.0f;
      for (int i = 16 * sj + 16 + lane; i < Qp; i += 32) {
        float s = 0.0f;
        for (int jt = 0; jt < sj; ++jt) s += E[i * kStrips + jt];
        below += s;
      }
      below = __shfl_sync(0xffffffffu, warp_sum(below), 0);
      float row = 0.0f;
      for (int jt = 0; jt < sj; ++jt) row += E[r * kStrips + jt];
      // inside the diagonal tile: sum over j < r <= i, each r
      float pr[16];
      {
        const float4* gd = reinterpret_cast<const float4*>(gdiag) + 64 * sj + lane;
        const float4 lo4 = gd[0], hi4 = gd[32];
        const float gv[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          pr[q] = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (frag_row(g, e) < q && q <= frag_col(t, e)) pr[q] += gv[e];
        }
      }
      const float daG = (below + suffix16(row)) + prefix16(cb[r])
                        + reduce_scatter16(pr);
      float wsum = 0.0f;
      for (int j = lane; j < 16 * sj; j += 32) wsum += dww[j];
      wsum = __shfl_sync(0xffffffffu, warp_sum(wsum), 0);
      float da = daG + (wsum + prefix16(dww[r]));
      da += ahd[kHeads + hh];              // ddecay decay
      float dAp = 0.0f;
      if (lane < 16 && r < Q) {
        a.ddt[(bc * Q + r) * a.H + h] = da * ahd[hh] + xs[r];
        dAp = da * dd[r];
      }
      dAp = warp_sum(dAp);
      if (lane == 0) dAs[hh * kStrips + sj] = dAp;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if (tid < nh) {
    float s = 0.0f;
    for (int q = 0; q < nQ; ++q) s += dAs[tid * kStrips + q];
    a.dapart[bc * a.H + h0 + tid] = s;
  }
  // D^T's partial for the B and C pass, as it is kept (fragments)
  float4* dpart = reinterpret_cast<float4*>(a.dpart)
                  + ((static_cast<int64_t>(grp) * a.B + b) * a.nc + c)
                    * (n_tri * 64);
  for (int e = tid; e < n_tri * 64; e += kThreads)
    dpart[e] = reinterpret_cast<const float4*>(smem + o_d)[e];
  // the states' term of dB
  if (states && live) {
    float* out = a.dbx + ((static_cast<int64_t>(grp) * a.B + b) * a.nc + c)
                         * Q * N;
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      const int col = 8 * q + 2 * t;
      if (q >= 2 * nN || col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = half ? jB : jA;
        if (j >= Q) continue;
        out[j * N + col] = dbs[q][2 * half];
        if (col + 1 < N) out[j * N + col + 1] = dbs[q][2 * half + 1];
      }
    }
  }
}

// dC = D B (blockIdx.z = 0) or dB = D^T C + the states' partials (1), D
// the sum of the head groups' partials split into bf16 hi + lo; B and C
// exact.  Two blocks a (chunk, batch row); warp w forms strip w of its
// output.
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_bc_kernel_mma(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr uint32_t o_dh = 0, o_dl = kBcBytes, o_b = 2 * kBcBytes,
                     o_c = 3 * kBcBytes, o_x = 4 * kBcBytes;
  float* dbx = reinterpret_cast<float*>(smem + o_x);      // [j][n]
  const uint32_t sb = smem_u32(smem);
  const int Q = a.Q, N = a.N;
  const int nQ = (Q + 15) / 16, nN = (N + 15) / 16, Qp = 16 * nQ;
  const int c = blockIdx.x, b = blockIdx.y;
  const bool is_db = blockIdx.z == 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t bc = static_cast<int64_t>(b) * a.nc + c;
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(a.bm);
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(a.cm);
  const bool vec_bc = a.vec_bc != 0;
  {
    const __nv_bfloat16* bb = bm + b * a.bsb + c * a.bsc;
    const __nv_bfloat16* cc = cm + b * a.csb + c * a.csc;
    const int bsq = static_cast<int>(a.bsq), csq = static_cast<int>(a.csq);
    for (int idx = tid; idx < Qp * 16; idx += kThreads) {
      const int r = idx / 16, ch = idx % 16;
      stage16(smem, o_b + swz16(r, ch), bb + r * bsq + 8 * ch, r < Q,
              N - 8 * ch, vec_bc, bm);
      stage16(smem, o_c + swz16(r, ch), cc + r * csq + 8 * ch, r < Q,
              N - 8 * ch, vec_bc, cm);
    }
  }
  cp_async_commit();
  // D = the groups' partials of D^T summed in group order, split into hi
  // and lo and stored as D [i][j]
  const int n_tri = nQ * (nQ + 1) / 2;
  const int64_t gstride = static_cast<int64_t>(a.B) * a.nc * n_tri * 64;
  const float4* part = reinterpret_cast<const float4*>(a.dpart)
                       + bc * n_tri * 64;
  for (int f = tid; f < n_tri * 64; f += kThreads) {
    float4 s = part[f];
    for (int gg = 1; gg < a.groups; ++gg) {
      const float4 v = part[gg * gstride + f];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    int it, jt;
    tri_pos(f / 64, &it, &jt);
    const int ln = f % 32, half = (f % 64) / 32;
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 16 * jt + frag_row(ln / 4, k);
      const int i = 16 * it + frag_col(ln % 4, 4 * half + k);
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[k]);
      const __nv_bfloat16 lo = __float2bfloat16_rn(v[k] - __bfloat162float(hi));
      const uint32_t o = swz16(i, j / 8) + 2 * (j % 8);
      *reinterpret_cast<__nv_bfloat16*>(smem + o_dh + o) = hi;
      *reinterpret_cast<__nv_bfloat16*>(smem + o_dl + o) = lo;
    }
  }
  // the states' partials of dB summed in group order, 16 bytes a read
  // where the rows allow
  const int64_t stride_g = static_cast<int64_t>(a.B) * a.nc;
  if (is_db && a.dst != nullptr) {
    const float* src = a.dbx + bc * Q * N;
    const int64_t gs = stride_g * Q * N;
    if ((Q * N) % 4 == 0) {
      for (int f = tid; f < Q * N / 4; f += kThreads) {
        float4 s = reinterpret_cast<const float4*>(src)[f];
        for (int gg = 1; gg < a.groups; ++gg) {
          const float4 v = reinterpret_cast<const float4*>(src + gg * gs)[f];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        reinterpret_cast<float4*>(dbx)[f] = s;
      }
    } else {
      for (int f = tid; f < Q * N; f += kThreads) {
        float s = src[f];
        for (int gg = 1; gg < a.groups; ++gg) s += src[gg * gs + f];
        dbx[f] = s;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (warp >= nQ) return;

  __nv_bfloat16* dcm = static_cast<__nv_bfloat16*>(a.dcm) + bc * Q * N;
  __nv_bfloat16* dbm = static_cast<__nv_bfloat16*>(a.dbm) + bc * Q * N;
  float acc[kNT][4];
  auto store = [&](__nv_bfloat16* out, bool add_states) {
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      const int col = 8 * q + 2 * t;
      if (q >= 2 * nN || col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half;
        if (r >= Q) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= N) continue;
          float v = acc[q][2 * half + e];
          if (add_states) v += dbx[r * N + col + e];
          out[r * N + col + e] = __float2bfloat16_rn(v);
        }
      }
    }
  };
  auto zero = [&]() {
#pragma unroll
    for (int q = 0; q < kNT; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  };

  zero();
  if (!is_db) {
    // dC_i = sum_{j <= i} D_ij B_j, rows i of strip `warp`
    for (int jt = 0; jt <= warp; ++jt) {
      uint32_t ah[4], al[4];
      const uint32_t ao = swz16(16 * warp + lane % 16, 2 * jt + lane / 16);
      ldsm_x4(sb + o_dh + ao, ah);
      ldsm_x4(sb + o_dl + ao, al);
#pragma unroll
      for (int np = 0; np < kStrips; ++np) {
          uint32_t bf[4];
        ldsm_x4_trans(sb + o_b + swz16(16 * jt + lane % 8 + 8 * ((lane / 8) % 2),
                                       2 * np + lane / 16), bf);
        mma2a(acc[2 * np], ah, al, bf[0], bf[1]);
        mma2a(acc[2 * np + 1], ah, al, bf[2], bf[3]);
      }
    }
    store(dcm, false);
    return;
  }

  // dB_j = sum_{i >= j} D_ij C_i + the states' partials, rows j of strip
  // `warp`; D^T's fragments by ldmatrix.trans of D
  for (int it = warp; it < nQ; ++it) {
    uint32_t ah[4], al[4];
    const uint32_t ao = swz16(16 * it + lane % 8 + 8 * (lane / 16),
                              2 * warp + (lane / 8) % 2);
    ldsm_x4_trans(sb + o_dh + ao, ah);
    ldsm_x4_trans(sb + o_dl + ao, al);
#pragma unroll
    for (int np = 0; np < kStrips; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(sb + o_c + swz16(16 * it + lane % 8 + 8 * ((lane / 8) % 2),
                                     2 * np + lane / 16), bf);
      mma2a(acc[2 * np], ah, al, bf[0], bf[1]);
      mma2a(acc[2 * np + 1], ah, al, bf[2], bf[3]);
    }
  }
  store(dbm, a.dst != nullptr);
}

}  // namespace tc

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

int launch_mma(const Args& a, cudaStream_t s) {
  int err;
  if ((err = smem_attr(reinterpret_cast<const void*>(&tc::ssd_bwd_kernel_mma),
                       tc::kSmemBytes)))
    return err;
  tc::ssd_bwd_kernel_mma<<<dim3(a.groups, a.nc, a.B), tc::kThreads,
                           tc::kSmemBytes, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = smem_attr(
           reinterpret_cast<const void*>(&tc::ssd_bwd_bc_kernel_mma),
           tc::kBcSmemBytes)))
    return err;
  tc::ssd_bwd_bc_kernel_mma<<<dim3(a.nc, a.B, 2), tc::kThreads,
                              tc::kBcSmemBytes, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int outs = a.a_rows ? a.B * a.H : a.H;
  ssd_bwd_a_kernel<<<(outs + 255) / 256, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

struct Workspace {
  int64_t wu, dw, dbx, dpart, dapart, total;
};

// float32 (CUDA cores): w o U and dw, dB's states partials, D's packed
// partials, dA's.  bf16 (tensor cores): D^T's partials as fragments
// (float4-aligned), dB's states partials, dA's.
Workspace workspace(int B, int nc, int Q, int H, int P, int N,
                    int has_states, int dtype) {
  const int64_t groups = (H + kHeads - 1) / kHeads;
  const int64_t bch = static_cast<int64_t>(B) * nc * H;
  const int64_t dbx = has_states ? groups * B * nc * Q * N : 0;
  Workspace w;
  if (dtype == 0) {
    w.wu = 0;
    w.dw = w.wu + (has_states ? bch * Q * P : 0);
    w.dbx = w.dw + (has_states ? bch * Q : 0);
    w.dpart = w.dbx + dbx;
    w.dapart = w.dpart + groups * B * nc * tri_off(round4(Q));
  } else {
    const int64_t nQ = (Q + 15) / 16;
    w.wu = w.dw = w.dpart = 0;
    w.dbx = w.dpart + groups * B * nc * (nQ * (nQ + 1) / 2) * 256;
    w.dapart = w.dbx + dbx;
  }
  w.total = w.dapart + bch;
  return w;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Floats of float32 workspace that ssd_chunk_bwd_launch needs for inputs of
// the given dtype (0 = float32, 1 = bf16).
int64_t ssd_chunk_bwd_workspace_floats(int B, int nc, int Q, int H, int P,
                                       int N, int has_states, int dtype) {
  return workspace(B, nc, Q, H, P, N, has_states, dtype).total;
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
  const Workspace w = workspace(B, nc, Q, H, P, N, dst != nullptr, dtype);
  float* f = static_cast<float*>(ws);
  // The bf16 route copies 16 bytes at a time where the rows allow it, and
  // element by element where they do not.
  const int vec_x = aligned16(x) && P % 8 == 0 && xsb % 8 == 0
                    && xsc % 8 == 0 && xsq % 8 == 0 && xsh % 8 == 0;
  const int vec_bc = aligned16(bm) && aligned16(cm) && N % 8 == 0
                     && bsb % 8 == 0 && bsc % 8 == 0 && bsq % 8 == 0
                     && csb % 8 == 0 && csc % 8 == 0 && csq % 8 == 0;
  const int vec_f = aligned16(dy) && (dst == nullptr || aligned16(dst))
                    && P % 4 == 0;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               bm, cm, static_cast<const float*>(dy),
               static_cast<const float*>(dst),
               static_cast<const float*>(ddec), dx, static_cast<float*>(ddt),
               static_cast<float*>(dA), dbm, dcm, f + w.wu, f + w.dw,
               f + w.dbx, f + w.dpart, f + w.dapart, B, nc, Q, H, P, N,
               (H + kHeads - 1) / kHeads, xsb, xsc, xsq, xsh, dsb, dsc, dsq,
               bsb, bsc, bsq, csb, csc, csq, asb, a_rows, vec_x, vec_bc,
               vec_f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_mma(a, s);
  return launch<float>(a, s);
}

}  // extern "C"
