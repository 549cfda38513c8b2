// ssd_chunk: the Mamba-2 SSD intra-chunk dual form (arXiv:2405.21060), for
// sm_90a.  Per (batch b, chunk c, head h), with Q positions in the chunk:
//
//   cum_i    = sum_{r <= i} dt_r A_h                     (left to right)
//   y_i      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state    = sum_j B_j^T (exp(cum_{Q-1} - cum_j) dt_j x_j)   (N x P)
//   decay    = exp(cum_{Q-1})
//
// x (B, nc, Q, H, P) and Bm, Cm (B, nc, Q, N) are float32 or bf16; dt
// (B, nc, Q, H) and A float32, A one row of H read with a batch stride (0:
// one A for every row; H: one per batch row, as the cohort's folded batch
// carries it in training); y (B, nc, Q, H, P), states (B, nc, H,
// N, P) and decays (B, nc, H) are written float32 and contiguous.  x, dt,
// Bm and Cm are read through their strides (unit stride along the last
// axis): the model's x is a view of the convolution's output, and no copy
// of it is made.  exp(cum_i - cum_j) is formed only for j <= i: for j > i
// the difference is positive and can overflow to inf, which a product
// formed before the mask would carry.  cum is one left-to-right float32 sum
// of the float32 products dt_r A_h, as the plain version's cumsum along a
// non-last axis takes it on the card, so decays match it bitwise; any Q, N,
// P up to 128 are taken.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_chunk.py:
// ssd_chunk (body _ssd_kernel).  The oracle is
// repro_torch/kernels/ref.py::ssd_chunk_ref.
//
// What bounds it on the H100: bytes.  At mamba2-2.7b's prefill layer
// (B = 1, S = 8192 -> nc = 64, Q = 128, H = 80, P = 64, N = 128, bf16
// inputs) one call reads 84 MB of x and writes 168 MB each of y and states
// (426 MB in all: 0.127 ms at 3.35 TB/s), while the 16.3 GFLOP it needs
// (C B^T once per chunk and y on their lower triangles, the states in
// full) take 0.016 ms at the bf16 tensor-core peak.  The bf16 route below
// stays some 2.5x above that bound: chip_ssd_ablation.py shows that
// neither its x reads nor its y and state writes hold it back, but the
// per-element work between the products (the exponentials and the bf16
// splits) and each block's fixed work (staging B and C, S = C B^T, cum).
//
// Two routes, chosen in ssd_chunk_launch by dtype.  Both take one block per
// (group of 8 heads, chunk, batch): the heads share Bm and Cm, so the block
// stages them once and forms S = C B^T once for its 8 heads.
//
// * bf16: the tensor cores (tc::ssd_chunk_kernel_mma), 8 warps, two blocks
//   an SM.  B and C are staged in bf16 by 16-byte cp.async copies into an
//   XOR-swizzled layout (conflict-free ldmatrix); S = C B^T runs once per
//   chunk as mma.sync m16n8k16 (bf16 in, float32 accumulate: the products
//   are exact) on the 36 lower-triangular 16 x 16 tiles only, dealt round
//   robin to the warps, and is kept in shared memory as float32 in the
//   accumulator layout, which is the A-fragment layout of the next product
//   (S in registers across heads would cost 72 more a thread and the second
//   block an SM).  Per head, with the next head's x tile (Q x 64 columns,
//   bf16) double-buffered by cp.async:
//     - states = (w o B)^T x, w_j = exp(cum_{Q-1} - cum_j) dt_j, in 16-row
//       strips of N: B^T comes by ldmatrix.trans, times w in float32,
//       split into bf16 hi + lo; x is read exact as the B operand by
//       ldmatrix.trans;
//     - y = M' x with M'_ij = S_ij exp(cum_i - cum_j) dt_j, formed in
//       registers from the S fragments (accurate expf, only on the tiles
//       j <= i, the mask only on the diagonal tiles), split three ways into
//       bf16 hi = bf16(M'), mid = bf16(M' - hi), lo = bf16(M' - hi - mid):
//       y = hi x + mid x + lo x.
//   Warps 0-3 form y, warp w on the row strips w and 7 - w (nine tiles
//   each) over all 64 columns, so each M' fragment is formed once; warps
//   4-7 form the states, two 16-row strips of N each.
//   Why three terms: y has to hold 1e-4 (relative and absolute) against the
//   float32 plain version.  hi + lo (flash_attention's split of P) puts
//   327 of the layer's 42 M lanes over on the H100 (chip_ssd_ablation.py);
//   hi + mid + lo carries M' to float32.  Folding dt into M' keeps x an
//   exact bf16 operand; splitting dt x instead puts lanes over, as one
//   bf16 M' does (tests/test_torch_ssd_numerics.py emulates each on the
//   CPU).  The states' weights span less, and hi + lo holds them.
//   chip_smoke.py reports each case's worst lane as a share of the limit.
//   Outputs are written float32 straight from the accumulators: a quad of
//   lanes writes one full 32-byte sector of a row (staging them through
//   shared memory as 16-byte stores measured no faster).  No atomics:
//   strided and contiguous inputs give the same bits.
// * float32: the CUDA cores (simt::ssd_chunk_kernel), 512 threads; TF32
//   would not hold 1e-4.  S and M = S o exp(cum_i - cum_j) are kept
//   lower-triangular in shared memory: row i holds columns 0 .. 4 *
//   floor(i / 4) + 3, so every row starts 16-byte aligned and the y product
//   skips the upper triangle without a test in its inner loop.  Each thread
//   owns 4 x 4 output tiles of y and of the state; every step of its inner
//   loop does 64 FMAs on eight 16-byte shared-memory loads, which bounds it
//   (~2 bytes of shared memory an FMA).  177 KB of shared memory at Q = N =
//   128, P = 64 (209 KB at P = 128).
//
// Not taken: wgmma fed by TMA with a producer warp (the full tensor-core
// rate; the products are not what holds the route back), and folding the
// inter-chunk recurrence and the y_inter epilogue of ssd() into the
// kernel, which would save the model more than this kernel now costs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kMaxDim = 128;       // Q, N, P

struct Args {
  const void* x; const float* dt; const float* A;
  const void* bm; const void* cm;
  float* y; float* st; float* dec;
  int nc, Q, H, P, N;
  int64_t xsb, xsc, xsq, xsh;   // x strides (b, c, q, h); unit along P
  int64_t dsb, dsc, dsq;        // dt strides (b, c, q); unit along H
  int64_t bsb, bsc, bsq;        // Bm strides (b, c, q); unit along N
  int64_t csb, csc, csq;        // Cm strides
  int64_t asb;                  // A's batch stride (0: one A for all rows)
  int vec_x, vec_bc;            // 16-byte copies allowed (bf16 route)
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 512;
constexpr int kHeads = 8;          // heads per block, sharing S = C B^T

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Offset of row i in the packed lower triangle: row 4a + r holds 4(a + 1)
// columns, so it starts at 4(a + 1)(2a + r).  tri_off(Qp) is the size.
__host__ __device__ __forceinline__ int tri_off(int i) {
  const int a = i >> 2, r = i & 3;
  return 4 * (a + 1) * (2 * a + r);
}

__host__ __device__ __forceinline__ int region_floats(int Qp, int Np, int Pp) {
  const int c_tile = Qp * (Np + 4);
  const int m_and_x = tri_off(Qp) + Qp * Pp;
  return c_tile > m_and_x ? c_tile : m_and_x;
}

__host__ __device__ __forceinline__ int smem_floats(int Qp, int Np, int Pp) {
  return tri_off(Qp)                 // S, packed
       + Qp * (Np + 4)               // B [j][n]
       + region_floats(Qp, Np, Pp)   // C [i][n], then M (packed) and X [j][p]
       + 2 * kHeads * Qp             // dt [h][j], cum [h][j]
       + Qp;                         // exp(cum_{Q-1} - cum_j) of one head
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 (&a)[4],
                                       const float4 (&x)[4]) {
  // acc[k][p] += sum_l a[k].l * x[l].p, l in order
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

__device__ __forceinline__ void store_row(float* out, int p, int P,
                                          const float (&v)[4]) {
  if ((P & 3) == 0) {
    *reinterpret_cast<float4*>(out + p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p + q < P) out[p + q] = v[q];
  }
}

// T is float on the port's path; T = __nv_bfloat16 is the design the
// tensor-core route replaced, which chip_ssd_ablation.py times beside it.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int Q = a.Q, N = a.N, P = a.P;
  const int Qp = round4(Q), Np = round4(N), Pp = round4(P);
  const int ldb = Np + 4;
  float* Sp = reinterpret_cast<float*>(smem4);
  float* Bs = Sp + tri_off(Qp);
  float* Cs = Bs + Qp * ldb;          // region: C, then M and X
  float* Mp = Cs;
  float* Xs = Cs + tri_off(Qp);
  float* dts = Cs + region_floats(Qp, Np, Pp);
  float* cum = dts + kHeads * Qp;
  float* edec = cum + kHeads * Qp;

  const int h0 = blockIdx.x * kHeads;
  const int nh = min(kHeads, a.H - h0);
  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;

  const T* x = static_cast<const T*>(a.x);
  const T* bm = static_cast<const T*>(a.bm);
  const T* cm = static_cast<const T*>(a.cm);

  // Stage dt of the block's heads (position-major, so neighbouring threads
  // read neighbouring heads), B and C; zeros in the padding.
  for (int idx = tid; idx < Qp * kHeads; idx += kThreads) {
    const int j = idx / kHeads, hh = idx % kHeads;
    float v = 0.0f;
    if (j < Q && hh < nh)
      v = a.dt[b * a.dsb + c * a.dsc + j * a.dsq + h0 + hh];
    dts[hh * Qp + j] = v;
  }
  for (int idx = tid; idx < Qp * Np; idx += kThreads) {
    const int j = idx / Np, n = idx % Np;
    float bv = 0.0f, cv = 0.0f;
    if (j < Q && n < N) {
      bv = to_f32(bm[b * a.bsb + c * a.bsc + j * a.bsq + n]);
      cv = to_f32(cm[b * a.csb + c * a.csc + j * a.csq + n]);
    }
    Bs[j * ldb + n] = bv;
    Cs[j * ldb + n] = cv;
  }
  __syncthreads();

  // cum, one thread a head, left to right; padded positions repeat the
  // last value, so every exp below stays finite.
  if (tid < nh) {
    const float Ah = a.A[b * a.asb + h0 + tid];
    const float* d = dts + tid * Qp;
    float* cu = cum + tid * Qp;
    float s = 0.0f;
    for (int j = 0; j < Q; ++j) {
      s = __fadd_rn(s, __fmul_rn(d[j], Ah));
      cu[j] = s;
    }
    for (int j = Q; j < Qp; ++j) cu[j] = s;
    a.dec[(static_cast<int64_t>(b) * a.nc + c) * a.H + h0 + tid] = expf(s);
  }

  // S = C B^T on the lower triangle of 4 x 4 tiles.
  const int Qt = Qp / 4, Pt = Pp / 4, Nt = Np / 4;
  for (int t = tid; t < Qt * Qt; t += kThreads) {
    const int ti = t / Qt, tj = t % Qt;
    if (tj > ti) continue;
    float acc[4][4] = {};
    for (int n = 0; n < Np; n += 4) {
      float4 cr[4], br[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cr[k] = *reinterpret_cast<const float4*>(Cs + (4 * ti + k) * ldb + n);
        br[k] = *reinterpret_cast<const float4*>(Bs + (4 * tj + k) * ldb + n);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          float s = acc[k][l];
          s = fmaf(cr[k].x, br[l].x, s);
          s = fmaf(cr[k].y, br[l].y, s);
          s = fmaf(cr[k].z, br[l].z, s);
          s = fmaf(cr[k].w, br[l].w, s);
          acc[k][l] = s;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(Sp + tri_off(4 * ti + k) + 4 * tj) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
  __syncthreads();   // S and cum are ready; C is no longer needed

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* cu = cum + hh * Qp;
    const float* d = dts + hh * Qp;

    // X = dt * x for this head, M = S o exp(cum_i - cum_j), j <= i, and the
    // decay to the chunk's end, once a row.
    for (int idx = tid; idx < Qp * Pp; idx += kThreads) {
      const int j = idx / Pp, p = idx % Pp;
      float v = 0.0f;
      if (j < Q && p < P)
        v = to_f32(x[b * a.xsb + c * a.xsc + j * a.xsq + h * a.xsh + p]) * d[j];
      Xs[idx] = v;
    }
    for (int i = warp; i < Qp; i += kWarps) {
      const int off = tri_off(i), len = 4 * ((i >> 2) + 1);
      const float ci = cu[i];
      for (int j = lane; j < len; j += 32)
        Mp[off + j] = j <= i ? Sp[off + j] * expf(ci - cu[j]) : 0.0f;
    }
    for (int j = tid; j < Qp; j += kThreads) edec[j] = expf(cu[Q - 1] - cu[j]);
    __syncthreads();

    // y = M X, each thread a 4 x 4 tile of (positions, P).
    for (int t = tid; t < Qt * Pt; t += kThreads) {
      const int ti = t / Pt, tp = t % Pt;
      float acc[4][4] = {};
      for (int jj = 0; jj < 4 * ti + 4; jj += 4) {
        float4 m[4], xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          m[k] = *reinterpret_cast<const float4*>(Mp + tri_off(4 * ti + k) + jj);
          xv[k] = *reinterpret_cast<const float4*>(Xs + (jj + k) * Pp + 4 * tp);
        }
        fma4x4(acc, m, xv);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * ti + k;
        if (i >= Q) break;
        float* out = a.y + (((static_cast<int64_t>(b) * a.nc + c) * Q + i)
                            * a.H + h) * P;
        store_row(out, 4 * tp, P, acc[k]);
      }
    }
    __syncthreads();

    // X <- exp(cum_{Q-1} - cum_j) X, the decay to the chunk's end.
    for (int idx = tid; idx < Qp * Pp; idx += kThreads)
      Xs[idx] *= edec[idx / Pp];
    __syncthreads();

    // state = B^T X, each thread a 4 x 4 tile of (N, P).
    for (int t = tid; t < Nt * Pt; t += kThreads) {
      const int tn = t / Pt, tp = t % Pt;
      float acc[4][4] = {};
      for (int j = 0; j < Qp; j += 4) {
        float4 br[4], xv[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          br[l] = *reinterpret_cast<const float4*>(Bs + (j + l) * ldb + 4 * tn);
          xv[l] = *reinterpret_cast<const float4*>(Xs + (j + l) * Pp + 4 * tp);
        }
        // acc[k][p] += sum_l B[j + l][4 tn + k] X[j + l][p]
        const float4 bt[4] = {
            make_float4(br[0].x, br[1].x, br[2].x, br[3].x),
            make_float4(br[0].y, br[1].y, br[2].y, br[3].y),
            make_float4(br[0].z, br[1].z, br[2].z, br[3].z),
            make_float4(br[0].w, br[1].w, br[2].w, br[3].w)};
        fma4x4(acc, bt, xv);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 4 * tn + k;
        if (n >= N) break;
        float* out = a.st + ((((static_cast<int64_t>(b) * a.nc + c) * a.H + h)
                              * N + n) * P);
        store_row(out, 4 * tp, P, acc[k]);
      }
    }
    __syncthreads();   // X, M and the decays are rewritten for the next head
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int bytes = smem_floats(round4(a.Q), round4(a.N), round4(a.P))
                    * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.H + kHeads - 1) / kHeads, a.nc, B);
  ssd_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 8;                     // heads per block, sharing S
constexpr int kStrips = kMaxDim / 16;         // 16-row strips of Q or N
constexpr int kTri = kStrips * (kStrips + 1) / 2;   // S tiles, j <= i
constexpr int kTriPerWarp = (kTri + kWarps - 1) / kWarps;
constexpr int kCols = 64;                     // columns of x a pass
constexpr int kNT = kCols / 8;                // 8-column tiles a pass
constexpr int kBcBytes = kMaxDim * kMaxDim * 2;     // B or C, bf16
constexpr int kSBytes = kTri * 32 * 8 * 4;          // S, float32 fragments
constexpr int kXBytes = kMaxDim * kCols * 2;        // one x buffer, bf16
constexpr int kVecFloats = kHeads * kMaxDim;        // cum, dt or w
constexpr int kSmemBytes = kBcBytes + kSBytes + 2 * kXBytes
                           + 3 * kVecFloats * 4;
static_assert(kSBytes >= kBcBytes, "C is staged where S is kept");
static_assert(kWarps == kStrips, "half the warps on two strips each of y "
                                  "and of the states");

// Rows of 16-byte chunks; chunk c of row r is stored at chunk c ^ (r & 7),
// so the 8 rows an ldmatrix phase reads at one column chunk fall in 8
// different 16-byte bank groups.  B and C rows are 256 bytes (N <= 128),
// x rows 128 bytes (64 columns).
__device__ __forceinline__ uint32_t swz16(int r, int c) {
  return static_cast<uint32_t>((r * 16 + (c ^ (r & 7))) * 16);
}
__device__ __forceinline__ uint32_t swz8(int r, int c) {
  return static_cast<uint32_t>((r * 8 + (c ^ (r & 7))) * 16);
}

// p0, p1 -> hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), each
// as a bf16 pair (the lower column in the low half); p - hi and
// (p - hi) - mid are exact in float32.
__device__ __forceinline__ void split3(float p0, float p1, uint32_t* hi,
                                       uint32_t* mid, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float r0 = p0 - __low2float(h), r1 = p1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  *hi = as_u32(h);
  *mid = as_u32(m);
  *lo = as_u32(__floats2bfloat162_rn(r0 - __low2float(m),
                                     r1 - __high2float(m)));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int q = 0; q < kNT; ++q)
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
}

// Write a warp's accumulators of a pass's 8-column tiles: this thread
// holds rows r and r + 8 (each < n_rows) at columns col + 8 q and
// col + 8 q + 1 (col < P); `out` is row 0, column 0, with rows ld floats
// apart.  A quad of lanes writes one 32-byte sector of a row.
__device__ __forceinline__ void store_acc(float* out, int64_t ld, int r,
                                          int n_rows, int col, int n_tiles,
                                          int P, const float (&acc)[kNT][4]) {
#pragma unroll
  for (int q = 0; q < kNT; ++q) {
    const int cq = col + 8 * q;
    if (q >= n_tiles || cq >= P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      if (row >= n_rows) continue;
      float* p = out + row * ld + cq;
      if ((P & 1) == 0) {
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[q][2 * half], acc[q][2 * half + 1]);
      } else {
        p[0] = acc[q][2 * half];
        if (cq + 1 < P) p[1] = acc[q][2 * half + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel_mma(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr uint32_t o_b = 0;                      // B [j][n]
  constexpr uint32_t o_s = kBcBytes;               // C [i][n], then S
  constexpr uint32_t o_x = o_s + kSBytes;          // x [j][p], two buffers
  // [head][j] each: cum, dt and w_j = exp(cum_{Q-1} - cum_j) dt_j
  float* cum = reinterpret_cast<float*>(smem + o_x + 2 * kXBytes);
  float* dts = cum + kVecFloats;
  float* wend = dts + kVecFloats;
  const float4* S4 = reinterpret_cast<const float4*>(smem + o_s);
  const uint32_t sbase = smem_u32(smem);

  const int Q = a.Q, N = a.N, P = a.P;
  const int nQ = (Q + 15) / 16, nN = (N + 15) / 16, Qp = 16 * nQ;
  const int h0 = blockIdx.x * kHeads, nh = min(kHeads, a.H - h0);
  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_pass = (P + kCols - 1) / kCols;
  const int n_it = nh * n_pass;                    // (head, column pass)

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(a.bm);
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(a.cm);
  const bool vec_x = a.vec_x != 0, vec_bc = a.vec_bc != 0;

  // Stage B and C (zeros past Q and N), then the first x tile.
  {
    const __nv_bfloat16* bb = bm + b * a.bsb + c * a.bsc;
    const __nv_bfloat16* cc = cm + b * a.csb + c * a.csc;
    const int chunks = 2 * nN;
    for (int idx = tid; idx < Qp * chunks; idx += kThreads) {
      const int r = idx / chunks, ch = idx % chunks;
      stage16(smem, o_b + swz16(r, ch), bb + r * a.bsq + 8 * ch, r < Q,
              N - 8 * ch, vec_bc, bm);
      stage16(smem, o_s + swz16(r, ch), cc + r * a.csq + 8 * ch, r < Q,
              N - 8 * ch, vec_bc, cm);
    }
  }
  cp_async_commit();
  auto stage_x = [&](int it, int buf) {
    const int hh = it / n_pass, col0 = kCols * (it % n_pass);
    const __nv_bfloat16* xh = x + b * a.xsb + c * a.xsc + (h0 + hh) * a.xsh
                              + col0;
    for (int idx = tid; idx < Qp * 8; idx += kThreads) {
      const int r = idx / 8, ch = idx % 8;
      stage16(smem, o_x + buf * kXBytes + swz8(r, ch), xh + r * a.xsq + 8 * ch,
              r < Q, P - col0 - 8 * ch, vec_x, x);
    }
  };
  stage_x(0, 0);
  cp_async_commit();

  // dt of the block's heads, position-major (neighbouring threads read
  // neighbouring heads); zeros in the padding.
  for (int idx = tid; idx < Qp * kHeads; idx += kThreads) {
    const int j = idx / kHeads, hh = idx % kHeads;
    float v = 0.0f;
    if (j < Q && hh < nh)
      v = a.dt[b * a.dsb + c * a.dsc + j * a.dsq + h0 + hh];
    dts[hh * kMaxDim + j] = v;
  }
  cp_async_wait<1>();                              // B and C have landed
  __syncthreads();

  // cum, one lane a head, left to right (padded positions repeat the last
  // value, so every exp below stays finite), and the chunk's decay.
  if (warp == kWarps - 1 && lane < nh) {
    const float Ah = a.A[b * a.asb + h0 + lane];
    const float* d = dts + lane * kMaxDim;
    float* cu = cum + lane * kMaxDim;
    float s = 0.0f;
    for (int j = 0; j < Q; ++j) {
      s = __fadd_rn(s, __fmul_rn(d[j], Ah));
      cu[j] = s;
    }
    for (int j = Q; j < Qp; ++j) cu[j] = s;
    a.dec[(static_cast<int64_t>(b) * a.nc + c) * a.H + h0 + lane] = expf(s);
  }

  // S = C B^T on the lower-triangular 16 x 16 tiles, tile k of the row-major
  // triangle to warp k % kWarps; kept in registers until C is read.
  const int n_tri = nQ * (nQ + 1) / 2;
  float sacc[kTriPerWarp][2][4];
#pragma unroll
  for (int k = 0; k < kTriPerWarp; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[k][0][e] = sacc[k][1][e] = 0.0f;
    const int tt = warp + kWarps * k;
    if (tt < n_tri) {
      int r = 0;
      while ((r + 1) * (r + 2) / 2 <= tt) ++r;
      const int jt = tt - r * (r + 1) / 2;
      for (int kk = 0; kk < nN; ++kk) {
        uint32_t af[4], bf[4];
        ldsm_x4(sbase + o_s + swz16(16 * r + lane % 16, 2 * kk + lane / 16),
                af);
        ldsm_x4(sbase + o_b + swz16(16 * jt + lane % 8 + 8 * (lane / 16),
                                    2 * kk + (lane / 8) % 2), bf);
        mma_bf16(sacc[k][0], af, bf[0], bf[1]);
        mma_bf16(sacc[k][1], af, bf[2], bf[3]);
      }
    }
  }
  __syncthreads();                                 // C is read; cum is ready

  // S tile tt as two planes of 32 float4s (columns 0-7 and 8-15), lane-major:
  // lane (g, t) holds rows g and g + 8 at columns 2t and 2t + 1 of each, its
  // A fragment of the product with x.
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
  for (int idx = tid; idx < nh * Qp; idx += kThreads) {
    const int hh = idx / Qp, j = idx % Qp;
    const float* cu = cum + hh * kMaxDim;
    wend[hh * kMaxDim + j] = expf(cu[Q - 1] - cu[j]) * dts[hh * kMaxDim + j];
  }

  // Warps 0-3 form y, warp w on the row strips ra = w and rb = nQ - 1 - w
  // (nine tiles at nQ = 8); warps 4-7 the states.
  const int ra = warp, rb = nQ - 1 - warp;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();           // x of this pass is in; the other buffer free
    if (it + 1 < n_it) stage_x(it + 1, (it + 1) & 1);
    cp_async_commit();

    const int hh = it / n_pass, h = h0 + hh, col0 = kCols * (it % n_pass);
    const int n8 = (min(kCols, P - col0) + 7) / 8;   // live 8-column tiles
    const uint32_t xb = sbase + o_x + (it & 1) * kXBytes;
    const float* cu = cum + hh * kMaxDim;
    const float* dd = dts + hh * kMaxDim;
    const float* ww = wend + hh * kMaxDim;

    if (warp >= kWarps / 2) {
      // states, rows [16 sn, 16 sn + 16) of N, two strips a warp:
      // (w o B)^T x, w o B split into bf16 hi + lo.
#pragma unroll 1
      for (int sn = 2 * (warp - kWarps / 2);
           sn < 2 * (warp - kWarps / 2) + 2 && sn < nN; ++sn) {
        float acc[kNT][4];
        zero(acc);
        for (int jt = 0; jt < nQ; ++jt) {
          uint32_t bt[4];
          ldsm_x4_trans(sbase + o_b + swz16(16 * jt + 8 * (lane / 16)
                                            + lane % 8,
                                            2 * sn + (lane / 8) % 2), bt);
          const float2 w01 = ld2(ww + 16 * jt + 2 * t);
          const float2 w89 = ld2(ww + 16 * jt + 2 * t + 8);
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 wk = k < 2 ? w01 : w89;
            const __nv_bfloat162 bv =
                *reinterpret_cast<const __nv_bfloat162*>(&bt[k]);
            split(__low2float(bv) * wk.x, __high2float(bv) * wk.y, &ahi[k],
                  &alo[k]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (2 * np >= n8) break;
            uint32_t xf[4];
            ldsm_x4_trans(xb + swz8(16 * jt + lane % 8 + 8 * ((lane / 8) % 2),
                                    2 * np + lane / 16), xf);
            mma_bf16(acc[2 * np], ahi, xf[0], xf[1]);
            mma_bf16(acc[2 * np], alo, xf[0], xf[1]);
            mma_bf16(acc[2 * np + 1], ahi, xf[2], xf[3]);
            mma_bf16(acc[2 * np + 1], alo, xf[2], xf[3]);
          }
        }
        float* out = a.st + (((static_cast<int64_t>(b) * a.nc + c) * a.H + h)
                             * N) * P;
        store_acc(out, P, 16 * sn + g, N, col0 + 2 * t, n8, P, acc);
      }
    } else {
      // y on row strips ra and rb: M' = S o exp(cum_i - cum_j) dt_j, split
      // into bf16 hi + mid + lo, times x.
#pragma unroll 1
      for (int s2 = 0; s2 < 2; ++s2) {
        const int r = s2 == 0 ? ra : rb;
        if (s2 == 0 ? ra > rb : rb <= ra) continue;
        float acc[kNT][4];
        zero(acc);
        const float ci0 = cu[16 * r + g], ci1 = cu[16 * r + g + 8];
        for (int jt = 0; jt <= r; ++jt) {
          const int tt = r * (r + 1) / 2 + jt;
          const float4 sl = S4[64 * tt + lane], sh = S4[64 * tt + 32 + lane];
          const float2 c01 = ld2(cu + 16 * jt + 2 * t);
          const float2 c89 = ld2(cu + 16 * jt + 2 * t + 8);
          const float2 d01 = ld2(dd + 16 * jt + 2 * t);
          const float2 d89 = ld2(dd + 16 * jt + 2 * t + 8);
          // element e of the fragment: row g (+8 for e % 4 >= 2), column
          // 2t (+1 for odd e, +8 for e >= 4)
          const float s[8] = {sl.x, sl.y, sl.z, sl.w, sh.x, sh.y, sh.z, sh.w};
          const float cj[4] = {c01.x, c01.y, c89.x, c89.y};
          const float dj[4] = {d01.x, d01.y, d89.x, d89.y};
          float m[8];
          if (jt < r) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int k = (e & 1) + 2 * (e >> 2);
              m[e] = s[e] * expf(((e & 2) ? ci1 : ci0) - cj[k]) * dj[k];
            }
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int k = (e & 1) + 2 * (e >> 2);
              const bool keep = g + ((e & 2) ? 8 : 0)
                                >= 2 * t + (e & 1) + ((e & 4) ? 8 : 0);
              const float arg = keep ? ((e & 2) ? ci1 : ci0) - cj[k] : 0.0f;
              m[e] = keep ? s[e] * expf(arg) * dj[k] : 0.0f;
            }
          }
          uint32_t mh[4], mm[4], ml[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            split3(m[2 * k], m[2 * k + 1], &mh[k], &mm[k], &ml[k]);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (2 * np >= n8) break;
            uint32_t xf[4];
            ldsm_x4_trans(xb + swz8(16 * jt + lane % 8 + 8 * ((lane / 8) % 2),
                                    2 * np + lane / 16), xf);
            mma_bf16(acc[2 * np], mh, xf[0], xf[1]);
            mma_bf16(acc[2 * np], mm, xf[0], xf[1]);
            mma_bf16(acc[2 * np], ml, xf[0], xf[1]);
            mma_bf16(acc[2 * np + 1], mh, xf[2], xf[3]);
            mma_bf16(acc[2 * np + 1], mm, xf[2], xf[3]);
            mma_bf16(acc[2 * np + 1], ml, xf[2], xf[3]);
          }
        }
        float* out = a.y + ((static_cast<int64_t>(b) * a.nc + c) * Q * a.H
                            + h) * P;
        store_acc(out, static_cast<int64_t>(a.H) * P, 16 * r + g, Q,
                     col0 + 2 * t, n8, P, acc);
      }
    }
  }
  cp_async_wait<0>();
}

int launch(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_chunk_kernel_mma,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.H + kHeads - 1) / kHeads, a.nc, B);
  ssd_chunk_kernel_mma<<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x (B, nc, Q, H, P), Bm and Cm (B, nc, Q, N) in the given dtype (0 =
// float32, CUDA cores; 1 = bf16, tensor cores) and dt (B, nc, Q, H)
// float32, each with unit stride along its last axis and the given element
// strides along the others; A float32 with unit stride along H and batch
// stride asb (0 for one A (H,) shared by every row).  y (B, nc, Q, H, P),
// st (B, nc, H, N, P) and dec (B, nc, H) are float32 and contiguous.
// 1 <= Q, N, P <= 128.  Returns a cudaError_t.
int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                     const void* bm, const void* cm, void* y, void* st,
                     void* dec, int dtype, int B, int nc, int Q, int H, int P,
                     int N, int64_t xsb, int64_t xsc, int64_t xsq, int64_t xsh,
                     int64_t dsb, int64_t dsc, int64_t dsq, int64_t bsb,
                     int64_t bsc, int64_t bsq, int64_t csb, int64_t csc,
                     int64_t csq, int64_t asb, void* stream) {
  if (Q < 1 || Q > kMaxDim || N < 1 || N > kMaxDim || P < 1 || P > kMaxDim
      || H < 1 || nc < 1 || B < 1 || nc > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // The bf16 route copies 16 bytes (8 values) at a time where the rows
  // allow it, and element by element where they do not.
  const int vec_x = aligned16(x) && P % 8 == 0 && xsb % 8 == 0
                    && xsc % 8 == 0 && xsq % 8 == 0 && xsh % 8 == 0;
  const int vec_bc = aligned16(bm) && aligned16(cm) && N % 8 == 0
                     && bsb % 8 == 0 && bsc % 8 == 0 && bsq % 8 == 0
                     && csb % 8 == 0 && csc % 8 == 0 && csq % 8 == 0;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               bm, cm, static_cast<float*>(y), static_cast<float*>(st),
               static_cast<float*>(dec), nc, Q, H, P, N, xsb, xsc, xsq, xsh,
               dsb, dsc, dsq, bsb, bsc, bsq, csb, csc, csq, asb, vec_x,
               vec_bc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return simt::launch<float>(a, B, s);
  if (dtype == 1) return tc::launch(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
