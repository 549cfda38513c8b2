// ssd_chunk: the Mamba-2 SSD intra-chunk dual form (arXiv:2405.21060), for
// sm_90a.  Per (batch b, chunk c, head h), with Q positions in the chunk:
//
//   cum_i    = sum_{r <= i} dt_r A_h                     (left to right)
//   y_i      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state    = sum_j B_j^T (exp(cum_{Q-1} - cum_j) dt_j x_j)   (N x P)
//   decay    = exp(cum_{Q-1})
//
// x (B, nc, Q, H, P) and Bm, Cm (B, nc, Q, N) are float32 or bf16; dt
// (B, nc, Q, H) and A (H,) float32; all arithmetic is float32, and y
// (B, nc, Q, H, P), states (B, nc, H, N, P) and decays (B, nc, H) are
// written float32 and contiguous.  x, dt, Bm and Cm are read through their
// strides (unit stride along the last axis): the model's x is a view of the
// convolution's output, and no copy of it is made.  exp(cum_i - cum_j) is
// formed only for j <= i: for j > i the difference is positive and can
// overflow to inf, which a product formed before the mask would carry.
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
// full) take 0.016 ms at the bf16 tensor-core peak.
//
// Design.  This first kernel is simple and right and runs on the CUDA
// cores in float32; tensor cores, TMA and wgmma are for a later kernel.
//   * One block per (group of 8 heads, chunk, batch), 512 threads.  Bm and
//     Cm are shared by all heads (one group), so the block stages them once
//     and forms S = C B^T once for its 8 heads: the Q x Q x N product is
//     paid once per 8 heads instead of once per head.
//   * S and M = S o exp(cum_i - cum_j) are kept lower-triangular in shared
//     memory: row i holds columns 0 .. 4 * floor(i / 4) + 3 (zeros past the
//     diagonal), so every row starts 16-byte aligned and the y product
//     skips the upper triangle without a test in its inner loop.
//   * cum is a left-to-right float32 sum of the float32 products dt_r A_h,
//     as the plain version's cumsum; the same cum feeds L, the decay to the
//     chunk's end and the chunk's decay.
//   * Each thread owns 4 x 4 output tiles of y (rows x P) and of the state
//     (N x P); every step of its inner loop does 64 FMAs on eight 16-byte
//     shared-memory loads.
//   * Shared memory, f32: S and M (8,448 floats each at Q = 128), B
//     (Q x (N + 4)), and one region that holds C while S is formed and then
//     M and dt * x (Q x P): 177 KB at Q = N = 128, P = 64, 209 KB at
//     P = 128, above the default 48 KB, so the launcher raises the block's
//     limit and returns cudaGetLastError() after the launch.
//   Q, N and P up to 128 are taken; each is padded to a multiple of 4 in
//   shared memory with zeros, and the padded rows are never written out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kHeads = 8;          // heads per block, sharing S = C B^T
constexpr int kMaxDim = 128;       // Q, N, P

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* x; const float* dt; const float* A;
  const void* bm; const void* cm;
  float* y; float* st; float* dec;
  int nc, Q, H, P, N;
  int64_t xsb, xsc, xsq, xsh;   // x strides (b, c, q, h); unit along P
  int64_t dsb, dsc, dsq;        // dt strides (b, c, q); unit along H
  int64_t bsb, bsc, bsq;        // Bm strides (b, c, q); unit along N
  int64_t csb, csc, csq;        // Cm strides
};

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
       + 2 * kHeads * Qp;            // dt [h][j], cum [h][j]
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
    const float Ah = a.A[h0 + tid];
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

    // X = dt * x for this head, and M = S o exp(cum_i - cum_j), j <= i.
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
    const float last = cu[Q - 1];
    for (int idx = tid; idx < Qp * Pp; idx += kThreads)
      Xs[idx] *= expf(last - cu[idx / Pp]);
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
    __syncthreads();   // X and M are rewritten for the next head
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

}  // namespace

extern "C" {

// x (B, nc, Q, H, P), Bm and Cm (B, nc, Q, N) in the given dtype (0 =
// float32, 1 = bf16) and dt (B, nc, Q, H) float32, each with unit stride
// along its last axis and the given element strides along the others; A
// (H,) float32 contiguous.  y (B, nc, Q, H, P), st (B, nc, H, N, P) and dec
// (B, nc, H) are float32 and contiguous.  1 <= Q, N, P <= 128.  Returns a
// cudaError_t.
int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                     const void* bm, const void* cm, void* y, void* st,
                     void* dec, int dtype, int B, int nc, int Q, int H, int P,
                     int N, int64_t xsb, int64_t xsc, int64_t xsq, int64_t xsh,
                     int64_t dsb, int64_t dsc, int64_t dsq, int64_t bsb,
                     int64_t bsc, int64_t bsq, int64_t csb, int64_t csc,
                     int64_t csq, void* stream) {
  if (Q < 1 || Q > kMaxDim || N < 1 || N > kMaxDim || P < 1 || P > kMaxDim
      || H < 1 || nc < 1 || B < 1 || nc > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               bm, cm, static_cast<float*>(y), static_cast<float*>(st),
               static_cast<float*>(dec), nc, Q, H, P, N, xsb, xsc, xsq, xsh,
               dsb, dsc, dsq, bsb, bsc, bsq, csb, csc, csq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
