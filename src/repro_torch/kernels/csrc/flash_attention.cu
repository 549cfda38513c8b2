// flash_attention: grouped-query attention with an online softmax, for
// sm_90a.
//
//   o[b, i, h, :] = sum_j softmax_j(s[i, j]) v[b, j, h // G, :]
//   s[i, j] = cap(q[b, i, h, :] . k[b, j, h // G, :] / sqrt(hd)), masked
//
// with G = H / KV query heads per KV head, cap(s) = softcap * tanh(s /
// softcap) when softcap > 0, and the masks causal (j <= i) and window
// (j > i - window); masked scores take -1e30.  Scores, the running max and
// sum and the accumulator are float32; o is written in q's dtype (float32
// or bf16).  The final divide is by max(l, 1e-30).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel).  The oracle is
// repro_torch/kernels/ref.py::sdpa (dense, or chunked above 2048^2 scores).
//
// What bounds it on the H100: operations.  At llama3.2-1b's prefill shape
// (B = 1, S = 8192, H = 32, KV = 8, hd = 64, causal, bf16) one call does
// 4 * H * hd * S (S + 1) / 2 = 275 GFLOP of QK^T and PV on 84 MB of q, k,
// v and o: ~3,300 flops per byte, far above the ~295 at which the card's
// bf16 tensor cores stop waiting on memory, so the least time is the FLOP
// bound, 0.278 ms at 989 TFLOP/s.
//
// Design.  This first kernel is simple and right; it runs on the CUDA
// cores in float32 (67 TFLOP/s at most), so it stays far from that bound
// and the f32 limit of 2e-5 against the plain version holds.  Tensor cores
// (mma.sync / wgmma with TMA) are for a later kernel.  What it does about
// the FLOP bound within that:
//   * One block per (tile of 64 rows, KV head, batch), 128 threads.  A row
//     is one (query position, query head of the group) pair, taken
//     position-major, so the G heads that share a KV head share each K/V
//     tile staged in shared memory (the TPU kernel's (G * bq, hd) fold),
//     and any G, Sq and Skv work: the kernel masks the ragged edges itself.
//   * A loop over K/V tiles of 64 keys inside the block takes the place of
//     the TPU grid's sequential kv axis.  Tiles that the causal or window
//     mask hides entirely are skipped, which halves the causal work; tiles
//     are visited in reverse row order so the longest blocks start first.
//   * Each thread owns a 4-row x 8-key tile of scores and a 4-row x hd/8
//     tile of the output, so QK^T and PV each do 32 FMAs for three 16-byte
//     shared-memory loads.  Q and K are staged transposed (d-major) and P
//     key-major, so those loads are float4 reads of consecutive addresses.
//   * q, k and v are read in their (B, S, heads, hd) layout through their
//     strides: no transposed copy is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;            // (position, group head) rows per block
constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kThreads = 128;        // 16 row groups x 8 key groups
constexpr int kRowsPerThread = 4;
constexpr int kKeysPerThread = 8;
constexpr int kPad = 4;              // keeps float4 alignment
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int Sq, Skv, H, G;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;
  float softcap, scale;
};

template <int HD>
constexpr int smem_floats() {
  return HD * (kRows + kPad)        // Qs[d][row]
       + HD * (kKeys + kPad)        // Ks[d][key]
       + kKeys * HD                 // Vs[key][d]
       + kKeys * (kRows + kPad);    // Ps[key][row]
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int kCols = HD / 8;     // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + HD * (kRows + kPad);
  float* Vs = Ks + HD * (kKeys + kPad);
  float* Ps = Vs + kKeys * HD;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int tile = gridDim.x - 1 - blockIdx.x;     // longest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;            // row group, key group
  const int G = a.G;
  const int row0 = tile * kRows;
  const int n_rows = a.Sq * G;

  // Stage the block's q rows, transposed, in float32.
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int gr = row0 + r;
    float x = 0.0f;
    if (gr < n_rows) {
      const int pos = gr / G, h = kvh * G + gr % G;
      x = to_f32(q[b * a.qsb + pos * a.qss + h * a.qsh + d]);
    }
    Qs[d * (kRows + kPad) + r] = x;
  }

  int qpos[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    qpos[i] = (row0 + rg * kRowsPerThread + i) / G;

  // The keys some row of this block can see.
  const int q_lo = row0 / G;
  const int q_hi = min((row0 + kRows - 1) / G, a.Sq - 1);
  int k_begin = 0, k_end = a.Skv;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  if (a.window > 0) k_begin = max(0, q_lo - a.window + 1);
  k_begin = (k_begin / kKeys) * kKeys;

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();   // the previous tile's Ks, Vs and Ps are consumed
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const int kp = kt + j;
      float kx = 0.0f, vx = 0.0f;
      if (kp < a.Skv) {
        kx = to_f32(k[b * a.ksb + kp * a.kss + kvh * a.ksh + d]);
        vx = to_f32(v[b * a.vsb + kp * a.vss + kvh * a.vsh + d]);
      }
      Ks[d * (kKeys + kPad) + j] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    // s = q k^T for this thread's 4 rows x 8 keys.
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(
          Qs + d * (kRows + kPad) + rg * kRowsPerThread);
      const float4 k0 = *reinterpret_cast<const float4*>(
          Ks + d * (kKeys + kPad) + cg * kKeysPerThread);
      const float4 k1 = *reinterpret_cast<const float4*>(
          Ks + d * (kKeys + kPad) + cg * kKeysPerThread + 4);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // Scale, cap, mask; online softmax over the tile.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kp = kt + cg * kKeysPerThread + j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
        bool keep = kp < a.Skv;
        if (a.causal) keep = keep && kp <= qpos[i];
        if (a.window > 0) keep = keep && kp > qpos[i] - a.window;
        x = keep ? x : kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 threads of a row group are lanes that differ in bits 0-2
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      *reinterpret_cast<float4*>(Ps + (cg * kKeysPerThread + j) * (kRows + kPad)
                                 + rg * kRowsPerThread) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows x hd/8 columns.
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(
          Ps + j * (kRows + kPad) + rg * kRowsPerThread);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      float vr[kCols];
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + j * HD + cg * kCols + c);
          vr[c] = vv.x; vr[c + 1] = vv.y; vr[c + 2] = vv.z; vr[c + 3] = vv.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) vr[c] = Vs[j * HD + cg * kCols + c];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
    }
  }

  // o is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gr = row0 + rg * kRowsPerThread + i;
    if (gr >= n_rows) continue;
    const int pos = gr / G, h = kvh * G + gr % G;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* out = o + ((static_cast<int64_t>(b) * a.Sq + pos) * a.H + h) * HD
             + cg * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(out + c, acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, int KV, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), KV, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, int KV, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, B, KV, stream);
    case 32: return launch<T, 32>(a, B, KV, stream);
    case 64: return launch<T, 64>(a, B, KV, stream);
    case 128: return launch<T, 128>(a, B, KV, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd), each with unit stride along
// hd and the given element strides along batch, sequence and head; o is
// contiguous (B, Sq, H, hd) in q's dtype.  dtype 0 = float32, 1 = bf16;
// hd in {16, 32, 64, 128}.  Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int Sq, int Skv, int H,
                           int KV, int hd, int64_t qsb, int64_t qss,
                           int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                           int64_t vsb, int64_t vss, int64_t vsh, int causal,
                           int window, float softcap, float scale,
                           void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, Sq, Skv, H, H / KV, qsb, qss, qsh, ksb, kss, ksh,
               vsb, vss, vsh, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, KV, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, KV, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
