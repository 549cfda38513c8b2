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
// or bf16).  The final divide is by max(l, 1e-30).  Given a non-null lse
// (float32, (B, H, Sq)), each row's log-sum-exp m + log(l) is written there
// too: the backward (flash_attention_bwd.cu) rebuilds P = exp(s - lse) from
// it.  Prefill and serve pass null, and the kernel then does what it did
// before lse existed, bit for bit.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:77,
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
// Two routes, chosen in flash_attention_launch by dtype.  Both take one
// block per (tile of rows, KV head, batch), where a row is one (query
// position, query head of the group) pair taken position-major, so the G
// heads that share a KV head share each K/V tile staged in shared memory
// (the TPU kernel's (G * bq, hd) fold) and any G, Sq and Skv work: the
// kernel masks the ragged edges itself.  A loop over K/V tiles of 64 keys
// inside the block takes the place of the TPU grid's sequential kv axis;
// tiles that the causal or window mask hides entirely are skipped, which
// halves the causal work, and the longest row tiles are launched first.
// q, k and v are read in their (B, S, heads, hd) layout through their
// strides: no transposed copy is made.
//
// * bf16: the tensor cores (flash_kernel_mma).  64 rows a block, 16 per
//   warp (8 warps of 16 measured no faster: K/V traffic is not what bounds
//   it).  S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, f32
//   accumulate); q and k are bf16, so the products are exact and S is the
//   same float32 dot product the plain version forms, up to summation
//   order.  Q is staged once and, at hd <= 128, kept in registers as A
//   fragments; K and V tiles are double-buffered in shared memory by
//   16-byte cp.async copies (keys past Skv zero-filled: v must be 0 there,
//   as 0 * garbage can be NaN), in an XOR-swizzled layout so that ldmatrix
//   (K) and ldmatrix.trans (V) run without bank conflicts.  The online
//   softmax runs on the quad of lanes that holds a row in the accumulator
//   layout, with exp on the special-function unit; the soft-cap and the
//   mask each sit in a branch around a whole loop, so the common path's
//   code stays short (inside the per-score loop they cost 1.8x).
//   Why P is split: the product P V takes bf16 operands, and rounding the
//   softmax weights P to bf16 once (the usual tensor-core design) moves
//   ~10% of the outputs by more than one bf16 step from the plain version
//   (9.6% at llama's shape on the H100), which rounds one float32 result
//   once; the port holds every bf16 lane within that step.  So each float32 P is split into hi = bf16(P) and
//   lo = bf16(P - hi), both built straight from the S accumulators (the
//   m16n8k16 C layout is its A layout), and O += hi V + lo V: P is carried
//   to ~2^-17 of itself, at 1.5x the tensor-core work of one bf16 P (on
//   the H100 at llama's shape the lo products cost ~20% of the kernel's
//   time).  The sum l is taken over the float32 P.  What keeps it from the
//   FLOP bound is mma.sync itself (Hopper's full tensor-core rate needs
//   wgmma) and the softmax's scalar work between the products; wgmma fed
//   by TMA, with a producer warp, is the next step.
//   At hd = 256 (gemma) the per-warp O accumulator alone is 32 n-tiles x 4
//   = 128 float32 registers a thread, and Q's A fragments would be 16
//   k-steps x 4 = 64 more: with S (32) and P's hi and lo fragments that is
//   past the 255 a thread may have.  So there Q stays in shared memory,
//   where it is staged anyway, and each k-step of Q K^T reads its A
//   fragment by ldmatrix (FlashAttention-2's choice at hdim 256): 4 live
//   registers instead of 64, for one more ldmatrix per k-step and K tile.
//   The block's 163,840 bytes of shared memory (Q, and K and V double
//   buffered) leave room for one block an SM.
// * float32: the CUDA cores (flash_kernel).  TF32 would not hold the 2e-5
//   limit against the plain version.  64 rows a block; each thread owns a
//   4-row x 8-key tile of scores and a 4-row x hd/8 tile of the output, so
//   QK^T and PV each do 32 FMAs for three 16-byte shared-memory loads.  At
//   hd = 256 its tiles take 222,208 bytes, under the 232,448 a block may
//   opt into, and each thread 128 accumulators; V is read four columns at
//   a time and used at once, so no 32-float row of V is held.  Q
//   and K are staged transposed (d-major) and P key-major, so those loads
//   are float4 reads of consecutive addresses.  It runs at up to 67
//   TFLOP/s, far from the bf16 bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kKeys = 64;            // keys per K/V tile (both routes)
constexpr float kNeg = -1e30f;

struct Args {
  const void* q; const void* k; const void* v; void* o;
  float* lse;                        // (B, H, Sq) or null
  int Sq, Skv, H, G;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;
  float softcap, scale;
};

// The first K/V tile some row of positions [q_lo, q_hi] can see, and the
// end of the keys they can see.
__device__ __forceinline__ void key_range(const Args& a, int q_lo, int q_hi,
                                          int* k_begin, int* k_end) {
  int lo = 0, hi = a.Skv;
  if (a.causal) hi = min(hi, q_hi + 1);
  if (a.window > 0) lo = max(0, q_lo - a.window + 1);
  *k_begin = (lo / kKeys) * kKeys;
  *k_end = hi;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kRows = 64;            // (position, group head) rows per block
constexpr int kThreads = 128;        // 16 row groups x 8 key groups
constexpr int kRowsPerThread = 4;
constexpr int kKeysPerThread = 8;
constexpr int kPad = 4;              // keeps float4 alignment

template <int HD>
constexpr int smem_floats() {
  return HD * (kRows + kPad)        // Qs[d][row]
       + HD * (kKeys + kPad)        // Ks[d][key]
       + kKeys * HD                 // Vs[key][d]
       + kKeys * (kRows + kPad);    // Ps[key][row]
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int kCols = HD / 8;     // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + HD * (kRows + kPad);
  float* Vs = Ks + HD * (kKeys + kPad);
  float* Ps = Vs + kKeys * HD;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);

  const int tile = gridDim.x - 1 - blockIdx.x;     // longest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;            // row group, key group
  const int G = a.G;
  const int row0 = tile * kRows;
  const int n_rows = a.Sq * G;

  // Stage the block's q rows, transposed.
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int gr = row0 + r;
    float x = 0.0f;
    if (gr < n_rows) {
      const int pos = gr / G, h = kvh * G + gr % G;
      x = q[b * a.qsb + pos * a.qss + h * a.qsh + d];
    }
    Qs[d * (kRows + kPad) + r] = x;
  }

  int qpos[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    qpos[i] = (row0 + rg * kRowsPerThread + i) / G;

  int k_begin, k_end;
  key_range(a, row0 / G, min((row0 + kRows - 1) / G, a.Sq - 1), &k_begin,
            &k_end);

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
        kx = k[b * a.ksb + kp * a.kss + kvh * a.ksh + d];
        vx = v[b * a.vsb + kp * a.vss + kvh * a.vsh + d];
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
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + j * HD + cg * kCols + c);
          const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[i][c + cc] = fmaf(pr[i], vr[cc], acc[i][c + cc]);
        }
      } else {
        float vr[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vr[c] = Vs[j * HD + cg * kCols + c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
      }
    }
  }

  // o is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int gr = row0 + rg * kRowsPerThread + i;
    if (gr >= n_rows) continue;
    const int pos = gr / G, h = kvh * G + gr % G;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && cg == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + h) * a.Sq + pos] =
          m[i] + logf(l[i]);
    float* out = o + ((static_cast<int64_t>(b) * a.Sq + pos) * a.H + h) * HD
                 + cg * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = acc[i][c] * inv;
  }
}

template <int HD>
int launch(const Args& a, int B, int KV, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), KV, B);
  flash_kernel<HD><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;   // fold rows per block, 16 per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kKeys / 8;       // 8-key column tiles of S per warp

// exp(x) as 2^(x log2 e), one instruction on the special-function unit:
// within ~2^-22 of expf relative (results below 2^-126 flush to 0), far
// below a bf16 step.  x = s - m is formed first, so a masked score at a
// row's running max (-1e30 - -1e30) gives exactly 1 and one below a real
// max gives 0, as with expf.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

template <int HD>
constexpr int smem_bytes() {
  return (kRows + 4 * kKeys) * HD * 2;   // Q; K and V, two buffers each
}

// At hd <= 64, 128 registers a thread keep four blocks (16 warps) on an SM;
// at hd = 256 shared memory holds one block an SM, which may then take up
// to 255 registers a thread.
template <int HD>
constexpr int kMinBlocks = HD <= 64 ? 4 : (HD <= 128 ? 2 : 1);

// Q's A fragments live in registers up to hd = 128 and are read from shared
// memory each k-step above (see the note at the top of the file).
template <int HD>
constexpr bool kQInRegisters = HD <= 128;

template <int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
flash_kernel_mma(const Args a, int n_tiles, int KV, int B) {
  constexpr int kChunks = HD / 8;
  constexpr int kSteps = HD / 16;    // k-steps of Q K^T
  constexpr int kOut = HD / 8;       // 8-column tiles of O
  constexpr uint32_t kTileBytes = kKeys * HD * 2;
  using Sw = Swizzle<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + kRows * HD * 2;
  const uint32_t s_v = s_k + 2 * kTileBytes;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);

  // Blocks in launch order: every (KV head, batch) of the longest row tile,
  // then of the next.
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / (KV * B);
  const int rest = static_cast<int>(blockIdx.x) % (KV * B);
  const int kvh = rest % KV, b = rest / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = a.G;
  const int n_rows = a.Sq * G;
  const int row0 = tile * kRows;

  int k_begin, k_end;
  key_range(a, row0 / G, min((row0 + kRows - 1) / G, a.Sq - 1), &k_begin,
            &k_end);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                   : 0;

  // Stage Q (rows past the end are zeros).
  for (int idx = tid; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int gr = row0 + r;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (gr < n_rows) {
      const int pos = gr / G, h = kvh * G + gr % G;
      src = q + b * a.qsb + pos * a.qss + h * a.qsh + c * 8;
      bytes = 16;
    }
    cp_async16(s_q + Sw::off(r, c), src, bytes);
  }
  cp_async_commit();

  // Each thread copies one 16-byte column chunk of every kRowStep-th key.
  constexpr int kRowStep = kThreads / kChunks;
  const int lr = tid / kChunks, lc = tid % kChunks;
  const __nv_bfloat16* kg = k + b * a.ksb + kvh * a.ksh + lc * 8;
  const __nv_bfloat16* vg = v + b * a.vsb + kvh * a.vsh + lc * 8;
  auto load_kv = [&](int kt, int buf) {
#pragma unroll
    for (int r = lr; r < kKeys; r += kRowStep) {
      const int kp = kt + r;
      const bool in = kp < a.Skv;
      const int64_t kr = in ? kp : 0;
      const uint32_t dst = buf * kTileBytes + Sw::off(r, lc);
      cp_async16(s_k + dst, kg + kr * a.kss, in ? 16 : 0);
      cp_async16(s_v + dst, vg + kr * a.vss, in ? 16 : 0);
    }
  };
  if (n_kt > 0) load_kv(k_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();                // Q has landed
  __syncthreads();

  // The A fragment of the warp's 16 rows at k-step kk.
  auto q_frag_addr = [&](int kk) {
    return s_q + Sw::off(warp * 16 + lane % 16, 2 * kk + lane / 16);
  };
  constexpr int kQRegSteps = kQInRegisters<HD> ? kSteps : 1;
  uint32_t qf[kQRegSteps][4];
  if constexpr (kQInRegisters<HD>) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) ldsm_x4(q_frag_addr(kk), qf[kk]);
  }

  // This thread holds rows r_a = wr0 + g and r_b = r_a + 8 of the warp's.
  const int wr0 = row0 + warp * 16;
  const int pos_a = (wr0 + g) / G, pos_b = (wr0 + g + 8) / G;
  const int wq_lo = wr0 / G, wq_hi = (wr0 + 15) / G;

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.0f, l_b = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int kt = k_begin + it * kKeys;
    if (it + 1 < n_kt) {
      load_kv(kt + kKeys, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // A tile that hides every key from all the warp's rows changes nothing
    // (its weights are exp(-1e30 - m) = 0, or are rescaled away by 0).
    const bool live = !(a.causal && kt > wq_hi)
                      && !(a.window > 0 && kt + kKeys - 1 <= wq_lo - a.window);
    if (live) {
      const uint32_t kb = s_k + (it & 1) * kTileBytes;
      const uint32_t vb = s_v + (it & 1) * kTileBytes;

      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t(&qa)[4] = qf[kQInRegisters<HD> ? kk : 0];
        if constexpr (!kQInRegisters<HD>) ldsm_x4(q_frag_addr(kk), qa);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          uint32_t kf[4];
          ldsm_x4(kb + Sw::off(16 * jp + lane % 8 + 8 * (lane / 16),
                               2 * kk + (lane / 8) % 2), kf);
          mma_bf16(s[2 * jp], qa, kf[0], kf[1]);
          mma_bf16(s[2 * jp + 1], qa, kf[2], kf[3]);
        }
      }

      // Scale, cap; mask only where the tile crosses an edge of some row.
      // Each branch holds a whole loop, so the common path stays short.
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= a.scale;
      if (a.softcap > 0.0f) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = a.softcap * tanhf(s[j][e] / a.softcap);
      }
      if (kt + kKeys > a.Skv || (a.causal && kt + kKeys - 1 > wq_lo)
          || (a.window > 0 && kt <= wq_hi - a.window)) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kt + 8 * j + 2 * t + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            bool keep = kp < a.Skv;
            if (a.causal) keep = keep && kp <= pos;
            if (a.window > 0) keep = keep && kp > pos - a.window;
            if (!keep) s[j][e] = kNeg;
          }
        }
      }

      // Online softmax; a row lives on the 4 lanes of a quad.
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float c_a = exp_sfu(m_a - mn_a), c_b = exp_sfu(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = exp_sfu(s[j][0] - mn_a);
        s[j][1] = exp_sfu(s[j][1] - mn_a);
        s[j][2] = exp_sfu(s[j][2] - mn_b);
        s[j][3] = exp_sfu(s[j][3] - mn_b);
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
      l_a = l_a * c_a + sum_a;       // this lane's share of the row's sum
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        acc[n][0] *= c_a;
        acc[n][1] *= c_a;
        acc[n][2] *= c_b;
        acc[n][3] *= c_b;
      }

      // O += hi V + lo V over the tile's four 16-key steps.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split(s[2 * kk][0], s[2 * kk][1], &ph[0], &pl[0]);
        split(s[2 * kk][2], s[2 * kk][3], &ph[1], &pl[1]);
        split(s[2 * kk + 1][0], s[2 * kk + 1][1], &ph[2], &pl[2]);
        split(s[2 * kk + 1][2], s[2 * kk + 1][3], &ph[3], &pl[3]);
#pragma unroll
        for (int np = 0; np < kOut / 2; ++np) {
          uint32_t vf[4];
          ldsm_x4_trans(vb + Sw::off(16 * kk + lane % 8 + 8 * ((lane / 8) % 2),
                                     2 * np + lane / 16), vf);
          mma_bf16(acc[2 * np], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * np], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                 // this buffer is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);

  // o is contiguous (B, Sq, H, hd).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gr = wr0 + g + 8 * half;
    if (gr >= n_rows) continue;
    const int pos = gr / G, h = kvh * G + gr % G;
    const float d = half ? d_b : d_a;
    if (a.lse != nullptr && t == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + h) * a.Sq + pos] =
          (half ? m_b : m_a) + logf(half ? l_b : l_a);
    __nv_bfloat16* out =
        o + ((static_cast<int64_t>(b) * a.Sq + pos) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < kOut; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * half] / d, acc[n][2 * half + 1] / d);
  }
}

template <int HD>
int launch(const Args& a, int B, int KV, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const int64_t n_tiles = (rows + kRows - 1) / kRows;
  const int64_t blocks = n_tiles * KV * B;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel_mma<HD><<<static_cast<unsigned>(blocks), kThreads, bytes,
                         stream>>>(a, static_cast<int>(n_tiles), KV, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int HD>
int launch(bool tensor_cores, const Args& a, int B, int KV, cudaStream_t s) {
  return tensor_cores ? tc::launch<HD>(a, B, KV, s)
                      : simt::launch<HD>(a, B, KV, s);
}

int dispatch(bool tensor_cores, const Args& a, int B, int KV, int hd,
             cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(tensor_cores, a, B, KV, s);
    case 32: return launch<32>(tensor_cores, a, B, KV, s);
    case 64: return launch<64>(tensor_cores, a, B, KV, s);
    case 128: return launch<128>(tensor_cores, a, B, KV, s);
    case 256: return launch<256>(tensor_cores, a, B, KV, s);
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
// hd and the given element strides along batch, sequence and head; o is
// contiguous (B, Sq, H, hd) in q's dtype; lse, when not null, is
// contiguous float32 (B, H, Sq).  dtype 0 = float32 (CUDA cores),
// 1 = bf16 (tensor cores; needs 16-byte aligned q, k, v and strides that
// are multiples of 8); hd in {16, 32, 64, 128, 256}.  Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int dtype, int B, int Sq,
                           int Skv, int H, int KV, int hd, int64_t qsb,
                           int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                           int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                           int causal, int window, float softcap, float scale,
                           void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, Sq, Skv, H, H / KV, qsb, qss, qsh, ksb, kss,
               ksh, vsb, vss, vsh, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch(false, a, B, KV, hd, s);
  if (dtype == 1) {
    if (!aligned16(q, qsb, qss, qsh) || !aligned16(k, ksb, kss, ksh)
        || !aligned16(v, vsb, vss, vsh))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return dispatch(true, a, B, KV, hd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
