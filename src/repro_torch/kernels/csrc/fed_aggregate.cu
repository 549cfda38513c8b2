// fed_aggregate: the F3AST server reduction (Alg. 1 line 9), for sm_90a.
//
//   delta[d] = sum_k w[k] * v[k, d]      accumulated in float32, written in
//                                        the delta dtype (float32 or bf16)
//
// Replaces the Pallas TPU kernel of src/repro/kernels/fed_aggregate.py:
// _fed_aggregate (body _agg_kernel).  The oracle is
// repro_torch/kernels/ref.py::fed_aggregate_ref.
//
// What bounds it on the H100: bytes.  It does 2 flops for every element of
// v it reads (K * D * sizeof(T) bytes), far below the card's ~20 flops per
// byte of float32 rate, so the least time is (K + 1) * D * sizeof(T) over
// 3.35 TB/s: ~0.22 ms for (10, 2^24) float32.
//
// Design.  On the TPU the cohort axis K is the sequential inner grid axis
// with an accumulator in VMEM scratch.  Here each thread owns 4 consecutive
// d and loops over the K rows itself, accumulating in registers: every
// element of v is read once, as 16-byte (float32) or 8-byte (bf16) vector
// loads where the rows are aligned, with a masked scalar path for the
// ragged edge, and each output is written once.  The K weights are read
// through the read-only cache.  The fed round flattens the whole parameter
// dict into one (K, D) buffer, so a round makes one launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float x[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  x[0] = fa.x; x[1] = fa.y; x[2] = fb.x; x[3] = fb.y;
}

__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float x[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x[0], x[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void agg_kernel(const T* __restrict__ v, const float* __restrict__ w,
                           T* __restrict__ out, int k_rows, int64_t d_cols,
                           int vec_ok) {
  const int64_t d0 = kPerThread * (static_cast<int64_t>(blockIdx.x) * blockDim.x
                                   + threadIdx.x);
  if (d0 >= d_cols) return;
  float acc[kPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (vec_ok && d0 + kPerThread <= d_cols) {
    for (int k = 0; k < k_rows; ++k) {
      const float wk = __ldg(w + k);
      float x[kPerThread];
      load4(v + k * d_cols + d0, x);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[j] = fmaf(wk, x[j], acc[j]);
    }
    store4(out + d0, acc);
    return;
  }
  const int m = d_cols - d0 < kPerThread ? static_cast<int>(d_cols - d0) : kPerThread;
  for (int k = 0; k < k_rows; ++k) {
    const float wk = __ldg(w + k);
    for (int j = 0; j < m; ++j)
      acc[j] = fmaf(wk, to_f32(v[k * d_cols + d0 + j]), acc[j]);
  }
  for (int j = 0; j < m; ++j) from_f32(out + d0 + j, acc[j]);
}

template <typename T>
int launch(const T* v, const float* w, T* out, int k_rows, int64_t d_cols,
           void* stream_ptr) {
  // Vector loads need every row start and the output aligned to 4 elements.
  const uintptr_t align = kPerThread * sizeof(T);
  const int vec_ok = d_cols % kPerThread == 0
                     && reinterpret_cast<uintptr_t>(v) % align == 0
                     && reinterpret_cast<uintptr_t>(out) % align == 0;
  const int64_t threads = (d_cols + kPerThread - 1) / kPerThread;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  agg_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream_ptr)>>>(v, w, out, k_rows,
                                                          d_cols, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// deltas (K, D) row-major, weights (K,) float32, out (D,).  Returns a
// cudaError_t.
int fed_aggregate_f32(const float* v, const float* w, float* out, int k_rows,
                      int64_t d_cols, void* stream) {
  return launch(v, w, out, k_rows, d_cols, stream);
}

int fed_aggregate_bf16(const void* v, const float* w, void* out, int k_rows,
                       int64_t d_cols, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(v), w,
                static_cast<__nv_bfloat16*>(out), k_rows, d_cols, stream);
}

}  // extern "C"
