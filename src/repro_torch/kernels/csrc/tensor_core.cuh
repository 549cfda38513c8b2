// PTX helpers shared by the tensor-core kernels (sm_90a): shared-memory
// addresses, cp.async copies, ldmatrix and mma.sync m16n8k16 with bf16
// operands and float32 accumulators; the swizzled tile layout that the
// flash and ssd backward kernels read with ldmatrix, and the staging of a
// row's 8 bf16 values into it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
// 4-byte copy; src_bytes = 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// c += a b for one m16n8k16 tile (a 16x16 row-major, b 16x8 column-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p0, p1 -> hi = bf16(p), lo = bf16(p - hi), each as a bf16 pair (the
// lower column in the low half).
__device__ __forceinline__ void split(float p0, float p1, uint32_t* hi,
                                      uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  *hi = as_u32(h);
  *lo = as_u32(__floats2bfloat162_rn(p0 - __low2float(h),
                                     p1 - __high2float(h)));
}

// A tile of rows of HD bf16 values in shared memory, in 16-byte chunks.
// Chunk c of row r is stored at chunk (c ^ f(r)), f chosen so that the 8
// rows one ldmatrix phase reads at one column chunk fall in 8 different
// 16-byte bank groups (rows of 64 or 32 bytes share a 128-byte line).
template <int HD>
struct Swizzle {
  static constexpr int kChunks = HD / 8;
  static constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    return static_cast<uint32_t>(
        (r * kChunks + (c ^ ((r / kRowsPerLine) & kMask))) * 16);
  }
};

// Stage 8 bf16 values of a row: `valid` of them are real (none if the row
// is out), the rest zeros.  With vec, one 16-byte cp.async (valid is then a
// multiple of 8); otherwise plain loads and one 16-byte shared store.
__device__ __forceinline__ void stage16(unsigned char* smem, uint32_t off,
                                        const __nv_bfloat16* src, bool row_in,
                                        int valid, bool vec,
                                        const void* any) {
  const bool in = row_in && valid > 0;
  if (vec) {
    cp_async16(smem_u32(smem) + off, in ? static_cast<const void*>(src) : any,
               in ? 16 : 0);
    return;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = in && 2 * e < valid ? s[2 * e] : 0u;
    const uint32_t hi = in && 2 * e + 1 < valid ? s[2 * e + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(smem + off) = make_uint4(w[0], w[1], w[2], w[3]);
}
