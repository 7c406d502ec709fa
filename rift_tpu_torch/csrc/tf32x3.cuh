// f32-accurate matrix products on Hopper's tensor cores (3xTF32), by
// mma.sync and by warpgroup wgmma, and the cp.async copies that stage
// weights in shared memory. Shared by points.cu and history_encoder.cu.
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits, ~3 decimal digits.
// Split each f32 operand into hi = tf32(x) and lo = tf32(x - hi); then
// a.b = ahi.bhi + ahi.blo + alo.bhi + alo.blo, and the last term is below
// f32's own rounding (2^-22 relative). The three kept products run as
// .tf32 mma.sync m16n8k8 or wgmma m64n64k8 with f32 accumulation, so a
// product costs three tensor-core products (495 / 3 = 165 TFLOP/s dense on
// an H100 SXM) and its error stays within a few f32 roundings of a plain
// f32 product, provided each short run of K is summed from zero and then
// added in f32 (the tensor cores truncate every result).
//
// Fragment layout of mma.sync.m16n8k8 (PTX ISA), g = lane / 4, t = lane % 4:
//   A [16 x 8] row-major: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B [8 x 8] (k x n):    b0 (t, g), b1 (t + 4, g)
//   C [16 x 8]:           c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// tf32(x), rounded to nearest with ties away from zero (cvt.rna.tf32.f32),
// in integer arithmetic: add half of the lowest kept bit to the magnitude
// and clear the 13 dropped bits. (The conversion instruction issues at a
// fraction of the integer rate, and a product splits every operand.)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b at f32 accuracy, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);
}

// The A fragment of rows r0 .. r0+15, columns k .. k+7 of a row-major
// f32 matrix in shared memory (row stride lda), split.
__device__ __forceinline__ void load_a(const float* A, int lda, int r0, int k,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* a = A + (r0 + g) * lda + k + t;
  split(a[0], hi[0], lo[0]);
  split(a[8 * lda], hi[1], lo[1]);
  split(a[4], hi[2], lo[2]);
  split(a[8 * lda + 4], hi[3], lo[3]);
}

// The B fragment of rows k .. k+7, columns n .. n+7 of a row-major [K, N]
// f32 matrix in shared memory (row stride ldb), split.
__device__ __forceinline__ void load_b(const float* B, int ldb, int k, int n,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* b = B + (k + t) * ldb + n + g;
  split(b[0], hi[0], lo[0]);
  split(b[4 * ldb], hi[1], lo[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows k0 .. k0+rows-1, columns c0 .. c0+cols-1 of the
// row-major [K, N] matrix W (device memory) into dst (shared memory, row
// stride ldd, a multiple of 4), by the whole block: 16-byte copies where
// the rows allow, else 4-byte ones. The caller commits and waits.
__device__ __forceinline__ void stage(float* dst, int ldd,
                                      const float* __restrict__ W, int N,
                                      int k0, int rows, int c0, int cols) {
  const float* src = W + (long long)k0 * N + c0;
  if (((N | c0 | cols) & 3) == 0 && ((uintptr_t)W & 15) == 0) {
    const int q = cols >> 2;
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
      const int r = i / q;
      const int c = (i - r * q) << 2;
      cp_async16(dst + r * ldd + c, src + (long long)r * N + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols;
      const int c = i - r * cols;
      cp_async4(dst + r * ldd + c, src + (long long)r * N + c);
    }
  }
}

// ---- warpgroup products (wgmma, sm_90a)
//
// A warpgroup (four consecutive warps, 128 threads) issues
// wgmma.mma_async m64n64k8: D [64 x 64] (+)= A [64 x 8] . B [8 x 64], with
// A in registers (warp w of the group holds rows 16w .. 16w+15 in the
// mma.m16n8k8 A layout above) and B in shared memory, K-major, as 8 x 16-
// byte core matrices (8 columns of B x 4 of K each, 128 contiguous bytes):
// the core matrix of column group q and K group c at q * SBO + c * LBO
// bytes. The thread's 32 results: d[4j + i] at row 16w + g + 8 (i / 2),
// column 8j + 2t + i % 2 (the C layout above, for j < 8).

// The shared-memory matrix descriptor: start address, LBO and SBO (bytes,
// multiples of 16), no swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D (64 x 64) = a.b (accumulate = 0) or D += a.b (accumulate = 1),
// asynchronously: wgmma.mma_async m64n64k8.
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Orders the compiler's accesses to registers around asynchronous wgmma
// (which read and write them behind its back).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma's reads (the
// async proxy); a block barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace tc
