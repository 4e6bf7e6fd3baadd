// The tensor-core instructions of the lazy2 tile stage (gf_block_src.cuh),
// and nothing else: the block kernels' inline PTX lives here (beside
// gf_common.cuh's max.NaN / min.NaN, which have a C++ form for a host
// compiler), so a CPU rehearsal of the kernels can replace this one file by
// a scalar emulation with the same lane -> fragment mapping and the same
// rounding.
//
//   * split: x = hi + lo, both rounded to TF32 as cvt.rna rounds (to
//     nearest, ties away from zero, 10 mantissa bits kept); a NaN x keeps
//     making NaN products (keep_nan, split_tf32_any), as in the plain
//     emulation (ops/gf_block.py round_tf32, matmul_3xtf32);
//   * mma3_tile: acc += a * b over a warp's tile of fragment pairs, each as
//     three m16n8k8 TF32 products with f32 accumulation, lo*hi + hi*lo
//     first, then hi*hi ("3xTF32": about f32 accuracy; a single TF32 pass
//     keeps ~3 decimal digits);
//   * cp.async of 16 or 4 bytes from global to shared memory, zero-filled
//     when the source size is 0.
//
// m16n8k8 fragments (PTX ISA, mma .tf32), lane = 4 * g + q:
//   A (16 x 8, row-major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
//                          a3 (g + 8, q + 4)
//   B (8 x 8, k x n):      b0 (q, g), b1 (q + 4, g)
//   C, D (16 x 8):         c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q),
//                          c3 (g + 8, 2q + 1)
#pragma once

#include <cstdint>

namespace gf {

// cvt.rna.tf32.f32 by integer operations: half a TF32 ulp added to the
// bits, the low 13 bits cleared (ties away from zero, the sign being a bit
// of its own).  The same bits as the conversion instruction for finite x,
// at the full integer rate where the conversion runs at a fraction of it.
// Not for a NaN: its mantissa's carry can run into the exponent or the
// sign (CUDA's NaN 0x7fffffff becomes -0); split_tf32 keeps it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32 parts, for an x that is finite or a NaN that
// to_tf32 keeps (keep_nan): the tile stages write such NaNs into their
// shared operands (the hidden column, a row's cotangents), so that the
// products' inner loops pay nothing for them.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x, with a NaN replaced by one that to_tf32 keeps (0x7fc00000)
__device__ __forceinline__ float keep_nan(float x) {
  return x != x ? __uint_as_float(0x7fc00000u) : x;
}

// split_tf32 for an operand as it comes from global memory (the final MLP
// weight w, any bits): a non-finite x makes r = x - hi a NaN (NaN - any,
// inf - inf), and lo takes it through 0 * r (NaN for a NaN r, +-0 else,
// which leaves a rounded lo's bits as they are), so every product with x
// is NaN, as with round_tf32 in ops/gf_block.py.  One FMA more than
// split_tf32 (a NaN select in to_tf32 slows the lazy2 kernels by 21-44%
// on an H100: the integer pipe paces the products' inner loops).
__device__ __forceinline__ void split_tf32_any(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = to_tf32(x);
  const float r = x - __uint_as_float(hi);
  lo = __float_as_uint(fmaf(0.0f, r, __uint_as_float(to_tf32(r))));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += A_i B_j for the first m A fragments and n B fragments, in
// 3xTF32: the lo*hi products of every pair, then hi*lo, then hi*hi, so that
// neighbouring instructions never wait on one accumulator
template <int M, int N>
__device__ __forceinline__ void mma3_tile(float (&acc)[M][N][4],
                                          const uint32_t (&ahi)[M][4],
                                          const uint32_t (&alo)[M][4],
                                          const uint32_t (&bhi)[N][2],
                                          const uint32_t (&blo)[N][2], int m,
                                          int n) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < m && j < n) mma_tf32(acc[i][j], alo[i], bhi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < m && j < n) mma_tf32(acc[i][j], ahi[i], blo[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < m && j < n) mma_tf32(acc[i][j], ahi[i], bhi[j]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace gf
