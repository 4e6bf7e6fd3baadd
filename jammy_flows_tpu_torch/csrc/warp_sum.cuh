// Summing a piece of per-row cotangents over the 32 rows of a warp into the
// warp's own partial of a parameter gradient, with shuffles and no barrier.
// Shared by the block backward's perm mode (gf_block_bwd.cu) and the
// per-layer backward's raw broadcast kernel (gf_layer_bwd.cu): a row of
// the partial always belongs to the same lane, so no other lane or warp
// touches it, and each warp's partial is summed with the others' once, at
// the end of the block, in warp order.
#pragma once

#include <cuda_runtime.h>

namespace gf {

// v[0] of lane l ends as the sum over the warp's 32 lanes of v[l % NV] (NV
// a power of two <= 32): NV - 1 exchanges halve the values a lane holds
// (lanes that differ in bit s swap the halves the other keeps), then the
// lanes that hold the same value index add theirs by a butterfly.  A fixed
// order of additions: the same bits on every call.
template <int NV>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[NV]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = NV / 2; s >= 1; s /= 2) {
    const bool upper = lane & s;
#pragma unroll
    for (int j = 0; j < s; ++j) {
      const float send = upper ? v[j] : v[j + s];
      const float keep = upper ? v[j + s] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
#pragma unroll
  for (int s = NV; s < 32; s *= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], s);
  return v[0];
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Add the warp's rows' cotangents of one piece (n <= NV values a row,
// parameter rows rows(j)) to the warp's partial: the warp sum of value j
// lands on lane j % 32, which owns rows(j) in the partial (a row belongs
// to one piece, so to one lane: no other lane or warp touches it).  NV is
// the length of the caller's array: up to 32 the values stay in registers
// and take one transpose-sum; beyond they go 32 at a time, and where NV is
// not a multiple of 32 (the per-layer skewed pieces: 4K values) the last
// NV % 32 by one transpose-sum of their own width.  Every lane of the warp
// calls it, rows past B with zeros.
template <int NV, class Rows>
__device__ __forceinline__ void warp_flush(float* wpart, const float* vals,
                                           int n, const Rows& rows) {
  const int lane = threadIdx.x & 31;
  if constexpr (NV <= 32) {
    constexpr int W = pow2_at_least(NV);
    float v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = (j < NV && j < n) ? vals[j] : 0.0f;
    const float sum = warp_transpose_sum<W>(v);
    if (lane < n) wpart[rows(lane)] += sum;
  } else if constexpr (NV % 32 == 0) {
    for (int c0 = 0; c0 < n; c0 += 32) {
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = c0 + j < n ? vals[c0 + j] : 0.0f;
      const float sum = warp_transpose_sum<32>(v);
      if (c0 + lane < n) wpart[rows(c0 + lane)] += sum;
    }
  } else {
    constexpr int C = NV / 32 * 32;  // the whole chunks of 32
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += 32) {
      if (c0 >= n) return;
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = c0 + j < n ? vals[c0 + j] : 0.0f;
      const float sum = warp_transpose_sum<32>(v);
      if (c0 + lane < n) wpart[rows(c0 + lane)] += sum;
    }
    if (C >= n) return;
    constexpr int W = pow2_at_least(NV - C);
    float v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = (j < NV - C && C + j < n) ? vals[C + j] : 0.0f;
    const float sum = warp_transpose_sum<W>(v);
    if (C + lane < n) wpart[rows(C + lane)] += sum;
  }
}

}  // namespace gf
