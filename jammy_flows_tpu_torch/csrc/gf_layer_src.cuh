// Parameter sources of the per-layer kernels, shared by the forward
// (gf_layer.cu) and the backward (gf_layer_bwd.cu), so that the backward
// recomputes each mixture with the forward's own code.  One call covers one
// `g` layer: x (B, D) and its mixture parameters, in one of three
// interfaces (ops/gf_layer.py):
//   * prepared: (means, inverse widths, log weights), made outside;
//   * raw: the pre-regulator slabs (means, lw, [ln], [se]); the regulators,
//     the weight normalization and the skew exponents run here;
//   * lazy: the final amortization-MLP product b_j + w_j . hidden made here
//     for each row and parameter row, from the row's hidden activations.
// Prepared and raw slabs are broadcast (K, D) or per row (K, D, B), B minor,
// so the threads of a warp (one row each) read neighbouring floats.
// Broadcast slabs are prepared once per block into shared memory; lazy
// blocks stage their rows' hidden activations there (H x (threads + 1)
// floats, conflict-free) and read w by broadcast through L1/L2.
#pragma once

#include <type_traits>

#include "gf_common.cuh"

namespace gf {

struct LayerArgs {
  const float* x;     // (B, D): density input, or the solve target
  float* out;         // (B, D): value, or the root
  float* ld;          // (B, D): log-derivative (null for the solve alone)
  const float* p[4];  // slabs in group order
  const float* hidden;  // lazy: (B, H)
  const float* w;       // lazy: (n_groups * K * D, H)
  const float* b;       // lazy: (n_groups * K * D,)
  int B, K, D, H, prepared, per_row, fit_norm, n_pos, ift, n_groups;
  Reg wreg, nreg, ereg;
};

// floats of shared memory a broadcast call prepares (10 arrays of K*D)
constexpr int BCAST_ARRAYS = 10;

template <bool SKEW, int N>
using MixT = typename std::conditional<SKEW, SkewMix<N>, Mix<N>>::type;

// Prepare a mixture from loaded values: raw (regulators, log-softmax and,
// when skewed, the exponents) or prepared (weights from the log weights).
template <bool SKEW, int N, int KT>
__device__ __forceinline__ void prep_layer_mix(MixT<SKEW, N>& mx, const float* lw,
                                               const float* ln, const float* se,
                                               const LayerArgs& a) {
  const int kk = KT > 0 ? KT : a.K;
  if (a.prepared) {
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      mx.iw[k] = lw[k];
      mx.lnw[k] = ln[k];
      mx.nw[k] = expf(ln[k]);
    }
    return;
  }
  prep_mix<N, KT>(mx, lw, ln, a.K, a.fit_norm, a.wreg, a.nreg);
  if constexpr (SKEW) prep_skew<N, KT>(mx, se, a.K, a.ereg);
}

template <bool LAZY, bool SKEW, int N, int KT>
struct LayerSrc {
  float* sm;   // broadcast: the prepared arrays; lazy: the hidden tile
  int hs;      // lazy: stride of a hidden row in shared memory
  int col;     // lazy: this thread's column

  // Stage the block's shared memory.  row0: the block's first row.  Every
  // thread of the block calls it (it synchronizes).
  __device__ LayerSrc(const LayerArgs& a, float* smem, int row0)
      : sm(smem), hs(blockDim.x + 1), col(threadIdx.x) {
    const int T = blockDim.x, tid = threadIdx.x;
    if constexpr (LAZY) {
      load_tile(a, row0);
    } else {
      if (!a.per_row) {
        const int kd = a.K * a.D;
        for (int dd = tid; dd < a.D; dd += T) {
          MixT<SKEW, N> mx;
          float lw[N], ln[N], se[N];
          read_global(a, 0, dd, mx, lw, ln, se);
          prep_layer_mix<SKEW, N, KT>(mx, lw, ln, se, a);
          const int kk = KT > 0 ? KT : a.K;
          for (int k = 0; k < kk; ++k) {
            const int j = k * a.D + dd;
            sm[j] = mx.m[k];
            sm[kd + j] = mx.iw[k];
            sm[2 * kd + j] = mx.lnw[k];
            sm[3 * kd + j] = mx.nw[k];
            sm[7 * kd + j] = lw[k];
            sm[8 * kd + j] = ln[k];
            if constexpr (SKEW) {
              sm[4 * kd + j] = mx.liw[k];
              sm[5 * kd + j] = mx.ls[k];
              sm[6 * kd + j] = mx.a[k];
              sm[9 * kd + j] = se[k];
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // lazy: this tile's hidden rows, coalesced, into columns (rows past B: 0)
  __device__ void load_tile(const LayerArgs& a, int row0) {
    const int T = blockDim.x, tid = threadIdx.x;
    __syncthreads();  // the previous tile's readers are done
    const int n = T * a.H;
    for (int i = tid; i < n; i += T) {
      const int r = i / a.H, h = i - r * a.H;
      sm[h * hs + r] =
          row0 + r < a.B ? __ldg(a.hidden + (size_t)row0 * a.H + i) : 0.0f;
    }
    __syncthreads();
  }

  // A slab's values of row `row`, dimension dd (broadcast: row ignored).
  __device__ void read_global(const LayerArgs& a, int row, int dd,
                              MixT<SKEW, N>& mx, float* lw, float* ln,
                              float* se) const {
    const int kk = KT > 0 ? KT : a.K;
    const size_t stride = a.per_row ? (size_t)a.B : 1;
    const size_t off = a.per_row ? (size_t)row : 0;
    const float* ln_p = a.prepared ? a.p[2] : (a.fit_norm ? a.p[2] : nullptr);
    const float* se_p = SKEW ? a.p[2 + a.fit_norm] : nullptr;
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      const size_t j = (size_t)(k * a.D + dd) * stride + off;
      mx.m[k] = __ldg(a.p[0] + j);
      lw[k] = __ldg(a.p[1] + j);
      ln[k] = ln_p ? __ldg(ln_p + j) : 0.0f;
      se[k] = SKEW ? __ldg(se_p + j) : 0.0f;
    }
  }

  // The mixture of dimension dd of row `row`, and the raw values it was
  // prepared from (raw interface: lw, ln, se; the backward needs them).
  __device__ void load(const LayerArgs& a, int row, int dd, MixT<SKEW, N>& mx,
                       float* lw, float* ln, float* se) const {
    const int kk = KT > 0 ? KT : a.K;
    if constexpr (LAZY) {
      const int kd = a.K * a.D;
#pragma unroll
      for (int k = 0; k < kk; ++k) mx.m[k] = lw[k] = ln[k] = se[k] = 0.0f;
      const int g_se = 2 + a.fit_norm;
      for (int h = 0; h < a.H; ++h) {
        const float hv = sm[h * hs + col];
        const float* wh = a.w + h;
#pragma unroll
        for (int k = 0; k < kk; ++k) {
          const int r = k * a.D + dd;
          mx.m[k] += __ldg(wh + (size_t)r * a.H) * hv;
          lw[k] += __ldg(wh + (size_t)(kd + r) * a.H) * hv;
          if (a.fit_norm) ln[k] += __ldg(wh + (size_t)(2 * kd + r) * a.H) * hv;
          if (SKEW) se[k] += __ldg(wh + (size_t)(g_se * kd + r) * a.H) * hv;
        }
      }
#pragma unroll
      for (int k = 0; k < kk; ++k) {
        const int r = k * a.D + dd;
        mx.m[k] += __ldg(a.b + r);
        lw[k] += __ldg(a.b + kd + r);
        if (a.fit_norm) ln[k] += __ldg(a.b + 2 * kd + r);
        if (SKEW) se[k] += __ldg(a.b + g_se * kd + r);
      }
      prep_layer_mix<SKEW, N, KT>(mx, lw, ln, se, a);
    } else if (a.per_row) {
      read_global(a, row, dd, mx, lw, ln, se);
      prep_layer_mix<SKEW, N, KT>(mx, lw, ln, se, a);
    } else {
      const int kd = a.K * a.D;
#pragma unroll
      for (int k = 0; k < kk; ++k) {
        const int j = k * a.D + dd;
        mx.m[k] = sm[j];
        mx.iw[k] = sm[kd + j];
        mx.lnw[k] = sm[2 * kd + j];
        mx.nw[k] = sm[3 * kd + j];
        lw[k] = sm[7 * kd + j];
        ln[k] = sm[8 * kd + j];
        if constexpr (SKEW) {
          mx.liw[k] = sm[4 * kd + j];
          mx.ls[k] = sm[5 * kd + j];
          mx.a[k] = sm[6 * kd + j];
          se[k] = sm[9 * kd + j];
        }
      }
    }
  }
};

// Shared memory floats a call's block needs for its source.
__host__ __device__ inline size_t layer_src_floats(int lazy, const LayerArgs& a,
                                                    int threads) {
  if (lazy) return (size_t)a.H * (threads + 1);
  return a.per_row ? 0 : (size_t)BCAST_ARRAYS * a.K * a.D;
}

}  // namespace gf
