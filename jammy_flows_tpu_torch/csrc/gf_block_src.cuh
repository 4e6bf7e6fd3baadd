// Parameter sources of the whole-block kernels, shared by the forward
// (gf_block.cu) and the backward (gf_block_bwd.cu), so that the backward's
// recomputation of the forward runs the forward's own code:
//   * perm: the block stages the (P,) vector in shared memory and prepares
//     it once (regulators, log-softmax of the weights, unit householder
//     vectors); every thread then reads it as a broadcast;
//   * lazy2: each thread writes its row's hidden tanh(w1 s + b1) into a
//     column of shared memory (H rows of `stride` floats), then produces
//     each parameter row b_j + w_j . hidden when it needs it, one layer and
//     dimension at a time (3K rows per mixture), reading w by broadcast
//     through L1/L2;
//   * lazy (precomputed hidden): each thread copies its row of the (B, H)
//     hidden activations, made outside by the MLP, into its column; the
//     parameter rows are then made exactly as in lazy2 (the same code).
#pragma once

#include <type_traits>

#include "gf_common.cuh"

namespace gf {

// parameter modes (the C interfaces' `mode` argument)
constexpr int PERM = 0;   // one broadcast (P,) vector
constexpr int LAZY2 = 1;  // the fused one-hidden-layer tanh MLP
constexpr int LAZYH = 2;  // precomputed hidden (B, H) and the final w, b

struct LayerMeta {
  int has_off, rot_it, has_ln, ift, row0;
};

struct BlockArgs {
  const float* x;
  float* out;
  float* ld;
  int B;
  const float* pvec;     // perm: (P,)
  const float* summary;  // lazy2: (B, n_in)
  const float* w1;       // (H, n_in)
  const float* b1;       // (H,)
  const float* w;        // (P, H)
  const float* b;        // (P,)
  const float* hidden;   // lazy: (B, H)
  int n_in, H, P, K, D, n_layers, fit_norm;
  Reg wreg, nreg;
  LayerMeta layers[MAX_LAYERS];
};

// rows of layer l's mixture groups
__device__ __forceinline__ void mix_rows(const LayerMeta& lm, int K, int D,
                                         int& m0, int& lw0, int& ln0) {
  m0 = lm.row0 + (lm.has_off ? D : 0) + lm.rot_it * D;
  lw0 = m0 + K * D;
  ln0 = lw0 + K * D;
}

// ---- permanent parameters: prepared once per block in shared memory ------
template <int N, int KT, int DN>
struct PermSrc {
  const float* A;    // raw rows; householder rows hold unit vectors
  const float* IW;   // at the log-width rows: inverse widths
  const float* LNW;  // at the log-width rows: log weights
  const float* NW;   // at the log-width rows: weights
  const float* raw;  // the (P,) vector in global memory

  __device__ PermSrc(const BlockArgs& a, float* smem) : raw(a.pvec) {
    float* sA = smem;
    float* sIW = sA + a.P;
    float* sLNW = sIW + a.P;
    float* sNW = sLNW + a.P;
    const int K = KT > 0 ? KT : a.K;
    for (int j = threadIdx.x; j < a.P; j += blockDim.x) sA[j] = a.pvec[j];
    __syncthreads();
    int n_rot = 0;
    for (int l = 0; l < a.n_layers; ++l) n_rot += a.layers[l].rot_it;
    const int n_mix = a.n_layers * a.D;
    for (int task = threadIdx.x; task < n_mix + n_rot; task += blockDim.x) {
      if (task < n_mix) {
        const LayerMeta& lm = a.layers[task / a.D];
        const int dd = task % a.D;
        int m0, lw0, ln0;
        mix_rows(lm, K, a.D, m0, lw0, ln0);
        float lw[N], ln[N];
        for (int k = 0; k < K; ++k) {
          lw[k] = sA[lw0 + k * a.D + dd];
          ln[k] = lm.has_ln ? sA[ln0 + k * a.D + dd] : 0.0f;
        }
        Mix<N> mx;
        prep_mix<N, KT>(mx, lw, ln, K, lm.has_ln && a.fit_norm, a.wreg, a.nreg);
        for (int k = 0; k < K; ++k) {
          const int j = lw0 + k * a.D + dd;
          sIW[j] = mx.iw[k];
          sLNW[j] = mx.lnw[k];
          sNW[j] = mx.nw[k];
        }
      } else {
        int t = task - n_mix, l = 0;
        while (t >= a.layers[l].rot_it) t -= a.layers[l++].rot_it;
        const LayerMeta& lm = a.layers[l];
        float* v = sA + lm.row0 + (lm.has_off ? a.D : 0) + t * a.D;
        float ss = 0.0f;
        for (int j = 0; j < a.D; ++j) ss += v[j] * v[j];
        const float nrm = sqrtf(ss + 1e-20f);
        for (int j = 0; j < a.D; ++j) v[j] = v[j] / nrm;
      }
    }
    __syncthreads();
    A = sA;
    IW = sIW;
    LNW = sLNW;
    NW = sNW;
  }

  __device__ float param(int j) const { return A[j]; }

  __device__ void unit_vec(int r0, int D, float* v) const {
    for (int j = 0; j < D; ++j) v[j] = A[r0 + j];
  }

  // the unit vector and the norm of its raw row
  __device__ void unit_vec(int r0, int D, float* v, float& nrm) const {
    float ss = 0.0f;
    for (int j = 0; j < D; ++j) {
      const float u = __ldg(raw + r0 + j);
      ss += u * u;
    }
    nrm = sqrtf(ss + 1e-20f);
    unit_vec(r0, D, v);
  }

  // the prepared mixture and its raw log-width / log-norm rows
  __device__ void load_mix_raw(Mix<N>& mx, float* lw, float* ln,
                               const LayerMeta& lm, int K, int D, int dd,
                               const BlockArgs&) const {
    int m0, lw0, ln0;
    mix_rows(lm, K, D, m0, lw0, ln0);
    const int kk = KT > 0 ? KT : K;
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      mx.m[k] = A[m0 + k * D + dd];
      const int j = lw0 + k * D + dd;
      mx.iw[k] = IW[j];
      mx.lnw[k] = LNW[j];
      mx.nw[k] = NW[j];
      lw[k] = A[j];
      ln[k] = lm.has_ln ? A[ln0 + k * D + dd] : 0.0f;
    }
  }

  __device__ void load_mix(Mix<N>& mx, const LayerMeta& lm, int K, int D,
                           int dd, const BlockArgs& a) const {
    float lw[N], ln[N];
    load_mix_raw(mx, lw, ln, lm, K, D, dd, a);
  }
};

// ---- amortized: hidden in shared memory, parameter rows on demand ---------
// FUSED: the hidden column made from the summary (lazy2); else copied from
// the precomputed (B, H) hidden (lazy).  Rows past B keep an unwritten
// column; their threads produce nothing.
template <int N, int KT, int DN, bool FUSED>
struct LazySrc {
  const float* hid;  // this thread's column: hid[h * stride]
  int stride, H;
  const float* w;
  const float* b;

  __device__ LazySrc(const BlockArgs& a, float* smem, int row, int stride_)
      : hid(smem + threadIdx.x), stride(stride_), H(a.H), w(a.w), b(a.b) {
    if (row >= a.B) return;
    float* col = smem + threadIdx.x;
    if constexpr (FUSED) {
      for (int h = 0; h < a.H; ++h) col[h * stride] = 0.0f;
      const float* s = a.summary + (size_t)row * a.n_in;
      for (int i = 0; i < a.n_in; ++i) {
        const float si = s[i];
        for (int h = 0; h < a.H; ++h) col[h * stride] += a.w1[h * a.n_in + i] * si;
      }
      for (int h = 0; h < a.H; ++h) col[h * stride] = tanhf(col[h * stride] + a.b1[h]);
    } else {
      const float* hr = a.hidden + (size_t)row * a.H;
      for (int h = 0; h < a.H; ++h) col[h * stride] = __ldg(hr + h);
    }
  }

  __device__ float param(int j) const {
    const float* wj = w + (size_t)j * H;
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += __ldg(wj + h) * hid[h * stride];
    return acc + __ldg(b + j);
  }

  __device__ void unit_vec(int r0, int D, float* v, float& nrm) const {
    float ss = 0.0f;
    for (int j = 0; j < D; ++j) {
      v[j] = param(r0 + j);
      ss += v[j] * v[j];
    }
    nrm = sqrtf(ss + 1e-20f);
    for (int j = 0; j < D; ++j) v[j] = v[j] / nrm;
  }

  __device__ void unit_vec(int r0, int D, float* v) const {
    float nrm;
    unit_vec(r0, D, v, nrm);
  }

  __device__ void load_mix_raw(Mix<N>& mx, float* lw, float* ln,
                               const LayerMeta& lm, int K, int D, int dd,
                               const BlockArgs& a) const {
    int m0, lw0, ln0;
    mix_rows(lm, K, D, m0, lw0, ln0);
    const int kk = KT > 0 ? KT : K;
#pragma unroll
    for (int k = 0; k < kk; ++k) mx.m[k] = lw[k] = ln[k] = 0.0f;
    // one pass over the hidden units for all 3K rows of this dimension
    for (int h = 0; h < H; ++h) {
      const float hv = hid[h * stride];
      const float* wh = w + h;
#pragma unroll
      for (int k = 0; k < kk; ++k) {
        const int r = k * D + dd;
        mx.m[k] += __ldg(wh + (size_t)(m0 + r) * H) * hv;
        lw[k] += __ldg(wh + (size_t)(lw0 + r) * H) * hv;
        if (lm.has_ln) ln[k] += __ldg(wh + (size_t)(ln0 + r) * H) * hv;
      }
    }
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      const int r = k * D + dd;
      mx.m[k] += __ldg(b + m0 + r);
      lw[k] += __ldg(b + lw0 + r);
      if (lm.has_ln) ln[k] += __ldg(b + ln0 + r);
    }
    prep_mix<N, KT>(mx, lw, ln, K, lm.has_ln && a.fit_norm, a.wreg, a.nreg);
  }

  __device__ void load_mix(Mix<N>& mx, const LayerMeta& lm, int K, int D,
                           int dd, const BlockArgs& a) const {
    float lw[N], ln[N];
    load_mix_raw(mx, lw, ln, lm, K, D, dd, a);
  }
};

template <int DN, class Src>
__device__ __forceinline__ void reflect(const Src& src, int r0, float* x, int D) {
  float v[DN];
  src.unit_vec(r0, D, v);
  float dot = v[0] * x[0];
  for (int j = 1; j < D; ++j) dot += v[j] * x[j];
  for (int j = 0; j < D; ++j) x[j] = x[j] - (2.0f * v[j]) * dot;
}

template <int MODE, int N, int KT, int DN>
using SrcT = typename std::conditional<MODE == PERM, PermSrc<N, KT, DN>,
                                       LazySrc<N, KT, DN, MODE == LAZY2>>::type;

// the forward kernels' source: hidden columns at stride blockDim.x
template <int MODE, int KT, int DT>
__device__ __forceinline__ SrcT<MODE, (KT > 0 ? KT : KMAX), KT,
                                (DT > 0 ? DT : DMAX)>
make_src(const BlockArgs& a, float* smem, int row) {
  if constexpr (MODE == PERM)
    return SrcT<MODE, (KT > 0 ? KT : KMAX), KT, (DT > 0 ? DT : DMAX)>(a, smem);
  else
    return SrcT<MODE, (KT > 0 ? KT : KMAX), KT, (DT > 0 ? DT : DMAX)>(
        a, smem, row, blockDim.x);
}

}  // namespace gf
