// Parameter sources of the whole-block kernels, shared by the forward
// (gf_block.cu) and the backward (gf_block_bwd.cu), so that the backward's
// recomputation of the forward runs the forward's own code:
//   * perm: the block stages the (P,) vector in shared memory and prepares
//     it once (regulators, log-softmax of the weights, unit householder
//     vectors); every thread then reads it as a broadcast;
//   * lazy2 and lazy (TileSrc): the block keeps its rows' hidden
//     activations as a tile in shared memory: lazy2 makes them itself, each
//     thread its row's tanh(w1 s + b1); lazy copies the (B, H) rows the MLP
//     made outside.  The block then makes the parameter rows of one piece
//     at a time for all its rows at once, as a tile product hidden (T x H)
//     . W_piece^T (H x n) + b on the tensor cores in 3xTF32
//     (tile_rows.cuh), into a shared slab that each row's thread reads.  A
//     piece is a layer's offset and reflection rows (slab `sa`, kept
//     through the layer) or one dimension's 3K mixture rows (slab `sm`).
// The stage hooks (stage_rot, stage_mix) are block-synchronous in the tile
// modes and empty in perm: every thread of a block calls them, rows past B
// included.
#pragma once

#include "gf_common.cuh"
#include "tile_rows.cuh"

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
  TileShape tile;        // lazy2, lazy
};

// The meta ints of the C interfaces into a: K, D, the layers and their
// parameter rows (meta: [K, D, n_layers, fit_norm, wreg kind, nreg kind,
// then per layer: has_off, rot_it, has_ln, ift]).  0, or
// cudaErrorInvalidValue when the block is not one the kernels take or its
// rows do not add up to P.
inline int parse_meta(BlockArgs& a, int mode, const int* meta, int P) {
  a.K = meta[0];
  a.D = meta[1];
  a.n_layers = meta[2];
  a.fit_norm = meta[3];
  if (mode < PERM || mode > LAZYH || a.K < 1 || a.K > KMAX || a.D < 1 ||
      a.D > DMAX || a.n_layers < 1 || a.n_layers > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  int row = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int* m = meta + 6 + 4 * l;
    a.layers[l] = LayerMeta{m[0], m[1], m[2], m[3], row};
    if (m[3] < 0 || m[3] > 3 || m[1] < 0) return (int)cudaErrorInvalidValue;
    row += (m[0] ? a.D : 0) + m[1] * a.D + (2 + m[2]) * a.K * a.D;
  }
  return row == P ? 0 : (int)cudaErrorInvalidValue;
}

// The tile of a call: the largest T of 128, 64, 32 rows whose shared
// memory fits; T = 0 when none does.  Slab widths are the layers' widest
// pieces, rounded up to ra rows (sa) and rm rows (sm).
inline TileShape piece_tile(const BlockArgs& a, int ra, int rm) {
  int na = 0, nm = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const LayerMeta& lm = a.layers[l];
    const int n_a = (lm.has_off ? a.D : 0) + lm.rot_it * a.D;
    const int n_m = (2 + lm.has_ln) * a.K;
    na = n_a > na ? n_a : na;
    nm = n_m > nm ? n_m : nm;
  }
  TileShape t{};
  for (int T = 128; T >= 32; T /= 2) {
    t = TileShape{T, (a.H + 7) / 8 * 8, T + 8, T + 4, (na + ra - 1) / ra * ra,
                  (nm + rm - 1) / rm * rm};
    if (t.floats() * 4 <= TILE_SMEM_LIMIT) return t;
  }
  t.T = 0;
  return t;
}

// lazy2's tile: the slabs rounded up to the 32 columns of a chunk
inline TileShape lazy2_tile(const BlockArgs& a) { return piece_tile(a, 32, 32); }

// The lazy mode's tile: each slab holds its widest piece's rows rounded up
// to 8 (rows_product writes up to the next multiple of 8), sm to 16 (the
// backward's gw_product reads a piece's rows in m16 tiles; what it reads
// past sa's end lies in sm).  Below lazy2's 32 rows, so that at the
// "64-64" flagship's H = 64 three blocks (12 warps) share an SM where
// lazy2's rounding keeps two.
inline TileShape lazy_tile(const BlockArgs& a) {
  return piece_tile(a, 8, 16);
}

// rows of layer l's mixture groups
__device__ __forceinline__ void mix_rows(const LayerMeta& lm, int K, int D,
                                         int& m0, int& lw0, int& ln0) {
  m0 = lm.row0 + (lm.has_off ? D : 0) + lm.rot_it * D;
  lw0 = m0 + K * D;
  ln0 = lw0 + K * D;
}

// ---- permanent parameters: prepared once per block in shared memory ------
// The forward (BWD = false) also prepares each component's row-independent
// mixture terms, lnw + log(iw) and nw * iw (MixF, load_mixf): 6P floats of
// shared memory.  BWD (the backward kernels): instead each component's
// regulator derivatives and log inverse width, parameter-only terms of the
// adjoint (mix_adjoint's fw, fn, fl), which in perm mode are the block's,
// not the row's: 7P floats.
template <int N, int KT, int DN, bool BWD = false>
struct PermSrc {
  static constexpr int FLOATS_PER_ROW = BWD ? 7 : 6;  // x P
  const float* A;    // raw rows; householder rows hold unit vectors
  const float* IW;   // at the log-width rows: inverse widths
  const float* LNW;  // at the log-width rows: log weights
  const float* NW;   // at the log-width rows: weights
  const float* FW;   // BWD, at the log-width rows: iw * d reg_w / d lw;
                     // forward: lnw + log(iw)
  const float* FN;   // BWD, at the log-width rows: d reg_n / d ln (or 0);
                     // forward: nw * iw
  const float* FL;   // BWD, at the log-width rows: log(iw)
  const float* raw;  // the (P,) vector in global memory

  __device__ PermSrc(const BlockArgs& a, float* smem) : raw(a.pvec) {
    float* sA = smem;
    float* sIW = sA + a.P;
    float* sLNW = sIW + a.P;
    float* sNW = sLNW + a.P;
    float* sFW = sNW + a.P;
    float* sFN = sFW + a.P;
    float* sFL = sFN + a.P;
    const int K = KT > 0 ? KT : a.K;
    for (int j = threadIdx.x; j < a.P; j += blockDim.x) sA[j] = a.pvec[j];
    __syncthreads();
    if constexpr (BWD)
      prepare_bwd(a, K, sA, sIW, sLNW, sNW, sFW, sFN, sFL);
    else
      prepare_fwd(a, K, sA, sIW, sLNW, sNW, sFW, sFN);
    A = sA;
    IW = sIW;
    LNW = sLNW;
    NW = sNW;
    FW = sFW;
    FN = sFN;
    FL = sFL;
  }

  // task t of the householder rows: normalize that row of sA in place
  __device__ static void unit_row(const BlockArgs& a, float* sA, int t) {
    int l = 0;
    while (t >= a.layers[l].rot_it) t -= a.layers[l++].rot_it;
    const LayerMeta& lm = a.layers[l];
    float* v = sA + lm.row0 + (lm.has_off ? a.D : 0) + t * a.D;
    float ss = 0.0f;
    for (int j = 0; j < a.D; ++j) ss += v[j] * v[j];
    const float nrm = sqrtf(ss + 1e-20f);
    for (int j = 0; j < a.D; ++j) v[j] = v[j] / nrm;
  }

  __device__ static int n_rot(const BlockArgs& a) {
    int n = 0;
    for (int l = 0; l < a.n_layers; ++l) n += a.layers[l].rot_it;
    return n;
  }

  // The backward's preparation: one mixture a thread (prep_mix) and its
  // adjoint's parameter-only terms.
  __device__ static void prepare_bwd(const BlockArgs& a, int K, float* sA,
                                     float* sIW, float* sLNW, float* sNW,
                                     float* sFW, float* sFN, float* sFL) {
    const int n_mix = a.n_layers * a.D;
    for (int task = threadIdx.x; task < n_mix + n_rot(a);
         task += blockDim.x) {
      if (task >= n_mix) {
        unit_row(a, sA, task - n_mix);
        continue;
      }
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
      const bool fit = lm.has_ln && a.fit_norm;
      prep_mix<N, KT>(mx, lw, ln, K, fit, a.wreg, a.nreg);
      for (int k = 0; k < K; ++k) {
        const int j = lw0 + k * a.D + dd;
        sIW[j] = mx.iw[k];
        sLNW[j] = mx.lnw[k];
        sNW[j] = mx.nw[k];
        sFW[j] = mx.iw[k] * reg_deriv(a.wreg, lw[k]);
        sFN[j] = fit ? reg_deriv(a.nreg, ln[k]) : 0.0f;
        sFL[j] = logf(mx.iw[k]);
      }
    }
    __syncthreads();
  }

  // The forward's preparation in three block-wide phases, one component a
  // thread where prep_mix takes one mixture a thread (the same expressions
  // in the same order, so the same bits as prep_mix and mix_lp /
  // mix_nwiw; a set-up about K times shorter): 1) each component's inverse
  // width and norm regulator value (into LNW), and the householder rows;
  // 2) each mixture's log-softmax: the log weights; 3) each component's
  // weight, lnw + log(iw) and nw * iw.
  __device__ static void prepare_fwd(const BlockArgs& a, int K, float* sA,
                                     float* sIW, float* sLNW, float* sNW,
                                     float* sLP, float* sNWIW) {
    const int n_mix = a.n_layers * a.D, n_comp = n_mix * K;
    // the log-width row of component k of mixture i, and its log-norm row
    auto rows = [&](int i, int k, int& j, int& jn, bool& fit) {
      const LayerMeta& lm = a.layers[i / a.D];
      int m0, lw0, ln0;
      mix_rows(lm, K, a.D, m0, lw0, ln0);
      j = lw0 + k * a.D + i % a.D;
      jn = ln0 + k * a.D + i % a.D;
      fit = lm.has_ln && a.fit_norm;
    };
    for (int task = threadIdx.x; task < n_comp + n_rot(a);
         task += blockDim.x) {
      if (task >= n_comp) {
        unit_row(a, sA, task - n_comp);
        continue;
      }
      int j, jn;
      bool fit;
      rows(task / K, task % K, j, jn, fit);
      sIW[j] = expf(-apply_reg(a.wreg, sA[j]));
      if (fit) sLNW[j] = apply_reg(a.nreg, sA[jn]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_mix; i += blockDim.x) {
      int j, jn;
      bool fit;
      rows(i, 0, j, jn, fit);
      if (fit) {
        float mmax = -INFINITY;
        for (int k = 0; k < K; ++k) mmax = fmaxf(mmax, sLNW[j + k * a.D]);
        float s = 0.0f;
        for (int k = 0; k < K; ++k) s += expf(sLNW[j + k * a.D] - mmax);
        const float lse = mmax + logf(s);
        for (int k = 0; k < K; ++k)
          sLNW[j + k * a.D] = sLNW[j + k * a.D] - lse;
      } else {
        const float c = (float)(-log((double)K));
        for (int k = 0; k < K; ++k) sLNW[j + k * a.D] = c;
      }
    }
    __syncthreads();
    for (int task = threadIdx.x; task < n_comp; task += blockDim.x) {
      int j, jn;
      bool fit;
      rows(task / K, task % K, j, jn, fit);
      Mix<1> mx;
      mx.iw[0] = sIW[j];
      mx.lnw[0] = sLNW[j];
      mx.nw[0] = expf(mx.lnw[0]);
      sNW[j] = mx.nw[0];
      sLP[j] = mix_lp(mx, 0);
      sNWIW[j] = mix_nwiw(mx, 0);
    }
    __syncthreads();
  }

  // no stage: the parameters are at hand
  __device__ void stage_rot(const BlockArgs&, const LayerMeta&) const {}
  __device__ void stage_mix(const BlockArgs&, const LayerMeta&, int) const {}

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

  // forward: the prepared mixture with its row-independent terms
  __device__ void load_mixf(MixF<N>& mx, const LayerMeta& lm, int K, int D,
                            int dd) const {
    static_assert(!BWD, "the backward's PermSrc holds no lp / nwiw");
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
      mx.lp[k] = FW[j];
      mx.nwiw[k] = FN[j];
    }
  }

  // BWD: the mixture's parameter-only adjoint terms (mix_adjoint's fw,
  // fn, fl)
  __device__ void load_mix_fac(float* fw, float* fn, float* fl,
                               const LayerMeta& lm, int K, int D,
                               int dd) const {
    int m0, lw0, ln0;
    mix_rows(lm, K, D, m0, lw0, ln0);
    const int kk = KT > 0 ? KT : K;
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      fw[k] = FW[lw0 + k * D + dd];
      fn[k] = FN[lw0 + k * D + dd];
      fl[k] = FL[lw0 + k * D + dd];
    }
  }
};

// ---- the hidden column of one row (lazy2) ---------------------------------
// tanh(w1 s + b1) from the row's summary
__device__ __forceinline__ void hidden_column(const BlockArgs& a, float* col,
                                              int stride, int row) {
  for (int h = 0; h < a.H; ++h) col[h * stride] = 0.0f;
  const float* s = a.summary + (size_t)row * a.n_in;
  for (int i = 0; i < a.n_in; ++i) {
    const float si = s[i];
    for (int h = 0; h < a.H; ++h) col[h * stride] += a.w1[h * a.n_in + i] * si;
  }
  // a NaN kept through the tile products' TF32 split
  for (int h = 0; h < a.H; ++h)
    col[h * stride] = keep_nan(tanhf(col[h * stride] + a.b1[h]));
}

// ---- lazy2 and lazy: parameter rows by tile on the tensor cores -----------

// rows of one mixture group: [means | raw log-widths | raw log-norms]
struct MixRows {
  int m0, lw0, ln0, K, D, dd;
  __device__ int operator()(int j) const {
    const int g = j / K, k = j - g * K;
    return (g == 0 ? m0 : (g == 1 ? lw0 : ln0)) + k * D + dd;
  }
};

// a contiguous span of rows (an offset and the reflections that follow it)
struct SpanRows {
  int r0;
  __device__ int operator()(int j) const { return r0 + j; }
};

// The hidden tile: lazy2 (FUSED) has each thread make its row's hidden
// column (zeros for a row past B and for the padding to Hp); lazy copies
// the block's rows of the precomputed (B, H) activations, coalesced
// (load_hidden_tile, block-synchronous).  The block then makes each
// piece's parameter rows by rows_product when the body asks for them
// (stage_rot, stage_mix) and each thread reads its row of the slab.  The
// backward writes a piece's cotangents over its own rows of the slab
// (a_col, put_mix) for the tile products of gf_block_bwd.cu.
template <int N, int KT, int DN, bool FUSED>
struct TileSrc {
  Tile tl;
  const float* w;
  const float* b;
  int t;            // this thread's row of the tile
  mutable int r_a;  // parameter row of sa's column 0 (the staged layer's)

  __device__ TileSrc(const BlockArgs& a, float* smem, int row)
      : tl(a.H, a.tile, a.w, smem), w(a.w), b(a.b), t(threadIdx.x),
        r_a(0) {
    if constexpr (FUSED) {
      float* col = tl.hid + t;
      if (row < a.B)
        hidden_column(a, col, tl.hs, row);
      else
        for (int h = 0; h < a.H; ++h) col[h * tl.hs] = 0.0f;
      for (int h = a.H; h < tl.Hp; ++h) col[h * tl.hs] = 0.0f;
    } else {
      load_hidden_tile(tl, a.hidden, row - t, a.B, a.H);
    }
  }

  __device__ void stage_rot(const BlockArgs& a, const LayerMeta& lm) const {
    r_a = lm.row0;
    rows_product(tl, tl.sa, w, b, SpanRows{lm.row0},
                 (lm.has_off ? a.D : 0) + lm.rot_it * a.D);
  }

  __device__ void stage_mix(const BlockArgs& a, const LayerMeta& lm,
                            int dd) const {
    const int K = KT > 0 ? KT : a.K;
    int m0, lw0, ln0;
    mix_rows(lm, K, a.D, m0, lw0, ln0);
    rows_product(tl, tl.sm, w, b, MixRows{m0, lw0, ln0, K, a.D, dd},
                 (2 + lm.has_ln) * K);
  }

  // this thread's entry of parameter row j of the staged offset/reflections
  __device__ float* a_col(int j) const { return tl.sa + (j - r_a) * tl.ts + t; }

  __device__ float param(int j) const { return *a_col(j); }

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
    const int kk = KT > 0 ? KT : K;
    const float* s = tl.sm + t;
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      mx.m[k] = s[k * tl.ts];
      lw[k] = s[(K + k) * tl.ts];
      ln[k] = lm.has_ln ? s[(2 * K + k) * tl.ts] : 0.0f;
    }
    prep_mix<N, KT>(mx, lw, ln, K, lm.has_ln && a.fit_norm, a.wreg, a.nreg);
  }

  __device__ void load_mix(Mix<N>& mx, const LayerMeta& lm, int K, int D,
                           int dd, const BlockArgs& a) const {
    float lw[N], ln[N];
    load_mix_raw(mx, lw, ln, lm, K, D, dd, a);
  }

  // the staged dimension's cotangents, over this thread's row of sm (a
  // NaN kept through the TF32 split)
  __device__ void put_mix(const float* vals, int n) const {
    for (int j = 0; j < n; ++j) tl.sm[j * tl.ts + t] = keep_nan(vals[j]);
  }
};

// x <- (I - 2 v v^T) x for a unit vector v
__device__ __forceinline__ void householder(const float* v, float* x, int D) {
  float dot = v[0] * x[0];
  for (int j = 1; j < D; ++j) dot += v[j] * x[j];
  for (int j = 0; j < D; ++j) x[j] = x[j] - (2.0f * v[j]) * dot;
}

template <int DN, class Src>
__device__ __forceinline__ void reflect(const Src& src, int r0, float* x, int D) {
  float v[DN];
  src.unit_vec(r0, D, v);
  householder(v, x, D);
}

template <int MODE, int N, int KT, int DN>
using SrcT = TileSrc<N, KT, DN, MODE == LAZY2>;

// the lazy2 / lazy forward kernels' source; the perm forward (gf_block.cu)
// builds its PermSrc itself
template <int MODE, int KT, int DT>
__device__ __forceinline__ SrcT<MODE, (KT > 0 ? KT : KMAX), KT,
                                (DT > 0 ? DT : DMAX)>
make_src(const BlockArgs& a, float* smem, int row) {
  static_assert(MODE == LAZY2 || MODE == LAZYH, "lazy2 or lazy");
  using S = SrcT<MODE, (KT > 0 ? KT : KMAX), KT, (DT > 0 ? DT : DMAX)>;
  return S(a, smem, row);
}

}  // namespace gf
