// Parameter sources of the whole-block kernels, shared by the forward
// (gf_block.cu) and the backward (gf_block_bwd.cu), so that the backward's
// recomputation of the forward runs the forward's own code:
//   * perm: the block stages the (P,) vector in shared memory and prepares
//     it once (regulators, log-softmax of the weights, unit householder
//     vectors); every thread then reads it as a broadcast;
//   * lazy2 (TileSrc): each thread writes its row's hidden tanh(w1 s + b1)
//     into a column of shared memory; the block then makes the parameter
//     rows of one piece at a time for all its rows at once, as a tile
//     product hidden (T x H) . W_piece^T (H x n) + b on the tensor cores in
//     3xTF32 (mma_tf32.cuh), into a shared slab that each row's thread
//     reads.  A piece is a layer's offset and reflection rows (slab `sa`,
//     kept through the layer) or one dimension's 3K mixture rows (slab
//     `sm`);
//   * lazy (precomputed hidden, LazySrc): each thread copies its row of the
//     (B, H) hidden activations, made outside by the MLP, into its column
//     and produces each parameter row b_j + w_j . hidden when it needs it,
//     one layer and dimension at a time, reading w through L1/L2.
// The stage hooks (stage_rot, stage_mix) are block-synchronous in lazy2 and
// empty in the other sources: every thread of a block calls them, rows past
// B included.
#pragma once

#include <type_traits>

#include "gf_common.cuh"
#include "mma_tf32.cuh"

namespace gf {

// parameter modes (the C interfaces' `mode` argument)
constexpr int PERM = 0;   // one broadcast (P,) vector
constexpr int LAZY2 = 1;  // the fused one-hidden-layer tanh MLP
constexpr int LAZYH = 2;  // precomputed hidden (B, H) and the final w, b

struct LayerMeta {
  int has_off, rot_it, has_ln, ift, row0;
};

// ---- the lazy2 tile: rows per block and shared-memory layout --------------
constexpr int TILE_KC = 32;            // a W chunk: 32 hidden columns (or
constexpr int TILE_NC = 32;            // k rows) of 32 parameter rows
constexpr int TILE_WS = TILE_KC + 8;   // a chunk row's capacity (floats)
constexpr int TILE_SMEM_LIMIT = 227 * 1024;

// Shared memory of a lazy2 block, in floats:
//   hid (Hp, hs)  hidden[h][t]; hs = T + 8: conflict-free A fragments
//   sa  (na, ts)  the layer's offset and reflection rows, kept through it
//   sm  (nm, ts)  one dimension's mixture rows; ts = T + 4: conflict-free
//                 C stores and per-row reads
//   wc  2 x (32, TILE_WS)  double-buffered W chunks (cp.async)
// Flagship (H = 128, 20 / 30 rows per piece, T = 128): 69,632 + 16,896 +
// 16,896 + 10,240 = 113,664 bytes, two blocks (8 warps) per SM.
struct TileShape {
  int T, Hp, hs, ts, na, nm;
  __host__ __device__ size_t floats() const {
    return (size_t)Hp * hs + (size_t)(na + nm) * ts + 2 * TILE_NC * TILE_WS;
  }
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
  TileShape tile;        // lazy2
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

// The lazy2 tile of a call: the largest T of 128, 64, 32 rows whose shared
// memory fits; T = 0 when none does.  Slab widths are the layers' widest
// pieces, rounded up to the 32 columns of a chunk.
inline TileShape lazy2_tile(const BlockArgs& a) {
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
    t = TileShape{T, (a.H + 7) / 8 * 8, T + 8, T + 4, (na + 31) / 32 * 32,
                  (nm + 31) / 32 * 32};
    if (t.floats() * 4 <= TILE_SMEM_LIMIT) return t;
  }
  t.T = 0;
  return t;
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

// ---- the hidden column of one row -----------------------------------------
// FUSED: tanh(w1 s + b1) from the row's summary (lazy2); else the row of the
// precomputed (B, H) hidden activations (lazy)
template <bool FUSED>
__device__ __forceinline__ void hidden_column(const BlockArgs& a, float* col,
                                              int stride, int row) {
  if constexpr (FUSED) {
    for (int h = 0; h < a.H; ++h) col[h * stride] = 0.0f;
    const float* s = a.summary + (size_t)row * a.n_in;
    for (int i = 0; i < a.n_in; ++i) {
      const float si = s[i];
      for (int h = 0; h < a.H; ++h) col[h * stride] += a.w1[h * a.n_in + i] * si;
    }
    // a NaN kept through the tile products' TF32 split
    for (int h = 0; h < a.H; ++h)
      col[h * stride] = keep_nan(tanhf(col[h * stride] + a.b1[h]));
  } else {
    const float* hr = a.hidden + (size_t)row * a.H;
    for (int h = 0; h < a.H; ++h) col[h * stride] = __ldg(hr + h);
  }
}

// ---- lazy (precomputed hidden): parameter rows on demand, per thread ------
// The hidden column is copied from the (B, H) rows.  Rows past B keep an
// unwritten column; their threads produce nothing.
template <int N, int KT, int DN>
struct LazySrc {
  const float* hid;  // this thread's column: hid[h * stride]
  int stride, H;
  const float* w;
  const float* b;

  __device__ LazySrc(const BlockArgs& a, float* smem, int row, int stride_)
      : hid(smem + threadIdx.x), stride(stride_), H(a.H), w(a.w), b(a.b) {
    if (row < a.B) hidden_column<false>(a, smem + threadIdx.x, stride, row);
  }

  // no stage: the parameters are at hand
  __device__ void stage_rot(const BlockArgs&, const LayerMeta&) const {}
  __device__ void stage_mix(const BlockArgs&, const LayerMeta&, int) const {}

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

// ---- lazy2: parameter rows by tile on the tensor cores --------------------

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

// the shared memory of a lazy2 block (TileShape), chunk buffers first so
// that 16-byte copies land aligned
struct Tile {
  float* wc;   // 2 x (TILE_NC, TILE_WS)
  float* hid;  // (Hp, hs)
  float* sa;   // (na, ts)
  float* sm;   // (nm, ts)
  int H, Hp, hs, ts;
  bool vec;    // w's rows 16-byte aligned: 16-byte copies

  __device__ Tile(const BlockArgs& a, float* smem)
      : wc(smem), hid(smem + 2 * TILE_NC * TILE_WS),
        sa(hid + (size_t)a.tile.Hp * a.tile.hs),
        sm(sa + (size_t)a.tile.na * a.tile.ts), H(a.H), Hp(a.tile.Hp),
        hs(a.tile.hs), ts(a.tile.ts),
        vec(a.H % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0) {}
};

// Start copying w's rows rows(c0 .. c0 + 31) (those below n), columns
// h0 .. h0 + 31 (those below H), into a chunk buffer at row stride ws,
// zeros elsewhere; one cp.async group.
template <class Rows>
__device__ void load_w_chunk(const Tile& tl, float* buf, int ws,
                             const float* w, const Rows& rows, int n, int c0,
                             int h0) {
  if (tl.vec) {
    constexpr int V = TILE_KC / 4;
    for (int i = threadIdx.x; i < TILE_NC * V; i += blockDim.x) {
      const int c = i / V, q = (i - c * V) * 4;
      const bool ok = c0 + c < n && h0 + q < tl.H;
      cp_async16(buf + c * ws + q,
                 ok ? w + (size_t)rows(c0 + c) * tl.H + h0 + q : w,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TILE_NC * TILE_KC; i += blockDim.x) {
      const int c = i / TILE_KC, q = i - c * TILE_KC;
      const bool ok = c0 + c < n && h0 + q < tl.H;
      cp_async4(buf + c * ws + q,
                ok ? w + (size_t)rows(c0 + c) * tl.H + h0 + q : w,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// The row product of one piece: slab[c][t] = b[rows(c)] + sum_h hid[t][h]
// w[rows(c)][h] for the block's rows t and the piece's columns c < n (and
// zeros up to the next multiple of 8), in 3xTF32 on the tensor cores.  Warp
// w makes rows 32w .. 32w + 31 (two m16 tiles), 32 columns (four n8 tiles)
// at a time, the hidden axis in chunks of 32 streamed through the two
// chunk buffers (row stride TILE_KC + 4: conflict-free B fragments).  The
// k order is fixed (hidden units 0..7, 8..15, ...), so a row's parameters
// do not depend on the tile, the piece or the kernel that makes them: the
// forward and the backward make the same bits.  Block-synchronous.
template <class Rows>
__device__ void rows_product(const Tile& tl, float* slab, const float* w,
                             const float* b, const Rows& rows, int n) {
  if (n <= 0) return;
  constexpr int WS = TILE_KC + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int t0 = (threadIdx.x >> 5) * 32;
  const int n_kc = (tl.Hp + TILE_KC - 1) / TILE_KC;
  const int n_steps = (n + TILE_NC - 1) / TILE_NC * n_kc;
  float acc[2][4][4];
  load_w_chunk(tl, tl.wc, WS, w, rows, n, 0, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int nc = s / n_kc, kc = s - nc * n_kc;
    if (s + 1 < n_steps) {
      const int nc1 = (s + 1) / n_kc;
      load_w_chunk(tl, tl.wc + ((s + 1) & 1) * TILE_NC * TILE_WS, WS, w,
                   rows, n, nc1 * TILE_NC, (s + 1 - nc1 * n_kc) * TILE_KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
    const float* wb = tl.wc + (s & 1) * TILE_NC * TILE_WS;
    const int n_tiles = min(4, (n - nc * TILE_NC + 7) / 8);
    const int k_steps = min(TILE_KC, tl.Hp - kc * TILE_KC) / 8;
#pragma unroll
    for (int ks = 0; ks < TILE_KC / 8; ++ks) {
      if (ks < k_steps) {
        const float* hk =
            tl.hid + (size_t)(kc * TILE_KC + ks * 8 + q) * tl.hs + t0 + g;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* h0 = hk + mt * 16;
          split_tf32(h0[0], ahi[mt][0], alo[mt][0]);
          split_tf32(h0[8], ahi[mt][1], alo[mt][1]);
          split_tf32(h0[4 * tl.hs], ahi[mt][2], alo[mt][2]);
          split_tf32(h0[4 * tl.hs + 8], ahi[mt][3], alo[mt][3]);
        }
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < n_tiles) {
            const float* wk = wb + (nt * 8 + g) * WS + ks * 8 + q;
            split_tf32_any(wk[0], bhi[nt][0], blo[nt][0]);
            split_tf32_any(wk[4], bhi[nt][1], blo[nt][1]);
          }
        }
        mma3_tile(acc, ahi, alo, bhi, blo, 2, n_tiles);
      }
    }
    if (kc == n_kc - 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < n_tiles) {
          const int c = nc * TILE_NC + nt * 8 + 2 * q;
          const float b0 = c < n ? __ldg(b + rows(c)) : 0.0f;
          const float b1 = c + 1 < n ? __ldg(b + rows(c + 1)) : 0.0f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float* o = slab + (size_t)c * tl.ts + t0 + mt * 16 + g;
            o[0] = acc[mt][nt][0] + b0;
            o[tl.ts] = acc[mt][nt][1] + b1;
            o[8] = acc[mt][nt][2] + b0;
            o[tl.ts + 8] = acc[mt][nt][3] + b1;
          }
        }
      }
    }
    __syncthreads();
  }
}

// lazy2 (FUSED; FUSED = false would take the precomputed hidden rows as
// LazySrc does): each thread makes its row's hidden column (zeros for a row
// past B and for the padding to Hp), then the block makes each piece's
// parameter rows by rows_product when the body asks for them (stage_rot,
// stage_mix) and each thread reads its row of the slab.  The backward
// writes a piece's cotangents over its own rows of the slab (a_col,
// put_mix) for the tile products of gf_block_bwd.cu.
template <int N, int KT, int DN, bool FUSED>
struct TileSrc {
  Tile tl;
  const float* w;
  const float* b;
  int t;            // this thread's row of the tile
  mutable int r_a;  // parameter row of sa's column 0 (the staged layer's)

  __device__ TileSrc(const BlockArgs& a, float* smem, int row)
      : tl(a, smem), w(a.w), b(a.b), t(threadIdx.x), r_a(0) {
    float* col = tl.hid + t;
    if (row < a.B)
      hidden_column<FUSED>(a, col, tl.hs, row);
    else
      for (int h = 0; h < a.H; ++h) col[h * tl.hs] = 0.0f;
    for (int h = a.H; h < tl.Hp; ++h) col[h * tl.hs] = 0.0f;
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
using SrcT = typename std::conditional<MODE == LAZY2,
                                       TileSrc<N, KT, DN, true>,
                                       LazySrc<N, KT, DN>>::type;

// the lazy2 / lazy forward kernels' source (lazy: hidden columns at stride
// blockDim.x); the perm forward (gf_block.cu) builds its PermSrc itself
template <int MODE, int KT, int DT>
__device__ __forceinline__ SrcT<MODE, (KT > 0 ? KT : KMAX), KT,
                                (DT > 0 ? DT : DMAX)>
make_src(const BlockArgs& a, float* smem, int row) {
  static_assert(MODE == LAZY2 || MODE == LAZYH, "lazy2 or lazy");
  using S = SrcT<MODE, (KT > 0 ? KT : KMAX), KT, (DT > 0 ? DT : DMAX)>;
  if constexpr (MODE == LAZY2)
    return S(a, smem, row);
  else
    return S(a, smem, row, blockDim.x);
}

}  // namespace gf
