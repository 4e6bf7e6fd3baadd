// Parameter sources of the per-layer kernels, shared by the forward
// (gf_layer.cu) and the backward (gf_layer_bwd.cu), so that the backward
// recomputes each mixture with the forward's own code.  One call covers one
// `g` layer: x (B, D) and its mixture parameters, in one of three
// interfaces (ops/gf_layer.py):
//   * prepared: (means, inverse widths, log weights), made outside;
//   * raw: the pre-regulator slabs (means, lw, [ln], [se]); the regulators,
//     the weight normalization and the skew exponents run here;
//   * lazy: the final amortization-MLP product b_j + w_j . hidden made here
//     from each row's hidden activations (B, H).
// Prepared and raw slabs are broadcast (K, D) or per row (K, D, B), B minor,
// so the threads of a warp (one row each) read neighbouring floats.
// Broadcast slabs are prepared once per block into shared memory
// (LayerSrc; the broadcast forward's BcastSrc).  Lazy blocks take the tile stage of tile_rows.cuh: the block
// makes one dimension's piece of parameter rows at a time for all its rows
// (the n_groups * K rows g K D + k D + dd, in the group order of the slabs)
// as a 3xTF32 tile product on the tensor cores, into a slab whose column
// each row's thread reads.  The forward (LayerStreamSrc) streams the hidden
// rows through shared memory in chunks, so that its shared memory does not
// grow with H; the backward (LayerTileSrc) stages the hidden tile whole,
// which its gw product reads again.  The k order of the products is fixed
// and the parts of a finite value the same, so the forward, the sample and
// the backward's recomputation make the same parameter bits.
#pragma once

#include <type_traits>

#include "gf_common.cuh"
#include "tile_rows.cuh"

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
  TileShape tile;       // lazy backward: the staged hidden tile
  StreamShape stream;   // lazy forward: the streamed hidden rows
};

// floats of shared memory a broadcast call prepares (10 arrays of K*D)
constexpr int BCAST_ARRAYS = 10;

template <bool SKEW, int N>
using MixT = typename std::conditional<SKEW, SkewMix<N>, Mix<N>>::type;
// the raw broadcast forward's mixture: the plain one with its
// row-independent terms prepared (MixF), the skewed one as LayerSrc's
template <bool SKEW, int N>
using MixFT = typename std::conditional<SKEW, SkewMix<N>, MixF<N>>::type;

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

// The prepared and raw interfaces: broadcast slabs prepared once per block
// into shared memory, per-row slabs read per row.  BWD (the raw broadcast
// backward): the set-up also prepares the adjoint's parameter-only terms
// (mix_adjoint / skew_adjoint FAC), iw reg_w'(lw), reg_n'(ln) and reg_e'(se)
// in place of the raw values, and log(iw) for the plain mixture too; load
// gives them where it gives the raw values.
template <bool SKEW, int N, int KT, bool BWD = false>
struct LayerSrc {
  float* sm;   // broadcast: the prepared arrays

  // Stage the block's shared memory.  Every thread of the block calls it
  // (it synchronizes).
  __device__ LayerSrc(const LayerArgs& a, float* smem) : sm(smem) {
    const int T = blockDim.x, tid = threadIdx.x;
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
          if constexpr (BWD) {
            sm[7 * kd + j] = mx.iw[k] * reg_deriv(a.wreg, lw[k]);
            sm[8 * kd + j] = a.fit_norm ? reg_deriv(a.nreg, ln[k]) : 0.0f;
          } else {
            sm[7 * kd + j] = lw[k];
            sm[8 * kd + j] = ln[k];
          }
          if constexpr (SKEW) {
            sm[4 * kd + j] = mx.liw[k];
            sm[5 * kd + j] = mx.ls[k];
            sm[6 * kd + j] = mx.a[k];
            sm[9 * kd + j] = BWD ? reg_deriv(a.ereg, se[k]) : se[k];
          } else if constexpr (BWD) {
            sm[4 * kd + j] = logf(mx.iw[k]);
          }
        }
      }
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
  // BWD, broadcast only: lw, ln, se take the adjoint's terms iw reg_w'(lw),
  // reg_n'(ln), and reg_e'(se) (skewed) or log(iw).
  __device__ void load(const LayerArgs& a, int row, int dd, MixT<SKEW, N>& mx,
                       float* lw, float* ln, float* se) const {
    const int kk = KT > 0 ? KT : a.K;
    if (!BWD && a.per_row) {
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
        } else if constexpr (BWD) {
          se[k] = sm[4 * kd + j];
        }
      }
    }
  }
};

// The broadcast forward's source (T4 / T5 / T6 raw, gf_layer_bcast_kernel;
// T4 / T6 prepared, gf_layer_prep_kernel, PREP): the block's mixtures
// prepared once into shared memory, K * D floats an array, value k of
// dimension dd at k * D + dd, by one (dimension, component) pair a thread.
// Raw slabs in two passes: the per-component terms (regulators,
// exponents), then, after a barrier, each pair's log-softmax over its
// dimension's regulated log-norms (every pair of a dimension sums them in
// the same order) and the terms that need it, MixF's lnw + log(iw) and
// nw * iw for the plain mixture.  prep_mix's and prep_skew's f32
// expressions, so the mixture's bits are those of LayerSrc's one thread a
// dimension (the set-up the per-row and lazy calls keep).  PREP (prepared
// slabs: means, inverse widths, log weights) in one pass: nw = exp(lnw)
// and MixF's terms, prep_layer_mix's expressions.
enum BcastArray {
  BA_M, BA_IW, BA_LNW, BA_NW, BA_LIW, BA_LS, BA_A, BA_LP, BA_NWIW, BA_L,
  BCAST_FWD_ARRAYS
};

template <bool SKEW, int N, int KT, bool PREP = false>
struct BcastSrc {
  float* sm;

  // Every thread of the block calls it (it synchronizes).
  __device__ BcastSrc(const LayerArgs& a, float* smem) : sm(smem) {
    const int T = blockDim.x, tid = threadIdx.x;
    const int kd = a.K * a.D;
    if constexpr (PREP) {
      for (int j = tid; j < kd; j += T) {
        const float iw = __ldg(a.p[1] + j), lnw = __ldg(a.p[2] + j);
        const float nw = expf(lnw);
        sm[BA_M * kd + j] = __ldg(a.p[0] + j);
        sm[BA_IW * kd + j] = iw;
        sm[BA_LNW * kd + j] = lnw;
        sm[BA_NW * kd + j] = nw;
        sm[BA_LP * kd + j] = lnw + logf(iw);
        sm[BA_NWIW * kd + j] = nw * iw;
      }
      __syncthreads();
      return;
    }
    for (int j = tid; j < kd; j += T) {
      const float iw = expf(-apply_reg(a.wreg, __ldg(a.p[1] + j)));
      sm[BA_M * kd + j] = __ldg(a.p[0] + j);
      sm[BA_IW * kd + j] = iw;
      if (a.fit_norm) sm[BA_L * kd + j] = apply_reg(a.nreg, __ldg(a.p[2] + j));
      if constexpr (SKEW) {
        const float ls = apply_reg(a.ereg, __ldg(a.p[2 + a.fit_norm] + j));
        sm[BA_LIW * kd + j] = logf(iw);
        sm[BA_LS * kd + j] = ls;
        sm[BA_A * kd + j] = expf(ls);
      }
    }
    __syncthreads();
    const int kk = KT > 0 ? KT : a.K;
    for (int j = tid; j < kd; j += T) {
      const int dd = j % a.D;
      float lnw;
      if (a.fit_norm) {
        const float* l = sm + BA_L * kd + dd;
        float mmax = -INFINITY;
        for (int k = 0; k < kk; ++k) mmax = fmaxf(mmax, l[k * a.D]);
        float s = 0.0f;
        for (int k = 0; k < kk; ++k) s += expf(l[k * a.D] - mmax);
        lnw = l[j - dd] - (mmax + logf(s));
      } else {
        lnw = (float)(-log((double)kk));
      }
      const float nw = expf(lnw);
      sm[BA_LNW * kd + j] = lnw;
      sm[BA_NW * kd + j] = nw;
      if constexpr (!SKEW) {
        const float iw = sm[BA_IW * kd + j];
        sm[BA_LP * kd + j] = lnw + logf(iw);
        sm[BA_NWIW * kd + j] = nw * iw;
      }
    }
    __syncthreads();
  }

  // dimension dd's mixture (the skewed mixture's weights nw are not read)
  __device__ void load(const LayerArgs& a, int dd, MixFT<SKEW, N>& mx) const {
    const int kk = KT > 0 ? KT : a.K;
    const int kd = a.K * a.D;
#pragma unroll
    for (int k = 0; k < kk; ++k) {
      const int j = k * a.D + dd;
      mx.m[k] = sm[BA_M * kd + j];
      mx.iw[k] = sm[BA_IW * kd + j];
      mx.lnw[k] = sm[BA_LNW * kd + j];
      if constexpr (SKEW) {
        mx.liw[k] = sm[BA_LIW * kd + j];
        mx.ls[k] = sm[BA_LS * kd + j];
        mx.a[k] = sm[BA_A * kd + j];
      } else {
        mx.nw[k] = sm[BA_NW * kd + j];
        mx.lp[k] = sm[BA_LP * kd + j];
        mx.nwiw[k] = sm[BA_NWIW * kd + j];
      }
    }
  }
};

// the parameter rows of dimension dd's piece: slab column j = g K + k is
// row g K D + k D + dd = j D + dd
struct PieceRows {
  int D, dd;
  __device__ int operator()(int j) const { return j * D + dd; }
};

// A row's mixture of the staged dimension from its column t of the piece's
// slab (stride ts), and the raw values it was prepared from
template <bool SKEW, int N, int KT>
__device__ __forceinline__ void load_piece_mix(const LayerArgs& a,
                                               const float* sm, int ts, int t,
                                               MixT<SKEW, N>& mx, float* lw,
                                               float* ln, float* se) {
  const int K = KT > 0 ? KT : a.K;
  const int g_se = 2 + a.fit_norm;
  const float* s = sm + t;
#pragma unroll
  for (int k = 0; k < (KT > 0 ? KT : a.K); ++k) {
    mx.m[k] = s[k * ts];
    lw[k] = s[(K + k) * ts];
    ln[k] = a.fit_norm ? s[(2 * K + k) * ts] : 0.0f;
    se[k] = SKEW ? s[(g_se * K + k) * ts] : 0.0f;
  }
  prep_layer_mix<SKEW, N, KT>(mx, lw, ln, se, a);
}

// The lazy forward: each dimension's piece of parameter rows made by the
// streamed tile product (tile_rows.cuh rows_product_streamed) into the
// slab.  stage is block-synchronous: every thread of the block calls it,
// rows past B included (their hidden rows read as zeros).
template <bool SKEW, int N, int KT>
struct LayerStreamSrc {
  StreamTile tl;
  int t;  // this thread's row of the tile

  __device__ LayerStreamSrc(const LayerArgs& a, float* smem)
      : tl(a.H, a.stream, a.w, a.hidden, smem), t(threadIdx.x) {}

  // dimension dd's piece of the parameter rows of the tile from row0, NT
  // n8 tiles of it at a time
  template <int NT>
  __device__ void stage(const LayerArgs& a, int row0, int dd) const {
    const int K = KT > 0 ? KT : a.K;
    rows_product_streamed<NT>(tl, a.hidden, row0, a.B, tl.sm, a.w, a.b,
                              PieceRows{a.D, dd}, a.n_groups * K);
  }

  __device__ void load(const LayerArgs& a, MixT<SKEW, N>& mx, float* lw,
                       float* ln, float* se) const {
    load_piece_mix<SKEW, N, KT>(a, tl.sm, tl.ts, t, mx, lw, ln, se);
  }
};

// The lazy backward's chunk buffers: W chunks of up to STREAM_NC rows, so
// that dh_product takes a skewed flagship piece (40 rows) in one chunk
constexpr int LAYER_WC_FLOATS = 2 * STREAM_NC * TILE_WS;

// Floats of a lazy backward block's tile (its chunk buffers LAYER_WC_FLOATS)
__host__ __device__ inline size_t layer_tile_floats(const TileShape& t) {
  return t.floats() - 2 * TILE_NC * TILE_WS + LAYER_WC_FLOATS;
}

// The lazy backward: the tile stage with the hidden tile staged whole
// (tile_rows.cuh), which the flush's gw product reads too.  Every call is
// block-synchronous but load and put, and every thread of the block makes
// them, rows past B included (their hidden rows are zeros).
template <bool SKEW, int N, int KT>
struct LayerTileSrc {
  Tile tl;
  int t;  // this thread's row of the tile

  __device__ LayerTileSrc(const LayerArgs& a, float* smem)
      : tl(a.H, a.tile, a.w, smem, LAYER_WC_FLOATS), t(threadIdx.x) {}

  // the hidden rows row0 .. row0 + T - 1 into the tile (load_hidden_tile)
  __device__ void load_tile(const LayerArgs& a, int row0) const {
    load_hidden_tile(tl, a.hidden, row0, a.B, a.H);
  }

  // dimension dd's piece of parameter rows into the slab
  __device__ void stage(const LayerArgs& a, int dd) const {
    const int K = KT > 0 ? KT : a.K;
    rows_product<4>(tl, tl.sm, a.w, a.b, PieceRows{a.D, dd}, a.n_groups * K);
  }

  // this thread's mixture of the staged dimension, and the raw values it
  // was prepared from
  __device__ void load(const LayerArgs& a, MixT<SKEW, N>& mx, float* lw,
                       float* ln, float* se) const {
    load_piece_mix<SKEW, N, KT>(a, tl.sm, tl.ts, t, mx, lw, ln, se);
  }

  // the backward: this thread's n cotangents of the staged piece over its
  // column of the slab (a NaN kept for the TF32 split), zeros up to the
  // next multiple of 8 (the tile products' k steps read them)
  __device__ void put(const float* vals, int n) const {
    float* s = tl.sm + t;
    for (int j = 0; j < n; ++j) s[j * tl.ts] = keep_nan(vals[j]);
    for (int j = n; j < (n + 7) / 8 * 8; ++j) s[j * tl.ts] = 0.0f;
  }
};

// Shared memory floats a broadcast or per-row call's block needs for its
// source (LayerSrc; the broadcast forward's BcastSrc: bcast).
__host__ __device__ inline size_t layer_src_floats(const LayerArgs& a,
                                                   bool bcast = false) {
  return a.per_row ? 0
                   : (size_t)(bcast ? BCAST_FWD_ARRAYS : BCAST_ARRAYS) *
                         a.K * a.D;
}

// The lazy forward's streamed tile for pieces of n parameter rows: 128
// rows at every H.
__host__ __device__ inline StreamShape layer_stream_shape(int n) {
  return StreamShape{128, 128 + 4, (n + 7) / 8 * 8};
}

// The lazy backward's tile for pieces of n parameter rows: the largest T of
// 128, 64, 32 rows whose shared memory fits, with dh_cols the backward's dh
// columns (Hp, hs) after the tile's own floats; T = 0 when none does.  The
// slab's rows: n rounded up to 16 (gw_product's m16 tiles read them).
__host__ __device__ inline TileShape layer_tile(int H, int n, bool dh_cols) {
  TileShape t{};
  for (int T = 128; T >= 32; T /= 2) {
    t = TileShape{T, (H + 7) / 8 * 8, T + 8, T + 4, 0, (n + 15) / 16 * 16};
    const size_t dh = dh_cols ? (size_t)t.Hp * t.hs : 0;
    if ((layer_tile_floats(t) + dh) * 4 <= TILE_SMEM_LIMIT) return t;
  }
  t.T = 0;
  return t;
}

}  // namespace gf
