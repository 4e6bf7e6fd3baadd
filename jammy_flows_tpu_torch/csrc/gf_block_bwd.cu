// Backward of the whole-block Gaussianization-flow kernels for Hopper
// (sm_90a), and the fused NLL value-and-gradient.
//
// Replaces the TPU kernels of jammy_flows_tpu/ops/pallas_gf_block.py:
//   * `_block_bwd_call` (T2): the VJP of a whole `gggg` block for arbitrary
//     cotangents (g_out, g_ld).  Density body (`_make_block_density_bwd`):
//     the forward recomputed, then a reverse sweep through the chain.
//     Sample body (`_make_block_sample_bwd`): each layer's solve output s_l
//     reconstructed from the block output y (one mixture value pass per
//     layer, no re-solve), then per-layer implicit steps
//     c = (gs + gld * lx) / fp and the parameters' VJP with (-c, gld);
//   * `_block_fused_call` (T3, `_make_block_density_fused`): the density
//     forward and its VJP in one launch with the cotangents (wv * val, wl)
//     known in advance; val and ld are the forward kernel's (same code).
// perm (one broadcast (P,) vector), lazy2 (the fused one-hidden-layer
// tanh MLP) and lazy (precomputed hidden) modes, as the forward kernels
// (gf_block.cu); T3 takes perm and lazy2 only, as the JAX package's.
//
// What bounds it on an H100: arithmetic, as the forward.  Per row it
// recomputes the forward (the density chain, or one value pass per layer
// for the sample body), runs the adjoint of every mixture (the iCDF
// partials by a three-tangent dual number, gf_common.cuh), and in lazy2 /
// lazy spends 2*P*H flops on the parameter rows, 2*P*H on the hidden
// cotangent dh = w^T dp and 2*P*H on gw = sum_rows dp (x) hidden: ~3x the
// forward's MLP work.  Bytes: x, the cotangents, the summary (lazy: hidden
// and ghidden) and gx per row, plus each block's partial gradients (P*H
// floats), read and written once per tile through L2.
//
// Design:
//   * one thread per batch row; a fixed grid of persistent blocks walks
//     the tiles in a fixed order, so the run is deterministic: in perm
//     mode as many blocks as the SMs hold at once (the occupancy API's
//     count: 3 per SM for the flagship, held by the launch bounds), else
//     two per SM;
//   * per row, the forward's per-layer inputs (L*d floats) are kept and the
//     layers swept in reverse;
//   * lazy2 and lazy (TileSrc, gf_block_src.cuh): the parameter rows come
//     from the forward's own tile stage (3xTF32 tensor-core products into
//     shared slabs), in the recomputation and again in the reverse sweep;
//     each row writes its cotangents over its own slab entries, then the
//     block adds the piece to dh (dh += dp . w_piece) and to its partial
//     gw (gw_piece += dp^T . hidden), both 3xTF32 mma.sync products, and
//     to gb (sum over the tile's rows).  lazy2's dh lives in the block's
//     global scratch (L2), so that two 128-row blocks (8 warps) share an
//     SM at H = 128; lazy keeps dh in shared memory after the tile where
//     two blocks still fit (lazy_dh_shared: H <= 64 at 128 rows),
//     else in the scratch too; the tile shrinks to 64 or 32 rows above
//     H = 454;
//   * perm: a piece's parameter-row cotangents (one mixture's 3K rows,
//     one reflection's or offset's d rows) are summed over the warp's 32
//     rows by a transpose-sum of shuffles (lane j ends with the sum of
//     value j: 31 shuffles for 32 values, 6 for 4) and added by lane j to
//     the warp's own partial in shared memory (P floats a warp; a
//     parameter row is always the same lane's, so no barrier in the
//     per-row body); at the end the block sums its warps' partials in warp
//     order and writes its row of the partials once;
//   * lazy2 ends each tile with dh * (1 - hidden^2) -> gsummary per row and
//     the block's gb1 / gw1 partials; lazy ends it with dh -> ghidden per
//     row (coalesced: consecutive threads write consecutive h);
//   * a second small kernel sums the blocks' partials in block order
//     (two-stage reduction, no atomics).
#include <cuda_runtime.h>

#include "gf_block_src.cuh"
#include "warp_sum.cuh"

using namespace gf;

namespace {

// floats per parameter row of the backward's PermSrc (x P)
constexpr int PERM_FLOATS = PermSrc<1, 0, 1, true>::FLOATS_PER_ROW;

constexpr int SMEM_LIMIT = 227 * 1024;

struct BwdArgs {
  BlockArgs a;        // a.x: x (density, nll) or y (sample); a.out, a.ld: nll
  const float* gout;  // (B, D) cotangent of out (density, sample)
  const float* gld;   // (B, D) cotangent of ld
  float wv, wl;       // nll cotangents: wv * val, wl
  float* gx;          // (B, D)
  float* gsummary;    // lazy2: (B, n_in); lazy: ghidden (B, H)
  float* partials;    // (gridDim.x, G)
  float* scratch;     // dh in global memory: (gridDim.x, Hp, hs), or null
  int G;              // perm: P; lazy2: H*n_in + H + P*H + P; lazy: P*H + P
  int hs;             // stride of a hidden / dh row
};

// a block's working memory: TileSrc's hidden tile and the dh columns
// (lazy2: the block's global scratch; lazy: shared memory after the tile,
// or the scratch) and the warp's partial of the parameter gradient (perm).
// The lazy2 backward keeps it on its stack; `pad` keeps it at 40 bytes:
// at 24 the lazy2 backward's SASS changes, though not its results
// (tools/tile_breakdown.py --part bits; ROADMAP Queue 2 item 4).
struct Stage {
  float* hid;     // lazy2: (Hp, hs)
  float* dh;      // lazy2, lazy: (Hp, hs)
  float* pad[2];  // unused
  float* wpart;   // perm: (P,), this warp's own
};

// ---- lazy2, lazy: a piece's cotangents into the gradients, on the tensor
// cores (dh_product, gw_product and gb_sum: tile_rows.cuh)

// One piece's cotangents dp (its slab: each row's thread has written its
// own) into dh, the block's partial gw (3xTF32 tile products) and gb (the
// sum over the tile's rows, in a fixed order).  The partial's gw follows
// lazy2's gw1 and gb1.  Block-synchronous.
template <int MODE, class Rows>
__device__ void flush_piece(const BwdArgs& A, const Stage& st, const Tile& tl,
                            const float* dp, const Rows& rows, int n) {
  if (n <= 0) return;
  const BlockArgs& a = A.a;
  float* pw = A.partials + (size_t)blockIdx.x * A.G;
  if constexpr (MODE == LAZY2) pw = pw + a.H * a.n_in + a.H;
  float* pb = pw + (size_t)a.P * a.H;
  __syncthreads();
  dh_product(tl, dp, st.dh, a.w, rows, n);
  gw_product(tl, dp, pw, rows, n);
  gb_sum(tl, dp, pb, rows, n);
}

// Reflection i's backward: x_out = x_in - 2 v (v . x_in), v = u / |u|.
// On entry x holds x_out (reflected back in place to x_in: a reflection is
// its own inverse) and g the cotangent of x_out; on exit g is the cotangent
// of x_in and gu that of the raw row u.
template <int DN, class Src>
__device__ __forceinline__ void reflect_bwd(const Src& src, int r0, int D,
                                            float* x, float* g, float* gu,
                                            bool x_is_output) {
  float v[DN], nrm;
  src.unit_vec(r0, D, v, nrm);
  if (x_is_output) {
    float dot = 0.0f;
    for (int j = 0; j < D; ++j) dot += v[j] * x[j];
    for (int j = 0; j < D; ++j) x[j] = x[j] - (2.0f * v[j]) * dot;
  }
  float vx = 0.0f, vg = 0.0f;
  for (int j = 0; j < D; ++j) {
    vx += v[j] * x[j];
    vg += v[j] * g[j];
  }
  float gv[DN], vgv = 0.0f;
  for (int j = 0; j < D; ++j) {
    gv[j] = -2.0f * (vx * g[j] + vg * x[j]);
    vgv += v[j] * gv[j];
  }
  for (int j = 0; j < D; ++j) {
    gu[j] = (gv[j] - v[j] * vgv) / nrm;
    g[j] = g[j] - (2.0f * v[j]) * vg;
  }
}

// A row's cotangents of one dimension's mixture rows (NV: the length of
// the caller's array): lazy2 and lazy write them over its row of the
// staged slab and flush the piece on the tensor cores; perm sums them over
// the warp into the warp's partial.
template <int MODE, int NV, class Src>
__device__ __forceinline__ void emit(const BwdArgs& A, const Stage& st,
                                     const Src& src, const float* vals, int n,
                                     const MixRows& rows) {
  if constexpr (MODE == PERM) {
    warp_flush<NV>(st.wpart, vals, n, rows);
  } else {
    src.put_mix(vals, n);
    flush_piece<MODE>(A, st, src.tl, src.tl.sm, rows, n);
  }
}

// A row's cotangents of the n offset or reflection rows from r0: lazy2 and
// lazy write them over its row of the staged `sa`, flushed by flush_a once
// the layer's are all there; perm as `emit`.
template <int MODE, int NV, class Src>
__device__ __forceinline__ void emit_a(const BwdArgs& A, const Stage& st,
                                       const Src& src, const float* vals,
                                       int n, int r0) {
  if constexpr (MODE == PERM) {
    warp_flush<NV>(st.wpart, vals, n, SpanRows{r0});
  } else {
    for (int j = 0; j < n; ++j) *src.a_col(r0 + j) = keep_nan(vals[j]);
  }
}

template <int MODE, class Src>
__device__ __forceinline__ void flush_a(const BwdArgs& A, const Stage& st,
                                        const Src& src, const LayerMeta& lm) {
  if constexpr (MODE != PERM)
    flush_piece<MODE>(A, st, src.tl, src.tl.sa, SpanRows{lm.row0},
                      (lm.has_off ? A.a.D : 0) + lm.rot_it * A.a.D);
}

// One dimension's mixture adjoint (gf_common.cuh mix_adjoint) at x with
// the cotangents (g, gl); the parameter cotangents [means | raw log-widths
// | raw log-norms] into vals.  perm: the parameter-only terms (regulator
// derivatives, log inverse widths) are the block's, prepared once by
// PermSrc<..., true>.
template <int MODE, int KT, bool SAMPLE, class Src>
__device__ __forceinline__ float adjoint(const Src& src, const BlockArgs& a,
                                         const LayerMeta& lm, int K, int D,
                                         int dd, float x, float g, float gl,
                                         float* vals) {
  constexpr int N = KT > 0 ? KT : KMAX;
  Mix<N> mx;
  float lw[N], ln[N];
  src.load_mix_raw(mx, lw, ln, lm, K, D, dd, a);
  const bool fit = lm.has_ln && a.fit_norm;
  if constexpr (MODE == PERM) {
    float fw[N], fn[N], fl[N];
    src.load_mix_fac(fw, fn, fl, lm, K, D, dd);
    return mix_adjoint<N, KT, SAMPLE, true>(x, mx, lw, ln, K, fit, a.wreg,
                                            a.nreg, lm.ift, g, gl, vals,
                                            vals + K, vals + 2 * K, fw, fn,
                                            fl);
  } else {
    return mix_adjoint<N, KT, SAMPLE>(x, mx, lw, ln, K, fit, a.wreg, a.nreg,
                                      lm.ift, g, gl, vals, vals + K,
                                      vals + 2 * K);
  }
}

// ---- density body (T2 density, T3) ----------------------------------------
template <int MODE, bool NLL, int KT, int DT, class Src>
__device__ void density_tile(const BwdArgs& A, const Stage& st, const Src& src,
                             int row) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const BlockArgs& a = A.a;
  const int K = KT > 0 ? KT : a.K;
  const int D = DT > 0 ? DT : a.D;
  const bool valid = row < a.B;

  // forward, keeping each layer's input
  float x[DN], ld[DN], g[DN], gl[DN];
  float xin[MAX_LAYERS][DN];
  for (int j = 0; j < D; ++j) {
    x[j] = valid ? a.x[(size_t)row * D + j] : 0.0f;
    ld[j] = 0.0f;
  }
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const LayerMeta& lm = a.layers[l];
    for (int j = 0; j < D; ++j) xin[l][j] = x[j];
    src.stage_rot(a, lm);
    int r = lm.row0;
    if (lm.has_off) {
      for (int j = 0; j < D; ++j) x[j] = x[j] - src.param(r + j);
      r += D;
    }
    for (int i = 0; i < lm.rot_it; ++i) reflect<DN>(src, r + i * D, x, D);
    for (int dd = 0; dd < D; ++dd) {
      src.stage_mix(a, lm, dd);
      Mix<N> mx;
      src.load_mix(mx, lm, K, D, dd, a);
      float lg;
      x[dd] = density_pass<N, KT>(x[dd], mx, K, lm.ift, lg);
      ld[dd] = ld[dd] + lg;
    }
  }
  for (int j = 0; j < D; ++j) {
    if (NLL) {
      if (valid) {
        a.out[(size_t)row * D + j] = x[j];
        a.ld[(size_t)row * D + j] = ld[j];
      }
      g[j] = valid ? A.wv * x[j] : 0.0f;
      gl[j] = valid ? A.wl : 0.0f;
    } else {
      g[j] = valid ? A.gout[(size_t)row * D + j] : 0.0f;
      gl[j] = valid ? A.gld[(size_t)row * D + j] : 0.0f;
    }
  }

  // reverse sweep: layer 0 first (the density direction ran it last)
  for (int l = 0; l < a.n_layers; ++l) {
    const LayerMeta& lm = a.layers[l];
    src.stage_rot(a, lm);
    float s[DN];
    for (int j = 0; j < D; ++j) s[j] = xin[l][j];
    int r = lm.row0;
    if (lm.has_off) {
      for (int j = 0; j < D; ++j) s[j] = s[j] - src.param(r + j);
      r += D;
    }
    const int rot0 = r;
    for (int i = 0; i < lm.rot_it; ++i) reflect<DN>(src, rot0 + i * D, s, D);
    int m0, lw0, ln0;
    mix_rows(lm, K, D, m0, lw0, ln0);
    const int n_mix = (2 + lm.has_ln) * K;
    // the entries of vals cleared: all of them where their count is a
    // constant (they then stay in registers)
    const int n_vals = KT > 0 ? 3 * N : n_mix;
    for (int dd = 0; dd < D; ++dd) {
      src.stage_mix(a, lm, dd);
      float vals[3 * N];
      for (int j = 0; j < n_vals; ++j) vals[j] = 0.0f;
      g[dd] = adjoint<MODE, KT, false>(src, a, lm, K, D, dd, s[dd], g[dd],
                                       gl[dd], vals);
      if (!valid)
        for (int j = 0; j < n_vals; ++j) vals[j] = 0.0f;
      emit<MODE, 3 * N>(A, st, src, vals, n_mix,
                        MixRows{m0, lw0, ln0, K, D, dd});
    }
    // reflections were applied i = 0 .. it-1: undo them last-first
    for (int i = lm.rot_it - 1; i >= 0; --i) {
      float gu[DN];
      reflect_bwd<DN>(src, rot0 + i * D, D, s, g, gu, true);
      if (!valid)
        for (int j = 0; j < D; ++j) gu[j] = 0.0f;
      emit_a<MODE, DN>(A, st, src, gu, D, rot0 + i * D);
    }
    if (lm.has_off) {
      float go[DN];
      for (int j = 0; j < D; ++j) go[j] = valid ? -g[j] : 0.0f;
      emit_a<MODE, DN>(A, st, src, go, D, lm.row0);
    }
    flush_a<MODE>(A, st, src, lm);
  }
  if (valid)
    for (int j = 0; j < D; ++j) A.gx[(size_t)row * D + j] = g[j];
}

// ---- sample body (T2 sample) ----------------------------------------------
template <int MODE, int KT, int DT, class Src>
__device__ void sample_tile(const BwdArgs& A, const Stage& st, const Src& src,
                            int row) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const BlockArgs& a = A.a;
  const int K = KT > 0 ? KT : a.K;
  const int D = DT > 0 ? DT : a.D;
  const bool valid = row < a.B;

  // reconstruct the solve outputs: s_l = R_l^T (out_l - off_l),
  // out_{l-1} = gauss_l(s_l), from out_{L-1} = y
  float out[DN], g[DN], gl[DN];
  float sl[MAX_LAYERS][DN];
  for (int j = 0; j < D; ++j) out[j] = valid ? a.x[(size_t)row * D + j] : 0.0f;
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const LayerMeta& lm = a.layers[l];
    src.stage_rot(a, lm);
    float s[DN];
    for (int j = 0; j < D; ++j) s[j] = out[j];
    int r = lm.row0;
    if (lm.has_off) {
      for (int j = 0; j < D; ++j) s[j] = s[j] - src.param(r + j);
      r += D;
    }
    for (int i = 0; i < lm.rot_it; ++i) reflect<DN>(src, r + i * D, s, D);
    for (int j = 0; j < D; ++j) sl[l][j] = s[j];
    if (l > 0) {
      for (int dd = 0; dd < D; ++dd) {
        src.stage_mix(a, lm, dd);
        Mix<N> mx;
        src.load_mix(mx, lm, K, D, dd, a);
        const MixOut o = mixture_eval<N, KT, true, false>(s[dd], mx, K);
        out[dd] = icdf_pass(o.log_cdf, o.log_sf, lm.ift);
      }
    }
  }
  for (int j = 0; j < D; ++j) {
    g[j] = valid ? A.gout[(size_t)row * D + j] : 0.0f;
    gl[j] = valid ? A.gld[(size_t)row * D + j] : 0.0f;
  }

  for (int l = a.n_layers - 1; l >= 0; --l) {
    const LayerMeta& lm = a.layers[l];
    const int rot0 = lm.row0 + (lm.has_off ? D : 0);
    src.stage_rot(a, lm);
    // out-ops y_l = R_l s_l + off_l, R_l applying reflections it-1 .. 0
    if (lm.has_off) {
      float go[DN];
      for (int j = 0; j < D; ++j) go[j] = valid ? g[j] : 0.0f;
      emit_a<MODE, DN>(A, st, src, go, D, lm.row0);
    }
    float xr[DN];
    for (int j = 0; j < D; ++j) xr[j] = sl[l][j];
    for (int i = lm.rot_it - 1; i >= 0; --i) reflect<DN>(src, rot0 + i * D, xr, D);
    for (int i = 0; i < lm.rot_it; ++i) {
      float gu[DN];
      reflect_bwd<DN>(src, rot0 + i * D, D, xr, g, gu, true);
      if (!valid)
        for (int j = 0; j < D; ++j) gu[j] = 0.0f;
      emit_a<MODE, DN>(A, st, src, gu, D, rot0 + i * D);
    }
    flush_a<MODE>(A, st, src, lm);
    // implicit steps through the solve and its log-derivative
    int m0, lw0, ln0;
    mix_rows(lm, K, D, m0, lw0, ln0);
    const int n_mix = (2 + lm.has_ln) * K;
    // the entries of vals cleared: all of them where their count is a
    // constant (they then stay in registers)
    const int n_vals = KT > 0 ? 3 * N : n_mix;
    for (int dd = 0; dd < D; ++dd) {
      src.stage_mix(a, lm, dd);
      float vals[3 * N];
      for (int j = 0; j < n_vals; ++j) vals[j] = 0.0f;
      g[dd] = adjoint<MODE, KT, true>(src, a, lm, K, D, dd, sl[l][dd], g[dd],
                                       gl[dd], vals);
      if (!valid)
        for (int j = 0; j < n_vals; ++j) vals[j] = 0.0f;
      emit<MODE, 3 * N>(A, st, src, vals, n_mix,
                        MixRows{m0, lw0, ln0, K, D, dd});
    }
  }
  if (valid)
    for (int j = 0; j < D; ++j) A.gx[(size_t)row * D + j] = g[j];
}

template <int KIND, int MODE, int KT, int DT, class Src>
__device__ __forceinline__ void run_tile(const BwdArgs& A, const Stage& st,
                                         const Src& src, int row) {
  if constexpr (KIND == 1)
    sample_tile<MODE, KT, DT>(A, st, src, row);
  else
    density_tile<MODE, KIND == 2, KT, DT>(A, st, src, row);
}

// KIND 0: T2 density, 1: T2 sample, 2: T3 (fused NLL); MODE as the source;
// DHG: dh in the block's global scratch.  A compile-time choice, so that
// where dh fits beside the tile its accesses stay shared-space loads and
// stores (a pointer that may be shared or global would make every access
// to it a generic one)
template <int KIND, int MODE, bool DHG, int KT, int DT>
__global__ void __launch_bounds__(128, MODE == PERM ? 3 : 1)
    gf_block_bwd_kernel(const BwdArgs A) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const BlockArgs& a = A.a;
  const int T = blockDim.x, tid = threadIdx.x;
  const int n_tiles = (a.B + T - 1) / T;
  extern __shared__ __align__(16) float smem[];
  Stage st{};
  if (MODE == LAZY2) {
    // the tile's shared memory is TileSrc's; dh is the block's scratch
    st.dh = A.scratch + (size_t)blockIdx.x * a.tile.Hp * A.hs;
  } else if (MODE == LAZYH) {
    // the tile's shared memory is TileSrc's; dh follows it or is the
    // block's scratch
    st.dh = DHG ? A.scratch + (size_t)blockIdx.x * a.tile.Hp * A.hs
                : smem + a.tile.floats();
  } else {
    // after PermSrc's 7P floats, one partial of P floats per warp
    float* wparts = smem + PERM_FLOATS * a.P;
    st.wpart = wparts + (size_t)(tid >> 5) * a.P;
    for (int j = tid; j < (T >> 5) * a.P; j += T) wparts[j] = 0.0f;
  }

  if constexpr (MODE == LAZYH) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row = tile * T + tid;
      // its hidden tile's copy waits for the previous tile's readers
      const TileSrc<N, KT, DN, false> src(a, smem, row);
      for (int h = 0; h < a.tile.Hp; ++h) st.dh[h * A.hs + tid] = 0.0f;
      run_tile<KIND, MODE, KT, DT>(A, st, src, row);
      // ghidden = dh, the tile's rows written h-fastest
      __syncthreads();
      const int n = min(T, a.B - tile * T) * a.H;
      for (int idx = tid; idx < n; idx += T) {
        const int r = idx / a.H, h = idx - r * a.H;
        A.gsummary[(size_t)tile * T * a.H + idx] = st.dh[h * A.hs + r];
      }
    }
  } else if constexpr (MODE == LAZY2) {
    float* pw1 = A.partials + (size_t)blockIdx.x * A.G;
    float* pb1 = pw1 + a.H * a.n_in;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row = tile * T + tid;
      const bool valid = row < a.B;
      const TileSrc<N, KT, DN, true> src(a, smem, row);
      st.hid = src.tl.hid;
      for (int h = 0; h < a.tile.Hp; ++h) st.dh[h * A.hs + tid] = 0.0f;
      run_tile<KIND, MODE, KT, DT>(A, st, src, row);
      // hidden layer: dpre = dh * (1 - hidden^2); gsummary = w1^T dpre
      for (int h = 0; h < a.H; ++h) {
        const float hv = st.hid[h * A.hs + tid];
        st.dh[h * A.hs + tid] *= 1.0f - hv * hv;
      }
      if (valid) {
        for (int i = 0; i < a.n_in; ++i) {
          float acc = 0.0f;
          for (int h = 0; h < a.H; ++h)
            acc += __ldg(a.w1 + h * a.n_in + i) * st.dh[h * A.hs + tid];
          A.gsummary[(size_t)row * a.n_in + i] = acc;
        }
      }
      __syncthreads();
      const int n_valid = min(T, a.B - tile * T);
      for (int h = tid; h < a.H; h += T) {
        float acc = 0.0f;
        for (int t = 0; t < T; ++t) acc += st.dh[h * A.hs + t];
        pb1[h] += acc;
      }
      for (int idx = tid; idx < a.H * a.n_in; idx += T) {
        const int h = idx / a.n_in, i = idx - h * a.n_in;
        const float* dp = st.dh + h * A.hs;
        const float* srow = a.summary + (size_t)tile * T * a.n_in + i;
        float acc = 0.0f;
        for (int t = 0; t < n_valid; ++t) acc += dp[t] * __ldg(srow + (size_t)t * a.n_in);
        pw1[idx] += acc;
      }
      __syncthreads();
    }
  } else {
    // PermSrc's set-up ends with a barrier, after which the zeroed warp
    // partials are visible; the tiles need no other barrier
    const PermSrc<N, KT, DN, true> src(a, smem);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      run_tile<KIND, MODE, KT, DT>(A, st, src, tile * T + tid);
    // the block's partial: its warps' partials summed in warp order,
    // written once (every block writes its row, tiles or not)
    __syncthreads();
    const float* wparts = smem + PERM_FLOATS * a.P;
    float* part = A.partials + (size_t)blockIdx.x * A.G;
    for (int j = tid; j < a.P; j += T) {
      float acc = 0.0f;
      for (int w = 0; w < (T >> 5); ++w) acc += wparts[(size_t)w * a.P + j];
      part[j] = acc;
    }
  }
}

// second stage: out[j] = sum over blocks of partials[b][j], in block order
__global__ void reduce_partials(const float* partials, int n_blocks, int G,
                                float* out) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < G;
       j += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < n_blocks; ++b) acc += partials[(size_t)b * G + j];
    out[j] = acc;
  }
}

template <int KIND, int MODE, bool DHG, int KT, int DT>
cudaError_t launch(const BwdArgs& A, int blocks, int threads, size_t smem,
                   cudaStream_t stream, int* occupancy) {
  auto kernel = gf_block_bwd_kernel<KIND, MODE, DHG, KT, DT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel,
                                                         threads, smem);
  kernel<<<blocks, threads, smem, stream>>>(A);
  return cudaGetLastError();
}

// lazy2 keeps dh in the block's scratch at every H (DHG)
template <int KIND, int MODE>
cudaError_t dispatch_shape(const BwdArgs& A, int blocks, int threads,
                           size_t smem, cudaStream_t stream, int* occupancy) {
  const bool k10 = A.a.K == 10 && A.a.D == 4;
  if constexpr (MODE == LAZY2) {
    return k10 ? launch<KIND, MODE, true, 10, 4>(A, blocks, threads, smem,
                                                 stream, occupancy)
               : launch<KIND, MODE, true, 0, 0>(A, blocks, threads, smem,
                                                stream, occupancy);
  } else {
    if constexpr (MODE != PERM) {
      if (A.scratch)
        return k10 ? launch<KIND, MODE, true, 10, 4>(A, blocks, threads, smem,
                                                     stream, occupancy)
                   : launch<KIND, MODE, true, 0, 0>(A, blocks, threads, smem,
                                                    stream, occupancy);
    }
    return k10 ? launch<KIND, MODE, false, 10, 4>(A, blocks, threads, smem,
                                                  stream, occupancy)
               : launch<KIND, MODE, false, 0, 0>(A, blocks, threads, smem,
                                                 stream, occupancy);
  }
}

template <int MODE>
cudaError_t dispatch(int kind, const BwdArgs& A, int blocks, int threads,
                     size_t smem, cudaStream_t stream, int* occupancy) {
  if (kind == 0)
    return dispatch_shape<0, MODE>(A, blocks, threads, smem, stream, occupancy);
  if (kind == 1)
    return dispatch_shape<1, MODE>(A, blocks, threads, smem, stream, occupancy);
  if constexpr (MODE == LAZYH)
    return cudaErrorInvalidValue;  // no fused NLL on precomputed hidden
  else
    return dispatch_shape<2, MODE>(A, blocks, threads, smem, stream, occupancy);
}

cudaError_t dispatch_mode(int kind, int mode, const BwdArgs& A, int blocks,
                          int threads, size_t smem, cudaStream_t stream,
                          int* occupancy) {
  if (mode == LAZY2)
    return dispatch<LAZY2>(kind, A, blocks, threads, smem, stream, occupancy);
  if (mode == LAZYH)
    return dispatch<LAZYH>(kind, A, blocks, threads, smem, stream, occupancy);
  return dispatch<PERM>(kind, A, blocks, threads, smem, stream, occupancy);
}

// Whether the lazy backward keeps dh (dh_bytes) in shared memory after its
// tile (tile_bytes): where two blocks of both still fit an SM (228 KB, 1 KB
// of it reserved per block), the blocks the kernel's registers allow.
bool lazy_dh_shared(size_t tile_bytes, size_t dh_bytes) {
  return 2 * (tile_bytes + dh_bytes + 1024) <= 228 * 1024;
}

// The tile of a call: its rows (threads) per block, dynamic shared memory,
// whether dh lives in the block's global scratch, and the stride of a
// hidden / dh row.  lazy2 takes lazy2_tile (sets a.tile) and always keeps
// dh in the scratch: with it in shared memory too, a block of 128 rows at
// H = 128 would fill the SM alone.  lazy takes lazy_tile and keeps dh
// after it where lazy_dh_shared says so.  0 or cudaErrorInvalidValue.
int tile_shape(int mode, BlockArgs& a, int& threads, size_t& smem,
               bool& dh_global, int& hs) {
  threads = 128;
  dh_global = false;
  hs = 0;
  if (mode == LAZY2) {
    a.tile = lazy2_tile(a);
    if (a.tile.T == 0) return (int)cudaErrorInvalidValue;
    threads = a.tile.T;
    smem = a.tile.floats() * 4;
    dh_global = true;
    hs = a.tile.hs;
  } else if (mode == LAZYH) {
    a.tile = lazy_tile(a);
    if (a.tile.T == 0) return (int)cudaErrorInvalidValue;
    threads = a.tile.T;
    hs = a.tile.hs;
    smem = a.tile.floats() * 4;
    const size_t dh = (size_t)a.tile.Hp * hs * 4;
    dh_global = !lazy_dh_shared(smem, dh);
    if (!dh_global) smem += dh;
  } else {
    smem = ((size_t)PERM_FLOATS + threads / 32) * a.P * 4;
  }
  return smem > SMEM_LIMIT ? (int)cudaErrorInvalidValue : 0;
}

// floats of dh scratch per block (0: dh in shared memory)
int scratch_floats(const BlockArgs& a, bool dh_global, int hs) {
  return dh_global ? a.tile.Hp * hs : 0;
}

}  // namespace

// The grid of a call: a fixed number of persistent blocks, at most one per
// tile: in perm mode as many as the SMs hold at once (the occupancy API's
// blocks per SM for this kernel, times n_sm), else two per SM.  Fixed for
// a card and a build, so the run is deterministic.  Each block keeps a
// private partial of the broadcast gradients; the caller allocates
// (blocks, G) floats for gf_block_bwd_launch, zeros except in perm mode
// (there each block writes its row once).  kind and meta as
// gf_block_bwd_launch; 0 when the call is not one the kernels take.
extern "C" int gf_block_bwd_blocks(int kind, int mode, int B, int H, int P,
                                   int n_sm, const int* meta) {
  BwdArgs A{};
  BlockArgs& a = A.a;
  a.H = H;
  a.P = P;
  int threads, hs;
  size_t smem;
  bool dh_global;
  if (kind < 0 || kind > 2 || parse_meta(a, mode, meta, P) != 0 ||
      tile_shape(mode, a, threads, smem, dh_global, hs) != 0)
    return 0;
  int per_sm = 2;
  if (mode == PERM &&
      dispatch_mode(kind, mode, A, 1, threads, smem, nullptr, &per_sm) !=
          cudaSuccess)
    return 0;
  const int n_tiles = (B + threads - 1) / threads;
  const int cap = (per_sm > 1 ? per_sm : 1) * n_sm;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  return blocks > 1 ? blocks : 1;
}

// Floats of global dh scratch a call needs per block: 0 while the dh
// columns fit in shared memory (perm; lazy where lazy_dh_shared).
extern "C" int gf_block_bwd_scratch(int mode, int H, int P, const int* meta) {
  BlockArgs a{};
  a.H = H;
  a.P = P;
  int threads, hs;
  size_t smem;
  bool dh_global;
  if (parse_meta(a, mode, meta, P) != 0 ||
      tile_shape(mode, a, threads, smem, dh_global, hs) != 0)
    return 0;
  return scratch_floats(a, dh_global, hs);
}

// Resident blocks per SM of the kernel a call of this (kind, mode, H, P,
// meta) launches, by cudaOccupancyMaxActiveBlocksPerMultiprocessor; writes
// [blocks per SM, threads per block, dynamic shared memory bytes] to out.
extern "C" int gf_block_bwd_occupancy(int kind, int mode, int H, int P,
                                      const int* meta, int* out) {
  BwdArgs A{};
  BlockArgs& a = A.a;
  a.H = H;
  a.P = P;
  int threads, hs;
  size_t smem;
  bool dh_global;
  if (kind < 0 || kind > 2 || parse_meta(a, mode, meta, P) != 0 ||
      tile_shape(mode, a, threads, smem, dh_global, hs) != 0)
    return (int)cudaErrorInvalidValue;
  // a non-null scratch selects the kernel that keeps dh in global memory
  float dummy;
  A.scratch = dh_global ? &dummy : nullptr;
  int n = 0;
  const cudaError_t e =
      dispatch_mode(kind, mode, A, 1, threads, smem, nullptr, &n);
  out[0] = n;
  out[1] = threads;
  out[2] = (int)smem;
  return (int)e;
}

// kind: 0 T2 density (x, gout, gld), 1 T2 sample (x = the sample output y,
// gout, gld), 2 T3 (x; writes val, ld; cotangents wv * val, wl; perm and
// lazy2 only).  mode and meta / regs as gf_block_launch.  partials:
// (n_blocks, G) floats, zeros except in perm mode, G = P (perm),
// H*n_in + H + P*H + P (lazy2) or P*H + P (lazy); grads (G,): the sums
// over rows, packed [gpvec], [gw1 (H, n_in) | gb1 | gw (P, H) | gb] or
// [gw | gb]; grow: the per-row gradient, gsummary (B, n_in) in lazy2,
// ghidden (B, H) in lazy.  scratch: n_blocks * gf_block_bwd_scratch(...)
// floats, or null when that is 0.
// Returns 0 or a cudaError_t; launches on `stream` and does not
// synchronize.
extern "C" int gf_block_bwd_launch(int kind, int mode, const float* x,
                                   const float* gout, const float* gld,
                                   float wv, float wl, float* val, float* ld,
                                   float* gx, int B, const float* pvec,
                                   const float* summary, const float* w1,
                                   const float* b1, const float* w,
                                   const float* b, const float* hidden,
                                   int n_in, int H, int P, const int* meta,
                                   const float* regs, float* grow,
                                   float* partials, int n_blocks,
                                   float* scratch, float* grads,
                                   void* stream) {
  BwdArgs A{};
  BlockArgs& a = A.a;
  a.x = x;
  a.out = val;
  a.ld = ld;
  a.B = B;
  a.pvec = pvec;
  a.summary = summary;
  a.w1 = w1;
  a.b1 = b1;
  a.w = w;
  a.b = b;
  a.hidden = hidden;
  a.n_in = n_in;
  a.H = H;
  a.P = P;
  a.wreg = Reg{meta[4], regs[0], regs[1], regs[2], regs[3], regs[4]};
  a.nreg = Reg{meta[5], regs[5], regs[6], regs[7], regs[8], regs[9]};
  A.gout = gout;
  A.gld = gld;
  A.wv = wv;
  A.wl = wl;
  A.gx = gx;
  A.gsummary = grow;
  A.partials = partials;
  A.scratch = scratch;
  if (kind < 0 || kind > 2 || parse_meta(a, mode, meta, P) != 0 || B < 0 ||
      n_blocks < 1 || (kind == 2 && mode == LAZYH))
    return (int)cudaErrorInvalidValue;
  if ((kind == 2 && (val == nullptr || ld == nullptr)) ||
      (kind != 2 && (gout == nullptr || gld == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;

  int threads, hs;
  size_t smem;
  bool dh_global;
  if (tile_shape(mode, a, threads, smem, dh_global, hs) != 0)
    return (int)cudaErrorInvalidValue;
  if (mode != PERM) {
    if (H < 1 || w == nullptr || b == nullptr || grow == nullptr ||
        (mode == LAZY2 && (n_in < 1 || summary == nullptr)) ||
        (mode == LAZYH && hidden == nullptr) ||
        (dh_global && scratch == nullptr))
      return (int)cudaErrorInvalidValue;
    A.G = (mode == LAZY2 ? H * n_in + H : 0) + P * H + P;
  } else {
    A.G = P;
  }
  A.hs = hs;
  if (!dh_global) A.scratch = nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      dispatch_mode(kind, mode, A, n_blocks, threads, smem, s, nullptr);
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<(A.G + 255) / 256, 256, 0, s>>>(partials, n_blocks, A.G,
                                                    grads);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_block_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
