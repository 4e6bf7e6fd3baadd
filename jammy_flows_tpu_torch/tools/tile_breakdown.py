"""Where a block kernel's time goes: the block kernels timed as built, and
again with parts of them switched off, on the card.

    python -m jammy_flows_tpu_torch.tools.tile_breakdown
        [--part lazy2|perm|perm_fwd|layer_lazy|layer_raw|layer_fwd_raw|
                layer_prep|block_lazy|sass|bits]
        [--csrc DIR [DIR ...]] [--rounds R] [--variants V [V ...]]

Builds ``csrc/gf_block.cu`` and ``csrc/gf_block_bwd.cu`` from a copy of the
sources (``--csrc``, by default the package's own: a parent tree's sources
can be measured with this tool, and several trees side by side) under
``build/tile_breakdown/``, each variant of each tree by its own nvcc
process, all at once.  ``--rounds R`` times the trees R times, in their
order and then in reverse (two trees, R = 2: A B B A), and reports each
time's median over the rounds beside every round's.

lazy2 (the flagship's block 2: H = 128, a 7-wide summary): as built; with
every 3xTF32 tile product off (``rows_product`` reduced to the bias, so that
every row's parameters become b and the body still runs on finite
parameters, ``dh_product`` and ``gw_product`` returning at once); the
backward with ``dh_product`` alone off; and with ``gw_product`` alone off.
The differences are what each product, its loads and its barriers cost
inside the kernel; the all-off time is the body (hidden layer, per-row
mixture preparation, mixtures, adjoints, the stages' barriers).  The T1
perm kernels are timed beside them; the backward kernels also as one of 10
launches back to back.

perm (the flagship's block 0, the T2 / T3 perm backward): as built, and
with the adding of each row's parameter cotangents into the block's
partials switched off (``perm_flush``: ``stage_flush`` returning at once in
perm mode, or ``warp_flush`` where the sources have it), so that the
difference is the flush and the rest the body (forward recomputation,
adjoints; the compiler may drop work whose only use was the flush, so the
body is a lower bound).  Each at two grids: two blocks per SM (the grid of
the kernels before the perm redesign) and (blocks per SM from the
occupancy API) x SMs, the latter also as one of 10 launches back to back.
With ``-Xptxas -v``: the perm kernels' registers, stack and spills.

perm_fwd (the flagship's block 0, the T1 perm forward: ``density_perm``,
``sample_perm``), each timed alone and as one of 10 launches back to back
(where the host's launch time hides behind the kernels before it): as
built, and with the per-row body switched off (the
forward kernels' layer loops left at once, ``perm_body``), so that only the
block's parameter set-up (``PermSrc``) and each row's loads and stores
remain.  Sources whose perm forward walks row tiles (a ``perm_grid``
function choosing its grid) are also timed at one block per tile of rows,
the grid of a kernel without a tile loop (``perm_grid`` switched to
``return n_tiles``), both with the body on and off.  With ``-Xptxas -v``:
the perm forward kernels' registers, stack and spills; with ``cuobjdump
-sass``: each perm forward kernel's MUFU (by function), FFMA, FMUL, FADD,
FCHK (one per IEEE division) and CALL instructions, as the kernel's code
holds them once (its loop bodies once each: the layer loop's trip count is
a run-time value), and its blocks per SM (the occupancy API).

layer_lazy (the per-layer lazy kernels of the flagship with
``{"g": {"add_skewness": 1}}``, block 2's shapes: T4 ``forward_lazy``, T5
``sample_lazy``, both T7 lazy bodies; builds ``csrc/gf_layer.cu`` and
``csrc/gf_layer_bwd.cu``), each timed alone and as one of 10 launches back
to back: as built; with the parameter product off (every parameter row
its bias b: the per-thread loop over the hidden units before the tile
redesign, ``rows_product`` / ``rows_product_streamed`` after it); T7
with the flush of each piece's cotangents into dh, gw and gb off.
Yardsticks on the same inputs: the P x H product
alone as ``torch.matmul`` and the materialized route (that product as
per-row slabs, then the raw per-row kernel; T7 also ghidden and gw as
matmuls).  With ``-Xptxas -v``: the lazy kernels' registers, stack and
spills; blocks per SM where the sources have an occupancy query.

layer_raw (T7 with raw broadcast slabs, both bodies: the skewed flagship's
block-0 layer 0, K = 10, d = 4, four parameter groups (40 rows a
dimension), and the same slabs without the exponents (the plain mixture,
three groups); the density body at that layer's log_prob input, the sample
body at its sample call's roots, 262,144 rows, cotangents from a seeded
generator; builds ``csrc/gf_layer_bwd.cu``), each timed alone and as one
of 10 launches back to back: as built; with the flush of each row's
parameter cotangents off (``stage_flush`` before the redesign,
``warp_flush`` after it, each reduced to adding the row's values into one
float of the partials, so that the adjoint's values stay live); with the
per-row adjoint off (``row_adjoint`` writing values
made from the cotangents alone), which leaves the flush and the set-up;
where the sources have them, the broadcast kernel's register caps (its
``__launch_bounds__`` minimum of blocks per SM, 4 as built, made 1, the
unbounded form, or 3) and its per-row factor multiplies off (the block's
regulator derivatives read as 1: the per-row work that applying them once
per block would save).
As built, the skewed model's training step on those sampled rows, the
four T7 raw launches of which are this kernel's (autograd of
-log_prob().mean(); a ``train.fit`` Adam step).  With ``-Xptxas -v`` the
raw kernels' registers, stack and spills, and each variant's blocks per SM
(the occupancy API) and grid.

layer_fwd_raw (T4 ``forward_raw`` and T5 ``sample_raw`` with raw
broadcast slabs: the skewed flagship's block-0 layer 0, K = 10, d = 4,
four parameter groups, and the same slabs without the exponents (the
plain mixture, three groups); T4 at that layer's log_prob input, T5 at its
sample call's targets, 1,048,576 rows; builds ``csrc/gf_layer.cu``), each
timed alone and as one of 10 launches back to back: as built; with the
per-row body off (``row_pass`` reduced to the row's load and store, so
that the block's set-up and the loads remain); with the set-up skipped
(``LayerSrc``'s or ``BcastSrc``'s set-up replaced by a fill of its arrays
with a plain mixture of unit widths at the raw means); T5's solve and
root log-derivative as one rolled loop over one copy of the mixture
evaluation (``fwd_rolled``) and unrolled (``fwd_unrolled``: ``skew_solve``
+ ``skew_density_pass``, ``solve`` + ``solve_log_deriv``); the kernel's
register cap, its ``__launch_bounds__`` minimum of blocks per SM made
2-6.  As built, the skewed model's ``sample`` and ``log_prob`` at
1,048,576 rows with that tree's library.  For every variant: the raw
broadcast kernels' registers, stack and spills (``-Xptxas -v``), their
``cuobjdump -sass`` instruction counts (as ``perm_fwd``), blocks per SM
(the occupancy API) and grid.

layer_prep (T4 ``forward_prepared`` and T6 ``inverse_prepared``, the
per-layer calls of the flagship with ``{"g": {"center_mean": 1}}``: its
block-0 layer 0 with broadcast slabs and its block-2 layer 0 with per-row
slabs, K = 10, d = 4, recorded from the model's ``sample`` at 1,048,576
rows, T6 at the layer's targets and T4 at T6's roots; and T6
``inverse_raw`` on the block-0 layer's mixture as raw broadcast slabs:
means, -log of the inverse widths and the log weights under identity
regulators; builds ``csrc/gf_layer.cu``), each timed alone and as one of
10 launches back to back: as built; with the per-row body off and the
set-up skipped (the switches of layer_fwd_raw; a per-row call's body off
also drops its slab loads but the first component's); T6's solve rolled
(``inv_rolled``) and unrolled (``inv_unrolled``: ``solve``), by text
injected into ``row_pass``; the register caps (``bounds_2`` - ``bounds_6``:
the ``__launch_bounds__`` minimum of blocks per SM of every non-lazy
forward kernel made 2-6).  For every variant: those kernels' registers,
stack and spills (``-Xptxas -v``), their ``cuobjdump -sass`` instruction
counts (as ``perm_fwd``), blocks per SM (from the registers: the occupancy
API of an older library does not answer for these calls) and grid.

block_lazy (the block's lazy mode, precomputed hidden activations, on
the flagship with ``amortization_mlp_dims="64-64"``, block 2: K = 10,
d = 4, P = 548, H = 64; T1 ``density_lazyh`` / ``sample_lazyh``, T2
``density_bwd_lazyh`` / ``sample_bwd_lazyh``), each timed alone and as
one of 10 launches back to back: as built; with the parameter product off
(every parameter row its bias b: the per-thread loops over the hidden
units of ``LazySrc`` before the tile redesign, ``rows_product`` after
it); T2 with the flush of the row cotangents into dh, gw and gb off
(``flush`` before, ``flush_piece`` after); where the sources choose them
by a function, the design's alternatives: the slabs' rows rounded up to
32 (``lazy_tile``) and dh in the block's global scratch at every H
(``lazy_dh_shared``).  Yardsticks on the same inputs: the P x H product
alone as one ``torch.matmul`` (float32 at "highest" precision), hidden .
w^T; T2 the two products dh = dp . w and gw = dp^T . hidden.  With
``-Xptxas -v`` the lazy kernels' registers, stack and spills, with
``cuobjdump -sass`` their TF32 HMMA instructions, and their blocks per SM
(the occupancy API) for every variant.

sass (no timing): the as-built libraries of every block and per-layer
source (``gf_block``, ``gf_block_bwd``, ``gf_layer``, ``gf_layer_bwd``) of
each tree, their kernels' SASS (``cuobjdump -sass``) compared with the
first tree's, function by function, with addresses and immediates masked:
per library the functions that are identical, those that differ (with
their count of differing instructions) and those only one tree has.

bits (no timing): the SASS comparison of ``sass``, and each tree's outputs
of the same seeded model calls compared bit for bit with the first
tree's.  The models: the flagship (perm and lazy2 blocks), the flagship
with ``{"g": {"center_mean": 1}}`` and with ``{"g": {"add_skewness":
1}}`` (the per-layer kernels, lazy and raw), and with
``amortization_mlp_dims="64-64"`` (the block's lazy mode); each model's
``sample`` and ``log_prob`` at 65,536 rows, the fused
``nll_value_and_grad``, and the gradients of ``-log_prob().mean()`` and of
a sample objective, with the kernels each model launched; the per-layer
lazy kernels (T4, T5, both T7 bodies) called directly on seeded inputs,
skewed and not, at K = 10 and at the generic shape; and the per-layer
prepared and raw kernels (T4, T5, T6, both T7 raw broadcast bodies), the
slabs broadcast (one value NaN) and per row, every iCDF type.

Forward at 1,048,576 rows, backward at 262,144; CUDA events, median of
10.  Prints one JSON line with the card's name and power limit.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

from ..ops import cuda_build

OUT = cuda_build.BUILD_DIR.parent / "tile_breakdown"
# the products' bodies, run after the opening brace when switched off
# (under GF_OFF_<name>)
_OFF = {
    "rows_product": "  if (n <= 0) return;\n  __syncthreads();\n"
                    "  for (int c = 0; c < (n + 7) / 8 * 8; ++c)\n"
                    "    slab[(size_t)c * tl.ts + threadIdx.x] =\n"
                    "        c < n ? __ldg(b + rows(c)) : 0.0f;\n"
                    "  __syncthreads();\n  return;\n",
    "dh_product": "  return;\n",
    "gw_product": "  return;\n",
}
# the perm flush: the function that adds a row's parameter cotangents to
# the block's partials in perm mode (the opening of its definition, as the
# sources before or after the perm redesign have it: one must be there) and
# its switched-off body
_PERM_FLUSH = {
    r"template <int MODE, class Rows>\s*__device__ void stage_flush":
        "  if (MODE == PERM) return;\n",
    r"__device__ __forceinline__ void warp_flush": "  return;\n"}
# the perm forward's per-row body: the forward kernels' layer loops
# (gf_block.cu), left at once (in every mode: this part times perm only)
_PERM_BODY = (r"for \(int l = a\.n_layers - 1; l >= 0; --l\) \{\n",
              r"for \(int l = 0; l < a\.n_layers; \+\+l\) \{\n")
# the perm forward's grid, where the sources have one to choose: one block
# per tile of rows
_PERM_GRID = r"int perm_grid\([^)]*\)\s*\{\n"


# the per-layer lazy kernels (T4 / T5 forward_lazy / sample_lazy, T7 lazy
# bodies): their parameter product (the sources before the tile redesign:
# each thread's loop over the hidden units, left at once, so that every
# parameter row is b; after it: rows_product and rows_product_streamed
# reduced to the bias, as _OFF), and T7's flush of a piece's cotangents (the per-thread staged flush
# before, the tile products after), each switched off
_LAYER_PRODUCT = {
    r"const int g_se = 2 \+ a\.fit_norm;\n\s*for \(int h = 0; h < a\.H; "
    r"\+\+h\) \{\n": "break;\n",
    r"__device__ void rows_product\([^)]*\)\s*\{\n": _OFF["rows_product"],
    r"__device__ void rows_product_streamed\([^)]*\)\s*\{\n":
        _OFF["rows_product"]}
_LAYER_FLUSH = {
    r"template <bool LAZY>\s*__device__ void flush\(const LayerBwdArgs[^)]*\)"
    r"\s*\{\n": "  if (LAZY) return;\n",
    r"__device__ void layer_flush\([^)]*\)\s*\{\n": "  return;\n"}
# T7 raw broadcast: the flush of a row's parameter cotangents (the staged
# per-thread flush before the redesign, the warp transpose-sums after it),
# each reduced to adding the row's values into one float of the partials
# (the values stay live, so the adjoint is not optimized away); the per-row
# adjoint, writing values made from the cotangents alone (the flush and
# the set-up remain); the broadcast kernel's register cap; its per-row
# multiplies by the block's regulator derivatives (read as 1)
_LAYER_RAW = {
    "raw_flush": {
        r"__device__ void stage_flush\(const LayerBwdArgs[^)]*\)\s*\{\n":
            "  float s_ = 0.0f;\n  for (int j = 0; j < n; ++j) s_ += vals[j];\n"
            "  if (threadIdx.x < n)\n"
            "    A.partials[(size_t)blockIdx.x * A.G + threadIdx.x] += s_;\n"
            "  return;\n",
        r"__device__ __forceinline__ void warp_flush\([^)]*\)\s*\{\n":
            "  float s_ = 0.0f;\n#pragma unroll\n"
            "  for (int j = 0; j < NV; ++j) s_ += j < n ? vals[j] : 0.0f;\n"
            "  if ((threadIdx.x & 31) < n) wpart[rows(threadIdx.x & 31)] += s_;\n"
            "  return;\n"},
    "raw_adjoint": {
        r"__device__ __forceinline__ void row_adjoint\([^)]*\)\s*\{\n":
            "  const float g1_ = valid ? A.g1[i] : 0.0f;\n"
            "  const float g2_ = valid ? A.g2[i] : 0.0f;\n#pragma unroll\n"
            "  for (int j = 0; j < (SKEW ? 4 : 3) * N; ++j)\n"
            "    vals[j] = g1_ + (float)j * g2_;\n"
            "  if (valid) A.gx[i] = g1_;\n  return;\n"},
    "factors_off": {
        r"bool FAC = false>\n__device__ __forceinline__ void row_adjoint"
        r"\([^)]*\)\s*\{\n":
            "  float one_[N];\n#pragma unroll\n"
            "  for (int k = 0; k < N; ++k) one_[k] = 1.0f;\n"
            "  if (FAC) {\n    lw = one_;\n    ln = one_;\n"
            "    if (SKEW) se = one_;\n  }\n"}}
# the broadcast kernel's register cap: its __launch_bounds__ minimum of
# blocks per SM (as built 4) made 1 (the unbounded form) or 3
_BOUNDS = re.compile(r"__launch_bounds__\(128, (\d+)\)"
                     r"(\s*gf_layer_bcast_bwd_kernel)")
_BOUNDS_MIN = (1, 3)
# the block's lazy mode (T1 / T2 lazyh): its parameter product (before the
# tile redesign LazySrc's per-thread loops over the hidden units, left so
# that every parameter row is b; after it rows_product, as _OFF), its
# flush (the staged per-thread flush before, flush_piece's tile products
# after) and, where the sources choose them by a function, the tile's
# slab rounding and dh's place
_BLOCK_LAZY = {
    "block_lazy_product": {
        r"__device__ float param\(int j\) const \{\n":
            "    return __ldg(b + j);\n",
        r"// one pass over the hidden units for all 3K rows of this "
        r"dimension\n\s*for \(int h = 0; h < H; \+\+h\) \{\n": "break;\n",
        r"__device__ void rows_product\([^)]*\)\s*\{\n": _OFF["rows_product"]},
    "block_lazy_flush": {
        r"__device__ void flush\(const BwdArgs& A, const Stage& st, int "
        r"cnt\) \{\n": "  return;\n",
        r"__device__ void flush_piece\([^)]*\)\s*\{\n": "  return;\n"},
    "lazy_slabs_32": {r"TileShape lazy_tile\([^)]*\)\s*\{\n":
                      "  return piece_tile(a, 32, 32);\n"},
    "lazy_dh_global": {r"bool lazy_dh_shared\([^)]*\)\s*\{\n":
                       "  return false;\n"},
}
# T4 / T5 raw broadcast (layer_fwd_raw), in the sources before and after
# their redesign: the per-row body (row_pass) reduced to each row's load
# and store and two of its mixture's values, so that the set-up and the
# loads remain; the set-up (LayerSrc's before, BcastSrc's after) replaced
# by a fill of the block's arrays with a plain mixture of unit widths at
# the raw means (every array, so the body runs on finite values); the sample
# mode's solve and root log-derivative as one rolled loop over one copy of
# the mixture evaluation (fwd_rolled, helpers defined after the sources'
# `using namespace gf;`) or unrolled as the parent's row_pass has it
# (skew_solve + skew_density_pass, solve + solve_log_deriv; fwd_unrolled)
_ROW_PASS = r"__device__ __forceinline__ void row_pass\([^)]*\)\s*\{\n"
_FWD_SETUP = (r"__device__ LayerSrc\(const LayerArgs& a, float\* smem\)"
              r"\s*:\s*sm\(smem\)\s*\{\n")
_FWD_FILL = """  if (!a.per_row) {
    const int kd_ = a.K * a.D;
    for (int j = threadIdx.x; j < kd_; j += blockDim.x)
      for (int q = 0; q < BCAST_ARRAYS; ++q)
        sm[q * kd_ + j] = q == 0 ? __ldg(a.p[0] + j)
                        : q == 2 ? -logf((float)a.K)
                        : (q == 3 || q == 11) ? 1.0f / (float)a.K
                        : (q == 1 || q == 6 || q == 10) ? 1.0f : 0.0f;
  }
  __syncthreads();
  return;
"""
_FWD_SETUP_BCAST = (r"__device__ BcastSrc\(const LayerArgs& a, float\* smem\)"
                    r"\s*:\s*sm\(smem\)\s*\{\n")
_FWD_FILL_BCAST = """  {
    const int kd_ = a.K * a.D;
    for (int j = threadIdx.x; j < kd_; j += blockDim.x)
      for (int q = 0; q < BCAST_FWD_ARRAYS; ++q)
        sm[q * kd_ + j] = q == BA_M ? __ldg(a.p[0] + j)
                        : (q == BA_LNW || q == BA_LP) ? -logf((float)a.K)
                        : (q == BA_NW || q == BA_NWIW) ? 1.0f / (float)a.K
                        : (q == BA_IW || q == BA_A) ? 1.0f : 0.0f;
  }
  __syncthreads();
  return;
"""
_FWD_ROLLED_HELPERS = """template <int N, int KT, class M>
__device__ __forceinline__ float gf_rolled_plain(float target, const M& mx,
                                                 int K, int ift, float& ld) {
  float lo, hi, x;
  solve_start<N, KT>(target, mx, K, ift, lo, hi, x);
#pragma unroll 1
  for (int it = 0;; ++it) {
    const MixOut o = mixture_eval<N, KT, false, true>(x, mx, K);
    if (it == N_NEWTON) {
      ld = icdf_log_deriv(o.log_cdf, o.log_sf, o.log_pdf, ift);
      return x;
    }
    float deriv;
    const float val = solve_value<true>(o, ift, deriv);
    newton_step(val, deriv, target, x, lo, hi);
  }
}
template <int N, int KT, class M>
__device__ __forceinline__ float gf_rolled_skew(float target, const M& mx,
                                                int K, int n_pos, int ift,
                                                float& ld) {
  const int kk = KT > 0 ? KT : K;
  const float t = ift == ISIGMOID ? target : logit_phi(target);
  const float log_q = -softplus(-t), log_1mq = -softplus(t);
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < kk; ++k) {
    const bool pos = k < n_pos;
    const float log_p = (pos ? log_q : log_1mq) / mx.a[k];
    const float u = fminf(log_p, -TINY);
    float l1me;
    if (u > -0.1f)
      l1me = logf(-u) + log1pf(u * (0.5f + u * (1.0f / 6.0f + u * (1.0f / 24.0f))));
    else
      l1me = log1pf(-expf(u));
    const float logit_p = log_p - l1me;
    const float q = mx.m[k] + (pos ? logit_p : -logit_p) / mx.iw[k];
    lo = fminf(lo, q);
    hi = fmaxf(hi, q);
  }
  const float margin = 0.05f * (hi - lo) + 0.5f;
  lo = lo - margin;
  hi = hi + margin;
  float unused;
  const float vlo = skew_solve_eval<N, KT, false>(lo, mx, K, n_pos, ift, unused);
  const float vhi = skew_solve_eval<N, KT, false>(hi, mx, K, n_pos, ift, unused);
  const bool good = (vlo <= target) && (vhi >= target);
  const float tt = (target - vlo) / fmaxf(vhi - vlo, 1e-30f);
  const float x_rf = lo + tt * (hi - lo);
  lo = good ? lo : SOLVE_LO;
  hi = good ? hi : SOLVE_HI;
  float x = good ? x_rf : 0.0f;
#pragma unroll 1
  for (int it = 0;; ++it) {
    const MixOut o = skew_eval<N, KT, true>(x, mx, K, n_pos);
    if (it == N_NEWTON) {
      ld = icdf_log_deriv(o.log_cdf, o.log_sf, o.log_pdf, ift);
      return x;
    }
    const float val = icdf_pass(o.log_cdf, o.log_sf, ift);
    const float deriv =
        ift == ISIGMOID
            ? expf((o.log_pdf - o.log_cdf) - o.log_sf)
            : expf(icdf_log_deriv(o.log_cdf, o.log_sf, o.log_pdf, ift));
    newton_step(val, deriv, target, x, lo, hi);
  }
}
"""
_FWD_ROLLED = """  if constexpr (MODE == 1) {
    float lg_;
    float root_;
    if constexpr (SKEW)
      root_ = gf_rolled_skew<N, KT>(a.x[i], mx, K, a.n_pos, a.ift, lg_);
    else
      root_ = gf_rolled_plain<N, KT>(a.x[i], mx, K, a.ift, lg_);
    a.out[i] = root_;
    a.ld[i] = lg_;
    return;
  }
"""
_FWD_UNROLLED = """  if constexpr (MODE == 1) {
    float lg_;
    float root_;
    if constexpr (SKEW) {
      root_ = skew_solve<N, KT>(a.x[i], mx, K, a.n_pos, a.ift);
      skew_density_pass<N, KT>(root_, mx, K, a.n_pos, a.ift, lg_);
    } else {
      root_ = solve<N, KT>(a.x[i], mx, K, a.ift);
      lg_ = solve_log_deriv<N, KT>(root_, mx, K, a.ift);
    }
    a.out[i] = root_;
    a.ld[i] = lg_;
    return;
  }
"""
_LAYER_FWD_RAW = {
    "fwd_body_off": {_ROW_PASS: "  a.out[i] = a.x[i] + mx.m[0];\n"
                                "  if (MODE != 2) a.ld[i] = mx.iw[0];\n"
                                "  return;\n"},
    "fwd_setup_off": {_FWD_SETUP: _FWD_FILL,
                      _FWD_SETUP_BCAST: _FWD_FILL_BCAST},
    "fwd_rolled": {r"using namespace gf;\n": _FWD_ROLLED_HELPERS,
                   _ROW_PASS: _FWD_ROLLED},
    "fwd_unrolled": {_ROW_PASS: _FWD_UNROLLED}}
# T6 (layer_prep): the solve alone as one rolled loop over one copy of the
# mixture evaluation (inv_rolled, the helper defined after the sources'
# `using namespace gf;`) or unrolled (inv_unrolled: solve), injected into
# row_pass for the plain mixture
_INV_ROLLED_HELPER = """template <int N, int KT, class M>
__device__ __forceinline__ float gf_rolled_solve(float target, const M& mx,
                                                 int K, int ift) {
  float lo, hi, x;
  solve_start<N, KT>(target, mx, K, ift, lo, hi, x);
#pragma unroll 1
  for (int it = 0; it < N_NEWTON; ++it) {
    float deriv;
    const float val = solve_eval<N, KT, true>(x, mx, K, ift, deriv);
    newton_step(val, deriv, target, x, lo, hi);
  }
  return x;
}
"""
_LAYER_PREP = {
    "inv_rolled": {r"using namespace gf;\n": _INV_ROLLED_HELPER,
                   _ROW_PASS: "  if constexpr (MODE == 2 && !SKEW) {\n"
                              "    a.out[i] = gf_rolled_solve<N, KT>(a.x[i], "
                              "mx, K, a.ift);\n    return;\n  }\n"},
    "inv_unrolled": {_ROW_PASS: "  if constexpr (MODE == 2 && !SKEW) {\n"
                                "    a.out[i] = solve<N, KT>(a.x[i], mx, K, "
                                "a.ift);\n    return;\n  }\n"}}
# the non-lazy forward kernels' register cap (layer_prep): the
# __launch_bounds__ of gf_layer_kernel and gf_layer_prep_kernel, their
# minimum of blocks per SM made n (with fwd_bounds_n for the raw broadcast
# kernel)
_PREP_BOUNDS = re.compile(r"(__launch_bounds__\(128(?:, [^()]*)?\))"
                          r"(?=\s*(?:gf_layer_kernel|gf_layer_prep_kernel)\()")
# the raw broadcast forward kernel's register cap: the __launch_bounds__ of
# gf_layer_bcast_kernel where the sources have it, else of gf_layer_kernel
# (before the redesign one kernel for every non-lazy call), its minimum of
# blocks per SM made n
_FWD_BOUNDS = (re.compile(r"(__launch_bounds__\(128(?:, [^()]*)?\))"
                          r"(?=\s*gf_layer_bcast_kernel\()"),
               re.compile(r"(__launch_bounds__\(128(?:, [^()]*)?\))"
                          r"(?=\s*gf_layer_kernel\()"))
_FWD_BOUNDS_MIN = (2, 3, 4, 5, 6)
_BOTH = ("gf_block", "gf_block_bwd")
# part -> variant -> (the switches on, the libraries built); a variant
# whose switch the sources do not have is left out (perm_grid)
VARIANTS = {
    "lazy2": {"as_built": ((), ("gf_block", "gf_block_bwd")),
              "products_off": (tuple(_OFF), ("gf_block", "gf_block_bwd")),
              "dh_off": (("dh_product",), ("gf_block_bwd",)),
              "gw_off": (("gw_product",), ("gf_block_bwd",))},
    "perm": {"as_built": ((), ("gf_block_bwd",)),
             "flush_off": (("perm_flush",), ("gf_block_bwd",))},
    "perm_fwd": {"as_built": ((), ("gf_block",)),
                 "body_off": (("perm_body",), ("gf_block",)),
                 "tile_grid": (("perm_grid",), ("gf_block",)),
                 "body_off_tile_grid": (("perm_body", "perm_grid"),
                                        ("gf_block",))},
    "layer_lazy": {"as_built": ((), ("gf_layer", "gf_layer_bwd")),
                   "product_off": (("layer_product",),
                                   ("gf_layer", "gf_layer_bwd")),
                   "flush_off": (("layer_flush",), ("gf_layer_bwd",))},
    "layer_raw": {"as_built": ((), ("gf_layer", "gf_layer_bwd")),
                  **{name: ((name,), ("gf_layer_bwd",))
                     for name in ("raw_flush", "raw_adjoint", "factors_off",
                                  *(f"bounds_{b}" for b in _BOUNDS_MIN))}},
    "layer_fwd_raw": {"as_built": ((), ("gf_layer",)),
                      **{name: ((name,), ("gf_layer",))
                         for name in (*_LAYER_FWD_RAW,
                                      *(f"fwd_bounds_{b}"
                                        for b in _FWD_BOUNDS_MIN))}},
    "layer_prep": {"as_built": ((), ("gf_layer",)),
                   **{name: ((name,), ("gf_layer",))
                      for name in ("fwd_body_off", "fwd_setup_off",
                                   *_LAYER_PREP)},
                   **{f"bounds_{b}": ((f"fwd_bounds_{b}", f"prep_bounds_{b}"),
                                      ("gf_layer",))
                      for b in _FWD_BOUNDS_MIN}},
    "block_lazy": {"as_built": ((), _BOTH),
                   "product_off": (("block_lazy_product",), _BOTH),
                   "flush_off": (("block_lazy_flush",), ("gf_block_bwd",)),
                   "slabs_32": (("lazy_slabs_32",), _BOTH),
                   "dh_global": (("lazy_dh_global",), ("gf_block_bwd",))},
    "sass": {"as_built": ((), _BOTH + ("gf_layer", "gf_layer_bwd"))},
    "bits": {"as_built": ((), _BOTH + ("gf_layer", "gf_layer_bwd"))},
}


def _switches(src_dir, part):
    """Insert each switch's body into a copy of the sources; raises unless
    the part's switches are there: for lazy2, perm and perm_fwd every
    product once, the perm flush at least once and the perm forward's
    layer loops at least once each; for layer_lazy the layer product and
    the layer flush.  Returns the switches found."""
    found = []
    for path in src_dir.iterdir():
        text = path.read_text()
        cases = [(name, r"__device__ void " + name + r"\([^)]*\)\s*\{\n",
                  body) for name, body in _OFF.items()] + \
            [("perm_flush", head + r"\([^)]*\)\s*\{\n", body)
             for head, body in _PERM_FLUSH.items()] + \
            [("layer_product", head, body)
             for head, body in _LAYER_PRODUCT.items()] + \
            [("layer_flush", head, body)
             for head, body in _LAYER_FLUSH.items()] + \
            [(switch, head, body) for switch, heads in
             (*_BLOCK_LAZY.items(), *_LAYER_RAW.items(),
              *_LAYER_FWD_RAW.items(), *_LAYER_PREP.items())
             for head, body in heads.items()]
        m = _BOUNDS.search(text)
        if m:
            text = "".join(
                f"#{'el' if i else ''}if defined(GF_OFF_bounds_{b})\n"
                f"#define GF_BCAST_MIN_BLOCKS {b}\n"
                for i, b in enumerate(_BOUNDS_MIN)) + \
                f"#else\n#define GF_BCAST_MIN_BLOCKS {m.group(1)}\n#endif\n" \
                + _BOUNDS.sub(r"__launch_bounds__(128, GF_BCAST_MIN_BLOCKS)\2",
                              text)
            found += [f"bounds_{b}" for b in _BOUNDS_MIN]
        if path.name == "gf_layer.cu" and _PREP_BOUNDS.search(text):
            text = "".join(
                f"#{'el' if i else ''}if defined(GF_OFF_prep_bounds_{b})\n"
                f"#define GF_PREP_MIN_BLOCKS {b}\n"
                for i, b in enumerate(_FWD_BOUNDS_MIN)) + "#endif\n" + \
                _PREP_BOUNDS.sub(lambda m: "\n#ifdef GF_PREP_MIN_BLOCKS\n"
                                 "__launch_bounds__(128, GF_PREP_MIN_BLOCKS)\n"
                                 f"#else\n{m.group(1)}\n#endif\n", text)
            found += [f"prep_bounds_{b}" for b in _FWD_BOUNDS_MIN]
        if path.name == "gf_layer.cu":
            pat = next((b for b in _FWD_BOUNDS if b.search(text)), None)
            if pat is not None:
                text = "".join(
                    f"#{'el' if i else ''}if defined(GF_OFF_fwd_bounds_{b})"
                    f"\n#define GF_FWD_MIN_BLOCKS {b}\n"
                    for i, b in enumerate(_FWD_BOUNDS_MIN)) + "#endif\n" + \
                    pat.sub(lambda m: "\n#ifdef GF_FWD_MIN_BLOCKS\n"
                            "__launch_bounds__(128, GF_FWD_MIN_BLOCKS)\n"
                            f"#else\n{m.group(1)}\n#endif\n", text, count=1)
                found += [f"fwd_bounds_{b}" for b in _FWD_BOUNDS_MIN]
        if path.name == "gf_block.cu":
            cases += [("perm_body", head, "break;\n") for head in _PERM_BODY]
            cases += [("perm_grid", _PERM_GRID, "  return n_tiles;\n")]
        for switch, head, body in cases:
            pat = re.compile("(" + head + ")")
            text, n = pat.subn(lambda m: m.group(1) + f"#ifdef GF_OFF_{switch}"
                               f"\n{body}#endif\n", text)
            found += [switch] * n
        path.write_text(text)
    if part in ("sass", "bits"):
        pass
    elif part == "block_lazy":
        if "block_lazy_product" not in found or \
                "block_lazy_flush" not in found:
            raise RuntimeError(f"switches found {found}, expected the "
                               "block lazy product and flush")
    elif part == "layer_raw":
        if "raw_flush" not in found or "raw_adjoint" not in found:
            raise RuntimeError(f"switches found {found}, expected the raw "
                               "flush and the raw adjoint")
    elif part == "layer_fwd_raw":
        missing = [n for n in _LAYER_FWD_RAW if n not in found]
        if missing or "fwd_bounds_2" not in found:
            raise RuntimeError(f"switches found {found}, expected "
                               f"{sorted(_LAYER_FWD_RAW)} and the forward's "
                               "launch bounds")
    elif part == "layer_prep":
        missing = [n for n in ("fwd_body_off", "fwd_setup_off", *_LAYER_PREP,
                               "prep_bounds_2") if n not in found]
        if missing:
            raise RuntimeError(f"switches found {found}, missing {missing}")
    elif part == "layer_lazy":
        if "layer_product" not in found or "layer_flush" not in found:
            raise RuntimeError(f"switches found {found}, expected the "
                               "layer product and the layer flush")
    elif sorted(f for f in found if f in _OFF) != sorted(_OFF) or \
            "perm_flush" not in found or found.count("perm_body") < 2:
        raise RuntimeError(f"switches found {found}, expected each of "
                           f"{sorted(_OFF)} once, perm_flush and both "
                           "perm forward layer loops")
    return set(found)


def build(part, trees, variants=None):
    """{(tree, variant, library): path} of the builds of every source tree
    in ``trees`` (a dict label -> csrc directory), all nvcc processes at
    once, and {tree: the -Xptxas -v report of its as-built libraries}
    (also written to ptxas.txt beside each tree's copy; layer_raw also
    {(tree, variant): each variant's report}).  ``variants``: the part's
    variants to build (default all)."""
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for i, (tree, csrc) in enumerate(trees.items()):
        src = OUT / f"tree{i}" / "csrc"
        shutil.copytree(csrc, src)
        found = _switches(src, part)
        # a requested "a+b" combines the switches of the part's variants a
        # and b (their libraries the union)
        table = dict(VARIANTS[part])
        for combo in (v for v in variants or () if "+" in v):
            parts = [VARIANTS[part][v] for v in combo.split("+")]
            table[combo] = (tuple(o for off, _ in parts for o in off),
                            tuple(sorted({lb for _, libs in parts
                                          for lb in libs})))
        for variant, (off, libs) in table.items():
            if not set(off) <= found or (variants and
                                         variant not in variants):
                continue
            extra = [f"-DGF_OFF_{name}" for name in off]
            flags = [f for f in cuda_build.NVCC_FLAGS
                     if variant == "as_built" or
                     part in ("layer_raw", "layer_fwd_raw", "layer_prep") or
                     f not in ("-Xptxas", "-v")]
            for lib in libs:
                out = src.parent / f"lib{lib}_{variant}.so"
                procs[(tree, variant, lib)] = (out, subprocess.Popen(
                    [cuda_build.nvcc_path(), *flags, *extra, "-I", str(src),
                     "-o", str(out), str(src / f"{lib}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
    paths, report = {}, collections.defaultdict(str)
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        paths[key] = out
        report[key[:2]] += err
        if key[1] == "as_built":
            report[key[0]] += err
            with open(out.parent / "ptxas.txt", "a") as f:
                f.write(err)
    return paths, report


# the perm kernels' mangled names: the backward gf_block_bwd_kernel<KIND,
# MODE = 0, ...>; the forward gf_block_{density,sample}_kernel<MODE = 0,
# KT, DT> before the perm redesign, gf_block_perm_kernel<SAMPLE, KT, DT>
# after it
_PERM_KERNELS = (
    (r"gf_block_bwd_kernelILi(\d)ELi0ELb\dELi(\d+)E",
     lambda m: ("density_bwd_perm", "sample_bwd_perm",
                "nll_perm")[int(m.group(1))]),
    (r"gf_block_(density|sample)_kernelILi0ELi(\d+)E",
     lambda m: f"{m.group(1)}_perm"),
    (r"gf_block_perm_kernelILb(\d)ELi(\d+)E",
     lambda m: ("density_perm", "sample_perm")[int(m.group(1))]))


def _perm_kernel(name):
    """(counter name, shape) of a perm kernel's mangled name, or None."""
    for pat, kernel in _PERM_KERNELS:
        m = re.search(pat, name)
        if m:
            return kernel(m), ("K=10, d=4" if m.group(2) == "10"
                               else "generic")
    return None


def perm_ptxas(report):
    """{kernel: "registers, stack, spills"} of the perm kernels in an
    -Xptxas -v report."""
    out = {}
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        which = _perm_kernel(name)
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        if which and regs and spill:
            out[f"{which[0]} ({which[1]})"] = (
                f"{regs.group(1)} registers, stack {spill.group(1)} B, spill "
                f"stores {spill.group(2)} B, loads {spill.group(3)} B")
    return out


# the per-layer lazy kernels' mangled names: gf_layer_kernel<LAZY = true,
# SKEW, MODE, KT>, gf_layer_bwd_kernel<LAZY = true, SKEW, SAMPLE, KT>
_LAYER_KERNELS = (
    (r"gf_layer_kernelILb1ELb(\d)ELi(\d)ELi(\d+)E",
     lambda m: ("forward_lazy", "sample_lazy")[int(m.group(2))]),
    (r"gf_layer_bwd_kernelILb1ELb(\d)ELb(\d)ELi(\d+)E",
     lambda m: ("forward_bwd_lazy", "sample_bwd_lazy")[int(m.group(2))]))


def layer_ptxas(report):
    """{kernel: "registers, stack, spills"} of the per-layer lazy kernels
    in an -Xptxas -v report (skewed or not, K = 10 or generic)."""
    out = {}
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        for pat, kernel in _LAYER_KERNELS:
            m = re.search(pat, name)
            if m and regs and spill:
                shape = "K=10" if m.group(3) == "10" else "generic"
                skew = ", skewed" if m.group(1) == "1" else ""
                out[f"{kernel(m)} ({shape}{skew})"] = (
                    f"{regs.group(1)} registers, stack {spill.group(1)} B, "
                    f"spill stores {spill.group(2)} B, loads "
                    f"{spill.group(3)} B")
    return out


# the per-layer raw backward's mangled names: gf_layer_bcast_bwd_kernel<
# SKEW, SAMPLE, KT> (raw broadcast, after the redesign), gf_layer_bwd_kernel<
# LAZY = false, SKEW, SAMPLE, KT> (raw broadcast and per row before it, per
# row after it)
_LAYER_RAW_KERNELS = (
    (r"gf_layer_bcast_bwd_kernelILb(\d)ELb(\d)ELi(\d+)E", "broadcast"),
    (r"gf_layer_bwd_kernelILb0ELb(\d)ELb(\d)ELi(\d+)E", "raw"))


def layer_raw_ptxas(report):
    """{kernel: "registers, stack, spills"} of the per-layer raw backward
    kernels in an -Xptxas -v report (the broadcast kernel of the redesign,
    and the raw kernel that before it took broadcast slabs too)."""
    out = {}
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        for pat, form in _LAYER_RAW_KERNELS:
            m = re.search(pat, name)
            if m and regs and spill:
                kernel = ("forward_bwd_raw", "sample_bwd_raw")[int(m.group(2))]
                shape = "K=10" if m.group(3) == "10" else "generic"
                skew = ", skewed" if m.group(1) == "1" else ""
                out[f"{kernel} {form} ({shape}{skew})"] = (
                    f"{regs.group(1)} registers, stack {spill.group(1)} B, "
                    f"spill stores {spill.group(2)} B, loads "
                    f"{spill.group(3)} B")
    return out


# T4 / T5 with raw broadcast slabs: gf_layer_bcast_kernel<SKEW, MODE, KT>
# after the redesign, gf_layer_kernel<LAZY = false, SKEW, MODE, KT> (every
# non-lazy call) before it
_LAYER_FWD_RAW_KERNELS = (r"gf_layer_bcast_kernelILb(\d)ELi([01])ELi(\d+)E",
                          r"gf_layer_kernelILb0ELb(\d)ELi([01])ELi(\d+)E")


def _layer_fwd_raw_kernel(name, bcast=True):
    """The label of a T4 / T5 raw broadcast kernel's mangled name (forward
    or sample, K = 10 or generic, skewed or plain), or None; ``bcast``:
    the sources have the broadcast kernel (their gf_layer_kernel no longer
    takes broadcast slabs)."""
    for pat in _LAYER_FWD_RAW_KERNELS[:1] if bcast else \
            _LAYER_FWD_RAW_KERNELS[1:]:
        m = re.search(pat, name)
        if m:
            return (f"{('forward_raw', 'sample_raw')[int(m.group(2))]} "
                    f"({'K=10' if m.group(3) == '10' else 'generic'}"
                    f"{', skewed' if m.group(1) == '1' else ''})")
    return None


def layer_fwd_raw_ptxas(report):
    """{kernel: "registers, stack, spills"} of the T4 / T5 raw broadcast
    kernels in an -Xptxas -v report."""
    out = {}
    bcast = "gf_layer_bcast_kernel" in report
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        which = _layer_fwd_raw_kernel(name, bcast)
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        if which and regs and spill:
            out[which] = (f"{regs.group(1)} registers, stack {spill.group(1)} "
                          f"B, spill stores {spill.group(2)} B, loads "
                          f"{spill.group(3)} B")
    return out


# T4 / T6 prepared and T6 raw (layer_prep): gf_layer_prep_kernel<MODE, KT>
# and gf_layer_bcast_kernel<SKEW = false, MODE = 2, KT> (broadcast, after
# the redesign), gf_layer_kernel<LAZY = false, SKEW = false, MODE, KT>
# (per row; before the redesign every such call)
_LAYER_PREP_KERNELS = (
    (r"gf_layer_prep_kernelILi([02])ELi(\d+)E", "{}_prepared broadcast"),
    (r"gf_layer_bcast_kernelILb0ELi(2)ELi(\d+)E", "{}_raw broadcast"),
    (r"gf_layer_kernelILb0ELb0ELi([02])ELi(\d+)E", "{} one block per tile"))


def _layer_prep_kernel(name):
    """The label of a layer_prep kernel's mangled name, or None."""
    for pat, label in _LAYER_PREP_KERNELS:
        m = re.search(pat, name)
        if m:
            mode = ("forward", "sample", "inverse")[int(m.group(1))]
            return (f"{label.format(mode)} "
                    f"({'K=10' if m.group(2) == '10' else 'generic'})")
    return None


def layer_prep_ptxas(report):
    """{kernel: "registers, stack, spills"} of the layer_prep kernels in an
    -Xptxas -v report."""
    out = {}
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        which = _layer_prep_kernel(name)
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        if which and regs and spill:
            out[which] = (f"{regs.group(1)} registers, stack {spill.group(1)} "
                          f"B, spill stores {spill.group(2)} B, loads "
                          f"{spill.group(3)} B")
    return out


def _blocks_from_registers(ptxas_line, threads=128):
    """Resident blocks per SM that a kernel's registers allow (65,536 a SM,
    allocated per warp in units of 256, 16 blocks of 128 threads at
    most)."""
    regs = int(ptxas_line.split()[0])
    per_warp = -(-regs * 32 // 256) * 256
    return min(65536 // per_warp // (threads // 32), 2048 // threads)


# the block's lazy-mode kernels' mangled names: gf_block_density_kernel /
# gf_block_sample_kernel<MODE = 2, KT, DT>, gf_block_bwd_kernel<KIND, MODE
# = 2, DHG, KT, DT>
_BLOCK_LAZY_KERNELS = (
    (r"gf_block_(density|sample)_kernelILi2ELi(\d+)E",
     lambda m: f"{m.group(1)}_lazyh"),
    (r"gf_block_bwd_kernelILi(\d)ELi2ELb\dELi(\d+)E",
     lambda m: ("density_bwd_lazyh", "sample_bwd_lazyh")[int(m.group(1))]))


def _block_lazy_kernel(name):
    """(counter name, shape) of a lazy-mode block kernel's mangled name
    (a dh-in-scratch instance of the backward gets " dh global"), or
    None."""
    for pat, kernel in _BLOCK_LAZY_KERNELS:
        m = re.search(pat, name)
        if m:
            shape = "K=10, d=4" if m.group(2) == "10" else "generic"
            if "bwd" in pat and re.search(r"ELi2ELb1E", name):
                shape += ", dh global"
            return kernel(m), shape
    return None


def block_lazy_ptxas(report):
    """{kernel: "registers, stack, spills"} of the block's lazy-mode
    kernels in an -Xptxas -v report."""
    out = {}
    for name, body in re.findall(r"Function properties for (\S+)\n(.*?)"
                                 r"(?=ptxas info\s+: Compil|\Z)", report, re.S):
        which = _block_lazy_kernel(name)
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        if which and regs and spill:
            out[f"{which[0]} ({which[1]})"] = (
                f"{regs.group(1)} registers, stack {spill.group(1)} B, spill "
                f"stores {spill.group(2)} B, loads {spill.group(3)} B")
    return out


def block_lazy_hmma(libs):
    """{kernel: TF32 HMMA instructions} of the block's lazy-mode kernels in
    the SASS (cuobjdump -sass) of the built libraries ``libs``."""
    tool = pathlib.Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    out = {}
    for lib in libs:
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=600).stdout
        for fn, body in re.findall(r"Function : (\S+)\n(.*?)"
                                   r"(?=Function : |\Z)", sass, re.S):
            which = _block_lazy_kernel(fn)
            if which:
                out[f"{which[0]} ({which[1]})"] = len(
                    re.findall(r"HMMA\.\S*TF32", body))
    return out


# SASS instruction classes counted in the perm forward kernels
_SASS_OPS = ("MUFU.EX2", "MUFU.LG2", "MUFU.RCP", "MUFU.RSQ", "MUFU.SQRT",
             "FFMA", "FMUL", "FADD", "FCHK", "CALL", "LDS", "LDL", "STL")


def perm_fwd_sass(lib, label=None):
    """{kernel: {instruction class: count}} of the perm forward kernels (or
    of the kernels ``label`` names: mangled name -> label or None) in the
    SASS of a built library (cuobjdump -sass)."""
    tool = pathlib.Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                               sass, re.S):
        if label is None:
            which = _perm_kernel(fn)
            if which is None or which[0] not in ("density_perm",
                                                 "sample_perm"):
                continue
            which = f"{which[0]} ({which[1]})"
        else:
            which = label(fn)
            if which is None:
                continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         body)
        counts = {op: sum(1 for o in ops if o == op or o.startswith(op + "."))
                  for op in _SASS_OPS}
        counts["instructions"] = len(ops)
        out[which] = counts
    return out


def _sass_functions(lib):
    """{mangled function name: [instructions]} of a built library's SASS,
    addresses and immediates masked (0x...: branch targets, constants,
    constant-bank offsets)."""
    tool = pathlib.Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                               sass, re.S):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
        # the anonymous namespace's name carries a hash of the source
        fn = re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                    "_ZN_anon_", fn)
        out[fn] = [re.sub(r"0x[0-9a-fA-F]+", "0x#", " ".join(o.split()))
                   for o in ops]
    return out


def sass_compare(paths, trees):
    """{tree: {library: {"identical": n, "differ": {function: differing
    instructions}, "only_here": [...], "only_first": [...]}}} of every tree
    against the first one's SASS."""
    first, *rest = trees
    out = {}
    for tree in rest:
        res = {}
        for lib in VARIANTS["sass"]["as_built"][1]:
            a = _sass_functions(paths[(first, "as_built", lib)])
            b = _sass_functions(paths[(tree, "as_built", lib)])
            differ = {}
            for fn in sorted(a.keys() & b.keys()):
                if a[fn] != b[fn]:
                    n = sum(x != y for x, y in zip(a[fn], b[fn]))
                    differ[fn] = n + abs(len(a[fn]) - len(b[fn]))
            res[lib] = {"identical": len(a.keys() & b.keys()) - len(differ),
                        "differ": differ,
                        "only_here": sorted(b.keys() - a.keys()),
                        "only_first": sorted(a.keys() - b.keys())}
        out[tree] = res
    return out


def _ms(fn, reps=10):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _ms_back_to_back(fn, n=10):
    """ms of one of n launches made back to back between two events: the
    host's time to issue a launch hides behind the kernels before it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _perm_case(gb, p, dev, g, n_sm):
    """The perm backward kernels (T2 both bodies, T3) on block 0 at
    262,144 rows: run(handle) times each at the grid of two blocks per SM
    and at the occupancy API's blocks per SM x SMs, and at the latter as
    one of 10 launches back to back; returns ({name: ms}, {name: blocks
    per SM})."""
    import torch
    prep, meta = p._block_meta[0]
    pvec = p.init_params(seed=0)["flow_0"]
    pvec = pvec + 0.1 * torch.randn(pvec.shape, generator=g, device=dev)
    x = 0.8 * torch.randn((1 << 18, 4), generator=g, device=dev)
    y = gb.block_plain("sample", x, (pvec,), prep, meta, "perm")[0]
    g_out = torch.randn(x.shape, generator=g, device=dev)
    g_ld = torch.randn(x.shape, generator=g, device=dev)
    n_tiles = (x.shape[0] + 127) // 128

    def run(handle):
        times, occ = {}, {}
        choose = handle.gf_block_bwd_blocks
        for kind in ("density", "sample", "nll"):
            name = "nll_perm" if kind == "nll" else f"{kind}_bwd_perm"
            occ[name] = gb.kernel_occupancy(name, prep, meta)[0]
            arg = y if kind == "sample" else x
            fn = (lambda kind=kind, arg=arg: gb._launch_bwd(
                kind, arg, (pvec,), None if kind == "nll" else g_out,
                None if kind == "nll" else g_ld, prep, meta, "perm",
                1.0 / x.shape[0], -1.0 / x.shape[0]))
            for grid, per_sm in (("2 per SM", 2), ("occupancy", occ[name])):
                handle.gf_block_bwd_blocks = (
                    lambda *a, b=min(n_tiles, per_sm * n_sm): b)
                times[f"{name} grid {grid}"] = _ms(fn)
            times[f"{name} grid occupancy (10 back to back)"] = \
                _ms_back_to_back(fn)
        handle.gf_block_bwd_blocks = choose
        return times, occ

    return run


def _perm_fwd_case(gb, p, dev, g):
    """The T1 perm forward kernels on block 0 at 1,048,576 rows: run(variant)
    times each; returns ({name: ms}, {name: blocks per SM})."""
    import torch
    prep, meta = p._block_meta[0]
    pvec = p.init_params(seed=0)["flow_0"]
    x = 0.8 * torch.randn((1 << 20, 4), generator=g, device=dev)
    z = torch.randn((1 << 20, 4), generator=g, device=dev)

    def run(variant):
        times, occ = {}, {}
        for d, arg in (("density", x), ("sample", z)):
            occ[f"{d}_perm"] = gb.kernel_occupancy(f"{d}_perm", prep, meta)[0]
            fn = lambda: gb._launch(arg, (pvec,), prep, meta, "perm", d)
            times[f"{d}_perm {variant}"] = _ms(fn)
            times[f"{d}_perm {variant} (10 back to back)"] = \
                _ms_back_to_back(fn)
        return times, occ

    return run


def _lazy2_case(gb, p, dev, g):
    """The flagship's lazy2 block 2 (and T1 perm beside it): run(lib,
    variant) times the kernels of library ``lib`` (the backward kernels
    also as one of 10 launches back to back); returns {name: ms}."""
    import torch
    prep, meta = p._block_meta[2]
    prep0, meta0 = p._block_meta[0]
    mlp = p.mlp_predictors[2]
    flat = p.init_params(seed=0)["mlp_2"]
    flat = flat + 0.02 * torch.randn(flat.shape, generator=g, device=dev)
    w1, b1 = mlp.first_layer_weights(flat)
    w, b = mlp.final_layer_weights(flat)
    pvec = p.init_params(seed=0)["flow_0"]

    def inputs(n):
        return (0.8 * torch.randn((n, 4), generator=g, device=dev),
                (torch.randn((n, mlp.input_dim), generator=g, device=dev),
                 w1.contiguous(), b1.contiguous(), w.contiguous(),
                 b.contiguous()))

    x1, par1 = inputs(1 << 20)
    x2, par2 = inputs(1 << 18)
    g_out = torch.randn(x2.shape, generator=g, device=dev)
    g_ld = torch.randn(x2.shape, generator=g, device=dev)

    def run(lib, variant):
        times = {}
        if lib == "gf_block":
            for d in ("density", "sample"):
                times[f"{d}_lazy2 {variant}"] = _ms(
                    lambda: gb._launch(x1, par1, prep, meta, "lazy2", d))
                if variant == "as_built":
                    times[f"{d}_perm"] = _ms(lambda: gb._launch(
                        x1, (pvec,), prep0, meta0, "perm", d))
        else:
            for kind in ("density", "sample", "nll"):
                name = "nll_lazy2" if kind == "nll" else f"{kind}_bwd_lazy2"
                fn = (lambda kind=kind: gb._launch_bwd(
                    kind, x2, par2, None if kind == "nll" else g_out,
                    None if kind == "nll" else g_ld, prep, meta, "lazy2",
                    1.0 / x2.shape[0], -1.0 / x2.shape[0]))
                times[f"{name} {variant}"] = _ms(fn)
                times[f"{name} {variant} (10 back to back)"] = \
                    _ms_back_to_back(fn)
        return times

    return run


def _block_lazy_case(gb, dev, g, n_fwd=1 << 20, n_bwd=1 << 18):
    """The block's lazy mode on the "64-64" flagship's block 2 (K = 10,
    d = 4, P = 548, H = 64), its MLP jittered by 0.02 N(0, 1), hidden rows
    made by the MLP from a random summary: T1 on n_fwd rows, T2 on the
    first n_bwd of them (the sample body at the plain sample's output)
    with cotangents from ``g``.  run(lib, variant) times the kernels of
    library ``lib`` single and as one of 10 launches back to back;
    yardsticks() times, on the same inputs, the P x H products alone as
    torch.matmul at "highest" precision; blocks(variant) gives each
    kernel's blocks per SM.  Returns (run, yardsticks, blocks, shapes)."""
    import torch
    from .. import pdf
    p = pdf("e4+s2+e4", "gggg+f+gggg", amortization_mlp_dims="64-64",
            device=dev)
    prep, meta = p._block_meta[2]
    mlp = p.mlp_predictors[2]
    flat = p.init_params(seed=0)["mlp_2"]
    flat = flat + 0.02 * torch.randn(flat.shape, generator=g, device=dev)
    w, b = (t.contiguous() for t in mlp.final_layer_weights(flat))
    summary = torch.randn((n_fwd, mlp.input_dim), generator=g, device=dev)
    hidden = mlp.apply_penultimate(flat, summary).contiguous()
    del summary
    x = 0.8 * torch.randn((n_fwd, 4), generator=g, device=dev)
    z = torch.randn((n_fwd, 4), generator=g, device=dev)
    par = (hidden, w, b)
    par2 = (hidden[:n_bwd].contiguous(), w, b)
    x2 = x[:n_bwd].contiguous()
    y2 = gb.block_plain("sample", z[:n_bwd].contiguous(), par2, prep, meta,
                        "lazy")[0]
    g_out = torch.randn(x2.shape, generator=g, device=dev)
    g_ld = torch.randn(x2.shape, generator=g, device=dev)
    hid = w.shape[1]

    def cases(lib):
        if lib == "gf_block":
            for d, arg in (("density", x), ("sample", z)):
                yield f"{d}_lazyh", lambda: gb._launch(arg, par, prep, meta,
                                                       "lazy", d)
        else:
            for d, arg in (("density", x2), ("sample", y2)):
                yield f"{d}_bwd_lazyh", lambda: gb._launch_bwd(
                    d, arg, par2, g_out, g_ld, prep, meta, "lazy")

    def run(lib, variant):
        times = {}
        for name, fn in cases(lib):
            times[f"{name} {variant}"] = _ms(fn)
            times[f"{name} {variant} (10 back to back)"] = \
                _ms_back_to_back(fn)
        return times

    def yardsticks():
        torch.set_float32_matmul_precision("highest")
        dp = torch.randn((n_bwd, w.shape[0]), generator=g, device=dev)
        times = {
            "lazyh forward: product alone (torch.matmul)":
                _ms(lambda: torch.matmul(hidden, w.T)),
            "lazyh backward: products dh, gw alone (torch.matmul)":
                _ms(lambda: (torch.matmul(dp, w),
                             torch.matmul(dp.T, par2[0])))}
        del dp
        return times

    def blocks(lib):
        names = (("density_lazyh", "sample_lazyh") if lib == "gf_block"
                 else ("density_bwd_lazyh", "sample_bwd_lazyh"))
        return {n: list(gb.kernel_occupancy(n, prep, meta, hid))
                for n in names}

    shapes = {"K": meta[0], "d": meta[1], "P": w.shape[0], "H": hid,
              "rows_forward": n_fwd, "rows_backward": n_bwd}
    return run, yardsticks, blocks, shapes


# the per-layer lazy kernels each layer_lazy variant changes
_VARIANT_KERNELS = {
    "product_off": ("forward_lazy", "sample_lazy", "forward_bwd_lazy",
                    "sample_bwd_lazy"),
    "flush_off": ("forward_bwd_lazy", "sample_bwd_lazy")}


def layer_occupancy(handle, lib, shapes):
    """{kernel: [blocks per SM, threads, dynamic shared memory bytes]} of
    the skewed per-layer lazy kernels at ``shapes``, from the library's
    occupancy query (the CUDA occupancy API), where the sources have one;
    {} where they do not."""
    fn = getattr(handle, f"{lib}_occupancy", None)
    if fn is None:
        return {}
    i = ctypes.c_int
    fn.argtypes = [i, i, i, i, i, i, i, ctypes.c_void_p]
    fn.restype = i
    k, d, hid = shapes["K"], shapes["d"], shapes["H"]
    n_groups = shapes["P"] // (k * d)
    names = (("forward_lazy", "sample_lazy") if lib == "gf_layer"
             else ("forward_bwd_lazy", "sample_bwd_lazy"))
    out = {}
    for mode, name in enumerate(names):
        res = (ctypes.c_int * 3)()
        if fn(mode, 1, 1, k, d, hid, n_groups, res) == 0:
            out[name] = list(res)
    return out


def materialized_route(gl, mode, x, params, ift, prep, kd, cts=None):
    """A yardstick the port never calls: a lazy call's function (``gl`` the
    per-layer wrapper module; mode forward / sample, cts the T7 body's
    cotangents or None for T4 / T5) through the materialized route: the
    rows b + w . hidden as torch.matmul into per-row (K, d, B) slabs
    (``gl._lazy_slabs``), then the raw per-row kernel; T7: the raw per-row
    backward, then ghidden = dp . w and gw = dp^T . hidden as two matmuls
    and gb as a sum.  Returns the route as a function of no arguments."""
    import torch
    hidden, w, b = params

    def route():
        slabs = gl._lazy_slabs(hidden, w, b, kd)
        if cts is None:
            return gl._launch(mode, "raw", x, slabs, ift, prep, None)
        _, gs = gl._launch_bwd(mode, "raw", x, slabs, *cts, ift, prep, None)
        gp = torch.stack(gs).view(-1, x.shape[0])
        return (torch.matmul(gp.T, w), torch.matmul(gp, hidden),
                gp.sum(dim=1))

    return route


def _layer_lazy_case(gl, p, params, dev, g, n_fwd=1 << 20, n_bwd=1 << 18):
    """The skewed flagship's per-layer lazy kernels at their own shapes
    (block 2, layer 0: K = 10, d = 4, four parameter groups, P = 160,
    H = 128): its forward_lazy / sample_lazy call in ``log_prob`` /
    ``sample`` at 1,048,576 rows, recorded with its inputs; T7's two bodies on the first
    262,144 rows of those (the density body at log_prob's input, the
    sample body at the sample call's roots) with cotangents from ``g``.
    run(variant) times each kernel single and as one of 10 launches back
    to back; yardsticks() times, on the same inputs, the P x H product
    alone as ``torch.matmul(hidden, w.T) + b`` and the materialized route
    (``materialized_route``).  Returns (run, yardsticks, shapes)."""
    import torch
    calls = {}
    run_layer = gl._run

    def record(mode, iface, x, ps, ift, prep, kd):
        if iface == "lazy":
            calls.setdefault(mode, []).append(
                (x.clone(), tuple(t.clone() for t in ps), ift, prep, kd))
        return run_layer(mode, iface, x, ps, ift, prep, kd)

    gl._run = record
    try:
        with torch.no_grad():
            xs = p.sample(params, samplesize=n_fwd, generator=g)[0]
            p.log_prob(params, xs)
    finally:
        gl._run = run_layer
    del xs
    n_b = n_bwd
    # layer 0 of block 2: the sample direction's first lazy call; log_prob
    # runs the block's layers in reverse, so its call of the same w
    z_s, par_s, ift_s, prep_s, kd = calls["sample"][0]
    x_f, par_f, ift_f, prep_f, _ = next(
        c for c in calls["forward"] if torch.equal(c[1][1], par_s[1]))
    del calls
    root = gl._launch("sample", "lazy", z_s, par_s, ift_s, prep_s, kd)[0]
    bwd = {"forward": (x_f[:n_b].contiguous(),
                       (par_f[0][:n_b].contiguous(), *par_f[1:]), ift_f,
                       prep_f),
           "sample": (root[:n_b].contiguous(),
                      (par_s[0][:n_b].contiguous(), *par_s[1:]), ift_s,
                      prep_s)}
    g1 = torch.randn((n_b, kd[1]), generator=g, device=dev)
    g2 = torch.randn((n_b, kd[1]), generator=g, device=dev)
    fwd = {"forward": (x_f, par_f, ift_f, prep_f),
           "sample": (z_s, par_s, ift_s, prep_s)}

    def cases():
        for mode, (x, ps, ift, prep) in fwd.items():
            yield f"{mode}_lazy", lambda: gl._launch(mode, "lazy", x, ps,
                                                     ift, prep, kd)
        for body, (x, ps, ift, prep) in bwd.items():
            yield f"{body}_bwd_lazy", lambda: gl._launch_bwd(
                body, "lazy", x, ps, g1, g2, ift, prep, kd)

    def run(variant):
        times = {}
        for name, fn in cases():
            times[f"{name} {variant}"] = _ms(fn)
            times[f"{name} {variant} (10 back to back)"] = \
                _ms_back_to_back(fn)
        return times

    def yardsticks():
        times = {}
        for name, (x, ps, ift, prep) in list(fwd.items()) + \
                [(f"{b}_bwd", v) for b, v in bwd.items()]:
            hidden, w, b = ps
            times[f"{name}_lazy: product alone (torch.matmul)"] = _ms(
                lambda: torch.matmul(hidden, w.T) + b)
            cts = (g1, g2) if name.endswith("_bwd") else None
            times[f"{name}_lazy: materialized route (torch.matmul + raw "
                  f"per-row kernel)"] = _ms(materialized_route(
                      gl, name.split("_")[0], x, ps, ift, prep, kd, cts))
        return times

    shapes = {"K": kd[0], "d": kd[1], "P": par_f[1].shape[0],
              "H": par_f[1].shape[1], "rows_forward": x_f.shape[0],
              "rows_backward": n_b, "ift": [ift_f, ift_s]}
    return run, yardsticks, shapes


def _layer_raw_case(gl, dev, g, n=1 << 18):
    """T7 with raw broadcast slabs at the skewed flagship's block-0 layer 0
    (K = 10, d = 4, four parameter groups; its permanent parameters and
    MLPs jittered by 0.02 N(0, 1)), recorded from the model's ``sample``
    and ``log_prob`` at n rows, and the same slabs without the exponents
    (the plain mixture, three groups): the density body at the layer's
    log_prob input, the sample body at its sample call's roots, cotangents
    from ``g``.  run(variant) times the four calls single and as one of 10
    launches back to back, and as built the model's training step on its n
    sampled rows (autograd of -log_prob().mean(), median of 10; one
    ``train.fit`` Adam step, host clock, mean of 20 after a one-step fit);
    blocks() gives each call's kernel's blocks per SM and its grid on the
    libraries loaded.  Returns (run, blocks, shapes)."""
    import torch
    from .. import pdf
    p = pdf("e4+s2+e4", "gggg+f+gggg",
            options_overwrite={"g": {"add_skewness": 1}}, device=dev)
    params = {k: v + 0.02 * torch.randn(v.shape, generator=g, device=dev)
              if k.startswith("mlp_") or k == "flow_0" else v
              for k, v in p.init_params(seed=0).items()}
    calls = {}
    run_layer = gl._run

    def record(mode, iface, x, ps, ift, prep, kd):
        out = run_layer(mode, iface, x, ps, ift, prep, kd)
        if iface == "raw" and ps[0].ndim == 2:
            calls.setdefault(mode, []).append(
                (x.clone(), tuple(t.clone() for t in ps), ift, prep,
                 out[0].clone()))
        return out

    gl._run = record
    try:
        with torch.no_grad():
            xs = p.sample(params, samplesize=n, generator=g)[0]
            p.log_prob(params, xs)
    finally:
        gl._run = run_layer
    # layer 0: the sample direction's first raw call; log_prob runs the
    # block's layers in reverse, so its call of the same slabs
    _, slabs, ift, prep, root = calls["sample"][0]
    x = next(c[0] for c in calls["forward"] if torch.equal(c[1][0], slabs[0]))
    del calls
    mixes = {"skewed": (slabs, prep),
             "plain": (slabs[:-1], tuple(prep[:3]) + (None, None))}
    g1 = torch.randn(x.shape, generator=g, device=dev)
    g2 = torch.randn(x.shape, generator=g, device=dev)

    def cases():
        for mix, (ps, pr) in mixes.items():
            for body, arg in (("forward", x), ("sample", root)):
                yield f"{body}_bwd_raw ({mix})", body, arg, ps, pr

    def step():
        # the model's training step on its n sampled rows, as chip_smoke
        # times it
        from .. import train
        auto = _ms(lambda: p._value_and_grad(
            lambda pp: -p.log_prob(pp, xs)[0].mean(), params))
        train.fit(p, params, xs[:4096], num_steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train.fit(p, params, xs, num_steps=20)
        torch.cuda.synchronize()
        return {"autograd of -log_prob().mean()": auto,
                "train.fit step (host clock, mean of 20)":
                    (time.perf_counter() - t0) / 20 * 1e3}

    def run(variant):
        times = {}
        for name, body, arg, ps, pr in cases():
            fn = (lambda body=body, arg=arg, ps=ps, pr=pr: gl._launch_bwd(
                body, "raw", arg, ps, g1, g2, ift, pr, None))
            times[f"{name} {variant}"] = _ms(fn)
            times[f"{name} {variant} (10 back to back)"] = \
                _ms_back_to_back(fn)
        if variant == "as_built":
            times.update(step())
        return times

    def blocks(handle):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        occ, grid = {}, {}
        for name, body, arg, ps, pr in cases():
            ints, floats, _, n_groups, _, k = gl._kernel_args(
                "raw", arg, ps, ift, pr, None)
            occ[name] = list(gl.kernel_occupancy(
                name.split()[0], k, arg.shape[1], 0, n_groups,
                skew=pr[3] is not None))
            c_ints, _ = gl._c_arrays([int(body == "sample")] + ints, floats)
            grid[name] = handle.gf_layer_bwd_blocks(0, arg.shape[0], 0, n_sm,
                                                    n_groups * k, c_ints)
        return occ, grid

    shapes = {"K": slabs[0].shape[0], "d": slabs[0].shape[1],
              "n_groups": {m: len(ps) for m, (ps, _) in mixes.items()},
              "rows": x.shape[0], "ift": ift}
    return run, blocks, shapes


def _layer_fwd_raw_case(gl, dev, g, n=1 << 20):
    """T4 / T5 with raw broadcast slabs at the skewed flagship's block-0
    layer 0 (K = 10, d = 4, four parameter groups; its permanent
    parameters and MLPs jittered by 0.02 N(0, 1)), recorded from the
    model's ``sample`` and ``log_prob`` at n rows, and the same slabs
    without the exponents (the plain mixture, three groups): T4 at the
    layer's log_prob input, T5 at its sample call's targets.  run(variant)
    times the four calls single and as one of 10 launches back to back,
    and as built the model's ``sample`` and ``log_prob`` at n rows (median
    of 10, the libraries loaded); blocks(handle) gives each call's
    kernel's blocks per SM (the occupancy API) and grid (the sources'
    ``gf_layer_grid`` where they have one, else one block per tile).
    Returns (run, blocks, shapes)."""
    import torch
    from .. import pdf
    p = pdf("e4+s2+e4", "gggg+f+gggg",
            options_overwrite={"g": {"add_skewness": 1}}, device=dev)
    params = {k: v + 0.02 * torch.randn(v.shape, generator=g, device=dev)
              if k.startswith("mlp_") or k == "flow_0" else v
              for k, v in p.init_params(seed=0).items()}
    calls = {}
    run_layer = gl._run

    def record(mode, iface, x, ps, ift, prep, kd):
        if iface == "raw" and ps[0].ndim == 2:
            calls.setdefault(mode, []).append(
                (x.clone(), tuple(t.clone() for t in ps), ift, prep))
        return run_layer(mode, iface, x, ps, ift, prep, kd)

    gl._run = record
    try:
        with torch.no_grad():
            xs = p.sample(params, samplesize=n, generator=g)[0]
            p.log_prob(params, xs)
    finally:
        gl._run = run_layer
    # layer 0: the sample direction's first raw call; log_prob runs the
    # block's layers in reverse, so its call of the same slabs
    z, slabs, ift, prep = calls["sample"][0]
    x = next(c[0] for c in calls["forward"] if torch.equal(c[1][0], slabs[0]))
    del calls
    mixes = {"skewed": (slabs, prep),
             "plain": (slabs[:-1], tuple(prep[:3]) + (None, None))}

    def cases():
        for mix, (ps, pr) in mixes.items():
            for mode, arg in (("forward", x), ("sample", z)):
                yield f"{mode}_raw ({mix})", mode, arg, ps, pr

    def run(variant):
        times = {}
        for name, mode, arg, ps, pr in cases():
            fn = (lambda mode=mode, arg=arg, ps=ps, pr=pr: gl._launch(
                mode, "raw", arg, ps, ift, pr, None))
            times[f"{name} {variant}"] = _ms(fn)
            times[f"{name} {variant} (10 back to back)"] = \
                _ms_back_to_back(fn)
        if variant == "as_built":
            with torch.no_grad():
                times[f"skewed model sample, {n} rows"] = _ms(
                    lambda: p.sample(params, samplesize=n, generator=g))
                times[f"skewed model log_prob, {n} rows"] = _ms(
                    lambda: p.log_prob(params, xs))
        return times

    def blocks(handle):
        occ, grid = {}, {}
        for name, mode, arg, ps, pr in cases():
            ints, floats, _, n_groups, _, k = gl._kernel_args(
                "raw", arg, ps, ift, pr, None)
            occ[name] = list(gl.kernel_occupancy(
                f"{mode}_raw", k, arg.shape[1], 0, n_groups,
                skew=pr[3] is not None))
            fn = getattr(handle, "gf_layer_grid", None)
            if fn is None:
                grid[name] = (arg.shape[0] + 127) // 128
                continue
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            c_ints, _ = gl._c_arrays([gl._MODES[mode]] + ints, floats)
            out = (ctypes.c_int * 2)()
            with torch.cuda.device(dev):
                if fn(c_ints, out) != 0:
                    raise RuntimeError(f"grid query of {name} failed")
            grid[name] = out[0]
        return occ, grid

    shapes = {"K": slabs[0].shape[0], "d": slabs[0].shape[1],
              "n_groups": {m: len(ps) for m, (ps, _) in mixes.items()},
              "rows": x.shape[0], "ift": ift}
    return run, blocks, shapes


def _layer_prep_case(gl, dev, g, n=1 << 20):
    """T4 / T6 prepared at the centred flagship's block-0 layer 0 (broadcast
    slabs) and block-2 layer 0 (per-row slabs), K = 10, d = 4 (its
    permanent parameters and MLPs jittered by 0.02 N(0, 1)), recorded from
    the model's ``sample`` at n rows: T6 at the layer's targets, T4 at T6's
    roots (the call that follows it); and T6 raw on the block-0 layer's
    mixture as raw broadcast slabs (means, -log inverse widths, log
    weights; identity regulators).  run(variant) times the five calls
    single and as one of 10 launches back to back; grid(handle) gives each
    call's grid (``gf_layer_grid``).  Returns (run, grid, shapes)."""
    import torch
    from .. import pdf
    from ..ops.special import IDENTITY
    p = pdf("e4+s2+e4", "gggg+f+gggg",
            options_overwrite={"g": {"center_mean": 1}}, device=dev)
    params = {k: v + 0.02 * torch.randn(v.shape, generator=g, device=dev)
              if k.startswith("mlp_") or k == "flow_0" else v
              for k, v in p.init_params(seed=0).items()}
    calls = {}
    run_layer = gl._run

    def record(mode, iface, x, ps, ift, prep, kd):
        if iface == "prepared":
            key = (mode, "per-row" if ps[0].ndim == 3 else "broadcast")
            if key not in calls and (mode == "inverse" or
                                     ("inverse", key[1]) in calls):
                calls[key] = (x.clone(), tuple(t.clone() for t in ps), ift)
        return run_layer(mode, iface, x, ps, ift, prep, kd)

    gl._run = record
    try:
        with torch.no_grad():
            p.sample(params, samplesize=n, generator=g)
    finally:
        gl._run = run_layer
    ift = calls[("inverse", "broadcast")][2]
    means, iw, lnw = calls[("inverse", "broadcast")][1]
    raw = ((means, -torch.log(iw), lnw), (IDENTITY, None, True, None, None))
    cases = [(f"{mode}_prepared ({form})", mode, "prepared", x, ps, None)
             for (mode, form), (x, ps, _) in sorted(calls.items())]
    cases.append(("inverse_raw (broadcast)", "inverse", "raw",
                  calls[("inverse", "broadcast")][0], *raw))

    def run(variant):
        times = {}
        for name, mode, iface, arg, ps, prep in cases:
            fn = (lambda mode=mode, iface=iface, arg=arg, ps=ps, prep=prep:
                  gl._launch(mode, iface, arg, ps, ift, prep, None))
            times[f"{name} {variant}"] = _ms(fn)
            times[f"{name} {variant} (10 back to back)"] = \
                _ms_back_to_back(fn)
        return times

    def grid(handle):
        out = {}
        fn = handle.gf_layer_grid
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name, mode, iface, arg, ps, prep in cases:
            ints, floats, _, _, _, _ = gl._kernel_args(iface, arg, ps, ift,
                                                       prep, None)
            c_ints, _ = gl._c_arrays([gl._MODES[mode]] + ints, floats)
            res = (ctypes.c_int * 2)()
            with torch.cuda.device(dev):
                if fn(c_ints, res) != 0:
                    raise RuntimeError(f"grid query of {name} failed")
            out[name] = res[0]
        return out

    shapes = {"K": means.shape[0], "d": means.shape[1], "rows": n,
              "ift": ift}
    return run, grid, shapes


def _bits_outputs(dev, n=1 << 16):
    """({name: output on the CPU}, {model: kernels launched}) of seeded
    calls of every model of the ``bits`` part through the libraries
    loaded."""
    import torch
    from .. import pdf
    from ..ops import gf_block as gb, gf_layer as gl
    models = (("flagship", {}),
              ("centred", {"options_overwrite": {"g": {"center_mean": 1}}}),
              ("skewed", {"options_overwrite": {"g": {"add_skewness": 1}}}),
              ("64-64", {"amortization_mlp_dims": "64-64"}))
    out, launched = {}, {}
    for label, kw in models:
        p = pdf("e4+s2+e4", "gggg+f+gggg", device=dev, **kw)
        g = torch.Generator(device=dev).manual_seed(0)
        params = {k: v + 0.02 * torch.randn(v.shape, generator=g, device=dev)
                  if k.startswith("mlp_") or k == "flow_0" else v
                  for k, v in p.init_params(seed=0).items()}
        z = torch.randn((n, p.total_base_dim), generator=g, device=dev)
        gb.reset_launch_counts()
        gl.reset_launch_counts()
        with torch.no_grad():
            x, _, lp_sample, _ = p.sample(params, samplesize=n, generator=g)
            lp = p.log_prob(params, x)[0]
        val, g_nll = p.nll_value_and_grad(params, x)
        _, g_lp = p._value_and_grad(
            lambda pp: -p.log_prob(pp, x)[0].mean(), params)

        def objective(pp):
            y, ld = p.all_layer_forward(pp, z, torch.zeros(
                n, dtype=z.dtype, device=dev), None)
            return (y**2).mean() - 0.1 * ld.mean()

        _, g_s = p._value_and_grad(objective, params)
        launched[label] = {k: v for k, v in {**gb.LAUNCHES,
                                              **gl.LAUNCHES}.items() if v}
        got = {"sample": x, "sample log_pdf": lp_sample, "log_prob": lp,
               "nll": val.reshape(1)}
        for what, grads in (("nll grad", g_nll), ("log_prob grad", g_lp),
                            ("sample grad", g_s)):
            got.update({f"{what} {k}": v for k, v in grads.items()})
        out.update({f"{label} {k}": v.detach().cpu().contiguous()
                    for k, v in got.items()})
    out.update(_layer_lazy_bits(dev, n))
    out.update(_layer_raw_bits(dev, n))
    return out, launched


def _layer_lazy_bits(dev, n, hid=64):
    """{name: output on the CPU} of the per-layer lazy kernels called
    directly on seeded inputs, skewed and not (the models reach the skewed
    ones only), at K = 10, d = 4 and the generic K = 7, d = 3: T4, T5 and
    both T7 bodies."""
    import numpy as np
    import torch
    from ..ops import gf_layer as gl
    from ..ops.special import log_bounded_exp_fn, width_regulator_fn

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    ift, out = "inormal_partly_precise", {}
    for skew in (0, 1):
        for k, d in ((10, 4), (7, 3)):
            rng = np.random.default_rng(100 * skew + k)
            signs = tuple([1.0] * (k // 2) + [-1.0] * (k - k // 2))
            prep = (width_regulator_fn(0, 1, 0.01, 100, 0), None, True,
                    log_bounded_exp_fn(0.1, 9.0, center=True) if skew
                    else None, signs if skew else None)
            groups = [rng.normal(size=(k, d)),
                      -1.0 + 0.5 * rng.normal(size=(k, d)),
                      rng.normal(size=(k, d))] + \
                [0.8 * rng.normal(size=(k, d))] * skew
            w = 0.2 * np.sqrt(24 / hid) * rng.normal(
                size=(len(groups) * k * d, hid))
            params = (t(np.tanh(rng.normal(size=(n, hid)))), t(w),
                      t(np.concatenate([g.reshape(-1) for g in groups])))
            x, g1, g2 = (t(rng.normal(size=(n, d))) for _ in range(3))
            got = {mode: gl._run(mode, "lazy", x, params, ift, prep, (k, d))
                   for mode in ("forward", "sample")}
            for body, res in (("forward", x), ("sample", got["sample"][0])):
                gx, gp = gl._run_bwd(body, "lazy", res, params, g1, g2, ift,
                                     prep, (k, d))
                got[f"{body}_bwd"] = (gx, *gp)
            for name, vals in got.items():
                out.update({f"layer lazy skew={skew} K={k} {name} {i}":
                            v.detach().cpu().contiguous()
                            for i, v in enumerate(vals)})
    return out


def _layer_raw_bits(dev, n):
    """{name: output on the CPU} of the per-layer prepared and raw kernels
    called directly on seeded inputs (the slabs broadcast and per row,
    skewed and not, K = 10, d = 4 and the generic K = 7, d = 3, every iCDF
    type, one component of one broadcast slab NaN): T4, T5 and T6, and T7
    with raw broadcast slabs (both bodies)."""
    import numpy as np
    import torch
    from ..ops import gf_layer as gl
    from ..ops.special import log_bounded_exp_fn, width_regulator_fn

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    out = {}
    for skew in (0, 1):
        for k, d in ((10, 4), (7, 3)):
            for per_row in (False, True):
                rng = np.random.default_rng(200 + 100 * skew + 10 * k +
                                            per_row)
                m = 512 if per_row else n
                shp = (k, d, m) if per_row else (k, d)
                signs = tuple([1.0] * (k // 2) + [-1.0] * (k - k // 2))
                prep = (width_regulator_fn(0, 1, 0.01, 100, 0), None, True,
                        log_bounded_exp_fn(0.1, 9.0, center=True) if skew
                        else None, signs if skew else None)
                raw = [t(rng.normal(size=shp)),
                       t(-1.0 + 0.5 * rng.normal(size=shp)),
                       t(rng.normal(size=shp))] + \
                    [t(0.8 * rng.normal(size=shp))] * skew
                if not per_row:
                    raw[1][3, d - 1] = float("nan")
                ln = rng.normal(size=shp)
                prepared = (t(rng.normal(size=shp)),
                            t(1.0 / (0.3 + rng.uniform(size=shp))),
                            t(ln - np.log(np.exp(ln).sum(0, keepdims=True))))
                x, g1, g2 = (t(rng.normal(size=(m, d))) for _ in range(3))
                for ift in ("isigmoid", "inormal_partly_precise",
                            "inormal_partly_crude", "inormal_full_pade"):
                    got = {}
                    for mode in ("forward", "sample", "inverse"):
                        got[f"{mode}_raw"] = gl._run(mode, "raw", x,
                                                     tuple(raw), ift, prep,
                                                     None)
                    if not skew:
                        for mode in ("forward", "inverse"):
                            got[f"{mode}_prepared"] = gl._run(
                                mode, "prepared", x, prepared, ift, None,
                                None)
                    if not per_row:
                        for body, res in (("forward", x),
                                          ("sample",
                                           got["sample_raw"][0])):
                            gx, gp = gl._run_bwd(body, "raw", res,
                                                 tuple(raw), g1, g2, ift,
                                                 prep, None)
                            got[f"{body}_bwd_raw"] = (gx, *gp)
                    for name, vals in got.items():
                        vals = vals if isinstance(vals, tuple) else (vals,)
                        out.update({
                            f"layer raw skew={skew} K={k} per_row={per_row}"
                            f" {ift} {name} {i}": v.detach().cpu()
                            .contiguous() for i, v in enumerate(vals)})
    return out


def _bits_compare(ref, got):
    """{name: "equal" or how the outputs differ} of ``got`` against
    ``ref``, bit for bit (a NaN equal to a NaN of the same bits)."""
    out = {}
    for k, a in ref.items():
        b = got[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            out[k] = f"shape {tuple(b.shape)} {b.dtype}"
            continue
        same = a.numpy().view("u1").reshape(a.numel(), -1) == \
            b.numpy().view("u1").reshape(b.numel(), -1)
        n = int((~same.all(axis=1)).sum())
        out[k] = "equal" if n == 0 else (
            f"{n} of {a.numel()} differ, max abs "
            f"{(a.double() - b.double()).abs().nan_to_num(0).max().item()}")
    return out


def main(argv=None):
    import torch
    from .. import pdf
    from ..ops import gf_block as gb
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=sorted(VARIANTS), default="lazy2")
    ap.add_argument("--csrc", type=pathlib.Path, nargs="+",
                    default=[cuda_build.CSRC])
    ap.add_argument("--variants", nargs="+", default=None,
                    help="build and time only these variants of the part "
                    "(a+b: the switches of a and b together)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time the trees this often, alternately in order "
                    "and in reverse")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile_breakdown: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    trees = {str(c): c for c in args.csrc}
    paths, report = build(args.part, trees, args.variants)
    if args.part == "sass":
        print(json.dumps({"card": card, "part": "sass",
                          "against": str(args.csrc[0]),
                          "trees": sass_compare(paths, trees)}))
        return 0
    dev = torch.device("cuda", torch.cuda.current_device())
    if args.part == "bits":
        from ..ops import gf_layer as gl
        declare = {"gf_block": gb._declare, "gf_block_bwd": gb._declare_bwd,
                   "gf_layer": gl._declare, "gf_layer_bwd": gl._declare_bwd}
        outputs = {}
        for tree in trees:
            for lib in VARIANTS["bits"]["as_built"][1]:
                handle = ctypes.CDLL(str(paths[(tree, "as_built", lib)]))
                declare[lib](handle)
                cuda_build._LOADED[lib] = handle
            outputs[tree] = _bits_outputs(dev)
            cuda_build._LOADED.clear()
        (first, (ref, launched)), *rest = outputs.items()
        print(json.dumps({"card": card, "part": "bits", "against": first,
                          "launched": launched,
                          "sass": sass_compare(paths, trees),
                          "bits": {t: _bits_compare(ref, o[0])
                                   for t, o in rest}}))
        return 0
    p = pdf("e4+s2+e4", "gggg+f+gggg", device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    if args.part == "perm":
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        run = _perm_case(gb, p, dev, g, n_sm)
    elif args.part == "perm_fwd":
        run = _perm_fwd_case(gb, p, dev, g)
    elif args.part == "block_lazy":
        torch.backends.cuda.matmul.allow_tf32 = False
        run, yardsticks, blocks, shapes = _block_lazy_case(gb, dev, g)
    elif args.part == "layer_raw":
        from ..ops import gf_layer as gl
        # the model's path (recording the calls) on the first tree's
        # as-built forward kernels
        handle = ctypes.CDLL(str(paths[(next(iter(trees)), "as_built",
                                        "gf_layer")]))
        gl._declare(handle)
        cuda_build._LOADED["gf_layer"] = handle
        run, blocks, shapes = _layer_raw_case(gl, dev, g)
    elif args.part == "layer_fwd_raw":
        from ..ops import gf_layer as gl
        # the model's path (recording the calls) on the first tree's
        # as-built library
        handle = ctypes.CDLL(str(paths[(next(iter(trees)), "as_built",
                                        "gf_layer")]))
        gl._declare(handle)
        cuda_build._LOADED["gf_layer"] = handle
        run, blocks, shapes = _layer_fwd_raw_case(gl, dev, g)
    elif args.part == "layer_prep":
        from ..ops import gf_layer as gl
        handle = ctypes.CDLL(str(paths[(next(iter(trees)), "as_built",
                                        "gf_layer")]))
        gl._declare(handle)
        cuda_build._LOADED["gf_layer"] = handle
        run, grid, shapes = _layer_prep_case(gl, dev, g)
    elif args.part == "layer_lazy":
        from ..ops import gf_layer as gl
        torch.backends.cuda.matmul.allow_tf32 = False
        p = pdf("e4+s2+e4", "gggg+f+gggg",
                options_overwrite={"g": {"add_skewness": 1}}, device=dev)
        params = p.init_params(seed=0)
        params = {k: v + 0.02 * torch.randn(v.shape, generator=g, device=dev)
                  if k.startswith("mlp_") or k == "flow_0" else v
                  for k, v in params.items()}
        # the model's path (recording the calls) on the first tree's
        # as-built kernels
        first = next(iter(trees))
        for lib, declare in (("gf_layer", gl._declare),
                             ("gf_layer_bwd", gl._declare_bwd)):
            handle = ctypes.CDLL(str(paths[(first, "as_built", lib)]))
            declare(handle)
            cuda_build._LOADED[lib] = handle
        run, yardsticks, shapes = _layer_lazy_case(gl, p, params, dev, g)
    else:
        run = _lazy2_case(gb, p, dev, g)

    def visit(tree):
        """({name: ms}, the tree's other facts) of one tree's kernels."""
        times, extra = {}, {}
        if args.part == "perm":
            extra = {"rows_backward": 1 << 18, "blocks_per_sm": {},
                     "ptxas": perm_ptxas(report[tree])}
        elif args.part == "perm_fwd":
            extra = {"rows_forward": 1 << 20, "blocks_per_sm": {},
                     "ptxas": perm_ptxas(report[tree]),
                     "sass": perm_fwd_sass(paths[(tree, "as_built",
                                                  "gf_block")])}
        elif args.part == "layer_lazy":
            extra = {"shapes": shapes, "ptxas": layer_ptxas(report[tree]),
                     "blocks_per_sm": {}}
        elif args.part == "block_lazy":
            extra = {"shapes": shapes,
                     "ptxas": block_lazy_ptxas(report[tree]),
                     "tf32_hmma": block_lazy_hmma(
                         [paths[(tree, "as_built", lib)] for lib in _BOTH]),
                     "blocks_per_sm": {}}
        else:
            extra = {"rows_forward": 1 << 20, "rows_backward": 1 << 18}
        if args.part == "layer_fwd_raw":
            extra = {"shapes": shapes, "ptxas": {}, "blocks_per_sm": {},
                     "grid": {}, "sass": {}}
            for (t, variant, lib), path in paths.items():
                if t != tree:
                    continue
                handle = ctypes.CDLL(str(path))
                gl._declare(handle)
                cuda_build._LOADED[lib] = handle
                extra["blocks_per_sm"][variant], extra["grid"][variant] = \
                    blocks(handle)
                extra["ptxas"][variant] = layer_fwd_raw_ptxas(
                    report[(tree, variant)])
                bcast = "gf_layer_bcast_kernel" in report[(tree, variant)]
                extra["sass"][variant] = perm_fwd_sass(
                    path, label=lambda n, b=bcast: _layer_fwd_raw_kernel(n, b))
                times.update(run(variant))
            return times, extra
        if args.part == "layer_prep":
            extra = {"shapes": shapes, "ptxas": {}, "blocks_per_sm": {},
                     "grid": {}, "sass": {}}
            for (t, variant, lib), path in paths.items():
                if t != tree:
                    continue
                handle = ctypes.CDLL(str(path))
                gl._declare(handle)
                cuda_build._LOADED[lib] = handle
                extra["grid"][variant] = grid(handle)
                ptx = layer_prep_ptxas(report[(tree, variant)])
                extra["ptxas"][variant] = ptx
                extra["blocks_per_sm"][variant] = {
                    k: _blocks_from_registers(v) for k, v in ptx.items()}
                extra["sass"][variant] = perm_fwd_sass(
                    path, label=_layer_prep_kernel)
                times.update(run(variant))
            return times, extra
        if args.part == "layer_raw":
            extra = {"shapes": shapes, "ptxas": {}, "blocks_per_sm": {},
                     "grid": {}}
            for (t, variant, lib), path in paths.items():
                if t != tree or lib != "gf_layer_bwd":
                    continue
                handle = ctypes.CDLL(str(path))
                gl._declare_bwd(handle)
                cuda_build._LOADED[lib] = handle
                extra["blocks_per_sm"][variant], extra["grid"][variant] = \
                    blocks(handle)
                extra["ptxas"][variant] = layer_raw_ptxas(report[(tree,
                                                                  variant)])
                times.update(run(variant))
            cuda_build._LOADED.pop("gf_layer_bwd", None)
            return times, extra
        if args.part == "layer_lazy":
            # every variant's libraries loaded together: a T7 variant
            # leaves the forward as built, and the reverse
            by_variant = collections.defaultdict(dict)
            for (t, variant, lib), path in paths.items():
                if t == tree:
                    by_variant[variant][lib] = path
            for variant, libs in by_variant.items():
                for lib in ("gf_layer", "gf_layer_bwd"):
                    path = libs.get(lib, paths.get((tree, "as_built", lib)))
                    handle = ctypes.CDLL(str(path))
                    (gl._declare if lib == "gf_layer"
                     else gl._declare_bwd)(handle)
                    cuda_build._LOADED[lib] = handle
                    extra["blocks_per_sm"].setdefault(variant, {}).update(
                        layer_occupancy(handle, lib, shapes))
                t_v = run(variant)
                times.update({k: v for k, v in t_v.items()
                              if variant == "as_built" or
                              any(k.startswith(n + " ") for n in
                                  _VARIANT_KERNELS[variant])})
                if variant == "as_built":
                    times.update(yardsticks())
            cuda_build._LOADED.clear()
            return times, extra
        for (t, variant, lib), path in paths.items():
            if t != tree:
                continue
            handle = ctypes.CDLL(str(path))
            (gb._declare if lib == "gf_block" else gb._declare_bwd)(handle)
            cuda_build._LOADED[lib] = handle
            if args.part == "perm":
                t, extra["blocks_per_sm"][variant] = run(handle)
                times.update({f"{k} {variant}": v for k, v in t.items()})
            elif args.part == "perm_fwd":
                t, extra["blocks_per_sm"][variant] = run(variant)
                times.update(t)
            elif args.part == "block_lazy":
                times.update(run(lib, variant))
                extra["blocks_per_sm"].setdefault(variant, {}).update(
                    blocks(lib))
            else:
                times.update(run(lib, variant))
        cuda_build._LOADED.clear()
        if args.part == "block_lazy":
            times.update(yardsticks())
        return times, extra

    results = {}
    for r in range(args.rounds):
        for tree in list(trees)[::1 if r % 2 == 0 else -1]:
            times, extra = visit(tree)
            res = results.setdefault(tree, {"ms": times, **extra})
            if args.rounds > 1:
                res.setdefault("ms_rounds", []).append(times)
    if args.rounds > 1:
        for res in results.values():
            res["ms"] = {k: statistics.median(t[k] for t in res["ms_rounds"])
                         for k in res["ms"]}
    if len(trees) == 1:
        (tree, res), = results.items()
        print(json.dumps({"card": card, "part": args.part, "csrc": tree,
                          **res}))
    else:
        print(json.dumps({"card": card, "part": args.part,
                          "trees": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
