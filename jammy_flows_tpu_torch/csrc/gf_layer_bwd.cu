// Backward of the per-layer Gaussianization-flow kernels for Hopper
// (sm_90a).
//
// Replaces the TPU kernel jammy_flows_tpu/ops/pallas_gf.py `_gf_bwd_call`
// (T7) with its two bodies:
//   * density (`_forward_bwd_body`): the VJP of one layer's density pass
//     (val, ld) at x for the cotangents (g1, g2), back to x and to the raw
//     parameters;
//   * sample (`_sample_bwd_body`): the implicit-function VJP at the root x
//     of the sample pass: with fp = dval/dx and lx = dld/dx,
//     c = (g1 + g2 lx) / fp is the target's cotangent and the parameters take
//     the VJP of (val, ld) for (-c, g2).
// Raw (broadcast or per row) and lazy parameters, skewed or not.  Gradients
// of per-row slabs and of the lazy hidden activations are written per row;
// broadcast slabs and the lazy w / b are summed over rows.
//
// What bounds it on an H100: arithmetic.  Per row and dimension it
// recomputes the forward's mixture (gf_layer_src.cuh, the forward's own
// code) and runs its adjoint: the plain mixture by the transposed JAX
// tangent rule (gf_common.cuh mix_adjoint), the skewed one by its AD
// written out (skew_adjoint).  The lazy interface adds, per row, the
// parameter rows (2 P H flops), dh = w^T dp (2 P H) and its share of
// gw = sum_rows dp (x) hidden (2 P H), P = n_groups * K * D: all three on
// the tensor cores (3xTF32).
//
// Design (the block backward's, csrc/gf_block_bwd.cu): one thread per row,
// tiles of rows walked by a fixed grid of persistent blocks, each adding
// to its private partial of the summed gradients; a second kernel sums the
// partials in block order.  Deterministic, no atomics.
//   * raw broadcast (gf_layer_bcast_bwd_kernel, the perm backward's design):
//     the regulator derivatives are the block's (LayerSrc<..., BWD>, once
//     per block; the adjoints' FAC form); a row's cotangents of one
//     dimension's piece are summed over the warp by shuffles (warp_sum.cuh)
//     into the warp's own partial in shared memory, a parameter row always
//     the same lane's, so the per-row body takes no barrier; at the end the
//     block sums its warps' partials in warp order and writes its row of the
//     partials once.  As many blocks as the SMs hold at once (the occupancy
//     API's count);
//   * raw per row: each row's thread writes its gradient slab rows;
//   * lazy: the tile stage of tile_rows.cuh (LayerTileSrc), as the lazy2
//     block backward: per dimension the block makes the piece's parameter
//     rows by the forward's own tile product (the same bits), each row's
//     thread runs the adjoint on its column and writes its cotangents back
//     over it, and the block flushes the piece: dh += dp . w_piece and the
//     partial gw_piece += dp^T . hidden as 3xTF32 tile products, gb as a
//     fixed-order sum.  dh stays in shared memory where it fits beside the
//     tile without costing the second block per SM (small H); otherwise it
//     lives in the block's global scratch (through L2).  The tile shrinks
//     to 64 / 32 rows above H ~ 454, so every H <= 1024 (the routing
//     limit, layers/euclidean.py) launches.
#include <cuda_runtime.h>

#include "gf_layer_src.cuh"
#include "warp_sum.cuh"

using namespace gf;

namespace {

constexpr int SMEM_LIMIT = 227 * 1024;

struct LayerBwdArgs {
  LayerArgs a;     // a.x: x (density body) or the root (sample body)
  const float* g1;  // (B, D) cotangent of val, or of the root
  const float* g2;  // (B, D) cotangent of ld
  float* gx;        // (B, D)
  float* gslab;     // per row: (n_groups, K, D, B)
  float* gh;        // lazy: (B, H)
  float* partials;  // (gridDim.x, G)
  float* scratch;   // lazy dh in global memory: (gridDim.x, H, T + 1), or null
  int G;            // broadcast: n_groups*K*D; lazy: P*H + P; per row: 0
};

// lazy: one piece's cotangents (the slab, each row's thread has written
// its own column) into dh and the block's partial gw (3xTF32 tile
// products) and gb (the sum over the tile's rows, in a fixed order).
// Block-synchronous.
__device__ void layer_flush(const LayerBwdArgs& A, const Tile& tl, float* dh,
                            int dd, int n) {
  const LayerArgs& a = A.a;
  float* pw = A.partials + (size_t)blockIdx.x * A.G;
  float* pb = pw + (size_t)a.n_groups * a.K * a.D * a.H;
  const PieceRows rows{a.D, dd};
  __syncthreads();
  dh_product<STREAM_NC>(tl, tl.sm, dh, a.w, rows, n);
  gw_product(tl, tl.sm, pw, rows, n);
  gb_sum(tl, tl.sm, pb, rows, n);
}

// One row's adjoint of dimension dd (element i; rows past B: zero input
// and cotangents): the cotangent of x into gx (valid rows), the parameter
// rows' cotangents into vals.  FAC (raw broadcast slabs): lw, ln, se hold
// the block's parameter-only terms (LayerSrc<..., BWD>::load), vals is
// zeroed by the caller and takes the order [means | log-widths | exponents
// (skewed) | log-norms], every offset a compile-time one where K is
// (AdjRows maps them to the slabs' rows).
template <bool SKEW, bool SAMPLE, int N, int KT, bool FAC = false>
__device__ __forceinline__ void row_adjoint(const LayerBwdArgs& A,
                                            const MixT<SKEW, N>& mx,
                                            const float* lw, const float* ln,
                                            const float* se, int K, size_t i,
                                            bool valid, float* vals) {
  const LayerArgs& a = A.a;
  [[maybe_unused]] const int n_mix = a.n_groups * K;
  const float xv = valid ? a.x[i] : 0.0f;
  const float g1 = valid ? A.g1[i] : 0.0f;
  const float g2 = valid ? A.g2[i] : 0.0f;
  if constexpr (!FAC)
    for (int j = 0; j < n_mix; ++j) vals[j] = 0.0f;
  float r;
  if constexpr (FAC && SKEW)
    r = skew_adjoint<N, KT, SAMPLE, true>(
        xv, mx, nullptr, nullptr, nullptr, K, a.n_pos, a.fit_norm, a.wreg,
        a.nreg, a.ereg, a.ift, g1, g2, vals, vals + K, vals + 3 * K,
        vals + 2 * K, lw, ln, se);
  else if constexpr (FAC)
    r = mix_adjoint<N, KT, SAMPLE, true>(xv, mx, nullptr, nullptr, K,
                                         a.fit_norm, a.wreg, a.nreg, a.ift,
                                         g1, g2, vals, vals + K, vals + 2 * K,
                                         lw, ln, se);
  else if constexpr (SKEW)
    r = skew_adjoint<N, KT, SAMPLE>(
        xv, mx, lw, ln, se, K, a.n_pos, a.fit_norm, a.wreg, a.nreg, a.ereg,
        a.ift, g1, g2, vals, vals + K, vals + 2 * K,
        vals + (2 + a.fit_norm) * K);
  else
    r = mix_adjoint<N, KT, SAMPLE>(xv, mx, lw, ln, K, a.fit_norm, a.wreg,
                                   a.nreg, a.ift, g1, g2, vals, vals + K,
                                   vals + 2 * K);
  if (valid) A.gx[i] = r;
}

// value j of row_adjoint<..., FAC>'s vals -> its parameter row of
// dimension dd in the slabs' group order [means | log-widths | log-norms |
// exponents]: row g K D + k D + dd for value g K + k, the exponents' and
// the log-norms' groups swapped where both are there
template <bool SKEW>
struct AdjRows {
  int K, D, dd;
  bool swap;  // skewed and fit_norm
  __device__ int operator()(int j) const {
    if (SKEW && swap && j >= 2 * K) j += j < 3 * K ? K : -K;
    return j * D + dd;
  }
};

// T7 raw broadcast (the raw interface with (K, D) slabs).  At least 4
// blocks per SM (128 registers, a few spilled) beat 3 and the unbounded
// form on the skewed flagship's layer (PERF.md, tools/tile_breakdown.py
// --part layer_raw).
template <bool SKEW, bool SAMPLE, int KT>
__global__ void __launch_bounds__(128, 4)
    gf_layer_bcast_bwd_kernel(const LayerBwdArgs A) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int NV = (SKEW ? 4 : 3) * N;
  const LayerArgs& a = A.a;
  const int T = blockDim.x, tid = threadIdx.x;
  const int K = KT > 0 ? KT : a.K;
  const int n_tiles = (a.B + T - 1) / T;
  const int n_mix = a.n_groups * K;
  extern __shared__ __align__(16) float smem[];
  // after the source's arrays, one partial of G floats per warp
  float* wparts = smem + layer_src_floats(a);
  float* wpart = wparts + (size_t)(tid >> 5) * A.G;
  for (int j = tid; j < (T >> 5) * A.G; j += T) wparts[j] = 0.0f;
  // the source's set-up ends with a barrier, after which the zeroed
  // partials are visible; the tiles need no other barrier
  const LayerSrc<SKEW, N, KT, true> src(a, smem);
  const bool swap = SKEW && a.fit_norm;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * T + tid;
    const bool valid = row < a.B;
    for (int dd = 0; dd < a.D; ++dd) {
      MixT<SKEW, N> mx;
      float fw[N], fn[N], fx[N], vals[NV] = {};
      src.load(a, row, dd, mx, fw, fn, fx);
      row_adjoint<SKEW, SAMPLE, N, KT, true>(A, mx, fw, fn, fx, K,
                                             (size_t)row * a.D + dd, valid,
                                             vals);
      if (!valid)
        for (int j = 0; j < NV; ++j) vals[j] = 0.0f;
      warp_flush<NV>(wpart, vals, n_mix, AdjRows<SKEW>{K, a.D, dd, swap});
    }
  }
  // the block's partial: its warps' partials summed in warp order, written
  // once (every block writes its row, tiles or not)
  __syncthreads();
  float* part = A.partials + (size_t)blockIdx.x * A.G;
  for (int j = tid; j < A.G; j += T) {
    float acc = 0.0f;
    for (int w = 0; w < (T >> 5); ++w) acc += wparts[(size_t)w * A.G + j];
    part[j] = acc;
  }
}

// T7 lazy, and raw with per-row (K, D, B) slabs.
template <bool LAZY, bool SKEW, bool SAMPLE, int KT>
__global__ void __launch_bounds__(128) gf_layer_bwd_kernel(const LayerBwdArgs A) {
  constexpr int N = KT > 0 ? KT : KMAX;
  const LayerArgs& a = A.a;
  const int T = blockDim.x, tid = threadIdx.x;
  const int K = KT > 0 ? KT : a.K;
  const int n_tiles = (a.B + T - 1) / T;
  const int n_mix = a.n_groups * K;
  extern __shared__ __align__(16) float smem[];
  if constexpr (LAZY) {
    const LayerTileSrc<SKEW, N, KT> src(a, smem);
    const Tile& tl = src.tl;
    float* dh = A.scratch ? A.scratch + (size_t)blockIdx.x * tl.Hp * tl.hs
                          : smem + layer_tile_floats(a.tile);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile * T, row = row0 + tid;
      const bool valid = row < a.B;
      src.load_tile(a, row0);
      for (int h = 0; h < tl.Hp; ++h) dh[h * tl.hs + tid] = 0.0f;
      for (int dd = 0; dd < a.D; ++dd) {
        src.stage(a, dd);
        MixT<SKEW, N> mx;
        float lw[N], ln[N], se[N], vals[4 * N];
        src.load(a, mx, lw, ln, se);
        row_adjoint<SKEW, SAMPLE, N, KT>(A, mx, lw, ln, se, K,
                                         (size_t)row * a.D + dd, valid, vals);
        if (!valid)
          for (int j = 0; j < n_mix; ++j) vals[j] = 0.0f;
        src.put(vals, n_mix);
        layer_flush(A, tl, dh, dd, n_mix);
      }
      // ghidden = dh, the tile's rows written h-fastest (coalesced)
      __syncthreads();
      const int n = min(T, a.B - row0) * a.H;
      for (int idx = tid; idx < n; idx += T) {
        const int r2 = idx / a.H, h = idx - r2 * a.H;
        A.gh[(size_t)row0 * a.H + idx] = dh[h * tl.hs + r2];
      }
    }
  } else {
    const LayerSrc<SKEW, N, KT> src(a, smem);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row = tile * T + tid;
      const bool valid = row < a.B;
      const int r_ld = valid ? row : a.B - 1;  // a row to read for idle threads
      for (int dd = 0; dd < a.D; ++dd) {
        MixT<SKEW, N> mx;
        float lw[N], ln[N], se[N], vals[4 * N];
        src.load(a, r_ld, dd, mx, lw, ln, se);
        row_adjoint<SKEW, SAMPLE, N, KT>(A, mx, lw, ln, se, K,
                                         (size_t)row * a.D + dd, valid, vals);
        if (valid)
          for (int j = 0; j < n_mix; ++j) {
            const int g = j / K, k = j - g * K;
            A.gslab[((size_t)(g * K + k) * a.D + dd) * a.B + row] = vals[j];
          }
      }
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

// Launch kernel on `stream`, or with occupancy non-null write its resident
// blocks per SM there instead (the CUDA occupancy API).
template <class Kernel>
cudaError_t launch(Kernel kernel, const LayerBwdArgs& A, int blocks,
                   int threads, size_t smem, cudaStream_t stream,
                   int* occupancy) {
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

// the kernel of a call: raw broadcast, raw per row, or lazy
template <bool LAZY, bool SKEW, bool SAMPLE, int KT>
cudaError_t launch_kt(const LayerBwdArgs& A, int blocks, int threads,
                      size_t smem, cudaStream_t s, int* occ) {
  if constexpr (!LAZY)
    if (!A.a.per_row)
      return launch(gf_layer_bcast_bwd_kernel<SKEW, SAMPLE, KT>, A, blocks,
                    threads, smem, s, occ);
  return launch(gf_layer_bwd_kernel<LAZY, SKEW, SAMPLE, KT>, A, blocks,
                threads, smem, s, occ);
}

template <bool LAZY, bool SKEW, bool SAMPLE>
cudaError_t dispatch_k(const LayerBwdArgs& A, int blocks, int threads,
                       size_t smem, cudaStream_t s, int* occ) {
  if (A.a.K == 10)
    return launch_kt<LAZY, SKEW, SAMPLE, 10>(A, blocks, threads, smem, s, occ);
  return launch_kt<LAZY, SKEW, SAMPLE, 0>(A, blocks, threads, smem, s, occ);
}

cudaError_t dispatch(bool sample, bool lazy, bool skew, const LayerBwdArgs& A,
                     int blocks, int threads, size_t smem, cudaStream_t s,
                     int* occ) {
  if (lazy) {
    if (skew)
      return sample ? dispatch_k<true, true, true>(A, blocks, threads, smem, s, occ)
                    : dispatch_k<true, true, false>(A, blocks, threads, smem, s, occ);
    return sample ? dispatch_k<true, false, true>(A, blocks, threads, smem, s, occ)
                  : dispatch_k<true, false, false>(A, blocks, threads, smem, s, occ);
  }
  if (skew)
    return sample ? dispatch_k<false, true, true>(A, blocks, threads, smem, s, occ)
                  : dispatch_k<false, true, false>(A, blocks, threads, smem, s, occ);
  return sample ? dispatch_k<false, false, true>(A, blocks, threads, smem, s, occ)
                : dispatch_k<false, false, false>(A, blocks, threads, smem, s, occ);
}

// The block of a call: its rows (threads) and dynamic shared memory, and
// for lazy a.tile (pieces of n_piece parameter rows) and where dh lives.
// Raw broadcast: 128 rows, the source's floats and a partial of the
// n_piece * D summed gradients per warp; raw per row: 128 rows and none.
// Lazy: the tile of layer_tile; dh in shared memory after it where the
// tile keeps its rows and two blocks still fit an SM, else in the block's
// global scratch (dh_global).  0 or cudaErrorInvalidValue.
int tile_shape(LayerArgs& a, int lazy, int n_piece, int& threads,
               size_t& smem, bool& dh_global) {
  dh_global = false;
  if (!lazy) {
    threads = 128;
    smem = a.per_row ? 0
                     : (layer_src_floats(a) +
                        (size_t)(threads / 32) * n_piece * a.D) * 4;
    return smem > SMEM_LIMIT ? (int)cudaErrorInvalidValue : 0;
  }
  a.tile = layer_tile(a.H, n_piece, false);
  threads = a.tile.T;
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const TileShape with_dh = layer_tile(a.H, n_piece, true);
  const size_t dh_floats = (size_t)with_dh.Hp * with_dh.hs;
  dh_global = with_dh.T != a.tile.T ||
              (layer_tile_floats(a.tile) + dh_floats) * 4 > SMEM_LIMIT / 2;
  smem = (layer_tile_floats(a.tile) + (dh_global ? 0 : dh_floats)) * 4;
  return 0;
}

}  // namespace

// The grid of a call: a fixed number of persistent blocks, at most one
// per tile: for raw broadcast slabs as many as the SMs hold at once (the
// occupancy API's blocks per SM for its kernel, times n_sm), else two per
// SM.  Fixed for a card and a build, so the run is deterministic.  Each
// block accumulates a private partial of the summed gradients, so the
// caller allocates (blocks, G) floats for gf_layer_bwd_launch (zeros but
// for raw broadcast slabs, where each block writes its row once).
// n_piece: the parameter rows of one dimension, n_groups * K (the lazy
// tile's rows and the broadcast partials depend on it); meta: the call's
// gf_layer_bwd_launch meta.  0 when the call is not one the kernels take.
extern "C" int gf_layer_bwd_blocks(int lazy, int B, int H, int n_sm,
                                   int n_piece, const int* meta) {
  LayerBwdArgs A{};
  LayerArgs& a = A.a;
  a.H = H;
  a.per_row = 1;
  const bool bcast = !lazy && !meta[4];
  if (bcast) {
    a.per_row = 0;
    a.K = meta[6];
    a.D = meta[7];
    if (a.K < 1 || a.K > KMAX || a.D < 1 || a.D > DMAX) return 0;
  }
  int threads;
  size_t smem;
  bool dh_global;
  if (tile_shape(a, lazy, n_piece, threads, smem, dh_global) != 0) return 0;
  int per_sm = 2;
  if (bcast && dispatch(meta[0] == 1, false, meta[2], A, 1, threads, smem,
                        nullptr, &per_sm) != cudaSuccess)
    return 0;
  const int n_tiles = (B + threads - 1) / threads;
  const int cap = (per_sm > 1 ? per_sm : 1) * n_sm;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  return blocks > 1 ? blocks : 1;
}

// Floats of global dh scratch a lazy call needs per block: 0 while the dh
// columns stay in shared memory.
extern "C" int gf_layer_bwd_scratch(int lazy, int H, int n_piece) {
  LayerArgs a{};
  a.H = H;
  a.per_row = 1;
  int threads;
  size_t smem;
  bool dh_global;
  if (tile_shape(a, lazy, n_piece, threads, smem, dh_global) != 0 ||
      !dh_global)
    return 0;
  return a.tile.Hp * a.tile.hs;
}

// Resident blocks per SM of the kernel a call of this (body, lazy, skew,
// K, D, H, n_groups) launches, lazy or with raw broadcast slabs (lazy 0),
// by cudaOccupancyMaxActiveBlocksPerMultiprocessor; writes [blocks per SM,
// threads per block, dynamic shared memory bytes] to out.  Returns 0 or a
// cudaError_t.
extern "C" int gf_layer_bwd_occupancy(int body, int lazy, int skew, int K,
                                      int D, int H, int n_groups, int* out) {
  LayerBwdArgs A{};
  LayerArgs& a = A.a;
  a.K = K;
  a.D = D;
  a.H = H;
  a.per_row = lazy;
  a.n_groups = n_groups;
  int threads;
  size_t smem;
  bool dh_global;
  if (body < 0 || body > 1 || K < 1 || K > KMAX || D < 1 || D > DMAX ||
      (lazy && H < 1) ||
      tile_shape(a, lazy, n_groups * K, threads, smem, dh_global) != 0)
    return (int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t e =
      dispatch(body == 1, lazy, skew, A, 1, threads, smem, nullptr, &n);
  out[0] = n;
  out[1] = threads;
  out[2] = (int)smem;
  return (int)e;
}

// meta: [body (0 density, 1 sample), lazy, skew, prepared (must be 0),
//        per_row, B, K, D, H, fit_norm, n_pos, ift, wreg kind, nreg kind,
//        ereg kind]; regs as gf_layer_launch.  x: the density input (body 0)
// or the root (body 1); g1, g2: cotangents of (val or root, ld).  gslab:
// per row, (n_groups, K, D, B) zeros; gh: lazy, (B, H); partials:
// (n_blocks, G) floats, zeros but for broadcast slabs, G = n_groups*K*D
// (broadcast) or P*H + P (lazy, P = n_groups*K*D); n_blocks: as
// gf_layer_bwd_blocks; grads (G,): the sums over rows, packed [g slabs] or
// [gw (P, H) | gb (P)]; scratch: n_blocks * gf_layer_bwd_scratch(...)
// floats, or null when that is 0.  Returns 0 or a cudaError_t; launches on
// `stream` and does not synchronize.
extern "C" int gf_layer_bwd_launch(const int* meta, const float* regs,
                                   const float* x, const float* g1,
                                   const float* g2, float* gx, const float* p0,
                                   const float* p1, const float* p2,
                                   const float* p3, const float* hidden,
                                   const float* w, const float* b,
                                   float* gslab, float* gh, float* partials,
                                   int n_blocks, float* scratch, float* grads,
                                   void* stream) {
  const int body = meta[0], lazy = meta[1], skew = meta[2];
  LayerBwdArgs A{};
  LayerArgs& a = A.a;
  a.x = x;
  a.p[0] = p0;
  a.p[1] = p1;
  a.p[2] = p2;
  a.p[3] = p3;
  a.hidden = hidden;
  a.w = w;
  a.b = b;
  a.prepared = meta[3];
  a.per_row = lazy ? 0 : meta[4];
  a.B = meta[5];
  a.K = meta[6];
  a.D = meta[7];
  a.H = meta[8];
  a.fit_norm = meta[9];
  a.n_pos = meta[10];
  a.ift = meta[11];
  a.wreg = Reg{meta[12], regs[0], regs[1], regs[2], regs[3], regs[4]};
  a.nreg = Reg{meta[13], regs[5], regs[6], regs[7], regs[8], regs[9]};
  a.ereg = Reg{meta[14], regs[10], regs[11], regs[12], regs[13], regs[14]};
  a.n_groups = 2 + a.fit_norm + skew;
  A.g1 = g1;
  A.g2 = g2;
  A.gx = gx;
  A.gslab = gslab;
  A.gh = gh;
  A.partials = partials;
  A.scratch = scratch;
  const int P = a.n_groups * a.K * a.D;
  A.G = lazy ? P * a.H + P : (a.per_row ? 0 : P);
  if (body < 0 || body > 1 || a.prepared || a.K < 1 || a.K > KMAX ||
      a.D < 1 || a.D > DMAX || a.B < 0 || a.ift < 0 || a.ift > 3 ||
      a.n_pos < 0 || a.n_pos > a.K || n_blocks < 1 || g1 == nullptr ||
      g2 == nullptr || gx == nullptr ||
      (lazy && (a.H < 1 || hidden == nullptr || w == nullptr ||
                b == nullptr || gh == nullptr)) ||
      (!lazy && a.per_row && gslab == nullptr) ||
      (A.G > 0 && (partials == nullptr || grads == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!lazy)
    for (int g = 0; g < a.n_groups; ++g)
      if (a.p[g] == nullptr) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;

  int threads;
  size_t smem;
  bool dh_global;
  if (tile_shape(a, lazy, a.n_groups * a.K, threads, smem, dh_global) != 0 ||
      (dh_global && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!dh_global) A.scratch = nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      dispatch(body == 1, lazy, skew, A, n_blocks, threads, smem, s, nullptr);
  if (e != cudaSuccess || A.G == 0) return (int)e;
  reduce_partials<<<(A.G + 255) / 256, 256, 0, s>>>(partials, n_blocks, A.G,
                                                    grads);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_layer_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
