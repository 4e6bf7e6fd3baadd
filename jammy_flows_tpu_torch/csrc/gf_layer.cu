// Per-layer Gaussianization-flow kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel jammy_flows_tpu/ops/pallas_gf.py `_gf_kernel_call`
// in its three modes:
//   T4 forward (`_make_forward_kernel`): (val, log|dval/dx|) of one layer's
//      mixture iCDF pass, the density direction;
//   T5 sample (`_make_sample_kernel`): the Newton solve of the pass at the
//      target, then the log-derivative at the root, in one launch;
//   T6 inverse (`_make_inverse_kernel`): the solve alone.
// Parameters in the prepared, raw or lazy interface, broadcast or per row,
// skewed or not (gf_layer_src.cuh); the iCDF type is a runtime argument.
//
// What bounds it on an H100: arithmetic, except the prepared and raw
// per-row calls of the forward, which read K*D*3-4 floats per row for ~30
// FP32 operations each.  Each mixture evaluation costs ~K transcendental-heavy
// terms per dimension (the skewed chain ~2.5x the plain one); the sample
// mode evaluates it ~7 times per dimension; the lazy interface adds
// 2 * n_groups * K * D * H flops per row for the parameter rows (the
// skewed flagship: 41 kflop per row and layer), which it runs on the
// tensor cores (3xTF32); the mixtures run in f32 on the CUDA cores.
//
// Design: one thread per row, looping over the dimensions (the mixture of
// one dimension in registers for K = 10, local memory otherwise), 128 rows
// per block.  Broadcast slabs (T4 / T5 / T6 raw, gf_layer_bcast_kernel;
// T4 / T6 prepared, gf_layer_prep_kernel): a grid of persistent blocks, as
// many as the SMs hold at once, each preparing the mixtures once
// (BcastSrc, one (dimension, component) pair a thread, with the
// row-independent terms a row would compute again: MixF's lnw + log(iw)
// and nw * iw), then walking its tiles one dimension at a time with that
// dimension's mixture in registers; the plain mixture's solve (and the
// root's log-derivative) is one rolled loop over one copy of the
// evaluation.  One block per tile repeated the set-up 8,192 times at 1M
// rows on 4 of 128 threads (35% of T4 skewed; PERF.md,
// tools/tile_breakdown.py --part layer_fwd_raw / layer_prep).  Per-row
// calls: one block per 128-row tile.
// Lazy
// calls: the tile stage of tile_rows.cuh (LayerStreamSrc): for each
// dimension the block makes that dimension's n_groups * K parameter rows
// for all its 128 rows as one 3xTF32 tile product, the hidden rows and w
// streamed through shared memory in chunks of 32 hidden units (cp.async,
// double-buffered), into a shared slab, and each row's thread runs the
// body on its column.  The stage is block-synchronous, so rows past B run
// it too (on zero rows).  Its shared memory (71 KB at the skewed flagship,
// any H) holds three blocks (12 warps, as many as the body's registers
// allow) per SM; a staged hidden tile (70 KB alone at H = 128) would hold
// two, and the body, latency-bound, ran ~1.6x slower there.  One block per
// tile: persistent blocks walking the tiles were no faster.  The density
// and sample kernels call the same __device__ functions and the library is
// built without fast-math, so the f32 sample -> log_prob roundtrip cancels.
#include <cuda_runtime.h>

#include "gf_layer_src.cuh"
#include "occupancy.cuh"

using namespace gf;

namespace {

constexpr int FORWARD = 0, SAMPLE = 1, INVERSE = 2;
constexpr int SMEM_LIMIT = 227 * 1024;

// One row's pass of dimension dd (element i of x): the value (FORWARD) or
// the root (SAMPLE, INVERSE) into out, and the log-derivative into ld.  M:
// the source's mixture (MixT), or one with its row-independent terms
// prepared (MixFT).  ROLLED (the broadcast kernels): the plain mixture's
// solve, and in SAMPLE its root's log-derivative, as one rolled loop
// (solve_rolled, solve_log_deriv_rolled: the same bits as the unrolled
// forms).  The skewed solve stays unrolled: at 96 registers (5 blocks per
// SM) its rolled loop was 11% slower (PERF.md).
template <bool SKEW, int MODE, int N, int KT, bool ROLLED = false, class M>
__device__ __forceinline__ void row_pass(const LayerArgs& a, const M& mx,
                                         int K, size_t i) {
  const float xv = a.x[i];
  if constexpr (MODE == FORWARD) {
    float lg;
    float val;
    if constexpr (SKEW)
      val = skew_density_pass<N, KT>(xv, mx, K, a.n_pos, a.ift, lg);
    else
      val = density_pass<N, KT>(xv, mx, K, a.ift, lg);
    a.out[i] = val;
    a.ld[i] = lg;
  } else if constexpr (ROLLED && !SKEW && MODE == SAMPLE) {
    float lg;
    a.out[i] = solve_log_deriv_rolled<N, KT>(xv, mx, K, a.ift, lg);
    a.ld[i] = lg;
  } else if constexpr (ROLLED && !SKEW && MODE == INVERSE) {
    a.out[i] = solve_rolled<N, KT>(xv, mx, K, a.ift);
  } else {
    float root;
    if constexpr (SKEW)
      root = skew_solve<N, KT>(xv, mx, K, a.n_pos, a.ift);
    else
      root = solve<N, KT>(xv, mx, K, a.ift);
    a.out[i] = root;
    if (MODE == SAMPLE) {
      float lg;
      if constexpr (SKEW)
        skew_density_pass<N, KT>(root, mx, K, a.n_pos, a.ift, lg);
      else
        lg = solve_log_deriv<N, KT>(root, mx, K, a.ift);
      a.ld[i] = lg;
    }
  }
}

// T4-T6 lazy and per row (prepared or raw): one block per 128-row tile;
// T6's plain solve rolled.
template <bool LAZY, bool SKEW, int MODE, int KT>
__global__ void __launch_bounds__(128) gf_layer_kernel(const LayerArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : a.K;
  if constexpr (LAZY) {
    const LayerStreamSrc<SKEW, N, KT> src(a, smem);
    const int row0 = blockIdx.x * blockDim.x;
    const int row = row0 + threadIdx.x;
    for (int dd = 0; dd < a.D; ++dd) {
      // forward: a skewed flagship piece (40 rows) in one W chunk; sample:
      // 32-row chunks, whose accumulators keep the skewed solve at 168
      // registers (3 blocks per SM; with 40 rows it took 221, 2 blocks)
      src.template stage<MODE == FORWARD ? 5 : 4>(a, row0, dd);
      if (row < a.B) {
        MixT<SKEW, N> mx;
        float lw[N], ln[N], se[N];
        src.load(a, mx, lw, ln, se);
        row_pass<SKEW, MODE, N, KT>(a, mx, K, (size_t)row * a.D + dd);
      }
    }
  } else {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    const LayerSrc<SKEW, N, KT> src(a, smem);
    if (row >= a.B) return;
    for (int dd = 0; dd < a.D; ++dd) {
      MixT<SKEW, N> mx;
      float lw[N], ln[N], se[N];
      src.load(a, row, dd, mx, lw, ln, se);
      // the plain solve alone (T6 per row): the broadcast kernels' rolled
      // solve on the row's mixture with its row-independent terms made once
      if constexpr (MODE == INVERSE && !SKEW)
        row_pass<SKEW, MODE, N, KT, true>(a, with_row_terms<N, KT>(mx, K), K,
                                          (size_t)row * a.D + dd);
      else
        row_pass<SKEW, MODE, N, KT>(a, mx, K, (size_t)row * a.D + dd);
    }
  }
}

// The broadcast forward kernels' register caps, the launch bounds' minimum
// of resident blocks per SM (tools/tile_breakdown.py --part layer_fwd_raw,
// layer_prep)
constexpr int BCAST_MIN_BLOCKS_FORWARD = 4, BCAST_MIN_BLOCKS_SAMPLE = 5;
constexpr int BCAST_MIN_BLOCKS_INVERSE = 5;

// T4 / T5 / T6 on raw broadcast slabs (gf_forward_raw, gf_sample_raw,
// gf_inverse_raw): a grid of persistent blocks (persistent_grid), each
// preparing the mixtures once (BcastSrc: one (dimension, component) a
// thread, with the row-independent terms of MixF), then, one dimension at a
// time, walking the tiles blockIdx.x, blockIdx.x + gridDim.x, ... of 128
// rows, a row a thread, with that dimension's mixture in registers; the
// plain mixture's solve rolled.  No barrier follows the set-up.
template <bool SKEW, int MODE, int KT>
__global__ void __launch_bounds__(128, MODE == SAMPLE ? BCAST_MIN_BLOCKS_SAMPLE : MODE == INVERSE ? BCAST_MIN_BLOCKS_INVERSE : BCAST_MIN_BLOCKS_FORWARD)
    gf_layer_bcast_kernel(const LayerArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : a.K;
  const BcastSrc<SKEW, N, KT> src(a, smem);
  const int n_tiles = (a.B + blockDim.x - 1) / blockDim.x;
  for (int dd = 0; dd < a.D; ++dd) {
    MixFT<SKEW, N> mx;
    src.load(a, dd, mx);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row = tile * blockDim.x + threadIdx.x;
      if (row >= a.B) break;
      row_pass<SKEW, MODE, N, KT, true>(a, mx, K, (size_t)row * a.D + dd);
    }
  }
}

// T4 / T6 on prepared broadcast slabs (gf_forward_pallas,
// gf_inverse_pallas): gf_layer_bcast_kernel's design on BcastSrc's
// prepared set-up (PREP).  A kernel of its own, so that the raw broadcast
// kernels keep their code.
template <int MODE, int KT>
__global__ void __launch_bounds__(128, MODE == INVERSE ? BCAST_MIN_BLOCKS_INVERSE : BCAST_MIN_BLOCKS_FORWARD)
    gf_layer_prep_kernel(const LayerArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : a.K;
  const BcastSrc<false, N, KT, true> src(a, smem);
  const int n_tiles = (a.B + blockDim.x - 1) / blockDim.x;
  for (int dd = 0; dd < a.D; ++dd) {
    MixF<N> mx;
    src.load(a, dd, mx);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row = tile * blockDim.x + threadIdx.x;
      if (row >= a.B) break;
      row_pass<false, MODE, N, KT, true>(a, mx, K, (size_t)row * a.D + dd);
    }
  }
}

// a call the broadcast kernels take: broadcast slabs, prepared or raw
inline bool bcast_call(bool lazy, const LayerArgs& a) {
  return !lazy && !a.per_row;
}

// The kernel of a call and its grid: the broadcast kernels' persistent
// blocks (blocks per SM x SMs, at most one per tile), else one block per
// tile.  0 or a cudaError_t.
template <bool LAZY, bool SKEW, int MODE, int KT>
cudaError_t kernel_grid(const LayerArgs& a, int threads, size_t smem,
                        const void*& kernel, int& blocks) {
  const int n_tiles = (a.B + threads - 1) / threads;
  blocks = n_tiles;
  if (!bcast_call(LAZY, a)) {
    kernel = (const void*)gf_layer_kernel<LAZY, SKEW, MODE, KT>;
    return cudaSuccess;
  }
  if constexpr (!LAZY) {
    if constexpr (!SKEW) {
      if (a.prepared) {
        kernel = (const void*)gf_layer_prep_kernel<MODE, KT>;
        return persistent_grid(kernel, threads, smem, n_tiles, blocks);
      }
    }
    kernel = (const void*)gf_layer_bcast_kernel<SKEW, MODE, KT>;
    return persistent_grid(kernel, threads, smem, n_tiles, blocks);
  }
  return cudaErrorInvalidValue;
}

// Launch on `stream`, or with occupancy non-null write the kernel's
// resident blocks per SM there instead (the CUDA occupancy API), or with
// grid non-null write the call's [blocks, threads] there.
template <bool LAZY, bool SKEW, int MODE, int KT>
cudaError_t launch(const LayerArgs& a, int threads, size_t smem,
                   cudaStream_t stream, int* occupancy, int* grid) {
  const void* kernel = nullptr;
  int blocks = 0;
  cudaError_t e = kernel_grid<LAZY, SKEW, MODE, KT>(a, threads, smem, kernel,
                                                     blocks);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel,
                                                         threads, smem);
  if (grid) {
    grid[0] = blocks;
    grid[1] = threads;
    return cudaSuccess;
  }
  void* args[] = {const_cast<LayerArgs*>(&a)};
  return cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, smem,
                          stream);
}

template <bool LAZY, bool SKEW, int MODE>
cudaError_t dispatch_k(const LayerArgs& a, int threads, size_t smem,
                       cudaStream_t s, int* occ, int* grid) {
  if (a.K == 10)
    return launch<LAZY, SKEW, MODE, 10>(a, threads, smem, s, occ, grid);
  return launch<LAZY, SKEW, MODE, 0>(a, threads, smem, s, occ, grid);
}

template <bool LAZY, bool SKEW>
cudaError_t dispatch_mode(int mode, const LayerArgs& a, int threads,
                          size_t smem, cudaStream_t s, int* occ, int* grid) {
  if (mode == FORWARD)
    return dispatch_k<LAZY, SKEW, FORWARD>(a, threads, smem, s, occ, grid);
  if (mode == SAMPLE)
    return dispatch_k<LAZY, SKEW, SAMPLE>(a, threads, smem, s, occ, grid);
  if constexpr (LAZY) {
    return cudaErrorInvalidValue;  // the lazy interface has no solve-alone
  } else {
    return dispatch_k<LAZY, SKEW, INVERSE>(a, threads, smem, s, occ, grid);
  }
}

cudaError_t dispatch(int mode, bool lazy, bool skew, const LayerArgs& a,
                     int threads, size_t smem, cudaStream_t s, int* occ,
                     int* grid) {
  if (lazy)
    return skew ? dispatch_mode<true, true>(mode, a, threads, smem, s, occ, grid)
                : dispatch_mode<true, false>(mode, a, threads, smem, s, occ, grid);
  return skew ? dispatch_mode<false, true>(mode, a, threads, smem, s, occ, grid)
              : dispatch_mode<false, false>(mode, a, threads, smem, s, occ, grid);
}

// A call's rows per block and dynamic shared memory (the lazy tile:
// a.tile); 0 or cudaErrorInvalidValue when none fits.
int block_shape(LayerArgs& a, bool lazy, int& threads, size_t& smem) {
  threads = 128;
  if (lazy) {
    a.stream = layer_stream_shape(a.n_groups * a.K);
    threads = a.stream.T;
    smem = a.stream.floats() * 4;
  } else {
    smem = layer_src_floats(a, bcast_call(lazy, a)) * 4;
  }
  return smem > SMEM_LIMIT ? (int)cudaErrorInvalidValue : 0;
}

// A call's arguments from its meta ints (gf_layer_launch); 0 or
// cudaErrorInvalidValue when the kernels do not take them.
int parse_meta(const int* meta, LayerArgs& a) {
  const int mode = meta[0], lazy = meta[1], skew = meta[2];
  a.prepared = meta[3];
  a.per_row = meta[4];
  a.B = meta[5];
  a.K = meta[6];
  a.D = meta[7];
  a.H = meta[8];
  a.fit_norm = meta[9];
  a.n_pos = meta[10];
  a.ift = meta[11];
  a.n_groups = a.prepared ? 3 : 2 + a.fit_norm + skew;
  if (mode < 0 || mode > 2 || a.K < 1 || a.K > KMAX || a.D < 1 ||
      a.D > DMAX || a.B < 0 || a.ift < 0 || a.ift > 3 ||
      a.n_pos < 0 || a.n_pos > a.K || (a.prepared && (skew || lazy)) ||
      (lazy && (a.H < 1 || mode == 2)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// meta: [mode (0 forward, 1 sample, 2 inverse), lazy, skew, prepared,
//        per_row, B, K, D, H, fit_norm, n_pos, ift, wreg kind, nreg kind,
//        ereg kind]
// regs: [wreg a, b, c, lo, hi, nreg ..., ereg ...]
// p0..p3: the slabs in group order (prepared: means, inverse widths, log
// weights; raw: means, raw log-widths, [raw log-norms], [raw exponents]);
// hidden, w, b: the lazy interface.  ld may be null for mode 2.  Returns 0
// or a cudaError_t; launches on `stream` and does not synchronize.
extern "C" int gf_layer_launch(const int* meta, const float* regs,
                               const float* x, float* out, float* ld,
                               const float* p0, const float* p1,
                               const float* p2, const float* p3,
                               const float* hidden, const float* w,
                               const float* b, void* stream) {
  const int mode = meta[0], lazy = meta[1], skew = meta[2];
  LayerArgs a{};
  if (parse_meta(meta, a) != 0) return (int)cudaErrorInvalidValue;
  a.x = x;
  a.out = out;
  a.ld = ld;
  a.p[0] = p0;
  a.p[1] = p1;
  a.p[2] = p2;
  a.p[3] = p3;
  a.hidden = hidden;
  a.w = w;
  a.b = b;
  a.wreg = Reg{meta[12], regs[0], regs[1], regs[2], regs[3], regs[4]};
  a.nreg = Reg{meta[13], regs[5], regs[6], regs[7], regs[8], regs[9]};
  a.ereg = Reg{meta[14], regs[10], regs[11], regs[12], regs[13], regs[14]};
  if ((lazy && (hidden == nullptr || w == nullptr || b == nullptr)) ||
      (mode != 2 && ld == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!lazy)
    for (int g = 0; g < a.n_groups; ++g)
      if (a.p[g] == nullptr) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;

  int threads;
  size_t smem;
  if (block_shape(a, lazy, threads, smem) != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(mode, lazy, skew, a, threads, smem,
                       (cudaStream_t)stream, nullptr, nullptr);
}

// The grid a call of these meta ints (gf_layer_launch's) launches on the
// current device: out = [blocks, threads per block].  0 or a cudaError_t.
extern "C" int gf_layer_grid(const int* meta, int* out) {
  LayerArgs a{};
  int threads;
  size_t smem;
  if (parse_meta(meta, a) != 0 || a.B < 1 ||
      block_shape(a, meta[1], threads, smem) != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(meta[0], meta[1], meta[2], a, threads, smem, nullptr,
                       nullptr, out);
}

// Resident blocks per SM of the kernel a call of this (mode, lazy, skew,
// K, D, H, n_groups, prepared) launches, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (lazy 0: broadcast slabs,
// raw or prepared); writes [blocks per SM, threads per block, dynamic
// shared memory bytes] to out.  Returns 0 or a cudaError_t.
extern "C" int gf_layer_occupancy(int mode, int lazy, int skew, int K, int D,
                                  int H, int n_groups, int* out,
                                  int prepared) {
  LayerArgs a{};
  a.B = 1;
  a.K = K;
  a.D = D;
  a.H = H;
  a.n_groups = n_groups;
  a.per_row = lazy;
  a.prepared = prepared;
  int threads;
  size_t smem;
  if (mode < 0 || mode > 2 || K < 1 || K > KMAX || D < 1 || D > DMAX ||
      (lazy && H < 1) || (prepared && (lazy || skew)) ||
      block_shape(a, lazy, threads, smem) != 0)
    return (int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t e =
      dispatch(mode, lazy, skew, a, threads, smem, nullptr, &n, nullptr);
  out[0] = n;
  out[1] = threads;
  out[2] = (int)smem;
  return (int)e;
}

extern "C" const char* gf_layer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
