// Whole-block Gaussianization-flow kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel jammy_flows_tpu/ops/pallas_gf_block.py
// `_block_call` (body `_make_block_kernel`, `_block_density_local` and
// `_block_sample_local`): a whole `gggg` stack of one sub-manifold in one
// launch per direction, with the parameters broadcast from one permanent
// vector ("perm"), predicted per row by the fused one-hidden-layer tanh
// amortization MLP inside the kernel ("lazy2"), or made per row from the
// MLP's precomputed hidden activations by its final product inside the
// kernel ("lazy", `gf_block_density_lazy` / `gf_block_sample_lazy`, for an
// MLP of more than one hidden layer or a summary wider than 128).
//
//   density (log_prob), layers in reverse:
//       x -= offset;  x = R_l^T x;  (x, ld_l) = mixture iCDF pass of x
//   sample, layers in order:
//       x = Newton solve;  ld += ld_l(x);  x = R_l x;  x += offset
//
// What bounds it on an H100: not memory.  A row reads d + In floats (lazy:
// d + H) and writes 2d; everything else is arithmetic.  lazy2 and lazy
// spend ~2*P*H flops per row on the final MLP product (P = 548, H = 128 on
// the flagship: 140 kflop per row) and each mixture evaluation ~K
// transcendental-heavy terms per dimension (the sample direction evaluates
// it ~6 times per layer and dimension).  The P x H product runs on the
// tensor cores; the rest is f32 on the CUDA cores and the SFU.
//
// Design:
//   * one thread per batch row; a mixture of one dimension (K means,
//     inverse widths, weights) lives in registers; K = 10, d = 4 (the
//     flagship) is a compile-time instantiation, other shapes use the
//     generic one (local arrays);
//   * perm (gf_block_perm_kernel; gf_block_src.cuh PermSrc): a fixed grid
//     of persistent blocks ((occupancy API blocks per SM) x SMs, at most
//     one per tile) walks the tiles of 128 rows.  Each block prepares the
//     (P,) vector once in shared memory, a mixture component a thread,
//     with each component's row-independent terms (lnw + log(iw), nw *
//     iw: MixF), so that a row evaluates no log(iw).  MixF also takes
//     1 / (1 + e) without the IEEE reciprocal's range check and slow-path
//     branch (recip_ge1: the same bits) and the Newton steps as a loop,
//     not unrolled (a quarter of the solve's code).  What is left is
//     latency-bound (PERF.md): the sample's four Newton steps are ~90% of
//     it, at 7 blocks (28 warps) per SM;
//   * lazy2 and lazy (TileSrc): a block of T = 128 rows (64 or 32 while
//     the tile does not fit: H > 454) keeps its rows' hidden activations
//     in shared memory (lazy2 makes each row's column; lazy copies the
//     precomputed (B, H) rows, coalesced), then makes the parameter rows a
//     piece at a time (a layer's offset and reflections, one dimension's
//     3K mixture rows) as a 3xTF32 mma.sync product of the hidden tile and
//     w's rows, streamed by cp.async, into a shared slab each row reads;
//     lazy2 111 KB at H = 128, two blocks (8 warps) per SM; lazy, its
//     slabs' rows rounded to 8 / 16 instead of 32 (lazy_tile), 73 KB at
//     the "64-64" flagship's H = 64, three blocks (12 warps).  Rows past B
//     run the body on zeros (the stages are block-synchronous) and write
//     nothing.
// wgmma and TMA for the tile products are later work.
#include <cuda_runtime.h>

#include "gf_block_src.cuh"
#include "occupancy.cuh"

using namespace gf;

namespace {

template <int MODE, int KT, int DT>
__global__ void __launch_bounds__(128)
gf_block_density_kernel(const BlockArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const int K = KT > 0 ? KT : a.K;
  const int D = DT > 0 ? DT : a.D;
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const auto src = make_src<MODE, KT, DT>(a, smem, row);
  // the stages are block-synchronous: a row past B runs the body on zeros
  // and writes nothing
  const bool valid = row < a.B;

  float x[DN], ld[DN];
  for (int j = 0; j < D; ++j) {
    x[j] = valid ? a.x[(size_t)row * D + j] : 0.0f;
    ld[j] = 0.0f;
  }
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const LayerMeta& lm = a.layers[l];
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
  if (!valid) return;
  for (int j = 0; j < D; ++j) {
    a.out[(size_t)row * D + j] = x[j];
    a.ld[(size_t)row * D + j] = ld[j];
  }
}

template <int MODE, int KT, int DT>
__global__ void __launch_bounds__(128)
gf_block_sample_kernel(const BlockArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const int K = KT > 0 ? KT : a.K;
  const int D = DT > 0 ? DT : a.D;
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const auto src = make_src<MODE, KT, DT>(a, smem, row);
  const bool valid = row < a.B;

  float x[DN], ld[DN];
  for (int j = 0; j < D; ++j) {
    x[j] = valid ? a.x[(size_t)row * D + j] : 0.0f;
    ld[j] = 0.0f;
  }
  for (int l = 0; l < a.n_layers; ++l) {
    const LayerMeta& lm = a.layers[l];
    for (int dd = 0; dd < D; ++dd) {
      src.stage_mix(a, lm, dd);
      Mix<N> mx;
      src.load_mix(mx, lm, K, D, dd, a);
      x[dd] = solve<N, KT>(x[dd], mx, K, lm.ift);
      ld[dd] = ld[dd] + solve_log_deriv<N, KT>(x[dd], mx, K, lm.ift);
    }
    src.stage_rot(a, lm);
    const int rot0 = lm.row0 + (lm.has_off ? D : 0);
    for (int i = lm.rot_it - 1; i >= 0; --i) reflect<DN>(src, rot0 + i * D, x, D);
    if (lm.has_off)
      for (int j = 0; j < D; ++j) x[j] = x[j] + src.param(lm.row0 + j);
  }
  if (!valid) return;
  for (int j = 0; j < D; ++j) {
    a.out[(size_t)row * D + j] = x[j];
    a.ld[(size_t)row * D + j] = ld[j];
  }
}

// ---- perm: one broadcast (P,) vector ----------------------------------------
constexpr int PERM_THREADS = 128;
// resident blocks per SM the launch bounds ask for (registers: 64 and 73
// at most), per direction
constexpr int PERM_MIN_BLOCKS_DENSITY = 8;
constexpr int PERM_MIN_BLOCKS_SAMPLE = 7;

// The density direction of one row, layers in reverse.
template <int N, int KT, int DN>
__device__ __forceinline__ void perm_density_row(const BlockArgs& a,
                                                 const PermSrc<N, KT, DN>& src,
                                                 int K, int D, float* x,
                                                 float* ld) {
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const LayerMeta& lm = a.layers[l];
    int r = lm.row0;
    if (lm.has_off) {
      for (int j = 0; j < D; ++j) x[j] = x[j] - src.param(r + j);
      r += D;
    }
    for (int i = 0; i < lm.rot_it; ++i) reflect<DN>(src, r + i * D, x, D);
    for (int dd = 0; dd < D; ++dd) {
      MixF<N> mx;
      src.load_mixf(mx, lm, K, D, dd);
      float lg;
      x[dd] = density_pass<N, KT>(x[dd], mx, K, lm.ift, lg);
      ld[dd] = ld[dd] + lg;
    }
  }
}

// The sample direction of one row, layers in order.
template <int N, int KT, int DN>
__device__ __forceinline__ void perm_sample_row(const BlockArgs& a,
                                                const PermSrc<N, KT, DN>& src,
                                                int K, int D, float* x,
                                                float* ld) {
  for (int l = 0; l < a.n_layers; ++l) {
    const LayerMeta& lm = a.layers[l];
    for (int dd = 0; dd < D; ++dd) {
      MixF<N> mx;
      src.load_mixf(mx, lm, K, D, dd);
      float lg;
      x[dd] = solve_log_deriv_rolled<N, KT>(x[dd], mx, K, lm.ift, lg);
      ld[dd] = ld[dd] + lg;
    }
    const int rot0 = lm.row0 + (lm.has_off ? D : 0);
    for (int i = lm.rot_it - 1; i >= 0; --i) reflect<DN>(src, rot0 + i * D, x, D);
    if (lm.has_off)
      for (int j = 0; j < D; ++j) x[j] = x[j] + src.param(lm.row0 + j);
  }
}

// T1 perm: each block prepares PermSrc once, then walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of blockDim.x rows, a row a
// thread.  No barrier follows the set-up.
template <bool SAMPLE, int KT, int DT>
__global__ void __launch_bounds__(PERM_THREADS,
                                  SAMPLE ? PERM_MIN_BLOCKS_SAMPLE
                                         : PERM_MIN_BLOCKS_DENSITY)
gf_block_perm_kernel(const BlockArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const int K = KT > 0 ? KT : a.K;
  const int D = DT > 0 ? DT : a.D;
  extern __shared__ __align__(16) float smem[];
  const PermSrc<N, KT, DN> src(a, smem);
  const int n_tiles = (a.B + blockDim.x - 1) / blockDim.x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * blockDim.x + threadIdx.x;
    if (row >= a.B) break;
    float x[DN], ld[DN];
    for (int j = 0; j < D; ++j) {
      x[j] = a.x[(size_t)row * D + j];
      ld[j] = 0.0f;
    }
    if (SAMPLE)
      perm_sample_row<N, KT, DN>(a, src, K, D, x, ld);
    else
      perm_density_row<N, KT, DN>(a, src, K, D, x, ld);
    for (int j = 0; j < D; ++j) {
      a.out[(size_t)row * D + j] = x[j];
      a.ld[(size_t)row * D + j] = ld[j];
    }
  }
}

// The exhaustive check of recip_ge1 (gf_common.cuh): over every float d
// whose bits lie in [lo, hi), the count of those whose recip_ge1(d)
// differs in its bits from the IEEE reciprocal 1.0f / d.
__global__ void recip_check_kernel(unsigned lo, unsigned hi,
                                   unsigned long long* count) {
  unsigned long long bad = 0;
  for (unsigned b = lo + blockIdx.x * blockDim.x + threadIdx.x; b < hi;
       b += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(b);
    bad += __float_as_uint(recip_ge1(d)) != __float_as_uint(1.0f / d);
  }
  atomicAdd(count, bad);
}

constexpr int SMEM_LIMIT = 227 * 1024;

using Kernel = void (*)(const BlockArgs);

template <int MODE>
Kernel kernel_of(bool sample, const BlockArgs& a) {
  if (a.K == 10 && a.D == 4)
    return sample ? gf_block_sample_kernel<MODE, 10, 4>
                  : gf_block_density_kernel<MODE, 10, 4>;
  return sample ? gf_block_sample_kernel<MODE, 0, 0>
                : gf_block_density_kernel<MODE, 0, 0>;
}

template <bool SAMPLE>
Kernel perm_kernel_of(const BlockArgs& a) {
  if (a.K == 10 && a.D == 4) return gf_block_perm_kernel<SAMPLE, 10, 4>;
  return gf_block_perm_kernel<SAMPLE, 0, 0>;
}

Kernel kernel_of(int mode, bool sample, const BlockArgs& a) {
  if (mode == LAZY2) return kernel_of<LAZY2>(sample, a);
  if (mode == LAZYH) return kernel_of<LAZYH>(sample, a);
  return sample ? perm_kernel_of<true>(a) : perm_kernel_of<false>(a);
}

// The perm kernels' grid: one persistent block per resident slot
// (blocks per SM x SMs), at most one per tile of PERM_THREADS rows.
int perm_grid(int n_tiles, int per_sm, int n_sm) {
  const int cap = (per_sm > 1 ? per_sm : 1) * n_sm;
  return n_tiles < cap ? n_tiles : cap;
}

// The block of a call: its rows (threads) and dynamic shared memory; lazy2
// and lazy also set a.tile.  0 or cudaErrorInvalidValue.
int block_shape(int mode, BlockArgs& a, int& threads, size_t& smem) {
  threads = 128;
  if (mode == LAZY2 || mode == LAZYH) {
    a.tile = mode == LAZY2 ? lazy2_tile(a) : lazy_tile(a);
    if (a.tile.T == 0) return (int)cudaErrorInvalidValue;
    threads = a.tile.T;
    smem = a.tile.floats() * 4;
  } else {
    threads = PERM_THREADS;
    smem = (size_t)PermSrc<1, 0, 1>::FLOATS_PER_ROW * a.P * 4;
  }
  return smem > SMEM_LIMIT ? (int)cudaErrorInvalidValue : 0;
}

// The perm kernel's grid for a.B rows on the current device (perm_grid).
cudaError_t perm_blocks(Kernel kernel, const BlockArgs& a, int threads,
                        size_t smem, int& blocks) {
  int dev, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = blocks_per_sm((const void*)kernel, threads, smem, dev, per_sm);
  blocks = perm_grid((a.B + PERM_THREADS - 1) / PERM_THREADS, per_sm, n_sm);
  return e;
}

cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// mode: 0 perm (pvec), 1 lazy2 (summary, w1, b1, w, b), 2 lazy (hidden,
// w, b).  meta: [K, D, n_layers, fit_norm, wreg kind, nreg kind,
//        then per layer: has_off, rot_it, has_ln, ift]
// regs: [wreg a, b, c, lo, hi, nreg a, b, c, lo, hi]
// Returns 0 or a cudaError_t; launches on `stream` and does not synchronize.
extern "C" int gf_block_launch(int sample, int mode, const float* x,
                               float* out, float* ld, int B, const float* pvec,
                               const float* summary, const float* w1,
                               const float* b1, const float* w, const float* b,
                               const float* hidden, int n_in, int H, int P,
                               const int* meta, const float* regs,
                               void* stream) {
  BlockArgs a{};
  a.x = x;
  a.out = out;
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
  if (parse_meta(a, mode, meta, P) != 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (mode != PERM &&
      (H < 1 || w == nullptr || b == nullptr ||
       (mode == LAZY2 && (n_in < 1 || summary == nullptr)) ||
       (mode == LAZYH && hidden == nullptr)))
    return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  if (block_shape(mode, a, threads, smem) != 0)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_of(mode, sample, a);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = (B + threads - 1) / threads;
  if (mode == PERM) {
    e = perm_blocks(kernel, a, threads, smem, blocks);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel a call with this (mode, H, P, meta)
// launches, by cudaOccupancyMaxActiveBlocksPerMultiprocessor; writes
// [blocks per SM, threads per block, dynamic shared memory bytes] to out.
extern "C" int gf_block_occupancy(int sample, int mode, int H, int P,
                                  const int* meta, int* out) {
  BlockArgs a{};
  a.H = H;
  a.P = P;
  if (parse_meta(a, mode, meta, P) != 0 || (mode != PERM && H < 1))
    return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  if (block_shape(mode, a, threads, smem) != 0)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_of(mode, sample, a);
  cudaError_t e = allow_smem(kernel, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem);
  out[0] = n;
  out[1] = threads;
  out[2] = (int)smem;
  return (int)e;
}

// The perm kernel's grid for B rows (sample: the sample direction) on the
// current device: out = [blocks, rows per tile].  0 or a cudaError_t.
extern "C" int gf_block_perm_grid(int sample, int B, int P, const int* meta,
                                  int* out) {
  BlockArgs a{};
  a.P = P;
  a.B = B;
  if (parse_meta(a, PERM, meta, P) != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  if (block_shape(PERM, a, threads, smem) != 0)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_of(PERM, sample, a);
  cudaError_t e = allow_smem(kernel, smem);
  int blocks = 0;
  if (e == cudaSuccess) e = perm_blocks(kernel, a, threads, smem, blocks);
  out[0] = blocks;
  out[1] = PERM_THREADS;
  return (int)e;
}

// recip_check_kernel over the bit patterns [lo, hi) (hi <= 0x7f800000),
// adding its count to *count (device memory); 0 or a cudaError_t.
extern "C" int gf_block_recip_mismatches(unsigned lo, unsigned hi,
                                         unsigned long long* count,
                                         void* stream) {
  if (lo > hi || hi > 0x7f800000u) return (int)cudaErrorInvalidValue;
  recip_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(lo, hi, count);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
