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
// it ~6 times per layer and dimension).  In lazy2 the P x H product runs on
// the tensor cores; the rest is f32 on the CUDA cores and the SFU.
//
// Design:
//   * one thread per batch row; a mixture of one dimension (K means,
//     inverse widths, weights) lives in registers; K = 10, d = 4 (the
//     flagship) is a compile-time instantiation, other shapes use the
//     generic one (local arrays);
//   * perm (gf_block_src.cuh PermSrc): the (P,) vector prepared once per
//     128-row block in shared memory;
//   * lazy2 (TileSrc): a block of T = 128 rows (64 or 32 while the tile
//     does not fit: H > 454) makes each row's hidden column in shared
//     memory, then the parameter rows a piece at a time (a layer's offset
//     and reflections, one dimension's 3K mixture rows) as a 3xTF32
//     mma.sync product of the hidden tile and w's rows, streamed by
//     cp.async, into a shared slab each row reads; 111 KB at H = 128, two
//     blocks (8 warps) per SM.  Rows past B run the body on zeros (the
//     stages are block-synchronous) and write nothing;
//   * lazy (LazySrc): each row's hidden column in shared memory (H x 128
//     floats, conflict-free; 64 or 32 rows per block above H = 454) and
//     the parameter rows made on demand per thread from w through L1/L2.
// wgmma and TMA for the tile products are later work.
#include <cuda_runtime.h>

#include "gf_block_src.cuh"

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
  // lazy2's stages are block-synchronous: a row past B runs the body on
  // zeros and writes nothing
  const bool valid = row < a.B;
  if (MODE != LAZY2 && !valid) return;

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
  if (MODE != LAZY2 && !valid) return;

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

Kernel kernel_of(int mode, bool sample, const BlockArgs& a) {
  if (mode == LAZY2) return kernel_of<LAZY2>(sample, a);
  if (mode == LAZYH) return kernel_of<LAZYH>(sample, a);
  return kernel_of<PERM>(sample, a);
}

// The block of a call: its rows (threads) and dynamic shared memory; lazy2
// also sets a.tile.  0 or cudaErrorInvalidValue.
int block_shape(int mode, BlockArgs& a, int& threads, size_t& smem) {
  threads = 128;
  if (mode == LAZY2) {
    a.tile = lazy2_tile(a);
    if (a.tile.T == 0) return (int)cudaErrorInvalidValue;
    threads = a.tile.T;
    smem = a.tile.floats() * 4;
  } else if (mode == LAZYH) {
    while (threads > 32 && (size_t)a.H * threads * 4 > SMEM_LIMIT) threads /= 2;
    smem = (size_t)a.H * threads * 4;
  } else {
    smem = (size_t)4 * a.P * 4;
  }
  return smem > SMEM_LIMIT ? (int)cudaErrorInvalidValue : 0;
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
  const int blocks = (B + threads - 1) / threads;
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

extern "C" const char* gf_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
