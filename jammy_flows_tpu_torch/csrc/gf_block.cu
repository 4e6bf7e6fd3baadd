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
// the flagship: 140 kflop per row) and
// each mixture evaluation ~K transcendental-heavy terms per dimension (the
// sample direction evaluates it ~6 times per layer and dimension), all in
// f32 on the CUDA cores: the kernel is bound by FP32 and SFU throughput.
//
// Design, simple first:
//   * one thread per batch row, 128 rows per block;
//   * the parameter sources of gf_block_src.cuh: perm prepared once per
//     block in shared memory; lazy2 and lazy with each row's hidden column
//     in shared memory (H x 128 floats, conflict-free; 64 or 32 rows per
//     block above H = 454) and the parameter rows made on demand from
//     w (280 KB on the flagship) through L1/L2;
//   * a mixture of one dimension (K means, inverse widths, weights) lives in
//     registers; K = 10, d = 4 (the flagship) is a compile-time
//     instantiation, other shapes use the generic one (local arrays).
// Tensor cores, TMA and wgmma for the MLP are later work.
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
  extern __shared__ float smem[];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const auto src = make_src<MODE, KT, DT>(a, smem, row);
  if (row >= a.B) return;

  float x[DN], ld[DN];
  for (int j = 0; j < D; ++j) {
    x[j] = a.x[(size_t)row * D + j];
    ld[j] = 0.0f;
  }
  for (int l = a.n_layers - 1; l >= 0; --l) {
    const LayerMeta& lm = a.layers[l];
    int r = lm.row0;
    if (lm.has_off) {
      for (int j = 0; j < D; ++j) x[j] = x[j] - src.param(r + j);
      r += D;
    }
    for (int i = 0; i < lm.rot_it; ++i) reflect<DN>(src, r + i * D, x, D);
    for (int dd = 0; dd < D; ++dd) {
      Mix<N> mx;
      src.load_mix(mx, lm, K, D, dd, a);
      float lg;
      x[dd] = density_pass<N, KT>(x[dd], mx, K, lm.ift, lg);
      ld[dd] = ld[dd] + lg;
    }
  }
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
  extern __shared__ float smem[];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const auto src = make_src<MODE, KT, DT>(a, smem, row);
  if (row >= a.B) return;

  float x[DN], ld[DN];
  for (int j = 0; j < D; ++j) {
    x[j] = a.x[(size_t)row * D + j];
    ld[j] = 0.0f;
  }
  for (int l = 0; l < a.n_layers; ++l) {
    const LayerMeta& lm = a.layers[l];
    for (int dd = 0; dd < D; ++dd) {
      Mix<N> mx;
      src.load_mix(mx, lm, K, D, dd, a);
      x[dd] = solve<N, KT>(x[dd], mx, K, lm.ift);
      ld[dd] = ld[dd] + solve_log_deriv<N, KT>(x[dd], mx, K, lm.ift);
    }
    const int rot0 = lm.row0 + (lm.has_off ? D : 0);
    for (int i = lm.rot_it - 1; i >= 0; --i) reflect<DN>(src, rot0 + i * D, x, D);
    if (lm.has_off)
      for (int j = 0; j < D; ++j) x[j] = x[j] + src.param(lm.row0 + j);
  }
  for (int j = 0; j < D; ++j) {
    a.out[(size_t)row * D + j] = x[j];
    a.ld[(size_t)row * D + j] = ld[j];
  }
}

constexpr int SMEM_LIMIT = 227 * 1024;

template <int MODE, int KT, int DT>
cudaError_t launch(bool sample, const BlockArgs& a, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kernel = sample ? gf_block_sample_kernel<MODE, KT, DT>
                       : gf_block_density_kernel<MODE, KT, DT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.B + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(bool sample, const BlockArgs& a, int threads, size_t smem,
                     cudaStream_t stream) {
  if (a.K == 10 && a.D == 4)
    return launch<MODE, 10, 4>(sample, a, threads, smem, stream);
  return launch<MODE, 0, 0>(sample, a, threads, smem, stream);
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
  a.K = meta[0];
  a.D = meta[1];
  a.n_layers = meta[2];
  a.fit_norm = meta[3];
  a.wreg = Reg{meta[4], regs[0], regs[1], regs[2], regs[3], regs[4]};
  a.nreg = Reg{meta[5], regs[5], regs[6], regs[7], regs[8], regs[9]};
  if (mode < PERM || mode > LAZYH || a.K < 1 || a.K > KMAX || a.D < 1 ||
      a.D > DMAX || a.n_layers < 1 || a.n_layers > MAX_LAYERS || B < 0)
    return (int)cudaErrorInvalidValue;
  int row = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int* m = meta + 6 + 4 * l;
    a.layers[l] = LayerMeta{m[0], m[1], m[2], m[3], row};
    if (m[3] < 0 || m[3] > 3 || m[1] < 0) return (int)cudaErrorInvalidValue;
    row += (m[0] ? a.D : 0) + m[1] * a.D + (2 + m[2]) * a.K * a.D;
  }
  if (row != P) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;

  int threads = 128;
  size_t smem;
  if (mode != PERM) {
    if (H < 1 || w == nullptr || b == nullptr ||
        (mode == LAZY2 && (n_in < 1 || summary == nullptr)) ||
        (mode == LAZYH && hidden == nullptr))
      return (int)cudaErrorInvalidValue;
    while (threads > 32 && (size_t)H * threads * 4 > SMEM_LIMIT) threads /= 2;
    smem = (size_t)H * threads * 4;
  } else {
    smem = (size_t)4 * P * 4;
  }
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (mode == LAZY2)
    e = dispatch<LAZY2>(sample, a, threads, smem, s);
  else if (mode == LAZYH)
    e = dispatch<LAZYH>(sample, a, threads, smem, s);
  else
    e = dispatch<PERM>(sample, a, threads, smem, s);
  return (int)e;
}

extern "C" const char* gf_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
