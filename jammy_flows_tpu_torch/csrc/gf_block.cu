// Whole-block Gaussianization-flow kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel jammy_flows_tpu/ops/pallas_gf_block.py
// `_block_call` (body `_make_block_kernel`, `_block_density_local` and
// `_block_sample_local`): a whole `gggg` stack of one sub-manifold in one
// launch per direction, with the parameters either broadcast from one
// permanent vector ("perm") or predicted per row by the fused
// one-hidden-layer tanh amortization MLP inside the kernel ("lazy2").
//
//   density (log_prob), layers in reverse:
//       x -= offset;  x = R_l^T x;  (x, ld_l) = mixture iCDF pass of x
//   sample, layers in order:
//       x = Newton solve;  ld += ld_l(x);  x = R_l x;  x += offset
//
// What bounds it on an H100: not memory.  A row reads d + In floats and
// writes 2d; everything else is arithmetic.  lazy2 spends ~2*P*H flops per
// row on the MLP (P = 548, H = 128 on the flagship: 140 kflop per row) and
// each mixture evaluation ~K transcendental-heavy terms per dimension (the
// sample direction evaluates it ~6 times per layer and dimension), all in
// f32 on the CUDA cores: the kernel is bound by FP32 and SFU throughput.
//
// Design, simple first:
//   * one thread per batch row, 128 rows per block;
//   * perm: the block stages the (P,) vector in shared memory and prepares
//     it once (regulators, log-softmax of the weights, unit householder
//     vectors); every thread then reads it as a broadcast;
//   * lazy2: each thread writes its row's hidden tanh(w1 s + b1) into a
//     column of shared memory (H x 128 floats, conflict-free), then produces
//     each parameter row b_j + w_j . hidden when it needs it, one layer and
//     dimension at a time (3K rows per mixture), reading w by broadcast
//     through L1/L2 (280 KB on the flagship);
//   * a mixture of one dimension (K means, inverse widths, weights) lives in
//     registers; K = 10, d = 4 (the flagship) is a compile-time
//     instantiation, other shapes use the generic one (local arrays).
// Tensor cores, TMA and wgmma for the MLP are later work.
#include <cuda_runtime.h>

#include <type_traits>

#include "gf_common.cuh"

using namespace gf;

namespace {

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
  int n_in, H, P, K, D, n_layers, fit_norm;
  Reg wreg, nreg;
  LayerMeta layers[MAX_LAYERS];
};

// rows of layer l's mixture groups
__device__ __forceinline__ void mix_rows(const LayerMeta& lm, int K, int D,
                                         int& m0, int& lw0, int& ln0) {
  m0 = lm.row0 + (lm.has_off ? D : 0) + lm.rot_it * D;
  lw0 = m0 + K * D;
  ln0 = lw0 + K * D;
}

// ---- permanent parameters: prepared once per block in shared memory ------
template <int N, int KT, int DN>
struct PermSrc {
  const float* A;    // raw rows; householder rows hold unit vectors
  const float* IW;   // at the log-width rows: inverse widths
  const float* LNW;  // at the log-width rows: log weights
  const float* NW;   // at the log-width rows: weights

  __device__ PermSrc(const BlockArgs& a, float* smem) {
    float* sA = smem;
    float* sIW = sA + a.P;
    float* sLNW = sIW + a.P;
    float* sNW = sLNW + a.P;
    const int K = KT > 0 ? KT : a.K;
    for (int j = threadIdx.x; j < a.P; j += blockDim.x) sA[j] = a.pvec[j];
    __syncthreads();
    int n_rot = 0;
    for (int l = 0; l < a.n_layers; ++l) n_rot += a.layers[l].rot_it;
    const int n_mix = a.n_layers * a.D;
    for (int task = threadIdx.x; task < n_mix + n_rot; task += blockDim.x) {
      if (task < n_mix) {
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
        prep_mix<N, KT>(mx, lw, ln, K, lm.has_ln && a.fit_norm, a.wreg, a.nreg);
        for (int k = 0; k < K; ++k) {
          const int j = lw0 + k * a.D + dd;
          sIW[j] = mx.iw[k];
          sLNW[j] = mx.lnw[k];
          sNW[j] = mx.nw[k];
        }
      } else {
        int t = task - n_mix, l = 0;
        while (t >= a.layers[l].rot_it) t -= a.layers[l++].rot_it;
        const LayerMeta& lm = a.layers[l];
        float* v = sA + lm.row0 + (lm.has_off ? a.D : 0) + t * a.D;
        float ss = 0.0f;
        for (int j = 0; j < a.D; ++j) ss += v[j] * v[j];
        const float nrm = sqrtf(ss + 1e-20f);
        for (int j = 0; j < a.D; ++j) v[j] = v[j] / nrm;
      }
    }
    __syncthreads();
    A = sA;
    IW = sIW;
    LNW = sLNW;
    NW = sNW;
  }

  __device__ float param(int j) const { return A[j]; }

  __device__ void unit_vec(int r0, int D, float* v) const {
    for (int j = 0; j < D; ++j) v[j] = A[r0 + j];
  }

  __device__ void load_mix(Mix<N>& mx, const LayerMeta& lm, int K, int D,
                           int dd, const BlockArgs&) const {
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
    }
  }
};

// ---- fused MLP: hidden in shared memory, parameter rows on demand --------
template <int N, int KT, int DN>
struct LazySrc {
  const float* hid;  // this thread's column: hid[h * stride]
  int stride, H;
  const float* w;
  const float* b;

  __device__ LazySrc(const BlockArgs& a, float* smem, int row)
      : hid(smem + threadIdx.x), stride(blockDim.x), H(a.H), w(a.w), b(a.b) {
    if (row >= a.B) return;
    float* col = smem + threadIdx.x;
    for (int h = 0; h < a.H; ++h) col[h * stride] = 0.0f;
    const float* s = a.summary + (size_t)row * a.n_in;
    for (int i = 0; i < a.n_in; ++i) {
      const float si = s[i];
      for (int h = 0; h < a.H; ++h) col[h * stride] += a.w1[h * a.n_in + i] * si;
    }
    for (int h = 0; h < a.H; ++h) col[h * stride] = tanhf(col[h * stride] + a.b1[h]);
  }

  __device__ float param(int j) const {
    const float* wj = w + (size_t)j * H;
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) acc += __ldg(wj + h) * hid[h * stride];
    return acc + __ldg(b + j);
  }

  __device__ void unit_vec(int r0, int D, float* v) const {
    float ss = 0.0f;
    for (int j = 0; j < D; ++j) {
      v[j] = param(r0 + j);
      ss += v[j] * v[j];
    }
    const float nrm = sqrtf(ss + 1e-20f);
    for (int j = 0; j < D; ++j) v[j] = v[j] / nrm;
  }

  __device__ void load_mix(Mix<N>& mx, const LayerMeta& lm, int K, int D,
                           int dd, const BlockArgs& a) const {
    int m0, lw0, ln0;
    mix_rows(lm, K, D, m0, lw0, ln0);
    const int kk = KT > 0 ? KT : K;
    float lw[N], ln[N];
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
};

template <int DN, class Src>
__device__ __forceinline__ void reflect(const Src& src, int r0, float* x, int D) {
  float v[DN];
  src.unit_vec(r0, D, v);
  float dot = v[0] * x[0];
  for (int j = 1; j < D; ++j) dot += v[j] * x[j];
  for (int j = 0; j < D; ++j) x[j] = x[j] - (2.0f * v[j]) * dot;
}

template <bool LAZY, int N, int KT, int DN>
using SrcT = typename std::conditional<LAZY, LazySrc<N, KT, DN>,
                                       PermSrc<N, KT, DN>>::type;

template <bool LAZY, int KT, int DT>
__device__ __forceinline__ SrcT<LAZY, (KT > 0 ? KT : KMAX), KT,
                                (DT > 0 ? DT : DMAX)>
make_src(const BlockArgs& a, float* smem, int row) {
  if constexpr (LAZY)
    return SrcT<LAZY, (KT > 0 ? KT : KMAX), KT, (DT > 0 ? DT : DMAX)>(a, smem, row);
  else
    return SrcT<LAZY, (KT > 0 ? KT : KMAX), KT, (DT > 0 ? DT : DMAX)>(a, smem);
}

template <bool LAZY, int KT, int DT>
__global__ void __launch_bounds__(128)
gf_block_density_kernel(const BlockArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const int K = KT > 0 ? KT : a.K;
  const int D = DT > 0 ? DT : a.D;
  extern __shared__ float smem[];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const auto src = make_src<LAZY, KT, DT>(a, smem, row);
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

template <bool LAZY, int KT, int DT>
__global__ void __launch_bounds__(128)
gf_block_sample_kernel(const BlockArgs a) {
  constexpr int N = KT > 0 ? KT : KMAX;
  constexpr int DN = DT > 0 ? DT : DMAX;
  const int K = KT > 0 ? KT : a.K;
  const int D = DT > 0 ? DT : a.D;
  extern __shared__ float smem[];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const auto src = make_src<LAZY, KT, DT>(a, smem, row);
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

template <bool LAZY, int KT, int DT>
cudaError_t launch(bool sample, const BlockArgs& a, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kernel = sample ? gf_block_sample_kernel<LAZY, KT, DT>
                       : gf_block_density_kernel<LAZY, KT, DT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.B + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool LAZY>
cudaError_t dispatch(bool sample, const BlockArgs& a, int threads, size_t smem,
                     cudaStream_t stream) {
  if (a.K == 10 && a.D == 4)
    return launch<LAZY, 10, 4>(sample, a, threads, smem, stream);
  return launch<LAZY, 0, 0>(sample, a, threads, smem, stream);
}

}  // namespace

// meta: [K, D, n_layers, fit_norm, wreg kind, nreg kind,
//        then per layer: has_off, rot_it, has_ln, ift]
// regs: [wreg a, b, c, lo, hi, nreg a, b, c, lo, hi]
// Returns 0 or a cudaError_t; launches on `stream` and does not synchronize.
extern "C" int gf_block_launch(int sample, int lazy, const float* x, float* out,
                               float* ld, int B, const float* pvec,
                               const float* summary, const float* w1,
                               const float* b1, const float* w, const float* b,
                               int n_in, int H, int P, const int* meta,
                               const float* regs, void* stream) {
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
  a.n_in = n_in;
  a.H = H;
  a.P = P;
  a.K = meta[0];
  a.D = meta[1];
  a.n_layers = meta[2];
  a.fit_norm = meta[3];
  a.wreg = Reg{meta[4], regs[0], regs[1], regs[2], regs[3], regs[4]};
  a.nreg = Reg{meta[5], regs[5], regs[6], regs[7], regs[8], regs[9]};
  if (a.K < 1 || a.K > KMAX || a.D < 1 || a.D > DMAX || a.n_layers < 1 ||
      a.n_layers > MAX_LAYERS || B < 0)
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
  if (lazy) {
    if (H < 1 || n_in < 1) return (int)cudaErrorInvalidValue;
    while (threads > 32 && (size_t)H * threads * 4 > SMEM_LIMIT) threads /= 2;
    smem = (size_t)H * threads * 4;
  } else {
    smem = (size_t)4 * P * 4;
  }
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = lazy ? dispatch<true>(sample, a, threads, smem, s)
                             : dispatch<false>(sample, a, threads, smem, s);
  return (int)e;
}

extern "C" const char* gf_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
