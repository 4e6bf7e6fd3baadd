// Chain-rate probe for Hopper (sm_90a): the per-op throughput of the
// operations the Gaussianization-flow kernels are made of.
//
// Replaces the TPU kernel jammy_flows_tpu/tools/transcendental_peak.py
// `_chain_kernel` (T8, launched at :89): every element runs a dependent
// chain of n_ops steps of one operation,
//     exp       x = expf(x) * -0.4
//     log       x = logf(x) * -0.3 + 1
//     softplus  x = (max(x, 0) + log1p(exp(-|x|))) * -0.5   (jax.nn.softplus)
//     sin       x = sinf(x) + 0.1
//     arccos    x = acosf(0.6 x) - 1   (the JAX probe measured it through
//                                       XLA only: Mosaic had no lowering)
//     fma       x = x * 1.0000001 + 1e-7
// each keeping x in a bounded range.  Timed at two chain lengths, the
// difference of the two times over the difference of the steps gives the
// rate of one step free of launch overhead
// (jammy_flows_tpu_torch/tools/transcendental_peak.py).
//
// What bounds it on an H100: arithmetic by construction (8 bytes per
// element against hundreds of dependent operations).  It is built as the
// flow kernels are (no fast-math): expf, logf, log1pf, sinf and acosf are
// the accurate library sequences (range reduction, a polynomial, the SFU's
// approximate ex2 / lg2 inside), so a step's rate is what the flow kernels
// get per call, not the SFU's raw issue rate.
//
// Design: four independent chains per thread (elements i, i + n/4, ...),
// enough warps per SM to cover the latency of a dependent chain; the chain
// length is a runtime argument so the compiler cannot fold it.
#include <cuda_runtime.h>

namespace {

enum Op { OP_EXP = 0, OP_LOG = 1, OP_SOFTPLUS = 2, OP_SIN = 3, OP_ARCCOS = 4, OP_FMA = 5 };

template <int OP>
__device__ __forceinline__ float step(float x) {
  if constexpr (OP == OP_EXP) return expf(x) * (-0.4f);
  else if constexpr (OP == OP_LOG) return logf(x) * (-0.3f) + 1.0f;
  else if constexpr (OP == OP_SOFTPLUS)
    return (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) * (-0.5f);
  else if constexpr (OP == OP_SIN) return sinf(x) + 0.1f;
  else if constexpr (OP == OP_ARCCOS) return acosf(x * 0.6f) - 1.0f;
  else return x * 1.0000001f + 1e-7f;
}

constexpr int ILP = 4;

template <int OP>
__global__ void __launch_bounds__(256)
chain_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
             int n_ops) {
  const int q = (n + ILP - 1) / ILP;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= q) return;
  float v[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const int i = t + j * q;
    v[j] = i < n ? x[i] : 0.5f;
  }
  for (int s = 0; s < n_ops; ++s) {
#pragma unroll
    for (int j = 0; j < ILP; ++j) v[j] = step<OP>(v[j]);
  }
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const int i = t + j * q;
    if (i < n) y[i] = v[j];
  }
}

template <int OP>
cudaError_t launch(const float* x, float* y, int n, int n_ops,
                   cudaStream_t s) {
  const int threads = 256;
  const int q = (n + ILP - 1) / ILP;
  chain_kernel<OP><<<(q + threads - 1) / threads, threads, 0, s>>>(x, y, n,
                                                                   n_ops);
  return cudaGetLastError();
}

}  // namespace

// op: 0 exp, 1 log, 2 softplus, 3 sin, 4 arccos, 5 fma; x, y: (n,) float32.
// Returns 0 or a cudaError_t; launches on `stream` and does not synchronize.
extern "C" int chain_peak_launch(int op, const float* x, float* y, int n,
                                 int n_ops, void* stream) {
  if (op < OP_EXP || op > OP_FMA || n < 0 || n_ops < 0 || x == nullptr ||
      y == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_EXP: return (int)launch<OP_EXP>(x, y, n, n_ops, s);
    case OP_LOG: return (int)launch<OP_LOG>(x, y, n, n_ops, s);
    case OP_SOFTPLUS: return (int)launch<OP_SOFTPLUS>(x, y, n, n_ops, s);
    case OP_SIN: return (int)launch<OP_SIN>(x, y, n, n_ops, s);
    case OP_ARCCOS: return (int)launch<OP_ARCCOS>(x, y, n, n_ops, s);
    default: return (int)launch<OP_FMA>(x, y, n, n_ops, s);
  }
}

extern "C" const char* chain_peak_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
