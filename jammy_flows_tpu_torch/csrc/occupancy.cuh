// Grids of persistent blocks: a kernel's resident blocks per SM from the
// CUDA occupancy API, asked once per (kernel, threads, shared memory,
// device) and then kept, so that the launch path does not pay for the
// query at every call; shared by the block forward (gf_block.cu) and the
// per-layer forward (gf_layer.cu).
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace gf {

inline cudaError_t blocks_per_sm(const void* kernel, int threads, size_t smem,
                                 int dev, int& per_sm) {
  struct Known {
    const void* kernel;
    int threads;
    size_t smem;
    int dev, per_sm;
  };
  static Known known[64];
  static int n_known = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_known; ++i) {
    const Known& k = known[i];
    if (k.kernel == kernel && k.threads == threads && k.smem == smem &&
        k.dev == dev) {
      per_sm = k.per_sm;
      return cudaSuccess;
    }
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (e == cudaSuccess && n_known < 64)
    known[n_known++] = Known{kernel, threads, smem, dev, per_sm};
  return e;
}

// The grid of a kernel whose blocks walk n_tiles tiles: one persistent
// block per resident slot (blocks per SM x SMs) on the current device, at
// most one per tile.
inline cudaError_t persistent_grid(const void* kernel, int threads,
                                   size_t smem, int n_tiles, int& blocks) {
  int dev, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = blocks_per_sm(kernel, threads, smem, dev, per_sm);
  const int cap = (per_sm > 1 ? per_sm : 1) * n_sm;
  blocks = n_tiles < cap ? n_tiles : cap;
  return e;
}

}  // namespace gf
