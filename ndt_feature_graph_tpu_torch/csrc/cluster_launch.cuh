// One launch of a kernel whose blocks are grouped in thread-block
// clusters along x (cudaLaunchKernelEx with a cluster dimension), shared
// by csrc/pair_fgh.cu and csrc/features.cu.
#pragma once

#include <cuda_runtime.h>

namespace ndtg {

// Launch `kernel` on `grid` (grid.x a multiple of `cluster`) with
// clusters of `cluster` blocks along x, `threads` threads and `smem`
// bytes of dynamic shared memory a block.  Returns the launch error
// (0 = success), the launch's own or the last one.
template <typename... KArgs, typename... Args>
inline int launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads,
                          int cluster, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace ndtg
