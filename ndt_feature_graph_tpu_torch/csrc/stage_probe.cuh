// Stage stamps of a probe build (-DNDTG_STAGE_PROBE), shared by
// csrc/features.cu and csrc/occupancy.cu: NDTG_STAGE(k, name) stamps each
// block's SM clock at the end of stage k, and the global timer at its
// first and last stamp, for the first kProbeBlocks blocks.  Each source
// that includes it has its own arrays and exports its own reader over
// ndtg::probe_read (examples/probe_feature_stages.py,
// examples/probe_occupancy.py).  In a normal build the marks are empty.
#pragma once

#ifdef NDTG_STAGE_PROBE
#include <cuda_runtime.h>

namespace ndtg {
namespace {

constexpr int kProbeBlocks = 4096, kProbeStages = 16;
__device__ long long probe_clock[kProbeBlocks * kProbeStages];
__device__ long long probe_ns[kProbeBlocks * 2];

__device__ __forceinline__ void probe_stamp(int k) {
  if (threadIdx.x != 0 || blockIdx.x >= kProbeBlocks) return;
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  probe_clock[blockIdx.x * kProbeStages + k] = clock64();
  if (k == 0) probe_ns[2 * blockIdx.x] = ns;
  probe_ns[2 * blockIdx.x + 1] = ns;
}

// Copies this source's stamps to host memory and clears them.
inline int probe_read(long long* clock, long long* ns) {
  void* p = nullptr;
  cudaError_t e = cudaMemcpyFromSymbol(clock, probe_clock,
                                       sizeof(probe_clock));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(ns, probe_ns, sizeof(probe_ns));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, probe_clock);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(probe_clock));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, probe_ns);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(probe_ns));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

}  // namespace
}  // namespace ndtg

#define NDTG_STAGE(k, name) ::ndtg::probe_stamp(k)
#else
#define NDTG_STAGE(k, name) ((void)0)
#endif
