// Stage stamps of a probe build (-DNDTG_STAGE_PROBE), shared by
// csrc/features.cu, csrc/occupancy.cu, csrc/pair_fgh.cu and
// csrc/overlap.cu: NDTG_STAGE(k, name) stamps each block's SM clock at
// the end of stage k, and the global timer at its first and last stamp,
// for the first kProbeBlocks blocks.  A stage that a block runs many
// times (a solve's trials, a loop's batches) is summed instead:
// NDTG_LAP_BEGIN() starts thread 0's lap clock, NDTG_LAP(k, name) adds
// the cycles since the last lap to stage k, NDTG_LAP_COUNT() counts one
// round, and NDTG_LAP_END(block) stores the sums at row `block` (stage
// kProbeStages - 1 holds the rounds) with the global timer at BEGIN and
// END.  Each source that includes it has its own arrays and exports its
// own reader over ndtg::probe_read (examples/probe_feature_stages.py,
// examples/probe_occupancy.py, examples/probe_link_stages.py).  In a
// normal build the marks are empty.
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

// Thread 0's lap sums, in the block's shared memory.
__shared__ long long probe_lap_sum[kProbeStages];
__shared__ long long probe_lap_last, probe_lap_ns;

__device__ __forceinline__ void probe_lap_begin() {
  if (threadIdx.x != 0) return;
  for (int k = 0; k < kProbeStages; ++k) probe_lap_sum[k] = 0;
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  probe_lap_ns = ns;
  probe_lap_last = clock64();
}

__device__ __forceinline__ void probe_lap(int k) {
  if (threadIdx.x != 0) return;
  const long long t = clock64();
  probe_lap_sum[k] += t - probe_lap_last;
  probe_lap_last = t;
}

__device__ __forceinline__ void probe_lap_count() {
  if (threadIdx.x == 0) probe_lap_sum[kProbeStages - 1] += 1;
}

__device__ __forceinline__ void probe_lap_end(long long block) {
  if (threadIdx.x != 0 || block < 0 || block >= kProbeBlocks) return;
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  for (int k = 0; k < kProbeStages; ++k) {
    probe_clock[block * kProbeStages + k] = probe_lap_sum[k];
  }
  probe_ns[2 * block] = probe_lap_ns;
  probe_ns[2 * block + 1] = ns;
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
#define NDTG_LAP_BEGIN() ::ndtg::probe_lap_begin()
#define NDTG_LAP(k, name) ::ndtg::probe_lap(k)
#define NDTG_LAP_COUNT() ::ndtg::probe_lap_count()
#define NDTG_LAP_END(block) ::ndtg::probe_lap_end(block)
#else
#define NDTG_STAGE(k, name) ((void)0)
#define NDTG_LAP_BEGIN() ((void)0)
#define NDTG_LAP(k, name) ((void)0)
#define NDTG_LAP_COUNT() ((void)0)
#define NDTG_LAP_END(block) ((void)0)
#endif
