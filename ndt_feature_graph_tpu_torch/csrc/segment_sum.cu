// Hopper (sm_90a) kernel of the map update's fixed-order sum
// (ops/ndt_map.py scatter_add_rows): new rows = old rows plus every entry
// with that row's index, added one after another in entry order,
// (((old + v_k1) + v_k2) + ...) for k1 < k2 < ..., each add rounded once
// in f32.  That is index_add on the CPU and XLA's `.at[].add` in the JAX
// package (ndt_feature_graph_tpu/ops/ndt_map.py add_points_touched and
// update_occupancy): a map update repeats bit for bit, and the card's
// equals the CPU's.
//
// Replaces no TPU kernel: the reference leaves this scatter to XLA.  It
// takes the place of torch's atomic index_add (an order that changes
// between runs) and of the stable-sorted index_put_(accumulate=True),
// whose sequential add per index is not in torch's API.
//
// Input: the entries' indices sorted stably (torch.sort(stable=True), a
// documented order: equal indices keep their entry order) and the
// permutation that sorts them; (base, values, out) triples that share
// the index, up to kMaxChannels float channels in all (the map's count,
// psum and outer: 1 + 2 + 4 channels in one launch).
//
// What bounds it on the H100: bytes, in principle.  Each row of the
// bases is read once and written once (40,000 cells x 7 floats = 2.24 MB
// a scan for the statistics, 0.32 MB for occupancy), each entry read
// once (its values, its sorted index and its position): about 3 MB a
// scan, under 1 us at 3.35 TB/s; 64 times that for a B = 64 fleet step.
// In practice the longest run: its adds are one dependent chain, which
// the fixed order forbids splitting.  Runs are long near the sensor
// (every ray crosses the cells around the robot: hundreds to a few
// thousand entries on one cell).
//
// Design:
//   * A block owns kSegRows consecutive rows and writes each of them
//     exactly once, so the output needs no prior copy and no row is
//     written by two threads: an untouched row is copied, a touched row
//     is summed.
//   * Its entries are a contiguous span of the sorted positions, found
//     by two warps (one for each end) in 32-way steps of a lower-bound
//     search.  The block's threads then, over that span in parallel,
//     mark in shared memory the first and the last sorted position of
//     each of its rows' runs (a position whose neighbour holds another
//     index), and copy each entry's channels into a scratch row at its
//     sorted position: the gathers through the permutation happen here,
//     all at once, and not on the chain.
//   * The thread of a row then adds its run in sorted order (which is
//     entry order, the sort being stable) from consecutive scratch rows,
//     kAhead entries loaded before their adds, so only the adds form the
//     dependent chain.
//   * No float atomics; __fadd_rn, so no add is contracted or
//     reassociated.
//
// Built with pair_fgh.cu into one library (ops/cuda_kernels.py build):
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3; bound
// through the plain C interface at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kSegRows = kSegThreads * kRowsPerThread;
constexpr int kMaxChannels = 8;

// One float channel: element (row, 0) of a (rows, stride) array at
// base / val / out, the channel's column already added.
struct Channels {
  const float* base[kMaxChannels];   // (n_rows, stride)
  const float* val[kMaxChannels];    // (m, stride)
  float* out[kMaxChannels];          // (n_rows, stride)
  int stride[kMaxChannels];
};

// The first position of keys[0, m) (ascending) whose key is >= v, or m:
// one warp probes 32 evenly spaced positions of the interval that holds
// the answer and keeps the gap between the last probe below v and the
// next probe.
__device__ long long warp_lower_bound(const int* __restrict__ keys,
                                      long long m, long long v, int lane) {
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const bool below = q < hi && __ldg(keys + q) < v;
    const int k = __popc(__ballot_sync(0xffffffffu, below));
    if (k == 0) {
      hi = lo;
    } else {
      const long long next = lo + k * step;
      if (k < 32 && next < hi) hi = next;
      lo += (k - 1) * step + 1;
    }
  }
  return lo;
}

// Row r: its old value plus the staged entries a..b (none if b < a), in
// that order.  The staged rows were written by this block in this
// launch, so they are read through L2 (__ldcg), not the read-only path.
template <int C>
__device__ __forceinline__ void sum_row(const Channels& ch,
                                        const float* __restrict__ stage,
                                        long long r, int a, int b) {
  constexpr int kAhead = 64 / C > 4 ? 64 / C : 4;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = __ldg(ch.base[c] + r * ch.stride[c]);
  int q = a;
  for (; q + kAhead - 1 <= b; q += kAhead) {
    const float* s = stage + static_cast<long long>(q) * C;
    float v[kAhead * C];
#pragma unroll
    for (int i = 0; i < kAhead * C; ++i) v[i] = __ldcg(s + i);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], v[j * C + c]);
    }
  }
  for (; q <= b; ++q) {
    const float* s = stage + static_cast<long long>(q) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __ldcg(s + c));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) ch.out[c][r * ch.stride[c]] = acc[c];
}

template <int C>
__global__ void __launch_bounds__(kSegThreads)
    segment_add_rows_kernel(const int* __restrict__ keys,
                            const long long* __restrict__ perm, long long m,
                            long long n_rows, Channels ch,
                            float* __restrict__ stage) {
  __shared__ int first[kSegRows];
  __shared__ int last[kSegRows];
  __shared__ long long span[2];
  const long long r0 = static_cast<long long>(blockIdx.x) * kSegRows;
  for (int i = threadIdx.x; i < kSegRows; i += kSegThreads) {
    first[i] = 0;
    last[i] = -1;                     // an empty run
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    const long long at =
        warp_lower_bound(keys, m, r0 + warp * kSegRows, lane);
    if (lane == 0) span[warp] = at;
  }
  __syncthreads();
  const long long p0 = span[0];
  const long long p1 = span[1];
#pragma unroll 4
  for (long long p = p0 + threadIdx.x; p < p1; p += kSegThreads) {
    const int key = __ldg(keys + p);
    const int local = static_cast<int>(key - r0);
    if (p == p0 || __ldg(keys + p - 1) != key) {
      first[local] = static_cast<int>(p);
    }
    if (p == p1 - 1 || __ldg(keys + p + 1) != key) {
      last[local] = static_cast<int>(p);
    }
    const long long src = __ldg(perm + p);
    float* dst = stage + p * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dst[c] = __ldg(ch.val[c] + src * ch.stride[c]);
    }
  }
  __syncthreads();                    // the marks and the staged rows
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int local = threadIdx.x + i * kSegThreads;
    const long long r = r0 + local;
    if (r < n_rows) sum_row<C>(ch, stage, r, first[local], last[local]);
  }
}

template <int C>
cudaError_t launch(const int* keys, const long long* perm, long long m,
                   long long n_rows, const Channels& ch, float* stage,
                   unsigned blocks, cudaStream_t stream) {
  segment_add_rows_kernel<C><<<blocks, kSegThreads, 0, stream>>>(
      keys, perm, m, n_rows, ch, stage);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ndtg_segment_max_channels() { return kMaxChannels; }

// outs[k] = bases[k] with the rows vals[k][perm[p]] added at row keys[p],
// p = 0..m-1 in order, for each of the n_groups (base, vals, out)
// triples of widths[k] float channels (row-major, contiguous); keys
// ascending (sorted stably from the entries' indices), perm the sorting
// permutation; stage: scratch of m x (the channels in all) floats.
// Entries whose key lies outside [0, n_rows) add nothing.  Returns the
// launch error (0 = success).
int ndtg_segment_add_rows(const int* keys, const long long* perm,
                          long long m, long long n_rows, int n_groups,
                          const float* const* bases,
                          const float* const* vals, float* const* outs,
                          const int* widths, float* stage, void* stream) {
  if (n_rows < 1 || m < 0 || m > 2147483647LL || n_groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_rows + kSegRows - 1) / kSegRows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  Channels ch = {};
  int c = 0;
  for (int k = 0; k < n_groups; ++k) {
    if (widths[k] < 1 || c + widths[k] > kMaxChannels) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int j = 0; j < widths[k]; ++j, ++c) {
      ch.base[c] = bases[k] + j;
      ch.val[c] = vals[k] + j;
      ch.out[c] = outs[k] + j;
      ch.stride[c] = widths[k];
    }
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (c) {
    case 1: err = launch<1>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    case 2: err = launch<2>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    case 3: err = launch<3>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    case 4: err = launch<4>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    case 5: err = launch<5>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    case 6: err = launch<6>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    case 7: err = launch<7>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    case 8: err = launch<8>(keys, perm, m, n_rows, ch, stage, nb, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
