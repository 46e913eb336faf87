// Hopper (sm_90a) kernel of the map's occupancy update
// (ops/ndt_map.py update_occupancy, through ops/cuda_kernels.py
// update_occupancy): log-odds along the beams of a scan, for one grid or
// a stack of grids (one a stream).  Each point's endpoint cell gets
// `hit`, each of its `samples` ray samples strictly before the endpoint
// `miss` (not in the endpoint's own cell), then every cell is clamped
// to [lo, hi].  It gives the CPU's bits on every element: the plain
// twin (ndt_map._update_occupancy_plain) builds the rays eagerly and
// adds the entries with index_add, one after another in entry order.
//
// Replaces no TPU kernel: the reference leaves this scatter to XLA
// (ndt_feature_graph_tpu/ops/ndt_map.py update_occupancy, `.at[].add`).
// It takes the place of the eager ray build, a stable sort and the
// generic fixed-order sum (csrc/segment_sum.cu) on the occupancy path.
//
// Why the order needs no sort here: every entry a cell receives is the
// same float constant `hit` or `miss`, and in entry order all of a
// cell's hits come before all of its misses (the hit entries are
// concatenated first).  So the CPU's sum of a cell is a function of its
// old value and two integers, n_hit and n_miss, and integer counts are
// exact in any order.  The dropped entries (masked points, samples off
// the grid or in the endpoint's cell) each add an exact +0.0 on the CPU
// at row k mod n_rows (entry k of the concatenation, ndt_map._drop_rows):
// that changes a row only where its sum would otherwise end as -0.0
// (x + y is -0.0 only when both are), which the row pass reproduces.
//
// Design: integer hit and miss counts a cell, then each row's adds.
//   * Counts: one warp a (stream, 32 points, kChunk of their ray samples;
//     the first chunk also takes the points' hits).  Every cell
//     coordinate is computed with the rounding of each eager operation
//     on the CPU: (p - o) / res as a correctly rounded division, the
//     sample position so + t (p - so) as three separately rounded
//     operations (no contraction into a fused multiply-add), floor, then
//     the int32 cast as the CPU makes it (INT_MIN for NaN and for values
//     out of range).  A warp's lanes are 32 neighbouring points at the
//     same sample: near the sensor every ray crosses the same few cells,
//     so the lanes that share a cell are grouped (all of them by
//     __match_any_sync on the two-pass path, runs of neighbouring lanes
//     on the cluster path) and one of a group adds their number with one
//     integer atomic.  Counter
//     words: n_hit in the low `shift` bits and n_miss above them (32-bit
//     words when P < 2^16 and P * samples < 2^16, else 64-bit).  No float
//     atomics.
//   * Rows: every row written exactly once: the old value, n_hit adds of
//     `hit`, n_miss adds of `miss`, each add rounded once (__fadd_rn),
//     then torch's clamp.  The operands are registers: no load on the
//     chain.  In the last non-empty phase the chain stops once the sum
//     lies strictly beyond the clamp in the direction of that phase's
//     constant: adding a constant of one sign is monotone, so the clamped
//     result is already fixed.  Near the sensor that cuts a chain of
//     thousands of misses to about (2 hi + hit n_hit) / |miss| adds.
// Two paths, chosen by shape (ops/cuda_kernels.py occupancy_cluster):
//   * One launch (occupancy_cluster_kernel) wherever a stream's counters
//     fit a thread-block cluster's shared memory: a cluster of k blocks
//     a stream, each block owning a contiguous range of its rows (their
//     counters and, staged by cp.async while the counts run, their old
//     values).  The count tasks are spread over the cluster's warps in
//     contiguous ranges; a count goes to its row's owner, by a shared
//     atomic in the block or a distributed-shared-memory atomic in
//     another block of the cluster (after a split cluster barrier that
//     lets the first ray's cells overlap the other blocks' zeroing); a
//     cluster barrier; then each block's rows, one a thread.  No counter
//     buffer in device memory, no zeroing pass.
//   * Two launches (occupancy_count_kernel, occupancy_row_kernel) for a
//     grid too large for the largest cluster: the counts into one
//     counter word a row in device memory, then the rows, four
//     consecutive rows a thread (16-byte accesses), the pass zeroing the
//     counters it read, so they are zero for the next update on the
//     stream with no memset launch.

// What bounds it on the H100: bytes in principle (occ read and written
// once, 8 bytes a row, and the points, masks and origins read once:
// 0.33 MB a scan, 20.9 MB for a B = 64 fleet step), in practice the
// launches, the row phase's longest chain (4-cycle dependent adds) and
// the count phase's atomics on the cells around the sensor.

// Not reproduced: a NaN already in `occ` comes out as a NaN, not with
// the CPU's payload bits.
//
// Built with the other sources into one library (ops/cuda_kernels.py
// build): nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3;
// bound through the plain C interface at the bottom.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "stage_probe.cuh"

namespace cg = cooperative_groups;

#ifdef NDTG_STAGE_PROBE
// Copies the stamps of occupancy_cluster_kernel's NDTG_STAGE marks to
// host memory and clears them (examples/probe_occupancy.py --stages).
extern "C" int ndtg_occupancy_probe_read(long long* clock, long long* ns) {
  return ndtg::probe_read(clock, ns);
}
#endif

namespace {

constexpr int kThreads = 256;        // the two-pass path's blocks
#ifndef NDTG_OCCUPANCY_THREADS
#define NDTG_OCCUPANCY_THREADS 1024
#endif
// A cluster block's threads (examples/tune_torch_port_kernels.py
// --occupancy rebuilds the source at other sizes).
constexpr int kClusterThreads = NDTG_OCCUPANCY_THREADS;
constexpr int kClusterChunk = 2;     // ray samples a cluster count task
constexpr int kMaxCluster = 16;      // cuda_kernels.OCCUPANCY_MAX_CLUSTER
// A cluster block's dynamic shared memory at most (227 KB).
constexpr long long kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kChunk = 4;        // ray samples a count-pass thread takes
constexpr int kExitEvery = 8;    // adds between two tests of the stop
constexpr int kRowsPerThread = 4;

struct Scan {
  const float* origin;           // (n, 2): row b at origin + b * origin_stride
  const float* sensor;           // (n, 2): row b at sensor + b * sensor_stride
  const float* pts;              // (n, P, 2), contiguous
  const unsigned char* mask;     // (n, P) bool, contiguous
  long long origin_stride, sensor_stride;
  long long n_streams;
  int n_points, h, w, samples;
  float res;
};

// One point's ray: the endpoint, the sensor, the grid origin, the
// endpoint's cell and whether the point counts (mask & finite).
struct Ray {
  float px, py, sx, sy, ox, oy;
  int iy, ix;
  bool valid;
};

// floor((v - o) / res) cast to int32 as torch casts on the CPU (x86's
// truncating conversion): the integer where it fits, INT_MIN for NaN
// and out of range.  Only in-bounds values and equality with in-bounds
// values are used, so any out-of-range value would do as well.
__device__ __forceinline__ int cell_of(float v, float o, float res) {
  const float f = floorf(__fdiv_rn(__fsub_rn(v, o), res));
  return (f >= -2147483648.0f && f < 2147483648.0f) ? static_cast<int>(f)
                                                    : INT_MIN;
}

__device__ __forceinline__ bool in_grid(const Scan& s, int iy, int ix) {
  return iy >= 0 && iy < s.h && ix >= 0 && ix < s.w;
}

__device__ Ray load_ray(const Scan& s, long long b, int p) {
  Ray r;
  const float* q = s.pts + (b * s.n_points + p) * 2;
  r.px = q[0];
  r.py = q[1];
  r.ox = s.origin[b * s.origin_stride];
  r.oy = s.origin[b * s.origin_stride + 1];
  r.sx = s.sensor[b * s.sensor_stride];
  r.sy = s.sensor[b * s.sensor_stride + 1];
  r.ix = cell_of(r.px, r.ox, s.res);
  r.iy = cell_of(r.py, r.oy, s.res);
  r.valid = s.mask[b * s.n_points + p] != 0 && isfinite(r.px) &&
            isfinite(r.py);
  return r;
}

// The endpoint's cell within its grid, or -1 where the CPU drops the
// hit entry.
__device__ __forceinline__ int hit_cell(const Scan& s, const Ray& r) {
  return r.valid && in_grid(s, r.iy, r.ix) ? r.iy * s.w + r.ix : -1;
}

// Sample k's cell within its grid, or -1 where the CPU drops the miss
// entry: ray = so + t (p - so), t = (k + 0.5) / samples, each operation
// rounded once as the eager tensors round it.
__device__ __forceinline__ int sample_cell(const Scan& s, const Ray& r,
                                           int k) {
  const float t = __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                            static_cast<float>(s.samples));
  const float x = __fadd_rn(r.sx, __fmul_rn(t, __fsub_rn(r.px, r.sx)));
  const float y = __fadd_rn(r.sy, __fmul_rn(t, __fsub_rn(r.py, r.sy)));
  const int ix = cell_of(x, r.ox, s.res);
  const int iy = cell_of(y, r.oy, s.res);
  if (!r.valid || !in_grid(s, iy, ix) || (iy == r.iy && ix == r.ix)) {
    return -1;
  }
  return iy * s.w + ix;
}

// The lanes holding the same cell add their number to its counter with
// one atomic (cell -1: nothing).  Every lane of the warp calls it.
template <typename Count>
__device__ __forceinline__ void add_count(Count* row0, int cell, Count unit,
                                          int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  if (cell >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(row0 + cell, unit * static_cast<Count>(__popc(peers)));
  }
}

// Warp w takes stream b, points 32 g .. 32 g + 31 and samples
// kChunk c .. kChunk c + kChunk - 1 (chunk 0 also the hits); all of it is
// uniform over the warp, so every lane reaches each __match_any_sync.
template <typename Count>
__global__ void __launch_bounds__(kThreads)
    occupancy_count_kernel(Scan s, Count* __restrict__ counts, int shift) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = (s.samples + kChunk - 1) / kChunk;
  const int groups = (s.n_points + 31) / 32;
  const int c = static_cast<int>(warp % chunks);
  const long long q = warp / chunks;
  const int g = static_cast<int>(q % groups);
  const long long b = q / groups;
  if (b >= s.n_streams) return;
  const int p = g * 32 + lane;
  const bool active = p < s.n_points;
  Ray r = {};
  if (active) r = load_ray(s, b, p);
  Count* row0 = counts + b * s.h * s.w;
  if (c == 0) {
    add_count<Count>(row0, active ? hit_cell(s, r) : -1, Count(1), lane);
  }
  const Count miss_unit = Count(1) << shift;
  const int k1 = min(s.samples, (c + 1) * kChunk);
  for (int k = c * kChunk; k < k1; ++k) {
    add_count<Count>(row0, active ? sample_cell(s, r, k) : -1, miss_unit,
                     lane);
  }
}

// Whether any dropped entry of the concatenation (the hits of every
// stream, then their misses) lands on row `row` (entry k at row
// k mod n_rows).  Recomputed only for a row whose sum ends as -0.0.
__device__ bool dropped_at(const Scan& s, long long row, long long n_rows) {
  const long long n_hits = s.n_streams * s.n_points;
  const long long n_all = n_hits * (1 + s.samples);
  for (long long k = row; k < n_all; k += n_rows) {
    if (k < n_hits) {
      const Ray r = load_ray(s, k / s.n_points,
                             static_cast<int>(k % s.n_points));
      if (hit_cell(s, r) < 0) return true;
    } else {
      const long long j = k - n_hits;
      const long long pt = j / s.samples;
      const Ray r = load_ray(s, pt / s.n_points,
                             static_cast<int>(pt % s.n_points));
      if (sample_cell(s, r, static_cast<int>(j % s.samples)) < 0) {
        return true;
      }
    }
  }
  return false;
}

// `n` adds of `v` onto acc, each rounded once.  With `last` (no later
// phase), stops once acc lies strictly beyond the clamp in v's
// direction and sets *beyond.  *adds counts the adds made.
__device__ __forceinline__ float add_run(float acc, float v, unsigned n,
                                         bool last, float lo, float hi,
                                         bool* beyond, unsigned* adds) {
  if (n == 0) return acc;
  if (v == 0.0f) {                // one add of a zero does what n do
    *adds += 1;
    return __fadd_rn(acc, v);
  }
  unsigned i = 0;
  for (; i + kExitEvery <= n; i += kExitEvery) {
#pragma unroll
    for (int j = 0; j < kExitEvery; ++j) acc = __fadd_rn(acc, v);
    if (last && (v > 0.0f ? acc > hi : acc < lo)) {
      *beyond = true;
      *adds += i + kExitEvery;
      return acc;
    }
  }
  for (; i < n; ++i) acc = __fadd_rn(acc, v);
  *adds += n;
  return acc;
}

// torch's clamp on the CPU: min(max(x, lo), hi) as (x < lo ? lo : x),
// then (hi < x ? hi : x); a NaN stays a NaN, a signed zero its sign.
__device__ __forceinline__ float torch_clamp(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return hi < x ? hi : x;
}

struct Row {
  float hit, miss, lo, hi;
  int shift;
  long long n_rows;
  unsigned* chain;               // null, or the adds of each row's chain
};

// Row `row`'s new value from its old value and its counter word.
template <typename Count>
__device__ __forceinline__ float row_value(const Scan& s, const Row& p,
                                           long long row, float old,
                                           Count word) {
  const unsigned n_hit =
      static_cast<unsigned>(word & ((Count(1) << p.shift) - 1));
  const unsigned n_miss = static_cast<unsigned>(word >> p.shift);
  bool beyond = false;
  unsigned adds = 0;
  float acc = add_run(old, p.hit, n_hit, n_miss == 0, p.lo, p.hi, &beyond,
                      &adds);
  acc = add_run(acc, p.miss, n_miss, true, p.lo, p.hi, &beyond, &adds);
  // The dropped entries' +0.0: only a sum that ends as -0.0 changes.
  if (!beyond && __float_as_uint(acc) == 0x80000000u &&
      dropped_at(s, row, p.n_rows)) {
    acc = 0.0f;
  }
  if (p.chain != nullptr) p.chain[row] = adds;
  return torch_clamp(acc, p.lo, p.hi);
}

// Four consecutive counter words, read and zeroed with 16-byte accesses.
__device__ __forceinline__ void take4(unsigned* c, unsigned (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(c);
  *reinterpret_cast<uint4*>(c) = make_uint4(0, 0, 0, 0);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void take4(unsigned long long* c,
                                      unsigned long long (&w)[4]) {
  const ulonglong2 a = reinterpret_cast<const ulonglong2*>(c)[0];
  const ulonglong2 b = reinterpret_cast<const ulonglong2*>(c)[1];
  reinterpret_cast<ulonglong2*>(c)[0] = make_ulonglong2(0, 0);
  reinterpret_cast<ulonglong2*>(c)[1] = make_ulonglong2(0, 0);
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// A thread takes kRowsPerThread consecutive rows, read and written with
// 16-byte accesses where the arrays allow it: with one row a thread,
// the few bytes each thread has in flight left a cold occ at a third of
// HBM's rate.  The pass zeroes the counters it read.
template <typename Count>
__global__ void __launch_bounds__(kThreads)
    occupancy_row_kernel(Scan s, Row p, const float* __restrict__ occ,
                         float* __restrict__ out,
                         Count* __restrict__ counts) {
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kRowsPerThread;
  if (row0 >= p.n_rows) return;
  const bool wide_access =
      row0 + kRowsPerThread <= p.n_rows &&
      ((reinterpret_cast<uintptr_t>(occ) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(counts)) & 15) == 0;
  if (wide_access) {
    const float4 o = *reinterpret_cast<const float4*>(occ + row0);
    Count w[4];
    take4(counts + row0, w);
    *reinterpret_cast<float4*>(out + row0) = make_float4(
        row_value(s, p, row0, o.x, w[0]), row_value(s, p, row0 + 1, o.y, w[1]),
        row_value(s, p, row0 + 2, o.z, w[2]),
        row_value(s, p, row0 + 3, o.w, w[3]));
    return;
  }
  const long long row1 = min(row0 + kRowsPerThread, p.n_rows);
  for (long long row = row0; row < row1; ++row) {
    const Count word = counts[row];
    counts[row] = 0;
    out[row] = row_value(s, p, row, occ[row], word);
  }
}

// The rows a cluster block owns: ceil(h w / k) rounded up to a multiple
// of four, so that every block's first row keeps the stream's 16-byte
// alignment.
__host__ __device__ __forceinline__ long long cluster_block_rows(long long rows,
                                                                 int k) {
  return ((rows + k - 1) / k + 3) / 4 * 4;
}

// A block's shared memory on the cluster path: its rows' counter words
// and old values.
__host__ __device__ __forceinline__ long long cluster_smem(long long rows,
                                                           int k, int word) {
  return cluster_block_rows(rows, k) * (word + 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Each run of neighbouring lanes holding the same cell adds its length
// to the cell's counter, by one lane, in the shared memory of the block
// that owns the cell's row: this block's, by a shared atomic, or another
// block's of the cluster, through distributed shared memory (cell -1:
// nothing).  The lanes are neighbouring beams at the same ray sample, so
// a cell's lanes are mostly one run (all 32 near the sensor); counts
// are integers, so how the lanes are grouped does not change them.
// Every lane of the warp calls it.
template <typename Count>
__device__ __forceinline__ void add_count_cluster(cg::cluster_group& cl,
                                                  Count* cnt, int rank,
                                                  int block_rows, int cell,
                                                  Count unit, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, cell, 1);
  const unsigned heads =
      __ballot_sync(0xffffffffu, lane == 0 || cell != prev);
  if (cell >= 0 && ((heads >> lane) & 1u)) {
    const unsigned later = lane == 31 ? 0u : heads >> (lane + 1);
    const int run = later ? __ffs(later) : 32 - lane;
    const Count n = unit * static_cast<Count>(run);
    const int owner = cell / block_rows;
    const int at = cell - owner * block_rows;
    if (owner == rank) {
      atomicAdd(cnt + at, n);
    } else {
      atomicAdd(cl.map_shared_rank(cnt, owner) + at, n);
    }
  }
}

// One cluster of k blocks a stream: blockIdx.x = stream * k + rank.
// Block `rank` owns rows [rank R, min(h w, (rank + 1) R)) of its stream
// (R = cluster_block_rows): their counters and their old values live in
// its shared memory.  The counts' warps are spread over the cluster's
// warps (warp-uniform loop: every lane reaches each __match_any_sync).
template <typename Count>
__global__ void __launch_bounds__(kClusterThreads)
    occupancy_cluster_kernel(Scan s, Row p, const float* __restrict__ occ,
                             float* __restrict__ out, int block_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  Count* cnt = reinterpret_cast<Count*>(smem);
  float* old = reinterpret_cast<float*>(cnt + block_rows);
  cg::cluster_group cl = cg::this_cluster();
  const int k = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const long long b = blockIdx.x / k;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long rows = static_cast<long long>(s.h) * s.w;
  const long long r0 = static_cast<long long>(rank) * block_rows;
  const int n_own = static_cast<int>(
      max(0LL, min(rows, r0 + block_rows) - r0));
  const long long g0 = b * rows + r0;        // the block's first row
  NDTG_STAGE(0, "occupancy: start");

  // The old values of the block's rows, copied while the counts run.
  const bool aligned =
      (reinterpret_cast<uintptr_t>(occ + g0) & 15) == 0;
  const int n4 = aligned ? n_own / 4 : 0;
  for (int i = tid; i < n4; i += blockDim.x)
    cp_async16(old + 4 * i, occ + g0 + 4 * i);
  for (int i = 4 * n4 + tid; i < n_own; i += blockDim.x)
    cp_async4(old + i, occ + g0 + i);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < block_rows; i += blockDim.x) cnt[i] = 0;
  // Arrive once the counters are zero (a release); wait (an acquire)
  // only before the first count, so that the first ray's load and cells
  // overlap the other blocks' zeroing.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  NDTG_STAGE(1, "occupancy: zero the counters");

  // The count tasks (32 points x kClusterChunk samples) of the stream, in
  // contiguous ranges a warp: a warp's tasks mostly share their points,
  // whose rays it loads once.
  const int chunks = (s.samples + kClusterChunk - 1) / kClusterChunk;
  const int groups = (s.n_points + 31) / 32;
  const int n_tasks = groups * chunks;
  const int warps = k * (blockDim.x >> 5);
  const int warp = rank * (blockDim.x >> 5) + (tid >> 5);
  const int t0 = static_cast<int>(static_cast<long long>(n_tasks) * warp /
                                  warps);
  const int t1 = static_cast<int>(static_cast<long long>(n_tasks) *
                                  (warp + 1) / warps);
  const Count miss_unit = Count(1) << p.shift;
  bool waited = false;
  int g_ray = -1;
  Ray r = {};
  bool active = false;
  for (int task = t0; task < t1; ++task) {        // warp-uniform
    const int c = task % chunks, g = task / chunks;
    if (g != g_ray) {
      const int pt = g * 32 + lane;
      active = pt < s.n_points;
      if (active) r = load_ray(s, b, pt);
      g_ray = g;
    }
    int cell[kClusterChunk + 1];
    cell[kClusterChunk] = c == 0 && active ? hit_cell(s, r) : -1;
#pragma unroll
    for (int j = 0; j < kClusterChunk; ++j) {
      const int sj = c * kClusterChunk + j;
      cell[j] = active && sj < s.samples ? sample_cell(s, r, sj) : -1;
    }
    if (!waited) {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      waited = true;
    }
    if (c == 0) {
      add_count_cluster<Count>(cl, cnt, rank, block_rows, cell[kClusterChunk],
                               Count(1), lane);
    }
#pragma unroll
    for (int j = 0; j < kClusterChunk; ++j) {
      add_count_cluster<Count>(cl, cnt, rank, block_rows, cell[j],
                               miss_unit, lane);
    }
  }
  if (!waited) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  NDTG_STAGE(2, "occupancy: count");
  cl.sync();     // every count in; no block reads another's memory after
  NDTG_STAGE(3, "occupancy: cluster barrier");

  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // One row a thread, neighbouring threads on neighbouring rows: the
  // old values come from shared memory, and a warp's chains run side by
  // side.
  for (int i = tid; i < n_own; i += blockDim.x)
    out[g0 + i] = row_value(s, p, g0 + i, old[i], cnt[i]);
  NDTG_STAGE(4, "occupancy: row");
}

// Sets the cluster kernel's attributes on the current device (once a
// device): `bytes` of dynamic shared memory and, for clusters of more
// than 8 blocks, the non-portable cluster size.
template <typename Count>
cudaError_t configure_cluster(long long bytes) {
  static long long configured[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[dev] == 0) {
    const void* fn = reinterpret_cast<const void*>(
        occupancy_cluster_kernel<Count>);
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured[dev] = 1;
  }
  return bytes > kMaxSmem ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename Count>
cudaError_t launch_cluster_path(const Scan& s, const Row& p,
                                const float* occ, float* out, int k,
                                cudaStream_t stream) {
  const long long rows = static_cast<long long>(s.h) * s.w;
  const long long bytes = cluster_smem(rows, k, sizeof(Count));
  const cudaError_t e = configure_cluster<Count>(bytes);
  if (e != cudaSuccess) return e;
  if (s.n_streams * k > 2147483647LL) return cudaErrorInvalidValue;
  return static_cast<cudaError_t>(ndtg::launch_cluster(
      occupancy_cluster_kernel<Count>,
      dim3(static_cast<unsigned>(s.n_streams * k)), kClusterThreads, k,
      static_cast<size_t>(bytes), stream, s, p, occ, out,
      static_cast<int>(cluster_block_rows(rows, k))));
}

// Clusters of k blocks the card holds at once on the cluster path
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
template <typename Count>
int max_clusters(long long rows, int k) {
  const long long bytes = cluster_smem(rows, k, sizeof(Count));
  cudaError_t e = configure_cluster<Count>(bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, occupancy_cluster_kernel<Count>,
                                     &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <typename Count>
cudaError_t launch(const Scan& s, const Row& p, const float* occ,
                   float* out, Count* counts, cudaStream_t stream) {
  const long long warps = s.n_streams * ((s.n_points + 31) / 32) *
                          ((s.samples + kChunk - 1) / kChunk);
  const long long count_blocks = (warps * 32 + kThreads - 1) / kThreads;
  constexpr long long kBlockRows = kThreads * kRowsPerThread;
  const long long row_blocks = (p.n_rows + kBlockRows - 1) / kBlockRows;
  if (count_blocks > 2147483647LL || row_blocks > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  if (count_blocks > 0) {
    occupancy_count_kernel<Count>
        <<<static_cast<unsigned>(count_blocks), kThreads, 0, stream>>>(
            s, counts, p.shift);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  occupancy_row_kernel<Count>
      <<<static_cast<unsigned>(row_blocks), kThreads, 0, stream>>>(
          s, p, occ, out, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Clusters of k blocks (1 to kMaxCluster) that the current card holds at
// once on the cluster path for grids of `rows` cells, or a negative CUDA
// error.
int ndtg_occupancy_max_clusters(long long rows, int k, int wide) {
  if (rows < 1 || k < 1 || k > kMaxCluster)
    return -static_cast<int>(cudaErrorInvalidValue);
  return wide ? max_clusters<unsigned long long>(rows, k)
              : max_clusters<unsigned>(rows, k);
}

// out = the occupancy update of occ (n_streams grids of h x w, row-major,
// contiguous) by the scans pts (n_streams, P, 2) / mask (n_streams, P)
// seen from sensor, against grids whose (0, 0) corners are at origin;
// origin and sensor rows `*_stride` floats apart (0: one row for all).
// Counter words 64-bit with `wide`, else 32-bit.  cluster: blocks a
// stream (1 to kMaxCluster) on the one-launch path, whose counters live
// in the cluster's shared memory (counts unused); 0 for the two-pass
// path, whose counts are n_streams * h * w words of zero, left zero.
// chain: null, or one unsigned a row for the number of adds its chain
// made.  Returns the launch error (0 = success).
int ndtg_occupancy_update(const float* occ, float* out, const float* origin,
                          long long origin_stride, const float* sensor,
                          long long sensor_stride, const float* pts,
                          const unsigned char* mask, long long n_streams,
                          int n_points, int h, int w, float res, int samples,
                          float hit, float miss, float lo, float hi,
                          void* counts, int wide, unsigned* chain,
                          int cluster, void* stream) {
  if (n_streams < 1 || n_points < 0 || h < 1 || w < 1 || samples < 1 ||
      cluster < 0 || cluster > kMaxCluster ||
      (cluster == 0 && counts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_rows = n_streams * h * w;
  if (n_rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Scan s = {origin, sensor, pts, mask, origin_stride, sensor_stride,
                  n_streams, n_points, h, w, samples, res};
  const Row p = {hit, miss, lo, hi, wide ? 32 : 16, n_rows, chain};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster > 0) {
    err = wide ? launch_cluster_path<unsigned long long>(s, p, occ, out,
                                                         cluster, st)
               : launch_cluster_path<unsigned>(s, p, occ, out, cluster, st);
  } else {
    err = wide ? launch(s, p, occ, out,
                        static_cast<unsigned long long*>(counts), st)
               : launch(s, p, occ, out, static_cast<unsigned*>(counts), st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
