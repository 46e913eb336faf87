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
// Design, two launches:
//   * Count pass: one thread a (stream, point) and kChunk of its ray
//     samples (the chunk's first thread also takes the point's hit).
//     Every cell coordinate is computed with the rounding of each eager
//     operation on the CPU: (p - o) / res as a correctly rounded
//     division, the sample position so + t (p - so) as three separately
//     rounded operations (no contraction into a fused multiply-add),
//     floor, then the int32 cast as the CPU makes it (INT_MIN for NaN
//     and for values out of range).  A warp's lanes are 32 neighbouring
//     points at the same sample: near the sensor every ray crosses the
//     same few cells, so the lanes that share a cell are grouped
//     (__match_any_sync) and one of them adds their number with one
//     integer atomic.  Counters: one word a row, n_hit in the low
//     `shift` bits and n_miss above them (32-bit words when P < 2^16
//     and P * samples < 2^16, else 64-bit).  No float atomics.
//   * Row pass: every row written exactly once, four consecutive rows
//     a thread (16-byte accesses): the old value, n_hit adds of `hit`,
//     n_miss adds of `miss`, each add rounded once (__fadd_rn), then
//     torch's clamp.  The operands are
//     registers: no load on the chain.  In the last non-empty phase the
//     chain stops once the sum lies strictly beyond the clamp in the
//     direction of that phase's constant: adding a constant of one sign
//     is monotone, so the clamped result is already fixed.  Near the
//     sensor that cuts a chain of thousands of misses to about
//     (2 hi + hit n_hit) / |miss| adds.  The pass zeroes the counters
//     it read, so they are zero for the next update on the stream with
//     no memset launch.
//
// What bounds it on the H100: bytes in principle (occ read and written
// once, 8 bytes a row, and the points, masks and origins read once:
// 0.33 MB a scan, 20.5 MB for a B = 64 fleet step), in practice the
// row pass's longest chain (4-cycle dependent adds) and the count
// pass's atomics on the cells around the sensor.
//
// Not reproduced: a NaN already in `occ` comes out as a NaN, not with
// the CPU's payload bits.
//
// Built with the other sources into one library (ops/cuda_kernels.py
// build): nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3;
// bound through the plain C interface at the bottom.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// out = the occupancy update of occ (n_streams grids of h x w, row-major,
// contiguous) by the scans pts (n_streams, P, 2) / mask (n_streams, P)
// seen from sensor, against grids whose (0, 0) corners are at origin;
// origin and sensor rows `*_stride` floats apart (0: one row for all).
// counts: n_streams * h * w words of zero (64-bit with `wide`, else
// 32-bit), left zero.  chain: null, or one unsigned a row for the number
// of adds its chain made.  Returns the launch error (0 = success).
int ndtg_occupancy_update(const float* occ, float* out, const float* origin,
                          long long origin_stride, const float* sensor,
                          long long sensor_stride, const float* pts,
                          const unsigned char* mask, long long n_streams,
                          int n_points, int h, int w, float res, int samples,
                          float hit, float miss, float lo, float hi,
                          void* counts, int wide, unsigned* chain,
                          void* stream) {
  if (n_streams < 1 || n_points < 0 || h < 1 || w < 1 || samples < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_rows = n_streams * h * w;
  if (n_rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Scan s = {origin, sensor, pts, mask, origin_stride, sensor_stride,
                  n_streams, n_points, h, w, samples, res};
  const Row p = {hit, miss, lo, hi, wide ? 32 : 16, n_rows, chain};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      wide ? launch(s, p, occ, out, static_cast<unsigned long long*>(counts),
                    st)
           : launch(s, p, occ, out, static_cast<unsigned*>(counts), st);
  return static_cast<int>(err);
}

}  // extern "C"
