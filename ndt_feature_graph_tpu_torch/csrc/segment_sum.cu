// Hopper (sm_90a) kernel of the map update's fixed-order sum
// (ops/ndt_map.py scatter_add_rows): new rows = old rows plus every entry
// with that row's index, added one after another in entry order,
// (((old + v_k1) + v_k2) + ...) for k1 < k2 < ..., each add rounded once
// in f32.  That is index_add on the CPU and XLA's `.at[].add` in the JAX
// package (ndt_feature_graph_tpu/ops/ndt_map.py add_points_touched): a
// map update repeats bit for bit, and the card's equals the CPU's.
//
// Replaces no TPU kernel: the reference leaves this scatter to XLA.  It
// takes the place of torch's atomic index_add (an order that changes
// between runs) and of the stable-sorted index_put_(accumulate=True),
// whose sequential add per index is not in torch's API.
//
// Input: the entries' int64 indices as they come (no sort: each block
// needs only its own rows' entries in entry order, and a counting pass
// over row blocks gives that); (base, values, out) triples that share
// the index, up to kMaxChannels float channels in all (the map's count,
// psum and outer: 1 + 2 + 4 channels in one call).
//
// What bounds it on the H100: bytes.  Each row of the bases is read once
// and written once (40,000 cells x 7 floats = 2.24 MB a scan), each entry
// read once (its values and its index): 2.27 MB a scan, 0.68 us at
// 3.35 TB/s; 145 MB, 43.3 us, for a B = 64 fleet step.  At one scan's
// size the passes' dependent steps (loads, block barriers) set the time,
// not the bytes.  Beside the bytes, a row's adds are one
// dependent chain that the fixed order forbids splitting.
//
// Design, two launches:
//   * Bucket pass: a block takes a tile of kTile consecutive entries (in
//     entry order); an entry's digit is its row bucket, idx >> (8 + s):
//     the 256 rows of a row-pass block (256 << s rows when the rows
//     exceed kMaxBuckets buckets: s = 0 up to 4,194,304 rows).  The
//     block finds the tile's least and greatest digit (a fleet step's
//     tile holds the points of two or three streams: a few hundred of
//     the stack's 10,000 digits) and counts only that range.  It ranks
//     the tile's entries stably by digit in shared memory with integer
//     counters only: each warp takes 128 consecutive entries, 32 at a
//     time; the lanes holding one digit are grouped (__match_any_sync)
//     and their leader adds their number to the warp's own 8-bit field
//     of the digit's 64-bit counter (one shared atomic whose sum does
//     not depend on the order of the warps); an entry's rank is the
//     field's value before that add plus its lower peers, plus the
//     fields of the warps before it.  A scan of the digits' totals (each
//     warp a contiguous range, 32 digits a step) gives each digit's
//     start.  The block writes the tile's (entry position, row) pairs,
//     grouped by digit and in entry order within a digit, into the
//     tile's own slice [t kTile, (t + 1) kTile) of the scratch, its
//     digit range, and the starts of the range's digits into the tile's
//     row of a (tiles, buckets + 1) int32 table.
//   * Row pass: block b owns the 256 rows [256 b, 256 b + 256), one a
//     thread, and writes each of them exactly once: the old value plus
//     its entries (an untouched row is copied).  Its bucket's run in each
//     tile comes from the table (none outside the tile's range), one
//     tile a thread; a block scan over the tiles (tile order is entry
//     order) lays the runs end to end.  The block stages that list in
//     chunks of kChunk entries: it ranks each chunk stably by local row
//     the same way as the bucket pass (warp fields, a scan), gathers each
//     entry's values into shared memory at its rank, then each row's
//     thread adds its run with __fadd_rn onto a register accumulator
//     that carries across chunks.  So a row holding every entry (5,000
//     of 6,000 on one cell) works in bounded shared memory and adds in
//     entry order.
//   * No float atomics, no sort.  The scratch (positions, ranges, table)
//     is written by each call before it is used (a table entry outside
//     its tile's range is read but never used): no memset, and no state
//     carried from one call to the next.
//
// Sizes (measured on an H100, PERF.md).  R = 256 rows a row-pass block,
// one a thread: one scan's 40,000 rows run on 157 blocks of the card's
// 132 SMs (the sort-based kernel's 1,024 rows a block gave 39); two and
// four rows a thread were 2% faster at a B = 64 step and 1-15% slower at
// one scan, the main path's shape.
// T = kTile = 1,024 entries a tile: 8 warps of 128, so a warp's field
// (<= 128) fits 8 bits and the eight fields one 64-bit counter; one
// scan's 720 entries are one tile, a B = 64 step's 46,080 are 45, and
// the table 45 x 10,001 ints, of which each tile writes its range.
// Counting every digit of a tile (10,001 at B = 64) made the bucket
// pass 12-13 us; counting the tile's range, 4 us.  kChunk = 512 entries
// (14 KB of values at 7 channels).
//
// Built with the other sources into one library (ops/cuda_kernels.py
// build): nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3;
// bound through the plain C interface at the bottom.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBlock = kThreads;          // rows a block, one a thread
constexpr int kRowShift = 8;                 // log2(kRowBlock)
static_assert(kRowBlock == 1 << kRowShift, "kRowShift");
constexpr int kWarpSpan = 128;               // tile entries a warp ranks
constexpr int kTile = kWarps * kWarpSpan;    // entries a bucket-pass tile
constexpr int kTileSteps = kWarpSpan / 32;
constexpr int kChunk = 512;                  // entries a row-pass chunk
constexpr int kChunkSteps = kChunk / kThreads;
constexpr int kMaxBuckets = 16384;           // 128 KB of tile counters
constexpr int kMaxChannels = 8;
constexpr unsigned kFull = 0xffffffffu;

// One float channel: element (row, 0) of a (rows, stride) array at
// base / val / out, the channel's column already added.
struct Channels {
  const float* base[kMaxChannels];   // (n_rows, stride)
  const float* val[kMaxChannels];    // (m, stride)
  float* out[kMaxChannels];          // (n_rows, stride)
  int stride[kMaxChannels];
};

// Row r of the bases into v, a float a channel.
template <int C>
__device__ __forceinline__ void load_row(const Channels& ch, long long r,
                                         float (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __ldg(ch.base[c] + r * ch.stride[c]);
}

// v into row r of the outputs.
template <int C>
__device__ __forceinline__ void store_row(const Channels& ch, long long r,
                                          const float (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) ch.out[c][r * ch.stride[c]] = v[c];
}

// The sum of the eight 8-bit fields of a counter (each <= 255).
__device__ __forceinline__ int field_sum(unsigned long long x) {
  x = (x & 0x00FF00FF00FF00FFull) + ((x >> 8) & 0x00FF00FF00FF00FFull);
  x = (x & 0x0000FFFF0000FFFFull) + ((x >> 16) & 0x0000FFFF0000FFFFull);
  return static_cast<int>((x & 0xFFFFFFFFull) + (x >> 32));
}

// The fields of the warps before `warp`.
__device__ __forceinline__ int fields_below(unsigned long long x, int warp) {
  return warp == 0 ? 0 : field_sum(x & ((1ull << (8 * warp)) - 1));
}

// Rank of this lane's `key` among the warp's earlier entries of the same
// key (the calls before this one, then the lower lanes): the leader of
// the lanes holding `key` adds their number to the warp's field of
// counter[key].  Keys >= n_keys are not counted (rank 0).  Every lane of
// the warp calls it.
__device__ __forceinline__ int warp_rank(unsigned long long* counter,
                                         int key, int n_keys, int warp,
                                         int lane) {
  const unsigned peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  unsigned long long old = 0;
  if (key < n_keys && lane == leader) {
    old = atomicAdd(counter + key,
                    static_cast<unsigned long long>(__popc(peers))
                        << (8 * warp));
  }
  old = __shfl_sync(kFull, old, leader);
  return static_cast<int>((old >> (8 * warp)) & 0xFF) +
         __popc(peers & ((1u << lane) - 1));
}

// Exclusive scan over the block of one int a thread, in thread order;
// the block's total into `total`.  warp_tot: kWarps ints of shared
// memory.  Every thread calls it; it synchronises the block twice, so
// shared memory written before the call is seen by every thread after it,
// and read before the call may be written after it.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();                    // warp_tot free for the next scan
  return before + x - v;
}

// Bucket pass: tile blockIdx.x.  Its digits span [lo, hi] (a fleet
// step's tile holds the points of two or three streams: a few hundred of
// the stack's digits); range[tile] = (lo, hi), and the table row holds,
// at digits lo .. hi + 1, the start of each digit's run in the tile's
// slice (hi + 1: the tile's entries on the rows); the other digits of
// the row are not written.  ent: (entry position, row) at tile start +
// run start + rank.  Entries outside [0, n_rows) take no slot.  Dynamic
// shared memory: n_buckets + 1 counters.
__global__ void __launch_bounds__(kThreads)
    segment_add_rows_bucket_pass(const long long* __restrict__ idx,
                                 long long m, long long n_rows,
                                 int n_buckets, int shift,
                                 int* __restrict__ table,
                                 int2* __restrict__ range,
                                 int2* __restrict__ ent) {
  extern __shared__ unsigned long long counter[];
  __shared__ int warp_tot[kWarps];
  __shared__ int span[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    span[0] = n_buckets;
    span[1] = -1;
  }
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  long long v[kTileSteps];             // every load in flight at once
#pragma unroll
  for (int s = 0; s < kTileSteps; ++s) {
    const long long j = t0 + warp * kWarpSpan + s * 32 + lane;
    v[s] = j < m ? __ldg(idx + j) : -1;
  }
  int digit[kTileSteps], lo = n_buckets, hi = -1;
#pragma unroll
  for (int s = 0; s < kTileSteps; ++s) {
    // past the entries or off the rows: no digit
    const bool on = v[s] >= 0 && v[s] < n_rows;
    digit[s] = on ? static_cast<int>(v[s] >> shift) : n_buckets + 1;
    if (on) {
      lo = min(lo, digit[s]);
      hi = max(hi, digit[s]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
  }
  __syncthreads();                    // span initialised
  if (lane == 0) {
    atomicMin(span, lo);
    atomicMax(span + 1, hi);
  }
  __syncthreads();
  lo = span[0];
  hi = span[1];
  const int n_digits = max(hi - lo + 2, 1);    // lo .. hi + 1
  for (int d = threadIdx.x; d < n_digits; d += kThreads) counter[d] = 0;
  __syncthreads();                    // the counters are zero
  int rank[kTileSteps];
#pragma unroll
  for (int s = 0; s < kTileSteps; ++s) {
    digit[s] = digit[s] <= hi ? digit[s] - lo : n_digits;
    rank[s] = warp_rank(counter, digit[s], n_digits - 1, warp, lane);
  }
  __syncthreads();                    // every warp's fields are in
#pragma unroll
  for (int s = 0; s < kTileSteps; ++s) {
    if (digit[s] < n_digits - 1) {
      rank[s] += fields_below(counter[digit[s]], warp);
    }
  }
  // The digits' starts: warp w scans digits [d0, d1), 32 at a time, on
  // top of the totals of the warps before it.
  const int per = (n_digits + kThreads - 1) / kThreads * 32;
  const int d0 = min(n_digits, warp * per);
  const int d1 = min(n_digits, d0 + per);
  int sum = 0;
  for (int d = d0 + lane; d < d1; d += 32) sum += field_sum(counter[d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) warp_tot[warp] = sum;
  __syncthreads();                    // ranks and sums read their fields
  int carry = 0;
  for (int w = 0; w < warp; ++w) carry += warp_tot[w];
  int* starts = table + static_cast<long long>(blockIdx.x) * (n_buckets + 1)
                + lo;
#pragma unroll 4
  for (int base = d0; base < d1; base += 32) {
    const int d = base + lane;
    const int c = d < d1 ? field_sum(counter[d]) : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (d < d1) {
      counter[d] = static_cast<unsigned long long>(carry + x - c);
      if (hi >= lo) starts[d] = carry + x - c;
    }
    carry += __shfl_sync(kFull, x, 31);
  }
  if (threadIdx.x == 0) range[blockIdx.x] = make_int2(lo, hi);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kTileSteps; ++s) {
    if (digit[s] < n_digits - 1) {
      const int j = static_cast<int>(t0) + warp * kWarpSpan + s * 32 + lane;
      ent[t0 + static_cast<int>(counter[digit[s]]) + rank[s]] =
          make_int2(j, static_cast<int>(v[s]));
    }
  }
}

// Row pass: rows [R b, R b + R) of bucket b >> shift (R = kRowBlock);
// thread t holds row R b + t.
template <int C>
__global__ void __launch_bounds__(kThreads)
    segment_add_rows_row_pass(Channels ch, long long n_rows,
                              const int* __restrict__ table,
                              const int2* __restrict__ range,
                              const int2* __restrict__ ent, int n_tiles,
                              int n_buckets, int shift) {
  __shared__ unsigned long long counter[kRowBlock];
  __shared__ int start[kRowBlock];
  __shared__ int tile_at[kThreads];    // scratch position of a tile's run
  __shared__ int tile_pre[kThreads];   // its first place in the list
  __shared__ int warp_tot[kWarps];
  __shared__ float staged[kChunk * C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowBlock;
  const long long row = r0 + threadIdx.x;
  float acc[C];
  if (row < n_rows) load_row<C>(ch, row, acc);
  counter[threadIdx.x] = 0;
  const int q = static_cast<int>(blockIdx.x >> shift);
  for (int tb = 0; tb < n_tiles; tb += kThreads) {
    // The bucket's run in each tile of the batch, laid end to end.
    const int tile = tb + threadIdx.x;
    int at = 0, n = 0;
    if (tile < n_tiles) {
      const int2 span = __ldcg(range + tile);
      const int* starts = table + static_cast<long long>(tile) *
                                      (n_buckets + 1) + q;
      const int a = __ldcg(starts);
      const int b = __ldcg(starts + 1);
      if (q >= span.x && q <= span.y) {
        at = a + tile * kTile;
        n = b - a;
      }
    }
    int total;
    const int pre = block_scan(n, warp_tot, total);
    tile_at[threadIdx.x] = at;
    tile_pre[threadIdx.x] = pre;
    const int last_tile = min(kThreads, n_tiles - tb) - 1;
    __syncthreads();
    for (int j0 = 0; j0 < total; j0 += kChunk) {
      const int n_c = min(kChunk, total - j0);
      // Warp w ranks list places j0 + w * span .. + span - 1, in order.
      const int span = (n_c + kThreads - 1) / kThreads * 32;
      int key[kChunkSteps], rank[kChunkSteps], pos[kChunkSteps];
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        const int i = warp * span + s * 32 + lane;
        key[s] = kRowBlock + 1;        // no entry
        pos[s] = 0;
        if (s * 32 < span && i < n_c) {
          const int j = j0 + i;
          int lo = 0, hi = last_tile;  // the last tile whose run starts <= j
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (tile_pre[mid] <= j) lo = mid; else hi = mid - 1;
          }
          const int2 e = __ldcg(ent + tile_at[lo] + (j - tile_pre[lo]));
          const long long local = e.y - r0;
          pos[s] = e.x;
          key[s] = local >= 0 && local < kRowBlock ? static_cast<int>(local)
                                                   : kRowBlock;
        }
        rank[s] = warp_rank(counter, key[s], kRowBlock, warp, lane);
      }
      __syncthreads();                // every warp's fields are in
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        if (key[s] < kRowBlock) rank[s] += fields_below(counter[key[s]], warp);
      }
      const int cnt = field_sum(counter[threadIdx.x]);
      int placed;                     // the chunk's entries on the rows
      const int first = block_scan(cnt, warp_tot, placed);
      start[threadIdx.x] = first;
      counter[threadIdx.x] = 0;       // for the next chunk
      __syncthreads();
      // Each entry's values, gathered at its place in the run of its row.
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        if (key[s] < kRowBlock) {
          float* dst = staged + (start[key[s]] + rank[s]) * C;
          const long long k = pos[s];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dst[c] = __ldg(ch.val[c] + k * ch.stride[c]);
          }
        }
      }
      __syncthreads();                // the chunk is staged by row
      const float* run = staged + first * C;
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], run[k * C + c]);
      }
      __syncthreads();                // staged free for the next chunk
    }
  }
  if (row < n_rows) store_row<C>(ch, row, acc);
}

// Row buckets of kRowBlock << shift rows: the least shift that keeps
// them within kMaxBuckets.
int bucket_shift(long long n_rows) {
  int shift = 0;
  while (((n_rows - 1) >> (kRowShift + shift)) + 1 > kMaxBuckets) ++shift;
  return shift;
}

template <int C>
cudaError_t launch_rows(const Channels& ch, long long n_rows,
                        const int* table, const int2* range,
                        const int2* ent, int n_tiles, int n_buckets,
                        int shift, unsigned blocks, cudaStream_t stream) {
  segment_add_rows_row_pass<C><<<blocks, kThreads, 0, stream>>>(
      ch, n_rows, table, range, ent, n_tiles, n_buckets, shift);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ndtg_segment_max_channels() { return kMaxChannels; }

// int32 words of scratch a call on m entries and n_rows rows needs: the
// tiles' (position, row) pairs, their digit ranges, then their table.
long long ndtg_segment_scratch_words(long long m, long long n_rows) {
  if (m <= 0 || n_rows <= 0) return 0;
  const long long tiles = (m + kTile - 1) / kTile;
  const int shift = bucket_shift(n_rows);
  const long long buckets = ((n_rows - 1) >> (kRowShift + shift)) + 1;
  return tiles * (kTile + 1) * 2 + tiles * (buckets + 1);
}

// outs[k] = bases[k] with the rows vals[k][p] added at row idx[p],
// p = 0..m-1 in order, for each of the n_groups (base, vals, out)
// triples of widths[k] float channels (row-major, contiguous); idx int64
// as given.  scratch: ndtg_segment_scratch_words(m, n_rows) int32 words,
// 8-byte aligned, in any state.  Entries whose index lies outside
// [0, n_rows) add nothing.  Two launches (one when m = 0).  Returns the
// launch error (0 = success).
int ndtg_segment_add_rows(const long long* idx, long long m,
                          long long n_rows, int n_groups,
                          const float* const* bases,
                          const float* const* vals, float* const* outs,
                          const int* widths, int* scratch, void* stream) {
  if (n_rows < 1 || n_rows > 2147483647LL || m < 0 || m > 2147483647LL ||
      n_groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const int shift = bucket_shift(n_rows);
  const int n_buckets =
      static_cast<int>(((n_rows - 1) >> (kRowShift + shift)) + 1);
  const int n_tiles = static_cast<int>((m + kTile - 1) / kTile);
  int2* ent = reinterpret_cast<int2*>(scratch);
  int2* range = ent + static_cast<long long>(n_tiles) * kTile;
  int* table = reinterpret_cast<int*>(range + n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    const int smem =
        (n_buckets + 1) * static_cast<int>(sizeof(unsigned long long));
    if (smem > 48 * 1024) {           // above the static limit: opt in
      const cudaError_t err = cudaFuncSetAttribute(
          segment_add_rows_bucket_pass,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    segment_add_rows_bucket_pass<<<n_tiles, kThreads, smem, s>>>(
        idx, m, n_rows, n_buckets, kRowShift + shift, table, range, ent);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks =
      static_cast<unsigned>((n_rows + kRowBlock - 1) / kRowBlock);
  cudaError_t err = cudaErrorInvalidValue;
  switch (c) {
#define NDTG_ROWS(C_)                                                    \
  case C_:                                                               \
    err = launch_rows<C_>(ch, n_rows, table, range, ent, n_tiles,        \
                          n_buckets, shift, blocks, s);                  \
    break;
    NDTG_ROWS(1) NDTG_ROWS(2) NDTG_ROWS(3) NDTG_ROWS(4)
    NDTG_ROWS(5) NDTG_ROWS(6) NDTG_ROWS(7) NDTG_ROWS(8)
#undef NDTG_ROWS
    default: break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
