// Hopper (sm_90a) kernel of the link paths' occupancy-overlap score
// (graph/links.py _overlap_score_flat and occupancy_overlap_score,
// through ops/cuda_kernels.py overlap_score): for each node pair (ref,
// mov) under the pose T (mov frame -> ref frame), the mean squared
// difference of the sigmoid occupancies over the cells where both maps
// carry information (|log-odds| > 1e-6), and their number; 1.0 without
// overlap.
//
// Replaces no TPU kernel: the reference leaves the score to XLA
// (ndt_feature_graph_tpu/graph/links.py occupancy_overlap_score,
// _overlap_score_flat).  It takes the place of the port's eager score
// (ops/cuda_kernels.py overlap_score_reference, ~30 operations over
// (P, H*W) tensors) and of the `row_sum` kernel that summed its last
// (P, H*W) intermediate.
//
// One launch, one pass, nothing written but the outputs.  Per pair and
// per moving cell c = (row r, column q):
//   * the cell centre  o_mov + (q + 0.5, r + 0.5) * res,
//   * its move by T    (c x - s y + t0, s x + c y + t1),
//   * rel = (tp - o_ref) * (1 / res), the floors, the bounds test and
//     the flat index iy * w + ix,
//   * the reference log-odds there, read from the bank (__ldg),
//   * both sigmoids, the two |x| > 1e-6 tests, and (a - b)^2 where both
//     hold;
// then the pair's sum and count, and sum / count (1.0 at count 0).
//
// Rounding: each operation rounds as the eager path's operation does on
// a CUDA tensor, so every cell index and every "both" bit is the eager
// path's: centres and rel as separately rounded operations; the rotation
// as torch's einsum contracts it (the product of the first column, then
// a fused multiply-add of the second: fma(R01, y, R00 x)); the division
// by the Python float `res` as a product with its float32 reciprocal, as
// ATen does with a CPU scalar divisor; the sigmoid as ATen's
// 1 / (1 + expf(-x)) with IEEE expf and division; the floors' int cast
// as cvt.rzi (NaN -> 0, as the eager int64 cast on the card).
//
// Design for this card:
//   * A cluster of C blocks serves one pair; C is a function of H*W
//     alone (a block per 256 vectors of four cells, at most the portable
//     8), so a pair scored alone (compute_link) runs the same blocks in
//     the same order as its row of a batch (compute_links_batch,
//     rescore_links): its bits.  The canonical 200 x 200 grid is spread
//     over 8 SMs even for one pair; 171 pairs give 1,368 blocks.
//   * The moving row is read straight from the bank, 16 bytes a load
//     where it is 16-byte aligned (four scalar loads with the same
//     order of adds otherwise, and for the partial last vector).  Thread
//     g of the cluster (rank * 256 + thread) takes vectors g, g + G, ...
//     (G = 256 C), four of them loaded before it works on any, and keeps
//     one accumulator per lane of the vector, four independent chains.
//     A vector the moving map does not know stops after the load and
//     the test (the canonical maps know a few percent of their cells);
//     in one it knows, the four cells' moves and gathers are independent.
//     Registers are capped for six blocks an SM.
//   * One fixed summation order, a function of H*W (and so of C) only:
//     each thread's (a0 + a1) + (a2 + a3); a warp-shuffle tree (offsets
//     16, 8, 4, 2, 1, lane 0's sum); the block's eight warps added in
//     order by thread 0, which writes the block's sum into rank 0's
//     shared memory (distributed shared memory); after one cluster
//     barrier rank 0 adds them in rank order.  No float atomics, no
//     second launch, the same bits on every call.  The count is an
//     integer sum.  tests/test_torch_overlap.py mirrors this order in
//     numpy.
//
// A second kernel, overlap_group_kernel (below), serves batches of 160
// pairs and more: a cluster a group of pairs that share a moving node,
// which reads that node's map once for the group; the same order, so
// the same bits.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32): the distinct
// bytes are the bank's maps (160 KB a node at 200 x 200), 3.2 MB for
// the 20-node bank of the offline graph's 171 pairs (~1 us); the
// operations are ~20 a known moving cell and ~73 a cell both maps know
// (two expf and two divisions), ~14 Mop there.  chip_smoke.py prints
// both for each run's own inputs.  On the pair path each pair reads its
// 160 KB moving row again (from L2: 27 MB at 171 pairs), and a pair's
// blocks wait on three dependent reads (indices, rows, gathers) and the
// cluster barrier: latency at a few pairs, L2 traffic at many.
//
// Built with the other sources into one library (ops/cuda_kernels.py
// build): nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// fast math; bound through the plain C interface at the bottom.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_probe.cuh"

namespace cg = cooperative_groups;

#ifdef NDTG_STAGE_PROBE
// Copies the lap sums of the NDTG_LAP marks below to host memory and
// clears them (examples/probe_link_stages.py).
extern "C" int ndtg_overlap_probe_read(long long* clock, long long* ns) {
  return ndtg::probe_read(clock, ns);
}
#endif

namespace {

// The layout: threads a block, the largest cluster, vectors a thread
// loads before it works on them, and the blocks an SM should hold (a
// register cap).  Threads and cluster set the order of the sum, and
// tests/test_torch_overlap.py's mirror reads them (ndtg_overlap_threads,
// ndtg_overlap_cluster).  PERF.md section 6 gives the layouts timed
// against this one.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;           // cells a vector
constexpr int kMaxCluster = 8;
constexpr int kBatch = 4;
constexpr int kMinBlocks = 6;
constexpr float kHas = 1e-6f;     // |log-odds| above this: the cell is known

// Blocks of a pair's cluster: a function of H*W only.
int cluster_of(long long hw) {
  const long long n_vec = (hw + kVec - 1) / kVec;
  long long c = (n_vec + kThreads - 1) / kThreads;
  if (c < 1) c = 1;
  return static_cast<int>(c < kMaxCluster ? c : kMaxCluster);
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  // ATen's CUDA sigmoid for float: one / (one + std::exp(-a)).
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

struct Pair {
  const float* mov;    // the moving map's H*W log-odds
  const float* ref;    // the reference map's
  float ox, oy;        // the moving map's origin
  float rx, ry;        // the reference map's origin
  float c, s, t0, t1;  // the pose's rotation and translation
};

// The vector of four moving log-odds at cells c0.. (zeros past hw).
__device__ __forceinline__ float4 load_vec(const float* row, int c0, int hw,
                                           bool aligned) {
  if (aligned && c0 + kVec <= hw) {
    return __ldg(reinterpret_cast<const float4*>(row + c0));
  }
  float4 q;
  q.x = c0 < hw ? __ldg(row + c0) : 0.0f;
  q.y = c0 + 1 < hw ? __ldg(row + c0 + 1) : 0.0f;
  q.z = c0 + 2 < hw ? __ldg(row + c0 + 2) : 0.0f;
  q.w = c0 + 3 < hw ? __ldg(row + c0 + 3) : 0.0f;
  return q;
}

// One vector of moving cells c0..c0+3: adds (a - b)^2 to acc[k] and one
// to n for each cell k both maps know.  A vector the moving map does not
// know stops at the test.  The four cells' moves and gathers are
// independent, so their reads overlap.  With kCells every cell's flat
// reference index is written to out[c] (-1 out of bounds), known to the
// moving map or not.
template <bool kCells>
__device__ __forceinline__ void vector_cells(const Pair& p, float4 q, int c0,
                                             int hw, int h, int w, float res,
                                             float inv, float* acc, int& n,
                                             int* out) {
  const float m[kVec] = {q.x, q.y, q.z, q.w};
  bool known[kVec];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    known[k] = fabsf(m[k]) > kHas;      // false past hw: the value is 0
    any |= known[k];
  }
  if (!kCells && !any) return;
  int r = c0 / w;
  int col = c0 - r * w;
  int idx[kVec];
  bool live[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float x =
        __fadd_rn(p.ox, __fmul_rn(__fadd_rn((float)col, 0.5f), res));
    const float y = __fadd_rn(p.oy, __fmul_rn(__fadd_rn((float)r, 0.5f), res));
    const float tx = __fadd_rn(__fmaf_rn(-p.s, y, __fmul_rn(p.c, x)), p.t0);
    const float ty = __fadd_rn(__fmaf_rn(p.c, y, __fmul_rn(p.s, x)), p.t1);
    const int ix = (int)floorf(__fmul_rn(__fsub_rn(tx, p.rx), inv));
    const int iy = (int)floorf(__fmul_rn(__fsub_rn(ty, p.ry), inv));
    const bool inb = ix >= 0 && ix < w && iy >= 0 && iy < h;
    idx[k] = inb ? iy * w + ix : 0;
    live[k] = known[k] && inb;
    if (kCells && c0 + k < hw) out[c0 + k] = inb ? idx[k] : -1;
    if (++col == w) {
      col = 0;
      ++r;
    }
  }
  float b[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) b[k] = live[k] ? __ldg(p.ref + idx[k]) : 0.0f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (live[k] && fabsf(b[k]) > kHas) {
      const float d = __fsub_rn(sigmoid_rn(m[k]), sigmoid_rn(b[k]));
      acc[k] = __fadd_rn(acc[k], __fmul_rn(d, d));
      n += 1;
    }
  }
}

// grid.x = C * n_pairs, cluster C: cluster k scores pair k.
template <bool kCells>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    overlap_kernel(const float* __restrict__ ref_occ,
                   const float* __restrict__ ref_origins,
                   const long long* __restrict__ ref_i, long long n_ref,
                   const float* __restrict__ mov_occ,
                   const float* __restrict__ mov_origins,
                   const long long* __restrict__ mov_i, long long n_mov,
                   const float* __restrict__ T, int h, int w, float res,
                   float inv, float* __restrict__ score,
                   long long* __restrict__ nb, int* __restrict__ cells) {
  __shared__ float warp_s[kWarps];
  __shared__ int warp_n[kWarps];
  __shared__ float block_s[kMaxCluster];   // rank 0's: each block's sum
  __shared__ int block_n[kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const long long pair = blockIdx.x / n_blocks;
  const int hw = h * w;
  // Half a cluster barrier: its wait, before the blocks write into rank
  // 0's shared memory, knows every block of the cluster has started.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  NDTG_LAP_BEGIN();

  // Without index tensors pair k reads node 0 of each bank.
  const long long ri = ref_i ? __ldg(ref_i + pair) : 0;
  const long long mi = mov_i ? __ldg(mov_i + pair) : 0;
  const bool ok = ri >= 0 && ri < n_ref && mi >= 0 && mi < n_mov;

  float acc[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};   // one a lane of a vector
  int n = 0;
  if (ok) {
    Pair p;
    p.mov = mov_occ + mi * hw;
    p.ref = ref_occ + ri * hw;
    p.ox = __ldg(mov_origins + 2 * mi);
    p.oy = __ldg(mov_origins + 2 * mi + 1);
    p.rx = __ldg(ref_origins + 2 * ri);
    p.ry = __ldg(ref_origins + 2 * ri + 1);
    const float th = __ldg(T + 3 * pair + 2);
    p.c = cosf(th);
    p.s = sinf(th);
    p.t0 = __ldg(T + 3 * pair);
    p.t1 = __ldg(T + 3 * pair + 1);
#ifdef NDTG_STAGE_PROBE
    if (p.c + p.t0 + p.t1 + p.ox + p.oy + p.rx + p.ry == 1.2345e-37f) n = 1;
#endif
    NDTG_LAP(1, "overlap: indices, origins, pose");
    int* out = kCells ? cells + pair * hw : nullptr;
    const bool aligned = (reinterpret_cast<uintptr_t>(p.mov) & 15) == 0;
    const int n_vec = (hw + kVec - 1) / kVec;
    const int stride = n_blocks * kThreads;
    // Vectors v0, v0 + stride, ... in ascending order, kBatch of them
    // loaded before any is worked on, so their reads are in flight
    // together.
    for (int v0 = rank * kThreads + threadIdx.x; v0 < n_vec;
         v0 += kBatch * stride) {
      float4 q[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int v = v0 + j * stride;
        q[j] = v < n_vec ? load_vec(p.mov, v * kVec, hw, aligned)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#ifdef NDTG_STAGE_PROBE
      float probe_sum = 0.0f;
      for (int j = 0; j < kBatch; ++j) probe_sum += q[j].x + q[j].w;
      if (probe_sum == 1.2345e-37f) n = 1;
#endif
      NDTG_LAP(2, "overlap: moving row");
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int v = v0 + j * stride;
        if (v < n_vec) {
          vector_cells<kCells>(p, q[j], v * kVec, hw, h, w, res, inv, acc,
                               n, out);
        }
      }
#ifdef NDTG_STAGE_PROBE
      if (acc[0] + acc[1] + acc[2] + acc[3] == 1.2345e-37f) n = 1;
#endif
      NDTG_LAP(3, "overlap: reference gathers");
    }
  }

  // The fixed order: thread, warp tree, the block's warps, the cluster.
  float t = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, off));
    n += __shfl_down_sync(0xffffffffu, n, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_s[warp] = t;
    warp_n[warp] = n;
  }
  __syncthreads();
  NDTG_LAP(4, "overlap: warp tree");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  NDTG_LAP(5, "overlap: cluster start barrier");
  if (threadIdx.x == 0) {
    float s = warp_s[0];
    int c = warp_n[0];
    for (int k = 1; k < kWarps; ++k) {
      s = __fadd_rn(s, warp_s[k]);
      c += warp_n[k];
    }
    // Into rank 0's shared memory: after the barrier only rank 0 reads,
    // its own memory, so the other blocks may leave.
    *cluster.map_shared_rank(block_s + rank, 0) = s;
    *cluster.map_shared_rank(block_n + rank, 0) = c;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float s = block_s[0];
    int c = block_n[0];
    for (int k = 1; k < n_blocks; ++k) {
      s = __fadd_rn(s, block_s[k]);
      c += block_n[k];
    }
    if (!ok) {
      score[pair] = __int_as_float(0x7fc00000);   // NaN: no such node
      nb[pair] = -1;
    } else {
      score[pair] = c > 0 ? __fdiv_rn(s, (float)c) : 1.0f;
      nb[pair] = c;
    }
  }
  NDTG_LAP(6, "overlap: cluster sum");
  NDTG_LAP_COUNT();
  NDTG_LAP_END(blockIdx.x);
}

// ---------------------------------------------------------------------
// The group path: pairs that share a moving node read its map once.
//
// A stage split (PERF.md section 6) found a pair's eight blocks spending their
// ~5.6 us on a chain of waits (indices and pose 0.9, the moving row 1.3,
// the gathers 1.3, the tree and the cluster sum 2.0), at two waves of
// blocks for 171 pairs and ten for 1,024, each pair reading its 160 KB
// moving row again.  Here a cluster of the same C blocks of 256 threads
// (thread t of block r is the pair path's thread (r, t)) serves a group of up
// to G pairs of one moving node: each thread reads its vectors of that
// map once (at most kGroupMaxVec, so grids up to kGroupMaxVec * 2,048
// vectors) into its own slots of shared memory, with a bit for each
// vector the map knows a cell of, then runs the group's pairs
// kGroupBatch at a time with their gathers in flight together, over its
// known vectors only, one warp tree a pair and one cluster barrier for
// the group.  The map's 160 KB are read once a group instead of once a
// pair.  Each pair's adds keep the pair path's order (a thread's vectors in
// ascending order, (a0 + a1) + (a2 + a3), the warp tree, the block's
// warps, the blocks in rank order), so its score has the bits of the
// pair path and of overlap_mirror.  Registers are capped for four
// blocks an SM (64, none spilled: at six the kernel spilled and was
// slower; tune_torch_port_kernels.py --overlap).
//
// The groups: the pairs of each moving node in index order, cut into
// runs of G; group k is the k-th in the order (node, run).  Every block
// finds its cluster's group itself from mov_i: a count of pairs a node
// in shared memory, a scan of the groups a node, and an ordered pass
// over the keys (held in registers for the first 1,024 pairs) for the
// group's pairs: no sort, no other launch.  Pairs whose moving index
// lies outside its bank form groups of a key of their own and score
// NaN / -1, as on the pair path; so do pairs whose reference index
// does.
//
// The wrapper's size rule (ops/cuda_kernels.py overlap_group) takes the
// pair path below 160 pairs and groups of 4 / 8 above, where the group
// path measured faster (171 pairs 13.6 -> 12.6 us, 1,024 pairs 62 -> 45
// us, warm L2, PERF.md section 6); the one-pair form and `cells` take the
// pair path.
constexpr int kGroupMaxVec = 6;       // vectors a thread holds
constexpr int kGroupMax = 8;          // pairs a group
constexpr int kGroupBatch = 2;        // pairs whose gathers overlap
// Blocks of the group kernel an SM holds (a register cap; the tune builds
// others, examples/tune_torch_port_kernels.py --overlap).
#ifndef NDTG_OVERLAP_GROUP_BLOCKS
#define NDTG_OVERLAP_GROUP_BLOCKS 4
#endif
constexpr int kGroupBlocks = NDTG_OVERLAP_GROUP_BLOCKS;
constexpr int kGroupMaxNodes = 4096;  // moving nodes the count takes
constexpr int kKeyTiles = 4;          // pairs' keys held: 1,024 pairs

struct PairParams {
  long long ref_off;   // the reference map's offset into its bank
  float ox, oy, rx, ry, c, s, t0, t1;
  int ok;
};

// kGroupBatch pairs of one moving node on one vector of moving cells
// c0..c0+3: vector_cells' operations for each pair, the cells' centres
// and the moving sigmoids shared, every gather of the batch issued
// before any is used.
__device__ __forceinline__ void vector_cells_batch(
    const Pair* ps, const bool* use, float4 q, int c0, int h, int w,
    float res, float inv, float (*acc)[kVec], int* n) {
  const float m[kVec] = {q.x, q.y, q.z, q.w};
  bool known[kVec];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    known[k] = fabsf(m[k]) > kHas;
    any |= known[k];
  }
  if (!any) return;
  int r = c0 / w;
  int col = c0 - r * w;
  float x[kVec], y[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    x[k] = __fadd_rn(ps[0].ox, __fmul_rn(__fadd_rn((float)col, 0.5f), res));
    y[k] = __fadd_rn(ps[0].oy, __fmul_rn(__fadd_rn((float)r, 0.5f), res));
    if (++col == w) {
      col = 0;
      ++r;
    }
  }
  int idx[kGroupBatch][kVec];
  bool live[kGroupBatch][kVec];
#pragma unroll
  for (int b = 0; b < kGroupBatch; ++b) {
    const Pair& p = ps[b];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float tx =
          __fadd_rn(__fmaf_rn(-p.s, y[k], __fmul_rn(p.c, x[k])), p.t0);
      const float ty =
          __fadd_rn(__fmaf_rn(p.c, y[k], __fmul_rn(p.s, x[k])), p.t1);
      const int ix = (int)floorf(__fmul_rn(__fsub_rn(tx, p.rx), inv));
      const int iy = (int)floorf(__fmul_rn(__fsub_rn(ty, p.ry), inv));
      const bool inb = ix >= 0 && ix < w && iy >= 0 && iy < h;
      idx[b][k] = inb ? iy * w + ix : 0;
      live[b][k] = use[b] && known[k] && inb;
    }
  }
  float bv[kGroupBatch][kVec];
#pragma unroll
  for (int b = 0; b < kGroupBatch; ++b) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      bv[b][k] = live[b][k] ? __ldg(ps[b].ref + idx[b][k]) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (!known[k]) continue;
    const float sm = sigmoid_rn(m[k]);
#pragma unroll
    for (int b = 0; b < kGroupBatch; ++b) {
      if (live[b][k] && fabsf(bv[b][k]) > kHas) {
        const float d = __fsub_rn(sm, sigmoid_rn(bv[b][k]));
        acc[b][k] = __fadd_rn(acc[b][k], __fmul_rn(d, d));
        n[b] += 1;
      }
    }
  }
}

// Exclusive prefix sum of v over the block (kThreads threads); *total
// gets the sum.  Every thread must call it; `tmp` holds kWarps ints.
__device__ __forceinline__ int block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    before += k < warp ? tmp[k] : 0;
    all += tmp[k];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// grid.x = C * (groups launched), cluster C: cluster k scores group k
// (an idle cluster, past the groups there are, leaves).
__global__ void __launch_bounds__(kThreads, kGroupBlocks)
    overlap_group_kernel(const float* __restrict__ ref_occ,
                         const float* __restrict__ ref_origins,
                         const long long* __restrict__ ref_i, long long n_ref,
                         const float* __restrict__ mov_occ,
                         const float* __restrict__ mov_origins,
                         const long long* __restrict__ mov_i, int n_mov,
                         const float* __restrict__ T, int n_pairs, int h,
                         int w, float res, float inv, int group,
                         float* __restrict__ score,
                         long long* __restrict__ nb) {
  extern __shared__ int count[];            // pairs a key, n_mov + 1 keys
  __shared__ int scan_tmp[kWarps];
  __shared__ int found[2];                 // the group's key and run
  __shared__ int members[kGroupMax];       // its pairs, in index order
  __shared__ PairParams pp[kGroupMax];
  __shared__ float warp_s[kGroupMax][kWarps];
  __shared__ int warp_n[kGroupMax][kWarps];
  __shared__ float block_s[kGroupMax][kMaxCluster];   // rank 0's
  __shared__ int block_n[kGroupMax][kMaxCluster];
  __shared__ float4 vectors[kGroupMaxVec][kThreads];   // the moving map's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const int k_group = blockIdx.x / n_blocks;
  const int hw = h * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  NDTG_LAP_BEGIN();

  // The group's key (its moving node; n_mov for a moving index outside
  // the bank), its run and its pairs.
  auto key_of = [&](int j) {
    const long long m = __ldg(mov_i + j);
    return (m >= 0 && m < n_mov) ? (int)m : n_mov;
  };
  int key, n_in;
  {   // the search's temporaries end with this block
    for (int k = threadIdx.x; k <= n_mov; k += kThreads) count[k] = 0;
    if (threadIdx.x == 0) found[0] = -1;
    __syncthreads();
    // The first kKeyTiles tiles' keys stay in registers for the ordered
    // pass below.
    int held[kKeyTiles];
#pragma unroll
    for (int u = 0; u < kKeyTiles; ++u) {
      const int j = u * kThreads + threadIdx.x;
      held[u] = j < n_pairs ? key_of(j) : -1;
      if (held[u] >= 0) atomicAdd(&count[held[u]], 1);
    }
    for (int j = kKeyTiles * kThreads + threadIdx.x; j < n_pairs;
         j += kThreads) {
      atomicAdd(&count[key_of(j)], 1);
    }
    __syncthreads();
    // Groups a key, then their prefix over the keys: each thread takes
    // a run of consecutive keys.
    const int per = (n_mov + 1 + kThreads - 1) / kThreads;
    const int k0 = threadIdx.x * per;
    int mine = 0;
    for (int k = k0; k < k0 + per && k <= n_mov; ++k) {
      mine += (count[k] + group - 1) / group;
    }
    int total;
    int start = block_scan(mine, scan_tmp, &total);
    for (int k = k0; k < k0 + per && k <= n_mov; ++k) {
      const int g = (count[k] + group - 1) / group;
      if (k_group >= start && k_group < start + g) {
        found[0] = k;
        found[1] = k_group - start;
      }
      start += g;
    }
    __syncthreads();
    key = found[0];
    if (key >= 0) {
      const int first = found[1] * group;
      n_in = min(group, count[key] - first);
      // The key's pairs first .. first + n_in - 1, counted in index
      // order, a tile of kThreads pairs at a time.
      for (int base = 0, u = 0; u * kThreads < n_pairs && base < first + n_in;
           ++u) {
        const int j = u * kThreads + threadIdx.x;
        int kj = held[kKeyTiles - 1];
#pragma unroll
        for (int t = 0; t < kKeyTiles - 1; ++t) kj = u == t ? held[t] : kj;
        if (u >= kKeyTiles) kj = j < n_pairs ? key_of(j) : -1;
        const bool hit = kj == key;
        const int pos = base + block_scan(hit ? 1 : 0, scan_tmp, &total);
        if (hit && pos >= first && pos < first + n_in) {
          members[pos - first] = j;
        }
        base += total;
      }
    } else {
      n_in = 0;
    }
  }
  NDTG_LAP(5, "group: finding the group");
  // This thread's vectors of the moving map, once for the group, in
  // flight while the members' parameters load.
  const int n_vec = (hw + kVec - 1) / kVec;
  const int stride = n_blocks * kThreads;
  const int v0 = rank * kThreads + threadIdx.x;
  float4 q[kGroupMaxVec];
  if (n_in > 0 && key < n_mov) {
    const float* mov = mov_occ + (long long)key * hw;
    const bool aligned = (reinterpret_cast<uintptr_t>(mov) & 15) == 0;
#pragma unroll
    for (int j = 0; j < kGroupMaxVec; ++j) {
      const int v = v0 + j * stride;
      q[j] = v < n_vec ? load_vec(mov, v * kVec, hw, aligned)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroupMaxVec; ++j) {
      q[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  // Each member's indices, origins and pose, once a block.
  __syncthreads();
  NDTG_LAP(6, "group: vector loads issued");
  if (threadIdx.x < n_in) {
    const int k = members[threadIdx.x];
    const long long ri = ref_i ? __ldg(ref_i + k) : 0;
    PairParams q;
    q.ok = key < n_mov && ri >= 0 && ri < n_ref;
    q.ref_off = q.ok ? ri * hw : 0;
    q.ox = key < n_mov ? __ldg(mov_origins + 2 * key) : 0.0f;
    q.oy = key < n_mov ? __ldg(mov_origins + 2 * key + 1) : 0.0f;
    q.rx = q.ok ? __ldg(ref_origins + 2 * ri) : 0.0f;
    q.ry = q.ok ? __ldg(ref_origins + 2 * ri + 1) : 0.0f;
    const float th = __ldg(T + 3 * k + 2);
    q.c = cosf(th);
    q.s = sinf(th);
    q.t0 = __ldg(T + 3 * k);
    q.t1 = __ldg(T + 3 * k + 1);
    pp[threadIdx.x] = q;
  }
  NDTG_LAP(7, "group: members' parameters");
  // The vectors into this thread's slots of shared memory (only it reads
  // them), with a bit for each one the moving map knows a cell of: the
  // group's pairs then hold no vector in registers.
  unsigned known = 0;
#pragma unroll
  for (int j = 0; j < kGroupMaxVec; ++j) {
    vectors[j][threadIdx.x] = q[j];
    if (fabsf(q[j].x) > kHas || fabsf(q[j].y) > kHas ||
        fabsf(q[j].z) > kHas || fabsf(q[j].w) > kHas) {
      known |= 1u << j;
    }
  }
  NDTG_LAP(2, "group: moving vectors");
  __syncthreads();
  NDTG_LAP(1, "group: parameters shared");


  for (int b0 = 0; b0 < n_in; b0 += kGroupBatch) {
    Pair ps[kGroupBatch];
    bool use[kGroupBatch];
#pragma unroll
    for (int b = 0; b < kGroupBatch; ++b) {
      const PairParams& g = pp[min(b0 + b, n_in - 1)];
      use[b] = b0 + b < n_in && g.ok;
      ps[b].mov = nullptr;
      ps[b].ref = ref_occ + g.ref_off;
      ps[b].ox = g.ox;
      ps[b].oy = g.oy;
      ps[b].rx = g.rx;
      ps[b].ry = g.ry;
      ps[b].c = g.c;
      ps[b].s = g.s;
      ps[b].t0 = g.t0;
      ps[b].t1 = g.t1;
    }
    float acc[kGroupBatch][kVec] = {};
    int n[kGroupBatch] = {};
    for (unsigned left = known; left != 0; left &= left - 1) {
      const int j = __ffs(left) - 1;    // ascending, as the pair path
      vector_cells_batch(ps, use, vectors[j][threadIdx.x],
                         (v0 + j * stride) * kVec, h, w, res, inv, acc, n);
    }
#pragma unroll
    for (int b = 0; b < kGroupBatch; ++b) {
      float t = __fadd_rn(__fadd_rn(acc[b][0], acc[b][1]),
                          __fadd_rn(acc[b][2], acc[b][3]));
      int c = n[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, off));
        c += __shfl_down_sync(0xffffffffu, c, off);
      }
      if (lane == 0 && b0 + b < n_in) {
        warp_s[b0 + b][warp] = t;
        warp_n[b0 + b][warp] = c;
      }
    }
  }
  NDTG_LAP(3, "group: reference gathers and warp trees");
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < n_in) {
    const int b = threadIdx.x;
    float s = warp_s[b][0];
    int c = warp_n[b][0];
    for (int k = 1; k < kWarps; ++k) {
      s = __fadd_rn(s, warp_s[b][k]);
      c += warp_n[b][k];
    }
    *cluster.map_shared_rank(&block_s[b][rank], 0) = s;
    *cluster.map_shared_rank(&block_n[b][rank], 0) = c;
  }
  cluster.sync();
  NDTG_LAP(4, "group: block sums and cluster barrier");
  if (rank == 0 && threadIdx.x < n_in) {
    const int b = threadIdx.x;
    const int k = members[b];
    float s = block_s[b][0];
    int c = block_n[b][0];
    for (int r = 1; r < n_blocks; ++r) {
      s = __fadd_rn(s, block_s[b][r]);
      c += block_n[b][r];
    }
    if (!pp[b].ok) {
      score[k] = __int_as_float(0x7fc00000);   // NaN: no such node
      nb[k] = -1;
    } else {
      score[k] = c > 0 ? __fdiv_rn(s, (float)c) : 1.0f;
      nb[k] = c;
    }
  }
  NDTG_LAP_COUNT();
  NDTG_LAP_END(blockIdx.x);
}

template <bool kCells>
int launch(const float* ref_occ, const float* ref_origins,
           const long long* ref_i, long long n_ref, const float* mov_occ,
           const float* mov_origins, const long long* mov_i, long long n_mov,
           const float* T, long long n_pairs, int h, int w, float res,
           float inv, float* score, long long* nb, int* cells,
           cudaStream_t stream) {
  const int cluster = cluster_of((long long)h * w);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * n_pairs), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, overlap_kernel<kCells>, ref_occ, ref_origins, ref_i, n_ref,
      mov_occ, mov_origins, mov_i, n_mov, T, h, w, res, inv, score, nb,
      cells);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Vectors a thread of a pair's cluster takes at h * w cells.
long long vectors_a_thread(long long hw) {
  const long long n_vec = (hw + kVec - 1) / kVec;
  const long long threads = (long long)cluster_of(hw) * kThreads;
  return (n_vec + threads - 1) / threads;
}

}  // namespace

extern "C" {

// 1 where the group path takes a grid of h * w cells and a moving bank of
// n_mov maps: a thread's vectors fit its registers and the nodes the
// count (ops/cuda_kernels.py overlap_group_fits).
int ndtg_overlap_group_fits(long long hw, long long n_mov) {
  return vectors_a_thread(hw) <= kGroupMaxVec && n_mov >= 1 &&
         n_mov <= kGroupMaxNodes;
}

// The group path of ndtg_overlap_score (its arguments, without `cells`):
// groups of up to `group` pairs of one moving node, `n_groups` clusters
// launched (at least the groups there are: ceil(P / group) plus the
// distinct moving keys bound them).  Both index tensors are required.
int ndtg_overlap_group_score(const float* ref_occ, const float* ref_origins,
                             const long long* ref_i, long long n_ref,
                             const float* mov_occ, const float* mov_origins,
                             const long long* mov_i, long long n_mov,
                             const float* T, long long n_pairs, int h, int w,
                             float res, float inv, int group,
                             long long n_groups, float* score, long long* nb,
                             void* stream) {
  const long long hw = (long long)h * w;
  const int cluster = cluster_of(hw);
  if (n_pairs < 1 || n_pairs > 2147483647LL || h < 1 || w < 1 ||
      hw > 2147483647LL || group < 1 || group > kGroupMax ||
      n_groups < 1 || n_groups * cluster > 2147483647LL ||
      ref_i == nullptr || mov_i == nullptr ||
      !ndtg_overlap_group_fits(hw, n_mov)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * n_groups), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(n_mov + 1) * sizeof(int);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, overlap_group_kernel, ref_occ, ref_origins, ref_i, n_ref, mov_occ,
      mov_origins, mov_i, static_cast<int>(n_mov), T,
      static_cast<int>(n_pairs), h, w, res, inv, group, score, nb);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Blocks of one pair's cluster at h * w cells; threads of a block.
int ndtg_overlap_cluster(long long hw) { return cluster_of(hw); }
int ndtg_overlap_threads() { return kThreads; }

// score (P,), nb (P,): each pair's overlap score and count.  Pair k
// reads node ref_i[k] of the reference bank (n_ref maps of h * w
// log-odds, origins (n_ref, 2)) and node mov_i[k] of the moving bank;
// a null index tensor reads node 0 for every pair.  T (P, 3).  `inv`:
// the float32 reciprocal of `res`.  A pair whose index is out of its
// bank gets score NaN and nb -1.  cells: null, or (P, h * w) int32 that
// receives every moving cell's flat reference index (-1 out of bounds).
// Returns the launch error (0 = success).
int ndtg_overlap_score(const float* ref_occ, const float* ref_origins,
                       const long long* ref_i, long long n_ref,
                       const float* mov_occ, const float* mov_origins,
                       const long long* mov_i, long long n_mov,
                       const float* T, long long n_pairs, int h, int w,
                       float res, float inv, float* score, long long* nb,
                       int* cells, void* stream) {
  const long long hw = (long long)h * w;
  if (n_pairs < 1 || h < 1 || w < 1 || hw > 2147483647LL ||
      n_pairs * cluster_of(hw) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cells != nullptr
             ? launch<true>(ref_occ, ref_origins, ref_i, n_ref, mov_occ,
                            mov_origins, mov_i, n_mov, T, n_pairs, h, w, res,
                            inv, score, nb, cells, s)
             : launch<false>(ref_occ, ref_origins, ref_i, n_ref, mov_occ,
                             mov_origins, mov_i, n_mov, T, n_pairs, h, w,
                             res, inv, score, nb, cells, s);
}

}  // extern "C"
