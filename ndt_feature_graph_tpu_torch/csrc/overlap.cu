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
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32): the distinct
// bytes are the bank's maps (160 KB a node at 200 x 200), 3.2 MB for
// the 20-node bank of the offline graph's 171 pairs (~1 us); the
// operations are ~20 a known moving cell and ~73 a cell both maps know
// (two expf and two divisions), ~14 Mop there.  chip_smoke.py prints
// both for each run's own inputs.  In practice each pair reads its
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

namespace cg = cooperative_groups;

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
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int v = v0 + j * stride;
        if (v < n_vec) {
          vector_cells<kCells>(p, q[j], v * kVec, hw, h, w, res, inv, acc,
                               n, out);
        }
      }
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
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

}  // namespace

extern "C" {

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
