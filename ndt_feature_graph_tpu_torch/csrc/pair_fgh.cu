// Hopper (sm_90a) kernels for the SE(2) D2D score / gradient / Hessian
// of NDT registration: one launch evaluates a whole Newton trial's
// objective, or runs a whole registration (newton_solve_kernel).
//
// Replaces: ndt_feature_graph_tpu/ops/pallas_kernels.py:pair_fgh_reduce
// (body _kernel, pair algebra _fgh_components), and around it what the
// JAX package leaves to XLA per trial: the window gather + masking of
// d2d_analytic.fgh_dense_flat (ops/d2d.py:gather_windows_flat), the
// pair inputs of d2d_analytic.fgh_paired, the odometry term
// d2d_analytic.fgh_mahalanobis and the sum of the three terms
// (fusion/fuser.py:fgh_fn); the solve kernel also the damped-Newton
// loop around them (ops/d2d.py:newton_match, the chunks of a lax.scan
// under lax.cond that the reference runs inside one XLA program).
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32).  The main
// path's trial is N = 256 source cells x K = 25 window cells = 6,400
// window pairs + 64 feature pairs: at most 205 KB of 32-byte table rows
// (served from L2: the whole 1.28 MB table fits in the 50 MB L2) and
// ~1.3 MFLOP, i.e. 0.06 us of bytes and 0.02 us of operations.  The
// batched entry at the offline shapes (174 lanes x 192 x 25 = 835,200
// pairs) is at most 26.7 MB of rows and ~0.17 GFLOP: 8 us of bytes.
// So a single trial is bound by launch latency and by the length of
// its dependent chain, not by the card's rates; only the batch entry
// comes near a roofline (bytes).  The measured times and the bounds of
// each run's own inputs are printed by chip_smoke.py.
//
// What the design does about it:
//   * One launch per trial.  A thread-block cluster (up to 8 blocks)
//     serves one lane; the blocks' partial sums are added by block rank
//     0 through distributed shared memory in rank order, so there is no
//     second launch, no scratch in device memory and no float atomic:
//     two calls give identical bits.
//   * The main path's feature pairs and its odometry term ride in the
//     same launch: the paired front end forms its inputs (move the
//     source feature, difference to the target feature) in registers,
//     and the finishing block adds window + paired + odometry sums in
//     that order and writes f, g (3) and the full H (3x3), 13 floats,
//     so the caller slices views and launches nothing more.
//   * A short dependent chain.  The trial pose (five trigonometric
//     calls) is computed once per block into shared memory while the
//     warps already load their source cells.  A warp takes a group of
//     source cells (every n_warps-th one, so the list's valid head is
//     spread over all warps), lane j owning the j-th: it moves the
//     gaussian and finds the window's base cell once per cell.  The
//     group's (cell, window cell) pairs are laid flat over the lanes,
//     32 per step, each lane fetching its pair's cell from the owner by
//     shuffle, so every lane works whatever K = (2n+1)^2 is (K = 25
//     would leave 7 of 32 lanes idle with one warp per cell) and the
//     table reads of a step do not wait on one another.  A window row
//     is 2n+1 consecutive 32-byte table rows, read as two float4 per
//     lane.  Threads keep their sums in registers over all their pairs
//     and reduce once: warp shuffles, a fixed-order sum over the
//     block's warps in shared memory, then the cluster.
//   * The batched entries are the same kernel with blockIdx.y the lane:
//     each lane has its own increment, pose, source list, origin and
//     64-bit row offset into one flat bank, and its own feature lists
//     and odometry information: a fleet step's whole Newton trial, all
//     streams, is one launch.  The lanes' clusters share nothing, so a
//     lane's sums are those of the same lane launched alone.
//   * A whole registration in one launch (newton_solve_kernel).  Per
//     trial the device work is a short dependent chain of a few
//     microseconds; what bounded a registration was the host around it
//     (~85 eager operations of the LM step and a read of the stop flag
//     every 6 trials).  So a cluster per lane stays resident over its
//     trials: the blocks evaluate a trial with objective_partials, the
//     per-trial kernel's own body (the same instructions at the same
//     cluster size, so the same bits); rank 0 sums the cluster into
//     shared memory and one of its threads runs the LM step (the PSD
//     shift by the closed-form smallest eigenvalue, the damped 3x3
//     solve by pivoted LU, Armijo, λ, the best score, the stop test),
//     rounding as d2d.newton_match_batch's eager operations round on
//     the card, so a solve gives the per-trial path's bits;
//     every block reads the next increment and the go flag from rank
//     0's shared memory after a cluster sync, so all leave together.
//     A lane leaves at its own stop, which the lockstep's masks make
//     exact.  The source cells and the feature pairs are read once into
//     shared memory; the table rows stay __ldg reads served from L2.
//   * A row mode for the reference's bfloat16 gather table: each row
//     read has its two mean channels made relative to its cell's world
//     centre (origin + (cell index + 0.5) * resolution), all channels
//     rounded to bfloat16 (to nearest even) and the centre added back in
//     f32.  The centre depends on the absolute cell index alone, so the
//     kernel rounds the f32 table's rows as it reads them and no second
//     table is kept.
//   * The solve serves the other registrations too: link refinement
//     (the window term alone over a bank of nodes) writes, on request,
//     the Hessian of the evaluation made at the increment it returns
//     (the best one's where the best-score fallback returns that), so a
//     link's covariance needs no second launch; P2D asks for the guarded
//     PSD projection (d2d._psd_project(guard=True)): the smallest
//     eigenvalue in double, a shift of PSD_ROUNDING of the largest
//     shifted diagonal entry, rounded to f32.
//   * No tensor cores: per pair the work is scalar algebra on 2x2 and
//     3x3 matrices, with no matrix product to feed wgmma.
//   * The table rows stay __ldg reads, the design measured faster.  A
//     ring of window boxes copied into shared memory by the Tensor
//     Memory Accelerator (a 3-D tensor map over the bank, one box of
//     (2n+1) x (2n+1) cells a source cell, mbarrier completion, later
//     cells' boxes in flight while earlier ones are read) gave the
//     same bits but was slower at every shape timed on the H100
//     (PERF.md §6): an 800-byte box a cell waits out a copy's round
//     trip, where a step's __ldg reads issue together and hit L2.
//   * Link refinement runs link_solve_kernel: the same solve with a
//     lane's cluster sized by its shape alone, persistent clusters
//     taking lanes from a device counter, one cluster barrier a trial
//     (its comment below says why).
//   * row_sum_kernel: the link paths' overlap sum in one fixed order a
//     row, so a pair scored alone keeps the bits of its row in a batch.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC (no --use_fast_math: expf, the divisions and
// the trigonometry stay IEEE f32) and bound through the plain C
// interface at the bottom.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "stage_probe.cuh"

namespace cg = cooperative_groups;

#ifdef NDTG_STAGE_PROBE
// Copies the lap sums of the NDTG_LAP marks below to host memory and
// clears them (examples/probe_link_stages.py).
extern "C" int ndtg_solve_probe_read(long long* clock, long long* ns) {
  return ndtg::probe_read(clock, ns);
}
#endif

namespace {

constexpr int kComps = 10;     // s, g0..g2, h00 h01 h02 h11 h12 h22
constexpr int kOut = 13;       // f, g (3), H (3x3 row-major)
constexpr int kMaxCluster = 8;   // the portable cluster size
// The largest cluster of a link lane (link_solve_kernel); above 8 it is
// non-portable (examples/tune_torch_port_kernels.py --links builds 16).
#ifndef NDTG_LINK_MAX_CLUSTER
#define NDTG_LINK_MAX_CLUSTER 8
#endif
constexpr int kLinkMaxCluster = NDTG_LINK_MAX_CLUSTER;
// Blocks of the link solve an SM holds (a register cap; the objective
// kernel's is three; examples/tune_torch_port_kernels.py --links builds
// three and four).
#ifndef NDTG_LINK_MIN_BLOCKS
#define NDTG_LINK_MIN_BLOCKS 4
#endif
constexpr int kLinkMinBlocks = NDTG_LINK_MIN_BLOCKS;
// Threads per block of the objective kernel.  256 is the fastest of
// 256, 512 and 1024 on the H100 for the batched lanes and as fast as
// 512 for one lane of 256 source cells
// (examples/tune_torch_port_kernels.py builds the others with -D).
#ifndef NDTG_OBJECTIVE_THREADS
#define NDTG_OBJECTIVE_THREADS 256
#endif
constexpr int kObjectiveThreads = NDTG_OBJECTIVE_THREADS;
constexpr int kPairThreads = 256;

// Adds one pair's (s, g0..g2, h00, h01, h02, h11, h12, h22) to acc;
// mirrors pallas_kernels._fgh_components term by term.
__device__ __forceinline__ void pair_components(
    float mu_x, float mu_y, float s00, float s01, float s11,
    float mx, float my, float c00, float c01, float c11,
    float lfd1, float lfd2, float* acc) {
  const float det = fmaxf(s00 * s11 - s01 * s01, 1e-12f);
  const float inv = 1.0f / det;
  const float a00 = s11 * inv;
  const float a01 = -s01 * inv;
  const float a11 = s00 * inv;

  const float amu_x = a00 * mu_x + a01 * mu_y;
  const float amu_y = a01 * mu_x + a11 * mu_y;
  const float q = mu_x * amu_x + mu_y * amu_y;

  // mu_t = G m_rot = (-my, mx); mu_tt = -m_rot
  const float mt_x = -my;
  const float mt_y = mx;

  // S = G K + K G^T (K = Crot); S2d = -2K + 2 G K G^T
  const float S00 = -2.0f * c01;
  const float S01 = c00 - c11;
  const float S11 = 2.0f * c01;
  const float S2d00 = -2.0f * c00 + 2.0f * c11;
  const float S2d01 = -4.0f * c01;
  const float S2d11 = 2.0f * c00 - 2.0f * c11;

  // A S (A mu)
  const float sa_x = S00 * amu_x + S01 * amu_y;
  const float sa_y = S01 * amu_x + S11 * amu_y;
  const float asa_x = a00 * sa_x + a01 * sa_y;
  const float asa_y = a01 * sa_x + a11 * sa_y;

  const float q_x = 2.0f * amu_x;
  const float q_y = 2.0f * amu_y;
  const float q_t =
      2.0f * (amu_x * mt_x + amu_y * mt_y) - (mu_x * asa_x + mu_y * asa_y);

  const float amt_x = a00 * mt_x + a01 * mt_y;
  const float amt_y = a01 * mt_x + a11 * mt_y;

  const float h_xx = 2.0f * a00;
  const float h_xy = 2.0f * a01;
  const float h_yy = 2.0f * a11;
  const float h_xt = 2.0f * amt_x - 2.0f * asa_x;
  const float h_yt = 2.0f * amt_y - 2.0f * asa_y;

  const float t1 = 2.0f * (mt_x * amt_x + mt_y * amt_y);
  const float t2 = 2.0f * (amu_x * (-mx) + amu_y * (-my));
  const float t3 = -4.0f * (asa_x * mt_x + asa_y * mt_y);
  // A_tt mu = 2 A S (A S A mu) - A S2d (A mu)
  const float sasa_x = S00 * asa_x + S01 * asa_y;
  const float sasa_y = S01 * asa_x + S11 * asa_y;
  const float asasa_x = a00 * sasa_x + a01 * sasa_y;
  const float asasa_y = a01 * sasa_x + a11 * sasa_y;
  const float s2a_x = S2d00 * amu_x + S2d01 * amu_y;
  const float s2a_y = S2d01 * amu_x + S2d11 * amu_y;
  const float as2a_x = a00 * s2a_x + a01 * s2a_y;
  const float as2a_y = a01 * s2a_x + a11 * s2a_y;
  const float t4 =
      mu_x * (2.0f * asasa_x - as2a_x) + mu_y * (2.0f * asasa_y - as2a_y);
  const float h_tt = t1 + t2 + t3 + t4;

  const float alpha = 0.5f * lfd2;
  const float E = expf(-alpha * q);
  const float k = lfd1 * alpha * E;
  acc[0] += -lfd1 * E;
  acc[1] += k * q_x;
  acc[2] += k * q_y;
  acc[3] += k * q_t;
  acc[4] += k * (h_xx - alpha * q_x * q_x);
  acc[5] += k * (h_xy - alpha * q_x * q_y);
  acc[6] += k * (h_xt - alpha * q_x * q_t);
  acc[7] += k * (h_yy - alpha * q_y * q_y);
  acc[8] += k * (h_yt - alpha * q_y * q_t);
  acc[9] += k * (h_tt - alpha * q_t * q_t);
}

// T = Trans(d_xy) Rot(d_t) o T0 (d2d._apply_increment) as (tx, ty, cos,
// sin).  Every block of a lane runs this same instruction sequence on
// the same d and T0, so all its blocks hold the same pose.
__device__ __forceinline__ void trial_pose(const float* __restrict__ d,
                                           const float* __restrict__ T0,
                                           float* pose) {
  const float cd = cosf(d[2]), sd = sinf(d[2]);
  pose[0] = d[0] + T0[0] * cd - T0[1] * sd;
  pose[1] = d[1] + T0[0] * sd + T0[1] * cd;
  const float traw = d[2] + T0[2];
  const float tt = atan2f(sinf(traw), cosf(traw));
  pose[2] = cosf(tt);
  pose[3] = sinf(tt);
}

// x rounded to bfloat16 (to nearest even) and back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A mean channel as the bfloat16 row mode holds it: relative to the
// cell centre origin + (cell + 0.5) * res, rounded, centre added back.
// The explicit roundings keep the compiler from contracting the centre
// into a fused multiply-add, so it equals the plain version's bit for
// bit.
__device__ __forceinline__ float bf16_mean(float mean, float origin, int cell,
                                           float res) {
  const float centre =
      __fadd_rn(origin, __fmul_rn(__fadd_rn((float)cell, 0.5f), res));
  return __fadd_rn(bf16_round(__fsub_rn(mean, centre)), centre);
}

// Moved gaussian: mean' = R m + t, K = R C R^T.
__device__ __forceinline__ void move_gaussian(
    const float* pose, float m0, float m1, float C00, float C01, float C10,
    float C11, float& mx, float& my, float& k00, float& k01, float& k11) {
  const float tx = pose[0], ty = pose[1], c = pose[2], s = pose[3];
  mx = c * m0 - s * m1 + tx;
  my = s * m0 + c * m1 + ty;
  const float rc00 = c * C00 - s * C10, rc01 = c * C01 - s * C11;
  const float rc10 = s * C00 + c * C10, rc11 = s * C01 + c * C11;
  k00 = rc00 * c - rc01 * s;
  k01 = rc00 * s + rc01 * c;
  k11 = rc10 * s + rc11 * c;
}

// Sum each of NC components over the block in a fixed order into
// part[0..NC) (shared memory).  Every thread of the block must call it.
template <int THREADS, int NC>
__device__ __forceinline__ void block_sum(const float* v,
                                          float (*warp_sums)[2 * kComps],
                                          float* part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float x = v[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) warp_sums[warp][c] = x;
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    float acc = 0.0f;
#pragma unroll
    for (int wi = 0; wi < THREADS / 32; ++wi) acc += warp_sums[wi][threadIdx.x];
    part[threadIdx.x] = acc;
  }
}

// Component of the 10 sums behind output o of (f, g0..g2, H row-major).
// The Hessian's upper triangle sits at 4..9: (0,0) (0,1) (0,2) (1,1)
// (1,2) (2,2).
__device__ __forceinline__ int comp_of_output(int o) {
  if (o < 4) return o;
  const int i = (o - 4) / 3, j = (o - 4) % 3;
  const int lo = min(i, j), hi = max(i, j);
  return 4 + 2 * lo - (lo >> 1) + hi;
}

// Output o of the odometry term (d^T Q d, (Q + Q^T) d, Q + Q^T).
__device__ __forceinline__ float odometry_output(int o,
                                                 const float* __restrict__ d,
                                                 const float* __restrict__ Q) {
  if (o == 0) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      acc += (d[0] * Q[j] + d[1] * Q[3 + j] + d[2] * Q[6 + j]) * d[j];
    }
    return acc;
  }
  if (o < 4) {
    const int i = o - 1;
    return (Q[3 * i] + Q[i]) * d[0] + (Q[3 * i + 1] + Q[3 + i]) * d[1] +
           (Q[3 * i + 2] + Q[6 + i]) * d[2];
  }
  const int i = (o - 4) / 3, j = (o - 4) % 3;
  return Q[3 * i + j] + Q[3 * j + i];
}

// Sum over the cluster's blocks, in rank order, of component c of each
// block's shared `part`: the reads are issued together, then added.
template <int MAXC = kMaxCluster>
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* part, int c,
                                             unsigned n_blocks) {
  float x[MAXC];
#pragma unroll
  for (unsigned r = 0; r < MAXC; ++r) {
    x[r] = r < n_blocks ? cluster.map_shared_rank(part, r)[c] : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (unsigned r = 0; r < MAXC; ++r) {
    if (r < n_blocks) acc += x[r];
  }
  return acc;
}

// Output o (of the 13) of the cluster's sum: the blocks' window partials
// part[0..10) added in rank order, then (paired) the paired partials
// part[10..20) of the first `paired_blocks` ranks, then (Q != nullptr)
// the odometry term.  Called by threads o < kOut of a block (rank 0, or
// every block of a link cluster) after a cluster.sync() that follows
// every block's partials.
template <int MAXC = kMaxCluster>
__device__ __forceinline__ float cluster_output(cg::cluster_group& cluster,
                                                float* part, int o,
                                                bool paired,
                                                unsigned paired_blocks,
                                                const float* d,
                                                const float* __restrict__ Q) {
  const int c = comp_of_output(o);
  float acc = cluster_sum<MAXC>(cluster, part, c, cluster.num_blocks());
  if (paired) {
    acc += cluster_sum<MAXC>(cluster, part, kComps + c, paired_blocks);
  }
  if (Q != nullptr) acc += odometry_output(o, d, Q);
  return acc;
}

// The finishing step of a cluster: rank 0 writes the 13 outputs of
// cluster_output.  Every thread of every block of the cluster must call
// it; `part` is each block's own shared array, written by threads of the
// calling block before the call.
__device__ __forceinline__ void cluster_finish(float* part, bool paired,
                                               unsigned paired_blocks,
                                               const float* __restrict__ d,
                                               const float* __restrict__ Q,
                                               float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every block's partials are written
  if (cluster.block_rank() == 0 && threadIdx.x < kOut) {
    out[threadIdx.x] = cluster_output(cluster, part, threadIdx.x, paired,
                                      paired_blocks, d, Q);
  }
  cluster.sync();                      // peers stay until rank 0 has read
}

struct ObjectiveArgs {
  // Every term is per lane (lane = blockIdx.y, B lanes).
  // Increment and initial pose (B, 3).  The solve kernel starts from d.
  const float* d;
  const float* T0;
  // Window term; packed == nullptr switches it off.  Source cells
  // (B, n_src, ...), flat packed bank, origins (B, 2), row offsets (B,)
  // or nullptr for offset 0.
  const float* means;
  const float* covs;
  const uint8_t* mask;
  const float* packed;
  const float* origins;
  const long long* row_offsets;
  int n_src, h, w, nb;
  float res;
  // Paired feature term, lists (B, n_feat, ...); fs_means == nullptr: off.
  const float* fs_means;
  const float* fs_covs;
  const uint8_t* fs_mask;
  const float* ft_means;
  const float* ft_covs;
  const uint8_t* ft_mask;
  int n_feat;
  // Odometry term, (B, 3, 3); nullptr: off.
  const float* Q;
  float lfd1, lfd2;
  float* out;   // (B, 13); the solve kernel writes SolveArgs' outputs
};

// A source cell as its owner lane holds it: raw, then moved.
struct SourceCell {
  float m0, m1, c00, c01, c10, c11;
  bool ok;
};

__device__ __forceinline__ SourceCell load_cell(
    const float* __restrict__ means, const float* __restrict__ covs,
    const uint8_t* __restrict__ mask, int i, bool mine) {
  SourceCell s;
  s.ok = mine && mask[i];
  if (s.ok) {
    const float2 m = *reinterpret_cast<const float2*>(means + 2 * i);
    const float4 c = *reinterpret_cast<const float4*>(covs + 4 * i);
    s.m0 = m.x; s.m1 = m.y;
    s.c00 = c.x; s.c01 = c.y; s.c10 = c.z; s.c11 = c.w;
  } else {
    s.m0 = s.m1 = s.c00 = s.c01 = s.c10 = s.c11 = 0.0f;
  }
  return s;
}

// The source cells of a block, kept in shared memory over a whole solve:
// slot t * kWarps + (local warp) holds cell (global warp) + t * n_warps
// of the lane as two float4 (m0 m1 c00 c01) (c10 c11 ok 0), ok = 0 past
// the list or masked.  slots_per_block(...) slots a block.
__host__ __device__ __forceinline__ int slots_per_block(int n_src,
                                                        int n_warps,
                                                        int warps) {
  return warps * ((n_src + n_warps - 1) / n_warps);
}

template <int THREADS>
__device__ __forceinline__ void fill_slots(const float* __restrict__ means,
                                           const float* __restrict__ covs,
                                           const uint8_t* __restrict__ mask,
                                           int n_src, int rank, int n_warps,
                                           float4* slots) {
  constexpr int kWarps = THREADS / 32;
  const int n_slots = slots_per_block(n_src, n_warps, kWarps);
  for (int s = threadIdx.x; s < n_slots; s += THREADS) {
    const int i = rank * kWarps + s % kWarps + (s / kWarps) * n_warps;
    const SourceCell c = load_cell(means, covs, mask, i, i < n_src);
    slots[2 * s] = make_float4(c.m0, c.m1, c.c00, c.c01);
    slots[2 * s + 1] = make_float4(c.c10, c.c11, c.ok ? 1.0f : 0.0f, 0.0f);
  }
}

// Slot s as load_cell gives the cell; only a lane that owns a cell
// (`mine`) reads, so no read passes the block's slots.
__device__ __forceinline__ SourceCell slot_cell(const float4* slots, int s,
                                                bool mine) {
  SourceCell c;
  const float4 a = mine ? slots[2 * s] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 b =
      mine ? slots[2 * s + 1] : make_float4(0.f, 0.f, 0.f, 0.f);
  c.ok = b.z > 0.5f;
  c.m0 = a.x; c.m1 = a.y; c.c00 = a.z; c.c01 = a.w;
  c.c10 = b.x; c.c11 = b.y;
  return c;
}

// A feature pair as its thread holds it: the source feature (mean,
// covariance), the target feature (mean, the covariance's (0,0) (0,1)
// (1,1)) and whether both are unmasked.
struct FeaturePair {
  float sm0, sm1, sc0, sc1, sc2, sc3, tm0, tm1, tc0, tc1, tc3;
  bool ok;
};

// Pair p of the flat (B * n_feat) lists; the rest is read only for an
// unmasked pair.
__device__ __forceinline__ FeaturePair load_pair(const ObjectiveArgs& a,
                                                 long long p) {
  FeaturePair q;
  q.ok = a.fs_mask[p] && a.ft_mask[p];
  if (q.ok) {
    const float* sm = a.fs_means + 2 * p;
    const float* sc = a.fs_covs + 4 * p;
    const float* tm = a.ft_means + 2 * p;
    const float* tc = a.ft_covs + 4 * p;
    q.sm0 = sm[0]; q.sm1 = sm[1];
    q.sc0 = sc[0]; q.sc1 = sc[1]; q.sc2 = sc[2]; q.sc3 = sc[3];
    q.tm0 = tm[0]; q.tm1 = tm[1];
    q.tc0 = tc[0]; q.tc1 = tc[1]; q.tc3 = tc[3];
  }
  return q;
}

// The feature pairs of a block, kept in shared memory over a whole
// solve: the thread that evaluates the k-th of its pairs (pair rank *
// THREADS + threadIdx.x + k * n_blocks * THREADS of the lane) keeps it in
// slot threadIdx.x + k * THREADS as three float4, and alone reads it.
// feature_slots_per_block(...) slots a block.
__host__ __device__ __forceinline__ int feature_slots_per_block(
    int n_feat, int n_blocks, int threads) {
  const int per_thread = (n_feat + n_blocks * threads - 1) /
                         (n_blocks * threads);
  return (n_feat < threads ? n_feat : threads) * per_thread;
}

template <int THREADS>
__device__ __forceinline__ void fill_feature_slots(const ObjectiveArgs& a,
                                                   long long b, int rank,
                                                   int n_blocks,
                                                   float4* slots) {
  int j = threadIdx.x;
  for (int i = rank * THREADS + threadIdx.x; i < a.n_feat;
       i += n_blocks * THREADS, j += THREADS) {
    const FeaturePair q = load_pair(a, b * a.n_feat + i);
    if (q.ok) {
      slots[3 * j] = make_float4(q.sm0, q.sm1, q.sc0, q.sc1);
      slots[3 * j + 1] = make_float4(q.sc2, q.sc3, q.tm0, q.tm1);
      slots[3 * j + 2] = make_float4(q.tc0, q.tc1, q.tc3, 1.0f);
    } else {
      slots[3 * j + 2] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ FeaturePair slot_pair(const float4* slots, int j) {
  FeaturePair q;
  const float4 c = slots[3 * j + 2];
  q.ok = c.w > 0.5f;
  if (q.ok) {
    const float4 x = slots[3 * j];
    const float4 y = slots[3 * j + 1];
    q.sm0 = x.x; q.sm1 = x.y; q.sc0 = x.z; q.sc1 = x.w;
    q.sc2 = y.x; q.sc3 = y.y; q.tm0 = y.z; q.tm1 = y.w;
    q.tc0 = c.x; q.tc1 = c.y; q.tc3 = c.z;
  }
  return q;
}

// Blocks of a lane's cluster that hold feature pairs: the first
// ceil(n_feat / THREADS), the same for every lane (n_feat is the lists'
// capacity).
template <int THREADS>
__device__ __forceinline__ unsigned paired_block_count(int n_feat,
                                                       int n_blocks) {
  return min(n_blocks, (n_feat + THREADS - 1) / THREADS);
}

// One block's share of lane b's objective at increment d (3 floats, in
// device or shared memory), summed into the block's shared part[]: the
// body of one Newton trial, shared by the per-trial kernel
// (objective_kernel) and the whole-solve kernel (newton_solve_kernel),
// so both evaluate a trial with the same instructions in the same order
// at the same cluster size.
//
// Window term: a warp takes `g` source cells at a time (g <= 32, as
// many as spread the list over the cluster's warps), every n_warps-th
// cell from its own index on; lane j owns the j-th of them — loads it
// (before the pose is ready), moves it and finds its window's base cell
// — and the g x K (cell, window cell) pairs are laid flat over the
// lanes, 32 per step, each lane fetching its pair's cell from the owner
// by shuffle: every lane works whatever K is.  Paired term: one thread
// per feature pair.  Then the block's fixed-order sums.  RESIDENT reads
// the source cells and the feature pairs from the block's shared slots
// (fill_slots, fill_feature_slots) instead of
// device memory.  Every thread of the block must call it.
template <int THREADS, bool BF16_ROWS, bool RESIDENT>
__device__ __forceinline__ void objective_partials(
    const ObjectiveArgs& a, long long b, const float* d, int rank,
    int n_blocks, const float4* slots, const float4* feature_slots,
    float* pose,
    float (*warp_sums)[2 * kComps], float* part) {
  constexpr int kWarps = THREADS / 32;
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool window = a.packed != nullptr;
  const bool paired = a.fs_means != nullptr;

  // The first group of source cells is loaded while thread 0 computes
  // the pose: neither depends on the other.
  const float* means = window ? a.means + b * a.n_src * 2 : nullptr;
  const float* covs = window ? a.covs + b * a.n_src * 4 : nullptr;
  const uint8_t* mask = window ? a.mask + b * a.n_src : nullptr;
  const int n_warps = n_blocks * kWarps;
  const int local_warp = threadIdx.x >> 5;
  const int warp = rank * kWarps + local_warp;
  const int g = min(32, (a.n_src + n_warps - 1) / n_warps);
  int t0 = 0;   // the warp's cells are warp + t * n_warps, t = t0 + lane
  SourceCell cell;
  cell.ok = false;
  if (window) {
    const int i = warp + lane * n_warps;
    const bool mine = lane < g && i < a.n_src;
    cell = RESIDENT ? slot_cell(slots, lane * kWarps + local_warp, mine)
                    : load_cell(means, covs, mask, i, mine);
  }
  if (threadIdx.x == 0) trial_pose(d, a.T0 + 3 * b, pose);
  __syncthreads();
  const float d0 = d[0], d1 = d[1];

  float v[2 * kComps];   // window sums, then paired sums
#pragma unroll
  for (int c = 0; c < 2 * kComps; ++c) v[c] = 0.0f;

  if (paired) {
    const long long f0 = b * a.n_feat;      // the lane's feature lists
    int j = threadIdx.x;                     // the pair's feature slot
    for (int i = rank * THREADS + threadIdx.x; i < a.n_feat;
         i += n_blocks * THREADS, j += THREADS) {
      const FeaturePair q =
          RESIDENT ? slot_pair(feature_slots, j) : load_pair(a, f0 + i);
      if (q.ok) {
        float mx, my, k00, k01, k11;
        move_gaussian(pose, q.sm0, q.sm1, q.sc0, q.sc1, q.sc2, q.sc3, mx, my,
                      k00, k01, k11);
        pair_components(mx - q.tm0, my - q.tm1, k00 + q.tc0, k01 + q.tc1,
                        k11 + q.tc3, mx - d0, my - d1, k00, k01, k11, a.lfd1,
                        a.lfd2, v + kComps);
      }
    }
  }

  if (window) {
    const float ox = a.origins[2 * b], oy = a.origins[2 * b + 1];
    const long long row0 = a.row_offsets != nullptr ? a.row_offsets[b] : 0;
    const float4* table = reinterpret_cast<const float4*>(a.packed) + 2 * row0;
    const int win = 2 * a.nb + 1;
    const int kwin = win * win;
    const int step_j = 32 / kwin, step_k = 32 % kwin;   // q += 32
    while (warp + t0 * n_warps < a.n_src) {      // warp-uniform
      // Owner lanes: the moved gaussian and the window's base cell
      // (dy-major windows, as gather_windows_flat).
      float mx, my, k00, k01, k11;
      move_gaussian(pose, cell.m0, cell.m1, cell.c00, cell.c01, cell.c10,
                    cell.c11, mx, my, k00, k01, k11);
      float rx = (mx - ox) / a.res;
      float ry = (my - oy) / a.res;
      rx = fminf(fmaxf(rx, -1.0e9f), 1.0e9f);
      ry = fminf(fmaxf(ry, -1.0e9f), 1.0e9f);
      const int bx = (int)floorf(rx) - a.nb;
      const int by = (int)floorf(ry) - a.nb;
      const int ok = cell.ok ? 1 : 0;
      // Pairs up to the group's last unmasked cell: cell lists keep
      // their valid cells first, so this trims the masked tail, and the
      // stride n_warps between a warp's cells spreads the valid ones
      // evenly over the warps.
      const int n_pairs = (32 - __clz(__ballot_sync(kFull, cell.ok))) * kwin;
      int j = lane / kwin;            // owner lane of this lane's pair
      int k = lane - j * kwin;        // its window cell
      for (int q = lane; q - lane < n_pairs; q += 32) {
        const int src_lane = min(j, 31);
        const float pmx = __shfl_sync(kFull, mx, src_lane);
        const float pmy = __shfl_sync(kFull, my, src_lane);
        const float p00 = __shfl_sync(kFull, k00, src_lane);
        const float p01 = __shfl_sync(kFull, k01, src_lane);
        const float p11 = __shfl_sync(kFull, k11, src_lane);
        const int pbx = __shfl_sync(kFull, bx, src_lane);
        const int pby = __shfl_sync(kFull, by, src_lane);
        const int pok = __shfl_sync(kFull, ok, src_lane);
        if (q < n_pairs && pok) {
          const int ix = pbx + k % win;
          const int iy = pby + k / win;
          const bool inb = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
          const int cy = min(max(iy, 0), a.h - 1);
          const int cx = min(max(ix, 0), a.w - 1);
          const float4* row = table + 2 * ((long long)cy * a.w + cx);
          float4 r0 = __ldg(row);             // mean_x mean_y c00 c01
          float4 r1 = __ldg(row + 1);         // c11 valid 0 0
          if (BF16_ROWS) {
            r0.x = bf16_mean(r0.x, ox, cx, a.res);
            r0.y = bf16_mean(r0.y, oy, cy, a.res);
            r0.z = bf16_round(r0.z);
            r0.w = bf16_round(r0.w);
            r1.x = bf16_round(r1.x);
          }
          if (inb && r1.y > 0.5f) {
            pair_components(pmx - r0.x, pmy - r0.y, p00 + r0.z, p01 + r0.w,
                            p11 + r1.x, pmx - d0, pmy - d1, p00, p01, p11,
                            a.lfd1, a.lfd2, v);
          }
        }
        j += step_j;
        k += step_k;
        if (k >= kwin) {
          k -= kwin;
          ++j;
        }
      }
      t0 += g;
      if (warp + t0 * n_warps < a.n_src) {
        const int i = warp + (t0 + lane) * n_warps;
        const bool mine = lane < g && i < a.n_src;
        cell = RESIDENT
                   ? slot_cell(slots, (t0 + lane) * kWarps + local_warp, mine)
                   : load_cell(means, covs, mask, i, mine);
      }
    }
  }

  NDTG_LAP(1, "solve: cell loop");
  if (paired && rank < (int)paired_block_count<THREADS>(a.n_feat, n_blocks)) {
    block_sum<THREADS, 2 * kComps>(v, warp_sums, part);
  } else {
    block_sum<THREADS, kComps>(v, warp_sums, part);
  }
  NDTG_LAP(2, "solve: block sum");
}

// One cluster per lane evaluates the lane's objective once
// (objective_partials from device memory, then the cluster's finish).
// BF16_ROWS reads the table in the bfloat16 row mode; it is a template
// argument so that the f32 instantiation carries none of its registers.
// At 256 threads the kernel is held to the registers of three blocks
// per SM (85 a thread): the cluster-size rule of the wrapper counts the
// blocks the card holds at once, and 174 lanes cost 13% more at two.
template <int THREADS, bool BF16_ROWS>
__global__ void __launch_bounds__(THREADS, THREADS <= 256 ? 3 : 1)
    objective_kernel(ObjectiveArgs a) {
  __shared__ float pose[4];
  __shared__ float warp_sums[THREADS / 32][2 * kComps];
  __shared__ float part[2 * kComps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const long long b = blockIdx.y;
  const float* d = a.d + 3 * b;
  objective_partials<THREADS, BF16_ROWS, false>(a, b, d, rank, n_blocks,
                                                nullptr, nullptr, pose,
                                                warp_sums, part);
  cluster_finish(part, a.fs_means != nullptr,
                 paired_block_count<THREADS>(a.n_feat, n_blocks), d,
                 a.Q != nullptr ? a.Q + 9 * b : nullptr, a.out + kOut * b);
}

// Paired term on prebuilt, flattened, broadcast inputs (the Pallas
// kernel's signature): the cluster's threads stride over the pairs.
template <int THREADS>
__global__ void __launch_bounds__(THREADS) pair_fgh_kernel(
    const float* __restrict__ mu, const float* __restrict__ sig,
    const float* __restrict__ m_rot, const float* __restrict__ crot,
    const uint8_t* __restrict__ ok, long long n_pairs, float lfd1,
    float lfd2, float* __restrict__ out) {
  __shared__ float warp_sums[THREADS / 32][2 * kComps];
  __shared__ float part[kComps];
  float v[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) v[c] = 0.0f;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
       p < n_pairs; p += (long long)gridDim.x * THREADS) {
    if (ok[p]) {
      pair_components(mu[2 * p], mu[2 * p + 1], sig[4 * p], sig[4 * p + 1],
                      sig[4 * p + 3], m_rot[2 * p], m_rot[2 * p + 1],
                      crot[4 * p], crot[4 * p + 1], crot[4 * p + 3], lfd1,
                      lfd2, v);
    }
  }
  block_sum<THREADS, kComps>(v, warp_sums, part);
  cluster_finish(part, false, 0, nullptr, nullptr, out);
}

// ---------------------------------------------------------------------
// The whole damped-Newton (Levenberg-Marquardt) minimisation of a lane
// in one launch: d2d.newton_match_batch over the objective above.

struct SolveArgs {
  int max_trials;        // the lockstep budget, 6 * ceil(2 itr_max / 6)
  float delta_score;
  int step_control;
  int psd_guard;         // project as d2d._psd_project(guard=True)
  float* d_out;          // (B, 3)
  float* score_out;      // (B,)
  int* trials_out;       // (B,)
  uint8_t* conv_out;     // (B,)
  float* h_out;          // (B, 9): H at d_out; nullptr: not written
};

// A lane's LM state, in rank 0's shared memory; thread 0 of rank 0
// alone reads and writes it.  trials < 0: the first evaluation is due.
struct LMState {
  float d[3], f, g[3], H[9], lam, best_d[3], best_f, best_H[9], delta[3];
  int itr, trials, stop, grad_vanished;
};

// The LM step rounds as the plain version's eager operations
// (ops/d2d.py) round on a CUDA tensor, operation by operation, so a
// solve gives the bits of the per-trial lockstep over the same
// objective: each operation rounded on its own (no contracted
// multiply-add) unless noted; a sum over a 3x3 or a 3-vector in the
// order of torch's CUDA reduction (sum3, sum9); a division by a Python
// scalar as a product with the scalar's reciprocal, as torch does it;
// the damped solve as torch.linalg.solve_ex's LU (lu_solve3).
// tests/test_torch_newton_solve.py mirrors it in numpy.
__device__ __forceinline__ float rn_add(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ float rn_sub(float x, float y) {
  return __fsub_rn(x, y);
}
__device__ __forceinline__ float rn_mul(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ float rn_div(float x, float y) {
  return __fdiv_rn(x, y);
}
// torch's CUDA sum of three values a, b, c (one reduction thread holds
// a and c, another b) and of nine e[0..8] (thread t < 8 holds e[t], and
// thread 0 also e[8]; the warp then adds at offsets 4, 2, 1).
__device__ __forceinline__ double rn_add(double x, double y) {
  return __dadd_rn(x, y);
}
template <typename T>
__device__ __forceinline__ T sum3(T a, T b, T c) {
  return rn_add(rn_add(a, c), b);
}
template <typename T>
__device__ __forceinline__ T sum9(const T* e) {
  const T t0 = rn_add(rn_add(e[0], e[8]), e[4]);
  const T t1 = rn_add(e[1], e[5]);
  const T t2 = rn_add(e[2], e[6]);
  const T t3 = rn_add(e[3], e[7]);
  return rn_add(rn_add(t0, t2), rn_add(t1, t3));
}

// torch.clamp: a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// d2d._min_eig_sym3: the smallest eigenvalue of a symmetric 3x3
// (row-major), trigonometric method, determinant by cofactors.
__device__ float min_eig_sym3(const float* H) {
  constexpr float kThird = 1.0f / 3.0f, kSixth = 1.0f / 6.0f;
  const float q = rn_mul(sum3(H[0], H[4], H[8]), kThird);
  const float qz = rn_mul(q, 0.0f);    // H - q * eye off the diagonal
  float B[9], sq[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    B[i] = rn_sub(H[i], (i % 4 == 0) ? q : qz);
    sq[i] = rn_mul(B[i], B[i]);
  }
  const float p2 = rn_mul(sum9(sq), kSixth);
  const float p = sqrtf(clamp_min(p2, 1e-30f));
  const float det = rn_add(
      rn_sub(rn_mul(B[0], rn_sub(rn_mul(B[4], B[8]), rn_mul(B[5], B[7]))),
             rn_mul(B[1], rn_sub(rn_mul(B[3], B[8]), rn_mul(B[5], B[6])))),
      rn_mul(B[2], rn_sub(rn_mul(B[3], B[7]), rn_mul(B[4], B[6]))));
  const float r = clamp_max(
      clamp_min(rn_div(det, rn_mul(rn_mul(rn_mul(2.0f, p), p), p)), -1.0f),
      1.0f);
  const float phi = rn_mul(acosf(r), kThird);
  const float lam_min = rn_add(
      q, rn_mul(rn_mul(2.0f, p), cosf(rn_add(phi, 2.0943951023931953f))));
  return p2 < 1e-28f ? q : lam_min;
}

// min_eig_sym3 on the float64 copy of H, as _psd_project(guard=True)
// takes it (H.to(float64)); acos, cos and sqrt in double.
__device__ double min_eig_sym3_f64(const float* Hf) {
  constexpr double kThird = 1.0 / 3.0, kSixth = 1.0 / 6.0;
  double H[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) H[i] = (double)Hf[i];
  const double q = __dmul_rn(sum3(H[0], H[4], H[8]), kThird);
  const double qz = __dmul_rn(q, 0.0);
  double B[9], sq[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    B[i] = __dsub_rn(H[i], (i % 4 == 0) ? q : qz);
    sq[i] = __dmul_rn(B[i], B[i]);
  }
  const double p2 = __dmul_rn(sum9(sq), kSixth);
  const double p = sqrt(p2 < 1e-30 ? 1e-30 : p2);
  const double det = __dadd_rn(
      __dsub_rn(
          __dmul_rn(B[0], __dsub_rn(__dmul_rn(B[4], B[8]),
                                    __dmul_rn(B[5], B[7]))),
          __dmul_rn(B[1], __dsub_rn(__dmul_rn(B[3], B[8]),
                                    __dmul_rn(B[5], B[6])))),
      __dmul_rn(B[2], __dsub_rn(__dmul_rn(B[3], B[7]),
                                __dmul_rn(B[4], B[6]))));
  double r = __ddiv_rn(det, __dmul_rn(__dmul_rn(__dmul_rn(2.0, p), p), p));
  r = r < -1.0 ? -1.0 : r;
  r = r > 1.0 ? 1.0 : r;
  const double phi = __dmul_rn(acos(r), kThird);
  const double lam_min = __dadd_rn(
      q, __dmul_rn(__dmul_rn(2.0, p), cos(__dadd_rn(phi,
                                                   2.0943951023931953))));
  return p2 < 1e-28 ? q : lam_min;
}

// The shift of _psd_project: the negative part of the smallest
// eigenvalue; with the guard taken in float64, plus PSD_ROUNDING (four
// float32 ulps) of the largest shifted diagonal entry, rounded to f32.
__device__ float psd_shift(const float* H, bool guard) {
  if (!guard) return clamp_min(-min_eig_sym3(H), 0.0f);
  const double lam = -min_eig_sym3_f64(H);
  const double shift = lam < 0.0 ? 0.0 : lam;   // a NaN passes through
  double diag = fabs((double)H[0]);
  const double d1 = fabs((double)H[4]), d2 = fabs((double)H[8]);
  // torch.amax: a NaN wins.
  diag = (d1 > diag || d1 != d1) ? d1 : diag;
  diag = (d2 > diag || d2 != d2) ? d2 : diag;
  constexpr double kPsdRounding = 4.0 / 8388608.0;   // 4 * 2^-23
  const double out =
      shift > 0.0
          ? __dadd_rn(shift, __dmul_rn(kPsdRounding, __dadd_rn(diag, shift)))
          : shift;
  return __double2float_rn(out);
}

// x = A^-1 y for a 3x3 A (row-major, overwritten), as
// torch.linalg.solve_ex rounds it on the card (cuBLAS / cuSOLVER getrf
// and getrs): LU with partial pivoting (the largest |a| of the column,
// the first on a tie), the multipliers as products with the pivot's
// reciprocal, the updates and both triangular solves, column by column,
// as fused multiply-adds, the back substitution dividing by the
// diagonal.
__device__ void lu_solve3(float* A, const float* y, float* x) {
  int perm[3] = {0, 1, 2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int piv = k;
    float best = fabsf(A[3 * k + k]);
    for (int i = k + 1; i < 3; ++i) {
      if (fabsf(A[3 * i + k]) > best) {
        best = fabsf(A[3 * i + k]);
        piv = i;
      }
    }
    if (piv != k) {
      for (int j = 0; j < 3; ++j) {
        const float t = A[3 * k + j];
        A[3 * k + j] = A[3 * piv + j];
        A[3 * piv + j] = t;
      }
      const int t = perm[k];
      perm[k] = perm[piv];
      perm[piv] = t;
    }
    const float rcp = rn_div(1.0f, A[3 * k + k]);
    for (int i = k + 1; i < 3; ++i) {
      const float l = rn_mul(A[3 * i + k], rcp);
      A[3 * i + k] = l;
      for (int j = k + 1; j < 3; ++j) {
        A[3 * i + j] = __fmaf_rn(-l, A[3 * k + j], A[3 * i + j]);
      }
    }
  }
  float z[3] = {y[perm[0]], y[perm[1]], y[perm[2]]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {          // L z = P y, unit diagonal
    for (int i = j + 1; i < 3; ++i) {
      z[i] = __fmaf_rn(-z[j], A[3 * i + j], z[i]);
    }
  }
#pragma unroll
  for (int j = 2; j >= 0; --j) {         // U x = z
    z[j] = rn_div(z[j], A[3 * j + j]);
    for (int i = 0; i < j; ++i) {
      z[i] = __fmaf_rn(-z[j], A[3 * i + j], z[i]);
    }
  }
  x[0] = z[0];
  x[1] = z[1];
  x[2] = z[2];
}

// One LM step of a lane after an evaluation `fgh` (f, g, H row-major)
// at trial_d, in the order of d2d.newton_match_batch: on the first
// evaluation the state starts there; after a trial, accept (Armijo), λ,
// the best score, the stop test and the count.  Then, unless the lane
// stops or its budget is spent, the next trial: the Hessian shifted by
// the negative part of its smallest eigenvalue (_psd_project, with its
// guard where s.psd_guard), the damped solve, trial_d = d + delta.
// Returns 1 when trial_d is to be evaluated, 0 when the lane is done.
// A lane that stops leaves the loop: in the lockstep every later update
// of a stopped lane is masked, so its result is the same.
__device__ __noinline__ int lm_step(LMState& st, const float* fgh,
                                    float* trial_d, const SolveArgs& s) {
  if (st.trials < 0) {
    for (int i = 0; i < 3; ++i) {
      st.d[i] = trial_d[i];
      st.best_d[i] = trial_d[i];
      st.g[i] = fgh[1 + i];
    }
    for (int i = 0; i < 9; ++i) {
      st.H[i] = fgh[4 + i];
      st.best_H[i] = fgh[4 + i];
    }
    st.f = fgh[0];
    st.best_f = fgh[0];
    st.lam = 1e-3f;
    st.itr = 0;
    st.trials = 0;
    st.stop = 0;
  } else {
    const float f_new = fgh[0];
    const float dg = sum3(rn_mul(st.delta[0], st.g[0]),
                          rn_mul(st.delta[1], st.g[1]),
                          rn_mul(st.delta[2], st.g[2]));
    const bool accept = f_new <= rn_add(st.f, rn_mul(1e-4f, dg));
    const float lam =
        !s.step_control ? 1e-6f
        : accept        ? clamp_min(rn_mul(st.lam, 0.33f), 1e-6f)
                        : rn_mul(st.lam, 6.0f);
    const bool score_converged =
        accept && rn_sub(st.f, f_new) <= s.delta_score;
    if (accept) {
      for (int i = 0; i < 3; ++i) {
        st.d[i] = trial_d[i];
        st.g[i] = fgh[1 + i];
      }
      for (int i = 0; i < 9; ++i) st.H[i] = fgh[4 + i];
      st.f = f_new;
    }
    st.lam = lam;
    if (st.f < st.best_f) {
      st.best_f = st.f;
      for (int i = 0; i < 3; ++i) st.best_d[i] = st.d[i];
      for (int i = 0; i < 9; ++i) st.best_H[i] = st.H[i];
    }
    st.stop = st.grad_vanished || lam > 1e7f || score_converged;
    st.itr += 1;
    st.trials += 1;
  }
  if (st.stop || st.trials >= s.max_trials) return 0;

  const float shift = psd_shift(st.H, s.psd_guard != 0);
  const float sz = rn_mul(st.lam, 0.0f);
  const float hz = rn_mul(shift, 0.0f);
  float A[9];
  for (int i = 0; i < 9; ++i) {     // (H + shift I) + lam I
    const bool diag = i % 4 == 0;
    A[i] = rn_add(rn_add(st.H[i], diag ? shift : hz), diag ? st.lam : sz);
  }
  const float gg = sum3(rn_mul(st.g[0], st.g[0]), rn_mul(st.g[1], st.g[1]),
                        rn_mul(st.g[2], st.g[2]));
  st.grad_vanished = sqrtf(gg) <= s.delta_score;
  float x[3];
  lu_solve3(A, st.g, x);
  for (int i = 0; i < 3; ++i) {
    st.delta[i] = -x[i];
    trial_d[i] = rn_add(st.d[i], st.delta[i]);
  }
  return 1;
}

// The lane's result: the best-score fallback, the trial count and the
// stop flag; with h_out, the Hessian of the evaluation made at the
// returned increment (what a second evaluation there would give).
__device__ __noinline__ void lm_finish(const LMState& st, const SolveArgs& s,
                                       long long b) {
  const bool use_best = st.f > st.best_f;
  for (int i = 0; i < 3; ++i) {
    s.d_out[3 * b + i] = use_best ? st.best_d[i] : st.d[i];
  }
  if (s.h_out != nullptr) {
    for (int i = 0; i < 9; ++i) {
      s.h_out[9 * b + i] = use_best ? st.best_H[i] : st.H[i];
    }
  }
  s.score_out[b] = use_best ? st.best_f : st.f;
  s.trials_out[b] = st.itr;
  s.conv_out[b] = st.stop ? 1 : 0;
}

// One cluster per lane runs the lane's whole minimisation: a loop of
// objective_partials (the per-trial kernel's body, on source cells held
// in shared memory over the solve) and, in block rank 0, the cluster's
// sum into shared memory and lm_step by one thread, which writes the
// next increment and the go flag.  After a cluster.sync() every block
// reads both from rank 0's shared memory; the flag is the same for all
// the cluster's blocks, so they leave the loop together, and a lane
// leaves at its own stop without waiting for another.  Two cluster
// syncs a trial, as the per-trial kernel's finish has.
template <int THREADS, bool BF16_ROWS>
__global__ void __launch_bounds__(THREADS, THREADS <= 256 ? 3 : 1)
    newton_solve_kernel(ObjectiveArgs a, SolveArgs s) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float4 solve_slots[];
  __shared__ float pose[4];
  __shared__ float warp_sums[kWarps][2 * kComps];
  __shared__ float part[2 * kComps];
  __shared__ float trial_d[3];   // the increment this trial evaluates
  __shared__ int go;             // 0: the lane is done
  __shared__ float fgh[kOut];    // rank 0: the trial's (f, g, H)
  __shared__ LMState st;         // rank 0: the lane's LM state

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const long long b = blockIdx.y;
  const bool paired = a.fs_means != nullptr;
  const unsigned paired_blocks =
      paired_block_count<THREADS>(a.n_feat, n_blocks);
  const float* Q = a.Q != nullptr ? a.Q + 9 * b : nullptr;
  // Dynamic shared memory: the source-cell slots, then the feature
  // pairs' (ndtg_solve_smem).
  const int n_cell_slots =
      a.packed != nullptr ? slots_per_block(a.n_src, n_blocks * kWarps, kWarps)
                          : 0;
  float4* feature_slots = solve_slots + 2 * n_cell_slots;
  if (a.packed != nullptr) {
    fill_slots<THREADS>(a.means + b * a.n_src * 2, a.covs + b * a.n_src * 4,
                        a.mask + b * a.n_src, a.n_src, rank,
                        n_blocks * kWarps, solve_slots);
  }
  if (paired) {
    fill_feature_slots<THREADS>(a, b, rank, n_blocks, feature_slots);
  }
  if (threadIdx.x < 3) trial_d[threadIdx.x] = a.d[3 * b + threadIdx.x];
  if (threadIdx.x == 0) st.trials = -1;
  __syncthreads();
  NDTG_LAP_BEGIN();

  for (;;) {
    NDTG_LAP_COUNT();
    objective_partials<THREADS, BF16_ROWS, true>(
        a, b, trial_d, rank, n_blocks, solve_slots, feature_slots, pose,
        warp_sums, part);
    cluster.sync();                    // every block's partials are written
    NDTG_LAP(3, "solve: first cluster sync");
    if (rank == 0) {
      if (threadIdx.x < kOut) {
        fgh[threadIdx.x] = cluster_output(cluster, part, threadIdx.x, paired,
                                          paired_blocks, trial_d, Q);
      }
      __syncthreads();
      if (threadIdx.x == 0) go = lm_step(st, fgh, trial_d, s);
    }
    NDTG_LAP(4, "solve: output and LM step");
    cluster.sync();                    // rank 0 has read and stepped
    if (rank != 0) {
      if (threadIdx.x < 3) {
        trial_d[threadIdx.x] = cluster.map_shared_rank(trial_d, 0)[threadIdx.x];
      } else if (threadIdx.x == 3) {
        go = *cluster.map_shared_rank(&go, 0);
      }
    }
    __syncthreads();
    NDTG_LAP(5, "solve: second sync and broadcast");
    if (!go) break;                    // uniform over the cluster
  }
  if (rank == 0 && threadIdx.x == 0) lm_finish(st, s, b);
  cluster.sync();                      // rank 0 stays until peers have read
  NDTG_LAP_END((long long)blockIdx.y * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------------
// Link refinement (links.refine_links_d2d, the window term over a bank of
// nodes with the Hessian at the result): the solve of newton_solve_kernel
// with its lanes scheduled over persistent clusters.
//
// The link paths launch one solve for up to a few hundred lanes whose
// trial counts differ by 50x (1 to 52 at the LC bank's 171 lanes,
// PERF.md section 6), so a launch lasts as long as its slowest lane's
// chain of trials or as the lanes' work over the clusters in flight,
// whichever is longer.  newton_solve_kernel sizes a lane's cluster by
// how many lanes share the card (2 blocks at 171 lanes, 8 at 16), which
// makes a lane's summation order, and so its bits, depend on its batch.
// This kernel instead:
//   * sizes a lane's cluster by its shape alone (the wrapper's
//     link_cluster: its source cells and feature pairs, and the card's
//     cluster limit), so a link refined alone keeps the bits of its row
//     in any batch, and those of the per-trial yardstick
//     (fgh_dense_flat_batch at the same cluster size);
//   * launches as many persistent clusters as the card holds at that
//     size (ndtg_link_max_clusters) and lets each take its next lane from
//     a device counter (an atomicAdd by rank 0, handed to its peers
//     through distributed shared memory before a cluster barrier), so a
//     cluster whose lane stops early takes another while a long lane
//     runs; which cluster takes a lane changes none of its bits.  The
//     last cluster to find the counter spent puts it back to zero, so
//     the counter needs no reset between launches on a stream;
//   * holds one cluster barrier a trial: every block reads all blocks'
//     partials (a parity-double-buffered `part`, so a block that runs
//     ahead into the next trial writes the other half) and runs
//     cluster_output and lm_step itself, the same instructions on the
//     same values in every block, so each holds the lane's LM state and
//     needs no broadcast.  lm_step and its rounding are newton_solve's.
// A trial at 8 blocks costs ~5.3-5.8 us (cell loop ~2.7-3.0, block sum
// ~0.5, the barrier ~0.9, output and LM step ~1.4-1.8; PERF.md section
// 6).  Registers are capped for four blocks an SM (64, some spilled):
// the 171-lane launch is bound by the clusters in flight, and four
// blocks an SM beat three there (examples/tune_torch_port_kernels.py).
template <int THREADS, bool BF16_ROWS, int MAXC>
__global__ void __launch_bounds__(THREADS,
                                  THREADS <= 256 ? kLinkMinBlocks : 1)
    link_solve_kernel(ObjectiveArgs a, SolveArgs s, int n_lanes,
                      int* __restrict__ queue) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float4 solve_slots[];
  __shared__ float pose[4];
  __shared__ float warp_sums[kWarps][2 * kComps];
  __shared__ float part[2][2 * kComps];   // a trial's partials, by parity
  __shared__ float trial_d[3];
  __shared__ int lane_of_cluster;         // written by rank 0
  __shared__ int go;
  __shared__ float fgh[kOut];
  __shared__ LMState st;

  // Half a cluster barrier, waited on before the first lane is taken.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const bool paired = a.fs_means != nullptr;
  const unsigned paired_blocks =
      paired_block_count<THREADS>(a.n_feat, n_blocks);
  const int n_cell_slots =
      a.packed != nullptr ? slots_per_block(a.n_src, n_blocks * kWarps, kWarps)
                          : 0;
  float4* feature_slots = solve_slots + 2 * n_cell_slots;
  NDTG_LAP_BEGIN();
  // Rank 0 writes into its peers' shared memory on its first take: the
  // wait knows every block of the cluster has started.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (;;) {
    if (rank == 0 && threadIdx.x == 0) {
      const int lane = atomicAdd(queue, 1);
      for (int r = 0; r < n_blocks; ++r) {
        *cluster.map_shared_rank(&lane_of_cluster, r) = lane;
      }
      if (lane >= n_lanes) {
        // This cluster's last take: the last of them resets the queue.
        __threadfence();
        if (atomicAdd(queue + 1, 1) == (int)gridDim.y - 1) {
          queue[0] = 0;
          queue[1] = 0;
        }
      }
    }
    cluster.sync();   // the lane is handed over; the last lane is read
    const int lane = lane_of_cluster;
    if (lane >= n_lanes) break;           // uniform over the cluster
    const long long b = lane;
    const float* Q = a.Q != nullptr ? a.Q + 9 * b : nullptr;
    if (a.packed != nullptr) {
      fill_slots<THREADS>(a.means + b * a.n_src * 2, a.covs + b * a.n_src * 4,
                          a.mask + b * a.n_src, a.n_src, rank,
                          n_blocks * kWarps, solve_slots);
    }
    if (paired) {
      fill_feature_slots<THREADS>(a, b, rank, n_blocks, feature_slots);
    }
    if (threadIdx.x < 3) trial_d[threadIdx.x] = a.d[3 * b + threadIdx.x];
    if (threadIdx.x == 0) st.trials = -1;
    __syncthreads();
    NDTG_LAP(0, "link: lane start");
    for (int t = 0;; t ^= 1) {
      NDTG_LAP_COUNT();
      objective_partials<THREADS, BF16_ROWS, true>(
          a, b, trial_d, rank, n_blocks, solve_slots, feature_slots, pose,
          warp_sums, part[t]);
      cluster.sync();                  // every block's partials are written
      NDTG_LAP(3, "link: cluster sync");
      if (threadIdx.x < kOut) {
        fgh[threadIdx.x] = cluster_output<MAXC>(
            cluster, part[t], threadIdx.x, paired, paired_blocks, trial_d, Q);
      }
      __syncthreads();
      if (threadIdx.x == 0) go = lm_step(st, fgh, trial_d, s);
      __syncthreads();
      NDTG_LAP(4, "link: output and LM step");
      if (!go) break;                  // uniform over the cluster
    }
    if (rank == 0 && threadIdx.x == 0) lm_finish(st, s, b);
  }
  NDTG_LAP_END((long long)blockIdx.y * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------------
// The link paths' overlap sum (graph/links.py _row_sum): each row of an
// (n_rows, n_cols) f32 matrix summed in one fixed order, whatever the
// number of rows, so a pair scored alone (compute_link) gets the bits
// of its row in a batch (compute_links_batch, rescore_links).  Not a
// port of a TPU kernel: the reference leaves this sum to XLA.  One block
// a row; thread t adds columns t, t + kRowSumThreads, ... in turn, then
// a fixed halving tree over the block in shared memory.  Bound by bytes
// (each element read once: 27 MB at 171 pairs of 200 x 200 cells).
constexpr int kRowSumThreads = 512;

__global__ void __launch_bounds__(kRowSumThreads)
    row_sum_kernel(const float* __restrict__ x, long long n_cols,
                   float* __restrict__ out) {
  __shared__ float part[kRowSumThreads];
  const float* row = x + (long long)blockIdx.x * n_cols;
  float acc = 0.0f;
  for (long long c = threadIdx.x; c < n_cols; c += kRowSumThreads) {
    acc += __ldg(row + c);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kRowSumThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      part[threadIdx.x] += part[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

// Launch `kernel` on a (cluster, n_lanes) grid whose x extent is one
// thread-block cluster.  Returns the launch error (0 = success).
// `smem`: dynamic shared memory bytes a block.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), int threads, int cluster,
                    int n_lanes, size_t smem, cudaStream_t stream,
                    Args... args) {
  if (cluster < 1 || cluster > kMaxCluster || n_lanes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return ndtg::launch_cluster(kernel, dim3(cluster, n_lanes, 1), threads,
                              cluster, smem, stream, args...);
}

}  // namespace

extern "C" {

int ndtg_max_cluster() { return kMaxCluster; }
int ndtg_pair_threads() { return kPairThreads; }

int ndtg_objective_threads() { return kObjectiveThreads; }

// Blocks of the objective kernel one SM holds.
int ndtg_objective_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, objective_kernel<kObjectiveThreads, false>, kObjectiveThreads, 0);
  int n_bf16 = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n_bf16, objective_kernel<kObjectiveThreads, true>, kObjectiveThreads,
      0);
  return n < n_bf16 ? n : n_bf16;
}

// The objective of n_lanes lanes, one cluster of `cluster` blocks x
// ndtg_objective_threads() threads per lane.  Null pointers switch
// terms off: packed (window), fs_means (paired), Q (odometry); a null
// row_offsets is offset 0.  Feature lists are (n_lanes, n_feat, ...), Q
// (n_lanes, 3, 3); bf16_rows != 0 reads the table in the bfloat16 row
// mode.  out: (n_lanes, 13).  Returns the launch error (0 = success).
int ndtg_objective(const float* d, const float* T0, const float* means,
                   const float* covs, const uint8_t* mask,
                   const float* packed, const float* origins,
                   const long long* row_offsets, int n_lanes, int n_src,
                   int h, int w, float res, int nb, int bf16_rows,
                   const float* fs_means,
                   const float* fs_covs, const uint8_t* fs_mask,
                   const float* ft_means, const float* ft_covs,
                   const uint8_t* ft_mask, int n_feat, const float* Q,
                   float lfd1, float lfd2, float* out, int cluster,
                   void* stream) {
  const ObjectiveArgs a = {d, T0, means, covs, mask, packed, origins,
                           row_offsets, n_src, h, w, nb, res, fs_means,
                           fs_covs, fs_mask, ft_means, ft_covs, ft_mask,
                           n_feat, Q, lfd1, lfd2, out};
  void (*kernel)(ObjectiveArgs) =
      bf16_rows != 0 ? objective_kernel<kObjectiveThreads, true>
                     : objective_kernel<kObjectiveThreads, false>;
  return launch_clusters(kernel, kObjectiveThreads, cluster, n_lanes, 0,
                         static_cast<cudaStream_t>(stream), a);
}

// Dynamic shared memory of a newton_solve block at `cluster` blocks a
// lane: its source-cell slots (two float4 each; n_src = 0 with the
// window term off), then its feature-pair slots (three float4 each;
// n_feat = 0 with the paired term off).
int ndtg_solve_smem(int n_src, int n_feat, int cluster) {
  constexpr int kWarps = kObjectiveThreads / 32;
  const int cells =
      n_src > 0 ? 32 * slots_per_block(n_src, cluster * kWarps, kWarps) : 0;
  const int pairs =
      n_feat > 0
          ? 48 * feature_slots_per_block(n_feat, cluster, kObjectiveThreads)
          : 0;
  return cells + pairs;
}

// Thread-block clusters of the solve kernel the card holds at once at
// `cluster` blocks a lane and the shared memory of ndtg_solve_smem,
// the fewer of its two row modes.  cudaOccupancyMaxActiveClusters
// counts where clusters can be placed within the GPCs, which SMs x
// blocks an SM does not.  Returns 0 if such a cluster cannot launch.
int ndtg_solve_max_clusters(int n_src, int n_feat, int cluster) {
  const int smem = ndtg_solve_smem(n_src, n_feat, cluster);
  void (*const kernels[2])(ObjectiveArgs, SolveArgs) = {
      newton_solve_kernel<kObjectiveThreads, false>,
      newton_solve_kernel<kObjectiveThreads, true>};
  int least = -1;
  for (auto kernel : kernels) {
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(kObjectiveThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    least = least < 0 || n < least ? n : least;
  }
  return least;
}

// The whole damped-Newton minimisation of n_lanes lanes from d_init
// (n_lanes, 3) over the objective of ndtg_objective (the same arguments
// and term switches), one cluster of `cluster` blocks per lane that
// loops over the lane's trials: at most max_trials after the first
// evaluation, stopping at delta_score as d2d.newton_match_batch does,
// with λ adapted when step_control != 0 and the Hessian projected with
// d2d._psd_project's guard when psd_guard != 0.  Writes d_out (n_lanes,
// 3), score_out (n_lanes,), trials_out (int32), conv_out (uint8) and,
// unless h_out is null, h_out (n_lanes, 9): the Hessian at d_out.
// Returns the launch error (0 = success).
int ndtg_newton_solve(const float* d_init, const float* T0,
                      const float* means, const float* covs,
                      const uint8_t* mask, const float* packed,
                      const float* origins, const long long* row_offsets,
                      int n_lanes, int n_src, int h, int w, float res,
                      int nb, int bf16_rows, const float* fs_means,
                      const float* fs_covs, const uint8_t* fs_mask,
                      const float* ft_means, const float* ft_covs,
                      const uint8_t* ft_mask, int n_feat, const float* Q,
                      float lfd1, float lfd2, int max_trials,
                      float delta_score, int step_control, int psd_guard,
                      float* d_out, float* score_out, int* trials_out,
                      uint8_t* conv_out, float* h_out, int cluster,
                      void* stream) {
  const ObjectiveArgs a = {d_init, T0, means, covs, mask, packed, origins,
                           row_offsets, n_src, h, w, nb, res, fs_means,
                           fs_covs, fs_mask, ft_means, ft_covs, ft_mask,
                           n_feat, Q, lfd1, lfd2, nullptr};
  const SolveArgs s = {max_trials, delta_score, step_control, psd_guard,
                       d_out, score_out, trials_out, conv_out, h_out};
  void (*kernel)(ObjectiveArgs, SolveArgs) =
      bf16_rows != 0 ? newton_solve_kernel<kObjectiveThreads, true>
                     : newton_solve_kernel<kObjectiveThreads, false>;
  if (cluster < 1 || cluster > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = ndtg_solve_smem(packed != nullptr ? n_src : 0,
                                   fs_means != nullptr ? n_feat : 0, cluster);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_clusters(kernel, kObjectiveThreads, cluster, n_lanes,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream), a, s);
}

int ndtg_link_max_cluster() { return kLinkMaxCluster; }

// The link solve's two row modes, their dynamic shared memory allowed
// up to `smem` and clusters above 8 blocks, once a process (the
// attribute is the function's, for every launch).  Returns the error.
static cudaError_t link_configure(int smem) {
  void (*const kernels[2])(ObjectiveArgs, SolveArgs, int, int*) = {
      link_solve_kernel<kObjectiveThreads, false, kLinkMaxCluster>,
      link_solve_kernel<kObjectiveThreads, true, kLinkMaxCluster>};
  for (auto kernel : kernels) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    if (kLinkMaxCluster > kMaxCluster) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// Clusters of the link solve the card holds at once at `cluster` blocks
// a lane (both row modes, the fewer); 0 if such a cluster cannot launch.
int ndtg_link_max_clusters(int n_src, int n_feat, int cluster) {
  if (cluster < 1 || cluster > kLinkMaxCluster) return 0;
  const int smem = ndtg_solve_smem(n_src, n_feat, cluster);
  if (link_configure(smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  void (*const kernels[2])(ObjectiveArgs, SolveArgs, int, int*) = {
      link_solve_kernel<kObjectiveThreads, false, kLinkMaxCluster>,
      link_solve_kernel<kObjectiveThreads, true, kLinkMaxCluster>};
  int least = -1;
  for (auto kernel : kernels) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(kObjectiveThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    least = least < 0 || n < least ? n : least;
  }
  return least;
}

// Link refinement: the minimisation of ndtg_newton_solve (the same
// arguments, terms and outputs) for n_lanes lanes on n_clusters
// persistent clusters of `cluster` blocks, each taking its next lane
// from `queue` (two ints, zero before the first launch on a stream; the
// launch leaves them zero).  Returns the launch error (0 = success).
int ndtg_link_solve(const float* d_init, const float* T0,
                    const float* means, const float* covs,
                    const uint8_t* mask, const float* packed,
                    const float* origins, const long long* row_offsets,
                    int n_lanes, int n_src, int h, int w, float res,
                    int nb, int bf16_rows, const float* fs_means,
                    const float* fs_covs, const uint8_t* fs_mask,
                    const float* ft_means, const float* ft_covs,
                    const uint8_t* ft_mask, int n_feat, const float* Q,
                    float lfd1, float lfd2, int max_trials,
                    float delta_score, int step_control, int psd_guard,
                    float* d_out, float* score_out, int* trials_out,
                    uint8_t* conv_out, float* h_out, int* queue,
                    int n_clusters, int cluster, void* stream) {
  const ObjectiveArgs a = {d_init, T0, means, covs, mask, packed, origins,
                           row_offsets, n_src, h, w, nb, res, fs_means,
                           fs_covs, fs_mask, ft_means, ft_covs, ft_mask,
                           n_feat, Q, lfd1, lfd2, nullptr};
  const SolveArgs s = {max_trials, delta_score, step_control, psd_guard,
                       d_out, score_out, trials_out, conv_out, h_out};
  if (cluster < 1 || cluster > kLinkMaxCluster || n_lanes < 1 ||
      n_clusters < 1 || n_clusters > 65535 || queue == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = ndtg_solve_smem(packed != nullptr ? n_src : 0,
                                   fs_means != nullptr ? n_feat : 0, cluster);
  const cudaError_t err = link_configure(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*kernel)(ObjectiveArgs, SolveArgs, int, int*) =
      bf16_rows != 0
          ? link_solve_kernel<kObjectiveThreads, true, kLinkMaxCluster>
          : link_solve_kernel<kObjectiveThreads, false, kLinkMaxCluster>;
  return ndtg::launch_cluster(kernel, dim3(cluster, n_clusters, 1),
                              kObjectiveThreads, cluster,
                              static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream), a, s,
                              n_lanes, queue);
}

// out: (13,).  One cluster of `cluster` blocks x ndtg_pair_threads().
int ndtg_pair_fgh_reduce(const float* mu, const float* sig,
                         const float* m_rot, const float* crot,
                         const uint8_t* ok, long long n_pairs, float lfd1,
                         float lfd2, float* out, int cluster, void* stream) {
  return launch_clusters(pair_fgh_kernel<kPairThreads>, kPairThreads,
                         cluster, 1, 0, static_cast<cudaStream_t>(stream), mu,
                         sig, m_rot, crot, ok, n_pairs, lfd1, lfd2, out);
}

// out[r] = the sum of row r of x (n_rows, n_cols), in row_sum_kernel's
// fixed order.  Returns the launch error (0 = success).
int ndtg_row_sum(const float* x, long long n_rows, long long n_cols,
                 float* out, void* stream) {
  if (n_rows < 1 || n_rows > 2147483647LL || n_cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_sum_kernel<<<static_cast<unsigned>(n_rows), kRowSumThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, n_cols, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
