// Hopper (sm_90a) kernels of the scan's feature front end (features/
// detector.py detect, features/descriptor.py describe, features/ransac.py
// match_sets and the odometry gate of fusion/feature_fuser.py, through
// ops/cuda_kernels.py detect_features, describe_features and
// match_features):
//
//   * features_detect_kernel: the multi-scale curvature detector, a
//     thread-block cluster of up to 8 blocks a scan;
//   * features_describe_kernel: the beta-grid descriptor, one block of
//     128 to 1,024 threads a (scan, feature): every thread bins the
//     feature's hits and chord samples, then 128 of them replay the
//     float adds in a fixed order;
//   * features_match_kernel: the descriptor chi2 matrix, the
//     correspondences, the two-point RANSAC hypotheses with their MSAC
//     scores, the winner's two Procrustes refinements and, where asked,
//     the odometry-consistency gate and the paired pseudo-cells of the
//     joint registration, a cluster of up to 4 blocks a pair.
//
// Replaces no TPU kernel: the reference leaves this region to XLA, fused
// inside its jitted scan step (ndt_feature_graph_tpu/features/detector.py
// detect, descriptor.py describe, ransac.py match_sets, distance.py
// symmetric_chi2_matrix, fusion/feature_fuser.py _prepare_features).  It
// takes the place of the port's ~780 eager operations a scan (the plain
// twins: detector._detect_plain, descriptor._describe_plain,
// ransac._match_sets_plain, ransac._gate_plain), among them the
// descriptor's (F, B, 8, 48) one-hot tensor.
//
// Rounding: each elementwise step rounds as the plain twin's operation on
// a CUDA tensor does, one rounding an operation (the helpers below keep
// nvcc from contracting a product and a sum into one fused multiply-add):
// a division by a Python float as a product with its reciprocal, taken in
// float64 and rounded to float32, as ATen does with a CPU scalar divisor
// on the card; x ** 2 as x * x and x ** 0.5 as
// a square root; torch.linalg.vector_norm of a pair as sqrt(x * x + y *
// y); a two-term einsum as fma(a1, b1, a0 * b0);
// expf, cosf, sinf, atan2f and log1pf of the CUDA maths library, which
// ATen calls.  The sums that steer a discrete choice of the detector (the
// cumulative arc, the windowed Gaussian sums) are taken in float64 by the
// kernel and by the plain twin alike, so their float32 results do not
// depend on the order of the adds.  The other sums run in one fixed order
// (each thread's in sequence, then fixed trees), with no float atomics:
// the same bits on every call and at every batch size.
//
// What bounds them on the H100: operations.  The detector evaluates one
// expf and four float32 products a scale for each (beam, window beam)
// pair of the same polyline piece (at most 720 x 97 x 5 = 349,200 a
// canonical scan) and three float64 fused multiply-adds; the descriptor
// ~60 operations and one atan2f for each of a feature's 720 hits and
// 5,760 chord samples; the matcher 48 x ~5 for each of its 1,024
// descriptor pairs and ~20 for each of its 256 x 64 hypothesis
// residuals.  Their bytes (ranges, masks, descriptors, draws) are a few
// KB a scan.  chip_smoke.py prints the bound of each run's inputs.  On
// one SM a scan's window sums and its O(B^2) rank count, and a pair's
// chi2 matrix and serial epilogue, were latency chains (PERF.md §6, the
// stage split of examples/probe_feature_stages.py): the detector now
// spreads a scan's beams over a cluster, one thread a (beam, scale) and
// a warp a beam's rank, exchanging the smoothed points and the best
// responses through distributed shared memory; the matcher spreads a
// pair's chi2 rows over a cluster, divides the descriptor rows with
// every thread, gives a warp to each first minimum and rank, and moves
// the gate's pseudo-cells beside the hypotheses; the descriptor bins a
// feature's 720 x 9 positions with every thread of a wide block (their
// bins do not depend on the order) and only replays the adds in order
// (~45 dependent adds a partial sum, no transcendental).  Each sum keeps
// the order it had in one block, so the bits do not depend on the
// cluster or the block size.
//
// Built with the other sources into one library (ops/cuda_kernels.py
// build): nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// fast math; bound through the plain C interface at the bottom.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "stage_probe.cuh"

namespace cg = cooperative_groups;

#ifdef NDTG_STAGE_PROBE
// Copies the stamps of the NDTG_STAGE marks below to host memory and
// clears them (examples/probe_feature_stages.py).
extern "C" int ndtg_features_probe_read(long long* clock, long long* ns) {
  return ndtg::probe_read(clock, ns);
}
#endif

namespace {

constexpr int kDetectThreads = 512;
constexpr int kScanRuns = 256;        // the arc's and counts' runs
constexpr int kMaxDetectCluster = 8;  // cuda_kernels.DETECT_MAX_CLUSTER
constexpr int kDescribeSums = 128;   // the miss sums' partials: their order
constexpr int kDescribeMaxThreads = 1024;
constexpr int kDropped = 0xff;       // a chord sample outside the support
constexpr int kMatchThreads = 512;
constexpr int kMaxMatchCluster = 4;   // cuda_kernels.MATCH_MAX_CLUSTER
constexpr int kMaxScales = 8;
constexpr int kMaxBins = 64;
// A block's dynamic shared memory at most: 227 KB less room for the
// kernels' static arrays.
constexpr int kMaxDynamicSmem = 232448 - 1024;
constexpr int kMaxDevices = 64;
constexpr float kPi = 3.14159265358979323846f;
constexpr unsigned kFull = 0xffffffffu;

// One rounding an operation, as ATen's separate elementwise kernels.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.linalg.vector_norm of a pair on the card: sqrt(x * x + y * y),
// each operation rounded (the CPU's fuses the second product).
__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(add(mul(x, x), mul(y, y)));
}
// torch.clamp / torch.minimum keep a NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
// A two-term einsum ("...ij,...pj->...pi") as cuBLAS contracts it.
__device__ __forceinline__ float dot2(float r0, float x, float r1, float y) {
  return __fmaf_rn(r1, y, __fmul_rn(r0, x));
}
// The int64 cast of a floor.
__device__ __forceinline__ long long floor_i64(float x) {
  return static_cast<long long>(floorf(x));
}
__device__ __forceinline__ float wrap_angle(float t) {
  return atan2f(sinf(t), cosf(t));
}

// An exclusive prefix sum of one value a thread over the block, and the
// block's total; `buf` holds 32 values.  Integer or float64 (whose sums
// here are exact or nearly so: their rounding does not reach float32).
template <typename T>
__device__ T block_exclusive_scan(T v, T* buf, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  T excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = T(0);
  __syncthreads();
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? buf[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    buf[lane] = w;
  }
  __syncthreads();
  const T before = warp > 0 ? buf[warp - 1] : T(0);
  *total = buf[nwarps - 1];
  __syncthreads();
  return before + excl;
}

// ------------------------------------------------------------------ detect

struct DetectArgs {
  const float* ranges;     // (N, B)
  const uint8_t* hit;      // (N, B)
  const float* cosb;       // (B,) torch.cos of the beam angles
  const float* sinb;
  int b, s, half, f, cluster;
  float sigma[kMaxScales];  // float32 of base_sigma * sigma_step ** i
  float inv_sigma[kMaxScales];  // float32 of its float64 reciprocal
  float peak_min_diff, peak_min_value;
  float* pts;               // (N, F, 2)
  float* angles;            // (N, F)
  float* scales;
  float* response;
  uint8_t* mask;
  float* arcs;              // null, or (N, B): the cumulative arc
  float* smoothed;          // null, or (N, S, B, 2): the smoothed points
};

// A beam's cumulative arc and its key: its polyline piece where it is a
// hit, else -1 (a window beam weighs in where its key is the centre's
// piece).
struct ArcKey {
  float cum;
  int key;
};

__host__ __device__ inline long long detect_smem(int b, int s) {
  return 32 * 8 + (long long)b * (16 + 8 + 4 + 4 + 12LL * s + 2);
}

// The first index k in [0, n) with arc[k].cum >= v, else n.
__device__ __forceinline__ int lower_bound(const ArcKey* arc, int n,
                                           float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(arc[mid].cum >= v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One cluster of `cluster` blocks a scan (blockIdx.x / cluster); block
// rank r owns the beams [r ceil(B / cluster), ...).  Every block loads
// the whole scan and takes the points, the arc and the pieces of all
// beams in one order (the same bits in each block); it smooths its own
// beams, one thread a (beam, scale) with the window in offset order (a
// beam's sums do not depend on the cluster size), and writes each
// smoothed point into every block's shared memory (stores, which need no
// round trip).  After a cluster barrier it takes the responses of its
// beams and of the two beams beside them, its beams' peaks and best
// scale, written to every block too; after a second barrier a warp a
// beam ranks its own beams among all B, and a thread a selected beam
// writes its feature.
//
// Shared memory, per beam: the point as two float64 (the window sums'
// operands), the arc and key, the smoothed point and the response of
// every scale, the piece id (then the zeros' prefix count), the best
// peak response, the hit bit and the best scale.
__global__ void __launch_bounds__(kDetectThreads)
features_detect_kernel(DetectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int B = a.b, S = a.s, K = a.cluster;
  double* dbuf = reinterpret_cast<double*>(smem);
  double2* pxy = reinterpret_cast<double2*>(dbuf + 32);
  ArcKey* arc = reinterpret_cast<ArcKey*>(pxy + B);
  float2* smv = reinterpret_cast<float2*>(arc + B);               // (S, B)
  float* resp = reinterpret_cast<float*>(smv + (size_t)S * B);    // (S, B)
  int* sid = reinterpret_cast<int*>(resp + (size_t)S * B);
  float* best = reinterpret_cast<float*>(sid + B);
  uint8_t* hitv = reinterpret_cast<uint8_t*>(best + B);
  uint8_t* bsc = hitv + B;
  int* ibuf = reinterpret_cast<int*>(dbuf);
  __shared__ float sig[kMaxScales], inv_sig[kMaxScales];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const size_t scan = blockIdx.x / K;
  const int per_block = (B + K - 1) / K;
  const int own_lo = min(rank * per_block, B);
  const int own_hi = min(own_lo + per_block, B), own = own_hi - own_lo;
  const float* rng = a.ranges + scan * B;
  const uint8_t* hg = a.hit + scan * B;
  NDTG_STAGE(0, "detect: start");
  // Every block of the cluster has started before any writes to
  // another's shared memory (the wait is before the first).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  if (tid < kMaxScales) {
    sig[tid] = a.sigma[tid];
    inv_sig[tid] = a.inv_sigma[tid];
  }
  float* rs = resp;        // the ranges, until the responses are taken
  for (int i = tid; i < B; i += nt) {
    const float r = rng[i];
    pxy[i] = make_double2((double)mul(r, a.cosb[i]),
                          (double)mul(r, a.sinb[i]));
    rs[i] = r;
    hitv[i] = hg[i] != 0;
  }
  __syncthreads();
  NDTG_STAGE(1, "detect: load the scan");

  // The segment lengths and the jumps, then both prefix sums: each of
  // the first kScanRuns threads a contiguous run of beams, the runs'
  // totals scanned over the block.
  const int per = (B + kScanRuns - 1) / kScanRuns;
  const int lo = tid < kScanRuns ? min(tid * per, B) : B;
  const int hi = min(lo + per, B);
  auto seg_of = [&](int i) -> float {
    if (i == 0) return 0.0f;
    return norm2(sub((float)pxy[i].x, (float)pxy[i - 1].x),
                 sub((float)pxy[i].y, (float)pxy[i - 1].y));
  };
  auto jump_of = [&](int i) -> int {
    const bool far = i > 0 && fabsf(sub(rs[i], rs[i - 1])) > 0.5f;
    return (far || !hitv[i] || !hitv[(i + B - 1) % B]) ? 1 : 0;
  };
  double dsum = 0.0;
  int jsum = 0;
  for (int i = lo; i < hi; ++i) {
    dsum += (double)seg_of(i);
    jsum += jump_of(i);
  }
  double dtotal;
  int jtotal;
  double doff = block_exclusive_scan(dsum, dbuf, &dtotal);
  int joff = block_exclusive_scan(jsum, ibuf, &jtotal);
  for (int i = lo; i < hi; ++i) {
    doff += (double)seg_of(i);
    joff += jump_of(i);
    arc[i] = ArcKey{(float)doff, hitv[i] ? joff : -1};
    sid[i] = joff;
  }
  __syncthreads();
  NDTG_STAGE(2, "detect: arc and piece prefix sums");

  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // Gaussian smoothing over the arc, a thread a (scale, own beam):
  // w = exp(-0.5 (darc / sigma)^2) on the same piece, the sums of w, w x
  // and w y in float64 in offset order, then (sum w p) / max(sum w, 1e-9).
  // A window beam off the piece adds w = 0 and p = 0, which leave the
  // sums' bits as they are.  Each smoothed point goes to every block.
  for (int it = tid; it < S * own; it += nt) {
    const int k = it / own, i = own_lo + (it - k * own);
    const float ci = arc[i].cum, iv = inv_sig[k];
    const int si = sid[i];
    double ws = 0.0, sx = 0.0, sy = 0.0;
#pragma unroll 4
    for (int off = -a.half; off <= a.half; ++off) {
      const int j = min(max(i + off, 0), B - 1);
      const ArcKey aj = arc[j];
      const bool on = aj.key == si;
      const float q = mul(fabsf(sub(aj.cum, ci)), iv);
      const float e = expf(mul(mul(q, q), -0.5f));
      const double w = on ? (double)e : 0.0;
      const double2 p = on ? pxy[j] : make_double2(0.0, 0.0);
      ws += w;
      sx = fma(w, p.x, sx);
      sy = fma(w, p.y, sy);
    }
    const double wsum = ws < 1e-9 ? 1e-9 : ws;
    const float2 m = make_float2((float)(sx / wsum), (float)(sy / wsum));
    const size_t o = (size_t)k * B + i;
    smv[o] = m;
    for (int q = 1; q < K; ++q) {
      cluster.map_shared_rank(smv, (rank + q) % K)[o] = m;
    }
    if (a.smoothed) {
      float* g = a.smoothed + ((scan * S + k) * B + i) * 2;
      g[0] = m.x;
      g[1] = m.y;
    }
  }
  if (a.arcs) {
    for (int i = own_lo + tid; i < own_hi; i += nt) {
      a.arcs[scan * B + i] = arc[i].cum;
    }
  }
  cluster.sync();                      // every block's points are here
  NDTG_STAGE(3, "detect: smoothing (window sums, sent to every block)");

  // The turning angle between the smoothed points one sigma of arc
  // ahead and behind, and its validity: the own beams and the beam
  // before and after them (the peaks' neighbours), circularly.
  const int span = K == 1 ? B : min(own + 2, B);
  const int first = K == 1 ? 0 : own_lo - 1 + B;
  if (own > 0) {
    for (int it = tid; it < S * span; it += nt) {
      const int k = it / span, i = (first + it - k * span) % B;
      const float ci = arc[i].cum;
      const int fwd = min(lower_bound(arc, B, add(ci, sig[k])), B - 1);
      const int bwd = min(lower_bound(arc, B, sub(ci, sig[k])), B - 1);
      const float2* sm = smv + (size_t)k * B;
      const float2 m = sm[i], mf = sm[fwd], mb = sm[bwd];
      const float fx = sub(mf.x, m.x), fy = sub(mf.y, m.y);
      const float bx = sub(m.x, mb.x), by = sub(m.y, mb.y);
      const float dot = add(mul(fx, bx), mul(fy, by));
      const float cross = sub(mul(bx, fy), mul(by, fx));
      const float curv = fabsf(atan2f(cross, add(dot, 1e-12f)));
      const int si = sid[i];
      const bool ok = hitv[i] && hitv[fwd] && hitv[bwd] && sid[fwd] == si &&
                      sid[bwd] == si && fwd > i && bwd < i;
      resp[(size_t)k * B + i] = ok ? curv : 0.0f;
    }
  }
  __syncthreads();
  NDTG_STAGE(4, "detect: responses (searches, turning angle)");

  // Strict peaks (the neighbours wrap around the scan), then the best
  // scale: the first maximum.
  for (int i = own_lo + tid; i < own_hi; i += nt) {
    const int l = i == 0 ? B - 1 : i - 1, r = i == B - 1 ? 0 : i + 1;
    float bv = 0.0f;
    int bs = 0;
    for (int k = 0; k < S; ++k) {
      const float* rk = resp + (size_t)k * B;
      const float v = rk[i];
      const bool peak = v > add(rk[l], a.peak_min_diff) &&
                        v > add(rk[r], a.peak_min_diff) &&
                        v > a.peak_min_value;
      const float pr = peak ? v : 0.0f;
      if (k == 0 || pr > bv) {
        bv = pr;
        bs = k;
      }
    }
    for (int q = 0; q < K; ++q) {
      float* qb = q == rank ? best : cluster.map_shared_rank(best, q);
      uint8_t* qs = q == rank ? bsc : cluster.map_shared_rank(bsc, q);
      qb[i] = bv;
      qs[i] = (uint8_t)bs;
    }
  }
  cluster.sync();   // every best response is here; no block's memory is
                    // touched by another after this
  NDTG_STAGE(5, "detect: peaks, best scale (sent to every block)");

  // The top `f` beams, in a stable descending order (a lower index first
  // among equal values): a positive response's rank is the count of
  // larger values and of equal ones before it, over all B (a warp a
  // beam); the zeros follow every positive one in beam order (their
  // rank: the positives' count and the zeros before them, a prefix
  // count over the runs, the same in every block).
  // (Both counts in one scan: the zeros' in the low 16 bits, the
  // positives' above; B < 2^16.)
  int both = 0;
  for (int i = lo; i < hi; ++i) both += best[i] > 0.0f ? 1 << 16 : 1;
  int total;
  int zoff = block_exclusive_scan(both, ibuf, &total) & 0xffff;
  const int ptotal = total >> 16;
  for (int i = lo; i < hi; ++i) {
    if (!(best[i] > 0.0f)) sid[i] = zoff++;
  }
  __syncthreads();
  for (int i = own_lo + warp; i < own_hi; i += nt >> 5) {
    const float v = best[i];
    if (v > 0.0f) {
      int cnt = 0;
      for (int j = lane; j < B; j += 32) {
        const float w = best[j];
        cnt += (w > v || (w == v && j < i)) ? 1 : 0;
      }
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) sid[i] = cnt;
    } else if (lane == 0) {
      sid[i] = ptotal + sid[i];
    }
  }
  __syncthreads();                     // sid: the own beams' ranks
  for (int i = own_lo + tid; i < own_hi; i += nt) {
    const int rank_i = sid[i];
    if (rank_i >= a.f) continue;
    const float v = best[i];
    // The selected beam's tangent at its best scale, its normal facing
    // the sensor, and the wrapped orientation.
    const int k = bsc[i];
    const float ci = arc[i].cum;
    const int fwd = min(lower_bound(arc, B, add(ci, sig[k])), B - 1);
    const int bwd = min(lower_bound(arc, B, sub(ci, sig[k])), B - 1);
    const float2* sm = smv + (size_t)k * B;
    const float tx = sub(sm[fwd].x, sm[bwd].x);
    const float ty = sub(sm[fwd].y, sm[bwd].y);
    float na = atan2f(tx, -ty);
    const float px = (float)pxy[i].x, py = (float)pxy[i].y;
    const float toward = add(mul(cosf(na), -px), mul(sinf(na), -py));
    if (toward < 0.0f) na = add(na, kPi);
    const size_t o = scan * a.f + rank_i;
    a.pts[2 * o] = px;
    a.pts[2 * o + 1] = py;
    a.angles[o] = wrap_angle(na);
    a.scales[o] = sig[k];
    a.response[o] = v;
    a.mask[o] = v > 0.0f;
  }
  NDTG_STAGE(6, "detect: top-K ranks, features");
}

// ---------------------------------------------------------------- describe

struct DescribeArgs {
  const float* ranges;      // (N, B)
  const uint8_t* hit;
  const float* cosb;
  const float* sinb;
  const float* fpts;        // (N, F, 2)
  const float* fang;        // (N, F)
  const float* fscale;
  const uint8_t* fmask;
  int b, f, r_bins, p_bins, hitmiss;
  float min_rho, max_rho, inv_base_sigma, inv_r_bins, inv_2pi;
  float* out;               // (N, F, D)
};

// The polar bin of a point relative to the feature (rotated by the
// feature's -angle: ca, sa) and whether it lies in the support.
__device__ __forceinline__ int polar_bin(float rx, float ry, float ca,
                                         float sa, float rden, float min_rho,
                                         int r_bins, int p_bins, float inv_2pi,
                                         bool* ok) {
  const float x = sub(mul(rx, ca), mul(ry, sa));
  const float y = add(mul(rx, sa), mul(ry, ca));
  const float rho = __fsqrt_rn(add(mul(x, x), mul(y, y)));
  const float phi = atan2f(y, x);
  const long long ri =
      floor_i64(mul(fdiv(sub(rho, min_rho), rden), (float)r_bins));
  long long pi = floor_i64(mul(mul(add(phi, kPi), inv_2pi), (float)p_bins));
  pi = pi < 0 ? 0 : (pi > p_bins - 1 ? p_bins - 1 : pi);
  *ok = ri >= 0 && ri < r_bins;
  const long long rc = ri < 0 ? 0 : (ri > r_bins - 1 ? r_bins - 1 : ri);
  return (int)(rc * p_bins + pi);
}

// The descriptor's shared memory: the 128 partial miss sums of each bin
// ([bin][sum]), each chord sample's bin (a byte, 8 a beam: kDropped where
// the sample falls outside the support or the beam has no chord), the hit
// count of each bin, each beam's chord start, length (-1: no chord) and
// weight.
__host__ __device__ constexpr long long describe_bins_bytes(int b) {
  return ((long long)b * 8 + 15) / 16 * 16;
}
__host__ __device__ constexpr long long describe_smem(int b, int nb) {
  return (long long)nb * kDescribeSums * 4 + describe_bins_bytes(b) +
         (long long)nb * 4 + (long long)b * 3 * 4;
}

// One block of blockDim.x threads (128 to 1,024, the wrapper's
// describe_threads) a (scan, feature): blockIdx.x = scan * F + feature.
// The bins of a feature's positions do not depend on the order, only its
// float adds do, so every thread computes bins, and 128 threads then
// replay the adds in the order of a 128-thread block that took beams t,
// t + 128, ... a thread (the descriptor's first design):
//   * beams: a thread a beam (strided), its hit's bin (integer counts, one
//     shared atomic a group of lanes with the same bin) and its chord;
//   * chord samples: a thread a (beam, sample), its bin as a byte;
//   * replay: partial sum t (t < 128) takes beams t, t + 128, ... in
//     turn and each beam's samples k = 0..7 in order, as that block's
//     thread t did (a run of samples in the same bin stays in a
//     register);
//   * tree: sum t and sum t + stride paired as that block's tree paired
//     them, a warp a bin: strides 64 and 32 in registers, 16 .. 1 by
//     warp shuffles.
// The same bits as the first design, at any block size.
__global__ void __launch_bounds__(kDescribeMaxThreads)
features_describe_kernel(DescribeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = kDescribeSums;
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = a.r_bins * a.p_bins;
  const int B = a.b;
  float* mb = reinterpret_cast<float*>(smem);                  // (nb, S)
  uint8_t* bins = reinterpret_cast<uint8_t*>(mb + (size_t)nb * S);  // (B, 8)
  int* hits = reinterpret_cast<int*>(bins + describe_bins_bytes(B));  // (nb,)
  float* c_t0 = reinterpret_cast<float*>(hits + nb);          // (B,)
  float* c_len = c_t0 + B;                                     // (B,)
  float* c_w = c_len + B;                                      // (B,)
  __shared__ float tot[2];

  NDTG_STAGE(0, "describe: start");
  const size_t item = blockIdx.x;
  const size_t scan = item / a.f;
  for (int i = tid; i < nb * S / 4; i += T)
    reinterpret_cast<float4*>(mb)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int n = tid; n < nb; n += T) hits[n] = 0;
  const bool live = a.fmask[item] != 0;
  float fx = 0.0f, fy = 0.0f, ca = 0.0f, sa = 0.0f, rden = 0.0f;
  if (live) {
    fx = a.fpts[2 * item];
    fy = a.fpts[2 * item + 1];
    const float fa = a.fang[item];
    ca = cosf(-fa);
    sa = sinf(-fa);
  }
  const float sup = fminf(
      fmaxf(mul(a.max_rho,
                __fsqrt_rn(clamp_min(mul(a.fscale[item], a.inv_base_sigma),
                                     1.0f))),
            a.max_rho),
      4.0f * a.max_rho);
  rden = sub(sup, a.min_rho);
  __syncthreads();
  NDTG_STAGE(1, "describe: load and zero");

  if (live) {
    const float bin_w = clamp_min(mul(rden, a.inv_r_bins), 1e-6f);
    const float p2 = add(mul(fx, fx), mul(fy, fy));
    const float sup2 = mul(sup, sup);
    const float* rng = a.ranges + scan * B;
    const uint8_t* hg = a.hit + scan * B;
    // Warp-uniform trip count: every lane reaches the __match_any_sync.
    for (int base = 0; base < B; base += T) {
      const int bm = base + tid;
      int hb = -1;
      if (bm < B) {
        const float r = rng[bm];
        const float dx = a.cosb[bm], dy = a.sinb[bm];
        if (hg[bm]) {
          bool ok;
          const int n = polar_bin(sub(mul(r, dx), fx), sub(mul(r, dy), fy),
                                  ca, sa, rden, a.min_rho, a.r_bins,
                                  a.p_bins, a.inv_2pi, &ok);
          if (ok) hb = n;
        }
        // The beam's chord through the support circle.
        const float dp = dot2(dx, fx, dy, fy);
        const float disc = add(sub(mul(dp, dp), p2), sup2);
        const float root = __fsqrt_rn(clamp_min(disc, 0.0f));
        const float t0 = clamp_min(sub(dp, root), 0.0f);
        const float t1 = minimum(add(dp, root), mul(r, 0.999f));
        const float chord = clamp_min(sub(t1, t0), 0.0f);
        const bool use = disc > 0.0f && chord > 1e-6f;
        c_t0[bm] = t0;
        c_len[bm] = use ? chord : -1.0f;
        c_w[bm] = use ? fdiv(mul(chord, 0.125f), bin_w) : 0.0f;
      }
      const unsigned peers = __match_any_sync(kFull, hb);
      if (hb >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(hits + hb, __popc(peers));
    }
  }
  __syncthreads();
  NDTG_STAGE(2, "describe: hit bins");

  if (live) {
    for (int it = tid; it < B * 8; it += T) {
      const int bm = it >> 3, k = it & 7;
      const float len = c_len[bm];
      uint8_t code = kDropped;
      if (len >= 0.0f) {
        const float ts = add(c_t0[bm], mul(len, ((float)k + 0.5f) * 0.125f));
        const float dx = a.cosb[bm], dy = a.sinb[bm];
        bool ok;
        const int n = polar_bin(sub(mul(ts, dx), fx), sub(mul(ts, dy), fy),
                                ca, sa, rden, a.min_rho, a.r_bins, a.p_bins,
                                a.inv_2pi, &ok);
        if (ok) code = (uint8_t)n;
      }
      bins[it] = code;
    }
  }
  __syncthreads();
  NDTG_STAGE(3, "describe: chord bins");

  if (live && tid < S) {
    int cur = -1;
    float acc = 0.0f;
    for (int bm = tid; bm < B; bm += S) {
      const uint2 word = *reinterpret_cast<const uint2*>(bins + 8 * bm);
      if ((word.x & word.y) == 0xffffffffu) continue;   // no sample kept
      const float w = c_w[bm];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = ((k < 4 ? word.x : word.y) >> (8 * (k & 3))) & 0xff;
        if (n == kDropped) continue;
        if (n != cur) {
          if (cur >= 0) mb[cur * S + tid] = acc;
          cur = n;
          acc = mb[n * S + tid];
        }
        acc = add(acc, w);
      }
    }
    if (cur >= 0) mb[cur * S + tid] = acc;
  }
  __syncthreads();
  NDTG_STAGE(4, "describe: replay");

  // A warp a bin: lane l holds sums l, l + 32, l + 64 and l + 96; the
  // strides 64 and 32 in registers, 16 .. 1 by shuffles.
  for (int n = warp; n < nb; n += T >> 5) {
    const float* m = mb + n * S;
    const float lo = add(m[lane], m[lane + 64]);
    const float hi = add(m[lane + 32], m[lane + 96]);
    float v = add(lo, hi);
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
      v = add(v, __shfl_down_sync(kFull, v, stride));
    if (lane == 0) mb[n * S] = v;
  }
  __syncthreads();
  NDTG_STAGE(5, "describe: tree");

  float* out = a.out + item * (size_t)(a.hitmiss ? 2 * nb : nb);
  if (!a.hitmiss) {
    for (int n = tid; n < nb; n += T) {
      const float h = (float)hits[n], m = mb[n * S];
      out[n] = fdiv(add(h, 1.0f), add(add(h, m), 2.0f));
    }
    NDTG_STAGE(6, "describe: output");
    return;
  }
  if (tid == 0) {
    float hs = 0.0f, ms = 0.0f;
    for (int n = 0; n < nb; ++n) {
      hs = add(hs, (float)hits[n]);
      ms = add(ms, mb[n * S]);
    }
    tot[0] = clamp_min(hs, 1e-9f);
    tot[1] = clamp_min(ms, 1e-9f);
  }
  __syncthreads();
  for (int n = tid; n < nb; n += T) {
    out[n] = mul(0.5f, fdiv((float)hits[n], tot[0]));
    out[nb + n] = mul(0.5f, fdiv(mb[n * S], tot[1]));
  }
  NDTG_STAGE(6, "describe: output");
}

// ------------------------------------------------------------------- match

struct MatchArgs {
  const float* ref_pts;  const uint8_t* ref_mask;  const float* ref_desc;
  const float* mov_pts;  const uint8_t* mov_mask;  const float* mov_desc;
  const float* u;
  long long s_ref_pts, s_ref_mask, s_ref_desc;     // elements a pair
  long long s_mov_pts, s_mov_mask, s_mov_desc, s_u;
  int f1, f2, d, c, m, budget, adaptive, cluster;
  float acc, dist_thr, rig4, w0, log1mp, eps;
  // the odometry gate (gate != 0): the sensor pose, the odometry motion
  // and the previous pose, (3,) a pair with these strides (0: shared).
  const float* sp;  const float* tm;  const float* prev;
  long long s_sp, s_tm, s_prev;
  int gate, check;
  float max_t, max_r, cov_xy;
  float* T;  float* score;  int* n_in;
  long long* corr_ref;  long long* corr_mov;
  uint8_t* corr_mask;  uint8_t* inlier;  uint8_t* valid;
  float* src;  float* tgt;  float* covs;  uint8_t* pair_mask;
};

// The descriptor rows' stride in shared memory: whole 16-byte words, an
// odd number of them, so that eight threads reading eight rows' words
// (a quarter warp's 16-byte loads) meet no bank twice.
__host__ __device__ inline int desc_stride(int d) {
  const int w = (d + 3) / 4;
  return 4 * (w % 2 ? w : w + 1);
}

// A block's shared memory at `k` blocks a pair: its ceil(f1 / k)
// reference rows of descriptors and distances.
__host__ __device__ inline long long match_smem(int f1, int f2, int d, int c,
                                                int m, int k) {
  const long long r1 = (f1 + k - 1) / k;
  return 16LL * c +
         4LL * ((r1 + f2) * desc_stride(d) + r1 * f2 + (r1 + f2) +
                (2LL * k + 2) * f2 +
                2LL * (f1 + f2) + 2LL * c + 9LL * m) +
         f1 + f2 + c + 64;
}

struct Pose { float x, y, t; };

__device__ __forceinline__ Pose compose(Pose a, Pose b) {
  const float ca = cosf(a.t), sa = sinf(a.t);
  return {sub(add(a.x, mul(b.x, ca)), mul(b.y, sa)),
          add(add(a.y, mul(b.x, sa)), mul(b.y, ca)), wrap_angle(add(a.t, b.t))};
}
__device__ __forceinline__ Pose inverse(Pose a) {
  const float ca = cosf(a.t), sa = sinf(a.t);
  return {-add(mul(a.x, ca), mul(a.y, sa)),
          -add(mul(-a.x, sa), mul(a.y, ca)), -a.t};
}
// se2.sub(origin, pose): pose in origin's frame.
__device__ __forceinline__ Pose relative(Pose o, Pose p) {
  const float co = cosf(o.t), so = sinf(o.t);
  const float dx = sub(p.x, o.x), dy = sub(p.y, o.y);
  return {add(mul(dx, co), mul(dy, so)), add(mul(-dx, so), mul(dy, co)),
          wrap_angle(sub(p.t, o.t))};
}
// se2.transform_points with the pose's cosine and sine: the rotation as
// torch's einsum, then the shift.
__device__ __forceinline__ float2 transform(Pose p, float c, float s, float x,
                                            float y) {
  return make_float2(add(dot2(c, x, -s, y), p.x), add(dot2(s, x, c, y), p.y));
}
// ransac._apply: c x - s y + t0, s x + c y + t1, against the
// correspondence's reference point.
__device__ __forceinline__ float residual2(float c, float s, float tx,
                                           float ty, float4 p) {
  const float px = add(sub(mul(c, p.z), mul(s, p.w)), tx);
  const float py = add(add(mul(s, p.z), mul(c, p.w)), ty);
  const float dx = sub(p.x, px), dy = sub(p.y, py);
  return add(mul(dx, dx), mul(dy, dy));
}
// The warp's sum of one value a lane: a butterfly (offsets 16 .. 1),
// every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
// (v, i) is before (w, j) in a first-minimum scan.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// One cluster of `cluster` blocks a pair (blockIdx.x / cluster).  Block
// rank r normalises its reference rows [r ceil(F1 / cluster), ...) and
// every moving row (a thread a row's sum, every thread some quotients),
// takes their chi2 distances (a thread an entry, the D terms in order)
// and each moving feature's first minimum over its rows (a warp a
// column), which it writes into rank 0's shared memory; after a cluster
// barrier rank 0 takes the first minimum over the ranks in order (the
// lowest row among equals, as one scan over all rows) and goes on alone:
// the stable top-C by counting ranks (a warp a feature), the
// correspondences, the hypotheses (a thread each, the C residuals in
// order), the winner; warp 0 refines
// it, scores it and, with the gate, decides it and writes the pair
// masks, while the other warps move the gate's pseudo-cells (they do
// not depend on the pose).
__global__ void __launch_bounds__(kMatchThreads)
features_match_kernel(MatchArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F1 = a.f1, F2 = a.f2, D = a.d, C = a.c, M = a.m, K = a.cluster;
  const int r1 = (F1 + K - 1) / K, Dp = desc_stride(D);
  float4* corr = reinterpret_cast<float4*>(smem);    // (C,) a, b points
  float* an = reinterpret_cast<float*>(corr + C);    // (r1, Dp)
  float* bn = an + (size_t)r1 * Dp;                  // (F2, Dp)
  float* dist = bn + (size_t)F2 * Dp;                // (r1, F2)
  float* rsum = dist + (size_t)r1 * F2;              // (r1 + F2,)
  float* pv = rsum + r1 + F2;                        // (K, F2) ranks' minima
  int* pi = reinterpret_cast<int*>(pv + (size_t)K * F2);   // (K, F2)
  float* bd = reinterpret_cast<float*>(pi + (size_t)K * F2);  // (F2,)
  int* bref = reinterpret_cast<int*>(bd + F2);       // (F2,)
  float* rp = reinterpret_cast<float*>(bref + F2);   // (F1, 2)
  float* mp = rp + 2 * F1;                           // (F2, 2)
  float* cd = mp + 2 * F2;                           // (C,)
  int* cmov = reinterpret_cast<int*>(cd + C);        // (C,)
  float* msac = reinterpret_cast<float*>(cmov + C);  // (M,)
  float* hyp = msac + M;               // (M, 5): the pose, its cos, sin
  float* ratio = hyp + 5 * M;                        // (M,)
  float* us = ratio + M;                             // (M, 2) the draws
  uint8_t* rm = reinterpret_cast<uint8_t*>(us + 2 * M);
  uint8_t* mm = rm + F1;
  uint8_t* cm = mm + F2;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int n_valid;
  __shared__ float gate_v[11];   // sp, cos and sin of sp.t, inverse(sp), tm

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int rank = (int)cluster.block_rank();
  const size_t pair = blockIdx.x / K;
  const int i_lo = min(rank * r1, F1), nr = min(i_lo + r1, F1) - i_lo;
  const float inf = __int_as_float(0x7f800000);
  NDTG_STAGE(0, "match: start");
  // Every block of the cluster has started before one writes to rank
  // 0's shared memory (the wait is before that).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  {
    const uint8_t* k = a.ref_mask + pair * a.s_ref_mask;
    for (int i = tid; i < F1; i += nt) rm[i] = __ldg(k + i) != 0;
    k = a.mov_mask + pair * a.s_mov_mask;
    for (int i = tid; i < F2; i += nt) mm[i] = __ldg(k + i) != 0;
    const float* g = a.ref_desc + pair * a.s_ref_desc + (size_t)i_lo * D;
#pragma unroll 4
    for (int i = tid; i < nr * D; i += nt) {
      an[(i / D) * Dp + i % D] = __ldg(g + i);
    }
    g = a.mov_desc + pair * a.s_mov_desc;
#pragma unroll 4
    for (int i = tid; i < F2 * D; i += nt) {
      bn[(i / D) * Dp + i % D] = __ldg(g + i);
    }
    if (rank == 0) {
      g = a.u + pair * a.s_u;
      for (int i = tid; i < 2 * M; i += nt) us[i] = __ldg(g + i);
      g = a.ref_pts + pair * a.s_ref_pts;
      for (int i = tid; i < 2 * F1; i += nt) rp[i] = __ldg(g + i);
      g = a.mov_pts + pair * a.s_mov_pts;
      for (int i = tid; i < 2 * F2; i += nt) mp[i] = __ldg(g + i);
      if (a.gate && tid == nt - 1) {   // the gate's poses, off the path
        g = a.sp + pair * a.s_sp;
        const Pose sp{g[0], g[1], g[2]};
        g = a.tm + pair * a.s_tm;
        const Pose inv = inverse(sp);
        const float v[11] = {sp.x, sp.y, sp.t, cosf(sp.t), sinf(sp.t),
                             inv.x, inv.y, inv.t, g[0], g[1], g[2]};
        for (int k = 0; k < 11; ++k) gate_v[k] = v[k];
      }
    }
  }
  __syncthreads();
  NDTG_STAGE(1, "match: load");
  // Each descriptor row over its sum (in order), clamped at eps: a
  // thread a row's sum (16-byte words), then every thread some entries'
  // quotients.
  for (int r = tid; r < nr + F2; r += nt) {
    const float* row = r < nr ? an + (size_t)r * Dp
                              : bn + (size_t)(r - nr) * Dp;
    float s = 0.0f;
    int k = 0;
    if ((D & 3) == 0) {
#pragma unroll 4
      for (; k < D; k += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + k);
        s = add(add(add(add(s, x.x), x.y), x.z), x.w);
      }
    }
    for (; k < D; ++k) s = add(s, row[k]);
    rsum[r] = clamp_min(s, a.eps);
  }
  __syncthreads();
  for (int it = tid; it < (nr + F2) * D; it += nt) {
    const int r = it / D;
    float* x = (r < nr ? an + (size_t)r * Dp : bn + (size_t)(r - nr) * Dp) +
               (it - r * D);
    *x = fdiv(*x, rsum[r]);
  }
  __syncthreads();
  NDTG_STAGE(2, "match: normalise");
  // The symmetric chi2 distances of the rank's rows, inf where either
  // feature is padding.
  for (int it = tid; it < nr * F2; it += nt) {
    const int i = it / F2, j = it - i * F2;
    float v = inf;
    if (rm[i_lo + i] && mm[j]) {
      const float* p = an + (size_t)i * Dp;
      const float* q = bn + (size_t)j * Dp;
      auto num = [&](float x, float y) {
        const float df = sub(x, y);
        return mul(df, df);
      };
      auto den = [&](float x, float y) { return add(add(x, y), a.eps); };
      float s = 0.0f;
      int k = 0;
      if ((D & 3) == 0) {            // rows 16-byte aligned: 4 terms a step
        for (; k < D; k += 4) {
          const float4 x = *reinterpret_cast<const float4*>(p + k);
          const float4 y = *reinterpret_cast<const float4*>(q + k);
          const float n0 = num(x.x, y.x), n1 = num(x.y, y.y);
          const float n2 = num(x.z, y.z), n3 = num(x.w, y.w);
          const float d0 = den(x.x, y.x), d1 = den(x.y, y.y);
          const float d2 = den(x.z, y.z), d3 = den(x.w, y.w);
          const float t0 = fdiv(n0, d0), t1 = fdiv(n1, d1);
          const float t2 = fdiv(n2, d2), t3 = fdiv(n3, d3);
          s = add(add(add(add(s, t0), t1), t2), t3);
        }
      }
      for (; k < D; ++k) s = add(s, fdiv(num(p[k], q[k]), den(p[k], q[k])));
      v = mul(0.5f, s);
    }
    dist[it] = v;
  }
  __syncthreads();
  NDTG_STAGE(3, "match: chi2 matrix");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // Each moving feature's first minimum over the rank's rows: a warp a
  // column, each lane its rows in order, then a butterfly that keeps
  // the lower row among equal values.
  for (int j = warp; j < F2; j += nwarps) {
    float bv = inf;
    int bi = 0x7fffffff;
    for (int i = lane; i < nr; i += 32) {
      const float v = dist[(size_t)i * F2 + j];
      if (before(v, i_lo + i, bv, bi)) {
        bv = v;
        bi = i_lo + i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {               // into rank 0's row `rank`
      const size_t o = (size_t)rank * F2 + j;
      if (rank == 0) {
        pv[o] = bv;
        pi[o] = bi;
      } else {
        cluster.map_shared_rank(pv, 0)[o] = bv;
        cluster.map_shared_rank(pi, 0)[o] = bi;
      }
    }
  }
  cluster.sync();                  // every rank's minima are in rank 0
  if (rank != 0) return;
  // Over the ranks in order: a later rank's rows win only below.
  for (int j = tid; j < F2; j += nt) {
    float bv = pv[j];
    int bi = pi[j];
    for (int r = 1; r < K; ++r) {
      const float v = pv[(size_t)r * F2 + j];
      if (v < bv) {
        bv = v;
        bi = pi[(size_t)r * F2 + j];
      }
    }
    bd[j] = bv;
    bref[j] = bi;
  }
  __syncthreads();
  NDTG_STAGE(4, "match: nearest neighbour");
  // The C nearest, in a stable ascending order (padded with feature 0 at
  // distance inf when F2 < C): a warp a moving feature counts the ones
  // before it.
  const int cs = min(C, F2);
  for (int j = warp; j < F2; j += nwarps) {
    const float v = bd[j];
    int cnt = 0;
    for (int k0 = 0; k0 < F2; k0 += 32) {
      const int k = k0 + lane;
      const bool b = k < F2 && before(bd[k], k, v, j);
      cnt += __popc(__ballot_sync(kFull, b));
    }
    if (lane == 0 && cnt < cs) {
      cmov[cnt] = j;
      cd[cnt] = v;
    }
  }
  for (int c = cs + tid; c < C; c += nt) {
    cmov[c] = 0;
    cd[c] = inf;
  }
  __syncthreads();
  NDTG_STAGE(5, "match: top-C ranks");
  for (int c = tid; c < C; c += nt) {
    const int j = cmov[c], i = bref[j];
    cm[c] = cd[c] < a.dist_thr;
    corr[c] = make_float4(rp[2 * i], rp[2 * i + 1], mp[2 * j], mp[2 * j + 1]);
    a.corr_ref[pair * C + c] = i;
    a.corr_mov[pair * C + c] = j;
    a.corr_mask[pair * C + c] = cm[c];
  }
  if (warp == 0) {
    int n = 0;
    for (int c = lane; c < C; c += 32) n += (cd[c] < a.dist_thr) ? 1 : 0;
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) n_valid = n;
  }
  __syncthreads();
  NDTG_STAGE(6, "match: correspondences");

  {
    // The hypotheses, a thread each: a pair of correspondences from the
    // draws, the two-point fit, its rigidity and validity, the MSAC
    // score over the C correspondences in order.
    const float nvf = clamp_min((float)n_valid, 1.0f);
    const float* ug = us;
    for (int m = tid; m < M; m += nt) {
      long long i0 = floor_i64(mul(ug[2 * m], nvf));
      long long i1 = floor_i64(mul(ug[2 * m + 1], nvf));
      i0 = i0 < 0 ? 0 : (i0 > C - 1 ? C - 1 : i0);
      i1 = i1 < 0 ? 0 : (i1 > C - 1 ? C - 1 : i1);
      const float4 c0 = corr[i0], c1 = corr[i1];
      const float dax = sub(c1.x, c0.x), day = sub(c1.y, c0.y);
      const float dbx = sub(c1.z, c0.z), dby = sub(c1.w, c0.w);
      const float seg_len = norm2(dbx, dby);
      const float theta = sub(atan2f(day, dax), atan2f(dby, dbx));
      const float ch = cosf(theta), sh = sinf(theta);
      const float tx = sub(c0.x, sub(mul(ch, c0.z), mul(sh, c0.w)));
      const float ty = sub(c0.y, add(mul(sh, c0.z), mul(ch, c0.w)));
      const float ld = sub(seg_len, norm2(dax, day));
      const bool ok = seg_len > 0.2f && mul(ld, ld) < a.rig4 && cm[i0] &&
                      cm[i1] && i0 != i1;
      float s = 0.0f;
      int inl = 0;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float r2 = residual2(ch, sh, tx, ty, corr[c]);
        s = add(s, clamp_max(cm[c] ? r2 : a.acc, a.acc));
        inl += (r2 < a.acc && cm[c]) ? 1 : 0;
      }
      msac[m] = (ok && m < a.budget) ? s : inf;
      hyp[5 * m] = tx;
      hyp[5 * m + 1] = ty;
      hyp[5 * m + 2] = theta;
      hyp[5 * m + 3] = ch;
      hyp[5 * m + 4] = sh;
      ratio[m] = ok ? fdiv((float)inl, nvf) : 0.0f;
    }
  }
  __syncthreads();
  NDTG_STAGE(7, "match: hypotheses, MSAC");
  if (a.adaptive && tid == 0) {
    // Hypothesis m counts while m < N(the best inlier ratio before it).
    float run = a.w0;
    for (int m = 0; m < M; ++m) {
      const float w2 = fminf(fmaxf(mul(run, run), 1e-9f), 0.999999f);
      const float bound = fdiv(a.log1mp, log1pf(-w2));
      if (!((float)m < ceilf(bound))) msac[m] = inf;
      run = fmaxf(run, clamp_min(ratio[m], a.w0));
    }
  }
  __syncthreads();
  // The winner: the first minimum of the scores.
  {
    float bv = inf;
    int bi = 0x7fffffff;
    for (int m = tid; m < M; m += nt) {
      if (before(msac[m], m, bv, bi)) {
        bv = msac[m];
        bi = m;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
  }
  __syncthreads();
  NDTG_STAGE(8, "match: winner");
  if (warp != 0) {
    if (!a.gate) return;
    // The gate's pseudo-cells, beside warp 0's fits: the reference points
    // in the world under the previous pose and the sensor pose, the
    // moving points in the vehicle frame (warp 0 writes the pair masks).
    const Pose sp{gate_v[0], gate_v[1], gate_v[2]};
    const float* g = a.prev + pair * a.s_prev;
    const Pose wp = compose(Pose{g[0], g[1], g[2]}, sp);
    const float wc = cosf(wp.t), ws = sinf(wp.t);
    for (int c = tid - 32; c < C; c += nt - 32) {
      const size_t o = pair * C + c;
      const float4 p = corr[c];
      const float2 t = transform(wp, wc, ws, p.x, p.y);
      const float2 s = transform(sp, gate_v[3], gate_v[4], p.z, p.w);
      a.tgt[2 * o] = t.x;
      a.tgt[2 * o + 1] = t.y;
      a.src[2 * o] = s.x;
      a.src[2 * o + 1] = s.y;
      a.covs[4 * o] = a.cov_xy;
      a.covs[4 * o + 1] = 0.0f;
      a.covs[4 * o + 2] = 0.0f;
      a.covs[4 * o + 3] = a.cov_xy;
    }
    return;
  }
  int win = red_i[0];
  float wv = red_v[0];
  for (int w = 1; w < nwarps; ++w) {
    if (before(red_v[w], red_i[w], wv, win)) {
      wv = red_v[w];
      win = red_i[w];
    }
  }
  if (win >= M) win = 0;
  const bool any_hyp = fabsf(msac[win]) < inf;
  float T0 = hyp[5 * win], T1 = hyp[5 * win + 1], T2 = hyp[5 * win + 2];
  // cosf and sinf of T2, carried with it (each taken once).
  float cT = hyp[5 * win + 3], sT = hyp[5 * win + 4];

  // Two weighted Procrustes fits on the inliers under the current pose.
  for (int rep = 0; rep < 2; ++rep) {
    const float c0 = cT, s0 = sT;
    float sw = 0.0f, sax = 0.0f, say = 0.0f, sbx = 0.0f, sby = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float4 p = corr[c];
      const float r2 = residual2(c0, s0, T0, T1, p);
      const float w = (r2 < a.acc && cm[c]) ? 1.0f : 0.0f;
      cd[c] = w;
      sw = add(sw, w);
      sax = add(sax, mul(p.x, w));
      say = add(say, mul(p.y, w));
      sbx = add(sbx, mul(p.z, w));
      sby = add(sby, mul(p.w, w));
    }
    sw = warp_sum(sw);
    sax = warp_sum(sax);
    say = warp_sum(say);
    sbx = warp_sum(sbx);
    sby = warp_sum(sby);
    __syncwarp();
    if (!(sw >= 2.0f)) continue;
    const float wsum = clamp_min(sw, 1e-9f);
    const float cax = fdiv(sax, wsum), cay = fdiv(say, wsum);
    const float cbx = fdiv(sbx, wsum), cby = fdiv(sby, wsum);
    float sxx = 0.0f, sxy = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float w = cd[c];
      const float4 p = corr[c];
      const float a0x = sub(p.x, cax), a0y = sub(p.y, cay);
      const float b0x = sub(p.z, cbx), b0y = sub(p.w, cby);
      sxx = add(sxx, mul(w, add(mul(b0x, a0x), mul(b0y, a0y))));
      sxy = add(sxy, mul(w, sub(mul(b0x, a0y), mul(b0y, a0x))));
    }
    sxx = warp_sum(sxx);
    sxy = warp_sum(sxy);
    __syncwarp();
    const float th = atan2f(sxy, sxx);
    const float c1 = cosf(th), s1 = sinf(th);
    T0 = sub(cax, sub(mul(c1, cbx), mul(s1, cby)));
    T1 = sub(cay, add(mul(s1, cbx), mul(c1, cby)));
    T2 = th;
    cT = c1;
    sT = s1;
  }
  if (!any_hyp) {
    T0 = T1 = T2 = 0.0f;
    cT = 1.0f;                         // cosf(0), sinf(0)
    sT = 0.0f;
  }
  NDTG_STAGE(9, "match: two Procrustes fits");

  // The result under the fitted pose, then the gate.
  const float c0 = cT, s0 = sT;
  float sco = 0.0f;
  int n_in = 0;
  for (int c = lane; c < C; c += 32) {
    const float r2 = residual2(c0, s0, T0, T1, corr[c]);
    const bool in = r2 < a.acc && cm[c] && any_hyp;
    cd[c] = in ? 1.0f : 0.0f;
    a.inlier[pair * C + c] = in;
    n_in += in ? 1 : 0;
    sco = add(sco, cm[c] ? clamp_max(r2, a.acc) : a.acc);
  }
  sco = warp_sum(sco);
  n_in = __reduce_add_sync(kFull, n_in);
  const bool valid = any_hyp && n_in >= 2;
  if (lane == 0) {
    a.T[3 * pair] = T0;
    a.T[3 * pair + 1] = T1;
    a.T[3 * pair + 2] = T2;
    a.score[pair] = sco;
    a.n_in[pair] = n_in;
    a.valid[pair] = valid;
  }
  NDTG_STAGE(10, "match: final score, result");
  if (!a.gate) {
    NDTG_STAGE(11, "match: gate, pair masks");
    return;
  }
  // RANSAC's T maps the current sensor frame onto the previous one:
  // compare it with the odometry in the vehicle frame.  compose(sp, T)
  // with sp's cosine and sine, taken beside the hypotheses.
  const Pose sp{gate_v[0], gate_v[1], gate_v[2]};
  const float sc = gate_v[3], ss = gate_v[4];
  const Pose inv_sp{gate_v[5], gate_v[6], gate_v[7]};
  const Pose tm{gate_v[8], gate_v[9], gate_v[10]};
  const Pose st{sub(add(sp.x, mul(T0, sc)), mul(T1, ss)),
                add(add(sp.y, mul(T0, ss)), mul(T1, sc)),
                wrap_angle(add(sp.t, T2))};
  const Pose diff = relative(compose(st, inv_sp), tm);
  const bool consistent =
      (norm2(diff.x, diff.y) <= a.max_t && fabsf(diff.t) <= a.max_r) ||
      !a.check;
  const bool feats_ok = valid && consistent;
  for (int c = lane; c < C; c += 32) {
    a.pair_mask[pair * C + c] = cd[c] != 0.0f && feats_ok;
  }
  NDTG_STAGE(11, "match: gate, pair masks");
}

// The CUDA maths library's functions the kernels call, elementwise, for
// a check against ATen's on the card (chip_smoke.py rounding_probe):
// out = f(a[, b]) with f = 0 expf, 1 cosf, 2 sinf, 3 atan2f(a, b),
// 4 log1pf.
__global__ void features_math_probe_kernel(const float* a, const float* b,
                                           float* out, long long n, int f) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i];
  out[i] = f == 0 ? expf(x) : f == 1 ? cosf(x) : f == 2 ? sinf(x)
         : f == 3 ? atan2f(x, b[i]) : log1pf(x);
}

// Lets `fn` take `bytes` of dynamic shared memory on the current device
// (set once a device, for the largest size asked so far).
int set_smem(const void* fn, long long bytes, long long* configured) {
  if (bytes > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (bytes > configured[dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = bytes;
  }
  return 0;
}

long long g_detect_smem[kMaxDevices], g_describe_smem[kMaxDevices],
    g_match_smem[kMaxDevices];

}  // namespace

extern "C" {

int ndtg_features_max_scales() { return kMaxScales; }
int ndtg_features_max_bins() { return kMaxBins; }
long long ndtg_features_max_smem() { return kMaxDynamicSmem; }
long long ndtg_detect_smem(int b, int s) { return detect_smem(b, s); }
long long ndtg_describe_smem(int b, int nb) { return describe_smem(b, nb); }
long long ndtg_match_smem(int f1, int f2, int d, int c, int m, int k) {
  return match_smem(f1, f2, d, c, m, k);
}

// pts (N, F, 2), angles / scales / response (N, F), mask (N, F): the top
// f interest points of each of the n scans (ranges, hit (N, B)).
// sigmas: the s scales as float64 (host memory).  arcs (N, B) and smoothed
// (N, S, B, 2): null, or the cumulative arc and the smoothed points.
// cluster: blocks a scan (1 to kMaxDetectCluster; the bits do not
// depend on it).
int ndtg_detect_features(const float* ranges, const uint8_t* hit,
                         const float* cosb, const float* sinb, long long n,
                         int b, int s, int half, int f, const double* sigmas,
                         float peak_min_diff, float peak_min_value,
                         float* pts, float* angles, float* scales,
                         float* response, uint8_t* mask, float* arcs,
                         float* smoothed, int cluster, void* stream) {
  if (s < 1 || s > kMaxScales || b < 1 || f < 1 || f > b || half < 0 ||
      cluster < 1 || cluster > kMaxDetectCluster || n < 1 ||
      n * cluster > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  DetectArgs a{ranges, hit, cosb, sinb, b, s, half, f, cluster, {}, {},
               peak_min_diff, peak_min_value, pts, angles, scales, response,
               mask, arcs, smoothed};
  for (int k = 0; k < s; ++k) {
    a.sigma[k] = (float)sigmas[k];
    a.inv_sigma[k] = (float)(1.0 / sigmas[k]);
  }
  const long long bytes = detect_smem(b, s);
  int err = set_smem((const void*)features_detect_kernel, bytes, g_detect_smem);
  if (err) return err;
  return ndtg::launch_cluster(features_detect_kernel,
                              dim3((unsigned)(n * cluster)), kDetectThreads,
                              cluster, (size_t)bytes, (cudaStream_t)stream, a);
}

// out (N, F, D): the descriptor of each feature of each of the n scans,
// one block of `threads` threads a feature (a multiple of 32, 128 to
// 1,024; the bits do not depend on it).
int ndtg_describe_features(const float* ranges, const uint8_t* hit,
                           const float* cosb, const float* sinb,
                           const float* fpts, const float* fang,
                           const float* fscale, const uint8_t* fmask,
                           long long n, int b, int f, int r_bins, int p_bins,
                           int hitmiss, float min_rho, float max_rho,
                           float inv_base_sigma, float inv_r_bins,
                           float inv_2pi, float* out, int threads,
                           void* stream) {
  if (r_bins < 1 || p_bins < 1 || r_bins * p_bins > kMaxBins || b < 1 ||
      threads < kDescribeSums || threads > kDescribeMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  DescribeArgs a{ranges, hit, cosb, sinb, fpts, fang, fscale, fmask, b, f,
                 r_bins, p_bins, hitmiss, min_rho, max_rho, inv_base_sigma,
                 inv_r_bins, inv_2pi, out};
  const long long bytes = describe_smem(b, r_bins * p_bins);
  int err = set_smem((const void*)features_describe_kernel, bytes,
                     g_describe_smem);
  if (err) return err;
  features_describe_kernel<<<(unsigned)(n * f), threads, bytes,
                             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The match of p pairs (ref set -> mov set, hypotheses from u), and with
// gate != 0 the odometry gate and the paired pseudo-cells.  cluster:
// blocks a pair (1 to kMaxMatchCluster; the bits do not depend on it).
int ndtg_match_features(
    const float* ref_pts, const uint8_t* ref_mask, const float* ref_desc,
    const float* mov_pts, const uint8_t* mov_mask, const float* mov_desc,
    const float* u, long long s_ref_pts, long long s_ref_mask,
    long long s_ref_desc, long long s_mov_pts, long long s_mov_mask,
    long long s_mov_desc, long long s_u, long long p, int f1, int f2, int d,
    int c, int m, int budget, int adaptive, float acc, float dist_thr,
    float rig4, float w0, float log1mp, float eps, const float* sp,
    const float* tm, const float* prev, long long s_sp, long long s_tm,
    long long s_prev, int gate, int check, float max_t, float max_r,
    float cov_xy, float* T, float* score, int* n_in, long long* corr_ref,
    long long* corr_mov, uint8_t* corr_mask, uint8_t* inlier, uint8_t* valid,
    float* src, float* tgt, float* covs, uint8_t* pair_mask, int cluster,
    void* stream) {
  if (f1 < 1 || f2 < 1 || d < 1 || c < 1 || m < 1 || cluster < 1 ||
      cluster > kMaxMatchCluster || p < 1 || p * cluster > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  MatchArgs a{ref_pts, ref_mask, ref_desc, mov_pts, mov_mask, mov_desc, u,
              s_ref_pts, s_ref_mask, s_ref_desc, s_mov_pts, s_mov_mask,
              s_mov_desc, s_u, f1, f2, d, c, m, budget, adaptive, cluster, acc,
              dist_thr, rig4, w0, log1mp, eps, sp, tm, prev, s_sp, s_tm,
              s_prev, gate, check, max_t, max_r, cov_xy, T, score, n_in,
              corr_ref, corr_mov, corr_mask, inlier, valid, src, tgt, covs,
              pair_mask};
  const long long bytes = match_smem(f1, f2, d, c, m, cluster);
  int err = set_smem((const void*)features_match_kernel, bytes, g_match_smem);
  if (err) return err;
  return ndtg::launch_cluster(features_match_kernel,
                              dim3((unsigned)(p * cluster)), kMatchThreads,
                              cluster, (size_t)bytes, (cudaStream_t)stream, a);
}

int ndtg_features_math_probe(const float* a, const float* b, float* out,
                             long long n, int f, void* stream) {
  if (n < 1) return 0;
  features_math_probe_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                               (cudaStream_t)stream>>>(a, b, out, n, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
