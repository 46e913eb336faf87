// Hopper (sm_90a) kernels of the scan's feature front end (features/
// detector.py detect, features/descriptor.py describe, features/ransac.py
// match_sets and the odometry gate of fusion/feature_fuser.py, through
// ops/cuda_kernels.py detect_features, describe_features and
// match_features):
//
//   * features_detect_kernel: the multi-scale curvature detector, one
//     block a scan;
//   * features_describe_kernel: the beta-grid descriptor, one block a
//     (scan, feature);
//   * features_match_kernel: the descriptor chi2 matrix, the
//     correspondences, the two-point RANSAC hypotheses with their MSAC
//     scores, the winner's two Procrustes refinements and, where asked,
//     the odometry-consistency gate and the paired pseudo-cells of the
//     joint registration, one block a pair.
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
// KB a scan.  chip_smoke.py prints the bound of each run's inputs.
//
// Built with the other sources into one library (ops/cuda_kernels.py
// build): nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// fast math; bound through the plain C interface at the bottom.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDetectThreads = 256;
constexpr int kDescribeThreads = 128;
constexpr int kMatchThreads = 256;
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

// The first index k in [0, n) with arc[k] >= v, else n: searchsorted's
// left side (ATen's and jnp's lower bound).
__device__ __forceinline__ int lower_bound(const float* arc, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(arc[mid] >= v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ------------------------------------------------------------------ detect

struct DetectArgs {
  const float* ranges;     // (N, B)
  const uint8_t* hit;      // (N, B)
  const float* cosb;       // (B,) torch.cos of the beam angles
  const float* sinb;
  int b, s, half, f;
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

__host__ __device__ inline long long detect_smem(int b, int s) {
  return 32 * 8 + (long long)b * (8 + 8 + 8LL * s + 4LL * s + 4 + 4 + 4 + 2);
}

// One block a scan (blockIdx.x).  Shared memory, per beam: the point as
// two float64 (the window sums' operands), the smoothed point and the
// response of every scale, the cumulative arc, the polyline piece, the
// best peak response, the hit bit and the best scale.
__global__ void __launch_bounds__(kDetectThreads)
features_detect_kernel(DetectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.b, S = a.s;
  double* dbuf = reinterpret_cast<double*>(smem);
  double* pxd = dbuf + 32;
  double* pyd = pxd + B;
  float2* smv = reinterpret_cast<float2*>(pyd + B);      // (S, B)
  float* resp = reinterpret_cast<float*>(smv + (size_t)S * B);  // (S, B)
  float* cum = resp + (size_t)S * B;
  int* sid = reinterpret_cast<int*>(cum + B);
  float* best = reinterpret_cast<float*>(sid + B);
  uint8_t* hitv = reinterpret_cast<uint8_t*>(best + B);
  uint8_t* bsc = hitv + B;
  int* ibuf = reinterpret_cast<int*>(dbuf);

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t scan = blockIdx.x;
  const float* rng = a.ranges + scan * B;
  const uint8_t* hg = a.hit + scan * B;

  for (int i = tid; i < B; i += nt) {
    const float r = rng[i];
    pxd[i] = (double)mul(r, a.cosb[i]);
    pyd[i] = (double)mul(r, a.sinb[i]);
    hitv[i] = hg[i] != 0;
  }
  __syncthreads();

  // The segment lengths and the jumps, then both prefix sums: each
  // thread a contiguous run of beams, the runs' totals scanned over the
  // block.
  const int per = (B + nt - 1) / nt;
  const int lo = min(tid * per, B), hi = min(lo + per, B);
  auto seg_of = [&](int i) -> float {
    if (i == 0) return 0.0f;
    return norm2(sub((float)pxd[i], (float)pxd[i - 1]),
                 sub((float)pyd[i], (float)pyd[i - 1]));
  };
  auto jump_of = [&](int i) -> int {
    const bool far = i > 0 && fabsf(sub(rng[i], rng[i - 1])) > 0.5f;
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
    cum[i] = (float)doff;
    sid[i] = joff;
  }
  __syncthreads();

  // Gaussian smoothing over the arc, every scale in one pass over the
  // window: w = exp(-0.5 (darc / sigma)^2) on the same piece, the sums
  // of w, w x and w y in float64, then (sum w p) / max(sum w, 1e-9).
  for (int i = tid; i < B; i += nt) {
    const float ci = cum[i];
    const int si = sid[i];
    double ws[kMaxScales], sx[kMaxScales], sy[kMaxScales];
#pragma unroll
    for (int k = 0; k < kMaxScales; ++k) ws[k] = sx[k] = sy[k] = 0.0;
    for (int off = -a.half; off <= a.half; ++off) {
      const int j = min(max(i + off, 0), B - 1);
      if (sid[j] != si || !hitv[j]) continue;     // weight 0
      const float d = fabsf(sub(cum[j], ci));
      const double xj = pxd[j], yj = pyd[j];
#pragma unroll
      for (int k = 0; k < kMaxScales; ++k) {
        if (k < S) {
          const float q = mul(d, a.inv_sigma[k]);
          const double w = (double)expf(mul(mul(q, q), -0.5f));
          ws[k] += w;
          sx[k] = fma(w, xj, sx[k]);
          sy[k] = fma(w, yj, sy[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxScales; ++k) {
      if (k < S) {
        const double wsum = ws[k] < 1e-9 ? 1e-9 : ws[k];
        smv[(size_t)k * B + i] = make_float2((float)(sx[k] / wsum),
                                             (float)(sy[k] / wsum));
      }
    }
  }
  __syncthreads();
  if (a.smoothed) {
    for (int it = tid; it < S * B; it += nt) {
      a.smoothed[(scan * S * B + it) * 2] = smv[it].x;
      a.smoothed[(scan * S * B + it) * 2 + 1] = smv[it].y;
    }
    for (int i = tid; i < B; i += nt) a.arcs[scan * B + i] = cum[i];
  }

  // The turning angle between the smoothed points one sigma of arc
  // ahead and behind, and its validity.
  for (int it = tid; it < S * B; it += nt) {
    const int k = it / B, i = it - k * B;
    const float ci = cum[i];
    const int fwd = min(lower_bound(cum, B, add(ci, a.sigma[k])), B - 1);
    const int bwd = min(lower_bound(cum, B, sub(ci, a.sigma[k])), B - 1);
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
    resp[it] = ok ? curv : 0.0f;
  }
  __syncthreads();

  // Strict peaks (the neighbours wrap around the scan), then the best
  // scale: the first maximum.
  int npos = 0;
  for (int i = tid; i < B; i += nt) {
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
    best[i] = bv;
    bsc[i] = (uint8_t)bs;
  }
  __syncthreads();

  // The top `f` beams, in a stable descending order (a lower index first
  // among equal values): a positive response's rank is the count of
  // larger values and of equal ones before it; the zeros follow every
  // positive one in beam order (their rank: the positives' count and the
  // zeros before them, a prefix count over the block).
  int zsum = 0;
  for (int i = lo; i < hi; ++i) {
    zsum += best[i] > 0.0f ? 0 : 1;
    npos += best[i] > 0.0f ? 1 : 0;
  }
  int ztotal, ptotal;
  int zoff = block_exclusive_scan(zsum, ibuf, &ztotal);
  block_exclusive_scan(npos, ibuf, &ptotal);
  for (int i = lo; i < hi; ++i) {
    const float v = best[i];
    int rank;
    if (v > 0.0f) {
      rank = 0;
      for (int j = 0; j < B; ++j) {
        const float w = best[j];
        rank += (w > v || (w == v && j < i)) ? 1 : 0;
      }
    } else {
      rank = ptotal + zoff;
      ++zoff;
    }
    if (rank >= a.f) continue;
    // The selected beam's tangent at its best scale, its normal facing
    // the sensor, and the wrapped orientation.
    const int k = bsc[i];
    const float ci = cum[i];
    const int fwd = min(lower_bound(cum, B, add(ci, a.sigma[k])), B - 1);
    const int bwd = min(lower_bound(cum, B, sub(ci, a.sigma[k])), B - 1);
    const float2* sm = smv + (size_t)k * B;
    const float tx = sub(sm[fwd].x, sm[bwd].x);
    const float ty = sub(sm[fwd].y, sm[bwd].y);
    float na = atan2f(tx, -ty);
    const float px = (float)pxd[i], py = (float)pyd[i];
    const float toward = add(mul(cosf(na), -px), mul(sinf(na), -py));
    if (toward < 0.0f) na = add(na, kPi);
    const size_t o = scan * a.f + rank;
    a.pts[2 * o] = px;
    a.pts[2 * o + 1] = py;
    a.angles[o] = wrap_angle(na);
    a.scales[o] = a.sigma[k];
    a.response[o] = v;
    a.mask[o] = v > 0.0f;
  }
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

// One block a (scan, feature): blockIdx.x = scan * F + feature.  Each
// thread keeps its own bins in shared memory ([bin][thread]: integer hit
// counts, float miss weights added in its beams' order), then a fixed
// tree over the threads adds them.
__global__ void __launch_bounds__(kDescribeThreads)
features_describe_kernel(DescribeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int nb = a.r_bins * a.p_bins;
  float* mb = reinterpret_cast<float*>(smem);                  // (nb, T)
  int* hb = reinterpret_cast<int*>(mb + (size_t)nb * T);      // (nb, T)
  __shared__ float tot[2];

  const size_t item = blockIdx.x;
  const size_t scan = item / a.f;
  const int B = a.b;
  for (int n = 0; n < nb; ++n) {
    mb[n * T + tid] = 0.0f;
    hb[n * T + tid] = 0;
  }

  if (a.fmask[item]) {
    const float fx = a.fpts[2 * item], fy = a.fpts[2 * item + 1];
    const float fa = a.fang[item];
    const float ca = cosf(-fa), sa = sinf(-fa);
    const float sup = fminf(
        fmaxf(mul(a.max_rho,
                  __fsqrt_rn(clamp_min(mul(a.fscale[item], a.inv_base_sigma),
                                       1.0f))),
              a.max_rho),
        4.0f * a.max_rho);
    const float rden = sub(sup, a.min_rho);
    const float bin_w = clamp_min(mul(rden, a.inv_r_bins), 1e-6f);
    const float p2 = add(mul(fx, fx), mul(fy, fy));
    const float sup2 = mul(sup, sup);
    const float* rng = a.ranges + scan * B;
    const uint8_t* hg = a.hit + scan * B;
    for (int bm = tid; bm < B; bm += T) {
      const float r = rng[bm];
      const float dx = a.cosb[bm], dy = a.sinb[bm];
      bool ok;
      if (hg[bm]) {
        const int n = polar_bin(sub(mul(r, dx), fx), sub(mul(r, dy), fy), ca,
                                sa, rden, a.min_rho, a.r_bins, a.p_bins,
                                a.inv_2pi, &ok);
        if (ok) hb[n * T + tid] += 1;
      }
      // The beam's chord through the support circle, 8 samples on it.
      const float dp = dot2(dx, fx, dy, fy);
      const float disc = add(sub(mul(dp, dp), p2), sup2);
      const float root = __fsqrt_rn(clamp_min(disc, 0.0f));
      const float t0 = clamp_min(sub(dp, root), 0.0f);
      const float t1 = minimum(add(dp, root), mul(r, 0.999f));
      const float chord = clamp_min(sub(t1, t0), 0.0f);
      if (!(disc > 0.0f) || !(chord > 1e-6f)) continue;
      const float w = fdiv(mul(chord, 0.125f), bin_w);
      for (int k = 0; k < 8; ++k) {
        const float ts = add(t0, mul(chord, ((float)k + 0.5f) * 0.125f));
        const int n = polar_bin(sub(mul(ts, dx), fx), sub(mul(ts, dy), fy),
                                ca, sa, rden, a.min_rho, a.r_bins, a.p_bins,
                                a.inv_2pi, &ok);
        if (ok) mb[n * T + tid] = add(mb[n * T + tid], w);
      }
    }
  }
  __syncthreads();
  for (int stride = T >> 1; stride > 0; stride >>= 1) {
    for (int it = tid; it < nb * stride; it += T) {
      const int n = it / stride, t = it - n * stride;
      mb[n * T + t] = add(mb[n * T + t], mb[n * T + t + stride]);
      hb[n * T + t] += hb[n * T + t + stride];
    }
    __syncthreads();
  }
  float* out = a.out + item * (size_t)(a.hitmiss ? 2 * nb : nb);
  if (!a.hitmiss) {
    for (int n = tid; n < nb; n += T) {
      const float h = (float)hb[n * T], m = mb[n * T];
      out[n] = fdiv(add(h, 1.0f), add(add(h, m), 2.0f));
    }
    return;
  }
  if (tid == 0) {
    float hs = 0.0f, ms = 0.0f;
    for (int n = 0; n < nb; ++n) {
      hs = add(hs, (float)hb[n * T]);
      ms = add(ms, mb[n * T]);
    }
    tot[0] = clamp_min(hs, 1e-9f);
    tot[1] = clamp_min(ms, 1e-9f);
  }
  __syncthreads();
  for (int n = tid; n < nb; n += T) {
    out[n] = mul(0.5f, fdiv((float)hb[n * T], tot[0]));
    out[nb + n] = mul(0.5f, fdiv(mb[n * T], tot[1]));
  }
}

// ------------------------------------------------------------------- match

struct MatchArgs {
  const float* ref_pts;  const uint8_t* ref_mask;  const float* ref_desc;
  const float* mov_pts;  const uint8_t* mov_mask;  const float* mov_desc;
  const float* u;
  long long s_ref_pts, s_ref_mask, s_ref_desc;     // elements a pair
  long long s_mov_pts, s_mov_mask, s_mov_desc, s_u;
  int f1, f2, d, c, m, budget, adaptive;
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

__host__ __device__ inline long long match_smem(int f1, int f2, int d, int c,
                                                int m) {
  return 4LL * ((long long)(f1 + f2) * d + (long long)f1 * f2 + 2 * f2 +
                2 * (f1 + f2) + 2 * c + 5 * c + 5 * m) +
         (f1 + f2) + c + 64;
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
// se2.transform_points: the rotation as torch's einsum, then the shift.
__device__ __forceinline__ float2 transform(Pose p, float x, float y) {
  const float c = cosf(p.t), s = sinf(p.t);
  return make_float2(add(dot2(c, x, -s, y), p.x), add(dot2(s, x, c, y), p.y));
}
// ransac._apply: c x - s y + t0, s x + c y + t1.
__device__ __forceinline__ float residual2(float c, float s, float tx,
                                           float ty, float ax, float ay,
                                           float bx, float by) {
  const float px = add(sub(mul(c, bx), mul(s, by)), tx);
  const float py = add(add(mul(s, bx), mul(c, by)), ty);
  const float dx = sub(ax, px), dy = sub(ay, py);
  return add(mul(dx, dx), mul(dy, dy));
}
// The warp's sum of one value a lane: a butterfly (offsets 16 .. 1),
// every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One block a pair (blockIdx.x).  Thread m scores hypothesis m (and
// m + blockDim.x, ...); warp 0 refines the winner and writes the result.
__global__ void __launch_bounds__(kMatchThreads)
features_match_kernel(MatchArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F1 = a.f1, F2 = a.f2, D = a.d, C = a.c, M = a.m;
  float* an = reinterpret_cast<float*>(smem);        // (F1, D)
  float* bn = an + (size_t)F1 * D;                   // (F2, D)
  float* dist = bn + (size_t)F2 * D;                 // (F1, F2)
  float* bd = dist + (size_t)F1 * F2;                // (F2,)
  int* bref = reinterpret_cast<int*>(bd + F2);       // (F2,)
  float* rp = reinterpret_cast<float*>(bref + F2);   // (F1, 2)
  float* mp = rp + 2 * F1;                           // (F2, 2)
  float* ca = mp + 2 * F2;                           // (C, 2)
  float* cb = ca + 2 * C;                            // (C, 2)
  float* cd = cb + 2 * C;                            // (C,)
  int* cmov = reinterpret_cast<int*>(cd + C);        // (C,)
  float* msac = reinterpret_cast<float*>(cmov + C);  // (M,)
  float* hyp = msac + M;                             // (M, 3)
  float* ratio = hyp + 3 * M;                        // (M,)
  uint8_t* rm = reinterpret_cast<uint8_t*>(ratio + M);
  uint8_t* mm = rm + F1;
  uint8_t* cm = mm + F2;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int n_valid;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t pair = blockIdx.x;
  const float inf = __int_as_float(0x7f800000);

  {
    const float* g = a.ref_pts + pair * a.s_ref_pts;
    for (int i = tid; i < 2 * F1; i += nt) rp[i] = g[i];
    g = a.mov_pts + pair * a.s_mov_pts;
    for (int i = tid; i < 2 * F2; i += nt) mp[i] = g[i];
    const uint8_t* k = a.ref_mask + pair * a.s_ref_mask;
    for (int i = tid; i < F1; i += nt) rm[i] = k[i] != 0;
    k = a.mov_mask + pair * a.s_mov_mask;
    for (int i = tid; i < F2; i += nt) mm[i] = k[i] != 0;
    g = a.ref_desc + pair * a.s_ref_desc;
    for (int i = tid; i < F1 * D; i += nt) an[i] = g[i];
    g = a.mov_desc + pair * a.s_mov_desc;
    for (int i = tid; i < F2 * D; i += nt) bn[i] = g[i];
  }
  __syncthreads();
  // Each descriptor row over its sum (in order), clamped at eps.
  for (int r = tid; r < F1 + F2; r += nt) {
    float* row = r < F1 ? an + (size_t)r * D : bn + (size_t)(r - F1) * D;
    float s = 0.0f;
    for (int k = 0; k < D; ++k) s = add(s, row[k]);
    s = clamp_min(s, a.eps);
    for (int k = 0; k < D; ++k) row[k] = fdiv(row[k], s);
  }
  __syncthreads();
  // The symmetric chi2 distances, inf where either feature is padding.
  for (int it = tid; it < F1 * F2; it += nt) {
    const int i = it / F2, j = it - i * F2;
    float v = inf;
    if (rm[i] && mm[j]) {
      const float* p = an + (size_t)i * D;
      const float* q = bn + (size_t)j * D;
      float s = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float df = sub(p[k], q[k]);
        s = add(s, fdiv(mul(df, df), add(add(p[k], q[k]), a.eps)));
      }
      v = mul(0.5f, s);
    }
    dist[it] = v;
  }
  __syncthreads();
  // Each moving feature's nearest reference feature (the first minimum).
  for (int j = tid; j < F2; j += nt) {
    float bv = dist[j];
    int bi = 0;
    for (int i = 1; i < F1; ++i) {
      const float v = dist[(size_t)i * F2 + j];
      if (v < bv) {
        bv = v;
        bi = i;
      }
    }
    bd[j] = bv;
    bref[j] = bi;
  }
  __syncthreads();
  // The C nearest, in a stable ascending order (padded with feature 0 at
  // distance inf when F2 < C).
  const int cs = min(C, F2);
  for (int j = tid; j < F2; j += nt) {
    const float v = bd[j];
    int rank = 0;
    for (int k = 0; k < F2; ++k) {
      const float w = bd[k];
      rank += (w < v || (w == v && k < j)) ? 1 : 0;
    }
    if (rank < cs) {
      cmov[rank] = j;
      cd[rank] = v;
    }
  }
  for (int c = cs + tid; c < C; c += nt) {
    cmov[c] = 0;
    cd[c] = inf;
  }
  __syncthreads();
  for (int c = tid; c < C; c += nt) {
    const int j = cmov[c], i = bref[j];
    cm[c] = cd[c] < a.dist_thr;
    ca[2 * c] = rp[2 * i];
    ca[2 * c + 1] = rp[2 * i + 1];
    cb[2 * c] = mp[2 * j];
    cb[2 * c + 1] = mp[2 * j + 1];
    a.corr_ref[pair * C + c] = i;
    a.corr_mov[pair * C + c] = j;
    a.corr_mask[pair * C + c] = cm[c];
  }
  if (warp == 0) {
    int n = 0;
    for (int c = lane; c < C; c += 32) n += (cd[c] < a.dist_thr) ? 1 : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (lane == 0) n_valid = n;
  }
  __syncthreads();

  // The hypotheses: a pair of correspondences from the draws, the
  // two-point fit, its rigidity and validity, the MSAC score over the C
  // correspondences in order.
  const float nvf = clamp_min((float)n_valid, 1.0f);
  const float* ug = a.u + pair * a.s_u;
  for (int m = tid; m < M; m += nt) {
    long long i0 = floor_i64(mul(ug[2 * m], nvf));
    long long i1 = floor_i64(mul(ug[2 * m + 1], nvf));
    i0 = i0 < 0 ? 0 : (i0 > C - 1 ? C - 1 : i0);
    i1 = i1 < 0 ? 0 : (i1 > C - 1 ? C - 1 : i1);
    const float a0x = ca[2 * i0], a0y = ca[2 * i0 + 1];
    const float b0x = cb[2 * i0], b0y = cb[2 * i0 + 1];
    const float dax = sub(ca[2 * i1], a0x), day = sub(ca[2 * i1 + 1], a0y);
    const float dbx = sub(cb[2 * i1], b0x), dby = sub(cb[2 * i1 + 1], b0y);
    const float seg_len = norm2(dbx, dby);
    const float theta = sub(atan2f(day, dax), atan2f(dby, dbx));
    const float ch = cosf(theta), sh = sinf(theta);
    const float tx = sub(a0x, sub(mul(ch, b0x), mul(sh, b0y)));
    const float ty = sub(a0y, add(mul(sh, b0x), mul(ch, b0y)));
    const float ld = sub(seg_len, norm2(dax, day));
    const bool ok = seg_len > 0.2f && mul(ld, ld) < a.rig4 && cm[i0] &&
                    cm[i1] && i0 != i1;
    float s = 0.0f;
    int inl = 0;
    for (int c = 0; c < C; ++c) {
      const float r2 = residual2(ch, sh, tx, ty, ca[2 * c], ca[2 * c + 1],
                                 cb[2 * c], cb[2 * c + 1]);
      s = add(s, clamp_max(cm[c] ? r2 : a.acc, a.acc));
      inl += (r2 < a.acc && cm[c]) ? 1 : 0;
    }
    msac[m] = (ok && m < a.budget) ? s : inf;
    hyp[3 * m] = tx;
    hyp[3 * m + 1] = ty;
    hyp[3 * m + 2] = theta;
    ratio[m] = ok ? fdiv((float)inl, nvf) : 0.0f;
  }
  __syncthreads();
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
      if (msac[m] < bv || (msac[m] == bv && m < bi)) {
        bv = msac[m];
        bi = m;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov < bv || (ov == bv && oi < bi)) {
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
  if (warp != 0) return;
  int win = red_i[0];
  float wv = red_v[0];
  for (int w = 1; w < (nt + 31) / 32; ++w) {
    if (red_v[w] < wv || (red_v[w] == wv && red_i[w] < win)) {
      wv = red_v[w];
      win = red_i[w];
    }
  }
  if (win >= M) win = 0;
  const bool any_hyp = fabsf(msac[win]) < inf;
  float T0 = hyp[3 * win], T1 = hyp[3 * win + 1], T2 = hyp[3 * win + 2];

  // Two weighted Procrustes fits on the inliers under the current pose.
  for (int rep = 0; rep < 2; ++rep) {
    const float c0 = cosf(T2), s0 = sinf(T2);
    float sw = 0.0f, sax = 0.0f, say = 0.0f, sbx = 0.0f, sby = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float ax = ca[2 * c], ay = ca[2 * c + 1];
      const float bx = cb[2 * c], by = cb[2 * c + 1];
      const float r2 = residual2(c0, s0, T0, T1, ax, ay, bx, by);
      const float w = (r2 < a.acc && cm[c]) ? 1.0f : 0.0f;
      cd[c] = w;
      sw = add(sw, w);
      sax = add(sax, mul(ax, w));
      say = add(say, mul(ay, w));
      sbx = add(sbx, mul(bx, w));
      sby = add(sby, mul(by, w));
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
      const float a0x = sub(ca[2 * c], cax), a0y = sub(ca[2 * c + 1], cay);
      const float b0x = sub(cb[2 * c], cbx), b0y = sub(cb[2 * c + 1], cby);
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
  }
  if (!any_hyp) T0 = T1 = T2 = 0.0f;

  // The result under the fitted pose, then the gate.
  const float c0 = cosf(T2), s0 = sinf(T2);
  float sc = 0.0f;
  int n_in = 0;
  for (int c = lane; c < C; c += 32) {
    const float r2 = residual2(c0, s0, T0, T1, ca[2 * c], ca[2 * c + 1],
                               cb[2 * c], cb[2 * c + 1]);
    const bool in = r2 < a.acc && cm[c] && any_hyp;
    cd[c] = in ? 1.0f : 0.0f;
    a.inlier[pair * C + c] = in;
    n_in += in ? 1 : 0;
    sc = add(sc, cm[c] ? clamp_max(r2, a.acc) : a.acc);
  }
  sc = warp_sum(sc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n_in += __shfl_xor_sync(kFull, n_in, o);
  const bool valid = any_hyp && n_in >= 2;
  if (lane == 0) {
    a.T[3 * pair] = T0;
    a.T[3 * pair + 1] = T1;
    a.T[3 * pair + 2] = T2;
    a.score[pair] = sc;
    a.n_in[pair] = n_in;
    a.valid[pair] = valid;
  }
  if (!a.gate) return;
  const float* g = a.sp + pair * a.s_sp;
  const Pose sp{g[0], g[1], g[2]};
  g = a.tm + pair * a.s_tm;
  const Pose tm{g[0], g[1], g[2]};
  g = a.prev + pair * a.s_prev;
  const Pose prev{g[0], g[1], g[2]};
  // RANSAC's T maps the current sensor frame onto the previous one:
  // compare it with the odometry in the vehicle frame.
  const Pose diff =
      relative(compose(compose(sp, Pose{T0, T1, T2}), inverse(sp)), tm);
  const bool consistent =
      (norm2(diff.x, diff.y) <= a.max_t && fabsf(diff.t) <= a.max_r) ||
      !a.check;
  const bool feats_ok = valid && consistent;
  const Pose world_prev = compose(prev, sp);
  for (int c = lane; c < C; c += 32) {
    const size_t o = pair * C + c;
    const float2 t = transform(world_prev, ca[2 * c], ca[2 * c + 1]);
    const float2 s = transform(sp, cb[2 * c], cb[2 * c + 1]);
    a.tgt[2 * o] = t.x;
    a.tgt[2 * o + 1] = t.y;
    a.src[2 * o] = s.x;
    a.src[2 * o + 1] = s.y;
    a.covs[4 * o] = a.cov_xy;
    a.covs[4 * o + 1] = 0.0f;
    a.covs[4 * o + 2] = 0.0f;
    a.covs[4 * o + 3] = a.cov_xy;
    a.pair_mask[o] = cd[c] != 0.0f && feats_ok;
  }
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
long long ndtg_match_smem(int f1, int f2, int d, int c, int m) {
  return match_smem(f1, f2, d, c, m);
}

// pts (N, F, 2), angles / scales / response (N, F), mask (N, F): the top
// f interest points of each of the n scans (ranges, hit (N, B)).
// sigmas: the s scales as float64 (host memory).  arcs (N, B) and smoothed
// (N, S, B, 2): null, or the cumulative arc and the smoothed points.
int ndtg_detect_features(const float* ranges, const uint8_t* hit,
                         const float* cosb, const float* sinb, long long n,
                         int b, int s, int half, int f, const double* sigmas,
                         float peak_min_diff, float peak_min_value,
                         float* pts, float* angles, float* scales,
                         float* response, uint8_t* mask, float* arcs,
                         float* smoothed, void* stream) {
  if (s < 1 || s > kMaxScales || b < 1 || f < 1 || f > b || half < 0)
    return (int)cudaErrorInvalidValue;
  DetectArgs a{ranges, hit, cosb, sinb, b, s, half, f, {}, {},
               peak_min_diff, peak_min_value, pts, angles, scales, response,
               mask, arcs, smoothed};
  for (int k = 0; k < s; ++k) {
    a.sigma[k] = (float)sigmas[k];
    a.inv_sigma[k] = (float)(1.0 / sigmas[k]);
  }
  const long long bytes = detect_smem(b, s);
  int err = set_smem((const void*)features_detect_kernel, bytes, g_detect_smem);
  if (err) return err;
  features_detect_kernel<<<(unsigned)n, kDetectThreads, bytes,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out (N, F, D): the descriptor of each feature of each of the n scans.
int ndtg_describe_features(const float* ranges, const uint8_t* hit,
                           const float* cosb, const float* sinb,
                           const float* fpts, const float* fang,
                           const float* fscale, const uint8_t* fmask,
                           long long n, int b, int f, int r_bins, int p_bins,
                           int hitmiss, float min_rho, float max_rho,
                           float inv_base_sigma, float inv_r_bins,
                           float inv_2pi, float* out, void* stream) {
  if (r_bins < 1 || p_bins < 1 || r_bins * p_bins > kMaxBins)
    return (int)cudaErrorInvalidValue;
  DescribeArgs a{ranges, hit, cosb, sinb, fpts, fang, fscale, fmask, b, f,
                 r_bins, p_bins, hitmiss, min_rho, max_rho, inv_base_sigma,
                 inv_r_bins, inv_2pi, out};
  const long long bytes = (long long)r_bins * p_bins * kDescribeThreads * 8;
  int err = set_smem((const void*)features_describe_kernel, bytes,
                     g_describe_smem);
  if (err) return err;
  features_describe_kernel<<<(unsigned)(n * f), kDescribeThreads, bytes,
                             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The match of p pairs (ref set -> mov set, hypotheses from u), and with
// gate != 0 the odometry gate and the paired pseudo-cells.
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
    float* src, float* tgt, float* covs, uint8_t* pair_mask, void* stream) {
  if (f1 < 1 || f2 < 1 || d < 1 || c < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  MatchArgs a{ref_pts, ref_mask, ref_desc, mov_pts, mov_mask, mov_desc, u,
              s_ref_pts, s_ref_mask, s_ref_desc, s_mov_pts, s_mov_mask,
              s_mov_desc, s_u, f1, f2, d, c, m, budget, adaptive, acc,
              dist_thr, rig4, w0, log1mp, eps, sp, tm, prev, s_sp, s_tm,
              s_prev, gate, check, max_t, max_r, cov_xy, T, score, n_in,
              corr_ref, corr_mov, corr_mask, inlier, valid, src, tgt, covs,
              pair_mask};
  const long long bytes = match_smem(f1, f2, d, c, m);
  int err = set_smem((const void*)features_match_kernel, bytes, g_match_smem);
  if (err) return err;
  features_match_kernel<<<(unsigned)p, kMatchThreads, bytes,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int ndtg_features_math_probe(const float* a, const float* b, float* out,
                             long long n, int f, void* stream) {
  if (n < 1) return 0;
  features_math_probe_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                               (cudaStream_t)stream>>>(a, b, out, n, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
