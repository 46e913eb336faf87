// Hopper (sm_90a) kernels for the SE(2) D2D score / gradient / Hessian
// reduction of NDT registration.
//
// Replaces: ndt_feature_graph_tpu/ops/pallas_kernels.py:pair_fgh_reduce
// (body _kernel, pair algebra _fgh_components), and in front of it the
// window gather + masking of d2d_analytic.fgh_dense_flat
// (ops/d2d.py:gather_windows_flat).
//
// What bounds it on the H100: at the main path's shapes (N = 256 source
// cells x K = 25 window cells = 6,400 pairs per Newton trial) one call
// is ~1 MFLOP of f32 pair algebra and ~205 KB of 32-byte table rows,
// mostly served from L2 (the whole 1.28 MB packed table fits in the
// 50 MB L2).  That is microseconds of work at the card's rates: the
// call is bound by launch latency, not by FLOPs or bytes.
//
// What the design does about it: one fused launch per Newton trial
// computes the trial pose, moves every source cell, gathers its window
// rows (two float4 loads per row), masks, evaluates the pair algebra
// and reduces — no per-pair intermediate ever reaches device memory.
// The reduction is deterministic (no float atomics): warp shuffles,
// then a fixed-order sum over the warps of a block into a (blocks, 10)
// scratch, then a second tiny launch sums the block partials in block
// order.  Repeated runs give bit-identical poses.
//
// The batched entry (fgh_dense_flat_batch) is the same term for B lanes
// of loop-closure link refinement (d2d_analytic.fgh_dense_flat_batch in
// the JAX package): a (pair blocks, B) grid over one flat (N*H*W, 8)
// bank, each lane with its own increment, initial pose, source list,
// target origin and 64-bit row offset, then one summing block per lane.
// At the offline shapes (~190 pairs x 256 source cells x 25 window
// cells, ~1.2 M pairs per trial) a call is ~0.2 GFLOP and ~39 MB of
// rows, gathered from a bank of a few tens of MB that largely stays in
// L2: still far from either roofline, so the design keeps the main
// path's fusion (no intermediate in device memory) and its fixed-order,
// atomic-free reduction.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -shared -Xcompiler -fPIC (no --use_fast_math: expf and the divisions
// stay IEEE f32) and bound through the plain C interface at the bottom.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kComps = 10;   // s, g0..g2, h00 h01 h02 h11 h12 h22

// Per-pair (s, g0..g2, h00, h01, h02, h11, h12, h22); mirrors
// pallas_kernels._fgh_components term by term.
__device__ __forceinline__ void pair_components(
    float mu_x, float mu_y, float s00, float s01, float s11,
    float mx, float my, float c00, float c01, float c11,
    float lfd1, float lfd2, float* out) {
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
  out[0] = -lfd1 * E;
  out[1] = k * q_x;
  out[2] = k * q_y;
  out[3] = k * q_t;
  out[4] = k * (h_xx - alpha * q_x * q_x);
  out[5] = k * (h_xy - alpha * q_x * q_y);
  out[6] = k * (h_xt - alpha * q_x * q_t);
  out[7] = k * (h_yy - alpha * q_y * q_y);
  out[8] = k * (h_yt - alpha * q_y * q_t);
  out[9] = k * (h_tt - alpha * q_t * q_t);
}

// Sum each of the 10 components over the block in a fixed order and
// write the block's partials.  Every thread of the block must call it.
__device__ __forceinline__ void block_reduce_store(float* v,
                                                   float* partials) {
  __shared__ float warp_sums[kWarps][kComps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kComps; ++c) {
    float x = v[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) warp_sums[warp][c] = x;
  }
  __syncthreads();
  if (threadIdx.x < kComps) {
    float acc = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) acc += warp_sums[wi][threadIdx.x];
    partials[blockIdx.x * kComps + threadIdx.x] = acc;
  }
}

// D2D window term of pair `t` = (source cell, window cell) of one lane:
// adds its 10 components to v when the pair is valid.
__device__ __forceinline__ void window_pair(
    const float* __restrict__ d, const float* __restrict__ T0,
    const float* __restrict__ means, const float* __restrict__ covs,
    const uint8_t* __restrict__ mask, const float* __restrict__ packed,
    const float* __restrict__ origin, long long row_offset, int n_src,
    int h, int w, float res, int nb, float lfd1, float lfd2, long long t,
    float* v) {
  const int win = 2 * nb + 1;
  const int kwin = win * win;
  if (t < (long long)n_src * kwin) {
    const int i = (int)(t / kwin);
    const int k = (int)(t % kwin);
    if (mask[i]) {
      // T = Trans(d_xy) Rot(d_t) o T0  (d2d._apply_increment).
      const float cd = cosf(d[2]), sd = sinf(d[2]);
      const float tx = d[0] + T0[0] * cd - T0[1] * sd;
      const float ty = d[1] + T0[0] * sd + T0[1] * cd;
      const float traw = d[2] + T0[2];
      const float tt = atan2f(sinf(traw), cosf(traw));
      const float c = cosf(tt), s = sinf(tt);

      // Moved source gaussian: mean' = R m + t, K = R C R^T.
      const float m0 = means[2 * i], m1 = means[2 * i + 1];
      const float mx = c * m0 - s * m1 + tx;
      const float my = s * m0 + c * m1 + ty;
      const float C00 = covs[4 * i], C01 = covs[4 * i + 1];
      const float C10 = covs[4 * i + 2], C11 = covs[4 * i + 3];
      const float rc00 = c * C00 - s * C10, rc01 = c * C01 - s * C11;
      const float rc10 = s * C00 + c * C10, rc11 = s * C01 + c * C11;
      const float k00 = rc00 * c - rc01 * s;
      const float k01 = rc00 * s + rc01 * c;
      const float k11 = rc10 * s + rc11 * c;

      // Window cell of this thread (dy-major, as gather_windows_flat).
      float rx = (mx - origin[0]) / res;
      float ry = (my - origin[1]) / res;
      rx = fminf(fmaxf(rx, -1.0e9f), 1.0e9f);
      ry = fminf(fmaxf(ry, -1.0e9f), 1.0e9f);
      const int ix = (int)floorf(rx) + (k % win - nb);
      const int iy = (int)floorf(ry) + (k / win - nb);
      const bool inb = iy >= 0 && iy < h && ix >= 0 && ix < w;
      const int cy = min(max(iy, 0), h - 1);
      const int cx = min(max(ix, 0), w - 1);
      const float4* row = reinterpret_cast<const float4*>(
          packed + (row_offset + (long long)cy * w + cx) * 8);
      const float4 r0 = __ldg(row);       // mean_x mean_y c00 c01
      const float4 r1 = __ldg(row + 1);   // c11 valid 0 0
      if (inb && r1.y > 0.5f) {
        pair_components(mx - r0.x, my - r0.y, k00 + r0.z, k01 + r0.w,
                        k11 + r1.x, mx - d[0], my - d[1], k00, k01, k11,
                        lfd1, lfd2, v);
      }
    }
  }
}

// D2D window term: one thread per (source cell, window cell) pair.
__global__ void __launch_bounds__(kThreads) fgh_dense_flat_kernel(
    const float* __restrict__ d, const float* __restrict__ T0,
    const float* __restrict__ means, const float* __restrict__ covs,
    const uint8_t* __restrict__ mask, const float* __restrict__ packed,
    const float* __restrict__ origin, long long row_offset, int n_src,
    int h, int w, float res, int nb, float lfd1, float lfd2,
    float* __restrict__ partials) {
  float v[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) v[c] = 0.0f;
  window_pair(d, T0, means, covs, mask, packed, origin, row_offset, n_src,
              h, w, res, nb, lfd1, lfd2,
              (long long)blockIdx.x * kThreads + threadIdx.x, v);
  block_reduce_store(v, partials);
}

// The same term for B lanes in one launch: blockIdx.y is the lane, whose
// increment, initial pose, source cells, target origin and row offset
// into the shared flat bank are its own; blockIdx.x walks its pairs.
// Each lane's block partials land in its own row of `partials`
// (lane * gridDim.x + blockIdx.x).
__global__ void __launch_bounds__(kThreads) fgh_dense_flat_batch_kernel(
    const float* __restrict__ d, const float* __restrict__ T0,
    const float* __restrict__ means, const float* __restrict__ covs,
    const uint8_t* __restrict__ mask, const float* __restrict__ packed,
    const float* __restrict__ origins,
    const long long* __restrict__ row_offsets, int n_src, int h, int w,
    float res, int nb, float lfd1, float lfd2,
    float* __restrict__ partials) {
  const long long lane = blockIdx.y;
  float v[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) v[c] = 0.0f;
  window_pair(d + 3 * lane, T0 + 3 * lane, means + lane * n_src * 2,
              covs + lane * n_src * 4, mask + lane * n_src, packed,
              origins + 2 * lane, row_offsets[lane], n_src, h, w, res, nb,
              lfd1, lfd2, (long long)blockIdx.x * kThreads + threadIdx.x, v);
  block_reduce_store(v, partials + lane * gridDim.x * kComps);
}

// Paired term: one thread per pair of flattened, broadcast inputs.
__global__ void __launch_bounds__(kThreads) pair_fgh_kernel(
    const float* __restrict__ mu, const float* __restrict__ sig,
    const float* __restrict__ m_rot, const float* __restrict__ crot,
    const uint8_t* __restrict__ ok, long long n_pairs, float lfd1,
    float lfd2, float* __restrict__ partials) {
  float v[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) v[c] = 0.0f;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p < n_pairs && ok[p]) {
    pair_components(mu[2 * p], mu[2 * p + 1], sig[4 * p], sig[4 * p + 1],
                    sig[4 * p + 3], m_rot[2 * p], m_rot[2 * p + 1],
                    crot[4 * p], crot[4 * p + 1], crot[4 * p + 3], lfd1,
                    lfd2, v);
  }
  block_reduce_store(v, partials);
}

// Fixed-order sum of the block partials, one block per lane:
// out[lane][c] = sum_b partials[lane][b][c].
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int n_blocks, float* __restrict__ out) {
  const long long lane = blockIdx.x;
  if (threadIdx.x < kComps) {
    const float* p = partials + lane * n_blocks * kComps;
    float acc = 0.0f;
    for (int b = 0; b < n_blocks; ++b) acc += p[b * kComps + threadIdx.x];
    out[lane * kComps + threadIdx.x] = acc;
  }
}

}  // namespace

extern "C" {

int ndtg_block_threads() { return kThreads; }

// Returns cudaGetLastError() after both launches (0 = success).
int ndtg_fgh_dense_flat(const float* d, const float* T0, const float* means,
                        const float* covs, const uint8_t* mask,
                        const float* packed, const float* origin,
                        long long row_offset, int n_src, int h, int w,
                        float res, int nb, float lfd1, float lfd2,
                        float* partials, int n_blocks, float* out,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fgh_dense_flat_kernel<<<n_blocks, kThreads, 0, st>>>(
      d, T0, means, covs, mask, packed, origin, row_offset, n_src, h, w, res,
      nb, lfd1, lfd2, partials);
  sum_partials_kernel<<<1, 32, 0, st>>>(partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// B lanes: partials (B, n_blocks, 10), out (B, 10).
int ndtg_fgh_dense_flat_batch(const float* d, const float* T0,
                              const float* means, const float* covs,
                              const uint8_t* mask, const float* packed,
                              const float* origins,
                              const long long* row_offsets, int n_lanes,
                              int n_src, int h, int w, float res, int nb,
                              float lfd1, float lfd2, float* partials,
                              int n_blocks, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fgh_dense_flat_batch_kernel<<<dim3(n_blocks, n_lanes), kThreads, 0, st>>>(
      d, T0, means, covs, mask, packed, origins, row_offsets, n_src, h, w,
      res, nb, lfd1, lfd2, partials);
  sum_partials_kernel<<<n_lanes, 32, 0, st>>>(partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

int ndtg_pair_fgh_reduce(const float* mu, const float* sig,
                         const float* m_rot, const float* crot,
                         const uint8_t* ok, long long n_pairs, float lfd1,
                         float lfd2, float* partials, int n_blocks,
                         float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pair_fgh_kernel<<<n_blocks, kThreads, 0, st>>>(mu, sig, m_rot, crot, ok,
                                                 n_pairs, lfd1, lfd2,
                                                 partials);
  sum_partials_kernel<<<1, 32, 0, st>>>(partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
