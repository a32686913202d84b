// Soft projection: k-NN softmax mixture of each query over its cloud,
// forward and backward.
//
// Replaces: samplenet_tpu/ops/pallas/soft_projection_kernel.py::soft_project
//   (custom VJP :160-193; forward `fused_soft_projection` :135, body
//   `_soft_projection_kernel` :35, `pl.pallas_call` :99). The JAX package
//   recomputes the backward in XLA from the saved indices (:185-190); here
//   it is the second kernel below.
//
// For each query q of cloud b: the k <= 16 nearest points p_0..p_{k-1},
// ascending by d_i = |q - p_i|^2, ties to the lowest index; w_i =
// exp(-(d_i - d_0) / s) with s = sigma^2 read from device memory;
// out = sum w_i p_i / sum w_i, and idx [B, M, k].
//
// What bounds it on the H100: at the train step's shape (B=1024 clouds of
// N=1024 points, M=32 queries, k=7) the forward computes 33.5M distances
// (0.27 GFLOP) and reads 12.6 MB of points once per query tile; the
// backward touches only M*k neighbours per cloud (0.9 MB of gathers). Both
// are bound by latency and the selection's compares, not by FLOPs or HBM.
//
// Forward design: one block per (cloud, tile of kQueryTile queries), one
// warp per query. The block stages the cloud in shared memory as
// structure-of-arrays, kChunk points at a time. Lane l scans points l,
// l+32, ... in ascending order and keeps its own sorted top-k in registers
// (insertion with a strict order on (d, index)); k rounds of a warp
// butterfly then pop the lexicographic minimum of the 32 list heads. The
// weights stream in that ascending order, so no [M, k] buffer is kept.
// Distances use sqdist.cuh (no FMA contraction) and a NaN distance counts
// as +inf, so idx is bit-equal to the plain version's stable sort.
//
// Backward design: one block per cloud, one thread per query (in chunks of
// kBwdQueries). Each thread recomputes its k distances and weights from
// idx and writes the k contributions to the points' gradient into shared
// memory; then thread t adds, in entry order, those that fall on points
// p with p % kBwdThreads == t into a shared [N, 3] accumulator it alone
// writes. The sum order is fixed, so the gradient is the same on every
// run, with no atomics. d sigma^2 leaves as one partial per cloud, summed
// by the caller; d queries is per thread.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueryTile = kWarps;  // one query per warp
constexpr int kChunk = 2048;        // points staged per pass: 24 KB
constexpr int kMaxK = 16;
constexpr int kBwdThreads = 256;
constexpr int kBwdQueries = kBwdThreads;  // one query per thread

// (d, i) comes strictly before (bd, bi)
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
  if (!before(d, i, bd[K - 1], bi[K - 1])) return;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (before(d, i, bd[j - 1], bi[j - 1])) {
      bd[j] = bd[j - 1];
      bi[j] = bi[j - 1];
    } else if (before(d, i, bd[j], bi[j])) {
      bd[j] = d;
      bi[j] = i;
    }
  }
  if (before(d, i, bd[0], bi[0])) {
    bd[0] = d;
    bi[0] = i;
  }
}

__device__ __forceinline__ float softmax_term(float d, float d0, float s) {
  return expf(__fdiv_rn(-__fsub_rn(d, d0), s));
}

template <int K>
__global__ void __launch_bounds__(kThreads)
soft_project_fwd_kernel(const float* __restrict__ points,   // [B, n, 3]
                        const float* __restrict__ queries,  // [B, m, 3]
                        const float* __restrict__ sigma,    // [1]: sigma^2
                        float* __restrict__ out,            // [B, m, 3]
                        int* __restrict__ idx,              // [B, m, K]
                        int n, int m) {
  __shared__ float sp[3][kChunk];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.y * kQueryTile + warp;
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  const float* qp = queries + (static_cast<size_t>(b) * m + min(q, m - 1)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = INT_MAX;  // after every real point, so n >= K fills the lists
  }
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int cn = min(kChunk, n - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < cn * 3; e += kThreads) {
      sp[e % 3][e / 3] = pb[static_cast<size_t>(c0) * 3 + e];
    }
    __syncthreads();
    for (int p = lane; p < cn; p += 32) {
      float d = sqdist(qx, qy, qz, sp[0][p], sp[1][p], sp[2][p]);
      if (d != d) d = CUDART_INF_F;
      insert<K>(bd, bi, d, c0 + p);
    }
  }

  const float s = *sigma;
  float d0 = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f, den = 0.0f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float d = bd[0];
    int i = bi[0];
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (before(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    if (bi[0] == i) {  // this lane held the winner (real indices are unique)
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        bd[j] = bd[j + 1];
        bi[j] = bi[j + 1];
      }
      bd[K - 1] = CUDART_INF_F;
      bi[K - 1] = INT_MAX;
    }
    if (r == 0) d0 = d;
    const float w = softmax_term(d, d0, s);
    const float* p = pb + static_cast<size_t>(i) * 3;
    nx += w * p[0];
    ny += w * p[1];
    nz += w * p[2];
    den += w;
    if (lane == 0 && q < m) idx[(static_cast<size_t>(b) * m + q) * K + r] = i;
  }
  if (lane == 0 && q < m) {
    float* o = out + (static_cast<size_t>(b) * m + q) * 3;
    o[0] = nx / den;
    o[1] = ny / den;
    o[2] = nz / den;
  }
}

template <int K>
__global__ void __launch_bounds__(kBwdThreads)
soft_project_bwd_kernel(const float* __restrict__ points,    // [B, n, 3]
                        const float* __restrict__ queries,   // [B, m, 3]
                        const float* __restrict__ sigma,     // [1]
                        const int* __restrict__ idx,         // [B, m, K]
                        const float* __restrict__ grad_out,  // [B, m, 3]
                        float* __restrict__ dpoints,         // [B, n, 3]
                        float* __restrict__ dqueries,        // [B, m, 3]
                        float* __restrict__ dsigma,          // [B] partials
                        int n, int m) {
  extern __shared__ float smem[];
  float* dp = smem;                                  // [n * 3]
  float* contrib = dp + static_cast<size_t>(n) * 3;  // [kBwdQueries * K * 3]
  int* cidx = reinterpret_cast<int*>(contrib + kBwdQueries * K * 3);
  __shared__ float red[kBwdThreads];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  for (int e = t; e < n * 3; e += kBwdThreads) dp[e] = 0.0f;
  const float s = *sigma;
  float ds = 0.0f;

  for (int m0 = 0; m0 < m; m0 += kBwdQueries) {
    const int nq = min(kBwdQueries, m - m0);
    __syncthreads();  // the previous chunk's contributions are consumed
    if (t < nq) {
      const size_t qrow = static_cast<size_t>(b) * m + m0 + t;
      const float qx = queries[qrow * 3 + 0], qy = queries[qrow * 3 + 1],
                  qz = queries[qrow * 3 + 2];
      const float gx = grad_out[qrow * 3 + 0], gy = grad_out[qrow * 3 + 1],
                  gz = grad_out[qrow * 3 + 2];
      float px[K], py[K], pz[K], d[K], w[K];
      int pi[K];
      float den = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        pi[j] = idx[qrow * K + j];
        const float* p = pb + static_cast<size_t>(pi[j]) * 3;
        px[j] = p[0];
        py[j] = p[1];
        pz[j] = p[2];
        d[j] = sqdist(qx, qy, qz, px[j], py[j], pz[j]);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        w[j] = softmax_term(d[j], d[0], s);
        den += w[j];
      }
      float ox = 0.0f, oy = 0.0f, oz = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        w[j] = w[j] / den;
        ox += w[j] * px[j];
        oy += w[j] * py[j];
        oz += w[j] * pz[j];
      }
      const float ubar = gx * ox + gy * oy + gz * oz;
      float dqx = 0.0f, dqy = 0.0f, dqz = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float u = gx * px[j] + gy * py[j] + gz * pz[j];
        const float e = w[j] * (u - ubar);        // dL/d(-d_j / s)
        ds += e * (d[j] - d[0]);
        const float two_dd = -2.0f * e / s;       // 2 dL/dd_j
        const float ex = px[j] - qx, ey = py[j] - qy, ez = pz[j] - qz;
        float* c = contrib + (t * K + j) * 3;
        c[0] = w[j] * gx + two_dd * ex;
        c[1] = w[j] * gy + two_dd * ey;
        c[2] = w[j] * gz + two_dd * ez;
        cidx[t * K + j] = pi[j];
        dqx -= two_dd * ex;
        dqy -= two_dd * ey;
        dqz -= two_dd * ez;
      }
      dqueries[qrow * 3 + 0] = dqx;
      dqueries[qrow * 3 + 1] = dqy;
      dqueries[qrow * 3 + 2] = dqz;
    }
    __syncthreads();
    for (int e = 0; e < nq * K; ++e) {  // entry order: (query, rank)
      const int p = cidx[e];
      if (p % kBwdThreads == t) {
        dp[p * 3 + 0] += contrib[e * 3 + 0];
        dp[p * 3 + 1] += contrib[e * 3 + 1];
        dp[p * 3 + 2] += contrib[e * 3 + 2];
      }
    }
  }
  __syncthreads();
  float* dpb = dpoints + static_cast<size_t>(b) * n * 3;
  for (int e = t; e < n * 3; e += kBwdThreads) dpb[e] = dp[e];

  red[t] = ds;
  __syncthreads();
  for (int half = kBwdThreads / 2; half > 0; half >>= 1) {
    if (t < half) red[t] += red[t + half];
    __syncthreads();
  }
  if (t == 0) dsigma[b] = red[0] / (s * s);
}

template <int K>
cudaError_t launch_fwd(const float* points, const float* queries,
                       const float* sigma, float* out, int* idx, int b, int n,
                       int m, cudaStream_t stream) {
  const dim3 grid(b, (m + kQueryTile - 1) / kQueryTile);
  soft_project_fwd_kernel<K><<<grid, kThreads, 0, stream>>>(
      points, queries, sigma, out, idx, n, m);
  return cudaGetLastError();
}

size_t bwd_smem(int n, int k) {
  return (static_cast<size_t>(n) * 3 + static_cast<size_t>(kBwdQueries) * k * 3) *
             sizeof(float) +
         static_cast<size_t>(kBwdQueries) * k * sizeof(int);
}

template <int K>
cudaError_t launch_bwd(const float* points, const float* queries,
                       const float* sigma, const int* idx,
                       const float* grad_out, float* dpoints, float* dqueries,
                       float* dsigma, int b, int n, int m,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(n, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        soft_project_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  soft_project_bwd_kernel<K><<<b, kBwdThreads, smem, stream>>>(
      points, queries, sigma, idx, grad_out, dpoints, dqueries, dsigma, n, m);
  return cudaGetLastError();
}

#define SNT_SWITCH_K(k, CALL)  \
  switch (k) {                 \
    case 1: return CALL(1);    \
    case 2: return CALL(2);    \
    case 3: return CALL(3);    \
    case 4: return CALL(4);    \
    case 5: return CALL(5);    \
    case 6: return CALL(6);    \
    case 7: return CALL(7);    \
    case 8: return CALL(8);    \
    case 9: return CALL(9);    \
    case 10: return CALL(10);  \
    case 11: return CALL(11);  \
    case 12: return CALL(12);  \
    case 13: return CALL(13);  \
    case 14: return CALL(14);  \
    case 15: return CALL(15);  \
    case 16: return CALL(16);  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

extern "C" size_t snt_soft_project_bwd_smem(int n, int k) {
  return bwd_smem(n, k);
}

extern "C" int snt_soft_project_fwd(const float* points, const float* queries,
                                    const float* sigma, float* out, int* idx,
                                    int b, int n, int m, int k,
                                    cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k > n) return static_cast<int>(cudaErrorInvalidValue);
#define SNT_FWD(K) \
  static_cast<int>(launch_fwd<K>(points, queries, sigma, out, idx, b, n, m, stream))
  SNT_SWITCH_K(k, SNT_FWD)
#undef SNT_FWD
}

extern "C" int snt_soft_project_bwd(const float* points, const float* queries,
                                    const float* sigma, const int* idx,
                                    const float* grad_out, float* dpoints,
                                    float* dqueries, float* dsigma, int b,
                                    int n, int m, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k > n) return static_cast<int>(cudaErrorInvalidValue);
#define SNT_BWD(K)                                                              \
  static_cast<int>(launch_bwd<K>(points, queries, sigma, idx, grad_out,         \
                                 dpoints, dqueries, dsigma, b, n, m, stream))
  SNT_SWITCH_K(k, SNT_BWD)
#undef SNT_BWD
}
