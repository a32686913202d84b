// 1-NN of every query point in a database cloud: (squared distance, index),
// and with the snap variant also the neighbour's coordinates.
//
// Replaces: samplenet_tpu/ops/pallas/chamfer_kernel.py::nn_direction
//   (body `_nn_direction_kernel` :28, `pl.pallas_call` :132) and, as
//   `snt_nn_snap`, ::nn_snap (:192; the same body with `emit_points`), the
//   hard projection's 1-NN snap.
//
// What bounds it on the H100: at the serving path's shape (B=1024 clouds,
// 32 queries, 1024 database points) it is 33.5M distances of 8 flops each,
// 0.27 GFLOP, and it reads 12.6 MB of database and 0.4 MB of queries once.
// That is microseconds of either the FP32 pipes or HBM, so the kernel is
// bound by latency and occupancy: a cloud has only 32 queries.
//
// Design: one block per (cloud, tile of kQueryTile queries). The block
// stages the database in shared memory as structure-of-arrays, kChunk points
// at a time, and each warp owns kQueriesPerWarp queries held in registers.
// Lane l scans points l, l+32, ... in ascending order with a strict '<', so
// it keeps the lowest index among its equal minima; a warp-shuffle merge
// then prefers the lower index on equal distances. The result is the first
// index of the minimum, as torch.argmin gives it. The ragged tail of the
// database is masked by the loop bound (no sentinel points).
//
// Distances are ((dx*dx + dy*dy) + dz*dz) with __fmul_rn/__fadd_rn, which
// the compiler never contracts into FMAs, so dist and idx equal the plain
// version (ops/cuda/chamfer_kernel.py::nn_direction_plain) bit for bit.
// NaN follows the JAX package's path off the TPU
// (samplenet_tpu/ops/pairwise.py::chunked_min_argmin: jnp.min, jnp.argmin)
// and torch's amin/argmin: a NaN distance ranks below every number, so a
// query whose distance to some point is NaN gets dist NaN and the first
// such index; a query with a NaN coordinate gets index 0. A lane keeps its
// running minimum with min.NaN and its index where the minimum's bits
// change, and the merge prefers NaN, then the lower index among equals.
//
// The snap variant (kSnap) writes the winner's xyz as well: after the warp
// merge, lane 0 copies y[idx] from the database, so the snapped point is
// the neighbour's coordinates bit for bit (the TPU kernel's one-hot select
// gives the same bits). At the progressive infer step's shape (B=32, 1024
// queries against 1024 points) it is 33.5M distances and 0.4 MB of
// snapped points out: latency-bound, like the direction alone.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerWarp = 4;
constexpr int kQueryTile = kWarps * kQueriesPerWarp;
constexpr int kChunk = 2048;  // database points staged per pass: 24 KB

// Whether (od, oi) from another lane comes before (d, i): NaN first, then
// the smaller distance, then the lower index.
__device__ __forceinline__ bool nn_merge_before(float od, int oi, float d,
                                                int i) {
  if (od != od) return d == d || oi < i;
  return od < d || (od == d && oi < i);
}

template <bool kSnap>
__global__ void __launch_bounds__(kThreads)
nn_direction_kernel(const float* __restrict__ x,  // [B, n1, 3] queries
                    const float* __restrict__ y,  // [B, n2, 3] database
                    float* __restrict__ dist,     // [B, n1]
                    int* __restrict__ idx,        // [B, n1]
                    float* __restrict__ snapped,  // [B, n1, 3] when kSnap
                    int n1, int n2) {
  __shared__ float sy[3][kChunk];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* xb = x + static_cast<size_t>(b) * n1 * 3;
  const float* yb = y + static_cast<size_t>(b) * n2 * 3;

  float qx[kQueriesPerWarp], qy[kQueriesPerWarp], qz[kQueriesPerWarp];
  float best[kQueriesPerWarp];
  int best_i[kQueriesPerWarp];
#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    const int q = min(blockIdx.y * kQueryTile + warp + j * kWarps, n1 - 1);
    qx[j] = xb[q * 3 + 0];
    qy[j] = xb[q * 3 + 1];
    qz[j] = xb[q * 3 + 2];
    best[j] = CUDART_INF_F;
    best_i[j] = 0;  // an all-inf row gives index 0, as torch.argmin does
  }

  for (int c0 = 0; c0 < n2; c0 += kChunk) {
    const int cn = min(kChunk, n2 - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < cn * 3; e += kThreads) {
      sy[e % 3][e / 3] = yb[static_cast<size_t>(c0) * 3 + e];
    }
    __syncthreads();
    for (int p = lane; p < cn; p += 32) {
      const float px = sy[0][p], py = sy[1][p], pz = sy[2][p];
#pragma unroll
      for (int j = 0; j < kQueriesPerWarp; ++j) {
        // min.NaN changes best's bits only where d < best, or where d is
        // NaN and best is not: the lane's first NaN stays
        const float m = min_nan(best[j],
                                sqdist(qx[j], qy[j], qz[j], px, py, pz));
        if (__float_as_uint(m) != __float_as_uint(best[j])) best_i[j] = c0 + p;
        best[j] = m;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    float d = best[j];
    int i = best_i[j];
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_down_sync(0xffffffffu, d, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (nn_merge_before(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    const int q = blockIdx.y * kQueryTile + warp + j * kWarps;
    if (lane == 0 && q < n1) {
      dist[static_cast<size_t>(b) * n1 + q] = d;
      idx[static_cast<size_t>(b) * n1 + q] = i;
      if (kSnap) {
        float* out = snapped + (static_cast<size_t>(b) * n1 + q) * 3;
        out[0] = yb[static_cast<size_t>(i) * 3 + 0];
        out[1] = yb[static_cast<size_t>(i) * 3 + 1];
        out[2] = yb[static_cast<size_t>(i) * 3 + 2];
      }
    }
  }
}

}  // namespace

extern "C" int snt_nn_direction(const float* x, const float* y, float* dist,
                                int* idx, int b, int n1, int n2,
                                cudaStream_t stream) {
  const dim3 grid(b, (n1 + kQueryTile - 1) / kQueryTile);
  nn_direction_kernel<false><<<grid, kThreads, 0, stream>>>(x, y, dist, idx,
                                                            nullptr, n1, n2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int snt_nn_snap(const float* x, const float* y, float* dist,
                           int* idx, float* snapped, int b, int n1, int n2,
                           cudaStream_t stream) {
  const dim3 grid(b, (n1 + kQueryTile - 1) / kQueryTile);
  nn_direction_kernel<true><<<grid, kThreads, 0, stream>>>(x, y, dist, idx,
                                                           snapped, n1, n2);
  return static_cast<int>(cudaGetLastError());
}
