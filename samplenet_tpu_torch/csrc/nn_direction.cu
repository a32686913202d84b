// 1-NN of every query point in a database cloud: (squared distance, index),
// and with the snap variant also the neighbour's coordinates.
//
// Replaces: samplenet_tpu/ops/pallas/chamfer_kernel.py::nn_direction
//   (body `_nn_direction_kernel` :28, `pl.pallas_call` :132) and, as
//   `snt_nn_snap`, ::nn_snap (:192; the same body with `emit_points`), the
//   hard projection's 1-NN snap.
//
// What bounds it on the H100: every (query, point) pair costs about 11
// lane-instructions that cannot be fused: the distance's 3 subtractions,
// 3 products and 2 sums (rounded apart, so no FMA), a min.NaN, a compare
// of the minimum's bits and an index select. At the serving path's shape
// (B=1024 clouds, 32 queries over 1024 points) that is 33.5M pairs, about
// 0.011 ms of the card's issue slots (132 SMs x 128 lanes at 1.98 GHz),
// while it reads 12.6 MB of database and 0.4 MB of queries. The same
// pairs arise the other way round in the Chamfer loss (1024 queries over
// 32 points): there a kernel that pays a block launch, a staging pass and
// a warp merge for each handful of pairs is bound by those fixed costs,
// not by the pairs.
//
// Design: the launch plan (ops/cuda/nn_plan.py) sets, for each shape,
// L lanes a query (a power of two up to 32), Q queries a thread (held in
// registers, so a point read from shared memory serves Q pairs), warps a
// block and the chunk of database points staged at a time. The grid is
// flat: blockIdx.x runs over (cloud, tile of queries), cloud-major, so
// only int32 indices cap it. A block stages its cloud chunk by chunk as
// float4 with cp.async (one point a thread, no div/mod a float), the next
// chunk into a second buffer while it scans the current one; its threads
// load their queries meanwhile, a group's lanes the same address, so a
// warp reads each of its queries once. Each group of L lanes scans the
// staged points: lane l takes points p = l, l + L, ... in ascending order. A lane keeps its running minimum with min.NaN and
// its index where the minimum's bits change, so it holds the first index
// of its own minimum, NaN first; log2 L shuffle rounds then merge a
// group's lanes, preferring NaN, then the smaller distance, then the lower
// index. That gives the first index of the minimum, NaN first, whatever
// the partition: every plan gives the same bits. L = 1 where a cloud's
// queries fill the card on their own (a thread owns its queries, no
// merge); L grows only where they leave it short.
//
// Distances are ((dx*dx + dy*dy) + dz*dz) with __fmul_rn/__fadd_rn, which
// the compiler never contracts into FMAs, so dist and idx equal the plain
// version (ops/cuda/chamfer_kernel.py::nn_direction_plain) bit for bit.
// NaN follows the JAX package's path off the TPU
// (samplenet_tpu/ops/pairwise.py::chunked_min_argmin: jnp.min, jnp.argmin)
// and torch's amin/argmin: a NaN distance ranks below every number, so a
// query whose distance to some point is NaN gets dist NaN and the first
// such index; a query with a NaN coordinate gets index 0. A lane with no
// point, or only +inf distances, holds (+inf, 0), which wins only where
// every distance is +inf, and index 0 is then argmin's answer.
//
// The snap variant (kSnap) writes the winner's xyz as well: after the
// merge, the group's first lane copies y[idx] from the database, so the
// snapped point is the neighbour's coordinates bit for bit (the TPU
// kernel's one-hot select gives the same bits).

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"
#include "stage.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxChunk = 1024;  // database points staged at a time
constexpr int kMaxLanes = 32;
constexpr int kMaxQueries = 8;

// Shared memory of one block: the chunk as float4, twice where the
// database takes more than one chunk (the next one is staged while the
// block scans the current one).
__host__ __device__ constexpr size_t nn_smem(int chunk, int n2) {
  return static_cast<size_t>(n2 > chunk ? 2 : 1) * chunk * 16;
}

// Whether (od, oi) from another lane comes before (d, i): NaN first, then
// the smaller distance, then the lower index.
__device__ __forceinline__ bool nn_merge_before(float od, int oi, float d,
                                                int i) {
  if (od != od) return d == d || oi < i;
  return od < d || (od == d && oi < i);
}

template <int L, int Q, bool kSnap>
__global__ void __launch_bounds__(kMaxThreads)
nn_direction_kernel(const float* __restrict__ x,  // [B, n1, 3] queries
                    const float* __restrict__ y,  // [B, n2, 3] database
                    float* __restrict__ dist,     // [B, n1]
                    int* __restrict__ idx,        // [B, n1]
                    float* __restrict__ snapped,  // [B, n1, 3] when kSnap
                    int n1, int n2, int tiles, int chunk) {
  extern __shared__ float4 smem[];
  const int groups = blockDim.x / L;
  const int tile = groups * Q;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - b * tiles) * tile;
  const int nq = min(tile, n1 - q0);  // this tile's queries
  const int g = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const float* xb = x + (static_cast<size_t>(b) * n1 + q0) * 3;
  const float* yb = y + static_cast<size_t>(b) * n2 * 3;

  // the first chunk's copies and the queries' loads are in flight at once;
  // query j of group g is g + j * groups, so neighbouring groups read (and
  // their first lanes write) neighbouring queries
  stage(smem, yb, 0, min(chunk, n2));
  float qx[Q], qy[Q], qz[Q], best[Q];
  int best_i[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int q = min(g + j * groups, nq - 1);  // past the tile: a copy
    qx[j] = xb[3 * q + 0];
    qy[j] = xb[3 * q + 1];
    qz[j] = xb[3 * q + 2];
    best[j] = CUDART_INF_F;
    best_i[j] = 0;  // an all-inf row gives index 0, as torch.argmin does
  }

  for (int c0 = 0, k = 0; c0 < n2; c0 += chunk, ++k) {
    const float4* buf = smem + (k & 1) * chunk;
    const int cn = min(chunk, n2 - c0);
    if (c0 + chunk < n2) {  // the next chunk, into the other buffer
      stage(smem + ((k + 1) & 1) * chunk, yb, c0 + chunk,
            min(chunk, n2 - c0 - chunk));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk k has landed, for every thread
#pragma unroll 4
    for (int p = lane; p < cn; p += L) {
      const float4 pt = buf[p];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        // min.NaN changes best's bits only where d < best, or where d is
        // NaN and best is not: the lane's first NaN stays
        const float m = min_nan(best[j],
                                sqdist(qx[j], qy[j], qz[j], pt.x, pt.y, pt.z));
        if (__float_as_uint(m) != __float_as_uint(best[j])) best_i[j] = c0 + p;
        best[j] = m;
      }
    }
    if (c0 + chunk < n2) __syncthreads();  // buf is free for chunk k + 2
  }

#pragma unroll
  for (int j = 0; j < Q; ++j) {
    float d = best[j];
    int i = best_i[j];
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float od = __shfl_down_sync(0xffffffffu, d, off, L);
      const int oi = __shfl_down_sync(0xffffffffu, i, off, L);
      if (nn_merge_before(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    const int t = g + j * groups;
    if (lane == 0 && t < nq) {
      const size_t o = static_cast<size_t>(b) * n1 + q0 + t;
      dist[o] = d;
      idx[o] = i;
      if (kSnap) {
        const float* s = yb + static_cast<size_t>(i) * 3;
        snapped[o * 3 + 0] = s[0];
        snapped[o * 3 + 1] = s[1];
        snapped[o * 3 + 2] = s[2];
      }
    }
  }
}

template <int L, int Q, bool kSnap>
cudaError_t launch(const float* x, const float* y, float* dist, int* idx,
                   float* snapped, int b, int n1, int n2, int warps,
                   int chunk, cudaStream_t stream) {
  const int threads = 32 * warps;
  const int tile = threads / L * Q;
  const int tiles = (n1 + tile - 1) / tile;
  if (static_cast<long long>(b) * tiles > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  nn_direction_kernel<L, Q, kSnap>
      <<<b * tiles, threads, nn_smem(chunk, n2), stream>>>(
          x, y, dist, idx, snapped, n1, n2, tiles, chunk);
  return cudaGetLastError();
}

template <bool kSnap>
int run(const float* x, const float* y, float* dist, int* idx,
        float* snapped, int b, int n1, int n2, int lanes, int queries,
        int warps, int chunk, cudaStream_t stream) {
  if (b < 1 || n1 < 1 || n2 < 1 || warps < 1 || warps > kMaxWarps ||
      chunk < 32 || chunk > kMaxChunk || chunk % 32 != 0 ||
      n1 > INT_MAX - 32 * kMaxWarps * kMaxQueries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
#define SNT_NN_CASE(LL, QQ)                                                \
  if (lanes == LL && queries == QQ) {                                      \
    err = launch<LL, QQ, kSnap>(x, y, dist, idx, snapped, b, n1, n2, warps, \
                                chunk, stream);                            \
  }
#define SNT_NN_LANES(LL) \
  SNT_NN_CASE(LL, 1) SNT_NN_CASE(LL, 2) SNT_NN_CASE(LL, 4) SNT_NN_CASE(LL, 8)
  SNT_NN_LANES(1)
  SNT_NN_LANES(2)
  SNT_NN_LANES(4)
  SNT_NN_LANES(8)
  SNT_NN_LANES(16)
  SNT_NN_LANES(32)
#undef SNT_NN_LANES
#undef SNT_NN_CASE
  return static_cast<int>(err);
}

}  // namespace

extern "C" size_t snt_nn_smem(int chunk, int n2) {
  return nn_smem(chunk, n2);
}

// The kernel's limits: 0 warps a block, 1 points staged at a time, 2 lanes
// a query, 3 queries a thread.
extern "C" int snt_nn_limit(int which) {
  const int limits[] = {kMaxWarps, kMaxChunk, kMaxLanes, kMaxQueries};
  return which >= 0 && which < 4 ? limits[which] : -1;
}

// lanes (a query, a power of two), queries (a thread: 1, 2, 4 or 8), warps
// (a block) and chunk (database points staged at a time, a multiple of 32)
// come from the launch plan; the outputs do not depend on it.
extern "C" int snt_nn_direction(const float* x, const float* y, float* dist,
                                int* idx, int b, int n1, int n2, int lanes,
                                int queries, int warps, int chunk,
                                cudaStream_t stream) {
  return run<false>(x, y, dist, idx, nullptr, b, n1, n2, lanes, queries,
                    warps, chunk, stream);
}

extern "C" int snt_nn_snap(const float* x, const float* y, float* dist,
                           int* idx, float* snapped, int b, int n1, int n2,
                           int lanes, int queries, int warps, int chunk,
                           cudaStream_t stream) {
  return run<true>(x, y, dist, idx, snapped, b, n1, n2, lanes, queries,
                   warps, chunk, stream);
}
