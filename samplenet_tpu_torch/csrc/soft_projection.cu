// Soft projection: k-NN softmax mixture of each query over its cloud,
// forward and backward.
//
// Replaces: samplenet_tpu/ops/pallas/soft_projection_kernel.py::soft_project
//   (custom VJP :160-193; forward `fused_soft_projection` :135, body
//   `_soft_projection_kernel` :35, `pl.pallas_call` :99). The JAX package
//   recomputes the backward in XLA from the saved indices (:185-190); here
//   it is the second kernel below.
//
// For each query q of cloud b: the k nearest points p_0..p_{k-1},
// ascending by d_i = |q - p_i|^2, ties to the lowest index; w_i =
// exp(-(d_i - d_0) / s) with s = sigma^2 read from device memory;
// out = sum w_i p_i / sum w_i, and idx [B, M, k].
//
// What bounds it on the H100: at the train step's shape (B=1024 clouds of
// N=1024 points, M=32 queries, k=7) the forward computes 33.5M distances
// (0.27 GFLOP, 9 FP32 ops each, none an FMA) and reads 12.6 MB of points;
// at the progressive AE step's (B=50, N=M=2048, k=16) 210M. It is bound
// by instruction issue and latency, not by FLOPs or HBM. The backward
// gathers M*k neighbours per cloud and must write d points whole (B*N*3
// floats, 12.6 MB at the train step's shape), which bounds it by bytes.
//
// Forward design: no list is kept while the cloud is scanned. Each query
// is served by `slices` adjacent lanes (1 to 8, a power of two), so that a
// small batch still fills the card; a block of 32 * warps lanes serves one
// cloud and 32 * warps / slices of its queries (`warps`, `slices` and the
// staged chunk come from the launch plan, ops/cuda/soft_projection_plan.py).
// The block stages the cloud in shared memory as float4 (x, y, z, 0); a
// query's lanes read consecutive points, and the queries of a warp share
// those loads as broadcasts while they scan the same points. A cloud longer
// than the chunk is staged chunk by chunk, once for each pass. The points
// fall in G groups of len = ceil(n / G) consecutive points, G = 16 for k <=
// 8 and 32 above. Two passes:
//   1. The lanes keep the least distance of each group (one fminf a point;
//      a NaN never wins) and combine them by shuffles. The G group minima
//      are distances of G distinct points, so their k-th smallest, tau (a
//      sorting network in registers), bounds the k-th neighbour's distance
//      from above, and only a group whose minimum is at or below tau (k of
//      the G, more on ties) can hold a point that is.
//   2. The lanes rescan those groups. Every point with (d, index) before
//      (tau, INT_MAX), NaN as +inf, goes into a buffer of the lane's own
//      (about k + k^2/2G points a query on randn clouds), and the buffer
//      into a sorted list of k in registers (insertion, strict order on
//      (d, index)) when it is full and at the end; a full list's k-th entry
//      then replaces tau. The query's lanes merge their lists by a
//      butterfly of shuffles.
// A lane loads and measures 8 points before it tests any, and branches only
// where a candidate may come in. The first lane of a query forms w_r from
// its list, reads the neighbours from shared memory (from global memory
// when the cloud spans several chunks) and sums them in rank order.
// Distances use sqdist.cuh (no FMA contraction) and the order is (d, index)
// throughout, so idx is bit-equal to the plain version's stable sort.
//
// Backward design: two kernels and a workspace in device memory, with no
// float atomics. The first runs one thread per query over a flat grid of
// all B*M queries (`tile` a block, so where M is small a block serves
// several clouds): it recomputes the query's k distances and weights from
// idx, writes its d queries row and, for each rank j, the contribution
// w_j g + 2 dL/dd_j (p_j - q) to its point's gradient (contrib [B, k, M] of
// float4) and the query's term of d sigma^2 as (e_j, d_j - d_0) (esd
// [B, k, M] of float2): 24 bytes an entry, 39 MB at the progressive AE
// step's shape. The second runs a flat grid of B * (point ranges + 1)
// blocks, cloud by cloud, so B has no cap either. A block owns `span`
// consecutive points of one cloud, one to kMaxPer a thread,
// and streams the cloud's M*k entries (query, rank) in rounds of
// 32 * kUnroll a warp, each lane holding kUnroll idx loads while the round
// before runs. A warp keeps the entries that fall on its block's points
// and fetches their contributions; a ballot and popc give each its place
// in the round's list in shared memory, in entry order. The list is then
// taken `threads` entries a slice: each warp groups its 32 by point
// (__match_any_sync), and the lowest lane of a group writes the group's
// lanes to a [warps, span] table of masks and sets the warp's bit in the
// point's flag word (an atomicOr whose result is not read). The thread
// that owns a point reads its flags, then those masks warp by warp, lane
// by lane, so every point sums its entries in entry order from +0.0f; it
// then stores its row, zeros included, through shared memory with
// coalesced stores. No place comes from an atomic. The last block of each
// cloud sums d sigma^2 in a fixed order: 256 stripes of queries
// (q = s mod 256), each adding its queries' terms e_j (d_j - d_0) in
// order, then a 256-way tree; the caller sums the clouds' partials. No
// sum's order depends on the launch plan (ops/cuda/soft_projection_plan.py),
// so the outputs are bit-equal across plans and runs, and shared memory
// holds one block's range of points and one round's list, never the cloud:
// N has no cap. Each block of the second kernel reads all of its cloud's
// entries, and each of its rounds and slices waits on memory and on
// barriers: at the progressive AE step's shape it is latency-bound, far
// from the bytes that bound the function (PERF.md).
//
// Group sizes above 16 (kMaxK, the register list's length) take the wide
// kernels. The key of a point is its distance's bits, NaN counted as +inf
// (non-negative floats order as their bits), and (key, index) is the order
// of the plain version's stable sort. The wide forward has two kernels, and
// the launch plan (ops/cuda/soft_projection_plan.py, plan_fwd_wide) picks
// one by (B, N, M, k) and the SM count.
//
// The pruned kernel (k up to 64, k at most a quarter of N) generalises the
// register forward's bound to any k. Each query is served by S = ws * cs
// warp-slices: ws warps of a block and cs blocks of a thread-block
// cluster, block r of a cluster taking the points [r * span, r * span +
// span), so that few queries on a long cloud still fill the card. A block
// serves 8 / ws queries of one cloud and stages its range in shared memory
// as float4, chunk by chunk with cp.async into two buffers in turn, so the
// next chunk loads while the current one is scanned; every query of the
// block reads each staged point. Then, none of it over device memory:
//   1. A lane computes its visits' distances once, keeps their keys in a
//      cache of its warp's own in shared memory, and keeps 8 group minima:
//      the i-th visit of each batch of 8 goes to slot i, so the lanes'
//      slots are disjoint groups of points. They are merged (slots, then
//      lanes by shuffles) to G / S a slice, G = 64 or 128 a query, at
//      least 2k. The G minima are distances of G distinct points, so their k-th
//      smallest, tau, bounds the k-th neighbour's distance from above.
//   2. The query's owner, the first warp of its slices in block (query mod
//      cs), sorts the G minima in registers (a bitonic network of shuffles,
//      G / 32 a lane): tau is the k-th. A lone slice (S = 1, the train
//      step's shape) has them in its own lanes; otherwise the slices leave
//      them in shared memory and the owner gathers them, from the other
//      blocks through distributed shared memory.
//   3. Every slice reads its cached keys again: a lane counts and marks
//      those at or below tau, a shuffle scan gives each lane its places,
//      one atomicAdd a warp on the owner's count the warp's (the order of
//      the list does not matter), and the lane writes each such key with
//      its index into the owner's buffer of `cap` words.
// On random clouds about k + k^2 / 2G points a query pass; the owner sorts
// them in registers too (64-bit (key, index) words, 2, 4 or 8 a lane), and
// the first k are the answer, each lane then summing its ranks. A list
// longer than `cap` (ties: many equal distances, or NaN or empty groups,
// where tau is +inf) is exact all the same: the owner then runs the radix
// selection below over the whole cloud from device memory. No group is
// skipped in pass 3: a group is a lane's slot, and a warp rereads a visit
// wherever one of its 32 lanes' groups is near, which is nearly everywhere;
// reading the cached key costs less than the test that would skip it. A
// lone slice meets no other warp after pass 1, so it takes no barrier.
// The radix kernel (k above 64, or k more than a quarter of N, where tau
// prunes little; or a cloud whose keys the caches cannot hold): one warp a
// query, over a flat grid of all B*M queries, and nothing held per k. A
// radix select of 4 passes of 8 bits (a [256] histogram a warp in shared
// memory, the lanes of a warp that share a bin adding once) finds the
// k-th smallest key T and the number of keys below it; a fifth pass writes
// the points below T, and the lowest-index points equal to T, found in
// index order by ballots, into the query's idx row; the warp then sorts
// that row in place by (key, index), recomputing each key from the
// index (a bitonic network in the form whose every compare puts the
// smaller entry at the lower index, so rows of any length k sort with no
// padding). Each pass recomputes the distances from the points in device
// memory (L1 and L2): shared memory does not grow with N or k.
// In both, the keys are unique, so idx is the plain version's stable sort
// bit for bit; distances are true f32 products and sums with no FMA
// (sqdist.cuh), never the tensor cores, so each key is the plain
// version's. The weighted sum runs a lane's ranks in order, then a
// butterfly.
// Wide backward (k > 16): a group of 8 or 32 lanes a query gathers each
// neighbour once, a lane a few ranks, and carries the query's sums in
// float64 in a fixed order (soft_project_bwd_entries_warp); its point kernel reads its
// cloud's entries in windows and keeps only its own, each point's
// entries put in entry order by a count, a scan and a sort of the
// point's segment (soft_project_bwd_points_wide): each point's sum in
// entry order, as at k <= 16, at any entry count. At k <= 16, a cloud of
// more entries (M * k) than an int numbers with a round to spare takes
// soft_project_bwd_points64: the same body counting entries in 64 bits,
// the same entry order, so the same sums.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"
#include "stage.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxWarps = 8;   // a block: 32 * warps lanes, from the plan
constexpr int kMaxSlices = 8;  // lanes a query, from the plan
constexpr int kBuffer = 32;    // candidates a lane holds before it sorts
constexpr int kStep = 8;       // points a lane loads before it tests them
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 16;           // the register kernels; above, wide
constexpr int kWideWarps = 8;       // wide radix forward: queries a block
constexpr int kRadixBins = 256;     // wide radix forward: 8 bits a pass
constexpr int kPruneWarps = 8;      // pruned wide forward: warps a block
constexpr int kSlots = 8;           // pruned: group minima a lane keeps
constexpr int kMaxGroups = 128;     // pruned: group minima a query (G)
constexpr int kMaxCap = 256;        // pruned: candidates a query
constexpr int kMaxCluster = 8;      // pruned: blocks a cluster
constexpr int kMaxVisits = 64;      // pruned: keys a lane caches
constexpr int kMaxPruneChunk = 2048;  // pruned: points staged at a time
constexpr int kMaxTile = 256;       // backward: queries a block, one a thread
constexpr int kMaxPointThreads = 256;  // backward: a point block's threads
constexpr int kMaxPer = 4;          // backward: points a thread
constexpr int kStripes = 256;       // d sigma^2: query stripes, then a tree
constexpr int kUnroll = 4;          // backward: idx loads a lane a round
constexpr int kWideBwdWarps = 8;    // wide backward: warps a block
constexpr int kWideRanks = 8;       // wide backward: ranks a lane holds
constexpr int kWideGroup = 8;       // wide backward: lanes a query, k <= 64
constexpr int kWidePointThreads = 1024;  // wide point kernel: threads, most
constexpr int kWideSpan = 4096;     // wide point kernel: points a block, most
constexpr int kWindowPer = 4;       // wide point kernel: entries a thread a window
constexpr int kWidePointsPer = 4;   // wide point kernel: points a thread
constexpr int kFusedEntries = 4096;  // the fused wide backward: M*k, most
// a point block's static shared memory: wcnt and red
constexpr size_t kPointStatic =
    (kMaxPointThreads / 32) * sizeof(int) + kStripes * sizeof(float);
// a wide point block's: red in float64 and the warps' totals
constexpr size_t kWideStatic =
    kStripes * sizeof(double) + (kWidePointThreads / 32) * sizeof(int);

// (d, i) comes strictly before (bd, bi)
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <int K>
__device__ __forceinline__ void insert(float (&ld)[K], int (&li)[K], float d,
                                       int i) {
  if (!before(d, i, ld[K - 1], li[K - 1])) return;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (before(d, i, ld[j - 1], li[j - 1])) {
      ld[j] = ld[j - 1];
      li[j] = li[j - 1];
    } else if (before(d, i, ld[j], li[j])) {
      ld[j] = d;
      li[j] = i;
    }
  }
  if (before(d, i, ld[0], li[0])) {
    ld[0] = d;
    li[0] = i;
  }
}

__device__ __forceinline__ float softmax_term(float d, float d0, float s) {
  return expf(__fdiv_rn(-__fsub_rn(d, d0), s));
}

// Groups of the first pass's bound: about 2k, a power of two.
__host__ __device__ constexpr int bound_groups(int k) {
  return k <= 8 ? 16 : 32;
}

// Points [c0, c0 + cn) of one cloud into sp as (x, y, z, 0): a thread
// takes 4 points, three 16-byte loads where the rows are so aligned.
__device__ void stage_points(float4* sp, const float* __restrict__ pb, int c0,
                             int cn) {
  const float* src = pb + static_cast<size_t>(c0) * 3;
  const int groups = cn / 4;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const float4 a = __ldg(s4 + 3 * g);
      const float4 b = __ldg(s4 + 3 * g + 1);
      const float4 c = __ldg(s4 + 3 * g + 2);
      sp[4 * g + 0] = make_float4(a.x, a.y, a.z, 0.0f);
      sp[4 * g + 1] = make_float4(a.w, b.x, b.y, 0.0f);
      sp[4 * g + 2] = make_float4(b.z, b.w, c.x, 0.0f);
      sp[4 * g + 3] = make_float4(c.y, c.z, c.w, 0.0f);
    }
  } else {
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const float* r = src + 12 * g;
      sp[4 * g + 0] = make_float4(r[0], r[1], r[2], 0.0f);
      sp[4 * g + 1] = make_float4(r[3], r[4], r[5], 0.0f);
      sp[4 * g + 2] = make_float4(r[6], r[7], r[8], 0.0f);
      sp[4 * g + 3] = make_float4(r[9], r[10], r[11], 0.0f);
    }
  }
  for (int p = 4 * groups + threadIdx.x; p < cn; p += blockDim.x) {
    const float* r = src + 3 * p;
    sp[p] = make_float4(r[0], r[1], r[2], 0.0f);
  }
}

// Sorts v ascending in registers (a bitonic network; no NaN in v).
template <int G>
__device__ __forceinline__ void sort_ascending(float (&v)[G]) {
#pragma unroll
  for (int size = 2; size <= G; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const float lo = fminf(v[i], v[j]), hi = fmaxf(v[i], v[j]);
          const bool up = (i & size) == 0;
          v[i] = up ? lo : hi;
          v[j] = up ? hi : lo;
        }
      }
    }
  }
}

// A lane's selection in pass 2: offer() puts a candidate (d, i) that comes
// before the bound (td, ti) into the buffer (bd, bi, cnt), flush() the
// buffer into the sorted list (ld, li); a full list's last entry then
// becomes the bound.
template <int K>
__device__ __forceinline__ void flush(float (&ld)[K], int (&li)[K],
                                      const float* bd, const int* bi,
                                      int& cnt, float& td, int& ti) {
  for (int e = 0; e < cnt; ++e) insert<K>(ld, li, bd[e], bi[e]);
  cnt = 0;
  if (li[K - 1] != INT_MAX) {
    td = ld[K - 1];
    ti = li[K - 1];
  }
}

template <int K>
__device__ __forceinline__ void offer(float d, int i, float (&ld)[K],
                                      int (&li)[K], float* bd, int* bi,
                                      int& cnt, float& td, int& ti) {
  if (!before(d, i, td, ti)) return;
  if (cnt == kBuffer) flush<K>(ld, li, bd, bi, cnt, td, ti);
  bd[cnt] = d;
  bi[cnt] = i;
  ++cnt;
}

template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
soft_project_fwd_kernel(const float* __restrict__ points,   // [B, n, 3]
                        const float* __restrict__ queries,  // [B, m, 3]
                        const float* __restrict__ sigma,    // [1]: sigma^2
                        float* __restrict__ out,            // [B, m, 3]
                        int* __restrict__ idx,              // [B, m, K]
                        int n, int m, int chunk, int slices) {
  constexpr int G = bound_groups(K);
  extern __shared__ float4 sp[];  // [chunk]
  const int b = blockIdx.x;
  const int s = threadIdx.x % slices;  // the query's lanes: s = 0..slices-1
  const int q = blockIdx.y * (blockDim.x / slices) + threadIdx.x / slices;
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  const float* qp = queries + (static_cast<size_t>(b) * m + min(q, m - 1)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const bool whole = n <= chunk;  // staged once for both passes
  const int len = (n + G - 1) / G;  // group g: points [g * len, g * len + len)

  // pass 1: the least distance of each group, then tau
  float gmin[G];
#pragma unroll
  for (int g = 0; g < G; ++g) gmin[g] = CUDART_INF_F;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = min(chunk, n - c0);
    __syncthreads();  // the previous chunk is no longer read
    stage_points(sp, pb, c0, cn);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int lo = max(g * len, c0) - c0;
      const int hi = min(g * len + len, c0 + cn) - c0;
      float a = CUDART_INF_F, c = CUDART_INF_F;  // two chains
      int p = lo + s;
      for (; p + slices < hi; p += 2 * slices) {
        const float4 v = sp[p], w = sp[p + slices];
        a = fminf(a, sqdist(qx, qy, qz, v.x, v.y, v.z));
        c = fminf(c, sqdist(qx, qy, qz, w.x, w.y, w.z));
      }
      if (p < hi) {
        const float4 v = sp[p];
        a = fminf(a, sqdist(qx, qy, qz, v.x, v.y, v.z));
      }
      gmin[g] = fminf(gmin[g], fminf(a, c));
    }
  }
  for (int off = 1; off < slices; off <<= 1) {  // the query's lanes
#pragma unroll
    for (int g = 0; g < G; ++g) {
      gmin[g] = fminf(gmin[g], __shfl_xor_sync(kFull, gmin[g], off));
    }
  }
  float tau;
  unsigned near = 0u;  // the groups whose minimum is at or below tau
  {
    float t[G];
#pragma unroll
    for (int g = 0; g < G; ++g) t[g] = gmin[g];
    sort_ascending(t);
    tau = t[K - 1];
#pragma unroll
    for (int g = 0; g < G; ++g) near |= (gmin[g] <= tau ? 1u : 0u) << g;
  }

  // pass 2: the near groups' candidates, through the buffer into the list
  float ld[K];
  int li[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    ld[r] = CUDART_INF_F;
    li[r] = INT_MAX;
  }
  float bd[kBuffer];
  int bi[kBuffer];
  int cnt = 0;
  float td = tau;  // (tau, INT_MAX): every d <= tau comes in
  int ti = INT_MAX;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = min(chunk, n - c0);
    if (!whole) {
      __syncthreads();
      stage_points(sp, pb, c0, cn);
      __syncthreads();
    }
    for (unsigned rest = near; rest != 0u; rest &= rest - 1u) {
      const int g = __ffs(rest) - 1;
      const int lo = max(g * len, c0) - c0;
      const int hi = min(g * len + len, c0 + cn) - c0;
      int p = lo + s;
      for (; p + (kStep - 1) * slices < hi; p += kStep * slices) {
        // kStep loads and distances with no branch between them, then one
        // test of all of them (d <= tau holds for every candidate)
        float d[kStep];
        bool any = false;
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const float4 v = sp[p + u * slices];
          // fminf: a NaN distance counts as +inf
          d[u] = fminf(sqdist(qx, qy, qz, v.x, v.y, v.z), CUDART_INF_F);
          any |= d[u] <= td;
        }
        if (any) {
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
            offer<K>(d[u], c0 + p + u * slices, ld, li, bd, bi, cnt, td, ti);
          }
        }
      }
      for (; p < hi; p += slices) {  // the group's ragged end
        const float4 v = sp[p];
        offer<K>(fminf(sqdist(qx, qy, qz, v.x, v.y, v.z), CUDART_INF_F),
                 c0 + p, ld, li, bd, bi, cnt, td, ti);
      }
    }
  }
  flush<K>(ld, li, bd, bi, cnt, td, ti);
  for (int off = 1; off < slices; off <<= 1) {  // merge the query's lanes
#pragma unroll
    for (int r = 0; r < K; ++r) {
      bd[r] = __shfl_xor_sync(kFull, ld[r], off);
      bi[r] = __shfl_xor_sync(kFull, li[r], off);
    }
    for (int r = 0; r < K; ++r) insert<K>(ld, li, bd[r], bi[r]);
  }
  if (q >= m || s != 0) return;  // no block barrier follows

  const float sg = *sigma;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, den = 0.0f;
  int* iq = idx + (static_cast<size_t>(b) * m + q) * K;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const float w = softmax_term(ld[r], ld[0], sg);
    float4 v;
    if (whole) {
      v = sp[li[r]];
    } else {
      const float* pp = pb + static_cast<size_t>(li[r]) * 3;
      v = make_float4(pp[0], pp[1], pp[2], 0.0f);
    }
    nx += w * v.x;
    ny += w * v.y;
    nz += w * v.z;
    den += w;
    iq[r] = li[r];
  }
  float* o = out + (static_cast<size_t>(b) * m + q) * 3;
  o[0] = nx / den;
  o[1] = ny / den;
  o[2] = nz / den;
}

// A wide query's distance to point i, NaN counted as +inf.
__device__ __forceinline__ float wide_dist(const float* __restrict__ pb,
                                           int i, float qx, float qy,
                                           float qz) {
  const float* p = pb + static_cast<size_t>(i) * 3;
  return fminf(sqdist(qx, qy, qz, __ldg(p), __ldg(p + 1), __ldg(p + 2)),
               CUDART_INF_F);
}

// (key, index) of point i: the order the plain version's stable sort gives.
__device__ __forceinline__ unsigned long long wide_key(
    const float* __restrict__ pb, int i, float qx, float qy, float qz) {
  return static_cast<unsigned long long>(
             __float_as_uint(wide_dist(pb, i, qx, qy, qz))) << 32 |
         static_cast<unsigned>(i);
}

// The radix selection of one query by one warp, any 1 <= k <= n: its k
// nearest points by (key, index) into row[0, k) (device memory), sorted.
// hist: the warp's kRadixBins counters in shared memory.
__device__ __forceinline__ void wide_radix_row(const float* __restrict__ pb,
                                               int n, int k, float qx,
                                               float qy, float qz,
                                               unsigned* hist, int* row,
                                               int lane) {
  const unsigned below = (1u << lane) - 1u;

  // 1. the k-th smallest key T, 8 bits a pass, and `lt` keys below it
  unsigned prefix = 0u, mask = 0u;
  int rank = k, lt = 0;  // T is the rank-th key among those on the prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < kRadixBins; i += 32) hist[i] = 0u;
    __syncwarp();
    for (int p0 = 0; p0 < n; p0 += 32) {
      int bin = -1;
      if (p0 + lane < n) {
        const unsigned key =
            __float_as_uint(wide_dist(pb, p0 + lane, qx, qy, qz));
        if ((key & mask) == prefix) bin = static_cast<int>(key >> shift) & 255;
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin >= 0 && (peers & below) == 0u) {
        atomicAdd(hist + bin, static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncwarp();
    // lane l holds bins 8l..8l+7; a scan finds the bin of the rank-th key
    unsigned c[8], sum = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[8 * lane + j];
      sum += c[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const unsigned r = static_cast<unsigned>(rank);
    const int src = __ffs(__ballot_sync(kFull, incl - sum < r && r <= incl)) - 1;
    int digit = 0;
    unsigned run = incl - sum;
    if (lane == src) {
      for (int j = 0; j < 8; ++j) {
        if (run + c[j] >= r) {
          digit = 8 * lane + j;
          break;
        }
        run += c[j];
      }
    }
    digit = __shfl_sync(kFull, digit, src);
    run = __shfl_sync(kFull, run, src);  // keys on the prefix below the bin
    lt += static_cast<int>(run);
    rank -= static_cast<int>(run);
    prefix |= static_cast<unsigned>(digit) << shift;
    mask |= 255u << shift;
    __syncwarp();  // the histogram is read before the next pass clears it
  }

  // 2. the row: the lt points below T, then the first `rank` equal to it
  int nlt = 0, neq = 0;
  for (int p0 = 0; p0 < n; p0 += 32) {
    const int p = p0 + lane;
    const unsigned key =
        p < n ? __float_as_uint(wide_dist(pb, p, qx, qy, qz)) : 0xffffffffu;
    const unsigned lb = __ballot_sync(kFull, key < prefix);
    const unsigned eb = __ballot_sync(kFull, key == prefix);
    if (key < prefix) {
      row[nlt + __popc(lb & below)] = p;
    } else if (key == prefix) {
      const int e = neq + __popc(eb & below);
      if (e < rank) row[lt + e] = p;
    }
    nlt += __popc(lb);
    neq += __popc(eb);
  }
  __syncwarp();

  // 3. sorted by (key, index): each step puts the smaller of a pair at the
  // lower index; a pair whose upper index is past the row is in order
  int pad = 1;
  while (pad < k) pad <<= 1;
  for (int size = 2; size <= pad; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int t = lane; t < pad / 2; t += 32) {
        const int base = t / stride * 2 * stride, off = t % stride;
        const int i = base + off;
        const int j = stride == size / 2 ? base + 2 * stride - 1 - off
                                         : i + stride;
        if (j < k) {
          const int a = row[i], c2 = row[j];
          if (wide_key(pb, a, qx, qy, qz) > wide_key(pb, c2, qx, qy, qz)) {
            row[i] = c2;
            row[j] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// The weighted sum of a query's k neighbours, row[r] the one of rank r:
// ranks in order a lane, then a butterfly; lane 0 writes o[0..2].
__device__ __forceinline__ void wide_sum(const int* row, int k,
                                         const float* __restrict__ pb,
                                         float qx, float qy, float qz,
                                         float sg, float* o, int lane) {
  const float d0 = wide_dist(pb, row[0], qx, qy, qz);
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, den = 0.0f;
  for (int r = lane; r < k; r += 32) {
    const float* pp = pb + static_cast<size_t>(row[r]) * 3;
    const float x = __ldg(pp), y = __ldg(pp + 1), z = __ldg(pp + 2);
    const float w = softmax_term(fminf(sqdist(qx, qy, qz, x, y, z),
                                       CUDART_INF_F), d0, sg);
    nx += w * x;
    ny += w * y;
    nz += w * z;
    den += w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nx += __shfl_xor_sync(kFull, nx, off);
    ny += __shfl_xor_sync(kFull, ny, off);
    nz += __shfl_xor_sync(kFull, nz, off);
    den += __shfl_xor_sync(kFull, den, off);
  }
  if (lane == 0) {
    o[0] = nx / den;
    o[1] = ny / den;
    o[2] = nz / den;
  }
}

// The radix kernel: one warp a query of the flat grid over all B*M
// queries, any 1 <= k <= n.
__global__ void __launch_bounds__(kWideWarps * 32)
soft_project_fwd_wide_kernel(const float* __restrict__ points,   // [B, n, 3]
                             const float* __restrict__ queries,  // [B, m, 3]
                             const float* __restrict__ sigma,    // [1]
                             float* __restrict__ out,            // [B, m, 3]
                             int* idx,                           // [B, m, k]
                             int n, int m, int k, long long total) {
  __shared__ unsigned hists[kWideWarps][kRadixBins];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * kWideWarps + warp;
  if (g >= total) return;  // the whole warp: no block barrier follows
  const float* pb = points + static_cast<size_t>(g / m) * n * 3;
  const float qx = queries[g * 3], qy = queries[g * 3 + 1],
              qz = queries[g * 3 + 2];
  int* row = idx + static_cast<size_t>(g) * k;
  wide_radix_row(pb, n, k, qx, qy, qz, hists[warp], row, lane);
  wide_sum(row, k, pb, qx, qy, qz, *sigma, out + g * 3, lane);
}

// The pruned kernel's launch, from the plan (ops/cuda/soft_projection_plan.py).
struct PrunePlan {
  int ws;      // warps a query in a block: 1, 2, 4 or 8
  int cs;      // blocks a cluster, each a range of `span` points: 1-8
  int groups;  // group minima a query (G), a power of two
  int cap;     // candidates a query, a power of two >= groups
  int chunk;   // points staged at a time, a multiple of 256 * ws
  int span;    // points a block, a multiple of 32 * ws
  int visits;  // keys a lane caches: ceil(span / chunk) chunks of visits
  int tiles;   // query tiles a cloud, kPruneWarps / ws queries each
};

// Keys a lane of a pruned block caches: every visit of its chunks.
__host__ __device__ inline int prune_visits(int ws, int chunk, int span) {
  return (span + chunk - 1) / chunk * (chunk / (32 * ws));
}

// Dynamic shared memory of a pruned block: the staged chunks (one buffer
// where the block's span is one chunk, else two), which the queries'
// states (a candidate buffer of cap keys, its count and tau) reuse once
// pass 1 is done, then each warp's key cache of 32 * visits keys.
__host__ __device__ inline size_t prune_smem(int ws, int cap, int chunk,
                                             int span) {
  const size_t staged = static_cast<size_t>(span > chunk ? 2 : 1) * chunk * 16;
  const size_t states = static_cast<size_t>(kPruneWarps / ws) * (cap * 8 + 16);
  const size_t cache = static_cast<size_t>(kPruneWarps) * 32 *
                       prune_visits(ws, chunk, span) * 4;
  return (staged > states ? staged : states) + cache;
}

template <bool kCluster>
__device__ __forceinline__ void prune_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// p in the shared memory of the cluster's block `rank` (kCluster), or p.
template <bool kCluster, class T>
__device__ __forceinline__ T* in_block(T* p, int rank) {
  if constexpr (kCluster) {
    return cg::this_cluster().map_shared_rank(p, rank);
  } else {
    return p;
  }
}

// Ascending sort of the 32 * E words v across a warp, word i in lane
// i % 32, slot i / 32: a bitonic network whose compares across lanes are
// shuffles and within a lane swaps. Each compare keeps the other lane's
// word where it is the one its place wants (equal words are alike).
template <class T, int E>
__device__ __forceinline__ void warp_sort_regs(T (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      if (st >= 32) {
        const int se = st / 32;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & se) == 0) {
            const bool up = ((e * 32) & size) == 0;
            const T a = v[e], c = v[e | se];
            if ((c < a) == up) {
              v[e] = c;
              v[e | se] = a;
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T o = __shfl_xor_sync(kFull, v[e], st);
          // the lower lane of an ascending pair keeps the smaller word
          const bool want_less = (((e * 32 + lane) & size) == 0) ==
                                 ((lane & st) == 0);
          if ((o < v[e]) == want_less) v[e] = o;
        }
      }
    }
  }
}

// Word i of the 32 * E sorted in v, to every lane.
template <class T, int E>
__device__ __forceinline__ T warp_word(const T (&v)[E], int i) {
  T w = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e == i / 32) w = v[e];
  }
  return __shfl_sync(kFull, w, i % 32);
}

// The G = 32 * E minima (a lone slice's own in its lanes' slots, else
// buf[0, G) of every block of the cluster, G / cs a block), sorted in
// registers: tau, the k-th.
template <bool kCluster, int E>
__device__ __forceinline__ unsigned tau_of(const unsigned (&gmin)[kSlots],
                                           const unsigned long long* buf,
                                           int k, int per, int rank,
                                           bool solo, int lane) {
  unsigned v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (solo) {
      v[e] = gmin[e];
    } else {
      const int i = e * 32 + lane;
      v[e] = static_cast<unsigned>(
          (i / per == rank ? buf[i]
                           : *in_block<kCluster>(buf + i, i / per)) >> 32);
    }
  }
  warp_sort_regs<unsigned, E>(v, lane);
  return warp_word<unsigned, E>(v, k - 1);
}

// The owner's last step on `found` <= 32 * E candidates in buf: sorted in
// registers (past `found`, ~0), the first k into row, the weighted sum into
// o (as wide_sum sums: a lane's ranks in order, then a butterfly).
template <int E>
__device__ __forceinline__ void select_regs(const unsigned long long* buf,
                                            int found, int k,
                                            const float* __restrict__ pb,
                                            float qx, float qy, float qz,
                                            float sg, int* row, float* o,
                                            int lane) {
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < found ? buf[i] : ~0ull;
  }
  warp_sort_regs<unsigned long long, E>(v, lane);
  const float d0 = __uint_as_float(static_cast<unsigned>(
      __shfl_sync(kFull, v[0], 0) >> 32));
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, den = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = e * 32 + lane;
    if (r < k) {
      const int i = static_cast<int>(v[e]);
      row[r] = i;
      const float* pp = pb + static_cast<size_t>(i) * 3;
      const float x = __ldg(pp), y = __ldg(pp + 1), z = __ldg(pp + 2);
      const float w = softmax_term(fminf(sqdist(qx, qy, qz, x, y, z),
                                         CUDART_INF_F), d0, sg);
      nx += w * x;
      ny += w * y;
      nz += w * z;
      den += w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nx += __shfl_xor_sync(kFull, nx, off);
    ny += __shfl_xor_sync(kFull, ny, off);
    nz += __shfl_xor_sync(kFull, nz, off);
    den += __shfl_xor_sync(kFull, den, off);
  }
  if (lane == 0) {
    o[0] = nx / den;
    o[1] = ny / den;
    o[2] = nz / den;
  }
}

// The pruned kernel: a cluster of cs blocks serves kPruneWarps / ws queries
// of one cloud, block r of the cluster the points [r * span, r * span +
// span), warp-slice w (of ws) of a query the visits v = 0, 1, ... with
// point (v * ws + w) * 32 + lane of the block's range. See the note at the
// top of the file.
template <bool kCluster>
__global__ void __launch_bounds__(kPruneWarps * 32)
soft_project_fwd_pruned_kernel(const float* __restrict__ points,   // [B, n, 3]
                               const float* __restrict__ queries,  // [B, m, 3]
                               const float* __restrict__ sigma,    // [1]
                               float* __restrict__ out,            // [B, m, 3]
                               int* __restrict__ idx,              // [B, m, k]
                               int n, int m, int k, PrunePlan pl) {
  extern __shared__ float4 psm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ws = pl.ws, cs = pl.cs, qb = kPruneWarps / ws;
  const int rank = kCluster ? static_cast<int>(cg::this_cluster().block_rank())
                            : 0;
  const int cl = blockIdx.x / cs;  // (cloud, tile), cloud-major
  const int b = cl / pl.tiles;
  const int j = warp / ws, w = warp - j * ws;  // the query, the slice
  const int q = (cl - b * pl.tiles) * qb + j;
  const int qq = min(q, m - 1);  // past the cloud's queries: a copy
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  const float* qp = queries + (static_cast<size_t>(b) * m + qq) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const int base = rank * pl.span;
  const int len = max(0, min(pl.span, n - base));  // the block's points
  const int chunks = (len + pl.chunk - 1) / pl.chunk;
  const int vpc = pl.chunk / (32 * ws);  // visits a chunk, a multiple of 8
  const int nbuf = pl.span > pl.chunk ? 2 : 1;
  const size_t staged = static_cast<size_t>(nbuf) * pl.chunk * 16;
  const size_t state_bytes = static_cast<size_t>(pl.cap) * 8 + 16;
  const size_t states = qb * state_bytes;
  const size_t region = staged > states ? staged : states;
  char* const smem = reinterpret_cast<char*>(psm);
  unsigned* cache = reinterpret_cast<unsigned*>(smem + region) +
                    static_cast<size_t>(warp) * 32 * pl.visits;
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(smem + j * state_bytes);
  int* count = reinterpret_cast<int*>(buf + pl.cap);
  unsigned* taup = reinterpret_cast<unsigned*>(count + 1);

  // 1. the keys into the cache, and each lane's kSlots group minima
  unsigned gmin[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) gmin[s] = 0xffffffffu;
  if (chunks > 0) stage(psm, pb, base, min(pl.chunk, len));
  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * pl.chunk;
    const int cn = min(pl.chunk, len - c0);
    const float4* cur = psm + (c & 1) * pl.chunk;
    if (c + 1 < chunks) {  // the next chunk, into the other buffer
      stage(psm + ((c + 1) & 1) * pl.chunk, pb, base + c0 + pl.chunk,
            min(pl.chunk, len - c0 - pl.chunk));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed, for every thread
    unsigned* cv = cache + c * vpc * 32 + lane;
    const float4* cw = cur + w * 32 + lane;
    if (cn == pl.chunk) {  // a whole chunk: no visit past the points
      for (int v = 0; v < vpc; v += kSlots) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const float4 pt = cw[(v + s) * ws * 32];
          const unsigned key = __float_as_uint(
              fminf(sqdist(qx, qy, qz, pt.x, pt.y, pt.z), CUDART_INF_F));
          cv[(v + s) * 32] = key;
          gmin[s] = min(gmin[s], key);
        }
      }
    } else {
      for (int v = 0; v < vpc; v += kSlots) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int off = ((v + s) * ws + w) * 32 + lane;
          unsigned key = 0xffffffffu;  // past the block's points
          if (off < cn) {
            const float4 pt = cur[off];
            key = __float_as_uint(
                fminf(sqdist(qx, qy, qz, pt.x, pt.y, pt.z), CUDART_INF_F));
          }
          cv[(v + s) * 32] = key;
          gmin[s] = min(gmin[s], key);
        }
      }
    }
    __syncthreads();  // the buffer is free: for chunk c + 2, or the states
  }
  if (chunks == 0) __syncthreads();

  // 2. the minima merged to gs = G / (ws * cs) a slice: slots s = j mod
  // keep_s, then lanes l = j mod keep_l; a lone slice keeps them in
  // registers, the others put them in this block's state of query j
  const bool solo = ws * cs == 1;  // no other warp meets this one
  const int gs = pl.groups / (ws * cs);
  const int keep_s = gs >= 32 ? gs / 32 : 1;
  const int keep_l = gs / keep_s;
  if (keep_s < 8) {
#pragma unroll
    for (int s = 0; s < 4; ++s) gmin[s] = min(gmin[s], gmin[s + 4]);
  }
  if (keep_s < 4) {
#pragma unroll
    for (int s = 0; s < 2; ++s) gmin[s] = min(gmin[s], gmin[s + 2]);
  }
  if (keep_s < 2) gmin[0] = min(gmin[0], gmin[1]);
  for (int off = 16; off >= keep_l; off >>= 1) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s < keep_s) gmin[s] = min(gmin[s], __shfl_xor_sync(kFull, gmin[s], off));
    }
  }
  if (!solo) {
    if (lane < keep_l) {
      unsigned long long* mine = buf + (rank * ws + w) * gs + lane;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < keep_s) {
          mine[s * keep_l] = static_cast<unsigned long long>(gmin[s]) << 32;
        }
      }
    }
    prune_sync<kCluster>();
  }

  // 3. the owner (block j mod cs, the query's first warp) sorts the G
  // minima in registers (a lone slice its own, else gathered from the
  // blocks of the cluster); tau is the k-th
  const int owner = j % cs;
  const bool owns = rank == owner && w == 0;
  if (owns) {
    const int per = ws * gs;  // minima a block
    const unsigned tau =
        pl.groups == 64
            ? tau_of<kCluster, 2>(gmin, buf, k, per, rank, solo, lane)
            : tau_of<kCluster, 4>(gmin, buf, k, per, rank, solo, lane);
    if (lane == 0) {
      *taup = tau;
      *count = 0;
    }
  }
  if (solo) {
    __syncwarp();
  } else {
    prune_sync<kCluster>();
  }

  // 4. every key at or below tau, with its index, into the owner's buffer:
  // a lane counts its keys and marks their visits, a scan gives each lane
  // its place (past the places other slices took: one atomicAdd a warp)
  {
    unsigned long long* obuf = in_block<kCluster>(buf, owner);
    int* ocount = in_block<kCluster>(count, owner);
    // a real key is at most +inf's bits, a padded one above
    const unsigned tau = min(*in_block<kCluster>(taup, owner), 0x7f800000u);
    const int visits = chunks * vpc;  // at most kMaxVisits = 64
    unsigned long long marks = 0ull;
    int mine = 0;
    for (int v = 0; v < visits; ++v) {
      const bool hit = cache[v * 32 + lane] <= tau;
      marks |= static_cast<unsigned long long>(hit) << v;
      mine += hit;
    }
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int at = 0;
    if (lane == 31 && total > 0) at = atomicAdd(ocount, total);
    at = __shfl_sync(kFull, at, 31) + incl - mine;
    for (; marks != 0ull; marks &= marks - 1ull, ++at) {
      const int v = __ffsll(static_cast<long long>(marks)) - 1;
      if (at < pl.cap) {
        obuf[at] = static_cast<unsigned long long>(cache[v * 32 + lane])
                       << 32 |
                   static_cast<unsigned>(base + (v * ws + w) * 32 + lane);
      }
    }
  }
  if (solo) {
    __syncwarp();
  } else {
    prune_sync<kCluster>();  // no block leaves while another may write to it
  }

  // 5. the owner: the k smallest candidates, sorted, or past the buffer the
  // radix selection over the whole cloud
  if (!owns || q >= m) return;
  int* row = idx + (static_cast<size_t>(b) * m + q) * k;
  float* o = out + (static_cast<size_t>(b) * m + q) * 3;
  const float sg = *sigma;
  const int found = *count;
  const int size = max(found, k);
  if (size <= 64) {  // found >= k: tau bounds the k-th neighbour
    select_regs<2>(buf, found, k, pb, qx, qy, qz, sg, row, o, lane);
  } else if (size <= 128) {
    select_regs<4>(buf, found, k, pb, qx, qy, qz, sg, row, o, lane);
  } else if (found <= pl.cap) {  // cap <= 256
    select_regs<8>(buf, found, k, pb, qx, qy, qz, sg, row, o, lane);
  } else {
    // the warp's cache (32 * visits >= 256 keys) holds the histogram
    wide_radix_row(pb, n, k, qx, qy, qz, cache, row, lane);
    wide_sum(row, k, pb, qx, qy, qz, sg, o, lane);
  }
}

// One thread a query of the flat grid over all B*M queries: d queries, and
// each rank's contribution to d points with e_j and d_j - d_0 for
// d sigma^2, into the workspace.
template <int K>
__global__ void __launch_bounds__(kMaxTile)
soft_project_bwd_entries(const float* __restrict__ points,    // [B, n, 3]
                         const float* __restrict__ queries,   // [B, m, 3]
                         const float* __restrict__ sigma,     // [1]
                         const int* __restrict__ idx,         // [B, m, K]
                         const float* __restrict__ grad_out,  // [B, m, 3]
                         float* __restrict__ dqueries,        // [B, m, 3]
                         float4* __restrict__ contrib,        // [B, K, m]
                         float2* __restrict__ esd,            // [B, K, m]
                         int n, int m, long long total) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (g >= total) return;
  const int b = static_cast<int>(g / m);
  const int q = static_cast<int>(g - static_cast<long long>(b) * m);
  const size_t qrow = static_cast<size_t>(g);
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  const float s = *sigma;
  const float qx = queries[qrow * 3 + 0], qy = queries[qrow * 3 + 1],
              qz = queries[qrow * 3 + 2];
  const float gx = grad_out[qrow * 3 + 0], gy = grad_out[qrow * 3 + 1],
              gz = grad_out[qrow * 3 + 2];
  float px[K], py[K], pz[K], d[K], w[K];
  float den = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float* p = pb + static_cast<size_t>(idx[qrow * K + j]) * 3;
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
  float4* cq = contrib + static_cast<size_t>(b) * K * m + q;
  float2* eq = esd + static_cast<size_t>(b) * K * m + q;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float u = gx * px[j] + gy * py[j] + gz * pz[j];
    const float e = w[j] * (u - ubar);        // dL/d(-d_j / s)
    const float two_dd = -2.0f * e / s;       // 2 dL/dd_j
    const float ex = px[j] - qx, ey = py[j] - qy, ez = pz[j] - qz;
    const float cx = w[j] * gx + two_dd * ex;
    const float cy = w[j] * gy + two_dd * ey;
    const float cz = w[j] * gz + two_dd * ez;
    cq[static_cast<size_t>(j) * m] = make_float4(cx, cy, cz, 0.0f);
    eq[static_cast<size_t>(j) * m] = make_float2(e, d[j] - d[0]);
    dqx -= two_dd * ex;
    dqy -= two_dd * ey;
    dqz -= two_dd * ez;
  }
  dqueries[qrow * 3 + 0] = dqx;
  dqueries[qrow * 3 + 1] = dqy;
  dqueries[qrow * 3 + 2] = dqz;
}

// The wide backward (k > kMaxK), first kernel: a group of G lanes a
// query (G = 8 for k up to 64, four queries a warp; else 32, a warp), over
// a flat grid of all B*M queries, `warps` warps a block (from the plan).
// Lane l of a group holds ranks l, l + G, ... (J a lane in registers,
// kWideRanks at most: k above 32 * kWideRanks rereads its ranks in
// batches of G * J for each pass), gathering each neighbour once. The
// query's sums (the weights' total and the weighted points, then d
// queries and its d sigma^2 term) are carried in float64, since with more
// neighbours their f32 round-off grows past the tolerances the k <= 16
// kernels meet (1/17 is inexact, and u - ubar cancels): a lane adds its
// ranks in order, then the group's G partials meet in a butterfly of
// shuffles (xor G/2, ..., 2, 1), where each lane adds its partner's value
// to its own, so every lane holds the same bits; G and J follow from k
// alone, so no order depends on the launch plan. Each distance and weight
// term is the f32 one of the k <= 16 kernel; the outputs are rounded to
// f32 once. It writes each entry's contribution to d points in entry order
// (contrib [B, M, k] of float4: a group's stores are contiguous) and the
// query's d sigma^2 term e . (d - d_0) (dsq [B, M], float64); no other
// workspace.
template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Query qrow of the wide backward, served by a group of G lanes (this
// lane the group's lane gl): put(j, point, contribution) for each rank j
// the lane holds, and the group's sums of d queries and of the d sigma^2
// term, the same bits in every lane of the group.
template <int G, int J, class Put>
__device__ __forceinline__ void wide_query(const float* __restrict__ points,
                                           const float* __restrict__ queries,
                                           const float* __restrict__ sigma,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ grad_out,
                                           int n, int m, int k, size_t qrow,
                                           int gl, Put put, double (&dq)[3],
                                           double& ds) {
  const int b = static_cast<int>(qrow / m);
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  const int* iq = idx + qrow * k;
  const float s = *sigma;
  const float qx = queries[qrow * 3 + 0], qy = queries[qrow * 3 + 1],
              qz = queries[qrow * 3 + 2];
  const double gx = grad_out[qrow * 3 + 0], gy = grad_out[qrow * 3 + 1],
               gz = grad_out[qrow * 3 + 2];
  const float* p0 = pb + static_cast<size_t>(__ldg(iq)) * 3;
  const float d0 = sqdist(qx, qy, qz, p0[0], p0[1], p0[2]);
  const int batches = (k + G * J - 1) / (G * J);
  float px[J], py[J], pz[J], d[J], tw[J];  // tw: the weight terms w~
  int pi[J];
  auto rank = [&](int bt, int i) { return bt * G * J + G * i + gl; };
  // rank(bt, i) into slot i
  auto gather = [&](int bt) {
#pragma unroll
    for (int i = 0; i < J; ++i) {
      if (rank(bt, i) < k) {
        pi[i] = __ldg(iq + rank(bt, i));
        const float* p = pb + static_cast<size_t>(pi[i]) * 3;
        px[i] = p[0];
        py[i] = p[1];
        pz[i] = p[2];
        d[i] = sqdist(qx, qy, qz, px[i], py[i], pz[i]);
      }
    }
  };
  if (batches == 1) gather(0);
  double den = 0.0, tx = 0.0, ty = 0.0, tz = 0.0;  // sum w~, sum w~ p
  for (int bt = 0; bt < batches; ++bt) {
    if (batches > 1) gather(bt);
#pragma unroll
    for (int i = 0; i < J; ++i) {
      if (rank(bt, i) < k) {
        tw[i] = softmax_term(d[i], d0, s);
        const double t = tw[i];
        den += t;
        tx += t * px[i];
        ty += t * py[i];
        tz += t * pz[i];
      }
    }
  }
  den = group_sum<G>(den);
  tx = group_sum<G>(tx);
  ty = group_sum<G>(ty);
  tz = group_sum<G>(tz);
  const double inv = 1.0 / den;  // w_j = w~_j / den
  const double ubar = (gx * tx + gy * ty + gz * tz) * inv;
  const double two_s = -2.0 / s;   // 2 dL/dd_j = e_j * two_s
  double dqx = 0.0, dqy = 0.0, dqz = 0.0, dsl = 0.0;
  for (int bt = 0; bt < batches; ++bt) {
    if (batches > 1) gather(bt);
#pragma unroll
    for (int i = 0; i < J; ++i) {
      if (rank(bt, i) >= k) continue;
      if (batches > 1) tw[i] = softmax_term(d[i], d0, s);
      const double w = tw[i] * inv;
      const double u = gx * px[i] + gy * py[i] + gz * pz[i];
      const double e = w * (u - ubar);              // dL/d(-d_j / s)
      const double two_dd = e * two_s;              // 2 dL/dd_j
      const double ex = static_cast<double>(px[i]) - qx,
                   ey = static_cast<double>(py[i]) - qy,
                   ez = static_cast<double>(pz[i]) - qz;
      put(rank(bt, i), pi[i],
          make_float4(static_cast<float>(w * gx + two_dd * ex),
                      static_cast<float>(w * gy + two_dd * ey),
                      static_cast<float>(w * gz + two_dd * ez), 0.0f));
      dqx -= two_dd * ex;
      dqy -= two_dd * ey;
      dqz -= two_dd * ez;
      dsl += e * (d[i] - d0);
    }
  }
  dq[0] = group_sum<G>(dqx);
  dq[1] = group_sum<G>(dqy);
  dq[2] = group_sum<G>(dqz);
  ds = group_sum<G>(dsl);
}

template <int G, int J>
__global__ void __launch_bounds__(kWideBwdWarps * 32, J <= 4 ? 4 : 2)
soft_project_bwd_entries_warp(const float* __restrict__ points,    // [B, n, 3]
                              const float* __restrict__ queries,   // [B, m, 3]
                              const float* __restrict__ sigma,     // [1]
                              const int* __restrict__ idx,         // [B, m, k]
                              const float* __restrict__ grad_out,  // [B, m, 3]
                              float* __restrict__ dqueries,        // [B, m, 3]
                              float4* __restrict__ contrib,        // [B, m, k]
                              double* __restrict__ dsq,            // [B, m]
                              int n, int m, int k, long long total) {
  const int lane = threadIdx.x & 31, gl = lane % G;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp * (32 / G) >= total) return;  // the whole warp
  const long long g = warp * (32 / G) + lane / G;
  const bool live = g < total;  // a group past the last query runs it again
  const size_t qrow = static_cast<size_t>(live ? g : total - 1);
  float4* cq = contrib + qrow * k;
  double dq[3], ds;
  wide_query<G, J>(points, queries, sigma, idx, grad_out, n, m, k, qrow, gl,
                   [&](int j, int, float4 c) {
                     if (live) cq[j] = c;
                   },
                   dq, ds);
  if (live && gl == 0) {
    dqueries[qrow * 3 + 0] = static_cast<float>(dq[0]);
    dqueries[qrow * 3 + 1] = static_cast<float>(dq[1]);
    dqueries[qrow * 3 + 2] = static_cast<float>(dq[2]);
    dsq[qrow] = ds;
  }
}

// d sigma^2 of cloud b from its queries' terms db[0..m) (global or shared
// memory), by the whole block: 256 stripes of queries (q = s mod 256),
// each adding its queries' terms in order, then a 256-way tree, in
// float64; thread 0 writes the partial (the caller sums the clouds').
__device__ void cloud_dsigma(const double* db, int m, const float* sigma,
                             double* red, float* dsigma_b) {
  const int t = threadIdx.x, threads = blockDim.x;
  for (int st = t; st < kStripes; st += threads) {
    double v = 0.0;
    for (int q = st; q < m; q += kStripes) v += db[q];
    red[st] = v;
  }
  __syncthreads();
  for (int half = kStripes / 2; half > 0; half >>= 1) {
    for (int st = t; st < half; st += threads) red[st] += red[st + half];
    __syncthreads();
  }
  if (t == 0) {
    const double s = *sigma;
    *dsigma_b = static_cast<float>(red[0] / (s * s));
  }
}

// The exclusive scan of cnt[0..np) into off[0..np] and cur (cur's counts
// become each segment's start), by the whole block: `per` consecutive
// counts a thread, then the warps' totals (wtot, a slot a warp).
__device__ void block_scan(int* cnt, int* off, int np, int* wtot) {
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int per = (np + threads - 1) / threads;
  int mine = 0;
  for (int i = 0; i < per; ++i) {
    const int pp = t * per + i;
    if (pp < np) mine += cnt[pp];
  }
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wtot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int v = lane < warps ? wtot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += x;
    }
    if (lane < warps) wtot[lane] = v;
  }
  __syncthreads();
  int at = (wid > 0 ? wtot[wid - 1] : 0) + incl - mine;
  for (int i = 0; i < per; ++i) {
    const int pp = t * per + i;
    if (pp < np) {
      const int c = cnt[pp];
      off[pp] = at;
      cnt[pp] = at;
      at += c;
    }
  }
  if (t == 0) off[np] = wtot[warps - 1];
}

// Thread t's points t + r * threads (r < kWidePointsPer, below np): each
// segment [off[p], off[p + 1]) of list sorted by entry, then its
// contributions cw[entry] added to the point's sum in that order.
__device__ __forceinline__ void add_segments(int* list, const int* off,
                                             const float4* cw, int np,
                                             float (&ax)[kWidePointsPer],
                                             float (&ay)[kWidePointsPer],
                                             float (&az)[kWidePointsPer]) {
#pragma unroll
  for (int r = 0; r < kWidePointsPer; ++r) {
    const int pp = threadIdx.x + r * blockDim.x;
    if (pp >= np) break;
    const int a = off[pp], z = off[pp + 1];
    for (int i = a + 1; i < z; ++i) {  // the segment in entry order
      const int v = list[i];
      int j = i - 1;
      while (j >= a && list[j] > v) {
        list[j + 1] = list[j];
        --j;
      }
      list[j + 1] = v;
    }
    for (int i = a; i < z; ++i) {
      const float4 c = cw[list[i]];
      ax[r] += c.x;
      ay[r] += c.y;
      az[r] += c.z;
    }
  }
}

// The wide backward in one kernel, where a block holds a cloud: its M*k
// contributions (and each one's point) in shared memory, and its N points
// at most kWidePointsPer a thread. Block b: the groups of its warps take
// the cloud's queries in turn (wide_query, as the entries kernel), each
// lane counting its entries' points; then the point kernel's scan,
// places, sorted segments and sums in entry order, over the whole cloud
// at once, and d sigma^2 from the queries' terms. The same values in the
// same orders as the two kernels: the same bits, without the
// contributions' round trip through device memory.
template <int G, int J>
__global__ void __launch_bounds__(kWideBwdWarps * 32, J <= 4 ? 4 : 2)
soft_project_bwd_fused(const float* __restrict__ points,    // [B, n, 3]
                       const float* __restrict__ queries,   // [B, m, 3]
                       const float* __restrict__ sigma,     // [1]
                       const int* __restrict__ idx,         // [B, m, k]
                       const float* __restrict__ grad_out,  // [B, m, 3]
                       float* __restrict__ dpoints,         // [B, n, 3]
                       float* __restrict__ dqueries,        // [B, m, 3]
                       float* __restrict__ dsigma,          // [B]
                       int n, int m, int k) {
  extern __shared__ float4 fsm4[];
  __shared__ double red[kStripes];
  __shared__ int wtot[kWideBwdWarps];
  const int entries = m * k;
  float4* cw = fsm4;                                       // [entries]
  double* dsq = reinterpret_cast<double*>(cw + entries);  // [m]
  int* pw = reinterpret_cast<int*>(dsq + m);              // [entries]: points
  int* list = pw + entries;                               // [entries]
  int* off = list + entries;                              // [n + 1]
  int* cur = off + n + 1;                                 // [n]
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int threads = blockDim.x;
  for (int i = t; i < n; i += threads) cur[i] = 0;
  __syncthreads();
  const int per_pass = (threads >> 5) * (32 / G);  // queries a pass
  for (int q0 = 0; q0 < m; q0 += per_pass) {
    const int first = q0 + wid * (32 / G);
    if (first >= m) continue;  // the whole warp
    const int q = first + lane / G;
    const bool live = q < m;  // a group past the last query runs it again
    const size_t qrow = static_cast<size_t>(b) * m + (live ? q : m - 1);
    const int gl = lane % G;
    double dq[3], ds;
    wide_query<G, J>(points, queries, sigma, idx, grad_out, n, m, k, qrow, gl,
                     [&](int j, int p, float4 c) {
                       if (!live) return;
                       const bool on = static_cast<unsigned>(p) < static_cast<unsigned>(n);
                       pw[q * k + j] = on ? p : -1;
                       if (on) {
                         cw[q * k + j] = c;
                         atomicAdd(cur + p, 1);
                       }
                     },
                     dq, ds);
    if (live && gl == 0) {
      dqueries[qrow * 3 + 0] = static_cast<float>(dq[0]);
      dqueries[qrow * 3 + 1] = static_cast<float>(dq[1]);
      dqueries[qrow * 3 + 2] = static_cast<float>(dq[2]);
      dsq[q] = ds;
    }
  }
  __syncthreads();
  cloud_dsigma(dsq, m, sigma, red, dsigma + b);
  block_scan(cur, off, n, wtot);
  __syncthreads();
  for (int e = t; e < entries; e += threads) {
    const int p = pw[e];
    if (static_cast<unsigned>(p) < static_cast<unsigned>(n)) {
      list[atomicAdd(cur + p, 1)] = e;
    }
  }
  __syncthreads();
  float ax[kWidePointsPer], ay[kWidePointsPer], az[kWidePointsPer];
#pragma unroll
  for (int r = 0; r < kWidePointsPer; ++r) ax[r] = ay[r] = az[r] = 0.0f;
  add_segments(list, off, cw, n, ax, ay, az);
  float* out = dpoints + static_cast<size_t>(b) * n * 3;
#pragma unroll
  for (int r = 0; r < kWidePointsPer; ++r) {
    const int pp = t + r * threads;
    if (pp < n) {
      out[pp * 3 + 0] = ax[r];
      out[pp * 3 + 1] = ay[r];
      out[pp * 3 + 2] = az[r];
    }
  }
}

// The wide backward's second kernel: d points of `span` points of one
// cloud a block, each point's entries added in entry order; block
// ranges * b + r takes range r of cloud b, and the block of range 0 also
// sums the cloud's d sigma^2. A block takes its cloud's M*k entries in
// windows of kWindowPer * threads, in order, each thread holding
// kWindowPer idx loads. In a window it keeps only the entries on its own
// points: a count a point (shared-memory int atomics), their
// contributions staged in shared memory by coalesced loads, an exclusive
// scan of the counts, then each such entry placed in its point's segment
// of the window's list (an int atomic on the point's cursor, so a
// segment's order is arbitrary). The thread that owns a point (up to
// kWidePointsPer a thread, summed in registers) sorts its segment by
// entry (insertion: about M*k / N entries a point a window on k-NN input)
// and adds the staged contributions from +0.0f, on across windows: entry
// order, whatever the plan, and no float atomics. Shared memory holds the
// span's offsets and cursors and one window's contributions and list,
// never the cloud or its entries. d sigma^2: 256 stripes of queries (q =
// s mod 256), each adding its queries' terms in order, then a 256-way
// tree, in float64; the caller sums the clouds' partials.
__global__ void __launch_bounds__(kWidePointThreads)
soft_project_bwd_points_wide(const int* __restrict__ idx,         // [B, m, k]
                             const float4* __restrict__ contrib,  // [B, m, k]
                             const double* __restrict__ dsq,      // [B, m]
                             const float* __restrict__ sigma,     // [1]
                             float* __restrict__ dpoints,         // [B, n, 3]
                             float* __restrict__ dsigma,          // [B]
                             int n, int m, int k, int span) {
  extern __shared__ float4 wsm4[];
  __shared__ double red[kStripes];
  __shared__ int wtot[kWidePointThreads / 32];
  const int ranges = (n + span - 1) / span;
  const int b = static_cast<int>(blockIdx.x / static_cast<unsigned>(ranges));
  const int range = static_cast<int>(blockIdx.x - b * static_cast<unsigned>(ranges));
  const int t = threadIdx.x, threads = blockDim.x;

  if (range == 0) {  // d sigma^2 of cloud b
    cloud_dsigma(dsq + static_cast<size_t>(b) * m, m, sigma, red, dsigma + b);
  }

  const long long entries = static_cast<long long>(m) * k;
  const int window = kWindowPer * threads;
  float4* cw = wsm4;                                  // [window]: contributions
  int* list = reinterpret_cast<int*>(cw + window);    // [window]: by point
  int* off = list + window;                           // [span + 1]: segments
  int* cur = off + span + 1;                          // [span]: counts, places
  const int p0 = range * span;
  const int np = min(span, n - p0);
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const float4* cb = contrib + static_cast<size_t>(b) * entries;
  float ax[kWidePointsPer], ay[kWidePointsPer], az[kWidePointsPer];
#pragma unroll
  for (int r = 0; r < kWidePointsPer; ++r) ax[r] = ay[r] = az[r] = 0.0f;

  for (long long w0 = 0; w0 < entries; w0 += window) {
    for (int i = t; i < np; i += threads) cur[i] = 0;
    int p[kWindowPer];  // entry w0 + u * threads + t's point, from p0
#pragma unroll
    for (int u = 0; u < kWindowPer; ++u) {
      const long long e = w0 + u * threads + t;
      p[u] = e < entries ? __ldg(ib + e) - p0 : -1;
    }
    __syncthreads();  // cur is clear; the last window's sums are done
#pragma unroll
    for (int u = 0; u < kWindowPer; ++u) {
      if (static_cast<unsigned>(p[u]) < static_cast<unsigned>(np)) {
        atomicAdd(cur + p[u], 1);
        cw[u * threads + t] = __ldg(cb + w0 + u * threads + t);
      }
    }
    __syncthreads();
    block_scan(cur, off, np, wtot);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kWindowPer; ++u) {
      if (static_cast<unsigned>(p[u]) < static_cast<unsigned>(np)) {
        list[atomicAdd(cur + p[u], 1)] = u * threads + t;
      }
    }
    __syncthreads();
    add_segments(list, off, cw, np, ax, ay, az);
  }
  __syncthreads();  // the window's contributions are read: stage the rows
  float* stage = reinterpret_cast<float*>(cw);  // [span * 3] <= window * 4
#pragma unroll
  for (int r = 0; r < kWidePointsPer; ++r) {
    const int pp = t + r * threads;
    if (pp < np) {
      stage[pp * 3 + 0] = ax[r];
      stage[pp * 3 + 1] = ay[r];
      stage[pp * 3 + 2] = az[r];
    }
  }
  __syncthreads();
  float* out = dpoints + (static_cast<size_t>(b) * n + p0) * 3;
  for (int i = t; i < np * 3; i += threads) out[i] = stage[i];
}

// d points of `span` points of one cloud a block, in entry order: block
// (ranges + 1) * b + r takes range r of cloud b, and r = ranges sums the
// cloud's d sigma^2. K = 0 takes k at run time (k_run).
// Count numbers a cloud's entries: int, or long long where M * k passes
// what an int holds with a round to spare (soft_project_bwd_points64).
template <int K, class Count>
__device__ __forceinline__ void bwd_points(const int* __restrict__ idx,
                                           const float4* __restrict__ contrib,
                                           const float2* __restrict__ esd,
                                           const float* __restrict__ sigma,
                                           float* __restrict__ dpoints,
                                           float* __restrict__ dsigma, int n,
                                           int m, int span, int k_run) {
  const int k = K > 0 ? K : k_run;
  extern __shared__ float4 bsm[];
  __shared__ int wcnt[kMaxPointThreads / 32];  // a round's list, by warp
  __shared__ float red[kStripes];
  const int ranges = (n + span - 1) / span;
  const int b = static_cast<int>(blockIdx.x / (ranges + 1));
  const int range = static_cast<int>(blockIdx.x - b * (ranges + 1u));
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int threads = blockDim.x, warps = threads >> 5;

  if (range == ranges) {  // d sigma^2 of cloud b
    const float2* eb = esd + static_cast<size_t>(b) * k * m;
    for (int st = t; st < kStripes; st += threads) {
      float ds = 0.0f;
#pragma unroll 1
      for (int q = st; q < m; q += kStripes) {
        if constexpr (K > 0) {
          float2 x[K];  // the query's k terms in flight together
#pragma unroll
          for (int j = 0; j < K; ++j) x[j] = eb[static_cast<size_t>(j) * m + q];
#pragma unroll
          for (int j = 0; j < K; ++j) ds += x[j].x * x[j].y;
        } else {
          for (int j = 0; j < k; ++j) {
            const float2 x = eb[static_cast<size_t>(j) * m + q];
            ds += x.x * x.y;
          }
        }
      }
      red[st] = ds;
    }
    __syncthreads();
    for (int half = kStripes / 2; half > 0; half >>= 1) {
      for (int st = t; st < half; st += threads) red[st] += red[st + half];
      __syncthreads();
    }
    if (t == 0) {
      const float s = *sigma;
      dsigma[b] = red[0] / (s * s);
    }
    return;
  }

  const Count entries = static_cast<Count>(m) * k;
  const int round = 32 * kUnroll * warps;  // entries a round
  const int cap = static_cast<int>(
      min(static_cast<Count>(round), entries));  // the list's room
  unsigned* hit = reinterpret_cast<unsigned*>(bsm);  // [span]: warps with
  unsigned* mask = hit + span;                       // [warps, span] lanes
  float4* lc = reinterpret_cast<float4*>(mask + warps * span);  // [cap]
  int* lp = reinterpret_cast<int*>(lc + cap);                   // [cap]
  float* stage = reinterpret_cast<float*>(lc);  // [span * 3], at the end
  const int p0 = range * span;
  const int np = min(span, n - p0);
  const int per = span / threads;
  const float4* cb = contrib + static_cast<size_t>(b) * k * m;
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const unsigned below = (1u << lane) - 1u;
  for (int i = t; i < span; i += threads) hit[i] = 0u;
  float ax[kMaxPer], ay[kMaxPer], az[kMaxPer];
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) ax[r] = ay[r] = az[r] = 0.0f;

  // lane `lane` of warp wid takes entries r0 + 32 * (kUnroll * wid + u) +
  // lane, u < kUnroll: the warp's share of a round, in entry order
  const int mine = 32 * kUnroll * wid + lane;
  int p[kUnroll];  // this round's points, relative to p0
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Count e = mine + 32 * u;
    p[u] = e < entries ? __ldg(ib + e) - p0 : -1;
  }
  for (Count r0 = 0; r0 < entries; r0 += round) {
    int pn[kUnroll];  // the next round's, in flight meanwhile
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Count e = r0 + round + mine + 32 * u;
      pn[u] = e < entries ? __ldg(ib + e) - p0 : -1;
    }
    // the warp's entries on the block's points, and their contributions
    unsigned vote[kUnroll];
    float4 c[kUnroll];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = static_cast<unsigned>(p[u]) < static_cast<unsigned>(np);
      vote[u] = __ballot_sync(kFull, in);
      c[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        const Count e = r0 + mine + 32 * u;
        const Count q = e / k;
        const int j = static_cast<int>(e - q * k);
        c[u] = cb[static_cast<size_t>(j) * m + static_cast<size_t>(q)];
      }
      cnt += __popc(vote[u]);
    }
    if (lane == 0) wcnt[wid] = cnt;
    __syncthreads();
    int at = 0, total = 0;
    for (int w = 0; w < warps; ++w) {
      at += w < wid ? wcnt[w] : 0;
      total += wcnt[w];
    }
    // the round's list in entry order: ballot and popc
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (static_cast<unsigned>(p[u]) < static_cast<unsigned>(np)) {
        lc[at + __popc(vote[u] & below)] = c[u];
        lp[at + __popc(vote[u] & below)] = p[u];
      }
      at += __popc(vote[u]);
      p[u] = pn[u];
    }
    __syncthreads();
    // `threads` entries a slice: each warp groups its lanes by point; the
    // group's lowest lane writes the group's lanes for the point's owner
    for (int c0 = 0; c0 < total; c0 += threads) {
      const int key = c0 + t < total ? lp[c0 + t] : -1;
      const unsigned peers = __match_any_sync(kFull, key);
      if (key >= 0 && (peers & below) == 0u) {
        mask[wid * span + key] = peers;
        atomicOr(hit + key, 1u << wid);  // a flag: the result is not read
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kMaxPer; ++r) {
        const int pp = t + r * threads;
        if (r >= per || pp >= np) continue;
        unsigned hw = hit[pp];
        if (hw == 0u) continue;
        hit[pp] = 0u;
        do {  // warp by warp, lane by lane: entry order
          const int w = __ffs(hw) - 1;
          hw &= hw - 1u;
          unsigned mk = mask[w * span + pp];
          do {
            const float4 v = lc[c0 + 32 * w + __ffs(mk) - 1];
            mk &= mk - 1u;
            ax[r] += v.x;
            ay[r] += v.y;
            az[r] += v.z;
          } while (mk != 0u);
        } while (hw != 0u);
      }
      __syncthreads();  // hit is clear, lc and lp are read
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxPer; ++r) {
    const int pp = t + r * threads;
    if (r < per && pp < np) {
      stage[pp * 3 + 0] = ax[r];
      stage[pp * 3 + 1] = ay[r];
      stage[pp * 3 + 2] = az[r];
    }
  }
  __syncthreads();
  float* out = dpoints + (static_cast<size_t>(b) * n + p0) * 3;
  for (int i = t; i < np * 3; i += threads) out[i] = stage[i];
}

template <int K>
__global__ void __launch_bounds__(kMaxPointThreads, 4)
soft_project_bwd_points(const int* __restrict__ idx,         // [B, m, k]
                        const float4* __restrict__ contrib,  // [B, k, m]
                        const float2* __restrict__ esd,      // [B, k, m]
                        const float* __restrict__ sigma,     // [1]
                        float* __restrict__ dpoints,         // [B, n, 3]
                        float* __restrict__ dsigma,          // [B] partials
                        int n, int m, int span, int k_run) {
  bwd_points<K, int>(idx, contrib, esd, sigma, dpoints, dsigma, n, m, span,
                     k_run);
}

// Clouds of more entries than an int numbers, k <= kMaxK: the same sums in the
// same orders (the d sigma^2 loop of K = 0 adds a query's terms in rank
// order, as the unrolled one of K > 0 does).
__global__ void __launch_bounds__(kMaxPointThreads, 4)
soft_project_bwd_points64(const int* __restrict__ idx,
                          const float4* __restrict__ contrib,
                          const float2* __restrict__ esd,
                          const float* __restrict__ sigma,
                          float* __restrict__ dpoints,
                          float* __restrict__ dsigma, int n, int m, int span,
                          int k_run) {
  bwd_points<0, long long>(idx, contrib, esd, sigma, dpoints, dsigma, n, m,
                           span, k_run);
}

size_t fwd_smem(int chunk) {
  return static_cast<size_t>(chunk) * sizeof(float4);
}

template <int K>
cudaError_t launch_fwd(const float* points, const float* queries,
                       const float* sigma, float* out, int* idx, int b, int n,
                       int m, int chunk, int warps, int slices,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(chunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        soft_project_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int per_block = 32 * warps / slices;  // queries
  const dim3 grid(b, (m + per_block - 1) / per_block);
  soft_project_fwd_kernel<K><<<grid, 32 * warps, smem, stream>>>(
      points, queries, sigma, out, idx, n, m, chunk, slices);
  return cudaGetLastError();
}

// Dynamic shared memory of a point block, as the kernel lays it out: the
// [span] hit flags and [warps, span] lane masks, then a round's list
// (contribution and point, at most min(round, M*k) entries), which the
// staged rows of d points later reuse.
size_t bwd_smem(int threads, int span, long long entries) {
  const size_t warps = threads / 32;
  const size_t round = 32 * kUnroll * warps;
  const size_t cap = round < static_cast<size_t>(entries)
                         ? round
                         : static_cast<size_t>(entries);
  const size_t list = cap * (sizeof(float4) + sizeof(int));
  const size_t stage = static_cast<size_t>(span) * 3 * sizeof(float);
  return (warps + 1) * span * sizeof(unsigned) + (list > stage ? list : stage);
}

// Entries a cloud the int-counted point kernels take: with a round to
// spare, so that no entry number they form passes INT_MAX.
constexpr long long kIntEntries = INT_MAX - 32 * kUnroll * kMaxPointThreads;

// Dynamic shared memory of a fused wide backward block: the cloud's
// contributions (float4), its queries' d sigma^2 terms (double), each
// entry's point and the list, then the offsets [n + 1] and cursors [n].
size_t bwd_fused_smem(int n, int m, int k) {
  const size_t entries = static_cast<size_t>(m) * k;
  return entries * (sizeof(float4) + 2 * sizeof(int)) + m * sizeof(double) +
         (2 * static_cast<size_t>(n) + 1) * sizeof(int);
}

// Dynamic shared memory of a wide point block: a window's contributions
// (float4) and list, then the span's offsets [span + 1] and cursors [span].
size_t bwd_wide_smem(int threads, int span) {
  return static_cast<size_t>(kWindowPer) * threads * (sizeof(float4) + sizeof(int)) +
         (2 * static_cast<size_t>(span) + 1) * sizeof(int);
}

// K = 1..kMaxK. A cloud of more than kIntEntries entries, or a plan's
// count64, takes soft_project_bwd_points64.
template <int K>
cudaError_t launch_bwd(const float* points, const float* queries,
                       const float* sigma, const int* idx,
                       const float* grad_out, float* dpoints, float* dqueries,
                       float* dsigma, float4* contrib, float2* esd, int b,
                       int n, int m, int k, int tile, int threads, int span,
                       bool count64, cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * m;
  const unsigned blocks = static_cast<unsigned>((total + tile - 1) / tile);
  soft_project_bwd_entries<K><<<blocks, tile, 0, stream>>>(
      points, queries, sigma, idx, grad_out, dqueries, contrib, esd, n, m,
      total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long entries = static_cast<long long>(m) * k;
  const size_t smem = bwd_smem(threads, span, entries);
  const bool wide_count = count64 || entries > kIntEntries;
  const void* points_kernel =
      wide_count ? reinterpret_cast<const void*>(soft_project_bwd_points64)
                 : reinterpret_cast<const void*>(soft_project_bwd_points<K>);
  if (smem + kPointStatic > 48 * 1024) {
    err = cudaFuncSetAttribute(points_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>(b) * ((n + span - 1) / span + 1);
  if (wide_count) {
    soft_project_bwd_points64<<<grid, threads, smem, stream>>>(
        idx, contrib, esd, sigma, dpoints, dsigma, n, m, span, k);
  } else {
    soft_project_bwd_points<K><<<grid, threads, smem, stream>>>(
        idx, contrib, esd, sigma, dpoints, dsigma, n, m, span, k);
  }
  return cudaGetLastError();
}

// K = 1..kMaxK on the register kernels, any other k on `WIDE`.
#define SNT_SWITCH_K(k, CALL, WIDE)  \
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
    default: return WIDE;      \
  }

}  // namespace

extern "C" size_t snt_soft_project_bwd_smem(int threads, int span,
                                            long long entries) {
  return bwd_smem(threads, span, entries);
}

// The backward's limits: 0 queries a block (tile), 1 threads a point
// block, 2 points a thread, 3 idx loads a lane holds a round, 4 the
// stripes of d sigma^2.
extern "C" int snt_soft_project_bwd_limit(int which) {
  const int limits[] = {kMaxTile, kMaxPointThreads, kMaxPer, kUnroll,
                        kStripes};
  return which >= 0 && which < 5 ? limits[which] : -1;
}

extern "C" size_t snt_soft_project_fwd_smem(int chunk) {
  return fwd_smem(chunk);
}

extern "C" int snt_soft_project_fwd_max_warps() { return kMaxWarps; }

extern "C" int snt_soft_project_fwd_max_slices() { return kMaxSlices; }

// chunk (points staged at a time, a multiple of 32), warps (a block has
// 32 * warps lanes) and slices (lanes a query, a power of two) come from
// the launch plan.
extern "C" int snt_soft_project_fwd(const float* points, const float* queries,
                                    const float* sigma, float* out, int* idx,
                                    int b, int n, int m, int k, int chunk,
                                    int warps, int slices,
                                    cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k > n || chunk < 32 || chunk % 32 != 0 ||
      warps < 1 || warps > kMaxWarps || slices < 1 || slices > kMaxSlices ||
      (slices & (slices - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define SNT_FWD(K)                                                          \
  static_cast<int>(launch_fwd<K>(points, queries, sigma, out, idx, b, n, m, \
                                 chunk, warps, slices, stream))
  SNT_SWITCH_K(k, SNT_FWD, static_cast<int>(cudaErrorInvalidValue))
#undef SNT_FWD
}

extern "C" int snt_soft_project_max_register_k() { return kMaxK; }

// The wide forward's limits: 0 the radix kernel's queries a block, 1 the
// pruned kernel's warps a block, 2 its group minima a lane, 3 its most
// group minima a query, 4 its most candidates a query, 5 its most blocks a
// cluster, 6 its most keys a lane caches, 7 its most points staged at a
// time.
extern "C" int snt_soft_project_fwd_wide_limit(int which) {
  const int limits[] = {kWideWarps, kPruneWarps, kSlots, kMaxGroups,
                        kMaxCap, kMaxCluster, kMaxVisits, kMaxPruneChunk};
  return which >= 0 && which < 8 ? limits[which] : -1;
}

extern "C" size_t snt_soft_project_fwd_pruned_smem(int ws, int cap,
                                                   int chunk, int span) {
  return prune_smem(ws, cap, chunk, span);
}

// The wide forward, any 1 <= k <= n. ws = 0: the radix kernel, one warp a
// query, kWideWarps a block. Otherwise the pruned kernel under the plan
// (ws, cs, groups, cap, chunk): ws warps a query in a block, cs blocks a
// cluster, G group minima and `cap` candidates a query, `chunk` points
// staged at a time; each block takes span = ceil(n / (cs * 32 * ws)) *
// 32 * ws points.
extern "C" int snt_soft_project_fwd_wide(const float* points,
                                         const float* queries,
                                         const float* sigma, float* out,
                                         int* idx, int b, int n, int m, int k,
                                         int ws, int cs, int groups, int cap,
                                         int chunk, cudaStream_t stream) {
  if (b < 1 || m < 1 || k < 1 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(b) * m;
  if (ws == 0) {
    const long long blocks = (total + kWideWarps - 1) / kWideWarps;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    soft_project_fwd_wide_kernel<<<static_cast<unsigned>(blocks),
                                   kWideWarps * 32, 0, stream>>>(
        points, queries, sigma, out, idx, n, m, k, total);
    return static_cast<int>(cudaGetLastError());
  }
  auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  if (!pow2(ws) || ws > kPruneWarps || !pow2(cs) || cs > kMaxCluster ||
      !pow2(groups) || groups < 64 || groups > kMaxGroups ||
      groups < ws * cs || k > groups || !pow2(cap) ||
      cap < groups || cap > kMaxCap || chunk < 256 * ws ||
      chunk % (256 * ws) != 0 || chunk > kMaxPruneChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PrunePlan pl;
  pl.ws = ws;
  pl.cs = cs;
  pl.groups = groups;
  pl.cap = cap;
  pl.chunk = chunk;
  const long long step = 32LL * ws * cs;
  pl.span = static_cast<int>((n + step - 1) / step * 32 * ws);
  pl.visits = prune_visits(ws, chunk, pl.span);
  pl.tiles = (m + kPruneWarps / ws - 1) / (kPruneWarps / ws);
  const long long blocks = static_cast<long long>(b) * pl.tiles * cs;
  if (pl.visits > kMaxVisits || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = prune_smem(ws, cap, chunk, pl.span);
  const void* kernel =
      cs > 1 ? reinterpret_cast<const void*>(soft_project_fwd_pruned_kernel<true>)
             : reinterpret_cast<const void*>(soft_project_fwd_pruned_kernel<false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kPruneWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaError_t err;
  if (cs > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, soft_project_fwd_pruned_kernel<true>,
                             points, queries, sigma, out, idx, n, m, k, pl);
  } else {
    err = cudaLaunchKernelEx(&cfg, soft_project_fwd_pruned_kernel<false>,
                             points, queries, sigma, out, idx, n, m, k, pl);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Any 1 <= k <= n: k <= kMaxK on the register kernels, above on the wide
// ones. contrib [B, k, M] float4 and esd [B, k, M] float2 are the caller's
// workspace; tile (queries a block of the first kernel), threads and span
// (points a block of the second, a multiple of threads, at most kMaxPer a
// thread) and count64 (entries counted in 64 bits, which more than
// kIntEntries a cloud need) come from the launch plan; the outputs do not
// depend on it.
extern "C" int snt_soft_project_bwd(const float* points, const float* queries,
                                    const float* sigma, const int* idx,
                                    const float* grad_out, float* dpoints,
                                    float* dqueries, float* dsigma,
                                    float* contrib, float* esd, int b, int n,
                                    int m, int k, int tile, int threads,
                                    int span, int count64,
                                    cudaStream_t stream) {
  if (k < 1 || k > n || b < 1 || m < 1 ||
      tile < 32 || tile > kMaxTile || tile % 32 != 0 || threads < 32 ||
      threads > kMaxPointThreads || threads % 32 != 0 || span < threads ||
      span % threads != 0 || span / threads > kMaxPer ||
      (static_cast<long long>(b) * m + tile - 1) / tile > INT_MAX ||
      static_cast<long long>(b) * ((n + span - 1) / span + 1) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float4* c4 = reinterpret_cast<float4*>(contrib);
  float2* e2 = reinterpret_cast<float2*>(esd);
#define SNT_BWD(K)                                                          \
  static_cast<int>(launch_bwd<K>(points, queries, sigma, idx, grad_out,     \
                                 dpoints, dqueries, dsigma, c4, e2, b, n,    \
                                 m, k, tile, threads, span, count64 != 0,   \
                                 stream))
  SNT_SWITCH_K(k, SNT_BWD, static_cast<int>(cudaErrorInvalidValue))
#undef SNT_BWD
}

// The wide backward's limits: 0 warps a block of its first kernel, 1
// ranks a lane holds, 2 threads and 3 points a block of its point kernel,
// 4 entries a thread a window, 5 the stripes of d sigma^2, 6 lanes a
// query up to k = 64, 7 points a thread of the point kernel, 8 the fused
// kernel's most entries a cloud.
extern "C" int snt_soft_project_bwd_wide_limit(int which) {
  const int limits[] = {kWideBwdWarps, kWideRanks, kWidePointThreads,
                        kWideSpan, kWindowPer, kStripes, kWideGroup,
                        kWidePointsPer, kFusedEntries};
  return which >= 0 && which < 9 ? limits[which] : -1;
}

extern "C" size_t snt_soft_project_bwd_wide_smem(int threads, int span) {
  return bwd_wide_smem(threads, span);
}

extern "C" size_t snt_soft_project_bwd_fused_smem(int n, int m, int k) {
  return bwd_fused_smem(n, m, k);
}

// The wide backward, any 1 <= k <= n (the wrapper sends it k > kMaxK):
// contrib [B, M, k] of float4 and dsq [B, M] of double are the caller's
// workspace, dsigma [B] the clouds' partials; warps (a block of the first
// kernel), threads and span (a block of the point kernel) come from the
// launch plan, or with `fused` one kernel of `threads` threads a cloud;
// the outputs do not depend on it.
extern "C" int snt_soft_project_bwd_wide(const float* points,
                                         const float* queries,
                                         const float* sigma, const int* idx,
                                         const float* grad_out, float* dpoints,
                                         float* dqueries, float* dsigma,
                                         float* contrib, double* dsq, int b,
                                         int n, int m, int k, int warps,
                                         int threads, int span, int fused,
                                         cudaStream_t stream) {
  if (fused) {
    if (k < 1 || k > n || b < 1 || m < 1 || threads < 32 ||
        threads > kWideBwdWarps * 32 || threads % 32 != 0 ||
        n > kWidePointsPer * threads ||
        static_cast<long long>(m) * k > kFusedEntries) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = bwd_fused_smem(n, m, k);
#define SNT_FUSED(G, J)                                                          \
  do {                                                                           \
    if (smem + kWideStatic > 48 * 1024) {                                        \
      const cudaError_t e = cudaFuncSetAttribute(                                \
          soft_project_bwd_fused<G, J>,                                          \
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));  \
      if (e != cudaSuccess) return static_cast<int>(e);                          \
    }                                                                            \
    soft_project_bwd_fused<G, J><<<b, threads, smem, stream>>>(                  \
        points, queries, sigma, idx, grad_out, dpoints, dqueries, dsigma, n, m, \
        k);                                                                      \
  } while (0)
    if (k <= 4 * kWideGroup) {
      SNT_FUSED(kWideGroup, 4);
    } else if (k <= kWideRanks * kWideGroup) {
      SNT_FUSED(kWideGroup, kWideRanks);
    } else if (k <= 4 * 32) {
      SNT_FUSED(32, 4);
    } else {
      SNT_FUSED(32, kWideRanks);
    }
#undef SNT_FUSED
    return static_cast<int>(cudaGetLastError());
  }
  if (k < 1 || k > n || b < 1 || m < 1 || warps < 1 ||
      warps > kWideBwdWarps || threads < 32 || threads > kWidePointThreads ||
      threads % 32 != 0 || span < 1 || span > kWideSpan ||
      span > kWidePointsPer * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(b) * m;
  const int group = k <= kWideRanks * kWideGroup ? kWideGroup : 32;
  const long long per_block = static_cast<long long>(warps) * (32 / group);
  const long long blocks = (total + per_block - 1) / per_block;
  const long long grid = static_cast<long long>(b) * ((n + span - 1) / span);
  if (blocks > INT_MAX || grid > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float4* c4 = reinterpret_cast<float4*>(contrib);
  // G lanes a query (group) and J ranks a lane, from k alone
#define SNT_ENTRIES(G, J)                                                    \
  soft_project_bwd_entries_warp<G, J><<<static_cast<unsigned>(blocks),       \
                                        32 * warps, 0, stream>>>(            \
      points, queries, sigma, idx, grad_out, dqueries, c4, dsq, n, m, k, total)
  if (k <= 4 * kWideGroup) {
    SNT_ENTRIES(kWideGroup, 4);
  } else if (k <= kWideRanks * kWideGroup) {
    SNT_ENTRIES(kWideGroup, kWideRanks);
  } else if (k <= 4 * 32) {
    SNT_ENTRIES(32, 4);
  } else {
    SNT_ENTRIES(32, kWideRanks);
  }
#undef SNT_ENTRIES
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_wide_smem(threads, span);
  if (smem + kWideStatic > 48 * 1024) {
    err = cudaFuncSetAttribute(soft_project_bwd_points_wide,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  soft_project_bwd_points_wide<<<static_cast<unsigned>(grid), threads, smem,
                                 stream>>>(idx, c4, dsq, sigma, dpoints,
                                           dsigma, n, m, k, span);
  return static_cast<int>(cudaGetLastError());
}
