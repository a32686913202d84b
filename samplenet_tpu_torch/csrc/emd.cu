// Approximate EMD: the 11-level auction match, its transport cost, and the
// analytic gradients of the cost with the match held fixed, without ever
// storing the [n, m] match.
//
// Replaces: samplenet_tpu/ops/pallas/emd_kernel.py::emd_cost_pallas (entry
//   :269; `pl.pallas_call` :225, body `_emd_kernel` :52-183).
//
// Semantics (kept exactly): levels L = -4^j for j = 8..-1, then 0. Row
// saturations satl start at max(n,m)//n, column saturations satr at
// max(n,m)//m. Per level, w_ij = exp(L * d2_ij) * satr_j scaled by
// satl_i / rowsum_i with rowsum_i = 1e-9 + sum_j exp(L * d2_ij) * satr_j;
// colsum_j = sum_i w_ij; ratio_j = min(satr_j / (1e-9 + colsum_j), 1);
// the level's mass wr_ij = w_ij * ratio_j; satl_i -= sum_j wr_ij and
// satr_j -= colsum_j * ratio_j, both clamped at 0. The cost adds
// sum wr_ij * d_ij with d = max(sqrt(max(d2, 0)), 1e-20), and with u =
// wr / d the gradients add g1_i += x1_i sum_j u_ij - sum_j u_ij x2_j and
// g2_j += x2_j sum_i u_ij - sum_i u_ij x1_i. d2 is sqdist.cuh's
// ((dx*dx + dy*dy) + dz*dz) without FMA contraction, as the plain version
// writes it: at |L| = 65536 the exp turns d2's error into the weight's,
// so the weights use the accurate expf. d and 1/d come from one rsqrtf of
// max(d2, 1e-40) (2 ulp, where the plain version takes an IEEE sqrt and
// divide): they enter only the cost and the gradients, never the match,
// and the IEEE sqrt and divide made the kernel 1.9x slower (PERF.md).
//
// Design. The TPU kernel walks one cloud per grid step, all rows in one
// program. Here a block takes kRows rows of one cloud (grid: row tiles x
// clouds, 1600 blocks at B=50, n=2048) and walks all m columns of it, the
// cloud's xyz2 and the column state (satr, ratio, next satr) held in shared
// memory with the block's rows; d2 is recomputed, never stored. The column
// sums of a level need every row of the cloud, so each level is one
// launch: blocks write per-tile partial column sums, and a small kernel
// adds them over the tiles in a fixed order and forms ratio and the next
// satr. As on the TPU, pass B of level l also computes the column sums of
// level l+1 (its row sums are stored per row and read by the next launch).
// Thread t owns columns t, t+256, ... and keeps their per-level sums in
// shared memory that only it touches; the row sums of 8 rows at a time are
// reduced across the block by warp shuffles and one pass over the warps'
// partials, and a column adds its sums 4 rows at a time. No float atomics:
// every sum has a fixed order, so two runs give the same bits.
//
// What bounds it on the H100: at B=50, n=m=2048 there are 210M pairs. The
// function needs, per pair, one rsqrt for d and 1/d and one exp for each of
// the 10 levels L != 0 (2.3G SFU operations: 0.55 ms at 16 per SM per
// clock, 132 SMs, 1.98 GHz), and each level's arithmetic once, 271 FLOP
// (57 GFLOP: 0.85 ms at 67 TFLOP/s); it moves 5 MB. So its bound is the
// FP32 rate (chip_smoke.py::_emd_bound). What the design does about it:
// at the steep levels (L = -65536 .. -64) most weights are exp of less
// than -104, which expf rounds to +0, and such a pair adds +0 to every sum.
// A warp's unit, 8 rows x 32 columns, is skipped whole where every pair
// underflows: first by the boxes of the row group and of the 32-column
// chunk (warp-uniform, before any d2: a lower bound on every pair's d2,
// rounded as sqdist rounds, so the test is exact), then by a vote on the
// pairs' own level * d2. The skip is bit-exact: the outputs equal those of
// the unit summed. The wrapper orders both clouds by Morton code, so that
// a row group and a chunk are each small in space and the boxes decide
// (emd_kernel.py::in_morton_order). The second sweep of a row group (the
// next level's column sums, after its row sums) recomputes d2 and the exp
// only for the units the first found live. Where the boxes show every
// pair live, no pair is tested. On the chip_smoke.py inputs the units
// skipped save 52% of the 20 exp per pair, on the AE step's pair 58%
// (tools/time_emd.py); the levels where no weight underflows run as
// before, at about 44% of the FP32 issue rate: 16 warps an SM (two blocks
// of 95 KB of shared memory, 128 registers a thread) do not hide the exp
// and shuffle latencies (PERF.md).

#include <cuda_runtime.h>

#include <math.h>

#include "sqdist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;   // rows of xyz1 per block
constexpr int kGroup = 8;   // rows that share one block reduction
// rows whose sum a column adds at once: the column sums round as they did
// with 4-row groups
constexpr int kColGroup = 4;
// The level kernel's row sums, each kGroup wide: the mass, the sum of u and
// of u x2 (3), the next level's rowsum; then one of the group's cost.
enum RowSum { kSumWr, kSumU, kSumUx, kSumNext = kSumUx + 3, kSumCost };
constexpr int kRed = kSumCost * kGroup + 1;
constexpr int kLevels = 11;
constexpr int kColThreads = 256;
constexpr int kMaxClouds = 65535;  // a launch's clouds: the grid's y axis
// expf(x) is +0 for every f32 x at or below this (snt_emd_underflow_check
// runs expf over all of them on the card): a warp's unit whose every
// level * d2 lies below it adds exact zeros, and is skipped.
constexpr float kUnderflow = -104.0f;
constexpr unsigned kFull = 0xffffffffu;

// v[k] summed over the block, into tot[k] for every thread to read. Sums in
// a fixed order: a shuffle butterfly inside each warp, then warps 0..7.
template <int V>
__device__ __forceinline__ void block_sum(float (&v)[V], float* red,
                                          float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    v[k] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) red[warp * V + k] = v[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < V; k += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * V + k];
    tot[k] = s;
  }
  __syncthreads();
}

// The accurate expf of the weights; exp(0 * d2) is 1 where d2 is finite
// and NaN where it is not, which is what expf gives there.
__device__ __forceinline__ float level_exp(float level, float d2) {
  if (level == 0.0f) return __fadd_rn(__fmul_rn(0.0f, d2), 1.0f);
  return expf(__fmul_rn(level, d2));
}

struct Shared {  // carved from dynamic shared memory, m columns
  float* x2;     // [3][m]
  float* satr;   // [m]
  float* ratio;  // [m]
  float* next;   // [m] satr of the next level
  float* acc_u;  // [m]    sum_i u_ij over this block's rows
  float* acc_ux; // [3][m] sum_i u_ij x1_i
  float* acc_col;// [m]    next level's column sums over this block's rows
  float* red;    // [kWarps][kRed]
  float* tot;    // [kRed]
  float* rows;   // [kRowVals][kRows] the block's rows: xyz, satl, rowsum, g1
  float* cbox;   // [chunks][6] each 32-column chunk's box: lo xyz, hi xyz
  int* ctame;    // [chunks] 1 where the chunk's coordinates are tame
};

enum RowVal { kX, kY, kZ, kSatl, kRowsum, kG1x, kG1y, kG1z, kRowVals };

__host__ __device__ constexpr int num_chunks(int m) { return (m + 31) / 32; }

__device__ Shared carve(float* smem, int m) {
  Shared s;
  s.x2 = smem;
  s.satr = s.x2 + 3 * m;
  s.ratio = s.satr + m;
  s.next = s.ratio + m;
  s.acc_u = s.next + m;
  s.acc_ux = s.acc_u + m;
  s.acc_col = s.acc_ux + 3 * m;
  s.red = s.acc_col + m;
  s.tot = s.red + kWarps * kRed;
  s.rows = s.tot + kRed;
  s.cbox = s.rows + kRowVals * kRows;
  s.ctame = reinterpret_cast<int*>(s.cbox + 6 * num_chunks(m));
  return s;
}

// A coordinate far enough from overflow that no d2 it enters is inf (3 *
// (2e18)^2 < FLT_MAX); false for inf and NaN.
__device__ __forceinline__ bool tame(float x) { return fabsf(x) <= 1e18f; }

// Stages the block's rows [begin, end) of cloud b (rows past `end` are 0
// with zero saturation and rowsum 1, so they carry no mass), with their
// rowsum and g1 where the kernel reads them, and each column chunk's box.
// Runs after x2 is in shared memory.
__device__ void stage(const Shared& s, const float* __restrict__ xyz1,
                      const float* __restrict__ satl,
                      const float* __restrict__ rowsum,
                      const float* __restrict__ g1, int b, int n, int m,
                      int begin, int end) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int i = begin + r;
    const bool ok = i < end;
    const size_t row = static_cast<size_t>(b) * n + i;
    for (int c = 0; c < 3; ++c) {
      s.rows[(kX + c) * kRows + r] = ok ? xyz1[row * 3 + c] : 0.0f;
      s.rows[(kG1x + c) * kRows + r] = ok && g1 ? g1[row * 3 + c] : 0.0f;
    }
    s.rows[kSatl * kRows + r] = ok ? satl[row] : 0.0f;
    s.rows[kRowsum * kRows + r] = ok && rowsum ? rowsum[row] : 1.0f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < num_chunks(m); c += kWarps) {
    const int j = 32 * c + lane;
    float lo[3], hi[3];
    bool ok = true;
    for (int a = 0; a < 3; ++a) {
      const float x = j < m ? s.x2[a * m + j] : 0.0f;
      ok = ok && tame(x);
      lo[a] = j < m ? x : INFINITY;
      hi[a] = j < m ? x : -INFINITY;
      for (int o = 16; o > 0; o >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], o));
      }
    }
    ok = __all_sync(kFull, ok);
    if (lane < 6) s.cbox[6 * c + lane] = lane < 3 ? lo[lane % 3] : hi[lane % 3];
    if (lane == 0) s.ctame[c] = ok;
  }
}

// Row group [r, r + kGroup) of the staged rows: its coordinates and box;
// false where a coordinate is not tame.
__device__ __forceinline__ bool load_group(const Shared& s, int r,
                                           float (&px)[kGroup],
                                           float (&py)[kGroup],
                                           float (&pz)[kGroup],
                                           float (&lo)[3], float (&hi)[3]) {
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = INFINITY;
    hi[a] = -INFINITY;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    px[g] = s.rows[kX * kRows + r + g];
    py[g] = s.rows[kY * kRows + r + g];
    pz[g] = s.rows[kZ * kRows + r + g];
    const float p[3] = {px[g], py[g], pz[g]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ok = ok && tame(p[a]);
      lo[a] = fminf(lo[a], p[a]);
      hi[a] = fmaxf(hi[a], p[a]);
    }
  }
  return ok;
}

// Bounds on the d2 of every pair of the row box and chunk c's box, rounded
// as sqdist rounds: each step of sqdist is monotone, so a pair's own d2 is
// at least `near` (from the gap between the boxes) and at most `far` (from
// their farthest corners).
__device__ __forceinline__ void box_range(const Shared& s, int c,
                                          const float (&lo)[3],
                                          const float (&hi)[3], float& near,
                                          float& far) {
  float gap[3], span[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float clo = s.cbox[6 * c + a], chi = s.cbox[6 * c + 3 + a];
    const float below = __fsub_rn(lo[a], chi), above = __fsub_rn(clo, hi[a]);
    gap[a] = fmaxf(fmaxf(below, above), 0.0f);
    span[a] = fmaxf(__fsub_rn(hi[a], clo), __fsub_rn(chi, lo[a]));
  }
  near = __fadd_rn(__fadd_rn(__fmul_rn(gap[0], gap[0]), __fmul_rn(gap[1], gap[1])),
                   __fmul_rn(gap[2], gap[2]));
  far = __fadd_rn(__fadd_rn(__fmul_rn(span[0], span[0]), __fmul_rn(span[1], span[1])),
                  __fmul_rn(span[2], span[2]));
}

// Pass A of the first level: each row's rowsum, and this tile's column sums
// of the normalised weights. Warp w's k-th unit is the row group x chunk c
// = w + kWarps * k, columns [32 c, 32 c + 32): lane l owns column 32 c + l.
// A unit whose weights underflow everywhere, by the boxes or pair by pair,
// adds +0 to every sum and is skipped; the second sweep recomputes only
// the units the first found live.
__global__ void __launch_bounds__(kThreads, 2)
emd_first_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                 int n, int m, float level, const float* __restrict__ satr,
                 const float* __restrict__ satl, float* __restrict__ rowsum,
                 float* __restrict__ colsum_part) {
  extern __shared__ float smem[];
  const Shared s = carve(smem, m);
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = num_chunks(m);
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const size_t col = static_cast<size_t>(b) * m + j;
    for (int c = 0; c < 3; ++c) s.x2[c * m + j] = xyz2[col * 3 + c];
    s.satr[j] = satr[col];
    s.acc_col[j] = 0.0f;
  }
  const int begin = tile * kRows, end = min(n, begin + kRows);
  __syncthreads();
  stage(s, xyz1, satl, nullptr, nullptr, b, n, m, begin, end);
  __syncthreads();
  for (int r0 = begin; r0 < end; r0 += kGroup) {
    const int r = r0 - begin;
    float px[kGroup], py[kGroup], pz[kGroup], lo[3], hi[3];
    const bool rtame = load_group(s, r, px, py, pz, lo, hi);
    float rs[kGroup] = {};
    unsigned live = 0;  // bit k: unit k has a weight that is not +0
    for (int k = 0, c = warp; c < chunks; ++k, c += kWarps) {
      // by the boxes (warp-uniform): the unit underflows everywhere (no
      // d2), or nowhere (no test pair by pair)
      bool live_all = false;
      if (rtame && s.ctame[c]) {
        float near, far;
        box_range(s, c, lo, hi, near, far);
        if (__fmul_rn(level, near) < kUnderflow) continue;
        live_all = !(__fmul_rn(level, far) < kUnderflow);
      }
      const int j = 32 * c + lane;
      const bool ok = j < m;
      const float ax = ok ? s.x2[j] : 0.0f, ay = ok ? s.x2[m + j] : 0.0f;
      const float az = ok ? s.x2[2 * m + j] : 0.0f;
      float d2[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) d2[g] = sqdist(px[g], py[g], pz[g], ax, ay, az);
      if (!live_all) {  // pair by pair
        bool dead = true;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) dead &= __fmul_rn(level, d2[g]) < kUnderflow;
        if (__all_sync(kFull, dead || !ok)) continue;
      }
      live |= 1u << k;
      if (ok) {
        const float sr = s.satr[j];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          rs[g] += __fmul_rn(level_exp(level, d2[g]), sr);
        }
      }
    }
    block_sum(rs, s.red, s.tot);
    float scale[kGroup], rsum[kGroup];
    bool finite = true;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      rsum[g] = __fadd_rn(1e-9f, s.tot[g]);
      scale[g] = __fdiv_rn(s.rows[kSatl * kRows + r + g], rsum[g]);
      finite &= isfinite(scale[g]);
    }
    // a unit of zeros adds +0 to the column sums where the scales are finite
    for (int k = 0, c = warp; c < chunks; ++k, c += kWarps) {
      const int j = 32 * c + lane;
      if (j < m && ((live >> k & 1u) || !finite)) {
        const float ax = s.x2[j], ay = s.x2[m + j], az = s.x2[2 * m + j];
        const float sr = s.satr[j];
#pragma unroll
        for (int h = 0; h < kGroup; h += kColGroup) {
          float col = 0.0f;
#pragma unroll
          for (int g = h; g < h + kColGroup; ++g) {
            const float d2 = sqdist(px[g], py[g], pz[g], ax, ay, az);
            col += __fmul_rn(__fmul_rn(level_exp(level, d2), sr), scale[g]);
          }
          s.acc_col[j] += col;
        }
      }
    }
    if (threadIdx.x < kGroup && r0 + threadIdx.x < end) {
      rowsum[static_cast<size_t>(b) * n + r0 + threadIdx.x] = rsum[threadIdx.x];
    }
  }
  for (int j = threadIdx.x; j < m; j += kThreads) {
    colsum_part[(static_cast<size_t>(b) * tiles + tile) * m + j] = s.acc_col[j];
  }
}

// Pass B of one level: apply the ratio, add the level's cost (and
// gradients), update satl, and (kNext) the next level's rowsum and this
// tile's next column sums. Units are skipped as in the first pass.
template <bool kGrads, bool kNext>
__global__ void __launch_bounds__(kThreads, 2)
emd_level_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                 int n, int m, float level, float next_level,
                 const float* __restrict__ satr, const float* __restrict__ ratio,
                 const float* __restrict__ satr_next, float* __restrict__ satl,
                 float* __restrict__ rowsum, float* __restrict__ colsum_part,
                 float* __restrict__ g2_part,   // [B, tiles, 3, m]
                 float* __restrict__ cost_part, // [B, tiles]
                 float* __restrict__ g1) {      // [B, n, 3]
  extern __shared__ float smem[];
  const Shared s = carve(smem, m);
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = num_chunks(m);
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const size_t col = static_cast<size_t>(b) * m + j;
    for (int c = 0; c < 3; ++c) s.x2[c * m + j] = xyz2[col * 3 + c];
    s.satr[j] = satr[col];
    s.ratio[j] = ratio[col];
    s.next[j] = satr_next[col];
    s.acc_u[j] = 0.0f;
    for (int c = 0; c < 3; ++c) s.acc_ux[c * m + j] = 0.0f;
    s.acc_col[j] = 0.0f;
  }
  const int begin = tile * kRows, end = min(n, begin + kRows);
  __syncthreads();
  stage(s, xyz1, satl, rowsum, kGrads ? g1 : nullptr, b, n, m, begin, end);
  __syncthreads();
  float blk_cost = 0.0f;  // thread 0's sum over its row groups, in order
  for (int r0 = begin; r0 < end; r0 += kGroup) {
    const int r = r0 - begin;
    float px[kGroup], py[kGroup], pz[kGroup], lo[3], hi[3];
    const bool rtame = load_group(s, r, px, py, pz, lo, hi);
    // A pair whose weight underflows adds exact zeros only where the row's
    // scale is finite (0 * inf or 0 * NaN is NaN).
    float sl[kGroup], scale[kGroup];
    bool rows_finite = true;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      sl[g] = s.rows[kSatl * kRows + r + g];
      scale[g] = __fdiv_rn(sl[g], s.rows[kRowsum * kRows + r + g]);
      rows_finite &= isfinite(scale[g]);
    }
    float v[kRed] = {};  // the row sums (RowSum)
    unsigned live_next = 0;  // bit k: unit k has a next weight not +0
    for (int k = 0, c = warp; c < chunks; ++k, c += kWarps) {
      // dead: this level's weight is +0 for every pair and d is finite, so
      // the pair adds +0 to every sum; dead_next: the next level's weight.
      // First by the boxes (warp-uniform, no d2), then pair by pair.
      // Where the boxes show every pair live, no test pair by pair.
      bool box_dead = false, box_dead_next = !kNext;
      bool live_all = false, live_all_next = false;
      if (rtame && s.ctame[c]) {
        float near, far;
        box_range(s, c, lo, hi, near, far);
        box_dead = rows_finite && __fmul_rn(level, near) < kUnderflow;
        box_dead_next = box_dead_next || __fmul_rn(next_level, near) < kUnderflow;
        live_all = !(__fmul_rn(level, far) < kUnderflow);
        live_all_next = !(__fmul_rn(next_level, far) < kUnderflow);
      }
      if (box_dead && box_dead_next) continue;
      const int j = 32 * c + lane;
      const bool ok = j < m;
      const float ax = ok ? s.x2[j] : 0.0f, ay = ok ? s.x2[m + j] : 0.0f;
      const float az = ok ? s.x2[2 * m + j] : 0.0f;
      float d2[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) d2[g] = sqdist(px[g], py[g], pz[g], ax, ay, az);
      bool live = !box_dead && live_all;
      if (!box_dead && !live_all) {  // pair by pair
        bool dead = rows_finite;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          dead &= __fmul_rn(level, d2[g]) < kUnderflow && d2[g] < INFINITY;
        }
        live = !__all_sync(kFull, dead || !ok);
      }
      bool live_next_unit = kNext && !box_dead_next && live_all_next;
      if (kNext && !box_dead_next && !live_all_next) {
        bool dead_next = true;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          dead_next &= __fmul_rn(next_level, d2[g]) < kUnderflow;
        }
        live_next_unit = !__all_sync(kFull, dead_next || !ok);
      }
      if (live && ok) {
        const float sr = s.satr[j], ra = s.ratio[j];
#pragma unroll
        for (int h = 0; h < kGroup; h += kColGroup) {
          float cu = 0.0f, cux = 0.0f, cuy = 0.0f, cuz = 0.0f;
#pragma unroll
          for (int g = h; g < h + kColGroup; ++g) {
            const float w = __fmul_rn(__fmul_rn(level_exp(level, d2[g]), sr),
                                      scale[g]);
            const float wr = __fmul_rn(w, ra);
            const float d2c = fmaxf(d2[g], 1e-40f);     // d >= 1e-20
            const float rd = rsqrtf(d2c);
            const float d = __fmul_rn(d2c, rd);
            v[kSumWr * kGroup + g] += wr;
            v[kSumCost * kGroup] = fmaf(wr, d, v[kSumCost * kGroup]);
            if (kGrads) {
              const float u = __fmul_rn(wr, rd);  // wr / d
              constexpr int x = kSumUx * kGroup, y = x + kGroup, z = y + kGroup;
              v[kSumU * kGroup + g] += u;
              v[x + g] = fmaf(u, ax, v[x + g]);
              v[y + g] = fmaf(u, ay, v[y + g]);
              v[z + g] = fmaf(u, az, v[z + g]);
              cu += u;
              cux = fmaf(u, px[g], cux);
              cuy = fmaf(u, py[g], cuy);
              cuz = fmaf(u, pz[g], cuz);
            }
          }
          if (kGrads) {
            s.acc_u[j] += cu;
            s.acc_ux[j] += cux;
            s.acc_ux[m + j] += cuy;
            s.acc_ux[2 * m + j] += cuz;
          }
        }
      }
      if (live_next_unit) {
        live_next |= 1u << k;
        if (ok) {
          const float sn = s.next[j];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            v[kSumNext * kGroup + g] += __fmul_rn(level_exp(next_level, d2[g]), sn);
          }
        }
      }
    }
    block_sum(v, s.red, s.tot);
    float new_sl[kGroup], scale2[kGroup], rsum2[kGroup];
    bool finite2 = true;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      new_sl[g] = fmaxf(__fsub_rn(sl[g], s.tot[kSumWr * kGroup + g]), 0.0f);
      rsum2[g] = __fadd_rn(1e-9f, s.tot[kSumNext * kGroup + g]);
      scale2[g] = __fdiv_rn(new_sl[g], rsum2[g]);
      finite2 &= isfinite(scale2[g]);
    }
    if (kNext) {
      // a unit of zeros adds +0 to the column sums where the scales are
      // finite; the live ones recompute the next level's weights
      for (int k = 0, c = warp; c < chunks; ++k, c += kWarps) {
        const int j = 32 * c + lane;
        if (j < m && ((live_next >> k & 1u) || !finite2)) {
          const float ax = s.x2[j], ay = s.x2[m + j], az = s.x2[2 * m + j];
          const float sn = s.next[j];
#pragma unroll
          for (int h = 0; h < kGroup; h += kColGroup) {
            float col = 0.0f;
#pragma unroll
            for (int g = h; g < h + kColGroup; ++g) {
              const float d2 = sqdist(px[g], py[g], pz[g], ax, ay, az);
              col += __fmul_rn(__fmul_rn(level_exp(next_level, d2), sn),
                               scale2[g]);
            }
            s.acc_col[j] += col;
          }
        }
      }
    }
    if (threadIdx.x == 0) blk_cost += s.tot[kSumCost * kGroup];
    if (threadIdx.x < kGroup && r0 + threadIdx.x < end) {
      const int g = threadIdx.x;
      const size_t row = static_cast<size_t>(b) * n + r0 + g;
      satl[row] = new_sl[g];
      if (kNext) rowsum[row] = rsum2[g];
      if (kGrads) {
        const float su = s.tot[kSumU * kGroup + g];
        for (int c = 0; c < 3; ++c) {
          float& acc = s.rows[(kG1x + c) * kRows + r + g];
          acc += s.rows[(kX + c) * kRows + r + g] * su -
                 s.tot[(kSumUx + c) * kGroup + g];
        }
      }
    }
  }
  __syncthreads();
  if (kGrads) {
    for (int r = threadIdx.x; r < end - begin; r += kThreads) {
      const size_t row = static_cast<size_t>(b) * n + begin + r;
      for (int c = 0; c < 3; ++c) g1[row * 3 + c] = s.rows[(kG1x + c) * kRows + r];
    }
  }
  const size_t part = static_cast<size_t>(b) * tiles + tile;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    if (kNext) colsum_part[part * m + j] = s.acc_col[j];
    if (kGrads) {
      for (int c = 0; c < 3; ++c) {
        g2_part[(part * 3 + c) * m + j] +=
            s.x2[c * m + j] * s.acc_u[j] - s.acc_ux[c * m + j];
      }
    }
  }
  if (threadIdx.x == 0) cost_part[part] += blk_cost;
}

// Column sums over the row tiles (tile order), then ratio and next satr.
__global__ void emd_columns_kernel(const float* __restrict__ colsum_part,
                                   int tiles, int m,
                                   const float* __restrict__ satr,
                                   float* __restrict__ ratio,
                                   float* __restrict__ satr_next) {
  const int j = blockIdx.x * kColThreads + threadIdx.x, b = blockIdx.y;
  if (j >= m) return;
  float cs = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    cs += colsum_part[(static_cast<size_t>(b) * tiles + t) * m + j];
  }
  const size_t col = static_cast<size_t>(b) * m + j;
  const float sr = satr[col];
  const float r = fminf(__fdiv_rn(sr, __fadd_rn(1e-9f, cs)), 1.0f);
  ratio[col] = r;
  satr_next[col] = fmaxf(__fsub_rn(sr, __fmul_rn(cs, r)), 0.0f);
}

// g2 = sum over tiles of the partials ([B, m, 3] out), cost = sum of the
// tiles' costs; both in tile order.
__global__ void emd_finish_kernel(const float* __restrict__ g2_part,
                                  const float* __restrict__ cost_part,
                                  int tiles, int m, int with_grads,
                                  float* __restrict__ g2,
                                  float* __restrict__ cost) {
  const int j = blockIdx.x * kColThreads + threadIdx.x, b = blockIdx.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float c = 0.0f;
    for (int t = 0; t < tiles; ++t) c += cost_part[static_cast<size_t>(b) * tiles + t];
    cost[b] = c;
  }
  if (j >= m) return;
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
    if (with_grads) {
      for (int t = 0; t < tiles; ++t) {
        acc += g2_part[((static_cast<size_t>(b) * tiles + t) * 3 + c) * m + j];
      }
    }
    g2[(static_cast<size_t>(b) * m + j) * 3 + c] = acc;
  }
}

size_t smem_bytes(int m) {
  return (11 * static_cast<size_t>(m) + kWarps * kRed + kRed + kRowVals * kRows +
          7 * num_chunks(m)) *
         sizeof(float);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kGrads, bool kNext>
cudaError_t launch_level(dim3 grid, size_t smem, cudaStream_t stream,
                         const float* xyz1, const float* xyz2, int n, int m,
                         float level, float next_level, const float* satr,
                         const float* ratio, const float* satr_next, float* satl,
                         float* rowsum, float* colsum_part, float* g2_part,
                         float* cost_part, float* g1) {
  const void* k = reinterpret_cast<const void*>(emd_level_kernel<kGrads, kNext>);
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  emd_level_kernel<kGrads, kNext><<<grid, kThreads, smem, stream>>>(
      xyz1, xyz2, n, m, level, next_level, satr, ratio, satr_next, satl, rowsum,
      colsum_part, g2_part, cost_part, g1);
  return cudaGetLastError();
}

// Every f32 from kUnderflow down to -inf through the kernels' expf; counts
// the results that are not +0.
__global__ void emd_underflow_kernel(unsigned* bad) {
  const unsigned first = __float_as_uint(kUnderflow), last = 0xff800000u;
  for (unsigned u = first + blockIdx.x * blockDim.x + threadIdx.x; u <= last;
       u += gridDim.x * blockDim.x) {
    if (__float_as_uint(level_exp(-1.0f, -__uint_as_float(u))) != 0u) {
      atomicAdd(bad, 1u);
    }
  }
}

}  // namespace

extern "C" size_t snt_emd_smem(int m) { return smem_bytes(m); }

extern "C" int snt_emd_rows_per_block() { return kRows; }

// Clouds a launch: the grid's y axis (the wrapper launches more in chunks).
extern "C" int snt_emd_max_clouds() { return kMaxClouds; }

extern "C" float snt_emd_underflow() { return kUnderflow; }

// Rows of the warp's unit that is skipped as a whole (with 32 columns).
extern "C" int snt_emd_unit_rows() { return kGroup; }

// bad [1] (zeroed by the caller): how many f32 x <= kUnderflow give an
// expf(x), as the kernels call it, other than +0.
extern "C" int snt_emd_underflow_check(unsigned* bad, cudaStream_t stream) {
  emd_underflow_kernel<<<132 * 8, 256, 0, stream>>>(bad);
  return static_cast<int>(cudaGetLastError());
}

// xyz1 [b, n, 3], xyz2 [b, m, 3]. The caller fills satl [b, n] with
// max(n,m)//n, satr_a [b, m] with max(n,m)//m, and g1 [b, n, 3], g2_part
// [b, tiles, 3, m] and cost_part [b, tiles] with zeros (tiles = ceil(n /
// kRows)); rowsum [b, n], satr_b and ratio [b, m] and colsum_part [b, tiles,
// m] are scratch. Out: cost [b], g1, g2 [b, m, 3] (zeros without grads).
extern "C" int snt_emd_cost(const float* xyz1, const float* xyz2, int b, int n,
                            int m, int with_grads, float* satl, float* rowsum,
                            float* satr_a, float* satr_b, float* ratio,
                            float* colsum_part, float* g2_part, float* cost_part,
                            float* g1, float* cost, float* g2,
                            cudaStream_t stream) {
  if (b < 1 || b > kMaxClouds || n < 1 || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float levels[kLevels];
  for (int j = 8, l = 0; j >= -1; --j, ++l) {
    levels[l] = j >= 0 ? -static_cast<float>(1 << (2 * j)) : -0.25f;
  }
  levels[kLevels - 1] = 0.0f;
  const int tiles = (n + kRows - 1) / kRows;
  const dim3 grid(tiles, b);
  const dim3 col_grid((m + kColThreads - 1) / kColThreads, b);
  const size_t smem = smem_bytes(m);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(emd_first_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  emd_first_kernel<<<grid, kThreads, smem, stream>>>(
      xyz1, xyz2, n, m, levels[0], satr_a, satl, rowsum, colsum_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  float* cur = satr_a;
  float* nxt = satr_b;
  for (int l = 0; l < kLevels; ++l) {
    emd_columns_kernel<<<col_grid, kColThreads, 0, stream>>>(colsum_part, tiles, m,
                                                           cur, ratio, nxt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const bool next = l + 1 < kLevels;
    const float nl = next ? levels[l + 1] : 0.0f;
    auto* launch = with_grads ? (next ? launch_level<true, true>
                                      : launch_level<true, false>)
                              : (next ? launch_level<false, true>
                                      : launch_level<false, false>);
    err = launch(grid, smem, stream, xyz1, xyz2, n, m, levels[l], nl, cur, ratio,
                 nxt, satl, rowsum, colsum_part, g2_part, cost_part, g1);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  emd_finish_kernel<<<col_grid, kColThreads, 0, stream>>>(g2_part, cost_part, tiles, m,
                                                        with_grads, g2, cost);
  return static_cast<int>(cudaGetLastError());
}
