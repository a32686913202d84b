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
// memory; the distance tile is recomputed in every pass, never stored.
// The column sums of a level need every row of the cloud, so each level
// is one launch: blocks write per-tile partial column sums, and a small
// kernel adds them over the tiles in a fixed order and forms ratio and the
// next satr. As on the TPU, pass B of level l also computes the column sums
// of level l+1 (its row sums are stored per row and read by the next
// launch instead of being recomputed). Thread t owns columns t, t+256, ...
// and keeps their per-level sums in shared memory that only it touches;
// the row sums of 4 rows at a time are reduced across the block by warp
// shuffles and one pass over the warps' partials. No float atomics: every
// sum has a fixed order, so two runs give the same bits.
//
// What bounds it on the H100: at B=50, n=m=2048 there are 210M pairs. The
// function needs, per pair, one rsqrt for d and 1/d and one exp for each of
// the 10 levels L != 0 (2.3G SFU operations: 0.55 ms at 16 per SM per
// clock, 132 SMs, 1.98 GHz), and each level's arithmetic once, 271 FLOP
// (57 GFLOP: 0.85 ms at 67 TFLOP/s); it moves 5 MB. So its bound is the
// FP32 rate (chip_smoke.py::_emd_bound). This kernel recomputes d2 and the
// weights in 12 passes: 33 exp and 11 rsqrt per pair, and about 80 FP32
// instructions per pair and pass. Keeping a row group's exp values in
// registers between passes and skipping pairs whose exp underflows to 0
// are later work.

#include <cuda_runtime.h>

#include "sqdist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;   // rows of xyz1 per block
constexpr int kGroup = 4;   // rows that share one block reduction
constexpr int kRed = 7 * kGroup;
constexpr int kLevels = 11;
constexpr int kColThreads = 256;

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
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[k] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) red[warp * V + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * V + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float level_exp(float level, float d2) {
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
};

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
  return s;
}

// Loads row group [r0, r0 + kGroup) of cloud b (rows past `end` read as 0
// with zero saturation, so they carry no mass).
__device__ __forceinline__ void load_rows(const float* __restrict__ xyz1,
                                          const float* __restrict__ satl,
                                          int b, int n, int r0, int end,
                                          float (&px)[kGroup],
                                          float (&py)[kGroup],
                                          float (&pz)[kGroup],
                                          float (&sl)[kGroup]) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int i = r0 + g;
    const bool ok = i < end;
    const size_t row = static_cast<size_t>(b) * n + i;
    px[g] = ok ? xyz1[row * 3 + 0] : 0.0f;
    py[g] = ok ? xyz1[row * 3 + 1] : 0.0f;
    pz[g] = ok ? xyz1[row * 3 + 2] : 0.0f;
    sl[g] = ok ? satl[row] : 0.0f;
  }
}

// Pass A of the first level: each row's rowsum, and this tile's column sums
// of the normalised weights.
__global__ void __launch_bounds__(kThreads, 2)
emd_first_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                 int n, int m, float level, const float* __restrict__ satr,
                 const float* __restrict__ satl, float* __restrict__ rowsum,
                 float* __restrict__ colsum_part) {
  extern __shared__ float smem[];
  const Shared s = carve(smem, m);
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const size_t col = static_cast<size_t>(b) * m + j;
    for (int c = 0; c < 3; ++c) s.x2[c * m + j] = xyz2[col * 3 + c];
    s.satr[j] = satr[col];
    s.acc_col[j] = 0.0f;
  }
  __syncthreads();
  const int begin = tile * kRows, end = min(n, begin + kRows);
  for (int r0 = begin; r0 < end; r0 += kGroup) {
    float px[kGroup], py[kGroup], pz[kGroup], sl[kGroup];
    load_rows(xyz1, satl, b, n, r0, end, px, py, pz, sl);
    float rs[kGroup] = {};
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float ax = s.x2[j], ay = s.x2[m + j], az = s.x2[2 * m + j];
      const float sr = s.satr[j];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float d2 = sqdist(px[g], py[g], pz[g], ax, ay, az);
        rs[g] += __fmul_rn(level_exp(level, d2), sr);
      }
    }
    block_sum(rs, s.red, s.tot);
    float scale[kGroup], rsum[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      rsum[g] = __fadd_rn(1e-9f, s.tot[g]);
      scale[g] = __fdiv_rn(sl[g], rsum[g]);
    }
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float ax = s.x2[j], ay = s.x2[m + j], az = s.x2[2 * m + j];
      const float sr = s.satr[j];
      float col = 0.0f;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float d2 = sqdist(px[g], py[g], pz[g], ax, ay, az);
        col += __fmul_rn(__fmul_rn(level_exp(level, d2), sr), scale[g]);
      }
      s.acc_col[j] += col;
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
// tile's next column sums.
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
  __syncthreads();
  float blk_cost = 0.0f;  // thread 0's sum over its rows, in row order
  const int begin = tile * kRows, end = min(n, begin + kRows);
  for (int r0 = begin; r0 < end; r0 += kGroup) {
    float px[kGroup], py[kGroup], pz[kGroup], sl[kGroup], scale[kGroup];
    load_rows(xyz1, satl, b, n, r0, end, px, py, pz, sl);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float rsum = r0 + g < end ? rowsum[static_cast<size_t>(b) * n + r0 + g]
                                      : 1.0f;
      scale[g] = __fdiv_rn(sl[g], rsum);
    }
    // v: [0] sum wr, [1] cost, [2] sum u, [3..5] sum u x2, [6] next rowsum
    float v[kRed] = {};
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float ax = s.x2[j], ay = s.x2[m + j], az = s.x2[2 * m + j];
      const float sr = s.satr[j], ra = s.ratio[j], sn = s.next[j];
      float cu = 0.0f, cux = 0.0f, cuy = 0.0f, cuz = 0.0f;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float d2 = sqdist(px[g], py[g], pz[g], ax, ay, az);
        const float w = __fmul_rn(__fmul_rn(level_exp(level, d2), sr), scale[g]);
        const float wr = __fmul_rn(w, ra);
        const float d2c = fmaxf(d2, 1e-40f);     // d >= 1e-20
        const float rd = rsqrtf(d2c);
        const float d = __fmul_rn(d2c, rd);
        v[g] += wr;
        v[kGroup + g] = fmaf(wr, d, v[kGroup + g]);
        if (kGrads) {
          const float u = __fmul_rn(wr, rd);  // wr / d
          v[2 * kGroup + g] += u;
          v[3 * kGroup + g] = fmaf(u, ax, v[3 * kGroup + g]);
          v[4 * kGroup + g] = fmaf(u, ay, v[4 * kGroup + g]);
          v[5 * kGroup + g] = fmaf(u, az, v[5 * kGroup + g]);
          cu += u;
          cux = fmaf(u, px[g], cux);
          cuy = fmaf(u, py[g], cuy);
          cuz = fmaf(u, pz[g], cuz);
        }
        if (kNext) {
          v[6 * kGroup + g] += __fmul_rn(level_exp(next_level, d2), sn);
        }
      }
      if (kGrads) {
        s.acc_u[j] += cu;
        s.acc_ux[j] += cux;
        s.acc_ux[m + j] += cuy;
        s.acc_ux[2 * m + j] += cuz;
      }
    }
    block_sum(v, s.red, s.tot);
    float new_sl[kGroup], scale2[kGroup], rsum2[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      new_sl[g] = fmaxf(__fsub_rn(sl[g], s.tot[g]), 0.0f);
      rsum2[g] = __fadd_rn(1e-9f, s.tot[6 * kGroup + g]);
      scale2[g] = __fdiv_rn(new_sl[g], rsum2[g]);
    }
    if (kNext) {
      for (int j = threadIdx.x; j < m; j += kThreads) {
        const float ax = s.x2[j], ay = s.x2[m + j], az = s.x2[2 * m + j];
        const float sn = s.next[j];
        float col = 0.0f;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float d2 = sqdist(px[g], py[g], pz[g], ax, ay, az);
          col += __fmul_rn(__fmul_rn(level_exp(next_level, d2), sn), scale2[g]);
        }
        s.acc_col[j] += col;
      }
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) blk_cost += s.tot[kGroup + g];
    }
    if (threadIdx.x < kGroup && r0 + threadIdx.x < end) {
      const int g = threadIdx.x;
      const size_t row = static_cast<size_t>(b) * n + r0 + g;
      satl[row] = new_sl[g];
      if (kNext) rowsum[row] = rsum2[g];
      if (kGrads) {
        const float su = s.tot[2 * kGroup + g];
        const float p[3] = {px[g], py[g], pz[g]};
        for (int c = 0; c < 3; ++c) {
          g1[row * 3 + c] += p[c] * su - s.tot[(3 + c) * kGroup + g];
        }
      }
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
  return (11 * static_cast<size_t>(m) + kWarps * kRed + kRed) * sizeof(float);
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

}  // namespace

extern "C" size_t snt_emd_smem(int m) { return smem_bytes(m); }

extern "C" int snt_emd_rows_per_block() { return kRows; }

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
  if (b < 1 || n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
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
    if (with_grads && next) {
      err = launch_level<true, true>(grid, smem, stream, xyz1, xyz2, n, m, levels[l],
                                     nl, cur, ratio, nxt, satl, rowsum, colsum_part,
                                     g2_part, cost_part, g1);
    } else if (with_grads) {
      err = launch_level<true, false>(grid, smem, stream, xyz1, xyz2, n, m, levels[l],
                                      nl, cur, ratio, nxt, satl, rowsum, colsum_part,
                                      g2_part, cost_part, g1);
    } else if (next) {
      err = launch_level<false, true>(grid, smem, stream, xyz1, xyz2, n, m, levels[l],
                                      nl, cur, ratio, nxt, satl, rowsum, colsum_part,
                                      g2_part, cost_part, g1);
    } else {
      err = launch_level<false, false>(grid, smem, stream, xyz1, xyz2, n, m,
                                       levels[l], nl, cur, ratio, nxt, satl, rowsum,
                                       colsum_part, g2_part, cost_part, g1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  emd_finish_kernel<<<col_grid, kColThreads, 0, stream>>>(g2_part, cost_part, tiles, m,
                                                        with_grads, g2, cost);
  return static_cast<int>(cudaGetLastError());
}
