// Train-mode per-point MLP chain with BatchNorm over blocks of clouds +
// global max, forward and backward: the ghost-BN chain and, as its case of
// one block, the exact batch-global BN chain, each in f32 or with bf16
// matmul operands.
//
// Replaces: samplenet_tpu/ops/pallas/point_mlp_train_kernel.py::
//   point_mlp_train_max (entry :400; `pl.pallas_call` :219 forward, :261
//   backward), and samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py::
//   point_mlp_exact_train_max (entry :499; `pl.pallas_call` :226 stats,
//   :244 chain, :262 top, :315 per-layer backward).
//
// The B clouds fall into P = B / bb blocks of bb clouds (block p holds
// clouds p*bb .. p*bb+bb-1, M = bb*N points, contiguous in x), and each
// layer normalises with its block's own statistics: ghost BN for bb < B,
// exact global BN for bb = B (P = 1). Per layer l and block
// (z_l = op(h_{l-1}) op(W_l), the dense bias never enters: BN cancels it):
// mu = mean z, msq = mean z^2, var = msq - mu^2 (the caller turns the
// f64 sums into mu and rstd, and clamps var at 0 for the exact chain),
// xhat = (z - mu) * rsqrt(var + eps), h_l = relu(gamma * xhat + beta);
// pooled = max over each cloud of h_L. op() rounds a matmul operand to bf16
// (__float2bfloat16_rn, products exact, sums in f32) when bf16 is on, as
// jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32).
//
// The backward's roundings are a mode (`Rounds`): 0 none; 1 the ghost chain
// in bf16 (below); 2 the exact chain in bf16 (point_mlp_exact_kernel.py
// :157-204, :283): the matmul operands rounded, xhat kept in f32, and dh
// read back rounded to bf16 as the TPU kernel spills it, while the rows
// pass sums the unrounded dh (the TPU kernel takes each layer's rows from
// dh_prev before its spill). Here dh_prev stays f32 in HBM and pmt_bwd_dz
// rounds it where it reads it, which gives the same numbers.
//
// The ghost backward is the TPU kernel's own VJP (:120-196), not the
// gradient of the forward: it stores xhat in the working type (bf16 when
// on), takes the ReLU mask from gamma * xhat_stored + beta, rebuilds h_prev
// from the layer below's stored xhat, takes rstd from z recomputed on that
// h_prev, and routes the pooled cotangent to the f32 chain's first argmax.
// With bf16 off every one of these equals the forward's value, and the
// backward is the exact chain's.
//
// Design: the TPU kernels recompute the chain in VMEM because their HBM was
// small. The H100 has 80 GB, so every pre-BN z_l stays in HBM (P x sum(C_l)
// floats: 1.9 GB at the classification train shape) and no matmul is
// recomputed (but for the bf16 backward's rstd, from the rounded h_prev):
// forward and backward each run one pass per layer.
//
//   pmt_dense   grid (G, P): block (g, p) takes tiles g, g+G, ... of ghost
//               block p (64 points each, none crossing a ghost block),
//               z = act(in) op(W) over the tile in shared memory, act being
//               the previous layer's ghost BN + ReLU applied on load from
//               the block's constants in shared memory (with the stored
//               xhat in the backward's recompute), rnd() rounding the
//               operand in bf16. The products run on FP32 FMAs in channel
//               order, 4 points x 4 channels a thread (mma_tile.cuh's
//               simt_product): the plain path's sums, which the train
//               chains' checks hold them to at BN's ReLU kinks
//               (mma_tile.cuh says why the tensor cores' are not). W comes
//               through the read-only cache, so shared memory holds only
//               the tile, and cp.async stages the next tile's raw rows
//               while the tile's products run where two blocks still fit
//               an SM with them (ops/cuda/point_mlp_plan.py). z goes to HBM
//               from the registers (unless null: the backward's recompute
//               of rstd needs only the sums) and, 64 channels at a time,
//               to shared memory, where one thread a channel sums the
//               tile's z (another its z^2) in f32 in point order; the
//               tiles are summed in f64 in tile order: one f64 row of sum z
//               and sum z^2 per block. Both orders are fixed because BN's
//               ReLU masks follow the last bits of z and of the
//               statistics (mma_tile.cuh).
//   pmt_pool    per cloud and channel, max over points of h_L and the first
//               point that attains it (a NaN wins, as in torch.argmax).
//   pmt_rows    grid (G, P): per ghost block, sum dy and sum dy*xhat_stored
//               (dy = dh where gamma*xhat_stored + beta > 0); for the top
//               layer dh is the pooled cotangent at each cloud's argmax.
//   pmt_bwd_dz  dz = rstd' * (gamma*dy - r1 - xhat_stored*r2) per point
//               with its ghost block's constants (loaded into shared memory
//               when the block changes: once in the exact chain; dy from
//               dh read back in bf16 in mode 2), rounded to bf16 when the
//               mode rounds operands, written to HBM, and dh_prev = dz
//               op(W)^T. A
//               block walks the 64-point tiles and holds op(W)^T (K chunks
//               reloaded per tile where it would leave room for one block
//               an SM) and the tile's dz.
//               Where two blocks still fit an SM with it (the 64-wide
//               layers), cp.async stages the next tile's raw z and dh rows
//               while the tile's product runs; elsewhere the rows are read
//               straight from HBM and the SM's other blocks overlap those
//               reads (one staged block an SM stalls between its phases,
//               and measured slower on the H100). Each thread owns
//               8 (4 at 64-wide inputs) points x 4 channels: per o it reads
//               dz as float4 and one float4 of op(W)^T, the warp's 4 x 8
//               layout keeping both free of bank conflicts. The dh_prev sums
//               run over o in order, so dz and dh_prev do not depend on the
//               tiling.
//   pmt_bwd_dw  dW = op(act(h_prev))^T dz by split-K: grid (output tiles of
//               [cin_pad, cout]) x S runs of consecutive 64-point tiles, S
//               fixed by the shape and the SM count. A block stages each
//               tile of `in` and of dz with cp.async, two stages deep,
//               applies the layer below's BN + ReLU and the roundings to the
//               staged copy, sums the tile in f32 registers and adds it once
//               into f64 registers. A thread owns 4 x 8 outputs of a 64 x 64
//               tile (64 KB of shared memory, three blocks an SM) or, where
//               cout >= 128, 8 x 8 of a 64 x 128 tile (96 KB, two blocks):
//               4 FMAs per float read from shared memory against 2.7 (the
//               4 x 8 tile is bound by those reads). The caller sums the f64
//               partials [S, cin_pad, cout] in order.
//
// Every partial is reduced by the caller over a grid fixed by the shape
// and the card, and nothing uses float atomics, so two runs give the same
// bits. Each 64-point tile is summed in f32 and the tiles' sums in f64: the
// lower layers' gradients are sums over all points of terms that BN's
// correction makes nearly cancel, and an f32 running sum over a block's
// ~4k points loses more than the terms' own rounding. BN uses
// __fsub_rn/__fmul_rn/__fmaf_rn in one helper, so the forward's ReLU mask
// and the backward's agree exactly.
//
// What bounds it on the H100: widths 3->64->64->64->128->128 are 32,960
// multiply-adds per point. For the exact chain at B=1024, N=1024 that is
// 69 GFLOP forward and 138 GFLOP backward, 1 ms and 2 ms on the FP32 pipes
// at 67 TFLOP/s. The forward's z (1.9 GB written, read back by the next
// layer's loader) adds about 1 ms at 3.35 TB/s. The backward's passes also
// move z and dh (the rows pass and pmt_bwd_dz read both), dz (written
// once, read by pmt_bwd_dw) and dh_prev: about 13 GB, 4 ms at 3.35 TB/s.
// pmt_bwd_dz is bound by those bytes at the 64-wide layers and nears its
// FP32 bound at 128 -> 128; pmt_bwd_dw, whose operands pass through shared
// memory once per tile, by its FP32 multiply-adds. At the progressive
// step's shape (B=32) it is 2.2 GFLOP forward and 4.3 GFLOP backward, on
// the SIMT pipes (bf16 only rounds the operands). The tensor cores wait on
// a check that sees accuracy rather than the plain path's summation order
// (ROADMAP.md); fusing pmt_rows into pmt_bwd_dz is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using mma::aidx;

constexpr int kThreads = 256;
constexpr int kDzThreads = 256;  // pmt_bwd_dz
constexpr int kDwThreads = 128;  // pmt_bwd_dw
constexpr int kDwTile = 64;      // pmt_bwd_dw: input channels of an output tile
constexpr int kTileP = 64;
constexpr int kStride = kTileP + 4;  // 4 x odd: conflict-free float4 stores

struct GBN {  // one layer's ghost BN: mu, rstd per [P, C]; gamma, beta [C]
  const float* mu;
  const float* rstd;
  const float* gamma;
  const float* beta;
};

struct Ghost {  // the block layout: m points per block in `tiles` tiles
  long long m;
  int tiles;
};

__device__ __forceinline__ float rnd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// What a backward mode rounds to bf16: the matmul operands (dz, op(W),
// act(h_prev)), the xhat the ghost chain stores, and the dh the exact chain
// spills (read by pmt_bwd_dz; the rows pass reads it unrounded)
template <int kMode>
struct Rounds {
  static constexpr bool op = kMode != 0;
  static constexpr bool xhat = kMode == 1;
  static constexpr bool dh = kMode == 2;
};

// ReLU that keeps a NaN, as torch.relu does
__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

__device__ __forceinline__ float ghost_xhat(const GBN& bn, int blk, int c,
                                            int n_ch, float z) {
  const size_t k = static_cast<size_t>(blk) * n_ch + c;
  return __fmul_rn(__fsub_rn(z, bn.mu[k]), bn.rstd[k]);
}

// relu(gamma * xhat + beta) of z, xhat = (z - mu) * rstd rounded to bf16
// first when `store` is set (the xhat the backward stores): the one BN +
// ReLU of the forward's loader and pmt_pool, so that the forward's ReLU
// mask and the backward's agree bit for bit
__device__ __forceinline__ float bn_act(float z, float mu, float rstd,
                                        float gamma, float beta, int store) {
  const float xh = rnd(__fmul_rn(__fsub_rn(z, mu), rstd), store);
  return relu_nan(__fmaf_rn(gamma, xh, beta));
}

__device__ __forceinline__ float ghost_act(const GBN& bn, int blk, int c,
                                           int n_ch, float z, int store) {
  const size_t k = static_cast<size_t>(blk) * n_ch + c;
  return bn_act(z, bn.mu[k], bn.rstd[k], bn.gamma[c], bn.beta[c], store);
}

__device__ __forceinline__ void tile_of(const Ghost& gh, long long k, int* blk,
                                        long long* p0, int* np) {
  *blk = static_cast<int>(k / gh.tiles);
  const long long t = k - static_cast<long long>(*blk) * gh.tiles;
  *p0 = *blk * gh.m + t * kTileP;
  *np = static_cast<int>(min(static_cast<long long>(kTileP), gh.m - t * kTileP));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Row stride, in floats, of the staged raw rows of a tile: cin + 4, so
// that a warp's 16-byte reads of 32 points' rows hit distinct banks
__host__ __device__ constexpr int stage_stride(int cin) { return cin + 4; }

// cp.async of tile rows [p0, p0 + np) of in [., cin] (contiguous, cin a
// multiple of 4) into stage [64][stage_stride(cin)]
__device__ __forceinline__ void stage_rows(float* stage,
                                           const float* __restrict__ in,
                                           int cin, long long p0, int np) {
  const int q = cin / 4;
  const float* src = in + p0 * cin;
  for (int e = threadIdx.x; e < np * q; e += kThreads) {
    const int p = e / q, c = (e % q) * 4;
    cp_async16(stage + p * stage_stride(cin) + c, src + static_cast<size_t>(p) * cin + c);
  }
}

// Loads tile rows [p0, p0 + np) of in [., cin] into the activation tile
// `as` (mma_tile.cuh's layout, cin rounded up to 4 rows) as act(in),
// rounded by rnd() in bf16, from the rows staged in `stage` when it is not
// null: the layer below's BN + ReLU from its constants cs [4][cin] (this
// ghost block's mu and rstd, gamma, beta; null for the first layer), with
// the stored-xhat rounding `store`. A warp takes 32 points of 4 channels:
// 16-byte loads where cin allows, and each store fills 32 consecutive
// points of one row (no bank conflict). Padded points and channels are 0.
template <bool kBf16>
__device__ __forceinline__ void load_act_tile(uint32_t* as,
                                              const float* __restrict__ in,
                                              const float* stage, int cin,
                                              const float* cs, int store,
                                              long long p0, int np) {
  const int cq = (cin + 3) / 4;
  for (int e = threadIdx.x; e < kTileP * cq; e += kThreads) {
    const int p = e % kTileP, c = (e / kTileP) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (p < np) {
      const float* src = in + (p0 + p) * cin + c;
      if (stage != nullptr) {
        const float4 q = *reinterpret_cast<const float4*>(
            stage + p * stage_stride(cin) + c);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else if (cin % 4 == 0) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = c + j < cin ? __ldg(src + j) : 0.0f;
      }
      if (cs != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = c + j;
          if (k < cin) {
            v[j] = bn_act(v[j], cs[k], cs[cin + k], cs[2 * cin + k],
                          cs[3 * cin + k], store);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) as[aidx(c + j, p)] = __float_as_uint(rnd(v[j], kBf16));
  }
}

// Output channels a pmt_dense block takes at a time: z and z^2 of each
// are summed from a [kChunk][kStride] copy of the chunk's z
constexpr int kChunk = 64;

// z[., n0 .. n0 + nc) = act(in) op(W) of one tile on the FP32 pipes, 4
// points x 4 channels a thread: each point's 4 channels of z stored to HBM
// as 16 bytes, and the chunk's z into zt [nc][kStride], channel-major.
__device__ __forceinline__ void dense_chunk(const uint32_t* as,
                                            const float* __restrict__ w,
                                            int cin, int cout, int n0, int nc,
                                            float* __restrict__ z, float* zt,
                                            long long p0, int np) {
  const int oq = nc / 4;
  for (int u = threadIdx.x; u < (kTileP / 4) * oq; u += kThreads) {
    const int oc = (u % oq) * 4, o0 = n0 + oc;
    const int pp = (u / oq) * 4;
    float a[4][4] = {};
    mma::simt_product(a, as, w, cin, cout, pp, o0);
#pragma unroll
    for (int pi = 0; pi < 4; ++pi) {
      if (z != nullptr && pp + pi < np) {
        *reinterpret_cast<float4*>(z + (p0 + pp + pi) * cout + o0) =
            make_float4(a[pi][0], a[pi][1], a[pi][2], a[pi][3]);
      }
    }
#pragma unroll
    for (int oj = 0; oj < 4; ++oj) {
      *reinterpret_cast<float4*>(zt + (oc + oj) * kStride + pp) =
          make_float4(a[0][oj], a[1][oj], a[2][oj], a[3][oj]);
    }
  }
}

// Operands rounded by rnd() with kBf16. With `stage`, cp.async brings the
// next tile's raw rows in while the tile's products run.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
pmt_dense_kernel(const float* __restrict__ in, int cin, GBN prev, int has_prev,
                 int store,
                 const float* __restrict__ w,  // [cin, cout], op() applied
                 int cout, float* __restrict__ z,  // [P*m, cout] or null
                 double* __restrict__ rows,        // [P, G, 2, cout]
                 Ghost gh, int stage) {
  extern __shared__ float4 smem4[];
  double* acc = reinterpret_cast<double*>(smem4);        // [2][cout]
  float* zt = reinterpret_cast<float*>(acc + 2 * cout);  // [kChunk][kStride]
  float* cs = zt + min(cout, kChunk) * kStride;          // [4][cin]
  uint32_t* as = reinterpret_cast<uint32_t*>(cs + 4 * cin);  // the tile
  const int arows = mma::tile_rows(cin, false);
  float* staged = stage ? reinterpret_cast<float*>(as + arows * kTileP) : nullptr;
  const int blk = blockIdx.y;
  for (int c = threadIdx.x; c < 2 * cout; c += kThreads) acc[c] = 0.0;
  if (has_prev) {  // the layer below's BN for this ghost block
    const size_t base = static_cast<size_t>(blk) * cin;
    for (int c = threadIdx.x; c < cin; c += kThreads) {
      cs[c] = prev.mu[base + c];
      cs[cin + c] = prev.rstd[base + c];
      cs[2 * cin + c] = prev.gamma[c];
      cs[3 * cin + c] = prev.beta[c];
    }
  }

  const long long first = static_cast<long long>(blk) * gh.tiles;
  int tb, np;
  long long p0;
  if (staged != nullptr && blockIdx.x < gh.tiles) {
    tile_of(gh, first + blockIdx.x, &tb, &p0, &np);
    stage_rows(staged, in, cin, p0, np);
  }
  cp_async_commit();
  for (int t = blockIdx.x; t < gh.tiles; t += gridDim.x) {
    tile_of(gh, first + t, &tb, &p0, &np);
    cp_async_wait<0>();
    __syncthreads();  // rows and constants in; the last tile's reads done
    load_act_tile<kBf16>(as, in, staged, cin, has_prev ? cs : nullptr, store,
                         p0, np);
    __syncthreads();  // the tile is in; the stage is free
    if (staged != nullptr && t + gridDim.x < gh.tiles) {
      int nb, nn;
      long long np0;
      tile_of(gh, first + t + gridDim.x, &nb, &np0, &nn);
      stage_rows(staged, in, cin, np0, nn);
    }
    cp_async_commit();
    for (int n0 = 0; n0 < cout; n0 += kChunk) {
      const int nc = min(kChunk, cout - n0);
      dense_chunk(as, w, cin, cout, n0, nc, z, zt, p0, np);
      __syncthreads();
      // per channel, the tile's sum of z (threads 0 .. nc-1) or of z^2
      // (nc .. 2nc-1) in f32 in point order, then into f64 in tile order
      const int j = threadIdx.x % nc;
      if (threadIdx.x < 2 * nc) {
        const float* v = zt + j * kStride;
        float s = 0.0f;
        if (threadIdx.x < nc) {
          for (int p = 0; p < np; ++p) s += v[p];
          acc[n0 + j] += s;
        } else {
          for (int p = 0; p < np; ++p) s += v[p] * v[p];
          acc[cout + n0 + j] += s;
        }
      }
      __syncthreads();  // zt is free for the next chunk
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  double* out = rows + (static_cast<size_t>(blk) * gridDim.x + blockIdx.x) * 2 * cout;
  for (int c = threadIdx.x; c < 2 * cout; c += kThreads) out[c] = acc[c];
}

__global__ void __launch_bounds__(kThreads)
pmt_pool_kernel(const float* __restrict__ z,  // [B, n, c]
                GBN bn, int bb, int n, int c_out,
                float* __restrict__ pooled,   // [B, c]
                int* __restrict__ argmax) {   // [B, c]
  const int b = blockIdx.x;
  const int blk = b / bb;
  for (int c = threadIdx.x; c < c_out; c += kThreads) {
    const float* zb = z + static_cast<size_t>(b) * n * c_out + c;
    float best = -1.0f;  // h >= 0 (or NaN), so point 0 always replaces it
    int bi = 0;
    for (int p = 0; p < n; ++p) {
      const float h = ghost_act(bn, blk, c, c_out, zb[static_cast<size_t>(p) * c_out], 0);
      if (best == best && (h > best || h != h)) {  // first max; first NaN wins
        best = h;
        bi = p;
      }
    }
    pooled[static_cast<size_t>(b) * c_out + c] = best;
    argmax[static_cast<size_t>(b) * c_out + c] = bi;
  }
}

// dh at point gp, channel c: dense [P*m, c] or, when dh == nullptr, the
// pooled cotangent g[b, c] at the cloud's argmax point and 0 elsewhere.
__device__ __forceinline__ float dh_at(const float* __restrict__ dh,
                                       const float* __restrict__ g,
                                       const int* __restrict__ argmax, int n,
                                       int c_out, long long gp, int c) {
  if (dh != nullptr) return dh[gp * c_out + c];
  const long long b = gp / n;
  const int p = static_cast<int>(gp - b * n);
  return argmax[b * c_out + c] == p ? g[b * c_out + c] : 0.0f;
}

// dy and xhat_stored at point gp, channel c of ghost block blk
__device__ __forceinline__ float dy_at(const float* __restrict__ z,
                                       const GBN& bn, int blk, int c,
                                       int c_out, int store,
                                       const float* __restrict__ dh,
                                       const float* __restrict__ g,
                                       const int* __restrict__ argmax, int n,
                                       long long gp, float* xh) {
  *xh = rnd(ghost_xhat(bn, blk, c, c_out, z[gp * c_out + c]), store);
  const float y = __fmaf_rn(bn.gamma[c], *xh, bn.beta[c]);
  return y > 0.0f ? dh_at(dh, g, argmax, n, c_out, gp, c) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
pmt_rows_kernel(const float* __restrict__ z, GBN bn, int c_out, int store,
                const float* __restrict__ dh, const float* __restrict__ g,
                const int* __restrict__ argmax, int bb, int n, Ghost gh,
                double* __restrict__ rows) {  // [P, G, 2, c]
  const int blk = blockIdx.y;
  for (int c = threadIdx.x; c < c_out; c += blockDim.x) {
    double s = 0.0, s2 = 0.0;
    float xh;
    if (dh == nullptr) {  // top layer: one nonzero dh per (cloud, channel)
      for (int j = blockIdx.x; j < bb; j += gridDim.x) {
        const long long b = static_cast<long long>(blk) * bb + j;
        const long long gp = b * n + argmax[b * c_out + c];
        const float dy = dy_at(z, bn, blk, c, c_out, store, nullptr, g, argmax,
                               n, gp, &xh);
        s += dy;
        s2 += dy * xh;
      }
    } else {
      for (int t = blockIdx.x; t < gh.tiles; t += gridDim.x) {
        int tb, np;
        long long p0;
        tile_of(gh, static_cast<long long>(blk) * gh.tiles + t, &tb, &p0, &np);
        float ts = 0.0f, ts2 = 0.0f;
        for (long long gp = p0; gp < p0 + np; ++gp) {
          const float dy = dy_at(z, bn, blk, c, c_out, store, dh, g, argmax, n,
                                 gp, &xh);
          ts += dy;
          ts2 += dy * xh;
        }
        s += ts;
        s2 += ts2;
      }
    }
    double* out = rows + (static_cast<size_t>(blk) * gridDim.x + blockIdx.x) * 2 * c_out;
    out[c] = s;
    out[c_out + c] = s2;
  }
}

// ---------------------------------------------------------------- backward

struct DzArgs {
  const float* z;       // [P*m, cout]: this layer's pre-BN z
  GBN bn;               // this layer's mu, rstd [P, cout], gamma, beta [cout]
  const float* rstd2;   // [P, cout]: rstd' (the bf16 backward's recompute)
  const float* r1;      // [P, cout]: gamma * sum dy / m
  const float* r2;      // [P, cout]: gamma * sum dy*xhat_stored / m
  const float* dh;      // [P*m, cout], or null: g at each cloud's argmax
  const float* g;       // [B, cout]
  const int* argmax;    // [B, cout]
  int n;                // points per cloud
  int cout;
  const float* wt;      // [cout, cin_pad]: op(W)^T, zero-padded
  int cin_pad;
  int kc;               // rows of op(W)^T in shared memory at once
  int stage;            // stage the next tile's z and dh rows with cp.async
  float* dz;            // [P*m, cout]
  float* dh_prev;       // [P*m, cin_pad]
  Ghost gh;             // ghost blocks in 64-point tiles
  int n_blocks;
};

// rows [r0, r1) of op(W)^T into shared memory, 16 bytes a thread
__device__ __forceinline__ void load_wt_rows(float* wts, const DzArgs& a,
                                             int r0, int r1) {
  const int q = a.cin_pad / 4;
  const float4* src = reinterpret_cast<const float4*>(a.wt) +
                      static_cast<size_t>(r0) * q;
  float4* dst = reinterpret_cast<float4*>(wts);
  for (int e = threadIdx.x; e < (r1 - r0) * q; e += kDzThreads) {
    dst[e] = __ldg(src + e);
  }
}

// cp.async of tile k's raw z rows (and dh rows) into the stage
__device__ __forceinline__ void stage_dz_tile(float* stage, const DzArgs& a,
                                              long long k) {
  int blk, np;
  long long p0;
  tile_of(a.gh, k, &blk, &p0, &np);
  const int chunks = np * a.cout / 4;  // the tile's rows are contiguous
  const float* z = a.z + p0 * a.cout;
  for (int c = threadIdx.x; c < chunks; c += kDzThreads) {
    cp_async16(stage + 4 * c, z + 4 * c);
  }
  if (a.dh != nullptr) {
    const float* dh = a.dh + p0 * a.cout;
    float* dst = stage + kTileP * a.cout;
    for (int c = threadIdx.x; c < chunks; c += kDzThreads) {
      cp_async16(dst + 4 * c, dh + 4 * c);
    }
  }
}

// dz of one tile into dzs [cout][kStride] and HBM, four points of one channel
// a thread (reads along the rows, one float4 store into dzs, coalesced
// stores of dz); z and dh rows from the stage (kStaged) or from HBM
template <bool kStaged, int kMode>
__device__ __forceinline__ void form_dz(const DzArgs& a, const float* zr,
                                        const float* dhr, const float* cs,
                                        const int* pcl, float* dzs,
                                        long long p0, int np) {
  using R = Rounds<kMode>;
  const int cout = a.cout;
  for (int e = threadIdx.x; e < (kTileP / 4) * cout; e += kDzThreads) {
    const int o = e % cout, q = (e / cout) * 4;
    const float mu = cs[o], rstd = cs[cout + o], gamma = cs[2 * cout + o];
    const float beta = cs[3 * cout + o], r1 = cs[4 * cout + o];
    const float r2 = cs[5 * cout + o], rstd2 = cs[6 * cout + o];
    float zv[4], dhv[4], v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // every load of the quad before any use
      const int p = q + j;
      zv[j] = dhv[j] = 0.0f;
      if (p < np) {
        const int k = p * cout + o;
        if (dhr == nullptr) {  // the top layer: g at the cloud's argmax
          const int b = pcl[p], lp = pcl[kTileP + p];
          dhv[j] = __ldg(a.argmax + b * cout + o) == lp ? __ldg(a.g + b * cout + o)
                                                        : 0.0f;
          zv[j] = kStaged ? zr[k] : __ldg(zr + k);
        } else {
          zv[j] = kStaged ? zr[k] : __ldg(zr + k);
          dhv[j] = rnd(kStaged ? dhr[k] : __ldg(dhr + k), R::dh);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = q + j;
      v[j] = 0.0f;
      if (p < np) {
        const float xh = rnd(__fmul_rn(__fsub_rn(zv[j], mu), rstd), R::xhat);
        const float y = __fmaf_rn(gamma, xh, beta);
        const float dy = y > 0.0f ? dhv[j] : 0.0f;
        v[j] = rnd(rstd2 * (gamma * dy - r1 - xh * r2), R::op);
        a.dz[(p0 + p) * cout + o] = v[j];
      }
    }
    *reinterpret_cast<float4*>(dzs + o * kStride + q) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// kRP consecutive dz values of one channel from dzs (float4 where kRP >= 4)
template <int kRP>
__device__ __forceinline__ void load_dz(float* d, const float* src) {
  if constexpr (kRP >= 4) {
#pragma unroll
    for (int r = 0; r < kRP; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + r);
      d[r] = v.x;
      d[r + 1] = v.y;
      d[r + 2] = v.z;
      d[r + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRP; ++r) d[r] = src[r];
  }
}

// dz = rstd' * (gamma*dy - r1 - xhat_stored*r2) and dh_prev = dz op(W)^T
// over 64-point tiles; kRP points x 4 channels of dh_prev a thread.
// blocks per SM each kRP is built for: its registers leave room for them
template <int kRP>
__host__ __device__ constexpr int dz_min_blocks() {
  return kRP == 1 ? 4 : kRP <= 4 ? 3 : 2;
}

template <int kRP, int kMode>
__global__ void __launch_bounds__(kDzThreads, dz_min_blocks<kRP>())
pmt_bwd_dz_kernel(DzArgs a) {
  extern __shared__ float4 smem4[];
  const int cout = a.cout, cin_pad = a.cin_pad;
  float* wts = reinterpret_cast<float*>(smem4);  // [kc][cin_pad]
  float* cs = wts + a.kc * cin_pad;              // [7][cout]: the constants
  float* dzs = cs + 7 * cout;                    // [cout][kStride]: the tile's dz
  int* pcl = reinterpret_cast<int*>(dzs + cout * kStride);  // [2][64]: b, point
  float* stage = reinterpret_cast<float*>(pcl + 2 * kTileP);  // [2][64][cout]
  const bool top = a.dh == nullptr;
  const bool resident = a.kc >= cout;
  const long long total = static_cast<long long>(a.n_blocks) * a.gh.tiles;
  // this thread's dh_prev outputs: warps of 4 point groups x 8 channel
  // groups where the tile allows (dz reads 4 rows, W^T 8 float4: no bank
  // conflict), else row-major
  const int ncg = cin_pad / 4, npg = kTileP / kRP, ntt = npg * ncg;

  if (resident) load_wt_rows(wts, a, 0, cout);
  long long k = blockIdx.x;
  if (a.stage && k < total) stage_dz_tile(stage, a, k);
  cp_async_commit();
  int cur = -1;
  for (; k < total; k += gridDim.x) {
    int blk, np;
    long long p0;
    tile_of(a.gh, k, &blk, &p0, &np);
    cp_async_wait<0>();
    __syncthreads();  // rows staged; the last tile's product is done with dzs
    if (blk != cur) {  // the ghost block's constants (once in the exact chain)
      const size_t base = static_cast<size_t>(blk) * cout;
      for (int c = threadIdx.x; c < cout; c += kDzThreads) {
        cs[c] = a.bn.mu[base + c];
        cs[cout + c] = a.bn.rstd[base + c];
        cs[2 * cout + c] = a.bn.gamma[c];
        cs[3 * cout + c] = a.bn.beta[c];
        cs[4 * cout + c] = a.r1[base + c];
        cs[5 * cout + c] = a.r2[base + c];
        cs[6 * cout + c] = a.rstd2[base + c];
      }
      cur = blk;
    }
    if (top) {  // each point's cloud and index in it
      for (int p = threadIdx.x; p < np; p += kDzThreads) {
        const long long b = (p0 + p) / a.n;
        pcl[p] = static_cast<int>(b);
        pcl[kTileP + p] = static_cast<int>(p0 + p - b * a.n);
      }
    }
    __syncthreads();
    if (a.stage) {
      form_dz<true, kMode>(a, stage, top ? nullptr : stage + kTileP * cout, cs, pcl,
                           dzs, p0, np);
    } else {
      form_dz<false, kMode>(a, a.z + p0 * cout,
                            top ? nullptr : a.dh + p0 * cout, cs, pcl, dzs, p0, np);
    }
    __syncthreads();  // dzs complete; the stage is free for the next tile
    if (a.stage && k + gridDim.x < total) stage_dz_tile(stage, a, k + gridDim.x);
    cp_async_commit();
    // dh_prev[p, i] = sum_o dz[p, o] op(W)[i, o], o in order, f32
    for (int u0 = 0; u0 < ntt; u0 += kDzThreads) {
      const int u = u0 + threadIdx.x;
      int pg, cg;
      if (ncg % 8 == 0 && npg % 4 == 0) {
        const int w = u / 32, l = u % 32, wpc = ncg / 8;
        pg = (w / wpc) * 4 + l / 8;
        cg = (w % wpc) * 8 + l % 8;
      } else {
        pg = u / ncg;
        cg = u % ncg;
      }
      const int pp = pg * kRP, i0 = cg * 4;
      float acc[kRP][4];
#pragma unroll
      for (int r = 0; r < kRP; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
      }
      for (int c0 = 0; c0 < cout; c0 += a.kc) {
        const int c1 = min(cout, c0 + a.kc);
        if (!resident) {  // K chunks: every thread takes part in the loads
          if (c0 > 0) __syncthreads();
          load_wt_rows(wts, a, c0, c1);
          __syncthreads();
        }
        if (u < ntt) {
#pragma unroll 4
          for (int o = c0; o < c1; ++o) {
            const float4 wv = *reinterpret_cast<const float4*>(
                wts + (o - c0) * cin_pad + i0);
            float d[kRP];
            load_dz<kRP>(d, dzs + o * kStride + pp);
#pragma unroll
            for (int r = 0; r < kRP; ++r) {
              acc[r][0] = fmaf(d[r], wv.x, acc[r][0]);
              acc[r][1] = fmaf(d[r], wv.y, acc[r][1]);
              acc[r][2] = fmaf(d[r], wv.z, acc[r][2]);
              acc[r][3] = fmaf(d[r], wv.w, acc[r][3]);
            }
          }
        }
      }
      if (!resident) __syncthreads();  // the next pass reloads the chunks
      if (u < ntt) {
#pragma unroll
        for (int r = 0; r < kRP; ++r) {
          if (pp + r < np) {
            *reinterpret_cast<float4*>(a.dh_prev + (p0 + pp + r) * cin_pad + i0) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

struct DwArgs {
  const float* in;   // [P*m, cin]: x, or the layer below's pre-BN z
  int cin;
  int cin_pad;
  GBN prev;          // the layer below's BN, applied to `in` (has_prev)
  int has_prev;
  const float* dz;   // [P*m, cout]
  int cout;
  double* dw_part;   // [splits, cin_pad, cout]
  Ghost gh;          // ghost blocks in 64-point tiles
  int n_blocks;
  int splits;
};

// A pmt_bwd_dw block for kRI x 8 outputs a thread: 64 input channels x
// dw_to<kRI>() output channels
template <int kRI>
__host__ __device__ constexpr int dw_to() {
  return kDwThreads * kRI * 8 / kDwTile;
}

// cp.async of tile k's rows of in (channels i0 .. i0+ti) and of dz
// (channels o0 .. o0+to) into A [64][kDwTile] and D [64][kTO]
template <int kTO>
__device__ __forceinline__ void stage_dw_tile(float* A, float* D,
                                              const DwArgs& a, long long k,
                                              int i0, int ti, int o0, int to) {
  int blk, np;
  long long p0;
  tile_of(a.gh, k, &blk, &p0, &np);
  constexpr int kQA = kDwTile / 4, kQD = kTO / 4;  // 16-byte chunks a row
  if (a.cin % 4 == 0) {
    for (int c = threadIdx.x; c < np * kQA; c += kDwThreads) {
      const int p = c / kQA, j = (c % kQA) * 4;
      if (j < ti) cp_async16(A + p * kDwTile + j, a.in + (p0 + p) * a.cin + i0 + j);
    }
  } else {  // x with 3 channels: 4 bytes at a time
    for (int c = threadIdx.x; c < np * kDwTile; c += kDwThreads) {
      const int p = c / kDwTile, j = c % kDwTile;
      if (i0 + j < a.cin && j < ti) {
        cp_async4(A + p * kDwTile + j, a.in + (p0 + p) * a.cin + i0 + j);
      }
    }
  }
  for (int c = threadIdx.x; c < np * kQD; c += kDwThreads) {
    const int p = c / kQD, j = (c % kQD) * 4;
    if (j < to) cp_async16(D + p * kTO + j, a.dz + (p0 + p) * a.cout + o0 + j);
  }
}

// dW[i, o] = sum_p op(act(in))[p, i] dz[p, o] over the block's run of
// 64-point tiles: each tile summed in f32 registers, kRI x 8 outputs a
// thread, then added once into f64 registers.
template <int kRI, int kMode>
__global__ void __launch_bounds__(kDwThreads, kRI == 4 ? 3 : 2)
pmt_bwd_dw_kernel(DwArgs a) {
  using R = Rounds<kMode>;
  constexpr int kTO = dw_to<kRI>(), kOG = kTO / 8;
  constexpr int kStage = kTileP * (kDwTile + kTO);
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);  // [2][A [64][64], D [64][kTO]]
  const int n_o = (a.cout + kTO - 1) / kTO;
  const int i0 = (blockIdx.x / n_o) * kDwTile, o0 = (blockIdx.x % n_o) * kTO;
  const int ti = min(kDwTile, a.cin_pad - i0), to = min(kTO, a.cout - o0);
  const long long total = static_cast<long long>(a.n_blocks) * a.gh.tiles;
  const long long k0 = total * blockIdx.y / a.splits;
  const long long k1 = total * (blockIdx.y + 1) / a.splits;
  const int ig = threadIdx.x / kOG, og = threadIdx.x % kOG;
  const bool active = kRI * ig < ti;
  // the transform's channel: each thread keeps one, with its BN constants
  const int tw = kDwThreads % ti == 0 ? ti : kDwTile;  // threads per row
  const int tc = threadIdx.x % tw, tr = threadIdx.x / tw;
  const int ch = min(i0 + tc, a.cin - 1);
  float mu = 0.0f, rstd = 0.0f, gamma = 0.0f, beta = 0.0f;
  double acc[kRI][8];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0;
  }
  if (k0 < k1) {
    stage_dw_tile<kTO>(bufs, bufs + kTileP * kDwTile, a, k0, i0, ti, o0, to);
  }
  cp_async_commit();
  int cur = -1;
  for (long long k = k0; k < k1; ++k) {
    float* A = bufs + ((k - k0) & 1) * kStage;
    float* D = A + kTileP * kDwTile;
    if (k + 1 < k1) {
      float* An = bufs + ((k + 1 - k0) & 1) * kStage;
      stage_dw_tile<kTO>(An, An + kTileP * kDwTile, a, k + 1, i0, ti, o0, to);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile k is in; tile k + 1 may still be loading
    __syncthreads();
    int blk, np;
    long long p0;
    tile_of(a.gh, k, &blk, &p0, &np);
    if (a.has_prev && blk != cur) {
      const size_t kb = static_cast<size_t>(blk) * a.cin + ch;
      mu = a.prev.mu[kb];
      rstd = a.prev.rstd[kb];
      gamma = a.prev.gamma[ch];
      beta = a.prev.beta[ch];
      cur = blk;
    }
    // op(act(in)) in place: the layer below's BN + ReLU on its stored xhat,
    // then the operand's rounding; channels past cin are 0
    if (tc < ti) {
      for (int p = tr; p < np; p += kDwThreads / tw) {
        float v = 0.0f;
        if (i0 + tc < a.cin) {
          v = A[p * kDwTile + tc];
          if (a.has_prev) {
            const float xh = rnd(__fmul_rn(__fsub_rn(v, mu), rstd), R::xhat);
            v = relu_nan(__fmaf_rn(gamma, xh, beta));
          }
          v = rnd(v, R::op);
        }
        A[p * kDwTile + tc] = v;
      }
    }
    __syncthreads();
    if (active) {
      float s[kRI][8];
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
      }
      // the operands of p + 1 are loaded before the products of p
      const float* ap = A + kRI * ig;
      const float* dp = D + 8 * og;
      float ar[kRI], dr[8];
      load_dz<kRI>(ar, ap);
      load_dz<8>(dr, dp);
#pragma unroll 2
      for (int p = 0; p < np; ++p) {
        const int pn = min(p + 1, np - 1);
        float an[kRI], dn[8];
        load_dz<kRI>(an, ap + pn * kDwTile);
        load_dz<8>(dn, dp + pn * kTO);
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(ar[i], dr[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRI; ++i) ar[i] = an[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) dr[j] = dn[j];
      }
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += static_cast<double>(s[i][j]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();
  if (!active) return;
  double* out = a.dw_part + static_cast<size_t>(blockIdx.y) * a.cin_pad * a.cout;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ii = kRI * ig + i, oo = 8 * og + j;
      if (ii < ti && oo < to) {
        out[static_cast<size_t>(i0 + ii) * a.cout + o0 + oo] = acc[i][j];
      }
    }
  }
}

// pmt_bwd_dz for kRP points a thread, or null for another kRP
template <int kMode>
const void* dz_kernel(int rp) {
  switch (rp) {
    case 1: return reinterpret_cast<const void*>(pmt_bwd_dz_kernel<1, kMode>);
    case 2: return reinterpret_cast<const void*>(pmt_bwd_dz_kernel<2, kMode>);
    case 4: return reinterpret_cast<const void*>(pmt_bwd_dz_kernel<4, kMode>);
    case 8: return reinterpret_cast<const void*>(pmt_bwd_dz_kernel<8, kMode>);
    case 16: return reinterpret_cast<const void*>(pmt_bwd_dz_kernel<16, kMode>);
    default: return nullptr;
  }
}

// pmt_bwd_dw for kRI input channels a thread, or null for another kRI
template <int kMode>
const void* dw_kernel(int ri) {
  switch (ri) {
    case 4: return reinterpret_cast<const void*>(pmt_bwd_dw_kernel<4, kMode>);
    case 8: return reinterpret_cast<const void*>(pmt_bwd_dw_kernel<8, kMode>);
    default: return nullptr;
  }
}

// k0(arg), k1(arg) or k2(arg) for backward mode 0, 1 or 2 (Rounds), or null
const void* of_mode(int mode, int arg, const void* (*k0)(int),
                    const void* (*k1)(int), const void* (*k2)(int)) {
  return mode == 0 ? k0(arg) : mode == 1 ? k1(arg) : mode == 2 ? k2(arg) : nullptr;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

GBN make_gbn(const float* const* v) {
  return v ? GBN{v[0], v[1], v[2], v[3]} : GBN{nullptr, nullptr, nullptr, nullptr};
}

Ghost make_ghost(int bb, int n) {
  const long long m = static_cast<long long>(bb) * n;
  return Ghost{m, static_cast<int>((m + kTileP - 1) / kTileP)};
}

}  // namespace

// A pmt_dense block (ops/cuda/point_mlp_plan.py counts the same): the f64
// sums [2, cout], a chunk of the tile's z [min(cout, 64)][68], the layer
// below's BN constants [4, cin], the activation tile of 64 words a row
// and, with `stage`, the next tile's raw rows [64, cin + 4].
extern "C" size_t snt_pmt_dense_smem(int cin, int cout, int stage) {
  return 2 * static_cast<size_t>(cout) * sizeof(double) +
         (static_cast<size_t>(cout < kChunk ? cout : kChunk) * kStride + 4 * cin +
          static_cast<size_t>(mma::tile_rows(cin, false)) * kTileP +
          (stage ? static_cast<size_t>(kTileP) * stage_stride(cin) : 0)) *
             sizeof(float);
}

// A pmt_bwd_dz block: op(W)^T rows [kc, cin_pad], 7 per-channel constants,
// dz [cout, 68], each point's cloud and index [2, 64], and with `stage` the
// raw z and dh rows [2, 64, cout] (the launch planner,
// ops/cuda/point_mlp_plan.py, counts the same).
extern "C" size_t snt_pmt_bwd_dz_smem(int cin_pad, int cout, int kc, int stage) {
  return sizeof(float) * (static_cast<size_t>(kc) * cin_pad + 7 * cout +
                          static_cast<size_t>(cout) * kStride + 2 * kTileP +
                          (stage ? 2 * static_cast<size_t>(kTileP) * cout : 0));
}

// A pmt_bwd_dw block for ri x 8 outputs a thread: two stages of a tile of
// act(in), 64 channels, and of dz, 16 * ri channels.
extern "C" size_t snt_pmt_bwd_dw_smem(int ri) {
  return sizeof(float) * 2 * kTileP * (kDwTile + kDwThreads * ri * 8 / kDwTile);
}

// prev_bn holds (mu, rstd, gamma, beta) of the layer below, or is null for
// the first layer (then `in` is x itself); `store` applies the backward's
// stored-xhat rounding to it. z may be null (sums only). bf16 rounds the
// operands; `stage` (the launch plan's, taken where cin is a multiple of
// 4) stages the next tile's rows with cp.async.
extern "C" int snt_pmt_dense(const float* in, int cin, const float* const* prev_bn,
                             int store, int bf16, const float* w, int cout,
                             float* z, double* rows, int n_blocks, int bb, int n,
                             int stage, int grid, cudaStream_t stream) {
  if (cout % 4 || cin < 1 || grid < 1 || n_blocks < 1 || (stage && cin % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = bf16 ? reinterpret_cast<const void*>(pmt_dense_kernel<true>)
                            : reinterpret_cast<const void*>(pmt_dense_kernel<false>);
  const size_t smem = snt_pmt_dense_smem(cin, cout, stage);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  GBN prev = make_gbn(prev_bn);
  int has_prev = prev_bn != nullptr;
  Ghost gh = make_ghost(bb, n);
  void* args[] = {&in, &cin, &prev, &has_prev, &store, &w, &cout, &z, &rows,
                  &gh, &stage};
  err = cudaLaunchKernel(kernel, dim3(grid, n_blocks), dim3(kThreads), args,
                         smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int snt_pmt_pool(const float* z, const float* const* bn, int b,
                            int bb, int n, int c_out, float* pooled, int* argmax,
                            cudaStream_t stream) {
  pmt_pool_kernel<<<b, kThreads, 0, stream>>>(z, make_gbn(bn), bb, n, c_out,
                                              pooled, argmax);
  return static_cast<int>(cudaGetLastError());
}

// dh null: the top layer, dh from the pooled cotangent g at argmax.
extern "C" int snt_pmt_rows(const float* z, const float* const* bn, int c_out,
                            int store, const float* dh, const float* g,
                            const int* argmax, int n_blocks, int bb, int n,
                            double* rows, int grid, cudaStream_t stream) {
  if (grid < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = c_out < kThreads ? (c_out + 31) / 32 * 32 : kThreads;
  pmt_rows_kernel<<<dim3(grid, n_blocks), threads, 0, stream>>>(
      z, make_gbn(bn), c_out, store, dh, g, argmax, bb, n, make_ghost(bb, n),
      rows);
  return static_cast<int>(cudaGetLastError());
}

// dz and dh_prev of one layer (dh null: the top layer, dh from the pooled
// cotangent g at argmax) over 64-point tiles, `grid` blocks, with the
// roundings of backward mode `mode` (Rounds: 0 f32, 1 ghost bf16, 2 exact
// bf16).
extern "C" int snt_pmt_bwd_dz(const float* z, const float* const* bn,
                              const float* rstd2, const float* r1,
                              const float* r2, int cout, int mode,
                              const float* dh, const float* g,
                              const int* argmax, const float* wt, int cin_pad,
                              float* dz, float* dh_prev, int n_blocks, int bb,
                              int n, int rp, int kc, int stage, int grid,
                              cudaStream_t stream) {
  if (cout % 4 || cin_pad % 4 || cin_pad < 4 || kc % 4 || kc < 4 || grid < 1 ||
      n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DzArgs a{z, make_gbn(bn), rstd2, r1, r2, dh, g, argmax, n, cout, wt,
                 cin_pad, kc, stage, dz, dh_prev, make_ghost(bb, n), n_blocks};
  const size_t smem = snt_pmt_bwd_dz_smem(cin_pad, cout, kc, stage);
  const void* kernel = of_mode(mode, rp, dz_kernel<0>, dz_kernel<1>, dz_kernel<2>);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<DzArgs*>(&a)};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(kDzThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// f64 partials dw_part [splits, cin_pad, cout] of dW = op(act(in))^T dz:
// grid (output tiles of 64 x 16*ri) x splits runs of consecutive 64-point
// tiles, ri x 8 outputs a thread, with the roundings of backward mode
// `mode` (Rounds).
extern "C" int snt_pmt_bwd_dw(const float* in, int cin, int cin_pad,
                              const float* const* prev_bn, int mode,
                              const float* dz, int cout, double* dw_part,
                              int n_blocks, int bb, int n, int splits, int ri,
                              cudaStream_t stream) {
  if (cout % 4 || cin_pad % 4 || cin < 1 || cin > cin_pad || splits < 1 ||
      n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = snt_pmt_bwd_dw_smem(ri);
  const void* kernel = of_mode(mode, ri, dw_kernel<0>, dw_kernel<1>, dw_kernel<2>);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwArgs a{in, cin, cin_pad, make_gbn(prev_bn), prev_bn != nullptr, dz,
                 cout, dw_part, make_ghost(bb, n), n_blocks, splits};
  const int to = kDwThreads * ri * 8 / kDwTile;
  const int out_tiles = ((cin_pad + kDwTile - 1) / kDwTile) * ((cout + to - 1) / to);
  void* args[] = {const_cast<DwArgs*>(&a)};
  err = cudaLaunchKernel(kernel, dim3(out_tiles, splits), dim3(kDwThreads), args,
                         smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
