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
//               operand in bf16. In f32 the products run on FP32 FMAs in
//               channel order, 4 points x 4 channels a thread (mma_tile.cuh's
//               simt_product): the plain path's sums, which the f32 chains'
//               checks hold them to at BN's ReLU kinks (mma_tile.cuh says
//               why the tensor cores' are not). In bf16 a layer of 16 or
//               more input channels runs on the tensor cores (mma.sync
//               m16n8k16 in tile_product_bf16's warp layout: the tile holds
//               act(in) as bf16 pairs, op(W) comes packed the same way and
//               is copied into shared memory once a block where two blocks
//               still fit an SM with it, each K step of 16 summed from zero,
//               then added in f32); the first layer (x, 3 channels) stays
//               on the FP32 pipes with rounded operands, as in
//               point_mlp_max; the ghost chain (its forward and its
//               backward's rstd recompute) stays there too, wmode 0: its
//               backward rounds each dz to bf16 from sums that follow this
//               z, and only in the plain path's channel order did those
//               roundings keep to the plain bf16 version's within its check
//               (PERF.md). In f32 W comes through the read-only cache,
//               so shared memory holds only the tile, and cp.async stages
//               the next tile's raw rows
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
//               op(W)^T. In the exact chain's bf16 mode 2, pmt_bwd_dz_mma
//               forms dz the same way and runs dh_prev on mma.sync
//               m16n8k16 (op(W)^T in pairs of output channels, K steps of
//               16 in order); its product is short and the form's reads
//               bound it, so the plan stages the rows wherever two blocks
//               fit with them, op(W)^T in K chunks if it must, a top layer
//               staging z alone. The ghost chain's mode 1 keeps the FP32
//               pipes: each layer's dz is rounded to bf16 from dh_prev's
//               sums, and in the plain path's order those roundings
//               follow the plain bf16 version's (PERF.md). A
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
//               Where the tile's dz [cout][68] and the constants [7][cout]
//               do not fit (cout >= 768 at 128 inputs), a second kernel,
//               pmt_bwd_dz_chunked, takes the output channels in chunks of
//               kc, in increasing order: per tile and chunk it loads the
//               chunk's constants and op(W)^T rows, forms the chunk's dz
//               (to HBM and [kc][68] in shared memory) and goes on with each
//               thread's dh_prev sums over the chunk's o. A sum outlives
//               the chunks in registers where the tile's dh_prev takes one
//               pass of the block's threads (every layer of the tracks), else
//               in dh_prev itself, which the same thread stores and reads
//               back: each sum runs over o = 0 .. cout-1 in order, as in one
//               chunk, so dz and dh_prev do not depend on kc either.
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
//               4 x 8 tile is bound by those reads). In bf16 (modes 1 and 2,
//               pmt_bwd_dw_mma, 256 threads) the same output tiles and
//               split-K grid run on mma.sync m16n8k16 with the points as K:
//               act(h_prev) of each staged tile is transformed into point
//               pairs in shared memory, dz's pairs are packed from its staged
//               rows in registers, each 16-point step summed from zero, the
//               tile's 4 steps in f32, the tile once into f64. The caller
//               sums the f64 partials [S, cin_pad, cout] in order.
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
// step's shape (B=32) it is 2.2 GFLOP forward and 4.3 GFLOP backward. In
// bf16 the products go to the tensor cores (989 TFLOP/s), where they take
// a tenth of a millisecond at B=1024: the bf16 modes are bound by the bytes
// above. Their checks hold them norm-wise to the plain bf16 version, which
// sums in another order already; the f32 chains stay on the FP32 pipes,
// held to the plain path's order, until a check that sees accuracy rather
// than summation order (ROADMAP.md). Fusing pmt_rows into pmt_bwd_dz is
// later work.

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

// The bf16 operand pair that the tensor-core passes take: bf16(lo) in the
// low half, bf16(hi) in the high half, each rounded to nearest as rnd()
// rounds (the pairs of pmt_dense's tile and of pmt_bwd_dw's act(h_prev))
__device__ __forceinline__ uint32_t pack_op(float lo, float hi) {
  return mma::pack_bf16(lo, hi);
}

// Two floats that hold bf16 values (dz, rounded where it was formed) as
// one pair, their high halves: no rounding
__device__ __forceinline__ uint32_t pair_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Words a row of bf16 pairs takes in shared memory where its c columns are
// an MMA's N (op(W) in pmt_dense, op(W)^T in pmt_bwd_dz_mma;
// point_mlp_plan.py's wt_stride): c to the N step of 8, plus 8 where that
// is a multiple of 16, so that the 4 pair rows a B fragment reads start 8
// (or 24) banks apart and its 32 words hit 32 banks
__host__ __device__ constexpr int wt_stride(int c) {
  return (c + 7) / 8 * 8 + ((c + 7) / 8 % 2 == 0 ? 8 : 0);
}

// Whether pmt_dense runs a layer on the tensor cores: bf16, 16 or more
// input channels, and `wmode` (its launch argument) 1 (op(W) through the
// read-only cache) or 2 (op(W) in shared memory); wmode 0 keeps bf16 on the
// FP32 pipes, in the plain path's channel order
template <bool kBf16>
__host__ __device__ __forceinline__ bool dense_pairs(int cin, int wmode) {
  if constexpr (kBf16) return cin >= mma::kBf16K && wmode != 0;
  return false;
}

// Rows of pmt_dense's activation tile: bf16 pairs on the tensor cores
// (`pairs`), else f32 rows to 4
template <bool kBf16>
__host__ __device__ __forceinline__ int dense_rows(int cin, bool pairs) {
  if constexpr (kBf16) {
    if (pairs) return mma::pair_rows(cin);
  }
  return mma::tile_rows(cin, false);
}

// load_act_tile's act(in) of tile rows [p0, p0 + np) into the pair tile
// `as` (mma_tile.cuh's bf16 layout: pair_rows(cin) rows, two channels a
// word, rounded by pack_op): a thread takes 4 channels of one point, as in
// load_act_tile, and stores two words; channels past cin and points past
// np are 0.
__device__ __forceinline__ void load_act_pairs(uint32_t* as,
                                               const float* __restrict__ in,
                                               const float* stage, int cin,
                                               const float* cs, int store,
                                               long long p0, int np) {
  const int cq = mma::pair_rows(cin) / 2;
  for (int e = threadIdx.x; e < kTileP * cq; e += kThreads) {
    const int p = e % kTileP, c = (e / kTileP) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (p < np && c < cin) {
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
    as[aidx(c / 2, p)] = pack_op(v[0], v[1]);
    as[aidx(c / 2 + 1, p)] = pack_op(v[2], v[3]);
  }
}

// acc[mi][ni] += A W for this thread's fragments of the 64-channel chunk at
// n0: mma_tile.cuh's tile_product_bf16 (its warp layout, each K step of 16
// summed from zero, then added in f32) with op(W) in pairs from shared
// memory, wsm [pair_rows(cin)][ws] words (the rows past ceil(cin/2) zero),
// columns past cout read as 0. W through the read-only cache, as
// tile_product_bf16 takes it, measured slower here: beside this kernel's
// shared memory the L1 keeps too little of it.
__device__ __forceinline__ void product_pairs(float (&acc)[2][2][4],
                                              const uint32_t* as,
                                              const uint32_t* wsm, int cin,
                                              int ws, int cout, int n0) {
  const mma::Frag f(n0, 2);
  const int col0 = f.n - 2 * f.t + f.g;  // this lane's B column, ni = 0
  const int kp = mma::pair_rows(cin);
  for (int k0 = 0; k0 < kp; k0 += mma::kBf16K / 2) {
    const int ka = k0 + f.t, kb = ka + 4;  // pair rows
    uint32_t a[2][4], b[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int p = f.m0 + 16 * mi + f.g;
      a[mi][0] = as[aidx(ka, p)];
      a[mi][1] = as[aidx(ka, p + 8)];
      a[mi][2] = as[aidx(kb, p)];
      a[mi][3] = as[aidx(kb, p + 8)];
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int c = col0 + 8 * ni;
      b[ni][0] = c < cout ? wsm[ka * ws + c] : 0u;
      b[ni][1] = c < cout ? wsm[kb * ws + c] : 0u;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        float step[4] = {};
        mma::mma_bf16(step, a[mi], b[ni]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += step[e];
      }
    }
  }
}

// dense_chunk on the tensor cores: z[., n0 .. n0 + nc) = act(in) op(W) of
// one tile from the pair tile and op(W)'s pairs, 64 channels a chunk: from
// shared memory (product_pairs) where wsm is set, else packed
// [ceil(cin/2)][cout] in device memory wp (tile_product_bf16). Each
// thread's fragments go to z in HBM, two channels at a time, and into zt
// [nc][kStride].
__device__ __forceinline__ void dense_chunk_mma(const uint32_t* as,
                                                const uint32_t* __restrict__ wp,
                                                const uint32_t* wsm, int cin,
                                                int cout, int n0, int nc,
                                                float* __restrict__ z, float* zt,
                                                long long p0, int np) {
  float acc[2][2][4] = {};
  if (wsm != nullptr) {
    product_pairs(acc, as, wsm, cin, wt_stride(cout), cout, n0);
  } else {
    mma::tile_product_bf16<2>(acc, as, wp, (cin + 1) / 2, cout, n0);
  }
  const mma::Frag f(n0, 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int c = f.n + 8 * ni;  // channels c, c + 1
      if (c >= n0 + nc) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = f.m0 + 16 * mi + f.g + 8 * h;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (z != nullptr && p < np) {
          *reinterpret_cast<float2*>(z + (p0 + p) * cout + c) = make_float2(v0, v1);
        }
        zt[(c - n0) * kStride + p] = v0;
        zt[(c - n0 + 1) * kStride + p] = v1;
      }
    }
  }
}

// Operands rounded by rnd() with kBf16. With `stage`, cp.async brings the
// next tile's raw rows in while the tile's products run; in bf16 `wmode`
// picks the tensor cores (dense_pairs; 2: op(W)'s pairs copied into shared
// memory once a block) or the FP32 pipes (0).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
pmt_dense_kernel(const float* __restrict__ in, int cin, GBN prev, int has_prev,
                 int store,
                 const float* __restrict__ w,  // [cin, cout], op() applied
                 int cout, float* __restrict__ z,  // [P*m, cout] or null
                 double* __restrict__ rows,        // [P, G, 2, cout]
                 Ghost gh, int stage, int wmode) {
  extern __shared__ float4 smem4[];
  double* acc = reinterpret_cast<double*>(smem4);        // [2][cout]
  float* zt = reinterpret_cast<float*>(acc + 2 * cout);  // [kChunk][kStride]
  float* cs = zt + min(cout, kChunk) * kStride;          // [4][cin]
  uint32_t* as = reinterpret_cast<uint32_t*>(cs + 4 * cin);  // the tile
  const bool pairs = dense_pairs<kBf16>(cin, wmode);
  const int arows = dense_rows<kBf16>(cin, pairs);
  float* staged = stage ? reinterpret_cast<float*>(as + arows * kTileP) : nullptr;
  uint32_t* wsm = nullptr;  // bf16 on the tensor cores: op(W)'s pairs
  if constexpr (kBf16) {
    if (pairs && wmode == 2) {
      wsm = as + arows * kTileP + (stage ? kTileP * stage_stride(cin) : 0);
      const int kp = (cin + 1) / 2, q = cout / 4, ws = wt_stride(cout);
      const uint4* src = reinterpret_cast<const uint4*>(w);
      for (int e = threadIdx.x; e < mma::pair_rows(cin) * q; e += kThreads) {
        const int r = e / q, c = (e % q) * 4;
        *reinterpret_cast<uint4*>(wsm + r * ws + c) =
            r < kp ? __ldg(src + e) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
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
    if constexpr (kBf16) {
      if (pairs) {
        load_act_pairs(as, in, staged, cin, has_prev ? cs : nullptr, store, p0, np);
      } else {
        load_act_tile<true>(as, in, staged, cin, has_prev ? cs : nullptr, store,
                            p0, np);
      }
    } else {
      load_act_tile<false>(as, in, staged, cin, has_prev ? cs : nullptr, store,
                           p0, np);
    }
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
      if constexpr (kBf16) {
        if (pairs) {
          dense_chunk_mma(as, reinterpret_cast<const uint32_t*>(w), wsm, cin,
                          cout, n0, nc, z, zt, p0, np);
        } else {
          dense_chunk(as, w, cin, cout, n0, nc, z, zt, p0, np);
        }
      } else {
        dense_chunk(as, w, cin, cout, n0, nc, z, zt, p0, np);
      }
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

// dz of channels o0 .. o0+nc-1 of one tile into dzs [nc][kStride] and HBM,
// from their constants cs [7][nc], four points of one channel a thread
// (reads along the rows, one float4 store into dzs, coalesced stores of dz);
// z and dh rows from the stage (kStaged) or from HBM
template <bool kStaged, int kMode>
__device__ __forceinline__ void form_dz(const DzArgs& a, const float* zr,
                                        const float* dhr, const float* cs,
                                        const int* pcl, float* dzs,
                                        long long p0, int np, int o0, int nc) {
  using R = Rounds<kMode>;
  const int cout = a.cout;
  for (int e = threadIdx.x; e < (kTileP / 4) * nc; e += kDzThreads) {
    const int o = e % nc, q = (e / nc) * 4, og = o0 + o;
    const float mu = cs[o], rstd = cs[nc + o], gamma = cs[2 * nc + o];
    const float beta = cs[3 * nc + o], r1 = cs[4 * nc + o];
    const float r2 = cs[5 * nc + o], rstd2 = cs[6 * nc + o];
    float zv[4], dhv[4], v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // every load of the quad before any use
      const int p = q + j;
      zv[j] = dhv[j] = 0.0f;
      if (p < np) {
        const int k = p * cout + og;
        if (dhr == nullptr) {  // the top layer: g at the cloud's argmax
          const int b = pcl[p], lp = pcl[kTileP + p];
          dhv[j] = __ldg(a.argmax + b * cout + og) == lp ? __ldg(a.g + b * cout + og)
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
        a.dz[(p0 + p) * cout + og] = v[j];
      }
    }
    *reinterpret_cast<float4*>(dzs + o * kStride + q) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The constants of channels c0 .. c0+nc-1 of ghost block blk into cs [7][nc]
__device__ __forceinline__ void load_dz_consts(float* cs, const DzArgs& a,
                                               int blk, int c0, int nc) {
  const size_t base = static_cast<size_t>(blk) * a.cout + c0;
  for (int c = threadIdx.x; c < nc; c += kDzThreads) {
    cs[c] = a.bn.mu[base + c];
    cs[nc + c] = a.bn.rstd[base + c];
    cs[2 * nc + c] = a.bn.gamma[c0 + c];
    cs[3 * nc + c] = a.bn.beta[c0 + c];
    cs[4 * nc + c] = a.r1[base + c];
    cs[5 * nc + c] = a.r2[base + c];
    cs[6 * nc + c] = a.rstd2[base + c];
  }
}

// Each point's cloud and index in it, for the top layer's dh at argmax
__device__ __forceinline__ void load_clouds(int* pcl, const DzArgs& a,
                                            long long p0, int np) {
  for (int p = threadIdx.x; p < np; p += kDzThreads) {
    const long long b = (p0 + p) / a.n;
    pcl[p] = static_cast<int>(b);
    pcl[kTileP + p] = static_cast<int>(p0 + p - b * a.n);
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

// The points (pg * kRP ..) and channels (cg * 4 ..) of dh_prev that slot u
// of a tile's ncg x npg slots owns: warps of 4 point groups x 8 channel
// groups where the tile allows (dz reads 4 rows, W^T 8 float4: no bank
// conflict), else row-major
__device__ __forceinline__ void dz_slot(int u, int ncg, int npg, int* pg,
                                        int* cg) {
  if (ncg % 8 == 0 && npg % 4 == 0) {
    const int w = u / 32, l = u % 32, wpc = ncg / 8;
    *pg = (w / wpc) * 4 + l / 8;
    *cg = (w % wpc) * 8 + l % 8;
  } else {
    *pg = u / ncg;
    *cg = u % ncg;
  }
}

// acc[r][j] += dz[pp + r, o] op(W)[i0 + j, o] over o = 0 .. n-1 in order,
// from op(W)^T rows wts [n][cin_pad] and dz rows dzs [n][kStride], f32
template <int kRP>
__device__ __forceinline__ void dz_product(float (&acc)[kRP][4],
                                           const float* wts, const float* dzs,
                                           int n, int cin_pad, int i0, int pp) {
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const float4 wv = *reinterpret_cast<const float4*>(wts + o * cin_pad + i0);
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
      load_dz_consts(cs, a, blk, 0, cout);
      cur = blk;
    }
    if (top) load_clouds(pcl, a, p0, np);
    __syncthreads();
    if (a.stage) {
      form_dz<true, kMode>(a, stage, top ? nullptr : stage + kTileP * cout, cs, pcl,
                           dzs, p0, np, 0, cout);
    } else {
      form_dz<false, kMode>(a, a.z + p0 * cout,
                            top ? nullptr : a.dh + p0 * cout, cs, pcl, dzs, p0, np,
                            0, cout);
    }
    __syncthreads();  // dzs complete; the stage is free for the next tile
    if (a.stage && k + gridDim.x < total) stage_dz_tile(stage, a, k + gridDim.x);
    cp_async_commit();
    // dh_prev[p, i] = sum_o dz[p, o] op(W)[i, o], o in order, f32
    for (int u0 = 0; u0 < ntt; u0 += kDzThreads) {
      const int u = u0 + threadIdx.x;
      int pg, cg;
      dz_slot(u, ncg, npg, &pg, &cg);
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
        if (u < ntt) dz_product<kRP>(acc, wts, dzs + c0 * kStride, c1 - c0, cin_pad, i0, pp);
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

// pmt_bwd_dz in chunks of kc output channels (the header says how); no
// staging. The partial of dh_prev of a slot: acc in registers where each
// thread owns at most one slot, else dh_prev in HBM between chunks.
template <int kRP, int kMode>
__global__ void __launch_bounds__(kDzThreads, dz_min_blocks<kRP>())
pmt_bwd_dz_chunked_kernel(DzArgs a) {
  extern __shared__ float4 smem4[];
  const int cout = a.cout, cin_pad = a.cin_pad, oc = a.kc;
  float* wts = reinterpret_cast<float*>(smem4);  // [oc][cin_pad]: op(W)^T rows
  float* cs = wts + oc * cin_pad;                // [7][nc]: the chunk's constants
  float* dzs = cs + 7 * oc;                      // [oc][kStride]: the chunk's dz
  int* pcl = reinterpret_cast<int*>(dzs + oc * kStride);  // [2][64]: b, point
  const bool top = a.dh == nullptr;
  const long long total = static_cast<long long>(a.n_blocks) * a.gh.tiles;
  const int ncg = cin_pad / 4, npg = kTileP / kRP, ntt = npg * ncg;
  const bool in_regs = ntt <= kDzThreads;
  for (long long k = blockIdx.x; k < total; k += gridDim.x) {
    int blk, np;
    long long p0;
    tile_of(a.gh, k, &blk, &p0, &np);
    __syncthreads();  // the last tile's product is done with pcl
    if (top) load_clouds(pcl, a, p0, np);
    float acc[kRP][4];
#pragma unroll
    for (int r = 0; r < kRP; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
    }
    for (int c0 = 0; c0 < cout; c0 += oc) {
      const int nc = min(oc, cout - c0);
      if (c0 > 0) __syncthreads();  // the last chunk's product is done
      load_dz_consts(cs, a, blk, c0, nc);
      load_wt_rows(wts, a, c0, c0 + nc);
      __syncthreads();
      form_dz<false, kMode>(a, a.z + p0 * cout, top ? nullptr : a.dh + p0 * cout,
                            cs, pcl, dzs, p0, np, c0, nc);
      __syncthreads();  // the chunk's dz is complete
      const bool last = c0 + nc == cout;
      for (int u = threadIdx.x; u < ntt; u += kDzThreads) {
        int pg, cg;
        dz_slot(u, ncg, npg, &pg, &cg);
        const int pp = pg * kRP, i0 = cg * 4;
        float* out = a.dh_prev + (p0 + pp) * cin_pad + i0;
        if (!in_regs) {  // this slot's sums so far (this thread stored them)
#pragma unroll
          for (int r = 0; r < kRP; ++r) {
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (c0 > 0 && pp + r < np) v = *reinterpret_cast<const float4*>(out + r * cin_pad);
            acc[r][0] = v.x;
            acc[r][1] = v.y;
            acc[r][2] = v.z;
            acc[r][3] = v.w;
          }
        }
        dz_product<kRP>(acc, wts, dzs, nc, cin_pad, i0, pp);
        if (in_regs && !last) continue;
#pragma unroll
        for (int r = 0; r < kRP; ++r) {
          if (pp + r < np) {
            *reinterpret_cast<float4*>(out + r * cin_pad) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          }
        }
      }
    }
  }
}

// pair rows [r0, r1) of op(W)^T [pair_rows(cout)][cin_pad] words into wts
// [.][wt_stride(cin_pad)], 16 bytes a thread
__device__ __forceinline__ void load_wt_pairs(uint32_t* wts, const DzArgs& a,
                                              int r0, int r1) {
  const int q = a.cin_pad / 4, ws = wt_stride(a.cin_pad);
  const uint4* src = reinterpret_cast<const uint4*>(a.wt) + static_cast<size_t>(r0) * q;
  for (int e = threadIdx.x; e < (r1 - r0) * q; e += kDzThreads) {
    const int r = e / q, c = (e % q) * 4;
    *reinterpret_cast<uint4*>(wts + r * ws + c) = __ldg(src + e);
  }
}

// pmt_bwd_dz in the exact chain's bf16 mode (2) with dh_prev = dz op(W)^T
// on the tensor cores: the tile's dz formed as in pmt_bwd_dz (form_dz, to HBM and
// to dzs [cout][kStride], rounded to bf16), then mma.sync m16n8k16 with the
// points as M, the input channels as N and the output channels as K. The
// 8 warps split a pass of 64 points x 128 input channels 2 x 4: warp w owns
// points 32*(w & 1) .. +31 (two 16-row tiles, their A fragments packed from
// dzs' rows, which hold bf16 values) and the 8-channel column tiles
// (w >> 1) + 4j of the pass; op(W)^T comes packed in pairs of output
// channels, [pair_rows(cout)][cin_pad] words, resident in shared memory or
// in K chunks of kc channels (a multiple of 16) reloaded per tile. Each K
// step of 16 output channels is summed from zero on the tensor cores and
// added into the f32 accumulator in increasing order, so dh_prev does not
// depend on the tiling either. Built for 2 or 3 blocks an SM (kMinBlocks:
// its registers), as the launch plan picks.
template <int kMode, int kMinBlocks>
__global__ void __launch_bounds__(kDzThreads, kMinBlocks)
pmt_bwd_dz_mma_kernel(DzArgs a) {
  extern __shared__ float4 smem4[];
  const int cout = a.cout, cin_pad = a.cin_pad, ws = wt_stride(cin_pad);
  const bool resident = a.kc >= cout;
  uint32_t* wts = reinterpret_cast<uint32_t*>(smem4);  // [pair_rows(kc)][ws]
  float* cs = reinterpret_cast<float*>(wts + mma::pair_rows(a.kc) * ws);  // [7][cout]
  float* dzs = cs + 7 * cout;                    // [cout][kStride]: the tile's dz
  int* pcl = reinterpret_cast<int*>(dzs + cout * kStride);  // [2][64]: b, point
  float* stage = reinterpret_cast<float*>(pcl + 2 * kTileP);  // [2][64][cout]
  const bool top = a.dh == nullptr;
  const long long total = static_cast<long long>(a.n_blocks) * a.gh.tiles;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, m0 = 32 * (w & 1), wn = w >> 1;
  const int ntiles = (cin_pad + 7) / 8;          // 8-channel column tiles
  const int kend = mma::pair_rows(cout) * 2;     // cout to the K step

  if (resident) load_wt_pairs(wts, a, 0, mma::pair_rows(cout));
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
      load_dz_consts(cs, a, blk, 0, cout);
      cur = blk;
    }
    if (top) load_clouds(pcl, a, p0, np);
    __syncthreads();
    if (a.stage) {
      form_dz<true, kMode>(a, stage, top ? nullptr : stage + kTileP * cout, cs, pcl,
                           dzs, p0, np, 0, cout);
    } else {
      form_dz<false, kMode>(a, a.z + p0 * cout,
                            top ? nullptr : a.dh + p0 * cout, cs, pcl, dzs, p0, np,
                            0, cout);
    }
    __syncthreads();  // dzs complete; the stage is free for the next tile
    if (a.stage && k + gridDim.x < total) stage_dz_tile(stage, a, k + gridDim.x);
    cp_async_commit();
    for (int nb = 0; nb < ntiles; nb += 16) {  // passes of 128 input channels
      float acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
        }
      }
      const int kc = resident ? kend : a.kc;  // K chunks: multiples of 16
      for (int c0 = 0; c0 < kend; c0 += kc) {
        const int c1 = min(kend, c0 + kc);
        if (!resident) {  // K chunks: every thread takes part in the loads
          __syncthreads();  // the last chunk's products are done with wts
          load_wt_pairs(wts, a, c0 / 2, c1 / 2);
          __syncthreads();
        }
        for (int o0 = c0; o0 < c1; o0 += mma::kBf16K) {  // K steps in order
          uint32_t af[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int p = m0 + 16 * mi + g;
#pragma unroll
            for (int hk = 0; hk < 2; ++hk) {  // output channels o, o + 1
              const int o = o0 + 2 * t + 8 * hk;
              const bool in = o < cout;
              const float* d = dzs + o * kStride + p;
              af[mi][2 * hk] = in ? pair_of(d[0], d[kStride]) : 0u;
              af[mi][2 * hk + 1] = in ? pair_of(d[8], d[kStride + 8]) : 0u;
            }
          }
          const uint32_t* wr = wts + ((o0 - (resident ? 0 : c0)) / 2 + t) * ws + g;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = nb + wn + 4 * j;
            if (nt >= ntiles) break;
            const uint32_t b[2] = {wr[nt * 8], wr[4 * ws + nt * 8]};
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {  // the step's sum, then one f32 add
              float step[4] = {};
              mma::mma_bf16(step, af[mi], b);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][j][e] += step[e];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = (nb + wn + 4 * j) * 8 + 2 * t;  // channels col, col + 1
        if (col >= cin_pad) continue;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = m0 + 16 * mi + g + 8 * h;
            if (p < np) {
              *reinterpret_cast<float2*>(a.dh_prev + (p0 + p) * cin_pad + col) =
                  make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
            }
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

constexpr int kPairStride = 36;  // words a row of point pairs: 4g + t hits 32 banks
constexpr int kDwMmaThreads = 256;

// pmt_bwd_dw_mma's shared memory for an output tile of 64 input x `to`
// output channels (64 or 128, as dw_to<4>() and dw_to<8>()): the raw rows
// of a tile of `in` [64][68] and of dz [64][to + 4], op(act(in)) in point
// pairs [64][kPairStride] words, and the BN constants of the tile's 64
// input channels [4][64]
__host__ __device__ constexpr size_t dw_mma_smem(int to) {
  return sizeof(float) * (static_cast<size_t>(kTileP) * (kDwTile + 4 + to + 4) +
                          static_cast<size_t>(kDwTile) * kPairStride + 4 * kDwTile);
}

// cp.async of tile k's rows of in, channels i0 .. i0+ti (those below cin),
// into A [64][kDwTile + 4]
__device__ __forceinline__ void stage_dw_in(float* A, const DwArgs& a, long long k,
                                            int i0, int ti) {
  constexpr int kQA = kDwTile / 4;
  int blk, np;
  long long p0;
  tile_of(a.gh, k, &blk, &p0, &np);
  if (a.cin % 4 == 0) {
    for (int c = threadIdx.x; c < np * kQA; c += kDwMmaThreads) {
      const int p = c / kQA, j = (c % kQA) * 4;
      if (j < ti) cp_async16(A + p * (kDwTile + 4) + j, a.in + (p0 + p) * a.cin + i0 + j);
    }
  } else {  // x with 3 channels: 4 bytes at a time
    const int na = min(ti, a.cin - i0);
    for (int c = threadIdx.x; c < np * na; c += kDwMmaThreads) {
      const int p = c / na, j = c % na;
      cp_async4(A + p * (kDwTile + 4) + j, a.in + (p0 + p) * a.cin + i0 + j);
    }
  }
}

// cp.async of tile k's rows of dz, channels o0 .. o0+to, into D [64][kTO + 4]
template <int kTO>
__device__ __forceinline__ void stage_dw_dz(float* D, const DwArgs& a, long long k,
                                            int o0, int to) {
  constexpr int kQD = kTO / 4;
  int blk, np;
  long long p0;
  tile_of(a.gh, k, &blk, &p0, &np);
  for (int c = threadIdx.x; c < np * kQD; c += kDwMmaThreads) {
    const int p = c / kQD, j = (c % kQD) * 4;
    if (j < to) cp_async16(D + p * (kTO + 4) + j, a.dz + (p0 + p) * a.cout + o0 + j);
  }
}

// Item e of a transform pass over `rows` channels x 32 point pairs: lanes
// take 8 channels x 4 pairs, so that the raw reads (rows 68 floats apart)
// and the pair stores (kPairStride words apart) hit 32 banks
__device__ __forceinline__ void pair_item(int e, int rows, int* c, int* q) {
  const int grp = e >> 5, cg = rows / 8;
  *c = 8 * (grp % cg) + (e & 7);
  *q = 4 * (grp / cg) + ((e >> 3) & 3);
}

// dW = op(act(in))^T dz in bf16 on the tensor cores, by the split-K grid of
// pmt_bwd_dw, with the points as K. A block stages each 64-point tile of
// `in` and of dz with cp.async, writes op(act(in)) (the layer below's BN +
// ReLU, the roundings of kMode, pack_op) as point pairs, the A operand's
// layout, for the 16-channel row tiles below ti only, and packs each B
// fragment from the staged dz rows in registers (dz is bf16 already: its
// high halves, pair_of; the points past a ragged tile's end as 0). The next
// tile's rows of `in` load while the tile's products run, its dz rows once
// they are done. The 8 warps split the output tile 4 x 2 (kTO 64: a warp
// owns 16 input x 32 output channels) or 2 x 4 (kTO 128: 32 x 32); warps
// whose rows lie past ti skip the products. Each 16-point K step is summed
// from zero, the tile's 4 steps added in f32 registers, and the tile's sum
// once into f64 registers. The caller sums the f64 partials as for
// pmt_bwd_dw, so two runs give the same bits.
template <int kTO, int kMode>
__global__ void __launch_bounds__(kDwMmaThreads, kTO == 64 ? 3 : 2)
pmt_bwd_dw_mma_kernel(DwArgs a) {
  using R = Rounds<kMode>;
  constexpr int kAS = kDwTile + 4, kDS = kTO + 4;
  constexpr int kMT = kTO == 64 ? 1 : 2;  // 16-row tiles a warp
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);                    // [64][kAS]
  float* D = A + kTileP * kAS;                                   // [64][kDS]
  uint32_t* Ap = reinterpret_cast<uint32_t*>(D + kTileP * kDS);  // [64][kPairStride]
  float* cs = reinterpret_cast<float*>(Ap + kDwTile * kPairStride);  // [4][64]
  const int n_o = (a.cout + kTO - 1) / kTO;
  const int i0 = (blockIdx.x / n_o) * kDwTile, o0 = (blockIdx.x % n_o) * kTO;
  const int ti = min(kDwTile, a.cin_pad - i0), to = min(kTO, a.cout - o0);
  const int arows = min(kDwTile, (ti + 15) / 16 * 16);  // A's row tiles in use
  const long long total = static_cast<long long>(a.n_blocks) * a.gh.tiles;
  const long long k0 = total * blockIdx.y / a.splits;
  const long long k1 = total * (blockIdx.y + 1) / a.splits;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wi = 16 * kMT * (w % (4 / kMT)), wo = 32 * (w / (4 / kMT));
  double acc[kMT][4][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
    }
  }
  if (k0 < k1) {
    stage_dw_in(A, a, k0, i0, ti);
    stage_dw_dz<kTO>(D, a, k0, o0, to);
  }
  cp_async_commit();
  int cur = -1;
  for (long long k = k0; k < k1; ++k) {
    int blk, np;
    long long p0;
    tile_of(a.gh, k, &blk, &p0, &np);
    cp_async_wait<0>();
    __syncthreads();  // tile k is in; the last tile's products are done
    if (a.has_prev && blk != cur) {  // the tile's channels' BN constants
      for (int c = threadIdx.x; c < kDwTile; c += kDwMmaThreads) {
        const int ch = min(i0 + c, a.cin - 1);
        const size_t kb = static_cast<size_t>(blk) * a.cin + ch;
        cs[c] = a.prev.mu[kb];
        cs[kDwTile + c] = a.prev.rstd[kb];
        cs[2 * kDwTile + c] = a.prev.gamma[ch];
        cs[3 * kDwTile + c] = a.prev.beta[ch];
      }
      cur = blk;
      __syncthreads();
    }
    // op(act(in)) as point pairs; channels past cin and points past np are 0
    for (int e = threadIdx.x; e < arows * 32; e += kDwMmaThreads) {
      int c, q;
      pair_item(e, arows, &c, &q);
      float v[2] = {0.0f, 0.0f};
      if (c < ti && i0 + c < a.cin) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 2 * q + h;
          if (p < np) {
            float x = A[p * kAS + c];
            if (a.has_prev) {
              const float xh = rnd(__fmul_rn(__fsub_rn(x, cs[c]), cs[kDwTile + c]),
                                   R::xhat);
              x = relu_nan(__fmaf_rn(cs[2 * kDwTile + c], xh, cs[3 * kDwTile + c]));
            }
            v[h] = x;
          }
        }
      }
      Ap[c * kPairStride + q] = pack_op(v[0], v[1]);
    }
    __syncthreads();  // the pairs are in; the raw rows of `in` are free
    if (k + 1 < k1) stage_dw_in(A, a, k + 1, i0, ti);
    cp_async_commit();
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int r0 = wi + 16 * mi;
      if (r0 >= ti) continue;
      float s[4][4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ni][e] = 0.0f;
      }
      const uint32_t* ar = Ap + (r0 + g) * kPairStride + t;
#pragma unroll
      for (int ks = 0; ks < kTileP / mma::kBf16K; ++ks) {  // K steps in order
        const uint32_t af[4] = {ar[8 * ks], ar[8 * kPairStride + 8 * ks],
                                ar[8 * ks + 4], ar[8 * kPairStride + 8 * ks + 4]};
        const int p = mma::kBf16K * ks + 2 * t;  // points p, p + 1, p + 8, p + 9
        const bool in0 = p < np, in1 = p + 1 < np, in8 = p + 8 < np, in9 = p + 9 < np;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* d = D + p * kDS + wo + 8 * ni + g;
          const uint32_t b[2] = {
              pair_of(in0 ? d[0] : 0.0f, in1 ? d[kDS] : 0.0f),
              pair_of(in8 ? d[8 * kDS] : 0.0f, in9 ? d[9 * kDS] : 0.0f)};
          float step[4] = {};
          mma::mma_bf16(step, af, b);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[ni][e] += step[e];
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += static_cast<double>(s[ni][e]);
      }
    }
    __syncthreads();  // the products are done with the dz rows
    if (k + 1 < k1) stage_dw_dz<kTO>(D, a, k + 1, o0, to);
    cp_async_commit();
  }
  cp_async_wait<0>();
  double* out = a.dw_part + static_cast<size_t>(blockIdx.y) * a.cin_pad * a.cout;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = wi + 16 * mi + g + 8 * (e >> 1), oo = wo + 8 * ni + 2 * t + (e & 1);
        if (ii < ti && oo < to) {
          out[static_cast<size_t>(i0 + ii) * a.cout + o0 + oo] = acc[mi][ni][e];
        }
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

// pmt_bwd_dz_mma in backward mode kMode built for `blocks` blocks an SM,
// or null for another number
template <int kMode>
const void* dz_mma_kernel(int blocks) {
  switch (blocks) {
    case 2: return reinterpret_cast<const void*>(pmt_bwd_dz_mma_kernel<kMode, 2>);
    case 3: return reinterpret_cast<const void*>(pmt_bwd_dz_mma_kernel<kMode, 3>);
    default: return nullptr;
  }
}

// pmt_bwd_dz_chunked for kRP points a thread, or null for another kRP
template <int kMode>
const void* dz_chunked_kernel(int rp) {
  switch (rp) {
    case 1: return reinterpret_cast<const void*>(pmt_bwd_dz_chunked_kernel<1, kMode>);
    case 2: return reinterpret_cast<const void*>(pmt_bwd_dz_chunked_kernel<2, kMode>);
    case 4: return reinterpret_cast<const void*>(pmt_bwd_dz_chunked_kernel<4, kMode>);
    case 8: return reinterpret_cast<const void*>(pmt_bwd_dz_chunked_kernel<8, kMode>);
    case 16: return reinterpret_cast<const void*>(pmt_bwd_dz_chunked_kernel<16, kMode>);
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

// pmt_bwd_dw_mma for the output tile of ri x 8 outputs a thread in mode 0,
// in backward mode kMode, or null for another ri
template <int kMode>
const void* dw_mma_kernel(int ri) {
  switch (ri) {
    case 4: return reinterpret_cast<const void*>(pmt_bwd_dw_mma_kernel<64, kMode>);
    case 8: return reinterpret_cast<const void*>(pmt_bwd_dw_mma_kernel<128, kMode>);
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
// below's BN constants [4, cin], the activation tile of 64 words a row (in
// bf16 rows of channel pairs from 16 input channels on) and, with `stage`,
// the next tile's raw rows [64, cin + 4]; bf16 as snt_pmt_dense takes it,
// with 2 (op(W) in shared memory) from 16 input channels on op(W)'s pairs
// [pair_rows(cin)][wt_stride(cout)] words.
extern "C" size_t snt_pmt_dense_smem(int cin, int cout, int stage, int bf16) {
  const int rows = dense_rows<true>(cin, dense_pairs<true>(cin, bf16 == 3 ? 0 : bf16));
  const size_t wsm = bf16 == 2 && cin >= mma::kBf16K
                         ? static_cast<size_t>(mma::pair_rows(cin)) * wt_stride(cout)
                         : 0;
  return 2 * static_cast<size_t>(cout) * sizeof(double) +
         (static_cast<size_t>(cout < kChunk ? cout : kChunk) * kStride + 4 * cin +
          static_cast<size_t>(rows) * kTileP + wsm +
          (stage ? static_cast<size_t>(kTileP) * stage_stride(cin) : 0)) *
             sizeof(float);
}

// A pmt_bwd_dz block: op(W)^T rows [kc, cin_pad] (in bf16, unchunked:
// pmt_bwd_dz_mma's pairs [pair_rows(kc)][wt_stride(cin_pad)] words), 7
// per-channel constants and dz [oc, 68] for a chunk of oc output channels
// (oc = cout but in pmt_bwd_dz_chunked), each point's cloud and index
// [2, 64], and with `stage` the raw z and dh rows [2, 64, cout]; for
// pmt_bwd_dz_mma `stage` counts the staged row sets, 1 (z: a top layer) or 2
// (the launch planner, ops/cuda/point_mlp_plan.py, counts the same).
extern "C" size_t snt_pmt_bwd_dz_smem(int cin_pad, int cout, int kc, int stage,
                                      int oc, int bf16) {
  const bool pairs = bf16 && oc == cout;
  const size_t wt = pairs ? static_cast<size_t>(mma::pair_rows(kc)) * wt_stride(cin_pad)
                          : static_cast<size_t>(kc) * cin_pad;
  const size_t sets = pairs ? stage : 2 * (stage != 0);
  return sizeof(float) * (wt + 7 * oc +
                          static_cast<size_t>(oc) * kStride + 2 * kTileP +
                          sets * kTileP * cout);
}

// A pmt_bwd_dw block for ri x 8 outputs a thread: two stages of a tile of
// act(in), 64 channels, and of dz, 16 * ri channels; in bf16 the layout of
// pmt_bwd_dw_mma for the same output tile (dw_mma_smem).
extern "C" size_t snt_pmt_bwd_dw_smem(int ri, int bf16) {
  const int to = kDwThreads * ri * 8 / kDwTile;
  if (bf16) return dw_mma_smem(to);
  return sizeof(float) * 2 * kTileP * (kDwTile + to);
}

// prev_bn holds (mu, rstd, gamma, beta) of the layer below, or is null for
// the first layer (then `in` is x itself); `store` applies the backward's
// stored-xhat rounding to it. z may be null (sums only). bf16 (nonzero)
// rounds the operands: 1 on the tensor cores where cin >= 16 (w: op(W)
// packed in pairs, [ceil(cin/2)][cout] words; else its rounded values), 2
// the same with those pairs copied into shared memory once a block (the
// launch plan's `w_smem`), 3 on the FP32 pipes (w: op(W)'s rounded values:
// the plain path's channel order, which the ghost backward's rstd
// recompute keeps); `stage` (the launch plan's, taken where cin is a multiple of
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
  const size_t smem = snt_pmt_dense_smem(cin, cout, stage, bf16);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  GBN prev = make_gbn(prev_bn);
  int has_prev = prev_bn != nullptr;
  Ghost gh = make_ghost(bb, n);
  int wmode = bf16 == 3 ? 0 : bf16;
  void* args[] = {&in, &cin, &prev, &has_prev, &store, &w, &cout, &z, &rows,
                  &gh, &stage, &wmode};
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
// bf16); oc < cout takes pmt_bwd_dz_chunked, in chunks of oc = kc output
// channels, unstaged, with wt op(W)^T [cout][cin_pad]; else mode 2 takes
// pmt_bwd_dz_mma, wt then op(W)^T in pairs [pair_rows(cout)][cin_pad]
// words, kc a multiple of 16 or all cout, and rp the blocks an SM its build
// is for (2 or 3) instead of the points a thread. Mode 1 keeps
// pmt_bwd_dz on the FP32 pipes: its dz rounds to bf16 after dh_prev's
// sums feed it, and in the tensor cores' order those roundings parted the
// ghost chain from the plain bf16 version past its check (PERF.md).
extern "C" int snt_pmt_bwd_dz(const float* z, const float* const* bn,
                              const float* rstd2, const float* r1,
                              const float* r2, int cout, int mode,
                              const float* dh, const float* g,
                              const int* argmax, const float* wt, int cin_pad,
                              float* dz, float* dh_prev, int n_blocks, int bb,
                              int n, int rp, int kc, int stage, int oc, int grid,
                              cudaStream_t stream) {
  const bool chunked = oc < cout;
  if (cout % 4 || cin_pad % 4 || cin_pad < 4 || kc % 4 || kc < 4 || grid < 1 ||
      n_blocks < 1 || oc % 4 || oc < 4 || oc > cout ||
      (chunked && (kc != oc || stage)) ||
      (!chunked && mode == 2 && kc < cout && kc % mma::kBf16K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DzArgs a{z, make_gbn(bn), rstd2, r1, r2, dh, g, argmax, n, cout, wt,
                 cin_pad, kc, stage, dz, dh_prev, make_ghost(bb, n), n_blocks};
  const size_t smem = snt_pmt_bwd_dz_smem(cin_pad, cout, kc, stage, oc, mode == 2);
  const void* kernel =
      chunked ? of_mode(mode, rp, dz_chunked_kernel<0>, dz_chunked_kernel<1>,
                        dz_chunked_kernel<2>)
              : of_mode(mode, rp, dz_kernel<0>, dz_kernel<1>, dz_mma_kernel<2>);
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
// tiles, ri x 8 outputs a thread (mode 0), or on the tensor cores with the
// roundings of backward mode `mode` (Rounds) 1 or 2: pmt_bwd_dw_mma, 256
// threads.
extern "C" int snt_pmt_bwd_dw(const float* in, int cin, int cin_pad,
                              const float* const* prev_bn, int mode,
                              const float* dz, int cout, double* dw_part,
                              int n_blocks, int bb, int n, int splits, int ri,
                              cudaStream_t stream) {
  if (cout % 4 || cin_pad % 4 || cin < 1 || cin > cin_pad || splits < 1 ||
      n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = snt_pmt_bwd_dw_smem(ri, mode != 0);
  const void* kernel = of_mode(mode, ri, dw_kernel<0>, dw_mma_kernel<1>,
                               dw_mma_kernel<2>);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwArgs a{in, cin, cin_pad, make_gbn(prev_bn), prev_bn != nullptr, dz,
                 cout, dw_part, make_ghost(bb, n), n_blocks, splits};
  const int to = kDwThreads * ri * 8 / kDwTile;
  const int out_tiles = ((cin_pad + kDwTile - 1) / kDwTile) * ((cout + to - 1) / to);
  void* args[] = {const_cast<DwArgs*>(&a)};
  const int threads = mode == 0 ? kDwThreads : kDwMmaThreads;
  err = cudaLaunchKernel(kernel, dim3(out_tiles, splits), dim3(threads), args,
                         smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
