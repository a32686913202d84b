// Train-mode per-point MLP chain with BatchNorm over blocks of clouds +
// global max, forward and backward: the ghost-BN chain and, as its case of
// one block with bf16 off, the exact batch-global BN chain.
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
//               z = act(in) W over the tile in shared memory, act being
//               the previous layer's ghost BN + ReLU applied on load (with
//               the stored xhat in the backward's recompute), rounded to
//               bf16 when on; it writes z (unless null: the backward's
//               recompute of rstd needs only the sums) and per block one
//               f64 row of sum z and sum z^2 over its tiles, in tile order.
//   pmt_pool    per cloud and channel, max over points of h_L and the first
//               point that attains it (a NaN wins, as in torch.argmax).
//   pmt_rows    grid (G, P): per ghost block, sum dy and sum dy*xhat_stored
//               (dy = dh where gamma*xhat_stored + beta > 0); for the top
//               layer dh is the pooled cotangent at each cloud's argmax.
//   pmt_bwd     dz = rstd' * (gamma*dy - r1 - xhat_stored*r2) per point with
//               its block's r1, r2, rstd', rounded to bf16 when on; dW
//               accumulates op(h_prev)^T dz per tile (f32) over the block's
//               tiles (f64) in shared memory, and dh_prev = dz op(W)^T goes
//               to HBM. A block takes a slab of the input channels
//               (grid.y = slab): it holds the f64 dW rows [slab, cout] and
//               the h_prev tile of its slab only, recomputes the
//               (elementwise) dz tile for all of cout, and writes dh_prev
//               for its slab, so no sum crosses slabs. The slab is all of
//               cin where that fits 227 KB (every width up to 128 in and
//               out), and smaller where it does not: the reconstruction
//               track's 128->256 takes slabs of 64 (218,112 bytes), its
//               256->128 slabs of 128 (200,704).
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
// 69 GFLOP forward and 138 GFLOP backward, about 3 ms at the f32 SIMT
// pipes' 67 TFLOP/s, and about 8 GB of z and dh through HBM, 2.5 ms at
// 3.35 TB/s. At the progressive step's shape (B=32) it is 2.2 GFLOP
// forward and 4.3 GFLOP backward, 0.03 and 0.06 ms in f32; in bf16 the
// tensor cores' 989 TFLOP/s would take a fifteenth of that. These kernels
// multiply on the SIMT pipes in both modes (bf16 only rounds the operands);
// wgmma and fusing pmt_rows into pmt_bwd are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBwdThreads = 512;  // pmt_bwd: one 200 KB block per SM
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

// ReLU that keeps a NaN, as torch.relu does
__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

__device__ __forceinline__ float ghost_xhat(const GBN& bn, int blk, int c,
                                            int n_ch, float z) {
  const size_t k = static_cast<size_t>(blk) * n_ch + c;
  return __fmul_rn(__fsub_rn(z, bn.mu[k]), bn.rstd[k]);
}

// relu(gamma * xhat + beta); with `store` the xhat as the backward stores
// it (bf16 when store is set)
__device__ __forceinline__ float ghost_act(const GBN& bn, int blk, int c,
                                           int n_ch, float z, int store) {
  const float xh = rnd(ghost_xhat(bn, blk, c, n_ch, z), store);
  return relu_nan(__fmaf_rn(bn.gamma[c], xh, bn.beta[c]));
}

__device__ __forceinline__ void tile_of(const Ghost& gh, long long k, int* blk,
                                        long long* p0, int* np) {
  *blk = static_cast<int>(k / gh.tiles);
  const long long t = k - static_cast<long long>(*blk) * gh.tiles;
  *p0 = *blk * gh.m + t * kTileP;
  *np = static_cast<int>(min(static_cast<long long>(kTileP), gh.m - t * kTileP));
}

// Loads tile rows [p0, p0 + np) of in [P, cin], channels [c0, c0 + width),
// channel-major into hs[(c - c0) * kStride + p], as op(act(in)); padded
// points and channels are 0.
template <int kT>
__device__ __forceinline__ void load_act_tile(
    float* hs, const float* __restrict__ in, int cin, int c0, int width,
    const GBN& prev, int has_prev, int store, int bf16, int blk, long long p0,
    int np) {
  for (int e = threadIdx.x; e < kTileP * width; e += kT) {
    const int p = e / width, c = c0 + e % width;
    float v = 0.0f;
    if (p < np && c < cin) {
      v = in[(p0 + p) * cin + c];
      if (has_prev) v = ghost_act(prev, blk, c, cin, v, store);
      v = rnd(v, bf16);
    }
    hs[(c - c0) * kStride + p] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
pmt_dense_kernel(const float* __restrict__ in, int cin, GBN prev, int has_prev,
                 int store, int bf16,
                 const float* __restrict__ w,  // [cin, cout], op() applied
                 int cout, float* __restrict__ z,  // [P*m, cout] or null
                 double* __restrict__ rows,        // [P, G, 2, cout]
                 Ghost gh) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [cin][kStride]
  float* zs = hs + cin * kStride;               // [cout][kStride]
  double* acc = reinterpret_cast<double*>(zs + cout * kStride);  // [2][cout]
  for (int c = threadIdx.x; c < 2 * cout; c += kThreads) acc[c] = 0.0;
  const int blk = blockIdx.y;
  const int oq = cout / 4;

  for (int t = blockIdx.x; t < gh.tiles; t += gridDim.x) {
    int tb, np;
    long long p0;
    tile_of(gh, static_cast<long long>(blk) * gh.tiles + t, &tb, &p0, &np);
    __syncthreads();  // the previous tile's hs and zs are no longer read
    load_act_tile<kThreads>(hs, in, cin, 0, cin, prev, has_prev, store, bf16,
                            blk, p0, np);
    __syncthreads();
    for (int u = threadIdx.x; u < (kTileP / 4) * oq; u += kThreads) {
      const int o0 = (u % oq) * 4;
      const int pp = (u / oq) * 4;
      float a[4][4] = {};
      for (int i = 0; i < cin; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + i * kStride + pp);
        const float4 wv = __ldg(reinterpret_cast<const float4*>(
            w + static_cast<size_t>(i) * cout + o0));
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
#pragma unroll
          for (int oj = 0; oj < 4; ++oj) a[pi][oj] += hr[pi] * wr[oj];
        }
      }
#pragma unroll
      for (int oj = 0; oj < 4; ++oj) {
        *reinterpret_cast<float4*>(zs + (o0 + oj) * kStride + pp) =
            make_float4(a[0][oj], a[1][oj], a[2][oj], a[3][oj]);
      }
      if (z != nullptr) {
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
          if (pp + pi < np) {
            *reinterpret_cast<float4*>(z + (p0 + pp + pi) * cout + o0) =
                make_float4(a[pi][0], a[pi][1], a[pi][2], a[pi][3]);
          }
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cout; c += kThreads) {  // owner of column c
      float s = 0.0f, s2 = 0.0f;
      for (int p = 0; p < np; ++p) {
        const float v = zs[c * kStride + p];
        s += v;
        s2 += v * v;
      }
      acc[c] += s;
      acc[cout + c] += s2;
    }
  }
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

__global__ void __launch_bounds__(kBwdThreads)
pmt_bwd_kernel(const float* __restrict__ in, int cin, int cin_pad, int slab,
               GBN prev, int has_prev, int bf16, const float* __restrict__ z,
               GBN bn, const float* __restrict__ rstd2,  // [P, cout]
               int cout, const float* __restrict__ dh,
               const float* __restrict__ g, const int* __restrict__ argmax,
               int n, const float* __restrict__ r1,   // [P, cout]
               const float* __restrict__ r2,          // [P, cout]
               const float* __restrict__ wt,  // [cout, cin_pad] = op(W)^T
               double* __restrict__ dw_part,  // [grid.x, cin_pad, cout]
               float* __restrict__ dh_prev,   // [P*m, cin_pad]
               Ghost gh, int n_blocks) {
  extern __shared__ float4 smem4[];
  const int c0 = blockIdx.y * slab;             // this block's input channels
  const int width = min(slab, cin_pad - c0);    // a multiple of 4
  float* hs = reinterpret_cast<float*>(smem4);  // [slab][kStride]
  float* dzs = hs + slab * kStride;             // [cout][kStride]
  double* dws = reinterpret_cast<double*>(dzs + cout * kStride);  // [slab][cout]
  const int iq = width / 4, oq = cout / 4;
  for (int e = threadIdx.x; e < width * cout; e += kBwdThreads) dws[e] = 0.0;
  const long long tiles = static_cast<long long>(n_blocks) * gh.tiles;

  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    int blk, np;
    long long p0;
    tile_of(gh, k, &blk, &p0, &np);
    __syncthreads();  // the previous tile's hs and dzs are no longer read
    load_act_tile<kBwdThreads>(hs, in, cin, c0, width, prev, has_prev, bf16,
                               bf16, blk, p0, np);
    for (int e = threadIdx.x; e < kTileP * cout; e += kBwdThreads) {
      const int p = e / cout, o = e % cout;
      float v = 0.0f;
      if (p < np) {
        float xh;
        const float dy = dy_at(z, bn, blk, o, cout, bf16, dh, g, argmax, n,
                               p0 + p, &xh);
        const size_t k2 = static_cast<size_t>(blk) * cout + o;
        v = rnd(rstd2[k2] * (bn.gamma[o] * dy - r1[k2] - xh * r2[k2]), bf16);
      }
      dzs[o * kStride + p] = v;
    }
    __syncthreads();
    // dW[i, o] += sum_p h_prev[p, i] dz[p, o]: each thread owns 4x4 blocks
    for (int u = threadIdx.x; u < iq * oq; u += kBwdThreads) {
      const int i0 = (u / oq) * 4, o0 = (u % oq) * 4;
      float a[4][4] = {};
      for (int p = 0; p < kTileP; p += 4) {  // padded points carry dz = 0
        float4 hv[4], dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hv[r] = *reinterpret_cast<const float4*>(hs + (i0 + r) * kStride + p);
          dv[r] = *reinterpret_cast<const float4*>(dzs + (o0 + r) * kStride + p);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int oj = 0; oj < 4; ++oj) {
            a[ii][oj] += hv[ii].x * dv[oj].x + hv[ii].y * dv[oj].y +
                         hv[ii].z * dv[oj].z + hv[ii].w * dv[oj].w;
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int oj = 0; oj < 4; ++oj) dws[(i0 + ii) * cout + o0 + oj] += a[ii][oj];
      }
    }
    // dh_prev[p, i] = sum_o dz[p, o] W[i, o]: 4 points x 4 channels each
    for (int u = threadIdx.x; u < (kTileP / 4) * iq; u += kBwdThreads) {
      const int i0 = (u % iq) * 4;
      const int pp = (u / iq) * 4;
      float a[4][4] = {};
      for (int o = 0; o < cout; ++o) {
        const float4 dv = *reinterpret_cast<const float4*>(dzs + o * kStride + pp);
        const float4 wv = __ldg(reinterpret_cast<const float4*>(
            wt + static_cast<size_t>(o) * cin_pad + c0 + i0));
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
#pragma unroll
          for (int ij = 0; ij < 4; ++ij) a[pi][ij] += dr[pi] * wr[ij];
        }
      }
#pragma unroll
      for (int pi = 0; pi < 4; ++pi) {
        if (pp + pi < np) {
          *reinterpret_cast<float4*>(dh_prev + (p0 + pp + pi) * cin_pad + c0 + i0) =
              make_float4(a[pi][0], a[pi][1], a[pi][2], a[pi][3]);
        }
      }
    }
  }
  __syncthreads();
  double* out = dw_part + (static_cast<size_t>(blockIdx.x) * cin_pad + c0) * cout;
  for (int e = threadIdx.x; e < width * cout; e += kBwdThreads) out[e] = dws[e];
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

extern "C" size_t snt_pmt_dense_smem(int cin, int cout) {
  return static_cast<size_t>(cin + cout) * kStride * sizeof(float) +
         2 * static_cast<size_t>(cout) * sizeof(double);
}

// A pmt_bwd block that takes `slab` input channels.
extern "C" size_t snt_pmt_bwd_smem(int slab, int cout) {
  return static_cast<size_t>(slab + cout) * kStride * sizeof(float) +
         static_cast<size_t>(slab) * cout * sizeof(double);
}

// prev_bn holds (mu, rstd, gamma, beta) of the layer below, or is null for
// the first layer (then `in` is x itself); `store` applies the backward's
// stored-xhat rounding to it. z may be null (sums only).
extern "C" int snt_pmt_dense(const float* in, int cin, const float* const* prev_bn,
                             int store, int bf16, const float* w, int cout,
                             float* z, double* rows, int n_blocks, int bb, int n,
                             int grid, cudaStream_t stream) {
  if (cout % 4 || cin < 1 || grid < 1 || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = snt_pmt_dense_smem(cin, cout);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(pmt_dense_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pmt_dense_kernel<<<dim3(grid, n_blocks), kThreads, smem, stream>>>(
      in, cin, make_gbn(prev_bn), prev_bn != nullptr, store, bf16, w, cout, z,
      rows, make_ghost(bb, n));
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

// grid blocks over all tiles for each of ceil(cin_pad / slab) slabs.
extern "C" int snt_pmt_bwd(const float* in, int cin, int cin_pad, int slab,
                           const float* const* prev_bn, int bf16, const float* z,
                           const float* const* bn, const float* rstd2, int cout,
                           const float* dh, const float* g, const int* argmax,
                           int n_blocks, int bb, int n, const float* r1,
                           const float* r2, const float* wt, double* dw_part,
                           float* dh_prev, int grid, cudaStream_t stream) {
  if (cout % 4 || cin_pad % 4 || slab % 4 || slab < 4 || cin > cin_pad ||
      grid < 1 || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = snt_pmt_bwd_smem(slab, cout);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(pmt_bwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(grid, (cin_pad + slab - 1) / slab);
  pmt_bwd_kernel<<<blocks, kBwdThreads, smem, stream>>>(
      in, cin, cin_pad, slab, make_gbn(prev_bn), prev_bn != nullptr, bf16, z,
      make_gbn(bn), rstd2, cout, dh, g, argmax, n, r1, r2, wt, dw_part, dh_prev,
      make_ghost(bb, n), n_blocks);
  return static_cast<int>(cudaGetLastError());
}
