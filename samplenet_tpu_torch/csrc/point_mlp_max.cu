// Eval per-point MLP chain (folded BN, ReLU on every layer) + global max.
//
// Replaces: samplenet_tpu/ops/pallas/point_mlp_kernel.py::point_mlp_max
//   (entry :128, body `_point_mlp_kernel` :45, `pl.pallas_call` :90).
//
// out[b, :] = max over points p of relu(...relu(x[b, p] W0 + b0)... W_{L-1}
// + b_{L-1}), with each (W_l, b_l) an eval BatchNorm folded into its layer
// (fold_bn_affine, done outside the kernel as in JAX). Two modes: f32
// operands, or, as the TPU kernel's default (:53-63), each layer's operands
// (x included) rounded to bf16 and their exact products summed in f32, with
// bias and ReLU in f32.
//
// What bounds it on the H100: at the serving path's shape (B=1024 clouds of
// N=1024 points, widths 3->64->64->64->128->128) each point costs 32,960
// multiply-adds, 69 GFLOP a batch, against 12.6 MB of input: the multiply-
// adds bound it. On the FP32 SIMT pipes (67 TFLOP/s) that is 1 ms; held to
// f32 on the tensor cores as 3xTF32 (three TF32 products per multiply-add,
// 495 TFLOP/s), 0.42 ms. mma.sync reaches 316 of those TFLOP/s on the card
// (tools/diagnostics/mma_peak.py), so the tile's own ceiling is 0.65 ms.
// With bf16 operands a multiply-add is one bf16 product: 0.070 ms at
// 989 TFLOP/s. The plain version instead writes and reads every [B*N, C] activation
// through HBM (about 3.6 GB a batch).
//
// Design: one block per cloud walks the cloud in 64-point tiles. A tile's
// activations stay in shared memory (mma_tile.cuh's swizzled layout),
// ping-ponging between two buffers sized for the layers each holds, so no
// activation reaches HBM and the classification widths take 48 KB a block
// (the reconstruction widths 96 KB: two blocks an SM). Each layer with 8 or
// more input channels runs on the tensor cores, its f32 operands split in
// two TF32 parts each (mma_tile.cuh's tile_product): the 8 warps take
// output chunks of 64 points x 32, 64 or 128 channels, the accumulators
// start at the bias, and W's B fragments come through the read-only cache,
// each serving the warp's two 16-point row tiles; a first layer of fewer
// than 8 channels (x, 3 channels: 0.6% of the multiply-adds) runs on FP32
// FMAs (simt_product). The epilogue applies ReLU and writes the next
// layer's rows (zeros in the channels padded to the K step), or, in the
// last layer, takes the max: over the thread's points (the ragged tail
// masked), across the warp's rows by shuffles, and into a per-block max by
// atomicMax on the int bit pattern, which orders non-negative floats as
// floats (post-ReLU values are >= 0) and is exact and deterministic.
// In bf16 the tile holds two channels a word (mma_tile.cuh's
// tile_product_bf16), which halves its shared memory (24 KB a block at
// the classification widths); every layer but a first one of fewer than
// 16 channels runs on mma.sync m16n8k16, and that first layer on FP32
// FMAs with x and W rounded to bf16 (exact products, f32 sums), its
// epilogue writing bf16 pairs. wgmma is later work.
//
// Below the card's block slots (B=32 at registration, B=50 at the NRE
// eval) one block a cloud leaves most SMs idle while each block walks its
// tiles in turn. So a cloud's tiles may be split over S blocks (gridDim.y,
// from the launch plan, ops/cuda/point_mlp_plan.py::max_splits; kernels
// of their own, so that S = 1 runs the code of one block a cloud): block
// (b, s) walks tiles s, s + S, ... of cloud b, each tile computed as with
// S = 1, and folds its per-channel max into the output by atomicMax on the
// int bit pattern, the rule the block already uses in shared memory, over
// an output zeroed first (0 is the max's identity after ReLU). Max is
// exact and order-free, so the output's bits do not depend on S.
//
// Any number of layers: a chain of up to kMaxLayers passes its layer table
// (pointers and widths) among the kernel's parameters; a deeper one takes
// point_mlp_max_deep_kernel, the same body reading its table from device
// memory (the caller's buffer, filled by snt_point_mlp_max), so only
// shared memory bounds a chain, as VMEM bounds the TPU kernel's.

#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using mma::aidx;
constexpr int kThreads = mma::kThreads;
constexpr int kTileP = mma::kTileP;
constexpr int kMaxLayers = 8;  // layers the parameter table holds

struct MLPArgs {
  const float* w[kMaxLayers];  // [c_l, c_{l+1}] row-major (bf16 pairs: words)
  const float* b[kMaxLayers];  // [c_{l+1}]
  int c[kMaxLayers + 1];
  int layers;
  int rows0;  // rows of buffer 0 (the inputs of layers 0, 2, ...)
  int rows1;  // rows of buffer 1
};

// A deeper chain's table in device memory: params + at[l] for layer l's W
// (or b), and widths as 64-bit ints.
struct DeviceLayers {
  const float* base;
  const long long* at;
  __device__ __forceinline__ const float* operator[](int l) const {
    return base + at[l];
  }
};

struct DeviceWidths {
  const long long* at;
  __device__ __forceinline__ int operator[](int l) const {
    return static_cast<int>(at[l]);
  }
};

struct DeepArgs {
  DeviceLayers w, b;
  DeviceWidths c;
  int layers, rows0, rows1;
};

// Whether layer l runs on the FP32 pipes: fewer than 8 input channels, or
// in bf16 a first layer of fewer than 16 (the others on the tensor cores)
__host__ __device__ __forceinline__ bool simt_at(bool bf16, int l, int ci) {
  return bf16 ? l == 0 && ci < mma::kBf16K : ci < 8;
}

// A layer on the FP32 pipes, writing f32 rows or, with kPairs, bf16 pairs.
template <bool kPairs>
__device__ void simt_layer(const uint32_t* hin, uint32_t* hout, int ci, int co,
                           const float* __restrict__ w,
                           const float* __restrict__ bias, bool last, int np,
                           int* smax) {
  float* of = reinterpret_cast<float*>(hout);
  const int oq = co / 4;
  for (int t = threadIdx.x; t < (kTileP / 4) * oq; t += kThreads) {
    const int o0 = (t % oq) * 4;
    const int pp = (t / oq) * 4;
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + o0));
    float acc[4][4];
#pragma unroll
    for (int pi = 0; pi < 4; ++pi) {
      acc[pi][0] = bv.x;
      acc[pi][1] = bv.y;
      acc[pi][2] = bv.z;
      acc[pi][3] = bv.w;
    }
    mma::simt_product(acc, hin, w, ci, co, pp, o0);
    if (kPairs && !last) {  // channels o0 + 2j, o0 + 2j + 1 in pair row o0/2 + j
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t v[4];
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
          v[pi] = mma::pack_bf16(fmaxf(acc[pi][2 * j], 0.0f),
                                 fmaxf(acc[pi][2 * j + 1], 0.0f));
        }
        *reinterpret_cast<uint4*>(hout + aidx(o0 / 2 + j, pp)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      continue;
    }
#pragma unroll
    for (int oj = 0; oj < 4; ++oj) {
      if (!last) {
        *reinterpret_cast<float4*>(of + aidx(o0 + oj, pp)) =
            make_float4(fmaxf(acc[0][oj], 0.0f), fmaxf(acc[1][oj], 0.0f),
                        fmaxf(acc[2][oj], 0.0f), fmaxf(acc[3][oj], 0.0f));
      } else {
        float m = 0.0f;
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
          if (pp + pi < np) m = fmaxf(m, acc[pi][oj]);
        }
        atomicMax(&smax[o0 + oj], __float_as_int(m));
      }
    }
  }
  if (!last) {  // zero the rows padded to the next layer's K step
    const int rows = kPairs ? co / 2 : co;
    const int pad = (kPairs ? mma::pair_rows(co) : mma::tile_rows(co, true)) - rows;
    for (int e = threadIdx.x; e < pad * kTileP; e += kThreads) {
      hout[aidx(rows + e / kTileP, e % kTileP)] = 0u;
    }
  }
}

// A layer on the tensor cores, in output chunks of 32 * kNT channels: f32
// operands (3xTF32) or bf16 pairs (ci in pairs, W packed in pairs), whose
// epilogue writes bf16 pairs.
template <int kNT, bool kBf16>
__device__ void mma_layer(const uint32_t* hin, uint32_t* hout, int ci, int co,
                          const float* __restrict__ w,
                          const float* __restrict__ bias, bool last, int np,
                          int* smax) {
  // channels of the next layer's tile rows, padded to its K step
  const int co_pad = kBf16 ? 2 * mma::pair_rows(co) : mma::tile_rows(co, true);
  for (int n0 = 0; n0 < co; n0 += 32 * kNT) {
    const mma::Frag f(n0, kNT);
    float acc[2][kNT][4];
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int c = f.n + 8 * ni;  // even, and co is a multiple of 4
      const float b0 = c < co ? __ldg(bias + c) : 0.0f;
      const float b1 = c < co ? __ldg(bias + c + 1) : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][ni][0] = acc[mi][ni][2] = b0;
        acc[mi][ni][1] = acc[mi][ni][3] = b1;
      }
    }
    if (kBf16) {
      mma::tile_product_bf16<kNT>(acc, hin, reinterpret_cast<const uint32_t*>(w),
                                  (ci + 1) / 2, co, n0);
    } else {
      mma::tile_product<kNT>(acc, hin, w, ci, co, n0);
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int c = f.n + 8 * ni;
      if (!last && kBf16) {  // channels c, c + 1 (c even) in pair row c / 2
        if (c < co_pad) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = f.m0 + 16 * mi + f.g + 8 * h;
              hout[aidx(c / 2, p)] = mma::pack_bf16(fmaxf(acc[mi][ni][2 * h], 0.0f),
                                                    fmaxf(acc[mi][ni][2 * h + 1], 0.0f));
            }
          }
        }
        continue;
      }
      if (!last) {
        if (c < co_pad) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int p = f.m0 + 16 * mi + f.g + 8 * (e >> 1);
              hout[aidx(c + (e & 1), p)] = __float_as_uint(fmaxf(acc[mi][ni][e], 0.0f));
            }
          }
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // channel c + j: max over the warp's rows
        float m = 0.0f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = f.m0 + 16 * mi + f.g + 8 * h;
            if (p < np) m = fmaxf(m, acc[mi][ni][2 * h + j]);
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        if (f.g == 0 && c + j < co) atomicMax(&smax[c + j], __float_as_int(m));
      }
    }
  }
}

// kSplit: the cloud's tiles are split over gridDim.y blocks (S > 1); the
// kernels of S = 1 take kSplit = false, the code of one block a cloud.
template <bool kBf16, bool kSplit, class Args>
__device__ __forceinline__ void mlp_max(const float* __restrict__ x,
                                        float* __restrict__ out, int n,
                                        const Args& args) {
  extern __shared__ float4 smem4[];
  uint32_t* buf0 = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* buf1 = buf0 + args.rows0 * kTileP;
  const int cin = args.c[0];
  const int cout_last = args.c[args.layers];
  int* smax = reinterpret_cast<int*>(buf1 + args.rows1 * kTileP);
  const int b = blockIdx.x;
  // blocks a cloud: this one takes tiles blockIdx.y, blockIdx.y + S, ...
  const int splits = kSplit ? gridDim.y : 1;
  const int first = kSplit ? blockIdx.y * kTileP : 0;
  for (int o = threadIdx.x; o < cout_last; o += kThreads) smax[o] = 0;
  const float* xb = x + static_cast<size_t>(b) * n * cin;
  // x as f32 rows (rounded to bf16 for a bf16 first layer on the FP32
  // pipes), or as bf16 pairs
  const bool x_pairs = kBf16 && !simt_at(true, 0, cin);
  const int cin_rows = x_pairs ? mma::pair_rows(cin) : mma::tile_rows(cin, cin >= 8);

  for (int p0 = first; p0 < n; p0 += splits * kTileP) {
    const int np = min(kTileP, n - p0);
    __syncthreads();  // the previous tile no longer reads buf0
    for (int e = threadIdx.x; e < kTileP * cin_rows; e += kThreads) {
      const int p = e % kTileP, r = e / kTileP;  // a warp: 32 points, one row
      const float* xp = xb + static_cast<size_t>(p0 + p) * cin;
      if (x_pairs) {
        const int c = 2 * r;
        buf0[aidx(r, p)] = mma::pack_bf16(p < np && c < cin ? xp[c] : 0.0f,
                                          p < np && c + 1 < cin ? xp[c + 1] : 0.0f);
      } else {
        const float v = p < np && r < cin ? xp[r] : 0.0f;
        buf0[aidx(r, p)] = __float_as_uint(kBf16 ? mma::bf16_round(v) : v);
      }
    }
    __syncthreads();
    uint32_t* hin = buf0;
    uint32_t* hout = buf1;
    for (int l = 0; l < args.layers; ++l) {
      const int ci = args.c[l], co = args.c[l + 1];
      const bool last = l == args.layers - 1;
      if (simt_at(kBf16, l, ci)) {
        simt_layer<kBf16>(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
      } else {
        switch (mma::chunk_nt(co)) {
          case 4:
            mma_layer<4, kBf16>(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
            break;
          case 2:
            mma_layer<2, kBf16>(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
            break;
          default:
            mma_layer<1, kBf16>(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
        }
      }
      __syncthreads();
      uint32_t* const done = hin;
      hin = hout;
      hout = done;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < cout_last; o += kThreads) {
    if constexpr (kSplit) {  // out was zeroed; the blocks fold in any order
      atomicMax(reinterpret_cast<int*>(out + static_cast<size_t>(b) * cout_last + o),
                smax[o]);
    } else {
      out[static_cast<size_t>(b) * cout_last + o] = __int_as_float(smax[o]);
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
point_mlp_max_kernel(const float* __restrict__ x,  // [B, n, c_0]
                     float* __restrict__ out,      // [B, c_L]
                     int n, MLPArgs args) {
  mlp_max<kBf16, false>(x, out, n, args);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
point_mlp_max_deep_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int n, DeepArgs args) {
  mlp_max<kBf16, false>(x, out, n, args);
}

// S > 1 blocks a cloud: grid (B, S)
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
point_mlp_max_split_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int n, MLPArgs args) {
  mlp_max<kBf16, true>(x, out, n, args);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
point_mlp_max_deep_split_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int n, DeepArgs args) {
  mlp_max<kBf16, true>(x, out, n, args);
}

// Rows of each activation buffer: buffer 0 holds x and the outputs of
// layers 1, 3, ..., buffer 1 those of layers 0, 2, ... (the last layer's
// output is not stored), each rounded up to the K step; in bf16, rows of
// channel pairs, x in f32 rows where the first layer runs on the FP32 pipes.
void buffer_rows(const int* widths, int layers, bool bf16, int* rows0, int* rows1) {
  if (!bf16) {
    *rows0 = mma::tile_rows(widths[0], widths[0] >= 8);
  } else {
    *rows0 = simt_at(true, 0, widths[0]) ? mma::tile_rows(widths[0], false)
                                         : mma::pair_rows(widths[0]);
  }
  *rows1 = 0;
  for (int l = 1; l < layers; ++l) {
    int* r = l % 2 ? rows1 : rows0;
    const int need = bf16 ? mma::pair_rows(widths[l]) : mma::tile_rows(widths[l], true);
    *r = need > *r ? need : *r;
  }
}

}  // namespace

// Shared memory of a block (ops/cuda/point_mlp_plan.py counts the same):
// the two activation buffers of 64 words a row, and the per-channel max.
extern "C" size_t snt_point_mlp_max_smem(const int* widths, int layers, int bf16) {
  int rows0, rows1;
  buffer_rows(widths, layers, bf16 != 0, &rows0, &rows1);
  return static_cast<size_t>(rows0 + rows1) * kTileP * sizeof(float) +
         static_cast<size_t>(widths[layers]) * sizeof(int);
}

namespace {

// The kernel of a chain of `layers` layers, one block a cloud or split.
const void* max_kernel(int layers, bool bf16, bool split) {
  const void* k[2][2][2] = {
      {{reinterpret_cast<const void*>(point_mlp_max_kernel<false>),
        reinterpret_cast<const void*>(point_mlp_max_kernel<true>)},
       {reinterpret_cast<const void*>(point_mlp_max_split_kernel<false>),
        reinterpret_cast<const void*>(point_mlp_max_split_kernel<true>)}},
      {{reinterpret_cast<const void*>(point_mlp_max_deep_kernel<false>),
        reinterpret_cast<const void*>(point_mlp_max_deep_kernel<true>)},
       {reinterpret_cast<const void*>(point_mlp_max_deep_split_kernel<false>),
        reinterpret_cast<const void*>(point_mlp_max_deep_split_kernel<true>)}}};
  return k[layers > kMaxLayers][split][bf16];
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Blocks of the chain's kernel (one block a cloud) an SM holds at once
// (registers, shared memory and threads, as the card counts them), or -1
// on an error: the launch plan's block slots.
extern "C" int snt_point_mlp_max_resident(const int* widths, int layers, int bf16) {
  const void* kernel = max_kernel(layers, bf16 != 0, false);
  const size_t smem = snt_point_mlp_max_smem(widths, layers, bf16);
  int blocks = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

// params holds, for each layer, W_l then b_l [c_{l+1}] packed back to back:
// W_l [c_l, c_{l+1}] f32, or in bf16 its rounded values where the layer runs
// on the FP32 pipes and else [ceil(c_l / 2), c_{l+1}] words of bf16 pairs
// (row 2k low); widths is a host array of layers + 1 ints. table: device
// memory of 3 * layers + 1 64-bit ints, which a chain of more than
// kMaxLayers layers reads (widths, then W's and b's offsets in params,
// copied here from the host), else unused. splits: blocks a cloud (S,
// 1 to 65535), from the launch plan; above 1 out is zeroed first.
extern "C" int snt_point_mlp_max(const float* x, const float* params,
                                 const int* widths, int layers, int bf16,
                                 long long* table, float* out, int b, int n,
                                 int splits, cudaStream_t stream) {
  if (layers < 1 || (layers > kMaxLayers && table == nullptr) || splits < 1 ||
      splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MLPArgs args;
  DeepArgs deep;
  const bool in_params = layers <= kMaxLayers;
  long long* host = in_params ? nullptr : new long long[3 * layers + 1];
  size_t off = 0;
  for (int l = 0; l <= layers; ++l) {
    if (in_params) {
      args.c[l] = widths[l];
    } else {
      host[l] = widths[l];
    }
  }
  for (int l = 0; l < layers; ++l) {
    const bool pairs = bf16 && !simt_at(true, l, widths[l]);
    if (in_params) {
      args.w[l] = params + off;
    } else {
      host[layers + 1 + l] = static_cast<long long>(off);
    }
    off += static_cast<size_t>(pairs ? (widths[l] + 1) / 2 : widths[l]) * widths[l + 1];
    if (in_params) {
      args.b[l] = params + off;
    } else {
      host[2 * layers + 1 + l] = static_cast<long long>(off);
    }
    off += widths[l + 1];
  }
  int rows0, rows1;
  buffer_rows(widths, layers, bf16 != 0, &rows0, &rows1);
  args.layers = deep.layers = layers;
  args.rows0 = deep.rows0 = rows0;
  args.rows1 = deep.rows1 = rows1;
  if (!in_params) {
    // pageable host memory: the copy is staged before the call returns
    const cudaError_t err = cudaMemcpyAsync(
        table, host, sizeof(long long) * (3 * layers + 1),
        cudaMemcpyHostToDevice, stream);
    delete[] host;
    if (err != cudaSuccess) return static_cast<int>(err);
    deep.c.at = table;
    deep.w.base = deep.b.base = params;
    deep.w.at = table + layers + 1;
    deep.b.at = table + 2 * layers + 1;
  }
  const size_t smem = snt_point_mlp_max_smem(widths, layers, bf16);
  const void* kernel = max_kernel(layers, bf16 != 0, splits > 1);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    err = cudaMemsetAsync(out, 0, sizeof(float) * b * widths[layers], stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  void* kargs[] = {&x, &out, &n, in_params ? static_cast<void*>(&args)
                                           : static_cast<void*>(&deep)};
  err = cudaLaunchKernel(kernel, dim3(b, splits), dim3(kThreads), kargs, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Layers whose table the kernel's parameters hold; a deeper chain needs
// the device table of snt_point_mlp_max.
extern "C" int snt_point_mlp_max_param_layers() { return kMaxLayers; }
