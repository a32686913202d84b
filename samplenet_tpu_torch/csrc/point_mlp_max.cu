// Eval per-point MLP chain (folded BN, ReLU on every layer) + global max.
//
// Replaces: samplenet_tpu/ops/pallas/point_mlp_kernel.py::point_mlp_max
//   (entry :128, body `_point_mlp_kernel` :45, `pl.pallas_call` :90).
//
// out[b, :] = max over points p of relu(...relu(x[b, p] W0 + b0)... W_{L-1}
// + b_{L-1}), with each (W_l, b_l) an eval BatchNorm folded into its layer
// (fold_bn_affine, done outside the kernel as in JAX).
//
// What bounds it on the H100: at the serving path's shape (B=1024 clouds of
// N=1024 points, widths 3->64->64->64->128->128) each point costs 32,960
// multiply-adds, 69 GFLOP a batch, against 12.6 MB of input: the multiply-
// adds bound it. On the FP32 SIMT pipes (67 TFLOP/s) that is 1 ms; held to
// f32 on the tensor cores as 3xTF32 (three TF32 products per multiply-add,
// 495 TFLOP/s), 0.42 ms. mma.sync reaches 316 of those TFLOP/s on the card
// (tools/diagnostics/mma_peak.py), so the tile's own ceiling is 0.65 ms.
// The plain version instead writes and reads every [B*N, C] activation
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
// floats (post-ReLU values are >= 0) and is exact and deterministic. bf16
// operands and wgmma are later work.

#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using mma::aidx;
constexpr int kThreads = mma::kThreads;
constexpr int kTileP = mma::kTileP;
constexpr int kMaxLayers = 8;

struct MLPArgs {
  const float* w[kMaxLayers];  // [c_l, c_{l+1}] row-major
  const float* b[kMaxLayers];  // [c_{l+1}]
  int c[kMaxLayers + 1];
  int layers;
  int rows0;  // rows of buffer 0 (the inputs of layers 0, 2, ...)
};

// A layer of fewer than 8 input channels on the FP32 pipes.
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
    const int pad = mma::tile_rows(co, true) - co;
    for (int e = threadIdx.x; e < pad * kTileP; e += kThreads) {
      hout[aidx(co + e / kTileP, e % kTileP)] = 0u;
    }
  }
}

// A layer of 8 or more input channels on the tensor cores, in output
// chunks of 32 * kNT channels.
template <int kNT>
__device__ void mma_layer(const uint32_t* hin, uint32_t* hout, int ci, int co,
                          const float* __restrict__ w,
                          const float* __restrict__ bias, bool last, int np,
                          int* smax) {
  const int co_pad = mma::tile_rows(co, true);
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
    mma::tile_product<kNT>(acc, hin, w, ci, co, n0);
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int c = f.n + 8 * ni;
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

__global__ void __launch_bounds__(kThreads, 2)
point_mlp_max_kernel(const float* __restrict__ x,  // [B, n, c_0]
                     float* __restrict__ out,      // [B, c_L]
                     int n, MLPArgs args) {
  extern __shared__ float4 smem4[];
  uint32_t* buf0 = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* buf1 = buf0 + args.rows0 * kTileP;
  const int cin = args.c[0];
  const int cout_last = args.c[args.layers];
  int rows1 = 0;
  for (int l = 1; l < args.layers; l += 2) {
    rows1 = max(rows1, mma::tile_rows(args.c[l], true));
  }
  int* smax = reinterpret_cast<int*>(buf1 + rows1 * kTileP);
  const int b = blockIdx.x;
  for (int o = threadIdx.x; o < cout_last; o += kThreads) smax[o] = 0;
  const float* xb = x + static_cast<size_t>(b) * n * cin;
  const int cin_rows = mma::tile_rows(cin, cin >= 8);

  for (int p0 = 0; p0 < n; p0 += kTileP) {
    const int np = min(kTileP, n - p0);
    __syncthreads();  // the previous tile no longer reads buf0
    for (int e = threadIdx.x; e < kTileP * cin_rows; e += kThreads) {
      const int p = e % kTileP, c = e / kTileP;  // a warp: 32 points, one channel
      buf0[aidx(c, p)] = __float_as_uint(
          p < np && c < cin ? xb[static_cast<size_t>(p0 + p) * cin + c] : 0.0f);
    }
    __syncthreads();
    uint32_t* hin = buf0;
    uint32_t* hout = buf1;
    for (int l = 0; l < args.layers; ++l) {
      const int ci = args.c[l], co = args.c[l + 1];
      const bool last = l == args.layers - 1;
      if (ci < 8) {
        simt_layer(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
      } else {
        switch (mma::chunk_nt(co)) {
          case 4:
            mma_layer<4>(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
            break;
          case 2:
            mma_layer<2>(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
            break;
          default:
            mma_layer<1>(hin, hout, ci, co, args.w[l], args.b[l], last, np, smax);
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
    out[static_cast<size_t>(b) * cout_last + o] = __int_as_float(smax[o]);
  }
}

// Rows of each activation buffer: buffer 0 holds x and the outputs of
// layers 1, 3, ..., buffer 1 those of layers 0, 2, ... (the last layer's
// output is not stored), each rounded up to the K step.
void buffer_rows(const int* widths, int layers, int* rows0, int* rows1) {
  *rows0 = mma::tile_rows(widths[0], widths[0] >= 8);
  *rows1 = 0;
  for (int l = 1; l < layers; ++l) {
    int* r = l % 2 ? rows1 : rows0;
    const int need = mma::tile_rows(widths[l], true);
    *r = need > *r ? need : *r;
  }
}

}  // namespace

// Shared memory of a block (ops/cuda/point_mlp_plan.py counts the same):
// the two activation buffers of 64 words a row, and the per-channel max.
extern "C" size_t snt_point_mlp_max_smem(const int* widths, int layers) {
  int rows0, rows1;
  buffer_rows(widths, layers, &rows0, &rows1);
  return static_cast<size_t>(rows0 + rows1) * kTileP * sizeof(float) +
         static_cast<size_t>(widths[layers]) * sizeof(int);
}

// params holds, for each layer, W_l [c_l, c_{l+1}] then b_l [c_{l+1}],
// packed back to back; widths is a host array of layers + 1 ints.
extern "C" int snt_point_mlp_max(const float* x, const float* params,
                                 const int* widths, int layers, float* out,
                                 int b, int n, cudaStream_t stream) {
  if (layers < 1 || layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MLPArgs args;
  size_t off = 0;
  for (int l = 0; l <= layers; ++l) args.c[l] = widths[l];
  for (int l = 0; l < layers; ++l) {
    args.w[l] = params + off;
    off += static_cast<size_t>(widths[l]) * widths[l + 1];
    args.b[l] = params + off;
    off += widths[l + 1];
  }
  args.layers = layers;
  int rows1;
  buffer_rows(widths, layers, &args.rows0, &rows1);
  const size_t smem = snt_point_mlp_max_smem(widths, layers);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        point_mlp_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  point_mlp_max_kernel<<<b, kThreads, smem, stream>>>(x, out, n, args);
  return static_cast<int>(cudaGetLastError());
}
