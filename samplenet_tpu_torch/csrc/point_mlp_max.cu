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
// multiply-adds, 69 GFLOP a batch, against 12.6 MB of input. With f32
// operands that is the FP32 SIMT pipes (67 TFLOP/s published): about 1 ms
// at peak. The plain version instead writes and reads every [B*N, C]
// activation through HBM (about 3.6 GB a batch).
//
// Design: one block per cloud walks the cloud in tiles of kTileP points.
// The tile's activations stay in shared memory, channel-major with a row
// stride of kStride floats, ping-ponging between two buffers, so no
// activation ever reaches HBM. Each thread computes a 4-point x 4-channel
// register tile: one float4 of activations (a shared-memory broadcast) and
// one float4 of weights (read through the read-only cache, where the
// 133 KB of folded weights stay resident) feed 16 FMAs. kStride = kTileP+4
// is 4 times an odd number, so the float4 stores of a warp hit distinct
// banks. The last layer does not store: each thread reduces its 4 points,
// masking the ragged tail, into a per-block max by atomicMax on the int bit
// pattern, which orders non-negative floats as floats (post-ReLU values are
// >= 0) and is exact and deterministic. Dynamic shared memory is
// 2 * C_max * kStride floats (70 KB here), above the 48 KB static limit.
// bf16 operands and wgmma are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 64;
constexpr int kStride = kTileP + 4;
constexpr int kMaxLayers = 8;

struct MLPArgs {
  const float* w[kMaxLayers];  // [c_l, c_{l+1}] row-major
  const float* b[kMaxLayers];  // [c_{l+1}]
  int c[kMaxLayers + 1];
  int layers;
  int c_max;
};

__global__ void __launch_bounds__(kThreads)
point_mlp_max_kernel(const float* __restrict__ x,  // [B, n, c_0]
                     float* __restrict__ out,      // [B, c_L]
                     int n, MLPArgs args) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + args.c_max * kStride;
  int* smax = reinterpret_cast<int*>(buf1 + args.c_max * kStride);

  const int b = blockIdx.x;
  const int cin = args.c[0];
  const int cout_last = args.c[args.layers];
  for (int o = threadIdx.x; o < cout_last; o += kThreads) smax[o] = 0;
  const float* xb = x + static_cast<size_t>(b) * n * cin;

  for (int p0 = 0; p0 < n; p0 += kTileP) {
    const int np = min(kTileP, n - p0);
    __syncthreads();  // the previous tile no longer reads buf0
    for (int e = threadIdx.x; e < kTileP * cin; e += kThreads) {
      const int p = e / cin, c = e % cin;
      buf0[c * kStride + p] =
          p < np ? xb[static_cast<size_t>(p0 + p) * cin + c] : 0.0f;
    }
    __syncthreads();
    float* hin = buf0;
    float* hout = buf1;
    for (int l = 0; l < args.layers; ++l) {
      const int ci = args.c[l], co = args.c[l + 1];
      const float* __restrict__ w = args.w[l];
      const bool last = l == args.layers - 1;
      const int oq = co / 4;
      for (int t = threadIdx.x; t < (kTileP / 4) * oq; t += kThreads) {
        const int o0 = (t % oq) * 4;
        const int pp = (t / oq) * 4;
        const float4 bias = __ldg(reinterpret_cast<const float4*>(args.b[l] + o0));
        float acc[4][4];
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
          acc[pi][0] = bias.x;
          acc[pi][1] = bias.y;
          acc[pi][2] = bias.z;
          acc[pi][3] = bias.w;
        }
        for (int i = 0; i < ci; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(hin + i * kStride + pp);
          const float4 wv = __ldg(
              reinterpret_cast<const float4*>(w + static_cast<size_t>(i) * co + o0));
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int pi = 0; pi < 4; ++pi) {
#pragma unroll
            for (int oj = 0; oj < 4; ++oj) acc[pi][oj] += av[pi] * wr[oj];
          }
        }
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
#pragma unroll
          for (int oj = 0; oj < 4; ++oj) acc[pi][oj] = fmaxf(acc[pi][oj], 0.0f);
        }
        if (!last) {
#pragma unroll
          for (int oj = 0; oj < 4; ++oj) {
            *reinterpret_cast<float4*>(hout + (o0 + oj) * kStride + pp) =
                make_float4(acc[0][oj], acc[1][oj], acc[2][oj], acc[3][oj]);
          }
        } else {
#pragma unroll
          for (int oj = 0; oj < 4; ++oj) {
            float m = 0.0f;
#pragma unroll
            for (int pi = 0; pi < 4; ++pi) {
              if (pp + pi < np) m = fmaxf(m, acc[pi][oj]);
            }
            atomicMax(&smax[o0 + oj], __float_as_int(m));
          }
        }
      }
      __syncthreads();
      float* const done = hin;
      hin = hout;
      hout = done;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < cout_last; o += kThreads) {
    out[static_cast<size_t>(b) * cout_last + o] = __int_as_float(smax[o]);
  }
}

}  // namespace

extern "C" size_t snt_point_mlp_max_smem(const int* widths, int layers) {
  int c_max = 0;
  for (int l = 0; l <= layers; ++l) c_max = widths[l] > c_max ? widths[l] : c_max;
  return (2 * static_cast<size_t>(c_max) * kStride) * sizeof(float) +
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
  args.c_max = 0;
  for (int l = 0; l <= layers; ++l) {
    args.c[l] = widths[l];
    args.c_max = widths[l] > args.c_max ? widths[l] : args.c_max;
  }
  for (int l = 0; l < layers; ++l) {
    args.w[l] = params + off;
    off += static_cast<size_t>(widths[l]) * widths[l + 1];
    args.b[l] = params + off;
    off += widths[l + 1];
  }
  args.layers = layers;
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
