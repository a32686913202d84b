// Squared distance ((dx*dx + dy*dy) + dz*dz) without FMA contraction, and
// the NaN-propagating min of the FPS and 1-NN kernels.
//
// __fsub_rn/__fmul_rn/__fadd_rn are never fused by the compiler, so this is
// the sum the plain PyTorch versions compute with separate tensor ops, in
// the same order (samplenet_tpu/ops/pallas/fps_kernel.py:58): the kernels
// that use it agree with their plain versions bit for bit.

#pragma once

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// min with NaN propagation (min.NaN): the canonical NaN 0x7fffffff if either
// input is NaN, as torch.minimum and jnp.minimum propagate it.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
