// Shared pieces of the port's kernels: activations, bf16 helpers and a warp
// sum. The product core is in gemm_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smt {

using bf16 = __nv_bfloat16;

enum Act { ACT_NONE = 0, ACT_GELU_ERF = 1, ACT_GELU_TANH = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == ACT_GELU_ERF) {
    return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  } else if constexpr (ACT == ACT_GELU_TANH) {
    // tanh.approx.f32: one MUFU instruction, relative error about 2^-11,
    // below the bf16 rounding every caller applies to the result
    const float k = 0.79788456080286536f;  // sqrt(2 / pi)
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(k * (x + 0.044715f * x * x * x)));
    return 0.5f * x * (1.0f + t);
  } else {
    return x;
  }
}

// d/dx of activate<ACT_GELU_TANH>, with the same tanh.approx.f32.
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k = 0.79788456080286536f, a = 0.044715f;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(k * (x + a * x * x * x)));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * k * (1.0f + 3.0f * a * x * x);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// Round a float through bf16, as a cast to bf16 and back does.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kThreads = 256;  // 8 warps per block in the kernels without products

}  // namespace smt
