// Shared pieces of the port's kernels: activations, bf16 helpers and the
// block-level bf16 WMMA product used by both kernels.
//
// Every product here is computed by the block itself with WMMA 16x16x16
// bf16 tiles and fp32 accumulation (no library GEMM). Weights are in
// torch.nn.Linear's layout, W[n][k] row-major, which is the B operand of
// C = A * W^T in WMMA's col_major form.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace smt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

enum Act { ACT_NONE = 0, ACT_GELU_ERF = 1, ACT_GELU_TANH = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == ACT_GELU_ERF) {
    return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  } else if constexpr (ACT == ACT_GELU_TANH) {
    const float k = 0.79788456080286536f;  // sqrt(2 / pi)
    return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
  } else {
    return x;
  }
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

constexpr int kThreads = 256;  // 8 warps per block in every kernel

// ---------------------------------------------------------------------------
// Row-panel product: C[PM x N] = A[PM x K] * W^T, A resident in shared memory
// (lda elements per row), W [N x K] in device memory (ldw elements per row).
// The product is taken in column chunks of PN; after each chunk the fp32
// chunk sits in shared memory (Cs[r * kLdc + c], r < PM, c < PN) and
// `epi(Cs, n0)` is called by every thread of the block.
// Warps are laid out 2 x 4; each owns a 32 x 32 piece (2 x 2 fragments).
// Requires K % kPK == 0, N % PN == 0, lda and ldw multiples of 8, and
// 16-byte aligned rows of W.
constexpr int PM = 64, PN = 128, kPK = 32;
constexpr int kLdb = kPK + 8;  // staged W tile [PN][kLdb] bf16
constexpr int kLdc = PN + 4;   // fp32 chunk [PM][kLdc]

template <class Epi>
__device__ void panel_gemm(const bf16* As, int lda, const bf16* __restrict__ W, int ldw,
                           int K, int N, bf16* Bs, float* Cs, Epi epi) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  for (int n0 = 0; n0 < N; n0 += PN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    // one 16-byte vector of the W tile per thread per step: PN*kPK/8 = 512
    uint4 reg[2];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int v = threadIdx.x + s * kThreads;
        const int n = v / (kPK / 8), kv = v % (kPK / 8);
        reg[s] = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + n) * ldw + k0 + kv * 8);
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += kPK) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int v = threadIdx.x + s * kThreads;
        const int n = v / (kPK / 8), kv = v % (kPK / 8);
        *reinterpret_cast<uint4*>(Bs + n * kLdb + kv * 8) = reg[s];
      }
      __syncthreads();
      if (k0 + kPK < K) fetch(k0 + kPK);  // next tile's loads overlap this tile's MMAs
#pragma unroll
      for (int kk = 0; kk < kPK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * kLdb + kk, kLdb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16, acc[i][j],
                                kLdc, wmma::mem_row_major);
    __syncthreads();
    epi(Cs, n0);
    __syncthreads();
  }
}

// Copy rows [t0, t0 + PM) of a [T x D] bf16 matrix into shared memory
// (ld elements per row), zero-filling rows at or beyond T. D % 8 == 0.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int D, int t0, int T) {
  const int per_row = D / 8;
  for (int v = threadIdx.x; v < PM * per_row; v += kThreads) {
    const int r = v / per_row, c = (v % per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(t0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

}  // namespace smt
