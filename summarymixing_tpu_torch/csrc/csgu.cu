// Fused Branchformer cgMLP branch for sm_90a.
//
// Replaces the TPU kernel summarymixing_tpu/ops/pallas_csgu.py (_kernel via
// fused_convolution_branch). Bound on the H100: operations (the two bf16
// products, 512 -> 3072 and 1536 -> 512 per frame). The TPU kernel keeps a
// [tile + 30, 3072] fp32 block in VMEM, which does not fit the 227 KB of
// shared memory of a Hopper block, so this first version runs in three
// launches:
//   (1) gemm_bias_act<tanh-GELU>: h = gelu(x W_pre^T + b_pre) -> bf16 [M, 2C]
//   (2) gate_pass: block per (utterance, 32-frame tile). LayerNorm statistics
//       of each gate row in fp32 (two passes over the row), rows that are
//       padding or outside [0, T) set to zero so they reach the conv as zero,
//       K-tap depthwise conv with its halo held in registers, + conv bias,
//       times res -> bf16 [M, C]
//   (3) gemm_bias_act<none>: out = g W_post^T + b_post -> bf16 [M, D]
// The GEMM is a 128 x 128 block tile of bf16 WMMA fragments with fp32
// accumulation; the next k-tile's loads are in flight during the current
// tile's MMAs. M = B*T may be ragged: rows past M load as zero and are not
// stored.
//
// C interface: csgu_forward(...) returns cudaGetLastError() after the launches.

#include "common.cuh"

namespace smt {

constexpr int GM = 128, GN = 128, GK = 32;
constexpr int kLds = GK + 8;     // staged A and W tiles [128][kLds] bf16
constexpr int kLdo = GN + 4;     // fp32 output tile [128][kLdo]
constexpr size_t kGemmSmem = (size_t)2 * GM * kLds * 2 + (size_t)GM * kLdo * 4;

// out[M x N] = act(A[M x K] W^T + bias), A row-major (ld K), W [N x K]
// row-major, bias fp32 [N]. Requires N % GN == 0 and K % GK == 0.
template <int ACT>
__global__ void __launch_bounds__(kThreads) gemm_bias_act(
    const bf16* __restrict__ A, const bf16* __restrict__ W, const float* __restrict__ bias,
    bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + GM * kLds;
  float* Cs = reinterpret_cast<float*>(Ws + GN * kLds);
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[2], rw[2];  // 2 x 16 bytes of each tile per thread: 128*32/8 = 512 vectors
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = threadIdx.x + s * kThreads, r = v / (GK / 8), kv = (v % (GK / 8)) * 8;
      ra[s] = (m0 + r < M) ? *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + kv)
                           : make_uint4(0u, 0u, 0u, 0u);
      rw[s] = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + kv);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += GK) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = threadIdx.x + s * kThreads, r = v / (GK / 8), kv = (v % (GK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * kLds + kv) = ra[s];
      *reinterpret_cast<uint4*>(Ws + r * kLds + kv) = rw[s];
    }
    __syncthreads();
    if (k0 + GK < K) fetch(k0 + GK);
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> w[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * kLds + kk, kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(w[j], Ws + (wn * 32 + j * 16) * kLds + kk, kLds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * kLdo + wn * 32 + j * 16, acc[i][j],
                              kLdo, wmma::mem_row_major);
  __syncthreads();
  // two adjacent columns per thread, stored as one bf16x2
  for (int e = threadIdx.x; e < GM * GN / 2; e += kThreads) {
    const int r = e / (GN / 2), c = (e % (GN / 2)) * 2;
    if (m0 + r < M) {
      const float v0 = activate<ACT>(Cs[r * kLdo + c] + bias[n0 + c]);
      const float v1 = activate<ACT>(Cs[r * kLdo + c + 1] + bias[n0 + c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + r) * N + n0 + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// h [B, T, 2C] bf16 (res = h[..., :C], gate = h[..., C:]); mask [B, T];
// conv_w [K, C]; g [B, T, C] = res * (conv(LN(gate) * mask) + conv_b).
template <int K, int TT>
__global__ void __launch_bounds__(kThreads) gate_pass(
    const bf16* __restrict__ h, const float* __restrict__ mask, int T, int C,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, float eps,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b, bf16* __restrict__ g) {
  constexpr int HALO = (K - 1) / 2, ROWS = TT + K - 1;
  __shared__ float mean_s[ROWS], rstd_s[ROWS], mask_s[ROWS];  // mask 0: row reaches the conv as 0
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t row2c = (size_t)2 * C;

  for (int j = warp; j < ROWS; j += kThreads / 32) {
    const int t = t0 - HALO + j;
    const float m = (t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.0f;
    float mu = 0.0f, rstd = 0.0f;
    if (m != 0.0f) {
      const bf16* gate = h + ((size_t)b * T + t) * row2c + C;
      float s = 0.0f;
      for (int c = lane; c < C; c += 32) s += bf(gate[c]);
      mu = warp_sum(s) / C;
      float v = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float d = bf(gate[c]) - mu;
        v += d * d;
      }
      rstd = rsqrtf(warp_sum(v) / C + eps);
    }
    if (lane == 0) {
      mean_s[j] = mu;
      rstd_s[j] = rstd;
      mask_s[j] = m;
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += kThreads) {
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = conv_w[(size_t)k * C + c];
    const float lw = ln_w[c], lb = ln_b[c], cb = conv_b[c];
    float x[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const float m = mask_s[j];
      x[j] = 0.0f;
      if (m != 0.0f) {
        const float v = bf(h[((size_t)b * T + t0 - HALO + j) * row2c + C + c]);
        x[j] = ((v - mean_s[j]) * rstd_s[j] * lw + lb) * m;
      }
    }
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const int t = t0 + i;
      if (t < T) {
        float acc = cb;
#pragma unroll
        for (int k = 0; k < K; ++k) acc += w[k] * x[i + k];
        const float res = bf(h[((size_t)b * T + t) * row2c + c]);
        g[((size_t)b * T + t) * C + c] = __float2bfloat16(res * acc);
      }
    }
  }
}

template <int K>
static void launch_gate(const bf16* h, const float* mask, int B, int T, int C,
                        const float* ln_w, const float* ln_b, float eps, const float* conv_w,
                        const float* conv_b, bf16* g, cudaStream_t stream) {
  constexpr int TT = 32;
  gate_pass<K, TT><<<dim3((T + TT - 1) / TT, B), kThreads, 0, stream>>>(
      h, mask, T, C, ln_w, ln_b, eps, conv_w, conv_b, g);
}

}  // namespace smt

extern "C" int csgu_forward(const void* x, const void* mask, int B, int T, int D, int C2, int K,
                            const void* w_pre, const void* b_pre, const void* ln_w,
                            const void* ln_b, float eps, const void* conv_w, const void* conv_b,
                            const void* w_post, const void* b_post, void* h, void* g, void* out,
                            void* stream) {
  using namespace smt;
  if (K != 15 && K != 31) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T, C = C2 / 2;
  const dim3 grid_m(1, (M + GM - 1) / GM);
  cudaError_t err = cudaFuncSetAttribute(gemm_bias_act<ACT_GELU_TANH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gemm_bias_act<ACT_NONE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  gemm_bias_act<ACT_GELU_TANH><<<dim3(C2 / GN, grid_m.y), kThreads, kGemmSmem, st>>>(
      (const bf16*)x, (const bf16*)w_pre, (const float*)b_pre, (bf16*)h, M, C2, D);
  if (K == 31)
    launch_gate<31>((const bf16*)h, (const float*)mask, B, T, C, (const float*)ln_w,
                    (const float*)ln_b, eps, (const float*)conv_w, (const float*)conv_b,
                    (bf16*)g, st);
  else
    launch_gate<15>((const bf16*)h, (const float*)mask, B, T, C, (const float*)ln_w,
                    (const float*)ln_b, eps, (const float*)conv_w, (const float*)conv_b,
                    (bf16*)g, st);
  gemm_bias_act<ACT_NONE><<<dim3(D / GN, grid_m.y), kThreads, kGemmSmem, st>>>(
      (const bf16*)g, (const bf16*)w_post, (const float*)b_post, (bf16*)out, M, D, C);
  return (int)cudaGetLastError();
}
