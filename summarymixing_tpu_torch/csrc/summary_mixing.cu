// Fused SummaryMixing cell (full mode, nhead 1, one hidden layer per
// branch) for sm_90a.
//
// Replaces the TPU kernel summarymixing_tpu/ops/pallas_summary.py
// (_kernel via _pallas_forward / fused_summary_mixing). Bound on the H100:
// operations (five bf16 products of [T x 512] by [512 x 512] per utterance).
// The TPU kernel holds an utterance in VMEM and carries the time sum through
// its sequential grid; Hopper blocks run in parallel, so the cell runs in
// three launches:
//   (a) summary_pass: block per (utterance, 64-frame tile). h = act(x S1^T +
//       c1) stays in shared memory as bf16; act(h S2^T + c2) * pad is summed
//       over the tile's rows in fp32 and written as one partial row. No
//       atomics: the result does not depend on block order.
//   (b) pool_pass: block per utterance. pooled = sum of partials /
//       max(sum pad, 1), rounded to bf16; bias = pooled M2^T + mb in fp32.
//   (c) local_pass: block per tile. h = act(x W1^T + b1), local = act(h W2^T +
//       b2) * pad (both bf16 in shared memory), out = act(local M1^T + bias).
// Products are bf16 WMMA tiles with fp32 accumulation (common.cuh). The
// ragged T edge is masked here: rows at or beyond T load as zero, carry
// pad 0 and are never stored.
//
// C interface: sm_forward(...) returns cudaGetLastError() after the launches.

#include "common.cuh"

namespace smt {

// shared memory carve-up shared by passes (a) and (c)
struct PanelSmem {
  int ldx, ldh;
  size_t bytes;
  __host__ __device__ PanelSmem(int xw, int hw) : ldx(xw + 8), ldh(hw + 8) {
    bytes = (size_t)PM * ldx * 2 + (size_t)PM * ldh * 2 + (size_t)PN * kLdb * 2 +
            (size_t)PM * kLdc * 4 + (size_t)PM * 4;
  }
};

template <int ACT>
__global__ void __launch_bounds__(kThreads) summary_pass(
    const bf16* __restrict__ x, const float* __restrict__ pad, int T, int D, int HS, int OS,
    const bf16* __restrict__ s1, const bf16* __restrict__ c1, const bf16* __restrict__ s2,
    const bf16* __restrict__ c2, float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PanelSmem L(D, HS);
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Hs = Xs + PM * L.ldx;
  bf16* Bs = Hs + PM * L.ldh;
  float* Cs = reinterpret_cast<float*>(Bs + PN * kLdb);
  float* pads = Cs + PM * kLdc;
  const int b = blockIdx.y, tile = blockIdx.x, t0 = tile * PM;

  load_rows(Xs, L.ldx, x + (size_t)b * T * D, D, t0, T);
  if (threadIdx.x < PM)
    pads[threadIdx.x] = (t0 + threadIdx.x < T) ? pad[(size_t)b * T + t0 + threadIdx.x] : 0.0f;
  __syncthreads();

  panel_gemm(Xs, L.ldx, s1, D, D, HS, Bs, Cs, [&](const float* C, int n0) {
    for (int e = threadIdx.x; e < PM * PN; e += kThreads) {
      const int r = e / PN, c = e % PN;
      Hs[r * L.ldh + n0 + c] = __float2bfloat16(activate<ACT>(C[r * kLdc + c] + bf(c1[n0 + c])));
    }
  });
  panel_gemm(Hs, L.ldh, s2, HS, HS, OS, Bs, Cs, [&](const float* C, int n0) {
    if (threadIdx.x < PN) {
      const int c = threadIdx.x;
      const float bias = bf(c2[n0 + c]);
      float s = 0.0f;
      for (int r = 0; r < PM; ++r) s += activate<ACT>(C[r * kLdc + c] + bias) * pads[r];
      partial[((size_t)b * gridDim.x + tile) * OS + n0 + c] = s;
    }
  });
}

__global__ void __launch_bounds__(kThreads) pool_pass(
    const float* __restrict__ partial, const float* __restrict__ pad, int T, int n_tiles, int OS,
    int N, const bf16* __restrict__ m2, int ldm2, const bf16* __restrict__ mb,
    float* __restrict__ bias) {
  extern __shared__ __align__(16) float pooled[];  // [OS]
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float cnt = 0.0f;
  for (int t = threadIdx.x; t < T; t += kThreads) cnt += pad[(size_t)b * T + t];
  cnt = warp_sum(cnt);
  if (lane == 0) red[warp] = cnt;
  __syncthreads();
  float count = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) count += red[w];
  count = fmaxf(count, 1.0f);

  for (int o = threadIdx.x; o < OS; o += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < n_tiles; ++i) s += partial[((size_t)b * n_tiles + i) * OS + o];
    pooled[o] = round_bf16(s / count);
  }
  __syncthreads();
  // one warp per output column: lanes walk row n of M2 (contiguous)
  for (int n = warp; n < N; n += kThreads / 32) {
    float acc = 0.0f;
    for (int o = lane; o < OS; o += 32) acc += pooled[o] * bf(m2[(size_t)n * ldm2 + o]);
    acc = warp_sum(acc);
    if (lane == 0) bias[(size_t)b * N + n] = acc + bf(mb[n]);
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads) local_pass(
    const bf16* __restrict__ x, const float* __restrict__ pad, int T, int D, int HL, int OL, int N,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, const bf16* __restrict__ m1, int ldm1,
    const float* __restrict__ bias, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PanelSmem L(D > OL ? D : OL, HL);
  bf16* Xs = reinterpret_cast<bf16*>(smem);  // x, then the local branch output
  bf16* Hs = Xs + PM * L.ldx;
  bf16* Bs = Hs + PM * L.ldh;
  float* Cs = reinterpret_cast<float*>(Bs + PN * kLdb);
  float* pads = Cs + PM * kLdc;
  const int b = blockIdx.y, t0 = blockIdx.x * PM;

  load_rows(Xs, L.ldx, x + (size_t)b * T * D, D, t0, T);
  if (threadIdx.x < PM)
    pads[threadIdx.x] = (t0 + threadIdx.x < T) ? pad[(size_t)b * T + t0 + threadIdx.x] : 0.0f;
  __syncthreads();

  panel_gemm(Xs, L.ldx, w1, D, D, HL, Bs, Cs, [&](const float* C, int n0) {
    for (int e = threadIdx.x; e < PM * PN; e += kThreads) {
      const int r = e / PN, c = e % PN;
      Hs[r * L.ldh + n0 + c] = __float2bfloat16(activate<ACT>(C[r * kLdc + c] + bf(b1[n0 + c])));
    }
  });
  panel_gemm(Hs, L.ldh, w2, HL, HL, OL, Bs, Cs, [&](const float* C, int n0) {
    for (int e = threadIdx.x; e < PM * PN; e += kThreads) {
      const int r = e / PN, c = e % PN;
      Xs[r * L.ldx + n0 + c] =
          __float2bfloat16(activate<ACT>(C[r * kLdc + c] + bf(b2[n0 + c])) * pads[r]);
    }
  });
  const float* brow = bias + (size_t)b * N;
  panel_gemm(Xs, L.ldx, m1, ldm1, OL, N, Bs, Cs, [&](const float* C, int n0) {
    for (int e = threadIdx.x; e < PM * PN; e += kThreads) {
      const int r = e / PN, c = e % PN;
      if (t0 + r < T)
        out[((size_t)b * T + t0 + r) * N + n0 + c] =
            __float2bfloat16(activate<ACT>(C[r * kLdc + c] + brow[n0 + c]));
    }
  });
}

template <int ACT>
static cudaError_t launch(const bf16* x, const float* pad, int B, int T, int D, int HL, int OL,
                          int HS, int OS, int N, const bf16* w1, const bf16* b1, const bf16* w2,
                          const bf16* b2, const bf16* s1, const bf16* c1, const bf16* s2,
                          const bf16* c2, const bf16* m1, int ldm1, const bf16* m2, int ldm2,
                          const bf16* mb, float* partial, float* bias, bf16* out,
                          cudaStream_t stream) {
  const int n_tiles = (T + PM - 1) / PM;
  const size_t smem_a = PanelSmem(D, HS).bytes;
  const size_t smem_c = PanelSmem(D > OL ? D : OL, HL).bytes;
  cudaError_t err = cudaFuncSetAttribute(summary_pass<ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(local_pass<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, B);
  summary_pass<ACT><<<grid, kThreads, smem_a, stream>>>(x, pad, T, D, HS, OS, s1, c1, s2, c2,
                                                        partial);
  pool_pass<<<B, kThreads, OS * sizeof(float), stream>>>(partial, pad, T, n_tiles, OS, N, m2,
                                                        ldm2, mb, bias);
  local_pass<ACT><<<grid, kThreads, smem_c, stream>>>(x, pad, T, D, HL, OL, N, w1, b1, w2, b2,
                                                      m1, ldm1, bias, out);
  return cudaGetLastError();
}

}  // namespace smt

extern "C" int sm_forward(const void* x, const void* pad, int B, int T, int D, int HL, int OL,
                          int HS, int OS, int N, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* s1, const void* c1, const void* s2,
                          const void* c2, const void* m1, const void* m2, int ldm1,
                          const void* mb, int ldm2, void* partial, void* bias, void* out, int act,
                          void* stream) {
  using smt::bf16;
  auto fn = act == smt::ACT_GELU_ERF ? smt::launch<smt::ACT_GELU_ERF>
          : act == smt::ACT_GELU_TANH ? smt::launch<smt::ACT_GELU_TANH>
                                      : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn((const bf16*)x, (const float*)pad, B, T, D, HL, OL, HS, OS, N,
                 (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                 (const bf16*)s1, (const bf16*)c1, (const bf16*)s2, (const bf16*)c2,
                 (const bf16*)m1, ldm1, (const bf16*)m2, ldm2, (const bf16*)mb,
                 (float*)partial, (float*)bias, (bf16*)out, (cudaStream_t)stream);
}
