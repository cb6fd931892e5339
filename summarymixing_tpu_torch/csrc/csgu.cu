// Fused Branchformer cgMLP branch for sm_90a.
//
// Replaces the TPU kernel summarymixing_tpu/ops/pallas_csgu.py (_kernel via
// fused_convolution_branch). Bound on the H100: operations for the two bf16
// products (512 -> 3072 and 1536 -> 512 per frame), bytes for the gate pass
// between them. The TPU kernel keeps a [tile + 30, 3072] fp32 block in VMEM,
// which does not fit the 227 KB of shared memory of a Hopper block, so the
// branch runs in four launches:
//   (1) gemm_tma<tanh-GELU>: h = gelu(x W_pre^T + b_pre) -> bf16 [M, 2C], on
//       the wgmma + TMA core (gemm_sm90.cuh): a persistent block per SM walks
//       128 x 128 tiles through a 5-stage ring; its two consumer warpgroups
//       take the tiles in turn, so one's epilogue (bias, GELU, a swizzled
//       shared tile, a TMA store) overlaps the other's products.
//   (2) ln_stats: one warp per valid row takes the gate half's LayerNorm
//       mean and rstd in fp32, two passes over the row, once per row.
//   (3) gate_pass: block per (128-frame tile, 64-channel tile, utterance),
//       three per SM. The normalised, masked gate window (tile + K - 1 rows)
//       is staged in shared memory; a row that is padding or outside [0, T)
//       is zero there, so it reaches the conv as zero and never as
//       LayerNorm(0) = ln_bias. Each thread keeps one channel's K conv taps
//       in registers and slides over 16 output frames at a time, all indices
//       compile-time; the result goes back through shared memory, so res is
//       read and g = res * (conv + bias) written as 16-byte vectors. With a
//       dropout keep-mask (bytes [B, T, C], 1 = keep), each product is
//       multiplied by `scale` = 1 / keep_prob where kept and zeroed elsewhere.
//   (4) gemm_tma<none>: out = g W_post^T + b_post -> bf16 [M, D], the same
//       kernel with a 4-stage ring: the 188 tiles of M = 6008 by D = 512 give
//       one or two per block, one per warpgroup.
// M = B*T may be ragged: TMA fills rows past M with zeros and does not store
// them.
//
// C interface: csgu_forward(...) returns 0, a CUDA error after the launches,
// or cudaErrorInvalidValue when a tensor map cannot be encoded.

#include "gemm_sm90.cuh"

namespace smt {

constexpr int kBM = 128, kBN = 128;  // output tile of the product kernel

template <int STAGES>
constexpr size_t gemm_smem() {  // ring, output staging of both warpgroups, barriers, alignment
  return (size_t)STAGES * (kBM + kBN) * kLineBytes + (size_t)2 * kBM * kBN * 2 +
         (2 * STAGES + 2) * 8 + 1024;
}

// out[M x N] = act(A[M x K] W^T + bias): A, W and out through TMA maps
// (boxes of 128 x 64 each), bias fp32 [N]. Requires N % 8 == 0 and
// K % 64 == 0; rows past M and columns past N load as zero and are not
// stored. Each block walks the 128 x 128 output tiles blockIdx.x,
// + gridDim.x, ... (column tiles fastest) and its two consumer warpgroups
// take turns: warpgroup w computes the block's tiles w, w + 2, ..., so one
// runs its products while the other runs its epilogue. The producer loads
// every tile's stages in order; a warpgroup skips the stages of the other's
// tiles. A pair of order barriers lets a warpgroup start its products only
// once the other's are done, so the two never wait on the ring at once and
// the ring's parity always names the right round. The epilogue writes the
// 128 x 128 result in bf16 to a swizzled shared tile and TMA stores it, so
// the stores leave in whole lines.
template <int STAGES, int ACT>
__global__ void __launch_bounds__(kCoreThreads, 1) gemm_tma(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_out, const float* __restrict__ bias, int M, int N,
    int K) {
  constexpr int BM = kBM, BN = kBN;
  constexpr uint32_t A_BYTES = BM * kLineBytes, STAGE = A_BYTES + BN * kLineBytes;
  constexpr uint32_t OUT_BYTES = BM * BN * 2;  // one warpgroup's staged result
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* staging = smem + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;  // order[w]: warpgroup w may start its products
  const int ntn = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * ntn, kblocks = K / kBK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the warps of the one warpgroup that reads the stage
    }
    mbar_init(&order[0], 1);
    mbar_init(&order[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    if ((threadIdx.x & 31) == 0) {
      RingPos pos;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / ntn) * BM, n0 = (tile % ntn) * BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
          mbar_expect_tx(&full[pos.stage], STAGE);
          uint8_t* st = smem + pos.stage * STAGE;
          tma_load_2d(st, &map_a, &full[pos.stage], kb * kBK, m0);
          tma_load_2d(st + A_BYTES, &map_w, &full[pos.stage], kb * kBK, n0);
          pos.next(STAGES);
        }
      }
    }
  } else {  // two consumer warpgroups, alternate tiles
    const int wg = warp / 4;
    const uint32_t base = smem_u32(smem);
    uint8_t* stg = staging + wg * OUT_BYTES;
    const bool issuer = threadIdx.x % 128 == 0;
    RingPos pos;
    pos.advance(wg * kblocks, STAGES);
    uint32_t turn = 0;  // parity of this warpgroup's next wait on order[wg]
    bool first = wg == 0;
    for (int tile = blockIdx.x + wg * gridDim.x; tile < tiles; tile += 2 * gridDim.x) {
      const int m0 = (tile / ntn) * BM, n0 = (tile % ntn) * BN;
      float acc[2][BN / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.0f;
      static_assert(BN == 128, "consume() computes 128 columns");
      if (!first) {
        mbar_wait(&order[wg], turn);
        turn ^= 1u;
      }
      first = false;
      consume<2>(
          acc, kblocks, full, empty, STAGES, pos,
          [&](int, int st) { return base + st * STAGE; },
          [&](int st) { return base + st * STAGE + A_BYTES; });
      if (issuer) mbar_arrive(&order[wg ^ 1]);
      pos.advance(kblocks, STAGES);  // the other warpgroup's tile
      if (issuer) bulk_wait_read();  // the previous tile's store has left the staging tile
      warpgroup_sync(wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + acc_col();
        const float2 bb = n0 + cl < N ? *reinterpret_cast<const float2*>(bias + n0 + cl)
                                      : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<__nv_bfloat162*>(
                stg + swizzled_offset(64 * h + acc_row() + 8 * hh, cl, BM)) =
                __floats2bfloat162_rn(activate<ACT>(acc[h][4 * j + 2 * hh] + bb.x),
                                      activate<ACT>(acc[h][4 * j + 2 * hh + 1] + bb.y));
      }
      fence_async_smem();
      warpgroup_sync(wg);
      if (issuer) {
        for (int kb = 0; kb < BN / kBK; ++kb)
          tma_store_2d(&map_out, stg + kb * BM * kLineBytes, n0 + kb * kBK, m0);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait_read();  // shared memory outlives the stores
  }
}

// LayerNorm statistics of the gate half h[row, C:2C] of every valid row:
// (mean, rstd) in fp32, two passes over the row. Rows with mask 0 are
// skipped: the gate pass never normalises them.
__global__ void __launch_bounds__(kThreads) ln_stats(const bf16* __restrict__ h,
                                                     const float* __restrict__ mask, int M, int C,
                                                     float eps, float2* __restrict__ stats) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= M || mask[row] == 0.0f) return;
  const uint4* gate = reinterpret_cast<const uint4*>(h + (size_t)row * 2 * C + C);
  const int nvec = C / 8;
  float s = 0.0f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 u = gate[v];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += bf(e[i]);
  }
  const float mu = warp_sum(s) / C;
  float var = 0.0f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 u = gate[v];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = bf(e[i]) - mu;
      var += d * d;
    }
  }
  var = warp_sum(var);
  if (lane == 0) stats[row] = make_float2(mu, rsqrtf(var / C + eps));
}

// h [B, T, 2C] bf16 (res = h[..., :C], gate = h[..., C:]); mask [B, T];
// stats [B*T] from ln_stats; conv_w [K, C];
// g [B, T, C] = res * (conv(LN(gate) * mask) + conv_b) [* keep * scale].
// Three phases per block, every device access a 16-byte vector:
//   1. the normalised, masked gate window [TT + K - 1, CT] into xs (fp32);
//   2. the conv: a thread holds one channel's K taps in registers and
//      slides over R = 16 frames at a time (compile-time indices only),
//      writing conv + bias to ys (fp32);
//   3. g = res * ys, with res read and g written as vectors.
constexpr int kGateTT = 128, kGateCT = 64, kGateR = 16;

template <int K>
constexpr size_t gate_smem() {
  return (size_t)(kGateTT + K - 1) * kGateCT * 4 + (size_t)kGateTT * kGateCT * 4 +
         (size_t)(kGateTT + K - 1) * 12 + 2 * kGateCT * 4;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 3) gate_pass(
    const bf16* __restrict__ h, const float* __restrict__ mask, const float2* __restrict__ stats,
    int T, int C, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const uint8_t* __restrict__ keep, float scale, bf16* __restrict__ g) {
  constexpr int HALO = (K - 1) / 2, ROWS = kGateTT + K - 1, CT = kGateCT, R = kGateR;
  constexpr int SEGS = kThreads / CT, SEG_FRAMES = kGateTT / SEGS;
  constexpr int VECS = ROWS * (CT / 8), PER = (VECS + kThreads - 1) / kThreads;
  constexpr int OUT_VECS = kGateTT * (CT / 8), OUT_PER = OUT_VECS / kThreads;
  static_assert(OUT_VECS % kThreads == 0, "output vectors per thread");
  extern __shared__ __align__(16) float gate_smem_raw[];
  float(*xs)[CT] = reinterpret_cast<float(*)[CT]>(gate_smem_raw);       // [ROWS][CT]
  float(*ys)[CT] = reinterpret_cast<float(*)[CT]>(gate_smem_raw + ROWS * CT);  // [TT][CT]
  float2* st_s = reinterpret_cast<float2*>(gate_smem_raw + (ROWS + kGateTT) * CT);  // (mean, rstd)
  float* m_s = reinterpret_cast<float*>(st_s + ROWS);  // 0: the row reaches the conv as 0
  float* lw_s = m_s + ROWS;
  float* lb_s = lw_s + CT;
  const int b = blockIdx.z, c0 = blockIdx.y * CT, t0 = blockIdx.x * kGateTT;
  const size_t row2c = (size_t)2 * C;

  for (int j = threadIdx.x; j < ROWS; j += kThreads) {
    const int t = t0 - HALO + j;
    const float m = (t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.0f;
    m_s[j] = m;
    st_s[j] = m != 0.0f ? stats[(size_t)b * T + t] : make_float2(0.0f, 0.0f);
  }
  if (threadIdx.x < CT) {
    lw_s[threadIdx.x] = ln_w[c0 + threadIdx.x];
    lb_s[threadIdx.x] = ln_b[c0 + threadIdx.x];
  }
  __syncthreads();
  // 1. the normalised, masked gate window; all of a thread's 16-byte reads
  // are issued before any is used, and padded rows are not read
  uint4 u[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int v = threadIdx.x + i * kThreads, j = v / (CT / 8), q = v % (CT / 8);
    u[i] = make_uint4(0u, 0u, 0u, 0u);
    if (v < VECS && m_s[j] != 0.0f)
      u[i] = *reinterpret_cast<const uint4*>(h + ((size_t)b * T + t0 - HALO + j) * row2c + C +
                                             c0 + 8 * q);
  }
  float lw[8], lb[8];  // a thread's 8 channels are the same for every i
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    lw[e] = lw_s[8 * (threadIdx.x % (CT / 8)) + e];
    lb[e] = lb_s[8 * (threadIdx.x % (CT / 8)) + e];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int v = threadIdx.x + i * kThreads, j = v / (CT / 8);
    if (v < VECS) {
      const bf16* e8 = reinterpret_cast<const bf16*>(&u[i]);
      const float2 st = st_s[j];
      const float m = m_s[j];
      float val[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)  // a zero mask gives exactly 0, whatever the row holds
        val[e] = m != 0.0f ? ((bf(e8[e]) - st.x) * st.y * lw[e] + lb[e]) * m : 0.0f;
      float4* dst = reinterpret_cast<float4*>(&xs[j][8 * (v % (CT / 8))]);
      dst[0] = make_float4(val[0], val[1], val[2], val[3]);
      dst[1] = make_float4(val[4], val[5], val[6], val[7]);
    }
  }
  __syncthreads();

  {  // 2. the conv
    const int cl = threadIdx.x % CT, seg = threadIdx.x / CT, c = c0 + cl;
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = conv_w[(size_t)k * C + c];
    const float cb = conv_b[c];
#pragma unroll 1
    for (int i0 = seg * SEG_FRAMES; i0 < (seg + 1) * SEG_FRAMES; i0 += R) {
      float acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = cb;
#pragma unroll
      for (int j = 0; j < R + K - 1; ++j) {
        const float v = xs[i0 + j][cl];
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (j - i >= 0 && j - i < K) acc[i] = fmaf(w[j - i], v, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) ys[i0 + i][cl] = acc[i];
    }
  }
  __syncthreads();

  // 3. g = res * conv; res is not masked: every frame in [0, T) is read
  uint4 r[OUT_PER];
#pragma unroll
  for (int i = 0; i < OUT_PER; ++i) {
    const int v = threadIdx.x + i * kThreads, f = v / (CT / 8), q = v % (CT / 8);
    r[i] = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + f < T)
      r[i] = *reinterpret_cast<const uint4*>(h + ((size_t)b * T + t0 + f) * row2c + c0 + 8 * q);
  }
#pragma unroll
  for (int i = 0; i < OUT_PER; ++i) {
    const int v = threadIdx.x + i * kThreads, f = v / (CT / 8), q = v % (CT / 8);
    if (t0 + f < T) {
      const bf16* e8 = reinterpret_cast<const bf16*>(&r[i]);
      const float4 y0 = *reinterpret_cast<const float4*>(&ys[f][8 * q]);
      const float4 y1 = *reinterpret_cast<const float4*>(&ys[f][8 * q + 4]);
      const size_t at = ((size_t)b * T + t0 + f) * C + c0 + 8 * q;
      float v[8] = {bf(e8[0]) * y0.x, bf(e8[1]) * y0.y, bf(e8[2]) * y0.z, bf(e8[3]) * y0.w,
                    bf(e8[4]) * y1.x, bf(e8[5]) * y1.y, bf(e8[6]) * y1.z, bf(e8[7]) * y1.w};
      if (keep != nullptr) {
        const uint2 k8 = *reinterpret_cast<const uint2*>(keep + at);
        const uint8_t* kb = reinterpret_cast<const uint8_t*>(&k8);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = kb[e] ? v[e] * scale : 0.0f;
      }
      uint4 o;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      *reinterpret_cast<uint4*>(g + at) = o;
    }
  }
}

template <class F>
static cudaError_t allow_smem(F* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// (1) and (4): 5 and 4 stages fill the shared memory left beside the two
// warpgroups' output staging.
constexpr int kPreStages = 5, kPostStages = 4;

// Blocks of `kernel` that are resident on the card at once.
template <class F>
static int resident_blocks(F* kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCoreThreads, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace smt

extern "C" int csgu_forward(const void* x, const void* mask, int B, int T, int D, int C2, int K,
                            const void* w_pre, const void* b_pre, const void* ln_w,
                            const void* ln_b, float eps, const void* conv_w, const void* conv_b,
                            const void* w_post, const void* b_post, const void* keep,
                            float scale, void* h, void* stats, void* g, void* out, void* stream) {
  using namespace smt;
  if (K != 15 && K != 31) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T, C = C2 / 2;
#define PRE_KERNEL gemm_tma<kPreStages, ACT_GELU_TANH>
#define POST_KERNEL gemm_tma<kPostStages, ACT_NONE>
  constexpr size_t pre_smem = gemm_smem<kPreStages>();
  constexpr size_t post_smem = gemm_smem<kPostStages>();
  static int pre_grid = 0, post_grid = 0;  // resident blocks: the persistent grids
  if (pre_grid == 0) {
    cudaError_t err = allow_smem(PRE_KERNEL, pre_smem);
    if (err == cudaSuccess) err = allow_smem(POST_KERNEL, post_smem);
    if (err == cudaSuccess) err = allow_smem(gate_pass<31>, gate_smem<31>());
    if (err == cudaSuccess) err = allow_smem(gate_pass<15>, gate_smem<15>());
    if (err != cudaSuccess) return (int)err;
    pre_grid = resident_blocks(PRE_KERNEL, pre_smem);
    post_grid = resident_blocks(POST_KERNEL, post_smem);
    if (pre_grid == 0 || post_grid == 0) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap map_x, map_wpre, map_h, map_g, map_wpost, map_out;
  if (!smt_host::matrix_map(&map_x, x, M, D, D, kBM) ||
      !smt_host::matrix_map(&map_wpre, w_pre, C2, D, D, kBN) ||
      !smt_host::matrix_map(&map_h, h, M, C2, C2, kBM) ||
      !smt_host::matrix_map(&map_g, g, M, C, C, kBM) ||
      !smt_host::matrix_map(&map_wpost, w_post, D, C, C, kBN) ||
      !smt_host::matrix_map(&map_out, out, M, D, D, kBM))
    return (int)cudaErrorInvalidValue;
  const int mtiles = (M + kBM - 1) / kBM, pre_tiles = mtiles * ((C2 + kBN - 1) / kBN);
  const int post_tiles = mtiles * ((D + kBN - 1) / kBN);
  PRE_KERNEL<<<pre_tiles < pre_grid ? pre_tiles : pre_grid, kCoreThreads, pre_smem, st>>>(
      map_x, map_wpre, map_h, (const float*)b_pre, M, C2, D);
  ln_stats<<<(M + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      (const bf16*)h, (const float*)mask, M, C, eps, (float2*)stats);
  const dim3 gate_grid((T + kGateTT - 1) / kGateTT, C / kGateCT, B);
  if (K == 31)
    gate_pass<31><<<gate_grid, kThreads, gate_smem<31>(), st>>>(
        (const bf16*)h, (const float*)mask, (const float2*)stats, T, C, (const float*)ln_w,
        (const float*)ln_b, (const float*)conv_w, (const float*)conv_b, (const uint8_t*)keep,
        scale, (bf16*)g);
  else
    gate_pass<15><<<gate_grid, kThreads, gate_smem<15>(), st>>>(
        (const bf16*)h, (const float*)mask, (const float2*)stats, T, C, (const float*)ln_w,
        (const float*)ln_b, (const float*)conv_w, (const float*)conv_b, (const uint8_t*)keep,
        scale, (bf16*)g);
  POST_KERNEL<<<post_tiles < post_grid ? post_tiles : post_grid, kCoreThreads, post_smem, st>>>(
      map_g, map_wpost, map_out, (const float*)b_post, M, D, C);
  return (int)cudaGetLastError();
#undef PRE_KERNEL
#undef POST_KERNEL
}
