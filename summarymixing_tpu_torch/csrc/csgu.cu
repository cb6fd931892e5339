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
// Backward (csgu_backward), from x, the kept h, LayerNorm statistics and g:
// bound by operations in its five bf16 products (dg = dOut W_post, dW_post =
// dOut^T g, the recompute z = x W_pre^T + b_pre, dx = dz W_pre, dW_pre = dz^T
// x: about 12.6 MFLOP a row), by bytes in the gate pass's VJP between them.
//   - gemm_grad: gemm_tma's persistent walk with an operand read MN-major
//     where it is stored token-major (the weight gradients read dOut, g, dz
//     and x as they lie, no transposed copy), K cut into token ranges whose
//     fp32 partial sums sum_parts adds in order, and epilogues that store
//     fp32 (dg, dx before its cast to bf16, the weight gradients' partials)
//     or turn dh into dz = dh * gelu'(z) in place;
//   - gate_backward, ln_backward: the gate pass's VJP (below) and
//     LayerNorm's, whose row sums span every channel tile;
//   - col_sums, sum_parts: the biases' and every split sum, in order.
// No atomics: two runs give the same bits.
//
// C interface: csgu_forward(...) and csgu_backward(...) return 0, a CUDA
// error after the launches, or cudaErrorInvalidValue when a tensor map
// cannot be encoded.

#include "gemm_sm90.cuh"

namespace smt {

constexpr int kBM = 128, kBN = 128;  // output tile of the product kernel

template <int STAGES>
constexpr size_t gemm_smem() {  // ring, output staging of both warpgroups, barriers, alignment
  return (size_t)STAGES * (kBM + kBN) * kLineBytes + (size_t)2 * kBM * kBN * 2 +
         (2 * STAGES + 2) * 8 + 1024;
}

constexpr int kGradStages = 5;  // the backward's products: the ring beside the staging tiles

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

// ------------------------------------------------------------- backward
//
// The VJP of the branch in bf16 products (fp32 accumulators) and fp32
// elementwise work, from what the training forward kept: x, h (bf16
// [M, 2C]), the gate rows' LayerNorm statistics and g (bf16 [M, C]).

// Epilogues of gemm_grad: the fp32 accumulators stored as they are
// (`out32`, split s at s * M * N), or dz = bf16(dh * gelu'(acc + bias)), dh
// loaded by TMA into a swizzled shared tile where dz is written and from
// which a TMA store takes it.
enum GradEpi { EPI_F32 = 0, EPI_DGELU = 1 };

template <int STAGES>
constexpr size_t grad_smem() {  // gemm_tma's, and the two dh barriers
  return gemm_smem<STAGES>() + 2 * 8;
}

// out[M x N] = A[M x K] B[N x K]^T, bf16 operands through TMA maps. A is read
// K-major from a [M x K] matrix (boxes of 128 x 64) or, with TA, MN-major
// from a [K x M] matrix (two boxes of 64 x 64 a stage); B likewise with TB.
// N % 128 == 0; rows and K past the matrices load as zero. With EPI_F32,
// `splits` cuts K into that many ranges of whole stages: item i is tile
// i % tiles of split i / tiles, so a weight gradient's tiles fill the card
// and its partial sums are added in order afterwards (sum_parts), without
// atomics; EPI_DGELU takes K whole. The block walk, the producer and the two
// warpgroups' turns are gemm_tma's. With EPI_DGELU a warpgroup's issuing
// thread loads the item's dh tile (map_out) into its staging tile while the
// products run, so the epilogue reads it from shared memory.
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kCoreThreads, 1) gemm_grad(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_out, float* __restrict__ out32,
    const float* __restrict__ bias, int M, int N, int K, int splits) {
  constexpr int BM = kBM, BN = kBN, STAGES = kGradStages;
  constexpr uint32_t HALF = 64 * kLineBytes;  // one 64-line box
  constexpr uint32_t A_BYTES = BM * kLineBytes, STAGE = A_BYTES + BN * kLineBytes;
  constexpr uint32_t OUT_BYTES = BM * BN * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* staging = smem + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;
  uint64_t* dh_full = order + 2;  // dh_full[w]: warpgroup w's dh tile has landed
  const int ntn = N / BN, tiles = ((M + BM - 1) / BM) * ntn, kblocks = (K + kBK - 1) / kBK;
  const int items = EPI == EPI_F32 ? tiles * splits : tiles;
  const int warp = threadIdx.x / 32;
  // the stages of item i: its split's K range, or all of K
  auto range = [&](int i, int& kb0) {
    if constexpr (EPI == EPI_F32) {
      const int sp = i / tiles;
      kb0 = sp * kblocks / splits;
      return (sp + 1) * kblocks / splits - kb0;
    }
    kb0 = 0;
    return kblocks;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&order[w], 1);
      mbar_init(&dh_full[w], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    if ((threadIdx.x & 31) == 0) {
      RingPos pos;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item % tiles, m0 = (tile / ntn) * BM, n0 = (tile % ntn) * BN;
        int kb0;
        const int nk = range(item, kb0);
        for (int kb = kb0; kb < kb0 + nk; ++kb) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
          mbar_expect_tx(&full[pos.stage], STAGE);
          uint8_t* st = smem + pos.stage * STAGE;
          if constexpr (TA) {
            tma_load_2d(st, &map_a, &full[pos.stage], m0, kb * kBK);
            tma_load_2d(st + HALF, &map_a, &full[pos.stage], m0 + 64, kb * kBK);
          } else {
            tma_load_2d(st, &map_a, &full[pos.stage], kb * kBK, m0);
          }
          if constexpr (TB) {
            tma_load_2d(st + A_BYTES, &map_b, &full[pos.stage], n0, kb * kBK);
            tma_load_2d(st + A_BYTES + HALF, &map_b, &full[pos.stage], n0 + 64, kb * kBK);
          } else {
            tma_load_2d(st + A_BYTES, &map_b, &full[pos.stage], kb * kBK, n0);
          }
          pos.next(STAGES);
        }
      }
    }
  } else {  // two consumer warpgroups, alternate items
    const int wg = warp / 4;
    const uint32_t base = smem_u32(smem);
    uint8_t* stg = staging + wg * OUT_BYTES;
    const bool issuer = threadIdx.x % 128 == 0;
    int kb0;
    RingPos pos;
    if (wg == 1) pos.advance(range(blockIdx.x, kb0), STAGES);  // warpgroup 0's first item
    uint32_t turn = 0, dh_turn = 0;
    bool first = wg == 0;
    for (int item = blockIdx.x + wg * gridDim.x; item < items; item += 2 * gridDim.x) {
      const int tile = item % tiles, m0 = (tile / ntn) * BM, n0 = (tile % ntn) * BN;
      if constexpr (EPI == EPI_DGELU) {
        if (issuer) {
          bulk_wait_read();  // the previous item's store has left the staging tile
          mbar_expect_tx(&dh_full[wg], OUT_BYTES);
          for (int kb = 0; kb < BN / kBK; ++kb)
            tma_load_2d(stg + kb * BM * kLineBytes, &map_out, &dh_full[wg], n0 + kb * kBK, m0);
        }
      }
      float acc[2][BN / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.0f;
      if (!first) {
        mbar_wait(&order[wg], turn);
        turn ^= 1u;
      }
      first = false;
      consume<2, TA, TB>(
          acc, range(item, kb0), full, empty, STAGES, pos,
          [&](int, int st) { return base + st * STAGE; },
          [&](int st) { return base + st * STAGE + A_BYTES; });
      if (issuer) mbar_arrive(&order[wg ^ 1]);
      pos.advance(range(item + gridDim.x, kb0), STAGES);  // the other warpgroup's item
      if constexpr (EPI == EPI_F32) {
        float* o = out32 + (size_t)(item / tiles) * M * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + acc_col();
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = m0 + 64 * h + acc_row() + 8 * hh;
              if (r < M)
                *reinterpret_cast<float2*>(o + (size_t)r * N + c) =
                    make_float2(acc[h][4 * j + 2 * hh], acc[h][4 * j + 2 * hh + 1]);
            }
        }
      } else {
        mbar_wait(&dh_full[wg], dh_turn);
        dh_turn ^= 1u;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int cl = 8 * j + acc_col();
          const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + cl);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
                  stg + swizzled_offset(64 * h + acc_row() + 8 * hh, cl, BM));
              const __nv_bfloat162 d2 = *at;
              *at = __floats2bfloat162_rn(
                  __low2float(d2) * gelu_tanh_grad(acc[h][4 * j + 2 * hh] + bb.x),
                  __high2float(d2) * gelu_tanh_grad(acc[h][4 * j + 2 * hh + 1] + bb.y));
            }
        }
        fence_async_smem();
        warpgroup_sync(wg);
        if (issuer) {
          for (int kb = 0; kb < BN / kBK; ++kb)
            tma_store_2d(&map_out, stg + kb * BM * kLineBytes, n0 + kb * kBK, m0);
          bulk_commit();
        }
      }
    }
    if constexpr (EPI != EPI_F32)
      if (issuer) bulk_wait_read();
  }
}

// The gate pass's VJP. A block per (128-frame tile, 64-channel tile,
// utterance), as gate_pass, two per SM, in three phases:
//   1. two windows of the tile's rows and K - 1 halo rows in shared memory
//      (fp32): xhat = LayerNorm's normalised gate (0 where the mask is 0 or
//      outside [0, T)), and dy = d(conv + bias) = do * res, do = dg [* keep
//      * scale], 0 outside [0, T); 16-byte reads;
//   2. a thread per (channel, 32-frame segment), its K taps in registers,
//      slides over R = 8 frames at a time (compile-time indices only) and
//      takes, for each frame, the conv output y again (for d res = do * y),
//      the transposed conv d(LN * mask) = sum_k w[k] dy[t + HALO - k], and
//      accumulates dconv_w[k] += dy[t] * nm[t - HALO + k] (nm = LN * mask),
//      dconv_b, and LayerNorm's dln_w, dln_b; it writes dh[:, :C] =
//      bf16(do * y) and dxhat = d(LN * mask) * mask * ln_w (fp32), and each
//      frame's sums of dxhat and dxhat * xhat over the tile's channels
//      (`rowpart`, one pair a channel tile: LayerNorm's backward needs them
//      over all C, so ln_backward finishes the gate half);
//   3. the four segments' parameter sums are added in order and written as
//      the block's partial `gparts[p][k][c]` (k < K: conv taps, then conv_b,
//      ln_w, ln_b), which sum_parts adds over blocks in order.
constexpr int kGbTT = 128, kGbCT = 64, kGbR = 8;

template <int K>
constexpr size_t gate_bwd_smem() {
  return (size_t)2 * (kGbTT + K - 1) * kGbCT * 4 + (size_t)(kGbTT + K - 1) * 12 +
         (size_t)kGbTT * 2 * 8;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2) gate_backward(
    const bf16* __restrict__ h, const float* __restrict__ mask, const float2* __restrict__ stats,
    int T, int C, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const uint8_t* __restrict__ keep, float scale, const float* __restrict__ dg,
    bf16* __restrict__ dh, float* __restrict__ dxhat, float2* __restrict__ rowpart,
    float* __restrict__ gparts) {
  constexpr int HALO = (K - 1) / 2, ROWS = kGbTT + K - 1, CT = kGbCT, R = kGbR, NP = K + 3;
  constexpr int SEGS = kThreads / CT, SEG_FRAMES = kGbTT / SEGS, VECS = ROWS * (CT / 8);
  static_assert(SEG_FRAMES % R == 0, "a segment is whole steps of R frames");
  static_assert(SEGS * NP * CT <= ROWS * CT, "the parameter sums fit in the xhat window");
  static_assert((3 * ROWS) % 2 == 0, "rs is 8-byte aligned");
  extern __shared__ __align__(16) float gb_smem[];
  float(*xs)[CT] = reinterpret_cast<float(*)[CT]>(gb_smem);              // [ROWS][CT] xhat
  float(*ds)[CT] = reinterpret_cast<float(*)[CT]>(gb_smem + ROWS * CT);  // [ROWS][CT] dy
  float2* st_s = reinterpret_cast<float2*>(gb_smem + 2 * ROWS * CT);
  float* m_s = reinterpret_cast<float*>(st_s + ROWS);
  float2(*rs)[2] = reinterpret_cast<float2(*)[2]>(m_s + ROWS);  // [TT][warp half]
  const int b = blockIdx.z, ct = blockIdx.y, c0 = ct * CT, t0 = blockIdx.x * kGbTT;
  const size_t row2c = (size_t)2 * C;

  for (int j = threadIdx.x; j < ROWS; j += kThreads) {
    const int t = t0 - HALO + j;
    const float m = (t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.0f;
    m_s[j] = m;
    st_s[j] = m != 0.0f ? stats[(size_t)b * T + t] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  // 1. the windows
  for (int v = threadIdx.x; v < VECS; v += kThreads) {
    const int j = v / (CT / 8), q = v % (CT / 8), t = t0 - HALO + j, c = c0 + 8 * q;
    float xv[8], dv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) xv[e] = dv[e] = 0.0f;
    if (t >= 0 && t < T) {
      const size_t row = (size_t)b * T + t;
      if (m_s[j] != 0.0f) {
        const uint4 u = *reinterpret_cast<const uint4*>(h + row * row2c + C + c);
        const bf16* e8 = reinterpret_cast<const bf16*>(&u);
        const float2 st = st_s[j];
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = (bf(e8[e]) - st.x) * st.y;
      }
      const uint4 r = *reinterpret_cast<const uint4*>(h + row * row2c + c);
      const bf16* r8 = reinterpret_cast<const bf16*>(&r);
      const float4 g0 = *reinterpret_cast<const float4*>(dg + row * C + c);
      const float4 g1 = *reinterpret_cast<const float4*>(dg + row * C + c + 4);
      float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      if (keep != nullptr) {
        const uint2 k8 = *reinterpret_cast<const uint2*>(keep + row * C + c);
        const uint8_t* kb = reinterpret_cast<const uint8_t*>(&k8);
#pragma unroll
        for (int e = 0; e < 8; ++e) gv[e] = kb[e] ? gv[e] * scale : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) dv[e] = gv[e] * bf(r8[e]);
    }
    float4* xd = reinterpret_cast<float4*>(&xs[j][8 * q]);
    float4* dd = reinterpret_cast<float4*>(&ds[j][8 * q]);
    xd[0] = make_float4(xv[0], xv[1], xv[2], xv[3]);
    xd[1] = make_float4(xv[4], xv[5], xv[6], xv[7]);
    dd[0] = make_float4(dv[0], dv[1], dv[2], dv[3]);
    dd[1] = make_float4(dv[4], dv[5], dv[6], dv[7]);
  }
  __syncthreads();

  // 2. a warp is 32 channels of one segment: its frame is the same in every lane
  const int cl = threadIdx.x % CT, seg = threadIdx.x / CT, c = c0 + cl;
  const int lane = threadIdx.x & 31, half = (threadIdx.x / 32) & 1;
  float w[K], dw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = conv_w[(size_t)k * C + c];
    dw[k] = 0.0f;
  }
  const float cb = conv_b[c], lw = ln_w[c], lb = ln_b[c];
  float dcb = 0.0f, dlw = 0.0f, dlb = 0.0f;
#pragma unroll 1
  for (int i0 = seg * SEG_FRAMES; i0 < (seg + 1) * SEG_FRAMES; i0 += R) {
    float y[R], dn[R], dyt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      y[r] = cb;
      dn[r] = 0.0f;
      dyt[r] = ds[i0 + HALO + r][cl];
    }
#pragma unroll
    for (int j = 0; j < R + K - 1; ++j) {
      const float nm = m_s[i0 + j] * fmaf(xs[i0 + j][cl], lw, lb);
      const float u = ds[i0 + j][cl];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = j - r;
        if (k >= 0 && k < K) {
          y[r] = fmaf(w[k], nm, y[r]);
          dw[k] = fmaf(dyt[r], nm, dw[k]);
          dn[r] = fmaf(w[K - 1 - k], u, dn[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r, t = t0 + i;
      dcb += dyt[r];
      float s1 = 0.0f, s2 = 0.0f;
      if (t < T) {
        const size_t row = (size_t)b * T + t;
        float gv = dg[row * C + c];
        if (keep != nullptr) gv = keep[row * C + c] ? gv * scale : 0.0f;
        dh[row * row2c + c] = __float2bfloat16(gv * y[r]);
        const float xv = xs[i + HALO][cl], dnv = dn[r] * m_s[i + HALO];
        dlb += dnv;
        dlw = fmaf(dnv, xv, dlw);
        const float dx = dnv * lw;
        dxhat[row * C + c] = dx;
        s1 = dx;
        s2 = dx * xv;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) rs[i][half] = make_float2(s1, s2);
    }
  }
  __syncthreads();

  // 3. the per-frame and per-parameter sums of the block
  for (int i = threadIdx.x; i < kGbTT; i += kThreads)
    if (t0 + i < T) {
      const float2 a = rs[i][0], z = rs[i][1];
      rowpart[((size_t)b * T + t0 + i) * gridDim.y + ct] = make_float2(a.x + z.x, a.y + z.y);
    }
  float(*red)[NP][CT] = reinterpret_cast<float(*)[NP][CT]>(gb_smem);  // over the xhat window
#pragma unroll
  for (int k = 0; k < K; ++k) red[seg][k][cl] = dw[k];
  red[seg][K][cl] = dcb;
  red[seg][K + 1][cl] = dlw;
  red[seg][K + 2][cl] = dlb;
  __syncthreads();
  const size_t p = (size_t)b * gridDim.x + blockIdx.x;
  for (int e = threadIdx.x; e < NP * CT; e += kThreads) {
    const int k = e / CT, q = e % CT;
    float sum = red[0][k][q];
#pragma unroll
    for (int sg = 1; sg < SEGS; ++sg) sum += red[sg][k][q];
    gparts[(p * NP + k) * C + c0 + q] = sum;
  }
}

// LayerNorm's backward for the gate half, a warp per row:
// dh[row, C + c] = bf16(rstd * (dxhat - (s1 + xhat * s2) / C)), s1 and s2
// the sums of dxhat and dxhat * xhat over the row (its channel tiles'
// `rowpart`, added in a fixed order); 0 on rows whose mask is 0.
__global__ void __launch_bounds__(kThreads) ln_backward(
    const bf16* __restrict__ h, const float* __restrict__ mask, const float2* __restrict__ stats,
    const float2* __restrict__ rowpart, int nct, const float* __restrict__ dxhat, int M, int C,
    bf16* __restrict__ dh) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= M) return;
  uint4* out = reinterpret_cast<uint4*>(dh + (size_t)row * 2 * C + C);
  const int nvec = C / 8;
  if (mask[row] == 0.0f) {
    for (int v = lane; v < nvec; v += 32) out[v] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < nct; i += 32) {
    const float2 part = rowpart[(size_t)row * nct + i];
    s1 += part.x;
    s2 += part.y;
  }
  s1 = warp_sum(s1) / C;
  s2 = warp_sum(s2) / C;
  const float2 st = stats[row];
  const uint4* gate = reinterpret_cast<const uint4*>(h + (size_t)row * 2 * C + C);
  const float4* dx = reinterpret_cast<const float4*>(dxhat + (size_t)row * C);
  for (int v = lane; v < nvec; v += 32) {
    const uint4 u = gate[v];
    const bf16* e8 = reinterpret_cast<const bf16*>(&u);
    const float4 d0 = dx[2 * v], d1 = dx[2 * v + 1];
    const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = (bf(e8[2 * e]) - st.x) * st.y, x1 = (bf(e8[2 * e + 1]) - st.x) * st.y;
      o2[e] = __floats2bfloat162_rn(st.y * (d[2 * e] - s1 - x0 * s2),
                                    st.y * (d[2 * e + 1] - s1 - x1 * s2));
    }
    out[v] = o;
  }
}

// parts[p][n] = the sum of rows [p * kColRows, (p + 1) * kColRows) of a bf16
// [M, N] matrix: a block per 256 columns and row range, each warp a strided
// share of the rows, the eight warps added in order.
constexpr int kColRows = 128;

__global__ void __launch_bounds__(kThreads) col_sums(const bf16* __restrict__ a, int M, int N,
                                                     float* __restrict__ parts) {
  __shared__ float part[kThreads / 32][256];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 256 + 8 * lane, r0 = blockIdx.y * kColRows;
  const int r1 = r0 + kColRows < M ? r0 + kColRows : M;
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = 0.0f;
  if (c < N)
    for (int r = r0 + warp; r < r1; r += kThreads / 32) {
      const uint4 u = *reinterpret_cast<const uint4*>(a + (size_t)r * N + c);
      const bf16* e8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] += bf(e8[e]);
    }
#pragma unroll
  for (int e = 0; e < 8; ++e) part[warp][8 * lane + e] = s[e];
  __syncthreads();
  const int cc = blockIdx.x * 256 + threadIdx.x;
  if (cc < N) {
    float sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) sum += part[w][threadIdx.x];
    parts[(size_t)blockIdx.y * N + cc] = sum;
  }
}

// out[i] = bf16(in[i]), four a thread; n % 4 == 0.
__global__ void __launch_bounds__(kThreads) to_bf16(const float* __restrict__ in, size_t n,
                                                    bf16* __restrict__ out) {
  const size_t i = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(in + i);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + i);
  o[0] = __floats2bfloat162_rn(v.x, v.y);
  o[1] = __floats2bfloat162_rn(v.z, v.w);
}

// out[i] = sum over p, in order, of parts[p * L + i].
__global__ void __launch_bounds__(kThreads) sum_parts(const float* __restrict__ parts, int P,
                                                      size_t L, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  float sum = 0.0f;
  for (int p = 0; p < P; ++p) sum += parts[(size_t)p * L + i];
  out[i] = sum;
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

// need: which gradients to compute, bit 0 dx, 1 W_pre, 2 b_pre, 3 the gate's
// vectors (conv_w, conv_b, ln_w, ln_b), 4 W_post, 5 b_post. Scratch: dg (dx in
// fp32 before its cast, once the gate pass has read dg), dxhat fp32 [M, C]; dh
// bf16 [M, 2C] (dz once the recompute has read it); rowpart
// fp32 [M, C / 64, 2]; gparts fp32 [B * ceil(T / 128), K + 3, C]; wparts fp32,
// the larger of split_post * D * C and split_pre * 2C * D; cparts fp32
// [ceil(M / 128), 2C]. Outputs: dx bf16 [M, D]; dw_pre [2C, D], db_pre [2C],
// dgate [K + 3, C] (conv_w's K rows, conv_b, ln_w, ln_b), dw_post [D, C],
// db_post [D], fp32. Returns 0, a CUDA error, or cudaErrorInvalidValue.
extern "C" int csgu_backward(const void* dout, const void* x, const void* h, const void* stats,
                             const void* g, const void* mask, const void* keep, float scale,
                             int B, int T, int D, int C2, int K, const void* w_pre,
                             const void* b_pre, const void* ln_w, const void* ln_b,
                             const void* conv_w, const void* conv_b, const void* w_post,
                             int need, int split_post, int split_pre, void* dg, void* dxhat,
                             void* dh, void* rowpart, void* gparts, void* wparts, void* cparts,
                             void* dx, void* dw_pre, void* db_pre, void* dgate, void* dw_post,
                             void* db_post, void* stream) {
  using namespace smt;
  if (K != 15 && K != 31) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * T, C = C2 / 2, nct = C / kGbCT, ttiles = (T + kGbTT - 1) / kGbTT;
  const int crow = (M + kColRows - 1) / kColRows;
#define WGRAD gemm_grad<true, true, EPI_F32>
#define DG gemm_grad<false, true, EPI_F32>
#define DZ gemm_grad<false, false, EPI_DGELU>
  constexpr size_t smem = grad_smem<kGradStages>();
  static int grid = 0;  // resident blocks of the product kernels (one per SM)
  if (grid == 0) {
    cudaError_t err = allow_smem(WGRAD, smem);
    if (err == cudaSuccess) err = allow_smem(DG, smem);
    if (err == cudaSuccess) err = allow_smem(DZ, smem);
    if (err == cudaSuccess) err = allow_smem(gate_backward<31>, gate_bwd_smem<31>());
    if (err == cudaSuccess) err = allow_smem(gate_backward<15>, gate_bwd_smem<15>());
    if (err != cudaSuccess) return (int)err;
    grid = resident_blocks(WGRAD, smem);
    if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  }
  auto blocks = [&](int rows, int cols, int splits) {
    const int items = ((rows + kBM - 1) / kBM) * (cols / kBN) * splits;
    return items < grid ? items : grid;
  };
  auto sum = [&](const void* parts, int P, size_t L, void* out) {
    sum_parts<<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const float*)parts, P, L, (float*)out);
  };
  if (need & 32) {  // db_post: the columns of dOut
    col_sums<<<dim3((D + 255) / 256, crow), kThreads, 0, st>>>((const bf16*)dout, M, D,
                                                               (float*)cparts);
    sum(cparts, crow, D, db_post);
  }
  if (need & 16) {  // dW_post = dOut^T g, both read MN-major, over split_post token ranges
    CUtensorMap map_a, map_b;
    if (!smt_host::matrix_map(&map_a, dout, M, D, D, 64) ||
        !smt_host::matrix_map(&map_b, g, M, C, C, 64))
      return (int)cudaErrorInvalidValue;
    WGRAD<<<blocks(D, C, split_post), kCoreThreads, smem, st>>>(
        map_a, map_b, map_a, (float*)wparts, nullptr, D, C, M, split_post);
    sum(wparts, split_post, (size_t)D * C, dw_post);
  }
  if (need & 15) {
    CUtensorMap map_dout, map_wpost;
    if (!smt_host::matrix_map(&map_dout, dout, M, D, D, kBM) ||
        !smt_host::matrix_map(&map_wpost, w_post, D, C, C, 64))
      return (int)cudaErrorInvalidValue;
    // dg = dOut W_post, fp32 [M, C]
    DG<<<blocks(M, C, 1), kCoreThreads, smem, st>>>(map_dout, map_wpost, map_dout, (float*)dg,
                                                     nullptr, M, C, D, 1);
    const dim3 gate_grid(ttiles, nct, B);
    if (K == 31)
      gate_backward<31><<<gate_grid, kThreads, gate_bwd_smem<31>(), st>>>(
          (const bf16*)h, (const float*)mask, (const float2*)stats, T, C, (const float*)ln_w,
          (const float*)ln_b, (const float*)conv_w, (const float*)conv_b, (const uint8_t*)keep,
          scale, (const float*)dg, (bf16*)dh, (float*)dxhat, (float2*)rowpart, (float*)gparts);
    else
      gate_backward<15><<<gate_grid, kThreads, gate_bwd_smem<15>(), st>>>(
          (const bf16*)h, (const float*)mask, (const float2*)stats, T, C, (const float*)ln_w,
          (const float*)ln_b, (const float*)conv_w, (const float*)conv_b, (const uint8_t*)keep,
          scale, (const float*)dg, (bf16*)dh, (float*)dxhat, (float2*)rowpart, (float*)gparts);
    if (need & 8) sum(gparts, B * ttiles, (size_t)(K + 3) * C, dgate);
  }
  if (need & 7) {
    ln_backward<<<(M + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
        (const bf16*)h, (const float*)mask, (const float2*)stats, (const float2*)rowpart, nct,
        (const float*)dxhat, M, C, (bf16*)dh);
    CUtensorMap map_x, map_wpre, map_dh;
    if (!smt_host::matrix_map(&map_x, x, M, D, D, kBM) ||
        !smt_host::matrix_map(&map_wpre, w_pre, C2, D, D, kBN) ||
        !smt_host::matrix_map(&map_dh, dh, M, C2, C2, kBM))
      return (int)cudaErrorInvalidValue;
    // z = x W_pre^T + b_pre again, in bf16 products; dz = dh gelu'(z) over dh
    DZ<<<blocks(M, C2, 1), kCoreThreads, smem, st>>>(map_x, map_wpre, map_dh, nullptr,
                                                      (const float*)b_pre, M, C2, D, 1);
    if (need & 1) {  // dx = dz W_pre, fp32 over dg (read by now), then bf16
      CUtensorMap map_wpre_mn;
      if (!smt_host::matrix_map(&map_wpre_mn, w_pre, C2, D, D, 64))
        return (int)cudaErrorInvalidValue;
      DG<<<blocks(M, D, 1), kCoreThreads, smem, st>>>(map_dh, map_wpre_mn, map_dh, (float*)dg,
                                                       nullptr, M, D, C2, 1);
      const size_t n = (size_t)M * D;
      to_bf16<<<(unsigned)((n / 4 + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          (const float*)dg, n, (bf16*)dx);
    }
    if (need & 2) {  // dW_pre = dz^T x, both read MN-major, over split_pre token ranges
      CUtensorMap map_a, map_b;
      if (!smt_host::matrix_map(&map_a, dh, M, C2, C2, 64) ||
          !smt_host::matrix_map(&map_b, x, M, D, D, 64))
        return (int)cudaErrorInvalidValue;
      WGRAD<<<blocks(C2, D, split_pre), kCoreThreads, smem, st>>>(
          map_a, map_b, map_a, (float*)wparts, nullptr, C2, D, M, split_pre);
      sum(wparts, split_pre, (size_t)C2 * D, dw_pre);
    }
    if (need & 4) {  // db_pre: the columns of dz
      col_sums<<<dim3((C2 + 255) / 256, crow), kThreads, 0, st>>>((const bf16*)dh, M, C2,
                                                                  (float*)cparts);
      sum(cparts, crow, C2, db_pre);
    }
  }
  return (int)cudaGetLastError();
#undef WGRAD
#undef DG
#undef DZ
}
