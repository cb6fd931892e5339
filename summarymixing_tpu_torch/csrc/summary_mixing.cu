// Fused SummaryMixing cell (full mode, nhead 1, one hidden layer per
// branch) for sm_90a.
//
// Replaces the TPU kernel summarymixing_tpu/ops/pallas_summary.py
// (_kernel via _pallas_forward / fused_summary_mixing). Bound on the H100:
// operations (five bf16 products of [valid frames x 512] by [512 x 512]).
// The TPU kernel holds an utterance in VMEM and carries the time sum through
// its sequential grid; Hopper blocks run in parallel, so the cell runs in
// three launches:
//   (a) branch_pass: grid (64-frame tile, utterance, branch), 192 blocks at
//       B=8, T=751, the local branch's blocks first: the scheduler starts
//       them first, and they run three products to the summary's two.
//       Each block chains its products on the wgmma + TMA core
//       (gemm_sm90.cuh): the x tile arrives by TMA into a swizzled buffer,
//       each epilogue writes the next product's A operand into shared memory
//       in the same layout, and the weights stream through a 3-stage ring.
//       Summary blocks: h = act(x S1^T + c1), then act(h S2^T + c2) * pad
//       summed over the tile's rows in fp32, in a fixed order (no atomics),
//       to one partial row. Local blocks: h = act(x W1^T + b1), local =
//       act(h W2^T + b2) * pad (bf16, in the buffer x held), then the fp32
//       pre-activation local M1^T to device memory. A tile with no valid
//       frame computes no product: its partial row is zero and its output
//       rows are act(bias), which (c) gives them.
//   (b) pool_pass: block per (utterance, 32 output columns). pooled = sum
//       of the partials in tile order / max(sum pad, 1), rounded to bf16;
//       bias = pooled M2^T + mb in fp32.
//   (c) finish_pass: out = act(pre + bias), with pre taken as 0 on a padded
//       frame (its local row is zero, so local M1^T is exactly 0 there).
// The ragged T edge: TMA fills frames past T with zeros, they carry pad 0
// and are never stored.
//
// Dropout (training): a keep-mask `keep` [B, T, OL + OS] (bytes, 1 = keep)
// over the concatenated [local, pooled] features, kept values times
// `scale` = 1 / keep_prob and rounded to bf16. (a)'s local epilogue masks
// the local half before the M1 product. The pooled half differs per frame,
// so pooled M2^T can no longer be folded into a row bias: (b) writes
// pooled * scale (bf16) and bias = mb, and
//   (d) pooled_pass: grid (64-frame tile, utterance), every tile with a
//       frame < T: the block builds the tile's masked pooled rows
//       (keep ? pooled * scale : 0) in a swizzled shared buffer and runs
//       their product with M2 on the same core, adding it to pre on every
//       frame (pre is taken as 0 on a padded frame, as (c) does), so (c)
//       then reads pre on every frame.
//
// The split route (a time-sharded encode, one shard of T per process):
// the cell's only coupling across frames is the pooled mean, so
//   sm_partial runs (a) and then partial_sum_pass, which reduces the tile
//     partials of each utterance, in tile order, to one fp32 row [B, OS]
//     and counts its valid frames [B] (fp32); pre [B, T, N] stays on the
//     device;
//   the caller all-reduces the sums and the counts over the shards;
//   sm_finish runs (b) on the reduced row (one "tile", the count given)
//     and (c).
// No keep-mask: the route serves inference.
//
// C interface: sm_forward(...), sm_partial(...) and sm_finish(...) return
// 0, a CUDA error after the launches, or cudaErrorInvalidValue for an
// unknown activation or a tensor map that cannot be encoded.

#include "gemm_sm90.cuh"

namespace smt {

constexpr int kTile = 64;                     // frames per block: one wgmma M
constexpr int kChunk = 256;                   // output columns per ring stage, 128 per warpgroup
constexpr int kStages = 3;
constexpr int kMaxWidth = 512;                // widest operand a resident buffer holds
constexpr uint32_t kBufBytes = kTile * kMaxWidth * 2;       // 64 KB, 8 swizzled k-blocks
constexpr uint32_t kKBlockBytes = kTile * kLineBytes;       // 8 KB
constexpr uint32_t kStageBytes = kChunk * kLineBytes;       // 32 KB
constexpr size_t kBranchSmem = 2 * kBufBytes + kStages * kStageBytes + 512 + 1024;
constexpr size_t kPooledSmem = kBufBytes + kStages * kStageBytes + 2 * kStages * 8 + 1024;

// Offset in a resident [64 x 512] operand of row r, column c0 + 8j + cq,
// for a column start c0 that is a multiple of 128 (j known at compile time).
__device__ __forceinline__ uint32_t chunk_offset(int r, int c0, int j, int cq) {
  return (uint32_t)(((c0 >> 6) + (j >> 3)) * kKBlockBytes + r * kLineBytes +
                    (((j & 7) ^ (r & 7)) << 4) + cq * 2);
}

struct Product {
  const CUtensorMap* map;
  int n, k;  // output columns, depth
};

template <int ACT>
__global__ void __launch_bounds__(kCoreThreads, 1) branch_pass(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w1,
    const __grid_constant__ CUtensorMap map_w2, const __grid_constant__ CUtensorMap map_s1,
    const __grid_constant__ CUtensorMap map_s2, const __grid_constant__ CUtensorMap map_m1,
    const float* __restrict__ pad, int T, int D, int HL, int OL, int HS, int OS, int N,
    const bf16* __restrict__ b1, const bf16* __restrict__ b2, const bf16* __restrict__ c1,
    const bf16* __restrict__ c2, const uint8_t* __restrict__ keep, int ldk, float scale,
    float* __restrict__ partial, float* __restrict__ pre) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* xbuf = smem;                   // x, then the local branch output (or fp32 scratch)
  uint8_t* hbuf = smem + kBufBytes;       // the hidden layer
  uint8_t* ring = smem + 2 * kBufBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* xbar = empty + kStages;
  float* pads = reinterpret_cast<float*>(xbar + 1);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * kTile;
  const bool summary = blockIdx.z == 1;  // local blocks first: they run three products
  const int n_tiles = gridDim.x;

  float p = 0.0f;
  if (threadIdx.x < kTile && t0 + (int)threadIdx.x < T) p = pad[(size_t)b * T + t0 + threadIdx.x];
  if (threadIdx.x < kTile) pads[threadIdx.x] = p;
  if (!__syncthreads_or(p != 0.0f)) {  // no valid frame: no product
    if (summary)
      for (int o = threadIdx.x; o < OS; o += kCoreThreads)
        partial[((size_t)b * n_tiles + tile) * OS + o] = 0.0f;
    return;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const Product prods[3] = {
      summary ? Product{&map_s1, HS, D} : Product{&map_w1, HL, D},
      summary ? Product{&map_s2, OS, HS} : Product{&map_w2, OL, HL},
      Product{&map_m1, N, OL}};
  const int n_prods = summary ? 2 : 3;
  const int warp = threadIdx.x / 32;

  if (warp == kConsumerWarps) {  // producer: x once, then every weight tile in order
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(xbar, (uint32_t)D * kTile * 2);
      for (int kb = 0; kb < D / kBK; ++kb)
        tma_load_3d(xbuf + kb * kKBlockBytes, &map_x, xbar, kb * kBK, t0, b);
      RingPos pos;
      for (int i = 0; i < n_prods; ++i)
        for (int n0 = 0; n0 < prods[i].n; n0 += kChunk)
          for (int kb = 0; kb < prods[i].k / kBK; ++kb) {
            mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
            mbar_expect_tx(&full[pos.stage], kStageBytes);
            tma_load_2d(ring + pos.stage * kStageBytes, prods[i].map, &full[pos.stage], kb * kBK,
                        n0);
            pos.next(kStages);
          }
    }
    return;
  }

  // consumers: warpgroup wg computes columns [128 wg, 128 wg + 128) of each chunk
  const int wg = warp / 4;
  const uint32_t ring_u32 = smem_u32(ring);
  const int r0 = acc_row(), cq = acc_col();
  RingPos pos;
  mbar_wait(xbar, 0);

  // Run product i with A resident at `a`, calling epi(acc, first column of
  // this warpgroup's 128) per chunk; then publish what the epilogues wrote
  // before the next product reads it.
  auto run = [&](int i, const uint8_t* a, auto epi) {
    const uint32_t a_u32 = smem_u32(a);
    for (int n0 = 0; n0 < prods[i].n; n0 += kChunk) {
      float acc[1][64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[0][j] = 0.0f;
      consume<1>(
          acc, prods[i].k / kBK, full, empty, kStages, pos,
          [&](int kb, int) { return a_u32 + kb * kKBlockBytes; },
          [&](int st) { return ring_u32 + st * kStageBytes + wg * 128 * kLineBytes; });
      epi(acc[0], n0 + wg * 128);
    }
    fence_async_smem();
    consumers_sync();
  };
  // act(acc + bias) [* pad], rounded to bf16, into a swizzled A buffer;
  // with `drop`, each value then kept (times `scale`, rounded again) or zeroed
  auto to_buffer = [&](uint8_t* dst, const bf16* bias, bool masked, const uint8_t* drop) {
    return [=](float(&acc)[64], int c0) {
      const float m0 = masked ? pads[r0] : 1.0f, m1 = masked ? pads[r0 + 8] : 1.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c0 + 8 * j + cq));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float m = hh ? m1 : m0;
          float v0 = activate<ACT>(acc[4 * j + 2 * hh] + bb.x) * m;
          float v1 = activate<ACT>(acc[4 * j + 2 * hh + 1] + bb.y) * m;
          if (drop != nullptr) {
            const int t = t0 + r0 + 8 * hh;
            uint32_t k2 = 0;  // two keep bytes, the lower column in the low byte
            if (t < T)
              k2 = *reinterpret_cast<const uint16_t*>(drop + ((size_t)b * T + t) * ldk + c0 +
                                                      8 * j + cq);
            v0 = (k2 & 0xffu) ? round_bf16(v0) * scale : 0.0f;
            v1 = (k2 >> 8) ? round_bf16(v1) * scale : 0.0f;
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + chunk_offset(r0 + 8 * hh, c0, j, cq)) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    };
  };

  run(0, xbuf, to_buffer(hbuf, summary ? c1 : b1, false, nullptr));
  if (summary) {
    // act(h S2^T + c2) * pad, summed over the tile's 64 rows: per thread over
    // its 2 rows, across the 8 lanes of a column, then over the 4 warps in
    // order through fp32 scratch in the x buffer (free once product 0 is done).
    float* scratch = reinterpret_cast<float*>(xbuf) + wg * 4 * 128;
    const int wq = warp % 4, lane = threadIdx.x & 31;
    run(1, hbuf, [&](float(&acc)[64], int c0) {
      const float p0 = pads[r0], p1 = pads[r0 + 8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(c2 + c0 + 8 * j + cq));
        float s0 = activate<ACT>(acc[4 * j] + bb.x) * p0 + activate<ACT>(acc[4 * j + 2] + bb.x) * p1;
        float s1 =
            activate<ACT>(acc[4 * j + 1] + bb.y) * p0 + activate<ACT>(acc[4 * j + 3] + bb.y) * p1;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (lane < 4) {
          scratch[wq * 128 + 8 * j + cq] = s0;
          scratch[wq * 128 + 8 * j + cq + 1] = s1;
        }
      }
      warpgroup_sync(wg);
      const int t = threadIdx.x % 128;
      const float s = ((scratch[t] + scratch[128 + t]) + scratch[256 + t]) + scratch[384 + t];
      partial[((size_t)b * n_tiles + tile) * OS + c0 + t] = s;
      warpgroup_sync(wg);
    });
  } else {
    run(1, hbuf, to_buffer(xbuf, b2, true, keep));
    run(2, xbuf, [&](float(&acc)[64], int c0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j + cq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + r0 + 8 * hh;
          if (t < T)
            *reinterpret_cast<float2*>(pre + ((size_t)b * T + t) * N + col) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      }
    });
  }
}

constexpr int kPoolCols = 32;

// Valid frames of utterance b: the sum of its pad row, in a fixed order.
__device__ __forceinline__ float pad_count(const float* __restrict__ pad, int T, int b,
                                           float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float cnt = 0.0f;
  for (int t = threadIdx.x; t < T; t += kThreads) cnt += pad[(size_t)b * T + t];
  cnt = warp_sum(cnt);
  if (lane == 0) red[warp] = cnt;
  __syncthreads();
  float count = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) count += red[w];
  return count;
}

// With `scaled` (dropout), no fold: pooled * scale to `pooled_out` [B, OS]
// (by the column-block-0 blocks) and bias = mb; pooled_pass adds the rest.
// With `count_in` (the split route) the count is read from it, else
// counted from pad.
__global__ void __launch_bounds__(kThreads) pool_pass(
    const float* __restrict__ partial, const float* __restrict__ pad, int T, int n_tiles, int OS,
    int N, const bf16* __restrict__ m2, int ldm2, const bf16* __restrict__ mb,
    float* __restrict__ bias, int scaled, float scale, bf16* __restrict__ pooled_out,
    const float* __restrict__ count_in) {
  extern __shared__ __align__(16) float pooled[];  // [OS]
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.y, n_first = blockIdx.x * kPoolCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const float count = fmaxf(count_in != nullptr ? count_in[b] : pad_count(pad, T, b, red), 1.0f);

  for (int o = threadIdx.x; o < OS; o += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < n_tiles; ++i) s += partial[((size_t)b * n_tiles + i) * OS + o];
    pooled[o] = round_bf16(s / count);
    if (scaled && blockIdx.x == 0)
      pooled_out[(size_t)b * OS + o] = __float2bfloat16(pooled[o] * scale);
  }
  if (scaled) {
    for (int n = n_first + threadIdx.x; n < n_first + kPoolCols; n += kThreads)
      bias[(size_t)b * N + n] = bf(mb[n]);
    return;
  }
  __syncthreads();
  // one warp per output column: lanes walk row n of M2 (contiguous)
  for (int n = n_first + warp; n < n_first + kPoolCols; n += kThreads / 32) {
    float acc = 0.0f;
    for (int o = lane; o < OS; o += 32) acc += pooled[o] * bf(m2[(size_t)n * ldm2 + o]);
    acc = warp_sum(acc);
    if (lane == 0) bias[(size_t)b * N + n] = acc + bf(mb[n]);
  }
}

// The split route's reduction: per utterance (block b), the sum of the tile
// partials in tile order -> sum [B, OS], and the valid-frame count -> count [B].
__global__ void __launch_bounds__(kThreads) partial_sum_pass(
    const float* __restrict__ partial, const float* __restrict__ pad, int T, int n_tiles, int OS,
    float* __restrict__ sum, float* __restrict__ count) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  const float c = pad_count(pad, T, b, red);
  if (threadIdx.x == 0) count[b] = c;
  for (int o = threadIdx.x; o < OS; o += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < n_tiles; ++i) s += partial[((size_t)b * n_tiles + i) * OS + o];
    sum[(size_t)b * OS + o] = s;
  }
}

// (d) pre[b, t] (+)= (keep_s[b, t] ? pooled_s[b] : 0) M2^T for the 64 frames
// of a tile; pre on a padded frame is taken as 0 (its local row is zero).
// OS <= kMaxWidth: the masked pooled rows stay resident in one buffer.
__global__ void __launch_bounds__(kCoreThreads, 1) pooled_pass(
    const __grid_constant__ CUtensorMap map_m2, const uint8_t* __restrict__ keep, int ldk,
    int OL, const bf16* __restrict__ pooled, const float* __restrict__ pad, int T, int OS,
    int N, float* __restrict__ pre) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* abuf = smem;
  uint8_t* ring = smem + kBufBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;

  if (warp == kConsumerWarps) {  // producer: every M2 tile in order
    if ((threadIdx.x & 31) == 0) {
      RingPos pos;
      for (int n0 = 0; n0 < N; n0 += kChunk)
        for (int kb = 0; kb < OS / kBK; ++kb) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
          mbar_expect_tx(&full[pos.stage], kStageBytes);
          tma_load_2d(ring + pos.stage * kStageBytes, &map_m2, &full[pos.stage], kb * kBK, n0);
          pos.next(kStages);
        }
    }
    return;
  }

  // the masked pooled rows, 8 columns (16 bytes) per store, in the layout
  // TMA would write
  const int vecs = OS / 8;
  for (int v = threadIdx.x; v < kTile * vecs; v += kConsumerWarps * 32) {
    const int r = v / vecs, c = (v % vecs) * 8, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      const uint2 k8 = *reinterpret_cast<const uint2*>(keep + ((size_t)b * T + t) * ldk + OL + c);
      const uint4 p8 = *reinterpret_cast<const uint4*>(pooled + (size_t)b * OS + c);
      const uint8_t* kb = reinterpret_cast<const uint8_t*>(&k8);
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(&p8);
      uint32_t* vw = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vw[e] = (kb[2 * e] ? (pw[e] & 0xffffu) : 0u) | (kb[2 * e + 1] ? (pw[e] & 0xffff0000u) : 0u);
    }
    *reinterpret_cast<uint4*>(abuf + swizzled_offset(r, c, kTile)) = val;
  }
  fence_async_smem();
  consumers_sync();

  const int wg = warp / 4;
  const uint32_t ring_u32 = smem_u32(ring), a_u32 = smem_u32(abuf);
  const int r0 = acc_row(), cq = acc_col();
  RingPos pos;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    float acc[1][64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[0][j] = 0.0f;
    consume<1>(
        acc, OS / kBK, full, empty, kStages, pos,
        [&](int kb, int) { return a_u32 + kb * kKBlockBytes; },
        [&](int st) { return ring_u32 + st * kStageBytes + wg * 128 * kLineBytes; });
    const int c0 = n0 + wg * 128;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + r0 + 8 * hh;
      if (t >= T) continue;
      const bool valid = pad[(size_t)b * T + t] != 0.0f;
      float* row = pre + ((size_t)b * T + t) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2* p = reinterpret_cast<float2*>(row + c0 + 8 * j + cq);
        const float2 old = valid ? *p : make_float2(0.0f, 0.0f);
        *p = make_float2(old.x + acc[0][4 * j + 2 * hh], old.y + acc[0][4 * j + 2 * hh + 1]);
      }
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads) finish_pass(const float* __restrict__ pre,
                                                        const float* __restrict__ pad,
                                                        const float* __restrict__ bias, int T,
                                                        int N, size_t total, int pre_all,
                                                        bf16* __restrict__ out) {
  const size_t e = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= total) return;
  const size_t row = e / N;
  const int n = (int)(e % N), b = (int)(row / T);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (pre_all || pad[row] != 0.0f) v = *reinterpret_cast<const float4*>(pre + e);
  const float4 bb = *reinterpret_cast<const float4*>(bias + (size_t)b * N + n);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + e);
  o[0] = __floats2bfloat162_rn(activate<ACT>(v.x + bb.x), activate<ACT>(v.y + bb.y));
  o[1] = __floats2bfloat162_rn(activate<ACT>(v.z + bb.z), activate<ACT>(v.w + bb.w));
}

template <int ACT>
static cudaError_t set_attributes() {
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        branch_pass<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBranchSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pooled_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kPooledSmem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  return cudaSuccess;
}

// (a) on x [B, T, D]; with a keep-mask also the M2 map for (d), into *mm2.
template <int ACT>
static cudaError_t launch_branches(const bf16* x, const float* pad, int B, int T, int D, int HL,
                                   int OL, int HS, int OS, int N, const bf16* w1, const bf16* b1,
                                   const bf16* w2, const bf16* b2, const bf16* s1, const bf16* c1,
                                   const bf16* s2, const bf16* c2, const bf16* m1, int ldm1,
                                   const bf16* m2, int ldm2, const uint8_t* keep, float scale,
                                   float* partial, float* pre, CUtensorMap* mm2,
                                   cudaStream_t stream) {
  cudaError_t err = set_attributes<ACT>();
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mw1, mw2, ms1, ms2, mm1;
  const uint64_t xdims[3] = {(uint64_t)D, (uint64_t)T, (uint64_t)B};
  const uint64_t xstrides[2] = {(uint64_t)D * 2, (uint64_t)T * D * 2};
  const uint32_t xbox[3] = {(uint32_t)kBK, (uint32_t)kTile, 1};
  if (!smt_host::bf16_map(&mx, x, 3, xdims, xstrides, xbox) ||
      !smt_host::matrix_map(&mw1, w1, HL, D, D, kChunk) ||
      !smt_host::matrix_map(&mw2, w2, OL, HL, HL, kChunk) ||
      !smt_host::matrix_map(&ms1, s1, HS, D, D, kChunk) ||
      !smt_host::matrix_map(&ms2, s2, OS, HS, HS, kChunk) ||
      !smt_host::matrix_map(&mm1, m1, N, OL, ldm1, kChunk) ||
      (keep != nullptr && !smt_host::matrix_map(mm2, m2, N, OS, ldm2, kChunk)))
    return cudaErrorInvalidValue;
  const int n_tiles = (T + kTile - 1) / kTile;
  branch_pass<ACT><<<dim3(n_tiles, B, 2), kCoreThreads, kBranchSmem, stream>>>(
      mx, mw1, mw2, ms1, ms2, mm1, pad, T, D, HL, OL, HS, OS, N, b1, b2, c1, c2, keep, OL + OS,
      scale, partial, pre);
  return cudaSuccess;
}

template <int ACT>
static void launch_finish_pass(const float* pre, const float* pad, const float* bias, int B,
                               int T, int N, int pre_all, bf16* out, cudaStream_t stream) {
  const size_t total = (size_t)B * T * N;
  finish_pass<ACT><<<(unsigned)((total / 4 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      pre, pad, bias, T, N, total, pre_all, out);
}

template <int ACT>
static cudaError_t launch(const bf16* x, const float* pad, int B, int T, int D, int HL, int OL,
                          int HS, int OS, int N, const bf16* w1, const bf16* b1, const bf16* w2,
                          const bf16* b2, const bf16* s1, const bf16* c1, const bf16* s2,
                          const bf16* c2, const bf16* m1, int ldm1, const bf16* m2, int ldm2,
                          const bf16* mb, const uint8_t* keep, float scale, float* partial,
                          float* bias, bf16* pooled, float* pre, bf16* out, cudaStream_t stream) {
  if (keep != nullptr && OS > kMaxWidth) return cudaErrorInvalidValue;
  CUtensorMap mm2;
  cudaError_t err = launch_branches<ACT>(x, pad, B, T, D, HL, OL, HS, OS, N, w1, b1, w2, b2, s1,
                                         c1, s2, c2, m1, ldm1, m2, ldm2, keep, scale, partial,
                                         pre, &mm2, stream);
  if (err != cudaSuccess) return err;
  const int n_tiles = (T + kTile - 1) / kTile;
  pool_pass<<<dim3(N / kPoolCols, B), kThreads, OS * sizeof(float), stream>>>(
      partial, pad, T, n_tiles, OS, N, m2, ldm2, mb, bias, keep != nullptr, scale, pooled,
      nullptr);
  if (keep != nullptr)
    pooled_pass<<<dim3(n_tiles, B), kCoreThreads, kPooledSmem, stream>>>(
        mm2, keep, OL + OS, OL, pooled, pad, T, OS, N, pre);
  launch_finish_pass<ACT>(pre, pad, bias, B, T, N, keep != nullptr, out, stream);
  return cudaGetLastError();
}

// The split route's first half: (a), then each utterance's sum [B, OS] and count [B].
template <int ACT>
static cudaError_t launch_partial(const bf16* x, const float* pad, int B, int T, int D, int HL,
                                  int OL, int HS, int OS, int N, const bf16* w1, const bf16* b1,
                                  const bf16* w2, const bf16* b2, const bf16* s1, const bf16* c1,
                                  const bf16* s2, const bf16* c2, const bf16* m1, int ldm1,
                                  float* partial, float* sum, float* count, float* pre,
                                  cudaStream_t stream) {
  cudaError_t err = launch_branches<ACT>(x, pad, B, T, D, HL, OL, HS, OS, N, w1, b1, w2, b2, s1,
                                         c1, s2, c2, m1, ldm1, nullptr, 0, nullptr, 1.0f,
                                         partial, pre, nullptr, stream);
  if (err != cudaSuccess) return err;
  partial_sum_pass<<<B, kThreads, 0, stream>>>(partial, pad, T, (T + kTile - 1) / kTile, OS, sum,
                                               count);
  return cudaGetLastError();
}

// The split route's second half, on the sums and counts reduced over the shards.
template <int ACT>
static cudaError_t launch_finish(const float* pre, const float* pad, int B, int T, int OS, int N,
                                 const bf16* m2, int ldm2, const bf16* mb, const float* sum,
                                 const float* count, float* bias, bf16* out,
                                 cudaStream_t stream) {
  pool_pass<<<dim3(N / kPoolCols, B), kThreads, OS * sizeof(float), stream>>>(
      sum, pad, T, 1, OS, N, m2, ldm2, mb, bias, 0, 1.0f, nullptr, count);
  launch_finish_pass<ACT>(pre, pad, bias, B, T, N, 0, out, stream);
  return cudaGetLastError();
}

}  // namespace smt

extern "C" int sm_forward(const void* x, const void* pad, int B, int T, int D, int HL, int OL,
                          int HS, int OS, int N, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* s1, const void* c1, const void* s2,
                          const void* c2, const void* m1, const void* m2, int ldm1,
                          const void* mb, int ldm2, const void* keep, float scale,
                          void* partial, void* bias, void* pooled, void* pre, void* out, int act,
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
                 (const uint8_t*)keep, scale, (float*)partial, (float*)bias, (bf16*)pooled,
                 (float*)pre, (bf16*)out, (cudaStream_t)stream);
}

extern "C" int sm_partial(const void* x, const void* pad, int B, int T, int D, int HL, int OL,
                          int HS, int OS, int N, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* s1, const void* c1, const void* s2,
                          const void* c2, const void* m1, int ldm1, void* partial, void* sum,
                          void* count, void* pre, int act, void* stream) {
  using smt::bf16;
  auto fn = act == smt::ACT_GELU_ERF ? smt::launch_partial<smt::ACT_GELU_ERF>
          : act == smt::ACT_GELU_TANH ? smt::launch_partial<smt::ACT_GELU_TANH>
                                      : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn((const bf16*)x, (const float*)pad, B, T, D, HL, OL, HS, OS, N,
                 (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                 (const bf16*)s1, (const bf16*)c1, (const bf16*)s2, (const bf16*)c2,
                 (const bf16*)m1, ldm1, (float*)partial, (float*)sum, (float*)count, (float*)pre,
                 (cudaStream_t)stream);
}

extern "C" int sm_finish(const void* pre, const void* pad, int B, int T, int OS, int N,
                         const void* m2, int ldm2, const void* mb, const void* sum,
                         const void* count, void* bias, void* out, int act, void* stream) {
  using smt::bf16;
  auto fn = act == smt::ACT_GELU_ERF ? smt::launch_finish<smt::ACT_GELU_ERF>
          : act == smt::ACT_GELU_TANH ? smt::launch_finish<smt::ACT_GELU_TANH>
                                      : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn((const float*)pre, (const float*)pad, B, T, OS, N, (const bf16*)m2, ldm2,
                 (const bf16*)mb, (const float*)sum, (const float*)count, (float*)bias,
                 (bf16*)out, (cudaStream_t)stream);
}
