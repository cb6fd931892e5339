// RelPosMHAXL's attention (Transformer-XL relative positions) fused for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA. It is
// added because the plain PyTorch path writes float32 [B, H, T, T] and
// [B, H, T, 2T-1] tensors to device memory some fifteen times a call, while
// the work itself is small. Bound on the H100: operations. The function needs
// three products of T x T x hd per (utterance, head): content, the rel_shift
// band of the position scores, and value; at B=4, H=8, hd=64, T=3,000 that is
// 1.11e11 operations, 0.112 ms at 989 TFLOP/s (this design computes the
// position scores over 2T-1 columns, 1.47e11 operations in all); the inputs
// and the output are about 55 MB, 0.017 ms at 3.35 TB/s.
//
// out[b, t, h] = sum_s softmax_s(score[t, s]) v[b, s, h], with
//   score[t, s] = ((q+u)[t] . k[s] + (q+v)[t] . p[T-1-t+s]) / sqrt(hd)
// over the keys s with mask[b, s] > 0 (every key without a mask; and s <= t
// when causal); a row with no such key attends uniformly over all T keys, as
// the plain path's all-masked softmax does. q+u and q+v are rounded to bf16
// as the plain version's bf16 add rounds them; products take bf16 operands
// and accumulate in fp32; the softmax is fp32; the probabilities are rounded
// to bf16 for the product with v.
//
// Design: a block per (128 queries, head, utterance); warps 0-7 are two
// consumer warpgroups of 64 queries each, warp 8 the producer, whose lane 0
// loads the q tile once and then, per tile of 64 keys, the k and v tiles
// and the 192 rows of p that both warpgroups' position scores read, by TMA
// through a ring of stages guarded by mbarriers. Each warpgroup first makes
// its rows of q+u and q+v in shared memory. Per tile a warpgroup runs
// the content product (q+u) k^T as m64n64 and the position product over its
// 128-row window of p, (q+v) p_win^T, as m64n128 on wgmma; each warp stages
// its 16 rows of position scores in shared memory and reads each row's band
// at offset 63 - r (the rel_shift); then an online softmax with a running max
// and sum in registers, the probabilities packed to bf16 in registers as the
// A operand of the m64n64 product with v (v's tile read MN-major). No score
// or probability reaches device memory. The key mask arrives as the [B, T]
// float32 pad mask, any pattern: each block first turns its utterance's row
// into one bit a key in shared memory (and finds the first and last allowed
// key), loads only the key tiles between them (and, when causal, up to the
// block's last query), and masks only in a tile whose 64 bits are not all
// set or that crosses the causal diagonal.
//
// C interface: relpos_attention_forward(...) takes a null mask for no pad
// mask; returns 0, a CUDA error after the launch (or when T's key bits do not
// fit in shared memory), or cudaErrorInvalidValue when a tensor map cannot
// be encoded.

#include "gemm_sm90.cuh"

namespace smt {

constexpr int kHeadDim = 64;                   // one 128-byte swizzle line of bf16
constexpr int kBQ = 128;                       // queries per block: 64 per warpgroup
constexpr int kBKV = 64;                       // keys per tile
constexpr int kWin = kBQ + kBKV;               // p rows a tile needs: 191, loaded as 192
constexpr int kRelStages = 2;
constexpr int kPosLd = 136;                    // staged row stride in floats (conflict-free stores)
constexpr uint32_t kQBytes = kBQ * kLineBytes;             // 16 KB
constexpr uint32_t kKVBytes = kBKV * kLineBytes;           // 8 KB
constexpr uint32_t kRelStageBytes = 2 * kKVBytes + kWin * kLineBytes;  // k, v, p window: 40 KB
// then the key bits, one 64-bit word a key tile: (T + 63) / 64 words more
constexpr size_t kRelSmem = 2 * kQBytes + (size_t)kRelStages * kRelStageBytes +
                            (size_t)kConsumerWarps * 16 * kPosLd * 4 + (2 * kRelStages + 1) * 8 +
                            1024;

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A * B with A (64 x 16, bf16) in registers, in the accumulator layout
// of an m64nN product, and B read MN-major (transposed) from shared memory.
__device__ __forceinline__ void wgmma_m64n64_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x in one MUFU instruction (relative error about 2^-22; results below
// 2^-126 flush to 0, far under the bf16 rounding of the probabilities).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q, k, v: [B, T, H*64] through 3-D maps (columns, frames, utterances;
// frames past T load as zero); p: [2T-1, H*64] through a 2-D map, rows outside
// it (a window that starts before row 0 or ends past 2T-2) load as zero: they
// meet only queries or keys outside [0, T). pos_u, pos_v: the biases [H, 64]
// in bf16. out: [B, T, H*64] bf16.
__global__ void __launch_bounds__(kCoreThreads, 1) relpos_attention(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_p,
    const bf16* __restrict__ pos_u, const bf16* __restrict__ pos_v,
    const float* __restrict__ mask, int T, int H, int causal_flag, float scale,
    bf16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem + 2 * kQBytes;  // q+u and q+v first (q arrives in the second), 128 rows each
  float* pos_stage = reinterpret_cast<float*>(ring + kRelStages * kRelStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(pos_stage + kConsumerWarps * 16 * kPosLd);
  uint64_t* empty = full + kRelStages;
  uint64_t* qbar = empty + kRelStages;
  uint64_t* key_bits = qbar + 1;  // bit c of word i: key 64 i + c is allowed (0 past T)
  __shared__ int key_first, key_last, key_count;  // of the utterance's allowed keys
  const int t0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRelStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // one arrive per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
    key_first = T;
    key_last = -1;
    key_count = 0;
  }
  __syncthreads();
  if (warp == kConsumerWarps && lane == 0) {  // q arrives while the keys are scanned
    mbar_expect_tx(qbar, kQBytes);
    tma_load_3d(smem + kQBytes, &map_q, qbar, h * kHeadDim, t0, b);
  }
  {  // each warp turns 32 keys at a time into a 32-bit half of a word
    int first = T, last = -1, count = 0;
    for (int w = warp; w < 2 * ((T + kBKV - 1) / kBKV); w += kCoreThreads / 32) {
      const int s = 32 * w + lane;
      const uint32_t bits =
          __ballot_sync(0xffffffffu, s < T && (mask == nullptr || mask[(size_t)b * T + s] > 0.0f));
      if (lane == 0) {
        reinterpret_cast<uint32_t*>(key_bits)[w] = bits;
        if (bits) {
          first = min(first, 32 * w + __ffs(bits) - 1);
          last = 32 * w + 31 - __clz(bits);
          count += __popc(bits);
        }
      }
    }
    if (lane == 0) {
      atomicMin(&key_first, first);
      atomicMax(&key_last, last);
      atomicAdd(&key_count, count);
    }
  }
  __syncthreads();
  // A row with no allowed key (or, causal, none up to its own position)
  // attends over every key with equal scores; a block holding such a row
  // visits them all.
  const bool causal = causal_flag != 0;
  bool some_empty;
  int tile_lo, tile_hi;
  {
    const int count = key_count, first = key_first, last = key_last;
    some_empty = count == 0 || (causal && t0 < first);
    tile_lo = some_empty ? 0 : first / kBKV;
    const int kv_end = some_empty ? T : causal ? min(last + 1, t0 + kBQ) : last + 1;
    tile_hi = (kv_end + kBKV - 1) / kBKV;
  }

  if (warp == kConsumerWarps) {  // producer
    if (lane == 0) {
      RingPos pos;
      for (int i = tile_lo; i < tile_hi; ++i) {
        const int s0 = i * kBKV;
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        mbar_expect_tx(&full[pos.stage], kRelStageBytes);
        uint8_t* st = ring + pos.stage * kRelStageBytes;
        tma_load_3d(st, &map_k, &full[pos.stage], h * kHeadDim, s0, b);
        tma_load_3d(st + kKVBytes, &map_v, &full[pos.stage], h * kHeadDim, s0, b);
        // rows T-1-(t0+127)+s0 .. T-1-t0+s0+63 of p: both warpgroups' windows
        tma_load_2d(st + 2 * kKVBytes, &map_p, &full[pos.stage], h * kHeadDim,
                    T - kBQ - t0 + s0);
        pos.next(kRelStages);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns queries t0 + 64 wg .. + 63; this thread
  // holds rows r and r + 8 of them (r = 16 lw + quad) and, of each 8-column
  // group of a tile, the columns qc and qc + 1
  const int wg = warp / 4, lw = warp % 4, quad = lane >> 2, qc = (lane & 3) * 2;
  const int r0 = lw * 16 + quad;
  const int tq = t0 + wg * 64 + r0;
  const uint32_t qu_addr = smem_u32(smem) + wg * 64 * kLineBytes;
  const uint32_t qv_addr = smem_u32(smem + kQBytes) + wg * 64 * kLineBytes;
  // warpgroup wg's window of p starts 64 (1 - wg) rows into the staged 192
  const uint32_t win_off = 2 * kKVBytes + (1 - wg) * 64 * kLineBytes;
  float* wst = pos_stage + warp * 16 * kPosLd;  // this warp's 16 rows of position scores
  const float scale_log2 = scale * 1.4426950408889634f;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  mbar_wait(qbar, 0);
  {  // q+u and q+v in bf16 (the sum rounded once, as the plain version's bf16
     // add), 16-byte chunks of this warpgroup's 64 rows in the swizzled
     // layout: physical chunk pc of row r holds columns 8 (pc ^ (r & 7)) + 0..7
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int i = tid; i < 64 * 8; i += 128) {
      const int r = wg * 64 + i / 8, pc = i % 8, c0 = 8 * (pc ^ (r & 7));
      uint4* qv_chunk = reinterpret_cast<uint4*>(smem + kQBytes + r * kLineBytes + pc * 16);
      const uint4 qraw = *qv_chunk;
      const uint4 uraw = *reinterpret_cast<const uint4*>(pos_u + h * kHeadDim + c0);
      const uint4 vraw = *reinterpret_cast<const uint4*>(pos_v + h * kHeadDim + c0);
      const bf16* q8 = reinterpret_cast<const bf16*>(&qraw);
      const bf16* u8 = reinterpret_cast<const bf16*>(&uraw);
      const bf16* v8 = reinterpret_cast<const bf16*>(&vraw);
      uint4 qu, qv;
      uint32_t* qu2 = reinterpret_cast<uint32_t*>(&qu);
      uint32_t* qv2 = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qu2[e] = pack_bf16(bf(q8[2 * e]) + bf(u8[2 * e]), bf(q8[2 * e + 1]) + bf(u8[2 * e + 1]));
        qv2[e] = pack_bf16(bf(q8[2 * e]) + bf(v8[2 * e]), bf(q8[2 * e + 1]) + bf(v8[2 * e + 1]));
      }
      *reinterpret_cast<uint4*>(smem + r * kLineBytes + pc * 16) = qu;
      *qv_chunk = qv;
    }
    fence_async_smem();  // the products read them through the async proxy
    warpgroup_sync(wg);
  }
  RingPos pos;
  for (int it = tile_lo; it < tile_hi; ++it) {
    const int s0 = it * kBKV;
    mbar_wait(&full[pos.stage], pos.phase);
    const uint32_t st = smem_u32(ring + pos.stage * kRelStageBytes);
    float sc[32], sp[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      wgmma_m64n64(sc, smem_desc(qu_addr + kk * 32), smem_desc(st + kk * 32), kk);
      wgmma_m64n128(sp, smem_desc(qv_addr + kk * 32), smem_desc(st + win_off + kk * 32), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(sp);

    // stage the position scores: local row quad + 8 hh, window column 8 j + qc
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(wst + (quad + 8 * hh) * kPosLd + 8 * j + qc) =
            make_float2(sp[4 * j + 2 * hh], sp[4 * j + 2 * hh + 1]);
    __syncwarp();
    // score = (content + position) / sqrt(hd), kept in log2 units (times
    // log2 e, exact with the power-of-2 scale) for ex2; row r reads window
    // column 63 - r + c. Only a tile with a key not allowed, or reaching
    // (causal) past the warpgroup's first query, or in a block with a row
    // with no key, masks anything.
    const uint64_t bits = key_bits[it];
    const bool edge = some_empty || bits != ~0ull || (causal && s0 + kBKV - 1 > t0 + wg * 64);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lr = quad + 8 * hh, c = 8 * j + qc + e;
          float& x = sc[4 * j + 2 * hh + e];
          x = (x + wst[lr * kPosLd + 63 - lw * 16 - lr + c]) * scale_log2;
        }
    if (edge) {
      const int count = key_count, first = key_first;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // row t attends to the allowed keys (up to t when causal); with
        // none, to all T keys equally
        const int t = tq + 8 * hh;
        const bool row_empty = count == 0 || (causal && t < first);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + qc + e, key = s0 + c;
            float& x = sc[4 * j + 2 * hh + e];
            if (row_empty)
              x = key < T ? 0.0f : -INFINITY;
            else if (!((bits >> c) & 1u) || (causal && key > t))
              x = -INFINITY;
          }
      }
    }
    __syncwarp();  // the stage is read before the next tile overwrites it

    // online softmax over the tile; rows are shared by the 4 lanes of a quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float base = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = ex2(m[hh] - base);
      m[hh] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = ex2(sc[4 * j + 2 * hh + e] - base);
          sc[4 * j + 2 * hh + e] = pr;
          sum += pr;
        }
      l[hh] = l[hh] * corr + sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 2 * hh] *= corr;
        o[4 * j + 2 * hh + 1] *= corr;
      }
    }

    // o += P v: P's accumulator layout is the A operand's register layout
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) a[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      // v read MN-major; N = 64 is one group, so its group stride is moot
      wgmma_m64n64_rs_mn(o, a[kk], smem_desc_mn(st + kKVBytes + kk * 16 * kLineBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    if (lane == 0) mbar_arrive(&empty[pos.stage]);
    pos.next(kRelStages);
  }

  // out = o / l in bf16, rows inside [0, T) only
  const int D = H * kHeadDim;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float tot = l[hh];
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    const int t = tq + 8 * hh;
    if (t < T) {
      bf16* row = out + ((size_t)b * T + t) * D + h * kHeadDim;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + qc) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] / tot, o[4 * j + 2 * hh + 1] / tot);
    }
  }
}

}  // namespace smt

extern "C" int relpos_attention_forward(const void* q, const void* k, const void* v,
                                        const void* p, const void* pos_u, const void* pos_v,
                                        const void* mask, int B, int T, int H, int causal,
                                        float scale, void* out, void* stream) {
  using namespace smt;
  const size_t smem = kRelSmem + (size_t)(T + kBKV - 1) / kBKV * 8;
  static size_t allowed = 0;  // the dynamic shared memory the kernel is set up for
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        relpos_attention, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const uint64_t D = (uint64_t)H * kHeadDim;
  const uint64_t dims[3] = {D, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[2] = {D * 2, (uint64_t)T * D * 2};
  const uint32_t q_box[3] = {(uint32_t)kHeadDim, (uint32_t)kBQ, 1};
  const uint32_t kv_box[3] = {(uint32_t)kHeadDim, (uint32_t)kBKV, 1};
  const uint64_t p_dims[2] = {D, (uint64_t)(2 * T - 1)};
  const uint32_t p_box[2] = {(uint32_t)kHeadDim, (uint32_t)kWin};
  CUtensorMap map_q, map_k, map_v, map_p;
  if (!smt_host::bf16_map(&map_q, q, 3, dims, strides, q_box) ||
      !smt_host::bf16_map(&map_k, k, 3, dims, strides, kv_box) ||
      !smt_host::bf16_map(&map_v, v, 3, dims, strides, kv_box) ||
      !smt_host::bf16_map(&map_p, p, 2, p_dims, strides, p_box))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  relpos_attention<<<grid, kCoreThreads, smem, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, map_p, (const bf16*)pos_u, (const bf16*)pos_v, (const float*)mask,
      T, H, causal, scale, (bf16*)out);
  return (int)cudaGetLastError();
}
