// The Hopper product core shared by both kernels: C = A * W^T with bf16
// operands and fp32 accumulators in registers, on `wgmma.mma_async`
// (m64n128k16), fed by TMA (`cp.async.bulk.tensor`, 128-byte swizzle) through
// a ring of shared-memory stages guarded by `mbarrier`s.
//
// Roles inside a block of kCoreThreads threads: warps 0-7 are two consumer
// warpgroups that issue the products and run the epilogues; warp 8 is the
// producer, whose lane 0 keeps the ring full with TMA loads. A stage is
// released by one arrive per warp that read it.
//
// Shared-memory operands are K-major tiles of 64 bf16 per row (one 128-byte
// swizzle line), rows in groups of 8 lines (1024 bytes). The wgmma matrix
// descriptor for such a tile is `smem_desc(addr)`; a step of 16 along K
// inside the tile adds 32 bytes to the address. An epilogue that writes a
// tile the next product reads as its A operand stores through
// `swizzled_offset`, the same layout TMA writes. An operand stored with its
// M or N index contiguous (a token-major activation read transposed, for a
// weight gradient) is read MN-major instead: each 128-byte line holds 64
// consecutive M or N values of one K row, `smem_desc_mn(addr, group)`
// describes it, and a step of 16 along K is 16 lines down.
//
// Weights are in torch.nn.Linear's layout, W[n][k], which is the K-major B
// operand of wgmma with no transpose. The host side encodes tensor maps with
// cuTensorMapEncodeTiled, looked up in the libcuda the process has already
// loaded (no link-time dependency), and caches them by their arguments.
#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <string.h>

#include <string>
#include <unordered_map>

#include "common.cuh"

namespace smt {

constexpr int kConsumerWarps = 8;
constexpr int kCoreThreads = kConsumerWarps * 32 + 32;  // + one producer warp
constexpr int kBK = 64;                  // K depth of a stage: one swizzle line of bf16
constexpr int kLineBytes = kBK * 2;      // 128

// ---------------------------------------------------------------- PTX pieces
// Swizzled tiles must start on a 1024-byte boundary of shared memory.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// more than 2^32 cycles (seconds) is a broken pipeline: trap, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA store of a swizzled shared tile to device memory; rows and columns
// outside the tensor are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's committed TMA stores have read their shared source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Make generic-proxy writes to shared memory visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier over the two consumer warpgroups (the producer never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}
// Named barrier over one consumer warpgroup (ids 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled tile at shared address
// `addr` (8-line groups 1024 bytes apart).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma descriptor of a 128-byte-swizzled tile read MN-major: each 128-byte
// line holds 64 consecutive M or N values of one K row, 8 K rows make a
// 1024-byte group (the stride between K groups), and the next 64 M or N
// values start `mn_group_bytes` further on.
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t mn_group_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(mn_group_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of the 16-deep K step `kk` of a stage's operand tile at `addr`:
// K-major, 32 bytes along the lines; MN-major (`MN`), 16 lines down, its
// 64-wide M or N groups 64 lines (8 KB) apart, as a stage's two TMA boxes lie.
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr, int kk) {
  if constexpr (MN) return smem_desc_mn(addr + kk * 16 * kLineBytes, 64 * kLineBytes);
  return smem_desc(addr + kk * 32);
}

// Byte offset of element (r, c) in a [rows x 64*kb] K-major operand held as
// k-blocks of `rows` swizzled lines each (block stride rows * 128 bytes).
__device__ __forceinline__ uint32_t swizzled_offset(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * kLineBytes + r * kLineBytes +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// d (+)= A * B for a 64 x 128 tile; TA, TB: the operand is read MN-major.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The accumulator of one m64n128 product, as wgmma leaves it: register i of
// a thread holds row (acc_row + 8 * ((i >> 1) & 1)) and column
// (8 * (i >> 2) + acc_col + (i & 1)) of the warpgroup's 64 x 128 tile.
__device__ __forceinline__ int acc_row() { return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2); }
__device__ __forceinline__ int acc_col() { return (threadIdx.x & 3) * 2; }

// Ring state of one role: stage index and the parity it waits on.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  __device__ __forceinline__ void advance(int n, int stages) {
    for (int i = 0; i < n; ++i) next(stages);
  }
};

// One consumer warpgroup's product over `kblocks` stages of the ring:
// acc[h] = sum_kb A_kb[64h : 64h + 64] * B_kb^T for MH row blocks of 64 and
// 128 output columns. `a_addr(kb, stage)` and `b_addr(stage)` give the
// shared addresses of this warpgroup's A tile (MH * 64 lines) and 128-line
// B tile; with TA or TB that operand is read MN-major, as two 64-line boxes
// 8 KB apart. Each stage is
// released (one arrive per warp) once the products that read it are
// complete; the next stage's products are in flight meanwhile.
template <int MH, bool TA = false, bool TB = false, class AAddr, class BAddr>
__device__ __forceinline__ void consume(float (&acc)[MH][64], int kblocks, uint64_t* full,
                                        uint64_t* empty, int stages, RingPos& pos, AAddr a_addr,
                                        BAddr b_addr) {
  const bool signal = (threadIdx.x & 31) == 0;
  int prev = -1;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&full[pos.stage], pos.phase);
    const uint32_t a = a_addr(kb, pos.stage), b = b_addr(pos.stage);
#pragma unroll
    for (int h = 0; h < MH; ++h) fence_acc(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < MH; ++h)
        wgmma_m64n128<TA, TB>(acc[h], operand_desc<TA>(a + h * 64 * kLineBytes, kk),
                              operand_desc<TB>(b, kk), (kb | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int h = 0; h < MH; ++h) fence_acc(acc[h]);
    if (prev >= 0 && signal) mbar_arrive(&empty[prev]);
    prev = pos.stage;
    pos.next(stages);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < MH; ++h) fence_acc(acc[h]);
  if (prev >= 0 && signal) mbar_arrive(&empty[prev]);
}

}  // namespace smt

// ------------------------------------------------------------- host side
namespace smt_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor map of `rank` (2 or 3) dimensions, innermost first, with
// 128-byte swizzle and zero fill out of bounds. `strides` are the byte
// strides of dimensions 1.. (a multiple of 16). Maps are cached by their
// arguments, so a weight's map is encoded once. Returns false on failure.
inline bool bf16_map(CUtensorMap* out, const void* base, int rank, const uint64_t* dims,
                     const uint64_t* strides, const uint32_t* box) {
  struct Key {
    const void* base;
    int rank;
    uint64_t dims[3], strides[2];
    uint32_t box[3];
  } key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) key.dims[i] = dims[i], key.box[i] = box[i];
  for (int i = 0; i + 1 < rank; ++i) key.strides[i] = strides[i];
  static std::unordered_map<std::string, CUtensorMap> cache;
  std::string k(reinterpret_cast<const char*>(&key), sizeof(key));
  auto it = cache.find(k);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base),
                  (const cuuint64_t*)dims, (const cuuint64_t*)strides, (const cuuint32_t*)box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  if (cache.size() > 4096) cache.clear();
  cache.emplace(std::move(k), *out);
  return true;
}

// [rows x cols] bf16 matrix with a row stride of `ld` elements, read in
// boxes of [box_rows x 64].
inline bool matrix_map(CUtensorMap* out, const void* base, int rows, int cols, int ld,
                       int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * 2};
  const uint32_t box[2] = {(uint32_t)smt::kBK, (uint32_t)box_rows};
  return bf16_map(out, base, 2, dims, strides, box);
}

}  // namespace smt_host
