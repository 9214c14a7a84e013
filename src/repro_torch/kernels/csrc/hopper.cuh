// Device and host helpers of the Hopper (sm_90a) designs: mbarriers, TMA
// loads, wgmma shared-memory descriptors and fences, and TMA tensor maps
// encoded on the host and kept for the next launch with the same operand.
// Shared by csrc/mpgemm_wgmma.cu (K1, bf16 and int8) and
// csrc/flash_attention_wgmma.cu (K4); each source compiles on its own into
// a library, so each holds its own map cache.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A wait that outlasts ~2^34 cycles (seconds; a tile takes microseconds)
// traps, so that a broken pipeline fails its launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One TMA load of a box at coordinates (c0 inner, c1 rows, c2 group) into
// shared memory; its bytes complete on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory writes of this thread (the generic proxy) made visible to
// wgmma and TMA (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over the first `threads` threads of the block (id 1; id 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// A shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (the libraries link no libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// What a map encodes: a contiguous (groups, rows, inner) tensor of
// `elem_bytes`-byte elements (2: bf16, 1: 8-bit), boxes of (box_inner,
// box_rows, 1), the 128-byte swizzle or none, zero fill out of bounds.
struct MapKey {
  const void* ptr;
  uint64_t inner, rows, groups;
  uint32_t box_inner, box_rows, elem_bytes, swizzle;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && rows == o.rows &&
           groups == o.groups && box_inner == o.box_inner &&
           box_rows == o.box_rows && elem_bytes == o.elem_bytes &&
           swizzle == o.swizzle;
  }
};

inline bool encode_map(CUtensorMap* map, const MapKey& k) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {k.inner, k.rows, k.groups};
  const cuuint64_t strides[2] = {k.inner * k.elem_bytes,
                                 k.inner * k.rows * k.elem_bytes};
  const cuuint32_t box[3] = {k.box_inner, k.box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                k.elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                3, const_cast<void*>(k.ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                k.swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encoded maps, kept by everything a map encodes (the strides follow from
// the extents), so that a kept map is the one encode_map would make.
// Serving and training call the same shapes on the same weights and reused
// activation buffers every step, and an encode costs microseconds of host
// time a launch.
struct MapEntry {
  MapKey key;
  CUtensorMap map;
  bool used;
};
constexpr int kMapCache = 1024;   // direct-mapped; a miss re-encodes
inline MapEntry map_cache[kMapCache];
inline std::mutex map_mutex;      // ctypes calls run without the GIL

// A 3-D map of a contiguous (groups, rows, inner) tensor: boxes of
// (box_inner, box_rows), 128-byte swizzle unless `swizzle` is false.
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                     uint64_t rows, uint64_t groups, uint32_t box_inner,
                     uint32_t box_rows, uint32_t elem_bytes = 2,
                     bool swizzle = true) {
  const MapKey key{ptr, inner, rows, groups, box_inner, box_rows,
                   elem_bytes, swizzle ? 1u : 0u};
  const uint64_t h = (reinterpret_cast<uintptr_t>(ptr) >> 4) ^
                     (inner * 0x9E3779B97F4A7C15ull) ^ (rows << 17) ^
                     (groups << 33) ^ (box_rows << 3) ^
                     (static_cast<uint64_t>(box_inner) << 45) ^
                     (elem_bytes << 1) ^ key.swizzle;
  MapEntry& slot = map_cache[(h ^ (h >> 29)) % kMapCache];
  std::lock_guard<std::mutex> lock(map_mutex);
  if (slot.used && slot.key == key) {
    *map = slot.map;
    return true;
  }
  if (!encode_map(map, key)) return false;
  slot = MapEntry{key, *map, true};
  return true;
}

}  // namespace hopper
