// Device and host helpers of the Hopper (sm_90a) designs: mbarriers, TMA
// loads, wgmma shared-memory descriptors and fences, TMA tensor maps
// encoded on the host and kept for the next launch with the same operand,
// the tf32 split and tf32 wgmma of 3xTF32, and attention's key ranges
// and masks.
// Shared by csrc/mpgemm_wgmma.cu, mpgemm_wgmma_int8.cu and
// mpgemm_wgmma_f32.cu (K1), mpgemm_packed_wgmma.cu and
// mpgemm_packed_wgmma_int8.cu (K2), mpgemm_sparse_wgmma.cu and
// mpgemm_sparse_wgmma_int8.cu (K3), csrc/flash_attention_wgmma.cu (K4,
// K5) and flash_attention_tf32x3.cu (K4 f32); each source compiles on its
// own into a library, so each holds its own map cache.
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

// One bulk copy of `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) from device memory into shared memory, no
// tensor map; its bytes complete on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
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
// `elem_bytes`-byte elements (4: f32, 2: bf16, 1: 8-bit), boxes of (box_inner,
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
                k.elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : k.elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
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

// ------------------------------------------- 3xTF32 (K1 f32, K4 f32)

// x = hi + lo + r: hi = x rounded to tf32 (to nearest, ties away), lo =
// the rest rounded to tf32; |r| <= 2^-22 |x|.  hi * hi + hi * lo + lo * hi
// on the tensor cores then misses a product by about 2^-21 of it (the
// dropped lo * lo and the two r terms), where one tf32 product misses by
// 2^-11.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  hi = __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(__fsub_rn(x, hi)));
  lo = __uint_as_float(l);
}

// An f32 tile of kBytes (a K-major tile as TMA wrote it, swizzled or not:
// the split is elementwise): each value's hi term in place, its lo term at
// the same offset of `lo`.
template <int kBytes, int kThreads>
__device__ __forceinline__ void split_in_place(uint8_t* tile, uint8_t* lo,
                                               int tid) {
  static_assert(kBytes % (16 * kThreads) == 0, "whole 16-byte chunks");
#pragma unroll
  for (int i = 0; i < kBytes / (16 * kThreads); ++i) {
    const int off = (tid + i * kThreads) * 16;
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    float4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<float4*>(tile + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// d += A (64 x 8) * B (8 x N), tf32 in (f32 words whose low 13 bits are
// zero: split_tf32's terms), f32 accumulators; both operands read K-major
// from shared memory (the only form wgmma takes for tf32); N = 128 (d[64]),
// 64 (d[32]) or 32 (d[16]).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += A (64 x 8, registers: rows r and r + 8, columns c and c + 4 of
// quad lane c, in the order (r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4))
// * B (8 x 64, shared, K-major), tf32 in, f32 sums.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// --------------------------------------------- attention (K4, K5)

// Is key j visible to query position qi (j <= j_hi, the last key of the
// block's range, already holds j < the live keys)?
__device__ __forceinline__ bool visible(int j, int j_hi, int qi, int causal,
                                        int window) {
  return j <= j_hi && (!causal || j <= qi) && (window <= 0 || j > qi - window);
}

// The keys [j_lo, j_hi] any of the folded rows [r_lo, r_hi] can see, of
// n_keys live keys, when row r sits at position r % Tq + qi_off (K4: Tk -
// Tq, right-aligned; K5: q_start[b]).
__device__ __forceinline__ void key_range(int r_lo, int r_hi, int Tq,
                                          int n_keys, int qi_off, int causal,
                                          int window, int& j_lo, int& j_hi) {
  // Folded rows past one head's Tq wrap around to t = 0.
  const int t_lo = r_hi - r_lo + 1 >= Tq ? 0 : r_lo % Tq;
  const int t_hi = r_hi - r_lo + 1 >= Tq ? Tq - 1 : r_hi % Tq;
  const bool wraps = t_hi < t_lo;
  const int qi_lo = (wraps ? 0 : t_lo) + qi_off;
  const int qi_hi = (wraps ? Tq - 1 : t_hi) + qi_off;
  j_lo = 0;
  j_hi = n_keys - 1;
  if (causal) j_hi = min(j_hi, qi_hi);
  if (window > 0) j_lo = max(0, qi_lo - window + 1);
}

}  // namespace hopper
