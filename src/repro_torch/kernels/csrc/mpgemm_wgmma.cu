// K1 for bf16 operands on Hopper's tensor cores: the dense MPGEMM with a
// fused epilogue, 2-D or grouped, loaded by TMA and summed by wgmma, for
// sm_90a.
//
// Replaces, with csrc/mpgemm.cu, the TPU kernel
// src/repro/kernels/mpgemm.py::make_gemm_kernel (dense body `kernel`),
// launched by mpgemm_pallas_spec for one GEMM and by mpgemm_grouped_pallas
// for G of them (the MoE expert GEMMs).  It computes what mpgemm.cu's
// float loop computes,
//
//     out[g] = tail(alpha * (op(A[g]) @ op(B[g])) * scale + bias[g])
//              + beta * C[g]
//
// for bf16 A (G, M, K), or (G, K, M) under trans_a, and bf16 B (G, K, N),
// or (G, N, K) under trans_b, summed in f32, with gemm_epilogue.cuh's
// epilogue unchanged in meaning (every kind, bias stride, C, gate,
// residual, row scale and output dtype).  The wrapper (kernels/mpgemm.py::
// k1_design) sends a launch here when both operands are bf16 and every row
// stride and base pointer is a multiple of 16 bytes (TMA's rule); f32,
// int8 and other shapes stay on mpgemm.cu's scalar loops.
//
// What bounds it on an H100: the served shapes are decode (M = 2) and
// chunked prefill (M <= 32) against 3072..32128-wide weights, and 32
// experts of 1024 x 512 at 2 or 32 rows each -- passes over the weights,
// bound by bytes of B over the 3.35 TB/s of HBM; the paper's Table III
// shapes at M >= 4096 and the training step's weight gradients are bound by
// the 989 TFLOP/s of bf16 tensor-core work.
//
// What the design does about it:
// * TMA loads whole tiles: one 3-D tensor map per operand (inner axis,
//   rows, group), encoded on the host (and kept for the next launch with
//   the same pointer and extents) and passed as a __grid_constant__
//   parameter, with a 128-byte swizzle, so that a tile
//   lands in the layout wgmma reads.  TMA fills out-of-bounds elements with
//   zeros, so the M, N and K tails need no masking in the loop, and M = 2
//   pads to 64 rows in shared memory, never in HBM; the group is the map's
//   outer axis, so a tile never crosses experts.
// * A ring of 4 stages (BK = 64: one 128-byte swizzle row of bf16) with a
//   full and an empty mbarrier each: one producer thread keeps TMA loads in
//   flight while one (BM = 64, for M <= 64) or two (BM = 128) consumer
//   warpgroups issue wgmma.mma_async m64n128k16 (f32 += bf16 x bf16) on
//   the stages that have arrived, one group of products in flight behind
//   the next.
// * Transposes come from the descriptors, never from copies: wgmma reads A
//   and B K-major or MN-major.  A (M, K) and B (N, K) (trans_b) are
//   K-major tiles, rows of 64 K values (the k16 steps advance 32 bytes
//   along the row); A (K, M) (trans_a) and B (K, N) (the served weight) are
//   MN-major tiles, boxes of 64 M or N values by 64 K rows, 8 KB each,
//   side by side along M or N (leading byte offset 8 KB, stride byte offset
//   1 KB per 8 K rows; the k16 steps advance 16 rows, 2 KB).
// * Split-K when there are fewer output tiles than SMs (decode: phi3's
//   3072-wide projections give 24 tiles of 128 columns): the wrapper
//   (k1_split) picks the number of slices, each at least one BK deep; each
//   slice writes its f32 partial tile to a workspace and counts itself in
//   on the tile's counter; the last to arrive reads every slice's partial
//   back in a fixed order (0, 1, 2, ...), runs the epilogue and resets the
//   counter for the next launch.  The sum does not depend on which block
//   comes last, so the result is bit-identical from run to run (training's
//   dW goes through trans_a, and a resumed run must repeat a continuous
//   one), and no second launch costs host time.
// * Large grids walk their tiles in groups of 8 rows of tiles, so that the
//   blocks in flight share their A and B tiles in L2.
// * After the loop the accumulator fragment passes through shared memory
//   (the ring, free by then) to one epilogue loop that calls
//   epilogue_store, as mpgemm.cu does, so each instantiation holds one copy
//   of the epilogue and the stores are coalesced.
// Known gaps, for later work: no persistent blocks (a tile's epilogue does
// not overlap the next tile's loads; the Table III shapes with K <= 1536
// and N >= 24576 run 2.5-4.2x cuBLAS on an H100 80GB HBM3 at 700 W,
// chip_smoke.py), BN stays 128, the epilogue stores one value a thread,
// no clusters or TMA multicast.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "gemm_epilogue.cuh"

namespace {

constexpr int BK = 64;          // K per stage: one 128-byte swizzle row
constexpr int BN = 128;         // output columns a block
constexpr int kStages = 4;
constexpr int kLd = BN + 8;     // the output tile's row stride in smem (f32)
constexpr int kGroupRows = 8;   // tile rows walked together (L2 reuse)
constexpr uint32_t kBox = 64 * BK * 2;   // one 64 x 64 bf16 box: 8 KB

template <int BM>
struct Cfg {
  static constexpr int kConsumers = BM / 64;                // warpgroups
  static constexpr int kThreads = (kConsumers + 1) * 128;   // + producer
  // BM = 64 (decode) runs two blocks an SM: 2 x ~97 KB of shared memory.
  static constexpr int kMinBlocks = BM == 64 ? 2 : 1;
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kStageBytes = kABytes + BN * BK * 2;
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = BM * kLd * 4;
  static_assert(kOutBytes <= kPipeBytes, "the output tile reuses the ring");
  // The ring, 2 * kStages mbarriers, and slack to align the ring to the
  // 1024 bytes of the 128-byte swizzle pattern.
  static constexpr int kSmemBytes = kPipeBytes + 2 * kStages * 8 + 1024;
};

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

// d += A (64 x 16) * B (16 x 128), bf16 in, f32 accumulators.  TA / TB are
// the instruction's transpose flags: 0 reads the operand K-major, 1
// MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

// One block computes a BM x BN output tile of group g over the K tiles of
// its slice s (blockIdx.z = g * splits + s).  With one slice it runs the
// epilogue; with more it writes its f32 partial tile to
// partial[s][g][M][N], and the last slice of the tile to arrive (counted
// on counters[g * tiles + tile], zero between launches) sums them.
template <int BM, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(Cfg<BM>::kThreads, Cfg<BM>::kMinBlocks)
mpgemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    EPILOGUE_PARAMS, float* partial, int* counters, int M,
                    int N, int G, int k_tiles, int per_split, int splits) {
  using C = Cfg<BM>;
  const Epilogue e = EPILOGUE_FROM_PARAMS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kPipeBytes);
  uint64_t* empty = full + kStages;

  // The tile: rows of kGroupRows tiles walked column by column.
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int pid = blockIdx.x;
  const int width = kGroupRows * tiles_n;
  const int first_m = (pid / width) * kGroupRows;
  const int rows_in_group = min(tiles_m - first_m, kGroupRows);
  const int m0 = (first_m + (pid % width) % rows_in_group) * BM;
  const int n0 = ((pid % width) / rows_in_group) * BN;
  const int g = blockIdx.z / splits, s = blockIdx.z % splits;
  const int kt0 = s * per_split;
  const int n_kt = min(k_tiles, kt0 + per_split) - kt0;

  const int tid = threadIdx.x;
  constexpr int kConsumerThreads = C::kConsumers * 128;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // Producer: one thread keeps the ring full.
    if (tid == kConsumerThreads) {
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* a_s = smem + st * C::kStageBytes;
        uint8_t* b_s = a_s + C::kABytes;
        const int k0 = (kt0 + it) * BK;
        mbar_expect_tx(&full[st], C::kStageBytes);
        if (TRANS_A) {          // (K, M): boxes of 64 M x 64 K
#pragma unroll
          for (int w = 0; w < C::kConsumers; ++w)
            tma_load(a_s + w * kBox, &map_a, &full[st], m0 + 64 * w, k0, g);
        } else {                // (M, K): one box of BM rows x 64 K
          tma_load(a_s, &map_a, &full[st], k0, m0, g);
        }
        if (TRANS_B) {          // (N, K): one box of 128 rows x 64 K
          tma_load(b_s, &map_b, &full[st], k0, n0, g);
        } else {                // (K, N): boxes of 64 N x 64 K
#pragma unroll
          for (int w = 0; w < BN / 64; ++w)
            tma_load(b_s + w * kBox, &map_b, &full[st], n0 + 64 * w, k0, g);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63.
  const int wg = tid / 128;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  // Per k16 step: 32 bytes along a K-major row, 16 rows (2 KB) down an
  // MN-major box.  Stride byte offset: the next 8 rows (1 KB) either way;
  // leading byte offset: the next 64-wide MN box (8 KB) of an MN-major
  // tile, unused (16 bytes) by a K-major one.
  constexpr uint32_t kStepA = TRANS_A ? 16 * 128 : 32;
  constexpr uint32_t kStepB = TRANS_B ? 32 : 16 * 128;
  constexpr uint32_t kLboA = TRANS_A ? kBox : 16;
  constexpr uint32_t kLboB = TRANS_B ? 16 : kBox;
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const uint32_t a_s = smem_u32(smem + st * C::kStageBytes) + wg * kBox;
    const uint32_t b_s = smem_u32(smem + st * C::kStageBytes + C::kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16<TRANS_A ? 1 : 0, TRANS_B ? 0 : 1>(
          d, smem_desc(a_s + kk * kStepA, kLboA, 1024),
          smem_desc(b_s + kk * kStepB, kLboB, 1024));
    wgmma_commit();
    // The previous stage's products are done: release its buffers.
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();

  // Every consumer is done with the ring: it holds the output tile now.
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  float* cs = reinterpret_cast<float*>(smem);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(&cs[r0 * kLd + col]) =
        make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(&cs[(r0 + 8) * kLd + col]) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  const int rows = min(BM, M - m0);
  if (splits > 1) {
    const size_t slice = static_cast<size_t>(G) * M * N;
    const float* tile = partial + static_cast<size_t>(g) * M * N;
    float* mine = partial + s * slice + static_cast<size_t>(g) * M * N;
    for (int el = tid; el < rows * BN; el += kConsumerThreads) {
      const int mm = el / BN, nn = el % BN;
      if (n0 + nn < N)
        mine[static_cast<size_t>(m0 + mm) * N + n0 + nn] = cs[mm * kLd + nn];
    }
    // Publish this slice, then count it in; the last slice to arrive sums
    // every slice's partial into the output tile, in slice order.
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    __shared__ int last;
    int* counter = counters + static_cast<size_t>(g) * gridDim.x + pid;
    if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    if (!last) return;
    __threadfence();
    // kUnroll outputs a thread at a time, their slices' loads issued
    // before any sum: one block sums up to 128 x 128 outputs of every
    // slice, so the loads' latency, not their bytes, sets its time.
    constexpr int kUnroll = 8;
    for (int el0 = tid; el0 < rows * BN; el0 += kUnroll * kConsumerThreads) {
      float v[kUnroll];
      size_t at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int el = el0 + u * kConsumerThreads;
        at[u] = el < rows * BN && n0 + el % BN < N
                    ? static_cast<size_t>(m0 + el / BN) * N + n0 + el % BN
                    : ~size_t(0);
        v[u] = at[u] != ~size_t(0) ? __ldcg(tile + at[u]) : 0.f;
      }
      for (int t = 1; t < splits; ++t) {
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          w[u] = at[u] != ~size_t(0) ? __ldcg(tile + t * slice + at[u])
                                     : 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] += w[u];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int el = el0 + u * kConsumerThreads;
        if (el < rows * BN) cs[(el / BN) * kLd + el % BN] = v[u];
      }
    }
    if (tid == 0) *counter = 0;     // ready for the next launch
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  }
  // The one epilogue loop of the kernel, over the output tile.
  for (int el = tid; el < rows * BN; el += kConsumerThreads) {
    const int mm = el / BN, nn = el % BN;
    if (n0 + nn < N)
      epilogue_store(e, cs[mm * kLd + nn], g, M, N, m0 + mm, n0 + nn);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (the library links no libcuda).
EncodeTiled encode_tiled() {
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

// A 3-D map of a contiguous bf16 (groups, rows, inner) tensor, boxes of
// (box_rows, 64) with the 128-byte swizzle and zero fill out of bounds.
bool encode_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                uint64_t rows, uint64_t groups, uint32_t box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {inner, rows, groups};
  const cuuint64_t strides[2] = {inner * 2, inner * rows * 2};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encoded maps, kept by everything a map encodes (pointer, extents, box;
// the strides follow from the extents), so that a kept map is the one
// encode_map would make.  Serving and training call the same shapes on the
// same weights and reused activation buffers every step, and an encode
// costs microseconds of host time a launch.
struct MapKey {
  const void* ptr;
  uint64_t inner, rows, groups;
  uint32_t box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && rows == o.rows &&
           groups == o.groups && box_rows == o.box_rows;
  }
};
struct MapEntry {
  MapKey key;
  CUtensorMap map;
  bool used;
};
constexpr int kMapCache = 1024;   // direct-mapped; a miss re-encodes
MapEntry map_cache[kMapCache];
std::mutex map_mutex;             // ctypes calls run without the GIL

bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
              uint64_t rows, uint64_t groups, uint32_t box_rows) {
  const MapKey key{ptr, inner, rows, groups, box_rows};
  const uint64_t h = (reinterpret_cast<uintptr_t>(ptr) >> 4) ^
                     (inner * 0x9E3779B97F4A7C15ull) ^ (rows << 17) ^
                     (groups << 33) ^ box_rows;
  MapEntry& slot = map_cache[(h ^ (h >> 29)) % kMapCache];
  std::lock_guard<std::mutex> lock(map_mutex);
  if (slot.used && slot.key == key) {
    *map = slot.map;
    return true;
  }
  if (!encode_map(map, ptr, inner, rows, groups, box_rows)) return false;
  slot = MapEntry{key, *map, true};
  return true;
}

template <int BM, bool TRANS_A, bool TRANS_B>
cudaError_t launch(const void* a, const void* b, const Epilogue& e,
                   float* partial, int* counters, int g, int m, int n, int k,
                   int splits, int per_split, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  // A: (K, M) boxes of 64 K rows x 64 M, or (M, K) boxes of BM rows x 64 K.
  const bool ok_a = TRANS_A ? make_map(&map_a, a, m, k, g, BK)
                            : make_map(&map_a, a, k, m, g, BM);
  // B: (N, K) boxes of 128 rows x 64 K, or (K, N) boxes of 64 K x 64 N.
  const bool ok_b = TRANS_B ? make_map(&map_b, b, k, n, g, BN)
                            : make_map(&map_b, b, n, k, g, BK);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  auto kernel = mpgemm_wgmma_kernel<BM, TRANS_A, TRANS_B>;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<BM>::kSmemBytes);
    if (rc != cudaSuccess) return rc;
    attribute_set = true;
  }
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int k_tiles = (k + BK - 1) / BK;
  dim3 grid(tiles, 1, g * splits);
  kernel<<<grid, Cfg<BM>::kThreads, Cfg<BM>::kSmemBytes, stream>>>(
      map_a, map_b, EPILOGUE_ARGS(e), partial, counters, m, n, g, k_tiles,
      per_split, splits);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_trans(int trans_a, int trans_b, const void* a,
                         const void* b, const Epilogue& e, float* partial,
                         int* counters, int g, int m, int n, int k,
                         int splits, int per_split, cudaStream_t s) {
  if (trans_a && trans_b)
    return launch<BM, true, true>(a, b, e, partial, counters, g, m, n, k,
                                  splits, per_split, s);
  if (trans_a)
    return launch<BM, true, false>(a, b, e, partial, counters, g, m, n, k,
                                   splits, per_split, s);
  if (trans_b)
    return launch<BM, false, true>(a, b, e, partial, counters, g, m, n, k,
                                   splits, per_split, s);
  return launch<BM, false, false>(a, b, e, partial, counters, g, m, n, k,
                                  splits, per_split, s);
}

}  // namespace

extern "C" {

// Launches the wgmma K1 on `stream` over `g` groups (1 for a 2-D GEMM)
// with bf16 operands; returns the cudaError_t of the launch (0 = ok).
// A is (G, M, K), or (G, K, M) under trans_a; B (G, K, N), or (G, N, K)
// under trans_b; both contiguous, every row 16-byte aligned.  The epilogue
// arguments are mpgemm_launch's (csrc/mpgemm.cu).  `bm` is 64 or 128;
// `splits` slices of `per_split` K tiles (64 deep) each; with more than one
// slice `partial` is an f32 workspace of splits * g * m * n values and
// `counters` g * (output tiles) ints, zero before the launch and after it.
int mpgemm_wgmma_launch(const void* a, const void* b, void* out,
                        const void* bias, const void* extra, const void* c,
                        const void* row_scale, const void* scale,
                        void* partial, void* counters, int g, int m, int n,
                        int k,
                        int bias_stride, int out_dtype, int c_dtype,
                        int trans_a, int trans_b, int kind, int act,
                        float alpha, float beta, int bm, int splits,
                        int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dtype, bias_stride, c_dtype, kind, act,
                                   alpha, beta);
  const int k_tiles = (k + BK - 1) / BK;
  if (!epilogue_ok(e) || g <= 0 || m <= 0 || n <= 0 || k <= 0 ||
      splits <= 0 || static_cast<long long>(g) * splits > 65535 ||
      per_split <= 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      (splits - 1) * per_split >= k_tiles || splits * per_split < k_tiles ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(partial);
  int* cnt = static_cast<int*>(counters);
  if (bm == 64)
    return launch_trans<64>(trans_a, trans_b, a, b, e, p, cnt, g, m, n, k,
                            splits, per_split, s);
  if (bm == 128)
    return launch_trans<128>(trans_a, trans_b, a, b, e, p, cnt, g, m, n, k,
                             splits, per_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mpgemm_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
