// K1 on Hopper's tensor cores: the dense MPGEMM with a fused epilogue, 2-D
// or grouped, loaded by TMA and summed by wgmma, for sm_90a.  One template
// for both operand types; csrc/mpgemm_wgmma.cu instantiates it for bf16
// and csrc/mpgemm_wgmma_int8.cu for int8, so the two build in parallel.
//
// Replaces, with csrc/mpgemm.cu, the TPU kernel
// src/repro/kernels/mpgemm.py::make_gemm_kernel (dense body `kernel`),
// launched by mpgemm_pallas_spec for one GEMM and by mpgemm_grouped_pallas
// for G of them (the MoE expert GEMMs).  It computes what mpgemm.cu's
// loops compute,
//
//     out[g] = tail(alpha * (op(A[g]) @ op(B[g])) * scale + bias[g])
//              + beta * C[g]
//
// for A (G, M, K), or (G, K, M) under trans_a, and B (G, K, N), or (G, N,
// K) under trans_b: bf16 operands summed in f32, or int8 operands summed
// exactly in int32, with gemm_epilogue.cuh's epilogue unchanged in meaning
// (every kind, bias stride, C, gate, residual, row scale and output
// dtype; an int8 product with no scale keeps the integer epilogue,
// epilogue_store_int).  The wrapper (kernels/mpgemm.py::k1_design) sends a
// launch here when both operands are bf16 or both int8 and every row
// stride and base pointer is a multiple of 16 bytes (TMA's rule); f32 and
// other shapes stay on mpgemm.cu's scalar loops.
//
// What bounds it on an H100: the served shapes are decode (M = 2) and
// chunked prefill (M <= 32) against 3072..32128-wide weights, and 32
// experts of 1024 x 512 at 2 or 32 rows each -- passes over the weights,
// bound by bytes of B over the 3.35 TB/s of HBM; the paper's Table III
// shapes at M >= 4096 and the training step's weight gradients are bound by
// the tensor cores (989 TFLOP/s of bf16, 1979 TOP/s of int8).
//
// What the design does about it:
// * TMA loads whole tiles: one 3-D tensor map per operand (inner axis,
//   rows, group), encoded on the host (and kept for the next launch with
//   the same pointer and extents, hopper.cuh) and passed as a
//   __grid_constant__ parameter.  TMA fills out-of-bounds elements with
//   zeros, so the M, N and K tails need no masking in the loop, and M = 2
//   pads to 64 rows in shared memory, never in HBM; the group is the map's
//   outer axis, so a tile never crosses experts.
// * Every stage holds 128 bytes of K a row: BK = 64 bf16 or 128 int8, one
//   128-byte swizzle row.  A ring of 4 stages with a full and an empty
//   mbarrier each: one producer thread keeps TMA loads in flight while one
//   (BM = 64, for M <= 64) or two (BM = 128) consumer warpgroups issue
//   wgmma.mma_async m64n128k16 (f32 += bf16 x bf16) or m64n128k32 (s32 +=
//   s8 x s8) on the stages that have arrived, one group of products in
//   flight behind the next.
// * bf16 transposes come from the descriptors, never from copies: wgmma
//   reads bf16 K-major or MN-major.  A (M, K) and B (N, K) (trans_b) are
//   K-major tiles, rows of 64 K values (the k16 steps advance 32 bytes
//   along the row); A (K, M) (trans_a) and B (K, N) (the served weight) are
//   MN-major tiles, boxes of 64 M or N values by 64 K rows, 8 KB each,
//   side by side along M or N (leading byte offset 8 KB, stride byte
//   offset 1 KB per 8 K rows; the k16 steps advance 16 rows, 2 KB).
// * wgmma's int8 form reads K-major operands only.  A (M, K) and B (N, K)
//   go from TMA to wgmma as bf16's K-major tiles do (the k32 steps advance
//   32 bytes along the row).  The MN-major ones -- B (K, N), the served
//   weight and Table III's B, and A (K, M) under trans_a -- arrive by TMA
//   unswizzled, 128 K rows of the tile's 128 (or 64) M or N bytes, and the
//   consumer warpgroups transpose them in shared memory into the K-major
//   128-byte-swizzled layout TMA would have written (transpose_tile: 4 x 4
//   byte blocks, four 4-byte loads, six byte permutes and four 4-byte
//   stores a block, no bank conflict on the stores and at most two-way on
//   the loads), then fence them to the async proxy and meet at a named
//   barrier before wgmma reads them.  Three transposed buffers rotate, so
//   the one written at step i was last read by step i - 3's products,
//   which every warpgroup has waited for before that barrier of step i -
//   1.  No copy in the wrapper: at M = 2 a transposed copy of the weight
//   would double the bytes of the whole bound.
// * Split-K when there are fewer output tiles than SMs (decode: phi3's
//   3072-wide projections give 24 tiles of 128 columns): the wrapper
//   (k1_split) picks the number of slices, each at least one BK deep; each
//   slice writes its partial tile (f32, or int32: exact, as no sum of int8
//   products leaves int32 while 128^2 * K < 2^31, which the wrapper
//   checks) to a workspace and counts itself in on the tile's counter; the
//   last to arrive reads every
//   slice's partial back in a fixed order (0, 1, 2, ...), runs the
//   epilogue and resets the counter for the next launch.  The sum does not
//   depend on which block comes last, so the result is bit-identical from
//   run to run (training's dW goes through trans_a, and a resumed run must
//   repeat a continuous one), and no second launch costs host time.
// * Large grids walk their tiles in groups of 8 rows of tiles, so that the
//   blocks in flight share their A and B tiles in L2.
// * After the loop the accumulator fragment passes through shared memory
//   (the ring, free by then) to one epilogue loop that calls
//   epilogue_store (or epilogue_store_int), as mpgemm.cu does, so each
//   instantiation holds one copy of the epilogue and the stores are
//   coalesced.
// Known gaps, for later work: no persistent blocks (a tile's epilogue does
// not overlap the next tile's loads; the bf16 Table III shapes with K <=
// 1536 and N >= 24576 run 2.5-4.2x cuBLAS on an H100 80GB HBM3 at 700 W,
// chip_smoke.py), BN stays 128, the epilogue stores one value a thread,
// no clusters or TMA multicast.  The int8 transposes run on the consumer
// warpgroups, and ptxas serialises the wgmma of those instantiations
// (warning C7515: the transposes sit between products in flight); moved
// to the producer warpgroup's three idle warps they cleared the warning
// but ran slower on an H100 80GB HBM3 at 700 W (chip_smoke.py phases:
// phi3's int8 decode step 10.2 ms against 6.0-7.0, Table III int8 7.1
// against 6.3-6.8): three warps could not keep up with the products.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "gemm_epilogue.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRowBytes = 128;  // K bytes per stage: one 128-byte swizzle row
constexpr int BN = 128;         // output columns a block
constexpr int kStages = 4;
constexpr int kLd = BN + 8;     // the output tile's row stride in smem
constexpr int kGroupRows = 8;   // tile rows walked together (L2 reuse)
constexpr uint32_t kBox = 64 * kRowBytes;   // one 64-row box: 8 KB

template <int BM, typename T, bool TRANS_A, bool TRANS_B>
struct Cfg {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int BK = kRowBytes / sizeof(T);          // 64 | 128
  static constexpr int kConsumers = BM / 64;                // warpgroups
  static constexpr int kThreads = (kConsumers + 1) * 128;   // + producer
  // bf16 at BM = 64 (decode) runs two blocks an SM: 2 x ~97 KB of shared
  // memory; int8's transposed buffers leave room for one.
  static constexpr int kMinBlocks = BM == 64 && !kInt8 ? 2 : 1;
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kStageBytes = kABytes + BN * kRowBytes;
  static constexpr int kPipeBytes = kStages * kStageBytes;
  // int8 only: the K-major copies of MN-major tiles, three of each.
  static constexpr bool kTransA = kInt8 && TRANS_A;
  static constexpr bool kTransB = kInt8 && !TRANS_B;
  static constexpr bool kTranspose = kTransA || kTransB;
  static constexpr int kTBufs = 3;
  static constexpr int kTBytes = (kTransA ? kABytes : 0) +
                                 (kTransB ? BN * kRowBytes : 0);
  static constexpr int kOutBytes = BM * kLd * 4;
  static_assert(kOutBytes <= kPipeBytes, "the output tile reuses the ring");
  // The ring, the transposed buffers, 2 * kStages mbarriers, and slack to
  // align the ring to the 1024 bytes of the 128-byte swizzle pattern.
  static constexpr int kBarOffset = kPipeBytes + kTBufs * kTBytes;
  static constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

// d += A (64 x 16) * B (16 x 128), bf16 in, f32 accumulators.  TA / TB are
// the instruction's transpose flags: 0 reads the operand K-major, 1
// MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
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

// d += A (64 x 32) * B (32 x 128), s8 in, exact s32 accumulators; both
// operands K-major (the only form wgmma takes for 8-bit types).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(int (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// One int8 tile, MN-major to K-major: `raw` holds 128 K rows of W bytes
// (W = the tile's M or N extent, 64 or 128; unswizzled, as TMA wrote it);
// `dst` gets W rows of 128 K bytes in the 128-byte swizzle (16-byte chunk
// c of row r at chunk c ^ (r % 8)).  Lane l of a warp takes the 4 x 4 byte
// block (K rows 4a..4a+3, MN bytes 4b..4b+3) with a = l ^ s, b = l % (W /
// 4), for s = this warp's steps: each 4-byte store of the warp hits 32
// distinct banks, each load at most two-way (W = 64).
template <int W, int kThreads>
__device__ __forceinline__ void transpose_tile(const uint8_t* raw,
                                               uint8_t* dst, int tid) {
  constexpr int NB = W / 4, kWarps = kThreads / 32;
  static_assert(NB % kWarps == 0, "each warp takes NB / kWarps steps");
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < NB / kWarps; ++i) {
    const int s = warp + i * kWarps;
    const int a = lane ^ s, b = lane % NB;
    const uint8_t* src = raw + 4 * a * W + 4 * b;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + W);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 2 * W);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 3 * W);
    // Row i of the block is w_i; column c of it is byte c of each.
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
    const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                             __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410),
                             __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = 4 * b + c;
      *reinterpret_cast<uint32_t*>(
          dst + r * kRowBytes + (((a / 4) ^ (r % 8)) * 16) + (a % 4) * 4) =
          col[c];
    }
  }
}

// One block computes a BM x BN output tile of group g over the K tiles of
// its slice s (blockIdx.z = g * splits + s).  With one slice it runs the
// epilogue; with more it writes its partial tile to partial[s][g][M][N],
// and the last slice of the tile to arrive (counted on counters[g * tiles
// + tile], zero between launches) sums them.
template <int BM, typename T, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(Cfg<BM, T, TRANS_A, TRANS_B>::kThreads,
                                  Cfg<BM, T, TRANS_A, TRANS_B>::kMinBlocks)
mpgemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    EPILOGUE_PARAMS, void* partial_raw, int* counters, int M,
                    int N, int G, int k_tiles, int per_split, int splits) {
  using C = Cfg<BM, T, TRANS_A, TRANS_B>;
  using Acc = typename std::conditional<C::kInt8, int, float>::type;
  Acc* partial = static_cast<Acc*>(partial_raw);
  const Epilogue e = EPILOGUE_FROM_PARAMS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* tbuf = smem + C::kPipeBytes;   // int8's transposed tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
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
    mbar_init_fence();
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
        const int k0 = (kt0 + it) * C::BK;
        mbar_expect_tx(&full[st], C::kStageBytes);
        if (TRANS_A && !C::kInt8) {   // (K, M): boxes of 64 M x 64 K
#pragma unroll
          for (int w = 0; w < C::kConsumers; ++w)
            tma_load(a_s + w * kBox, &map_a, &full[st], m0 + 64 * w, k0, g);
        } else if (TRANS_A) {         // int8 (K, M): BM M bytes x 128 K
          tma_load(a_s, &map_a, &full[st], m0, k0, g);
        } else {                      // (M, K): one box of BM rows x BK
          tma_load(a_s, &map_a, &full[st], k0, m0, g);
        }
        if (TRANS_B) {                // (N, K): one box of 128 rows x BK
          tma_load(b_s, &map_b, &full[st], k0, n0, g);
        } else if (C::kInt8) {        // int8 (K, N): 128 N bytes x 128 K
          tma_load(b_s, &map_b, &full[st], n0, k0, g);
        } else {                      // (K, N): boxes of 64 N x 64 K
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
  Acc d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  // Per k step (16 bf16 or 32 int8 values): 32 bytes along a K-major row,
  // 16 rows (2 KB) down a bf16 MN-major box.  Stride byte offset: the
  // next 8 rows (1 KB) either way; leading byte offset: the next 64-wide
  // MN box (8 KB) of an MN-major tile, unused (16 bytes) by a K-major one.
  constexpr bool kMnA = TRANS_A && !C::kInt8, kMnB = !TRANS_B && !C::kInt8;
  constexpr uint32_t kStepA = kMnA ? 16 * 128 : 32;
  constexpr uint32_t kStepB = kMnB ? 16 * 128 : 32;
  constexpr uint32_t kLboA = kMnA ? kBox : 16;
  constexpr uint32_t kLboB = kMnB ? kBox : 16;
  constexpr int kKSteps = kRowBytes / 32;
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    uint8_t* a_tile = smem + st * C::kStageBytes;
    uint8_t* b_tile = a_tile + C::kABytes;
    if constexpr (C::kTranspose) {
      uint8_t* t = tbuf + (it % C::kTBufs) * C::kTBytes;
      if constexpr (C::kTransA) {
        transpose_tile<BM, kConsumerThreads>(a_tile, t, tid);
        a_tile = t;
        t += C::kABytes;
      }
      if constexpr (C::kTransB) {
        transpose_tile<BN, kConsumerThreads>(b_tile, t, tid);
        b_tile = t;
      }
      fence_async_smem();
      named_sync(kConsumerThreads);
    }
    const uint32_t a_s = smem_u32(a_tile) + wg * kBox;
    const uint32_t b_s = smem_u32(b_tile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wgmma_m64n128<kMnA ? 1 : 0, kMnB ? 1 : 0>(
          d, smem_desc(a_s + kk * kStepA, kLboA, 1024),
          smem_desc(b_s + kk * kStepB, kLboB, 1024));
    wgmma_commit();
    // The previous stage's products are done: release its buffers.
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();

  // Every consumer is done with the ring: it holds the output tile now.
  named_sync(kConsumerThreads);
  Acc* cs = reinterpret_cast<Acc*>(smem);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  using Acc2 = typename std::conditional<C::kInt8, int2, float2>::type;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    *reinterpret_cast<Acc2*>(&cs[r0 * kLd + col]) = Acc2{d[4 * j],
                                                         d[4 * j + 1]};
    *reinterpret_cast<Acc2*>(&cs[(r0 + 8) * kLd + col]) =
        Acc2{d[4 * j + 2], d[4 * j + 3]};
  }
  named_sync(kConsumerThreads);
  const int rows = min(BM, M - m0);
  if (splits > 1) {
    const size_t slice = static_cast<size_t>(G) * M * N;
    const Acc* tile = partial + static_cast<size_t>(g) * M * N;
    Acc* mine = partial + s * slice + static_cast<size_t>(g) * M * N;
    for (int el = tid; el < rows * BN; el += kConsumerThreads) {
      const int mm = el / BN, nn = el % BN;
      if (n0 + nn < N)
        mine[static_cast<size_t>(m0 + mm) * N + n0 + nn] = cs[mm * kLd + nn];
    }
    // Publish this slice, then count it in; the last slice to arrive sums
    // every slice's partial into the output tile, in slice order.
    __threadfence();
    named_sync(kConsumerThreads);
    __shared__ int last;
    int* counter = counters + static_cast<size_t>(g) * gridDim.x + pid;
    if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
    named_sync(kConsumerThreads);
    if (!last) return;
    __threadfence();
    // kUnroll outputs a thread at a time, their slices' loads issued
    // before any sum: one block sums up to 128 x 128 outputs of every
    // slice, so the loads' latency, not their bytes, sets its time.
    constexpr int kUnroll = 8;
    for (int el0 = tid; el0 < rows * BN; el0 += kUnroll * kConsumerThreads) {
      Acc v[kUnroll];
      size_t at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int el = el0 + u * kConsumerThreads;
        at[u] = el < rows * BN && n0 + el % BN < N
                    ? static_cast<size_t>(m0 + el / BN) * N + n0 + el % BN
                    : ~size_t(0);
        v[u] = at[u] != ~size_t(0) ? __ldcg(tile + at[u]) : Acc(0);
      }
      for (int t = 1; t < splits; ++t) {
        Acc w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          w[u] = at[u] != ~size_t(0) ? __ldcg(tile + t * slice + at[u])
                                     : Acc(0);
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
    named_sync(kConsumerThreads);
  }
  // The one epilogue loop of the kernel, over the output tile: an int32
  // sum with no scale keeps the integer epilogue, every other sum runs in
  // f32 (an int32 sum converted as mpgemm.cu converts it).
  const bool int_epilogue = C::kInt8 && e.scale == nullptr;
  for (int el = tid; el < rows * BN; el += kConsumerThreads) {
    const int mm = el / BN, nn = el % BN;
    if (n0 + nn >= N) continue;
    if constexpr (C::kInt8) {
      if (int_epilogue) {
        epilogue_store_int(e, cs[mm * kLd + nn], g, M, N, m0 + mm, n0 + nn);
        continue;
      }
    }
    epilogue_store(e, static_cast<float>(cs[mm * kLd + nn]), g, M, N,
                   m0 + mm, n0 + nn);
  }
}

template <int BM, typename T, bool TRANS_A, bool TRANS_B>
cudaError_t launch(const void* a, const void* b, const Epilogue& e,
                   void* partial, int* counters, int g, int m, int n, int k,
                   int splits, int per_split, cudaStream_t stream) {
  using C = Cfg<BM, T, TRANS_A, TRANS_B>;
  constexpr uint32_t esz = sizeof(T), bk = C::BK;
  CUtensorMap map_a, map_b;
  bool ok_a, ok_b;
  if (!C::kInt8) {
    // A: (K, M) boxes of 64 K rows x 64 M, or (M, K) boxes of BM x 64 K.
    ok_a = TRANS_A ? make_map(&map_a, a, m, k, g, 64, bk)
                   : make_map(&map_a, a, k, m, g, 64, BM);
    // B: (N, K) boxes of 128 rows x 64 K, or (K, N) boxes of 64 K x 64 N.
    ok_b = TRANS_B ? make_map(&map_b, b, k, n, g, 64, BN)
                   : make_map(&map_b, b, n, k, g, 64, bk);
  } else {
    // A: (K, M) unswizzled boxes of 128 K rows x BM, or (M, K) boxes of BM
    // rows x 128 K; B: (N, K) boxes of 128 x 128 K, or (K, N) unswizzled
    // boxes of 128 K rows x 128 N.
    ok_a = TRANS_A ? make_map(&map_a, a, m, k, g, BM, bk, esz, false)
                   : make_map(&map_a, a, k, m, g, bk, BM, esz);
    ok_b = TRANS_B ? make_map(&map_b, b, k, n, g, bk, BN, esz)
                   : make_map(&map_b, b, n, k, g, BN, bk, esz, false);
  }
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  auto kernel = mpgemm_wgmma_kernel<BM, T, TRANS_A, TRANS_B>;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (rc != cudaSuccess) return rc;
    attribute_set = true;
  }
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int k_tiles = (k + C::BK - 1) / C::BK;
  dim3 grid(tiles, 1, g * splits);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      map_a, map_b, EPILOGUE_ARGS(e), partial, counters, m, n, g, k_tiles,
      per_split, splits);
  return cudaGetLastError();
}

template <int BM, typename T>
cudaError_t launch_trans(int trans_a, int trans_b, const void* a,
                         const void* b, const Epilogue& e, void* partial,
                         int* counters, int g, int m, int n, int k,
                         int splits, int per_split, cudaStream_t s) {
  if (trans_a && trans_b)
    return launch<BM, T, true, true>(a, b, e, partial, counters, g, m, n, k,
                                     splits, per_split, s);
  if (trans_a)
    return launch<BM, T, true, false>(a, b, e, partial, counters, g, m, n,
                                      k, splits, per_split, s);
  if (trans_b)
    return launch<BM, T, false, true>(a, b, e, partial, counters, g, m, n,
                                      k, splits, per_split, s);
  return launch<BM, T, false, false>(a, b, e, partial, counters, g, m, n, k,
                                     splits, per_split, s);
}

// The launch of mpgemm_wgmma.cu's and mpgemm_wgmma_int8.cu's C entry
// points (their comments give the contract), for operands of type T.
template <typename T>
int mpgemm_wgmma_launch_typed(const void* a, const void* b, void* out,
                              const void* bias, const void* extra,
                              const void* c, const void* row_scale,
                              const void* scale, void* partial,
                              void* counters, int g, int m, int n, int k,
                              int bias_stride, int out_dtype, int c_dtype,
                              int trans_a, int trans_b, int kind, int act,
                              float alpha, float beta, int bm, int splits,
                              int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dtype, bias_stride, c_dtype, kind, act,
                                   alpha, beta);
  constexpr int bk = kRowBytes / sizeof(T);
  const int k_tiles = (k + bk - 1) / bk;
  if (!epilogue_ok(e) || g <= 0 || m <= 0 || n <= 0 || k <= 0 ||
      splits <= 0 || static_cast<long long>(g) * splits > 65535 ||
      per_split <= 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      (splits - 1) * per_split >= k_tiles || splits * per_split < k_tiles ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int* cnt = static_cast<int*>(counters);
  if (bm == 64)
    return launch_trans<64, T>(trans_a, trans_b, a, b, e, partial, cnt, g, m,
                               n, k, splits, per_split, s);
  if (bm == 128)
    return launch_trans<128, T>(trans_a, trans_b, a, b, e, partial, cnt, g,
                                m, n, k, splits, per_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
