// K1, K2 and K3 on Hopper's tensor cores: the dense MPGEMM with a fused
// epilogue, 2-D or grouped, loaded by TMA and summed by wgmma, for sm_90a,
// and the same with B read from a packed payload (K2) or from the stored
// tiles of a tile-sparse one (K3), below.  One template for every operand
// type; csrc/mpgemm_wgmma.cu instantiates it for bf16,
// csrc/mpgemm_wgmma_int8.cu for int8 and csrc/mpgemm_wgmma_f32.cu for f32
// (K1), csrc/mpgemm_packed_wgmma.cu and mpgemm_packed_wgmma_int8.cu for
// K2, csrc/mpgemm_sparse_wgmma.cu and mpgemm_sparse_wgmma_int8.cu for K3,
// so the seven build in parallel.
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
// * K2 (the packed payload, P != kDense; csrc/mpgemm_packed_wgmma.cu and
//   mpgemm_packed_wgmma_int8.cu): the same ring, A by TMA, and a B stage
//   read from the payload's contiguous 128 x 128 tiles
//   (repro_torch/packing/layout.py).  A bf16 payload comes by TMA boxes of
//   the payload viewed as (G * nkb * nnb) tiles and goes to wgmma as a
//   dense (K, N) weight does; a codec payload comes raw by one bulk copy
//   a stage and the consumer warpgroups decode it into a transposed
//   buffer: for bf16 A (decode_tile) each value times its tile's scale
//   (__fmul_rn), rounded to bf16, into the MN-major layout above; for
//   int8 A the int8 tile, or the int4 one with its nibbles sign-extended,
//   through transpose_tile into the K-major layout.  Every payload tile's
//   128 rows are summed on the tensor cores and folded into an f32 sum on
//   the CUDA cores in K-tile order -- int8: acc += float(partial) *
//   tile_scale, the exact int32 partial rounded as the reference rounds
//   it; bf16: acc += partial -- so the f32 sum sees the reference's tile
//   boundaries, and a tensor core's sum never runs longer than a tile
//   (summed over all of a long K on the tensor cores, the served granite
//   steps' logits moved past their bound in chip_smoke.py).  The
//   split-K rule (kernels/mpgemm.py::k2_split) cuts whole payload tiles
//   and keeps the grid within one wave of blocks: a K2 block's decoded
//   tiles leave no room for a second on its SM.  The decode runs on the
//   consumer warpgroups, as the int8 transposes do; the tile's scale is
//   loaded one stage ahead.
// * K1's f32 operands (kF32; csrc/mpgemm_wgmma_f32.cu): 32-deep stages
//   (128 bytes of f32), read K-major as int8's are; the consumers split
//   each value into tf32 hi and lo terms (split_tf32) -- a K-major tile's
//   hi in place and its lo in a buffer, an MN-major tile's terms
//   transposed into two buffers (split_transpose) -- and wgmma
//   m64n128k8.f32.tf32.tf32 sums lo_a hi_b + hi_a lo_b + hi_a hi_b; the
//   partial is folded into the f32 sum every 128 K values, as K2's tiles
//   are.  The buffers take two stages' worth and the ring three or four
//   stages (Cfg::kStages), within a block's 227 KB.
// * K3 (SPARSE; csrc/mpgemm_sparse_wgmma.cu and _int8.cu): K2's B stage
//   and fold over the payload's stored tiles.  A block owns one 128-wide
//   tile column c = g * nnb + j and a slice of its stored tiles
//   indptr[c] .. indptr[c + 1] (the split, kernels/mpgemm.py::k3_split,
//   cuts the longest column into whole tiles and keeps one wave of
//   blocks); the producer warp reads the slice's k-tile indices into
//   shared memory at the start, then per stage loads A's k tile at
//   indices[t] (TMA's zero fill covers the K tail, the payload's tiles are
//   zero-padded) and tile t of the payload; each stored tile's partial is
//   folded in payload order, as the reference's _accumulate adds a tile.
//   A slice past its column's count sums nothing and counts itself in on
//   the tile's counter with a zero partial, so the last block to arrive
//   sums every slice; an empty column runs its epilogue on a zero sum.
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
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "gemm_epilogue.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRowBytes = 128;  // K bytes per stage: one 128-byte swizzle row
constexpr int BN = 128;         // output columns a block
constexpr int kLd = BN + 8;     // the output tile's row stride in smem
constexpr int kGroupRows = 8;   // tile rows walked together (L2 reuse)
constexpr uint32_t kBox = 64 * kRowBytes;   // one 64-row box: 8 KB

// K2's payload codes (kernels/mpgemm.py::_PAYLOAD_CODES); kDense: K1's
// dense B.
enum { kDense = -1, P_BF16 = 1, P_INT8 = 2, P_INT4 = 3, P_FP8 = 4 };

// K2's packed B (P != kDense): payload[G][nkb][nnb][tk][BN] tiles of 128 K
// rows, scales[G][nkb][nnb] f32 for the codecs; `tiles` the payload's tile
// count (G * nkb * nnb).  K3's tile-sparse B: payload[nnz + 1][128][BN]
// and scales[nnz + 1] (int8 tiles), `tiles` = nnz + 1, and the column
// structure: column c = g * nnb + j stores the k tiles indices[indptr[c]
// .. indptr[c + 1]) at the same payload positions
// (repro_torch/sparse/layout.py).  K1 passes none.
struct PackedB {
  const uint8_t* payload;
  const float* scales;
  int nkb, nnb;
  long long tiles;
  const int* indptr;
  const int* indices;
};

template <int BM, typename T, bool TRANS_A, bool TRANS_B, int P = kDense>
struct Cfg {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  // K1's f32 operands, summed as 3xTF32 (hopper.cuh::split_tf32).
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // wgmma reads int8 and tf32 K-major only; bf16 either way.
  static constexpr bool kKMajorOnly = kInt8 || kF32;
  static constexpr int BK = kRowBytes / sizeof(T);          // 32 | 64 | 128
  static constexpr int kConsumers = BM / 64;                // warpgroups
  static constexpr int kThreads = (kConsumers + 1) * 128;   // + producer
  // K2: a stage is BK rows of one 128-deep payload tile (bf16 A: half of
  // it, int8 A: all of it); a codec payload arrives raw (BK rows of BN
  // bytes, int4 BK / 2) and is decoded into a transposed buffer.
  static constexpr bool kPacked = P != kDense;
  static constexpr bool kDecode = kPacked && P != P_BF16;
  static constexpr int kSub = 128 / BK;                     // stages a tile
  // K2 sums each payload tile's 128 rows on the tensor cores and folds
  // the tile's partial into an f32 sum on the CUDA cores (int8 A: the
  // exact int32 partial times the tile's scale), as the reference adds a
  // tile's dot to its accumulator: the tensor cores' f32 sums then never
  // run longer than a tile.
  // K1's f32 path folds in the same way, every 128 K values (four
  // 32-deep stages): the tensor cores' sums then never run longer.
  static constexpr bool kFold = kPacked || kF32;
  static constexpr int kBBytes =
      kDecode ? (P == P_INT4 ? BK / 2 : BK) * BN : BN * kRowBytes;
  // bf16 at BM = 64 (decode) runs two blocks an SM: 2 x ~97 KB of shared
  // memory; int8's transposed buffers leave room for one, and K2 and f32
  // keep one so that their f32 fold's registers (64 a thread) do not
  // spill.
  static constexpr int kMinBlocks =
      BM == 64 && !kInt8 && !kF32 && !kPacked ? 2 : 1;
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // int8's K-major copies of MN-major tiles and K2's decoded tiles, three
  // of each.  f32 (kF32): every stage's operands split into tf32 hi and lo
  // terms -- a K-major tile's hi in place and its lo in a buffer, an
  // MN-major tile's hi and lo both transposed into buffers -- two sets of
  // buffers, enough since the fold waits for each stage's products before
  // the next stage's barrier.
  static constexpr bool kTransA = kInt8 && TRANS_A;
  static constexpr bool kTransB = kInt8 && !TRANS_B;
  static constexpr bool kTranspose = kTransA || kTransB || kDecode;
  static constexpr int kTBufs = kF32 ? 2 : 3;
  static constexpr int kTBytes =
      kF32 ? (TRANS_A ? 2 : 1) * kABytes + (TRANS_B ? 1 : 2) * BN * kRowBytes
           : (kTransA ? kABytes : 0) +
                 (kTransB || kDecode ? BN * kRowBytes : 0);
  // A ring of 4 stages, or 3 where 4 and the buffers pass the 227 KB of a
  // block (f32 under trans_a at BM = 128).
  static constexpr int kStages =
      4 * kStageBytes + kTBufs * kTBytes + 2048 <= 232448 ? 4 : 3;
  static constexpr int kPipeBytes = kStages * kStageBytes;
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

// K1 f32, an MN-major tile: `raw` holds 32 K rows of W f32 (W = the tile's
// M or N extent, 64 or 128; unswizzled, as TMA wrote it); `hi` and `lo`
// get W rows of 32 K values (128 bytes) in the 128-byte swizzle, the
// K-major layout TMA would have written (16-byte chunk q of row r at chunk
// q ^ (r % 8)).  A thread takes row r's chunk q: four loads down K rows
// 4q..4q+3 (a warp's 32 consecutive r: one row of raw, no bank conflict),
// one 16-byte store to each term (8 consecutive rows: 8 distinct chunks).
template <int W, int kThreads>
__device__ __forceinline__ void split_transpose(const uint8_t* raw,
                                                uint8_t* hi, uint8_t* lo,
                                                int tid) {
  constexpr int kItems = W * (kRowBytes / 16);
  static_assert(kItems % kThreads == 0, "every thread the same chunks");
  const float* src = reinterpret_cast<const float*>(raw);
#pragma unroll
  for (int i = 0; i < kItems / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e % W, q = e / W;
    float4 h, l;
    split_tf32(src[(4 * q) * W + r], h.x, l.x);
    split_tf32(src[(4 * q + 1) * W + r], h.y, l.y);
    split_tf32(src[(4 * q + 2) * W + r], h.z, l.z);
    split_tf32(src[(4 * q + 3) * W + r], h.w, l.w);
    const int off = r * kRowBytes + ((q ^ (r % 8)) * 16);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// The four bytes of w with each one's low (high) nibble sign-extended.
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// One int8 tile, MN-major to K-major: `raw` holds 128 K rows of W bytes
// (W = the tile's M or N extent, 64 or 128; unswizzled, as TMA wrote it);
// `dst` gets W rows of 128 K bytes in the 128-byte swizzle (16-byte chunk
// c of row r at chunk c ^ (r % 8)).  Lane l of a warp takes the 4 x 4 byte
// block (K rows 4a..4a+3, MN bytes 4b..4b+3) with a = l ^ s, b = l % (W /
// 4), for s = this warp's steps: each 4-byte store of the warp hits 32
// distinct banks, each load at most two-way (W = 64).  NIBBLES (K2's int4
// payload): `raw` holds 64 rows of W bytes, byte (r, n) K rows 2r (low
// nibble) and 2r + 1 (high), sign-extended here; the loads of a warp are
// then conflict-free.
template <int W, int kThreads, bool NIBBLES = false>
__device__ __forceinline__ void transpose_tile(const uint8_t* raw,
                                               uint8_t* dst, int tid) {
  constexpr int NB = W / 4, kWarps = kThreads / 32;
  static_assert(NB % kWarps == 0, "each warp takes NB / kWarps steps");
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < NB / kWarps; ++i) {
    const int s = warp + i * kWarps;
    const int a = lane ^ s, b = lane % NB;
    uint32_t w0, w1, w2, w3;
    if constexpr (NIBBLES) {
      const uint8_t* src = raw + 2 * a * W + 4 * b;
      const uint32_t p0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t p1 = *reinterpret_cast<const uint32_t*>(src + W);
      w0 = nibbles_lo(p0);
      w1 = nibbles_hi(p0);
      w2 = nibbles_lo(p1);
      w3 = nibbles_hi(p1);
    } else {
      const uint8_t* src = raw + 4 * a * W + 4 * b;
      w0 = *reinterpret_cast<const uint32_t*>(src);
      w1 = *reinterpret_cast<const uint32_t*>(src + W);
      w2 = *reinterpret_cast<const uint32_t*>(src + 2 * W);
      w3 = *reinterpret_cast<const uint32_t*>(src + 3 * W);
    }
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

// Eight bf16 values x[0..7] * ts (the product rounded as __fmul_rn, then
// to bf16 by round-to-nearest: the reference's bf.astype(a.dtype)) as the
// 16-byte chunk of K row k, N columns 8c..8c+7, of the MN-major layout TMA
// writes for a dense (K, N) bf16 B: two boxes of 64 N x 64 K rows, chunk c
// % 8 of row k at chunk (c % 8) ^ (k % 8).
__device__ __forceinline__ void store_row8(uint8_t* dst, int k, int c,
                                           const float (&x)[8], float ts) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(
        __fmul_rn(x[2 * i], ts), __fmul_rn(x[2 * i + 1], ts));
    h[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(dst + (c / 8) * kBox + k * kRowBytes +
                            (((c % 8) ^ (k % 8)) * 16)) =
      make_uint4(h[0], h[1], h[2], h[3]);
}

// K2, bf16 A against a codec payload: `raw` holds one stage's 64 payload
// rows of BN (128) values as the payload stores them (int8 and fp8e4m3 a
// byte each; int4 32 rows of bytes holding K rows 2r, low nibble, and 2r +
// 1); `dst` gets them decoded, times the tile's scale, in bf16, in the
// layout wgmma reads for the served bf16 weight.  A thread takes 8 bytes
// of a row at a time (a warp reads 256 contiguous bytes) and stores 16.
template <int P, int kThreads>
__device__ __forceinline__ void decode_tile(const uint8_t* raw,
                                            uint8_t* dst, float ts,
                                            int tid) {
  constexpr int kRows = P == P_INT4 ? 32 : 64;   // payload rows in `raw`
  constexpr int kItems = kRows * BN / 8;         // 8-byte pieces
  static_assert(kItems % kThreads == 0, "every thread the same pieces");
#pragma unroll
  for (int i = 0; i < kItems / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (BN / 8), c = e % (BN / 8);
    const uint2 w = *reinterpret_cast<const uint2*>(raw + r * BN + c * 8);
    const uint32_t word[2] = {w.x, w.y};
    float x[8], y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = (word[j / 4] >> (8 * (j % 4))) & 0xFFu;
      if constexpr (P == P_INT4) {
        x[j] = static_cast<float>(static_cast<int8_t>(byte << 4) >> 4);
        y[j] = static_cast<float>(static_cast<int8_t>(byte) >> 4);
      } else if constexpr (P == P_FP8) {
        x[j] = __half2float(__half(__nv_cvt_fp8_to_halfraw(
            static_cast<__nv_fp8_storage_t>(byte), __NV_E4M3)));
      } else {
        x[j] = static_cast<float>(static_cast<int8_t>(byte));
      }
    }
    if constexpr (P == P_INT4) {
      store_row8(dst, 2 * r, c, x, ts);
      store_row8(dst, 2 * r + 1, c, y, ts);
    } else {
      store_row8(dst, r, c, x, ts);
    }
  }
}

// The accumulator fragment d of warpgroup rows r0 (this thread's rows r0
// and r0 + 8) into the shared output tile cs.
template <typename V, typename V2>
__device__ __forceinline__ void stash_fragment(V* cs, const V (&d)[64],
                                               int r0, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    *reinterpret_cast<V2*>(&cs[r0 * kLd + col]) = V2{d[4 * j], d[4 * j + 1]};
    *reinterpret_cast<V2*>(&cs[(r0 + 8) * kLd + col]) =
        V2{d[4 * j + 2], d[4 * j + 3]};
  }
}

// One block computes a BM x BN output tile of group g over the K tiles of
// its slice s (blockIdx.z = g * splits + s).  With one slice it runs the
// epilogue; with more it writes its partial tile to partial[s][g][M][N],
// and the last slice of the tile to arrive (counted on counters[g * tiles
// + tile], zero between launches) sums them.  K2 (P != kDense) reads B
// from the packed payload `pk` (map_b covers a bf16 payload as (BN, 128,
// pk.tiles) tiles; a codec payload comes by bulk copies).  K3 (SPARSE)
// reads the payload's stored tiles of the block's column, slice s taking
// its stored tiles s * per_split .. (s + 1) * per_split - 1 (per_split
// counts stored tiles there, K stages everywhere else); a slice past the
// column's count sums nothing and still counts itself in.
template <int BM, typename T, bool TRANS_A, bool TRANS_B, int P,
          bool SPARSE = false>
__device__ __forceinline__ void mpgemm_wgmma_body(
    const CUtensorMap& map_a, const CUtensorMap& map_b, const Epilogue& e,
    void* partial_raw, int* counters, int M, int N, int G, int k_tiles,
    int per_split, int splits, const PackedB& pk) {
  using C = Cfg<BM, T, TRANS_A, TRANS_B, P>;
  constexpr int kStages = C::kStages;
  // The sum a block holds: int32 for K1's int8 product, f32 otherwise
  // (K2's int8 partials are folded into f32 a payload tile at a time).
  using Acc =
      typename std::conditional<C::kInt8 && !C::kPacked, int, float>::type;
  // What wgmma accumulates.
  using WAcc = typename std::conditional<C::kInt8, int, float>::type;
  Acc* partial = static_cast<Acc*>(partial_raw);
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
  // K1, K2: the slice's K stages kt0 .. kt0 + n_kt - 1.  K3: its stored
  // tiles t0 .. t0 + n_kt / kSub - 1, kSub stages each (kt0 = 0).
  int kt0 = 0, n_kt, t0 = 0;
  if constexpr (SPARSE) {
    const int col = g * pk.nnb + n0 / BN;
    const int hi = __ldg(pk.indptr + col + 1);
    t0 = __ldg(pk.indptr + col) + s * per_split;
    n_kt = max(0, min(hi, t0 + per_split) - t0) * C::kSub;
  } else {
    kt0 = s * per_split;
    n_kt = min(k_tiles, kt0 + per_split) - kt0;
  }

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
    // Producer: one thread keeps the ring full.  K3's producer warp first
    // reads the slice's k-tile indices into shared memory, a lane each, so
    // that no TMA issue waits on a dependent load.
    constexpr int kIdx = SPARSE ? 256 : 1;
    __shared__ int idx_s[kIdx];
    if constexpr (SPARSE) {
      if (tid < kConsumerThreads + 32) {
        for (int i = tid - kConsumerThreads; i < min(n_kt / C::kSub, kIdx);
             i += 32)
          idx_s[i] = __ldg(pk.indices + t0 + i);
        __syncwarp();
      }
    }
    if (tid == kConsumerThreads) {
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* a_s = smem + st * C::kStageBytes;
        uint8_t* b_s = a_s + C::kABytes;
        // The stage: A's K offset k0, and (K2, K3) payload tile `tile`,
        // whose (sub)-th BK rows it is.
        int k0, tile = 0, sub = 0;
        if constexpr (SPARSE) {
          const int i = it / C::kSub;
          sub = it % C::kSub;
          tile = t0 + i;
          k0 = (i < kIdx ? idx_s[i] : __ldg(pk.indices + tile)) * 128 +
               sub * C::BK;
        } else {
          const int kt = kt0 + it;
          k0 = kt * C::BK;
          if constexpr (C::kPacked) {
            tile = (g * pk.nkb + kt / C::kSub) * pk.nnb + n0 / BN;
            sub = kt % C::kSub;
          }
        }
        mbar_expect_tx(&full[st], C::kStageBytes);
        if (TRANS_A && !C::kKMajorOnly) {   // (K, M): boxes of 64 M x 64 K
#pragma unroll
          for (int w = 0; w < C::kConsumers; ++w)
            tma_load(a_s + w * kBox, &map_a, &full[st], m0 + 64 * w, k0, g);
        } else if (TRANS_A) {   // int8 / f32 (K, M): BM M values x BK K
          tma_load(a_s, &map_a, &full[st], m0, k0, g);
        } else {                      // (M, K): one box of BM rows x BK
          tma_load(a_s, &map_a, &full[st], k0, m0, g);
        }
        if constexpr (C::kPacked) {
          if constexpr (C::kDecode) {
            bulk_load(b_s, pk.payload + (static_cast<size_t>(tile) * C::kSub +
                                         sub) * C::kBBytes,
                      C::kBBytes, &full[st]);
          } else {                    // bf16 payload: boxes of 64 N x 64 K
#pragma unroll
            for (int w = 0; w < BN / 64; ++w)
              tma_load(b_s + w * kBox, &map_b, &full[st], 64 * w,
                       sub * C::BK, tile);
          }
        } else if (TRANS_B) {         // (N, K): one box of 128 rows x BK
          tma_load(b_s, &map_b, &full[st], k0, n0, g);
        } else if (C::kKMajorOnly) {  // int8 / f32 (K, N): 128 N x BK K
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
  WAcc d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  // K2: the f32 sum of the folded int8 partials, and the scale of the
  // payload tile of the stage in hand and of the next one (its load in
  // flight behind this stage's work).
  float acc_f[C::kFold ? 64 : 1];
#pragma unroll
  for (int i = 0; i < (C::kFold ? 64 : 1); ++i) acc_f[i] = 0.f;
  // K2's scales step by nnb a K tile, K3's by one a stored tile.
  const float* ts_ptr = nullptr;
  float ts_next = 0.f;
  const int ts_stride = SPARSE ? 1 : pk.nnb;
  if constexpr (C::kPacked) {
    if (pk.scales != nullptr && n_kt > 0) {
      ts_ptr = SPARSE ? pk.scales + t0
                      : pk.scales + static_cast<size_t>(g) * pk.nkb * pk.nnb +
                            n0 / BN;
      ts_next =
          __ldg(ts_ptr + static_cast<size_t>(kt0 / C::kSub) * ts_stride);
    }
  }
  // Per k step (16 bf16 or 32 int8 values): 32 bytes along a K-major row,
  // 16 rows (2 KB) down a bf16 MN-major box.  Stride byte offset: the
  // next 8 rows (1 KB) either way; leading byte offset: the next 64-wide
  // MN box (8 KB) of an MN-major tile, unused (16 bytes) by a K-major one.
  constexpr bool kMnA = TRANS_A && !C::kKMajorOnly;
  constexpr bool kMnB = !TRANS_B && !C::kKMajorOnly;
  constexpr uint32_t kStepA = kMnA ? 16 * 128 : 32;
  constexpr uint32_t kStepB = kMnB ? 16 * 128 : 32;
  constexpr uint32_t kLboA = kMnA ? kBox : 16;
  constexpr uint32_t kLboB = kMnB ? kBox : 16;
  constexpr int kKSteps = kRowBytes / 32;
  // A folding design's step after stage it's products were issued: wait
  // for them, release the stage to the producer, and at the last stage of
  // a 128-deep K tile (a payload tile for K2 and K3) fold the tile's
  // partial into the f32 sum in K-tile order: acc += float(partial) *
  // tile_scale (int8 A, each step rounded as the reference rounds it) or
  // acc += partial (bf16 A, and f32's three products).
  auto release_and_fold = [&](int it, float ts) {
    if constexpr (C::kFold) {
      wgmma_wait<0>();
      mbar_arrive(&empty[it % kStages]);
      if ((kt0 + it) % C::kSub == C::kSub - 1 || it == n_kt - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if constexpr (C::kInt8)
            acc_f[i] = __fadd_rn(acc_f[i],
                                 __fmul_rn(static_cast<float>(d[i]), ts));
          else
            acc_f[i] = __fadd_rn(acc_f[i], d[i]);
          d[i] = 0;
        }
      }
    }
  };
  if constexpr (C::kF32) {
    // K1 f32 (3xTF32).  Stage it's hi and lo terms: a K-major tile's hi in
    // place in its ring stage, the lo terms and an MN-major tile's hi in
    // buffer it % kTBufs.
    auto terms = [&](int it, uint8_t*& ah, uint8_t*& al, uint8_t*& bh,
                     uint8_t*& bl) {
      uint8_t* t = tbuf + (it % C::kTBufs) * C::kTBytes;
      ah = smem + (it % kStages) * C::kStageBytes;
      bh = ah + C::kABytes;
      if constexpr (TRANS_A) {
        ah = t;
        al = t + C::kABytes;
        t += 2 * C::kABytes;
      } else {
        al = t;
        t += C::kABytes;
      }
      if constexpr (TRANS_B) {
        bl = t;
      } else {
        bh = t;
        bl = t + BN * kRowBytes;
      }
    };
    auto split_stage = [&](int it) {
      uint8_t* a_tile = smem + (it % kStages) * C::kStageBytes;
      uint8_t* b_tile = a_tile + C::kABytes;
      uint8_t *ah, *al, *bh, *bl;
      terms(it, ah, al, bh, bl);
      mbar_wait(&full[it % kStages], (it / kStages) & 1);
      if constexpr (TRANS_A)
        split_transpose<BM, kConsumerThreads>(a_tile, ah, al, tid);
      else
        split_in_place<C::kABytes, kConsumerThreads>(a_tile, al, tid);
      if constexpr (TRANS_B)
        split_in_place<BN * kRowBytes, kConsumerThreads>(b_tile, bl, tid);
      else
        split_transpose<BN, kConsumerThreads>(b_tile, bh, bl, tid);
      fence_async_smem();
    };
    // Stage it + 1 is split while stage it's products run on the tensor
    // cores: its terms go to buffer (it + 1) % 2, which stage it - 1's
    // products read last, and every consumer waited for those before the
    // barrier that ended iteration it - 1.
    if (n_kt > 0) {
      split_stage(0);
      named_sync(kConsumerThreads);
    }
    for (int it = 0; it < n_kt; ++it) {
      uint8_t *ah, *al, *bh, *bl;
      terms(it, ah, al, bh, bl);
      const uint32_t a_h = smem_u32(ah) + wg * kBox;
      const uint32_t a_l = smem_u32(al) + wg * kBox;
      const uint32_t b_h = smem_u32(bh), b_l = smem_u32(bl);
      wgmma_fence();
      // The small products first, then hi * hi, into one sum.
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint64_t dah = smem_desc(a_h + kk * 32, 16, 1024);
        const uint64_t dbh = smem_desc(b_h + kk * 32, 16, 1024);
        wgmma_tf32(d, smem_desc(a_l + kk * 32, 16, 1024), dbh);
        wgmma_tf32(d, dah, smem_desc(b_l + kk * 32, 16, 1024));
        wgmma_tf32(d, dah, dbh);
      }
      wgmma_commit();
      if (it + 1 < n_kt) split_stage(it + 1);
      release_and_fold(it, 0.f);
      named_sync(kConsumerThreads);
    }
  } else {
    for (int it = 0; it < n_kt; ++it) {
      const int st = it % kStages;
      float ts = 0.f;
      if constexpr (C::kPacked) {
        ts = ts_next;
        const int kt = kt0 + it + 1;
        if (ts_ptr != nullptr && it + 1 < n_kt)
          ts_next =
              __ldg(ts_ptr + static_cast<size_t>(kt / C::kSub) * ts_stride);
      }
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
        if constexpr (C::kPacked && C::kInt8) {   // K2: int8 / int4, K-major
          transpose_tile<BN, kConsumerThreads, P == P_INT4>(b_tile, t, tid);
          b_tile = t;
        } else if constexpr (C::kDecode) {   // K2: bf16 A, decoded payload
          decode_tile<P, kConsumerThreads>(b_tile, t, ts, tid);
          b_tile = t;
        } else if constexpr (C::kTransB) {
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
      if constexpr (C::kFold) {
        release_and_fold(it, ts);
      } else {
        // The previous stage's products are done: release its buffers.
        wgmma_wait<1>();
        if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
  }
  wgmma_wait<0>();

  // Every consumer is done with the ring: it holds the output tile now.
  named_sync(kConsumerThreads);
  Acc* cs = reinterpret_cast<Acc*>(smem);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  using Acc2 = typename std::conditional<std::is_same<Acc, int>::value, int2,
                                         float2>::type;
  if constexpr (C::kFold)
    stash_fragment<Acc, Acc2>(cs, acc_f, r0, lane);
  else
    stash_fragment<Acc, Acc2>(cs, d, r0, lane);
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
  const bool int_epilogue = C::kInt8 && !C::kPacked && e.scale == nullptr;
  for (int el = tid; el < rows * BN; el += kConsumerThreads) {
    const int mm = el / BN, nn = el % BN;
    if (n0 + nn >= N) continue;
    if constexpr (std::is_same<Acc, int>::value) {
      if (int_epilogue) {
        epilogue_store_int(e, cs[mm * kLd + nn], g, M, N, m0 + mm, n0 + nn);
        continue;
      }
    }
    epilogue_store(e, static_cast<float>(cs[mm * kLd + nn]), g, M, N,
                   m0 + mm, n0 + nn);
  }
}

// K1: the body over a dense B.
template <int BM, typename T, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(Cfg<BM, T, TRANS_A, TRANS_B>::kThreads,
                                  Cfg<BM, T, TRANS_A, TRANS_B>::kMinBlocks)
mpgemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    EPILOGUE_PARAMS, void* partial_raw, int* counters, int M,
                    int N, int G, int k_tiles, int per_split, int splits) {
  mpgemm_wgmma_body<BM, T, TRANS_A, TRANS_B, kDense>(
      map_a, map_b, EPILOGUE_FROM_PARAMS, partial_raw, counters, M, N, G,
      k_tiles, per_split, splits, PackedB{});
}

// K2: the body over a packed B of payload code P (A read (M, K)).
template <int BM, typename T, int P>
__global__ void __launch_bounds__(Cfg<BM, T, false, false, P>::kThreads,
                                  Cfg<BM, T, false, false, P>::kMinBlocks)
mpgemm_packed_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           EPILOGUE_PARAMS, void* partial_raw, int* counters,
                           int M, int N, int G, int k_tiles, int per_split,
                           int splits, const PackedB pk) {
  mpgemm_wgmma_body<BM, T, false, false, P>(
      map_a, map_b, EPILOGUE_FROM_PARAMS, partial_raw, counters, M, N, G,
      k_tiles, per_split, splits, pk);
}

// K3: the body over the stored tiles of a tile-sparse B of payload code P
// (A read (M, K)).
template <int BM, typename T, int P>
__global__ void __launch_bounds__(Cfg<BM, T, false, false, P>::kThreads,
                                  Cfg<BM, T, false, false, P>::kMinBlocks)
mpgemm_sparse_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           EPILOGUE_PARAMS, void* partial_raw, int* counters,
                           int M, int N, int G, int per_split, int splits,
                           const PackedB pk) {
  mpgemm_wgmma_body<BM, T, false, false, P, true>(
      map_a, map_b, EPILOGUE_FROM_PARAMS, partial_raw, counters, M, N, G, 0,
      per_split, splits, pk);
}

template <int BM, typename T, bool TRANS_A, bool TRANS_B, int P = kDense,
          bool SPARSE = false>
cudaError_t launch(const void* a, const void* b, const Epilogue& e,
                   void* partial, int* counters, int g, int m, int n, int k,
                   int splits, int per_split, cudaStream_t stream,
                   const PackedB& pk = PackedB{}) {
  using C = Cfg<BM, T, TRANS_A, TRANS_B, P>;
  constexpr uint32_t esz = sizeof(T), bk = C::BK;
  CUtensorMap map_a, map_b;
  bool ok_a, ok_b;
  if (!C::kKMajorOnly) {
    // A: (K, M) boxes of 64 K rows x 64 M, or (M, K) boxes of BM x 64 K.
    ok_a = TRANS_A ? make_map(&map_a, a, m, k, g, 64, bk)
                   : make_map(&map_a, a, k, m, g, 64, BM);
  } else {
    // A (int8, f32): (K, M) unswizzled boxes of BK K rows x BM, or (M, K)
    // boxes of BM rows x BK K.
    ok_a = TRANS_A ? make_map(&map_a, a, m, k, g, BM, bk, esz, false)
                   : make_map(&map_a, a, k, m, g, bk, BM, esz);
  }
  if constexpr (C::kDecode) {
    // K2, a codec payload: bulk copies, no map.
    map_b = map_a;
    ok_b = true;
  } else if constexpr (C::kPacked) {
    // K2 and K3, a bf16 payload: pk.tiles tiles of 128 K rows x BN, boxes
    // of 64 K x 64 N, as a dense (K, N) B's.
    ok_b = make_map(&map_b, b, BN, 128, static_cast<uint64_t>(pk.tiles), 64,
                    bk);
  } else if (!C::kKMajorOnly) {
    // B: (N, K) boxes of 128 rows x 64 K, or (K, N) boxes of 64 K x 64 N.
    ok_b = TRANS_B ? make_map(&map_b, b, k, n, g, 64, BN)
                   : make_map(&map_b, b, n, k, g, 64, bk);
  } else {
    // B (int8, f32): (N, K) boxes of 128 x BK K, or (K, N) unswizzled
    // boxes of BK K rows x 128 N.
    ok_b = TRANS_B ? make_map(&map_b, b, k, n, g, bk, BN, esz)
                   : make_map(&map_b, b, n, k, g, BN, bk, esz, false);
  }
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  const void* kernel;
  if constexpr (SPARSE)
    kernel = reinterpret_cast<const void*>(
        mpgemm_sparse_wgmma_kernel<BM, T, P>);
  else if constexpr (C::kPacked)
    kernel = reinterpret_cast<const void*>(
        mpgemm_packed_wgmma_kernel<BM, T, P>);
  else
    kernel = reinterpret_cast<const void*>(
        mpgemm_wgmma_kernel<BM, T, TRANS_A, TRANS_B>);
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
  if constexpr (SPARSE)
    mpgemm_sparse_wgmma_kernel<BM, T, P>
        <<<grid, C::kThreads, C::kSmemBytes, stream>>>(
            map_a, map_b, EPILOGUE_ARGS(e), partial, counters, m, n, g,
            per_split, splits, pk);
  else if constexpr (C::kPacked)
    mpgemm_packed_wgmma_kernel<BM, T, P>
        <<<grid, C::kThreads, C::kSmemBytes, stream>>>(
            map_a, map_b, EPILOGUE_ARGS(e), partial, counters, m, n, g,
            k_tiles, per_split, splits, pk);
  else
    mpgemm_wgmma_kernel<BM, T, TRANS_A, TRANS_B>
        <<<grid, C::kThreads, C::kSmemBytes, stream>>>(
            map_a, map_b, EPILOGUE_ARGS(e), partial, counters, m, n, g,
            k_tiles, per_split, splits);
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

// The launch of mpgemm_packed_wgmma.cu's and mpgemm_packed_wgmma_int8.cu's
// C entry points (their comments give the contract): K2 with A of type T
// against payload code `pcode`.
template <typename T>
int mpgemm_packed_wgmma_launch_typed(
    const void* a, const void* payload, const void* tile_scales, void* out,
    const void* bias, const void* extra, const void* c, const void* row_scale,
    const void* scale, void* partial, void* counters, int g, int m, int n,
    int k, int nkb, int nnb, int bias_stride, int pcode, int out_dtype,
    int c_dtype, int kind, int act, float alpha, float beta, int bm,
    int splits, int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dtype, bias_stride, c_dtype, kind, act,
                                   alpha, beta);
  constexpr int bk = kRowBytes / sizeof(T);
  const int k_tiles = (k + bk - 1) / bk;
  const bool codec = pcode != P_BF16;
  if (!epilogue_ok(e) || g <= 0 || m <= 0 || n <= 0 || k <= 0 ||
      nkb != (k + 127) / 128 || nnb != (n + BN - 1) / BN ||
      (codec && tile_scales == nullptr) || splits <= 0 ||
      static_cast<long long>(g) * splits > 65535 || per_split <= 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      (splits - 1) * per_split >= k_tiles || splits * per_split < k_tiles ||
      per_split % (128 / bk) != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(payload) % 16 || (bm != 64 && bm != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const PackedB pk{static_cast<const uint8_t*>(payload),
                   static_cast<const float*>(tile_scales),
                   nkb,
                   nnb,
                   static_cast<long long>(g) * nkb * nnb,
                   nullptr,
                   nullptr};
  int* cnt = static_cast<int*>(counters);
#define K2_LAUNCH(BM_, P_)                                                  \
  return static_cast<int>(launch<BM_, T, false, false, P_>(                 \
      a, payload, e, partial, cnt, g, m, n, k, splits, per_split, s, pk))
#define K2_LAUNCH_BM(P_)     \
  if (bm == 64) K2_LAUNCH(64, P_); \
  K2_LAUNCH(128, P_)
  if constexpr (std::is_same<T, int8_t>::value) {
    if (pcode == P_INT8) { K2_LAUNCH_BM(P_INT8); }
    if (pcode == P_INT4) { K2_LAUNCH_BM(P_INT4); }
  } else {
    if (pcode == P_BF16) { K2_LAUNCH_BM(P_BF16); }
    if (pcode == P_INT8) { K2_LAUNCH_BM(P_INT8); }
    if (pcode == P_INT4) { K2_LAUNCH_BM(P_INT4); }
    if (pcode == P_FP8) { K2_LAUNCH_BM(P_FP8); }
  }
#undef K2_LAUNCH_BM
#undef K2_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch of mpgemm_sparse_wgmma.cu's and mpgemm_sparse_wgmma_int8.cu's
// C entry points (their comments give the contract): K3 with A of type T
// against payload code `pcode`, `splits` slices of `per_split` stored
// tiles of each column.
template <typename T>
int mpgemm_sparse_wgmma_launch_typed(
    const void* a, const void* payload, const void* tile_scales,
    const void* indptr, const void* indices, void* out, const void* bias,
    const void* extra, const void* c, const void* row_scale,
    const void* scale, void* partial, void* counters, int g, int m, int n,
    int k, int nnz, int bias_stride, int pcode, int out_dtype, int c_dtype,
    int kind, int act, float alpha, float beta, int bm, int splits,
    int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dtype, bias_stride, c_dtype, kind, act,
                                   alpha, beta);
  const bool codec = pcode != P_BF16;
  if (!epilogue_ok(e) || g <= 0 || m <= 0 || n <= 0 || k <= 0 || nnz < 0 ||
      indptr == nullptr || (nnz > 0 && indices == nullptr) ||
      (codec && tile_scales == nullptr) || splits <= 0 ||
      static_cast<long long>(g) * splits > 65535 || per_split <= 0 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(payload) % 16 || (bm != 64 && bm != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const PackedB pk{static_cast<const uint8_t*>(payload),
                   static_cast<const float*>(tile_scales),
                   (k + 127) / 128,
                   (n + BN - 1) / BN,
                   static_cast<long long>(nnz) + 1,
                   static_cast<const int*>(indptr),
                   static_cast<const int*>(indices)};
  int* cnt = static_cast<int*>(counters);
#define K3_LAUNCH(BM_, P_)                                                  \
  return static_cast<int>(launch<BM_, T, false, false, P_, true>(           \
      a, payload, e, partial, cnt, g, m, n, k, splits, per_split, s, pk))
#define K3_LAUNCH_BM(P_)     \
  if (bm == 64) K3_LAUNCH(64, P_); \
  K3_LAUNCH(128, P_)
  if constexpr (std::is_same<T, int8_t>::value) {
    if (pcode == P_INT8) { K3_LAUNCH_BM(P_INT8); }
  } else {
    if (pcode == P_BF16) { K3_LAUNCH_BM(P_BF16); }
    if (pcode == P_INT8) { K3_LAUNCH_BM(P_INT8); }
  }
#undef K3_LAUNCH_BM
#undef K3_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ring's stages and the shared memory of one instantiation
// (Cfg::kStages, Cfg::kSmemBytes), for the C entry points' *_stages
// functions: the planner's shared-memory model
// (repro_torch/core/blocking.py::wgmma_stages, vmem_working_set) is held
// to these by a card test.
template <int BM, typename T, bool TRANS_A, bool TRANS_B, int P>
int cfg_stages(int* smem_bytes) {
  *smem_bytes = Cfg<BM, T, TRANS_A, TRANS_B, P>::kSmemBytes;
  return Cfg<BM, T, TRANS_A, TRANS_B, P>::kStages;
}

// K1's instantiation of type T for (bm, trans_a, trans_b): its stages, or
// 0 for a bm the kernel does not take.
template <typename T>
int mpgemm_wgmma_stages_typed(int bm, int trans_a, int trans_b,
                              int* smem_bytes) {
#define K1_STAGES(BM_)                                                    \
  return trans_a ? (trans_b ? cfg_stages<BM_, T, true, true, kDense>(      \
                                  smem_bytes)                            \
                            : cfg_stages<BM_, T, true, false, kDense>(     \
                                  smem_bytes))                           \
                 : (trans_b ? cfg_stages<BM_, T, false, true, kDense>(     \
                                  smem_bytes)                            \
                            : cfg_stages<BM_, T, false, false, kDense>(    \
                                  smem_bytes))
  if (bm == 64) { K1_STAGES(64); }
  if (bm == 128) { K1_STAGES(128); }
#undef K1_STAGES
  return 0;
}

// K2's and K3's instantiation with A of type T against payload code
// `pcode`: its stages, or 0 for a (bm, pcode) the kernel does not take.
template <typename T>
int mpgemm_packed_wgmma_stages_typed(int bm, int pcode, int* smem_bytes) {
  if (bm != 64 && bm != 128) return 0;
#define K2_STAGES(P_)                                                     \
  return bm == 64 ? cfg_stages<64, T, false, false, P_>(smem_bytes)        \
                  : cfg_stages<128, T, false, false, P_>(smem_bytes)
  if constexpr (std::is_same<T, int8_t>::value) {
    if (pcode == P_INT8) { K2_STAGES(P_INT8); }
    if (pcode == P_INT4) { K2_STAGES(P_INT4); }
  } else {
    if (pcode == P_BF16) { K2_STAGES(P_BF16); }
    if (pcode == P_INT8) { K2_STAGES(P_INT8); }
    if (pcode == P_INT4) { K2_STAGES(P_INT4); }
    if (pcode == P_FP8) { K2_STAGES(P_FP8); }
  }
#undef K2_STAGES
  return 0;
}

}  // namespace
