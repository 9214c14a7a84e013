// K4 on Hopper: flash attention over dense K/V for bf16 operands, for
// sm_90a, in two designs that kernels/flash_attention.py::k4_design picks
// between by the operands: "wgmma" (tensor cores, TMA) for blocks of 64 or
// 128 folded query rows, "split" (CUDA cores) for at most 16 folded rows,
// the decode shapes.  f32 attention and shapes outside the rule stay on
// csrc/flash_attention.cu's scalar kernel.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel, launched by
// flash_attention.  For request b, kv head kv and query row t:
//
//     qi   = t + (Tk - Tq)                     (right-aligned position)
//     mask = j < Tk  [&& j <= qi if causal]  [&& j > qi - window]
//     s    = scale * q . k_j   (f32),  masked s = -1e30 (finite, never -inf)
//     online softmax in f32 (m, l, acc)
//     out  = acc / max(l, 1e-30), cast to bf16
//
// GQA: head h = kv * G + gi (the reference's q.reshape(b, hkv, g, tq, d)),
// so the G query heads of a kv head are G * Tq consecutive rows of q --
// the "folded rows" -- and K/V are never repeated.
//
// What bounds it on an H100: operations at the encoder's and a prefill's
// shapes (4 * D flops per (query row, key) pair, 1500 x 1500 pairs a head
// for whisper's encoder: far above the card's 295 flops a byte of bf16),
// bytes at decode (every K/V row read for one query row).
//
// The "wgmma" design (flash_wgmma_kernel): one block per (BM = 64 or 128
// folded rows, kv head, request, slice of the keys), one consumer
// warpgroup per 64 rows and one producer warp.
// * TMA loads Q once (3-D maps over (D, rows, B * Hkv): a tile never
//   crosses heads) and K and V tiles of 64 keys through a ring of 3 stages
//   with full and empty mbarriers; D is cut into panels of 64 (one 128-byte
//   swizzle row each), and TMA's zero fill pads D to DP = 64 or 128 and the
//   key and row tails in shared memory, never in HBM.
// * S = Q K^T by wgmma m64n64k16 (both K-major: D is their contiguous
//   axis), f32 accumulators in registers; scale * log2(e) folded into S and
//   exp2f for the exponentials.
// * The masks and the online softmax run on the accumulator fragment (a
//   row's max and sum over the four threads of a quad); a block visits
//   only the keys some of its rows can see.
// * P is rounded to bf16 and fed to wgmma from registers (the RS form: the
//   accumulator fragment of S is the A fragment of P V); V is read
//   MN-major, its transpose taken from the descriptor.  O stays in f32
//   registers, m64nDP.
// * Split over the keys (k4_split): with fewer blocks than SMs, each
//   block's key tiles are cut into `splits` slices; a slice writes its f32
//   (m, l, O) to a workspace and counts itself in on the tile's counter;
//   the last to arrive combines the slices in slice order (0, 1, 2, ...),
//   normalises, writes the output and resets the counter.  One launch, the
//   same bits every run.
//
// The "split" design (flash_split_kernel): at most 16 folded rows (decode:
// whisper's cross-attention has one) make tensor-core tiles of 64 rows
// mostly padding, and the work is bytes.  One block of 128 threads per
// (slice of the keys, kv head, request); chunks of 64 keys come in with
// 16-byte loads, the next chunk's loads in flight while the current one is
// scored (K from a padded shared tile, one key a thread), softmaxed (a
// warp a row) and summed into P V (one output a thread); the slices are
// combined as above.  A decode step's launch is latency, not bytes: on
// an H100 80GB HBM3 at 700 W (chip_smoke.py) four times the blocks, a
// slice a 64-key tile, ran no faster than 5 slices of 300 keys (31-36 us
// a launch against a 3.7 us bound; SDPA 21-25 us).
//
// Numerics, against the plain version (f32 P, expf): P is rounded to
// bf16 before P V in the wgmma design (a relative error of at most 2^-9
// an element; l sums the unrounded P), and both designs take exp2f of
// scores scaled by scale * log2(e).  The card gate stays bf16's 1.6e-2.
//
// Fully masked rows (a row that sees no key, possible only when Tq > Tk
// under causal) are finite: they average the V rows their block visited
// (zero when it visited none), as the reference averages the rows of its
// own blocks.  No caller makes such rows.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKV = 64;           // keys a tile
constexpr int kStages = 3;
constexpr uint32_t kPanel = 64 * 128;   // 64 rows of 64 bf16: 8 KB

// d += A (64 x 16, shared) * B (16 x 64, shared), bf16 in, f32 sums, both
// read K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
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

// d += A (64 x 16, registers) * B (16 x 64, shared, read MN-major),
// bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
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

// d += A (64 x 16, registers) * B (16 x 128, shared, read MN-major),
// bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Is key j visible to right-aligned query position qi (j <= j_hi, the
// last key of the block's range, already holds j < Tk)?
__device__ __forceinline__ bool visible(int j, int j_hi, int qi, int causal,
                                        int window) {
  return j <= j_hi && (!causal || j <= qi) && (window <= 0 || j > qi - window);
}

// The keys [j_lo, j_hi] any of the folded rows [r_lo, r_hi] can see (a
// row's right-aligned position is r % Tq + Tk - Tq).
__device__ __forceinline__ void key_range(int r_lo, int r_hi, int Tq, int Tk,
                                          int causal, int window, int& j_lo,
                                          int& j_hi) {
  const int off = Tk - Tq;
  // Folded rows past one head's Tq wrap around to t = 0.
  const int t_lo = r_hi - r_lo + 1 >= Tq ? 0 : r_lo % Tq;
  const int t_hi = r_hi - r_lo + 1 >= Tq ? Tq - 1 : r_hi % Tq;
  const bool wraps = t_hi < t_lo;
  const int qi_lo = (wraps ? 0 : t_lo) + off;
  const int qi_hi = (wraps ? Tq - 1 : t_hi) + off;
  j_lo = 0;
  j_hi = Tk - 1;
  if (causal) j_hi = min(j_hi, qi_hi);
  if (window > 0) j_lo = max(0, qi_lo - window + 1);
}

// The slice [t0, t1) of a block's n_tiles key tiles.
__device__ __forceinline__ void slice_tiles(int n_tiles, int splits, int s,
                                            int& t0, int& t1) {
  const int per = (n_tiles + splits - 1) / splits;
  t0 = min(n_tiles, s * per);
  t1 = min(n_tiles, t0 + per);
}

template <int BM, int DP>
struct FaCfg {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kConsumerThreads = kConsumers * 128;
  static constexpr int kThreads = kConsumerThreads + 32;   // + producer warp
  static constexpr int kPanels = DP / 64;
  static constexpr int kQBytes = kPanels * BM * 128;
  static constexpr int kKVBytes = kPanels * kPanel;       // K or V, a stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
  // The workspace of one (tile, slice): O (BM x DP), then m and l (BM).
  static constexpr int kWs = BM * DP + 2 * BM;
};

// grid (q_tiles * splits, Hkv, B); FaCfg::kThreads threads; the maps
// cover q and out as (B * Hkv, G * Tq, D) and k, v as (B * Hkv, Tk, D).
template <int BM, int DP>
__global__ void __launch_bounds__(FaCfg<BM, DP>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int Hkv, int Tq, int Tk,
                   int D, int rows, int causal, int window, float scale_log2,
                   int splits) {
  using C = FaCfg<BM, DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* q_s = smem;
  uint8_t* ring = smem + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int q_tiles = (rows + BM - 1) / BM;
  const int qt = blockIdx.x / splits, s = blockIdx.x % splits;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int bh = b * Hkv + kv;
  const int m0 = qt * BM;
  int j_lo, j_hi;
  key_range(m0, min(m0 + BM, rows) - 1, Tq, Tk, causal, window, j_lo, j_hi);
  const int n_tiles = j_hi >= j_lo ? (j_hi - j_lo + BKV) / BKV : 0;
  int t0, t1;
  slice_tiles(n_tiles, splits, s, t0, t1);
  const int n_kv = t1 - t0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::kConsumerThreads);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= C::kConsumerThreads) {
    // Producer: one thread loads Q, then keeps the K/V ring full.
    if (tid == C::kConsumerThreads) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
        tma_load(q_s + p * BM * 128, &map_q, q_full, 64 * p, m0, bh);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* k_s = ring + st * C::kStageBytes;
        uint8_t* v_s = k_s + C::kKVBytes;
        const int j0 = j_lo + (t0 + it) * BKV;
        mbar_expect_tx(&full[st], C::kStageBytes);
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load(k_s + p * kPanel, &map_k, &full[st], 64 * p, j0, bh);
          tma_load(v_s + p * kPanel, &map_v, &full[st], 64 * p, j0, bh);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns folded rows m0 + 64 wg .. + 63; this
  // thread the rows r[0] and r[1] = r[0] + 8 of the fragments.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r_base = m0 + wg * 64 + warp * 16 + lane / 4;
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qi[h] = (r_base + 8 * h) % Tq + Tk - Tq;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  const uint32_t q_base = smem_u32(q_s) + wg * 64 * 128;
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const uint32_t k_base = smem_u32(ring + st * C::kStageBytes);
    const uint32_t v_base = k_base + C::kKVBytes;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;   // 16 values of D
      wgmma_ss(sc,
               smem_desc(q_base + (kk / 4) * BM * 128 + step, 16, 1024),
               smem_desc(k_base + (kk / 4) * kPanel + step, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();

    // Masks, then the online softmax of this tile, in the log2 domain.
    const int j0 = j_lo + (t0 + it) * BKV;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int key = j0 + 8 * j + 2 * (lane % 4) + (e % 2);
        const float v = visible(key, j_hi, qi[h], causal, window)
                            ? sc[4 * j + e] * scale_log2
                            : NEG_INF;
        sc[4 * j + e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sc[4 * j + e] - m_run[e / 2]);
        l_run[e / 2] += p[e];
      }
      // Key block j is half of the A fragment of k16 step j / 2: rows r
      // and r + 8, keys 2 (lane % 4) + 8 (j % 2) and the next.
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs(o, pa[kk], smem_desc(v_base + kk * 16 * 128, kPanel, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }

  const size_t out_base = static_cast<size_t>(bh) * rows * D;
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_base + 8 * h;
      if (r >= rows) continue;
      const float den = fmaxf(l_run[h], 1e-30f);
      __nv_bfloat16* orow = out + out_base + static_cast<size_t>(r) * D;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * i + 2 * h] / den,
                                    o[4 * i + 2 * h + 1] / den);
      }
    }
    return;
  }

  // Split: publish this slice's (O, m, l), count it in; the last slice of
  // the tile combines every slice in slice order.
  const int tile = bh * q_tiles + qt;
  float* ws_tile = ws + static_cast<size_t>(tile) * splits * C::kWs;
  float* mine = ws_tile + static_cast<size_t>(s) * C::kWs;
  const int lr = wg * 64 + warp * 16 + lane / 4;   // the row in the tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      *reinterpret_cast<float2*>(mine + (lr + 8 * h) * DP + col) =
          make_float2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
    }
    if (lane % 4 == 0) {
      mine[BM * DP + lr + 8 * h] = m_run[h];
      mine[BM * DP + BM + lr + 8 * h] = l_run[h];
    }
  }
  __threadfence();
  named_sync(C::kConsumerThreads);
  __shared__ int last;
  if (tid == 0) last = atomicAdd(counters + tile, 1) == splits - 1;
  named_sync(C::kConsumerThreads);
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_base + 8 * h, row = lr + 8 * h;
    float m_all = NEG_INF;
    for (int t = 0; t < splits; ++t)
      m_all = fmaxf(m_all, __ldcg(ws_tile + t * C::kWs + BM * DP + row));
    float l_all = 0.f;
    float acc[DP / 4];
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;
    for (int t = 0; t < splits; ++t) {
      const float* sl = ws_tile + t * C::kWs;
      const float w = exp2f(__ldcg(sl + BM * DP + row) - m_all);
      l_all += w * __ldcg(sl + BM * DP + BM + row);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        const float2 x = __ldcg(reinterpret_cast<const float2*>(
            sl + row * DP + col));
        acc[2 * i] += w * x.x;
        acc[2 * i + 1] += w * x.y;
      }
    }
    if (r >= rows) continue;
    const float den = fmaxf(l_all, 1e-30f);
    __nv_bfloat16* orow = out + out_base + static_cast<size_t>(r) * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[2 * i] / den, acc[2 * i + 1] / den);
    }
  }
  named_sync(C::kConsumerThreads);
  if (tid == 0) counters[tile] = 0;     // ready for the next launch
}

// ---------------------------------------------------------------- "split"

constexpr int SP_ROWS = 16;        // folded rows a block, at most
constexpr int SP_THREADS = 128;
constexpr int SP_DMAX = 128;
constexpr int SP_LOADS = BKV * SP_DMAX / 8 / SP_THREADS;   // 16 B a load
constexpr int SP_OUT = SP_ROWS * SP_DMAX / SP_THREADS;     // outputs a thread
// The workspace of one (request and kv head, slice): O, then m and l.
constexpr int SP_WS = SP_ROWS * SP_DMAX + 2 * SP_ROWS;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (splits, Hkv, B); SP_THREADS threads; q and out (B * Hkv, rows, D)
// with rows = G * Tq <= SP_ROWS, k and v (B * Hkv, Tk, D); D <= SP_DMAX,
// D % 8 == 0, 16-byte aligned bases.
__global__ void __launch_bounds__(SP_THREADS)
flash_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int Hkv, int Tq, int Tk,
                   int D, int rows, int causal, int window, float scale_log2,
                   int splits) {
  __shared__ __align__(16) float q_s[SP_ROWS][SP_DMAX];
  // K rows padded by 16 bytes: the 16-byte reads of 8 consecutive keys
  // land in 8 distinct bank groups.
  __shared__ __align__(16) __nv_bfloat16 k_s[BKV][SP_DMAX + 8];
  __shared__ __align__(16) __nv_bfloat16 v_s[BKV][SP_DMAX];
  __shared__ float p_s[SP_ROWS][BKV];
  __shared__ float m_s[SP_ROWS], l_s[SP_ROWS], alpha_s[SP_ROWS];
  __shared__ int last;

  const int s = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int bh = b * Hkv + kv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int j_lo, j_hi;
  key_range(0, rows - 1, Tq, Tk, causal, window, j_lo, j_hi);
  const int n_tiles = j_hi >= j_lo ? (j_hi - j_lo + BKV) / BKV : 0;
  int t0, t1;
  slice_tiles(n_tiles, splits, s, t0, t1);

  if (tid < SP_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int dv = D / 8;                 // 16-byte vectors a row
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * Tk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * Tk * D;
  uint4 kr[SP_LOADS], vr[SP_LOADS];
  auto load = [&](int c) {
    const int j0 = j_lo + (t0 + c) * BKV;
#pragma unroll
    for (int i = 0; i < SP_LOADS; ++i) {
      const int e = tid + SP_THREADS * i;
      const int key = j0 + e / dv;
      kr[i] = vr[i] = make_uint4(0, 0, 0, 0);
      if (e < BKV * dv && key <= j_hi) {
        const size_t at = static_cast<size_t>(key) * D + (e % dv) * 8;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kb + at));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vb + at));
      }
    }
  };
  float acc[SP_OUT];
#pragma unroll
  for (int i = 0; i < SP_OUT; ++i) acc[i] = 0.f;
  const int qi_of = Tk - Tq;
  if (t1 > t0) load(0);                 // in flight while q is staged
  for (int e = tid; e < rows * D; e += SP_THREADS)
    q_s[e / D][e % D] = __bfloat162float(
        q[(static_cast<size_t>(bh) * rows + e / D) * D + e % D]);
  for (int c = 0; c < t1 - t0; ++c) {
    const int j0 = j_lo + (t0 + c) * BKV;
    __syncthreads();      // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < SP_LOADS; ++i) {
      const int e = tid + SP_THREADS * i;
      if (e < BKV * dv) {
        *reinterpret_cast<uint4*>(&k_s[e / dv][(e % dv) * 8]) = kr[i];
        *reinterpret_cast<uint4*>(&v_s[e / dv][(e % dv) * 8]) = vr[i];
      }
    }
    __syncthreads();
    if (c + 1 < t1 - t0) load(c + 1);   // in flight while this one runs

    // Scores: key jj = tid % 64 against rows tid / 64 + 2 i.
    {
      const int jj = tid % BKV, r0 = tid / BKV;
      float sacc[SP_ROWS / 2];
#pragma unroll
      for (int i = 0; i < SP_ROWS / 2; ++i) sacc[i] = 0.f;
      for (int x = 0; x < dv; ++x) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(&k_s[jj][8 * x]), kf);
#pragma unroll
        for (int i = 0; i < SP_ROWS / 2; ++i) {
          const int r = r0 + 2 * i;
          if (r < rows) {
            const float4 qa = *reinterpret_cast<const float4*>(&q_s[r][8 * x]);
            const float4 qb = *reinterpret_cast<const float4*>(
                &q_s[r][8 * x + 4]);
            sacc[i] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] +
                       qa.w * kf[3] + qb.x * kf[4] + qb.y * kf[5] +
                       qb.z * kf[6] + qb.w * kf[7];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < SP_ROWS / 2; ++i) {
        const int r = r0 + 2 * i;
        if (r < rows)
          p_s[r][jj] = visible(j0 + jj, j_hi, r % Tq + qi_of, causal, window)
                           ? sacc[i] * scale_log2
                           : NEG_INF;
      }
    }
    __syncthreads();
    // The online softmax: warp w takes rows w, w + 4, ...
    for (int r = warp; r < rows; r += SP_THREADS / 32) {
      const float x0 = p_s[r][lane], x1 = p_s[r][lane + 32];
      const float m_new = fmaxf(m_s[r], warp_max(fmaxf(x0, x1)));
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      p_s[r][lane] = p0;
      p_s[r][lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_s[r] - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // P V: output e = tid + SP_THREADS i is (row e / D, column e % D).
#pragma unroll
    for (int i = 0; i < SP_OUT; ++i) {
      const int e = tid + SP_THREADS * i;
      if (e < rows * D) {
        const int r = e / D, d = e % D;
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int jj = 0; jj < BKV; ++jj)
          a += p_s[r][jj] * __bfloat162float(v_s[jj][d]);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  const size_t out_base = static_cast<size_t>(bh) * rows * D;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < SP_OUT; ++i) {
      const int e = tid + SP_THREADS * i;
      if (e < rows * D)
        out[out_base + e] =
            __float2bfloat16_rn(acc[i] / fmaxf(l_s[e / D], 1e-30f));
    }
    return;
  }
  float* ws_tile = ws + static_cast<size_t>(bh) * splits * SP_WS;
  float* mine = ws_tile + static_cast<size_t>(s) * SP_WS;
#pragma unroll
  for (int i = 0; i < SP_OUT; ++i) {
    const int e = tid + SP_THREADS * i;
    if (e < rows * D) mine[(e / D) * SP_DMAX + e % D] = acc[i];
  }
  if (tid < rows) {
    mine[SP_ROWS * SP_DMAX + tid] = m_s[tid];
    mine[SP_ROWS * SP_DMAX + SP_ROWS + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + bh, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < SP_OUT; ++i) {
    const int e = tid + SP_THREADS * i;
    if (e >= rows * D) continue;
    const int r = e / D, d = e % D;
    float m_all = NEG_INF;
    for (int t = 0; t < splits; ++t)
      m_all = fmaxf(m_all, __ldcg(ws_tile + t * SP_WS + SP_ROWS * SP_DMAX + r));
    float l_all = 0.f, o = 0.f;
    for (int t = 0; t < splits; ++t) {
      const float* sl = ws_tile + t * SP_WS;
      const float w = exp2f(__ldcg(sl + SP_ROWS * SP_DMAX + r) - m_all);
      l_all += w * __ldcg(sl + SP_ROWS * SP_DMAX + SP_ROWS + r);
      o += w * __ldcg(sl + r * SP_DMAX + d);
    }
    out[out_base + e] = __float2bfloat16_rn(o / fmaxf(l_all, 1e-30f));
  }
  __syncthreads();
  if (tid == 0) counters[bh] = 0;     // ready for the next launch
}

template <int BM, int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* ws, int* counters, int B, int Hkv,
                         int Tq, int Tk, int D, int rows, int causal,
                         int window, float scale_log2, int splits,
                         cudaStream_t stream) {
  using C = FaCfg<BM, DP>;
  CUtensorMap map_q, map_k, map_v;
  const uint64_t groups = static_cast<uint64_t>(B) * Hkv;
  if (!make_map(&map_q, q, D, rows, groups, 64, BM) ||
      !make_map(&map_k, k, D, Tk, groups, 64, BKV) ||
      !make_map(&map_v, v, D, Tk, groups, 64, BKV))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<BM, DP>;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (rc != cudaSuccess) return rc;
    attribute_set = true;
  }
  const int q_tiles = (rows + BM - 1) / BM;
  dim3 grid(q_tiles * splits, Hkv, B);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), ws, counters,
      Hkv, Tq, Tk, D, rows, causal, window, scale_log2, splits);
  return cudaGetLastError();
}

bool args_ok(const void* q, const void* k, const void* v, int B, int H,
             int Hkv, int Tq, int Tk, int D, int splits, const void* ws,
             const void* counters) {
  return B >= 1 && B <= 65535 && Hkv >= 1 && Hkv <= 65535 && H % Hkv == 0 &&
         Tq >= 1 && Tk >= 1 && D >= 8 && D <= 128 && D % 8 == 0 &&
         splits >= 1 && (splits == 1 || (ws != nullptr && counters != nullptr))
         && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches the "wgmma" design on `stream`; returns the cudaError_t of the
// launch (0 = ok).  q and out (B, H, Tq, D), k and v (B, Hkv, Tk, D),
// contiguous bf16 with 16-byte aligned bases; 8 <= D <= 128, D % 8 == 0;
// window <= 0 means none; `bm` 64 or 128 folded rows a block.  With
// `splits` > 1, `ws` holds q_tiles * B * Hkv * splits * (bm * DP + 2 bm)
// floats (DP = 64 for D <= 64, else 128) and `counters` q_tiles * B * Hkv
// ints, zero before the launch and after it.
int flash_wgmma_launch(const void* q, const void* k, const void* v,
                       void* out, void* ws, void* counters, int B, int H,
                       int Hkv, int Tq, int Tk, int D, int causal,
                       int window, float scale, int bm, int splits,
                       void* stream) {
  if (!args_ok(q, k, v, B, H, Hkv, Tq, Tk, D, splits, ws, counters) ||
      (bm != 64 && bm != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = H / Hkv * Tq;
  const long long blocks = static_cast<long long>((rows + bm - 1) / bm) *
                           splits;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  const float sl = scale * LOG2E;
  if (bm == 64 && D <= 64)
    return launch_wgmma<64, 64>(q, k, v, out, w, c, B, Hkv, Tq, Tk, D, rows,
                                causal, window, sl, splits, s);
  if (bm == 64)
    return launch_wgmma<64, 128>(q, k, v, out, w, c, B, Hkv, Tq, Tk, D,
                                 rows, causal, window, sl, splits, s);
  if (D <= 64)
    return launch_wgmma<128, 64>(q, k, v, out, w, c, B, Hkv, Tq, Tk, D,
                                 rows, causal, window, sl, splits, s);
  return launch_wgmma<128, 128>(q, k, v, out, w, c, B, Hkv, Tq, Tk, D, rows,
                                causal, window, sl, splits, s);
}

// Launches the "split" design on `stream`, as flash_wgmma_launch but for
// H / Hkv * Tq <= 16 folded rows; with `splits` > 1, `ws` holds B * Hkv *
// splits * (16 * 128 + 32) floats and `counters` B * Hkv ints.
int flash_split_launch(const void* q, const void* k, const void* v,
                       void* out, void* ws, void* counters, int B, int H,
                       int Hkv, int Tq, int Tk, int D, int causal,
                       int window, float scale, int splits, void* stream) {
  const int rows = Hkv > 0 ? H / Hkv * Tq : 0;
  if (!args_ok(q, k, v, B, H, Hkv, Tq, Tk, D, splits, ws, counters) ||
      rows > SP_ROWS || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(splits, Hkv, B);
  flash_split_kernel<<<grid, SP_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), Hkv, Tq, Tk, D, rows, causal, window,
      scale * LOG2E, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
