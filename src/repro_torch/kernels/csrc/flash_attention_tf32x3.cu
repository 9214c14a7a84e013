// K4's f32 design on Hopper ("tf32x3"): flash attention over dense K/V for
// f32 q, k and v, both products on the tensor cores as 3xTF32, for sm_90a.
// kernels/flash_attention.py::k4_design sends an f32 launch here under the
// bf16 designs' operand rule (16-byte bases, D % 8 == 0, D <= 128) when a
// kv head folds more than 16 query rows; f32 decode, D > 128 and unaligned
// operands stay on csrc/flash_attention.cu's scalar kernel.
//
// Replaces, for f32, the TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel, launched by
// flash_attention.  For request b, kv head kv and query row t:
//
//     qi   = t + (Tk - Tq)              right-aligned position
//     mask = [j <= qi if causal]  [&& j > qi - window]
//     s    = scale * q . k_j   (f32),   masked s = -1e30 (finite)
//     online softmax in f32 (m, l, acc)
//     out  = acc / max(l, 1e-30)
//
// GQA folds the G query heads of a kv head into G * Tq consecutive rows
// of q (head h = kv * G + gi), as csrc/flash_attention_wgmma.cu does.
//
// What bounds it on an H100: a training step's attention (granite: B 4,
// H 16:8, T 128, D 64, causal) is a few hundred thousand products a block
// in about a hundred blocks, so a launch is latency -- loads, the splits
// and the chain of dependent products -- far from both the bytes bound
// and the tensor cores' rate.  The first scalar kernel spent its time on
// shared-memory round trips and serial FMA chains (17x its bound).
//
// The design: one block per (64 folded rows, kv head, request), one
// consumer warpgroup and one producer warp.
// * TMA loads Q once and K and V tiles of BKV keys (64 at D <= 64, 32
//   above, so that D = 128 keeps two stages within 227 KB) through a ring
//   of 2 stages with full and empty mbarriers; 3-D maps over (D, rows, B *
//   Hkv), so a tile never crosses heads and TMA's zero fill pads D to DP =
//   64 or 128 and the key and row tails in shared memory: K/V rows past Tk
//   are never read.  D is cut into panels of 32 f32 (one 128-byte swizzle
//   row each).
// * 3xTF32 (hopper.cuh::split_tf32): every f32 operand is split into tf32
//   hi and lo terms, and each product sums lo * hi + hi * lo + hi * hi on
//   wgmma .f32.tf32.tf32, as K1's f32 design does (about 2^-21 of a
//   product against plain TF32's 2^-11; the f32 gate of 1e-4 rules plain
//   TF32 out).
// * S = Q K^T (wgmma m64nBKVk8, both operands K-major in shared memory):
//   Q is split once (hi in place, lo beside it), each K tile as it
//   arrives.  Scores are scaled by scale * log2(e) and exponentiated with
//   exp2f; masked keys score -1e30, keys past the block's last visible
//   key (the zero-filled tail, or beyond every row's causal bound) -inf,
//   so that a row that sees no key averages the keys [j_lo, j_hi] of its
//   block, not the tail's zeros.
// * O += P V (wgmma m64n64k8 with P from registers, A operand in tf32 hi
//   and lo): wgmma takes tf32 B only K-major, and V's tile is (keys x D)
//   with D contiguous, so the consumers write V^T into hi and lo buffers
//   (keys contiguous, 128-byte swizzled) in the same pass that splits it.
//   The accumulator fragment of S holds keys 2c and 2c + 1 of each 8-key
//   step for quad lane c, where the A fragment of a k8 step takes columns
//   c and c + 4: so V^T stores each step's keys in the order 0 2 4 6 1 3
//   5 7, and P goes from the S fragment to the A fragment with no
//   shuffle.
// * One pass per tile: the block waits for each product group before the
//   next step (no overlap of the next tile's split with this tile's
//   products), and runs no split over the keys; no atomics, so the result
//   is the same bits every run.
//
// Numerics, against the plain version (f32 scores, expf, f32 P V): S and
// P V to about 2^-21 of each product, exp2f of prescaled scores; the card
// gate is f32's 1e-4.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;                  // folded rows a block
constexpr int kConsumerThreads = 128;   // one consumer warpgroup
constexpr int kThreads = kConsumerThreads + 32;   // + the producer warp
constexpr int kStages = 2;
constexpr int kRow = 128;               // one 128-byte swizzle row: 32 f32

// Shared memory of a block: Q's hi (in place) and lo terms, the ring of K
// and V tiles (K's hi in place), K's lo terms, V^T's hi and lo terms, the
// barriers.
template <int DP>
struct Tf {
  static constexpr int BKV = DP <= 64 ? 64 : 32;   // keys a tile
  static constexpr int kQBytes = BM * DP * 4;
  static constexpr int kKVBytes = BKV * DP * 4;    // a K, V or V^T tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kQLo = kQBytes;
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kKLo = kRing + kStages * kStageBytes;
  static constexpr int kVtHi = kKLo + kKVBytes;
  static constexpr int kVtLo = kVtHi + kKVBytes;
  static constexpr int kBarOffset = kVtLo + kKVBytes;
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

// V's tile (BKV keys x DP, as TMA wrote K's: panels of 32 values of D,
// a key's 128-byte row swizzled) into V^T's hi and lo terms, the K-major
// B operand of P V: panels of 32 keys, one 128-byte swizzled row for each
// of the DP values of D, each 8-key step's keys in the order 0 2 4 6 1 3
// 5 7 (P's A fragment).  A thread takes row r's 16-byte chunk q (4 keys
// two apart): a warp's 32 consecutive r read 128 contiguous bytes of a key
// row, and 8 consecutive rows store to 8 distinct chunks.
template <int DP, int BKV>
__device__ __forceinline__ void split_transpose_v(const uint8_t* v,
                                                  uint8_t* hi, uint8_t* lo,
                                                  int tid) {
  constexpr int kItems = DP * (BKV / 4);
  static_assert(kItems % kConsumerThreads == 0, "the same chunks a thread");
#pragma unroll
  for (int i = 0; i < kItems / kConsumerThreads; ++i) {
    const int e = tid + i * kConsumerThreads;
    const int r = e % DP, q = e / DP;
    const int key0 = 8 * (q / 2) + q % 2;
    const uint8_t* col = v + (r / 32) * BKV * kRow + (r % 4) * 4;
    float x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int key = key0 + 2 * t;
      x[t] = *reinterpret_cast<const float*>(
          col + key * kRow + ((((r % 32) / 4) ^ (key % 8)) * 16));
    }
    float4 h, l;
    split_tf32(x[0], h.x, l.x);
    split_tf32(x[1], h.y, l.y);
    split_tf32(x[2], h.z, l.z);
    split_tf32(x[3], h.w, l.w);
    const int off = (q / 8) * DP * kRow + r * kRow + (((q % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// grid (q tiles of BM folded rows, Hkv, B); kThreads threads; the maps
// cover q as (B * Hkv, G * Tq, D) and k, v as (B * Hkv, Tk, D), boxes of
// 32 values of D by BM or BKV rows, 128-byte swizzled.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32x3_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    float* __restrict__ out, int Hkv, int Tq, int Tk, int D,
                    int rows, int causal, int window, float scale_log2) {
  using C = Tf<DP>;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* q_s = smem;
  uint8_t* q_lo = smem + C::kQLo;
  uint8_t* ring = smem + C::kRing;
  uint8_t* k_lo = smem + C::kKLo;
  uint8_t* vt_hi = smem + C::kVtHi;
  uint8_t* vt_lo = smem + C::kVtLo;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int kv = blockIdx.y, b = blockIdx.z;
  const int bh = b * Hkv + kv;
  const int m0 = blockIdx.x * BM;
  const int qi_off = Tk - Tq;
  int j_lo, j_hi;
  key_range(m0, min(m0 + BM, rows) - 1, Tq, Tk, qi_off, causal, window, j_lo,
            j_hi);
  const int n_kv = j_hi >= j_lo ? (j_hi - j_lo + BKV) / BKV : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerThreads);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // Producer: one thread loads Q, then keeps the K/V ring full.
    if (tid == kConsumerThreads) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int p = 0; p < DP / 32; ++p)
        tma_load(q_s + p * BM * kRow, &map_q, q_full, 32 * p, m0, bh);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* k_s = ring + st * C::kStageBytes;
        uint8_t* v_s = k_s + C::kKVBytes;
        const int j0 = j_lo + it * BKV;
        mbar_expect_tx(&full[st], C::kStageBytes);
#pragma unroll
        for (int p = 0; p < DP / 32; ++p) {
          tma_load(k_s + p * BKV * kRow, &map_k, &full[st], 32 * p, j0, bh);
          tma_load(v_s + p * BKV * kRow, &map_v, &full[st], 32 * p, j0, bh);
        }
      }
    }
    return;
  }

  // Consumers: this thread holds rows r_base and r_base + 8 of the
  // fragments, quad lane c = lane % 4.
  const int warp = tid / 32, lane = tid % 32, c = lane % 4;
  const int r_base = m0 + warp * 16 + lane / 4;
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qi[h] = (r_base + 8 * h) % Tq + qi_off;
  float o[DP / 64][32];
#pragma unroll
  for (int n = 0; n < DP / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  split_in_place<C::kQBytes, kConsumerThreads>(q_s, q_lo, tid);
  const uint32_t qh = smem_u32(q_s), ql = smem_u32(q_lo);
  const uint32_t kl = smem_u32(k_lo);
  const uint32_t vh = smem_u32(vt_hi), vl = smem_u32(vt_lo);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % kStages;
    uint8_t* k_s = ring + st * C::kStageBytes;
    mbar_wait(&full[st], (it / kStages) & 1);
    split_in_place<C::kKVBytes, kConsumerThreads>(k_s, k_lo, tid);
    split_transpose_v<DP, BKV>(k_s + C::kKVBytes, vt_hi, vt_lo, tid);
    fence_async_smem();
    named_sync(kConsumerThreads);

    // S = Q K^T: the small products first, then hi * hi, into one sum.
    const uint32_t kh = smem_u32(k_s);
    float sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t a = (kk / 4) * BM * kRow + (kk % 4) * 32;
      const uint32_t bk = (kk / 4) * BKV * kRow + (kk % 4) * 32;
      const uint64_t dqh = smem_desc(qh + a, 16, 1024);
      const uint64_t dkh = smem_desc(kh + bk, 16, 1024);
      wgmma_tf32(sc, smem_desc(ql + a, 16, 1024), dkh);
      wgmma_tf32(sc, dqh, smem_desc(kl + bk, 16, 1024));
      wgmma_tf32(sc, dqh, dkh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);      // K and V are read: the stage is free

    // Masks, then the online softmax of this tile, in the log2 domain.
    const int j0 = j_lo + it * BKV;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int key = j0 + 8 * j + 2 * c + (e % 2);
        const float v = key > j_hi ? -INFINITY
                        : visible(key, j_hi, qi[h], causal, window)
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
    // P's hi and lo terms as the A fragments of the tile's k8 steps: step
    // j's columns c and c + 4 are keys 8 j + 2 c and 8 j + 2 c + 1.
    uint32_t ph[BKV / 8][4], pl[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Fragment value e (row + 8 (e / 2), key 2 c + e % 2) is A
        // register 2 (e % 2) + e / 2.
        const float p = exp2f(sc[4 * j + e] - m_run[e / 2]);
        l_run[e / 2] += p;
        float hi, lo;
        split_tf32(p, hi, lo);
        ph[j][2 * (e % 2) + e / 2] = __float_as_uint(hi);
        pl[j][2 * (e % 2) + e / 2] = __float_as_uint(lo);
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 64; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[n][4 * i] *= alpha[0];
        o[n][4 * i + 1] *= alpha[0];
        o[n][4 * i + 2] *= alpha[1];
        o[n][4 * i + 3] *= alpha[1];
      }
    // O += P V over V^T's 64-row halves of D.
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int n = 0; n < DP / 64; ++n) {
        const uint32_t off = (j / 4) * DP * kRow + n * 64 * kRow +
                             (j % 4) * 32;
        const uint64_t dvh = smem_desc(vh + off, 16, 1024);
        wgmma_tf32_rs(o[n], pl[j], dvh);
        wgmma_tf32_rs(o[n], ph[j], smem_desc(vl + off, 16, 1024));
        wgmma_tf32_rs(o[n], ph[j], dvh);
      }
    wgmma_commit();
    wgmma_wait<0>();
    named_sync(kConsumerThreads);   // K's lo and V^T read: free to rewrite
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }

  const size_t out_base = static_cast<size_t>(bh) * rows * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_base + 8 * h;
    if (r >= rows) continue;
    const float den = fmaxf(l_run[h], 1e-30f);
    float* orow = out + out_base + static_cast<size_t>(r) * D;
#pragma unroll
    for (int n = 0; n < DP / 64; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = n * 64 + 8 * i + 2 * c;
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[n][4 * i + 2 * h] / den,
                          o[n][4 * i + 2 * h + 1] / den);
      }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hkv, int Tq, int Tk, int D, int rows,
                   int causal, int window, float scale_log2,
                   cudaStream_t stream) {
  using C = Tf<DP>;
  CUtensorMap map_q, map_k, map_v;
  const uint64_t groups = static_cast<uint64_t>(B) * Hkv;
  if (!make_map(&map_q, q, D, rows, groups, 32, BM, 4) ||
      !make_map(&map_k, k, D, Tk, groups, 32, C::BKV, 4) ||
      !make_map(&map_v, v, D, Tk, groups, 32, C::BKV, 4))
    return cudaErrorInvalidValue;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t rc = cudaFuncSetAttribute(
        flash_tf32x3_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmemBytes);
    if (rc != cudaSuccess) return rc;
    attribute_set = true;
  }
  dim3 grid((rows + BM - 1) / BM, Hkv, B);
  flash_tf32x3_kernel<DP><<<grid, kThreads, C::kSmemBytes, stream>>>(
      map_q, map_k, map_v, static_cast<float*>(out), Hkv, Tq, Tk, D, rows,
      causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the "tf32x3" design on `stream`; returns the cudaError_t of the
// launch (0 = ok).  q and out (B, H, Tq, D), k and v (B, Hkv, Tk, D),
// contiguous f32 with 16-byte aligned bases; 8 <= D <= 128, D % 8 == 0;
// window <= 0 means none.
int flash_tf32x3_launch(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Hkv, int Tq, int Tk,
                        int D, int causal, int window, float scale,
                        void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || H % Hkv != 0 ||
      Tq < 1 || Tk < 1 || D < 8 || D > 128 || D % 8 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(H / Hkv) * Tq;
  if (rows > 0x7fffffffll - BM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl = scale * LOG2E;
  if (D <= 64)
    return static_cast<int>(launch<64>(q, k, v, out, B, Hkv, Tq, Tk, D,
                                       static_cast<int>(rows), causal, window,
                                       sl, s));
  return static_cast<int>(launch<128>(q, k, v, out, B, Hkv, Tq, Tk, D,
                                      static_cast<int>(rows), causal, window,
                                      sl, s));
}

const char* flash_tf32x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
