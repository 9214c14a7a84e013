// K1 on the CUDA cores' f32 FMA, 2-D or grouped, for sm_90a: the design of
// the f32 products whose caller keeps f32 FMA arithmetic
// (kernels/mpgemm.py::k1_design's "fma": the fp32 policy's products --
// granite-moe's MoE routers in every serve and training step, and every
// product of an fp32 training step, forward, dX and dW, 2-D and grouped).
//
// Replaces the TPU kernel src/repro/kernels/mpgemm.py::make_gemm_kernel
// (dense body `kernel`, its pallas_call at :735, grouped at :812) at
// precision=float32.  Computes what csrc/mpgemm.cu's float kernel computes,
// for every group g < G,
//
//     out[g] = tail(alpha * (op(A[g]) @ op(B[g])) * scale + bias[g])
//              + beta * C[g]
//
// with f32 A (G, M, K), or (G, K, M) under trans_a, and f32 B (G, K, N),
// or (G, N, K) under trans_b, and the same epilogue (gemm_epilogue.cuh's
// epilogue_store: linear, bias, gated, residual, quant_in's f32 row scale,
// beta * C; an f32 or bf16 output).
//
// The same bits as the scalar loop.  csrc/mpgemm.cu sums each output in one
// chain, acc = fmaf(a[k], b[k], acc) for k = 0 .. K-1 from 0.f, and runs
// fmaf(0, 0, acc) once more for each zero it pads K with (when its K tile,
// 64 for its narrow tile -- M <= 16 without trans_a -- else 16, does not
// divide K).  This design splits M and N and never K: each output is one
// thread's chain in the same order, the last partial K tile stops at K, and
// one fmaf(0, 0, acc) stands for the scalar loop's padding (which changes
// only a -0 sum into +0; a second one changes nothing).  No TF32, no
// atomics, no reduction across threads.  So the fp32 policy's results --
// granite's routing, its served logits, a training run and its --resume --
// are those of the scalar loop, bit for bit.
//
// What bounds it on an H100: the decode router (M = 2, K = 1024, N = 32)
// reads 131 KB, 0.04 us at 3.35 TB/s; without a split over K its floor is
// one chain of 1024 dependent FMAs (about 4 cycles each: 2.3 us at the
// card's clock).  Training's products (M = 512 tokens, 32 experts of 160
// rows, dW over the tokens) and the paper's Table III are compute-bound at
// the f32 FMA rate, 67 TFLOP/s.
//
// What the design does about it:
// * tiles by shape (kernels/mpgemm.py::k1_fma_tile, a pure function of the
//   shape): 128 x 128 block tiles of 8 x 8 outputs a thread, 64 x 64 of
//   4 x 4, 32 x 32 of 2 x 2, and 16 x 4 of one output a thread, so that a
//   small output still spreads over many SMs (the decode router: 8
//   blocks);
// * a ring of three or four stages of 16-byte cp.async copies (zero-filled
//   outside the operands), so that the next stages' loads are in flight
//   while the chains run; one __syncthreads a stage;
// * an operand whose contiguous axis is M or N (A under trans_a, B
//   without trans_b) kept as [BK][BM or BN], read a k at a time as float4
//   (float2, float) runs of a thread's rows or columns; one whose
//   contiguous axis is K kept K-major, [BM or BN][BK + 4], and read as
//   float4 runs of four k of one row (the 64, 32 and 16 x 4 tiles; the pad
//   of 4 puts consecutive rows on other banks), or, in the 128 tile,
//   fetched into registers as float4 runs of K and stored transposed into
//   [BK][BM + 4], so that its reads of one k at a time fit two blocks an
//   SM.  A thread owns rows t + T * i of a K-major tile and runs of V of
//   an M- or N-major one, so that a warp's reads take the fewest
//   shared-memory wavefronts;
// * the register tile passes through shared memory (in two passes of 64
//   rows for the 128-row tile) and the epilogue runs once per output from
//   one loop, as in csrc/mpgemm.cu, so the kernel holds one copy of it
//   (the 16 x 4 tile's one output a thread is stored from its register).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "gemm_epilogue.cuh"

namespace {

// One 16-byte copy from device memory into shared memory; `full` false
// fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One operand's tile of a stage: BMN rows of the output's M (A) or N (B)
// axis by BK of K, of which a thread computes TT; NT threads a block.
// MN_MAJOR: the operand's contiguous axis is M or N (its stored rows run
// along K).  The tile is kept MN-major, [BK][BMN (+ 4)], and read a k at a
// time as float4 (float2, float) runs of a thread's rows or columns --
// copied by cp.async when the operand is MN-major, or, for a K-major one
// with STAGE_K (REG), fetched as float4 runs of K into registers and
// stored transposed (the pad of 4 keeps those stores off each other's
// banks).  A K-major operand without STAGE_K (KM) is kept K-major,
// [BMN][BK + 4], copied by cp.async and read as float4 runs of four k of
// one row.
template <int BMN, int BK, int TT, int NT, bool MN_MAJOR, bool STAGE_K>
struct Operand {
  static constexpr bool KM = !MN_MAJOR && !STAGE_K;
  static constexpr bool REG = !MN_MAJOR && STAGE_K;
  static constexpr int T = BMN / TT;          // threads along the axis
  static constexpr int V = TT < 4 ? TT : 4;   // values an MN-major read
  static constexpr int KP = BK + 4;           // row pitch, K-major
  static constexpr int P = BMN + (REG ? 4 : 0);  // row pitch, MN-major
  static constexpr int FLOATS = KM ? BMN * KP : BK * P;
  static constexpr int CHUNKS = BK * BMN / 4;  // 16-byte runs a stage
  static constexpr int ROUNDS = (CHUNKS + NT - 1) / NT;
  static_assert(BMN % 4 == 0 && BK % 4 == 0 && TT % V == 0, "tile shape");
  static_assert(FLOATS % 4 == 0 && P % 4 == 0, "16-byte aligned rows");

  // The tile row (0 .. BMN) of a thread's fragment slot i (t: the
  // thread's index along the axis).
  __device__ static __forceinline__ int slot(int t, int i) {
    if constexpr (KM) return t + T * i;
    else return (i / V) * (T * V) + t * V + i % V;
  }

  // Run c of the stage at k0 of this group's operand X ((K, MN) rows if
  // MN_MAJOR, else (MN, K) rows; MN the axis' extent): its tile row and
  // its first k, and whether it lies inside the operand (whole runs: the
  // contiguous extent is a multiple of 4, k1_design's rule).
  __device__ static __forceinline__ const float* run(const float* X, int c,
                                                    int mn0, int MN, int k0,
                                                    int K, int& row,
                                                    int& kk, bool& in) {
    if constexpr (MN_MAJOR) {
      kk = c / (BMN / 4);
      row = 4 * (c % (BMN / 4));
      in = k0 + kk < K && mn0 + row < MN;
      return X + static_cast<size_t>(k0 + kk) * MN + mn0 + row;
    } else {
      row = c / (BK / 4);
      kk = 4 * (c % (BK / 4));
      in = mn0 + row < MN && k0 + kk < K;
      return X + static_cast<size_t>(mn0 + row) * K + k0 + kk;
    }
  }

  // cp.async of this thread's runs of the stage (MN_MAJOR or KM); zeros
  // outside the operand.
  __device__ static __forceinline__ void copy(float* tile, const float* X,
                                              int tid, int mn0, int MN,
                                              int k0, int K) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int c = tid + r * NT;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      int row, kk;
      bool in;
      const float* src = run(X, c, mn0, MN, k0, K, row, kk, in);
      cp_async16(tile + (KM ? row * KP + kk : kk * P + row), in ? src : X,
                 in);
    }
  }

  // REG: this thread's runs of the stage into registers, then into the
  // MN-major tile, transposed.
  __device__ static __forceinline__ void fetch(float4 (&v)[ROUNDS],
                                               const float* X, int tid,
                                               int mn0, int MN, int k0,
                                               int K) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int c = tid + r * NT;
      int row, kk;
      bool in;
      const float* src = run(X, c, mn0, MN, k0, K, row, kk, in);
      v[r] = (CHUNKS % NT == 0 || c < CHUNKS) && in
                 ? __ldg(reinterpret_cast<const float4*>(src))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ static __forceinline__ void put(float* tile,
                                             const float4 (&v)[ROUNDS],
                                             int tid) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int c = tid + r * NT;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      const int row = c / (BK / 4), kk = 4 * (c % (BK / 4));
      tile[kk * P + row] = v[r].x;
      tile[(kk + 1) * P + row] = v[r].y;
      tile[(kk + 2) * P + row] = v[r].z;
      tile[(kk + 3) * P + row] = v[r].w;
    }
  }

  // KM: thread t's values for k = k4 .. k4 + 3: f[kk][i] of slot i.
  __device__ static __forceinline__ void frag4(const float* tile, int t,
                                               int k4, float (&f)[4][TT]) {
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(tile + (t + T * i) * KP + k4);
      f[0][i] = v.x; f[1][i] = v.y; f[2][i] = v.z; f[3][i] = v.w;
    }
  }

  // MN-major: thread t's values at k: f[i] of slot i.
  __device__ static __forceinline__ void frag1(const float* tile, int t,
                                               int k, float (&f)[TT]) {
#pragma unroll
    for (int c = 0; c < TT / V; ++c) {
      const float* p = tile + k * P + c * (T * V) + t * V;
      if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        f[4 * c] = v.x; f[4 * c + 1] = v.y;
        f[4 * c + 2] = v.z; f[4 * c + 3] = v.w;
      } else if constexpr (V == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        f[2 * c] = v.x; f[2 * c + 1] = v.y;
      } else {
        f[c] = *p;
      }
    }
  }
};

// One stage's products: each of the thread's TM x TN chains takes k = 0 ..
// BK - 1 of the stage in order; GUARD (the last stage, when BK does not
// divide K) stops at kmax.
template <int TM, int TN, int BK, bool GUARD, class OA, class OB>
__device__ __forceinline__ void stage_products(const float* sa,
                                               const float* sb, int ty,
                                               int tx, int kmax,
                                               float (&acc)[TM][TN]) {
#pragma unroll
  for (int k4 = 0; k4 < BK; k4 += 4) {
    if (GUARD && k4 >= kmax) break;
    float fa[4][TM], fb[4][TN];
    if constexpr (OA::KM) OA::frag4(sa, ty, k4, fa);
    if constexpr (OB::KM) OB::frag4(sb, tx, k4, fb);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (GUARD && k4 + kk >= kmax) break;
      if constexpr (!OA::KM) OA::frag1(sa, ty, k4 + kk, fa[kk]);
      if constexpr (!OB::KM) OB::frag1(sb, tx, k4 + kk, fb[kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(fa[kk][i], fb[kk][j], acc[i][j]);
    }
  }
}

// A tile of the design: BM x BN outputs a block, TM x TN a thread (thread
// t at row t / TX, column t % TX of the (BM / TM) x (BN / TN) grid),
// STAGES stages BK deep, MINB blocks an SM in the launch bounds, and
// STAGE_K: a K-major operand goes through registers into an MN-major
// tile.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_,
          int MINB_, bool STAGE_K_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_,
                       STAGES = STAGES_, MINB = MINB_;
  static constexpr bool STAGE_K = STAGE_K_;
  static constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
};

// A launch's shared memory: the ring of STAGES stages, reused for the
// output tile's passes of PR rows (a pass holds slots i of one range: see
// Operand::slot).
template <class TL, bool TRANS_A, bool TRANS_B>
struct Layout {
  using OA = Operand<TL::BM, TL::BK, TL::TM, TL::NT, TRANS_A, TL::STAGE_K>;
  using OB = Operand<TL::BN, TL::BK, TL::TN, TL::NT, !TRANS_B, TL::STAGE_K>;
  static constexpr int STAGE = OA::FLOATS + OB::FLOATS;
  static constexpr int PASSES = TL::TM >= 8 ? 2 : 1;
  static constexpr int PR = TL::BM / PASSES;
  static constexpr int RING = TL::STAGES * STAGE, OUT = PR * (TL::BN + 1);
  static constexpr size_t BYTES = 4 * static_cast<size_t>(
      RING > OUT ? RING : OUT);
  static_assert(BYTES <= 227 * 1024, "an SM's shared memory");
};

template <class TL, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(TL::NT, TL::MINB)
mpgemm_fma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  EPILOGUE_PARAMS, int M, int N, int K, int pad) {
  constexpr int BM = TL::BM, BN = TL::BN, TM = TL::TM, TN = TL::TN,
                BK = TL::BK, STAGES = TL::STAGES, NT = TL::NT, TX = TL::TX;
  using LY = Layout<TL, TRANS_A, TRANS_B>;
  using OA = typename LY::OA;
  using OB = typename LY::OB;
  constexpr int STAGE = LY::STAGE, PASSES = LY::PASSES, PR = LY::PR;
  extern __shared__ __align__(16) float smem[];

  const Epilogue e = EPILOGUE_FROM_PARAMS;
  const int gz = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  A += static_cast<size_t>(gz) * M * K;
  B += static_cast<size_t>(gz) * K * N;
  const int tiles = (K + BK - 1) / BK;

  // The cp.async part of stage t (the operands that are not REG).
  auto copy = [&](int t) {
    float* sa = smem + (t % STAGES) * STAGE;
    if constexpr (!OA::REG) OA::copy(sa, A, tid, m0, M, t * BK, K);
    if constexpr (!OB::REG) OB::copy(sa + OA::FLOATS, B, tid, n0, N, t * BK,
                                     K);
  };
  float4 ra[OA::REG ? OA::ROUNDS : 1], rb[OB::REG ? OB::ROUNDS : 1];
  auto fetch = [&](int t) {
    if constexpr (OA::REG) OA::fetch(ra, A, tid, m0, M, t * BK, K);
    if constexpr (OB::REG) OB::fetch(rb, B, tid, n0, N, t * BK, K);
  };
  auto put = [&](int t) {
    float* sa = smem + (t % STAGES) * STAGE;
    if constexpr (OA::REG) OA::put(sa, ra, tid);
    if constexpr (OB::REG) OB::put(sa + OA::FLOATS, rb, tid);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) copy(s);
    cp_async_commit();
  }
  if constexpr (OA::REG || OB::REG) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < tiles) {
        fetch(s);
        put(s);
      }
  }
  const int tail = K % BK;
  for (int t = 0; t < tiles; ++t) {
    // Stage t has landed (groups complete in order; the REG stores were
    // made before this barrier); every thread is done with stage t - 1,
    // whose buffer the next stage refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < tiles) {
      copy(next);
      fetch(next);
    }
    cp_async_commit();
    const float* sa = smem + (t % STAGES) * STAGE;
    const float* sb = sa + OA::FLOATS;
    if (tail && t == tiles - 1)
      stage_products<TM, TN, BK, true, OA, OB>(sa, sb, ty, tx, tail, acc);
    else
      stage_products<TM, TN, BK, false, OA, OB>(sa, sb, ty, tx, BK, acc);
    if (next < tiles) put(next);
  }
  cp_async_wait<0>();
  __syncthreads();

  // The scalar loop's padding of K (see the note at the top).
  if (pad) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(0.f, 0.f, acc[i][j]);
  }
  if constexpr (TM == 1 && TN == 1) {   // one output a thread: no pass
    const int gm = m0 + OA::slot(ty, 0), gn = n0 + OB::slot(tx, 0);
    if (gm < M && gn < N) epilogue_store(e, acc[0][0], gz, M, N, gm, gn);
    return;
  }

#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
#pragma unroll
    for (int i = p * (TM / PASSES); i < (p + 1) * (TM / PASSES); ++i) {
      const int r = OA::slot(ty, i) - p * PR;
#pragma unroll
      for (int j = 0; j < TN; ++j) smem[r * (BN + 1) + OB::slot(tx, j)] =
          acc[i][j];
    }
    __syncthreads();
    for (int el = tid; el < PR * BN; el += NT) {
      const int mm = el / BN, nn = el % BN;
      const int gm = m0 + p * PR + mm, gn = n0 + nn;
      if (gm < M && gn < N)
        epilogue_store(e, smem[mm * (BN + 1) + nn], gz, M, N, gm, gn);
    }
    __syncthreads();
  }
}

template <class TL, bool TRANS_A, bool TRANS_B>
cudaError_t launch_tile(const float* a, const float* b, const Epilogue& e,
                        int g, int m, int n, int k, int pad,
                        cudaStream_t stream) {
  constexpr size_t bytes = Layout<TL, TRANS_A, TRANS_B>::BYTES;
  if constexpr (bytes > 48 * 1024) {     // once per instantiation
    static const cudaError_t set = cudaFuncSetAttribute(
        mpgemm_fma_kernel<TL, TRANS_A, TRANS_B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (set != cudaSuccess) return set;
  }
  dim3 grid((n + TL::BN - 1) / TL::BN, (m + TL::BM - 1) / TL::BM, g);
  mpgemm_fma_kernel<TL, TRANS_A, TRANS_B><<<grid, TL::NT, bytes, stream>>>(
      a, b, EPILOGUE_ARGS(e), m, n, k, pad);
  return cudaGetLastError();
}

// The tiles of kernels/mpgemm.py::FMA_TILES, by (BM, BN).
template <bool TRANS_A, bool TRANS_B>
cudaError_t launch_trans(int bm, int bn, const float* a, const float* b,
                         const Epilogue& e, int g, int m, int n, int k,
                         int pad, cudaStream_t s) {
#define FMA_TILE(BM, BN, TM, TN, BK, STAGES, MINB, STAGE_K)                 \
  if (bm == BM && bn == BN)                                                \
    return launch_tile<Tile<BM, BN, TM, TN, BK, STAGES, MINB, STAGE_K>,    \
                       TRANS_A, TRANS_B>(a, b, e, g, m, n, k, pad, s);
  FMA_TILE(128, 128, 8, 8, 16, 3, 2, true)
  FMA_TILE(64, 64, 4, 4, 16, 4, 1, false)
  FMA_TILE(32, 32, 2, 2, 16, 4, 1, false)
  FMA_TILE(16, 4, 1, 1, 128, 4, 1, false)
#undef FMA_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the f32 FMA design of K1 on `stream` over `g` groups with the
// (bm, bn) tile; returns the cudaError_t of the launch (0 = ok).  The
// operands are f32, contiguous with the group leading, 16-byte aligned,
// with rows of a multiple of 4 values (A (K, M) under trans_a, B (N, K)
// under trans_b); the epilogue's arguments are csrc/mpgemm.cu's.
int mpgemm_fma_launch(const void* a, const void* b, void* out,
                      const void* bias, const void* extra, const void* c,
                      const void* row_scale, const void* scale, int g, int m,
                      int n, int k, int bias_stride, int out_dtype,
                      int c_dtype, int trans_a, int trans_b, int kind,
                      int act, float alpha, float beta, int bm, int bn,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dtype, bias_stride, c_dtype, kind, act,
                                   alpha, beta);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  if (!epilogue_ok(e) || g <= 0 || g > 65535 || m <= 0 || n <= 0 ||
      k <= 0 || base % 16 || (trans_a ? m : k) % 4 || (trans_b ? k : n) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // Does csrc/mpgemm.cu's float loop pad K for this launch?  Its K tile
  // is 64 for M <= 16 without trans_a, else 16.
  const int pad = k % ((!trans_a && m <= 16) ? 64 : 16) != 0;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  if (trans_a && trans_b)
    return launch_trans<true, true>(bm, bn, A, B, e, g, m, n, k, pad, s);
  if (trans_a)
    return launch_trans<true, false>(bm, bn, A, B, e, g, m, n, k, pad, s);
  if (trans_b)
    return launch_trans<false, true>(bm, bn, A, B, e, g, m, n, k, pad, s);
  return launch_trans<false, false>(bm, bn, A, B, e, g, m, n, k, pad, s);
}

const char* mpgemm_fma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
