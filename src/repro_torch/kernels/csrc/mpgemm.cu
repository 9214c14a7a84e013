// K1: the dense mixed-precision GEMM with a fused epilogue, 2-D or grouped,
// for sm_90a: the scalar design.  bf16 and int8 launches whose operands TMA
// can describe run csrc/mpgemm_wgmma.cu / mpgemm_wgmma_int8.cu instead, and
// f32 ones csrc/mpgemm_wgmma_f32.cu (kernels/mpgemm.py::k1_design); this
// file runs what that rule leaves out (rows that are not a multiple of 16
// bytes, a view off a 16-byte boundary, and the f32 products whose caller
// keeps f32 FMA arithmetic: the fp32 policy's, granite's router among
// them).
//
// Replaces the TPU kernel src/repro/kernels/mpgemm.py::make_gemm_kernel
// (dense body `kernel`), launched by mpgemm_pallas_spec for one GEMM and
// by mpgemm_grouped_pallas for G of them (the MoE expert GEMMs).
// Computes, for every group g < G,
//
//     out[g] = tail(alpha * (op(A[g]) @ op(B[g])) * scale + bias[g])
//              + beta * C[g]
//     tail = act(acc) | act(acc) * gate[g] | act(acc) + residual[g]
//          | act(acc * row_scale[g]) [+ residual[g]]   (quant_in)
//
// with A (G, M, K) row-major or (G, K, M) under trans_a (the backward's dW
// = A^T B, and the op-level API's transposes), B (G, K, N) row-major or
// (G, N, K) under trans_b, bf16 or f32 inputs summed in f32, or int8 inputs
// summed exactly in int32 over the whole K (the int8 policy, quant_in's int8
// X, and the paper's INT8 -> INT32 GEMM), an f32 bias of N values per group
// (bias_stride = N) or shared by all (bias_stride = 0), gate / residual
// (G, M, N) in the output dtype, C (G, M, N) in f32, bf16 or int32, (G, M)
// f32 row scales, and an f32, bf16 or int32 output.  The epilogue is
// gemm_epilogue.cuh's, every operand of it a run-time argument; an int8
// product with no scale keeps it in int32 (exact, bit-equal to the plain
// version).  The output dtype is a run-time argument too, so a loop is
// instantiated once per input dtype, tile and transpose pair.  The 2-D GEMM
// is the case G = 1: the group is blockIdx.z, so one instantiation serves
// both.  The float kernel folds the group into its row indices (A's and C's row
// g * M + m, B's row g * K + k); the int8 kernel instead moves its pointers by
// the group's extent before the loop.  Each form is the faster one for its loop
// on an H100 (built side by side, with bit-equal outputs): moved pointers made
// the float loop much slower at the decode shapes, folded indices the int8
// loop.  `scale` is an optional f32 scalar in device memory (the int8 policy's
// sx * sw), read by the kernel so that the host never waits for it.
//
// trans_a (training's weight gradient) stages A's (BK, BM) tile from its
// (K, M) rows -- consecutive threads on consecutive m, A's contiguous axis
// -- into the same shared tile, with the K tail predicated on A's rows;
// the sum over K stays in one block's registers, in one fixed order, so dW
// is deterministic (no atomics, no split over K): a resumed run repeats a
// continuous one bit for bit.  Its shapes are the training step's weight
// gradients (M x N a weight, K the tokens of the step), a compute-bound
// product for this scalar loop.
//
// What bounds it on an H100: the served shapes are decode (M = 2) and
// chunked prefill (M <= 32) against 3072..32128-wide weights, or 32
// experts of 1024 x 512 (granite-moe: M = 2 or 32 rows per expert), so
// every call is a pass over the weights -- bytes of B over the 3.35 TB/s
// of HBM.
//
// What this first design does about it: little, on purpose (a right and
// simple kernel first).  One thread block per (BM, BN) output tile; a K
// loop that stages an A tile and a B tile in shared memory as f32, then
// accumulates with FMAs in registers (no tensor cores; the sum is f32
// either way); M, N and K edges masked at the loads and the store; after
// the loop the register tile passes through shared memory and the
// epilogue runs once per output element from one loop.  Small M uses a
// narrow tile (16 x 32) so that more blocks stream the weight; trans_a
// takes the wide tile only.
// The int8 kernel is the same loop over int32 staging and integer
// multiply-adds, A read as (M, K) or (K, M); it is a kernel of its own
// because one template for both compiled the float loop into code about
// 30 % slower on an H100 at M = 2 (with bit-equal outputs).  Known gaps,
// for later work: no vectorised or asynchronous loads (cp.async / TMA), no
// split-K for decode (N / 32 blocks cannot fill 132 SMs when N = 3072);
// the tensor-core routes are the wgmma designs named above (f32 there as
// 3xTF32: plain TF32 misses the 1e-4 gate).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "gemm_epilogue.cuh"

namespace {

// Blocks an SM must be able to hold, for the float kernel: four of the
// narrow decode tile's 128 threads (at most 128 registers a thread), so
// that the grouped launches, which give every SM several blocks, keep their
// occupancy; its unrolled staging loops would otherwise take registers for
// more loads in flight.  (Unrolled so, the int8 kernel was slower: its
// staging loops are left to the compiler.)
template <int BM, int BN, int TM, int TN>
constexpr int kMinBlocks = (BM / TM) * (BN / TN) <= 128 ? 4 : 1;

// Thread (ty, tx) owns rows ty + i * TY and columns tx + j * TX of the tile:
// strided ownership keeps the shared-memory reads of a warp on distinct
// banks and its global stores coalesced.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool TRANS_A,
          bool TRANS_B>
__global__ void
__launch_bounds__((BM / TM) * (BN / TN), kMinBlocks<BM, BN, TM, TN>)
mpgemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
              EPILOGUE_PARAMS, int M, int N, int K) {
  const Epilogue e = EPILOGUE_FROM_PARAMS;
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  // The staging loops below run a whole number of rounds, unrolled.
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile split");
  // The A and B tiles of the K loop; after it, the output tile (Cs).
  constexpr int kStage = BK * (BM + 1) + BK * (BN + 1);
  constexpr int kOut = BM * (BN + 1);
  __shared__ float smem[kStage > kOut ? kStage : kOut];
  float (*As)[BM + 1] = reinterpret_cast<float (*)[BM + 1]>(smem);
  float (*Bs)[BN + 1] =
      reinterpret_cast<float (*)[BN + 1]>(smem + BK * (BM + 1));

  const int gz = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK): consecutive threads walk the contiguous axis, K
    // for an (M, K) A, M for a (K, M) one (trans_a).
    if (!TRANS_A) {
      #pragma unroll
      for (int r = 0; r < (BM * BK) / NT; ++r) {
        const int el = tid + r * NT;
        const int mm = el / BK, kk = el % BK;
        const int gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < M && gk < K)
                         ? to_f32(A[((size_t)gz * M + gm) * K + gk]) : 0.f;
      }
    } else {
      #pragma unroll
      for (int r = 0; r < (BM * BK) / NT; ++r) {
        const int el = tid + r * NT;
        const int kk = el / BM, mm = el % BM;
        const int gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < M && gk < K)
                         ? to_f32(A[((size_t)gz * K + gk) * M + gm]) : 0.f;
      }
    }
    // B tile (BK x BN): consecutive threads walk the contiguous axis.
    if (!TRANS_B) {
      #pragma unroll
      for (int r = 0; r < (BK * BN) / NT; ++r) {
        const int el = tid + r * NT;
        const int kk = el / BN, nn = el % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        Bs[kk][nn] =
            (gk < K && gn < N) ? to_f32(B[((size_t)gz * K + gk) * N + gn])
                               : 0.f;
      }
    } else {
      #pragma unroll
      for (int r = 0; r < (BK * BN) / NT; ++r) {
        const int el = tid + r * NT;
        const int nn = el / BK, kk = el % BK;
        const int gk = k0 + kk, gn = n0 + nn;
        Bs[kk][nn] =
            (gk < K && gn < N) ? to_f32(B[((size_t)gz * N + gn) * K + gk])
                               : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The register tile to shared memory, then the epilogue once per output
  // from one loop (consecutive threads on consecutive columns).
  float (*Cs)[BN + 1] = reinterpret_cast<float (*)[BN + 1]>(smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) Cs[ty + i * TY][tx + j * TX] = acc[i][j];
  __syncthreads();
  for (int el = tid; el < BM * BN; el += NT) {
    const int mm = el / BN, nn = el % BN;
    const int gm = m0 + mm, gn = n0 + nn;
    if (gm < M && gn < N) epilogue_store(e, Cs[mm][nn], gz, M, N, gm, gn);
  }
}

template <typename T, bool TRANS_A, bool TRANS_B>
cudaError_t launch_typed(const void* a, const void* b, const Epilogue& e,
                         int g, int m, int n, int k, cudaStream_t stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  // The narrow decode tile serves small M; trans_a (dW, M a weight's K)
  // always takes the wide one, which halves its instantiations.
  if (!TRANS_A && m <= 16) {
    constexpr int BM = 16, BN = 32, BK = 64, TM = 2, TN = 2;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_kernel<T, BM, BN, BK, TM, TN, false, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, EPILOGUE_ARGS(e), m, n, k);
  } else {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_kernel<T, BM, BN, BK, TM, TN, TRANS_A, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, EPILOGUE_ARGS(e), m, n, k);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_trans(int trans_a, int trans_b, const void* a,
                         const void* b, const Epilogue& e, int g, int m,
                         int n, int k, cudaStream_t stream) {
  if (trans_a && trans_b)
    return launch_typed<T, true, true>(a, b, e, g, m, n, k, stream);
  if (trans_a)
    return launch_typed<T, true, false>(a, b, e, g, m, n, k, stream);
  if (trans_b)
    return launch_typed<T, false, true>(a, b, e, g, m, n, k, stream);
  return launch_typed<T, false, false>(a, b, e, g, m, n, k, stream);
}

// The int8 variant: the loop above over int32 staging and an exact int32
// sum.  With a scale (the int8 policy, quant_in over a dense weight) the
// epilogue runs in f32; without one it stays in int32 (epilogue_store_int).
template <int BM, int BN, int BK, int TM, int TN, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mpgemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   EPILOGUE_PARAMS, int M, int N, int K) {
  const Epilogue e = EPILOGUE_FROM_PARAMS;
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  // The A and B tiles of the K loop; after it, the output tile (Cs).
  constexpr int kStage = BK * (BM + 1) + BK * (BN + 1);
  constexpr int kOut = BM * (BN + 1);
  __shared__ int smem[kStage > kOut ? kStage : kOut];
  int (*As)[BM + 1] = reinterpret_cast<int (*)[BM + 1]>(smem);
  int (*Bs)[BN + 1] = reinterpret_cast<int (*)[BN + 1]>(smem + BK * (BM + 1));

  const size_t g = blockIdx.z;
  A += g * M * K;
  B += g * K * N;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int el = tid; el < BM * BK; el += NT) {
      int mm, kk;
      if (TRANS_A) { kk = el / BM; mm = el % BM; }
      else { mm = el / BK; kk = el % BK; }
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K)
                       ? A[TRANS_A ? (size_t)gk * M + gm : (size_t)gm * K + gk]
                       : 0;
    }
    for (int el = tid; el < BK * BN; el += NT) {
      int kk, nn;
      if (TRANS_B) { nn = el / BK; kk = el % BK; }
      else { kk = el / BN; nn = el % BN; }
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N)
                       ? B[TRANS_B ? (size_t)gn * K + gk : (size_t)gk * N + gn]
                       : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  int (*Cs)[BN + 1] = reinterpret_cast<int (*)[BN + 1]>(smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) Cs[ty + i * TY][tx + j * TX] = acc[i][j];
  __syncthreads();
  const bool int_epilogue = e.scale == nullptr;
  for (int el = tid; el < BM * BN; el += NT) {
    const int mm = el / BN, nn = el % BN;
    const int gm = m0 + mm, gn = n0 + nn;
    if (gm >= M || gn >= N) continue;
    if (int_epilogue)
      epilogue_store_int(e, Cs[mm][nn], g, M, N, gm, gn);
    else
      epilogue_store(e, static_cast<float>(Cs[mm][nn]), g, M, N, gm, gn);
  }
}

template <bool TRANS_A, bool TRANS_B>
cudaError_t launch_int8(const void* a, const void* b, const Epilogue& e,
                        int g, int m, int n, int k, cudaStream_t stream) {
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  if (!TRANS_A && m <= 16) {
    constexpr int BM = 16, BN = 32, BK = 64, TM = 2, TN = 2;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_int8_kernel<BM, BN, BK, TM, TN, false, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, EPILOGUE_ARGS(e), m, n, k);
  } else {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_int8_kernel<BM, BN, BK, TM, TN, TRANS_A, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, EPILOGUE_ARGS(e), m, n, k);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over `g` groups (1 for a 2-D GEMM); returns the
// cudaError_t of the launch (0 = ok).  in_dtype: 0 f32, 1 bf16, 2 int8
// (both operands); out_dtype: 0 f32, 1 bf16, 3 int32; c_dtype: 0 f32, 1
// bf16, 3 int32.  Every operand is contiguous with the group as its leading
// axis; A is (K, M) per group under trans_a, B (N, K) under trans_b.
// `bias`, `extra`, `c`, `row_scale` and `scale` may be null; `bias_stride`
// is N for a (G, N) bias and 0 for one (N,) bias shared by every group;
// `extra` (the gate or residual) has the output's dtype; `c` is read when
// non-null, times `beta`; `row_scale` is the quant_in kinds' (G, M) f32;
// `scale` is one f32 in device memory.
int mpgemm_launch(const void* a, const void* b, void* out, const void* bias,
                  const void* extra, const void* c, const void* row_scale,
                  const void* scale, int g, int m, int n, int k,
                  int bias_stride, int in_dtype, int out_dtype, int c_dtype,
                  int trans_a, int trans_b, int kind, int act, float alpha,
                  float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dtype, bias_stride, c_dtype, kind, act,
                                   alpha, beta);
  if (!epilogue_ok(e) || g <= 0 || g > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == DT_INT8) {
#define K1_INT8(TA, TB) return launch_int8<TA, TB>(a, b, e, g, m, n, k, s)
    if (trans_a && trans_b) K1_INT8(true, true);
    if (trans_a) K1_INT8(true, false);
    if (trans_b) K1_INT8(false, true);
    K1_INT8(false, false);
#undef K1_INT8
  }
  if (in_dtype == DT_BF16)
    return launch_trans<__nv_bfloat16>(trans_a, trans_b, a, b, e, g, m, n, k,
                                       s);
  if (in_dtype == DT_F32)
    return launch_trans<float>(trans_a, trans_b, a, b, e, g, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mpgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
