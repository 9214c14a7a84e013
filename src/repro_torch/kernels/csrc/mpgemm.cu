// K1: the dense mixed-precision GEMM with a fused epilogue, 2-D or grouped,
// for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/mpgemm.py::make_gemm_kernel
// (dense body `kernel`), launched by mpgemm_pallas_spec for one GEMM and
// by mpgemm_grouped_pallas for G of them (the MoE expert GEMMs).
// Computes, for every group g < G,
//
//     out[g] = tail(alpha * (A[g] @ op(B[g])) * scale + bias[g])
//     tail = act(acc) | act(acc) * gate[g] | act(acc) + residual[g]
//
// with A (G, M, K) row-major -- or (G, K, M) under trans_a, the backward's dW =
// op(A)^T B (float inputs, trans_b off) -- B (G, K, N) row-major or (G, N, K)
// under trans_b, bf16 or f32 inputs summed in f32, or int8 inputs summed
// exactly in int32 over the whole K (the int8 policy), an f32 bias of N values
// per group (bias_stride = N) or shared by all (bias_stride = 0), gate /
// residual (G, M, N) in the output dtype, and a bf16 or f32 output.  The 2-D
// GEMM is the case G = 1: the group is blockIdx.z, so one instantiation serves
// both.  The float kernel folds the group into its row indices (A's and C's row
// g * M + m, B's row g * K + k); the int8 kernel instead moves its pointers by
// the group's extent before the loop.  Each form is the faster one for its loop
// on an H100 (built side by side, with bit-equal outputs): moved pointers made
// the float loop much slower at the decode shapes, folded indices the int8
// loop.  `scale` is an optional f32 scalar in device memory (the int8 policy's
// sx * sw), read by the kernel so that the host never waits for it.  The
// epilogue runs in f32 in the order of
// repro_torch/core/gemm_spec.py::apply_epilogue (float(acc) * scale, alpha,
// bias, tail).
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
// either way); M, N and K edges masked at the loads and the store; the
// epilogue once after the loop.  Small M uses a narrow tile (16 x 32) so
// that more blocks stream the weight.  The int8 kernel is the same loop
// over int32 staging and integer multiply-adds; it is a kernel of its own
// because one template for both compiled the float loop into code about
// 30 % slower on an H100 at M = 2 (with bit-equal outputs).  Known gaps,
// for later work: no vectorised or asynchronous loads (cp.async / TMA), no
// split-K for decode (N / 32 blocks cannot fill 132 SMs when N = 3072), no
// wgmma.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "gemm_epilogue.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Thread (ty, tx) owns rows ty + i * TY and columns tx + j * TX of the tile:
// strided ownership keeps the shared-memory reads of a warp on distinct
// banks and its global stores coalesced.
template <typename T, typename OutT, int BM, int BN, int BK, int TM, int TN,
          bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mpgemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
              OutT* __restrict__ C, const float* __restrict__ bias,
              const OutT* __restrict__ extra, int M, int N, int K,
              int bias_stride, int kind, int act, float alpha,
              const float* __restrict__ scale) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

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
      for (int e = tid; e < BM * BK; e += NT) {
        const int mm = e / BK, kk = e % BK;
        const int gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < M && gk < K)
                         ? to_f32(A[((size_t)gz * M + gm) * K + gk]) : 0.f;
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int kk = e / BM, mm = e % BM;
        const int gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < M && gk < K)
                         ? to_f32(A[((size_t)gz * K + gk) * M + gm]) : 0.f;
      }
    }
    // B tile (BK x BN): consecutive threads walk the contiguous axis.
    if (!TRANS_B) {
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, nn = e % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        Bs[kk][nn] =
            (gk < K && gn < N) ? to_f32(B[((size_t)gz * K + gk) * N + gn])
                               : 0.f;
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        const int nn = e / BK, kk = e % BK;
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      const size_t o = ((size_t)gz * M + gm) * N + gn;
      float v = acc[i][j];
      if (scale != nullptr) v *= *scale;
      if (alpha != 1.f) v *= alpha;
      if (bias != nullptr) v += bias[gz * bias_stride + gn];
      v = activate(v, act);
      if (kind == KIND_GATED) v *= to_f32(extra[o]);
      else if (kind == KIND_RESIDUAL) v += to_f32(extra[o]);
      C[o] = from_f32<OutT>(v);
    }
  }
}

template <typename T, typename OutT, bool TRANS_A, bool TRANS_B>
cudaError_t launch_typed(const void* a, const void* b, void* out,
                         const void* bias, const void* extra,
                         const float* scale, int g, int m, int n, int k,
                         int bias_stride, int kind, int act, float alpha,
                         cudaStream_t stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  OutT* C = static_cast<OutT*>(out);
  const float* bi = static_cast<const float*>(bias);
  const OutT* ex = static_cast<const OutT*>(extra);
  // The narrow decode tile serves small M; trans_a (dW, M a weight's K)
  // always takes the wide one, which halves its instantiations.
  if (!TRANS_A && m <= 16) {
    constexpr int BM = 16, BN = 32, BK = 64, TM = 2, TN = 2;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_kernel<T, OutT, BM, BN, BK, TM, TN, false, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, C, bi, ex, m, n, k, bias_stride, kind, act, alpha, scale);
  } else {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_kernel<T, OutT, BM, BN, BK, TM, TN, TRANS_A, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, C, bi, ex, m, n, k, bias_stride, kind, act, alpha, scale);
  }
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_trans(int trans_a, int trans_b, const void* a,
                         const void* b, void* out, const void* bias,
                         const void* extra, const float* scale, int g, int m,
                         int n, int k, int bias_stride, int kind, int act,
                         float alpha, cudaStream_t stream) {
  if (trans_a)   // trans_a with trans_b is refused by mpgemm_launch
    return launch_typed<T, OutT, true, false>(a, b, out, bias, extra, scale,
                                              g, m, n, k, bias_stride, kind,
                                              act, alpha, stream);
  if (trans_b)
    return launch_typed<T, OutT, false, true>(a, b, out, bias, extra, scale,
                                              g, m, n, k, bias_stride, kind,
                                              act, alpha, stream);
  return launch_typed<T, OutT, false, false>(a, b, out, bias, extra, scale,
                                             g, m, n, k, bias_stride, kind,
                                             act, alpha, stream);
}

// The int8 variant: the loop above over int32 staging and an exact int32
// sum; the output (and the gate / residual operand, of the output's dtype)
// is f32 or bf16, chosen at run time.
template <int BM, int BN, int BK, int TM, int TN, bool TRANS_B>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mpgemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   void* __restrict__ C, const float* __restrict__ bias,
                   const void* __restrict__ extra,
                   const float* __restrict__ scale, int M, int N, int K,
                   int bias_stride, int out_dt, int kind, int act,
                   float alpha) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  __shared__ int As[BK][BM + 1];
  __shared__ int Bs[BK][BN + 1];

  const size_t g = blockIdx.z;
  const size_t out_bytes = out_dt == DT_BF16 ? 2 : 4;
  A += g * M * K;
  B += g * K * N;
  C = static_cast<char*>(C) + g * M * N * out_bytes;
  if (extra != nullptr)
    extra = static_cast<const char*>(extra) + g * M * N * out_bytes;
  if (bias != nullptr) bias += g * bias_stride;

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
    for (int e = tid; e < BM * BK; e += NT) {
      const int mm = e / BK, kk = e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      int kk, nn;
      if (TRANS_B) { nn = e / BK; kk = e % BK; }
      else { kk = e / BN; nn = e % BN; }
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      epilogue_store(static_cast<float>(acc[i][j]), (size_t)gm * N + gn, gn,
                     C, bias, extra, scale, out_dt, kind, act, alpha);
    }
  }
}

template <bool TRANS_B>
cudaError_t launch_int8(const void* a, const void* b, void* out,
                        const float* bias, const void* extra,
                        const float* scale, int g, int m, int n, int k,
                        int bias_stride, int out_dt, int kind, int act,
                        float alpha, cudaStream_t stream) {
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  if (m <= 16) {
    constexpr int BM = 16, BN = 32, BK = 64, TM = 2, TN = 2;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_int8_kernel<BM, BN, BK, TM, TN, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, out, bias, extra, scale, m, n, k, bias_stride, out_dt, kind,
            act, alpha);
  } else {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
    mpgemm_int8_kernel<BM, BN, BK, TM, TN, TRANS_B>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, B, out, bias, extra, scale, m, n, k, bias_stride, out_dt, kind,
            act, alpha);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over `g` groups (1 for a 2-D GEMM); returns the
// cudaError_t of the launch (0 = ok).  in_dtype: 0 f32, 1 bf16, 2 int8
// (both operands); out_dtype: 0 f32, 1 bf16.  Every operand is contiguous
// with the group as its leading axis; A is (K, M) per group under trans_a
// (float operands only, trans_b off).  `bias`, `extra` and `scale` may be
// null; `bias_stride` is N for a (G, N) bias and 0 for one (N,) bias shared
// by every group; `extra` is read for kind 1 (gated) and kind 2 (residual)
// and has the output's dtype; `scale` is one f32 in device memory.
int mpgemm_launch(const void* a, const void* b, void* out, const void* bias,
                  const void* extra, const void* scale, int g, int m, int n,
                  int k, int bias_stride, int in_dtype, int out_dtype,
                  int trans_a, int trans_b, int kind, int act, float alpha,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g <= 0 || g > 65535 || bias_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (trans_a && (trans_b || in_dtype == DT_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == DT_INT8) {
    const float* bi = static_cast<const float*>(bias);
    if (trans_b)
      return launch_int8<true>(a, b, out, bi, extra, sc, g, m, n, k,
                               bias_stride, out_dtype, kind, act, alpha, s);
    return launch_int8<false>(a, b, out, bi, extra, sc, g, m, n, k,
                              bias_stride, out_dtype, kind, act, alpha, s);
  }
#define K1_LAUNCH(T, OutT)                                                   \
  return launch_trans<T, OutT>(trans_a, trans_b, a, b, out, bias, extra, sc, \
                               g, m, n, k, bias_stride, kind, act, alpha, s)
  if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    K1_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    K1_LAUNCH(__nv_bfloat16, float);
  if (in_dtype == DT_F32 && out_dtype == DT_F32) K1_LAUNCH(float, float);
  if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    K1_LAUNCH(float, __nv_bfloat16);
#undef K1_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mpgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
