// K2: the packed-B mixed-precision GEMM with a fused epilogue, 2-D or
// grouped, for sm_90a.
//
// Replaces the packed-B branch of the TPU kernel
// src/repro/kernels/mpgemm.py::make_gemm_kernel (`kernel` reading B through
// an identity tile index map, the int4 decode `unpack_nibbles`, and the
// per-tile scale of `_accumulate`), launched by mpgemm_pallas_spec, and by
// mpgemm_grouped_pallas for a grouped payload (the MoE experts).
// Computes, for every group g < G,
//
//     out[g] = tail(alpha * (sum_kk A[g][:, kk] @ dequant(B[g][kk, j]))
//                   * scale + bias[g])
//
// with A (G, M, K) row-major and B a payload of zero-padded tiles
// payload[G][nkb][nnb][tk][bn] (repro_torch/packing/layout.py), one f32
// scale per tile for the codec payloads, scales[G][nkb][nnb]:
//
//   float A (f32 / bf16) x codec tile (int8, int4, fp8e4m3): each element is
//       decoded, multiplied by the tile's scale in f32 and rounded to A's
//       dtype (bf16) before the product -- the reference's
//       `bf.astype(a.dtype)`; the sum is f32;
//   int8 A x int8 / int4 tile: an exact int32 partial over the tile's bk
//       rows, then acc += float(partial) * tile_scale, so the f32 sum sees
//       the same tile boundaries as the reference;
//   int8 A x fp8e4m3 tile (quant_in's int8 X over an fp8 payload): the
//       reference's int x float branch -- both sides upcast to f32, the
//       tile's scale applied to B in f32 (no rounding to a narrower type),
//       an f32 sum;
//   float A x float tile of the same dtype: no scale.
//
// int4 bytes hold row 2r in the low nibble and row 2r + 1 in the high one,
// sign-extended with arithmetic shifts.  The payload is zero-padded, so only
// A's K edge needs a mask: rows past K are never visited.  `scale` (the int8
// policy's per-tensor sx) is one f32 in device memory; the epilogue is
// gemm_epilogue.cuh's f32 one (scale, alpha, bias, the quant_in row scale,
// activation, gate or residual, beta * C).  The group is blockIdx.z (G = 1
// for a 2-D GEMM): each block moves its A and payload pointers by g times
// the group's extent before the loop.
//
// What bounds it on an H100: decode (M = 2) and chunked prefill (M <= 32)
// read every payload byte once per call, so bytes over the 3.35 TB/s of
// HBM -- a quarter of the bf16 bytes for int4.  Design, simple first: one
// block per 32 output columns and BM rows; each of its 8 warps takes every
// 8th K tile of those columns, one column per lane, so that a warp's loads
// of a payload row are 32 consecutive elements and its A loads are
// broadcasts; the 8 partial sums meet in shared memory once, in warp order.
// Known gaps, for later work: one payload element per lane and load (no
// 16-byte vector loads), no tensor cores, and N / 32 blocks for N = 3072.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "gemm_epilogue.cuh"

namespace {

enum { P_F32 = 0, P_BF16 = 1, P_INT8 = 2, P_INT4 = 3, P_FP8 = 4 };

constexpr int kCols = 32;   // output columns per block, one per lane
constexpr int kWarps = 8;   // K-tile groups per block
constexpr int kThreads = kCols * kWarps;

// Integer element (r, c) of an int8 or int4 payload tile.
template <int P>
__device__ __forceinline__ int decode_int(const void* tile, int r, int c,
                                          int bn) {
  const int8_t* t = static_cast<const int8_t*>(tile);
  if constexpr (P == P_INT4) {
    const int8_t b = t[(size_t)(r >> 1) * bn + c];
    // Low nibble: shift it to the top, then back (arithmetic, sign-extends).
    return (r & 1) ? (b >> 4) : (static_cast<int8_t>(b << 4) >> 4);
  } else {
    return t[(size_t)r * bn + c];
  }
}

// Element (r, c) of one payload tile, before its scale.
template <int P>
__device__ __forceinline__ float decode(const void* tile, int r, int c,
                                        int bn) {
  if constexpr (P == P_F32) {
    return static_cast<const float*>(tile)[(size_t)r * bn + c];
  } else if constexpr (P == P_BF16) {
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(tile)[(size_t)r * bn + c]);
  } else if constexpr (P == P_FP8) {
    const __nv_fp8_storage_t b =
        static_cast<const __nv_fp8_storage_t*>(tile)[(size_t)r * bn + c];
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
  } else {
    return static_cast<float>(decode_int<P>(tile, r, c, bn));
  }
}

template <typename AT>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename AT, int P, int BM>
__global__ void __launch_bounds__(kThreads)
mpgemm_packed_kernel(const AT* __restrict__ A,
                     const void* __restrict__ payload,
                     const float* __restrict__ tile_scales, EPILOGUE_PARAMS,
                     int M, int N, int K, int bk, int bn) {
  const Epilogue e = EPILOGUE_FROM_PARAMS;
  // int8 A takes the exact integer partial against int8 / int4 tiles, and
  // the f32 loop below against fp8 tiles (round_to<int8_t> is the identity).
  constexpr bool kIntDot = std::is_same<AT, int8_t>::value && P != P_FP8;
  constexpr bool kCodec = P >= P_INT8;
  constexpr int kElemBytes = P == P_F32 ? 4 : P == P_BF16 ? 2 : 1;
  // Unroll the row loop (several payload loads in flight) only for the
  // decode shape: at BM = 32 each row already carries 32 products.
  constexpr int kUnroll = BM <= 4 ? 4 : 1;
  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int gn = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  const int mrows = min(BM, M - m0);
  const int nkb = (K + bk - 1) / bk;
  const int nnb = (N + bn - 1) / bn;
  const int tk = P == P_INT4 ? (bk + 1) / 2 : bk;
  const size_t tile_bytes = (size_t)tk * bn * kElemBytes;

  const size_t g = blockIdx.z;
  A += g * M * K;
  payload = static_cast<const char*>(payload) + g * nkb * nnb * tile_bytes;
  if (tile_scales != nullptr) tile_scales += g * nkb * nnb;

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  if (gn < N) {
    const int j = gn / bn, c = gn % bn;
    for (int kk = warp; kk < nkb; kk += kWarps) {
      const void* tile = static_cast<const char*>(payload) +
                         ((size_t)kk * nnb + j) * tile_bytes;
      const int k0 = kk * bk;
      const int rows = min(bk, K - k0);
      const AT* a0 = A + (size_t)m0 * K + k0;
      if constexpr (kIntDot) {
        const float ts = tile_scales[(size_t)kk * nnb + j];
        int part[BM];
#pragma unroll
        for (int i = 0; i < BM; ++i) part[i] = 0;
#pragma unroll(kUnroll)
        for (int r = 0; r < rows; ++r) {
          const int q = decode_int<P>(tile, r, c, bn);
#pragma unroll
          for (int i = 0; i < BM; ++i)
            if (i < mrows)
              part[i] += static_cast<int>(a0[(size_t)i * K + r]) * q;
        }
#pragma unroll
        for (int i = 0; i < BM; ++i)
          acc[i] = __fadd_rn(acc[i],
                             __fmul_rn(static_cast<float>(part[i]), ts));
      } else {
        const float ts = kCodec ? tile_scales[(size_t)kk * nnb + j] : 1.f;
#pragma unroll(kUnroll)
        for (int r = 0; r < rows; ++r) {
          float w = decode<P>(tile, r, c, bn);
          if (kCodec) w = round_to<AT>(__fmul_rn(w, ts));
#pragma unroll
          for (int i = 0; i < BM; ++i)
            if (i < mrows)
              acc[i] = fmaf(to_f32(a0[(size_t)i * K + r]), w, acc[i]);
        }
      }
    }
  }

  // The kWarps partial sums of each output meet here, added in warp order.
  __shared__ float red[kWarps][BM][kCols];
#pragma unroll
  for (int i = 0; i < BM; ++i) red[warp][i][lane] = acc[i];
  __syncthreads();
  for (int o = threadIdx.x; o < BM * kCols; o += kThreads) {
    const int i = o / kCols, cc = o % kCols;
    const int gm = m0 + i, col = blockIdx.x * kCols + cc;
    if (gm >= M || col >= N) continue;
    float v = red[0][i][cc];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][i][cc];
    epilogue_store(e, v, g, M, N, gm, col);
  }
}

template <typename AT, int P>
cudaError_t launch_rows(const void* a, const void* payload, const float* ts,
                        const Epilogue& e, int g, int m, int n, int k, int bk,
                        int bn, cudaStream_t stream) {
  const AT* A = static_cast<const AT*>(a);
  if (m <= 4) {
    constexpr int BM = 4;
    const dim3 grid((n + kCols - 1) / kCols, (m + BM - 1) / BM, g);
    mpgemm_packed_kernel<AT, P, BM><<<grid, kThreads, 0, stream>>>(
        A, payload, ts, EPILOGUE_ARGS(e), m, n, k, bk, bn);
  } else {
    constexpr int BM = 32;
    const dim3 grid((n + kCols - 1) / kCols, (m + BM - 1) / BM, g);
    mpgemm_packed_kernel<AT, P, BM><<<grid, kThreads, 0, stream>>>(
        A, payload, ts, EPILOGUE_ARGS(e), m, n, k, bk, bn);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K2 on `stream` over `g` groups (1 for a 2-D GEMM); returns the
// cudaError_t of the launch (0 = ok).  a_dt: 0 f32, 1 bf16, 2 int8.
// pcode: 0 f32, 1 bf16, 2 int8, 3 int4, 4 fp8e4m3.  Taken pairs: f32 A x
// {f32, int8, int4, fp8}, bf16 A x {bf16, int8, int4, fp8}, int8 A x
// {int8, int4, fp8}.  `tile_scales` is (G, nkb, nnb) f32 for the codec
// payloads; the epilogue's operands are those of mpgemm_launch
// (csrc/mpgemm.cu): `bias`, `extra`, `c`, `row_scale` and `scale` may be
// null, `bias_stride` is N for a (G, N) bias and 0 for a shared (N,) one,
// `extra` has the output's dtype.
int mpgemm_packed_launch(const void* a, const void* payload,
                         const void* tile_scales, void* out, const void* bias,
                         const void* extra, const void* c,
                         const void* row_scale, const void* scale, int g,
                         int m, int n, int k, int bk, int bn, int bias_stride,
                         int a_dt, int pcode, int out_dt, int c_dt, int kind,
                         int act, float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ts = static_cast<const float*>(tile_scales);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dt, bias_stride, c_dt, kind, act, alpha,
                                   beta);
  if (!epilogue_ok(e)) return cudaErrorInvalidValue;
  if (pcode >= P_INT8 && ts == nullptr) return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0 || k <= 0 || bk <= 0 || bn <= 0 || g <= 0 ||
      g > 65535)
    return cudaErrorInvalidValue;
#define K2_LAUNCH(AT, P) \
  return launch_rows<AT, P>(a, payload, ts, e, g, m, n, k, bk, bn, s)
  if (a_dt == DT_BF16) {
    if (pcode == P_BF16) K2_LAUNCH(__nv_bfloat16, P_BF16);
    if (pcode == P_INT8) K2_LAUNCH(__nv_bfloat16, P_INT8);
    if (pcode == P_INT4) K2_LAUNCH(__nv_bfloat16, P_INT4);
    if (pcode == P_FP8) K2_LAUNCH(__nv_bfloat16, P_FP8);
  } else if (a_dt == DT_F32) {
    if (pcode == P_F32) K2_LAUNCH(float, P_F32);
    if (pcode == P_INT8) K2_LAUNCH(float, P_INT8);
    if (pcode == P_INT4) K2_LAUNCH(float, P_INT4);
    if (pcode == P_FP8) K2_LAUNCH(float, P_FP8);
  } else if (a_dt == DT_INT8) {
    if (pcode == P_INT8) K2_LAUNCH(int8_t, P_INT8);
    if (pcode == P_INT4) K2_LAUNCH(int8_t, P_INT4);
    if (pcode == P_FP8) K2_LAUNCH(int8_t, P_FP8);
  }
#undef K2_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mpgemm_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
