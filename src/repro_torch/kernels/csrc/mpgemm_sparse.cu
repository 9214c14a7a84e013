// K3: the tile-sparse mixed-precision GEMM with a fused epilogue, 2-D or
// grouped, for sm_90a: the scalar design.  bf16 A against bf16 or int8
// tiles and int8 A against int8 tiles, in 128 x 128 tiles with 16-byte
// rows and bases, run csrc/mpgemm_sparse_wgmma.cu / _int8.cu instead
// (kernels/mpgemm.py::k3_design); this file runs f32 A, other tile shapes
// and misaligned views.
//
// Replaces the TPU kernel src/repro/kernels/mpgemm.py::make_gemm_kernel
// (`sparse_kernel`), launched by _launch_sparse for a TileSparseOperand B
// (2-D, or grouped for the MoE expert stacks).  Computes, for every output
// column c of the g * nnb tile columns (group g = c / nnb, n-tile j =
// c % nnb),
//
//     out[g][:, j] = tail(alpha * (sum over t in [indptr[c], indptr[c+1])
//                         of A[g][:, indices[t]] @ payload[t]) * scale
//                         + bias[g][j])
//
// with A (G, M, K) row-major, payload[nnz + 1][bk][bn] the stored tiles in
// column-major order (repro_torch/sparse/layout.py; tile t belongs to the
// column whose indptr range holds t, at k-tile indices[t]), and
//
//   bf16 A x bf16 tiles, f32 A x f32 tiles: an f32 sum;
//   int8 A x int8 tiles: an exact int32 partial over each tile's bk rows,
//       then acc += float(partial) * tile_scale[t], so the f32 sum sees the
//       reference's tile boundaries;
//   bf16 or f32 A x int8 tiles (an int8 payload under a float policy): each
//       element decoded, multiplied by its tile's scale in f32 and rounded
//       to A's dtype before the product (the reference's
//       `bf.astype(a.dtype)`), an f32 sum.
//
// The reference walks a schedule with first / last flags and gives an
// empty column one "anchor" visit of the trailing zero tile; here a block
// owns its column, so an empty column is a loop that runs no iteration and
// the epilogue runs on a zero sum (the zero tile is never read).  Payload
// tiles are zero-padded past K and N, so only A's K edge needs a mask: the
// tile at k-tile nkb - 1 reads min(bk, K - k0) rows of A, never past K, and
// stores past M and N are masked.  `scale` (the int8 policy's per-tensor
// sx) is one f32 in device memory; the epilogue is gemm_epilogue.cuh's f32
// one (with beta * C and the quant_in row scale).
//
// What bounds it on an H100: decode (M = 2) and chunked prefill (M <= 32)
// read every stored tile once per call, so bytes over the 3.35 TB/s of HBM:
// at 50 % tile density, half of K1's weight bytes.  Design, simple first,
// with a block per (column slice of one tile column c, rows) that reads
// indptr and indices from device memory and walks the column's stored
// tiles; a column's stored-tile count sets its block's work, so a skewed
// pattern is load-imbalanced.  Two loops:
//
//   M <= 4 (decode): K2's loop over the stored tiles instead of all K
//       tiles -- 32 columns a block, one per lane; each of the 8 warps
//       takes every 8th stored tile, so a warp's payload loads are 32
//       consecutive elements of a tile row and its A loads are
//       broadcasts; 4 rows of the tile and of A are loaded before their
//       products (a decode launch has fewer blocks than the card has SMs:
//       loads in flight, not occupancy, bound it); the 8 partial sums meet
//       in shared memory once, in warp order;
//   M > 4 (chunked prefill, M = 32): K1's loop -- a 32 x 64 output tile a
//       block, each stored tile staged 32 rows at a time through shared
//       memory (A and payload), 2 x 4 outputs a thread, the output tile
//       back through shared memory to the epilogue; K2's loop would issue
//       one global load of A per multiply-add at M = 32.
//
// Known gaps of this design (the wgmma one has none of them): no 16-byte
// loads, no tensor cores, no split over a long column.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "gemm_epilogue.cuh"

namespace {

constexpr int kCols = 32;   // output columns per block, one per lane
constexpr int kWarps = 8;   // stored-tile groups per block
constexpr int kThreads = kCols * kWarps;
constexpr int kRows = 4;    // tile rows loaded ahead in the decode loop

template <typename AT>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A payload element as the float product reads it: an int8 one (against
// float A) dequantized by its tile's scale `ts` in f32 and rounded to A's
// dtype; a float one as it is.
template <typename AT, typename PT>
__device__ __forceinline__ float weight(PT w, float ts) {
  if constexpr (std::is_same<PT, int8_t>::value)
    return round_to<AT>(__fmul_rn(static_cast<float>(w), ts));
  else
    return to_f32(w);
}

// The decode loop (M <= BM = 4).  AT is A's element type, PT the
// payload's: the same (bf16, f32 or int8), or float A against int8 tiles.
template <typename AT, typename PT, int BM>
__global__ void __launch_bounds__(kThreads)
mpgemm_sparse_kernel(const AT* __restrict__ A, const PT* __restrict__ payload,
                     const float* __restrict__ tile_scales,
                     const int* __restrict__ indptr,
                     const int* __restrict__ indices, EPILOGUE_PARAMS, int M,
                     int N, int K, int bk, int bn, int nnb, int nsub) {
  const Epilogue e = EPILOGUE_FROM_PARAMS;
  constexpr bool kIntDot = std::is_same<AT, int8_t>::value;
  constexpr bool kDequant = !kIntDot && std::is_same<PT, int8_t>::value;
  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int c = blockIdx.x / nsub;                 // output tile column
  const int g = c / nnb, j = c % nnb;
  const int col0 = (blockIdx.x % nsub) * kCols;    // first column in tile
  const int cc = col0 + lane;
  const int gn = j * bn + cc;
  const int m0 = blockIdx.y * BM;
  const int mrows = min(BM, M - m0);

  A += (size_t)g * M * K;

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  if (cc < bn && gn < N) {
    const int lo = indptr[c], hi = indptr[c + 1];
    for (int t = lo + warp; t < hi; t += kWarps) {
      const PT* tile = payload + (size_t)t * bk * bn + cc;
      const int k0 = indices[t] * bk;
      const int rows = min(bk, K - k0);
      const AT* a0 = A + (size_t)m0 * K + k0;
      // kRows rows of the tile and of A are loaded before their products,
      // so that a block keeps that many loads in flight: the launches have
      // fewer blocks than the card has SMs, so latency, not occupancy,
      // bounds them.
      PT wv[kRows];
      AT av[kRows][BM];
      if constexpr (kIntDot) {
        int part[BM];
#pragma unroll
        for (int i = 0; i < BM; ++i) part[i] = 0;
        for (int r0 = 0; r0 < rows; r0 += kRows) {
          const int n_r = min(kRows, rows - r0);
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            wv[u] = u < n_r ? tile[(size_t)(r0 + u) * bn] : PT{};
#pragma unroll
            for (int i = 0; i < BM; ++i)
              av[u][i] = (u < n_r && i < mrows)
                             ? a0[(size_t)i * K + r0 + u] : AT{};
          }
#pragma unroll
          for (int u = 0; u < kRows; ++u)
#pragma unroll
            for (int i = 0; i < BM; ++i)
              part[i] += static_cast<int>(av[u][i]) *
                         static_cast<int>(wv[u]);
        }
        const float ts = tile_scales[t];
#pragma unroll
        for (int i = 0; i < BM; ++i)
          acc[i] = __fadd_rn(acc[i],
                             __fmul_rn(static_cast<float>(part[i]), ts));
      } else {
        const float ts = kDequant ? tile_scales[t] : 1.f;
        for (int r0 = 0; r0 < rows; r0 += kRows) {
          const int n_r = min(kRows, rows - r0);
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            wv[u] = u < n_r ? tile[(size_t)(r0 + u) * bn] : PT{};
#pragma unroll
            for (int i = 0; i < BM; ++i)
              av[u][i] = (u < n_r && i < mrows)
                             ? a0[(size_t)i * K + r0 + u] : AT{};
          }
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const float w = weight<AT>(wv[u], ts);
#pragma unroll
            for (int i = 0; i < BM; ++i)
              acc[i] = fmaf(to_f32(av[u][i]), w, acc[i]);
          }
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
    const int i = o / kCols, l = o % kCols;
    const int gm = m0 + i, col = j * bn + col0 + l;
    if (gm >= M || col0 + l >= bn || col >= N) continue;
    float v = red[0][i][l];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][i][l];
    epilogue_store(e, v, g, M, N, gm, col);
  }
}

// An element widened for the product: int for int8, else f32.
template <typename S, typename T>
__device__ __forceinline__ S widen(T x) {
  if constexpr (std::is_same<S, int>::value) return static_cast<int>(x);
  else return to_f32(x);
}

// The chunked-prefill loop (M > 4): a BM x BN output tile of one tile
// column, each stored tile staged BK rows at a time, TM x TN outputs a
// thread; int8 sums each tile exactly in int32 before its scale, float A
// stages int8 tiles dequantized (weight()).
template <typename AT, typename PT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mpgemm_sparse_tiled_kernel(const AT* __restrict__ A,
                           const PT* __restrict__ payload,
                           const float* __restrict__ tile_scales,
                           const int* __restrict__ indptr,
                           const int* __restrict__ indices, EPILOGUE_PARAMS,
                           int M, int N, int K, int bk, int bn, int nnb,
                           int nsub) {
  const Epilogue e = EPILOGUE_FROM_PARAMS;
  constexpr bool kIntDot = std::is_same<AT, int8_t>::value;
  constexpr bool kDequant = !kIntDot && std::is_same<PT, int8_t>::value;
  using S = typename std::conditional<kIntDot, int, float>::type;
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  // The staging loops below run a whole number of rounds, unrolled.
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile split");
  // The A and tile stages of the loop; after it, the output tile (Cs).
  constexpr int kStage = BK * (BM + 1) + BK * (BN + 1);
  constexpr int kOut = BM * (BN + 1);
  static_assert(sizeof(S) == sizeof(float), "one shared buffer for both");
  __shared__ float smem[kStage > kOut ? kStage : kOut];
  S (*As)[BM + 1] = reinterpret_cast<S (*)[BM + 1]>(smem);
  S (*Bs)[BN + 1] = reinterpret_cast<S (*)[BN + 1]>(smem + BK * (BM + 1));

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c = blockIdx.x / nsub;                 // output tile column
  const int g = c / nnb, j = c % nnb;
  const int col0 = (blockIdx.x % nsub) * BN;       // first column in tile
  const int m0 = blockIdx.y * BM;

  A += (size_t)g * M * K;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;

  const int lo = indptr[c], hi = indptr[c + 1];
  for (int t = lo; t < hi; ++t) {
    const PT* tile = payload + (size_t)t * bk * bn;
    const int k0 = indices[t] * bk;
    const int rows = min(bk, K - k0);
    const float ts = (kIntDot || kDequant) ? tile_scales[t] : 1.f;
    int part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) part[i][jj] = 0;
    for (int kc = 0; kc < rows; kc += BK) {
      // A rows m0.., K columns k0 + kc..: consecutive threads walk K.
      #pragma unroll
      for (int q = 0; q < (BM * BK) / NT; ++q) {
        const int el = tid + q * NT;
        const int mm = el / BK, kk = el % BK;
        const int gm = m0 + mm, r = kc + kk;
        As[kk][mm] = (gm < M && r < rows)
                         ? widen<S>(A[(size_t)gm * K + k0 + r]) : S(0);
      }
      // Payload rows kc.., columns col0..: consecutive threads walk N.
      #pragma unroll
      for (int q = 0; q < (BK * BN) / NT; ++q) {
        const int el = tid + q * NT;
        const int kk = el / BN, nn = el % BN;
        const int r = kc + kk, cc = col0 + nn;
        if constexpr (kIntDot)
          Bs[kk][nn] = (r < rows && cc < bn)
                           ? widen<S>(tile[(size_t)r * bn + cc]) : S(0);
        else
          Bs[kk][nn] = (r < rows && cc < bn)
                           ? weight<AT>(tile[(size_t)r * bn + cc], ts) : S(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        S a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) b[jj] = Bs[kk][tx + jj * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj) {
            if constexpr (kIntDot) part[i][jj] += a[i] * b[jj];
            else acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
          }
      }
      __syncthreads();
    }
    if constexpr (kIntDot) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          acc[i][jj] = __fadd_rn(
              acc[i][jj], __fmul_rn(static_cast<float>(part[i][jj]), ts));
    }
  }

  // The loop's last __syncthreads() came after its last read of the
  // stages, so the output tile may reuse them.
  float (*Cs)[BN + 1] = reinterpret_cast<float (*)[BN + 1]>(smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) Cs[ty + i * TY][tx + jj * TX] = acc[i][jj];
  __syncthreads();
  for (int el = tid; el < BM * BN; el += NT) {
    const int mm = el / BN, nn = el % BN;
    const int gm = m0 + mm, cc = col0 + nn, col = j * bn + cc;
    if (gm < M && cc < bn && col < N)
      epilogue_store(e, Cs[mm][nn], g, M, N, gm, col);
  }
}

template <typename AT, typename PT>
cudaError_t launch_rows(const void* a, const void* payload, const float* ts,
                        const int* indptr, const int* indices,
                        const Epilogue& e, int g, int m, int n, int k, int bk,
                        int bn, cudaStream_t stream) {
  const AT* A = static_cast<const AT*>(a);
  const PT* P = static_cast<const PT*>(payload);
  const int nnb = (n + bn - 1) / bn;
  if (m <= 4) {
    constexpr int BM = 4;
    const int nsub = (bn + kCols - 1) / kCols;
    const long long nblocks = (long long)g * nnb * nsub;
    if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)nblocks, (m + BM - 1) / BM);
    mpgemm_sparse_kernel<AT, PT, BM><<<grid, kThreads, 0, stream>>>(
        A, P, ts, indptr, indices, EPILOGUE_ARGS(e), m, n, k, bk, bn, nnb,
        nsub);
  } else {
    constexpr int BM = 32, BN = 64, BK = 32, TM = 2, TN = 4;
    const int nsub = (bn + BN - 1) / BN;
    const long long nblocks = (long long)g * nnb * nsub;
    if (nblocks > 0x7fffffffLL || (m + BM - 1) / BM > 65535)
      return cudaErrorInvalidValue;
    const dim3 grid((unsigned)nblocks, (m + BM - 1) / BM);
    mpgemm_sparse_tiled_kernel<AT, PT, BM, BN, BK, TM, TN>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
            A, P, ts, indptr, indices, EPILOGUE_ARGS(e), m, n, k, bk, bn, nnb,
        nsub);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream` over `g` groups (1 for a 2-D GEMM); returns the
// cudaError_t of the launch (0 = ok).  a_dt: 0 f32, 1 bf16, 2 int8; p_dt
// the payload's: A's own, or 2 (int8) against float A.  `tile_scales` is
// (nnz + 1) f32 for an int8 payload; `indptr` (g * nnb + 1) and `indices`
// (nnz) are int32 in device memory; the epilogue's operands are those of
// mpgemm_launch (csrc/mpgemm.cu): `bias`, `extra`, `c`, `row_scale` and
// `scale` may be null, `bias_stride` is N for a (G, N) bias and 0 for a
// shared (N,) one, `extra` has the output's dtype.
int mpgemm_sparse_launch(const void* a, const void* payload,
                         const void* tile_scales, const void* indptr,
                         const void* indices, void* out, const void* bias,
                         const void* extra, const void* c,
                         const void* row_scale, const void* scale, int g,
                         int m, int n, int k, int bk, int bn, int bias_stride,
                         int a_dt, int p_dt, int out_dt, int c_dt, int kind,
                         int act, float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ts = static_cast<const float*>(tile_scales);
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const Epilogue e = make_epilogue(out, bias, extra, c, row_scale, scale,
                                   out_dt, bias_stride, c_dt, kind, act, alpha,
                                   beta);
  if (!epilogue_ok(e)) return cudaErrorInvalidValue;
  if (p_dt == DT_INT8 && ts == nullptr) return cudaErrorInvalidValue;
  if (ip == nullptr || m <= 0 || n <= 0 || k <= 0 || bk <= 0 || bn <= 0 ||
      g <= 0)
    return cudaErrorInvalidValue;
#define K3_LAUNCH(AT, PT) \
  return launch_rows<AT, PT>(a, payload, ts, ip, ix, e, g, m, n, k, bk, bn, s)
  if (a_dt == DT_BF16 && p_dt == DT_BF16) K3_LAUNCH(__nv_bfloat16,
                                                    __nv_bfloat16);
  if (a_dt == DT_F32 && p_dt == DT_F32) K3_LAUNCH(float, float);
  if (a_dt == DT_INT8 && p_dt == DT_INT8) K3_LAUNCH(int8_t, int8_t);
  if (a_dt == DT_BF16 && p_dt == DT_INT8) K3_LAUNCH(__nv_bfloat16, int8_t);
  if (a_dt == DT_F32 && p_dt == DT_INT8) K3_LAUNCH(float, int8_t);
#undef K3_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mpgemm_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
