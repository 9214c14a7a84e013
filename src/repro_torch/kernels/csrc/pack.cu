// K6: tile packing with on-the-fly transposition and per-tile quantization,
// for sm_90a.
//
// Replaces the TPU kernels src/repro/packing/pack.py::_pack_kernel and
// ::_pack_quant_kernel (launched by _pack_pallas, 2-D or with the group
// grid axis of a (G, ., .) expert stack).  Packs a row-major (k, n) source
// -- or an (n, k) one under trans_w, transposed during the pack -- into a
// payload of zero-padded (bk, bn) tiles, tile (i, j) at payload[i][j]
// (nkb x nnb tiles); a stack of G such sources, one after the other, packs
// into payload[g][i][j] with scales[g][i][j], the group on blockIdx.z.
// Lanes past k or n read as 0.
//
//   float payload (f32 / bf16): the source value cast (round to nearest
//       even for bf16);
//   int8 / int4: scale = max(amax, 1e-8) / qmax (qmax 127 / 7), then
//       q = clip(rint(x / scale), -qmax, qmax); int4 stores two K-adjacent
//       values per byte, (hi << 4) | (lo & 0xF), in ceil(bk / 2) rows;
//   fp8e4m3: scale = max(amax, 1e-8) / 448, then the saturating e4m3 cast
//       (round to nearest even, never the NaN code) of clip(x / scale).
//
// Payload and scales must be byte-identical to the plain version
// (repro_torch/packing/pack.py::pack_reference): the divisions are IEEE
// (__fdiv_rn) and rounding is rintf, half to even as torch.round.  The
// build takes no --use_fast_math.
//
// What bounds it on an H100: a pack reads the source once and writes the
// payload once, so bytes over the 3.35 TB/s of HBM; it runs once per weight
// at load time.  Design: one block per tile; a block-wide max of |x| (warp
// shuffles, then shared memory), then a second pass over the tile (from L2)
// that quantizes and stores.  Consecutive threads walk the source's
// contiguous axis for the reads (n, or k under trans_w).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include <cstdint>

namespace {

enum { SRC_F32 = 0, SRC_BF16 = 1 };
enum { P_F32 = 0, P_BF16 = 1, P_INT8 = 2, P_INT4 = 3, P_FP8 = 4 };

constexpr int kThreads = 256;

__device__ __forceinline__ float load_src(const void* src, int dt,
                                          size_t idx) {
  if (dt == SRC_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(src)[idx]);
  return static_cast<const float*>(src)[idx];
}

// Logical element (r, c) of tile (i, j): source (i*bk + r, j*bn + c),
// zero outside the (k, n) extent.  `src` points at this group's source.
__device__ __forceinline__ float tile_value(const void* src, int dt, int k,
                                            int n, int bk, int bn,
                                            int trans_w, int i, int j, int r,
                                            int c) {
  if (r >= bk) return 0.f;
  const int gk = i * bk + r, gn = j * bn + c;
  if (gk >= k || gn >= n) return 0.f;
  const size_t idx =
      trans_w ? (size_t)gn * k + gk : (size_t)gk * n + gn;
  return load_src(src, dt, idx);
}

__device__ __forceinline__ float quantize_int(float x, float scale,
                                              float qmax) {
  const float q = rintf(__fdiv_rn(x, scale));
  return fminf(fmaxf(q, -qmax), qmax);
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const void* __restrict__ src, void* __restrict__ payload,
            float* __restrict__ scales, int src_dt, int pcode, int k, int n,
            int bk, int bn, int trans_w) {
  const int j = blockIdx.x, i = blockIdx.y;
  const int nnb = gridDim.x, nkb = gridDim.y;
  const int tile = bk * bn;
  // This tile's index in the (G, nkb, nnb) grid: it places the tile's
  // payload and its scale.
  const size_t t = ((size_t)blockIdx.z * nkb + i) * nnb + j;
  src = static_cast<const char*>(src) +
        (size_t)blockIdx.z * k * n * (src_dt == SRC_BF16 ? 2 : 4);
  // Walk the tile so that consecutive threads read consecutive source
  // addresses: along c for a (k, n) source, along r for an (n, k) one.
  auto coords = [&](int e, int& r, int& c) {
    if (trans_w) { r = e % bk; c = e / bk; }
    else { r = e / bn; c = e % bn; }
  };

  if (pcode == P_F32 || pcode == P_BF16) {
    const size_t base = t * tile;
    for (int e = threadIdx.x; e < tile; e += kThreads) {
      int r, c;
      coords(e, r, c);
      const float v =
          tile_value(src, src_dt, k, n, bk, bn, trans_w, i, j, r, c);
      const size_t o = base + (size_t)r * bn + c;
      if (pcode == P_BF16)
        static_cast<__nv_bfloat16*>(payload)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(payload)[o] = v;
    }
    return;
  }

  // Pass 1: the tile's max |x| (max is exact in any order).
  float amax = 0.f;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    int r, c;
    coords(e, r, c);
    amax = fmaxf(amax, fabsf(tile_value(src, src_dt, k, n, bk, bn, trans_w,
                                        i, j, r, c)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kThreads / 32];
  __shared__ float tile_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  const float qmax =
      pcode == P_INT8 ? 127.f : pcode == P_INT4 ? 7.f : 448.f;
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    const float s = __fdiv_rn(fmaxf(m, 1e-8f), qmax);
    tile_scale = s;
    scales[t] = s;
  }
  __syncthreads();
  const float scale = tile_scale;

  if (pcode == P_INT4) {
    // One thread per payload byte: rows 2r (low nibble) and 2r + 1 (high).
    const int rows = (bk + 1) / 2;
    int8_t* out = static_cast<int8_t*>(payload) + t * rows * bn;
    for (int e = threadIdx.x; e < rows * bn; e += kThreads) {
      const int r = e / bn, c = e % bn;
      const int lo = (int)quantize_int(
          tile_value(src, src_dt, k, n, bk, bn, trans_w, i, j, 2 * r, c),
          scale, qmax);
      const int hi = (int)quantize_int(
          tile_value(src, src_dt, k, n, bk, bn, trans_w, i, j, 2 * r + 1, c),
          scale, qmax);
      out[(size_t)r * bn + c] =
          static_cast<int8_t>(((hi & 0xF) << 4) | (lo & 0xF));
    }
    return;
  }

  const size_t base = t * tile;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    int r, c;
    coords(e, r, c);
    const float v =
        tile_value(src, src_dt, k, n, bk, bn, trans_w, i, j, r, c);
    const size_t o = base + (size_t)r * bn + c;
    if (pcode == P_INT8) {
      static_cast<int8_t*>(payload)[o] =
          static_cast<int8_t>(quantize_int(v, scale, qmax));
    } else {  // P_FP8
      const float x = fminf(fmaxf(__fdiv_rn(v, scale), -448.f), 448.f);
      static_cast<__nv_fp8_storage_t*>(payload)[o] =
          __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
    }
  }
}

}  // namespace

extern "C" {

// Launches K6 on `stream` over a stack of `g` sources (1 for a 2-D weight);
// returns the cudaError_t of the launch (0 = ok).  `scales` is written for
// the codec payloads (int8, int4, fp8) and may be null for the float ones.
int pack_launch(const void* src, void* payload, float* scales, int src_dt,
                int pcode, int g, int k, int n, int bk, int bn, int trans_w,
                void* stream) {
  if (src_dt != SRC_F32 && src_dt != SRC_BF16) return cudaErrorInvalidValue;
  if (pcode < P_F32 || pcode > P_FP8) return cudaErrorInvalidValue;
  if (pcode >= P_INT8 && scales == nullptr) return cudaErrorInvalidValue;
  if (k <= 0 || n <= 0 || bk <= 0 || bn <= 0 || g <= 0 || g > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((n + bn - 1) / bn, (k + bk - 1) / bk, g);
  pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, payload, scales, src_dt, pcode, k, n, bk, bn, trans_w);
  return static_cast<int>(cudaGetLastError());
}

const char* pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
