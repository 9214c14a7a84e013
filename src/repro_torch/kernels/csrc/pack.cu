// K6: tile packing with on-the-fly transposition and per-tile quantization,
// and K7, its inverse (the tile unpacker), for sm_90a.  The two share the
// payload codes and the codec constants.
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
//
// K7 replaces src/repro/packing/pack.py::_unpack_kernel and
// ::_unpack_quant_kernel (launched by _unpack_pallas): payload tiles back to
// the dense (k, n) operand -- (g, k, n) for a grouped payload -- with the
// transpose already resolved, in f32 or bf16.  A float payload is cast; a
// codec payload is decoded (int8 as is, int4 nibbles sign-extended, low
// nibble = even k, fp8e4m3 exactly through half) and multiplied in f32 by
// its tile's scale, then cast once: the IEEE product and rounding of the
// plain version (repro_torch/packing/pack.py::unpack_reference), so the two
// are bit-equal.  It serves training's backward of a packed weight and a
// float payload's forward under the int8 policy.  Bound: bytes (the payload
// read once, the dense operand written once); one thread per output
// element, a row of blocks per output row, consecutive threads on
// consecutive columns (the contiguous axis of both the tile rows and the
// output).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

enum { OUT_F32 = 0, OUT_BF16 = 1 };

// Element (r, c) of group gg of the dense output: tile (r / bk, c / bn),
// lane (r % bk, c % bn) of the payload.  One block row of threads per
// output row (blockIdx.y, blockIdx.z: row and group), so no thread divides
// a 64-bit index.
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const void* __restrict__ payload,
              const float* __restrict__ scales, void* __restrict__ out,
              int pcode, int out_dt, int g, int k, int n, int bk, int bn) {
  const int nkb = (k + bk - 1) / bk, nnb = (n + bn - 1) / bn;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  const int j = c / bn, cc = c % bn;
  for (int gg = blockIdx.z; gg < g; gg += gridDim.z) {
    for (int r = blockIdx.y; r < k; r += gridDim.y) {
      const int i = r / bk, rr = r % bk;
      const size_t t = ((size_t)gg * nkb + i) * nnb + j;
      float v;
      if (pcode == P_INT4) {
        const int rows = (bk + 1) / 2;
        const int b = static_cast<const int8_t*>(
            payload)[(t * rows + rr / 2) * bn + cc];
        const int q = (rr & 1) ? (b >> 4) : (((b & 0xF) ^ 8) - 8);
        v = static_cast<float>(q) * scales[t];
      } else {
        const size_t e = (t * bk + rr) * bn + cc;
        if (pcode == P_F32) {
          v = static_cast<const float*>(payload)[e];
        } else if (pcode == P_BF16) {
          v = __bfloat162float(
              static_cast<const __nv_bfloat16*>(payload)[e]);
        } else if (pcode == P_INT8) {
          v = static_cast<float>(static_cast<const int8_t*>(payload)[e]) *
              scales[t];
        } else {  // P_FP8: e4m3 is exact in half, half exact in f32
          const __half_raw h = __nv_cvt_fp8_to_halfraw(
              static_cast<const __nv_fp8_storage_t*>(payload)[e],
              __NV_E4M3);
          v = __half2float(__half(h)) * scales[t];
        }
      }
      const size_t o = ((size_t)gg * k + r) * n + c;
      if (out_dt == OUT_BF16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
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

// Launches K7 on `stream`: the dense (g, k, n) operand of a payload of g
// groups (1 for a 2-D weight) in f32 (out_dt 0) or bf16 (1); returns the
// cudaError_t of the launch (0 = ok).  `scales` is read for the codec
// payloads (int8, int4, fp8) and may be null for the float ones.
int unpack_launch(const void* payload, const float* scales, void* out,
                  int pcode, int out_dt, int g, int k, int n, int bk, int bn,
                  void* stream) {
  if (pcode < P_F32 || pcode > P_FP8) return cudaErrorInvalidValue;
  if (out_dt != OUT_F32 && out_dt != OUT_BF16) return cudaErrorInvalidValue;
  if (pcode >= P_INT8 && scales == nullptr) return cudaErrorInvalidValue;
  if (k <= 0 || n <= 0 || bk <= 0 || bn <= 0 || g <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads, k < 65535 ? k : 65535,
                  g < 65535 ? g : 65535);
  unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      payload, scales, out, pcode, out_dt, g, k, n, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

const char* pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
