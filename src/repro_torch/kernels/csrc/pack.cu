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
// at load time and once per step for a trainable packed weight's gradient.
// Two designs, picked by packing/pack.py::k6_design from the operands:
//
//   "stream" (pack_stream_kernel, below): one block per tile.  The tile is
//       read once, in 16-byte vectors (64 KB in flight a block, two blocks
//       an SM), into shared memory as f32 -- transposed there under
//       trans_w -- with |x|'s max taken on the way; the payload is then
//       written in 16-byte runs of a payload row from shared memory (int4:
//       each byte formed from rows 2r and 2r + 1 in registers).  Takes
//       16-byte-aligned contiguous sources whose contiguous axis and whose
//       tile span along it are multiples of 16 bytes, payload rows of a
//       multiple of 16 bytes, and tiles of at most 128 x 128 (64 KB of
//       f32).  Tried and measured slower on phi3's and granite's packs: a
//       cluster of two blocks a tile meeting their maxima through
//       distributed shared memory, and a persistent grid that loads the
//       next tile while it writes this one (PERF.md, section 6).
//   "simt" (pack_kernel): the first, scalar port, for everything else: one
//       block per tile; a block-wide max of |x|, then a second pass over
//       the tile (from L2) that quantizes and stores, one element a thread.
//
// The two run the same operations on every element, so their bytes are
// equal.
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
// read once, the dense operand written once).  Two designs, picked by
// packing/pack.py::k7_design:
//
//   "stream" (unpack_stream_kernel): one block per 32 payload rows of a
//       tile, its tile's scale read once a thread; a thread owns runs of 8
//       consecutive columns of a tile row (int4: of rows 2r and 2r + 1, one
//       8-byte read), reads each run's payload as one vector and writes 16
//       bytes (bf16) or 32 (f32) of output, two runs in flight at once.
//       Takes payload tiles and outputs whose rows are multiples of 8
//       columns.
//   "simt" (unpack_kernel): one thread per output element, a row of blocks
//       per output row, consecutive threads on consecutive columns.
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

// ------------------------------------------------------- the stream designs

// Threads a block: K6's stream design reads a 128 x 128 f32 tile in one
// round of 8 vectors a thread; K7's takes 32 payload rows a block.
constexpr int kPackThreads = 512;
constexpr int kUnpackThreads = 256;
// The stream packer's shared tile: at most this many f32 (64 KB), rows of a
// multiple of 32 floats.
constexpr int kStreamMaxFloats = 128 * 128;

// (row, run) of the units e = e0, e0 + step, e0 + 2 step, ... of a tile whose
// rows hold `per` units, walked without a division a unit.
struct Walk {
  int r, c, dr, dc, per;
  __device__ __forceinline__ Walk(int e0, int per_, int step) : per(per_) {
    r = e0 / per;
    c = e0 - r * per;
    dr = step / per;
    dc = step - dr * per;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
};

// The shared tile's 16-byte slots are XOR-swizzled by row, so that 8 lanes
// on 8 consecutive rows (the payload writes), on rows 2r of 8 consecutive r
// (int4), on one row (the untransposed reads) or on 16 columns of 2 x 4
// rows (the transposed reads of an f32 source) hit 8 distinct slots of the
// 128-byte bank line.
__device__ __forceinline__ int swizzle(int r) { return (r ^ (r >> 3)) & 7; }

// Float index of tile element (r, c); `pitch` is a multiple of 32.
__device__ __forceinline__ int tile_at(int r, int c, int pitch) {
  return r * pitch + (((c >> 2) ^ swizzle(r)) << 2) + (c & 3);
}

__device__ __forceinline__ float4 tile_slot(const float* tile, int r,
                                            int slot, int pitch) {
  return reinterpret_cast<const float4*>(
      tile)[(r * pitch >> 2) + (slot ^ swizzle(r))];
}

// The values of a 16-byte source vector: 4 f32, or 8 bf16 widened exactly.
template <int SRC>
__device__ __forceinline__ void widen(const uint4& v, float* x) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (SRC == SRC_BF16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[2 * q] = __uint_as_float(w[q] << 16);
      x[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = __uint_as_float(w[q]);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// One payload byte of a codec value (int8, fp8e4m3): the scalar kernel's
// operations.
template <int PC>
__device__ __forceinline__ unsigned code_byte(float x, float scale) {
  if constexpr (PC == P_INT8) {
    return static_cast<unsigned>(
               static_cast<int>(quantize_int(x, scale, 127.f))) & 0xffu;
  } else {
    const float y = fminf(fmaxf(__fdiv_rn(x, scale), -448.f), 448.f);
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  }
}

// A tile's place: group z, tile row i, tile column j.
struct TileAt {
  int z, i, j;
};

// K6's stream design: the source values of one tile, U 16-byte vectors a
// thread a round (a 128 x 128 f32 tile takes one), into registers (load)
// and from them into the shared tile (store, which also takes max |x|).
// Untransposed: consecutive threads on consecutive vectors of a tile row.
// Under trans_w the source row gn = j*bn + c runs along the tile's r: a
// warp reads 2 consecutive vectors of 16 source rows (one 32-byte sector
// each) and stores the values transposed, one float at a time.
template <int SRC, bool TRANS, int U>
struct StreamTile {
  static constexpr int ESZ = SRC == SRC_BF16 ? 2 : 4;
  static constexpr int VW = 16 / ESZ;           // source values a vector
  const char* src;
  int k, n, bk, bn, pitch;

  // Vectors (units under trans_w) a tile round walks.
  __device__ __forceinline__ int units() const {
    if constexpr (TRANS)
      return ((bn + 15) >> 4) * (((bk / VW) + 1) >> 1) * 32;
    else
      return bk * (bn / VW);
  }

  // Under trans_w: unit e's first tile row r (of VW) and column c, or
  // false for a unit past the tile.
  __device__ __forceinline__ bool unit(int e, int& r, int& c) const {
    const int pairs = ((bk / VW) + 1) >> 1;
    const int q = e >> 5;
    c = (q / pairs) * 16 + (e & 15);
    r = ((q % pairs) * 2 + ((e >> 4) & 1)) * VW;
    return e < units() && c < bn && r < bk;
  }

  __device__ __forceinline__ void load(const TileAt& at, int e0, uint4* v)
      const {
    const char* base = src + (size_t)at.z * k * n * ESZ;
    const int total = units();
    Walk w(e0, TRANS ? 1 : bn / VW, kPackThreads);   // untransposed
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int r = w.r, c = w.c * VW;
      const bool live = TRANS ? unit(e0 + u * kPackThreads, r, c)
                              : e0 + u * kPackThreads < total;
      const int gk = at.i * bk + r, gn = at.j * bn + c;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (live && gk < k && gn < n)
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            base + (TRANS ? (size_t)gn * k + gk : (size_t)gk * n + gn) *
                       ESZ));
      if constexpr (!TRANS) w.next();
    }
  }

  __device__ __forceinline__ void store(int e0, const uint4* v, float* tile,
                                        float& amax) const {
    const int total = units();
    Walk w(e0, TRANS ? 1 : bn / VW, kPackThreads);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int r = w.r, c = w.c * VW;
      const bool live = TRANS ? unit(e0 + u * kPackThreads, r, c)
                              : e0 + u * kPackThreads < total;
      if constexpr (!TRANS) w.next();
      if (!live) continue;
      float x[VW];
      widen<SRC>(v[u], x);
#pragma unroll
      for (int q = 0; q < VW; ++q) amax = fmaxf(amax, fabsf(x[q]));
      if constexpr (TRANS) {
#pragma unroll
        for (int q = 0; q < VW; ++q) tile[tile_at(r + q, c, pitch)] = x[q];
      } else {
        float4* row = reinterpret_cast<float4*>(tile + r * pitch);
        const int sw = swizzle(r), s = c >> 2;
        if constexpr (VW == 4) {
          row[s ^ sw] = make_float4(x[0], x[1], x[2], x[3]);
        } else {
          // Two slots: lanes 4-7 of each 8 store their second one first,
          // so that one store of 8 lanes covers 8 distinct slots.
          const float4 a = make_float4(x[0], x[1], x[2], x[3]);
          const float4 b = make_float4(x[4], x[5], x[6], x[7]);
          const int flip = (s >> 3) & 1;
          row[(s + flip) ^ sw] = flip ? b : a;
          row[(s + 1 - flip) ^ sw] = flip ? a : b;
        }
      }
    }
  }
};

// K6, the stream design.  Grid (nnb, nkb, G), one block a tile, held in
// dynamic shared memory of bk rows of `pitch` floats (bn rounded up to 32).
template <int SRC, int PC, bool TRANS>
__global__ void __launch_bounds__(kPackThreads, 2)
pack_stream_kernel(const void* __restrict__ src, void* __restrict__ payload,
                   float* __restrict__ scales, int k, int n, int bk, int bn,
                   int pitch) {
  extern __shared__ float4 stream_smem[];
  float* tile = reinterpret_cast<float*>(stream_smem);
  __shared__ float warp_max[kPackThreads / 32];
  constexpr int U = 8;                           // vectors in flight a thread
  constexpr int ROUND = kPackThreads * U;
  constexpr bool CODEC = PC >= P_INT8;
  constexpr int PB = PC == P_F32 ? 4 : PC == P_BF16 ? 2 : 1;
  constexpr int CW = 16 / PB;                    // columns a payload run
  const StreamTile<SRC, TRANS, U> st{static_cast<const char*>(src), k, n,
                                     bk, bn, pitch};
  const int tid = threadIdx.x;
  const TileAt at{(int)blockIdx.z, (int)blockIdx.y, (int)blockIdx.x};
  const size_t t =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int prow = PC == P_INT4 ? (bk + 1) >> 1 : bk;
  const int runs = bn / CW;

  // Phase 1: the tile into shared memory, zero past k and n, read once.
  float amax = 0.f;
  for (int e0 = 0; e0 < st.units(); e0 += ROUND) {
    uint4 v[U];
    st.load(at, e0 + tid, v);
    st.store(e0 + tid, v, tile, amax);
  }
  // Phase 2: the tile's scale from max |x| (exact in any order).
  if constexpr (CODEC) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  }
  __syncthreads();
  float scale = 1.f;
  if constexpr (CODEC) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kPackThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    const float qmax = PC == P_INT8 ? 127.f : PC == P_INT4 ? 7.f : 448.f;
    scale = __fdiv_rn(fmaxf(m, 1e-8f), qmax);
    if (tid == 0) scales[t] = scale;
  }

  // Phase 3: 16-byte runs of payload rows.  8 consecutive threads take
  // one run of 8 consecutive rows (distinct slots in shared memory); 4
  // such groups a warp take 4 consecutive runs of those rows (64
  // contiguous bytes a row in device memory).
  char* out = static_cast<char*>(payload) + (size_t)t * prow * bn * PB;
  const int total = ((prow + 7) >> 3) * runs * 8;
  Walk w(tid >> 3, runs, kPackThreads >> 3);
  for (int e = tid; e < total; e += kPackThreads, w.next()) {
    const int r = w.r * 8 + (tid & 7), slot = w.c * (CW / 4);
    if (r >= prow) continue;
    uint4 o;
    if constexpr (PC == P_F32) {
      const float4 a = tile_slot(tile, r, slot, pitch);
      o = make_uint4(__float_as_uint(a.x), __float_as_uint(a.y),
                     __float_as_uint(a.z), __float_as_uint(a.w));
    } else if constexpr (PC == P_BF16) {
      const float4 a = tile_slot(tile, r, slot, pitch);
      const float4 b = tile_slot(tile, r, slot + 1, pitch);
      o = make_uint4(bf16_bits(a.x) | bf16_bits(a.y) << 16,
                     bf16_bits(a.z) | bf16_bits(a.w) << 16,
                     bf16_bits(b.x) | bf16_bits(b.y) << 16,
                     bf16_bits(b.z) | bf16_bits(b.w) << 16);
    } else if constexpr (PC == P_INT4) {
      // Byte c: row 2r's value in the low nibble, row 2r + 1's (zero
      // past an odd bk) in the high one.
      const bool has_hi = 2 * r + 1 < bk;
      unsigned word[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 a = tile_slot(tile, 2 * r, slot + s, pitch);
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (has_hi) b = tile_slot(tile, 2 * r + 1, slot + s, pitch);
        const float lo[4] = {a.x, a.y, a.z, a.w};
        const float hi[4] = {b.x, b.y, b.z, b.w};
        unsigned wd = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int l = (int)quantize_int(lo[q], scale, 7.f);
          const int h = (int)quantize_int(hi[q], scale, 7.f);
          wd |= static_cast<unsigned>(((h & 0xF) << 4) | (l & 0xF))
                << (8 * q);
        }
        word[s] = wd;
      }
      o = make_uint4(word[0], word[1], word[2], word[3]);
    } else {  // P_INT8, P_FP8: one byte a value
      unsigned word[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 a = tile_slot(tile, r, slot + s, pitch);
        word[s] = code_byte<PC>(a.x, scale) |
                  code_byte<PC>(a.y, scale) << 8 |
                  code_byte<PC>(a.z, scale) << 16 |
                  code_byte<PC>(a.w, scale) << 24;
      }
      o = make_uint4(word[0], word[1], word[2], word[3]);
    }
    *reinterpret_cast<uint4*>(out + ((size_t)r * bn + w.c * CW) * PB) = o;
  }
}

// One payload value of K7 as f32, times the tile's scale for a codec: the
// scalar kernel's operations.
template <int PC>
__device__ __forceinline__ float decode(unsigned byte, float scale) {
  if constexpr (PC == P_INT8) {
    return static_cast<float>(static_cast<int8_t>(byte)) * scale;
  } else {  // P_FP8: e4m3 is exact in half, half exact in f32
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(byte), __NV_E4M3);
    return __half2float(__half(h)) * scale;
  }
}

// K7's stream design: payload rows a block.
constexpr int kUnpackRows = 32;

// K7, the stream design.  Grid (nnb * splits, nkb, G): block x = j * splits
// + s takes payload rows [s * kUnpackRows, (s + 1) * kUnpackRows) of tile
// (i, j).
template <int PC, int OUT>
__global__ void __launch_bounds__(kUnpackThreads)
unpack_stream_kernel(const void* __restrict__ payload,
                     const float* __restrict__ scales, void* __restrict__ out,
                     int k, int n, int bk, int bn, int splits) {
  constexpr int PB = PC == P_F32 ? 4 : PC == P_BF16 ? 2 : 1;
  constexpr int U = 2;                 // runs in flight a thread
  constexpr int OB = OUT == OUT_BF16 ? 2 : 4;
  const int j = blockIdx.x / splits, s = blockIdx.x - j * splits;
  const int i = blockIdx.y, gg = blockIdx.z, tid = threadIdx.x;
  const size_t t = ((size_t)gg * gridDim.y + i) * (gridDim.x / splits) + j;
  const int prow = PC == P_INT4 ? (bk + 1) >> 1 : bk;
  const int p0 = s * kUnpackRows;
  const int rows = (prow - p0 < kUnpackRows ? prow - p0 : kUnpackRows);
  const int per = bn >> 3, total = rows * per;
  const float scale = PC >= P_INT8 ? __ldg(scales + t) : 1.f;
  const char* tile = static_cast<const char*>(payload) +
                     (t * prow + p0) * bn * PB;
  char* dst = static_cast<char*>(out) + (size_t)gg * k * n * OB;
  const int b0 = PC == P_INT4 ? 2 * p0 : p0;   // this block's first tile row
  const int gk0 = i * bk + b0, left = bk - b0;
  Walk w(tid, per, kUnpackThreads);
  for (int e0 = 0; e0 < total; e0 += kUnpackThreads * U) {
    // A run's payload: 32 bytes (f32), 16 (bf16) or 8 (int8, fp8, int4).
    uint4 v[U][PB == 4 ? 2 : 1];
    Walk at = w;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gk = gk0 + (PC == P_INT4 ? 2 * at.r : at.r);
      const int gn = j * bn + 8 * at.c;
      const bool live =
          e0 + u * kUnpackThreads + tid < total && gk < k && gn < n;
      const char* p = tile + ((size_t)at.r * bn + 8 * at.c) * PB;
      v[u][0] = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (PB == 4) {
        v[u][1] = make_uint4(0u, 0u, 0u, 0u);
        if (live) {
          v[u][0] = __ldg(reinterpret_cast<const uint4*>(p));
          v[u][1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
        }
      } else if constexpr (PB == 2) {
        if (live) v[u][0] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        if (live) {
          const uint2 b = __ldg(reinterpret_cast<const uint2*>(p));
          v[u][0].x = b.x;
          v[u][0].y = b.y;
        }
      }
      at.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gk = gk0 + (PC == P_INT4 ? 2 * w.r : w.r);
      const int gn = j * bn + 8 * w.c;
      if (e0 + u * kUnpackThreads + tid < total && gk < k && gn < n) {
        // x[0..7]: output row gk; int4: x[8..15] row gk + 1.
        float x[16];
        unsigned wd[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                          0u, 0u, 0u, 0u};
        if constexpr (PB == 4) {
          wd[4] = v[u][1].x;
          wd[5] = v[u][1].y;
          wd[6] = v[u][1].z;
          wd[7] = v[u][1].w;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if constexpr (PC == P_F32) {
            x[q] = __uint_as_float(wd[q]);
          } else if constexpr (PC == P_BF16) {
            const unsigned h = wd[q >> 1];
            x[q] = __uint_as_float((q & 1) ? h & 0xffff0000u : h << 16);
          } else {
            const unsigned byte = (wd[q >> 2] >> (8 * (q & 3))) & 0xffu;
            if constexpr (PC == P_INT4) {
              const int b = static_cast<int8_t>(byte);
              x[q] = static_cast<float>(((b & 0xF) ^ 8) - 8) * scale;
              x[8 + q] = static_cast<float>(b >> 4) * scale;
            } else {
              x[q] = decode<PC>(byte, scale);
            }
          }
        }
        const int outs = PC == P_INT4 && 2 * w.r + 1 < left && gk + 1 < k
                             ? 2 : 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h >= outs) break;
          const float* y = x + 8 * h;
          char* o = dst + ((size_t)(gk + h) * n + gn) * OB;
          if constexpr (OUT == OUT_BF16) {
            *reinterpret_cast<uint4*>(o) = make_uint4(
                bf16_bits(y[0]) | bf16_bits(y[1]) << 16,
                bf16_bits(y[2]) | bf16_bits(y[3]) << 16,
                bf16_bits(y[4]) | bf16_bits(y[5]) << 16,
                bf16_bits(y[6]) | bf16_bits(y[7]) << 16);
          } else {
            reinterpret_cast<float4*>(o)[0] =
                make_float4(y[0], y[1], y[2], y[3]);
            reinterpret_cast<float4*>(o)[1] =
                make_float4(y[4], y[5], y[6], y[7]);
          }
        }
      }
      w.next();
    }
  }
}

template <int SRC, int PC, bool TRANS>
int launch_pack_stream(const void* src, void* payload, float* scales, int g,
                       int k, int n, int bk, int bn, cudaStream_t stream) {
  const auto kernel = pack_stream_kernel<SRC, PC, TRANS>;
  // Above 48 KB only with the attribute: set on every launch (a launch on
  // another card needs it too); a missing one fails the launch below.
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStreamMaxFloats * (int)sizeof(float));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int pitch = (bn + 31) & ~31;
  const dim3 grid((n + bn - 1) / bn, (k + bk - 1) / bk, g);
  kernel<<<grid, kPackThreads, (size_t)bk * pitch * sizeof(float),
           stream>>>(src, payload, scales, k, n, bk, bn, pitch);
  return static_cast<int>(cudaGetLastError());
}

template <int SRC, bool TRANS>
int pack_stream_by_payload(int pcode, const void* src, void* payload,
                           float* scales, int g, int k, int n, int bk, int bn,
                           cudaStream_t s) {
  switch (pcode) {
    case P_F32:
      return launch_pack_stream<SRC, P_F32, TRANS>(src, payload, scales, g,
                                                   k, n, bk, bn, s);
    case P_BF16:
      return launch_pack_stream<SRC, P_BF16, TRANS>(src, payload, scales, g,
                                                    k, n, bk, bn, s);
    case P_INT8:
      return launch_pack_stream<SRC, P_INT8, TRANS>(src, payload, scales, g,
                                                    k, n, bk, bn, s);
    case P_INT4:
      return launch_pack_stream<SRC, P_INT4, TRANS>(src, payload, scales, g,
                                                    k, n, bk, bn, s);
    default:
      return launch_pack_stream<SRC, P_FP8, TRANS>(src, payload, scales, g,
                                                   k, n, bk, bn, s);
  }
}

template <int PC, int OUT>
int launch_unpack_stream(const void* payload, const float* scales, void* out,
                         int g, int k, int n, int bk, int bn,
                         cudaStream_t stream) {
  const int prow = PC == P_INT4 ? (bk + 1) >> 1 : bk;
  const int splits = (prow + kUnpackRows - 1) / kUnpackRows;
  const dim3 grid(splits * ((n + bn - 1) / bn), (k + bk - 1) / bk, g);
  unpack_stream_kernel<PC, OUT><<<grid, kUnpackThreads, 0, stream>>>(
      payload, scales, out, k, n, bk, bn, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int OUT>
int unpack_stream_by_payload(int pcode, const void* payload,
                             const float* scales, void* out, int g, int k,
                             int n, int bk, int bn, cudaStream_t s) {
  switch (pcode) {
    case P_F32:
      return launch_unpack_stream<P_F32, OUT>(payload, scales, out, g, k, n,
                                              bk, bn, s);
    case P_BF16:
      return launch_unpack_stream<P_BF16, OUT>(payload, scales, out, g, k, n,
                                               bk, bn, s);
    case P_INT8:
      return launch_unpack_stream<P_INT8, OUT>(payload, scales, out, g, k, n,
                                               bk, bn, s);
    case P_INT4:
      return launch_unpack_stream<P_INT4, OUT>(payload, scales, out, g, k, n,
                                               bk, bn, s);
    default:
      return launch_unpack_stream<P_FP8, OUT>(payload, scales, out, g, k, n,
                                              bk, bn, s);
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

// Launches K6's stream design on `stream` (arguments as pack_launch's);
// returns the cudaError_t of the launch, cudaErrorInvalidValue for operands
// outside the design (packing/pack.py::k6_design: 16-byte-aligned source,
// its contiguous axis -- n, or k under trans_w -- and the tile's span along
// it multiples of 16 bytes, payload rows of a multiple of 16 bytes, at most
// 128 x 128 f32 of tile in shared memory).
int pack_stream_launch(const void* src, void* payload, float* scales,
                       int src_dt, int pcode, int g, int k, int n, int bk,
                       int bn, int trans_w, void* stream) {
  if (src_dt != SRC_F32 && src_dt != SRC_BF16) return cudaErrorInvalidValue;
  if (pcode < P_F32 || pcode > P_FP8) return cudaErrorInvalidValue;
  if (pcode >= P_INT8 && scales == nullptr) return cudaErrorInvalidValue;
  if (k <= 0 || n <= 0 || bk <= 0 || bn <= 0 || g <= 0 || g > 65535 ||
      (k + bk - 1) / bk > 65535)
    return cudaErrorInvalidValue;
  const int esz = src_dt == SRC_BF16 ? 2 : 4;
  const int pb = pcode == P_F32 ? 4 : pcode == P_BF16 ? 2 : 1;
  const int pitch = trans_w ? k : n, span = trans_w ? bk : bn;
  if (reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(payload) % 16 || (pitch * esz) % 16 ||
      (span * esz) % 16 || (bn * pb) % 16 ||
      bk * ((bn + 31) & ~31) > kStreamMaxFloats)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_dt == SRC_BF16)
    return trans_w ? pack_stream_by_payload<SRC_BF16, true>(
                         pcode, src, payload, scales, g, k, n, bk, bn, s)
                   : pack_stream_by_payload<SRC_BF16, false>(
                         pcode, src, payload, scales, g, k, n, bk, bn, s);
  return trans_w ? pack_stream_by_payload<SRC_F32, true>(
                       pcode, src, payload, scales, g, k, n, bk, bn, s)
                 : pack_stream_by_payload<SRC_F32, false>(
                       pcode, src, payload, scales, g, k, n, bk, bn, s);
}

// Launches K7's stream design on `stream` (arguments as unpack_launch's);
// returns the cudaError_t of the launch, cudaErrorInvalidValue for operands
// outside the design (packing/pack.py::k7_design: 16-byte-aligned payload
// and output, bn and n multiples of 8).
int unpack_stream_launch(const void* payload, const float* scales, void* out,
                         int pcode, int out_dt, int g, int k, int n, int bk,
                         int bn, void* stream) {
  if (pcode < P_F32 || pcode > P_FP8) return cudaErrorInvalidValue;
  if (out_dt != OUT_F32 && out_dt != OUT_BF16) return cudaErrorInvalidValue;
  if (pcode >= P_INT8 && scales == nullptr) return cudaErrorInvalidValue;
  if (k <= 0 || n <= 0 || bk <= 0 || bn <= 0 || g <= 0 || g > 65535 ||
      (k + bk - 1) / bk > 65535 || bn % 8 || n % 8 ||
      reinterpret_cast<uintptr_t>(payload) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dt == OUT_BF16
             ? unpack_stream_by_payload<OUT_BF16>(pcode, payload, scales, out,
                                                  g, k, n, bk, bn, s)
             : unpack_stream_by_payload<OUT_F32>(pcode, payload, scales, out,
                                                 g, k, n, bk, bn, s);
}

const char* pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
