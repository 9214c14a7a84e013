// K5: paged flash attention over a block-table KV pool, for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::_paged_flash_kernel, launched by
// paged_flash_attention.  For request b, kv head kv and query row t:
//
//     qi   = q_start[b] + t                    (logical query position)
//     key j lives at page block_tables[b, j / ps], offset j % ps
//     mask = j < lengths[b]  [&& j <= qi]  [&& j > qi - window]
//     s    = scale * q . k_j   (f32),  masked s = -1e30 (finite, never -inf)
//     online softmax in f32;  V rows j >= lengths[b] read as zero
//     out  = acc / max(l, 1e-30), cast to q's dtype
//
// GQA: head h = kv * G + gi (the reference's q.reshape(b, hkv, g, tq, d)).
//
// What bounds it on an H100: bytes.  Each step reads the live part of the
// KV pool once per layer (K and V, `lengths[b]` rows per request and kv
// head) and does 4 * D flops per (query row, key) pair -- far below the
// tensor cores' ratio of flops to bytes at these row counts (1..64 rows).
//
// What the design does about it: one block per (q-block, kv head, request)
// with the whole GQA group folded into the block's rows, so each K/V page
// is read from HBM once per kv head, not once per query head.  Keys are
// staged 32 at a time in shared memory as f32 (gathered through the block
// table by the block itself); each warp owns up to 4 query rows, one lane
// per key for the scores and one lane per 32 head dims for the P.V
// accumulator.  The loop stops after the last live key (cdiv over
// lengths[b]): masked keys past it would add nothing, and an idle row
// (lengths[b] == 0) visits no key and writes 0, as the reference does with
// its zeroed V.  Scalar FMAs, no tensor cores: a later PR's work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr float NEG_INF = -1e30f;
constexpr int KT = 32;          // keys per shared-memory chunk (one per lane)
constexpr int MAX_ROWS = 32;    // query rows per block (G * bq)
constexpr int MAX_WARPS = 8;
constexpr int RPW = 4;          // rows per warp: MAX_ROWS / MAX_WARPS
constexpr int DPL = 8;          // head dims per lane: D <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// grid (n_qblocks, Hkv, B); block 32 * nwarps threads; dynamic shared
// memory: q rows [rows][D], K chunk [KT][D + 1], V chunk [KT][D] (f32).
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_flash_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, T* __restrict__ out,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ q_start,
                   const int* __restrict__ lengths, int H, int Hkv, int Tq,
                   int D, int ps, int W, int causal, int window, float scale,
                   int bq) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int rows = G * bq;
  float* qs = smem;
  float* ks = qs + rows * D;
  float* vs = ks + KT * (D + 1);

  const int qb = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int t0 = qb * bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int e = tid; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int gi = r / bq, t = t0 + r % bq;
    qs[e] = t < Tq
        ? to_f32(q[(((size_t)b * H + kv * G + gi) * Tq + t) * D + d])
        : 0.f;
  }

  const int length = lengths[b];
  const int qstart = q_start[b];
  const int kv_len = min(length, W * ps);
  const int* bt = block_tables + (size_t)b * W;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[rr][c] = 0.f;
  }

  for (int j0 = 0; j0 < kv_len; j0 += KT) {
    __syncthreads();  // q staged / previous chunk consumed
    for (int e = tid; e < KT * D; e += blockDim.x) {
      const int jj = e / D, d = e % D;
      const int key = j0 + jj;
      float kval = 0.f, vval = 0.f;  // V rows past the length read as zero
      if (key < kv_len) {
        const size_t off =
            (((size_t)bt[key / ps] * Hkv + kv) * ps + key % ps) * D + d;
        kval = to_f32(kp[off]);
        vval = to_f32(vp[off]);
      }
      ks[jj * (D + 1) + d] = kval;
      vs[jj * D + d] = vval;
    }
    __syncthreads();

    const int key = j0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + rr * nwarps;
      if (r >= rows) break;                 // warp-uniform
      const int t = t0 + r % bq;
      if (t >= Tq) continue;                // warp-uniform
      const int qi = qstart + t;
      const float* qrow = qs + r * D;
      const float* krow = ks + lane * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      s *= scale;
      bool valid = key < kv_len;            // kv_len = min(length, W * ps)
      if (causal) valid = valid && key <= qi;
      if (window > 0) valid = valid && key > qi - window;
      s = valid ? s : NEG_INF;

      const float m_new = fmaxf(m[rr], warp_max(s));
      const float alpha = expf(m[rr] - m_new);
      const float p = expf(s - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[rr][c] *= alpha;
      for (int jj = 0; jj < KT; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vrow = vs + jj * D;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[rr][c] = fmaf(pj, vrow[d], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp + rr * nwarps;
    if (r >= rows) break;
    const int gi = r / bq, t = t0 + r % bq;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* orow = out + (((size_t)b * H + kv * G + gi) * Tq + t) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f32<T>(acc[rr][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp,
                         void* out, const void* bt, const void* qs,
                         const void* ln, int B, int H, int Hkv, int Tq, int D,
                         int ps, int W, int causal, int window, float scale,
                         cudaStream_t stream) {
  const int G = H / Hkv;
  int bq = MAX_ROWS / G;
  if (bq > Tq) bq = Tq;
  const int rows = G * bq;
  int nwarps = rows < MAX_WARPS ? rows : MAX_WARPS;
  // Every warp owns at most RPW rows.
  while ((rows + nwarps - 1) / nwarps > RPW) ++nwarps;
  const size_t smem =
      sizeof(float) * ((size_t)rows * D + (size_t)KT * (D + 1) +
                       (size_t)KT * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Tq + bq - 1) / bq, Hkv, B);
  paged_flash_kernel<T><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<T*>(out),
      static_cast<const int*>(bt), static_cast<const int*>(qs),
      static_cast<const int*>(ln), H, Hkv, Tq, D, ps, W, causal, window,
      scale, bq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The caller guarantees H % Hkv == 0, H / Hkv <= 32, 1 <= D <= 256,
// window <= 0 meaning "no window", and block-table entries that are valid
// page ids of the pool.
int paged_flash_launch(const void* q, const void* k_pages,
                       const void* v_pages, void* out,
                       const void* block_tables, const void* q_start,
                       const void* lengths, int B, int H, int Hkv, int Tq,
                       int D, int ps, int W, int causal, int window,
                       float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_typed<__nv_bfloat16>(q, k_pages, v_pages, out, block_tables,
                                       q_start, lengths, B, H, Hkv, Tq, D, ps,
                                       W, causal, window, scale, s);
  if (dtype == DT_F32)
    return launch_typed<float>(q, k_pages, v_pages, out, block_tables,
                               q_start, lengths, B, H, Hkv, Tq, D, ps, W,
                               causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
