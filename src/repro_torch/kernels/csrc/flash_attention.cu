// K4: flash attention over dense K/V, for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel, launched by
// flash_attention.  For request b, kv head kv and query row t:
//
//     qi   = t + (Tk - Tq)                     (right-aligned position)
//     mask = j < Tk  [&& j <= qi if causal]  [&& j > qi - window]
//     s    = scale * q . k_j   (f32),  masked s = -1e30 (finite, never -inf)
//     online softmax in f32 (m, l, acc);  K/V rows past Tk are never read
//     out  = acc / max(l, 1e-30), cast to q's dtype
//
// GQA: head h = kv * G + gi (the reference's q.reshape(b, hkv, g, tq, d)),
// so K/V are never repeated.
//
// What bounds it on an H100: operations at the encoder's and a prefill's
// shapes (4 * D flops per (query row, key) pair over 1500 x 1500 pairs per
// head: far above the card's ratio of flops to bytes), bytes at decode's
// Tq = 1 (every K/V row read for one query row).
//
// What the design does about it: a simple first design that is right.
// One block per (block of query rows, kv head, request), 8 warps, with the
// whole GQA group folded into the block's 32 rows, so each K/V chunk is
// read from HBM once per kv head and block of rows.  Keys are staged 32 at
// a time in shared memory as f32: K transposed (one key per lane, a padded
// stride so neither the stores nor the loads conflict), V row-major.  Each
// warp owns 4 query rows and scores them together, so one K value read
// from shared memory feeds 4 FMAs and one float4 read of a q row feeds 4
// more; P.V gives each lane 32-dim columns of the accumulator.  A warp
// skips the rows it does not own (a decode block has one row).  K/V rows
// load 16 bytes a thread where D and the pointers allow, so a block with
// few rows waits on one memory round trip a chunk, not one an element.
// Blocks visit only the keys some of their rows can see ([qi_lo - window
// + 1, min(qi_hi, Tk - 1)]), so causal and windowed attention skip the
// masked chunks.  Scalar FMAs, no tensor cores, no TMA, no split over the
// KV axis (decode's Tq = 1 launches only B * Hkv blocks, each walking all
// of Tk alone): a later PR's work.
//
// Fully masked rows (a row that sees no key, possible only when Tq > Tk
// under causal) are finite: they average the V rows their block visited
// (zero when it visited none), as the reference averages the rows of its
// own blocks.  No caller makes such rows.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr float NEG_INF = -1e30f;
constexpr int KT = 32;          // keys per shared-memory chunk (one per lane)
constexpr int KTP = KT + 1;     // stride of the transposed K chunk
constexpr int ROWS = 32;        // query rows per block (G * bq)
constexpr int NWARPS = 8;
constexpr int RPW = ROWS / NWARPS;  // rows per warp
static_assert(RPW == 4, "flash_kernel's switch over a warp's rows takes 1-4");

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

// 16 bytes of T at p (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
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

// One staged chunk for the NR rows warp `warp` owns (rows warp, warp +
// NWARPS, ...): scores, the online-softmax update and P.V.  NR is a
// template argument so the hot loops carry no per-row test.
template <int NR, int NC>
__device__ __forceinline__ void score_chunk(
    const float* qs, const float* kt, const float* vs, int D, int Dp,
    int warp, int lane, int j0, int n, int j_hi, int t0, int bq, int off,
    int causal, int window, float scale, float (&m)[RPW], float (&l)[RPW],
    float (&acc)[RPW][NC]) {
  float s[NR];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) s[rr] = 0.f;
  for (int d = 0; d < Dp; d += 4) {
    const float k0 = kt[(d + 0) * KTP + lane];
    const float k1 = kt[(d + 1) * KTP + lane];
    const float k2 = kt[(d + 2) * KTP + lane];
    const float k3 = kt[(d + 3) * KTP + lane];
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      const float4 qv = *reinterpret_cast<const float4*>(
          qs + (warp + rr * NWARPS) * Dp + d);
      s[rr] = fmaf(qv.x, k0, s[rr]);
      s[rr] = fmaf(qv.y, k1, s[rr]);
      s[rr] = fmaf(qv.z, k2, s[rr]);
      s[rr] = fmaf(qv.w, k3, s[rr]);
    }
  }

  const int key = j0 + lane;
  float p[NR];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    const int qi = t0 + (warp + rr * NWARPS) % bq + off;
    bool valid = key <= j_hi;         // j_hi <= Tk - 1
    if (causal) valid = valid && key <= qi;
    if (window > 0) valid = valid && key > qi - window;
    const float sv = valid ? s[rr] * scale : NEG_INF;
    const float m_new = fmaxf(m[rr], warp_max(sv));
    const float alpha = expf(m[rr] - m_new);
    p[rr] = expf(sv - m_new);
    l[rr] = l[rr] * alpha + warp_sum(p[rr]);
    m[rr] = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha;
  }
  for (int jj = 0; jj < n; ++jj) {
    float vv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      vv[c] = d < D ? vs[jj * D + d] : 0.f;
    }
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      const float pj = __shfl_sync(0xffffffffu, p[rr], jj);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[rr][c] = fmaf(pj, vv[c], acc[rr][c]);
    }
  }
}

// grid (n_qblocks, Hkv, B); block NWARPS * 32 threads; dynamic shared
// memory (f32): q rows [ROWS][Dp], K chunk transposed [Dp][KTP], V chunk
// [KT][D].  Dp = D rounded up to 4 (zero-padded), NC = ceil(D / 32).
// `vec`: D is a multiple of 16 bytes of T, so K/V rows load 16 bytes at a
// time (one load a thread for a bf16 chunk of D = 64) instead of one
// element, and a block with few rows does not wait on many round trips.
template <typename T, int NC>
__global__ void __launch_bounds__(NWARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Hkv,
             int Tq, int Tk, int D, int Dp, int causal, int window,
             float scale, int bq, int vec) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kt = qs + ROWS * Dp;
  float* vs = kt + Dp * KTP;

  const int G = H / Hkv;
  const int rows = G * bq;
  const int qb = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int t0 = qb * bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = Tk - Tq;

  for (int e = tid; e < ROWS * Dp; e += blockDim.x) {
    const int r = e / Dp, d = e % Dp;
    float val = 0.f;
    if (r < rows && d < D) {
      const int gi = r / bq, t = t0 + r % bq;
      if (t < Tq)
        val = to_f32(q[(((size_t)b * H + kv * G + gi) * Tq + t) * D + d]);
    }
    qs[e] = val;
  }
  for (int e = tid; e < (Dp - D) * KTP; e += blockDim.x)
    kt[D * KTP + e] = 0.f;     // padding dims, never overwritten

  // The keys any row of this block can see.
  const int qi_lo = t0 + off;
  const int qi_hi = min(t0 + bq, Tq) - 1 + off;
  int j_lo = 0, j_hi = Tk - 1;
  if (causal) j_hi = min(j_hi, qi_hi);
  if (window > 0) j_lo = max(0, qi_lo - window + 1);

  const size_t kv_off = ((size_t)b * Hkv + kv) * Tk * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  // Rows this warp owns (warp, warp + NWARPS, ...): a decode block (one
  // row) scores one row, not RPW.
  const int nr = warp < rows ? min(RPW, (rows - warp + NWARPS - 1) / NWARPS)
                             : 0;

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  for (int j0 = j_lo; j0 <= j_hi; j0 += KT) {
    const int n = min(KT, j_hi + 1 - j0);
    __syncthreads();  // q staged / previous chunk consumed
    if (vec) {
      constexpr int VEC = 16 / sizeof(T);
      for (int e = tid * VEC; e < KT * D; e += blockDim.x * VEC) {
        const int jj = e / D, d = e % D;
        float kf[VEC], vf[VEC];
        if (jj < n) {
          const size_t o = (size_t)(j0 + jj) * D + d;
          load16(kb + o, kf);
          load16(vb + o, vf);
        } else {                        // rows past the range read as zero
#pragma unroll
          for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kt[(d + i) * KTP + jj] = kf[i];
          vs[e + i] = vf[i];
        }
      }
    } else {
      for (int e = tid; e < KT * D; e += blockDim.x) {
        const int jj = e / D, d = e % D;
        float kval = 0.f, vval = 0.f;
        if (jj < n) {
          const size_t o = (size_t)(j0 + jj) * D + d;
          kval = to_f32(kb[o]);
          vval = to_f32(vb[o]);
        }
        kt[d * KTP + jj] = kval;
        vs[e] = vval;
      }
    }
    __syncthreads();
    switch (nr) {                     // warp-uniform
      case 4:
        score_chunk<4, NC>(qs, kt, vs, D, Dp, warp, lane, j0, n, j_hi, t0,
                           bq, off, causal, window, scale, m, l, acc);
        break;
      case 3:
        score_chunk<3, NC>(qs, kt, vs, D, Dp, warp, lane, j0, n, j_hi, t0,
                           bq, off, causal, window, scale, m, l, acc);
        break;
      case 2:
        score_chunk<2, NC>(qs, kt, vs, D, Dp, warp, lane, j0, n, j_hi, t0,
                           bq, off, causal, window, scale, m, l, acc);
        break;
      case 1:
        score_chunk<1, NC>(qs, kt, vs, D, Dp, warp, lane, j0, n, j_hi, t0,
                           bq, off, causal, window, scale, m, l, acc);
        break;
      default:
        break;                        // the warp owns no row
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    if (rr >= nr) break;
    const int r = warp + rr * NWARPS;
    const int gi = r / bq, t = t0 + r % bq;
    if (t >= Tq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    T* orow = out + (((size_t)b * H + kv * G + gi) * Tq + t) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f32<T>(acc[rr][c] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int Hkv, int Tq, int Tk, int D,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  const int G = H / Hkv;
  int bq = ROWS / G;
  if (bq > Tq) bq = Tq;
  const int Dp = (D + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)ROWS * Dp +
                                       (size_t)Dp * KTP + (size_t)KT * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // 16-byte loads need 16-byte rows and 16-byte aligned bases.
  const int vec = (D * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<size_t>(k) % 16 == 0 &&
                  reinterpret_cast<size_t>(v) % 16 == 0;
  dim3 grid((Tq + bq - 1) / bq, Hkv, B);
  flash_kernel<T, NC><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Tq, Tk, D, Dp,
      causal, window, scale, bq, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Hkv, int Tq, int Tk,
                         int D, int causal, int window, float scale,
                         cudaStream_t s) {
#define K4_NC(nc)                                                         \
  case nc:                                                                \
    return launch_nc<T, nc>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,   \
                            window, scale, s)
  switch ((D + 31) / 32) {
    K4_NC(1);
    K4_NC(2);
    K4_NC(3);
    K4_NC(4);
    K4_NC(5);
    K4_NC(6);
    K4_NC(7);
    K4_NC(8);
    default:
      return cudaErrorInvalidValue;
  }
#undef K4_NC
}

}  // namespace

extern "C" {

// Launches K4 on `stream`; returns the cudaError_t of the launch (0 = ok).
// q (B, H, Tq, D), k/v (B, Hkv, Tk, D) and out (B, H, Tq, D) contiguous, of
// one dtype.  The caller guarantees H % Hkv == 0, H / Hkv <= 32,
// 1 <= D <= 256, Tq >= 1, Tk >= 1, B <= 65535, Hkv <= 65535, and window
// <= 0 meaning "no window".
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int Hkv, int Tq, int Tk,
                           int D, int causal, int window, float scale,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, Tk, D,
                                       causal, window, scale, s);
  if (dtype == DT_F32)
    return launch_typed<float>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                               window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
