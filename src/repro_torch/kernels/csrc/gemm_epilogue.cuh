// Device code shared by the MPGEMM kernels (K1 mpgemm.cu, K2
// mpgemm_packed.cu, K3 mpgemm_sparse.cu): the codes the wrappers pass,
// element conversions, the activations and the fused epilogue of one
// output element, in the order of
// repro_torch/core/gemm_spec.py::apply_epilogue.  Each kernel source
// compiles on its own into a library.
//
// Every epilogue input is a run-time argument: a kernel source
// instantiates its inner loops only.  The epilogue of an f32 accumulator
// runs in f32; that of an int32 accumulator with no scale (K1's int8
// product under the op-level API) keeps the reference's integers: alpha,
// the bias and beta are truncated toward zero to int32, as
// jnp.asarray(x, int32) does, and the sum never passes through f32.
//
// What the layout is for (each point measured on an H100, chip_ab.py):
// * the paths the kernels had before C, row scales and int32 outputs -- no
//   C, no row scale, an f32 or bf16 output, the linear, gated or residual
//   tail -- take a small inline epilogue; everything else calls one
//   out-of-line copy (epilogue_store_full, epilogue_store_int).  The whole
//   epilogue inlined into every unrolled output of every instantiation
//   made mpgemm.cu's build run past 20 minutes; called out of line for
//   every path it slowed the decode kernels by 30-90 %;
// * K1 and K3's prefill loop pass their register tile through shared
//   memory and run the epilogue from one loop, so each kernel holds one
//   copy of it;
// * the epilogue's pointers are __restrict__ kernel parameters (macros
//   below): a pointer inside a struct carries no __restrict__, and one
//   that might alias A or B kept the K loop's loads off the read-only
//   data path.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

enum { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2, DT_INT32 = 3 };
enum {
  KIND_LINEAR = 0, KIND_GATED = 1, KIND_RESIDUAL = 2, KIND_QUANT_IN = 3,
  KIND_QUANT_IN_RESIDUAL = 4
};
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU_TANH = 3 };

// What the epilogue reads and writes.  Every (G, M, N) operand is
// contiguous with the group leading; null pointers are absent operands.
struct Epilogue {
  void* out;               // (G, M, N), dtype out_dt
  const float* bias;       // N values per group (bias_stride N) or shared (0)
  const void* extra;       // gate / residual, (G, M, N) in the output's dtype
  const void* c;           // C, (G, M, N) in dtype c_dt; read when non-null
  const float* row_scale;  // quant_in row scales, (G, M)
  const float* scale;      // one f32 (the int8 policy's sx * sw)
  int out_dt, bias_stride, c_dt, kind, act;
  float alpha, beta;
  int full;                // 1: C, row scales, int32 output or quant_in
};

// A kernel takes the epilogue's pointers as __restrict__ parameters and
// its codes as one struct (EPILOGUE_PARAMS), rebuilds the Epilogue from
// them (EPILOGUE_FROM_PARAMS), and is launched with EPILOGUE_ARGS(e).
struct EpilogueCodes {
  int out_dt, bias_stride, c_dt, kind, act;
  float alpha, beta;
  int full;
};
#define EPILOGUE_PARAMS                                                   \
  void* __restrict__ ep_out, const float* __restrict__ ep_bias,           \
      const void* __restrict__ ep_extra, const void* __restrict__ ep_c,   \
      const float* __restrict__ ep_row_scale,                             \
      const float* __restrict__ ep_scale, EpilogueCodes ep_codes
#define EPILOGUE_FROM_PARAMS                                              \
  Epilogue{ep_out, ep_bias, ep_extra, ep_c, ep_row_scale, ep_scale,       \
           ep_codes.out_dt, ep_codes.bias_stride, ep_codes.c_dt,          \
           ep_codes.kind, ep_codes.act, ep_codes.alpha, ep_codes.beta,    \
           ep_codes.full}
#define EPILOGUE_ARGS(e)                                                  \
  (e).out, (e).bias, (e).extra, (e).c, (e).row_scale, (e).scale,          \
      EpilogueCodes{(e).out_dt, (e).bias_stride, (e).c_dt, (e).kind,      \
                    (e).act, (e).alpha, (e).beta, (e).full}

inline Epilogue make_epilogue(void* out, const void* bias, const void* extra,
                              const void* c, const void* row_scale,
                              const void* scale, int out_dt, int bias_stride,
                              int c_dt, int kind, int act, float alpha,
                              float beta) {
  const int full = c != nullptr || row_scale != nullptr ||
                   out_dt == DT_INT32 || kind == KIND_QUANT_IN ||
                   kind == KIND_QUANT_IN_RESIDUAL;
  return Epilogue{out, static_cast<const float*>(bias), extra, c,
                  static_cast<const float*>(row_scale),
                  static_cast<const float*>(scale), out_dt, bias_stride,
                  c_dt, kind, act, alpha, beta, full};
}

// The checks every launch shares: codes in range, and the operands each
// kind and beta need.
inline bool epilogue_ok(const Epilogue& e) {
  const bool row = e.kind == KIND_QUANT_IN || e.kind == KIND_QUANT_IN_RESIDUAL;
  const bool extra = e.kind == KIND_GATED || e.kind == KIND_RESIDUAL ||
                     e.kind == KIND_QUANT_IN_RESIDUAL;
  return (e.out_dt == DT_F32 || e.out_dt == DT_BF16 || e.out_dt == DT_INT32)
      && e.kind >= KIND_LINEAR && e.kind <= KIND_QUANT_IN_RESIDUAL
      && (!row || e.row_scale != nullptr) && (!extra || e.extra != nullptr)
      && (e.c == nullptr || e.c_dt == DT_F32 || e.c_dt == DT_BF16 ||
          e.c_dt == DT_INT32)
      && e.bias_stride >= 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_SILU:
      return x / (1.f + expf(-x));
    case ACT_GELU_TANH: {
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
    }
    default:
      return x;
  }
}

// Element i of an f32, bf16 or int32 tensor whose dtype is chosen at run
// time, as f32.
__device__ __forceinline__ float load_f32(const void* p, size_t i, int dt) {
  switch (dt) {
    case DT_BF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case DT_INT32:
      return __int2float_rn(static_cast<const int*>(p)[i]);
    default:
      return static_cast<const float*>(p)[i];
  }
}

// The same element cast to int32 as astype(int32) casts: truncated toward
// zero.
__device__ __forceinline__ int load_i32(const void* p, size_t i, int dt) {
  if (dt == DT_INT32) return static_cast<const int*>(p)[i];
  return __float2int_rz(load_f32(p, i, dt));
}

__device__ __forceinline__ void store_f32(void* out, size_t i, int dt,
                                          float v) {
  if (dt == DT_BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else if (dt == DT_INT32)
    static_cast<int*>(out)[i] = __float2int_rz(v);
  else
    static_cast<float*>(out)[i] = v;
}

// The tail of an f32 value v of output element idx (row r = g * M + m):
// the row scale (quant_in), the activation, the gate or residual, then
// beta * C.
__device__ __forceinline__ float tail_f32(const Epilogue& e, float v,
                                          size_t idx, size_t r) {
  if (e.kind == KIND_QUANT_IN || e.kind == KIND_QUANT_IN_RESIDUAL)
    v *= e.row_scale[r];
  v = activate(v, e.act);
  if (e.kind == KIND_GATED)
    v *= load_f32(e.extra, idx, e.out_dt);
  else if (e.kind == KIND_RESIDUAL || e.kind == KIND_QUANT_IN_RESIDUAL)
    v += load_f32(e.extra, idx, e.out_dt);
  if (e.c != nullptr) v += e.beta * load_f32(e.c, idx, e.c_dt);
  return v;
}

// out[g][m][n] = tail(v * scale * alpha + bias[g][n]) + beta * C for an
// f32 accumulator value v: every variant, out of line.
static __device__ __noinline__ void epilogue_store_full(Epilogue e, float v,
                                                        size_t g, int M,
                                                        int N, int m, int n) {
  const size_t r = g * M + m, idx = r * N + n;
  if (e.scale != nullptr) v *= *e.scale;
  if (e.alpha != 1.f) v *= e.alpha;
  if (e.bias != nullptr) v += e.bias[g * e.bias_stride + n];
  store_f32(e.out, idx, e.out_dt, tail_f32(e, v, idx, r));
}

// The same, inline where the kernels' existing paths need it (no C, no row
// scales, an f32 or bf16 output, the linear, gated or residual tail) and a
// call to epilogue_store_full otherwise: the loops of those paths compile as
// they did before the other variants existed.
__device__ __forceinline__ void epilogue_store(const Epilogue& e, float v,
                                               size_t g, int M, int N, int m,
                                               int n) {
  if (e.full) {
    epilogue_store_full(e, v, g, M, N, m, n);
    return;
  }
  const size_t idx = (g * M + m) * N + n;
  if (e.scale != nullptr) v *= *e.scale;
  if (e.alpha != 1.f) v *= e.alpha;
  if (e.bias != nullptr) v += e.bias[g * e.bias_stride + n];
  v = activate(v, e.act);
  if (e.kind != KIND_LINEAR) {
    const float x = load_f32(e.extra, idx, e.out_dt);
    v = e.kind == KIND_GATED ? v * x : v + x;
  }
  if (e.out_dt == DT_BF16)
    static_cast<__nv_bfloat16*>(e.out)[idx] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(e.out)[idx] = v;
}

// int32 products and sums that wrap on overflow, as the reference's int32
// arithmetic does (signed overflow is undefined in C++).
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// The same for an int32 accumulator and no scale, in integers: alpha, the
// bias and beta truncated to int32; the gate, residual and C cast to int32;
// relu keeps the sum in int32 (the wrapper refuses silu).  As in the
// reference, the tanh GELU turns it into f32 (the gate or residual, cast to
// int32 first, and beta * C then join in f32), and a quant_in tail turns it
// into f32 at the row scale.
static __device__ __noinline__ void epilogue_store_int(Epilogue e, int v,
                                                       size_t g, int M, int N,
                                                       int m, int n) {
  const size_t r = g * M + m, idx = r * N + n;
  v = wrap_mul(v, __float2int_rz(e.alpha));
  if (e.bias != nullptr)
    v = wrap_add(v, __float2int_rz(e.bias[g * e.bias_stride + n]));
  if (e.kind == KIND_QUANT_IN || e.kind == KIND_QUANT_IN_RESIDUAL) {
    store_f32(e.out, idx, e.out_dt, tail_f32(e, __int2float_rn(v), idx, r));
    return;
  }
  if (e.act == ACT_GELU_TANH) {
    float f = activate(__int2float_rn(v), e.act);
    if (e.kind == KIND_GATED)
      f *= __int2float_rn(load_i32(e.extra, idx, e.out_dt));
    else if (e.kind == KIND_RESIDUAL)
      f += __int2float_rn(load_i32(e.extra, idx, e.out_dt));
    if (e.c != nullptr) f += e.beta * load_f32(e.c, idx, e.c_dt);
    store_f32(e.out, idx, e.out_dt, f);
    return;
  }
  if (e.act == ACT_RELU) v = max(v, 0);
  if (e.kind == KIND_GATED)
    v = wrap_mul(v, load_i32(e.extra, idx, e.out_dt));
  else if (e.kind == KIND_RESIDUAL)
    v = wrap_add(v, load_i32(e.extra, idx, e.out_dt));
  if (e.c != nullptr)
    v = wrap_add(v, wrap_mul(__float2int_rz(e.beta),
                             load_i32(e.c, idx, e.c_dt)));
  if (e.out_dt == DT_INT32)
    static_cast<int*>(e.out)[idx] = v;
  else
    store_f32(e.out, idx, e.out_dt, __int2float_rn(v));
}
