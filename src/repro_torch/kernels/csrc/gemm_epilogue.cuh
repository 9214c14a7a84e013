// Device code shared by the MPGEMM kernels (K1 mpgemm.cu, K2
// mpgemm_packed.cu, K3 mpgemm_sparse.cu): the codes the wrappers pass,
// element conversions, the activations and the fused epilogue of one
// output element, in the order of
// repro_torch/core/gemm_spec.py::apply_epilogue.  Each kernel source
// compiles on its own into a library, so these are inline functions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

enum { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2 };
enum { KIND_LINEAR = 0, KIND_GATED = 1, KIND_RESIDUAL = 2 };
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU_TANH = 3 };

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

// Element i of an f32 or bf16 tensor whose dtype is chosen at run time.
__device__ __forceinline__ float load_out(const void* p, size_t i, int dt) {
  return dt == DT_BF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// out[idx] = tail(act(v * scale * alpha + bias[col])), stored as out_dt:
// the gate (kind 1) multiplies, the residual (kind 2) adds extra[idx], of
// the output's dtype.  `scale` and `bias` may be null.
__device__ __forceinline__ void epilogue_store(
    float v, size_t idx, int col, void* out, const float* bias,
    const void* extra, const float* scale, int out_dt, int kind, int act,
    float alpha) {
  if (scale != nullptr) v *= *scale;
  if (alpha != 1.f) v *= alpha;
  if (bias != nullptr) v += bias[col];
  v = activate(v, act);
  if (kind != KIND_LINEAR) {
    const float e = load_out(extra, idx, out_dt);
    v = kind == KIND_GATED ? v * e : v + e;
  }
  if (out_dt == DT_BF16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[idx] = v;
}
