// K1 for f32 operands on Hopper's tensor cores: mpgemm_wgmma.cuh's design
// instantiated for f32 A and B as 3xTF32.  TMA loads 32-deep f32 stages
// (128 bytes of K a row); the consumer warpgroups split every value x into
// tf32 terms hi + lo (split_tf32: hi = x rounded to tf32, lo = the rest
// rounded to tf32) -- a K-major tile's hi in place, an MN-major tile's
// terms transposed into K-major buffers, as the int8 path transposes --
// and wgmma m64n128k8.f32.tf32.tf32 sums lo_a hi_b + hi_a lo_b + hi_a hi_b
// a k step.  Each 128 K values' tensor-core partial is folded into an f32
// sum on the CUDA cores (K2's fold), so the tensor cores' sums stay short.
// A product then misses by about 2^-21 of itself, where one tf32 product
// misses by 2^-11: plain TF32 misses the f32 gate of 1e-4 (atol and rtol)
// at Table III's depths, 3xTF32 holds it (tests/test_torch_k1_design.py
// emulates both this and six bf16-term products on the CPU).
//
// Replaces, for the launches kernels/mpgemm.py::k1_design sends here (f32
// operands with rows of a multiple of 4 values and 16-byte bases), the f32
// loop of csrc/mpgemm.cu, the scalar port of the TPU kernel
// src/repro/kernels/mpgemm.py::make_gemm_kernel.  What bounds it on an
// H100: three tf32 products a multiply-add, so 2 * M * N * K * 3 over the
// 495 TFLOP/s of tf32 at the Table III shapes (bytes at decode), where the
// scalar loop's bound is 2 * M * N * K over the 67 TFLOP/s of f32 FMA.
#include "mpgemm_wgmma.cuh"

extern "C" {

// As mpgemm_wgmma_launch (csrc/mpgemm_wgmma.cu) for f32 A and B: K tiles
// are 32 deep, rows 16-byte aligned (multiples of 4 values), and with more
// than one slice `partial` is an f32 workspace of splits * g * m * n
// values.
int mpgemm_wgmma_f32_launch(const void* a, const void* b, void* out,
                            const void* bias, const void* extra,
                            const void* c, const void* row_scale,
                            const void* scale, void* partial, void* counters,
                            int g, int m, int n, int k, int bias_stride,
                            int out_dtype, int c_dtype, int trans_a,
                            int trans_b, int kind, int act, float alpha,
                            float beta, int bm, int splits, int per_split,
                            void* stream) {
  return mpgemm_wgmma_launch_typed<float>(
      a, b, out, bias, extra, c, row_scale, scale, partial, counters, g, m,
      n, k, bias_stride, out_dtype, c_dtype, trans_a, trans_b, kind, act,
      alpha, beta, bm, splits, per_split, stream);
}

// The ring's stages (Cfg::kStages) of the instantiation a launch with
// `bm`, `trans_a`, `trans_b` runs, 0 for a bm it does not take; writes
// its shared memory (Cfg::kSmemBytes) to `smem_bytes`.
int mpgemm_wgmma_f32_stages(int bm, int trans_a, int trans_b, int* smem_bytes) {
  return mpgemm_wgmma_stages_typed<float>(bm, trans_a, trans_b, smem_bytes);
}

const char* mpgemm_wgmma_f32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
