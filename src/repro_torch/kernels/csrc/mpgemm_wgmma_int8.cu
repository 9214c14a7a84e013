// K1 for int8 operands on Hopper's tensor cores: mpgemm_wgmma.cuh's design
// instantiated for int8 A and B, summed exactly in int32 by wgmma
// m64n128k32.s32.s8.s8 over 128-deep stages, with the MN-major operands
// (B (K, N), A (K, M) under trans_a) transposed in shared memory between
// TMA and wgmma.  Replaces the int8 loop of csrc/mpgemm.cu for the
// launches kernels/mpgemm.py::k1_design sends here (int8 operands whose
// rows and base pointers are multiples of 16 bytes); the header's note says
// what it replaces and why it is shaped as it is.  The sum is exact while
// 127^2 * K < 2^31 (the wrapper checks K), as in the scalar loop.
#include "mpgemm_wgmma.cuh"

extern "C" {

// As mpgemm_wgmma_launch (csrc/mpgemm_wgmma.cu) for int8 A and B: K tiles
// are 128 deep, and with more than one slice `partial` is an int32
// workspace of splits * g * m * n values.  With no `scale` the epilogue
// runs on the int32 sum (epilogue_store_int), else in f32.
int mpgemm_wgmma_int8_launch(const void* a, const void* b, void* out,
                             const void* bias, const void* extra,
                             const void* c, const void* row_scale,
                             const void* scale, void* partial,
                             void* counters, int g, int m, int n, int k,
                             int bias_stride, int out_dtype, int c_dtype,
                             int trans_a, int trans_b, int kind, int act,
                             float alpha, float beta, int bm, int splits,
                             int per_split, void* stream) {
  return mpgemm_wgmma_launch_typed<int8_t>(
      a, b, out, bias, extra, c, row_scale, scale, partial, counters, g, m,
      n, k, bias_stride, out_dtype, c_dtype, trans_a, trans_b, kind, act,
      alpha, beta, bm, splits, per_split, stream);
}

// The ring's stages (Cfg::kStages) of the instantiation a launch with
// `bm`, `trans_a`, `trans_b` runs, 0 for a bm it does not take; writes
// its shared memory (Cfg::kSmemBytes) to `smem_bytes`.
int mpgemm_wgmma_int8_stages(int bm, int trans_a, int trans_b, int* smem_bytes) {
  return mpgemm_wgmma_stages_typed<int8_t>(bm, trans_a, trans_b, smem_bytes);
}

const char* mpgemm_wgmma_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
