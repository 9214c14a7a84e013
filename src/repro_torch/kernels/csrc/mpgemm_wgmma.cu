// K1 for bf16 operands on Hopper's tensor cores: mpgemm_wgmma.cuh's design
// (TMA, wgmma m64n128k16, split-K by the last block of a tile) instantiated
// for bf16 A and B, summed in f32.  kernels/mpgemm.py::k1_design sends a
// launch here; the header's note says what it replaces and why it is
// shaped as it is.
#include "mpgemm_wgmma.cuh"

extern "C" {

// Launches the wgmma K1 on `stream` over `g` groups (1 for a 2-D GEMM)
// with bf16 operands; returns the cudaError_t of the launch (0 = ok).
// A is (G, M, K), or (G, K, M) under trans_a; B (G, K, N), or (G, N, K)
// under trans_b; both contiguous, every row 16-byte aligned.  The epilogue
// arguments are mpgemm_launch's (csrc/mpgemm.cu).  `bm` is 64 or 128;
// `splits` slices of `per_split` K tiles (64 deep) each; with more than one
// slice `partial` is an f32 workspace of splits * g * m * n values and
// `counters` g * (output tiles) ints, zero before the launch and after it.
int mpgemm_wgmma_launch(const void* a, const void* b, void* out,
                        const void* bias, const void* extra, const void* c,
                        const void* row_scale, const void* scale,
                        void* partial, void* counters, int g, int m, int n,
                        int k, int bias_stride, int out_dtype, int c_dtype,
                        int trans_a, int trans_b, int kind, int act,
                        float alpha, float beta, int bm, int splits,
                        int per_split, void* stream) {
  return mpgemm_wgmma_launch_typed<__nv_bfloat16>(
      a, b, out, bias, extra, c, row_scale, scale, partial, counters, g, m,
      n, k, bias_stride, out_dtype, c_dtype, trans_a, trans_b, kind, act,
      alpha, beta, bm, splits, per_split, stream);
}

const char* mpgemm_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
