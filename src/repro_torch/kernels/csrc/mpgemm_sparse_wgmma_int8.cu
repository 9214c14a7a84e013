// K3 for int8 A on Hopper's tensor cores: mpgemm_sparse_wgmma.cu's walk
// over each column's stored tiles with int8 A (the int8 policy) against
// int8 tiles: one stored tile a 128-deep stage, the tile by one bulk copy,
// transposed in shared memory into the K-major layout wgmma's s8 form
// reads (K1's transpose_tile), summed exactly in int32 by wgmma
// m64n128k32.s32.s8.s8, and folded as acc = acc + float(partial) *
// tile_scale in payload order: the reference's _accumulate, and
// csrc/mpgemm_sparse.cu's int8 loop.  kernels/mpgemm.py::k3_design sends a
// launch here.
//
// Replaces, with csrc/mpgemm_sparse.cu, the TPU kernel
// src/repro/kernels/mpgemm.py::make_gemm_kernel (`sparse_kernel`).  Bound
// by the stored tiles' bytes at the served shapes, as
// mpgemm_sparse_wgmma.cu.
#include "mpgemm_wgmma.cuh"

extern "C" {

// As mpgemm_sparse_wgmma_launch (csrc/mpgemm_sparse_wgmma.cu) for int8 A
// against int8 tiles (pcode 2): `scale` (the int8 policy's sx) and the
// rest of the epilogue run in f32.
int mpgemm_sparse_wgmma_int8_launch(
    const void* a, const void* payload, const void* tile_scales,
    const void* indptr, const void* indices, void* out, const void* bias,
    const void* extra, const void* c, const void* row_scale,
    const void* scale, void* partial, void* counters, int g, int m, int n,
    int k, int nnz, int bias_stride, int pcode, int out_dtype, int c_dtype,
    int kind, int act, float alpha, float beta, int bm, int splits,
    int per_split, void* stream) {
  return mpgemm_sparse_wgmma_launch_typed<int8_t>(
      a, payload, tile_scales, indptr, indices, out, bias, extra, c,
      row_scale, scale, partial, counters, g, m, n, k, nnz, bias_stride,
      pcode, out_dtype, c_dtype, kind, act, alpha, beta, bm, splits,
      per_split, stream);
}

// The ring's stages (Cfg::kStages) of the instantiation a launch with
// `bm` against payload code `pcode` runs, 0 for one it does not take;
// writes its shared memory (Cfg::kSmemBytes) to `smem_bytes`.
int mpgemm_sparse_wgmma_int8_stages(int bm, int pcode, int* smem_bytes) {
  return mpgemm_packed_wgmma_stages_typed<int8_t>(bm, pcode, smem_bytes);
}

const char* mpgemm_sparse_wgmma_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
