// K3 for bf16 A on Hopper's tensor cores: mpgemm_wgmma.cuh's design (TMA,
// wgmma m64n128k16, K2's payload B stage and fold, split by the last block
// of a tile) walking only the stored tiles of each output column.  A block
// owns one 128-wide tile column c (group c / nnb) and one slice of the
// column's stored tiles indices[indptr[c] .. indptr[c + 1]); its producer
// warp reads the slice's k-tile indices into shared memory, then per stage
// loads A's k tile at indices[t] by TMA (zero fill past K) and half of
// payload tile t: a bf16 tile by TMA boxes of the payload viewed as nnz + 1
// tiles, straight to wgmma as K1's dense (K, N) weight goes; an int8 tile
// by one bulk copy, which the consumer warpgroups decode in shared memory
// (each value times its tile's scale in f32, rounded to bf16: the
// reference's bf.astype(a.dtype), and mpgemm_sparse.cu's weight()).  Each
// stored tile's 128 rows are summed on the tensor cores and folded into an
// f32 sum on the CUDA cores in payload order (acc = acc + partial), as the
// reference's _accumulate and K3's plain version add a tile's product.
// kernels/mpgemm.py::k3_design sends a launch here (128 x 128 tiles,
// 16-byte rows and bases); f32 A, other tiles and misaligned views stay on
// csrc/mpgemm_sparse.cu.
//
// Replaces, with csrc/mpgemm_sparse.cu, the TPU kernel
// src/repro/kernels/mpgemm.py::make_gemm_kernel (`sparse_kernel`), launched
// by _launch_sparse for a TileSparseOperand B (2-D, or grouped for the MoE
// expert stacks).  What bounds it on an H100: decode (M = 2) and chunked
// prefill (M <= 32) read every stored tile once a call, so bytes over the
// 3.35 TB/s of HBM; the split over a column's stored tiles
// (kernels/mpgemm.py::k3_split) keeps one wave of blocks on the SMs when
// the columns are fewer.
#include "mpgemm_wgmma.cuh"

extern "C" {

// Launches the wgmma K3 on `stream` over `g` groups (1 for a 2-D GEMM)
// with bf16 A (G, M, K), contiguous, rows 16-byte aligned, against a
// tile-sparse payload of nnz + 1 tiles of 128 x 128 (the last one zero),
// 16-byte aligned; pcode 1 bf16, 2 int8 with `tile_scales` (nnz + 1) f32;
// `indptr` (g * nnb + 1) and `indices` (nnz) int32 in device memory.  The
// epilogue arguments are mpgemm_launch's (csrc/mpgemm.cu).  `bm` is 64 or
// 128; `splits` slices of `per_split` stored tiles of each column; with
// more than one slice `partial` is an f32 workspace of splits * g * m * n
// values and `counters` g * (output tiles) ints, zero before the launch
// and after it.  Returns the cudaError_t of the launch (0 = ok).
int mpgemm_sparse_wgmma_launch(
    const void* a, const void* payload, const void* tile_scales,
    const void* indptr, const void* indices, void* out, const void* bias,
    const void* extra, const void* c, const void* row_scale,
    const void* scale, void* partial, void* counters, int g, int m, int n,
    int k, int nnz, int bias_stride, int pcode, int out_dtype, int c_dtype,
    int kind, int act, float alpha, float beta, int bm, int splits,
    int per_split, void* stream) {
  return mpgemm_sparse_wgmma_launch_typed<__nv_bfloat16>(
      a, payload, tile_scales, indptr, indices, out, bias, extra, c,
      row_scale, scale, partial, counters, g, m, n, k, nnz, bias_stride,
      pcode, out_dtype, c_dtype, kind, act, alpha, beta, bm, splits,
      per_split, stream);
}

// The ring's stages (Cfg::kStages) of the instantiation a launch with
// `bm` against payload code `pcode` runs, 0 for one it does not take;
// writes its shared memory (Cfg::kSmemBytes) to `smem_bytes`.
int mpgemm_sparse_wgmma_stages(int bm, int pcode, int* smem_bytes) {
  return mpgemm_packed_wgmma_stages_typed<__nv_bfloat16>(bm, pcode, smem_bytes);
}

const char* mpgemm_sparse_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
