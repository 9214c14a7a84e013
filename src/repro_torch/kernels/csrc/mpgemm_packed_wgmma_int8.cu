// K2 for int8 A on Hopper's tensor cores: mpgemm_wgmma.cuh's design with a
// B stage that reads the packed payload, one 128 x 128 tile a stage.  An
// int8 tile, or an int4 one with its nibbles sign-extended to int8, comes
// raw by a bulk copy and the consumer warpgroups transpose it in shared
// memory into the K-major layout wgmma's s8 form reads (K1's
// transpose_tile); wgmma m64n128k32.s32.s8.s8 sums the tile's 128 rows
// exactly in int32, and the partial is folded into the f32 sum as acc +=
// float(partial) * tile_scale in K-tile order, so the f32 sum sees the
// reference's tile boundaries.  kernels/mpgemm.py::k2_design sends a
// launch here; int8 A against an fp8e4m3 payload (the reference's f32
// int x float branch) stays on csrc/mpgemm_packed.cu.
//
// Replaces, with csrc/mpgemm_packed.cu, the packed-B branch of the TPU
// kernel src/repro/kernels/mpgemm.py::make_gemm_kernel (`_accumulate`'s
// integer partial a tile, times the tile's scale), launched by
// mpgemm_pallas_spec and mpgemm_grouped_pallas.  Bound by the payload's
// bytes at the served shapes, as mpgemm_packed_wgmma.cu.
#include "mpgemm_wgmma.cuh"

extern "C" {

// As mpgemm_packed_wgmma_launch (csrc/mpgemm_packed_wgmma.cu) for int8 A
// against an int8 (pcode 2) or int4 (3) payload: K stages are 128 deep,
// one payload tile each, and with more than one slice `partial` is an f32
// workspace of splits * g * m * n values.  `scale` (the int8 policy's sx)
// and the rest of the epilogue run in f32.
int mpgemm_packed_wgmma_int8_launch(
    const void* a, const void* payload, const void* tile_scales, void* out,
    const void* bias, const void* extra, const void* c, const void* row_scale,
    const void* scale, void* partial, void* counters, int g, int m, int n,
    int k, int nkb, int nnb, int bias_stride, int pcode, int out_dtype,
    int c_dtype, int kind, int act, float alpha, float beta, int bm,
    int splits, int per_split, void* stream) {
  return mpgemm_packed_wgmma_launch_typed<int8_t>(
      a, payload, tile_scales, out, bias, extra, c, row_scale, scale,
      partial, counters, g, m, n, k, nkb, nnb, bias_stride, pcode, out_dtype,
      c_dtype, kind, act, alpha, beta, bm, splits, per_split, stream);
}

// The ring's stages (Cfg::kStages) of the instantiation a launch with
// `bm` against payload code `pcode` runs, 0 for one it does not take;
// writes its shared memory (Cfg::kSmemBytes) to `smem_bytes`.
int mpgemm_packed_wgmma_int8_stages(int bm, int pcode, int* smem_bytes) {
  return mpgemm_packed_wgmma_stages_typed<int8_t>(bm, pcode, smem_bytes);
}

const char* mpgemm_packed_wgmma_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
