// K2 for bf16 A on Hopper's tensor cores: mpgemm_wgmma.cuh's design (TMA,
// wgmma m64n128k16, split-K by the last block of a tile) with a B stage
// that reads the packed payload.  A bf16 payload goes from TMA straight to
// wgmma, as K1's dense (K, N) weight does; an int8, int4 or fp8e4m3
// payload arrives raw by a bulk copy, half a 128 x 128 tile a stage, and
// the consumer warpgroups decode it in shared memory -- each value times
// its tile's scale in f32, rounded to bf16 (the reference's
// bf.astype(a.dtype)) -- into the 128-byte-swizzled MN-major layout
// wgmma reads for the served bf16 weight.  kernels/mpgemm.py::k2_design
// sends a launch here; the header's note says what K1's template does,
// and csrc/mpgemm_packed.cu's what K2 computes.
//
// Replaces, with csrc/mpgemm_packed.cu, the packed-B branch of the TPU
// kernel src/repro/kernels/mpgemm.py::make_gemm_kernel (the int4 decode
// `unpack_nibbles` and the per-tile scale of `_accumulate`), launched by
// mpgemm_pallas_spec and by mpgemm_grouped_pallas for a grouped payload.
//
// What bounds it on an H100: the served shapes read every payload byte
// once a call (decode M = 2, prefill chunks M = 32), so bytes over the
// 3.35 TB/s of HBM; the decode of a value costs a few instructions, spread
// over every SM by split-K when there are fewer output tiles than SMs.
#include "mpgemm_wgmma.cuh"

extern "C" {

// Launches the wgmma K2 on `stream` over `g` groups (1 for a 2-D GEMM)
// with bf16 A (G, M, K), contiguous, rows 16-byte aligned, against a
// payload of 128 x 128 tiles, (G, nkb, nnb, tk, 128) with tk = 128 (64 for
// int4), 16-byte aligned; pcode 1 bf16, 2 int8, 3 int4, 4 fp8e4m3;
// `tile_scales` (G, nkb, nnb) f32 for the codecs.  The epilogue arguments
// are mpgemm_launch's (csrc/mpgemm.cu).  `bm` is 64 or 128; `splits`
// slices of `per_split` K stages (64 deep: half a payload tile, so an
// even count) each; with more than one slice `partial` is an f32
// workspace of splits * g * m * n values and `counters` g * (output
// tiles) ints, zero before the launch and after it.  Returns the
// cudaError_t of the launch (0 = ok).
int mpgemm_packed_wgmma_launch(
    const void* a, const void* payload, const void* tile_scales, void* out,
    const void* bias, const void* extra, const void* c, const void* row_scale,
    const void* scale, void* partial, void* counters, int g, int m, int n,
    int k, int nkb, int nnb, int bias_stride, int pcode, int out_dtype,
    int c_dtype, int kind, int act, float alpha, float beta, int bm,
    int splits, int per_split, void* stream) {
  return mpgemm_packed_wgmma_launch_typed<__nv_bfloat16>(
      a, payload, tile_scales, out, bias, extra, c, row_scale, scale,
      partial, counters, g, m, n, k, nkb, nnb, bias_stride, pcode, out_dtype,
      c_dtype, kind, act, alpha, beta, bm, splits, per_split, stream);
}

// The ring's stages (Cfg::kStages) of the instantiation a launch with
// `bm` against payload code `pcode` runs, 0 for one it does not take;
// writes its shared memory (Cfg::kSmemBytes) to `smem_bytes`.
int mpgemm_packed_wgmma_stages(int bm, int pcode, int* smem_bytes) {
  return mpgemm_packed_wgmma_stages_typed<__nv_bfloat16>(bm, pcode, smem_bytes);
}

const char* mpgemm_packed_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
