// Compressed (JD) shrink with the per-token Sigma scale: the Hopper kernel
// behind repro_torch/kernels/jd_apply.py::jd_shrink_scale.
//
// Replaces the TPU kernel kernels/jd_apply.py::jd_shrink_scale
// (_shrink_scale_kernel):
//
//   out[t, c] = (sum_k x[t, k] * V[cid, k, c]) * sigma_tok[t, c]
//
// in f32, with cid = tile_cids[tile of t] and the scale applied once the sum
// over d_in is complete (the TPU applies it after its last d block).  No
// scale (sigma_tok null) gives the plain shrink that JD-Full runs before
// sigma_bmm; multiplying by the TPU's ones instead would not change a bit.
// V (k, d_in, r) keeps a basis column strided by r, so the block stages a
// (d_in chunk, r) slab, which is contiguous in V, and reads it transposed;
// the rest is the grouped shrink of sgmv.cuh.  With bf16 x it runs on the
// tensor cores: a bf16 V through ldmatrix.trans, an f32 V split into three
// bf16 pieces per element (split3), one mma per piece.
//
// Bound on an H100: memory, one read of x (T_pad * d_in values) and of the
// bases the tiles reach, as for sgmv_shrink.

#include "sgmv.cuh"

extern "C" {

// x (T_pad, d_in), V (k, d_in, r), sigma_tok (T_pad, r) or null
//   -> out (T_pad, r) f32
int jd_shrink_scale_launch(const void* x, int x_dtype, const void* V,
                           int v_dtype, const int* tile_cids,
                           const void* sigma_tok, int sig_dtype, float* out,
                           int n_tiles, int bt, int d_in, int r,
                           void* stream) {
  return grouped_shrink_launch<true>(x, x_dtype, V, v_dtype, tile_cids,
                                     sigma_tok, sig_dtype, out, n_tiles, bt,
                                     d_in, r, (cudaStream_t)stream);
}

}  // extern "C"
