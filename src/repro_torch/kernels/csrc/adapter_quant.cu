// Symmetric int8 per-output-channel quantization of adapter / basis banks:
// the Hopper kernel behind repro_torch/kernels/adapter_quant.py.
//
// Replaces the TPU kernel kernels/adapter_quant.py::adapter_quantize
// (_quant_rows_kernel / _quant_cols_kernel).  For a bank w (N, R, C):
//   rows (axis=-1): scale[n, i]  = absmax_j |w[n, i, j]| / 127  (1 if 0);
//   cols (axis=-2): scale[n, j]  = absmax_i |w[n, i, j]| / 127  (1 if 0);
//   q = clip(rint(w / scale), -127, 127).
// It must equal the plain version exactly: the division is IEEE
// (__fdiv_rn; this file is never built with --use_fast_math) and rounding
// is half to even (rintf), as jnp.round and torch.round; never roundf,
// which rounds half away from zero.  The absmax is order-independent.
//
// Bound on an H100: memory, one read of w and one write of q (a quarter or
// half of it) plus the scales.  Rows: one warp per row, eight rows per
// block, so the 16-wide rows of a rank-16 B/U bank do not each take a
// block.  Cols: one block per (matrix, 32-column tile), 8 row groups of 32
// threads, each warp reading 32 adjacent columns of one row.

#include "common.cuh"

#define QMAX 127.0f
#define ROWS_PER_BLOCK 8
#define COL_TILE 32
#define COL_GROUPS 8

__device__ __forceinline__ float scale_of(float absmax) {
  return absmax > 0.f ? __fdiv_rn(absmax, QMAX) : 1.0f;
}

__device__ __forceinline__ int8_t quant(float x, float scale) {
  float qv = rintf(__fdiv_rn(x, scale));
  qv = fminf(fmaxf(qv, -QMAX), QMAX);
  return (int8_t)qv;
}

__global__ void quant_rows_kernel(const void* __restrict__ w, int w_dtype,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ scale, int64_t rows,
                                  int C) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = row * C;
  float mx = 0.f;
  for (int j = lane; j < C; j += 32)
    mx = fmaxf(mx, fabsf(load_any(w, base + j, w_dtype)));
  mx = warp_max(mx);
  const float s = scale_of(mx);
  for (int j = lane; j < C; j += 32)
    q[base + j] = quant(load_any(w, base + j, w_dtype), s);
  if (lane == 0) scale[row] = s;
}

__global__ void quant_cols_kernel(const void* __restrict__ w, int w_dtype,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ scale, int R, int C) {
  __shared__ float red[COL_GROUPS][COL_TILE];
  const int n = blockIdx.x;
  const int j = blockIdx.y * COL_TILE + (threadIdx.x % COL_TILE);
  const int grp = threadIdx.x / COL_TILE;
  const int64_t base = (int64_t)n * R * C;
  float mx = 0.f;
  if (j < C)
    for (int i = grp; i < R; i += COL_GROUPS)
      mx = fmaxf(mx, fabsf(load_any(w, base + (int64_t)i * C + j, w_dtype)));
  red[grp][threadIdx.x % COL_TILE] = mx;
  __syncthreads();
  for (int g = 0; g < COL_GROUPS; ++g)
    mx = fmaxf(mx, red[g][threadIdx.x % COL_TILE]);
  if (j >= C) return;
  const float s = scale_of(mx);
  for (int i = grp; i < R; i += COL_GROUPS)
    q[base + (int64_t)i * C + j] =
        quant(load_any(w, base + (int64_t)i * C + j, w_dtype), s);
  if (grp == 0) scale[(int64_t)n * C + j] = s;
}

extern "C" {

// w (N, R, C) -> q (N, R, C) int8 and scale (N, R) [rows] or (N, C) [cols]
int adapter_quant_launch(const void* w, int w_dtype, void* q, float* scale,
                         int64_t N, int R, int C, int rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows) {
    const int64_t n_rows = N * R;
    const int64_t blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    quant_rows_kernel<<<(unsigned)blocks, 32 * ROWS_PER_BLOCK, 0, st>>>(
        w, w_dtype, static_cast<int8_t*>(q), scale, n_rows, C);
  } else {
    if (N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)N, (C + COL_TILE - 1) / COL_TILE);
    quant_cols_kernel<<<grid, COL_TILE * COL_GROUPS, 0, st>>>(
        w, w_dtype, static_cast<int8_t*>(q), scale, R, C);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
