// Symmetric int8 per-output-channel quantization of adapter / basis banks:
// the Hopper kernel behind repro_torch/kernels/adapter_quant.py.
//
// Replaces the TPU kernel kernels/adapter_quant.py::adapter_quantize
// (_quant_rows_kernel / _quant_cols_kernel).  For a bank w (N, R, C):
//   rows (axis=-1): scale[n, i]  = absmax_j |w[n, i, j]| / 127  (1 if 0);
//   cols (axis=-2): scale[n, j]  = absmax_i |w[n, i, j]| / 127  (1 if 0);
//   q = clip(rint(w / scale), -127, 127).
// It must equal the plain version exactly (scale_of and quant of
// common.cuh, shared with kv_quant.cu; the wrapper passes qmax = 127,
// kv_quant.QMAX[8]).  The absmax is order-independent.
//
// Bound on an H100: memory, one read of w and one write of q (a quarter or
// half of it) plus the scales.  Rows: one warp per row, eight rows per
// block, so the 16-wide rows of a rank-16 B/U bank do not each take a
// block.  Cols: one block per (matrix, 32-column tile), 8 row groups of 32
// threads, each warp reading 32 adjacent columns of one row.

#include "common.cuh"

#define ROWS_PER_BLOCK 8
#define COL_TILE 32
#define COL_GROUPS 8

__global__ void quant_rows_kernel(const void* __restrict__ w, int w_dtype,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ scale, int64_t rows,
                                  int C, float qmax) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = row * C;
  float mx = 0.f;
  for (int j = lane; j < C; j += 32)
    mx = fmaxf(mx, fabsf(load_any(w, base + j, w_dtype)));
  mx = warp_max(mx);
  const float s = scale_of(mx, qmax);
  for (int j = lane; j < C; j += 32)
    q[base + j] = (int8_t)quant(load_any(w, base + j, w_dtype), s, qmax);
  if (lane == 0) scale[row] = s;
}

__global__ void quant_cols_kernel(const void* __restrict__ w, int w_dtype,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ scale, int R, int C,
                                  float qmax) {
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
  const float s = scale_of(mx, qmax);
  for (int i = grp; i < R; i += COL_GROUPS)
    q[base + (int64_t)i * C + j] = (int8_t)quant(
        load_any(w, base + (int64_t)i * C + j, w_dtype), s, qmax);
  if (grp == 0) scale[(int64_t)n * C + j] = s;
}

// Dequantization, replacing kernels/adapter_quant.py::adapter_dequantize
// (_dequant_kernel): out[n, i, j] = q[n, i, j] * scale (scale[n, i] for
// rows, scale[n, j] for cols), one f32 multiply (__fmul_rn) and one
// rounding to the output type, so it equals the plain version bit for bit.
// Bound: memory, one read of q and the scales, one write of out (4 or 2
// bytes per value).  A grid-stride loop, one element per thread per step,
// consecutive threads on consecutive elements.
#define DEQ_THREADS 256

template <typename T>
__global__ void __launch_bounds__(DEQ_THREADS) dequant_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scale,
    T* __restrict__ out, int64_t total, int R, int C, int rows) {
  const int64_t stride = (int64_t)gridDim.x * DEQ_THREADS;
  for (int64_t e = (int64_t)blockIdx.x * DEQ_THREADS + threadIdx.x;
       e < total; e += stride) {
    const int64_t n = e / ((int64_t)R * C);
    const int64_t s = rows ? n * R + (e / C) % R : n * C + e % C;
    out[e] = from_f<T>(__fmul_rn((float)q[e], scale[s]));
  }
}

extern "C" {

// q (N, R, C) int8, scale (N, R) [rows] or (N, C) [cols] f32
//   -> out (N, R, C) f32 or bf16
int adapter_dequant_launch(const int8_t* q, const float* scale, void* out,
                           int out_dtype, int64_t N, int R, int C, int rows,
                           void* stream) {
  const int64_t total = N * R * C;
  if (total == 0) return (int)cudaSuccess;
  const int64_t want = (total + DEQ_THREADS - 1) / DEQ_THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == DT_BF16)
    dequant_kernel<__nv_bfloat16><<<blocks, DEQ_THREADS, 0, st>>>(
        q, scale, static_cast<__nv_bfloat16*>(out), total, R, C, rows);
  else if (out_dtype == DT_F32)
    dequant_kernel<float><<<blocks, DEQ_THREADS, 0, st>>>(
        q, scale, static_cast<float*>(out), total, R, C, rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// w (N, R, C) -> q (N, R, C) int8 and scale (N, R) [rows] or (N, C) [cols]
int adapter_quant_launch(const void* w, int w_dtype, void* q, float* scale,
                         int64_t N, int R, int C, int rows, float qmax,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows) {
    const int64_t n_rows = N * R;
    const int64_t blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    quant_rows_kernel<<<(unsigned)blocks, 32 * ROWS_PER_BLOCK, 0, st>>>(
        w, w_dtype, static_cast<int8_t*>(q), scale, n_rows, C, qmax);
  } else {
    if (N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)N, (C + COL_TILE - 1) / COL_TILE);
    quant_cols_kernel<<<grid, COL_TILE * COL_GROUPS, 0, st>>>(
        w, w_dtype, static_cast<int8_t*>(q), scale, R, C, qmax);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
