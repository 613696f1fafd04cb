// Grouped multi-adapter LoRA kernels (SGMV): the Hopper kernels behind
// repro_torch/kernels/sgmv.py.
//
// Replace the TPU kernels kernels/sgmv.py::sgmv_shrink (_shrink_kernel),
// sgmv_expand (_expand_kernel) and sigma_bmm (_sigma_bmm_kernel).  Tokens
// arrive grouped and padded so that every tile of bt rows uses one bank
// index, tile_ids[i]; each block reads its own.
//
//   shrink:    out (T_pad, r) f32    = x (T_pad, d_in) . A[id] (r, d_in)^T
//   expand:    out (T_pad, d_out) T  = t (T_pad, r)    . B[id] (d_out, r)^T
//   sigma_bmm: out (T_pad, r) T      = t (T_pad, r)    . Sigma[id] (r, r)
//
// with T the type of t (f32 or bf16); every product is summed in f32 and
// rounded once.  x, t and the banks are f32 or bf16 (type codes of
// common.cuh), the rank at most SGMV_RMAX.
//
// Bounds on an H100 (memory, at the prefill shapes of 4096 tokens by 4096
// channels, rank 16): the shrink reads x once (~32 MB in bf16, ~10 us),
// the expand writes its output once (the same), sigma_bmm moves
// T_pad * r values (~0.5 MB).
//
// shrink: see sgmv.cuh (one block per 32-row slab of a tile).
// expand: one block per (tile, 128 output channels); thread o keeps the r
//   weights of channel o in registers and walks the tile's rows, reading
//   each row of t (staged in shared memory, 32 rows at a time) as float4
//   broadcasts; consecutive threads write consecutive channels.
// sigma_bmm: one block per tile, Sigma[id] (r, r) in shared memory.

#include "sgmv.cuh"

#define EXPAND_COLS 128
#define EXPAND_ROWS 32

template <int RP, typename T>
__global__ void __launch_bounds__(EXPAND_COLS) sgmv_expand_kernel(
    const T* __restrict__ t, const void* __restrict__ w, int w_dtype,
    const int* __restrict__ tile_ids, T* __restrict__ out, int bt, int r,
    int d_out) {
  __shared__ __align__(16) float ts[EXPAND_ROWS][RP];
  const int tile = blockIdx.x;
  const int o = blockIdx.y * EXPAND_COLS + threadIdx.x;
  const int64_t row0 = (int64_t)tile * bt;
  const int64_t wrow = ((int64_t)tile_ids[tile] * d_out + o) * r;

  float b[RP];
#pragma unroll
  for (int j = 0; j < RP; ++j)
    b[j] = (o < d_out && j < r) ? load_any(w, wrow + j, w_dtype) : 0.f;

  for (int s0 = 0; s0 < bt; s0 += EXPAND_ROWS) {
    const int nrows = min(EXPAND_ROWS, bt - s0);
    for (int e = threadIdx.x; e < EXPAND_ROWS * RP; e += EXPAND_COLS) {
      const int row = e / RP, j = e % RP;
      ts[row][j] = (row < nrows && j < r)
          ? to_f(t[(row0 + s0 + row) * r + j]) : 0.f;
    }
    __syncthreads();
    if (o < d_out) {
      for (int row = 0; row < nrows; ++row) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < RP; j += 4) {
          const float4 tv = *reinterpret_cast<const float4*>(&ts[row][j]);
          acc = __fmaf_rn(tv.x, b[j], acc);
          acc = __fmaf_rn(tv.y, b[j + 1], acc);
          acc = __fmaf_rn(tv.z, b[j + 2], acc);
          acc = __fmaf_rn(tv.w, b[j + 3], acc);
        }
        out[(row0 + s0 + row) * d_out + o] = from_f<T>(acc);
      }
    }
    __syncthreads();
  }
}

#define BMM_THREADS 128

template <typename T>
__global__ void __launch_bounds__(BMM_THREADS) sigma_bmm_kernel(
    const T* __restrict__ t, const void* __restrict__ sigma, int s_dtype,
    const int* __restrict__ tile_ids, T* __restrict__ out, int bt, int r) {
  __shared__ float ss[SGMV_RMAX * SGMV_RMAX];
  const int tile = blockIdx.x;
  const int64_t sbase = (int64_t)tile_ids[tile] * r * r;
  for (int e = threadIdx.x; e < r * r; e += BMM_THREADS)
    ss[e] = load_any(sigma, sbase + e, s_dtype);
  __syncthreads();
  const int64_t row0 = (int64_t)tile * bt;
  for (int e = threadIdx.x; e < bt * r; e += BMM_THREADS) {
    const int row = e / r, q = e % r;
    const T* trow = t + (row0 + row) * r;
    float acc = 0.f;
    for (int j = 0; j < r; ++j)
      acc = __fmaf_rn(to_f(trow[j]), ss[j * r + q], acc);
    out[(row0 + row) * r + q] = from_f<T>(acc);
  }
}

template <typename T>
static int expand_launch(const T* t, const void* w, int w_dtype,
                         const int* tile_ids, T* out, int n_tiles, int bt,
                         int r, int d_out, cudaStream_t st) {
  dim3 grid(n_tiles, (d_out + EXPAND_COLS - 1) / EXPAND_COLS);
#define EXPAND_CASE(RPV)                                                   \
  sgmv_expand_kernel<RPV, T><<<grid, EXPAND_COLS, 0, st>>>(                \
      t, w, w_dtype, tile_ids, out, bt, r, d_out)
  if (r <= 4) EXPAND_CASE(4);
  else if (r <= 8) EXPAND_CASE(8);
  else if (r <= 16) EXPAND_CASE(16);
  else if (r <= 32) EXPAND_CASE(32);
  else EXPAND_CASE(64);
#undef EXPAND_CASE
  return (int)cudaGetLastError();
}

extern "C" {

// x (T_pad, d_in), A (n, r, d_in) -> out (T_pad, r) f32
int sgmv_shrink_launch(const void* x, int x_dtype, const void* A,
                       int a_dtype, const int* tile_ids, float* out,
                       int n_tiles, int bt, int d_in, int r, void* stream) {
  return grouped_shrink_launch<false>(x, x_dtype, A, a_dtype, tile_ids,
                                      nullptr, 0, out, n_tiles, bt, d_in, r,
                                      (cudaStream_t)stream);
}

// t (T_pad, r), B (n, d_out, r) -> out (T_pad, d_out) in t's type
int sgmv_expand_launch(const void* t, int t_dtype, const void* B,
                       int b_dtype, const int* tile_ids, void* out,
                       int n_tiles, int bt, int r, int d_out, void* stream) {
  if (r < 1 || r > SGMV_RMAX || bt < 1 || t_dtype == DT_I8)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0 || d_out == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (t_dtype == DT_BF16)
    return expand_launch(static_cast<const __nv_bfloat16*>(t), B, b_dtype,
                         tile_ids, static_cast<__nv_bfloat16*>(out), n_tiles,
                         bt, r, d_out, st);
  return expand_launch(static_cast<const float*>(t), B, b_dtype, tile_ids,
                       static_cast<float*>(out), n_tiles, bt, r, d_out, st);
}

// t (T_pad, r), Sigma (n, r, r) -> out (T_pad, r) in t's type
int sigma_bmm_launch(const void* t, int t_dtype, const void* sigma,
                     int s_dtype, const int* tile_ids, void* out, int n_tiles,
                     int bt, int r, void* stream) {
  if (r < 1 || r > SGMV_RMAX || bt < 1 || t_dtype == DT_I8)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (t_dtype == DT_BF16)
    sigma_bmm_kernel<__nv_bfloat16><<<n_tiles, BMM_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t), sigma, s_dtype, tile_ids,
        static_cast<__nv_bfloat16*>(out), bt, r);
  else
    sigma_bmm_kernel<float><<<n_tiles, BMM_THREADS, 0, st>>>(
        static_cast<const float*>(t), sigma, s_dtype, tile_ids,
        static_cast<float*>(out), bt, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
