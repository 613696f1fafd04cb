// The grouped "shrink" shared by sgmv.cu (sgmv_shrink) and jd_apply.cu
// (jd_shrink_scale): per token tile, out[t, c] = sum_k x[t, k] * W[w, c, k]
// in f32, optionally times a per-token scale once the sum over d_in is
// complete.
//
// Tokens arrive grouped (repro_torch/kernels/ref.py::
// group_tokens_by_adapter): tile i holds rows [i*bt, (i+1)*bt), all with
// the bank index tile_ids[i], which the block reads itself (the TPU
// kernel's scalar prefetch).  The TPU runs one grid step per (tile, 512-wide
// d_in block) in order and carries the sum in its output block; here one
// block owns a slab of SHRINK_ROWS rows of one tile and walks all of d_in
// itself, so nothing crosses blocks and the sum is taken in the same order
// every run.
//
// Per SHRINK_KC-wide chunk of d_in the block stages the slab's x and the
// (RP, SHRINK_KC) weight chunk in shared memory as f32; thread (c, g) keeps
// RPT accumulators for column c and rows g, g + NG, ..., reading one float4
// of the weight chunk for RPT float4 reads of x (broadcast within a warp).
// RP is the rank rounded up to a power of two; columns c >= r are zero.
// What limits it is the latency of the loads, not their bytes: each thread
// loads its share of the next chunk into registers before it computes on
// the current one, and slabs of 8 rows give 512 blocks at 4096 rows,
// several per SM, so that other warps run while one waits.
//
// Bound on an H100: memory.  Each x row is read once (T_pad * d_in
// elements) and each weight slice once per slab from L2; the f32 products,
// 2 * T_pad * d_in * r operations, would take ~1 us of the card's f32 rate
// at the prefill shapes, against ~10 us to read x.
#pragma once

#include "common.cuh"

#define SHRINK_THREADS 128
#define SHRINK_ROWS 8
#define SHRINK_KC 64
#define SHRINK_PAD 4               // keeps rows 16-byte aligned, spreads banks
#define SGMV_RMAX 64

// W_COLS false: W is an A bank (n, r, d_in), row c of W[w] contiguous.
// W_COLS true:  W is a V bank  (k, d_in, r), column c of W[w] strided.
template <int RP, bool W_COLS>
__global__ void __launch_bounds__(SHRINK_THREADS) grouped_shrink_kernel(
    const void* __restrict__ x, int x_dtype, const void* __restrict__ w,
    int w_dtype, const int* __restrict__ tile_ids,
    const void* __restrict__ scale, int scale_dtype, float* __restrict__ out,
    int d_in, int r, int bt) {
  constexpr int NG = SHRINK_THREADS / RP;                  // row groups
  constexpr int RPT = (SHRINK_ROWS + NG - 1) / NG;         // rows a thread
  constexpr int LD = SHRINK_KC + SHRINK_PAD;
  constexpr int XPT = SHRINK_ROWS * SHRINK_KC / SHRINK_THREADS;  // x loads
  constexpr int WPT = RP * SHRINK_KC / SHRINK_THREADS;     // weight loads
  __shared__ __align__(16) float xs[SHRINK_ROWS][LD];
  __shared__ __align__(16) float ws[RP][LD];

  const int tile = blockIdx.x;
  const int slab0 = blockIdx.y * SHRINK_ROWS;              // within the tile
  const int nrows = min(SHRINK_ROWS, bt - slab0);
  const int64_t row0 = (int64_t)tile * bt + slab0;         // global row
  const int64_t wbase = (int64_t)tile_ids[tile] * r * d_in;
  const int tid = threadIdx.x;
  const int c = tid % RP;
  const int g = tid / RP;

  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.f;

  // element i of this thread's share of a chunk: (row, kk) of x, (cc, kk)
  // of the weights (V: r contiguous per k, so cc runs fastest)
  float xr[XPT], wr[WPT];
  auto fetch = [&](int k0) {
    const int kc = min(SHRINK_KC, d_in - k0);
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * SHRINK_THREADS;
      const int row = e / SHRINK_KC, kk = e % SHRINK_KC;
      xr[i] = (row < nrows && kk < kc)
          ? load_any(x, (row0 + row) * d_in + k0 + kk, x_dtype) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int e = tid + i * SHRINK_THREADS;
      const int cc = W_COLS ? e % RP : e / SHRINK_KC;
      const int kk = W_COLS ? e / RP : e % SHRINK_KC;
      const int64_t off = W_COLS ? (int64_t)(k0 + kk) * r + cc
                                 : (int64_t)cc * d_in + k0 + kk;
      wr[i] = (cc < r && kk < kc) ? load_any(w, wbase + off, w_dtype) : 0.f;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < d_in; k0 += SHRINK_KC) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * SHRINK_THREADS;
      xs[e / SHRINK_KC][e % SHRINK_KC] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int e = tid + i * SHRINK_THREADS;
      if (W_COLS) ws[e % RP][e / RP] = wr[i];
      else        ws[e / SHRINK_KC][e % SHRINK_KC] = wr[i];
    }
    __syncthreads();
    if (k0 + SHRINK_KC < d_in) fetch(k0 + SHRINK_KC);   // in flight below
    if (g < SHRINK_ROWS) {
#pragma unroll 4
      for (int kk = 0; kk < SHRINK_KC; kk += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[c][kk]);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int row = g + j * NG;
          if (row < SHRINK_ROWS) {
            const float4 xv = *reinterpret_cast<const float4*>(&xs[row][kk]);
            float a = acc[j];
            a = __fmaf_rn(xv.x, wv.x, a);
            a = __fmaf_rn(xv.y, wv.y, a);
            a = __fmaf_rn(xv.z, wv.z, a);
            a = __fmaf_rn(xv.w, wv.w, a);
            acc[j] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  if (c >= r) return;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = g + j * NG;
    if (row < nrows) {
      const int64_t o = (row0 + row) * r + c;
      out[o] = scale == nullptr
          ? acc[j] : __fmul_rn(acc[j], load_any(scale, o, scale_dtype));
    }
  }
}

// Launch one instantiation per rank bucket: RP = r rounded up to a power
// of two.  Grid: (tiles, slabs of SHRINK_ROWS rows per tile).
template <bool W_COLS>
int grouped_shrink_launch(const void* x, int x_dtype, const void* w,
                          int w_dtype, const int* tile_ids, const void* scale,
                          int scale_dtype, float* out, int n_tiles, int bt,
                          int d_in, int r, cudaStream_t st) {
  if (r < 1 || r > SGMV_RMAX || bt < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  dim3 grid(n_tiles, (bt + SHRINK_ROWS - 1) / SHRINK_ROWS);
#define SHRINK_CASE(RPV)                                                    \
  grouped_shrink_kernel<RPV, W_COLS><<<grid, SHRINK_THREADS, 0, st>>>(      \
      x, x_dtype, w, w_dtype, tile_ids, scale, scale_dtype, out, d_in, r,  \
      bt)
  if (r <= 4) SHRINK_CASE(4);
  else if (r <= 8) SHRINK_CASE(8);
  else if (r <= 16) SHRINK_CASE(16);
  else if (r <= 32) SHRINK_CASE(32);
  else SHRINK_CASE(64);
#undef SHRINK_CASE
  return (int)cudaGetLastError();
}
