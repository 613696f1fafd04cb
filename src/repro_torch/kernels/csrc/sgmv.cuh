// The grouped "shrink" shared by sgmv.cu (sgmv_shrink) and jd_apply.cu
// (jd_shrink_scale): per token tile, out[t, c] = sum_k x[t, k] * W[w, c, k]
// in f32, optionally times a per-token scale once the sum over d_in is
// complete.  Replaces the TPU kernels kernels/sgmv.py::sgmv_shrink
// (_shrink_kernel) and kernels/jd_apply.py::jd_shrink_scale
// (_shrink_scale_kernel).
//
// Tokens arrive grouped (repro_torch/kernels/ref.py::
// group_tokens_by_adapter): tile i holds rows [i*bt, (i+1)*bt), all with
// the bank index tile_ids[i], which the block reads itself (the TPU
// kernel's scalar prefetch).  The TPU runs one grid step per (tile, 512-wide
// d_in block) in order and carries the sum in its output block; here one
// block owns a slab of rows of one tile and walks all of d_in itself, so
// nothing crosses blocks, no atomics are used, and every sum is taken in
// the same order on every run (results repeat bit for bit).
//
// Bound on an H100: memory.  Each x row is read once (T_pad * d_in
// elements, ~32 MB in bf16 at the prefill shapes: ~10 us at 3.35 TB/s) and
// each weight slice once per slab from L2; N = r is tiny and K = d_in long,
// so the products (2 * T_pad * d_in * r operations) must cost next to
// nothing and the kernel must keep enough of x in flight.
//
// Two kernels behind one launch function, chosen by dtype and alignment
// (never by catching a failure):
//
// * bf16 x with a bf16 bank, or with an f32 V bank (jd_shrink_scale's
//   bases): grouped_shrink_mma_kernel, on the tensor cores.  A
//   block owns a 32-row slab of a tile (two mma M tiles; 128 blocks at
//   4096 rows, one per SM) and its 8 warps walk d_in in 64-wide chunks,
//   warp w taking chunks w, w + 8, ...  Each warp streams its x chunk
//   (32 x 64) and weight chunk (RP x 64, or 64 x RP for a V bank) through
//   its own ring of 16-byte cp.async copies (4 chunks deep, fewer where a
//   larger rank leaves less of the 227 KB), and per 16 of d_in issues
//   mma.sync.m16n8k16 (bf16 in, f32 out) fed by ldmatrix (.trans for a V
//   bank, whose basis columns are strided); each weight fragment serves
//   both M tiles, so a tile's weight slice crosses L2 once per 32 rows.
//   Each mma starts from a zero C and its result is added to a register
//   accumulator with __fadd_rn, so the sums over d_in stay IEEE whatever
//   the tensor core's own internal rounding; the eight warps' partials are
//   then summed in shared memory in warp order.  Rows past the tile,
//   columns past r (RP = r rounded up to 16, 32 or 64) and d_in past its
//   end are zero-filled.  Where a row is not 16-byte aligned (d_in, or r
//   for a V bank, not a multiple of 8, or a pointer off 16 bytes) the same
//   kernel fills its ring with plain element loads instead of cp.async.
//   An f32 V bank streams as f32 in 32-wide chunks; each lane splits the
//   values of its B fragments into three bf16 pieces (split3) and issues
//   one mma per piece: the pieces sum to V exactly and each product with
//   a bf16 x is exact, so the result carries the bf16 path's errors (two
//   more f32 roundings per 16 of d_in), inside the checks' 2**-20 * M.
//   Slabs of 16 rows (256 blocks, 4 warps), of 32 rows with 4 warps and
//   of 64 rows all ran slower at the prefill shapes than 32 rows with 8
//   warps (H100 80GB HBM3, 700 W); chip_smoke.py times the kernel kept.
// * f32 x, or an f32 A bank: grouped_shrink_kernel on the CUDA cores.  Per
//   SHRINK_KC-wide chunk of d_in the block stages an 8-row slab of x and
//   the (RP, SHRINK_KC) weight chunk in shared memory as f32; thread (c, g)
//   keeps RPT accumulators for column c and rows g, g + NG, ..., reading
//   one float4 of the weight chunk for RPT float4 reads of x; each thread
//   loads its share of the next chunk into registers before it computes on
//   the current one.
#pragma once

#include "common.cuh"

#define SHRINK_THREADS 128
#define SHRINK_ROWS 8
#define SHRINK_KC 64
#define SHRINK_PAD 4               // keeps rows 16-byte aligned, spreads banks
#define SGMV_RMAX 64

// -- the CUDA-core shrink (any f32 operand) ----------------------------------

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

// -- the tensor-core shrink (bf16 x; bf16 W, or an f32 V bank) -------------

#define TC_WARPS 8
#define TC_MT 2                    // m16 tiles of a block's slab
#define TC_ROWS (16 * TC_MT)       // rows of a block's slab

// One warp's ring of chunks: x (TC_ROWS x KC, bf16) then the weights'
// (RP x KC for an A bank; KC x RP for a V bank, in WT).  A ring holds as
// many chunks (at most 4) as fit in a block's 227 KB of shared memory;
// after the loop the rings hold the warps' f32 partials.
template <int RP, bool W_COLS, typename WT>
struct ShrinkRing {
  static constexpr bool F32 = sizeof(WT) == 4;
  static constexpr int KC = F32 ? 32 : 64;              // d_in of a chunk
  static constexpr int LD = KC + 8;   // x row in bf16: 80 or 144 bytes, so
                                      // an ldmatrix's 8 rows hit 8 bank groups
  static constexpr int WLD = W_COLS ? RP + (F32 ? 4 : 8) : LD;  // in WT
  static constexpr int EPS = 16 / (int)sizeof(WT);      // WT per 16 bytes
  static constexpr int X_BYTES = TC_ROWS * LD * 2;
  static constexpr int STAGE_BYTES =
      X_BYTES + (W_COLS ? KC : RP) * WLD * (int)sizeof(WT);
  static constexpr int FIT = 232448 / (TC_WARPS * STAGE_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BYTES = TC_WARPS * STAGES * STAGE_BYTES;
  static_assert(W_COLS || !F32, "f32 weights only as a V bank");
  static_assert(STAGES >= 2, "a ring needs two chunks");
  static_assert(TC_WARPS * TC_ROWS * RP * 4 <= BYTES, "the partials fit");
};

// VEC: every 16-byte segment of an x row and of a weight row is aligned,
// so the ring fills by cp.async; otherwise by plain element loads.
template <int RP, bool W_COLS, bool VEC, typename WT>
__global__ void __launch_bounds__(TC_WARPS * 32) grouped_shrink_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const WT* __restrict__ w,
    const int* __restrict__ tile_ids, const void* __restrict__ scale,
    int scale_dtype, float* __restrict__ out, int d_in, int r, int bt) {
  using S = ShrinkRing<RP, W_COLS, WT>;
  constexpr int KC = S::KC, LD = S::LD, WLD = S::WLD, EPS = S::EPS;
  constexpr int NT = RP / 8;                            // n8 tiles
  constexpr int SEGS = KC / 8;                          // 16-byte x segments
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = smem + warp * S::STAGES * S::STAGE_BYTES;
  float* part = reinterpret_cast<float*>(smem);        // after the loop

  const int tile = blockIdx.x;
  const int slab0 = blockIdx.y * TC_ROWS;
  const int nrows = min(TC_ROWS, bt - slab0);
  const int64_t row0 = (int64_t)tile * bt + slab0;
  const __nv_bfloat16* xb = x + row0 * d_in;
  const WT* wb = w + (int64_t)tile_ids[tile] * r * d_in;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const WT wzero = from_f<WT>(0.f);
  const int n_chunks = (d_in + KC - 1) / KC;
  const int my_chunks = warp < n_chunks
      ? (n_chunks - warp + TC_WARPS - 1) / TC_WARPS : 0;

  // chunk `chunk` (d_in from chunk * KC) into ring stage `stage`
  auto fetch = [&](int stage, int chunk) {
    unsigned char* base = ring + stage * S::STAGE_BYTES;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    WT* ws = reinterpret_cast<WT*>(base + S::X_BYTES);
    const int k0 = chunk * KC;
    if (VEC) {
      for (int i = lane; i < TC_ROWS * SEGS; i += 32) {
        const int row = i / SEGS, k = k0 + (i % SEGS) * 8;
        const bool ok = row < nrows && k < d_in;
        cp_async16(xs + row * LD + (i % SEGS) * 8,
                   ok ? xb + (int64_t)row * d_in + k : xb, ok ? 16 : 0);
      }
      if (W_COLS) {
        for (int i = lane; i < KC * (RP / EPS); i += 32) {
          const int kk = i / (RP / EPS), c = (i % (RP / EPS)) * EPS;
          const bool ok = k0 + kk < d_in && c < r;
          cp_async16(ws + kk * WLD + c,
                     ok ? wb + (int64_t)(k0 + kk) * r + c : wb, ok ? 16 : 0);
        }
      } else {
        for (int i = lane; i < RP * SEGS; i += 32) {
          const int c = i / SEGS, k = k0 + (i % SEGS) * 8;
          const bool ok = c < r && k < d_in;
          cp_async16(ws + c * WLD + (i % SEGS) * 8,
                     ok ? wb + (int64_t)c * d_in + k : wb, ok ? 16 : 0);
        }
      }
    } else {
      for (int i = lane; i < TC_ROWS * KC; i += 32) {
        const int row = i / KC, kk = i % KC;
        xs[row * LD + kk] = (row < nrows && k0 + kk < d_in)
            ? xb[(int64_t)row * d_in + k0 + kk] : zero;
      }
      for (int i = lane; i < RP * KC; i += 32) {
        if (W_COLS) {
          const int kk = i / RP, c = i % RP;
          ws[kk * WLD + c] = (k0 + kk < d_in && c < r)
              ? wb[(int64_t)(k0 + kk) * r + c] : wzero;
        } else {
          const int c = i / KC, kk = i % KC;
          ws[c * WLD + kk] = (c < r && k0 + kk < d_in)
              ? wb[(int64_t)c * d_in + k0 + kk] : wzero;
        }
      }
    }
  };

  // acc[m][j]: the 16 x 8 output block of m16 tile m and n8 tile j, as
  // the mma lays out C: (m * 16 + lane / 4, j * 8 + lane % 4 * 2 + {0, 1})
  // and 8 rows below
  float acc[TC_MT][NT][4];
#pragma unroll
  for (int m = 0; m < TC_MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  const int g = lane / 4, kq = (lane % 4) * 2;
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < my_chunks) fetch(s, warp + s * TC_WARPS);
    cp_async_commit();
  }
  for (int i = 0; i < my_chunks; ++i) {
    cp_async_wait<S::STAGES - 2>();       // chunk i has landed
    __syncwarp();                         // ... for every lane; stage
                                          // (i - 1) % S::STAGES is free
    const int nxt = i + S::STAGES - 1;
    if (nxt < my_chunks) fetch(nxt % S::STAGES, warp + nxt * TC_WARPS);
    cp_async_commit();
    const unsigned char* base = ring + (i % S::STAGES) * S::STAGE_BYTES;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const WT* ws = reinterpret_cast<const WT*>(base + S::X_BYTES);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[TC_MT][4];
#pragma unroll
      for (int m = 0; m < TC_MT; ++m)
        ldmatrix_x4(a[m], xs + (m * 16 + lane % 16) * LD + ks * 16
                              + (lane / 16) * 8);
      if constexpr (S::F32) {
        // B fragments of n8 tile j straight from the f32 chunk: this
        // lane's (k, n) = (ks*16 + kq + {0, 1, 8, 9}, j*8 + g), split
        // into three bf16 pieces, one mma per piece
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          __nv_bfloat16 pc[4][3];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split3(ws[(ks * 16 + kq + (e & 1) + (e >> 1) * 8) * WLD + j * 8
                      + g], pc[e]);
#pragma unroll
          for (int m = 0; m < TC_MT; ++m) {
            float d[3][4];
#pragma unroll
            for (int q = 0; q < 3; ++q)
              mma_bf16_zero_c(d[q], a[m], pack_bf16x2(pc[0][q], pc[1][q]),
                              pack_bf16x2(pc[2][q], pc[3][q]));
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[m][j][q] = __fadd_rn(acc[m][j][q], __fadd_rn(
                  d[0][q], __fadd_rn(d[1][q], d[2][q])));
          }
        }
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {    // n8 tiles 2p and 2p + 1
          uint32_t b[4];
          if (W_COLS)
            ldmatrix_x4_trans(b, ws + (ks * 16 + lane % 8
                                       + (lane / 8) % 2 * 8) * WLD
                                     + p * 16 + (lane / 16) * 8);
          else
            ldmatrix_x4(b, ws + (p * 16 + lane % 8 + (lane / 16) * 8) * WLD
                               + ks * 16 + (lane / 8) % 2 * 8);
#pragma unroll
          for (int m = 0; m < TC_MT; ++m) {
            float d[4];
            mma_bf16_zero_c(d, a[m], b[0], b[1]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[m][2 * p][q] = __fadd_rn(acc[m][2 * p][q], d[q]);
            mma_bf16_zero_c(d, a[m], b[2], b[3]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[m][2 * p + 1][q] = __fadd_rn(acc[m][2 * p + 1][q], d[q]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // every ring is read

  // the warps' partials, summed in warp order
  float* mine = part + warp * TC_ROWS * RP;
#pragma unroll
  for (int m = 0; m < TC_MT; ++m) {
    const int row = m * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mine[row * RP + j * 8 + kq] = acc[m][j][0];
      mine[row * RP + j * 8 + kq + 1] = acc[m][j][1];
      mine[(row + 8) * RP + j * 8 + kq] = acc[m][j][2];
      mine[(row + 8) * RP + j * 8 + kq + 1] = acc[m][j][3];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TC_ROWS * RP; e += TC_WARPS * 32) {
    const int row = e / RP, c = e % RP;
    if (row >= nrows || c >= r) continue;
    float s = part[e];
#pragma unroll
    for (int v = 1; v < TC_WARPS; ++v)
      s = __fadd_rn(s, part[v * TC_ROWS * RP + e]);
    const int64_t o = (row0 + row) * r + c;
    out[o] = scale == nullptr
        ? s : __fmul_rn(s, load_any(scale, o, scale_dtype));
  }
}

template <int RP, bool W_COLS, bool VEC, typename WT>
int shrink_mma_launch(const void* x, const void* w, const int* tile_ids,
                      const void* scale, int scale_dtype, float* out,
                      int n_tiles, int bt, int d_in, int r, cudaStream_t st) {
  auto kernel = grouped_shrink_mma_kernel<RP, W_COLS, VEC, WT>;
  constexpr int bytes = ShrinkRing<RP, W_COLS, WT>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(n_tiles, (bt + TC_ROWS - 1) / TC_ROWS);
  kernel<<<grid, TC_WARPS * 32, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const WT*>(w),
      tile_ids, scale, scale_dtype, out, d_in, r, bt);
  return (int)cudaGetLastError();
}

template <bool W_COLS, typename WT>
int shrink_mma_dispatch(bool vec, const void* x, const void* w,
                        const int* tile_ids, const void* scale,
                        int scale_dtype, float* out, int n_tiles, int bt,
                        int d_in, int r, cudaStream_t st) {
#define SHRINK_MMA_CASE(RPV)                                               \
  return vec ? shrink_mma_launch<RPV, W_COLS, true, WT>(                   \
                   x, w, tile_ids, scale, scale_dtype, out, n_tiles, bt,   \
                   d_in, r, st)                                            \
             : shrink_mma_launch<RPV, W_COLS, false, WT>(                  \
                   x, w, tile_ids, scale, scale_dtype, out, n_tiles, bt,   \
                   d_in, r, st)
  if (r <= 16) SHRINK_MMA_CASE(16);
  if (r <= 32) SHRINK_MMA_CASE(32);
  SHRINK_MMA_CASE(64);
#undef SHRINK_MMA_CASE
}

// Launch the tensor-core kernel for bf16 x with a bf16 bank or an f32 V
// bank (RP = r rounded up to 16, 32 or 64; grid: tiles x 32-row slabs),
// else the CUDA-core kernel (RP = r rounded up to a power of two; grid:
// tiles x 8-row slabs).
template <bool W_COLS>
int grouped_shrink_launch(const void* x, int x_dtype, const void* w,
                          int w_dtype, const int* tile_ids, const void* scale,
                          int scale_dtype, float* out, int n_tiles, int bt,
                          int d_in, int r, cudaStream_t st) {
  if (r < 1 || r > SGMV_RMAX || bt < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  const bool aligned = d_in % 8 == 0 && aligned16(x) && aligned16(w);
  if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    return shrink_mma_dispatch<W_COLS, __nv_bfloat16>(
        aligned && (!W_COLS || r % 8 == 0), x, w, tile_ids, scale,
        scale_dtype, out, n_tiles, bt, d_in, r, st);
  if constexpr (W_COLS) {
    if (x_dtype == DT_BF16 && w_dtype == DT_F32)
      return shrink_mma_dispatch<true, float>(
          aligned && r % 4 == 0, x, w, tile_ids, scale, scale_dtype, out,
          n_tiles, bt, d_in, r, st);
  }
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
