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
// shrink: see sgmv.cuh (tensor cores for bf16 x, 32-row slabs).
// expand, bf16 t (sgmv_expand_mma_kernel, tensor cores): K = r is tiny and
//   the output is the bytes, so the design is about the stores.  A block
//   owns (tile, 128 output channels): it stages its B columns (128 x r,
//   zero-padded to KP = r rounded up to 16) in shared memory once, then
//   each of its 4 warps takes 16-row slabs of the tile (warp w: slabs w,
//   w + 4, ...), loads the slab's t rows, and per pair of n8 tiles issues
//   KP / 16 mma.sync.m16n8k16 from a zero C, each result added with
//   __fadd_rn.  An f32 bank is staged as three bf16 planes (sgmv.cuh's
//   split3: the pieces sum to B exactly and the products stay exact) and
//   takes three mmas per step.  The f32 sums are rounded to bf16 once and
//   staged in shared memory, and the warp writes the slab's 16 x 128
//   outputs as 16-byte stores, 16 lanes to a 256-byte row segment (2-byte
//   stores where d_out is not a multiple of 8).  At the prefill shapes it
//   writes about as fast as one cuBLAS bmm does (chip_smoke.py's
//   sgmv_expand row); loading the whole tile's t rows with B before one
//   block-wide wait was slower (H100 80GB HBM3, 700 W).
// expand, f32 t (sgmv_expand_kernel, CUDA cores): one block per (tile,
//   128 output channels); thread o keeps the r weights of channel o in
//   registers and walks the tile's rows, reading each row of t (staged in
//   shared memory, 32 rows at a time) as float4 broadcasts; consecutive
//   threads write consecutive channels.
// sigma_bmm (CUDA cores): r is at most 64, so each output is a short sum
//   and the kernel is latency: one block per (tile, BMM_ROWS rows), 512
//   blocks at 4096 rows (at the prefill shapes 8 rows a block ran faster
//   than 16 or 32, and 128 threads than 64; H100 80GB HBM3, 700 W).  A block stages its rows of t (while the tile's
//   id is in flight) and Sigma[id] as f32 in shared memory, 16 bytes a
//   load where aligned; consecutive threads then write
//   consecutive outputs, each an ascending __fmaf_rn sum over j.

#include "sgmv.cuh"

#define EXPAND_COLS 128
#define EXPAND_ROWS 32

template <int RP>
__global__ void __launch_bounds__(EXPAND_COLS) sgmv_expand_kernel(
    const float* __restrict__ t, const void* __restrict__ w, int w_dtype,
    const int* __restrict__ tile_ids, float* __restrict__ out, int bt, int r,
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
          ? t[(row0 + s0 + row) * r + j] : 0.f;
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
        out[(row0 + s0 + row) * d_out + o] = acc;
      }
    }
    __syncthreads();
  }
}

#define EXP_TC_WARPS 4
#define EXP_TC_COLS 128                      // output channels of a block
#define EXP_TC_LDO (EXP_TC_COLS + 8)         // staged output row, in bf16

// Shared memory of the tensor-core expand: the B columns as P bf16 planes
// (P = 1 for a bf16 bank; 3 for an f32 bank, split3's pieces), each warp's
// t slab, each warp's staged outputs.
template <int KP, int P>
struct ExpandSmem {
  static constexpr int LDK = KP + 8;   // 16-byte aligned rows, no ldmatrix
                                       // bank conflicts
  static constexpr int PLANE = EXP_TC_COLS * LDK;
  static constexpr int BYTES =
      2 * (P * PLANE + EXP_TC_WARPS * 16 * (LDK + EXP_TC_LDO));
};

// KP: r rounded up to 16 (one mma's K).  VEC: d_out % 8 == 0 and out
// 16-byte aligned, so each staged row segment goes out as one 16-byte store.
template <int KP, bool VEC, typename WT>
__global__ void __launch_bounds__(EXP_TC_WARPS * 32) sgmv_expand_mma_kernel(
    const __nv_bfloat16* __restrict__ t, const WT* __restrict__ w,
    const int* __restrict__ tile_ids, __nv_bfloat16* __restrict__ out,
    int bt, int r, int d_out) {
  constexpr int P = sizeof(WT) == 4 ? 3 : 1;
  using S = ExpandSmem<KP, P>;
  constexpr int LDK = S::LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* tw = bs + P * S::PLANE + warp * 16 * LDK;
  __nv_bfloat16* ow = bs + P * S::PLANE + EXP_TC_WARPS * 16 * LDK
      + warp * 16 * EXP_TC_LDO;
  const int tile = blockIdx.x;
  const int o0 = blockIdx.y * EXP_TC_COLS;
  const int64_t row0 = (int64_t)tile * bt;
  const WT* wb = w + ((int64_t)tile_ids[tile] * d_out + o0) * r;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  for (int e = threadIdx.x; e < EXP_TC_COLS * KP; e += EXP_TC_WARPS * 32) {
    const int o = e / KP, k = e % KP;
    const bool ok = o0 + o < d_out && k < r;
    if constexpr (P == 1) {
      bs[o * LDK + k] = ok ? wb[(int64_t)o * r + k] : zero;
    } else {
      __nv_bfloat16 pc[3];
      split3(ok ? wb[(int64_t)o * r + k] : 0.f, pc);
#pragma unroll
      for (int q = 0; q < 3; ++q) bs[q * S::PLANE + o * LDK + k] = pc[q];
    }
  }
  __syncthreads();

  const int g = lane / 4, cq = (lane % 4) * 2;
  for (int s0 = warp * 16; s0 < bt; s0 += EXP_TC_WARPS * 16) {
    const int nrows = min(16, bt - s0);
    const __nv_bfloat16* tb = t + (row0 + s0) * r;
    for (int e = lane; e < 16 * KP; e += 32) {
      const int row = e / KP, k = e % KP;
      tw[row * LDK + k] = (row < nrows && k < r) ? tb[(int64_t)row * r + k]
                                                 : zero;
    }
    __syncwarp();
    uint32_t a[KP / 16][4];
#pragma unroll
    for (int ks = 0; ks < KP / 16; ++ks)
      ldmatrix_x4(a[ks], tw + (lane % 16) * LDK + ks * 16 + (lane / 16) * 8);
#pragma unroll 2
    for (int p = 0; p < EXP_TC_COLS / 16; ++p) {   // n8 tiles 2p, 2p + 1
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KP / 16; ++ks) {
        // d[h][q]: n8 tile 2p + h from plane q (h + m + l for f32)
        float d[2][P][4];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          uint32_t b[4];
          ldmatrix_x4(b, bs + q * S::PLANE
                             + (p * 16 + lane % 8 + (lane / 16) * 8) * LDK
                             + ks * 16 + (lane / 8) % 2 * 8);
          mma_bf16_zero_c(d[0][q], a[ks], b[0], b[1]);
          mma_bf16_zero_c(d[1][q], a[ks], b[2], b[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (P == 1) {
              acc[h][q] = __fadd_rn(acc[h][q], d[h][0][q]);
            } else {
              acc[h][q] = __fadd_rn(acc[h][q], __fadd_rn(
                  d[h][0][q], __fadd_rn(d[h][1][q], d[h][2][q])));
            }
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = p * 16 + h * 8 + cq;
        *reinterpret_cast<__nv_bfloat162*>(&ow[g * EXP_TC_LDO + col]) =
            __floats2bfloat162_rn(acc[h][0], acc[h][1]);
        *reinterpret_cast<__nv_bfloat162*>(&ow[(g + 8) * EXP_TC_LDO + col]) =
            __floats2bfloat162_rn(acc[h][2], acc[h][3]);
      }
    }
    __syncwarp();
    __nv_bfloat16* ob = out + (row0 + s0) * d_out + o0;
    if (VEC) {
      for (int e = lane; e < 16 * (EXP_TC_COLS / 8); e += 32) {
        const int row = e / (EXP_TC_COLS / 8), c = (e % (EXP_TC_COLS / 8)) * 8;
        if (row < nrows && o0 + c < d_out)
          *reinterpret_cast<uint4*>(ob + (int64_t)row * d_out + c) =
              *reinterpret_cast<const uint4*>(&ow[row * EXP_TC_LDO + c]);
      }
    } else {
      for (int e = lane; e < 16 * EXP_TC_COLS; e += 32) {
        const int row = e / EXP_TC_COLS, c = e % EXP_TC_COLS;
        if (row < nrows && o0 + c < d_out)
          ob[(int64_t)row * d_out + c] = ow[row * EXP_TC_LDO + c];
      }
    }
    __syncwarp();                      // tw and ow are reused
  }
}

template <int KP, bool VEC, typename WT>
static int expand_mma_launch_kp(const void* t, const void* w,
                                const int* tile_ids, void* out, int n_tiles,
                                int bt, int r, int d_out, cudaStream_t st) {
  auto kernel = sgmv_expand_mma_kernel<KP, VEC, WT>;
  constexpr int bytes = ExpandSmem<KP, sizeof(WT) == 4 ? 3 : 1>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(n_tiles, (d_out + EXP_TC_COLS - 1) / EXP_TC_COLS);
  kernel<<<grid, EXP_TC_WARPS * 32, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(t), static_cast<const WT*>(w),
      tile_ids, static_cast<__nv_bfloat16*>(out), bt, r, d_out);
  return (int)cudaGetLastError();
}

template <bool VEC, typename WT>
static int expand_mma_launch(const void* t, const void* w,
                             const int* tile_ids, void* out, int n_tiles,
                             int bt, int r, int d_out, cudaStream_t st) {
#define EXPAND_MMA_CASE(KPV)                                               \
  return expand_mma_launch_kp<KPV, VEC, WT>(t, w, tile_ids, out, n_tiles,  \
                                            bt, r, d_out, st)
  if (r <= 16) EXPAND_MMA_CASE(16);
  if (r <= 32) EXPAND_MMA_CASE(32);
  if (r <= 48) EXPAND_MMA_CASE(48);
  EXPAND_MMA_CASE(64);
#undef EXPAND_MMA_CASE
}

template <typename WT>
static int expand_mma_route(const void* t, const void* w, const int* tile_ids,
                            void* out, int n_tiles, int bt, int r, int d_out,
                            cudaStream_t st) {
  return d_out % 8 == 0 && aligned16(out)
      ? expand_mma_launch<true, WT>(t, w, tile_ids, out, n_tiles, bt, r,
                                    d_out, st)
      : expand_mma_launch<false, WT>(t, w, tile_ids, out, n_tiles, bt, r,
                                     d_out, st);
}

#define BMM_THREADS 128
#define BMM_ROWS 8           // rows of a tile per block

// `n` values of a bf16 or f32 array as f32 into shared memory, 16 bytes a
// load where the source is aligned and n is a multiple of a load
template <typename T>
static __device__ __forceinline__ void stage_f32(float* dst, const T* src,
                                                 int n) {
  constexpr int VE = 16 / sizeof(T);
  if (aligned16(src) && n % VE == 0) {
    for (int i = threadIdx.x; i < n / VE; i += BMM_THREADS) {
      float f[VE];
      unpack16(src + i * VE, f);
#pragma unroll
      for (int e = 0; e < VE; e += 4)
        *reinterpret_cast<float4*>(dst + i * VE + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += BMM_THREADS) dst[i] = to_f(src[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(BMM_THREADS) sigma_bmm_kernel(
    const T* __restrict__ t, const void* __restrict__ sigma, int s_dtype,
    const int* __restrict__ tile_ids, T* __restrict__ out, int bt, int r) {
  __shared__ __align__(16) float ss[SGMV_RMAX * SGMV_RMAX];
  __shared__ __align__(16) float ts[BMM_ROWS * SGMV_RMAX];
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BMM_ROWS;
  const int ne = min(BMM_ROWS, bt - row0) * r;     // this block's outputs
  const int64_t e0 = ((int64_t)tile * bt + row0) * r;
  const int id = tile_ids[tile];       // in flight while t's rows load
  stage_f32(ts, t + e0, ne);
  const int64_t sbase = (int64_t)id * r * r;
  if (s_dtype == DT_BF16)
    stage_f32(ss, static_cast<const __nv_bfloat16*>(sigma) + sbase, r * r);
  else
    stage_f32(ss, static_cast<const float*>(sigma) + sbase, r * r);
  __syncthreads();
  // consecutive threads, consecutive outputs; each sum in ascending j
  for (int e = threadIdx.x; e < ne; e += BMM_THREADS) {
    const int row = e / r, q = e - row * r;
    const float* trow = ts + row * r;
    float acc = 0.f;
    for (int j = 0; j < r; ++j) acc = __fmaf_rn(trow[j], ss[j * r + q], acc);
    out[e0 + e] = from_f<T>(acc);
  }
}

static int expand_launch(const float* t, const void* w, int w_dtype,
                         const int* tile_ids, float* out, int n_tiles, int bt,
                         int r, int d_out, cudaStream_t st) {
  dim3 grid(n_tiles, (d_out + EXPAND_COLS - 1) / EXPAND_COLS);
#define EXPAND_CASE(RPV)                                                   \
  sgmv_expand_kernel<RPV><<<grid, EXPAND_COLS, 0, st>>>(                   \
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
  if (r < 1 || r > SGMV_RMAX || bt < 1 || t_dtype == DT_I8 ||
      (b_dtype != DT_F32 && b_dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0 || d_out == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (t_dtype == DT_BF16 && b_dtype == DT_BF16)
    return expand_mma_route<__nv_bfloat16>(t, B, tile_ids, out, n_tiles, bt,
                                           r, d_out, st);
  if (t_dtype == DT_BF16)
    return expand_mma_route<float>(t, B, tile_ids, out, n_tiles, bt, r,
                                   d_out, st);
  return expand_launch(static_cast<const float*>(t), B, b_dtype, tile_ids,
                       static_cast<float*>(out), n_tiles, bt, r, d_out, st);
}

// t (T_pad, r), Sigma (n, r, r) -> out (T_pad, r) in t's type
int sigma_bmm_launch(const void* t, int t_dtype, const void* sigma,
                     int s_dtype, const int* tile_ids, void* out, int n_tiles,
                     int bt, int r, void* stream) {
  if (r < 1 || r > SGMV_RMAX || bt < 1 || t_dtype == DT_I8 ||
      (s_dtype != DT_F32 && s_dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n_tiles, (bt + BMM_ROWS - 1) / BMM_ROWS);
  if (t_dtype == DT_BF16)
    sigma_bmm_kernel<__nv_bfloat16><<<grid, BMM_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t), sigma, s_dtype, tile_ids,
        static_cast<__nv_bfloat16*>(out), bt, r);
  else
    sigma_bmm_kernel<float><<<grid, BMM_THREADS, 0, st>>>(
        static_cast<const float*>(t), sigma, s_dtype, tile_ids,
        static_cast<float*>(out), bt, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
