// Symmetric int8 per-output-channel quantization of adapter / basis banks,
// and its inverse: the Hopper kernels behind repro_torch/kernels/
// adapter_quant.py.
//
// Replaces the TPU kernels kernels/adapter_quant.py::adapter_quantize
// (_quant_rows_kernel / _quant_cols_kernel) and ::adapter_dequantize
// (_dequant_kernel).  For a bank w (N, R, C):
//   rows (axis=-1): scale[n, i]  = absmax_j |w[n, i, j]| / 127  (1 if 0);
//   cols (axis=-2): scale[n, j]  = absmax_i |w[n, i, j]| / 127  (1 if 0);
//   q = clip(rint(w / scale), -127, 127);   out = q * scale.
// Both equal the plain versions exactly (scale_of of common.cuh, shared
// with kv_quant.cu; quant_screened below, equal to common.cuh's quant; one
// f32 multiply and one rounding to the output type).  The absmax is
// order-independent.  No atomics, no ordered grid.
//
// Bound on an H100: memory.  Quantize reads w once (16-byte loads into
// registers, reduced, then quantized from the registers) and writes q (a
// quarter or half of it) plus the scales; dequantize reads q once (16 int8
// values a thread) and writes out (4 or 2 bytes a value).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// -- quantize -----------------------------------------------------------------

#define QT 256          // threads of every quantize block
#define HOLD 16         // 16-byte chunks a cluster-kernel thread holds
#define GROUP_STEPS 4   // chunks a thread of the short-row kernel takes
#define COL_MAX 256     // widest row of the cluster kernel: 32 chunks of bf16

// values in 16 bytes of a bank
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int V = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
};

__device__ __forceinline__ void chunk_floats(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void chunk_floats(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ float chunk_absmax(const uint4& u) {
  float f[Chunk<T>::V];
  chunk_floats(u, f);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < Chunk<T>::V; ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

// One value's level: equal to quant() of common.cuh, rintf of the IEEE
// quotient x / s clipped to [-qmax, qmax], with the division taken only
// where it can change the level.  r = __frcp_rn(s), p = x * r rounded, t
// the exact x / s: r = (1/s)(1 + d1), p = t (1 + d1)(1 + d2) and
// fl(t) = t (1 + d3), each |d| <= 2^-24, so |p - fl(t)| < 2^-22 |t|, and
// where |p| <= 256, |t| < 257 and |p - fl(t)| < 2^-13.  rintf is constant
// on each open interval (k - 1/2, k + 1/2): if p lies more than 2^-10
// inside one, fl(t) lies in the same one and rintf(fl(t)) = rintf(p).
// Every other p (within 2^-10 of a half-integer, past 256, or not finite:
// r is inf where s < 2^-128) takes __fdiv_rn.  A subnormal p or fl(t) is
// within 2^-149 of its real value and below 2^-126: both round to 0.
__device__ __forceinline__ int quant_screened(float x, float s, float r,
                                              float qmax) {
  const float p = __fmul_rn(x, r);
  float qv = rintf(p);
  if (!(fabsf(__fsub_rn(p, qv)) < 0.4990234375f && fabsf(p) <= 256.f))
    qv = rintf(__fdiv_rn(x, s));
  return (int)fminf(fmaxf(qv, -qmax), qmax);
}

__device__ __forceinline__ uint32_t pack_i8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8)
      | ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// the V levels of one chunk at q (V-byte aligned): one 4- or 8-byte store
__device__ __forceinline__ void store_levels(int8_t* q, const int (&l)[4]) {
  *reinterpret_cast<uint32_t*>(q) = pack_i8x4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void store_levels(int8_t* q, const int (&l)[8]) {
  *reinterpret_cast<uint2*>(q) = make_uint2(pack_i8x4(l[0], l[1], l[2], l[3]),
                                            pack_i8x4(l[4], l[5], l[6], l[7]));
}

// one chunk quantized with one scale
template <typename T>
__device__ __forceinline__ void quant_chunk(int8_t* q, const uint4& u,
                                            float s, float r, float qmax) {
  constexpr int V = Chunk<T>::V;
  float f[V];
  int l[V];
  chunk_floats(u, f);
#pragma unroll
  for (int i = 0; i < V; ++i) l[i] = quant_screened(f[i], s, r, qmax);
  store_levels(q, l);
}

// Any other row of whole 16-byte chunks (an A bank's 4096 bf16 values are
// 512): TPR threads a row (four warps), 256 / TPR rows a block.  Thread t
// loads chunks t, t + TPR, ... (each load a warp's 512 adjacent bytes), up
// to UPT of them into registers, takes the row's absmax (warp_max, then
// across the row's warps in shared memory) and quantizes from the
// registers; a row past TPR * UPT chunks reads the rest again.  Four warps
// a row keep a thread's registers few enough for 32-40 warps an SM, which
// keeps more loads in flight than one warp holding a whole row.
#define TPR 128  // threads a row of the long-row kernel
#define UPT 4    // chunks a thread of it holds

template <typename T>
__global__ void __launch_bounds__(QT) adapter_quant_rows_vec_kernel(
    const T* __restrict__ w, int8_t* __restrict__ q,
    float* __restrict__ scale, int64_t rows, int C, float qmax) {
  constexpr int V = Chunk<T>::V;
  constexpr int WPR = TPR / 32;                  // warps a row
  __shared__ float red[QT / 32];
  const int t = threadIdx.x % TPR, rloc = threadIdx.x / TPR;
  const int64_t row = (int64_t)blockIdx.x * (QT / TPR) + rloc;
  const bool live = row < rows;
  const int units = C / V;
  const uint4* src = reinterpret_cast<const uint4*>(w + (live ? row : 0) * C);
  uint4 held[UPT];
#pragma unroll
  for (int k = 0; k < UPT; ++k)
    if (live && k * TPR + t < units) held[k] = __ldg(src + k * TPR + t);
  float mx = 0.f;
#pragma unroll
  for (int k = 0; k < UPT; ++k)
    if (live && k * TPR + t < units) mx = fmaxf(mx, chunk_absmax<T>(held[k]));
  if (live)
    for (int u = UPT * TPR + t; u < units; u += TPR)
      mx = fmaxf(mx, chunk_absmax<T>(__ldg(src + u)));
  mx = warp_max(mx);
  if (WPR > 1) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WPR; ++i) mx = fmaxf(mx, red[rloc * WPR + i]);
  }
  if (!live) return;
  const float s = scale_of(mx, qmax), r = __frcp_rn(s);
  int8_t* dst = q + row * C;
#pragma unroll
  for (int k = 0; k < UPT; ++k)
    if (k * TPR + t < units)
      quant_chunk<T>(dst + (k * TPR + t) * V, held[k], s, r, qmax);
  for (int u = UPT * TPR + t; u < units; u += TPR)
    quant_chunk<T>(dst + u * V, __ldg(src + u), s, r, qmax);
  if (t == 0) scale[row] = s;
}

// Rows of 1, 2, 4, 8 or 16 chunks (the 16-wide rows of B, U and a full
// Sigma: 2 chunks in bf16, 4 in f32): 2^lg adjacent lanes a row, so a warp
// covers 32 >> lg rows and no lane idles; the absmax by shuffles within
// the lane group.  Each thread takes GROUP_STEPS chunks, QT apart (a
// multiple of the group, so a group never straddles), all loaded first.
template <typename T>
__global__ void __launch_bounds__(QT) adapter_quant_rows_group_kernel(
    const T* __restrict__ w, int8_t* __restrict__ q,
    float* __restrict__ scale, int64_t units, int lg, float qmax) {
  constexpr int V = Chunk<T>::V;
  const uint4* src = reinterpret_cast<const uint4*>(w);
  const int64_t base = (int64_t)blockIdx.x * (QT * GROUP_STEPS) + threadIdx.x;
  uint4 held[GROUP_STEPS];
#pragma unroll
  for (int k = 0; k < GROUP_STEPS; ++k) {
    const int64_t u = base + k * QT;
    held[k] = u < units ? __ldg(src + u) : make_uint4(0u, 0u, 0u, 0u);
  }
  const int G = 1 << lg;
#pragma unroll
  for (int k = 0; k < GROUP_STEPS; ++k) {
    const int64_t u = base + k * QT;
    float mx = chunk_absmax<T>(held[k]);
    for (int o = 1; o < G; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (u < units) {
      const float s = scale_of(mx, qmax);
      quant_chunk<T>(q + u * V, held[k], s, __frcp_rn(s), qmax);
      if ((u & (G - 1)) == 0) scale[u >> lg] = s;
    }
  }
}

// Columns (a V bank (N, 4096, 16), reduced over its 4096 rows): a cluster
// of `cl` blocks a matrix, each block a slice of its rows, read once into
// registers (HOLD chunks a thread).  A row is 2^lg chunks; a thread's
// chunks are QT apart, so each thread holds the same columns at every
// step.  Each block reduces its column maxima (shuffles across the lanes
// holding the same columns, then across warps in shared memory), the
// cluster exchanges them through distributed shared memory, and every
// block quantizes its slice from the registers.  Rank 0 writes the scales.
template <typename T>
__global__ void __launch_bounds__(QT) adapter_quant_cols_cluster_kernel(
    const T* __restrict__ w, int8_t* __restrict__ q,
    float* __restrict__ scale, int R, int C, int lg, float qmax) {
  constexpr int V = Chunk<T>::V;
  __shared__ float part[QT / 32][COL_MAX];
  __shared__ float colmax[COL_MAX];
  __shared__ float sc[COL_MAX], rc[COL_MAX];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t n = blockIdx.x / cl;
  const int G = 1 << lg;
  const int per = (R + cl - 1) / cl;
  const int r0 = min(R, rank * per), r1 = min(R, r0 + per);
  const int units = (r1 - r0) << lg;
  const int64_t first = (n * R + r0) << lg;      // the slice's first chunk
  const uint4* src = reinterpret_cast<const uint4*>(w) + first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cu = tid & (G - 1);       // this thread's chunk of a row

  uint4 held[HOLD];
#pragma unroll
  for (int k = 0; k < HOLD; ++k)
    if (k * QT + tid < units) held[k] = __ldg(src + k * QT + tid);
  float cm[V];
#pragma unroll
  for (int i = 0; i < V; ++i) cm[i] = 0.f;
#pragma unroll
  for (int k = 0; k < HOLD; ++k)
    if (k * QT + tid < units) {
      float f[V];
      chunk_floats(held[k], f);
#pragma unroll
      for (int i = 0; i < V; ++i) cm[i] = fmaxf(cm[i], fabsf(f[i]));
    }
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      cm[i] = fmaxf(cm[i], __shfl_xor_sync(0xffffffffu, cm[i], o));
  if (lane < G)
#pragma unroll
    for (int i = 0; i < V; ++i) part[warp][lane * V + i] = cm[i];
  __syncthreads();
  if (tid < C) {
    float m = 0.f;
#pragma unroll
    for (int wi = 0; wi < QT / 32; ++wi) m = fmaxf(m, part[wi][tid]);
    colmax[tid] = m;
  }
  cluster.sync();
  if (tid < C) {
    float m = 0.f;
    for (int b = 0; b < cl; ++b)
      m = fmaxf(m, cluster.map_shared_rank(colmax, b)[tid]);
    const float s = scale_of(m, qmax);
    sc[tid] = s;
    rc[tid] = __frcp_rn(s);
    if (rank == 0) scale[n * C + tid] = s;
  }
  // no block leaves while another reads its maxima; sc and rc are set
  cluster.sync();
  float s[V], r[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] = sc[cu * V + i];
    r[i] = rc[cu * V + i];
  }
  int8_t* dst = q + first * V;
#pragma unroll
  for (int k = 0; k < HOLD; ++k)
    if (k * QT + tid < units) {
      float f[V];
      int l[V];
      chunk_floats(held[k], f);
#pragma unroll
      for (int i = 0; i < V; ++i)
        l[i] = quant_screened(f[i], s[i], r[i], qmax);
      store_levels(dst + (int64_t)(k * QT + tid) * V, l);
    }
}

// Any other bank (a row that is no whole number of 16-byte chunks, a bank
// pointer that is not 16-byte aligned, columns the cluster kernel does not
// take): element loads, one warp per row, or one block per (matrix,
// 32-column tile) in 8 row groups.
#define COL_TILE 32
#define COL_GROUPS 8

__global__ void adapter_quant_rows_kernel(const void* __restrict__ w,
                                          int w_dtype, int8_t* __restrict__ q,
                                          float* __restrict__ scale,
                                          int64_t rows, int C, float qmax) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (QT / 32) + (threadIdx.x >> 5);
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

__global__ void adapter_quant_cols_kernel(const void* __restrict__ w,
                                          int w_dtype, int8_t* __restrict__ q,
                                          float* __restrict__ scale, int R,
                                          int C, float qmax) {
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

template <typename T>
static cudaError_t launch_quant(const void* w, int w_dtype, int8_t* q,
                                float* scale, int64_t N, int R, int C,
                                int rows, float qmax, cudaStream_t st) {
  const int64_t row_bytes = (int64_t)C * sizeof(T);
  const int64_t G = row_bytes / 16;              // chunks a row
  const bool chunks = aligned16(w) && aligned16(q) && row_bytes % 16 == 0;
  const bool pow2 = G > 0 && (G & (G - 1)) == 0;
  int lg = 0;
  while ((1LL << lg) < G) ++lg;
  const T* wt = static_cast<const T*>(w);
  if (rows) {
    const int64_t n_rows = N * R;
    if (chunks && pow2 && G <= 16) {
      const int64_t blocks = (n_rows * G + QT * GROUP_STEPS - 1)
          / (QT * GROUP_STEPS);
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
      adapter_quant_rows_group_kernel<T><<<(unsigned)blocks, QT, 0, st>>>(
          wt, q, scale, n_rows * G, lg, qmax);
      return cudaGetLastError();
    }
    // four warps a row (two rows a block), 4 chunks a thread held; element
    // loads a warp a row (eight rows a block)
    const int per_block = chunks ? QT / TPR : QT / 32;
    const int64_t blocks = (n_rows + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (chunks)
      adapter_quant_rows_vec_kernel<T><<<(unsigned)blocks, QT, 0, st>>>(
          wt, q, scale, n_rows, C, qmax);
    else
      adapter_quant_rows_kernel<<<(unsigned)blocks, QT, 0, st>>>(
          w, w_dtype, q, scale, n_rows, C, qmax);
    return cudaGetLastError();
  }
  // columns: a cluster of CL blocks a matrix, so an L = 32 bank of V bases
  // spreads over 128 SMs; a matrix past their registers takes element loads
  constexpr int CL = 4;
  const int64_t units = (int64_t)R * G;
  if (chunks && pow2 && G <= 32 && units <= (int64_t)CL * QT * HOLD
      && N * CL <= 0x7fffffffLL) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(N * CL));
    cfg.blockDim = dim3(QT);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, adapter_quant_cols_cluster_kernel<T>, wt,
                              q, scale, R, C, lg, qmax);
  }
  if (N > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)N, (C + COL_TILE - 1) / COL_TILE);
  adapter_quant_cols_kernel<<<grid, COL_TILE * COL_GROUPS, 0, st>>>(
      w, w_dtype, q, scale, R, C, qmax);
  return cudaGetLastError();
}

// -- dequantize ---------------------------------------------------------------
//
// out[n, i, j] = q[n, i, j] * scale (scale[n, i] for rows, scale[n, j] for
// cols): one f32 multiply (__fmul_rn) and one rounding to the output type,
// so it equals the plain version bit for bit.  One launch takes a group
// of up to DEQ_MAX_BANKS banks of any layouts, passed by value as a
// __grid_constant__ parameter (no copy to the device, no sync); each bank
// owns a run of blocks, found from the first-block offsets.  A thread
// takes one 16-byte load of 16 int8 values and writes four (f32) or two
// (bf16) 16-byte stores.  The 16 outputs of a thread are 64 (32) adjacent
// bytes, so the block passes them through shared memory and each store
// instruction writes a warp's 512 adjacent bytes: stored straight from the
// registers, a warp's stores land 64 bytes apart, and a layer's group ran
// at 42% of its bound against 93% so.  The scale needs no 64-bit
// division: rows with C % 16 == 0 have one scale per vector (a 32-bit row
// index); cols with C == 16 have one row per vector, the matrix's 16
// scales read as four 16-byte loads.  Any other bank (an odd C, a pointer
// that is not 16-byte aligned) takes the scalar path of the same kernel,
// 16 values a thread, 256 apart.

#define DEQ_THREADS 256
#define DEQ_VEC 16
#define DEQ_BLOCK_VALS (DEQ_THREADS * DEQ_VEC)
#define DEQ_MAX_BANKS 16

enum { DEQ_SCALAR = 0, DEQ_ROWS = 1, DEQ_COLS16 = 2 };

// one bank of the wrapper's table (adapter_quant.py::_DeqBank)
struct DeqBankArg {
  const int8_t* q;
  const float* scale;
  void* out;
  int64_t N;
  int R, C;
  int rows;  // 1: scale (N, R); 0: scale (N, C)
  int pad;
};

// one bank as the kernel sees it
struct DeqBank {
  const int8_t* q;
  const float* scale;
  void* out;
  int64_t total;   // N * R * C values
  int64_t block0;  // the bank's first block
  int R, C, rows, path;
};

struct DeqGroup {
  DeqBank bank[DEQ_MAX_BANKS];
  int n;
};

// 16 values as 16-byte words of the output type: four f32 or two bf16
__device__ __forceinline__ void out_words(const float (&o)[DEQ_VEC],
                                          uint4 (&w)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = make_uint4(__float_as_uint(o[4 * j]), __float_as_uint(o[4 * j + 1]),
                      __float_as_uint(o[4 * j + 2]),
                      __float_as_uint(o[4 * j + 3]));
}

__device__ __forceinline__ void out_words(const float (&o)[DEQ_VEC],
                                          uint4 (&w)[2]) {
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    p[j] = pack_bf16x2(__float2bfloat16_rn(o[2 * j]),
                       __float2bfloat16_rn(o[2 * j + 1]));
  w[0] = make_uint4(p[0], p[1], p[2], p[3]);
  w[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

// a vector path's 16 outputs of this thread, f32 before their rounding
__device__ __forceinline__ void deq_vector(const DeqBank& d, uint32_t v,
                                           float (&o)[DEQ_VEC]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(d.q) + v);
  float s[DEQ_VEC];
  if (d.path == DEQ_ROWS) {
    const float sv = __ldg(d.scale + v / (uint32_t)(d.C / DEQ_VEC));
#pragma unroll
    for (int i = 0; i < DEQ_VEC; ++i) s[i] = sv;
  } else {
    const float4* sp = reinterpret_cast<const float4*>(d.scale)
        + (size_t)(v / (uint32_t)d.R) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 t = __ldg(sp + j);
      s[4 * j] = t.x;
      s[4 * j + 1] = t.y;
      s[4 * j + 2] = t.z;
      s[4 * j + 3] = t.w;
    }
  }
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < DEQ_VEC; ++i)
    o[i] = __fmul_rn((float)(int8_t)(w[i >> 2] >> (8 * (i & 3))), s[i]);
}

template <typename T>
__global__ void __launch_bounds__(DEQ_THREADS) adapter_dequant_group_kernel(
    const __grid_constant__ DeqGroup g) {
  int b = 0;
  while (b + 1 < g.n && (int64_t)blockIdx.x >= g.bank[b + 1].block0) ++b;
  const DeqBank& d = g.bank[b];
  const int64_t blk = (int64_t)blockIdx.x - d.block0;
  T* out = static_cast<T*>(d.out);
  if (d.path != DEQ_SCALAR) {
    // W 16-byte words a thread; word j of thread t sits at t * W + (j + t)
    // % W, so a quarter warp's writes spread over the banks
    constexpr int W = sizeof(T);
    __shared__ uint4 tile[DEQ_THREADS * W];
    const uint32_t v = (uint32_t)blk * DEQ_THREADS + threadIdx.x;
    const int64_t nv = d.total / DEQ_VEC;
    if (v < nv) {
      float o[DEQ_VEC];
      uint4 words[W];
      deq_vector(d, v, o);
      out_words(o, words);
#pragma unroll
      for (int j = 0; j < W; ++j)
        tile[threadIdx.x * W + ((j + threadIdx.x) & (W - 1))] = words[j];
    }
    __syncthreads();
    const int64_t first = blk * DEQ_THREADS * W, n16 = nv * W;
    uint4* dst = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = k * DEQ_THREADS + threadIdx.x, t = i / W, j = i % W;
      if (first + i < n16) dst[first + i] = tile[t * W + ((j + t) & (W - 1))];
    }
    return;
  }
  const int64_t first = blk * DEQ_BLOCK_VALS + threadIdx.x;
  const int64_t RC = (int64_t)d.R * d.C;
#pragma unroll 4
  for (int k = 0; k < DEQ_VEC; ++k) {
    const int64_t e = first + k * DEQ_THREADS;
    if (e >= d.total) break;
    const int64_t si = d.rows ? e / d.C : (e / RC) * d.C + e % d.C;
    out[e] = from_f<T>(__fmul_rn((float)d.q[e], __ldg(d.scale + si)));
  }
}

extern "C" {

// banks: a host table of n_banks (1..DEQ_MAX_BANKS) banks, each
// q (N, R, C) int8 and scale (N, R) [rows] or (N, C) [cols] f32
//   -> out (N, R, C) f32 or bf16; one launch for all of them
int adapter_dequant_group_launch(const DeqBankArg* banks, int n_banks,
                                 int out_dtype, void* stream) {
  if (n_banks < 1 || n_banks > DEQ_MAX_BANKS)
    return (int)cudaErrorInvalidValue;
  DeqGroup g;
  g.n = n_banks;
  int64_t blocks = 0;
  for (int i = 0; i < n_banks; ++i) {
    const DeqBankArg& a = banks[i];
    DeqBank& d = g.bank[i];
    d.q = a.q;
    d.scale = a.scale;
    d.out = a.out;
    d.total = a.N * a.R * a.C;
    d.block0 = blocks;
    d.R = a.R;
    d.C = a.C;
    d.rows = a.rows;
    const bool vec = aligned16(a.q) && aligned16(a.out)
        && d.total / DEQ_VEC < (1LL << 31);
    d.path = !vec ? DEQ_SCALAR
        : (a.rows && a.C % DEQ_VEC == 0) ? DEQ_ROWS
        : (!a.rows && a.C == DEQ_VEC && aligned16(a.scale)) ? DEQ_COLS16
        : DEQ_SCALAR;
    blocks += (d.total + DEQ_BLOCK_VALS - 1) / DEQ_BLOCK_VALS;
  }
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == DT_BF16)
    adapter_dequant_group_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, DEQ_THREADS, 0, st>>>(g);
  else if (out_dtype == DT_F32)
    adapter_dequant_group_kernel<float>
        <<<(unsigned)blocks, DEQ_THREADS, 0, st>>>(g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// w (N, R, C) -> q (N, R, C) int8 and scale (N, R) [rows] or (N, C) [cols]
int adapter_quant_launch(const void* w, int w_dtype, void* q, float* scale,
                         int64_t N, int R, int C, int rows, float qmax,
                         void* stream) {
  if ((rows ? N * R : N * C) == 0) return (int)cudaSuccess;  // no scale
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* qi = static_cast<int8_t*>(q);
  if (w_dtype == DT_BF16)
    return (int)launch_quant<__nv_bfloat16>(w, w_dtype, qi, scale, N, R, C,
                                            rows, qmax, st);
  if (w_dtype == DT_F32)
    return (int)launch_quant<float>(w, w_dtype, qi, scale, N, R, C, rows,
                                    qmax, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
