// The compressed (JD) delta of a group of projections that read one input,
// one adapter per sequence, added into their outputs in place: the Hopper
// kernels behind repro_torch/kernels/jd_delta.py::jd_delta_.
//
// For each target t of the group (q/k/v together, or o alone) and each
// sequence b, with a = ids[b] and c = cluster_of_t[a]:
//
//   y_t[b] += scaling * ((x[b] V_t[c]) Sigma_t[a]) U_t[c]^T
//
// with Sigma_t[a] full (r, r) or diagonal (r,).  Rounded where the plain
// version (models/lora.py::apply, mode "jd") rounds: each rank-r stage is
// summed in f32 and rounded to bf16 (x's type), the bank values are first
// rounded to bf16 as the plain version's .to(x.dtype) does, the bf16 delta
// is multiplied by `scaling` in f32 and rounded to y's type (bf16), and the
// sum y + delta is taken in f32 and rounded once.
//
// It replaces no TPU kernel: the JAX package leaves the prefill and decode
// steps' adapter deltas to XLA's einsums.  For one adapter per sequence it
// fuses the composition of sgmv.cu's sigma_bmm and jd_apply.cu's
// jd_shrink_scale (rows 11, 12) with sgmv.cu's expand (row 10): no host
// grouping of tokens into tiles (whose copy of the ids costs a sync), no
// gather of a cluster's bases into a new tensor; each block reads its
// sequence's adapter id and cluster itself.
//
// Bound on an H100: memory.  x is read once, each y read and written once,
// the bases come from L2: at 1,020 tokens of Mistral-7B, about 34 MB for
// q/k/v (10 us at 3.35 TB/s) and 25 MB for o.  Two launches a group:
//
// * jd_delta_shrink_kernel<NT> (tensor cores): one cluster of JD_SPLIT (8)
//   blocks per 128 rows of one sequence, block s taking the s-th eighth of
//   d_in in 64-wide chunks through a ring of four stages that its 8 warps
//   fill together with 16-byte cp.async copies: the chunk's 128 x rows and
//   each target's chunk of V[c] (contiguous in V; an f32 bank is rounded to
//   bf16 as it is staged).  Warp w takes rows 32 (w % 4) .. + 31 and half
//   w / 4 of each chunk: per 16 of d_in, mma.sync.m16n8k16 for every
//   (target, m16 tile, n8 tile), each from a zero C and added with
//   __fadd_rn (as sgmv.cuh's shrink), so x crosses memory once for the
//   whole group and a V chunk serves 128 rows.  The block sums each row's
//   two halves in order; block s then sums rows 16s..16s+15 of the
//   cluster's eight partials in rank order through distributed shared
//   memory, rounds them to bf16, and applies Sigma_t[a] (rounded to bf16)
//   on the CUDA cores, an ascending __fmaf_rn sum, rounded to bf16 into
//   the (rows, NT, r) scratch the wrapper allocates (a few KB).  Tiles of
//   32 rows, each warp with its own ring, read a sequence's V from L2 once
//   per 32 rows (12 KB a row for q/k/v, more than x's 8 KB): 0.0203 ms
//   against this design's 0.0144 at 1,020 tokens of q/k/v (H100 80GB
//   HBM3, 700 W).
// * jd_delta_expand_kernel (tensor cores): one block per (128 output
//   channels of one target, 64 rows of one sequence), 4 warps of 16 rows.
//   The block copies its y tile, its t rows and U_t[c]'s 128 rows into
//   shared memory (cp.async, 16 bytes a lane), each warp issues JD_R / 16
//   mma per n8 tile and adds its delta into the staged y tile in place,
//   and the block writes the tile back as 16-byte stores: y is read and
//   written once, coalesced.
//
// x, y and every bank row are 16-byte aligned with widths that are
// multiples of 8 (the wrapper checks); ids and cluster_of are int32 or
// int64; an adapter or cluster index out of range traps, as the plain
// version's gather asserts on the card.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define JD_MAX_TARGETS 3
#define JD_R 16                    // the rank: one mma's K, two n8 tiles
#define JD_WARPS 8
#define JD_BM 128                  // rows of a shrink block: 4 warps' 32
#define JD_SPLIT 8                 // blocks of a shrink cluster
#define JD_TAIL_ROWS (JD_BM / JD_SPLIT)
#define JD_EXP_WARPS 4
#define JD_EXP_ROWS (16 * JD_EXP_WARPS)
#define JD_EXP_COLS 128
#define JD_EXP_LDY (JD_EXP_COLS + 8)

// one target of the wrapper's table (jd_delta.py::_Target)
struct JdTargetArg {
  void* y;                 // (B * S, d_out), bf16, updated in place
  const void* U;           // (k, d_out, r)
  const void* V;           // (k, d_in, r)
  const void* sigma;       // (n, r, r) full or (n, r) diagonal
  const void* cluster_of;  // (n,)
  int d_out, k;
  int uv_dtype;            // U and V: DT_F32 or DT_BF16
  int sigma_dtype;         // DT_F32 or DT_BF16
  int sigma_full;          // 1: (n, r, r); 0: (n, r)
  int cluster_i64;         // cluster_of int64 (1) or int32 (0)
};

struct JdGroup {
  JdTargetArg t[JD_MAX_TARGETS];
  int col_tile0[JD_MAX_TARGETS + 1];   // the expand's first tile of each
  const __nv_bfloat16* x;              // (B * S, d_in)
  const void* ids;                     // (B,)
  __nv_bfloat16* tbuf;                 // (B * S, nt, r)
  int nt, S, d_in, n, ids_i64;
  float scaling;
};

__device__ __forceinline__ int64_t load_index(const void* p, int64_t i,
                                              int i64) {
  return i64 ? static_cast<const int64_t*>(p)[i]
             : (int64_t) static_cast<const int32_t*>(p)[i];
}

// the adapter of sequence b and its cluster in target t's bank
__device__ __forceinline__ int64_t adapter_of(const JdGroup& g, int b) {
  const int64_t a = load_index(g.ids, b, g.ids_i64);
  if (a < 0 || a >= g.n) __trap();
  return a;
}

__device__ __forceinline__ int64_t cluster_in(const JdTargetArg& t,
                                              int64_t a) {
  const int64_t c = load_index(t.cluster_of, a, t.cluster_i64);
  if (c < 0 || c >= t.k) __trap();
  return c;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// eight f32 values at p (32-byte aligned) as eight bf16 in 16 bytes
__device__ __forceinline__ uint4 f32x8_to_bf16(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(
      pack_bf16x2(__float2bfloat16_rn(a.x), __float2bfloat16_rn(a.y)),
      pack_bf16x2(__float2bfloat16_rn(a.z), __float2bfloat16_rn(a.w)),
      pack_bf16x2(__float2bfloat16_rn(b.x), __float2bfloat16_rn(b.y)),
      pack_bf16x2(__float2bfloat16_rn(b.z), __float2bfloat16_rn(b.w)));
}

// 16 bytes of bf16 from a bank row of either type into shared memory:
// cp.async for bf16, a rounding copy for f32; zeros where !ok
__device__ __forceinline__ void stage8(__nv_bfloat16* dst, const void* bank,
                                       int64_t i, int dtype, bool ok) {
  if (dtype == DT_BF16) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(bank);
    cp_async16(dst, ok ? src + i : src, ok ? 16 : 0);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        ok ? f32x8_to_bf16(static_cast<const float*>(bank) + i)
           : make_uint4(0u, 0u, 0u, 0u);
  }
}

// -- shrink and Sigma ---------------------------------------------------------

// The block's ring: per stage, KC of d_in for its JD_BM x rows and for
// each target's V (rows of KC + 8 and JD_R + 8 bf16: an ldmatrix's 8 rows
// hit 8 bank groups); two blocks fit an SM
template <int NT>
struct JdRing {
  static constexpr int KC = 64;
  static constexpr int LD = KC + 8;
  static constexpr int WLD = JD_R + 8;
  static constexpr int X_BYTES = JD_BM * LD * 2;
  static constexpr int V_BYTES = KC * WLD * 2;
  static constexpr int STAGE_BYTES = X_BYTES + NT * V_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // after the loop: the warps' partials (the block's sum in place of warps
  // 0-3's), each target's Sigma as f32, the cluster's sum of its rows
  static constexpr int ROW = NT * JD_R;
  static constexpr int TAIL_BYTES =
      4 * (JD_WARPS * 32 * ROW + NT * JD_R * JD_R + JD_TAIL_ROWS * ROW);
  static constexpr int BYTES =
      RING_BYTES > TAIL_BYTES ? RING_BYTES : TAIL_BYTES;
  static_assert(2 * (BYTES + 1024) <= 233472, "two blocks an SM");
};

template <int NT>
__global__ void __cluster_dims__(JD_SPLIT, 1, 1)
    __launch_bounds__(JD_WARPS * 32, 2) jd_delta_shrink_kernel(
        const __grid_constant__ JdGroup g) {
  using R = JdRing<NT>;
  constexpr int KC = R::KC, LD = R::LD, WLD = R::WLD, ROW = R::ROW;
  constexpr int NP = JD_R / 16;                     // pairs of n8 tiles
  constexpr int XSEGS = KC / 8, VSEGS = JD_R / 8;   // 16-byte segments a row
  constexpr int RR = JD_R * JD_R;
  constexpr int THREADS = JD_WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, kh = warp / 4;   // 32 rows; half of each chunk

  const int b = blockIdx.y;
  const int s0 = blockIdx.x / JD_SPLIT * JD_BM;
  const int nrows = min(JD_BM, g.S - s0);
  const int64_t row0 = (int64_t)b * g.S + s0;
  const int d_in = g.d_in;
  const __nv_bfloat16* xb = g.x + row0 * d_in;
  // this block's eighth of d_in: chunks c0 .. c0 + my_chunks - 1
  const int n_chunks = (d_in + KC - 1) / KC;
  const int c0 = n_chunks * split / JD_SPLIT;
  const int my_chunks = n_chunks * (split + 1) / JD_SPLIT - c0;

  const int64_t a = adapter_of(g, b);
  int64_t vbase[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    vbase[t] = cluster_in(g.t[t], a) * d_in * JD_R;
  constexpr int SG_PER = (NT * RR + THREADS - 1) / THREADS;
  float sgr[SG_PER];
#pragma unroll
  for (int k = 0; k < SG_PER; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int t = e / RR, i = e % RR;
    sgr[k] = 0.f;
    if (t < NT) {
      const JdTargetArg& T = g.t[t];
      if (T.sigma_full)
        sgr[k] = round_bf16(load_any(T.sigma, a * RR + i, T.sigma_dtype));
      else if (i < JD_R)
        sgr[k] = round_bf16(load_any(T.sigma, a * JD_R + i, T.sigma_dtype));
    }
  }

  auto fetch = [&](int stage, int chunk) {
    unsigned char* base = smem + stage * R::STAGE_BYTES;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    const int k0 = chunk * KC;
    for (int i = threadIdx.x; i < JD_BM * XSEGS; i += THREADS) {
      const int row = i / XSEGS, k = k0 + (i % XSEGS) * 8;
      const bool ok = row < nrows && k < d_in;
      cp_async16(xs + row * LD + (i % XSEGS) * 8,
                 ok ? xb + (int64_t)row * d_in + k : xb, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < NT * KC * VSEGS; i += THREADS) {
      const int t = i / (KC * VSEGS), e = i % (KC * VSEGS);
      const int kk = e / VSEGS, c = (e % VSEGS) * 8;
      __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(
          base + R::X_BYTES + t * R::V_BYTES);
      stage8(vs + kk * WLD + c, g.t[t].V,
             vbase[t] + (int64_t)(k0 + kk) * JD_R + c, g.t[t].uv_dtype,
             k0 + kk < d_in);
    }
  };

  float acc[NT][2][2 * NP][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][m][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < my_chunks) fetch(s, c0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < my_chunks; ++i) {
    cp_async_wait<R::STAGES - 2>();       // chunk i has landed
    __syncthreads();                      // ... for every thread; stage
                                          // (i - 1) % STAGES is free
    const int nxt = i + R::STAGES - 1;
    if (nxt < my_chunks) fetch(nxt % R::STAGES, c0 + nxt);
    cp_async_commit();
    const unsigned char* base = smem + (i % R::STAGES) * R::STAGE_BYTES;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(base) + rg * 32 * LD;
#pragma unroll
    for (int kk = 0; kk < KC / 32; ++kk) {
      const int ks = kh * (KC / 32) + kk;   // this warp's 16 of the chunk
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldmatrix_x4(af[m], xs + (m * 16 + lane % 16) * LD + ks * 16
                               + (lane / 16) * 8);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(
            base + R::X_BYTES + t * R::V_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) {    // n8 tiles 2p and 2p + 1
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vs + (ks * 16 + lane % 8
                                      + (lane / 8) % 2 * 8) * WLD
                                    + p * 16 + (lane / 16) * 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            float d[4];
            mma_bf16_zero_c(d, af[m], bf[0], bf[1]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[t][m][2 * p][q] = __fadd_rn(acc[t][m][2 * p][q], d[q]);
            mma_bf16_zero_c(d, af[m], bf[2], bf[3]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[t][m][2 * p + 1][q] =
                  __fadd_rn(acc[t][m][2 * p + 1][q], d[q]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring is read

  // the warps' partials (row of the warp's 32, target, column), then each
  // target's Sigma, then the cluster's sum of this block's tail rows
  float* part = reinterpret_cast<float*>(smem);
  float* sg = part + JD_WARPS * 32 * ROW;
  float* tt = sg + NT * RR;
  const int gq = lane / 4, kq = (lane % 4) * 2;
  float* mine = part + warp * 32 * ROW;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* o = mine + (m * 16 + gq + 8 * h) * ROW + t * JD_R + j * 8 + kq;
          o[0] = acc[t][m][j][2 * h];
          o[1] = acc[t][m][j][2 * h + 1];
        }
#pragma unroll
  for (int k = 0; k < SG_PER; ++k) {
    const int e = threadIdx.x + k * THREADS;
    if (e < NT * RR) sg[e] = sgr[k];
  }
  __syncthreads();
  // the block's sum: a row's first half of each chunk, then its second
  // (warps 0-3 hold rows 0..JD_BM-1 in order; the sum goes in their place)
  for (int e = threadIdx.x; e < JD_BM * ROW; e += THREADS)
    part[e] = __fadd_rn(part[e], part[JD_BM * ROW + e]);
  cluster.sync();                         // every block's sum is written
  // this block's JD_TAIL_ROWS rows of x V: the cluster's blocks summed in
  // rank order through distributed shared memory, rounded to bf16
  const int tail0 = split * JD_TAIL_ROWS;
  for (int e = threadIdx.x; e < JD_TAIL_ROWS * ROW; e += THREADS) {
    const int o = tail0 * ROW + e;
    float s = cluster.map_shared_rank(part, 0)[o];
#pragma unroll
    for (int q = 1; q < JD_SPLIT; ++q)
      s = __fadd_rn(s, cluster.map_shared_rank(part, q)[o]);
    tt[e] = round_bf16(s);
  }
  cluster.sync();                         // no block leaves while read
  // times Sigma, rounded to bf16, into the scratch rows (row, t, q)
  for (int e = threadIdx.x; e < JD_TAIL_ROWS * ROW; e += THREADS) {
    const int row = tail0 + e / ROW, t = (e / JD_R) % NT, q = e % JD_R;
    if (row >= nrows) continue;
    const float* tr = tt + (e / ROW) * ROW + t * JD_R;
    const float* st = sg + t * RR;
    float v;
    if (g.t[t].sigma_full) {
      v = 0.f;
#pragma unroll
      for (int c = 0; c < JD_R; ++c) v = __fmaf_rn(tr[c], st[c * JD_R + q], v);
    } else {
      v = __fmul_rn(tr[q], st[q]);
    }
    g.tbuf[(row0 + row) * ROW + t * JD_R + q] = __float2bfloat16_rn(v);
  }
}

// -- expand and add -----------------------------------------------------------

__global__ void __launch_bounds__(JD_EXP_WARPS * 32) jd_delta_expand_kernel(
    const __grid_constant__ JdGroup g) {
  constexpr int LDK = JD_R + 8;       // 16-byte rows, no ldmatrix conflicts
  constexpr int KSEGS = JD_R / 8;
  constexpr int YSEGS = JD_EXP_COLS / 8;
  __shared__ __align__(16) __nv_bfloat16 ys[JD_EXP_ROWS * JD_EXP_LDY];
  __shared__ __align__(16) __nv_bfloat16 us[JD_EXP_COLS * LDK];
  __shared__ __align__(16) __nv_bfloat16 ts[JD_EXP_ROWS * LDK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int t = 0;
#pragma unroll
  for (int i = 1; i < JD_MAX_TARGETS; ++i)
    if (i < g.nt && (int)blockIdx.x >= g.col_tile0[i]) t = i;
  const JdTargetArg& T = g.t[t];
  const int d_out = T.d_out;
  const int o0 = ((int)blockIdx.x - g.col_tile0[t]) * JD_EXP_COLS;
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * JD_EXP_ROWS;
  const int nrows = min(JD_EXP_ROWS, g.S - s0);
  const int64_t row0 = (int64_t)b * g.S + s0;
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(T.y) + row0 * d_out + o0;

  // y and t first: neither waits for the adapter's cluster
  for (int i = threadIdx.x; i < JD_EXP_ROWS * YSEGS; i += JD_EXP_WARPS * 32) {
    const int row = i / YSEGS, c = (i % YSEGS) * 8;
    const bool ok = row < nrows && o0 + c < d_out;
    cp_async16(ys + row * JD_EXP_LDY + c,
               ok ? yb + (int64_t)row * d_out + c : yb, ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < JD_EXP_ROWS * KSEGS; i += JD_EXP_WARPS * 32) {
    const int row = i / KSEGS, c = (i % KSEGS) * 8;
    const bool ok = row < nrows;
    const __nv_bfloat16* src =
        g.tbuf + ((row0 + (ok ? row : 0)) * g.nt + t) * JD_R + c;
    cp_async16(ts + row * LDK + c, src, ok ? 16 : 0);
  }
  const int64_t ubase =
      (cluster_in(T, adapter_of(g, b)) * d_out + o0) * (int64_t)JD_R;
  for (int i = threadIdx.x; i < JD_EXP_COLS * KSEGS; i += JD_EXP_WARPS * 32) {
    const int o = i / KSEGS, c = (i % KSEGS) * 8;
    stage8(us + o * LDK + c, T.U, ubase + (int64_t)o * JD_R + c, T.uv_dtype,
           o0 + o < d_out);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (warp * 16 < nrows) {
    uint32_t af[JD_R / 16][4];
#pragma unroll
    for (int ks = 0; ks < JD_R / 16; ++ks)
      ldmatrix_x4(af[ks], ts + (warp * 16 + lane % 16) * LDK + ks * 16
                              + (lane / 16) * 8);
    const int gq = lane / 4, kq = (lane % 4) * 2;
    const float scaling = g.scaling;
#pragma unroll 2
    for (int p = 0; p < JD_EXP_COLS / 16; ++p) {   // n8 tiles 2p, 2p + 1
      float d[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[h][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < JD_R / 16; ++ks) {
        uint32_t bf[4];
        ldmatrix_x4(bf, us + (p * 16 + lane % 8 + (lane / 16) * 8) * LDK
                            + ks * 16 + (lane / 8) % 2 * 8);
        float e[4];
        mma_bf16_zero_c(e, af[ks], bf[0], bf[1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) d[0][q] = __fadd_rn(d[0][q], e[q]);
        mma_bf16_zero_c(e, af[ks], bf[2], bf[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) d[1][q] = __fadd_rn(d[1][q], e[q]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(
              ys + (warp * 16 + gq + 8 * half) * JD_EXP_LDY
              + (2 * p + h) * 8 + kq);
          const float2 yv = __bfloat1622float2(*yp);
          const float v0 = round_bf16(
              __fmul_rn(scaling, round_bf16(d[h][2 * half])));
          const float v1 = round_bf16(
              __fmul_rn(scaling, round_bf16(d[h][2 * half + 1])));
          *yp = __floats2bfloat162_rn(__fadd_rn(yv.x, v0),
                                      __fadd_rn(yv.y, v1));
        }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < JD_EXP_ROWS * YSEGS; i += JD_EXP_WARPS * 32) {
    const int row = i / YSEGS, c = (i % YSEGS) * 8;
    if (row < nrows && o0 + c < d_out)
      *reinterpret_cast<uint4*>(yb + (int64_t)row * d_out + c) =
          *reinterpret_cast<const uint4*>(ys + row * JD_EXP_LDY + c);
  }
}

template <int NT>
int jd_delta_run(const JdGroup& g, int B, cudaStream_t st) {
  auto shrink = jd_delta_shrink_kernel<NT>;
  constexpr int bytes = JdRing<NT>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      shrink, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  shrink<<<dim3((g.S + JD_BM - 1) / JD_BM * JD_SPLIT, B), JD_WARPS * 32,
           bytes, st>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  jd_delta_expand_kernel<<<dim3(g.col_tile0[NT],
                                    (g.S + JD_EXP_ROWS - 1) / JD_EXP_ROWS, B),
                               JD_EXP_WARPS * 32, 0, st>>>(g);
  return (int)cudaGetLastError();
}

extern "C" {

// x (B * S, d_in) bf16, ids (B,), the table's nt targets, tbuf (B * S, nt,
// r) bf16 scratch; each y_t (B * S, d_out_t) gains its delta in place
int jd_delta_launch(const JdTargetArg* table, int nt, const void* x,
                    const void* ids, int ids_i64, void* tbuf, int B, int S,
                    int d_in, int r, int n, float scaling, void* stream) {
  if (nt < 1 || nt > JD_MAX_TARGETS || r != JD_R || d_in % 8 ||
      B < 0 || S < 0 || n < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  JdGroup g;
  g.col_tile0[0] = 0;
  for (int i = 0; i < JD_MAX_TARGETS; ++i) {
    if (i < nt) {
      g.t[i] = table[i];
      const JdTargetArg& t = table[i];
      if (t.d_out < 1 || t.d_out % 8 || t.k < 1 ||
          (t.uv_dtype != DT_BF16 && t.uv_dtype != DT_F32) ||
          (t.sigma_dtype != DT_BF16 && t.sigma_dtype != DT_F32))
        return (int)cudaErrorInvalidValue;
      g.col_tile0[i + 1] =
          g.col_tile0[i] + (t.d_out + JD_EXP_COLS - 1) / JD_EXP_COLS;
    } else {
      g.t[i] = table[0];
      g.col_tile0[i + 1] = g.col_tile0[i];
    }
  }
  g.x = static_cast<const __nv_bfloat16*>(x);
  g.ids = ids;
  g.tbuf = static_cast<__nv_bfloat16*>(tbuf);
  g.nt = nt;
  g.S = S;
  g.d_in = d_in;
  g.n = n;
  g.ids_i64 = ids_i64;
  g.scaling = scaling;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (nt == 1) return jd_delta_run<1>(g, B, st);
  if (nt == 2) return jd_delta_run<2>(g, B, st);
  return jd_delta_run<3>(g, B, st);
}

}  // extern "C"
