// Decode attention (one query token per sequence, GQA) with an optional
// adapter "shrink" epilogue: the Hopper kernels behind
// repro_torch/kernels/flash_decode.py and the first pass of
// repro_torch/kernels/fused_decode.py.
//
// Replaces the TPU kernels kernels/flash_decode.py::flash_decode (body
// _decode_kernel) and the attention half plus the rank-r shrink of
// kernels/fused_decode.py::fused_decode_lora / fused_decode_jd.
//
// One block per (b, kv-head): it loads the G query rows of that head group
// (scaled by hd**-0.5), walks only the valid prefix kv_len[b] of the cache
// in tiles of TILE_S positions with an online softmax in f32, and keeps the
// (G, hd) accumulator in shared memory.  K/V rows are addressed through
// explicit batch and row strides, so a view of a larger cache (the fused
// decode step passes cache[layer, :, :bucket]) is read in place.
//
// Every mode runs the same kernel, so the attention output of the fused
// kernels is bit-identical with flash_decode's; the arithmetic is spelled
// with explicit _rn intrinsics so that no FMA contraction choice can make
// two launches differ.
//
// Paged addressing (replacing kernels/flash_decode.py::flash_decode_paged
// and fused_decode.py::fused_decode_lora_paged / fused_decode_jd_paged):
// with a non-null page table, K/V come from a pool of pages (P, page_t,
// Kv, hd) and row s of sequence b lives at
//   pool + page_table[b * n_blocks + s / page_t] * page_stride
//        + (s % page_t) * row_stride + kvh * hd,
// the page strides passed where the contiguous launch passes batch
// strides (the K and V pools have one shape and layout, so one offset
// serves both).  The page is looked up per row, not per TILE_S tile (a
// tile may span pages: page_t 16 in tests/test_kernels.py): at the start
// of each tile every row's offset is computed once into shared memory, in
// int64 (a pool of 20k pages of 128 x 8 x 128 passes 2^31 elements), so the
// inner loops add one offset per row as the contiguous mode does.  Only rows below kv_len[b] are read, so table entries past
// ceil(kv_len / page_t) are never touched; the TPU kernel fetches and masks
// them, with the same result.  The arithmetic is the contiguous kernel's,
// unchanged (one template, PAGED only picks the addresses), so a paged
// launch gives out, l, m and partial bit-identical to a contiguous launch
// on equal logical content.
//
// Epilogue modes:
//   MODE_NONE: write out (q's dtype) and the softmax stats l, m;
//   MODE_ROWS: raw LoRA.  t[j] = sum_c of[c] * A[ids[b], j, head cols c],
//              partial[b, kvh, j] = t[j] * a_scale[ids[b], j];
//   MODE_COLS: JD.  t[j] = sum_c of[c] * V[cid, head rows c, j],
//              partial[b, kvh, j] = t[j] * v_scale[cid, j],
//              with cid = cluster_of[ids[b]].
// `of` is the f32 normalised attention output, taken before the cast (as
// _finalized_attn on the TPU).  The TPU carries t across kv-heads in
// scratch because its grid runs in order; here blocks run in parallel, so
// each writes its head's partial and fused_expand.cu sums them in head
// order.  No atomics: results repeat bit for bit.
//
// Bound on an H100: memory.  Each block streams its K/V prefix once
// (2 * kv_len * hd * 2 bytes in bf16) and its slice of the adapter bank;
// the work per byte is ~2*G flops, far below the ~295 flops/byte at which
// the tensor cores would bind.  This first version reads K rows with one
// warp each and V rows coalesced across threads, with no async copies and
// only B * Kv blocks (64 at B=8, Kv=8, under half of the 132 SMs): a later
// PR splits the sequence across blocks (flash-decoding) and pipelines.

#include "common.cuh"

#define TILE_S 64
#define ATTN_THREADS 128
#define KMAX 8            // hd <= 32 * KMAX = 256

#define MODE_NONE 0
#define MODE_ROWS 1
#define MODE_COLS 2

#define NEG_INF (-1e30f)

template <typename T, typename TKV, bool PAGED>
__global__ void __launch_bounds__(ATTN_THREADS) decode_attn_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const int* __restrict__ kv_len, int H, int Kv,
    int hd, int S, int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss,
    float scale, T* __restrict__ out, float* __restrict__ l_out,
    float* __restrict__ m_out, int mode, const int* __restrict__ ids,
    const int* __restrict__ cluster_of, const void* __restrict__ bank,
    int bank_dtype, const float* __restrict__ bank_scale, int r,
    float* __restrict__ partial, const int* __restrict__ page_table,
    int n_blocks, int page_t) {
  const int b = blockIdx.x / Kv;
  const int kvh = blockIdx.x % Kv;
  const int G = H / Kv;
  const int GH = G * hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = ATTN_THREADS / 32;

  extern __shared__ int64_t smem_raw[];
  // paged: the element offset of each row of the current tile in the
  // pools (K and V share the table and the page layout)
  int64_t* row_s = smem_raw;           // (TILE_S) when PAGED
  float* smem = reinterpret_cast<float*>(smem_raw + (PAGED ? TILE_S : 0));
  float* q_s = smem;                   // (G, hd)
  float* acc_s = q_s + GH;             // (G, hd)
  float* p_s = acc_s + GH;             // (G, TILE_S)
  float* m_s = p_s + G * TILE_S;       // (G)
  float* l_s = m_s + G;                // (G)
  float* alpha_s = l_s + G;            // (G)
  float* red_s = alpha_s + G;          // (ATTN_THREADS)

  const T* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  // contiguous: row s at kb + s * k_ss; paged: at kb + row_s[s - s0]
  const TKV* kb = k + (PAGED ? 0 : (int64_t)b * k_sb) + (int64_t)kvh * hd;
  const TKV* vb = v + (PAGED ? 0 : (int64_t)b * v_sb) + (int64_t)kvh * hd;
  const int* pt_b = PAGED ? page_table + (int64_t)b * n_blocks : nullptr;
  int n_valid = kv_len[b];
  n_valid = n_valid < S ? n_valid : S;   // S = n_blocks * page_t when paged

  for (int i = tid; i < GH; i += ATTN_THREADS) {
    q_s[i] = __fmul_rn(to_f(qb[i]), scale);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += ATTN_THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < n_valid; s0 += TILE_S) {
    const int ns = min(TILE_S, n_valid - s0);
    if (PAGED) {
      for (int sr = tid; sr < ns; sr += ATTN_THREADS) {
        const int s = s0 + sr;
        row_s[sr] = (int64_t)pt_b[s / page_t] * k_sb +
                    (int64_t)(s % page_t) * k_ss;
      }
      __syncthreads();
    }
    // logits: one warp per key row, the row held in registers
    for (int sr = warp; sr < ns; sr += nwarps) {
      const int s = s0 + sr;
      const TKV* krow = PAGED ? kb + row_s[sr] : kb + (int64_t)s * k_ss;
      float kr[KMAX];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        const int d = lane + 32 * i;
        kr[i] = d < hd ? to_f(krow[d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) dot = __fmaf_rn(q_s[g * hd + d], kr[i], dot);
        }
        dot = warp_sum(dot);
        if (lane == 0) p_s[g * TILE_S + sr] = dot;
      }
    }
    __syncthreads();
    // online softmax: one warp per query row of the group
    for (int g = warp; g < G; g += nwarps) {
      float mx = NEG_INF;
      for (int sr = lane; sr < ns; sr += 32) mx = fmaxf(mx, p_s[g * TILE_S + sr]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int sr = lane; sr < ns; sr += 32) {
        const float p = expf(__fsub_rn(p_s[g * TILE_S + sr], m_new));
        p_s[g * TILE_S + sr] = p;
        sum = __fadd_rn(sum, p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        l_s[g] = __fmaf_rn(l_s[g], alpha, sum);
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V, V rows read coalesced across threads
    for (int i = tid; i < GH; i += ATTN_THREADS) {
      const int g = i / hd, d = i - g * hd;
      float a = __fmul_rn(acc_s[i], alpha_s[g]);
      const float* pg = p_s + g * TILE_S;
      if (PAGED) {
        const TKV* vcol = vb + d;
        for (int sr = 0; sr < ns; ++sr)
          a = __fmaf_rn(pg[sr], to_f(vcol[row_s[sr]]), a);
      } else {
        const TKV* vcol = vb + (int64_t)s0 * v_ss + d;
        for (int sr = 0; sr < ns; ++sr)
          a = __fmaf_rn(pg[sr], to_f(vcol[(int64_t)sr * v_ss]), a);
      }
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // normalise in place: acc_s now holds the f32 attention output `of`
  T* ob = out + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  for (int i = tid; i < GH; i += ATTN_THREADS) {
    const float o = __fdiv_rn(acc_s[i], fmaxf(l_s[i / hd], 1e-30f));
    acc_s[i] = o;
    ob[i] = from_f<T>(o);
  }
  if (l_out != nullptr) {
    for (int g = tid; g < G; g += ATTN_THREADS) {
      l_out[((int64_t)b * Kv + kvh) * G + g] = l_s[g];
      m_out[((int64_t)b * Kv + kvh) * G + g] = m_s[g];
    }
  }
  if (mode == MODE_NONE) return;
  __syncthreads();

  float* pb = partial + ((int64_t)b * Kv + kvh) * r;
  const int id = ids[b];
  if (mode == MODE_ROWS) {
    // A (n, r, H*hd): row j of adapter id, this head group's columns
    const int64_t ld = (int64_t)H * hd;
    const int64_t base = (int64_t)id * r * ld + (int64_t)kvh * GH;
    for (int j = warp; j < r; j += nwarps) {
      float dot = 0.f;
      for (int c = lane; c < GH; c += 32)
        dot = __fmaf_rn(acc_s[c], load_any(bank, base + j * ld + c, bank_dtype),
                        dot);
      dot = warp_sum(dot);
      if (lane == 0) pb[j] = __fmul_rn(dot, bank_scale[(int64_t)id * r + j]);
    }
  } else {
    // V (k, H*hd, r): this head group's rows of cluster cid; thread
    // (part, j) sums rows part, part + P, ... of column j
    const int cid = cluster_of[id];
    const int64_t base = ((int64_t)cid * H * hd + (int64_t)kvh * GH) * r;
    const int P = ATTN_THREADS / r;
    if (tid < P * r) {
      const int j = tid % r, part = tid / r;
      float dot = 0.f;
      for (int c = part; c < GH; c += P)
        dot = __fmaf_rn(acc_s[c], load_any(bank, base + (int64_t)c * r + j,
                                           bank_dtype), dot);
      red_s[tid] = dot;
    }
    __syncthreads();
    if (tid < r) {
      float dot = 0.f;
      for (int part = 0; part < P; ++part)
        dot = __fadd_rn(dot, red_s[part * r + tid]);
      pb[tid] = __fmul_rn(dot, bank_scale[(int64_t)cid * r + tid]);
    }
  }
}

static size_t attn_smem_bytes(int G, int hd, bool paged) {
  return sizeof(float) *
             (2 * (size_t)G * hd + (size_t)G * TILE_S + 3 * (size_t)G +
              ATTN_THREADS) +
         (paged ? sizeof(int64_t) * TILE_S : 0);
}

template <typename T, typename TKV>
static int launch(const void* q, const void* k, const void* v,
                  const int* kv_len, int B, int H, int Kv, int hd, int S,
                  int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss,
                  float scale, void* out, float* l_out, float* m_out,
                  int mode, const int* ids, const int* cluster_of,
                  const void* bank, int bank_dtype, const float* bank_scale,
                  int r, float* partial, const int* page_table, int n_blocks,
                  int page_t, cudaStream_t stream) {
  const int G = H / Kv;
  const bool paged = page_table != nullptr;
  const size_t smem = attn_smem_bytes(G, hd, paged);
  if (paged)
    decode_attn_kernel<T, TKV, true><<<B * Kv, ATTN_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), kv_len, H, Kv, hd, n_blocks * page_t,
        k_sb, k_ss, v_sb, v_ss, scale, static_cast<T*>(out), l_out, m_out,
        mode, ids, cluster_of, bank, bank_dtype, bank_scale, r, partial,
        page_table, n_blocks, page_t);
  else
    decode_attn_kernel<T, TKV, false><<<B * Kv, ATTN_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), kv_len, H, Kv, hd, S, k_sb, k_ss, v_sb,
        v_ss, scale, static_cast<T*>(out), l_out, m_out, mode, ids,
        cluster_of, bank, bank_dtype, bank_scale, r, partial, nullptr, 0, 1);
  return (int)cudaGetLastError();
}

#define ATTN_ARGS                                                          \
  q, k, v, kv_len, B, H, Kv, hd, S, k_sb, k_ss, v_sb, v_ss, scale, out,    \
      l_out, m_out, mode, ids, cluster_of, bank, bank_dtype, bank_scale, r, \
      partial, page_table, n_blocks, page_t, stream

// q/out in `dtype`, k/v in `kv_dtype` (f32 or bf16 each: an f32 model
// keeps the bf16 KV cache)
static int dispatch(int dtype, int kv_dtype, const void* q, const void* k,
                    const void* v, const int* kv_len, int B, int H, int Kv,
                    int hd, int S, int64_t k_sb, int64_t k_ss, int64_t v_sb,
                    int64_t v_ss, float scale, void* out, float* l_out,
                    float* m_out, int mode, const int* ids,
                    const int* cluster_of, const void* bank, int bank_dtype,
                    const float* bank_scale, int r, float* partial,
                    const int* page_table, int n_blocks, int page_t,
                    cudaStream_t stream) {
  if (dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(ATTN_ARGS);
  if (dtype == DT_F32 && kv_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(ATTN_ARGS);
  if (dtype == DT_BF16 && kv_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(ATTN_ARGS);
  if (dtype == DT_F32 && kv_dtype == DT_F32)
    return launch<float, float>(ATTN_ARGS);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Both entry points take an optional page table (B, n_blocks) int32: null
// for a contiguous cache k/v (B, S, Kv, hd) with batch strides k_sb/v_sb
// and row strides k_ss/v_ss; set for pools k/v (P, page_t, Kv, hd) of one
// layout, with page strides in k_sb == v_sb, row strides in k_ss == v_ss,
// and S ignored (n_blocks * page_t).

// flash_decode: out (B, H, hd) in q's dtype, l/m (B, Kv, G) f32
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, void* out, float* l_out,
                        float* m_out, int B, int H, int Kv, int hd, int S,
                        int64_t k_sb, int64_t k_ss, int64_t v_sb,
                        int64_t v_ss, float scale, int dtype, int kv_dtype,
                        const int* page_table, int n_blocks, int page_t,
                        void* stream) {
  if (page_table != nullptr &&
      (n_blocks <= 0 || page_t <= 0 || k_sb != v_sb || k_ss != v_ss))
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, kv_dtype, q, k, v, kv_len, B, H, Kv, hd, S, k_sb,
                  k_ss, v_sb, v_ss, scale, out, l_out, m_out, MODE_NONE,
                  nullptr, nullptr, nullptr, 0, nullptr, 0, nullptr,
                  page_table, n_blocks, page_t, (cudaStream_t)stream);
}

// attention + per-head shrink into partial (B, Kv, r) f32; cluster_of is
// null for raw LoRA (rows of A) and set for JD (columns of V)
int fused_attn_shrink_launch(const void* q, const void* k, const void* v,
                             const int* kv_len, const int* ids,
                             const int* cluster_of, const void* bank,
                             int bank_dtype, const float* bank_scale, int r,
                             void* out, float* partial, int B, int H, int Kv,
                             int hd, int S, int64_t k_sb, int64_t k_ss,
                             int64_t v_sb, int64_t v_ss, float scale,
                             int dtype, int kv_dtype, const int* page_table,
                             int n_blocks, int page_t, void* stream) {
  if (page_table != nullptr &&
      (n_blocks <= 0 || page_t <= 0 || k_sb != v_sb || k_ss != v_ss))
    return (int)cudaErrorInvalidValue;
  const int mode = cluster_of == nullptr ? MODE_ROWS : MODE_COLS;
  return dispatch(dtype, kv_dtype, q, k, v, kv_len, B, H, Kv, hd, S, k_sb,
                  k_ss, v_sb, v_ss, scale, out, nullptr, nullptr, mode, ids,
                  cluster_of, bank, bank_dtype, bank_scale, r, partial,
                  page_table, n_blocks, page_t, (cudaStream_t)stream);
}

}  // extern "C"
