// Decode attention (one query token per sequence, GQA) with an optional
// adapter epilogue, the o-projection's LoRA or JD delta: the Hopper
// kernels behind repro_torch/kernels/flash_decode.py and
// repro_torch/kernels/fused_decode.py.
//
// Replaces the TPU kernels kernels/flash_decode.py::flash_decode (body
// _decode_kernel) and flash_decode_paged, and kernels/fused_decode.py::
// fused_decode_lora / fused_decode_jd and their _paged variants.
//
// Split over the sequence (flash-decoding).  The valid prefix kv_len[b] of
// each (b, kv-head) is cut into chunks of SPLIT_S positions, chunk c
// covering [c * SPLIT_S, (c + 1) * SPLIT_S): the boundaries depend on the
// position alone, never on S, the bucket, the page size or the layout.  One
// block of ATTN_THREADS per (b, kv-head, chunk), in passes of GB query rows
// of the head group (one pass for G <= GB).  A block:
//
//   1. streams the chunk's K rows, then its V rows, through a ring of
//      NSTAGE tiles of TILE_S rows in shared memory, filled by 16-byte
//      cp.async copies (by element loads where a row or a pointer is not
//      16-byte aligned; the arithmetic reads shared memory either way);
//   2. takes the logits S = q K^T: with bf16 K/V and hd a multiple of 32 on
//      the tensor cores (mma.sync m16n8k16; the scaled f32 query split into
//      three exact bf16 pieces, so every product is exact in f32), warp w
//      taking rows w*8 .. w*8+7 of each tile; otherwise on the CUDA cores,
//      four lanes per key row summing their quarters of the row's 16-byte
//      chunks in ascending order, the four sums added in a fixed butterfly;
//   3. runs the softmax over the chunk in f32, one warp per query row:
//      m = max, p = exp(s - m), l = sum p.  All of the chunk's logits sit in
//      shared memory, so nothing is rescaled inside a chunk;
//   4. accumulates acc = p @ V: on the tensor cores (p split into three
//      bf16 pieces, V through ldmatrix.trans) warp w owns the 16-column
//      slices w, w + 4, ... of acc for all rows; on the CUDA cores warp w
//      takes rows w*8 .. w*8+7 of each tile for all (g, d), one 16-byte
//      chunk of a V row a lane, and the lane groups' and then the warps'
//      sums are added in fixed order.
//
// A launch whose cache holds one chunk (S <= SPLIT_S: every launch of the
// serving path's 128-token bucket) normalises in place,
// out = acc / max(l, 1e-30), writes out, l, m and runs the epilogue: one
// launch, as before the split.  Otherwise each block writes its chunk's
// (acc, l, m) to a workspace (a chunk that starts at or past kv_len[b]
// writes m = -1e30, l = 0, acc = 0 and reads no row), and
// decode_attn_merge_kernel, one block per (b, kv-head), merges the chunks
// in ascending order:
//   m = max_c m_c,  w_c = exp(m_c - m),  l = sum_c w_c l_c,
//   out = sum_c w_c acc_c / max(l, 1e-30),
// writes the global l, m and out, and runs the epilogue.  An empty chunk
// enters the sums as exact zeros and a lone chunk merges with w = 1, so
// the result does not depend on how many chunks a launch covers: a paged
// launch stays bit-identical with a contiguous one on equal logical
// content.  No atomics and no ordered grid: two launches give the same
// bits (every sum, the tensor cores' included, runs in a fixed order).
// The CUDA-core arithmetic is spelled with explicit _rn intrinsics so that
// no FMA contraction choice can make two launches differ, and every mode
// runs the same code, so the attention output of the fused kernels is
// bit-identical with flash_decode's.
//
// K/V rows are addressed through explicit batch and row strides, so a view
// of a larger cache (the fused decode step passes cache[layer, :, :bucket])
// is read in place.  Paged addressing: with a non-null page table, K/V
// come from a pool of pages (P, page_t, Kv, hd) and row s of sequence b
// lives at
//   pool + page_table[b * n_blocks + s / page_t] * page_stride
//        + (s % page_t) * row_stride + kvh * hd,
// the page strides passed where the contiguous launch passes batch
// strides (the K and V pools have one shape and layout, so one offset
// serves both).  Each row's offset is computed once per chunk into shared
// memory, in int64 (a pool of 20k pages of 128 x 8 x 128 passes 2^31
// elements), while kv_len[b] is in flight.  Only rows below kv_len[b] are
// read, so the pages of table entries past ceil(kv_len / page_t) are never
// touched (the entries may hold anything); the TPU kernel fetches and
// masks them, with the same result.  PAGED only picks the addresses.
//
// Epilogue modes (the fused kernels):
//   MODE_NONE: write out (q's dtype) and the softmax stats l, m;
//   MODE_ROWS: raw LoRA.  t[j] = sum_c of[c] * A[ids[b], j, head cols c],
//              partial[kvh, j] = t[j] * a_scale[ids[b], j], then
//              delta[b, o] = (sum_j T[j] * B[ids[b], o, j])
//                            * b_scale[ids[b], o];
//   MODE_COLS: JD.  t[j] = sum_c of[c] * V[cid, head rows c, j],
//              partial[kvh, j] = t[j] * v_scale[cid, j], then T is taken
//              through Sigma[ids[b]] (diag: T[j] * sigma[j]; full: sum_j
//              T[j] * Sigma[j, q]) and expanded through U[cid] and u_scale,
//              with cid = cluster_of[ids[b]];
// T[j] = sum over kv-heads h = 0 .. Kv-1, in that order, of partial[h, j].
// `of` is the f32 normalised attention output, taken before the cast (as
// _finalized_attn on the TPU).  The TPU carries t across kv-heads in
// scratch because its grid runs in order, and its last head's epilogue
// expands (_expand_out).  Here the Kv blocks of a sequence run in
// parallel, so a shrink mode launches them as one thread-block cluster of
// Kv blocks (Kv <= 16, the card's non-portable cluster limit): each block
// pushes its r partials into slot kvh of every block's shared memory
// (distributed shared memory), and every block sums the Kv slots in head
// order (every block gets the same T, bit for bit), applies Sigma, and
// expands its own 1/Kv of the d_out channels, thread t taking channels
// t, t + 128, ... (coalesced writes of delta).  No atomics: one launch per
// fused call where the cache is one chunk, two where it is split (the
// chunks, then the merge, whose blocks form the clusters).  MODE_NONE
// kernels launch without a cluster and run none of this code.
//
// The shrink's bank slice with its scales, this block's expand rows of B
// or U with their scales, and Sigma[ids[b]] are copied to shared memory
// by bulk copies (the copy engine; one thread issues them) as the block
// starts, so that their latency hides behind the attention; each group
// completes on its own transaction barrier, so the shrink waits only for
// its slice and the expand for its rows.  They are read 16 bytes at a
// time where alignment and r allow (element loads from device memory
// otherwise, or where they do not fit).  The exchange pushes each partial
// into every block's shared memory with st.async, counted on a third
// barrier of the receiving block: no block reads another's memory, so no
// block has to wait for the others before it leaves.
//
// Bound on an H100: memory.  The valid K/V rows are read once (2 * kv_len
// * hd * 2 bytes per (b, kv-head) in bf16) with ~2*G flops per byte, far
// below the ~295 flops/byte at which the tensor cores would bind.  So the
// design is about keeping bytes in flight and the arithmetic out of their
// way: at B 8, Kv 8 and kv_len ~1500 the chunk grid gives ~400 busy blocks
// (the unsplit kernel had 64, under half of the 132 SMs), each keeping
// NSTAGE - 1 tiles of copies outstanding, and on the tensor cores a
// 32-row tile costs a warp some 60 instructions of arithmetic, counted
// from the code, where the CUDA-core path takes some 400.  The adapter's
// bytes (d_out * r per slot for the expand) are a few hundred KB a layer:
// at the serving shape a fused call is latency, which the single launch
// and the staged slices address.

#include <mutex>
#include <utility>
#include <vector>

#include "common.cuh"

#define SPLIT_S 256          // positions per chunk (flash_decode.SPLIT_S)
#define ATTN_THREADS 128
#define ATTN_WARPS (ATTN_THREADS / 32)
#define TILE_S (8 * ATTN_WARPS)   // rows per staged tile: 8 per warp
#define NSTAGE 5             // tiles in the ring
#define GB 4                 // query rows of the head group per pass
#define KMAX 8               // hd <= 32 * KMAX = 256
#define RED_FLOATS (ATTN_WARPS * 128)   // the epilogue's buffer, r <= 128
#define SLICE_MAX (32 * 1024)  // a bank slice staged for the shrink, at most
#define MAX_SMEM_BLOCK (227 * 1024)   // an H100 block's shared memory
#define ACC_MAX (64 * 1024)    // the merge's staged chunk partials, at most
#define EXPAND_MAX (48 * 1024) // staged expand rows (or Sigma), at most
#define KV_MAX 16              // blocks in a cluster (non-portable limit)
#define STAGER (ATTN_THREADS - 32)  // the thread that sets up the barriers
                                    // and issues the bulk copies: the last
                                    // warp's, so that warp 0 (the merge's
                                    // per-row work) never waits on ids

#define MODE_NONE 0
#define MODE_ROWS 1
#define MODE_COLS 2

#define NEG_INF (-1e30f)
#define FULL_MASK 0xffffffffu

// Rows go through the tensor cores where K/V are bf16 and hd a multiple of
// 32 (flash_decode.uses_mma), through the CUDA cores otherwise.
static __host__ __device__ __forceinline__ bool uses_mma(int hd, int es) {
  return es == 2 && hd % 32 == 0;
}

// Bytes between two K/V rows in the ring: the row's 16-byte chunks, padded
// so that the rows an instruction reads together fall on disjoint banks:
// rs % 128 == 16 for ldmatrix (8 rows of 16 bytes), rs % 128 == 64 for
// the CUDA-core logits (two rows of 64 bytes a quarter-warp).
static __host__ __device__ __forceinline__ int attn_row_stride(int hd,
                                                              int es) {
  int rs = (hd * es + 15) / 16 * 16;
  if (uses_mma(hd, es)) return rs + (144 - rs % 128) % 128;
  if (rs > 64) rs += (192 - rs % 128) % 128;
  return rs;
}

// Bytes of the pass's query rows: their A fragments as three bf16 pieces
// (tensor cores), or GB rows of hdp floats
static __host__ __device__ __forceinline__ int attn_q_bytes(int hd, int es) {
  const int hdp = (hd * es + 15) / 16 * 16 / es;
  return uses_mma(hd, es) ? 3 * (hd / 16) * 16 * 8 : 4 * GB * hdp;
}

// Bytes of the chunk's p as A fragments (tensor cores only)
static __host__ __device__ __forceinline__ int attn_p_bytes(int hd, int es) {
  return uses_mma(hd, es) ? (SPLIT_S / 16) * 3 * 16 * 8 : 0;
}

// Shared memory of decode_attn_kernel (flash_decode.attn_smem_bytes):
// the ring, the chunk's logits (GB, SPLIT_S), the pass's query rows, the
// chunk's p fragments, the paged row offsets, m and l, the epilogue's
// buffer and the normalised output (G, hd).
static size_t attn_smem_bytes(int G, int hd, int es, bool paged) {
  return (size_t)NSTAGE * TILE_S * attn_row_stride(hd, es) +
         attn_q_bytes(hd, es) + attn_p_bytes(hd, es) +
         sizeof(float) * ((size_t)GB * SPLIT_S + 2 * GB + RED_FLOATS +
                          (size_t)G * hd) +
         (paged ? sizeof(int64_t) * SPLIT_S : 0);
}

// Shared memory of decode_attn_merge_kernel (flash_decode.merge_smem_bytes):
// m, l, the epilogue's buffer, the output and the weights (G, nc)
static size_t merge_smem_bytes(int G, int hd, int nc) {
  return sizeof(float) *
         (2 * (size_t)G + RED_FLOATS + (size_t)G * hd + (size_t)G * nc);
}

struct Epilogue {
  int mode;
  const int* ids;
  const int* cluster_of;
  const void* bank;          // the shrink: A (MODE_ROWS) or V (MODE_COLS)
  int bank_dtype;
  const float* bank_scale;
  int r;
  const void* sigma;         // JD: (n, r) or (n, r, r), f32 or bf16
  int sigma_dtype, sigma_full;
  const void* w;             // the expand: B (MODE_ROWS) or U (MODE_COLS)
  int w_dtype;
  const float* w_scale;
  int d_out;
  float* delta;              // (B, d_out) f32
  int w_stage, sig_stage;    // bytes staged in shared memory (0: none);
                             // set by the launch (fused_smem)
};

static __host__ __device__ __forceinline__ int elem_bytes(int dtype) {
  return dtype == DT_F32 ? 4 : dtype == DT_BF16 ? 2 : 1;
}

// The expand's output channels a block takes: ceil(d_out / Kv)
static __host__ __device__ __forceinline__ int expand_cols(const Epilogue& e,
                                                           int Kv) {
  return (e.d_out + Kv - 1) / Kv;
}

// Whether the expand reads its rows of W 16 bytes at a time
static __host__ __device__ __forceinline__ bool expand16(const Epilogue& e) {
  return (e.r * elem_bytes(e.w_dtype)) % 16 == 0 && aligned16(e.w);
}

// Whether a block's expand scales (and the shrink's r scales) start and
// end on 16 bytes, as a bulk copy needs
static __host__ __device__ __forceinline__ bool scale16(const Epilogue& e,
                                                        int Kv) {
  return e.d_out % 4 == 0 && expand_cols(e, Kv) % 4 == 0 &&
         aligned16(e.w_scale);
}

static __host__ __device__ __forceinline__ bool bsc16(const Epilogue& e) {
  return e.r % 4 == 0 && aligned16(e.bank_scale);
}

// Bytes of the expand's staged scales, after its staged rows
static __host__ __device__ __forceinline__ int scale_stage_bytes(
    const Epilogue& e, int Kv) {
  return scale16(e, Kv) ? 4 * expand_cols(e, Kv) : 0;
}

static __host__ __device__ __forceinline__ int sigma_elems(const Epilogue& e) {
  return e.sigma_full ? e.r * e.r : e.r;
}

// Whether the shrink can read its bank slice 16 bytes at a time
static __host__ __device__ __forceinline__ bool shrink16(const Epilogue& e,
                                                         int H, int Kv,
                                                         int hd) {
  const int EB = 16 / elem_bytes(e.bank_dtype), GH = H / Kv * hd;
  if (!aligned16(e.bank)) return false;
  if (e.mode == MODE_ROWS) return ((int64_t)H * hd) % EB == 0 && GH % EB == 0;
  return e.r % EB == 0 && 32 % (e.r / EB) == 0;
}

// The bank slice's bytes where the shrink stages it in shared memory
// (16-byte reads, at most SLICE_MAX bytes), else 0
static __host__ __device__ __forceinline__ int slice_bytes(const Epilogue& e,
                                                           int H, int Kv,
                                                           int hd) {
  if (e.mode == MODE_NONE || !shrink16(e, H, Kv, hd)) return 0;
  const int64_t bytes =
      (int64_t)(H / Kv) * hd * e.r * elem_bytes(e.bank_dtype);
  return bytes <= SLICE_MAX ? (int)bytes : 0;
}

// W's element count in 16 bytes, and 16 bytes of W as f32
template <typename W>
struct Chunk {
  static constexpr int N = 16 / sizeof(W);
};

static __device__ __forceinline__ void unpack_w(const float* p,
                                                float (&f)[4]) {
  unpack16(p, f);
}
static __device__ __forceinline__ void unpack_w(const __nv_bfloat16* p,
                                                float (&f)[8]) {
  unpack16(p, f);
}
static __device__ __forceinline__ void unpack_w(const int8_t* p,
                                                float (&f)[16]) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = (float)(int8_t)(w[i] >> (8 * b));
}

// MODE_ROWS from 16-byte loads: warp w takes rows j0 .. j0+JB-1 of A[id]
// at once (their loads in flight together); lane l sums chunks l, l + 32,
// ... of each row against of_s, in ascending order, then a warp_sum
#define JB 4
template <typename W>
static __device__ __forceinline__ void shrink_rows16(
    const Epilogue& e, const float* of_s, float* pb, const float* bsc,
    const W* bank, int64_t ld, int GH) {
  constexpr int EB = Chunk<W>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nck = GH / EB;
  for (int j0 = warp * JB; j0 < e.r; j0 += ATTN_WARPS * JB) {
    float dot[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) dot[jj] = 0.f;
    for (int ch = lane; ch < nck; ch += 32) {
      const float* o = of_s + ch * EB;
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        if (j0 + jj < e.r) {
          float w[EB];
          unpack_w(bank + (j0 + jj) * ld + ch * EB, w);
#pragma unroll
          for (int x = 0; x < EB; ++x) dot[jj] = __fmaf_rn(o[x], w[x], dot[jj]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const float d = warp_sum(dot[jj]);
      if (lane == 0 && j0 + jj < e.r)
        pb[j0 + jj] = __fmul_rn(d, bsc[j0 + jj]);
    }
  }
}

// MODE_COLS from 16-byte loads: the slice of V[cid] is GH rows of r
// columns, cpr = r / EB chunks a row; thread t takes chunks t, t + 128, ...
// (one row each, always columns (t % cpr) * EB ..), sums them in ascending
// order, then the lanes of one column block in a butterfly and the warps
// in warp order
template <typename W>
static __device__ __forceinline__ void shrink_cols16(
    const Epilogue& e, const float* of_s, float* red_s, float* pb,
    const float* bsc, const W* bank, int GH) {
  constexpr int EB = Chunk<W>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = e.r, cpr = r / EB;
  float acc[EB];
#pragma unroll
  for (int x = 0; x < EB; ++x) acc[x] = 0.f;
#pragma unroll 4
  for (int ch = tid; ch < GH * cpr; ch += ATTN_THREADS) {
    const float o = of_s[ch / cpr];
    float w[EB];
    unpack_w(bank + (int64_t)ch * EB, w);
#pragma unroll
    for (int x = 0; x < EB; ++x) acc[x] = __fmaf_rn(o, w[x], acc[x]);
  }
  for (int off = cpr; off < 32; off <<= 1)
#pragma unroll
    for (int x = 0; x < EB; ++x)
      acc[x] = __fadd_rn(acc[x], __shfl_xor_sync(FULL_MASK, acc[x], off));
  if (lane < cpr) {
#pragma unroll
    for (int x = 0; x < EB; ++x) red_s[warp * r + lane * EB + x] = acc[x];
  }
  __syncthreads();
  if (tid < r) {
    float d = red_s[tid];
    for (int w = 1; w < ATTN_WARPS; ++w) d = __fadd_rn(d, red_s[w * r + tid]);
    pb[tid] = __fmul_rn(d, bsc[tid]);
  }
}

// The shrink for bank element type W; `slice` the bank slice staged in
// shared memory by stage_epilogue, or null; bsc the r scales of the bank
// row
template <typename W>
static __device__ __forceinline__ void shrink_typed(
    const Epilogue& e, const float* of_s, float* red_s, int b, int kvh,
    int H, int Kv, int hd, const unsigned char* slice, float* pb,
    const float* bsc) {
  const int GH = H / Kv * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = e.r;
  const int id = e.ids[b];
  const W* bank = static_cast<const W*>(e.bank);
  if (e.mode == MODE_ROWS) {
    // A (n, r, H*hd): row j of adapter id, this head group's columns
    const int64_t ld = (int64_t)H * hd;
    const int64_t base = (int64_t)id * r * ld + (int64_t)kvh * GH;
    if (slice != nullptr)
      return shrink_rows16<W>(e, of_s, pb, bsc,
                              reinterpret_cast<const W*>(slice), GH, GH);
    if (shrink16(e, H, Kv, hd))
      return shrink_rows16<W>(e, of_s, pb, bsc, bank + base, ld, GH);
    for (int j = warp; j < r; j += ATTN_WARPS) {
      float dot = 0.f;
      for (int c = lane; c < GH; c += 32)
        dot = __fmaf_rn(of_s[c], to_f(bank[base + j * ld + c]), dot);
      dot = warp_sum(dot);
      if (lane == 0) pb[j] = __fmul_rn(dot, bsc[j]);
    }
  } else {
    // V (k, H*hd, r): this head group's rows of cluster cid
    const int cid = e.cluster_of[id];
    const int64_t base = ((int64_t)cid * H * hd + (int64_t)kvh * GH) * r;
    if (slice != nullptr)
      return shrink_cols16<W>(e, of_s, red_s, pb, bsc,
                              reinterpret_cast<const W*>(slice), GH);
    if (shrink16(e, H, Kv, hd))
      return shrink_cols16<W>(e, of_s, red_s, pb, bsc, bank + base, GH);
    // thread (part, j) sums rows part, part + P, ... of column j
    const int P = ATTN_THREADS / r;
    if (tid < P * r) {
      const int j = tid % r, part = tid / r;
      float dot = 0.f;
      for (int c = part; c < GH; c += P)
        dot = __fmaf_rn(of_s[c], to_f(bank[base + (int64_t)c * r + j]),
                        dot);
      red_s[tid] = dot;
    }
    __syncthreads();
    if (tid < r) {
      float dot = 0.f;
      for (int part = 0; part < P; ++part)
        dot = __fadd_rn(dot, red_s[part * r + tid]);
      pb[tid] = __fmul_rn(dot, bsc[tid]);
    }
  }
}

// The rank-r shrink of one (b, kv-head)'s normalised f32 output of_s
// (G, hd) in shared memory, into pb (r floats of this block's shared
// memory), with the bank row's r scales bsc; every thread of the block
// calls it.  16-byte reads of the bank slice wherever its alignment and r
// allow (from shared memory where stage_epilogue copied it at the block's
// start: the shrink is latency), element loads otherwise.
static __device__ __forceinline__ void shrink_epilogue(
    const Epilogue& e, const float* of_s, float* red_s, int b, int kvh,
    int H, int Kv, int hd, const unsigned char* slice, float* pb,
    const float* bsc) {
  if (e.bank_dtype == DT_BF16)
    shrink_typed<__nv_bfloat16>(e, of_s, red_s, b, kvh, H, Kv, hd, slice,
                                pb, bsc);
  else if (e.bank_dtype == DT_I8)
    shrink_typed<int8_t>(e, of_s, red_s, b, kvh, H, Kv, hd, slice, pb, bsc);
  else
    shrink_typed<float>(e, of_s, red_s, b, kvh, H, Kv, hd, slice, pb, bsc);
}

// -- the fused epilogue: a cluster over a sequence's kv-heads ---------------

// Cluster barrier halves (PTX defaults: arrive releases, wait acquires,
// shared memory included; every thread of every block of the cluster
// takes part)
static __device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

static __device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// p's counterpart in the shared memory of block `rank` of this cluster
// (distributed shared memory), as a shared::cluster address
static __device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                        int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// A transaction barrier in shared memory, used for one phase: one arrival
// (this block's, with the bytes it expects) plus the bytes that bulk and
// st.async copies complete
static __device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_expect(uint64_t* bar,
                                                   int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ bool mbar_try(uint64_t* bar) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar))
      : "memory");
  return done != 0;
}

// Wait for the barrier's phase; a copy that never lands traps (the launch
// fails with an error) instead of hanging the card
static __device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  for (int n = 0; !mbar_try(bar); ++n)
    if (n == (1 << 22)) __trap();
}

// 4 bytes into another block's shared memory, completing 4 bytes of its
// barrier (both shared::cluster addresses)
static __device__ __forceinline__ void st_async(uint32_t dst, float v,
                                                uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from device memory to this block's shared
// memory by the copy engine (a bulk copy; both 16-byte aligned), counted
// on the barrier bar
static __device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                                 int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// The fused epilogue's own shared memory: three barriers (the shrink's
// staged operands, the expand's, the exchange), t (this block's partial),
// x (T, the head-order sum), u (T through Sigma), bsc (the shrink's r
// scales, staged where bsc16) and recv (Kv x r: the cluster's partials,
// pushed by their blocks)
static __host__ __device__ __forceinline__ int xch_bytes(const Epilogue& e,
                                                         int Kv) {
  return 32 + 4 * 4 * ATTN_THREADS + (4 * Kv * e.r + 15) / 16 * 16;
}

// That memory from a 16-byte aligned base, then what the launch staged
// (fused_smem's layout)
struct FusedSmem {
  uint64_t *sbar, *wbar, *xbar;
  float *t, *x, *u, *bsc, *recv;
  unsigned char* slice;      // the shrink's bank slice (sbytes)
  unsigned char* w;          // this block's expand rows (e.w_stage)
  float* sc;                 // their scales
  unsigned char* sig;        // Sigma[ids[b]] (e.sig_stage)
};

static __device__ __forceinline__ FusedSmem carve(const void* after,
                                                  const Epilogue& e,
                                                  int sbytes, int Kv) {
  unsigned char* p = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(after) + 15) & ~uintptr_t(15));
  FusedSmem f;
  f.sbar = reinterpret_cast<uint64_t*>(p);
  f.wbar = f.sbar + 1;
  f.xbar = f.sbar + 2;
  f.t = reinterpret_cast<float*>(p + 32);
  f.x = f.t + ATTN_THREADS;
  f.u = f.x + ATTN_THREADS;
  f.bsc = f.u + ATTN_THREADS;
  f.recv = f.bsc + ATTN_THREADS;
  f.slice = p + xch_bytes(e, Kv);
  f.w = f.slice + sbytes;
  f.sc = reinterpret_cast<float*>(f.w + e.w_stage);
  f.sig = f.w + e.w_stage + (e.w_stage > 0 ? scale_stage_bytes(e, Kv) : 0);
  return f;
}

// Where the epilogue's operands lie in device memory: the shrink's bank
// slice (A[id]'s rows at this head group's columns, or V[cid]'s rows of
// this head group) and r scales, this block's expand rows o0 .. o0+n-1 of
// W[w_idx] (n = 0 for a block past d_out), their scales, and Sigma[id].
// Called as the block starts: ids (and cluster_of) are in flight while
// the block goes on.
struct EpiSrc {
  const unsigned char* slice;
  const float* bsc;
  const unsigned char* w;
  const float* sc;
  const unsigned char* sig;
  int o0, n;
};

static __device__ __forceinline__ EpiSrc epi_src(const Epilogue& e, int b,
                                                 int kvh, int H, int Kv,
                                                 int hd) {
  const int id = e.ids[b];
  const int w_idx = e.mode == MODE_ROWS ? id : e.cluster_of[id];
  const int C = expand_cols(e, Kv);
  const int64_t GH = (int64_t)(H / Kv) * hd;
  EpiSrc s;
  s.slice = static_cast<const unsigned char*>(e.bank) +
            ((int64_t)w_idx * e.r * H * hd +
             kvh * GH * (e.mode == MODE_ROWS ? 1 : e.r)) *
                elem_bytes(e.bank_dtype);
  s.o0 = min(e.d_out, kvh * C);
  s.n = min(e.d_out, s.o0 + C) - s.o0;
  const int64_t row = (int64_t)w_idx * e.d_out + s.o0;
  s.w = static_cast<const unsigned char*>(e.w) +
        row * e.r * elem_bytes(e.w_dtype);
  s.sc = e.w_scale + row;
  s.bsc = e.bank_scale + (int64_t)w_idx * e.r;   // A's or V's row of scales
  s.sig = e.sigma == nullptr
              ? nullptr
              : static_cast<const unsigned char*>(e.sigma) +
                    (int64_t)id * sigma_elems(e) * elem_bytes(e.sigma_dtype);
  return s;
}

// Start the bulk copies of what the launch staged, by STAGER: the
// shrink's bank slice (sbytes; MODE_ROWS r rows of GH columns, MODE_COLS
// GH rows of r columns) and scales on f.sbar, this block's expand rows,
// their scales and Sigma[id] on f.wbar
static __device__ __forceinline__ void stage_epilogue(const Epilogue& e,
                                                      const EpiSrc& s,
                                                      const FusedSmem& f,
                                                      int H, int Kv, int hd,
                                                      int sbytes) {
  const bool bsc = bsc16(e);
  mbar_expect(f.sbar, sbytes + (bsc ? 4 * e.r : 0));
  const int wrows = e.w_stage > 0 ? s.n * e.r * elem_bytes(e.w_dtype) : 0;
  const bool sc = wrows > 0 && scale16(e, Kv);
  mbar_expect(f.wbar, wrows + (sc ? 4 * s.n : 0) + e.sig_stage);
  if (sbytes > 0 && e.mode == MODE_ROWS) {
    const int row = sbytes / e.r;
    const int64_t ld = (int64_t)H * hd * elem_bytes(e.bank_dtype);
    for (int j = 0; j < e.r; ++j)
      bulk_copy(f.slice + j * row, s.slice + j * ld, row, f.sbar);
  } else if (sbytes > 0) {
    bulk_copy(f.slice, s.slice, sbytes, f.sbar);
  }
  if (bsc) bulk_copy(f.bsc, s.bsc, 4 * e.r, f.sbar);
  if (wrows > 0) bulk_copy(f.w, s.w, wrows, f.wbar);
  if (sc) bulk_copy(f.sc, s.sc, 4 * s.n, f.wbar);
  if (e.sig_stage > 0) bulk_copy(f.sig, s.sig, e.sig_stage, f.wbar);
}

// delta[b, o0 + i] = (sum_j t[j] * W[w_idx, o0 + i, j]) * w_scale[.., o0 + i]
// for this block's channels, thread t taking i = t, t + 128, ...: XCH of
// them at once, as independent sums that share each read of t; each sum
// in ascending j, from shared memory where staged (16 bytes at a time
// where expand16) or device memory
#define XCH 4
template <typename W>
static __device__ __forceinline__ void expand_typed(const Epilogue& e,
                                                    const float* t,
                                                    const EpiSrc& s,
                                                    const FusedSmem& f,
                                                    int b, int Kv) {
  const int r = e.r;
  const bool staged = e.w_stage > 0;
  const W* w = reinterpret_cast<const W*>(staged ? f.w : s.w);
  const float* sc = staged && scale16(e, Kv) ? f.sc : s.sc;
  float* out = e.delta + (int64_t)b * e.d_out + s.o0;
  const bool v16 = expand16(e);
  for (int i0 = threadIdx.x; i0 < s.n; i0 += XCH * ATTN_THREADS) {
    float acc[XCH];
#pragma unroll
    for (int q = 0; q < XCH; ++q) acc[q] = 0.f;
    if (v16) {
      constexpr int EB = Chunk<W>::N;
      for (int c = 0; c < r; c += EB) {
        float tc[EB];
#pragma unroll
        for (int k = 0; k < EB; ++k) tc[k] = t[c + k];
#pragma unroll
        for (int q = 0; q < XCH; ++q) {
          const int i = i0 + q * ATTN_THREADS;
          if (i < s.n) {
            float x[EB];
            unpack_w(w + (int64_t)i * r + c, x);
#pragma unroll
            for (int k = 0; k < EB; ++k)
              acc[q] = __fmaf_rn(tc[k], x[k], acc[q]);
          }
        }
      }
    } else {
      for (int j = 0; j < r; ++j) {
        const float tj = t[j];
#pragma unroll
        for (int q = 0; q < XCH; ++q) {
          const int i = i0 + q * ATTN_THREADS;
          if (i < s.n)
            acc[q] = __fmaf_rn(tj, to_f(w[(int64_t)i * r + j]), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < XCH; ++q) {
      const int i = i0 + q * ATTN_THREADS;
      if (i < s.n) out[i] = __fmul_rn(acc[q], sc[i]);
    }
  }
}

// A shrink block's first step: its barriers set up, and its arrival at
// the cluster barrier whose wait (fused_epilogue) makes sure that every
// block's exchange barrier is set up before any block pushes to it
static __device__ __forceinline__ void cluster_start(const FusedSmem& f) {
  if (threadIdx.x == STAGER) {
    mbar_init(f.sbar);
    mbar_init(f.wbar);
    mbar_init(f.xbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();
}

// The shrink, then the rest of the epilogue: this block's partial pushed
// to every block of the cluster (slot kvh of their recv), the Kv partials
// received summed in head order, Sigma (JD), and this block's share of the
// expand.  Every thread of every block of the cluster calls it, with of_s
// complete.  A block leaves only once all Kv pushes into it have landed,
// so no push reaches a block that has gone.
static __device__ __forceinline__ void fused_epilogue(
    const Epilogue& e, const FusedSmem& f, const EpiSrc& s, const float* of_s,
    float* red_s, int b, int kvh, int H, int Kv, int hd, int sbytes) {
  const int tid = threadIdx.x, r = e.r;
  mbar_wait(f.sbar);              // the shrink's slice and scales
  shrink_epilogue(e, of_s, red_s, b, kvh, H, Kv, hd,
                  sbytes > 0 ? f.slice : nullptr, f.t,
                  bsc16(e) ? f.bsc : s.bsc);
  __syncthreads();                // the partial is in f.t
  cluster_wait();                 // every block's barrier is set up
  if (tid == STAGER) mbar_expect(f.xbar, 4 * Kv * r);
  for (int i = tid; i < Kv * r; i += ATTN_THREADS) {   // partial j to block h
    const int h = i / r, j = i - h * r;
    st_async(cluster_addr(f.recv + kvh * r + j, h), f.t[j],
             cluster_addr(f.xbar, h));
  }
  mbar_wait(f.xbar);              // the Kv partials are in f.recv
  if (tid < r) {
    float t = 0.f;
    for (int h = 0; h < Kv; ++h) t = __fadd_rn(t, f.recv[h * r + tid]);
    f.x[tid] = t;
  }
  mbar_wait(f.wbar);              // the expand's rows, scales and Sigma
  __syncthreads();
  const float* t = f.x;
  if (e.sigma != nullptr) {
    if (tid < r) {
      const void* sg = e.sig_stage > 0 ? f.sig : s.sig;
      float u;
      if (e.sigma_full) {         // u[q] = sum_j T[j] * Sigma[id, j, q]
        u = 0.f;
#pragma unroll 8
        for (int j = 0; j < r; ++j)
          u = __fmaf_rn(f.x[j], load_any(sg, (int64_t)j * r + tid,
                                         e.sigma_dtype), u);
      } else {                    // u[j] = T[j] * sigma[id, j]
        u = __fmul_rn(f.x[tid], load_any(sg, tid, e.sigma_dtype));
      }
      f.u[tid] = u;
    }
    __syncthreads();
    t = f.u;
  }
  if (e.w_dtype == DT_BF16)
    expand_typed<__nv_bfloat16>(e, t, s, f, b, Kv);
  else if (e.w_dtype == DT_I8)
    expand_typed<int8_t>(e, t, s, f, b, Kv);
  else
    expand_typed<float>(e, t, s, f, b, Kv);
}

// Stage tile t of the chunk's sequence K_0 .. K_{nt-1}, V_0 .. V_{nt-1}
// into its ring slot: 16-byte cp.async copies (vec), or element loads
// padded with zeros to hdp.  Rows r0 .. of the chunk sit at
// base + row_off[r0 + i] (paged) or base + (c0 + r0 + i) * ss.  For the
// tensor cores the tile's rows past the chunk's end, up to the next 16,
// are zero (a zero p times stale shared memory could be NaN).
template <typename TKV, bool PAGED, bool MMA>
static __device__ __forceinline__ void issue_tile(
    int t, int nt, int n, unsigned char* ring, const TKV* kb, const TKV* vb,
    const int64_t* row_off, int64_t k_ss, int64_t v_ss, int c0, bool vec,
    int nch, int hd, int hdp, int rs) {
  if (t >= 2 * nt) return;
  const bool is_k = t < nt;
  const int r0 = (is_k ? t : t - nt) * TILE_S;
  const int rows = min(TILE_S, n - r0);
  const int staged = MMA ? min(TILE_S, (rows + 15) / 16 * 16) : rows;
  const TKV* base = is_k ? kb : vb;
  const int64_t ss = is_k ? k_ss : v_ss;
  unsigned char* dst = ring + (t % NSTAGE) * TILE_S * rs;
  if (vec) {
    // every source address first, then the copies back to back (a copy's
    // asm orders memory, so it would hold the next address's read back)
    constexpr int MAXC = TILE_S * (32 * KMAX * sizeof(TKV) / 16) /
                         ATTN_THREADS;
    const unsigned char* src[MAXC];
    int off[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int i = threadIdx.x + c * ATTN_THREADS;
      const int row = i / nch, x = i - row * nch;
      const bool live = row < rows;
      src[c] = reinterpret_cast<const unsigned char*>(
                   live ? base + (PAGED ? row_off[r0 + row]
                                        : (int64_t)(c0 + r0 + row) * ss)
                        : base) + (live ? x * 16 : 0);
      off[c] = live ? row * rs + x * 16 : -(row * rs + x * 16) - 1;
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int i = threadIdx.x + c * ATTN_THREADS;
      if (i < staged * nch) {
        const bool live = off[c] >= 0;
        cp_async16(dst + (live ? off[c] : -off[c] - 1), src[c],
                   live ? 16 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < staged * hdp; i += ATTN_THREADS) {
      const int row = i / hdp, x = i - row * hdp;
      const bool live = row < rows;
      const TKV* s = base + (PAGED ? (live ? row_off[r0 + row] : 0)
                                   : (int64_t)(c0 + r0 + row) * ss);
      reinterpret_cast<TKV*>(dst + row * rs)[x] =
          live && x < hd ? s[x] : from_f<TKV>(0.f);
    }
  }
}

// Softmax over the chunk's n logits of each of the pass's gn query rows,
// one warp per row: p in place of the logits, m and l
static __device__ __forceinline__ void chunk_softmax(float* s_s, float* m_s,
                                                     float* l_s, int n,
                                                     int gn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < gn; g += ATTN_WARPS) {
    float* sg = s_s + g * SPLIT_S;
    float mx = NEG_INF;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sg[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(__fsub_rn(sg[i], mx));
      sg[i] = p;
      sum = __fadd_rn(sum, p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
}

// A fragments (m16n8k16, rows g = lane / 4 < 4 of 16; rows 8-15 zero) of
// `rows` rows of f32 values x(g, k), as three bf16 pieces:
// frag[(ks * 3 + piece) * 16 + lane] = (a0, a2) for k-step ks and lanes
// below 16 (the lanes of rows 4-7 hold zeros: see frag_a)
// The A fragment of a lane from build_frags' table (rows 4-15 zero)
static __device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                              const uint2* frag, int idx,
                                              int lane) {
  const uint2 f = lane < 16 ? frag[idx * 16 + lane] : make_uint2(0u, 0u);
  a[0] = f.x;
  a[1] = 0u;
  a[2] = f.y;
  a[3] = 0u;
}

template <typename F>
static __device__ __forceinline__ void build_frags(uint2* frag, int ksteps,
                                                   F x) {
  for (int i = threadIdx.x; i < ksteps * 16; i += ATTN_THREADS) {
    const int ks = i >> 4, l = i & 15, g = l >> 2;
    const int k0 = ks * 16 + 2 * (l & 3);
    __nv_bfloat16 pc[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(x(g, k0 + (e & 1) + (e >> 1) * 8),
                                       pc[e]);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      frag[(ks * 3 + p) * 16 + l] =
          make_uint2(pack_bf16x2(pc[0][p], pc[1][p]),
                     pack_bf16x2(pc[2][p], pc[3][p]));
  }
}

template <typename T, typename TKV, bool PAGED, bool SHRINK, bool MMA>
__global__ void __launch_bounds__(ATTN_THREADS) decode_attn_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const int* __restrict__ kv_len, int H,
    int Kv, int hd, int S, int nc, int64_t k_sb, int64_t k_ss,
    int64_t v_sb, int64_t v_ss, float scale, bool vec, T* __restrict__ out,
    float* __restrict__ l_out, float* __restrict__ m_out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml, Epilogue epi,
    int sbytes, const int* __restrict__ page_table, int n_blocks,
    int page_t) {
  constexpr int ES = sizeof(TKV);
  constexpr int VE = 16 / ES;               // elements in 16 bytes
  const int G = H / Kv;
  const int bk = blockIdx.x;                // b * Kv + kvh
  const int b = bk / Kv, kvh = bk % Kv, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (hd * ES + 15) / 16;      // 16-byte chunks of a row
  const int hdp = nch * VE;                 // row length, padded
  const int rs = attn_row_stride(hd, ES);
  const int KS = hd / 16;                   // k-steps of a row (MMA)

  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = chunk * SPLIT_S;
  int64_t* row_off = reinterpret_cast<int64_t*>(
      smem + NSTAGE * TILE_S * rs + 4 * GB * SPLIT_S + attn_q_bytes(hd, ES) +
      attn_p_bytes(hd, ES));
  if (PAGED) {
    // the chunk's pool offsets, read while kv_len is in flight (entries
    // past the prefix are read but never followed)
    const int* pt_b = page_table + (int64_t)b * n_blocks;
    for (int i = tid; i < min(SPLIT_S, S - c0); i += ATTN_THREADS) {
      const int s = c0 + i;
      row_off[i] = (int64_t)pt_b[s / page_t] * k_sb +
                   (int64_t)(s % page_t) * k_ss;
    }
  }
  const int n_valid = min(kv_len[b], S);    // S = n_blocks * page_t if paged
  const int n = max(0, min(SPLIT_S, n_valid - c0));   // rows of this chunk
  const int64_t wbase = (int64_t)bk * nc + chunk;     // its partial's index
  if (n == 0 && nc > 1) {                   // at or past kv_len: empty
    for (int i = tid; i < G * hd; i += ATTN_THREADS)
      ws_acc[wbase * G * hd + i] = 0.f;
    for (int g = tid; g < G; g += ATTN_THREADS) {
      ws_ml[(wbase * G + g) * 2] = NEG_INF;
      ws_ml[(wbase * G + g) * 2 + 1] = 0.f;
    }
    return;
  }

  unsigned char* ring = smem;                          // (NSTAGE, TILE_S) rows
  float* s_s = reinterpret_cast<float*>(smem + NSTAGE * TILE_S * rs);
  unsigned char* q_r = reinterpret_cast<unsigned char*>(s_s + GB * SPLIT_S);
  float* q_s = reinterpret_cast<float*>(q_r);          // (GB, hdp), CUDA cores
  uint2* qf = reinterpret_cast<uint2*>(q_r);           // (KS, 3, 16), MMA
  uint2* pf = reinterpret_cast<uint2*>(q_r + attn_q_bytes(hd, ES));
  float* m_s = reinterpret_cast<float*>(row_off + (PAGED ? SPLIT_S : 0));
  float* l_s = m_s + GB;
  float* red_s = l_s + GB;                             // (RED_FLOATS)
  float* of_s = red_s + RED_FLOATS;                    // (G, hd)
  // the epilogue's slices: their addresses now, their copies with the
  // last of the first tiles (so they fly behind the attention)
  FusedSmem fs{};
  EpiSrc xs{};
  if (SHRINK) {
    fs = carve(of_s + G * hd, epi, sbytes, Kv);
    cluster_start(fs);
    xs = epi_src(epi, b, kvh, H, Kv, hd);
  }
  // CUDA cores: the warps' partial sums (ATTN_WARPS, GB, hdp), over the
  // ring once the last tile is done with
  float* wacc = reinterpret_cast<float*>(smem);

  const T* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  // contiguous: row s at kb + s * k_ss; paged: at kb + row_off[s - c0]
  const TKV* kb = k + (PAGED ? 0 : (int64_t)b * k_sb) + (int64_t)kvh * hd;
  const TKV* vb = v + (PAGED ? 0 : (int64_t)b * v_sb) + (int64_t)kvh * hd;
  if (PAGED) __syncthreads();              // row_off in
  const int nt = (n + TILE_S - 1) / TILE_S;  // K tiles, then as many V tiles
  const int total = 2 * nt;
#define ISSUE(t)                                                             \
  issue_tile<TKV, PAGED, MMA>(t, nt, n, ring, kb, vb, row_off, k_ss, v_ss,  \
                              c0, vec, nch, hd, hdp, rs)

  // CUDA cores, p @ V: lane grp * nchl + lch holds the 16-byte chunk lch
  // (and lch + 32) of every ngrp-th row; lanes past ngrp * nchl idle
  constexpr int CPL = ES == 4 ? 2 : 1;      // chunks a lane holds, hd <= 256
  const int nchl = min(nch, 32);
  const int ngrp = 32 / nchl;
  const int grp = lane / nchl, lch = lane - grp * nchl;
  const bool vlane = grp < ngrp;
  // tensor cores, p @ V: warp w takes the 16-column slices w, w + 4, ...
  constexpr int PMAX = 32 * KMAX / 16 / ATTN_WARPS;

  T* ob = out + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  for (int g0 = 0; g0 < G; g0 += GB) {
    const int gn = min(GB, G - g0);
    // the first tiles' copies fly while the query rows load
#pragma unroll
    for (int t = 0; t < NSTAGE - 1; ++t) {
      ISSUE(t);
      if (SHRINK && g0 == 0 && t == NSTAGE - 2 && tid == STAGER)
        stage_epilogue(epi, xs, fs, H, Kv, hd, sbytes);
      cp_async_commit();
    }
    auto qx = [&](int g, int d) {
      return g < gn && d < hd
                 ? __fmul_rn(to_f(qb[(int64_t)(g0 + g) * hd + d]), scale)
                 : 0.f;
    };
    if (MMA) {
      build_frags(qf, KS, qx);
    } else {
      for (int i = tid; i < GB * hdp; i += ATTN_THREADS)
        q_s[i] = qx(i / hdp, i % hdp);
    }
    float acc[CPL][GB][VE];                 // CUDA cores
    float vd[PMAX][2][4];                   // tensor cores (rows g < 4)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int x = 0; x < VE; ++x) acc[cc][g][x] = 0.f;
#pragma unroll
    for (int pi = 0; pi < PMAX; ++pi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 4; ++x) vd[pi][h][x] = 0.f;

    for (int t = 0; t < total; ++t) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // tile t and q are in; all are done with tile t-1
      ISSUE(t + NSTAGE - 1);            // into tile t-1's slot
      cp_async_commit();
      const unsigned char* tile = ring + (t % NSTAGE) * TILE_S * rs;
      if (t < nt && MMA) {
        // logits of rows warp*8 .. warp*8+7: S = Q K^T on the tensor
        // cores, one chain of k-steps per piece of q (three chains in
        // flight), then (h + m) + l
        float sd[3][4] = {};
        const unsigned char* kr =
            tile + (warp * 8 + (lane & 7)) * rs + (lane >> 3) * 16;
        for (int ks = 0; ks < KS; ks += 2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, kr + ks * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int pc = 0; pc < 3; ++pc) {
              uint32_t a[4];
              frag_a(a, qf, (ks + h) * 3 + pc, lane);
              mma_bf16(sd[pc], a, bf[2 * h], bf[2 * h + 1]);
            }
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
          sd[0][x] = __fadd_rn(__fadd_rn(sd[0][x], sd[1][x]), sd[2][x]);
        const int g = lane >> 2, s = t * TILE_S + warp * 8 + 2 * (lane & 3);
        if (g < gn) {
          if (s < n) s_s[g * SPLIT_S + s] = sd[0][0];
          if (s + 1 < n) s_s[g * SPLIT_S + s + 1] = sd[0][1];
        }
      } else if (t < nt) {
        // logits: lanes 4i .. 4i+3 of a warp take row warp*8 + i
        const int row = warp * 8 + (lane >> 2), part = lane & 3;
        const unsigned char* krow = tile + row * rs;
        float dot[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) dot[g] = 0.f;
        for (int ch = part; ch < nch; ch += 4) {
          float kf[VE];
          unpack16(krow + ch * 16, kf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float* qg = q_s + g * hdp + ch * VE;
#pragma unroll
            for (int e = 0; e < VE; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + e);
              dot[g] = __fmaf_rn(qv.x, kf[e], dot[g]);
              dot[g] = __fmaf_rn(qv.y, kf[e + 1], dot[g]);
              dot[g] = __fmaf_rn(qv.z, kf[e + 2], dot[g]);
              dot[g] = __fmaf_rn(qv.w, kf[e + 3], dot[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          dot[g] = __fadd_rn(dot[g], __shfl_xor_sync(FULL_MASK, dot[g], 1));
          dot[g] = __fadd_rn(dot[g], __shfl_xor_sync(FULL_MASK, dot[g], 2));
        }
        const int s = t * TILE_S + row;
        if (part == 0 && s < n) {
#pragma unroll
          for (int g = 0; g < GB; ++g)
            if (g < gn) s_s[g * SPLIT_S + s] = dot[g];
        }
      } else {
        if (t == nt) {
          // every logit of the chunk is in: softmax (and, for the tensor
          // cores, p as A fragments)
          chunk_softmax(s_s, m_s, l_s, n, gn);
          if (MMA) {
            __syncthreads();
            build_frags(pf, (n + 15) / 16, [&](int g, int r) {
              return g < gn && r < n ? s_s[g * SPLIT_S + r] : 0.f;
            });
          }
          __syncthreads();
        }
        const int vt = t - nt, r0 = vt * TILE_S;
        if (MMA) {
          // acc += P V: the tile's two k-steps of 16 rows, pieces h, m, l
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ks = vt * 2 + h;
            if (ks * 16 >= n) break;
            uint32_t a[3][4];
#pragma unroll
            for (int pc = 0; pc < 3; ++pc) {
              frag_a(a[pc], pf, ks * 3 + pc, lane);
            }
            const unsigned char* vr =
                tile + (h * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * rs +
                (lane >> 4) * 16;
#pragma unroll
            for (int pi = 0; pi < PMAX; ++pi) {
              const int pp = warp + pi * ATTN_WARPS;
              if (pp < KS) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, vr + pp * 32);
#pragma unroll
                for (int pc = 0; pc < 3; ++pc) {
                  mma_bf16(vd[pi][0], a[pc], bf[0], bf[1]);
                  mma_bf16(vd[pi][1], a[pc], bf[2], bf[3]);
                }
              }
            }
          }
        } else {
          // acc += p @ V over rows warp*8 .. warp*8+7 of the tile: lane
          // group grp takes rows grp, grp + ngrp, ... of them
          const int rows = min(TILE_S, n - r0);
          for (int j = grp; j < 8 && vlane; j += ngrp) {
            const int row = warp * 8 + j;
            if (row >= rows) break;
            float pg[GB];
#pragma unroll
            for (int g = 0; g < GB; ++g) pg[g] = s_s[g * SPLIT_S + r0 + row];
#pragma unroll
            for (int cc = 0; cc < CPL; ++cc) {
              const int ch = lch + 32 * cc;
              if (ch < nch) {
                float vf[VE];
                unpack16(tile + row * rs + ch * 16, vf);
#pragma unroll
                for (int g = 0; g < GB; ++g)
#pragma unroll
                  for (int x = 0; x < VE; ++x)
                    acc[cc][g][x] = __fmaf_rn(pg[g], vf[x], acc[cc][g][x]);
              }
            }
          }
        }
      }
    }
    if (nt == 0 && tid < GB) {      // kv_len 0: nothing to attend to
      m_s[tid] = NEG_INF;
      l_s[tid] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();                // the ring is free
    // out (one chunk) or this chunk's partial, from each output's sum
    auto emit = [&](int g, int d, float a) {
      const int64_t gi = (int64_t)(g0 + g) * hd + d;
      if (nc > 1) {
        ws_acc[wbase * G * hd + gi] = a;
      } else {
        const float o = __fdiv_rn(a, fmaxf(l_s[g], 1e-30f));
        if (SHRINK) of_s[gi] = o;
        ob[gi] = from_f<T>(o);
      }
    };
    if (MMA) {
      const int g = lane >> 2;
#pragma unroll
      for (int pi = 0; pi < PMAX; ++pi) {
        const int pp = warp + pi * ATTN_WARPS;
        if (pp < KS && g < gn) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = pp * 16 + h * 8 + 2 * (lane & 3);
            emit(g, d, vd[pi][h][0]);
            emit(g, d + 1, vd[pi][h][1]);
          }
        }
      }
    } else {
      // the lane groups' sums in group order, then the warps' in warp order
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int x = 0; x < VE; ++x) {
            float a = __shfl_sync(FULL_MASK, acc[cc][g][x], lch);
            for (int gi = 1; gi < ngrp; ++gi)
              a = __fadd_rn(a, __shfl_sync(FULL_MASK, acc[cc][g][x],
                                           gi * nchl + lch));
            const int ch = lch + 32 * cc;
            if (grp == 0 && ch < nch && g < gn)
              wacc[(warp * GB + g) * hdp + ch * VE + x] = a;
          }
      __syncthreads();
      for (int i = tid; i < gn * hd; i += ATTN_THREADS) {
        const int g = i / hd, d = i - g * hd, w0 = g * hdp + d;
        float a = wacc[w0];
        for (int w = 1; w < ATTN_WARPS; ++w)
          a = __fadd_rn(a, wacc[w * GB * hdp + w0]);
        emit(g, d, a);
      }
    }
    if (tid < gn) {
      const int g = g0 + tid;
      if (nc > 1) {
        ws_ml[(wbase * G + g) * 2] = m_s[tid];
        ws_ml[(wbase * G + g) * 2 + 1] = l_s[tid];
      } else if (l_out != nullptr) {
        l_out[(int64_t)bk * G + g] = l_s[tid];
        m_out[(int64_t)bk * G + g] = m_s[tid];
      }
    }
    __syncthreads();   // of_s complete; the next pass may reuse the rest
  }
#undef ISSUE
  if (SHRINK)        // a shrink launch has one chunk (the merge runs it else)
    fused_epilogue(epi, fs, xs, of_s, red_s, b, kvh, H, Kv, hd, sbytes);
}

// Merge the chunks of one (b, kv-head) in ascending order; then out, the
// global l, m and (SHRINK: a cluster of the sequence's Kv blocks) the
// epilogue, as the one-chunk launch writes them.  The chunks' partials
// (where they fit in ACC_MAX) are copied to shared memory as the block
// starts, while it computes the weights w_c = exp(m_c - m), and the
// epilogue's slices while it merges.
template <typename T, bool SHRINK>
__global__ void __launch_bounds__(ATTN_THREADS) decode_attn_merge_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    int nc, int H, int Kv, int hd, T* __restrict__ out,
    float* __restrict__ l_out, float* __restrict__ m_out, Epilogue epi,
    bool acc_staged, int sbytes) {
  const int bk = blockIdx.x, b = bk / Kv, kvh = bk % Kv;
  const int G = H / Kv, GH = G * hd;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  float* m_s = reinterpret_cast<float*>(smem);         // (G)
  float* l_s = m_s + G;                                // (G)
  float* red_s = l_s + G;                              // (RED_FLOATS)
  float* of_s = red_s + RED_FLOATS;                    // (G, hd)
  float* w_s = of_s + GH;                              // (G, nc)
  float* acc_s = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(w_s + G * nc) + 15) & ~uintptr_t(15));
  const float* ml = ws_ml + (int64_t)bk * nc * G * 2;  // (nc, G, 2)
  const float* acc = ws_acc + (int64_t)bk * nc * GH;   // (nc, G, hd)
  if (acc_staged) {
    for (int i = tid; i < nc * GH / 4; i += ATTN_THREADS)
      cp_async16(acc_s + 4 * i, acc + 4 * i, 16);
    acc = acc_s;
  }
  cp_async_commit();
  FusedSmem fs{};
  EpiSrc xs{};
  if (SHRINK) {
    // the epilogue's operands next, so that they fly while the block merges
    fs = carve(acc_s + (acc_staged ? nc * GH : 0), epi, sbytes, Kv);
    cluster_start(fs);
    xs = epi_src(epi, b, kvh, H, Kv, hd);
    if (tid == STAGER) stage_epilogue(epi, xs, fs, H, Kv, hd, sbytes);
  }
  for (int g = tid; g < G; g += ATTN_THREADS) {
    float m = NEG_INF;
    for (int c = 0; c < nc; ++c) m = fmaxf(m, ml[(c * G + g) * 2]);
    float l = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float w = expf(__fsub_rn(ml[(c * G + g) * 2], m));
      w_s[g * nc + c] = w;
      l = __fmaf_rn(w, ml[(c * G + g) * 2 + 1], l);
    }
    m_s[g] = m;
    l_s[g] = l;
  }
  cp_async_wait<0>();
  __syncthreads();
  T* ob = out + (int64_t)bk * GH;
  for (int i = tid; i < GH; i += ATTN_THREADS) {
    const int g = i / hd;
    const float* wg = w_s + g * nc;
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < nc; ++c)
      a = __fmaf_rn(wg[c], acc[(int64_t)c * GH + i], a);
    const float o = __fdiv_rn(a, fmaxf(l_s[g], 1e-30f));
    of_s[i] = o;
    ob[i] = from_f<T>(o);
  }
  if (l_out != nullptr) {
    for (int g = tid; g < G; g += ATTN_THREADS) {
      l_out[(int64_t)bk * G + g] = l_s[g];
      m_out[(int64_t)bk * G + g] = m_s[g];
    }
  }
  if (SHRINK) {
    __syncthreads();        // of_s complete
    fused_epilogue(epi, fs, xs, of_s, red_s, b, kvh, H, Kv, hd, sbytes);
  }
}

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  int B, H, Kv, hd, S;
  int64_t k_sb, k_ss, v_sb, v_ss;
  float scale;
  void* out;
  float* l_out;
  float* m_out;
  float* ws_acc;
  float* ws_ml;
  int n_chunks;
  Epilogue epi;
  const int* page_table;
  int n_blocks, page_t;
  cudaStream_t stream;
};

// Dynamic shared memory above 48 KB must be allowed per kernel, once.
template <typename K>
static int allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) allowed = bytes;
  return err;
}

// The shared memory of a shrink launch: `base` bytes, then the fused
// epilogue's (carve's layout): the exchange buffers, the shrink's bank
// slice (sbytes: slice_bytes), this block's expand rows with their scales
// (e.w_stage: the widest block's rows, where expand16 and under
// EXPAND_MAX) and Sigma[id] (e.sig_stage: 16-byte multiples, under
// EXPAND_MAX), each staged only where it still fits in MAX_SMEM_BLOCK
static size_t fused_smem(size_t base, Epilogue& e, int H, int Kv, int hd,
                         int& sbytes) {
  size_t smem = base + 16 + xch_bytes(e, Kv);
  sbytes = slice_bytes(e, H, Kv, hd);
  if (smem + sbytes > MAX_SMEM_BLOCK) sbytes = 0;
  smem += sbytes;
  const int64_t wb =
      (int64_t)expand_cols(e, Kv) * e.r * elem_bytes(e.w_dtype);
  e.w_stage = expand16(e) && wb <= EXPAND_MAX ? (int)wb : 0;
  if (e.w_stage > 0) {
    const size_t with = smem + e.w_stage + scale_stage_bytes(e, Kv);
    if (with > MAX_SMEM_BLOCK)
      e.w_stage = 0;
    else
      smem = with;
  }
  const int sb = e.sigma == nullptr
                     ? 0
                     : sigma_elems(e) * elem_bytes(e.sigma_dtype);
  e.sig_stage = sb % 16 == 0 && sb <= EXPAND_MAX && aligned16(e.sigma) &&
                        smem + sb <= MAX_SMEM_BLOCK
                    ? sb
                    : 0;
  return smem + e.sig_stage;
}

// The (shared memory, cluster size) pairs of one shrink kernel already
// checked: the occupancy query runs before the first launch of each
struct ClusterChecks {
  std::mutex mu;
  std::vector<std::pair<size_t, int>> done;
};

// Launch `kernel` as clusters of Kv blocks along x (a sequence's kv-heads:
// blockIdx.x = b * Kv + kvh).  Above 8 blocks the cluster size is
// non-portable and must be allowed; a shape whose cluster cannot be
// resident (cudaOccupancyMaxActiveClusters 0) is refused, never launched.
template <typename K, typename... Args>
static int launch_cluster(K kernel, dim3 grid, size_t smem, int Kv,
                          cudaStream_t stream, ClusterChecks& checks,
                          Args&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Kv;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(ATTN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> lock(checks.mu);
    const std::pair<size_t, int> key(smem, Kv);
    bool seen = false;
    for (const auto& d : checks.done) seen = seen || d == key;
    if (!seen) {
      int err = 0;
      if (Kv > 8)
        err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err) return err;
      int n = 0;
      err = (int)cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err) return err;
      if (n < 1) return (int)cudaErrorInvalidConfiguration;
      checks.done.push_back(key);
    }
  }
  const int err =
      (int)cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename T, bool SHRINK>
static int launch_merge(const AttnArgs& a) {
  static size_t allowed = 48 * 1024;
  const int G = a.H / a.Kv, GH = G * a.hd;
  size_t smem = merge_smem_bytes(G, a.hd, a.n_chunks) + 16;
  const size_t acc_bytes = sizeof(float) * a.n_chunks * (size_t)GH;
  const bool acc_staged = GH % 4 == 0 && acc_bytes <= ACC_MAX &&
                          aligned16(a.ws_acc);
  if (acc_staged) smem += acc_bytes;
  Epilogue epi = a.epi;
  int sbytes = 0;
  if (SHRINK) smem = fused_smem(smem, epi, a.H, a.Kv, a.hd, sbytes);
  auto kernel = decode_attn_merge_kernel<T, SHRINK>;
  int err = allow_smem(kernel, smem, allowed);
  if (err) return err;
  if constexpr (SHRINK) {
    static ClusterChecks checks;
    return launch_cluster(kernel, dim3(a.B * a.Kv), smem, a.Kv, a.stream,
                          checks, a.ws_acc, a.ws_ml, a.n_chunks, a.H, a.Kv,
                          a.hd, static_cast<T*>(a.out), a.l_out, a.m_out,
                          epi, acc_staged, sbytes);
  } else {
    decode_attn_merge_kernel<T, false><<<a.B * a.Kv, ATTN_THREADS, smem,
                                         a.stream>>>(
        a.ws_acc, a.ws_ml, a.n_chunks, a.H, a.Kv, a.hd,
        static_cast<T*>(a.out), a.l_out, a.m_out, epi, acc_staged, sbytes);
    return (int)cudaGetLastError();
  }
}

template <typename T, typename TKV, bool PAGED, bool SHRINK, bool MMA>
static int launch(const AttnArgs& a, bool vec) {
  static size_t allowed = 48 * 1024;
  const int G = a.H / a.Kv;
  size_t smem = attn_smem_bytes(G, a.hd, sizeof(TKV), PAGED);
  Epilogue epi = a.epi;
  int sbytes = 0;
  if (SHRINK) smem = fused_smem(smem, epi, a.H, a.Kv, a.hd, sbytes);
  auto kernel = decode_attn_kernel<T, TKV, PAGED, SHRINK, MMA>;
  int err = allow_smem(kernel, smem, allowed);
  if (err) return err;
  const dim3 grid(a.B * a.Kv, a.n_chunks);
  if constexpr (SHRINK) {   // one chunk: the whole call
    static ClusterChecks checks;
    return launch_cluster(
        kernel, grid, smem, a.Kv, a.stream, checks,
        static_cast<const T*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.kv_len, a.H, a.Kv, a.hd, a.S,
        a.n_chunks, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale, vec,
        static_cast<T*>(a.out), a.l_out, a.m_out, a.ws_acc, a.ws_ml, epi,
        sbytes, a.page_table, a.n_blocks, a.page_t);
  } else {
    decode_attn_kernel<T, TKV, PAGED, false, MMA><<<grid, ATTN_THREADS, smem,
                                                    a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.kv_len, a.H, a.Kv, a.hd, a.S,
        a.n_chunks, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale, vec,
        static_cast<T*>(a.out), a.l_out, a.m_out, a.ws_acc, a.ws_ml, epi,
        sbytes, a.page_table, a.n_blocks, a.page_t);
    err = (int)cudaGetLastError();
    if (err || a.n_chunks == 1) return err;
    // the chunks' launch carries no epilogue; the merge runs it
    return a.epi.mode == MODE_NONE ? launch_merge<T, false>(a)
                                   : launch_merge<T, true>(a);
  }
}

template <typename T, typename TKV, bool PAGED, bool SHRINK>
static int launch_mma(const AttnArgs& a, bool vec) {
  if constexpr (sizeof(TKV) == 2)
    if (uses_mma(a.hd, 2)) return launch<T, TKV, PAGED, SHRINK, true>(a, vec);
  return launch<T, TKV, PAGED, SHRINK, false>(a, vec);
}

// 16-byte copies need 16-byte aligned rows: the base pointers and every
// stride (and the head offset kvh * hd) in bytes.  The arithmetic does not
// depend on how the ring is filled.
template <typename T, typename TKV>
static int launch_kv(const AttnArgs& a) {
  const int64_t es = sizeof(TKV);
  const bool vec = (a.hd * es) % 16 == 0 && aligned16(a.k) &&
                   aligned16(a.v) && (a.k_sb * es) % 16 == 0 &&
                   (a.k_ss * es) % 16 == 0 && (a.v_sb * es) % 16 == 0 &&
                   (a.v_ss * es) % 16 == 0;
  // the epilogue runs in this kernel only where there is one chunk (else
  // in the merge)
  const bool shrink = a.epi.mode != MODE_NONE && a.n_chunks == 1;
  if (a.page_table != nullptr)
    return shrink ? launch_mma<T, TKV, true, true>(a, vec)
                  : launch_mma<T, TKV, true, false>(a, vec);
  return shrink ? launch_mma<T, TKV, false, true>(a, vec)
                : launch_mma<T, TKV, false, false>(a, vec);
}

// q/out in `dtype`, k/v in `kv_dtype` (f32 or bf16 each: an f32 model
// keeps the bf16 KV cache)
static int dispatch(int dtype, int kv_dtype, AttnArgs& a) {
  if (a.page_table != nullptr) {
    if (a.n_blocks <= 0 || a.page_t <= 0 || a.k_sb != a.v_sb ||
        a.k_ss != a.v_ss)
      return (int)cudaErrorInvalidValue;
    a.S = a.n_blocks * a.page_t;
  }
  if (a.hd < 1 || a.hd > 32 * KMAX || a.Kv < 1 || a.H % a.Kv ||
      a.n_chunks < 1 || a.n_chunks > 65535 ||
      (int64_t)a.n_chunks * SPLIT_S < a.S ||
      (a.n_chunks > 1 && (a.ws_acc == nullptr || a.ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaSuccess;
  if (dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch_kv<__nv_bfloat16, __nv_bfloat16>(a);
  if (dtype == DT_F32 && kv_dtype == DT_BF16)
    return launch_kv<float, __nv_bfloat16>(a);
  if (dtype == DT_BF16 && kv_dtype == DT_F32)
    return launch_kv<__nv_bfloat16, float>(a);
  if (dtype == DT_F32 && kv_dtype == DT_F32) return launch_kv<float, float>(a);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Both entry points take an optional page table (B, n_blocks) int32: null
// for a contiguous cache k/v (B, S, Kv, hd) with batch strides k_sb/v_sb
// and row strides k_ss/v_ss; set for pools k/v (P, page_t, Kv, hd) of one
// layout, with page strides in k_sb == v_sb, row strides in k_ss == v_ss,
// and S ignored (n_blocks * page_t).  n_chunks >= ceil(S / SPLIT_S); where
// it is above 1, ws_acc (B, Kv, n_chunks, G, hd) and ws_ml (B, Kv,
// n_chunks, G, 2) f32 hold the chunks' partials and a merge launch follows.

// flash_decode: out (B, H, hd) in q's dtype, l/m (B, Kv, G) f32
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, void* out, float* l_out,
                        float* m_out, int B, int H, int Kv, int hd, int S,
                        int64_t k_sb, int64_t k_ss, int64_t v_sb,
                        int64_t v_ss, float scale, int dtype, int kv_dtype,
                        const int* page_table, int n_blocks, int page_t,
                        float* ws_acc, float* ws_ml, int n_chunks,
                        void* stream) {
  Epilogue none{};
  none.mode = MODE_NONE;
  AttnArgs a{q, k, v, kv_len, B, H, Kv, hd, S, k_sb, k_ss, v_sb, v_ss,
             scale, out, l_out, m_out, ws_acc, ws_ml, n_chunks, none,
             page_table, n_blocks, page_t, (cudaStream_t)stream};
  return dispatch(dtype, kv_dtype, a);
}

// Attention (out in q's dtype) and the o-projection delta (B, d_out) f32
// in one launch (two where n_chunks > 1).  cluster_of and sigma are null
// for raw LoRA (bank = A, rows; w = B) and set for JD (bank = V, columns;
// sigma (n, r) or (n, r, r) as sigma_full says; w = U).  Scales are f32,
// (n, r) for the bank and (n, d_out) for w; Kv <= KV_MAX (one cluster).
int fused_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, const int* ids,
                        const int* cluster_of, const void* bank,
                        int bank_dtype, const float* bank_scale, int r,
                        const void* sigma, int sigma_dtype, int sigma_full,
                        const void* w, int w_dtype, const float* w_scale,
                        int d_out, float* delta, void* out, int B, int H,
                        int Kv, int hd, int S, int64_t k_sb, int64_t k_ss,
                        int64_t v_sb, int64_t v_ss, float scale, int dtype,
                        int kv_dtype, const int* page_table, int n_blocks,
                        int page_t, float* ws_acc, float* ws_ml,
                        int n_chunks, void* stream) {
  if (r < 1 || r > ATTN_THREADS || d_out < 1 || Kv > KV_MAX ||
      (sigma == nullptr) != (cluster_of == nullptr))
    return (int)cudaErrorInvalidValue;
  Epilogue e{};
  e.mode = cluster_of == nullptr ? MODE_ROWS : MODE_COLS;
  e.ids = ids;
  e.cluster_of = cluster_of;
  e.bank = bank;
  e.bank_dtype = bank_dtype;
  e.bank_scale = bank_scale;
  e.r = r;
  e.sigma = sigma;
  e.sigma_dtype = sigma_dtype;
  e.sigma_full = sigma_full;
  e.w = w;
  e.w_dtype = w_dtype;
  e.w_scale = w_scale;
  e.d_out = d_out;
  e.delta = delta;
  AttnArgs a{q, k, v, kv_len, B, H, Kv, hd, S, k_sb, k_ss, v_sb, v_ss,
             scale, out, nullptr, nullptr, ws_acc, ws_ml, n_chunks, e,
             page_table, n_blocks, page_t, (cudaStream_t)stream};
  return dispatch(dtype, kv_dtype, a);
}

}  // extern "C"
