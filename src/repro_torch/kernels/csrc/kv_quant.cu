// Per-channel symmetric quantization of KV wire blocks: the Hopper kernels
// behind repro_torch/kernels/kv_quant.py.
//
// Replaces the TPU kernels kernels/kv_quant.py::kv_quantize (_quant8_kernel,
// _quant4_kernel) and kv_dequantize (_dequant8_kernel, _dequant4_kernel).
// For a block x (T, C), T tokens by C channels:
//   scale[j] = absmax_t |x[t, j]| / qmax  (1 if 0), qmax 127 or 7;
//   q[t, j]  = clip(rint(x[t, j] / scale[j]), -qmax, qmax);
//   int8: q as (T, C) int8;
//   int4: packed[p, j] = (q[2p, j] & 0xF) | ((q[2p+1, j] & 0xF) << 4),
//         (T/2, C) uint8, the even token in the low nibble.
// Dequantization sign-extends each nibble as ((v & 0xF) ^ 8) - 8 and
// computes q * scale with one __fmul_rn and one rounding to the output
// type.  Both equal the plain versions bit for bit (scale_of and quant of
// common.cuh, and a division-free quotient equal to __fdiv_rn's; never
// --use_fast_math).
//
// Bound on an H100: bytes.  Quantize reads the block once (bf16: 2 bytes a
// value) and writes 1 (int8) or 1/2 (int4) byte a value plus the scales;
// dequantize reads the packed bytes and the scales and writes 4 (f32) or 2
// (bf16) bytes a value.  The wire block (128, 65536) moves 21-42 MB, a few
// microseconds at the HBM rate, so the kernels must issue wide accesses
// with many in flight, read no byte twice and keep the per-value
// arithmetic to a few full-rate instructions.
//
// Quantize: one block of 256 threads owns a 128-byte column of the block
// (64 bf16 or 32 f32 channels) over all T tokens.  A thread owns one
// 16-byte chunk of it, V = 8 or 4 channels, of two row pairs: rows 2p and
// 2p+1 for p = g and g + 32, g its group of 32.  It issues all four
// 16-byte loads first (a warp's: 4 rows x 128 contiguous bytes; 16 KB a
// block of bf16 in flight) and keeps them in registers: the absmax
// (max.bf16x2 on packed pairs; shuffles over a warp's 4 groups, then the
// 8 warps in shared memory) and the quantization read the same copy, so x
// leaves HBM once.  A level is rint of the IEEE quotient without a
// division: x * (1/s) and two FMA remainder steps give RN(x / s) exactly
// (div_rn_fma), and adding 1.5 * 2^23 rounds it half to even with the
// level in the low bits, no branch and no quarter-rate instruction (a
// per-value branch to __fdiv_rn near ties cost as much as the loads).
// int8 rows go out as 8-byte (bf16) or 4-byte (f32) stores; under int4
// the thread packs its pair's nibbles in registers and stores as many
// bytes.  What still bounds it: a block quantizes only once all T rows
// have arrived, so its arithmetic follows its loads instead of overlapping
// them (blocks per SM and a cp.async ring of tiles were tried; see
// PERF.md).  Above QTile::RESIDENT = 128 tokens (both input types) it
// reads x twice: the absmax chunk by chunk, then each chunk again to
// quantize (the last one still held).
//
// Dequantize: a 2-D grid, 8 warps down the token rows by 32 lanes across
// the channels.  The stores are 2-4x the bytes of the loads, so the layout
// follows them: a lane owns V = 4 (f32 out) or 8 (bf16 out) channels and
// writes 16 bytes a token row, a warp 512 contiguous bytes; it reads 4 or
// 8 packed bytes a row (a warp 128 or 256 contiguous), four rows of each
// in flight (two packed rows under int4, each byte giving both of its
// tokens).  Its scales are loaded once and held across the rows.  The
// int8 and nibble levels become floats through the exponent of 1.5 * 2^23
// (__byte_perm, then one subtraction, exact), not the quarter-rate
// integer conversion, and no per-value division or modulo is taken.  It
// streams at the HBM rate.
//
// Both kernels take the vector path only where C is a multiple of the
// lane's width and the base pointers are aligned for its loads and stores
// (a contiguous tensor with a storage offset may not be); otherwise the
// same kernel moves one value at a time.

#include <type_traits>

#include "common.cuh"

#define KVQ_THREADS 256
#define KVQ_ROW_BYTES 128                          // a tile row: 8 chunks
#define KVQ_HOLD 2                                 // row pairs a thread holds
#define KVDQ_THREADS 256
#define KVDQ_WARPS (KVDQ_THREADS / 32)             // warps down the rows
#define KVDQ_ROWS 4                                // token rows a lane writes

__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// -- quantize -----------------------------------------------------------------

// A block's tile: KVQ_ROW_BYTES-byte row segments (64 bf16 or 32 f32
// channels) of every token.  A thread owns one 16-byte chunk column, V
// channels, of HOLD row pairs a chunk of RESIDENT tokens: rows 2p and
// 2p + 1 for p = g + GROUPS * i.
template <typename T>
struct QTile {
  static constexpr int V = 16 / sizeof(T);                 // 8 or 4
  static constexpr int CH = KVQ_ROW_BYTES / sizeof(T);     // 64 or 32
  static constexpr int ACROSS = CH / V;                    // 8 threads
  static constexpr int GROUPS = KVQ_THREADS / ACROSS;      // 32
  static constexpr int RESIDENT = 2 * GROUPS * KVQ_HOLD;   // 128 tokens
};

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 16 bytes of a row as loaded (zeros past the block's edge) and the
// running absmax of such chunks: bf16 pairs by max.bf16x2 on the
// sign-cleared words (exact, and NaN-dropping as fmaxf), f32 by fmaxf
template <typename T>
struct Chunk16;

template <>
struct Chunk16<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ float get(int k) const {
    const uint32_t w = word_of(u, k >> 1);
    return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
  }
  struct Max {
    uint32_t m[4] = {0u, 0u, 0u, 0u};
    __device__ __forceinline__ void add(const Chunk16& c) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m[j] = bf16x2_max(m[j], word_of(c.u, j) & 0x7fff7fffu);
    }
    __device__ __forceinline__ float get(int k) const {
      const uint32_t w = m[k >> 1];
      return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
    }
  };
};

template <>
struct Chunk16<float> {
  uint4 u;
  __device__ __forceinline__ float get(int k) const {
    return __uint_as_float(word_of(u, k));
  }
  struct Max {
    float m[4] = {0.f, 0.f, 0.f, 0.f};
    __device__ __forceinline__ void add(const Chunk16& c) {
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = fmaxf(m[k], fabsf(c.get(k)));
    }
    __device__ __forceinline__ float get(int k) const { return m[k]; }
  };
};

// chunk column c (V channels, n of them inside C) of row r: one 16-byte
// load on the vector path, else value by value; zeros past the block
template <typename T>
__device__ __forceinline__ Chunk16<T> load_chunk(const T* x, int r, int c,
                                                 int n, int n_tok, int C,
                                                 bool vec) {
  using Bits = unsigned short;
  constexpr int V = QTile<T>::V;
  Chunk16<T> v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  if (r >= n_tok || n == 0) return v;
  const T* src = x + (int64_t)r * C + c;
  if (vec) {
    v.u = __ldg(reinterpret_cast<const uint4*>(src));
    return v;
  }
  const Bits* s = reinterpret_cast<const Bits*>(src);
  uint32_t h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)          // V values of sizeof(T) / 2 halves
    h[k] = k / (8 / V) < n ? s[k] : 0u;
  v.u = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                   h[6] | h[7] << 16);
  return v;
}

// x / s rounded to nearest, as __fdiv_rn gives it, without a branch.
// From y = __frcp_rn(s), q0 = x * y lies within 1.5 ulp of x / s; one
// remainder step (r = x - s q by FMA, then q + r y) brings it within an
// ulp, and from there a second is Markstein's correction, which returns
// RN(x / s) when y = RN(1/s), no step under- or overflows (Muller et al.,
// Handbook of Floating-Point Arithmetic, division with an FMA).  For the
// quantizer's scales, 2^-90 <= s <= 2^100 (the caller takes quant()
// elsewhere): a remainder below the normal range then needs |x / s| <
// 1/4, whose level is 0 from either quotient.
__device__ __forceinline__ float div_rn_fma(float x, float s, float y) {
  float q = __fmul_rn(x, y);
  q = __fmaf_rn(__fmaf_rn(-s, q, x), y, q);
  return __fmaf_rn(__fmaf_rn(-s, q, x), y, q);
}

// The V levels of one chunk in the low bytes of l, each equal to quant():
// rint of the quotient through 1.5 * 2^23 (q + 1.5 * 2^23 rounds q half
// to even and holds the level, two's complement, in its low bits; |q| <=
// qmax (1 + 2^-23) since every value is within the absmax its scale came
// from, so no clip), or quant() itself (EXACT: a scale outside
// div_rn_fma's range).
template <bool EXACT, typename T>
__device__ __forceinline__ void levels(uint32_t* l, const Chunk16<T>& v,
                                       const float* s, const float* y,
                                       float qmax) {
#pragma unroll
  for (int k = 0; k < QTile<T>::V; ++k)
    l[k] = EXACT ? (uint32_t)quant(v.get(k), s[k], qmax)
                 : __float_as_uint(__fadd_rn(
                       div_rn_fma(v.get(k), s[k], y[k]), 12582912.0f));
}

// the low bytes of four words, in order, as one word
__device__ __forceinline__ uint32_t low_bytes(const uint32_t* b) {
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040u),
                     __byte_perm(b[2], b[3], 0x0040u), 0x5410u);
}

// W words at p (4W-byte aligned on the vector path), the first n bytes of
// them on the scalar one
template <int W>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t* w,
                                            bool vec, int n) {
  if (vec) {
    if constexpr (W == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
    return;
  }
#pragma unroll
  for (int k = 0; k < 4 * W; ++k)
    if (k < n) p[k] = (uint8_t)(w[k / 4] >> (8 * (k % 4)));
}

template <typename T, int BITS>
__global__ void __launch_bounds__(KVQ_THREADS) kv_quantize_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ packed,
    float* __restrict__ scale, int n_tok, int C, bool vec) {
  using Q = QTile<T>;
  constexpr int V = Q::V;
  constexpr float qmax = BITS == 8 ? 127.f : 7.f;
  __shared__ float red[KVQ_THREADS / 32][Q::CH];
  __shared__ float sc[Q::CH], rc[Q::CH];
  const int cv = threadIdx.x % Q::ACROSS, g = threadIdx.x / Q::ACROSS;
  const int c0 = blockIdx.x * Q::CH, c = c0 + cv * V;
  const int n = max(0, min(V, C - c));           // this thread's channels
  const int n_chunks = (n_tok + Q::RESIDENT - 1) / Q::RESIDENT;

  // rows 2 (ch * RESIDENT / 2 + g + GROUPS * (i / 2)) + i % 2 of chunk ch
  Chunk16<T> v[2 * KVQ_HOLD];
  auto load = [&](int ch) {
#pragma unroll
    for (int i = 0; i < 2 * KVQ_HOLD; ++i)
      v[i] = load_chunk(
          x, 2 * (ch * (Q::RESIDENT / 2) + g + Q::GROUPS * (i / 2)) + i % 2,
          c, n, n_tok, C, vec);
  };
  typename Chunk16<T>::Max am;
  for (int ch = 0; ch < n_chunks; ++ch) {
    load(ch);
#pragma unroll
    for (int i = 0; i < 2 * KVQ_HOLD; ++i) am.add(v[i]);
  }
  // a warp's lanes are 32 / ACROSS groups x ACROSS chunk columns: fold the
  // groups, then the warps in shared memory
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float mx[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mx[k] = am.get(k);
#pragma unroll
    for (int o = Q::ACROSS; o < 32; o <<= 1)
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
  }
  if (lane < Q::ACROSS)
#pragma unroll
    for (int k = 0; k < V; ++k) red[warp][lane * V + k] = mx[k];
  __syncthreads();
  if (threadIdx.x < Q::CH) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < KVQ_THREADS / 32; ++w)
      m = fmaxf(m, red[w][threadIdx.x]);
    const float s = scale_of(m, qmax);
    sc[threadIdx.x] = s;
    // 0 where levels must take quant() (outside div_rn_fma's range)
    rc[threadIdx.x] = s >= 0x1p-90f && s <= 0x1p100f ? __frcp_rn(s) : 0.f;
    if (c0 + (int)threadIdx.x < C) scale[c0 + threadIdx.x] = s;
  }
  __syncthreads();
  if (n == 0) return;
  float s[V], y[V];
  bool exact = false;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = sc[cv * V + k];
    y[k] = rc[cv * V + k];
    exact |= y[k] == 0.f;
  }
  // the held rows' levels and stores, the division-free levels unless a
  // scale of this thread's is outside their range (branch once a chunk)
  auto quantize = [&](int ch, auto exact_t) {
#pragma unroll
    for (int i = 0; i < KVQ_HOLD; ++i) {
      const int p = ch * (Q::RESIDENT / 2) + g + Q::GROUPS * i;
      uint32_t l[2][V], w[V / 4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        levels<decltype(exact_t)::value>(l[h], v[2 * i + h], s, y, qmax);
      if constexpr (BITS == 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (2 * p + h < n_tok) {
#pragma unroll
            for (int j = 0; j < V / 4; ++j) w[j] = low_bytes(l[h] + 4 * j);
            store_words<V / 4>(packed + (int64_t)(2 * p + h) * C + c, w, vec,
                               n);
          }
      } else if (2 * p < n_tok) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          l[0][k] = (l[0][k] & 0xFu) | ((l[1][k] & 0xFu) << 4);
#pragma unroll
        for (int j = 0; j < V / 4; ++j) w[j] = low_bytes(l[0] + 4 * j);
        store_words<V / 4>(packed + (int64_t)p * C + c, w, vec, n);
      }
    }
  };
  // the last chunk is still held; an earlier one is read again
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    if (ch != n_chunks - 1) load(ch);
    if (exact)
      quantize(ch, std::true_type{});
    else
      quantize(ch, std::false_type{});
  }
}

// -- dequantize ---------------------------------------------------------------

// four levels, one a byte of `biased` (each the level plus `bias` less
// 1.5 * 2^23, in 0..255), as exact floats: the byte under the exponent of
// 1.5 * 2^23 (0x4B40'00bb) is 1.5 * 2^23 + byte, and the subtraction is
// exact
__device__ __forceinline__ void level_floats4(uint32_t biased, float bias,
                                              float* f) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __fsub_rn(
        __uint_as_float(__byte_perm(biased, 0x4B400000u, 0x7640u + k)), bias);
}

// V packed bytes of a row at p (V-byte aligned on the vector path), as
// V / 4 words; the first n of them on the scalar path
template <int V>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[V / 4],
                                           const uint8_t* p, bool vec,
                                           int n) {
  if (vec) {
    if constexpr (V == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    w[j] = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < n) w[j] |= (uint32_t)p[4 * j + k] << (8 * k);
  }
}

// one token row's V values times their scales, rounded once to the
// output: 16 bytes at p (16-byte aligned) on the vector path
__device__ __forceinline__ void store_row(float* p, const float (&o)[4],
                                          bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < n) p[k] = o[k];
}

__device__ __forceinline__ void store_row(__nv_bfloat16* p,
                                          const float (&o)[8], bool vec,
                                          int n) {
  if (vec) {
    uint32_t h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
      h[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < n) p[k] = __float2bfloat16_rn(o[k]);
}

template <typename To, int BITS>
__global__ void __launch_bounds__(KVDQ_THREADS) kv_dequantize_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ scale,
    To* __restrict__ out, int n_tok, int C, bool vec) {
  constexpr int V = 16 / sizeof(To);              // channels a lane owns
  constexpr int NR = BITS == 8 ? KVDQ_ROWS : KVDQ_ROWS / 2;  // packed rows
  constexpr int SPAN = KVDQ_WARPS * NR;           // packed rows a block
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * (32 * V) + lane * V;
  const int n = max(0, min(V, C - c));
  if (n == 0) return;
  const int rows = BITS == 8 ? n_tok : n_tok / 2;
  float s[V];
  if (vec) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(scale + c) + j);
      s[4 * j] = t.x;
      s[4 * j + 1] = t.y;
      s[4 * j + 2] = t.z;
      s[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = k < n ? __ldg(scale + c + k) : 0.f;
  }
  for (int r0 = blockIdx.y * SPAN + warp; r0 < rows; r0 += gridDim.y * SPAN) {
    uint32_t w[NR][V / 4];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = r0 + i * KVDQ_WARPS;
      if (r < rows) load_bytes<V>(w[i], packed + (int64_t)r * C + c, vec, n);
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = r0 + i * KVDQ_WARPS;
      if (r >= rows) continue;
      if constexpr (BITS == 8) {
        float o[V];
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          level_floats4(w[i][j] ^ 0x80808080u, 12583040.0f, o + 4 * j);
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = __fmul_rn(o[k], s[k]);
        store_row(out + (int64_t)r * C + c, o, vec, n);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {         // token 2r (low nibbles), 2r+1
          float o[V];
#pragma unroll
          for (int j = 0; j < V / 4; ++j)
            level_floats4(
                ((w[i][j] >> (4 * h)) & 0x0F0F0F0Fu) ^ 0x08080808u,
                12582920.0f, o + 4 * j);
#pragma unroll
          for (int k = 0; k < V; ++k) o[k] = __fmul_rn(o[k], s[k]);
          store_row(out + (int64_t)(2 * r + h) * C + c, o, vec, n);
        }
      }
    }
  }
}

template <typename Ti>
static int quant_typed(const void* x, void* packed, float* scale, int T,
                       int C, int bits, bool vec, cudaStream_t st) {
  const unsigned blocks =
      (unsigned)((C + QTile<Ti>::CH - 1) / QTile<Ti>::CH);
  auto* xi = static_cast<const Ti*>(x);
  auto* q = static_cast<uint8_t*>(packed);
  if (bits == 8)
    kv_quantize_kernel<Ti, 8><<<blocks, KVQ_THREADS, 0, st>>>(xi, q, scale, T,
                                                              C, vec);
  else
    kv_quantize_kernel<Ti, 4><<<blocks, KVQ_THREADS, 0, st>>>(xi, q, scale, T,
                                                              C, vec);
  return (int)cudaGetLastError();
}

template <typename To>
static void dequant_typed(const void* packed, const float* scale, void* out,
                          int T, int C, int bits, cudaStream_t st) {
  constexpr int V = 16 / sizeof(To);
  const bool vec = C % V == 0 && (uintptr_t)packed % V == 0 &&
                   aligned16(scale) && aligned16(out);
  const int rows = bits == 8 ? T : T / 2;
  const int span = KVDQ_WARPS * (bits == 8 ? KVDQ_ROWS : KVDQ_ROWS / 2);
  const int row_blocks = (rows + span - 1) / span;
  const dim3 grid((unsigned)((C + 32 * V - 1) / (32 * V)),
                  (unsigned)(row_blocks < 65535 ? row_blocks : 65535));
  auto* q = static_cast<const uint8_t*>(packed);
  auto* o = static_cast<To*>(out);
  if (bits == 8)
    kv_dequantize_kernel<To, 8><<<grid, KVDQ_THREADS, 0, st>>>(
        q, scale, o, T, C, vec);
  else
    kv_dequantize_kernel<To, 4><<<grid, KVDQ_THREADS, 0, st>>>(
        q, scale, o, T, C, vec);
}

extern "C" {

// x (T, C) f32 or bf16 -> packed (T, C) int8 [bits 8] or (T/2, C) uint8
// [bits 4, T even], scale (1, C) f32
int kv_quant_launch(const void* x, int x_dtype, void* packed, float* scale,
                    int T, int C, int bits, void* stream) {
  if ((bits != 8 && bits != 4) || (bits == 4 && T % 2))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  // a thread stores 16 / sizeof(x) packed bytes a row at once
  const int lane_bytes = x_dtype == DT_BF16 ? 8 : 4;
  const bool vec = C % lane_bytes == 0 && aligned16(x) &&
                   (uintptr_t)packed % lane_bytes == 0;
  if (x_dtype == DT_BF16)
    return quant_typed<__nv_bfloat16>(x, packed, scale, T, C, bits, vec, st);
  if (x_dtype == DT_F32)
    return quant_typed<float>(x, packed, scale, T, C, bits, vec, st);
  return (int)cudaErrorInvalidValue;
}

// packed (T, C) int8 [bits 8] or (T/2, C) uint8 [bits 4, T even], scale
// (1, C) f32 -> out (T, C) f32 or bf16
int kv_dequant_launch(const void* packed, const float* scale, void* out,
                      int out_dtype, int T, int C, int bits, void* stream) {
  if ((bits != 8 && bits != 4) || (bits == 4 && T % 2))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)T * C == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == DT_BF16)
    dequant_typed<__nv_bfloat16>(packed, scale, out, T, C, bits, st);
  else if (out_dtype == DT_F32)
    dequant_typed<float>(packed, scale, out, T, C, bits, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
