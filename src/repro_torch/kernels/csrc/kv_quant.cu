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
// common.cuh: __fdiv_rn, rintf; never --use_fast_math).
//
// Bound on an H100: memory.  Quantize reads the block once (bf16: 2 bytes
// a value) and writes 1 (int8) or 1/2 (int4) byte a value plus the scales;
// dequantize the reverse.  Quantize: one block per tile of 32 channels and
// all T tokens, so the absmax reduction stays in the block (as
// quant_cols_kernel of adapter_quant.cu): 8 token groups of 32 threads,
// each warp on 32 adjacent channels of one token; under int4 each thread
// packs its channel's token pairs.  Dequantize: a grid-stride loop, one
// output value per thread per step, consecutive threads on consecutive
// channels.  A first version: each warp moves 64 bytes of a bf16 row at a
// time, and quantize reads x twice (the second read mostly from L2).

#include "common.cuh"

#define KVQ_TILE 32
#define KVQ_GROUPS 8
#define KVDQ_THREADS 256

template <typename T>
__global__ void __launch_bounds__(KVQ_TILE * KVQ_GROUPS) kv_quantize_kernel(
    const T* __restrict__ x, void* __restrict__ packed,
    float* __restrict__ scale, int n_tok, int C, int bits) {
  __shared__ float red[KVQ_GROUPS][KVQ_TILE];
  const int col = threadIdx.x % KVQ_TILE;
  const int grp = threadIdx.x / KVQ_TILE;
  const int j = blockIdx.x * KVQ_TILE + col;
  const float qmax = bits == 8 ? 127.f : 7.f;
  float mx = 0.f;
  if (j < C)
    for (int t = grp; t < n_tok; t += KVQ_GROUPS)
      mx = fmaxf(mx, fabsf(to_f(x[(int64_t)t * C + j])));
  red[grp][col] = mx;
  __syncthreads();
  for (int g = 0; g < KVQ_GROUPS; ++g) mx = fmaxf(mx, red[g][col]);
  if (j >= C) return;
  const float s = scale_of(mx, qmax);
  if (bits == 8) {
    int8_t* q = static_cast<int8_t*>(packed);
    for (int t = grp; t < n_tok; t += KVQ_GROUPS) {
      const int64_t e = (int64_t)t * C + j;
      q[e] = (int8_t)quant(to_f(x[e]), s, qmax);
    }
  } else {
    uint8_t* q = static_cast<uint8_t*>(packed);
    for (int p = grp; p < n_tok / 2; p += KVQ_GROUPS) {
      const int64_t e = (int64_t)(2 * p) * C + j;
      const unsigned lo = (unsigned)quant(to_f(x[e]), s, qmax) & 0xFu;
      const unsigned hi = (unsigned)quant(to_f(x[e + C]), s, qmax) & 0xFu;
      q[(int64_t)p * C + j] = (uint8_t)(lo | (hi << 4));
    }
  }
  if (grp == 0) scale[j] = s;
}

template <typename T>
__global__ void __launch_bounds__(KVDQ_THREADS) kv_dequantize_kernel(
    const void* __restrict__ packed, const float* __restrict__ scale,
    T* __restrict__ out, int64_t total, int C, int bits) {
  const int64_t stride = (int64_t)gridDim.x * KVDQ_THREADS;
  for (int64_t e = (int64_t)blockIdx.x * KVDQ_THREADS + threadIdx.x;
       e < total; e += stride) {
    const int j = (int)(e % C);
    int v;
    if (bits == 8) {
      v = static_cast<const int8_t*>(packed)[e];
    } else {
      const int64_t t = e / C;
      const int byte = static_cast<const uint8_t*>(packed)[(t >> 1) * C + j];
      const int nib = ((t & 1) ? (byte >> 4) : byte) & 0xF;
      v = (nib ^ 8) - 8;
    }
    out[e] = from_f<T>(__fmul_rn((float)v, scale[j]));
  }
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
  const unsigned blocks = (unsigned)((C + KVQ_TILE - 1) / KVQ_TILE);
  if (x_dtype == DT_BF16)
    kv_quantize_kernel<__nv_bfloat16><<<blocks, KVQ_TILE * KVQ_GROUPS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), packed, scale, T, C, bits);
  else if (x_dtype == DT_F32)
    kv_quantize_kernel<float><<<blocks, KVQ_TILE * KVQ_GROUPS, 0, st>>>(
        static_cast<const float*>(x), packed, scale, T, C, bits);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// packed (T, C) int8 [bits 8] or (T/2, C) uint8 [bits 4], scale (1, C) f32
//   -> out (T, C) f32 or bf16
int kv_dequant_launch(const void* packed, const float* scale, void* out,
                      int out_dtype, int T, int C, int bits, void* stream) {
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)T * C;
  if (total == 0) return (int)cudaSuccess;
  const int64_t want = (total + KVDQ_THREADS - 1) / KVDQ_THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == DT_BF16)
    kv_dequantize_kernel<__nv_bfloat16><<<blocks, KVDQ_THREADS, 0, st>>>(
        packed, scale, static_cast<__nv_bfloat16*>(out), total, C, bits);
  else if (out_dtype == DT_F32)
    kv_dequantize_kernel<float><<<blocks, KVDQ_THREADS, 0, st>>>(
        packed, scale, static_cast<float*>(out), total, C, bits);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
