// Second pass of the fused decode kernels (repro_torch/kernels/
// fused_decode.py): the adapter "expand" of the o-projection delta.
//
// Replaces the last-head epilogue (_expand / _expand_out) of the TPU
// kernels kernels/fused_decode.py::fused_decode_lora / fused_decode_jd.
// On the TPU the rank-r accumulator t lives in scratch across the
// sequential kv-head axis; here decode_attention.cu writes one partial per
// (b, kv-head) and this kernel, one block per (b, d_out tile), sums them in
// head order h = 0..Kv-1 (so the result repeats bit for bit), applies Sigma
// (JD only: diag (n, r) or full (n, r, r)), and expands:
//
//   delta[b, o] = (sum_j t[j] * W[w_idx, o, j]) * w_scale[w_idx, o]
//
// with W = B (n, d_out, r), w_idx = ids[b] for raw LoRA, and W = U
// (k, d_out, r), w_idx = cluster_of[ids[b]] for JD.  Banks are f32, bf16
// or int8 (with their per-output-channel scales; ones for fp banks).
//
// Bound on an H100: memory, d_out * r bank elements per slot and the
// (B, d_out) f32 output, a few hundred KB per layer: the launch itself
// (a few microseconds) outweighs the bytes at mistral-7b's width.  One
// thread per output channel reads its r contiguous weights.

#include "common.cuh"

#define EXPAND_THREADS 256
#define RMAX 128

__global__ void __launch_bounds__(EXPAND_THREADS) fused_expand_kernel(
    const float* __restrict__ partial, int Kv, int r,
    const int* __restrict__ ids, const int* __restrict__ cluster_of,
    const void* __restrict__ sigma, int sigma_dtype, int sigma_full,
    const void* __restrict__ w, int w_dtype,
    const float* __restrict__ w_scale, int d_out,
    float* __restrict__ delta) {
  __shared__ float t_s[RMAX];
  __shared__ float u_s[RMAX];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int id = ids[b];
  const int w_idx = cluster_of == nullptr ? id : cluster_of[id];

  if (tid < r) {
    float t = 0.f;
    for (int h = 0; h < Kv; ++h)
      t = __fadd_rn(t, partial[((int64_t)b * Kv + h) * r + tid]);
    t_s[tid] = t;
  }
  __syncthreads();
  if (sigma != nullptr && tid < r) {
    float u;
    if (sigma_full) {            // u[q] = sum_j t[j] * Sigma[id, j, q]
      u = 0.f;
      for (int j = 0; j < r; ++j)
        u = __fmaf_rn(t_s[j],
                      load_any(sigma, ((int64_t)id * r + j) * r + tid,
                               sigma_dtype), u);
    } else {                     // u[j] = t[j] * sigma[id, j]
      u = __fmul_rn(t_s[tid],
                    load_any(sigma, (int64_t)id * r + tid, sigma_dtype));
    }
    u_s[tid] = u;
  }
  __syncthreads();
  const float* t = sigma != nullptr ? u_s : t_s;

  const int o = blockIdx.y * EXPAND_THREADS + tid;
  if (o >= d_out) return;
  const int64_t row = ((int64_t)w_idx * d_out + o) * r;
  float acc = 0.f;
  for (int j = 0; j < r; ++j)
    acc = __fmaf_rn(t[j], load_any(w, row + j, w_dtype), acc);
  delta[(int64_t)b * d_out + o] =
      __fmul_rn(acc, w_scale[(int64_t)w_idx * d_out + o]);
}

extern "C" {

// partial (B, Kv, r) f32 -> delta (B, d_out) f32.  cluster_of null: raw
// LoRA (W = B[ids]); set: JD (W = U[cluster_of[ids]], Sigma[ids]).
int fused_expand_launch(const float* partial, const int* ids,
                        const int* cluster_of, const void* sigma,
                        int sigma_dtype, int sigma_full, const void* w,
                        int w_dtype, const float* w_scale, float* delta,
                        int B, int Kv, int r, int d_out, void* stream) {
  if (r > RMAX) return (int)cudaErrorInvalidValue;
  dim3 grid(B, (d_out + EXPAND_THREADS - 1) / EXPAND_THREADS);
  fused_expand_kernel<<<grid, EXPAND_THREADS, 0, (cudaStream_t)stream>>>(
      partial, Kv, r, ids, cluster_of, sigma, sigma_dtype, sigma_full, w,
      w_dtype, w_scale, d_out, delta);
  return (int)cudaGetLastError();
}

}  // extern "C"
