// Shared helpers of the port's CUDA kernels: typed loads, warp reductions.
//
// Banks and their scales arrive in one of three element types, picked at
// run time by a small code (uniform across a block, so the switch costs a
// predicted branch):
//   DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DT_F32 0
#define DT_BF16 1
#define DT_I8 2

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// element i of a bank of element type `code`, as f32
__device__ __forceinline__ float load_any(const void* p, int64_t i,
                                          int code) {
  if (code == DT_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == DT_I8) return (float)static_cast<const int8_t*>(p)[i];
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Symmetric quantization shared by adapter_quant.cu and kv_quant.cu: the
// scale of a channel whose absmax is `absmax` (1 where it is 0), and one
// value's level in [-qmax, qmax].  Exact, as the plain versions: IEEE
// division (__fdiv_rn; these files are never built with --use_fast_math)
// and rounding half to even (rintf, as jnp.round and torch.round; never
// roundf, which rounds half away from zero).
__device__ __forceinline__ float scale_of(float absmax, float qmax) {
  return absmax > 0.f ? __fdiv_rn(absmax, qmax) : 1.0f;
}

__device__ __forceinline__ int quant(float x, float scale, float qmax) {
  const float qv = rintf(__fdiv_rn(x, scale));
  return (int)fminf(fmaxf(qv, -qmax), qmax);
}
