// Shared helpers of the port's CUDA kernels: typed loads, warp reductions,
// exact quantization and 16-byte asynchronous copies.
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
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

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

// -- asynchronous copies (sm_80+ PTX, used on sm_90a) -----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; the destination is zero-filled
// past src_bytes (0 or 16), so a masked copy reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static __host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16 bytes (16-byte aligned) as f32: eight bf16 or four f32 values
static __device__ __forceinline__ void unpack16(const void* p,
                                                float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

static __device__ __forceinline__ void unpack16(const void* p,
                                                float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

// -- tensor-core building blocks (sm_80+ PTX, used on sm_90a) ---------------

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16x8 f32) = a (16x16 bf16, row) . b (16x8 bf16, col), from a zero C
__device__ __forceinline__ void mma_bf16_zero_c(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 value as three bf16 pieces, h + m + l: each piece is the rounded
// remainder of the ones before it (the remainders are exact in f32), and
// 8 + 8 + 8 bits hold the value's 24, so the pieces sum to it exactly
// (below ~1e-25 the last piece underflows and drops low bits); each
// piece's product with a bf16 value is exact in f32.
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1])));
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
      | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
