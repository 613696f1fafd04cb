"""Decode attention: one query token per sequence against its KV cache.

Replaces the TPU kernel ``kernels/flash_decode.py::flash_decode`` (body
``_decode_kernel``) with the hand-written Hopper kernel of
``csrc/decode_attention.cu``.  What bounds it on an H100 is memory: each
(b, kv-head) streams its valid K/V prefix once, ~2*G flops per byte.  The
kernel runs one block per (b, kv-head), walks only the ``kv_len[b]`` valid
positions (the TPU kernel computes masked blocks too), and reads K/V
through their batch and row strides, so a slice of a larger cache is read
in place, never copied.

A CPU tensor goes to the plain version (``ref.flash_decode_ref``); a CUDA
tensor launches the kernel or raises.  ``kv_len`` must be >= 1 per row.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref

LAUNCHES = 0             # kernel launches since the last reset
MAX_SMEM = 48 * 1024
TILE_S = 64              # csrc/decode_attention.cu
ATTN_THREADS = 128


def attn_smem_bytes(G: int, hd: int) -> int:
    return 4 * (2 * G * hd + G * TILE_S + 3 * G + ATTN_THREADS)


def check_attention_args(q, k, v, kv_len):
    """Validate q (B, H, hd), k/v (B, S, Kv, hd) views and kv_len (B,);
    returns (B, H, Kv, hd, S)."""
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q must be (B, H, hd) and k/v (B, S, Kv, hd)")
    B, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    S, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"{H} heads do not group over {Kv} kv heads")
    if hd > 256:
        raise ValueError(f"head_dim {hd} > 256")
    if attn_smem_bytes(H // Kv, hd) > MAX_SMEM:
        raise ValueError("head group too large for one block's shared memory")
    for t in (q, k, v, kv_len):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all operands must be on q's CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype not in (torch.bfloat16, torch.float32) or \
            v.dtype != k.dtype:
        raise TypeError("q and k/v must be bf16 or f32 (k and v alike)")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError("k/v rows must be contiguous (Kv, hd)")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,) or \
            not kv_len.is_contiguous():
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor")
    return B, H, Kv, hd, S


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor):
    """q: (B, H, hd); k/v: (B, S, Kv, hd); kv_len: (B,) int32.

    Returns (out (B, H, hd) in q's dtype, l (B, Kv, G, 1) f32,
    m (B, Kv, G, 1) f32), as the JAX function does."""
    global LAUNCHES
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len)
    B, H, Kv, hd, S = check_attention_args(q, k, v, kv_len)
    G = H // Kv
    out = torch.empty_like(q)
    l = torch.empty((B, Kv, G, 1), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Kv, G, 1), dtype=torch.float32, device=q.device)
    err = _build.lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), l.data_ptr(), m.data_ptr(), B, H, Kv, hd, S,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), hd ** -0.5,
        _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_decode")
    LAUNCHES += 1
    return out, l, m
