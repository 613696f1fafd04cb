"""Decode-path entry points over the port's kernels (the port of the
decode half of ``kernels/ops.py``).

They dispatch on the tensors' device, not on a global backend: a CPU
tensor runs the plain version, a CUDA tensor the Hopper kernel (or the
wrapper raises).  There is no fallback from one to the other.
"""
from __future__ import annotations

from .flash_decode import flash_decode
from .fused_decode import fused_decode_jd, fused_decode_lora


def decode_attention(q, k, v, kv_len):
    """Decode attention (one token per sequence); returns out (B, H, hd)."""
    out, _, _ = flash_decode(q, k, v, kv_len)
    return out


def fused_lora_decode(q, k, v, kv_len, ids, A, B, a_scale=None,
                      b_scale=None):
    """Decode attention + per-slot raw-LoRA output delta; returns
    (out (B, H, hd), delta (B, d_out) f32)."""
    return fused_decode_lora(q, k, v, kv_len, ids, A, B, a_scale, b_scale)


def fused_jd_decode(q, k, v, kv_len, ids, U, V, sigma, cluster_of,
                    u_scale=None, v_scale=None):
    """Decode attention + compressed shared-basis output delta."""
    return fused_decode_jd(q, k, v, kv_len, ids, U, V, sigma, cluster_of,
                           u_scale, v_scale)
