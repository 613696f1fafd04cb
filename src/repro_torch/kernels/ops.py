"""Entry points over the port's kernels (the port of ``kernels/ops.py``):
token-flattened multi-adapter application and decode attention.

They dispatch on the tensors' device, not on a global backend: a CPU
tensor runs the plain version, a CUDA tensor the Hopper kernels (or the
wrapper raises).  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref
from .flash_decode import flash_decode
from .fused_decode import fused_decode_jd, fused_decode_lora
from .jd_apply import jd_apply as _jd_apply_tiles
from .sgmv import sgmv_expand, sgmv_shrink


def _scatter_valid(y, perm, valid, T: int) -> torch.Tensor:
    """Rows of the grouped result back in token order: every token has
    exactly one valid row, so an index copy of the valid rows is the TPU's
    masked scatter-add onto zeros."""
    keep = valid.bool()
    out = torch.zeros((T, y.shape[1]), dtype=y.dtype, device=y.device)
    out[perm[keep].long()] = y[keep]
    return out


def lora_apply(x, A, B, ids, *, tile: int = 128, scaling: float = 1.0):
    """Uncompressed multi-LoRA delta on flattened tokens (the baseline
    path): x (T, d_in); A (n, r, d_in); B (n, d_out, r); ids (T,).
    Tokens are grouped by adapter on the host (one copy of ``ids``), the
    grouped shrink and expand run, and the valid rows are scattered back.
    Returns (T, d_out) in x's dtype."""
    _build.refuse("lora_apply", x, A, B, ids)
    if x.device.type == "cpu":
        return ref.lora_apply_ref(x, A, B, ids, scaling)
    return lora_apply_grouped(x, A, B, ids, tile=tile, scaling=scaling)


def lora_apply_grouped(x, A, B, ids, *, tile: int = 128,
                       scaling: float = 1.0):
    """:func:`lora_apply`'s grouped path on any device (on the CPU each
    stage runs its plain version): what the TPU's non-``ref`` path does."""
    _build.refuse("lora_apply_grouped", x, A, B, ids)
    perm, tile_ids, valid = ref.group_tokens_by_adapter(ids, A.shape[0],
                                                        tile)
    xg = x[perm.long()]
    t = sgmv_shrink(xg, A, tile_ids, block_t=tile)
    y = sgmv_expand(t.to(x.dtype), B, tile_ids, block_t=tile)
    return _scatter_valid(y, perm, valid, x.shape[0]) * scaling


def jd_apply(x, U, V, sigma, cluster_of, ids, *, tile: int = 128):
    """Compressed (JD) multi-LoRA delta on flattened tokens: U (k, d_out,
    r); V (k, d_in, r); sigma (n, r) diag or (n, r, r) full; cluster_of
    (n,); ids (T,).  Returns (T, d_out) in x's dtype.

    A full Sigma is applied as ``t @ Sigma``, i.e. ``U Sigma^T V^T x``, as
    in the JAX package; compression's ``Sigma_i = U^T B_i A_i V`` needs its
    transpose here to reproduce ``B_i A_i x``."""
    _build.refuse("jd_apply", x, U, V, sigma, cluster_of, ids)
    if x.device.type == "cpu":
        return ref.jd_apply_ref(x, U, V, sigma, cluster_of, ids)
    return jd_apply_grouped(x, U, V, sigma, cluster_of, ids, tile=tile)


def jd_apply_grouped(x, U, V, sigma, cluster_of, ids, *, tile: int = 128):
    """:func:`jd_apply`'s grouped path on any device."""
    _build.refuse("jd_apply_grouped", x, U, V, sigma, cluster_of, ids)
    perm, tile_ids, valid = ref.group_tokens_by_adapter(ids, sigma.shape[0],
                                                        tile)
    pl = perm.long()
    tile_cids = cluster_of[tile_ids.long()].to(torch.int32)
    y = _jd_apply_tiles(x[pl], U, V, sigma, ids[pl], tile_cids, tile_ids)
    return _scatter_valid(y, perm, valid, x.shape[0])


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
