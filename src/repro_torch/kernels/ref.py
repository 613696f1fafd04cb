"""Plain PyTorch versions of the port's kernels (the port of the matching
functions of ``kernels/ref.py``).

They are what a wrapper runs for a tensor on the CPU, and what
``chip_smoke.py`` and the GPU tests hold each CUDA kernel against on the
card.  They repeat the kernels' arithmetic in f32 and are no yardstick of
speed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
QMAX8 = 127


def _attend(q, k, v, kv_len):
    """Decode attention in f32: (out (B, H, hd) f32, l, m)."""
    B, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qf = q.reshape(B, Kv, G, hd).float() * (hd ** -0.5)
    logits = torch.einsum("bkgh,bskh->bkgs", qf, k.float())
    if kv_len is not None:
        mask = (torch.arange(S, device=q.device)[None, :]
                < kv_len.reshape(-1, 1).to(q.device))
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.tensor(NEG_INF, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p / l, v.float())
    return out.reshape(B, H, hd), l, m


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention.  q: (B, H, hd); k/v: (B, S, Kv, hd); kv_len (B,).

    Returns (out (B, H, hd) in q's dtype, l (B, Kv, G, 1) f32,
    m (B, Kv, G, 1) f32): the softmax denominator and running max, as
    ``flash_decode`` returns them for a cross-shard merge."""
    out, l, m = _attend(q, k, v, kv_len)
    return out.to(q.dtype), l, m


def _attend_for_delta(q, k, v, kv_len, f32_delta: bool):
    """(out in q's dtype, the flattened f32 output the delta contracts):
    the rounded ``out`` as ``kernels/ref.py`` takes it, or with
    ``f32_delta`` the f32 output before the cast, as the kernels take it
    (``_finalized_attn`` on the TPU)."""
    of, _, _ = _attend(q, k, v, kv_len)
    out = of.to(q.dtype)
    src = of if f32_delta else out.float()
    return out, src.reshape(src.shape[0], -1)


def _deq(w: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    wf = w.float()
    return wf if scale is None else wf * scale.float()


def fused_decode_lora_ref(q, k, v, kv_len, ids, A, B, a_scale=None,
                          b_scale=None, f32_delta: bool = False):
    """Decode attention, then the per-slot LoRA delta on the flattened
    (H*hd) attention output, rounded to q's dtype unless ``f32_delta``.
    A: (n, r, H*hd); B: (n, d_out, r); optional per-channel scales
    dequantize int8 banks.  Returns (out (B, H, hd), delta (B, d_out)
    f32)."""
    out, of = _attend_for_delta(q, k, v, kv_len, f32_delta)
    ids = ids.long()
    t = torch.einsum("bd,brd->br", of, _deq(A, a_scale)[ids])
    delta = torch.einsum("br,bor->bo", t, _deq(B, b_scale)[ids])
    return out, delta


def fused_decode_jd_ref(q, k, v, kv_len, ids, U, V, sigma, cluster_of,
                        u_scale=None, v_scale=None, f32_delta: bool = False):
    """Decode attention, then the compressed shared-basis delta
    (V^T -> Sigma -> U) with per-slot sigma ((n, r) diag or (n, r, r)
    full) and per-cluster bases U (k, d_out, r), V (k, H*hd, r); the
    attention output as in :func:`fused_decode_lora_ref`."""
    out, of = _attend_for_delta(q, k, v, kv_len, f32_delta)
    ids = ids.long()
    cid = cluster_of.long()[ids]
    t = torch.einsum("bd,bdr->br", of, _deq(V, v_scale)[cid])
    sig = sigma[ids].float()
    if sig.ndim == 2:                        # JD-Diag: (B, r)
        t = t * sig
    else:                                    # JD-Full: (B, r, r)
        t = torch.einsum("br,brq->bq", t, sig)
    delta = torch.einsum("br,bor->bo", t, _deq(U, u_scale)[cid])
    return out, delta


def adapter_quant_ref(w: torch.Tensor, axis: int = -1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: one f32 scale per channel,
    reduced over the matrix's input ``axis`` (keepdims); round half to
    even, as ``jnp.round``."""
    xf = w.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    qmax = torch.full_like(absmax, float(QMAX8))
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -QMAX8, QMAX8)
    return q.to(torch.int8), scale


def adapter_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                        out_dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(out_dtype)
