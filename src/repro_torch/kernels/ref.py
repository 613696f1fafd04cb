"""Plain PyTorch versions of the port's kernels (the port of the matching
functions of ``kernels/ref.py``).

They are what a wrapper runs for a tensor on the CPU, and what
``chip_smoke.py`` and the GPU tests hold each CUDA kernel against on the
card.  They repeat the kernels' arithmetic in f32 and are no yardstick of
speed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
# symmetric quantization's largest level per bit width (kv_quant.QMAX)
QMAX = {8: 127, 4: 7}


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


# -- paged KV ------------------------------------------------------------------


def gather_pages_ref(pages: torch.Tensor, page_table: torch.Tensor
                     ) -> torch.Tensor:
    """A contiguous KV layout from a paged pool.

    pages: (P, page_t, Kv, hd) physical pages; page_table: (B, n_blocks)
    int32, sequence b's logical block s in page ``page_table[b, s]``.
    Returns (B, n_blocks * page_t, Kv, hd), the layout the contiguous
    functions take."""
    B, n_blocks = page_table.shape
    g = pages[page_table.long()]             # (B, n_blocks, page_t, Kv, hd)
    return g.reshape(B, n_blocks * pages.shape[1], *pages.shape[2:])


def flash_decode_paged_ref(q, k_pages, v_pages, page_table, kv_len=None):
    """Paged decode attention: gather to contiguous, then
    :func:`flash_decode_ref`; returns (out, l, m) as it does."""
    return flash_decode_ref(q, gather_pages_ref(k_pages, page_table),
                            gather_pages_ref(v_pages, page_table), kv_len)


def fused_decode_lora_paged_ref(q, k_pages, v_pages, page_table, kv_len,
                                ids, A, B, a_scale=None, b_scale=None,
                                f32_delta: bool = False):
    """:func:`fused_decode_lora_ref` over a paged pool."""
    return fused_decode_lora_ref(
        q, gather_pages_ref(k_pages, page_table),
        gather_pages_ref(v_pages, page_table), kv_len, ids, A, B, a_scale,
        b_scale, f32_delta)


def fused_decode_jd_paged_ref(q, k_pages, v_pages, page_table, kv_len, ids,
                              U, V, sigma, cluster_of, u_scale=None,
                              v_scale=None, f32_delta: bool = False):
    """:func:`fused_decode_jd_ref` over a paged pool."""
    return fused_decode_jd_ref(
        q, gather_pages_ref(k_pages, page_table),
        gather_pages_ref(v_pages, page_table), kv_len, ids, U, V, sigma,
        cluster_of, u_scale, v_scale, f32_delta)


def adapter_quant_ref(w: torch.Tensor, axis: int = -1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: one f32 scale per channel,
    reduced over the matrix's input ``axis`` (keepdims); round half to
    even, as ``jnp.round``."""
    xf = w.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    qmax = torch.full_like(absmax, float(QMAX[8]))
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -QMAX[8], QMAX[8])
    return q.to(torch.int8), scale


def adapter_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                        out_dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(out_dtype)


# -- KV wire quantization -------------------------------------------------------


def kv_quant_ref(x: torch.Tensor, bits: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric quantization of a KV block x (T, C): one f32
    scale per channel (absmax over the T tokens / qmax, 1 where the
    channel is 0), values rounded half to even and clipped to [-qmax,
    qmax].  Returns (q (T, C) int8, scale (1, C) f32); int4 values are
    held in int8 here (:func:`pack_int4` packs them)."""
    qm = QMAX[bits]
    xf = x.float()
    absmax = xf.abs().amax(dim=0, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    qmax = torch.full_like(absmax, float(qm))
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -qm, qm)
    return q.to(torch.int8), scale


def kv_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Values (T, C) int8 times per-channel scales, rounded once to
    ``out_dtype``."""
    return (q.float() * scale.float()).to(out_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (T, C) in int8, T even -> (T/2, C) uint8: each token
    pair's two's-complement nibbles in one byte, the even token low."""
    qi = q.to(torch.int32) & 0xF
    return (qi[0::2] | (qi[1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (T/2, C) uint8 -> (T, C) int8, each
    nibble sign-extended as ``((v & 0xF) ^ 8) - 8``."""
    v = packed.to(torch.int32)
    lo = ((v & 0xF) ^ 8) - 8
    hi = ((v >> 4) ^ 8) - 8
    rows, C = v.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * rows, C).to(torch.int8)


# -- token-flattened multi-adapter application ------------------------------
#
# The serving engine flattens a batch into (T, d) tokens, each with its own
# adapter id.  These are the port of the token-level oracles of
# ``kernels/ref.py``: every product in f32, the result in the input's type.


def sgmv_shrink_ref(x: torch.Tensor, A: torch.Tensor, ids: torch.Tensor
                    ) -> torch.Tensor:
    """y[t] = A[ids[t]] @ x[t].   x: (T, d_in), A: (n, r, d_in) -> (T, r)."""
    return torch.einsum("trd,td->tr", A[ids.long()].float(),
                        x.float()).to(x.dtype)


def sgmv_expand_ref(t: torch.Tensor, B: torch.Tensor, ids: torch.Tensor
                    ) -> torch.Tensor:
    """y[i] = B[ids[i]] @ t[i].   t: (T, r), B: (n, d_out, r) -> (T, d_out)."""
    return torch.einsum("tor,tr->to", B[ids.long()].float(),
                        t.float()).to(t.dtype)


def lora_apply_ref(x, A, B, ids, scaling: float = 1.0) -> torch.Tensor:
    """Uncompressed multi-LoRA delta: B[id] @ (A[id] @ x) per token."""
    t = sgmv_shrink_ref(x, A, ids)
    return sgmv_expand_ref(t, B, ids) * scaling


def jd_apply_ref(x, U, V, sigma, cluster_of, ids) -> torch.Tensor:
    """Compressed (JD) multi-LoRA delta per token.

    x: (T, d_in); U: (k, d_out, r); V: (k, d_in, r);
    sigma: (n, r, r) full or (n, r) diag; cluster_of: (n,); ids: (T,).
    """
    ids = ids.long()
    cid = cluster_of.long()[ids]
    t = torch.einsum("td,tdr->tr", x.float(), V[cid].float())
    sig = sigma[ids].float()
    if sig.ndim == 2:
        t = t * sig
    else:
        t = torch.einsum("tr,trq->tq", t, sig)
    return torch.einsum("tq,toq->to", t, U[cid].float()).to(x.dtype)


def sigma_bmm_ref(t: torch.Tensor, sigma: torch.Tensor, ids: torch.Tensor
                  ) -> torch.Tensor:
    """t: (T, r) x sigma[ids]: per-token (r, r) matmul (JD-Full mid stage)."""
    sig = sigma[ids.long()].float()
    return torch.einsum("tr,trq->tq", t.float(), sig).to(t.dtype)


def jd_shrink_scale_ref(x: torch.Tensor, V: torch.Tensor,
                        sigma_tok: Optional[torch.Tensor],
                        cids: torch.Tensor) -> torch.Tensor:
    """(x[t] @ V[cids[t]]) * sigma_tok[t] in f32 (no scale when
    ``sigma_tok`` is None).  x: (T, d_in); V: (k, d_in, r) -> (T, r) f32."""
    t = torch.einsum("td,tdr->tr", x.float(), V[cids.long()].float())
    return t if sigma_tok is None else t * sigma_tok.float()


def tile_rows(tile_ids: torch.Tensor, T: int) -> torch.Tensor:
    """Per-row ids of a grouped batch from its per-tile ids."""
    return tile_ids.repeat_interleave(T // tile_ids.shape[0])


def group_tokens_by_adapter(ids, n_adapters: int, tile: int):
    """Host-side grouping: sort tokens by adapter and pad each group to a
    multiple of ``tile``, so that every tile holds one adapter.

    Returns (perm (T_pad,), tile_ids (T_pad // tile,), valid (T_pad,)),
    int32 tensors on ``ids``' device (numpy input: the CPU):
      - perm: indices into the original tokens; a padding slot repeats its
        group's first token;
      - tile_ids: the adapter of each tile;
      - valid: 0/1, 0 on padding slots.
    ``ids`` is copied to the host (one sync per call, as on the TPU).
    """
    device = ids.device if isinstance(ids, torch.Tensor) else "cpu"
    ids_np = (ids.cpu().numpy() if isinstance(ids, torch.Tensor)
              else np.asarray(ids))
    if ids_np.size and (ids_np.min() < 0 or ids_np.max() >= n_adapters):
        raise ValueError(f"adapter ids must lie in [0, {n_adapters})")
    order = np.argsort(ids_np, kind="stable")
    sorted_ids = ids_np[order]
    starts = np.flatnonzero(np.r_[True, sorted_ids[1:] != sorted_ids[:-1]]) \
        if ids_np.size else np.zeros(0, np.int64)
    ends = np.r_[starts[1:], ids_np.size].astype(np.int64)
    perm, valid, tile_ids = [], [], []
    for s, e in zip(starts, ends):
        sel = order[s:e]
        pad = (-sel.size) % tile
        perm.append(np.concatenate([sel, np.full(pad, sel[0])]))
        valid.append(np.r_[np.ones(sel.size), np.zeros(pad)])
        tile_ids.append(np.full((sel.size + pad) // tile, sorted_ids[s]))

    def as_t(parts):
        a = np.concatenate(parts) if parts else np.zeros(0)
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return as_t(perm), as_t(tile_ids), as_t(valid)
