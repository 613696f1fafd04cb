"""Dense transformer building blocks (the port of ``models/layers.py``):
norms, RoPE, GQA attention for prefill and decode, SwiGLU MLP, embeddings
and logits.

Plain functions on tensors; parameters are nested dicts of tensors in the
JAX package's layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``, ...).  The
sequence-sharded and lazy decode branches and the mesh constraints of the
JAX module are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import lora as lora_mod
from .param import ParamDef

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms & rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions. positions: (...,S)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs            # (...,S,half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_defs(cfg, kv_heads: Optional[int] = None) -> Dict:
    d, H = cfg.d_model, cfg.num_heads
    Kv = kv_heads if kv_heads is not None else cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, H, hd), ("d_model", "heads", "head_dim")),
        "wk": ParamDef((d, Kv, hd), ("d_model", "kv_heads", "head_dim")),
        "wv": ParamDef((d, Kv, hd), ("d_model", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "d_model")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((Kv, hd), ("kv_heads", "head_dim"),
                              init="zeros")
        defs["bv"] = ParamDef((Kv, hd), ("kv_heads", "head_dim"),
                              init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
        defs["k_norm"] = ParamDef((hd,), ("head_dim",), init="ones")
    return defs


def _qkv(p: Dict, x: torch.Tensor, cfg, lora_ctx):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if lora_ctx is not None:
        q = lora_mod.apply(lora_ctx, "q", x, q)
        k = lora_mod.apply(lora_ctx, "k", x, k)
        v = lora_mod.apply(lora_ctx, "v", x, v)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_mask(B: int, Sq: int, Skv: int, device, *, causal: bool,
               q_offset, kv_len, sliding_window: int) -> torch.Tensor:
    """(B|1, Sq, Skv) bool mask of the positions a query may attend."""
    kpos = torch.arange(Skv, device=device)
    q_off = torch.as_tensor(q_offset, device=device)
    if q_off.ndim == 0:
        qp = (torch.arange(Sq, device=device) + q_off)[None]    # (1, Sq)
        mask = torch.ones((1, Sq, Skv), dtype=torch.bool, device=device)
    else:        # per-batch offsets (continuous batching, ragged slots)
        qp = q_off[:, None] + torch.arange(Sq, device=device)[None]
        mask = torch.ones((B, Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos[None, None, :] <= qp[:, :, None])
    if sliding_window:
        mask = mask & (kpos[None, None, :] > qp[:, :, None] - sliding_window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=device)
        kl = kl[:, None, None] if kl.ndim == 1 else kl
        mask = mask & (kpos[None, None, :] < kl)
    return mask


def _scale_like(x: torch.Tensor, c: float) -> torch.Tensor:
    """A Python scalar as JAX multiplies it into ``x``: weakly typed, so
    rounded to x's dtype first (torch would keep it at f32 precision)."""
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset=0, kv_len=None,
                    sliding_window: int = 0) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,hd); k,v: (B,Skv,Kv,hd)."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, hd) * _scale_like(q, hd ** -0.5)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    mask = _attn_mask(B, Sq, Skv, q.device, causal=causal,
                      q_offset=q_offset, kv_len=kv_len,
                      sliding_window=sliding_window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk_q: int, chunk_kv: int,
                      q_offset: int = 0, kv_len=None,
                      sliding_window: int = 0) -> torch.Tensor:
    """Flash-style online-softmax attention in plain torch ops (a loop over
    query and KV chunks).  Memory is O(chunk_q * chunk_kv) per (batch,
    head) instead of O(Sq * Skv)."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    cq, ckv = min(chunk_q, Sq), min(chunk_kv, Skv)
    if Sq % cq or Skv % ckv:
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, sliding_window=sliding_window)
    nq, nkv = Sq // cq, Skv // ckv
    dev = q.device
    qg = (q.reshape(B, nq, cq, Kv, G, hd) * _scale_like(q, hd ** -0.5)
          ).float()
    ks = k.reshape(B, nkv, ckv, Kv, hd).float()
    vs = v.reshape(B, nkv, ckv, Kv, hd).float()
    neg = torch.tensor(NEG_INF, device=dev)
    outs = []
    for iq in range(nq):
        q_i = qg[:, iq]                                   # (B,cq,Kv,G,hd)
        qpos = iq * cq + torch.arange(cq, device=dev) + q_offset
        m = torch.full((B, Kv, G, cq), NEG_INF, device=dev)
        l = torch.zeros((B, Kv, G, cq), device=dev)
        acc = torch.zeros((B, Kv, G, cq, hd), device=dev)
        for ikv in range(nkv):
            logits = torch.einsum("bqkgh,bskh->bkgqs", q_i, ks[:, ikv])
            kpos = ikv * ckv + torch.arange(ckv, device=dev)
            mask = torch.ones((cq, ckv), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if sliding_window:
                mask = mask & (kpos[None, :] > qpos[:, None] - sliding_window)
            if kv_len is not None:
                mask = mask & (kpos[None, :] < kv_len)
            logits = torch.where(mask, logits, neg)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vs[:, ikv])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,Kv,G,cq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,cq,Kv,G,hd)
    return torch.stack(outs, dim=1).reshape(B, Sq, H, hd).to(q.dtype)


def attention_fwd(p: Dict, x: torch.Tensor, cfg, *,
                  positions: torch.Tensor,
                  mode: str = "prefill",          # prefill | decode
                  cache: Optional[Dict] = None,
                  lora_ctx=None, causal: bool = True):
    """Self-attention over x; returns (y, new_cache) where ``cache`` and
    ``new_cache`` are ``{"k", "v", "index"}`` dicts for one layer
    (``k/v (B, S_max, Kv, hd)``, ``index`` a scalar).  Prefill writes the
    prompt at position 0 and attends within it; decode writes the new
    token at ``index`` and attends over ``[0, index + S)``.  Neither
    mutates ``cache``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, lora_ctx)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is None:
        raise ValueError("attention_fwd needs a cache in prefill/decode")
    if mode == "prefill":
        keys = cache["k"].clone()
        vals = cache["v"].clone()
        keys[:, :S] = k.to(keys.dtype)
        vals[:, :S] = v.to(vals.dtype)
        new_cache = {"k": keys, "v": vals, "index": S}
        keys, vals, kv_len, q_offset = k, v, None, 0   # within prompt only
    elif mode == "decode":
        idx = int(cache["index"])
        # a write past the end lands on the last S slots, as XLA's
        # dynamic_update_slice clamps its start index
        w = min(idx, cache["k"].shape[1] - S)
        keys = cache["k"].clone()
        vals = cache["v"].clone()
        keys[:, w:w + S] = k.to(keys.dtype)
        vals[:, w:w + S] = v.to(vals.dtype)
        new_cache = {"k": keys, "v": vals, "index": idx + S}
        kv_len, q_offset = idx + S, idx
    else:
        raise ValueError(mode)
    use_chunks = (cfg.attn_chunk_q > 0 and mode != "decode"
                  and S > cfg.attn_chunk_q)
    if use_chunks:
        out = chunked_attention(q, keys, vals, causal=causal,
                                chunk_q=cfg.attn_chunk_q,
                                chunk_kv=cfg.attn_chunk_kv,
                                q_offset=q_offset, kv_len=kv_len,
                                sliding_window=cfg.sliding_window)
    else:
        out = naive_attention(q, keys, vals, causal=causal,
                              q_offset=q_offset, kv_len=kv_len,
                              sliding_window=cfg.sliding_window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if lora_ctx is not None:
        y = lora_mod.apply(lora_ctx, "o", out.reshape(B, S, -1), y)
    return y, new_cache


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------


def mlp_defs(d_model: int, d_ff: int) -> Dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("d_model", "d_ff")),
        "w_up": ParamDef((d_model, d_ff), ("d_model", "d_ff")),
        "w_down": ParamDef((d_ff, d_model), ("d_ff", "d_model")),
    }


def mlp_fwd(p: Dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


# ---------------------------------------------------------------------------
# embeddings & logits
# ---------------------------------------------------------------------------


def embedding_defs(cfg) -> Dict:
    Vp, d = cfg.padded_vocab, cfg.d_model
    defs = {
        "embed": ParamDef((Vp, d), ("vocab", "d_model"), scale=0.02),
        "final_norm": ParamDef((d,), ("d_model",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, Vp), ("d_model", "vocab"), scale=0.02)
    return defs


def embed_tokens(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def _unembed_matrix(p: Dict, cfg) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["unembed"]


def logits_fwd(p: Dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """Logits over the whole ``cfg.padded_vocab``, padding unmasked, as in
    the JAX package (so argmax streams stay comparable)."""
    h = rms_norm(h, p["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", h, _unembed_matrix(p, cfg))
