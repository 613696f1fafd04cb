"""Dense transformer building blocks (the port of ``models/layers.py``):
norms, RoPE, GQA attention for training, prefill and decode, encoder-decoder
cross attention, SwiGLU MLP, embeddings, logits and the memory-safe
cross-entropy.

Plain functions on tensors; parameters are nested dicts of tensors in the
JAX package's layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``, ...).

Decode attention takes one of three branches (``cfg.decode_attn``, under
the JAX module's conditions, :func:`attention_fwd`): ``gather`` writes the
new token into a copy of the layer's cache and attends over it;
``lazy`` attends over the old cache and the new token as a two-part
softmax and returns only the new token's K/V, which the caller splices
into the stacked cache once a step (``transformer.forward``);
``seq_shard`` runs ``distributed/collectives.py``'s sequence-sharded
step under a mesh whose model axis the KV heads do not divide, and the
gather branch otherwise.

Activations carry the JAX module's logical sharding constraints
(``distributed/sharding.py::constrain``), which act inside the sharded
step (``sharding.sharded_step``: parameters, batch and cache as DTensors)
and leave plain tensors alone outside it.  There the attention proper,
the cache writes, the ``lazy`` branch's kernel, the ``seq_shard`` step,
the lookup into the vocab-sharded table and the vocab-sharded
cross-entropy run on each rank's own block (``sharding.island_locals`` /
``island_out``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..distributed import collectives
from ..distributed import sharding as shd
from ..distributed.sharding import constrain, current_mesh
from ..kernels.flash_decode import flash_decode
from ..spans import span
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
        q, k, v = lora_mod.apply_group(lora_ctx, ("q", "k", "v"), x,
                                       (q, k, v))
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _index_tensor(x, device) -> torch.Tensor:
    """An int (as an int64 scalar, by ``torch.full``: see
    :func:`_scale_like`) or a tensor of positions, on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.full((), x, dtype=torch.int64, device=device)


def _attn_mask(B: int, Sq: int, Skv: int, device, *, causal: bool,
               q_offset, kv_len, sliding_window: int) -> torch.Tensor:
    """(B|1, Sq, Skv) bool mask of the positions a query may attend."""
    kpos = torch.arange(Skv, device=device)
    q_off = _index_tensor(q_offset, device)
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
        kl = _index_tensor(kv_len, device)
        kl = kl[:, None, None] if kl.ndim == 1 else kl
        mask = mask & (kpos[None, None, :] < kl)
    return mask


def _scale_like(x: torch.Tensor, c: float) -> torch.Tensor:
    """A Python scalar as JAX multiplies it into ``x``: weakly typed, so
    rounded to x's dtype first (torch would keep it at f32 precision).
    Made by ``torch.full``, as the model's other constants, so that a dry
    run on ``meta`` sees the same op as the card (``torch.tensor`` goes
    another way on meta)."""
    return torch.full((), c, dtype=x.dtype, device=x.device)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset=0, kv_len=None,
                    sliding_window: int = 0) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,hd); k,v: (B,Skv,Kv,hd).  On
    DTensors, on each rank's own heads (:func:`_attention_island`)."""
    if shd.is_dtensor(q):
        return _attention_island(naive_attention, q, k, v, causal=causal,
                                 q_offset=q_offset, kv_len=kv_len,
                                 sliding_window=sliding_window)
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, hd) * _scale_like(q, hd ** -0.5)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    mask = _attn_mask(B, Sq, Skv, q.device, causal=causal,
                      q_offset=q_offset, kv_len=kv_len,
                      sliding_window=sliding_window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk_q: int, chunk_kv: int,
                      q_offset: int = 0, kv_len=None,
                      sliding_window: int = 0) -> torch.Tensor:
    """Flash-style online-softmax attention in plain torch ops (a loop over
    query and KV chunks).  Memory is O(chunk_q * chunk_kv) per (batch,
    head) instead of O(Sq * Skv).  On DTensors, on each rank's own heads
    (:func:`_attention_island`)."""
    if shd.is_dtensor(q):
        return _attention_island(chunked_attention, q, k, v, causal=causal,
                                 chunk_q=chunk_q, chunk_kv=chunk_kv,
                                 q_offset=q_offset, kv_len=kv_len,
                                 sliding_window=sliding_window)
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
    neg = torch.full((), NEG_INF, device=dev)
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


def _two_part_decode_attention(q, cache_k, cache_v, k_new, v_new, idx):
    """Decode attention over (old cache) + (current token) without writing
    the cache first, as the JAX function computes it (the plain version).
    q/k_new/v_new: (B,1,H|Kv,hd); cache: (B,S,Kv,hd); idx: the old cache's
    length, an int or (B,)."""
    B, _, H, hd = q.shape
    S, Kv = cache_k.shape[1], cache_k.shape[2]
    G = H // Kv
    dev = q.device
    qg = (q[:, 0].reshape(B, Kv, G, hd) * _scale_like(q, hd ** -0.5)).float()
    logits_c = torch.einsum("bkgh,bskh->bkgs", qg, cache_k.float())
    kl = collectives.lengths(idx, B, dev)
    valid = (torch.arange(S, device=dev)[None, :] < kl[:, None])[:, None,
                                                                  None, :]
    logits_c = torch.where(valid, logits_c,
                           torch.full((), NEG_INF, device=dev))
    logit_s = torch.einsum("bkgh,bkh->bkg", qg,
                           k_new[:, 0].float())[..., None]
    m = torch.maximum(logits_c.amax(-1, keepdim=True), logit_s)
    w_c = torch.where(valid, torch.exp(logits_c - m),
                      torch.zeros((), device=dev))
    w_s = torch.exp(logit_s - m)
    denom = w_c.sum(-1, keepdim=True) + w_s
    out = torch.einsum("bkgs,bskh->bkgh", w_c, cache_v.float())
    out = out + w_s * v_new[:, 0].float().reshape(B, Kv, 1, hd)
    out = out / torch.clamp(denom, min=1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def two_part_decode_attention(q, cache_k, cache_v, k_new, v_new, idx):
    """:func:`_two_part_decode_attention`; on a CUDA tensor the old cache
    goes through ``flash_decode`` (``csrc/decode_attention.cu``, reading
    the cache once in its own dtype) with the query scaled as the JAX
    function scales it (in q's dtype, then f32) and the kernel's scale 1,
    and the new token joins through the kernel's ``(l, m)``: with ``m' =
    max(m, s)``, ``w_c = exp(m - m') * l`` and ``w_s = exp(s - m')``, out
    = ``(w_c * out_c + w_s * v_new) / (w_c + w_s)``.  A ``meta`` q (a dry
    run) takes the kernel's path too, with the lengths on the host."""
    if q.device.type == "cpu":
        return _two_part_decode_attention(q, cache_k, cache_v, k_new,
                                          v_new, idx)
    B, _, H, hd = q.shape
    Kv = cache_k.shape[2]
    G = H // Kv
    kl = collectives.lengths(idx, B, "cpu" if q.is_meta else q.device)
    qs = (q[:, 0] * _scale_like(q, hd ** -0.5)).float().contiguous()
    out_c, l, m = flash_decode(qs, cache_k, cache_v, kl, scale=1.0)
    s = torch.einsum("bkgh,bkh->bkg", qs.reshape(B, Kv, G, hd),
                     k_new[:, 0].float())[..., None]
    m2 = torch.maximum(m, s)
    w_c = torch.exp(m - m2) * l
    w_s = torch.exp(s - m2)
    out = (w_c * out_c.reshape(B, Kv, G, hd)
           + w_s * v_new[:, 0].float().reshape(B, Kv, 1, hd)) / (w_c + w_s)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _attention_island(fn, q, k, v, **kw):
    """``fn`` (:func:`naive_attention` or :func:`chunked_attention`) on
    each rank's own heads of DTensors q, k, v (``sharding.head_blocks``:
    the batch as q's, the sequences whole, q's heads over "model" where it
    divides them and the kv heads those heads read): DTensor cannot carry
    the attention's head-grouping views and batched products."""
    pl_q, pl_kv, narrow = shd.head_blocks(q, k)
    q_l, k_l, v_l = shd.island_locals((q, pl_q), (k, pl_kv), (v, pl_kv))
    if narrow is not None:
        k_l, v_l = (t.narrow(2, *narrow) for t in (k_l, v_l))
    return shd.island_out(fn(q_l, k_l, v_l, **kw), q, pl_q, q.shape)


def _lazy_island(q, cache_k, cache_v, k_new, v_new, idx):
    """:func:`two_part_decode_attention` on each rank's own block of
    DTensors (``sharding.head_blocks``: the cache with its sequence whole,
    its batch and, where the model axis divides them, its kv heads as
    q's; q's own heads and the kv heads they read).  On a CUDA tensor row
    1 (``flash_decode``) runs on these local blocks."""
    pl_q, pl_kv, narrow = shd.head_blocks(q, cache_k)
    q_l = shd.island_local(q, pl_q)
    kv = [shd.island_local(t, pl_kv)
          for t in (cache_k, cache_v, k_new, v_new)]
    if narrow is not None:
        kv = [t.narrow(2, *narrow) for t in kv]
    out = two_part_decode_attention(q_l, *kv[:2], *kv[2:], idx)
    return shd.island_out(out, q, pl_q, q.shape)


def _seq_shard_island(q, cache_k, cache_v, k_new, v_new, idx, mesh):
    """``collectives.seq_sharded_decode_step`` on each rank's own block of
    DTensors: the rank's slice of the sequence of a copy of the cache, q
    and the new token whole over the model axis (the step's layout)."""
    from torch.distributed.tensor import Replicate, Shard
    pl_c = list(cache_k.placements)
    pl_q = shd.replace_placements(pl_c, lambda i, p: p if (
        isinstance(p, Shard) and p.dim == 0) else Replicate())
    ck, cv = (t.to_local().clone() for t in (cache_k, cache_v))
    q_l, kn, vn = (shd.island_local(t, pl_q) for t in (q, k_new, v_new))
    out, ck, cv = collectives.seq_sharded_decode_step(q_l, ck, cv, kn, vn,
                                                      idx, mesh)
    return (shd.island_out(out, q, pl_q, q.shape),
            shd.island_out(ck, cache_k, pl_c, cache_k.shape),
            shd.island_out(cv, cache_v, pl_c, cache_v.shape))


def attention_fwd(p: Dict, x: torch.Tensor, cfg, *,
                  positions: torch.Tensor,
                  mode: str = "prefill",   # train | prefill | decode
                  cache: Optional[Dict] = None,
                  lora_ctx=None, causal: bool = True):
    """Self-attention over x; returns (y, new_cache) where ``cache`` and
    ``new_cache`` are ``{"k", "v", "index"}`` dicts for one layer
    (``k/v (B, S_max, Kv, hd)``, ``index`` a scalar).  Train attends
    within x and takes no cache (``new_cache`` is None); prefill writes the
    prompt at position 0 and attends within it; decode writes the new
    token at ``index`` and attends over ``[0, index + S)``.  Neither
    mutates ``cache``.  Decode of one token under ``cfg.decode_attn ==
    "lazy"`` returns as ``new_cache`` only the new token's K/V
    ``(B, 1, Kv, hd)``; under ``"seq_shard"`` with a mesh whose model axis
    the KV heads do not divide, ``cache`` is this rank's slice of the
    sequence (``collectives.seq_sharded_decode_step``)."""
    B, S, _ = x.shape
    if cfg.decode_attn not in ("gather", "seq_shard", "lazy"):
        raise ValueError(f"decode_attn {cfg.decode_attn!r}: the configs know "
                         f"'gather', 'seq_shard' and 'lazy'")
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, lora_ctx)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    mesh = current_mesh()
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    # the JAX module's context-parallel fallback: heads that do not divide
    # the model axis shard the attention over the sequence instead
    use_cp = (cfg.attn_cp_fallback and tp > 1 and cfg.num_heads % tp != 0
              and mode != "decode" and S % tp == 0)
    if use_cp:
        q = constrain(q, "batch", "seq_sp", "heads", "head_dim")
    else:
        q = constrain(q, "batch", "seq", "heads", "head_dim")
    # v as JAX's context-parallel branch holds it, on both branches: it
    # leaves the layer input's sequence sharding (the carry's "seq_sp"),
    # which DTensor cannot carry through the chunked attention's reshapes
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    if mode == "train":
        keys, vals, kv_len, q_offset, new_cache = k, v, None, 0, None
    elif cache is None:
        raise ValueError("attention_fwd needs a cache in prefill/decode")
    elif mode == "prefill":
        keys = shd.write_slice(cache["k"], k, 0, 1)
        vals = shd.write_slice(cache["v"], v, 0, 1)
        new_cache = {"k": keys, "v": vals, "index": S}
        keys, vals, kv_len, q_offset = k, v, None, 0   # within prompt only
    elif mode == "decode":
        idx = int(cache["index"])
        sharded = shd.is_dtensor(q)
        if (cfg.decode_attn == "seq_shard" and S == 1 and tp > 1
                and cfg.num_kv_heads % tp != 0
                and cache["k"].shape[1] % tp == 0):
            # the JAX condition: the cache is S-sharded over the model
            # axis; update + attention on the rank's slice (the copies
            # keep the caller's cache unmutated, as the gather branch does)
            if sharded:
                out, keys, vals = _seq_shard_island(
                    q, cache["k"], cache["v"], k, v, idx, mesh)
            else:
                out, keys, vals = collectives.seq_sharded_decode_step(
                    q, cache["k"].clone(), cache["v"].clone(), k, v, idx,
                    mesh)
            return _out_proj(p, out, lora_ctx), {"k": keys, "v": vals,
                                                 "index": idx + S}
        if cfg.decode_attn == "lazy" and S == 1:
            out = (_lazy_island if sharded else two_part_decode_attention)(
                q, cache["k"], cache["v"], k, v, idx)
            return _out_proj(p, out, lora_ctx), {
                "k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype),
                "index": idx + S}
        # a write past the end lands on the last S slots, as XLA's
        # dynamic_update_slice clamps its start index
        w = min(idx, cache["k"].shape[1] - S)
        keys = shd.write_slice(cache["k"], k, w, 1)
        vals = shd.write_slice(cache["v"], v, w, 1)
        new_cache = {"k": keys, "v": vals, "index": idx + S}
        kv_len, q_offset = idx + S, idx
        keys = constrain(keys, "batch", "kv_seq", "kv_heads", "head_dim")
        vals = constrain(vals, "batch", "kv_seq", "kv_heads", "head_dim")
    else:
        raise ValueError(mode)
    use_chunks = (cfg.attn_chunk_q > 0 and mode != "decode"
                  and S > cfg.attn_chunk_q)
    with span("attention_core"):
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
    return _out_proj(p, out, lora_ctx), new_cache


def _out_proj(p: Dict, out: torch.Tensor, lora_ctx) -> torch.Tensor:
    """(B, S, H, hd) attention output through ``wo`` and the o adapter."""
    B, S = out.shape[:2]
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    y = shd.whole_grad(torch.einsum("bshk,hkd->bsd", out, p["wo"]))
    if lora_ctx is not None:
        y = lora_mod.apply(lora_ctx, "o", out.reshape(B, S, -1), y)
    return constrain(y, "batch", "seq", "d_model")


def cross_attention_fwd(p: Dict, x: torch.Tensor, memory: torch.Tensor, cfg,
                        lora_ctx=None) -> torch.Tensor:
    """Encoder-decoder cross attention (no rope, no causal mask)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    if lora_ctx is not None:
        q = lora_mod.apply(lora_ctx, "xq", x, q)
        k = lora_mod.apply(lora_ctx, "xk", memory, k)
        v = lora_mod.apply(lora_ctx, "xv", memory, v)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    out = naive_attention(q, k, v, causal=False)
    return shd.whole_grad(torch.einsum("bshk,hkd->bsd", out, p["wo"]))


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
    with span("mlp"):
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        u = torch.einsum("bsd,df->bsf", x, p["w_up"])
        h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
        h = constrain(h, "batch", "seq", "d_ff")
        return shd.whole_grad(torch.einsum("bsf,fd->bsd", h, p["w_down"]))


# ---------------------------------------------------------------------------
# embeddings, logits & losses
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
    E = shd.unshard_batch_axes(p["embed"])
    x = _embed_island(E, tokens) if shd.is_dtensor(E) else E[tokens]
    return constrain(x, "batch", "seq", "d_model")


def _embed_island(E, tokens):
    """The lookup on each rank's own rows of a vocab-sharded table: a token
    outside them gives zeros, and the rows sum over the model axis (one
    nonzero term: exact) when the result is constrained; DTensor has no
    backward for a lookup into a sharded table."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl_t = shd.replace_placements(tokens.placements, lambda i, p: p if (
        isinstance(p, Shard) and p.dim == 0) else Replicate())
    pl_e = list(E.placements)
    e_l, t_l = shd.island_locals((E, pl_e), (tokens, pl_t))
    rows = e_l.shape[0]
    t = t_l.long() - shd.global_offset(E, 0)
    inside = (t >= 0) & (t < rows)
    x = torch.where(inside[..., None], e_l[t.clamp(0, rows - 1)],
                    torch.zeros((), dtype=e_l.dtype, device=e_l.device))
    pl_x = [Partial() if isinstance(pe, Shard) else pt
            for pe, pt in zip(pl_e, pl_t)]
    return shd.island_out(x, E, pl_x, tuple(tokens.shape) + (E.shape[1],))


def _seq_whole(h: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, d) with its sequence whole, before work sharded over
    the model axis (a block's, the unembedding): the layer boundary holds
    it over that axis, and DTensor cannot flatten a batch and a sequence
    sharded at once."""
    return constrain(h, "batch", "seq", "d_model")


def _unembed_matrix(p: Dict, cfg) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["unembed"]


def logits_fwd(p: Dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """Logits over the whole ``cfg.padded_vocab``, padding unmasked, as in
    the JAX package (so argmax streams stay comparable)."""
    p = shd.unshard_batch_axes(p)
    h = _seq_whole(rms_norm(h, p["final_norm"], cfg.norm_eps))
    logits = torch.einsum("bsd,dv->bsv", h, _unembed_matrix(p, cfg))
    return constrain(logits, "batch", "seq", "vocab")


def cross_entropy(p: Dict, h: torch.Tensor, targets: torch.Tensor, cfg,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE.  With cfg.logits_chunk_vocab > 0, never materializes the
    full (B, S, V) logits: loops over vocab chunks with an online logsumexp.

    The chunks are the JAX module's (the same chunk-count search), so the
    sums run over the same pieces; as there, each chunk's logits are taken
    in the model dtype and then cast to f32, and the target logit is an f32
    product of ``h`` and the target's unembedding column."""
    p = shd.unshard_batch_axes(p)
    h = _seq_whole(rms_norm(h, p["final_norm"], cfg.norm_eps))
    W = _unembed_matrix(p, cfg)                   # (d, Vp)
    if shd.is_dtensor(h):
        return _cross_entropy_island(h, W, targets, cfg, mask)
    Vp = W.shape[1]
    tgt = torch.clamp(targets, 0, Vp - 1).long()
    if mask is None:
        mask = (targets >= 0).float()
    chunk = _vocab_chunk(Vp, cfg.logits_chunk_vocab)
    if chunk:
        m, l = _online_lse(h, W, chunk)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        tgt_logit = torch.einsum("bsd,bsd->bs", h.float(),
                                 W.T[tgt].float())
    else:
        logits = torch.einsum("bsd,dv->bsv", h, W).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (lse - tgt_logit) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def _vocab_chunk(V: int, chunk: int) -> int:
    """The width of the vocab chunks the JAX module takes over ``V``
    columns for ``cfg.logits_chunk_vocab = chunk``: ``V`` over the
    smallest chunk count >= V / chunk that divides ``V``; 0 where the
    logits are taken at once."""
    if not chunk or V <= chunk:
        return 0
    n = -(-V // chunk)
    while V % n and n < min(V, 4096):
        n += 1
    return V // n if V % n == 0 else 0


def _online_lse(h: torch.Tensor, W: torch.Tensor, chunk: int):
    """The logsumexp over ``W``'s columns of each token's logits, chunk by
    chunk (each in the model dtype, then f32): ``(m, l)`` with
    ``lse = m + log(l)``."""
    m = torch.full(h.shape[:2], NEG_INF, device=h.device)
    l = torch.zeros(h.shape[:2], device=h.device)
    for i in range(W.shape[1] // chunk):
        lg = torch.einsum("bsd,dv->bsv", h,
                          W[:, i * chunk:(i + 1) * chunk]).float()
        m_new = torch.maximum(m, lg.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            lg - m_new[..., None]).sum(-1)
        m = m_new
    return m, l


def _cross_entropy_island(h, W, targets, cfg, mask):
    """:func:`cross_entropy` on DTensors, each rank over its own tokens and
    its own slice of the vocab (``W`` over "model" as the vocab rule puts
    it): :func:`_online_lse` over the slice in the chunks
    :func:`_vocab_chunk` picks for it (one chunk where it picks none),
    then the ranks' (max, sum) and target logits merged over the model
    axis, as the vocab-sharded logits JAX constrains are reduced.  The
    token mean is taken on DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    pl_h = shd.replace_placements(h.placements, lambda i, p: p if (
        isinstance(p, Shard) and p.dim == 0) else Replicate())
    pl_w = shd.replace_placements(W.placements, lambda i, p: p if (
        isinstance(p, Shard) and p.dim == 1) else Replicate())
    tg = targets if shd.is_dtensor(targets) else shd.island_out(
        targets, h, [Replicate()] * len(pl_h))
    h_l, w_l, t_l = shd.island_locals((h, pl_h), (W, pl_w), (tg, pl_h))
    cols, v0 = w_l.shape[1], shd.global_offset(W, 1)
    m, l = _online_lse(h_l, w_l,
                       _vocab_chunk(cols, cfg.logits_chunk_vocab) or cols)
    t = torch.clamp(t_l, 0, W.shape[1] - 1).long() - v0
    inside = (t >= 0) & (t < cols)
    col = w_l.T[t.clamp(0, cols - 1)].float()              # (b, s, d)
    tgt_logit = torch.where(inside, torch.einsum(
        "bsd,bsd->bs", h_l.float(), col), torch.zeros((), device=col.device))
    md = shd.mesh_dim(W, "model")
    if isinstance(pl_w[md] if md is not None else None, Shard):
        group = W.device_mesh.get_group("model")
        m_all = shd.max_over_ranks(m, group)
        l = shd.SumOverRanks.apply(l * torch.exp(m - m_all), group)
        tgt_logit = shd.SumOverRanks.apply(tgt_logit, group)
        m = m_all
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    nll = shd.island_out(lse - tgt_logit, h, pl_h, tuple(h.shape[:2]))
    if mask is None:
        mask = (targets >= 0).float()
    nll = nll * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
