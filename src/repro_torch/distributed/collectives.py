"""Distributed attention collectives (the port of
``distributed/collectives.py``).

``seq_sharded_decode_attention``: flash-decoding over a KV cache whose
*sequence* dimension is sharded across the mesh's model axis (the layout
``launch/shardings.py`` gives the cache when the KV heads do not divide
the model axis).  Each rank computes partial attention over its slice
with online-softmax stats ``(o, l, m)``; the ranks merge them with a
``max`` and a ``sum`` all-reduce instead of gathering the cache.

On a CUDA tensor a rank's partial is the port's ``flash_decode``
(``csrc/decode_attention.cu``) over its slice, with the local length
``clamp(kv_len - r * S_loc, 0, S_loc)``: its ``out`` is normalised.  On
the CPU it is :func:`_partial_decode`, the JAX function, whose ``o`` is
not.  The merge weights each partial so that the result is attention
over the whole cache, ``m = max_r m_r``, ``w_r = exp(m_r - m)``:

- a normalised partial takes ``w_r * l_r``, an unnormalised one ``w_r``;
- the denominator is ``sum_r w_r * l_r`` either way.

The JAX module weights its unnormalised partial by ``w_r * l_r``, which
gives ``p @ V`` on one shard, not attention (ROADMAP queue 3); the port
does not copy that.

Every rank passes its own shard: ``q`` and the new token replicated over
the axis, the cache the rank's slice of the sequence (positions
``[r * S_loc, (r + 1) * S_loc)``), ``kv_len`` the whole sequence's length.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.flash_decode import flash_decode
from .sharding import Mesh

NEG_INF = -1e30


def _partial_decode(q, k, v, start, kv_len):
    """Partial attention over a KV slice.  q: (B,1,H,hd); k/v: (B,S_loc,Kv,hd);
    global positions are start + arange(S_loc); valid when < kv_len.
    Returns (o (B,Kv,G,hd) unnormalised, l (B,Kv,G), m (B,Kv,G)) in f32."""
    B, _, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q[:, 0].reshape(B, Kv, G, hd).float() * (hd ** -0.5)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float())
    pos = start + torch.arange(S, device=q.device)
    valid = pos[None, :] < torch.as_tensor(kv_len, device=q.device
                                           ).reshape(-1, 1)
    neg = torch.tensor(NEG_INF, device=q.device)
    logits = torch.where(valid[:, None, None, :], logits, neg)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(valid[:, None, None, :], p,
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o, l, m


def _kernel_partial(q, k, v, start: int, kv_len):
    """The kernel's partial over a slice: (o (B,Kv,G,hd) normalised, l, m
    (B,Kv,G)) in f32 (q goes in as f32, so ``out`` comes back in f32)."""
    B, _, H, hd = q.shape
    S_loc, Kv = k.shape[1], k.shape[2]
    local = torch.clamp(kv_len - start, 0, S_loc).to(torch.int32).contiguous()
    out, l, m = flash_decode(q[:, 0].float().contiguous(), k, v, local)
    return out.reshape(B, Kv, H // Kv, hd), l[..., 0], m[..., 0]


def _merge(o, l, m, normalised: bool, group) -> torch.Tensor:
    """Attention over the whole sequence from each rank's (o, l, m): one
    ``max`` and one ``sum`` all-reduce (the weighted o and the weights in
    one buffer).  Returns (B, Kv, G, hd) f32."""
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - m_g)                           # (B, Kv, G)
    wl = w * l
    wo = wl if normalised else w
    buf = torch.cat([o * wo[..., None], wl[..., None]], dim=-1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf[..., :-1] / torch.clamp(buf[..., -1:], min=1e-30)


def _partial(q, k, v, start: int, kv_len):
    """(o, l, m, normalised): the kernel's partial on a CUDA tensor, the
    plain one on the CPU."""
    if q.is_cuda:
        return (*_kernel_partial(q, k, v, start, kv_len), True)
    return (*_partial_decode(q, k, v, start, kv_len), False)


def lengths(idx, B: int, device) -> torch.Tensor:
    """Per-sequence lengths as a (B,) int32 tensor on ``device``, from an
    int (every sequence) or a (B,) tensor."""
    if isinstance(idx, torch.Tensor) and idx.ndim == 1:
        return idx.to(device=device, dtype=torch.int32)
    return torch.full((B,), int(idx), dtype=torch.int32, device=device)


def seq_sharded_decode_attention(q: torch.Tensor, keys: torch.Tensor,
                                 vals: torch.Tensor, kv_len: torch.Tensor,
                                 mesh: Mesh, axis: str = "model"
                                 ) -> torch.Tensor:
    """q: (B,1,H,hd) replicated over `axis`; keys/vals: this rank's
    (B,S_loc,Kv,hd) slice of the sequence; kv_len: (B,).  Returns
    (B,1,H,hd) in q's dtype."""
    B, _, H, hd = q.shape
    start = mesh.coordinate(axis) * keys.shape[1]
    o, l, m, normalised = _partial(q, keys, vals, start,
                                   lengths(kv_len, B, q.device))
    out = _merge(o, l, m, normalised, mesh.group(axis))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def seq_sharded_decode_step(q: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, idx, mesh: Mesh,
                            axis: str = "model"):
    """Cache update + partial attention + softmax merge: the S-sharded
    cache never leaves its ranks.

    q/k_new/v_new: (B,1,H|Kv,hd) replicated over `axis`; cache_k/v: this
    rank's (B,S_loc,Kv,hd) slice, written in place (the rank holding
    position ``idx[b]`` writes sequence b's new token there, the others
    rewrite what they hold); idx: (B,) or a scalar, the current lengths.
    Returns (out (B,1,H,hd), cache_k, cache_v)."""
    B, _, H, hd = q.shape
    S_loc = cache_k.shape[1]
    start = mesh.coordinate(axis) * S_loc
    idx_vec = lengths(idx, B, q.device)
    pos = idx_vec.long() - start                      # (B,) local write pos
    ok = (pos >= 0) & (pos < S_loc)
    safe = torch.clamp(pos, 0, S_loc - 1)
    rows = torch.arange(B, device=q.device)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[rows, safe] = torch.where(ok[:, None, None],
                                        new[:, 0].to(cache.dtype),
                                        cache[rows, safe])
    o, l, m, normalised = _partial(q, cache_k, cache_v, start, idx_vec + 1)
    out = _merge(o, l, m, normalised, mesh.group(axis))
    return out.reshape(B, 1, H, hd).to(q.dtype), cache_k, cache_v

