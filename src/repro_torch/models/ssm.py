"""Mamba2 / SSD (state-space duality) block (the port of
``models/ssm.py``).

The chunked SSD formulation (arXiv:2405.21060 §6): the intra-chunk terms
are plain einsums, the inter-chunk recurrence a short Python loop over
chunk states.  Decode is an O(1) recurrent state update: the "KV cache"
of an SSM layer is its fixed-size conv window and state.

Inside the sharded step (DTensors, ``distributed/sharding.py``) the
activations carry the JAX module's constraints, the scan and the decode
recurrence run on each rank's own heads, and the causal conv runs on its
x, B and C parts apart (the same numbers) so that x keeps its sharding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (constrain, head_blocks, is_dtensor,
                                     island_locals, island_out, mesh_dim,
                                     whole_grad)
from . import lora as lora_mod
from .layers import rms_norm
from .param import ParamDef


@dataclasses.dataclass
class SSMCache:
    """conv: (B, d_conv-1, di+2GN) in the cache dtype; state: (B, H, N, P)
    f32; index: the number of tokens seen."""
    conv: torch.Tensor
    state: torch.Tensor
    index: int

    @staticmethod
    def zeros(batch: int, cfg, *, device,
              dtype=torch.bfloat16) -> "SSMCache":
        s = cfg.ssm
        H = s.n_heads(cfg.d_model)
        return SSMCache(
            conv=torch.zeros((batch, s.d_conv - 1, conv_width(cfg)),
                             dtype=dtype, device=device),
            state=torch.zeros((batch, H, s.d_state, s.head_dim),
                              dtype=torch.float32, device=device),
            index=0)


def conv_width(cfg) -> int:
    """Channels of the causal conv: x, B and C (di + 2GN)."""
    s = cfg.ssm
    return s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state


def ssm_defs(cfg) -> Dict:
    d = cfg.d_model
    s = cfg.ssm
    di = s.d_inner(d)
    GN = s.n_groups * s.d_state
    H = s.n_heads(d)
    return {
        "wz": ParamDef((d, di), ("d_model", "d_ff")),
        "wx": ParamDef((d, di), ("d_model", "d_ff")),
        "wB": ParamDef((d, GN), ("d_model", "ssm_state")),
        "wC": ParamDef((d, GN), ("d_model", "ssm_state")),
        "wdt": ParamDef((d, H), ("d_model", "ssm_heads")),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "D": ParamDef((H,), ("ssm_heads",), init="ones"),
        "conv_w": ParamDef((s.d_conv, di + 2 * GN), ("conv_k", "d_ff"),
                           scale=0.5),
        "norm": ParamDef((di,), ("d_ff",), init="ones"),
        "out_proj": ParamDef((di, d), ("d_ff", "d_model")),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xbc: (B, S, W); w: (k, W).

    Returns (out (B,S,W), new_conv_state (B, k-1, W))."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                  # (B, S+k-1, W)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else xp[:, :0, :]
    return F.silu(out.float()).to(xbc.dtype), new_state


def _check_ssm_in(lora_ctx, di: int) -> None:
    """An ``ssm_in`` bank is sized by ``lora.target_dims`` at the published
    in-projection width (2·di + 2·G·N + H), but its delta is added to the
    x branch alone (width di), as in the JAX module, where such a bank
    fails to reshape (ROADMAP queue 3).  Refuse it by name here."""
    if lora_ctx is None or lora_ctx.params is None \
            or "ssm_in" not in lora_ctx.params:
        return
    p = lora_ctx.params["ssm_in"]
    bank = next(p[k] for k in ("b", "B", "U") if k in p)
    width = bank.shape[-2]
    if width != di:
        raise ValueError(
            f"an ssm_in adapter of output width {width} cannot be applied: "
            f"its delta is added to the SSM's x branch of width {di} (the "
            f"width lora.target_dims gives is the whole in-projection's)")


def _project(p: Dict, x: torch.Tensor, cfg, lora_ctx):
    """x: (B,S,d) -> z (B,S,di), the conv's input in its three parts (x
    (B,S,di), B and C (B,S,GN)) and dt (B,S,H)."""
    z = torch.einsum("bsd,de->bse", x, p["wz"])
    xs = torch.einsum("bsd,de->bse", x, p["wx"])
    if lora_ctx is not None:
        _check_ssm_in(lora_ctx, xs.shape[-1])
        xs = lora_mod.apply(lora_ctx, "ssm_in", x, xs)
    bb = torch.einsum("bsd,de->bse", x, p["wB"])
    cc = torch.einsum("bsd,de->bse", x, p["wC"])
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"]).float()
    dt = F.softplus(dt + p["dt_bias"].float())
    return z, (xs, bb, cc), dt


def _conv_parts(parts, w: torch.Tensor):
    """:func:`_causal_conv` over the parts' concatenation, part by part (a
    depthwise conv: each channel alike), so that the x part keeps its
    sharding over the model axis in the sharded step, where a concatenation
    with the replicated B and C would replicate it.  Returns (the parts'
    outputs, the concatenation's new conv state)."""
    outs, states, o = [], [], 0
    for t in parts:
        n = t.shape[-1]
        out, st = _causal_conv(t, w[:, o:o + n])
        outs.append(out)
        states.append(st)
        o += n
    return outs, torch.cat(states, dim=-1)


def _split_xbc(xbc: torch.Tensor, cfg):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    GN = s.n_groups * s.d_state
    B_, S_ = xbc.shape[:2]
    H = s.n_heads(cfg.d_model)
    xh = xbc[..., :di].reshape(B_, S_, H, s.head_dim)
    bg = xbc[..., di:di + GN].reshape(B_, S_, s.n_groups, s.d_state)
    cg = xbc[..., di + GN:].reshape(B_, S_, s.n_groups, s.d_state)
    return xh, bg, cg


def _decay(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_scan(xh: torch.Tensor, bg: torch.Tensor, cg: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xh: (B,S,H,P); bg/cg: (B,S,G,N); dt: (B,S,H);
    A: (H,) < 0.  On DTensors, on each rank's own heads
    (:func:`_ssd_island`).

    Returns (y (B,S,H,P) f32, final_state (B,H,N,P) f32)."""
    if is_dtensor(xh):
        return _ssd_island(lambda *a: ssd_scan(*a[:5], chunk, a[5]), xh,
                           bg, cg, dt, A, init_state)
    B, S, H, P = xh.shape
    G, N = bg.shape[2], bg.shape[3]
    hpg = H // G
    Q = min(chunk, S)
    if S % Q:
        # pad with dt = 0 steps: decay factor exp(0) = 1 and zero state
        # contribution, so padding is exact; slice y back afterwards
        pad = Q - S % Q
        y, final = ssd_scan(F.pad(xh, (0, 0, 0, 0, 0, pad)),
                            F.pad(bg, (0, 0, 0, 0, 0, pad)),
                            F.pad(cg, (0, 0, 0, 0, 0, pad)),
                            F.pad(dt, (0, 0, 0, pad)), A, chunk, init_state)
        return y[:, :S], final
    nc = S // Q
    # heads laid out as (G, hpg): head h belongs to group h // hpg
    xf = xh.float().reshape(B, nc, Q, G, hpg, P)
    bf = bg.float().reshape(B, nc, Q, G, N)
    cf = cg.float().reshape(B, nc, Q, G, N)
    dtc = dt.reshape(B, nc, Q, G, hpg)
    dA = dtc * A.reshape(G, hpg)[None, None, None]     # (B,nc,Q,G,hpg) <= 0
    cum = torch.cumsum(dA, dim=2)                      # inclusive
    # intra-chunk: M[...,i,j] = C_i.B_j * exp(cum_i - cum_j) * dt_j  (i>=j)
    cb = torch.einsum("bcign,bcjgn->bcgij", cf, bf)    # (B,nc,G,Q,Q)
    ii = torch.arange(Q, device=xh.device)
    cum_h = cum.permute(0, 1, 3, 4, 2)                 # (B,nc,G,hpg,Q)
    decay = _decay(cum_h[..., :, None] - cum_h[..., None, :])
    mask = ii[:, None] >= ii[None, :]
    M = cb[:, :, :, None] * torch.where(mask, decay, 0.0) \
        * dtc.permute(0, 1, 3, 4, 2)[..., None, :]    # (B,nc,G,hpg,Q,Q)
    y_intra = torch.einsum("bcghij,bcjghp->bcighp", M, xf)
    # chunk state: sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    seg = _decay(cum[:, :, -1:] - cum) * dtc           # (B,nc,Q,G,hpg)
    bx = torch.einsum("bcjgn,bcjgh,bcjghp->bcghnp", bf, seg, xf)
    total_decay = _decay(cum[:, :, -1])                # (B,nc,G,hpg)
    state = (torch.zeros((B, G, hpg, N, P), device=xh.device)
             if init_state is None
             else init_state.float().reshape(B, G, hpg, N, P))
    prev = []                                          # state BEFORE chunk
    for c in range(nc):
        prev.append(state)
        state = state * total_decay[:, c, ..., None, None] + bx[:, c]
    prev_states = torch.stack(prev, dim=1)             # (B,nc,G,hpg,N,P)
    y_inter = torch.einsum("bcign,bcghnp,bcigh->bcighp", cf, prev_states,
                           _decay(cum))
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, state.reshape(B, H, N, P)


def _ssd_island(fn, xh, bg, cg, dt, A, state):
    """``fn(xh, bg, cg, dt, A, state)`` (:func:`ssd_scan` or
    :func:`ssd_decode_step`) on each rank's own heads of DTensors
    (``sharding.head_blocks``: the groups as a GQA's kv heads; the batch as
    xh's), returning (y, state) over the same heads: DTensor cannot carry
    the scan's head-grouping views and batched products."""
    from torch.distributed.tensor import Replicate, Shard
    pl_x, pl_g, narrow = head_blocks(xh, bg)
    md = mesh_dim(xh, "model")
    heads = md is not None and isinstance(pl_x[md], Shard)
    pl_a = [Shard(0) if heads and i == md else Replicate()
            for i in range(len(pl_x))]
    pl_s = [Shard(1) if heads and i == md else p
            for i, p in enumerate(pl_x)]
    pairs = [(xh, pl_x), (bg, pl_g), (cg, pl_g), (dt, pl_x), (A, pl_a)]
    if state is not None:
        pairs.append((state, pl_s))
    loc = island_locals(*pairs)
    if narrow is not None:
        loc[1], loc[2] = (t.narrow(2, *narrow) for t in loc[1:3])
    y, st = fn(*loc[:5], loc[5] if state is not None else None)
    B, H, P = xh.shape[0], xh.shape[2], xh.shape[3]
    return (island_out(y, xh, pl_x, xh.shape),
            island_out(st, xh, pl_s, (B, H, bg.shape[3], P)))


def ssd_decode_step(xh, bg, cg, dt, A, state):
    """Single-token recurrence.  xh: (B,1,H,P) etc.  state: (B,H,N,P).
    On DTensors, on each rank's own heads (:func:`_ssd_island`)."""
    if is_dtensor(xh):
        return _ssd_island(ssd_decode_step, xh, bg, cg, dt, A, state)
    H = xh.shape[2]
    hpg = H // bg.shape[2]
    xf = xh[:, 0].float()                              # (B,H,P)
    bf = torch.repeat_interleave(bg[:, 0].float(), hpg, dim=1)   # (B,H,N)
    cf = torch.repeat_interleave(cg[:, 0].float(), hpg, dim=1)
    dtf = dt[:, 0]                                     # (B,H)
    decay = _decay(dtf * A[None, :])
    new_state = state * decay[:, :, None, None] + \
        torch.einsum("bhn,bh,bhp->bhnp", bf, dtf, xf)
    y = torch.einsum("bhn,bhnp->bhp", cf, new_state)
    return y[:, None], new_state                       # (B,1,H,P)


def ssm_block_fwd(p: Dict, x: torch.Tensor, cfg, *, mode: str = "train",
                  cache: Optional[SSMCache] = None, lora_ctx=None
                  ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full Mamba2 block: proj -> causal conv -> SSD -> gated norm -> out.
    Prefill starts from zero conv and SSM states, as the JAX module does;
    ``cache`` is not mutated."""
    B, S, _ = x.shape
    s = cfg.ssm
    A = -torch.exp(p["A_log"].float())
    z, parts, dt = _project(p, x, cfg, lora_ctx)

    new_cache = None
    if mode == "decode":
        if cache is None:
            raise ValueError("ssm decode needs a cache")
        xbc = torch.cat(parts, dim=-1)
        full = torch.cat([cache.conv.to(xbc.dtype), xbc], dim=1)
        conv_out = torch.einsum("bkw,kw->bw", full[:, -s.d_conv:, :],
                                p["conv_w"])
        conv_out = F.silu(conv_out.float()).to(xbc.dtype)[:, None]
        xh, bg, cg = _split_xbc(conv_out, cfg)
        y, new_state = ssd_decode_step(xh, bg, cg, dt, A, cache.state)
        new_cache = SSMCache(
            conv=full[:, -(s.d_conv - 1):, :].to(cache.conv.dtype),
            state=new_state, index=cache.index + 1)
    else:
        (xs, bs, cs), conv_state = _conv_parts(parts, p["conv_w"])
        xh = xs.reshape(B, S, s.n_heads(cfg.d_model), s.head_dim)
        bg, cg = (t.reshape(B, S, s.n_groups, s.d_state) for t in (bs, cs))
        xh = constrain(xh, "batch", "seq", "ssm_heads", None)
        y, final_state = ssd_scan(xh, bg, cg, dt, A, s.chunk)
        if mode == "prefill":
            if cache is None:
                raise ValueError("ssm prefill needs a cache")
            new_cache = SSMCache(conv=conv_state.to(cache.conv.dtype),
                                 state=final_state, index=S)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = constrain(y.reshape(B, S, -1).to(x.dtype), "batch", "seq", "d_ff")
    y = y * F.silu(constrain(z, "batch", "seq", "d_ff").float()).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    y = constrain(y, "batch", "seq", "d_ff")
    out = whole_grad(torch.einsum("bse,ed->bsd", y, p["out_proj"]))
    if lora_ctx is not None:
        out = lora_mod.apply(lora_ctx, "ssm_out", y, out)
    return constrain(out, "batch", "seq", "d_model"), new_cache
