"""Model assembly for every architecture family (the port of
``models/transformer.py``): dense, vlm, moe, ssm, hybrid and audio.

``model_defs(cfg)`` builds the ParamDef tree; ``forward`` runs it in
train, prefill or decode mode with an optional LoRA context, and
``lm_loss`` is the training objective.  Layers run as a Python loop over
the stacked (leading layer axis) parameters, one step where the JAX
module scans one: a layer, or for the hybrid family a group of ``period``
SSM layers followed by the weight-shared attention block.  In train mode
each step is recomputed in the backward pass when ``cfg.remat`` is set,
and its input passes the bf16 gradient boundary when
``cfg.grad_cast_bf16`` is set, as the JAX scan's carry does.

Caches are dicts of stacked tensors plus ``"index"``, one scalar shared
by all slots, kept as a Python int so that no step has to read it back
from the device (a decode step under ``cfg.decode_attn == "lazy"`` writes
every layer's new token into the caller's stacked cache in place, once a
step; every other step leaves the caller's cache as it was):

- dense, vlm, moe: ``k``, ``v`` (L, B, S_max, Kv, hd);
- ssm: ``conv`` (L, B, d_conv-1, W) and ``state`` (L, B, H, N, P) f32;
- hybrid: ``conv``/``state`` (groups, period, B, ...) and ``k``/``v``
  (groups, B, S_max, Kv, hd), one KV slice per use of the shared block;
- audio: ``k``/``v`` and the encoder memory's ``cross_k``/``cross_v``
  (L, B, enc_len, Kv, hd), which prefill fills.

Inside the sharded step (``distributed/sharding.py::sharded_step``) the
parameters, batch and cache are DTensors: each step's input is held to
the JAX scan carry's layout (``batch``, ``seq_sp``, ``d_model``), each
block gathers its own weights over the batch axes first (FSDP, under the
train rules), and the lazy branch's splice writes each rank's own block
of the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding as shd
from ..distributed.sharding import constrain
from ..spans import span
from . import lora as lora_mod
from .layers import (attention_defs, attention_fwd, cross_attention_fwd,
                     _seq_whole, cross_entropy, embed_tokens, embedding_defs,
                     logits_fwd,
                     mlp_defs, mlp_fwd, naive_attention, rms_norm)
from .moe import moe_defs, moe_fwd
from .param import ParamDef, stacked, tree_map
from .ssm import SSMCache, conv_width, ssm_block_fwd, ssm_defs

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("d_model",), init="ones")


def _attn_block_defs(cfg) -> Dict:
    return {"ln1": _norm_def(cfg.d_model), "attn": attention_defs(cfg),
            "ln2": _norm_def(cfg.d_model),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff)}


def _moe_block_defs(cfg) -> Dict:
    return {"ln1": _norm_def(cfg.d_model), "attn": attention_defs(cfg),
            "ln2": _norm_def(cfg.d_model), "moe": moe_defs(cfg)}


def _ssm_block_defs(cfg) -> Dict:
    return {"ln1": _norm_def(cfg.d_model), "ssm": ssm_defs(cfg)}


def _decoder_block_defs(cfg) -> Dict:
    return {"ln1": _norm_def(cfg.d_model), "attn": attention_defs(cfg),
            "lnx": _norm_def(cfg.d_model), "xattn": attention_defs(cfg),
            "ln2": _norm_def(cfg.d_model),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff)}


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


def _dense_cfg(cfg):
    """The first-k-dense layers' config: their MLP is ``d_ff_dense`` wide."""
    return dataclasses.replace(cfg, d_ff=cfg.moe.d_ff_dense)


def _groups(cfg) -> int:
    return cfg.num_layers // cfg.hybrid.period


def model_defs(cfg) -> Dict:
    _check_family(cfg)
    defs: Dict[str, Any] = {"embed": embedding_defs(cfg)}
    L = cfg.num_layers
    if cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        if fk:
            defs["dense_layers"] = stacked(_attn_block_defs(_dense_cfg(cfg)),
                                           fk)
        defs["layers"] = stacked(_moe_block_defs(cfg), L - fk)
    elif cfg.family == "ssm":
        defs["layers"] = stacked(_ssm_block_defs(cfg), L)
    elif cfg.family == "hybrid":
        defs["layers"] = stacked(stacked(_ssm_block_defs(cfg),
                                         cfg.hybrid.period, None),
                                 _groups(cfg))
        defs["shared"] = _attn_block_defs(cfg)
    elif cfg.family == "audio":
        defs["enc_layers"] = stacked(_attn_block_defs(cfg),
                                     cfg.encdec.encoder_layers)
        defs["enc_norm"] = _norm_def(cfg.d_model)
        defs["layers"] = stacked(_decoder_block_defs(cfg), L)
    else:  # dense / vlm
        defs["layers"] = stacked(_attn_block_defs(cfg), L)
    return defs


def lora_defs_tree(cfg) -> Dict:
    """LoRA adapter ParamDefs mirroring the layer structure."""
    _check_family(cfg)
    targets = cfg.lora.targets
    if cfg.family == "hybrid":
        ssm_targets = tuple(t for t in targets if t.startswith("ssm"))
        attn_targets = tuple(t for t in targets if not t.startswith("ssm"))
        out = {}
        if ssm_targets:
            out["layers"] = stacked(
                stacked(lora_mod.lora_layer_defs(cfg, ssm_targets),
                        cfg.hybrid.period, None), _groups(cfg))
        if attn_targets:
            out["shared"] = lora_mod.lora_layer_defs(cfg, attn_targets)
        return out
    per = lora_mod.lora_layer_defs(cfg, targets)
    if cfg.family == "audio":
        return {"enc_layers": stacked(per, cfg.encdec.encoder_layers),
                "layers": stacked(per, cfg.num_layers)}
    if cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        out = {"layers": stacked(per, cfg.num_layers - fk)}
        if fk:
            out["dense_layers"] = stacked(per, fk)
        return out
    return {"layers": stacked(per, cfg.num_layers)}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, s_max: int, *, device, enc_len: int = 0,
               dtype=torch.bfloat16) -> Dict[str, Any]:
    """The family's decode cache, stacked over layers (see the module
    docstring); SSM states are f32 whatever ``dtype``."""
    _check_family(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    hd, Kv, L = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_layers
    cache: Dict[str, Any] = {"index": 0}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        lead = (L,) if cfg.family == "ssm" else (_groups(cfg),
                                                 cfg.hybrid.period)
        cache["conv"] = zeros(*lead, batch, s.d_conv - 1, conv_width(cfg))
        cache["state"] = zeros(*lead, batch, s.n_heads(cfg.d_model),
                               s.d_state, s.head_dim, dt=torch.float32)
    if cfg.family != "ssm":
        n_kv = _groups(cfg) if cfg.family == "hybrid" else L
        cache["k"] = zeros(n_kv, batch, s_max, Kv, hd)
        cache["v"] = zeros(n_kv, batch, s_max, Kv, hd)
    if cfg.family == "audio":
        cache["cross_k"] = zeros(L, batch, enc_len, Kv, hd)
        cache["cross_v"] = zeros(L, batch, enc_len, Kv, hd)
    return cache


def layer_params(tree, li: int):
    """Layer ``li``'s slice of a stacked parameter or adapter tree."""
    return tree_map(lambda a: a[li], tree)


# ---------------------------------------------------------------------------
# blocks (one layer)
# ---------------------------------------------------------------------------


def _norm(x, scale, cfg):
    """A block's normed input with its sequence whole (``_seq_whole``):
    the layer boundary holds it over the model axis (``_step``,
    Megatron-SP), and the heads-, d_ff- or expert-sharded work after it
    needs it gathered, as GSPMD gathers it."""
    return _seq_whole(rms_norm(x, scale, cfg.norm_eps))


def _dense_block(p, x, cfg, *, positions, mode, kv, lora_ctx, causal=True):
    p = shd.unshard_batch_axes(p)
    xin = _norm(x, p["ln1"], cfg)
    with span("attention"):
        h, new_kv = attention_fwd(p["attn"], xin, cfg, positions=positions,
                                  mode=mode, cache=kv, lora_ctx=lora_ctx,
                                  causal=causal)
    x = x + h
    x = x + mlp_fwd(p["mlp"], _norm(x, p["ln2"], cfg))
    return x, new_kv


def _moe_block(p, x, cfg, *, positions, mode, kv, lora_ctx):
    p = shd.unshard_batch_axes(p)
    xin = _norm(x, p["ln1"], cfg)
    with span("attention"):
        h, new_kv = attention_fwd(p["attn"], xin, cfg, positions=positions,
                                  mode=mode, cache=kv, lora_ctx=lora_ctx)
    x = x + h
    y, aux = moe_fwd(p["moe"], _norm(x, p["ln2"], cfg), cfg)
    return x + y, new_kv, aux


def _ssm_block(p, x, cfg, *, mode, cache, lora_ctx):
    p = shd.unshard_batch_axes(p)
    h, new_cache = ssm_block_fwd(p["ssm"], _norm(x, p["ln1"], cfg),
                                 cfg, mode=mode, cache=cache,
                                 lora_ctx=lora_ctx)
    return x + h, new_cache


# ---------------------------------------------------------------------------
# one scanned step: remat and the bf16 gradient boundary
# ---------------------------------------------------------------------------


class _BF16GradBoundary(torch.autograd.Function):
    """Identity forward; the backward rounds an f32 cotangent through bf16
    (the JAX module's ``_bf16_grad_boundary`` custom VJP)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.dtype == torch.float32:
            return g.to(torch.bfloat16).float()
        return g


def _bf16_grad_boundary(x: torch.Tensor) -> torch.Tensor:
    return _BF16GradBoundary.apply(x)


def _maybe_remat(fn, cfg, mode: str):
    """``fn(x) -> outputs`` recomputed in the backward pass (activation
    checkpointing) when ``cfg.remat`` is set in train mode.  A layer draws
    no random numbers, so the recompute keeps no RNG state (stashing it
    is host work that differs by device).  The recompute runs in the mesh
    context of the forward (it may run in another thread, where the
    thread-local context is not set)."""
    if cfg.remat and mode == "train":
        ctx = shd.context()

        def run(x):
            with shd.use_context(ctx):
                return fn(x)

        return lambda x: checkpoint(run, x, use_reentrant=False,
                                    preserve_rng_state=False)
    return fn


def _step(fn, x, cfg, mode: str):
    """One scanned step ``fn(x)``: its input held to the layer-boundary
    layout (Megatron-SP: the sequence over the model axis, outside remat,
    as the JAX carry) and through the bf16 gradient boundary (when
    ``cfg.grad_cast_bf16`` is set), then ``fn`` under remat.  A step may
    record the cache leaves it makes: remat runs only in train mode,
    which makes none."""
    x = constrain(x, "batch", "seq_sp", "d_model")
    if cfg.grad_cast_bf16:
        x = _bf16_grad_boundary(x)
    return _maybe_remat(fn, cfg, mode)(x)


def _layer_ctx(proto, lora_stack, *idx):
    """The LoRA context of one layer (``idx`` indexes the stacked banks),
    or None without adapters there."""
    if lora_stack is None or proto is None:
        return None
    for i in idx:
        lora_stack = layer_params(lora_stack, i)
    return lora_mod.layer_slice(proto, lora_stack)


def _kv(cache, mode, li, index):
    if mode == "train":
        return None
    return {"k": cache["k"][li], "v": cache["v"][li], "index": index}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(params: Dict, cfg, *, tokens: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, mode: str,
            cache: Optional[Dict] = None,
            lora_params: Optional[Dict] = None,
            lora_ctx_proto: Optional[lora_mod.LoRAContext] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Run the model in ``train``, ``prefill`` or ``decode`` mode.  Returns
    (hidden (B, S, d), new_cache, aux_loss); train mode takes no cache and
    returns None.  ``cache`` is not mutated, except by a lazy decode step
    (``cfg.decode_attn == "lazy"``, one token, the dense and vlm
    families), which writes the step's new K/V rows into ``cache["k"]``
    and ``cache["v"]`` at ``index`` in place and returns them in
    ``new_cache``.  ``aux_loss`` is the MoE layers' mean load-balancing
    loss, 0 for the other families.

    ``patches`` (vlm: (B, P, d) embeddings put before the tokens) and
    ``frames`` (audio: (B, F, d) encoder input) are the stub front ends'
    outputs.  ``lora_params`` mirrors the layer structure (see
    :func:`lora_defs_tree`); ``lora_ctx_proto`` carries mode/ids/scaling."""
    _check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if mode != "train" and cache is None:
        raise ValueError(f"{mode} needs a cache")
    lazy = (mode == "decode" and cfg.decode_attn == "lazy"
            and tokens.shape[1] == 1 and cfg.family != "ssm")
    if lazy and cfg.family not in ("dense", "vlm"):
        raise ValueError(
            f"decode_attn 'lazy' on the {cfg.family} family: the JAX "
            f"package's {cfg.family} stack assigns each layer's output as the "
            f"whole cache, which under 'lazy' holds only the new token, so "
            f"the cache loses its history (ROADMAP queue 3); use 'gather'")
    lp = lora_params or {}
    if cfg.family == "audio":
        return _forward_audio(params, cfg, tokens=tokens, frames=frames,
                              mode=mode, cache=cache, lp=lp,
                              proto=lora_ctx_proto)

    x = embed_tokens(params["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        x = constrain(x, "batch", "seq", "d_model")
    S = x.shape[1]
    index = 0 if mode == "train" else int(cache["index"])
    positions = index + torch.arange(S, dtype=torch.int32, device=x.device)
    new = {}

    def attn_layers(x, p_stack, lora_stack, block_cfg, first, block):
        """Attention layers ``first``, ``first + 1``, ... of the cache;
        ``block`` is _dense_block or _moe_block (which adds its aux)."""
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n = p_stack["ln1"].shape[0]
        for i in range(n):
            kv = _kv(cache, mode, first + i, index)
            ctx = _layer_ctx(lora_ctx_proto, lora_stack, i)
            x, new_kv, *aux_l = _step(lambda x, i=i, kv=kv, ctx=ctx: block(
                layer_params(p_stack, i), x, block_cfg, positions=positions,
                mode=mode, kv=kv, lora_ctx=ctx), x, cfg, mode)
            if aux_l:
                aux_sum = aux_sum + aux_l[0]
            if new_kv is not None:
                new.setdefault("k", []).append(new_kv["k"])
                new.setdefault("v", []).append(new_kv["v"])
        return x, aux_sum

    def ssm_layer(x, p_l, c_idx, ctx):
        c = None if mode == "train" else SSMCache(
            conv=cache["conv"][c_idx], state=cache["state"][c_idx],
            index=index)
        x, new_c = _ssm_block(p_l, x, cfg, mode=mode, cache=c, lora_ctx=ctx)
        if new_c is not None:
            new.setdefault("conv", []).append(new_c.conv)
            new.setdefault("state", []).append(new_c.state)
        return x

    if cfg.family in ("dense", "vlm"):
        x, _ = attn_layers(x, params["layers"], lp.get("layers"), cfg, 0,
                           _dense_block)
    elif cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        if fk:
            x, _ = attn_layers(x, params["dense_layers"],
                               lp.get("dense_layers"), _dense_cfg(cfg), 0,
                               _dense_block)
        x, aux_acc = attn_layers(x, params["layers"], lp.get("layers"), cfg,
                                 fk, _moe_block)
        aux = aux + aux_acc / max(cfg.num_layers - fk, 1)
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            ctx = _layer_ctx(lora_ctx_proto, lp.get("layers"), li)
            x = _step(lambda x, li=li, ctx=ctx: ssm_layer(
                x, layer_params(params["layers"], li), li, ctx), x, cfg, mode)
    else:  # hybrid: period SSM layers, then the shared attention block
        shared_ctx = _layer_ctx(lora_ctx_proto, lp.get("shared"))

        def group(x, g):
            for i in range(cfg.hybrid.period):
                x = ssm_layer(x, layer_params(layer_params(
                    params["layers"], g), i), (g, i),
                    _layer_ctx(lora_ctx_proto, lp.get("layers"), g, i))
            x, new_kv = _dense_block(params["shared"], x, cfg,
                                     positions=positions, mode=mode,
                                     kv=_kv(cache, mode, g, index),
                                     lora_ctx=shared_ctx)
            if new_kv is not None:
                new.setdefault("k", []).append(new_kv["k"])
                new.setdefault("v", []).append(new_kv["v"])
            return x

        for g in range(_groups(cfg)):
            x = _step(lambda x, g=g: group(x, g), x, cfg, mode)

    if mode == "train":
        return x, None, aux
    new_cache = dict(cache)
    if lazy:
        # each layer's new token into the stacked cache, once a step; the
        # write lands past every position this step's attention read
        w = min(index, cache["k"].shape[2] - 1)
        for key in ("k", "v"):
            shd.write_slice(cache[key], torch.stack(new.pop(key)), w, 2,
                            inplace=True)
    for key, leaves in new.items():
        if cfg.family == "hybrid" and key in ("conv", "state"):
            # (groups * period) layers back to (groups, period, ...)
            stackd = torch.stack(leaves)
            new_cache[key] = stackd.reshape(
                (_groups(cfg), cfg.hybrid.period) + stackd.shape[1:])
        else:
            new_cache[key] = torch.stack(leaves)
    new_cache["index"] = index + S
    return x, new_cache, aux


def _forward_audio(params, cfg, *, tokens, frames, mode, cache, lp, proto):
    """whisper-style: encoder over frames, decoder over tokens with cross
    attention.  Decode attends over the cached ``cross_k``/``cross_v``
    (without the adapters' cross deltas, as in the JAX module); prefill
    fills them from the encoder memory."""
    index = 0 if mode == "train" else int(cache["index"])
    memory = None
    if frames is not None:
        h = frames
        pos_e = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        for i in range(cfg.encdec.encoder_layers):
            ctx = _layer_ctx(proto, lp.get("enc_layers"), i)
            h = _step(lambda h, i=i, ctx=ctx: _dense_block(
                layer_params(params["enc_layers"], i), h, cfg,
                positions=pos_e, mode="train", kv=None, lora_ctx=ctx,
                causal=False)[0], h, cfg, mode)
        memory = _norm(h, shd.unshard_batch_axes(params["enc_norm"]), cfg)
    elif mode != "decode":
        raise ValueError(f"the audio family's {mode} mode needs frames, the "
                         f"encoder's input")

    x = embed_tokens(params["embed"], tokens)
    S = x.shape[1]
    positions = index + torch.arange(S, dtype=torch.int32, device=x.device)
    new = {}

    def dec_layer(x, li, ctx):
        p_l = shd.unshard_batch_axes(layer_params(params["layers"], li))
        h, new_kv = attention_fwd(p_l["attn"],
                                  _norm(x, p_l["ln1"], cfg), cfg,
                                  positions=positions, mode=mode,
                                  cache=_kv(cache, mode, li, index),
                                  lora_ctx=ctx)
        x = x + h
        xin = _norm(x, p_l["lnx"], cfg)
        if mode == "decode":
            q = torch.einsum("bsd,dhk->bshk", xin, p_l["xattn"]["wq"])
            o = naive_attention(q, cache["cross_k"][li],
                                cache["cross_v"][li], causal=False)
            h2 = torch.einsum("bshk,hkd->bsd", o, p_l["xattn"]["wo"])
        else:
            h2 = cross_attention_fwd(p_l["xattn"], xin, memory, cfg,
                                     lora_ctx=ctx)
            if mode == "prefill":
                new.setdefault("cross_k", []).append(torch.einsum(
                    "bsd,dhk->bshk", memory, p_l["xattn"]["wk"]))
                new.setdefault("cross_v", []).append(torch.einsum(
                    "bsd,dhk->bshk", memory, p_l["xattn"]["wv"]))
        x = x + h2
        x = x + mlp_fwd(p_l["mlp"], _norm(x, p_l["ln2"], cfg))
        if new_kv is not None:
            new.setdefault("k", []).append(new_kv["k"])
            new.setdefault("v", []).append(new_kv["v"])
        return x

    for li in range(cfg.num_layers):
        ctx = _layer_ctx(proto, lp.get("layers"), li)
        x = _step(lambda x, li=li, ctx=ctx: dec_layer(x, li, ctx), x, cfg,
                  mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x, None, aux
    new_cache = dict(cache)
    new_cache.update({k: torch.stack(v) for k, v in new.items()})
    new_cache["index"] = index + S
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# public steps
# ---------------------------------------------------------------------------


def lm_loss(params: Dict, batch: Dict, cfg,
            lora_params: Optional[Dict] = None,
            lora_ctx_proto=None, aux_weight: float = 0.01) -> torch.Tensor:
    """Token-mean next-token CE of ``batch`` (``tokens``, ``targets`` with
    -1 where no loss is taken, optional ``loss_mask``, ``patches`` or
    ``frames``) plus ``aux_weight`` times the MoE aux loss."""
    h, _, aux = forward(params, cfg, tokens=batch.get("tokens"),
                        patches=batch.get("patches"),
                        frames=batch.get("frames"), mode="train",
                        lora_params=lora_params,
                        lora_ctx_proto=lora_ctx_proto)
    if cfg.family == "vlm" and batch.get("patches") is not None:
        h = h[:, batch["patches"].shape[1]:]
    loss = cross_entropy(params["embed"], h, batch["targets"], cfg,
                         mask=batch.get("loss_mask"))
    return loss + aux_weight * aux


def prefill(params: Dict, batch: Dict, cfg, cache: Dict,
            lora_params=None, lora_ctx_proto=None):
    h, new_cache, _ = forward(params, cfg, tokens=batch.get("tokens"),
                              patches=batch.get("patches"),
                              frames=batch.get("frames"), mode="prefill",
                              cache=cache, lora_params=lora_params,
                              lora_ctx_proto=lora_ctx_proto)
    return logits_fwd(params["embed"], h[:, -1:], cfg), new_cache


def decode_step(params: Dict, tokens: torch.Tensor, cfg, cache: Dict,
                lora_params=None, lora_ctx_proto=None):
    """One decode step: (logits (B, S, Vp), new_cache).  Under
    ``cfg.decode_attn == "lazy"`` (dense and vlm) the new token's K/V go
    into ``cache`` in place, with no per-layer copy of the cache, and
    ``new_cache`` holds the same tensors: a caller that keeps the old
    cache clones it first (the executor replaces its cache anyway)."""
    h, new_cache, _ = forward(params, cfg, tokens=tokens, mode="decode",
                              cache=cache, lora_params=lora_params,
                              lora_ctx_proto=lora_ctx_proto)
    return logits_fwd(params["embed"], h, cfg), new_cache
