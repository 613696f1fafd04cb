"""Model assembly for the dense family (the port of the ``dense``/``vlm``
branches of ``models/transformer.py``).

``model_defs(cfg)`` builds the ParamDef tree; ``forward`` runs it in
prefill or decode mode with an optional LoRA context.  Layers run as a
Python loop over the stacked (leading layer axis) parameters.  The cache is
``{"k", "v": (L, B, S_max, Kv, hd), "index": int}``: the index is one
scalar shared by all slots, kept as a Python int so that no step has to
read it back from the device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import lora as lora_mod
from .layers import (attention_defs, attention_fwd, embed_tokens,
                     embedding_defs, logits_fwd, mlp_defs, mlp_fwd, rms_norm)
from .param import ParamDef, stacked, tree_map


def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("d_model",), init="ones")


def _attn_block_defs(cfg) -> Dict:
    return {"ln1": _norm_def(cfg.d_model), "attn": attention_defs(cfg),
            "ln2": _norm_def(cfg.d_model),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff)}


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"the port runs the dense family only, not {cfg.family!r}")


def model_defs(cfg) -> Dict:
    _check_family(cfg)
    return {"embed": embedding_defs(cfg),
            "layers": stacked(_attn_block_defs(cfg), cfg.num_layers)}


def init_cache(cfg, batch: int, s_max: int, *, device,
               dtype=torch.bfloat16) -> Dict[str, Any]:
    _check_family(cfg)
    shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def layer_params(tree, li: int):
    """Layer ``li``'s slice of a stacked parameter or adapter tree."""
    return tree_map(lambda a: a[li], tree)


def _dense_block(p, x, cfg, *, positions, mode, kv, lora_ctx):
    h, new_kv = attention_fwd(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                              cfg, positions=positions, mode=mode, cache=kv,
                              lora_ctx=lora_ctx)
    x = x + h
    x = x + mlp_fwd(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, new_kv


def forward(params: Dict, cfg, *, tokens: torch.Tensor, mode: str,
            cache: Dict, lora_params: Optional[Dict] = None,
            lora_ctx_proto: Optional[lora_mod.LoRAContext] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the model in ``prefill`` or ``decode`` mode.  Returns
    (hidden (B, S, d), new_cache); ``cache`` is not mutated.

    ``lora_params`` mirrors the layer structure (``{"layers": {target:
    stacked banks}}``); ``lora_ctx_proto`` carries mode/ids/scaling."""
    _check_family(cfg)
    if mode not in ("prefill", "decode"):
        raise ValueError(mode)
    x = embed_tokens(params["embed"], tokens)
    S = x.shape[1]
    index = int(cache["index"])
    positions = index + torch.arange(S, dtype=torch.int32, device=x.device)
    lora_stack = (lora_params or {}).get("layers")
    ks, vs = [], []
    for li in range(cfg.num_layers):
        p_l = layer_params(params["layers"], li)
        ctx = None
        if lora_stack is not None and lora_ctx_proto is not None:
            ctx = lora_mod.layer_slice(lora_ctx_proto,
                                       layer_params(lora_stack, li))
        kv = {"k": cache["k"][li], "v": cache["v"][li], "index": index}
        x, new_kv = _dense_block(p_l, x, cfg, positions=positions, mode=mode,
                                 kv=kv, lora_ctx=ctx)
        ks.append(new_kv["k"])
        vs.append(new_kv["v"])
    new_cache = dict(cache)
    new_cache.update(k=torch.stack(ks), v=torch.stack(vs), index=index + S)
    return x, new_cache


def prefill(params: Dict, batch: Dict, cfg, cache: Dict,
            lora_params=None, lora_ctx_proto=None):
    h, new_cache = forward(params, cfg, tokens=batch["tokens"],
                           mode="prefill", cache=cache,
                           lora_params=lora_params,
                           lora_ctx_proto=lora_ctx_proto)
    return logits_fwd(params["embed"], h[:, -1:], cfg), new_cache


def decode_step(params: Dict, tokens: torch.Tensor, cfg, cache: Dict,
                lora_params=None, lora_ctx_proto=None):
    h, new_cache = forward(params, cfg, tokens=tokens, mode="decode",
                           cache=cache, lora_params=lora_params,
                           lora_ctx_proto=lora_ctx_proto)
    return logits_fwd(params["embed"], h, cfg), new_cache
