"""Public model API (the port of ``repro/models/api.py``): the inputs of
each (arch x shape) cell as ``meta`` tensors, and the step functions.

``input_specs(cfg, shape)`` gives every model input of the cell (the batch
and, for prefill and decode, the cache) with its shape and dtype and no
storage: what a dry run sizes and what ``launch/shardings.py`` lays out.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..training.step import make_train_step
from . import transformer as tf


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The step input batch of this cell as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def tok(b, s):
        return _meta((b, s), i32)

    if shape.kind == "train":
        if cfg.family == "audio":
            return {"frames": _meta((B, S, cfg.d_model), bf16),
                    "tokens": tok(B, S), "targets": tok(B, S)}
        if cfg.family == "vlm":
            npch = cfg.vlm.num_patches
            return {"tokens": tok(B, S - npch),
                    "patches": _meta((B, npch, cfg.d_model), bf16),
                    "targets": tok(B, S - npch)}
        return {"tokens": tok(B, S), "targets": tok(B, S)}
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"frames": _meta((B, S, cfg.d_model), bf16),
                    "tokens": tok(B, S)}
        if cfg.family == "vlm":
            npch = cfg.vlm.num_patches
            return {"tokens": tok(B, S - npch),
                    "patches": _meta((B, npch, cfg.d_model), bf16)}
        return {"tokens": tok(B, S)}
    # decode: one new token against a cache of seq_len
    return {"tokens": tok(B, 1)}


def cache_struct(cfg: ModelConfig, shape: ShapeConfig) -> Optional[Dict]:
    """The cell's decode cache as ``meta`` tensors (``index`` an int32
    scalar, where the port's live cache keeps a Python int); None for a
    train cell."""
    if shape.kind == "train":
        return None
    B, S = shape.global_batch, shape.seq_len
    enc_len = S if cfg.family == "audio" else 0
    cache = tf.init_cache(cfg, B, S, device="meta", enc_len=enc_len)
    cache["index"] = _meta((), torch.int32)
    return cache


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All step inputs (batch + cache when applicable) as ``meta``
    tensors."""
    out = {"batch": batch_struct(cfg, shape)}
    c = cache_struct(cfg, shape)
    if c is not None:
        out["cache"] = c
    return out


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch, lora_params=None, lora_ctx_proto=None):
        return tf.lm_loss(params, batch, cfg, lora_params=lora_params,
                          lora_ctx_proto=lora_ctx_proto)
    return loss_fn


def make_prefill_fn(cfg: ModelConfig):
    def prefill_fn(params, batch, cache, lora_params=None,
                   lora_ctx_proto=None):
        return tf.prefill(params, batch, cfg, cache, lora_params=lora_params,
                          lora_ctx_proto=lora_ctx_proto)
    return prefill_fn


def make_decode_fn(cfg: ModelConfig):
    def decode_fn(params, batch, cache, lora_params=None,
                  lora_ctx_proto=None):
        return tf.decode_step(params, batch["tokens"], cfg, cache,
                              lora_params=lora_params,
                              lora_ctx_proto=lora_ctx_proto)
    return decode_fn


def step_fn_for(cfg: ModelConfig, shape: ShapeConfig, with_opt: bool = True):
    """The step function of this cell: a full train step (fwd + bwd + AdamW)
    for a train cell, the serve step for a prefill or decode cell."""
    if shape.kind == "train":
        return make_train_step(cfg, with_opt=with_opt)
    if shape.kind == "prefill":
        return make_prefill_fn(cfg)
    return make_decode_fn(cfg)
