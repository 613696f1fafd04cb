"""Public model API: step functions (the port of ``repro/models/api.py``).

The JAX module's batch and cache structs (``batch_struct``,
``cache_struct``, ``input_specs``) serve its dry run and meshes, which the
port does not have yet.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..training.step import make_train_step
from . import transformer as tf


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
