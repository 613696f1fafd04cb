"""Train-step builders: full fine-tuning and LoRA-only fine-tuning, with
microbatched gradient accumulation (the port of ``repro/training/step.py``).

Gradients come from ``torch.autograd.grad`` over detached copies of the
trained tree's leaves, so the caller's tensors are never marked as
requiring grad.  As in the JAX module, one microbatch gives gradients in
the parameters' dtype, and more are accumulated in f32 as
``g.float() / n_micro``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import transformer as tf
from ..models.lora import LoRAContext
from ..models.param import tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_update


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(tree)


def _value_and_grad(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach has a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten_like(params, grads)


def _microbatch_grads(loss_fn, params, batch, n_micro: int):
    """Gradient accumulation over n_micro microbatches."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)

    def split(x):
        b = x.shape[0]
        return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    mb = {k: split(v) for k, v in batch.items()}
    leaf = tree_leaves(params)[0]
    n = torch.full((), n_micro, dtype=torch.float32, device=leaf.device)
    loss_acc = torch.zeros((), dtype=torch.float32, device=leaf.device)
    grads_acc = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(n_micro):
        loss, grads = _value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in mb.items()})
        grads_acc = _unflatten_like(params, [
            a + g.float() / n for a, g in zip(tree_leaves(grads_acc),
                                              tree_leaves(grads))])
        loss_acc = loss_acc + loss / n
    return loss_acc, grads_acc


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    n_micro: int = 1, with_opt: bool = True):
    """Full-model train step: loss -> grads -> AdamW.

    signature: step(params, opt_state, batch) -> (params, opt_state, metrics)
    (with_opt=False: step(params, batch) -> (loss, grads), for tests)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def loss_fn(params, batch):
        return tf.lm_loss(params, batch, cfg)

    if not with_opt:
        def grad_step(params, batch):
            return _microbatch_grads(loss_fn, params, batch, n_micro)
        return grad_step

    def step(params, opt_state, batch):
        loss, grads = _microbatch_grads(loss_fn, params, batch, n_micro)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_lora_train_step(cfg: ModelConfig,
                         opt_cfg: Optional[AdamWConfig] = None,
                         n_micro: int = 1):
    """LoRA fine-tuning: base params frozen, gradients over adapters only.

    signature: step(base_params, lora_params, opt_state, batch)
               -> (lora_params, opt_state, metrics)"""
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, weight_decay=0.0)
    scaling = cfg.lora.alpha / cfg.lora.rank
    proto = LoRAContext(mode="single", params=None, scaling=scaling)

    def step(base_params, lora_params, opt_state, batch):
        def loss_fn(lp, b):
            return tf.lm_loss(base_params, b, cfg, lora_params=lp,
                              lora_ctx_proto=proto)

        loss, grads = _microbatch_grads(loss_fn, lora_params, batch, n_micro)
        lora_params, opt_state, metrics = adamw_update(
            opt_cfg, grads, opt_state, param_dtype=torch.float32)
        metrics["loss"] = loss
        return lora_params, opt_state, metrics

    return step


def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                      n_batch_shards: int, budget_bytes: float = 2.5e9,
                      seq_shard: int = 1) -> int:
    """Pick a grad-accumulation factor so rematted layer inputs fit HBM.

    saved-per-layer ~= B_local/n x S x d_model x 2 bytes / seq_shard."""
    B_local = max(shape.global_batch // max(n_batch_shards, 1), 1)
    layers = cfg.num_layers * (2 if cfg.family == "audio" else 1)
    per_full = B_local * shape.seq_len * cfg.d_model * 2 * layers / seq_shard
    n = 1
    while per_full / n > budget_bytes and n < B_local:
        n *= 2
    return n
