"""AdamW with f32 master weights and moments (the port of
``repro/training/optimizer.py``).

The optimizer state mirrors the parameter tree (nested dicts of tensors):
``{"master", "mu", "nu"}`` in f32 and an int32 ``count``.  Every constant
enters the arithmetic as an f32 tensor on the parameters' device, as JAX
rounds a Python scalar to the array's f32: a Python float in a torch op
may be applied otherwise (CUDA divides by a scalar as a multiply by its
reciprocal), and the schedule and bias corrections are computed in f32
from the int32 count, never in Python's f64.  :func:`abstract_opt_state`
gives the state as ``meta`` tensors and :func:`opt_state_specs` its
partition specs, which mirror the parameters'.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ..distributed.sharding import P
from ..models.param import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 (``step`` an integer tensor)."""
    step = step.float()
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), step),
                         _f32(1.0, step))
    t = torch.clamp((step - _f32(cfg.warmup_steps, step))
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
                    0.0, 1.0)
    # Python evaluates (1 - min_lr_ratio) * 0.5 before the array enters
    cos = _f32(cfg.min_lr_ratio, step) + _f32(
        (1 - cfg.min_lr_ratio) * 0.5, step) * (
        _f32(1.0, step) + torch.cos(_f32(math.pi, step) * t))
    return _f32(cfg.lr, step) * warm * cos


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def init_opt_state(params) -> Dict[str, Any]:
    """The state of a parameter tree; of DTensors, each leaf in its
    parameter's placements and ``count`` replicated on their mesh."""
    leaf = tree_leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if isinstance(leaf, DTensor):
        count = distribute_tensor(count, leaf.device_mesh,
                                  [Replicate()] * leaf.device_mesh.ndim)
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           params),
        "mu": tree_map(_zeros_f32, params),
        "nu": tree_map(_zeros_f32, params),
        "count": count,
    }


def abstract_opt_state(params_struct) -> Dict[str, Any]:
    """The state of a parameter tree (of tensors, meta or not) as ``meta``
    tensors: f32 ``master``/``mu``/``nu`` and an int32 ``count``."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {
        "master": tree_map(f32, params_struct),
        "mu": tree_map(f32, params_struct),
        "nu": tree_map(f32, params_struct),
        "count": torch.empty((), dtype=torch.int32, device="meta"),
    }


def opt_state_specs(param_spec_tree) -> Dict[str, Any]:
    """Optimizer-state partition specs mirror the parameters'."""
    return {
        "master": param_spec_tree,
        "mu": param_spec_tree,
        "nu": param_spec_tree,
        "count": P(),
    }


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_update(cfg: AdamWConfig, grads, opt_state,
                 param_dtype=torch.bfloat16):
    """One AdamW step.  Returns (new_params, new_opt_state, metrics)."""
    with torch.no_grad():
        count = opt_state["count"] + 1
        gnorm = global_norm(grads)
        one = _f32(1.0, gnorm)
        scale = (torch.minimum(one, _f32(cfg.grad_clip, gnorm)
                               / torch.clamp(gnorm, min=1e-12))
                 if cfg.grad_clip > 0 else one)
        lr = lr_at(cfg, count)
        cf = count.float()
        b1c = one - torch.pow(_f32(cfg.b1, cf), cf)
        b2c = one - torch.pow(_f32(cfg.b2, cf), cf)
        b1, b2 = _f32(cfg.b1, cf), _f32(cfg.b2, cf)
        # (1 - b) is taken in Python, as the JAX module does
        ob1, ob2 = _f32(1 - cfg.b1, cf), _f32(1 - cfg.b2, cf)
        eps, wd = _f32(cfg.eps, cf), _f32(cfg.weight_decay, cf)

        def upd(g, m, mu, nu):
            g = g.float() * scale
            mu = b1 * mu + ob1 * g
            nu = b2 * nu + ob2 * g * g
            step = (mu / b1c) / (torch.sqrt(nu / b2c) + eps)
            m = m - lr * (step + wd * m)
            return m, mu, nu

        def walk(g, m, mu, nu):
            if isinstance(g, dict):
                outs = {k: walk(g[k], m[k], mu[k], nu[k]) for k in g}
                return tuple({k: o[i] for k, o in outs.items()}
                             for i in range(3))
            return upd(g, m, mu, nu)

        master, mu, nu = walk(grads, opt_state["master"], opt_state["mu"],
                              opt_state["nu"])
        params = tree_map(lambda m: m.to(param_dtype), master)
    new_state = {"master": master, "mu": mu, "nu": nu, "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
