"""LoRA application inside model layers (the port of ``models/lora.py``),
in three modes:

- ``single``:  one adapter, training / single-tenant serving.
- ``batched``: uncompressed multi-LoRA serving; per-sequence adapter ids
  select (A_i, B_i) from stacked banks (the vLLM-multi-LoRA baseline).
- ``jd``:      compressed serving; shared (possibly clustered) bases U, V +
  per-adapter Sigma (the paper's method).

Per-sequence gathers (ids are (B,)); bank layouts are the JAX package's:
``A (n, r, d_in)``, ``B (n, d_out, r)``, ``U (k, d_out, r)``,
``V (k, d_in, r)``, ``sigma (n, r)`` or ``(n, r, r)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..kernels import jd_delta
from ..kernels.ref import jd_delta_ref
from ..spans import count, span
from .param import ParamDef


@dataclasses.dataclass
class LoRAContext:
    mode: str                             # single | batched | jd
    params: Optional[Dict[str, Any]]      # target -> tensors
    ids: Optional[torch.Tensor] = None    # (B,) adapter id per sequence
    scaling: float = 1.0


def single_lora_defs(d_in: int, d_out: int, rank: int) -> Dict:
    return {
        "a": ParamDef((rank, d_in), ("rank", "d_model"), scale=0.02),
        "b": ParamDef((d_out, rank), (None, "rank"), init="zeros"),
    }


def target_dims(cfg, target: str) -> tuple:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    if target in ("q", "xq"):
        return d, H * hd
    if target in ("k", "v", "xk", "xv"):
        return d, Kv * hd
    if target == "o":
        return H * hd, d
    if target == "ssm_in":
        s = cfg.ssm
        di = s.d_inner(d)
        return d, 2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d)
    if target == "ssm_out":
        return cfg.ssm.d_inner(d), d
    raise ValueError(target)


def lora_layer_defs(cfg, targets=None) -> Dict:
    targets = targets or cfg.lora.targets
    return {t: single_lora_defs(*target_dims(cfg, t), cfg.lora.rank)
            for t in targets}


def apply(ctx: Optional[LoRAContext], target: str, x: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """y + scaled LoRA delta for `target`; no-op when absent (one target
    of :func:`apply_group`)."""
    return apply_group(ctx, (target,), x, (y,))[0]


def apply_group(ctx: Optional[LoRAContext], targets: Sequence[str],
                x: torch.Tensor, ys: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
    """Each ``ys[i]`` plus the scaled delta of ``targets[i]``, for targets
    that all read ``x`` (q, k and v); a target without params passes its
    ``y`` through.  The delta is computed in x's dtype, cast to f32 before
    ``scaling``, then to y's.  Differentiable: training takes gradients to
    ``a`` and ``b`` of the ``single`` mode through it.

    Mode "jd" with no gradient to take, on inputs that
    ``kernels/jd_delta.py::refusal`` lists as the kernels' (the card, bf16,
    no DTensor), runs the group's hand-written kernels, which add the
    deltas into ``ys`` in place and return them; every other call (CPU,
    meta, DTensors, modes "single" and "batched", a gradient, f32
    activations) runs the plain einsums below.  A span ``adapter`` marks
    each call of the kernels (a group) and each target's einsums; counters
    ``adapter_kernel`` and ``adapter_plain`` add up the targets each path
    carried."""
    if ctx is None or ctx.params is None:
        return tuple(ys)
    present = [i for i, t in enumerate(targets) if t in ctx.params]
    if not present:
        return tuple(ys)
    banks = [ctx.params[targets[i]] for i in present]
    got = [ys[i] for i in present]
    xk = _kernel_input(ctx, x, got, banks)
    if xk is not None:
        with span("adapter"):
            count("adapter_kernel", len(present))
            jd_delta.jd_delta_(xk, got, banks, ctx.ids, ctx.scaling)
        return tuple(ys)
    count("adapter_plain", len(present))
    out = list(ys)
    for i, p in zip(present, banks):
        with span("adapter"):
            out[i] = plain(ctx, p, x, ys[i])
    return tuple(out)


def _kernel_input(ctx: LoRAContext, x: torch.Tensor, ys, banks
                  ) -> Optional[torch.Tensor]:
    """x as the kernels take it (contiguous) where the call goes to them:
    mode jd, no gradient to take, inputs they take; else None."""
    if ctx.mode != "jd" or x.device.type != "cuda":
        return None
    if torch.is_grad_enabled() and (
            x.requires_grad or any(y.requires_grad for y in ys) or any(
                p[k].requires_grad for p in banks
                for k in ("U", "V", "sigma"))):
        return None
    x = x.contiguous()
    return x if jd_delta.takes(x, ys, banks, ctx.ids) else None


def plain(ctx: LoRAContext, p: Dict[str, Any], x: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """One target's einsum path: y plus its scaled delta, a new tensor."""
    dt = x.dtype
    if ctx.mode == "single":
        t = torch.einsum("bsd,rd->bsr", x, p["a"].to(dt))
        delta = torch.einsum("bsr,or->bso", t, p["b"].to(dt))
    elif ctx.mode == "batched":
        A = p["A"][ctx.ids].to(dt)               # (B, r, d_in)
        Bm = p["B"][ctx.ids].to(dt)              # (B, d_out, r)
        t = torch.einsum("bsd,brd->bsr", x, A)
        delta = torch.einsum("bsr,bor->bso", t, Bm)
    elif ctx.mode == "jd":
        delta = jd_delta_ref(x, p["U"], p["V"], p["sigma"], p["cluster_of"],
                             ctx.ids)
    else:
        raise ValueError(ctx.mode)
    delta = (ctx.scaling * delta.float()).to(y.dtype)
    return y + delta.reshape(y.shape)


def layer_slice(ctx: Optional[LoRAContext], layer_params
                ) -> Optional[LoRAContext]:
    """Rebind a context to one layer's adapter params."""
    if ctx is None or layer_params is None:
        return None
    return LoRAContext(mode=ctx.mode, params=layer_params, ids=ctx.ids,
                       scaling=ctx.scaling)
