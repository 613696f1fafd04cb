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
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class LoRAContext:
    mode: str                             # single | batched | jd
    params: Optional[Dict[str, Any]]      # target -> tensors
    ids: Optional[torch.Tensor] = None    # (B,) adapter id per sequence
    scaling: float = 1.0


def apply(ctx: Optional[LoRAContext], target: str, x: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """y + scaled LoRA delta for `target`; no-op when absent.  The delta is
    computed in x's dtype, cast to f32 before ``scaling``, then to y's."""
    if ctx is None or ctx.params is None or target not in ctx.params:
        return y
    p = ctx.params[target]
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
        cid = p["cluster_of"][ctx.ids].long()    # (B,)
        V = p["V"][cid].to(dt)                   # (B, d_in, r)
        U = p["U"][cid].to(dt)                   # (B, d_out, r)
        sig = p["sigma"][ctx.ids].to(dt)         # (B, r, r) or (B, r)
        t = torch.einsum("bsd,bdr->bsr", x, V)
        if sig.ndim == 2:                        # JD-Diag
            t = t * sig[:, None, :]
        else:                                    # JD-Full
            t = torch.einsum("bsr,brq->bsq", t, sig)
        delta = torch.einsum("bsr,bor->bso", t, U)
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
