"""Mixture-of-Experts block (the port of ``models/moe.py``): shared experts
plus routed top-k experts.

- :func:`_moe_dense`: every expert processes every token, masked combine.
  It is the JAX module's one-device path of ``moe_fwd``, taken without a
  mesh (compute is O(E) per token).
- :func:`_moe_ep`: the expert-parallel path, taken under a mesh with a
  ``model`` axis (of any size, as in JAX).  Each rank dispatches its
  tokens to its own experts (or, where the model axis does not divide the
  experts, to its slice of every expert's ``expert_ff``) with
  :func:`_dispatch` / :func:`_expert_ffn` / :func:`_combine` (the JAX
  module's static capacity, trash bucket, trash slot and
  ``bucket_offset`` window), and a sum all-reduce over ``model`` adds the
  ranks' parts.

Token dropping follows the static-capacity discipline (``capacity_factor``
in the config); dropped tokens fall through on the residual.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import current_mesh
from .layers import mlp_defs, mlp_fwd
from .param import ParamDef

# where _route records its decisions inside a record_routes block
_ROUTES: Optional[List] = None


def moe_defs(cfg) -> Dict:
    d = cfg.d_model
    m = cfg.moe
    E, f = m.num_experts, m.d_ff_expert
    defs = {
        "router": ParamDef((d, E), ("d_model", "experts"), scale=0.02),
        "w_gate": ParamDef((E, d, f), ("experts", "d_model", "expert_ff")),
        "w_up": ParamDef((E, d, f), ("experts", "d_model", "expert_ff")),
        "w_down": ParamDef((E, f, d), ("experts", "expert_ff", "d_model")),
    }
    if m.num_shared:
        defs["shared"] = mlp_defs(d, m.num_shared * f)
    return defs


def _route(p: Dict, x: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router in f32: returns (topw (T,k), topi (T,k) int32, aux_loss)."""
    m = cfg.moe
    logits = torch.einsum("td,de->te", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, m.top_k, dim=-1)
    if _ROUTES is not None:
        # the k-th chosen probability less the first one left out
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        _ROUTES.append((topi.cpu(), (top[:, -2] - top[:, -1]).cpu()))
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balancing aux loss
    E = m.num_experts
    # one-hot as a comparison (jax.nn.one_hot's), on every device the same
    # ops: F.one_hot takes another decomposition on meta than on the card
    f_e = (topi[:, :1] == torch.arange(E, device=topi.device)).float().mean(0)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e)
    return topw, topi.to(torch.int32), aux


@contextlib.contextmanager
def record_routes():
    """Record every routing decision :func:`_route` makes inside the
    block: a list of ``(topi (T, k), margin (T,))`` per call, where the
    margin is how far each token's choice is from flipping."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def _moe_dense(p: Dict, x: torch.Tensor, topw: torch.Tensor,
               topi: torch.Tensor, cfg) -> torch.Tensor:
    """(T, d) tokens; computes every expert then combines."""
    E = cfg.moe.num_experts
    g = torch.einsum("td,edf->tef", x, p["w_gate"])
    u = torch.einsum("td,edf->tef", x, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    y_all = torch.einsum("tef,efd->ted", h, p["w_down"])   # (T, E, d)
    w_full = torch.zeros((x.shape[0], E), dtype=x.dtype, device=x.device)
    w_full = w_full.scatter(1, topi.long(), topw.to(x.dtype))
    return torch.einsum("ted,te->td", y_all, w_full)


def _dispatch(x: torch.Tensor, topi: torch.Tensor, capacity: int,
              n_buckets: int, bucket_offset: int = 0):
    """Scatter tokens into (n_buckets, capacity, d) by expert choice.

    Only choices with bucket id in [bucket_offset, bucket_offset+n_buckets)
    take part; everything else lands in a trash bucket or slot that is
    sliced off.  Returns (buf, eid, slot, valid) where eid/slot/valid are
    per choice (T*k,) in the original choice order (for combine)."""
    T, k = topi.shape
    d = x.shape[-1]
    dev = x.device
    flat = topi.reshape(-1).long() - bucket_offset
    inside = (flat >= 0) & (flat < n_buckets)
    eid = torch.where(inside, flat, torch.full_like(flat, n_buckets))
    order = torch.argsort(eid, stable=True)
    sorted_e = eid[order]
    counts = torch.bincount(eid, minlength=n_buckets + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[sorted_e]
    slot_sorted = torch.where((pos < capacity) & (sorted_e < n_buckets),
                              pos, torch.full_like(pos, capacity))
    buf = torch.zeros((n_buckets + 1, capacity + 1, d), dtype=x.dtype,
                      device=dev)
    buf[sorted_e, slot_sorted] = x[order // k]
    # per-choice mapping back in original order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    slot = slot_sorted[inv]
    valid = (slot < capacity) & inside
    return buf[:n_buckets, :capacity], eid, slot, valid


def _combine(y_buf: torch.Tensor, eid: torch.Tensor, slot: torch.Tensor,
             valid: torch.Tensor, topw: torch.Tensor) -> torch.Tensor:
    """Gather per-choice outputs and sum them weighted over k."""
    T, k = topw.shape
    n_buckets, capacity, d = y_buf.shape
    e = torch.clamp(eid, max=n_buckets - 1)
    s = torch.clamp(slot, max=capacity - 1)
    y = y_buf[e, s] * valid[:, None].to(y_buf.dtype)
    y = y.reshape(T, k, d) * topw[..., None].to(y_buf.dtype)
    return y.sum(dim=1)


def _expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """(E_loc, C, d) x per-expert weights -> (E_loc, C, d)."""
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    u = torch.einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.einsum("ecf,efd->ecd", h, w_down)


def _local(w: torch.Tensor, dim: int, full: int, n_loc: int,
           r: int) -> torch.Tensor:
    """Rank ``r``'s slice of ``n_loc`` along ``dim`` of a weight that is
    either whole (``full`` there) or already the rank's shard."""
    if w.shape[dim] == n_loc:
        return w
    if w.shape[dim] != full:
        raise ValueError(f"expert weight {tuple(w.shape)}: dim {dim} is "
                         f"neither {full} nor the shard's {n_loc}")
    return w.narrow(dim, r * n_loc, n_loc)


def _moe_ep(p: Dict, x: torch.Tensor, topw: torch.Tensor,
            topi: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """Expert-parallel MoE: each rank's experts (or ``expert_ff`` slice)
    on this rank's tokens, then a sum all-reduce over the model axis.

    ``x``/``topw``/``topi`` are this rank's tokens (its share of the
    batch over the mesh's other axes, replicated over ``model``); the
    expert weights are whole or already this rank's shard
    (``launch/shardings.py``).  The capacity is the JAX module's, from
    the tokens a rank holds."""
    m = cfg.moe
    E = m.num_experts
    M = mesh.shape.get("model", 1)
    expert_sharded = (E % M == 0) and M > 1
    E_loc = E // M if expert_sharded else E
    T_loc = max(x.shape[0], 1)
    capacity = max(int(T_loc * m.top_k / E * m.capacity_factor) + 1, 4)
    r = mesh.coordinate("model") if M > 1 else 0
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if expert_sharded:
        wg, wu, wd = (_local(w, 0, E, E_loc, r) for w in (wg, wu, wd))
        offset = r * E_loc
    else:
        f = m.d_ff_expert
        if f % M:
            raise ValueError(f"expert_ff {f} does not split over {M} ranks")
        wg, wu = (_local(w, 2, f, f // M, r) for w in (wg, wu))
        wd = _local(wd, 1, f, f // M, r)
        offset = 0
    buf, eid, slot, valid = _dispatch(x, topi, capacity, E_loc, offset)
    y_buf = _expert_ffn(buf, wg, wu, wd)
    y = _combine(y_buf, eid, slot, valid, topw)
    if M > 1:
        torch.distributed.all_reduce(y, group=mesh.group("model"))
    return y


def moe_fwd(p: Dict, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MoE layer on (B, S, d).  Returns (y, aux_loss)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    topw, topi, aux = _route(p, xt, cfg)
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        y = _moe_ep(p, xt, topw, topi, cfg, mesh)
    else:
        y = _moe_dense(p, xt, topw, topi, cfg)
    y = y.reshape(B, S, d)
    if cfg.moe.num_shared:
        y = y + mlp_fwd(p["shared"], x)
    return y, aux
