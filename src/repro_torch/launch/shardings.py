"""Per-cell sharding assembly (the port of ``launch/shardings.py``):
params (TP, or TP + FSDP for training), batch, cache and optimizer state,
as trees of ``NamedSharding`` on a mesh (a description or one with a
DeviceMesh)."""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig
from ..distributed.sharding import DEFAULT_RULES, Mesh, NamedSharding, P, \
    spec_for
from ..models.param import tree_leaves, tree_map

# FSDP: weight d_model dims additionally sharded over the batch axes (train)
TRAIN_PARAM_RULES = {**DEFAULT_RULES, "d_model": ("pod", "data")}
SERVE_PARAM_RULES = dict(DEFAULT_RULES)


def _bd(mesh: Mesh):
    names = tuple(n for n in ("pod", "data") if n in mesh.shape)
    return names if len(names) > 1 else (names[0] if names else None)


def _div(dim: int, mesh: Mesh, axis) -> bool:
    if axis is None:
        return False
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh.shape.get(a, 1)
    return size > 1 and dim % size == 0


def param_rules_for(kind: str) -> Dict:
    return TRAIN_PARAM_RULES if kind == "train" else SERVE_PARAM_RULES


def params_shardings(defs, mesh: Mesh, kind: str):
    rules = param_rules_for(kind)
    return tree_map(
        lambda d: NamedSharding(mesh, spec_for(d.shape, d.axes, mesh, rules)),
        defs)


def batch_shardings(batch_struct: Dict, mesh: Mesh):
    bd = _bd(mesh)

    def one(s):
        b = s.shape[0]
        first = bd if _div(b, mesh, bd) else None
        return NamedSharding(mesh, P(first, *([None] * (len(s.shape) - 1))))

    return tree_map(one, batch_struct)


def cache_shardings(cache_struct: Dict, cfg: ModelConfig, mesh: Mesh):
    bd = _bd(mesh)
    m = mesh.shape.get("model", 1)

    def kv_spec(s):
        *lead, B, S, Kv, hd = s.shape
        bspec = bd if _div(B, mesh, bd) else None
        if Kv % m == 0 and m > 1:
            return P(*([None] * len(lead)), bspec, None, "model", None)
        if S % m == 0 and m > 1:
            return P(*([None] * len(lead)), bspec, "model", None, None)
        return P(*([None] * len(lead)), bspec, None, None, None)

    def conv_spec(s):
        *lead, B, K, W = s.shape
        bspec = bd if _div(B, mesh, bd) else None
        wspec = "model" if (W % m == 0 and m > 1) else None
        return P(*([None] * len(lead)), bspec, None, wspec)

    def state_spec(s):
        *lead, B, H, N, Pdim = s.shape
        bspec = bd if _div(B, mesh, bd) else None
        hspec = "model" if (H % m == 0 and m > 1) else None
        return P(*([None] * len(lead)), bspec, hspec, None, None)

    out = {}
    for key, s in cache_struct.items():
        if key == "index":
            out[key] = NamedSharding(mesh, P())
        elif key in ("k", "v", "cross_k", "cross_v"):
            out[key] = NamedSharding(mesh, kv_spec(s))
        elif key == "conv":
            out[key] = NamedSharding(mesh, conv_spec(s))
        elif key == "state":
            out[key] = NamedSharding(mesh, state_spec(s))
        else:
            raise KeyError(key)
    return out


def opt_shardings(param_sh):
    return {
        "master": param_sh,
        "mu": param_sh,
        "nu": param_sh,
        "count": _replicated_like(param_sh),
    }


def _replicated_like(param_sh):
    leaf = tree_leaves(param_sh)[0]
    return NamedSharding(leaf.mesh, P())

