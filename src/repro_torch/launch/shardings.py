"""Per-cell sharding assembly (the port of ``launch/shardings.py``):
params (TP, or TP + FSDP for training), batch, cache and optimizer state,
as trees of ``NamedSharding`` on a mesh (a description or one with a
DeviceMesh); and :func:`sharded_step_for`, the cell's step over DTensors
placed by them (the JAX dry run's ``jax.jit(step, in_shardings=...)``),
with :func:`place_inputs` to lay its inputs out."""
from __future__ import annotations

from typing import Dict, Optional

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



def cell_shardings(cfg: ModelConfig, shape, mesh: Mesh) -> Dict:
    """The shardings of the cell's step inputs: ``params``, ``batch`` and
    ``opt_state`` (train) or ``cache`` (prefill, decode), as JAX's dry run
    gives them to ``jax.jit``."""
    from ..models import api, transformer as tf
    defs = tf.model_defs(cfg)
    out = {"params": params_shardings(defs, mesh, shape.kind),
           "batch": batch_shardings(api.batch_struct(cfg, shape), mesh)}
    if shape.kind == "train":
        out["opt_state"] = opt_shardings(out["params"])
    else:
        out["cache"] = cache_shardings(api.cache_struct(cfg, shape), cfg,
                                       mesh)
    return out


def place_inputs(cfg: ModelConfig, shape, mesh: Mesh, device="cpu",
                 **inputs) -> Dict:
    """``params``, ``batch``, ``cache`` and ``opt_state`` (any of them:
    trees of numpy arrays or tensors, whole on every rank) as DTensors on
    ``mesh``'s DeviceMesh under :func:`cell_shardings`: each rank keeps
    only its own block (``convert.to_dtensors``).  A cache's ``index``
    stays a host integer."""
    from ..convert import to_dtensors
    sh = cell_shardings(cfg, shape, mesh)
    return {k: to_dtensors(v, sh[k], device) for k, v in inputs.items()}


def sharded_step_for(cfg: ModelConfig, shape, mesh: Mesh, *,
                     n_micro: int = 1, opt_cfg=None):
    """The cell's step (``models/api.py::step_fn_for``: a full train step
    of ``n_micro`` microbatches, a prefill or a decode step) over DTensors
    placed on ``mesh`` by :func:`cell_shardings`, run inside
    ``sharding.sharded_step`` with the default activation rules, as JAX's
    dry run jits it under ``use_mesh``.  No adapters, as there.  The
    train step returns its parameters and state in their input
    placements; a serve step returns the logits over (``batch``,
    ``seq``, ``vocab``) and the new cache in the cache's placements."""
    from ..distributed.sharding import sharded_step
    from ..models import api
    from ..training.step import make_train_step
    if mesh.device_mesh is None:
        raise ValueError("the sharded step needs a mesh over a process "
                         "group (launch.mesh.device_mesh)")
    if shape.kind == "train":
        fn = make_train_step(cfg, opt_cfg, n_micro=n_micro)
    else:
        fn = api.step_fn_for(cfg, shape)

    def step(*args):
        with sharded_step(mesh):
            out = fn(*args)
            # the output shardings: the state as it came in
            if shape.kind == "train":
                return (_placed_as(out[0], args[0]),
                        _placed_as(out[1], args[1]), out[2])
            return out[0], _placed_as(out[1], args[2])

    return step


def _placed_as(tree, like):
    """``tree`` with each DTensor leaf in the placements of the leaf at the
    same place of ``like`` (JAX's ``out_shardings``)."""
    if isinstance(tree, dict):
        return {k: _placed_as(v, like[k]) for k, v in tree.items()}
    if hasattr(tree, "placements") and hasattr(like, "placements") and \
            tuple(tree.placements) != tuple(like.placements):
        return tree.redistribute(like.device_mesh, like.placements)
    return tree
