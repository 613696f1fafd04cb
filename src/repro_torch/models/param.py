"""Minimal parameter-definition system (the port of ``models/param.py``).

Models are defined as nested dicts of :class:`ParamDef`; the same tree
yields (1) tensors on one device (:func:`init_params`), (2) partition specs
through the logical-axis rules (:func:`param_specs`), (3) tensors on the
``meta`` device for allocation-free shape checks (:func:`abstract_params`)
and (4) parameter counts (:func:`count_defs`).  Layouts are the JAX
package's, so weights carry across with a plain copy (``convert.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed.sharding import NamedSharding, spec_for

# the most elements drawn in one piece by init_params (2^28: 1 GiB of f32)
DRAW_PIECE = 1 << 28


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]           # logical axis per dim
    init: str = "normal"                      # normal | zeros | ones | small
    scale: Optional[float] = None             # stddev override
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict (dict keys are leaves'
    paths; anything that is not a dict is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (the order JAX flattens
    a dict pytree in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_params(defs, generator: torch.Generator, device,
                dtype_override=None):
    """Materialize a ParamDef tree into tensors on ``device``.

    The std rule is the JAX package's: ``scale`` when given, else
    ``1/sqrt(shape[0])`` for a matrix (for a stacked layer leaf that is
    the layer count) and ``1/sqrt(shape[-1])`` for a vector; ``small`` is
    ``0.02 * (scale or 1)``.  Draws are f32 normals from ``generator`` in
    sorted-key leaf order, made on the generator's own device (a CUDA
    generator keeps a 7B-parameter draw off the host), then cast and
    moved to ``device``.  A leaf is drawn in pieces of at most
    ``DRAW_PIECE`` elements (in memory order; a smaller leaf is one draw),
    so that a full-width expert bank needs no f32 copy of itself and every
    index stays under 2^31."""
    def one(d: ParamDef):
        dt = dtype_override or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        if d.init == "small":
            std = (d.scale or 1.0) * 0.02
        out = torch.empty(d.shape, dtype=dt, device=device)
        flat = out.view(-1)
        for i in range(0, flat.numel(), DRAW_PIECE):
            n = min(DRAW_PIECE, flat.numel() - i)
            x = torch.randn(n, generator=generator, dtype=torch.float32,
                            device=generator.device)
            flat[i:i + n] = (x * std).to(dtype=dt, device=device)
        return out

    out: Dict[str, Any] = {}

    def walk(src, dst):
        for k in sorted(src):
            v = src[k]
            if isinstance(v, dict):
                dst[k] = {}
                walk(v, dst[k])
            else:
                dst[k] = one(v)

    walk(defs, out)
    return out


def abstract_params(defs, dtype_override=None):
    """The tree as tensors on the ``meta`` device: shapes and dtypes, no
    storage."""
    return tree_map(lambda d: torch.empty(d.shape,
                                          dtype=dtype_override or d.dtype,
                                          device="meta"), defs)


def param_specs(defs, mesh=None):
    """Partition-spec tree resolved against a mesh (the current one by
    default)."""
    return tree_map(lambda d: spec_for(d.shape, d.axes, mesh), defs)


def param_shardings(defs, mesh):
    return tree_map(lambda d: NamedSharding(mesh, spec_for(d.shape, d.axes,
                                                           mesh)), defs)


def count_defs(defs) -> int:
    """Parameters in a ParamDef tree, as a Python integer (the JAX
    module's ``count_params`` counts in int32 and overflows past 2^31;
    it is not ported)."""
    total = 0
    for d in tree_leaves(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total


def stacked(defs: Dict, n: int, axis_name: Optional[str] = "layers"):
    """Add a leading stacking dim (one slice per layer) to every leaf; the
    hybrid family nests two (groups, then layers of a group, named None)."""
    return tree_map(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      axes=(axis_name,) + d.axes), defs)
