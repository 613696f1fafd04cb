"""Minimal parameter-definition system (the port of ``models/param.py``).

Models are defined as nested dicts of :class:`ParamDef`; :func:`init_params`
materializes the tree into tensors on one device.  Layouts are the JAX
package's, so weights carry across with a plain copy (``convert.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


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
    moved to ``device``."""
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
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(dtype=dt, device=device)

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


def stacked(defs: Dict, n: int, axis_name: str = "layers"):
    """Add a leading stacking dim (one slice per layer) to every leaf."""
    return tree_map(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      axes=(axis_name,) + d.axes), defs)
