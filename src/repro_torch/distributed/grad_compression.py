"""Compressed cross-replica gradient reduction (the port of
``distributed/grad_compression.py``): an int8 reduce-scatter and
all-gather in place of an f32 all-reduce.

Used for the data-parallel all-reduce of LoRA-adapter gradients: adapters
are small, but at 1000+ concurrent fine-tunes the aggregate traffic
matters.  The wire carries int8 chunks, moved with ``all_to_all_single``
(the reduce-scatter phase) and ``all_gather_into_tensor`` (the broadcast
phase), plus two f32 scales: 4x less traffic than an f32 all-reduce, with
an error bounded by 2/127 of the largest magnitude per hop.

The arithmetic is the JAX module's, operation for operation in f32
(divisions by a tensor on the data's device, never by a Python scalar,
which CUDA applies as a reciprocal multiply), so the int8 payloads equal
JAX's exactly.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.param import tree_map
from .sharding import Mesh, current_mesh


def _const(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.full((), c, dtype=torch.float32, device=x.device)


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x / torch.clamp(scale, min=1e-30) * _const(x, 127.0))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale / _const(scale, 127.0)


def compressed_psum(x: torch.Tensor, axis_name: str,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """int8 reduce-scatter + all-gather in place of a sum all-reduce of
    ``x`` over the ranks along ``axis_name`` of ``mesh`` (the current one
    by default).  Every rank passes its own ``x``; each gets the sum."""
    mesh = mesh or current_mesh()
    g = mesh.shape.get(axis_name, 1)
    if g == 1:
        return x
    group = mesh.group(axis_name)
    shape = x.shape
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % g
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(g, -1)
    # phase 1: a shared scale (max over the ranks keeps quantization
    # consistent across peers)
    scale = torch.amax(torch.abs(flat))
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = _quant(chunks, scale)                              # (g, n/g) int8
    # reduce-scatter: everyone sends chunk j to peer j
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)           # (g, n/g) int8
    part = torch.sum(_dequant(recv, scale), dim=0)         # my reduced chunk
    # broadcast phase: requantize the reduced chunk and all-gather
    scale2 = torch.amax(torch.abs(part))
    dist.all_reduce(scale2, op=dist.ReduceOp.MAX, group=group)
    q2 = _quant(part, scale2)
    full = torch.empty(g * q2.numel(), dtype=torch.int8, device=x.device)
    dist.all_gather_into_tensor(full, q2, group=group)     # (g * n/g,)
    out = _dequant(full, scale2)
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(x.dtype)


def compressed_psum_tree(tree: Any, axis_name: str,
                         mesh: Optional[Mesh] = None) -> Any:
    return tree_map(lambda x: compressed_psum(x, axis_name, mesh), tree)


def make_compressed_dp_allreduce(mesh: Mesh,
                                 axes: Sequence[str] = ("pod", "data")):
    """A function reducing a gradient tree over the mesh's data-parallel
    axes with int8 traffic: each axis in turn, the sum divided by the
    axis's size (the mean)."""
    names = tuple(a for a in axes if a in mesh.shape)
    if not names:
        return lambda tree: tree

    def reducer(tree):
        out = tree
        for a in names:
            out = tree_map(lambda x, a=a: compressed_psum(x, a, mesh)
                           / _const(x, float(mesh.shape[a])).to(x.dtype),
                           out)
        return out

    return reducer
