"""Carry parameter, adapter and optimizer-state trees across between numpy
and the port.

The JAX package's trees (parameters from ``models/param.py``, adapter
bundles from ``launch/serve.py`` or ``core/collection.py``) become nested
dicts of numpy arrays with ``np.asarray(leaf)``; :func:`to_torch` turns
such a tree into tensors on one device with the same layouts, bit for bit.
The compression containers (a ``LoRABank``, a ``JDResult`` or
``ClusteredJD``, a ``ServingAdapterBundle``) and an SSM layer's
``SSMCache`` cross the same way, field by field, into the port's types:
the functions below read the fields with ``np.asarray`` and import
nothing of the JAX package.

bf16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses; it crosses as its raw 16 bits (``view(np.int16)``) and is
re-viewed as ``torch.bfloat16`` on the other side, which is exact.
:func:`to_numpy` brings a tree of tensors back for comparison with the
JAX package's results.  :func:`to_rank` carries a tree across to one rank
of a mesh: each leaf's block under its sharding (``launch/shardings.py``),
so a rank receives only its shard of the arrays JAX drew, and
:func:`to_dtensors` makes those blocks the DTensors of the sharded step
(no communication: each rank wraps its own block).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.cluster import ClusteredJD
from .core.collection import LoRABank, ServingAdapterBundle
from .core.jd import JDResult
from .distributed.sharding import local_block
from .models.ssm import SSMCache


def array_to_tensor(a, device="cpu") -> torch.Tensor:
    # np.array, not np.ascontiguousarray, which makes a 0-d array 1-d
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def to_torch(tree, device="cpu"):
    """Nested dict of arrays -> the same dict of tensors on ``device``: a
    parameter or adapter tree of any family (the hybrid family's nests
    (groups, period) stacks), a decode cache (its 0-d ``index`` as a 0-d
    tensor, which the model reads with ``int``), or an optimizer state
    (``{"master", "mu", "nu": tree, "count": 0-d int32}``)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return array_to_tensor(tree, device)


def to_numpy(tree):
    """The inverse of :func:`to_torch` for comparisons: nested dict of
    tensors -> the same dict of numpy arrays (bf16 as its exact f32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tensor_to_array(tree)


def to_rank(tree, shardings, coords, device="cpu"):
    """Nested dict of arrays (or tensors) -> this rank's shards as tensors
    on ``device``: each leaf's block under the ``NamedSharding`` at the
    same place of ``shardings``, for the rank at ``coords`` (its index
    along each mesh axis, ``Mesh.coordinates()``)."""
    if isinstance(tree, dict):
        return {k: to_rank(v, shardings[k], coords, device)
                for k, v in tree.items()}
    block = local_block(tree.shape, shardings.spec, shardings.mesh, coords)
    if isinstance(tree, torch.Tensor):
        # a copy: a view would keep the whole array's storage alive
        return tree[block].to(device=device, copy=True,
                              memory_format=torch.contiguous_format)
    return array_to_tensor(np.asarray(tree)[block], device)


def to_dtensor(a, sharding, device="cpu"):
    """One array or tensor, whole, as a DTensor on ``sharding.mesh``'s
    DeviceMesh: this rank's block (:func:`to_rank`) under the sharding's
    placements (a ``meta`` tensor's block stays on ``meta``)."""
    from .distributed.sharding import island_out
    m = sharding.mesh
    if isinstance(a, torch.Tensor) and a.is_meta:
        device = "meta"
    local = to_rank(a, sharding, m.coordinates(), device)
    return island_out(local, m._dm(), sharding.placements(), tuple(a.shape))


def to_dtensors(tree, shardings, device="cpu"):
    """Nested dict of arrays or tensors (whole on every rank) -> the same
    dict of DTensors under the ``NamedSharding`` tree ``shardings`` (on a
    mesh with a DeviceMesh).  A Python int (a cache's ``index``) or a 0-d
    integer array under a key named ``index`` stays a host integer; a
    ``meta`` one (a dry run's input) is placed as the other leaves."""
    if isinstance(tree, dict):
        return {k: (int(np.asarray(v)) if k == "index" and not (
                    isinstance(v, torch.Tensor) and v.is_meta)
                    else to_dtensors(v, shardings[k], device))
                for k, v in tree.items()}
    return to_dtensor(tree, shardings, device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """The inverse for one tensor: a bf16 tensor comes back as float32
    (exact), every other dtype as itself."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def ssm_cache(cache, device="cpu") -> SSMCache:
    """An ``SSMCache`` (fields ``conv``, ``state``, ``index``) -> the
    port's, its index as a Python int."""
    return SSMCache(conv=array_to_tensor(cache.conv, device),
                    state=array_to_tensor(cache.state, device),
                    index=int(np.asarray(cache.index)))


def lora_bank(bank, device="cpu") -> LoRABank:
    """A bank with fields ``A``, ``B``, ``ranks`` -> the port's LoRABank."""
    return LoRABank(A=array_to_tensor(bank.A, device),
                    B=array_to_tensor(bank.B, device),
                    ranks=array_to_tensor(bank.ranks, device))


def compressed_result(res, device="cpu"):
    """A ``JDResult`` (U, V, sigma, diag) or ``ClusteredJD`` (with
    ``assign``) -> the port's type of the same name."""
    fields = {k: array_to_tensor(getattr(res, k), device)
              for k in ("U", "V", "sigma")}
    if hasattr(res, "assign"):
        return ClusteredJD(assign=array_to_tensor(res.assign, device).to(
            torch.int32), diag=bool(res.diag), **fields)
    return JDResult(diag=bool(res.diag), **fields)


def serving_bundle(bundle, device="cpu") -> ServingAdapterBundle:
    """A ``ServingAdapterBundle`` -> the port's, arrays as tensors."""
    return ServingAdapterBundle(
        kind=bundle.kind, arrays=to_torch(dict(bundle.arrays), device),
        param_bytes_shared=int(bundle.param_bytes_shared),
        param_bytes_per_adapter=int(bundle.param_bytes_per_adapter))
