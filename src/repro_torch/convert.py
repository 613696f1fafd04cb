"""Carry parameter and adapter trees across from numpy to the port.

The JAX package's trees (parameters from ``models/param.py``, adapter
bundles from ``launch/serve.py`` or ``core/collection.py``) become nested
dicts of numpy arrays with ``np.asarray(leaf)``; :func:`to_torch` turns
such a tree into tensors on one device with the same layouts, bit for bit.

bf16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses; it crosses as its raw 16 bits (``view(np.uint16)``) and is
re-viewed as ``torch.bfloat16`` on the other side, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch


def array_to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def to_torch(tree, device="cpu"):
    """Nested dict of arrays -> the same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return array_to_tensor(tree, device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """The inverse for one tensor: a bf16 tensor comes back as float32
    (exact), every other dtype as itself."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
