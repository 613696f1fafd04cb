"""The compressed (JD) delta of a group of projections that read one input,
one adapter per sequence, added into their outputs in place.

For each target ``t`` of the group and each sequence ``b``, with
``a = ids[b]`` and ``c = cluster_of_t[a]``::

    y_t[b] += scaling * U_t[c] (Sigma_t[a] (V_t[c]^T x[b]))

with Sigma applied as the reference applies it (``t @ Sigma``).  This is
``models/lora.py::apply``'s mode "jd" for a whole group: q/k/v read the
same ``x`` and go in one call.  A CUDA tensor launches the two kernels of
``csrc/jd_delta.cu`` (a shrink with Sigma, then an expand that adds into
``y``), which replace no TPU kernel (the JAX package leaves this delta to
XLA); a CPU tensor runs the plain version, ``ref.jd_delta_ref``.  Both
round where the plain einsums round.

:func:`refusal` is the one list of what the kernels take: ``lora``'s
router asks :func:`takes` before it picks this path, and :func:`jd_delta_`
raises with the reason on anything else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from . import _build
from . import ref

LAUNCHES = 0             # kernel launches since the last reset (2 a call)
MAX_TARGETS = 3          # csrc/jd_delta.cu's JD_MAX_TARGETS
RANK = 16                # csrc/jd_delta.cu's RP, the paper's rank
_FP = (torch.bfloat16, torch.float32)
_INT = (torch.int32, torch.int64)
_BANK = ("U", "V", "sigma", "cluster_of")


class _Target(ctypes.Structure):
    """One target of a launch's table (``JdTargetArg`` of
    ``csrc/jd_delta.cu``)."""
    _fields_ = [("y", ctypes.c_void_p), ("U", ctypes.c_void_p),
                ("V", ctypes.c_void_p), ("sigma", ctypes.c_void_p),
                ("cluster_of", ctypes.c_void_p), ("d_out", ctypes.c_int),
                ("k", ctypes.c_int), ("uv_dtype", ctypes.c_int),
                ("sigma_dtype", ctypes.c_int), ("sigma_full", ctypes.c_int),
                ("cluster_i64", ctypes.c_int)]


def refusal(x: torch.Tensor, ys: Sequence[torch.Tensor],
            banks: Sequence[Dict], ids: torch.Tensor) -> Optional[str]:
    """Why the kernels do not take these inputs, or None where they do.
    The one list of their conditions: on the card, no DTensor; ``x``
    (B, S, d_in) and each ``ys[t]`` (B, S, ...) bf16; 1 to
    :data:`MAX_TARGETS` targets; each bank ``U (k, d_out, r)`` and
    ``V (k, d_in, r)`` of rank :data:`RANK`, one type (bf16 or f32),
    ``sigma (n, r, r)`` or ``(n, r)`` bf16 or f32, ``cluster_of (n,)`` and
    ``ids (B,)`` int32 or int64; d_in and each d_out multiples of 8; k, n
    and d_out at least 1, B at most 65535 (``jd_delta_launch``'s checks).
    Every tensor contiguous; x, the ys, U and V, which the kernels copy 16
    bytes at a time, start on a 16-byte boundary (a bank may be a
    per-layer slice of a stacked one); sigma, cluster_of and ids are read
    an element at a time and need no more than their type's alignment."""
    dev = x.device
    tensors = [x, ids, *ys, *(p[k] for p in banks for k in _BANK)]
    if any(isinstance(t, DTensor) for t in tensors):
        return "no DTensor"
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        return "every tensor on one card"
    if not all(t.is_contiguous() for t in tensors):
        return "every tensor contiguous"
    if x.dim() != 3 or x.dtype != torch.bfloat16 or x.shape[-1] % 8:
        return "x (B, S, d_in) bf16, d_in a multiple of 8"
    B, S, d_in = x.shape
    if ids.shape != (B,) or ids.dtype not in _INT or B > 65535:
        return f"ids ({B},) int32 or int64, B at most 65535"
    if not 1 <= len(ys) <= MAX_TARGETS or len(banks) != len(ys):
        return f"1 to {MAX_TARGETS} outputs, one bank dict each"
    n = banks[0]["sigma"].shape[0]
    if n < 1:
        return "at least one adapter"
    for i, (y, p) in enumerate(zip(ys, banks)):
        U, V, sig, cl = p["U"], p["V"], p["sigma"], p["cluster_of"]
        if (U.dim() != 3 or U.shape[2] != RANK or U.shape[1] % 8
                or min(U.shape[:2]) < 1 or V.shape != (U.shape[0], d_in, RANK)
                or U.dtype not in _FP or V.dtype != U.dtype):
            return (f"target {i}: U (k, d_out, {RANK}) and V (k, {d_in}, "
                    f"{RANK}) of one type, bf16 or f32, k >= 1, d_out a "
                    f"positive multiple of 8")
        if (sig.shape not in ((n, RANK, RANK), (n, RANK))
                or sig.dtype not in _FP or cl.shape != (n,)
                or cl.dtype not in _INT):
            return (f"target {i}: sigma ({n}, {RANK}[, {RANK}]) bf16 or "
                    f"f32, cluster_of ({n},) int32 or int64")
        if (y.dtype != torch.bfloat16 or y.shape[:2] != (B, S)
                or y.numel() != B * S * U.shape[1]):
            return (f"target {i}: y ({B}, {S}, ...) bf16, d_out values "
                    f"a token")
    if any(t.data_ptr() % 16 for t in (x, *ys, *(
            p[k] for p in banks for k in ("U", "V")))):
        return "x, the ys, U and V on 16-byte boundaries"
    return None


def takes(x: torch.Tensor, ys: Sequence[torch.Tensor],
          banks: Sequence[Dict], ids: torch.Tensor) -> bool:
    """Whether the kernels take these inputs (:func:`refusal`)."""
    return refusal(x, ys, banks, ids) is None


def jd_delta_(x: torch.Tensor, ys: Sequence[torch.Tensor],
              banks: Sequence[Dict], ids: torch.Tensor,
              scaling: float = 1.0) -> List[torch.Tensor]:
    """Add each target's delta into its ``y`` in place and return ``ys``.

    x (B, S, d_in); ys[t] (B, S, ...) with d_out_t values a token; banks[t]
    ``{"U" (k, d_out, r), "V" (k, d_in, r), "sigma" (n, r, r) or (n, r),
    "cluster_of" (n,)}``; ids (B,) one adapter a sequence.  On the card the
    inputs are what :func:`refusal` lists, or it raises ``ValueError``."""
    global LAUNCHES
    _build.refuse("jd_delta_", x, ids, *ys,
                  *(p[k] for p in banks for k in _BANK))
    if len(ys) != len(banks):
        raise ValueError("one bank dict per output")
    if x.device.type == "cpu":
        for y, p in zip(ys, banks):
            delta = ref.jd_delta_ref(x, p["U"], p["V"], p["sigma"],
                                     p["cluster_of"], ids)
            y.add_((scaling * delta.float()).to(y.dtype).reshape(y.shape))
        return list(ys)
    why = refusal(x, ys, banks, ids)
    if why is not None:
        raise ValueError(f"jd_delta_: the kernels take {why}")
    dev = x.device
    B, S, d_in = x.shape
    n = banks[0]["sigma"].shape[0]
    table = (_Target * len(ys))()
    for i, (y, p) in enumerate(zip(ys, banks)):
        U, V, sig, cl = p["U"], p["V"], p["sigma"], p["cluster_of"]
        table[i] = _Target(y.data_ptr(), U.data_ptr(), V.data_ptr(),
                           sig.data_ptr(), cl.data_ptr(), U.shape[1],
                           U.shape[0], _build.dtype_code(U.dtype),
                           _build.dtype_code(sig.dtype), int(sig.dim() == 3),
                           int(cl.dtype == torch.int64))
    tbuf = torch.empty((B * S, len(ys), RANK), dtype=torch.bfloat16,
                       device=dev)
    err = _build.lib("jd_delta").jd_delta_launch(
        ctypes.addressof(table), len(ys), x.data_ptr(), ids.data_ptr(),
        int(ids.dtype == torch.int64), tbuf.data_ptr(), B, S, d_in, RANK, n,
        float(scaling), _build.stream_ptr(dev))
    _build.check(err, "jd_delta_")
    LAUNCHES += 2
    return list(ys)
