"""Int8 per-output-channel quantization for adapter / basis banks.

Replaces the TPU kernels ``kernels/adapter_quant.py::adapter_quantize`` and
``adapter_dequantize`` with the hand-written Hopper kernels of
``csrc/adapter_quant.cu``.  Every output channel (a row of a LoRA
``A``/``B`` factor or of a basis ``U``, a column of a basis ``V``) gets one
f32 scale over its input axis:

* LoRA ``A`` bank ``(..., r, d_in)``      -> ``axis=-1``, scales ``(..., r, 1)``
* LoRA ``B`` / basis ``U`` ``(..., d, r)`` -> ``axis=-1``, scales ``(..., d, 1)``
* basis ``V`` ``(..., d_in, r)``           -> ``axis=-2``, scales ``(..., 1, r)``

What bounds it on an H100 is memory: one read of the bank, one write of
a quarter (from f32) or half (from bf16) of it.  The kernel takes one warp
per row (so the many 16-wide rows of a rank-16 ``B`` do not each occupy a
block) or one block per 32-column tile, and equals the plain version
exactly: IEEE division and round half to even, with ``kv_quant.QMAX[8]``
levels.  Dequantization is one f32 multiply and one rounding per value,
also exact.  The round trip's error per channel is within
:func:`int8_error_bound`.

A CPU tensor goes to the plain version (``ref.adapter_quant_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from . import _build
from . import ref
from .kv_quant import ERROR_BOUND, QMAX

LAUNCHES = 0             # quantize launches since the last reset
LAUNCHES_DEQUANT = 0     # dequantize launches since the last reset
INT8_SCALE_BYTES = 4     # one f32 scale per output channel


def _norm_axis(ndim: int, axis: int) -> int:
    axis = axis % ndim
    if axis not in (ndim - 1, ndim - 2):
        raise ValueError("axis must be one of the trailing two (matrix) dims")
    return axis


def adapter_quantize(w: torch.Tensor, *, axis: int = -1):
    """Quantize a bank of matrices ``w (..., R, C)`` to int8 plus f32
    per-output-channel scales (keepdims along ``axis``)."""
    global LAUNCHES
    if w.ndim < 2:
        raise ValueError("adapter_quantize expects a bank of matrices")
    axis = _norm_axis(w.ndim, axis)
    if w.device.type == "cpu":
        return ref.adapter_quant_ref(w, axis=axis)
    if not w.is_cuda or not w.is_contiguous():
        raise ValueError("w must be a contiguous CUDA tensor")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("adapter_quantize takes f32 or bf16 banks")
    lead = tuple(w.shape[:-2])
    R, C = w.shape[-2:]
    N = math.prod(lead)
    rows = axis == w.ndim - 1
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s_shape = lead + ((R, 1) if rows else (1, C))
    scale = torch.empty(s_shape, dtype=torch.float32, device=w.device)
    err = _build.lib().adapter_quant_launch(
        w.data_ptr(), _build.dtype_code(w.dtype), q.data_ptr(),
        scale.data_ptr(), N, R, C, int(rows), float(QMAX[8]),
        _build.stream_ptr(w.device))
    _build.check(err, "adapter_quantize")
    LAUNCHES += 1
    return q, scale


def adapter_dequantize(q: torch.Tensor, scale: torch.Tensor, *,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`adapter_quantize`: ``q * scale`` in f32, rounded
    once to ``out_dtype`` (f32 or bf16).  The reduction axis is read from
    the keepdims position of ``scale``: ``(..., R, 1)`` or ``(..., 1, C)``.
    Equal to the plain version bit for bit."""
    global LAUNCHES_DEQUANT
    if q.device.type == "cpu":
        return ref.adapter_dequant_ref(q, scale, out_dtype)
    if q.ndim < 2 or scale.ndim != q.ndim:
        raise ValueError("adapter_dequantize expects a bank of matrices and "
                         "keepdims scales")
    lead = tuple(q.shape[:-2])
    R, C = q.shape[-2:]
    rows = tuple(scale.shape) == lead + (R, 1)
    if not rows and tuple(scale.shape) != lead + (1, C):
        raise ValueError(f"scale {tuple(scale.shape)} fits neither "
                         f"{lead + (R, 1)} nor {lead + (1, C)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("adapter_dequantize takes int8 values and f32 "
                        "scales")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("adapter_dequantize writes f32 or bf16")
    for name, t in (("q", q), ("scale", scale)):
        if not t.is_cuda or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor on "
                             f"{q.device}")
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    err = _build.lib().adapter_dequant_launch(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        _build.dtype_code(out_dtype), math.prod(lead), R, C, int(rows),
        _build.stream_ptr(q.device))
    _build.check(err, "adapter_dequantize")
    LAUNCHES_DEQUANT += 1
    return out


def quantized_nbytes(shape, *, axis: int = -1) -> int:
    """Bytes of the packed representation: int8 values + one f32 scale per
    output channel."""
    axis = _norm_axis(len(shape), axis)
    values = math.prod(shape)
    return values + INT8_SCALE_BYTES * (values // shape[axis])


def int8_error_bound(w: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Worst-case |dequant(quant(w)) - w| per output channel: half a
    quantization step, ``absmax * ERROR_BOUND[8]`` (the KV kernels'
    bound), keepdims along ``axis``."""
    axis = _norm_axis(w.ndim, axis)
    return w.float().abs().amax(dim=axis, keepdim=True) * ERROR_BOUND[8]
