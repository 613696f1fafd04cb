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
a quarter (from f32) or half (from bf16) of it.  The quantize kernels
read each bank once, 16 bytes a load, into registers: four warps per
long row, 2 or 4 lanes per 16-wide row, a cluster of blocks per matrix for
column scales (their maxima exchanged through distributed shared
memory).  They equal the plain version exactly: IEEE division (screened
by a reciprocal multiply, exact wherever it can matter) and round half to
even, with ``kv_quant.QMAX[8]`` levels.  Dequantization is one f32
multiply and one rounding per value, also exact; one launch takes up to
:data:`GROUP_CAP` banks of any layouts (:func:`adapter_dequantize_group`),
which is how the fused_q8 executor dequantizes a layer's banks.  The
round trip's error per channel is within :func:`int8_error_bound`.

A CPU tensor goes to the plain version (``ref.adapter_quant_ref``,
``ref.adapter_dequant_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from . import _build
from . import ref
from .kv_quant import ERROR_BOUND, QMAX

LAUNCHES = 0             # quantize launches since the last reset
LAUNCHES_DEQUANT = 0     # dequantize launches since the last reset
INT8_SCALE_BYTES = 4     # one f32 scale per output channel
GROUP_CAP = 16           # banks a dequantize launch takes (DEQ_MAX_BANKS)


class _DeqBank(ctypes.Structure):
    """One bank of a dequantize launch's table (``DeqBankArg`` of
    ``csrc/adapter_quant.cu``)."""
    _fields_ = [("q", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("N", ctypes.c_int64),
                ("R", ctypes.c_int), ("C", ctypes.c_int),
                ("rows", ctypes.c_int), ("pad", ctypes.c_int)]


def _norm_axis(ndim: int, axis: int) -> int:
    axis = axis % ndim
    if axis not in (ndim - 1, ndim - 2):
        raise ValueError("axis must be one of the trailing two (matrix) dims")
    return axis


def adapter_quantize(w: torch.Tensor, *, axis: int = -1):
    """Quantize a bank of matrices ``w (..., R, C)`` to int8 plus f32
    per-output-channel scales (keepdims along ``axis``)."""
    _build.refuse("adapter_quantize", w)
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
    _build.refuse("adapter_dequantize", q, scale)
    return adapter_dequantize_group([(q, scale)], out_dtype=out_dtype)[0]


def _bank(q: torch.Tensor, scale: torch.Tensor, out_dtype, device
          ) -> Tuple[int, int, int, bool]:
    """(N, R, C, rows) of one packed bank, checked as the kernel takes
    it."""
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
        if not t.is_cuda or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor on "
                             f"{device}")
    return math.prod(lead), R, C, rows


def adapter_dequantize_group(pairs: Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]], *,
                             out_dtype=torch.float32) -> List[torch.Tensor]:
    """:func:`adapter_dequantize` of every ``(q, scale)`` bank in ``pairs``
    (any mix of rows and cols layouts and shapes, per-layer slices of a
    stacked bank included) in one launch for up to :data:`GROUP_CAP`
    banks: a longer list takes one launch per :data:`GROUP_CAP` banks, and
    empty banks none.  Returns the outputs in order, each equal to the
    plain version bit for bit.  A list held wholly on the CPU runs the
    plain version bank by bank; any other list must lie wholly on one
    card."""
    global LAUNCHES_DEQUANT
    pairs = list(pairs)
    _build.refuse("adapter_dequantize_group", *[t for p in pairs for t in p])
    cuda = [t.device for p in pairs for t in p if t.device.type != "cpu"]
    if not cuda:
        return [ref.adapter_dequant_ref(q, s, out_dtype) for q, s in pairs]
    device = cuda[0]
    outs, table = [], []
    for q, s in pairs:
        N, R, C, rows = _bank(q, s, out_dtype, device)
        out = torch.empty(q.shape, dtype=out_dtype, device=device)
        outs.append(out)
        if out.numel():
            table.append(_DeqBank(q.data_ptr(), s.data_ptr(),
                                  out.data_ptr(), N, R, C, int(rows), 0))
    lib = _build.lib()
    code, stream = _build.dtype_code(out_dtype), _build.stream_ptr(device)
    for i in range(0, len(table), GROUP_CAP):
        part = table[i:i + GROUP_CAP]
        arr = (_DeqBank * len(part))(*part)
        _build.check(lib.adapter_dequant_group_launch(
            ctypes.addressof(arr), len(part), code, stream),
            "adapter_dequantize_group")
        LAUNCHES_DEQUANT += 1
    return outs


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
