"""Per-channel symmetric quantization of KV blocks for the wire.

Replaces the TPU kernels ``kernels/kv_quant.py::kv_quantize`` and
``kv_dequantize`` with the hand-written Hopper kernels of
``csrc/kv_quant.cu``.  A KV block is (T, C): T tokens (the canonical
wire block is :data:`BLOCK_T` = 128) by C channels (layers x kv-heads x
head_dim, K then V).  Each channel gets one f32 scale, absmax over the T
tokens / qmax (1 where the channel is 0); values round half to even and
clip to [-qmax, qmax]:

* int8 (qmax 127): (T, C) int8;
* int4 (qmax 7): two tokens a byte, the even token in the low nibble,
  (T/2, C) uint8, so T must be even.

The packed values plus the scales are the bytes the serving simulator
(``serving/resources.py::KVCompressionConfig``) prices on the wire;
:func:`measured_wire_ratio` reads them off the kernel's output.  The
worst per-channel error is half a step, ``absmax / (2 qmax)``:
:data:`ERROR_BOUND`.

What bounds the kernels on an H100 is memory: quantize reads the block
and writes a half (int8) or a quarter (int4) of its bf16 bytes, dequantize
the reverse.  Both equal the plain versions bit for bit.

A CPU tensor goes to the plain version (``ref.kv_quant_ref`` and
``ref.pack_int4``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import _build
from . import ref
from .ref import QMAX

BLOCK_T = 128            # canonical KV wire block, in tokens
# wire bytes per raw bf16 byte at the canonical block: values plus one f32
# scale per channel (what measured_wire_ratio reads off the kernel)
WIRE_RATIO = {8: (BLOCK_T + 4) / (2 * BLOCK_T),
              4: (BLOCK_T // 2 + 4) / (2 * BLOCK_T)}
# worst-case |dequant - x| per channel, as a fraction of the channel absmax
ERROR_BOUND = {8: 1 / 254, 4: 1 / 14}

LAUNCHES_QUANT = 0       # quantize launches since the last reset
LAUNCHES_DEQUANT = 0     # dequantize launches since the last reset


def _check_bits(bits: int) -> None:
    if bits not in QMAX:
        raise ValueError(f"bits must be one of {sorted(QMAX)}, got {bits}")


def kv_quantize(x: torch.Tensor, bits: int = 8):
    """Quantize a (T, C) KV block per channel.

    Returns ``(packed, scales)``: packed is (T, C) int8 for 8 bits or
    (T/2, C) uint8 for 4 bits; scales is (1, C) f32."""
    _build.refuse("kv_quantize", x, bits)
    global LAUNCHES_QUANT
    if x.ndim != 2:
        raise ValueError(f"a KV block is (T, C), got {tuple(x.shape)}")
    _check_bits(bits)
    T, C = x.shape
    if bits == 4 and T % 2:
        raise ValueError("int4 packing needs an even token count")
    if x.device.type == "cpu":
        q, scales = ref.kv_quant_ref(x, bits)
        return (q if bits == 8 else ref.pack_int4(q)), scales
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("x must be a contiguous CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("kv_quantize takes f32 or bf16 blocks")
    rows = T if bits == 8 else T // 2
    packed = torch.empty((rows, C), device=x.device,
                         dtype=torch.int8 if bits == 8 else torch.uint8)
    scales = torch.empty((1, C), dtype=torch.float32, device=x.device)
    err = _build.lib("kv_quant").kv_quant_launch(
        x.data_ptr(), _build.dtype_code(x.dtype), packed.data_ptr(),
        scales.data_ptr(), T, C, bits, _build.stream_ptr(x.device))
    _build.check(err, "kv_quantize")
    LAUNCHES_QUANT += 1
    return packed, scales


def kv_dequantize(packed: torch.Tensor, scales: torch.Tensor, bits: int = 8,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`kv_quantize`: the (T, C) block in ``out_dtype`` (f32
    or bf16), one f32 multiply and one rounding per value."""
    _build.refuse("kv_dequantize", packed, scales, bits, out_dtype)
    global LAUNCHES_DEQUANT
    _check_bits(bits)
    if packed.ndim != 2:
        raise ValueError(f"packed values are 2-D, got "
                         f"{tuple(packed.shape)}")
    rows, C = packed.shape
    want = torch.int8 if bits == 8 else torch.uint8
    if packed.dtype != want:
        raise TypeError(f"{bits}-bit values are {want}, got {packed.dtype}")
    if tuple(scales.shape) != (1, C) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be (1, {C}) f32")
    if packed.device.type == "cpu":
        q = packed if bits == 8 else ref.unpack_int4(packed)
        return ref.kv_dequant_ref(q, scales, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("kv_dequantize writes f32 or bf16")
    for name, t in (("packed", packed), ("scales", scales)):
        if not t.is_cuda or t.device != packed.device or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor on "
                             f"{packed.device}")
    T = rows if bits == 8 else 2 * rows
    out = torch.empty((T, C), dtype=out_dtype, device=packed.device)
    err = _build.lib("kv_quant").kv_dequant_launch(
        packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        _build.dtype_code(out_dtype), T, C, bits,
        _build.stream_ptr(packed.device))
    _build.check(err, "kv_dequantize")
    LAUNCHES_DEQUANT += 1
    return out


def kv_roundtrip_ref(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The plain round trip, quantize then dequantize, in f32."""
    q, s = ref.kv_quant_ref(x, bits)
    return ref.kv_dequant_ref(q, s)


def measured_wire_ratio(bits: int, n_tokens: int = BLOCK_T,
                        n_channels: int = 256, device=None) -> float:
    """Wire bytes per raw bf16 byte, read off :func:`kv_quantize`'s output
    for one (n_tokens, n_channels) block on ``device`` (the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n_tokens, n_channels), generator=g,
                    device=dev).to(torch.bfloat16)
    packed, scales = kv_quantize(x.float(), bits)
    return (packed.nbytes + scales.nbytes) / x.nbytes
