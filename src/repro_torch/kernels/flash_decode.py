"""Decode attention: one query token per sequence against its KV cache.

Replaces the TPU kernel ``kernels/flash_decode.py::flash_decode`` (body
``_decode_kernel``) with the hand-written Hopper kernel of
``csrc/decode_attention.cu``.  What bounds it on an H100 is memory: each
(b, kv-head) streams its valid K/V prefix once, ~2*G flops per byte.  The
kernel runs one block per (b, kv-head), walks only the ``kv_len[b]`` valid
positions (the TPU kernel computes masked blocks too), and reads K/V
through their batch and row strides, so a slice of a larger cache is read
in place, never copied.

:func:`flash_decode_paged` replaces ``flash_decode_paged``: the same
kernel reads K/V from a pool of pages (P, page_t, Kv, hd) through a page
table (B, n_blocks), looking the page up per row, and gives results
bit-identical with :func:`flash_decode` on equal logical content.

A CPU tensor goes to the plain version (``ref.flash_decode_ref``,
``ref.flash_decode_paged_ref``); a CUDA tensor launches the kernel or
raises.  ``kv_len`` must be >= 1 per row.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref

LAUNCHES = 0             # kernel launches since the last reset
LAUNCHES_PAGED = 0       # paged launches since the last reset
MAX_SMEM = 48 * 1024
TILE_S = 64              # csrc/decode_attention.cu
ATTN_THREADS = 128


def attn_smem_bytes(G: int, hd: int, paged: bool = False) -> int:
    return (4 * (2 * G * hd + G * TILE_S + 3 * G + ATTN_THREADS)
            + (8 * TILE_S if paged else 0))


def _check_common(q, k, v, kv_len, paged: bool):
    """What the contiguous and paged layouts share: k/v (X, Y, Kv, hd)
    alike, with q (B, H, hd); returns (B, H, Kv, hd)."""
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q must be (B, H, hd) and k/v 4-D")
    B, H, hd = q.shape
    if k.shape != v.shape or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    Kv = k.shape[2]
    if H % Kv:
        raise ValueError(f"{H} heads do not group over {Kv} kv heads")
    if hd > 256:
        raise ValueError(f"head_dim {hd} > 256")
    if attn_smem_bytes(H // Kv, hd, paged) > MAX_SMEM:
        raise ValueError("head group too large for one block's shared memory")
    for t in (q, k, v, kv_len):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all operands must be on q's CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype not in (torch.bfloat16, torch.float32) or \
            v.dtype != k.dtype:
        raise TypeError("q and k/v must be bf16 or f32 (k and v alike)")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,) or \
            not kv_len.is_contiguous():
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor")
    return B, H, Kv, hd


def check_attention_args(q, k, v, kv_len):
    """Validate q (B, H, hd), k/v (B, S, Kv, hd) views and kv_len (B,);
    returns (B, H, Kv, hd, S)."""
    B, H, Kv, hd = _check_common(q, k, v, kv_len, paged=False)
    if k.shape[0] != B:
        raise ValueError(f"k/v hold {k.shape[0]} sequences, q {B}")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError("k/v rows must be contiguous (Kv, hd)")
    return B, H, Kv, hd, k.shape[1]


def check_paged_args(q, k_pages, v_pages, page_table, kv_len):
    """Validate q (B, H, hd), contiguous pools k/v_pages (P, page_t, Kv,
    hd), a contiguous page_table (B, n_blocks) int32 and kv_len (B,), all
    on q's device; returns (B, H, Kv, hd, page_t, n_blocks).  The table's
    entries are not read here (no host sync): each must index a page of
    the pool up to ``ceil(kv_len[b] / page_t)``."""
    B, H, Kv, hd = _check_common(q, k_pages, v_pages, kv_len, paged=True)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (P, page_t, Kv, "
                             f"hd) pool")
    if page_table.ndim != 2 or page_table.shape[0] != B or \
            page_table.shape[1] < 1:
        raise ValueError(f"page_table must be ({B}, n_blocks), got "
                         f"{tuple(page_table.shape)}")
    if page_table.dtype != torch.int32 or not page_table.is_contiguous() \
            or page_table.device != q.device:
        raise ValueError(f"page_table must be a contiguous int32 tensor on "
                         f"{q.device}")
    page_t = k_pages.shape[1]
    if page_t < 1:
        raise ValueError("pages must hold at least one token")
    return B, H, Kv, hd, page_t, page_table.shape[1]


def paged_launch_args(k_pages, v_pages, page_table, page_t: int,
                      n_blocks: int):
    """The kernel's K/V address arguments for a pool: S, the page strides
    where a contiguous launch passes batch strides, the row strides, and
    the table (``csrc/decode_attention.cu``)."""
    return (n_blocks * page_t, k_pages.stride(0), k_pages.stride(1),
            v_pages.stride(0), v_pages.stride(1),
            (page_table.data_ptr(), n_blocks, page_t))


def contiguous_launch_args(k, v):
    return (k.shape[1], k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            (None, 0, 0))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor):
    """q: (B, H, hd); k/v: (B, S, Kv, hd); kv_len: (B,) int32.

    Returns (out (B, H, hd) in q's dtype, l (B, Kv, G, 1) f32,
    m (B, Kv, G, 1) f32), as the JAX function does."""
    global LAUNCHES
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len)
    dims = check_attention_args(q, k, v, kv_len)[:4]
    res = _launch(q, k, v, kv_len, dims, contiguous_launch_args(k, v),
                  "flash_decode")
    LAUNCHES += 1
    return res


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor):
    """q: (B, H, hd); k/v_pages: (P, page_t, Kv, hd) pools; page_table:
    (B, n_blocks) int32, sequence b's logical block s in page
    ``page_table[b, s]``; kv_len: (B,) int32 (clamped to n_blocks *
    page_t).  Returns (out, l, m) as :func:`flash_decode`."""
    global LAUNCHES_PAGED
    if q.device.type == "cpu":
        return ref.flash_decode_paged_ref(q, k_pages, v_pages, page_table,
                                          kv_len)
    *dims, page_t, n_blocks = check_paged_args(q, k_pages, v_pages,
                                               page_table, kv_len)
    res = _launch(q, k_pages, v_pages, kv_len, dims,
                  paged_launch_args(k_pages, v_pages, page_table, page_t,
                                    n_blocks), "flash_decode_paged")
    LAUNCHES_PAGED += 1
    return res


def _launch(q, k, v, kv_len, dims, addr, name):
    """One launch of the kernel without an epilogue; ``addr`` from
    :func:`contiguous_launch_args` or :func:`paged_launch_args`."""
    B, H, Kv, hd = dims
    S, k_sb, k_ss, v_sb, v_ss, (pt, n_blocks, page_t) = addr
    G = H // Kv
    out = torch.empty_like(q)
    l = torch.empty((B, Kv, G, 1), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Kv, G, 1), dtype=torch.float32, device=q.device)
    err = _build.lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), l.data_ptr(), m.data_ptr(), B, H, Kv, hd, S,
        k_sb, k_ss, v_sb, v_ss, hd ** -0.5,
        _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
        pt, n_blocks, page_t, _build.stream_ptr(q.device))
    _build.check(err, name)
    return out, l, m
