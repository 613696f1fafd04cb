"""Fused decode attention + per-slot adapter delta of the o-projection.

Replaces the TPU kernels ``kernels/fused_decode.py::fused_decode_lora`` and
``fused_decode_jd``.  On the TPU one kernel does it all, because its grid
runs the kv-heads in order: a scratch accumulator carries the rank-r
shrink from one head to the next and the last head's epilogue expands.
On the H100 the kv-heads' blocks run in parallel, so
``csrc/decode_attention.cu`` launches a sequence's Kv blocks as one
thread-block cluster, in one launch and with no atomics:

1. each block runs the same attention as :func:`flash_decode` (so ``out``
   is bit-identical with it), then contracts its (b, kv-head)'s f32
   normalised output with its slice of ``A[ids[b]]`` (LoRA) or
   ``V[cluster_of[ids[b]]]`` (JD), times the rank scale, into r partials
   in its own shared memory;
2. each block pushes its partials into every block of the cluster
   (distributed shared memory, ``st.async`` on a transaction barrier);
   every block sums the Kv partials in head order, applies
   ``Sigma[ids[b]]`` (JD: diag or full), and expands its 1/Kv of the
   output channels through ``B[ids[b]]`` or ``U[cid]`` with the
   per-channel output scale.

Where the cache holds more than one chunk of ``flash_decode.SPLIT_S``
positions the chunks run first and their merge launch, clustered the same
way, runs the epilogue: two launches.  The shrink's slice, the expand's
rows, the scales and Sigma are staged in shared memory by bulk copies
(the copy engine) behind the attention.
``delta`` is bit-identical with the two-launch design it replaces (the
same products and sums in the same order).  A cluster holds at most
:data:`MAX_KV_HEADS` blocks, so the fused kernels take at most that many
kv heads, on every device.

What bounds it on an H100 is memory: the K/V prefix, plus the adapter
slices (a few hundred KB per layer at mistral-7b's width).  Banks are
bf16, f32 or int8 with their scales; fp banks get scales of ones, as in
the JAX wrappers, so one body serves both precisions.

``delta`` uses the f32 attention output, as the TPU kernel does, while the
plain versions (``ref.fused_decode_*_ref``) use the bf16-rounded ``out``:
the two differ by about one bf16 rounding of ``out`` times ||A||.

The paged variants (replacing ``fused_decode_lora_paged`` and
``fused_decode_jd_paged``) give the launch a page table, so that it reads
K/V from a pool of pages as ``flash_decode_paged`` does.  On equal logical
content their ``out`` and ``delta`` are bit-identical with the contiguous
variants'.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernels
or raises.  ``ids`` (and ``cluster_of``) must index their banks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from . import ref
from .flash_decode import (attention_launches, check_attention_args,
                           check_paged_args, contiguous_launch_args,
                           paged_launch_args, split_workspace,
                           workspace_args)

# kernel launches since the last reset: one per call (two where the cache
# holds more than one chunk)
LAUNCHES_LORA = 0
LAUNCHES_JD = 0
LAUNCHES_LORA_PAGED = 0  # the paged variants' launches, counted alike
LAUNCHES_JD_PAGED = 0
MAX_RANK = 128
MAX_KV_HEADS = 16        # blocks in a thread-block cluster (the H100's limit)
_ONES: Dict[Tuple, torch.Tensor] = {}


def _ones(shape, device) -> torch.Tensor:
    key = (tuple(shape), str(device))
    if key not in _ONES:
        _ONES[key] = torch.ones(shape, dtype=torch.float32, device=device)
    return _ONES[key]


def _check_bank(name: str, w: torch.Tensor, shape, device) -> None:
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(w.shape)}, "
                         f"expected {tuple(shape)}")
    if w.device != device or not w.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")
    _build.dtype_code(w.dtype)


def _check_scale(name: str, s: torch.Tensor, shape, device) -> None:
    _check_bank(name, s, shape, device)
    if s.dtype != torch.float32:
        raise TypeError(f"{name} must be f32")


def _check_ids(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dtype != torch.int32 or t.shape != (n,) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor "
                         f"on {device}")


def _check_kv_heads(kv_heads: int) -> None:
    """The fused kernels sum a sequence's kv-heads in one cluster: at most
    :data:`MAX_KV_HEADS`, on the CPU too, so both share one contract."""
    if kv_heads > MAX_KV_HEADS:
        raise ValueError(f"{kv_heads} kv heads: the fused decode kernels "
                         f"take at most {MAX_KV_HEADS} (one thread-block "
                         f"cluster of a sequence's kv heads)")


def _launch(q, k, v, kv_len, ids, cluster_of, bank, bank_scale, sigma, w,
            w_scale, r, dims, addr):
    """The fused launch (the chunks' and the merge's where the cache is
    split): attention, shrink through ``bank``, Sigma, expand through
    ``w``.  ``addr``: ``flash_decode.contiguous_launch_args`` or
    ``paged_launch_args``.  Returns (out, delta (B, d_out) f32)."""
    B, H, Kv, hd = dims
    S, k_sb, k_ss, v_sb, v_ss, (pt, n_blocks, page_t) = addr
    d_out = w.shape[1]
    out = torch.empty_like(q)
    delta = torch.empty((B, d_out), dtype=torch.float32, device=q.device)
    ws = split_workspace(B, Kv, H // Kv, hd, S, q.device)
    err = _build.lib().fused_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        ids.data_ptr(), None if cluster_of is None else cluster_of.data_ptr(),
        bank.data_ptr(), _build.dtype_code(bank.dtype), bank_scale.data_ptr(),
        r, None if sigma is None else sigma.data_ptr(),
        0 if sigma is None else _build.dtype_code(sigma.dtype),
        int(sigma is not None and sigma.ndim == 3),
        w.data_ptr(), _build.dtype_code(w.dtype), w_scale.data_ptr(), d_out,
        delta.data_ptr(), out.data_ptr(), B, H, Kv, hd, S,
        k_sb, k_ss, v_sb, v_ss, hd ** -0.5,
        _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
        pt, n_blocks, page_t, *workspace_args(ws),
        _build.stream_ptr(q.device))
    _build.check(err, "fused_decode")
    return out, delta


def _lora(q, k, v, kv_len, ids, A, B, a_scale, b_scale, dims, addr):
    """Check the raw-LoRA operands (fp banks get scales of ones), then the
    launch; ``addr`` as :func:`_launch` takes it."""
    Bt, H, Kv, hd = dims
    n, r, d_attn = A.shape
    d_out = B.shape[1]
    dev = q.device
    if d_attn != H * hd:
        raise ValueError(f"A maps {d_attn} dims, attention makes {H * hd}")
    if r > MAX_RANK:
        raise ValueError(f"rank {r} > {MAX_RANK}")
    a_scale = _ones((n, r, 1), dev) if a_scale is None else a_scale
    b_scale = _ones((n, d_out, 1), dev) if b_scale is None else b_scale
    _check_bank("A", A, (n, r, d_attn), dev)
    _check_bank("B", B, (n, d_out, r), dev)
    _check_scale("a_scale", a_scale, (n, r, 1), dev)
    _check_scale("b_scale", b_scale, (n, d_out, 1), dev)
    _check_ids("ids", ids, Bt, dev)
    return _launch(q, k, v, kv_len, ids, None, A, a_scale, None, B, b_scale,
                   r, dims, addr)


def _jd(q, k, v, kv_len, ids, U, V, sigma, cluster_of, u_scale, v_scale,
        dims, addr):
    """Check the compressed-basis operands (fp bases get scales of ones),
    then the launch."""
    Bt, H, Kv, hd = dims
    kcl, d_attn, r = V.shape
    d_out = U.shape[1]
    n = sigma.shape[0]
    dev = q.device
    if d_attn != H * hd:
        raise ValueError(f"V maps {d_attn} dims, attention makes {H * hd}")
    if r > MAX_RANK:
        raise ValueError(f"rank {r} > {MAX_RANK}")
    if sigma.shape not in ((n, r), (n, r, r)):
        raise ValueError(f"sigma must be ({n}, {r}) or ({n}, {r}, {r})")
    if sigma.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("sigma must be f32 or bf16 (dequantize int8 first)")
    u_scale = _ones((kcl, d_out, 1), dev) if u_scale is None else u_scale
    v_scale = _ones((kcl, 1, r), dev) if v_scale is None else v_scale
    _check_bank("U", U, (kcl, d_out, r), dev)
    _check_bank("V", V, (kcl, d_attn, r), dev)
    _check_bank("sigma", sigma, tuple(sigma.shape), dev)
    _check_scale("u_scale", u_scale, (kcl, d_out, 1), dev)
    _check_scale("v_scale", v_scale, (kcl, 1, r), dev)
    _check_ids("ids", ids, Bt, dev)
    _check_ids("cluster_of", cluster_of, n, dev)
    return _launch(q, k, v, kv_len, ids, cluster_of, V, v_scale, sigma, U,
                   u_scale, r, dims, addr)


def fused_decode_lora(q, k, v, kv_len, ids, A, B,
                      a_scale: Optional[torch.Tensor] = None,
                      b_scale: Optional[torch.Tensor] = None):
    """Fused decode attention + raw-LoRA output delta.

    q: (B, H, hd); k/v: (B, S, Kv, hd) (row-contiguous views allowed);
    kv_len/ids: (B,) int32; A: (n, r, H*hd) fp or int8 with a_scale
    (n, r, 1); B: (n, d_out, r) fp or int8 with b_scale (n, d_out, 1).
    Returns (out (B, H, hd), delta (B, d_out) f32), delta un-scaled by the
    LoRA ``scaling``."""
    _build.refuse("fused_decode_lora", q, k, v, kv_len, ids, A, B, a_scale,
                  b_scale)
    global LAUNCHES_LORA
    _check_kv_heads(k.shape[-2])
    if q.device.type == "cpu":
        return ref.fused_decode_lora_ref(q, k, v, kv_len, ids, A, B,
                                         a_scale, b_scale)
    dims = check_attention_args(q, k, v, kv_len)[:4]
    addr = contiguous_launch_args(k, v)
    res = _lora(q, k, v, kv_len, ids, A, B, a_scale, b_scale, dims, addr)
    LAUNCHES_LORA += attention_launches(addr[0])
    return res


def fused_decode_lora_paged(q, k_pages, v_pages, page_table, kv_len, ids, A,
                            B, a_scale: Optional[torch.Tensor] = None,
                            b_scale: Optional[torch.Tensor] = None):
    """:func:`fused_decode_lora` over a paged pool: k/v_pages (P, page_t,
    Kv, hd) and page_table (B, n_blocks) int32, as ``flash_decode_paged``
    takes them."""
    _build.refuse("fused_decode_lora_paged", q, k_pages, v_pages, page_table,
                  kv_len, ids, A, B, a_scale, b_scale)
    global LAUNCHES_LORA_PAGED
    _check_kv_heads(k_pages.shape[-2])
    if q.device.type == "cpu":
        return ref.fused_decode_lora_paged_ref(
            q, k_pages, v_pages, page_table, kv_len, ids, A, B, a_scale,
            b_scale)
    *dims, page_t, n_blocks = check_paged_args(q, k_pages, v_pages,
                                               page_table, kv_len)
    addr = paged_launch_args(k_pages, v_pages, page_table, page_t, n_blocks)
    res = _lora(q, k_pages, v_pages, kv_len, ids, A, B, a_scale, b_scale,
                dims, addr)
    LAUNCHES_LORA_PAGED += attention_launches(addr[0])
    return res


def fused_decode_jd(q, k, v, kv_len, ids, U, V, sigma, cluster_of,
                    u_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None):
    """Fused decode attention + compressed shared-basis (jd) output delta.

    U: (k, d_out, r) / V: (k, H*hd, r) fp or int8 with u_scale (k, d_out, 1)
    / v_scale (k, 1, r); sigma: per-adapter (n, r) diag or (n, r, r) full,
    bf16 or f32; cluster_of: (n,) int32.  Returns (out (B, H, hd),
    delta (B, d_out) f32)."""
    _build.refuse("fused_decode_jd", q, k, v, kv_len, ids, U, V, sigma,
                  cluster_of, u_scale, v_scale)
    global LAUNCHES_JD
    _check_kv_heads(k.shape[-2])
    if q.device.type == "cpu":
        return ref.fused_decode_jd_ref(q, k, v, kv_len, ids, U, V, sigma,
                                       cluster_of, u_scale, v_scale)
    dims = check_attention_args(q, k, v, kv_len)[:4]
    addr = contiguous_launch_args(k, v)
    res = _jd(q, k, v, kv_len, ids, U, V, sigma, cluster_of, u_scale,
              v_scale, dims, addr)
    LAUNCHES_JD += attention_launches(addr[0])
    return res


def fused_decode_jd_paged(q, k_pages, v_pages, page_table, kv_len, ids, U, V,
                          sigma, cluster_of,
                          u_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None):
    """:func:`fused_decode_jd` over a paged pool (the layout of
    :func:`fused_decode_lora_paged`)."""
    _build.refuse("fused_decode_jd_paged", q, k_pages, v_pages, page_table,
                  kv_len, ids, U, V, sigma, cluster_of, u_scale, v_scale)
    global LAUNCHES_JD_PAGED
    _check_kv_heads(k_pages.shape[-2])
    if q.device.type == "cpu":
        return ref.fused_decode_jd_paged_ref(
            q, k_pages, v_pages, page_table, kv_len, ids, U, V, sigma,
            cluster_of, u_scale, v_scale)
    *dims, page_t, n_blocks = check_paged_args(q, k_pages, v_pages,
                                               page_table, kv_len)
    addr = paged_launch_args(k_pages, v_pages, page_table, page_t, n_blocks)
    res = _jd(q, k_pages, v_pages, kv_len, ids, U, V, sigma, cluster_of,
              u_scale, v_scale, dims, addr)
    LAUNCHES_JD_PAGED += attention_launches(addr[0])
    return res
