"""Decode attention: one query token per sequence against its KV cache.

Replaces the TPU kernel ``kernels/flash_decode.py::flash_decode`` (body
``_decode_kernel``) with the hand-written Hopper kernel of
``csrc/decode_attention.cu``.  What bounds it on an H100 is memory: each
(b, kv-head) streams its valid K/V prefix once, ~2*G flops per byte.  The
kernel splits the sequence (flash-decoding): one block per (b, kv-head,
chunk of :data:`SPLIT_S` positions), K/V staged through a ring of 16-byte
asynchronous copies, and where the cache holds more than one chunk a
second launch merges the chunks in ascending order into ``out`` and the
global ``l, m``.  It walks only the ``kv_len[b]`` valid positions (the TPU
kernel computes masked blocks too), and reads K/V through their batch and
row strides, so a slice of a larger cache is read in place, never copied.

:func:`flash_decode_paged` replaces ``flash_decode_paged``: the same
kernel reads K/V from a pool of pages (P, page_t, Kv, hd) through a page
table (B, n_blocks), looking the page up per row, and gives results
bit-identical with :func:`flash_decode` on equal logical content (chunk
boundaries depend on the position alone, and empty chunks merge as exact
zeros).

A CPU tensor goes to the plain version (``ref.flash_decode_ref``,
``ref.flash_decode_paged_ref``); a CUDA tensor launches the kernel or
raises.  A ``meta`` q makes :func:`flash_decode` return the kernel's
outputs as meta tensors and record the call for a dry run
(``launch/op_cost.py``); the paged wrapper refuses it.  ``kv_len`` must
be >= 1 per row for the plain version; the kernel gives a row of
``kv_len`` 0 ``out`` 0, ``l`` 0 and ``m`` -1e30 (a rank's empty slice in
``distributed/collectives.py``, whose CPU path is its own
``_partial_decode``).
"""
from __future__ import annotations

import torch

from ..launch import op_cost
from . import _build
from . import ref

LAUNCHES = 0             # kernel launches since the last reset
LAUNCHES_PAGED = 0       # paged launches since the last reset
MAX_SMEM = 227 * 1024    # an H100 block's dynamic shared memory
# csrc/decode_attention.cu
SPLIT_S = 256            # positions per chunk
TILE_S, NSTAGE = 32, 5   # rows per staged tile, tiles in the ring
GB = 4                   # query rows of the head group per pass
RED_FLOATS = 4 * 128     # the shrink epilogue's buffer (rank <= 128)
MAX_HEAD_DIM = 256


def uses_mma(hd: int, kv_es: int) -> bool:
    """bf16 K/V rows of a multiple of 32 go through the tensor cores."""
    return kv_es == 2 and hd % 32 == 0


def _row_stride(hd: int, es: int) -> int:
    """Bytes between two staged K/V rows (``attn_row_stride``)."""
    rs = -(-hd * es // 16) * 16
    if uses_mma(hd, es):
        return rs + (144 - rs % 128) % 128
    return rs + (192 - rs % 128) % 128 if rs > 64 else rs


def attn_smem_bytes(G: int, hd: int, kv_es: int, paged: bool = False) -> int:
    """Shared memory of one attention block: the K/V ring, the chunk's
    logits, the pass's query rows (A fragments in three bf16 pieces on the
    tensor cores), the chunk's p fragments (tensor cores), m and l, the
    epilogue's buffer, the normalised output (G, hd) and, paged, the
    chunk's row offsets."""
    hdp = -(-hd * kv_es // 16) * 16 // kv_es
    mma = uses_mma(hd, kv_es)
    q_bytes = 3 * (hd // 16) * 16 * 8 if mma else 4 * GB * hdp
    p_bytes = (SPLIT_S // 16) * 3 * 16 * 8 if mma else 0
    return (NSTAGE * TILE_S * _row_stride(hd, kv_es) + q_bytes + p_bytes
            + 4 * (GB * SPLIT_S + 2 * GB + RED_FLOATS + G * hd)
            + (8 * SPLIT_S if paged else 0))


def merge_smem_bytes(G: int, hd: int, nc: int) -> int:
    """Shared memory of the merge block: m, l, the epilogue's buffer, the
    output (G, hd) and the chunks' weights (G, nc)."""
    return 4 * (2 * G + RED_FLOATS + G * hd + G * nc)


def n_chunks(S: int) -> int:
    """Chunks of :data:`SPLIT_S` positions a launch over ``S`` covers."""
    return max(1, -(-S // SPLIT_S))


def attention_launches(S: int) -> int:
    """Kernel launches of one attention over ``S`` positions: the chunks'
    launch, and the merge where there is more than one chunk."""
    return 1 if n_chunks(S) == 1 else 2


def split_workspace(B: int, Kv: int, G: int, hd: int, S: int, device):
    """(ws_acc (B, Kv, nc, G, hd), ws_ml (B, Kv, nc, G, 2), nc): the f32
    per-chunk partials of a launch over ``S`` positions; None, None where
    it has one chunk."""
    nc = n_chunks(S)
    if nc == 1:
        return None, None, 1
    if merge_smem_bytes(G, hd, nc) > MAX_SMEM:
        raise ValueError(f"{S} positions in {nc} chunks: too many for one "
                         f"merge block's shared memory")
    f32 = torch.float32
    return (torch.empty((B, Kv, nc, G, hd), dtype=f32, device=device),
            torch.empty((B, Kv, nc, G, 2), dtype=f32, device=device), nc)


def workspace_args(ws) -> tuple:
    """The kernel's (ws_acc, ws_ml, n_chunks) arguments."""
    acc, ml, nc = ws
    return (None if acc is None else acc.data_ptr(),
            None if ml is None else ml.data_ptr(), nc)


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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if attn_smem_bytes(H // Kv, hd, k.element_size(), paged) > MAX_SMEM:
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
                 kv_len: torch.Tensor, scale=None):
    """q: (B, H, hd); k/v: (B, S, Kv, hd); kv_len: (B,) int32; the logits
    ``q . k`` times ``scale`` (default hd^-0.5).

    Returns (out (B, H, hd) in q's dtype, l (B, Kv, G, 1) f32,
    m (B, Kv, G, 1) f32), as the JAX function does."""
    _build.refuse("flash_decode", q, k, v, kv_len, scale, meta=False)
    global LAUNCHES
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len, scale)
    if q.device.type == "meta":
        return _meta_outputs(q, k, v, kv_len)
    dims = check_attention_args(q, k, v, kv_len)[:4]
    addr = contiguous_launch_args(k, v)
    with op_cost.port_kernel("flash_decode", attention_launches(addr[0]),
                             lambda: _cost(q, k, kv_len)):
        res = _launch(q, k, v, kv_len, dims, addr, "flash_decode", scale)
    LAUNCHES += attention_launches(addr[0])
    return res


def _cost(q, k, kv_len):
    """(bytes, flops) of one call: ``checks.attention_bytes`` and
    ``attention_flops``, the kernel bound's own arithmetic, on the valid
    rows (``kv_len`` read to the host)."""
    from . import checks
    case = {"q": q, "k": k, "kv_len": kv_len.cpu()}
    return checks.attention_bytes(case), checks.attention_flops(case)


def _meta_outputs(q, k, v, kv_len):
    """:func:`flash_decode` on ``meta`` q/k/v (a dry run): the kernel's
    outputs (out, l, m) and its split workspace as meta tensors, after the
    kernel's own shape checks; the call is recorded as the launches the
    card would make (``launch/op_cost.py``).  ``kv_len`` stays on the host
    (a meta tensor holds no lengths): its valid rows are what the card's
    call would read.  Nothing is launched and the count does not move."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.device.type != "meta" or v.device.type != "meta" or \
            kv_len.device.type != "cpu" or kv_len.dtype != torch.int32 or \
            kv_len.shape != (q.shape[0],):
        raise ValueError("flash_decode on meta: q/k/v on meta, kv_len a "
                         "(B,) int32 tensor on the host")
    B, H, hd = q.shape
    Kv = k.shape[2]
    if H % Kv or hd > MAX_HEAD_DIM or \
            attn_smem_bytes(H // Kv, hd, k.element_size()) > MAX_SMEM:
        raise ValueError(f"flash_decode: {H} heads over {Kv} kv heads of "
                         f"{hd} do not fit the kernel")
    G = H // Kv
    with op_cost.port_kernel("flash_decode", attention_launches(k.shape[1]),
                             lambda: _cost(q, k, kv_len)):
        split_workspace(B, Kv, G, hd, k.shape[1], q.device)
        out = torch.empty_like(q)
        l = torch.empty((B, Kv, G, 1), dtype=torch.float32, device="meta")
        m = torch.empty((B, Kv, G, 1), dtype=torch.float32, device="meta")
    return out, l, m


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor):
    """q: (B, H, hd); k/v_pages: (P, page_t, Kv, hd) pools; page_table:
    (B, n_blocks) int32, sequence b's logical block s in page
    ``page_table[b, s]``; kv_len: (B,) int32 (clamped to n_blocks *
    page_t).  Returns (out, l, m) as :func:`flash_decode`."""
    _build.refuse("flash_decode_paged", q, k_pages, v_pages, page_table,
                  kv_len)
    global LAUNCHES_PAGED
    if q.device.type == "cpu":
        return ref.flash_decode_paged_ref(q, k_pages, v_pages, page_table,
                                          kv_len)
    *dims, page_t, n_blocks = check_paged_args(q, k_pages, v_pages,
                                               page_table, kv_len)
    addr = paged_launch_args(k_pages, v_pages, page_table, page_t, n_blocks)
    res = _launch(q, k_pages, v_pages, kv_len, dims, addr,
                  "flash_decode_paged")
    LAUNCHES_PAGED += attention_launches(addr[0])
    return res


def _launch(q, k, v, kv_len, dims, addr, name, scale=None):
    """The kernel without an epilogue (and its merge where the cache holds
    more than one chunk); ``addr`` from :func:`contiguous_launch_args` or
    :func:`paged_launch_args`."""
    B, H, Kv, hd = dims
    S, k_sb, k_ss, v_sb, v_ss, (pt, n_blocks, page_t) = addr
    G = H // Kv
    out = torch.empty_like(q)
    l = torch.empty((B, Kv, G, 1), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Kv, G, 1), dtype=torch.float32, device=q.device)
    ws = split_workspace(B, Kv, G, hd, S, q.device)
    err = _build.lib("decode_attention").flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), l.data_ptr(), m.data_ptr(), B, H, Kv, hd, S,
        k_sb, k_ss, v_sb, v_ss, hd ** -0.5 if scale is None else scale,
        _build.dtype_code(q.dtype), _build.dtype_code(k.dtype),
        pt, n_blocks, page_t, *workspace_args(ws),
        _build.stream_ptr(q.device))
    _build.check(err, name)
    return out, l, m
