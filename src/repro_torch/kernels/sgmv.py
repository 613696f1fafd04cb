"""SGMV (segmented-gather matrix multiply): the grouped multi-adapter
LoRA kernels.

Replaces the TPU kernels ``kernels/sgmv.py::sgmv_shrink``, ``sgmv_expand``
and ``sigma_bmm`` with the hand-written Hopper kernels of
``csrc/sgmv.cu``.  Tokens arrive grouped by adapter and padded so that
every tile of ``block_t`` rows maps to one adapter
(``ref.group_tokens_by_adapter``); ``tile_ids`` holds the adapter of each
tile and each block reads its own.

A CPU tensor goes to the plain version (``ref.sgmv_*_ref`` on the per-row
ids); a CUDA tensor launches the kernel or raises.  The ids must index
their banks: the kernels do not check them.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref

LAUNCHES_SHRINK = 0      # kernel launches since the last reset
LAUNCHES_EXPAND = 0
LAUNCHES_SIGMA = 0
MAX_RANK = 64            # SGMV_RMAX of csrc/sgmv.cuh


def _pick_block(dim: int, target: int) -> int:
    """Largest divisor of `dim` that is <= target (keeps tiles exact)."""
    b = min(dim, target)
    while dim % b:
        b -= 1
    return b


# -- rank-tile cost model (pure) ---------------------------------------------
#
# Copies of the JAX package's pure cost model (``kernels/sgmv.py``): an
# SGMV contraction moves the rank axis through hardware tiles, so a rank-r
# adapter pays for ceil(r / tile) * tile rank lanes.  ``tile_rank=8`` is the
# TPU's f32 sublane tile; the Hopper value is not measured yet.


def sgmv_tile_cost(rank: int, tile_rank: int = 8) -> int:
    """Rank lanes one SGMV contraction actually occupies: `rank` padded
    up to the next multiple of the hardware's native `tile_rank`."""
    if rank < 1:
        raise ValueError("rank must be >= 1")
    if tile_rank < 1:
        raise ValueError("tile_rank must be >= 1")
    return tile_rank * -(-rank // tile_rank)


def sgmv_rank_efficiency(rank: int, tile_rank: int = 8) -> float:
    """Useful fraction of the occupied rank lanes, in (0, 1]: 1.0 when
    `rank` is a tile multiple, 1/tile_rank at its worst."""
    return rank / sgmv_tile_cost(rank, tile_rank)


# -- argument checks shared with jd_apply.py ---------------------------------


def check_fp(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, not {t.ndim}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be f32 or bf16, not {t.dtype}")


def check_tiles(tile_ids: torch.Tensor, T: int, block_t: int, device) -> int:
    """The tile size, after checking that ``tile_ids`` has one int32 id per
    tile of ``T`` rows."""
    bt = _pick_block(T, block_t) if T else block_t
    if tile_ids.dtype != torch.int32 or tile_ids.ndim != 1 \
            or tile_ids.device != device or not tile_ids.is_contiguous():
        raise ValueError(f"tile_ids must be a contiguous int32 vector on "
                         f"{device}")
    if tile_ids.shape[0] * bt != T:
        raise ValueError(f"{tile_ids.shape[0]} tile ids for {T} rows in "
                         f"tiles of {bt}")
    return bt


def check_rank(r: int) -> None:
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")


def sgmv_shrink(x: torch.Tensor, A: torch.Tensor, tile_ids: torch.Tensor, *,
                block_t: int = 128) -> torch.Tensor:
    """x: (T_pad, d_in) grouped tokens; A: (n, r, d_in); tile_ids:
    (T_pad / block_t,) adapter per tile.  Returns (T_pad, r) f32."""
    _build.refuse("sgmv_shrink", x, A, tile_ids)
    global LAUNCHES_SHRINK
    if x.device.type == "cpu":
        return ref.sgmv_shrink_ref(x.float(), A,
                                   ref.tile_rows(tile_ids, x.shape[0]))
    dev = x.device
    check_fp("x", x, 2, dev)
    check_fp("A", A, 3, dev)
    T, d_in = x.shape
    n, r, a_in = A.shape
    if a_in != d_in:
        raise ValueError(f"A maps {a_in} dims, x has {d_in}")
    check_rank(r)
    bt = check_tiles(tile_ids, T, block_t, dev)
    out = torch.empty((T, r), dtype=torch.float32, device=dev)
    err = _build.lib().sgmv_shrink_launch(
        x.data_ptr(), _build.dtype_code(x.dtype), A.data_ptr(),
        _build.dtype_code(A.dtype), tile_ids.data_ptr(), out.data_ptr(),
        tile_ids.shape[0], bt, d_in, r, _build.stream_ptr(dev))
    _build.check(err, "sgmv_shrink")
    LAUNCHES_SHRINK += 1
    return out


def sgmv_expand(t: torch.Tensor, B: torch.Tensor, tile_ids: torch.Tensor, *,
                block_t: int = 128) -> torch.Tensor:
    """t: (T_pad, r); B: (n, d_out, r); returns (T_pad, d_out) in t's
    dtype."""
    _build.refuse("sgmv_expand", t, B, tile_ids)
    global LAUNCHES_EXPAND
    if t.device.type == "cpu":
        return ref.sgmv_expand_ref(t, B, ref.tile_rows(tile_ids, t.shape[0]))
    dev = t.device
    check_fp("t", t, 2, dev)
    check_fp("B", B, 3, dev)
    T, r = t.shape
    n, d_out, b_r = B.shape
    if b_r != r:
        raise ValueError(f"B has rank {b_r}, t has {r}")
    check_rank(r)
    bt = check_tiles(tile_ids, T, block_t, dev)
    out = torch.empty((T, d_out), dtype=t.dtype, device=dev)
    err = _build.lib().sgmv_expand_launch(
        t.data_ptr(), _build.dtype_code(t.dtype), B.data_ptr(),
        _build.dtype_code(B.dtype), tile_ids.data_ptr(), out.data_ptr(),
        tile_ids.shape[0], bt, r, d_out, _build.stream_ptr(dev))
    _build.check(err, "sgmv_expand")
    LAUNCHES_EXPAND += 1
    return out


def sigma_bmm(t: torch.Tensor, sigma: torch.Tensor, tile_ids: torch.Tensor,
              *, block_t: int = 128) -> torch.Tensor:
    """t: (T_pad, r); sigma: (n, r, r); per-tile adapter ids.  Returns
    t @ sigma[id] per tile, (T_pad, r) in t's dtype (JD-Full's middle
    stage)."""
    _build.refuse("sigma_bmm", t, sigma, tile_ids)
    global LAUNCHES_SIGMA
    if t.device.type == "cpu":
        return ref.sigma_bmm_ref(t, sigma, ref.tile_rows(tile_ids,
                                                         t.shape[0]))
    dev = t.device
    check_fp("t", t, 2, dev)
    check_fp("sigma", sigma, 3, dev)
    T, r = t.shape
    if tuple(sigma.shape[1:]) != (r, r):
        raise ValueError(f"sigma must be (n, {r}, {r}), not "
                         f"{tuple(sigma.shape)}")
    check_rank(r)
    bt = check_tiles(tile_ids, T, block_t, dev)
    out = torch.empty((T, r), dtype=t.dtype, device=dev)
    err = _build.lib().sigma_bmm_launch(
        t.data_ptr(), _build.dtype_code(t.dtype), sigma.data_ptr(),
        _build.dtype_code(sigma.dtype), tile_ids.data_ptr(), out.data_ptr(),
        tile_ids.shape[0], bt, r, _build.stream_ptr(dev))
    _build.check(err, "sigma_bmm")
    LAUNCHES_SIGMA += 1
    return out
