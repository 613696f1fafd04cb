"""Compressed-LoRA (JD) application to grouped tokens.

Replaces the TPU kernel ``kernels/jd_apply.py::jd_shrink_scale`` with the
hand-written Hopper kernel of ``csrc/jd_apply.cu``, and ports the
``jd_apply`` composition around it.  ``U Sigma_i V^T x`` keeps per-adapter
state only in the small Sigma stage; ``V^T x`` and ``U (.)`` read bases
shared by every token of a cluster (the paper's App. D):

* JD-Diag: ``jd_shrink_scale`` (shrink through ``V[cluster]``, times the
  token's diagonal Sigma), then ``sgmv_expand`` through ``U[cluster]``;
* JD-Full: the same shrink without a scale, ``sigma_bmm`` by adapter tiles,
  then the expand.

The rank-r intermediate is cast to ``x``'s dtype between the stages, as
on the TPU: with bf16 activations that rounding is part of the function.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernels
or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from . import ref
from .sgmv import (check_fp, check_rank, check_tiles, sgmv_expand,
                   sigma_bmm)

LAUNCHES = 0             # jd_shrink_scale launches since the last reset


def jd_shrink_scale(x: torch.Tensor, V: torch.Tensor,
                    sigma_tok: Optional[torch.Tensor],
                    tile_cids: torch.Tensor, *,
                    block_t: int = 128) -> torch.Tensor:
    """x: (T_pad, d_in); V: (k, d_in, r); sigma_tok: (T_pad, r) per-token
    diagonal Sigma (None: no scale); tile_cids: (T_pad / block_t,) cluster
    per tile.  Returns (x @ V[cluster]) * sigma_tok, (T_pad, r) f32."""
    _build.refuse("jd_shrink_scale", x, V, sigma_tok, tile_cids)
    global LAUNCHES
    if x.device.type == "cpu":
        return ref.jd_shrink_scale_ref(x, V, sigma_tok,
                                       ref.tile_rows(tile_cids, x.shape[0]))
    dev = x.device
    check_fp("x", x, 2, dev)
    check_fp("V", V, 3, dev)
    T, d_in = x.shape
    k, v_in, r = V.shape
    if v_in != d_in:
        raise ValueError(f"V maps {v_in} dims, x has {d_in}")
    check_rank(r)
    if sigma_tok is not None:
        check_fp("sigma_tok", sigma_tok, 2, dev)
        if tuple(sigma_tok.shape) != (T, r):
            raise ValueError(f"sigma_tok must be ({T}, {r})")
    bt = check_tiles(tile_cids, T, block_t, dev)
    out = torch.empty((T, r), dtype=torch.float32, device=dev)
    err = _build.lib().jd_shrink_scale_launch(
        x.data_ptr(), _build.dtype_code(x.dtype), V.data_ptr(),
        _build.dtype_code(V.dtype), tile_cids.data_ptr(),
        None if sigma_tok is None else sigma_tok.data_ptr(),
        0 if sigma_tok is None else _build.dtype_code(sigma_tok.dtype),
        out.data_ptr(), tile_cids.shape[0], bt, d_in, r,
        _build.stream_ptr(dev))
    _build.check(err, "jd_shrink_scale")
    LAUNCHES += 1
    return out


def jd_apply(x, U, V, sigma, ids, tile_cids, tile_ids) -> torch.Tensor:
    """The compressed delta of grouped tokens: x (T_pad, d_in); U (k, d_out,
    r); V (k, d_in, r); sigma (n, r) diag or (n, r, r) full; ids (T_pad,)
    the adapter of each row; tile_cids / tile_ids the cluster / adapter of
    each tile (one adapter, hence one cluster, per tile).  Returns
    (T_pad, d_out) in x's dtype."""
    _build.refuse("jd_apply", x, U, V, sigma, ids, tile_cids, tile_ids)
    T, n_tiles = x.shape[0], tile_ids.shape[0]
    if tile_cids.shape != tile_ids.shape or (T % n_tiles if n_tiles else T):
        raise ValueError("tile_cids and tile_ids must cut x into equal tiles")
    bt = T // n_tiles if n_tiles else 1  # the tile size of the grouping
    if sigma.ndim == 2:                  # JD-Diag
        sig_tok = sigma[ids.long()].to(x.dtype)
        t = jd_shrink_scale(x, V, sig_tok, tile_cids, block_t=bt)
    else:                                # JD-Full
        t = jd_shrink_scale(x, V, None, tile_cids, block_t=bt)
        t = sigma_bmm(t.to(x.dtype), sigma, tile_ids, block_t=bt)
    return sgmv_expand(t.to(x.dtype), U, tile_cids, block_t=bt)
