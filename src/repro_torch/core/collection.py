"""Containers for LoRA collections and their compressed forms (the port of
``core/collection.py``).

A *collection* maps target-module names (e.g. ``"layers.0.attn.q_proj"``)
to stacked adapter banks: the interface between compression
(:mod:`repro_torch.core.jd` / :mod:`repro_torch.core.cluster`) and serving,
which wants per-module ``U/V/Sigma`` plus per-request indices
(:func:`export_for_serving`, applied by ``kernels/ops.py::jd_apply``).

Heterogeneous ranks are zero-padded to the collection max (padding rows of
A / columns of B with zeros leaves every product ``B_i A_i`` unchanged).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from .cluster import (ClusteredJD, cluster_jd,
                      clustered_reconstruction_errors)
from .jd import (JDResult, default_generator, jd_diag, jd_full, jd_full_eig,
                 normalize_bank, reconstruction_errors, svd_per_lora,
                 svd_reconstruction_errors, ties_merge)

F32_BYTES = 4            # the exported arrays are counted as f32


@dataclasses.dataclass
class LoRABank:
    """All adapters targeting one linear module."""

    A: torch.Tensor      # (n, r_pad, d_in)
    B: torch.Tensor      # (n, d_out, r_pad)
    ranks: torch.Tensor  # (n,) original ranks (before padding)

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def d_in(self) -> int:
        return self.A.shape[-1]

    @property
    def d_out(self) -> int:
        return self.B.shape[1]

    def delta(self, i: int) -> torch.Tensor:
        return self.B[i] @ self.A[i]


def stack_bank(pairs: Sequence[tuple], pad_to: Optional[int] = None
               ) -> LoRABank:
    """Stack [(A_1, B_1), ...] of possibly different ranks into a LoRABank."""
    ranks = [a.shape[0] for a, _ in pairs]
    r_pad = pad_to or max(ranks)
    As = [F.pad(a, (0, 0, 0, r_pad - a.shape[0])) for a, _ in pairs]
    Bs = [F.pad(b, (0, r_pad - b.shape[1])) for _, b in pairs]
    return LoRABank(A=torch.stack(As), B=torch.stack(Bs),
                    ranks=torch.tensor(ranks, dtype=torch.int32,
                                       device=pairs[0][0].device))


@dataclasses.dataclass
class CompressionConfig:
    method: str = "jd_full"       # jd_full | jd_full_eig | jd_diag | svd | ties
    rank: int = 16
    n_clusters: int = 1
    iters: int = 10
    normalize: bool = True        # §6.1 unit-Frobenius normalization
    outer_iters: int = 5          # clustering alternations
    seed: int = 0


@dataclasses.dataclass
class CompressedModule:
    """One module's compressed bank + bookkeeping."""

    result: object                # JDResult or ClusteredJD
    norms: Optional[torch.Tensor]  # de-normalization scales (None if not)
    metrics: Dict[str, float]
    method: str

    @property
    def clustered(self) -> bool:
        return isinstance(self.result, ClusteredJD)


def compress_bank(bank: LoRABank, cfg: CompressionConfig,
                  starts: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> CompressedModule:
    """Compress one module bank according to ``cfg`` (renormalization folded
    back into sigma so the stored compressed adapters reconstruct the
    ORIGINAL products).

    ``starts`` holds explicit random starts: ``cluster_jd``'s ``starts``
    when ``cfg.n_clusters > 1``, else the solver's ``U0``/``V0``.  What is
    not given is drawn from ``generator`` (default: seeded ``cfg.seed`` on
    the bank's device).  Runs on the bank's device, in f32.
    """
    A, B = bank.A.float(), bank.B.float()
    norms = None
    if cfg.normalize:
        A, B, norms = normalize_bank(A, B)
    g = generator if generator is not None else default_generator(
        A.device, cfg.seed)
    starts = starts or {}

    if cfg.n_clusters > 1:
        res = cluster_jd(A, B, rank=cfg.rank, n_clusters=cfg.n_clusters,
                         outer_iters=cfg.outer_iters, jd_iters=cfg.iters,
                         solver="eig" if cfg.method == "jd_full_eig"
                         else "eigh", starts=starts, generator=g)
        errs = clustered_reconstruction_errors(A, B, res)
    elif cfg.method in ("jd_full", "jd_full_eig", "jd_diag"):
        fn = {"jd_full": jd_full, "jd_full_eig": jd_full_eig,
              "jd_diag": jd_diag}[cfg.method]
        res = fn(A, B, rank=cfg.rank, iters=cfg.iters, generator=g, **starts)
        errs = reconstruction_errors(A, B, res)
    elif cfg.method == "svd":
        res = svd_per_lora(A, B, rank=cfg.rank)
        errs = svd_reconstruction_errors(A, B, res)
    elif cfg.method == "ties":
        res = ties_merge(A, B, rank=cfg.rank)
        errs = reconstruction_errors(A, B, res)
    else:
        raise ValueError(f"unknown method {cfg.method}")

    if norms is not None:
        res = res.scale_sigma(norms)

    metrics = {k: float(v) for k, v in errs.items() if v.ndim == 0}
    return CompressedModule(result=res, norms=norms, metrics=metrics,
                            method=cfg.method)


def compress_collection(banks: Mapping[str, LoRABank],
                        cfg: CompressionConfig,
                        progress: Optional[Callable[[str, dict], None]] = None,
                        ) -> Dict[str, CompressedModule]:
    """Compress every module bank (the per-module independence of eq. 1)."""
    out = {}
    for name in sorted(banks):
        out[name] = compress_bank(banks[name], cfg)
        if progress is not None:
            progress(name, out[name].metrics)
    return out


def collection_loss(comp: Mapping[str, CompressedModule]) -> float:
    """Mean reconstruction loss across modules (§6.5 validation)."""
    return sum(m.metrics["loss"] for m in comp.values()) / max(len(comp), 1)


# ---------------------------------------------------------------------------
# serving export
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingAdapterBundle:
    """Device-ready arrays for serving, one module.

    Uncompressed:  A (n, r, d_in), B (n, d_out, r)
    Compressed:    U (k, d_out, r), V (k, d_in, r), sigma (n, r[, r]),
                   cluster_of (n,) int32
    """

    kind: str                     # "lora" | "jd"
    arrays: Dict[str, torch.Tensor]
    param_bytes_shared: int       # resident once (U, V)
    param_bytes_per_adapter: int  # per adapter (sigma / A+B)


def export_for_serving(module: CompressedModule) -> ServingAdapterBundle:
    res = module.result
    if isinstance(res, ClusteredJD):
        arrays = dict(U=res.U, V=res.V, sigma=res.sigma,
                      cluster_of=res.assign.to(torch.int32))
        shared = res.U.numel() + res.V.numel()
        per = res.sigma[0].numel() + 1
    elif not isinstance(res, JDResult):
        raise TypeError(f"cannot export {type(res).__name__}")
    elif res.U.ndim == 3:   # svd baseline: per-adapter bases, nothing shared
        arrays = dict(U=res.U, V=res.V, sigma=res.sigma,
                      cluster_of=torch.arange(res.n, dtype=torch.int32,
                                              device=res.U.device))
        shared = 0
        per = res.U[0].numel() + res.V[0].numel() + res.sigma[0].numel()
    else:
        arrays = dict(U=res.U[None], V=res.V[None], sigma=res.sigma,
                      cluster_of=torch.zeros(res.n, dtype=torch.int32,
                                             device=res.U.device))
        shared = res.U.numel() + res.V.numel()
        per = res.sigma[0].numel()
    arrays = {k: v.contiguous() for k, v in arrays.items()}
    return ServingAdapterBundle(kind="jd", arrays=arrays,
                                param_bytes_shared=shared * F32_BYTES,
                                param_bytes_per_adapter=per * F32_BYTES)


def export_uncompressed(bank: LoRABank) -> ServingAdapterBundle:
    per = bank.A[0].numel() + bank.B[0].numel()
    return ServingAdapterBundle(kind="lora", arrays=dict(A=bank.A, B=bank.B),
                                param_bytes_shared=0,
                                param_bytes_per_adapter=per * F32_BYTES)
