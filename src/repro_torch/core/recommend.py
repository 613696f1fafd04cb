"""§6.5 hyperparameter recommendation procedure (the port of
``core/recommend.py``).

  - <=100 LoRAs: JD-Full without clustering, rank ~ n/2 + 7.
  - >100 LoRAs: rank 16 JD-Full + clustering; pick a mid-network module,
    sweep an exponentially growing number of clusters, and choose the
    minimal k whose reconstruction loss drops below 0.6.  Reconstruction
    loss is a cheap validation metric (no LLM eval needed).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from .cluster import cluster_jd, clustered_reconstruction_errors
from .collection import CompressionConfig, LoRABank
from .jd import (default_generator, jd_full_eig, normalize_bank,
                 reconstruction_errors)


@dataclasses.dataclass
class Recommendation:
    rank: int
    n_clusters: int
    probe_module: Optional[str]
    probe_losses: dict            # k -> reconstruction loss on the probe module
    threshold: float


def recommend_rank(n_loras: int) -> int:
    """Rank rule of thumb for the unclustered regime."""
    return max(4, int(n_loras / 2 + 7))


def pick_probe_module(names: Sequence[str]) -> str:
    """'Select a LoRA module from the middle of the network' (§6.5)."""
    names = sorted(names)
    return names[len(names) // 2]


def recommend(banks: Mapping[str, LoRABank], rank: int = 16,
              threshold: float = 0.6, max_clusters: int = 64,
              iters: int = 10, seed: int = 0,
              starts: Optional[Mapping[int, dict]] = None
              ) -> Recommendation:
    """The §6.5 procedure on the probe module's bank, on its device.

    ``starts[k]`` holds explicit random starts for the solve at k
    clusters: ``jd_full_eig``'s ``U0``/``V0`` at k = 1, ``cluster_jd``'s
    ``starts`` above.  What is not given is drawn from a generator seeded
    ``seed``, anew for each k (the JAX module reuses one key for each k)."""
    names = list(banks)
    n = banks[names[0]].n
    if n <= 100:
        return Recommendation(rank=recommend_rank(n), n_clusters=1,
                              probe_module=None, probe_losses={},
                              threshold=threshold)

    probe = pick_probe_module(names)
    bank = banks[probe]
    A, B, _ = normalize_bank(bank.A.float(), bank.B.float())
    starts = starts or {}

    losses = {}
    k = 1
    best_k = max_clusters
    while k <= max_clusters:
        g = default_generator(A.device, seed)
        if k == 1:
            res = jd_full_eig(A, B, rank=rank, iters=iters, generator=g,
                              **starts.get(1, {}))
            loss = float(reconstruction_errors(A, B, res)["loss"])
        else:
            res = cluster_jd(A, B, rank=rank, n_clusters=k, jd_iters=iters,
                             starts=starts.get(k), generator=g)
            loss = float(clustered_reconstruction_errors(A, B, res)["loss"])
        losses[k] = loss
        if loss < threshold:
            best_k = k
            break
        k *= 2
    return Recommendation(rank=rank, n_clusters=best_k, probe_module=probe,
                          probe_losses=losses, threshold=threshold)


def to_config(rec: Recommendation,
              method: str = "jd_full_eig") -> CompressionConfig:
    return CompressionConfig(method=method, rank=rec.rank,
                             n_clusters=rec.n_clusters)
