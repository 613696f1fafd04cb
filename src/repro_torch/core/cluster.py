"""Clustered joint compression (§3.2, Appendix A.3; the port of
``core/cluster.py``).

Alternates between (1) per-cluster JD-Full solves and (2) reassigning each
adapter to the cluster whose shared basis reconstructs it best.  Every
per-cluster solve runs over the *full* bank with a 0/1 membership mask, as
the JAX package's vmapped solves do; here the clusters are a loop.

Initialization follows App. A.3: one global JD, then k-means on vec(Sigma_i).
The random starts (the global solve's, the k initial centroids, one start
per cluster, reused by every outer iteration) can be passed in through
``starts``; otherwise they are drawn from ``generator``.

The online lifecycle functions (``assign_adapter``, ``add_adapter``,
``drop_adapter``, ``refresh_gate``) place, append, drop and gate single
adapters on the tensors' device without a re-solve; the control plane of
``serving/lifecycle.py`` plugs them in through its hooks
(``launch/grounded_churn.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .jd import (JDResult, default_generator, jd_full, jd_full_eig,
                 product_frob_norms)


@dataclasses.dataclass
class ClusteredJD:
    """k per-cluster bases + per-adapter sigma and assignment."""

    U: torch.Tensor        # (k, d_out, r)
    V: torch.Tensor        # (k, d_in, r)
    sigma: torch.Tensor    # (n, r, r)
    assign: torch.Tensor   # (n,) int32
    diag: bool = False

    @property
    def n_clusters(self) -> int:
        return self.U.shape[0]

    @property
    def rank(self) -> int:
        return self.U.shape[-1]

    def cluster_result(self, j: int) -> JDResult:
        return JDResult(U=self.U[j], V=self.V[j], sigma=self.sigma,
                        diag=self.diag)

    def reconstruct(self, i: int) -> torch.Tensor:
        j = int(self.assign[i])
        return self.U[j] @ self.sigma[i] @ self.V[j].T

    def scale_sigma(self, scales: torch.Tensor) -> "ClusteredJD":
        shape = (-1,) + (1,) * (self.sigma.ndim - 1)
        return dataclasses.replace(self,
                                   sigma=self.sigma * scales.reshape(shape))


# ---------------------------------------------------------------------------
# small fixed-iteration k-means on vec(sigma) for initialization
# ---------------------------------------------------------------------------


def _kmeans(x: torch.Tensor, k: int, iters: int, init_idx=None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Plain k-means from k distinct points ``init_idx`` (default: drawn
    from ``generator``); returns assignments (n,).  x: (n, d)."""
    n = x.shape[0]
    if init_idx is None:
        g = generator if generator is not None else default_generator(
            x.device)
        init_idx = torch.randperm(n, generator=g, device=g.device)[:k]
    cent = x[torch.as_tensor(init_idx).long().to(x.device)]
    a = None
    for _ in range(iters):
        d2 = ((x[:, None, :] - cent[None]) ** 2).sum(-1)       # (n, k)
        a = d2.argmin(dim=1)
        onehot = torch.nn.functional.one_hot(a, k).to(x.dtype)
        filled = onehot.sum(0)
        cent_new = (onehot.T @ x) / torch.clamp(filled, min=1.0)[:, None]
        # keep the old centroid of an empty cluster
        cent = torch.where((filled > 0)[:, None], cent_new, cent)
    return a


# ---------------------------------------------------------------------------
# assignment step: best cluster per adapter under orthogonal-U,V JD-Full
# ---------------------------------------------------------------------------


def _assignment_scores(A, B, U, V) -> torch.Tensor:
    """Retained energy ||U_j^T B_i A_i V_j||_F^2 for every (i, j).

    With orthogonal U_j, V_j the reconstruction error of adapter i in cluster
    j is ||B_iA_i||^2 - retained_ij, so argmax retained == argmin error.
    Returns (n, k).
    """
    AV = torch.einsum("nri,kic->nkrc", A, V)
    BtU = torch.einsum("nor,koc->nkrc", B, U)
    sig = torch.einsum("nkrc,nkrd->nkcd", BtU, AV)
    return (sig ** 2).sum(dim=(-2, -1))


def _solver_start(solver: str, d_in: int, d_out: int, rank: int,
                  g: torch.Generator) -> dict:
    def draw(rows):
        return torch.randn((rows, rank), generator=g, device=g.device)
    if solver == "eig":
        return {"U0": draw(d_out), "V0": draw(d_in)}
    return {"V0": draw(d_in)}


def cluster_jd(A, B, rank: int, n_clusters: int, outer_iters: int = 5,
               jd_iters: int = 10, kmeans_iters: int = 10,
               solver: str = "eig", starts: Optional[dict] = None,
               generator: Optional[torch.Generator] = None) -> ClusteredJD:
    """The full clustering loop (App. A.3).

    solver: "eig" (App. A.2 iteration; default) or "eigh" (App. A.1 exact
            alternating eigendecomposition).
    starts: optional ``{"global": {...}, "centroids": (k,) indices,
            "clusters": [{...}] * k}``, the dicts holding the solver's
            ``U0``/``V0``; whatever is missing is drawn from ``generator``.
    """
    solve = {"eig": jd_full_eig, "eigh": jd_full}[solver]
    n, d_in, d_out = A.shape[0], A.shape[-1], B.shape[1]
    k = n_clusters
    g = generator if generator is not None else default_generator(A.device)
    starts = starts or {}
    glob_start = starts.get("global") or _solver_start(solver, d_in, d_out,
                                                       rank, g)

    # ---- init: global JD + k-means on vec(sigma) ---------------------------
    glob = solve(A, B, rank=rank, iters=jd_iters, **glob_start)
    assign = _kmeans(glob.sigma.reshape(n, -1), k, kmeans_iters,
                     init_idx=starts.get("centroids"), generator=g)
    cstarts = starts.get("clusters") or [
        _solver_start(solver, d_in, d_out, rank, g) for _ in range(k)]

    prev_assign = None
    U = V = None
    for _ in range(outer_iters):
        masks = torch.nn.functional.one_hot(assign.long(), k).to(A.dtype).T
        res = [solve(A, B, rank=rank, iters=jd_iters, weights=masks[j],
                     **cstarts[j]) for j in range(k)]
        U = torch.stack([r.U for r in res])
        V = torch.stack([r.V for r in res])
        assign = _assignment_scores(A, B, U, V).argmax(dim=1).to(torch.int32)
        if prev_assign is not None and torch.equal(assign, prev_assign):
            break
        prev_assign = assign

    # final per-adapter sigma against its own cluster basis
    a = assign.long()
    BtU = torch.einsum("nor,nok->nrk", B, U[a])
    AV = torch.einsum("nri,nil->nrl", A, V[a])
    sigma = torch.einsum("nrk,nrl->nkl", BtU, AV)
    return ClusteredJD(U=U, V=V, sigma=sigma, assign=assign, diag=False)


def clustered_reconstruction_errors(A, B, c: ClusteredJD) -> dict:
    """Reconstruction metrics where each adapter uses its assigned cluster."""
    norms_sq = product_frob_norms(A, B) ** 2
    a = c.assign.long()
    BtU = torch.einsum("nor,nok->nrk", B, c.U[a])
    AV = torch.einsum("nri,nik->nrk", A, c.V[a])
    cross = ((BtU @ c.sigma) * AV).sum(dim=(-2, -1))
    # U_j, V_j orthonormal => gram = ||sigma_i||^2
    gram = (c.sigma ** 2).sum(dim=(-2, -1))
    err_sq = torch.clamp(norms_sq - 2.0 * cross + gram, min=0.0)
    rel = torch.sqrt(err_sq / torch.clamp(norms_sq, min=1e-30))
    return dict(err_sq=err_sq, norms_sq=norms_sq, rel_err=rel,
                mean_rel_err=rel.mean(),
                loss=err_sq.sum() / torch.clamp(norms_sq.sum(), min=1e-30))


# ---------------------------------------------------------------------------
# online lifecycle: incremental assignment, lazy shrink, refresh gate
# ---------------------------------------------------------------------------


def assign_adapter(A_i, B_i, c: ClusteredJD):
    """Incrementally place ONE new adapter on its nearest existing basis.

    The online-registration half of the assignment step: score every
    cluster with :func:`_assignment_scores` on a singleton bank (retained
    energy under the orthogonal bases — argmax retained == argmin
    reconstruction error) and compute the adapter's Sigma against the
    winner.  Nothing is re-solved, so this is cheap enough to run at
    register time; the basis only *serves* the adapter after the next
    refresh ships it fleet-wide (see ``serving/lifecycle.py``).

    A_i: (r_lora, d_in), B_i: (d_out, r_lora).  Returns
    ``(cluster, sigma, rel_err)`` — the nearest cluster index, the (r, r)
    Sigma against that cluster's basis, and the adapter's relative
    reconstruction error under it."""
    A, B = A_i[None], B_i[None]
    scores = _assignment_scores(A, B, c.U, c.V)[0]            # (k,)
    j = int(scores.argmax())
    sigma = (c.U[j].T @ B_i) @ (A_i @ c.V[j])
    norm_sq = product_frob_norms(A, B)[0] ** 2
    err_sq = torch.clamp(norm_sq - scores[j], min=0.0)
    rel = float(torch.sqrt(err_sq / torch.clamp(norm_sq, min=1e-30)))
    return j, sigma, rel


def add_adapter(c: ClusteredJD, A_i, B_i):
    """Hot-register: append one adapter to the collection without a
    re-solve (its Sigma rides the nearest existing basis; the next basis
    refresh re-solves with it as a full member).  Returns
    ``(new ClusteredJD, cluster, rel_err)``."""
    j, sigma, rel = assign_adapter(A_i, B_i, c)
    new = dataclasses.replace(
        c, sigma=torch.cat([c.sigma, sigma[None].to(c.sigma.dtype)]),
        assign=torch.cat([c.assign, torch.tensor(
            [j], dtype=c.assign.dtype, device=c.assign.device)]))
    return new, j, rel


def drop_adapter(c: ClusteredJD, i: int) -> ClusteredJD:
    """Retire: drop adapter `i`'s Sigma row and assignment.  The shared
    bases are left untouched — lazy shrink: they still reconstruct every
    remaining adapter exactly as before, and the next refresh re-solves
    over the smaller membership."""
    keep = torch.arange(c.sigma.shape[0], device=c.sigma.device) != i
    return dataclasses.replace(c, sigma=c.sigma[keep], assign=c.assign[keep])


def refresh_gate(A, B, serving: ClusteredJD, candidate: ClusteredJD,
                 max_regression: float = 0.0, abs_slack: float = 1e-6,
                 max_new_rel_err: float = 1.0) -> dict:
    """Quality gate for a basis-refresh rollout (invariant L3).

    `A`/`B` is the bank the *candidate* covers; its first
    ``serving.sigma.shape[0]`` adapters (same order) are the ones the
    serving basis covers, any tail rows are newly absorbed raw adapters.
    The candidate passes only if

    - the adapters already served compressed do not regress: candidate
      mean relative reconstruction error <= serving mean * (1 +
      `max_regression`) + `abs_slack`, and
    - every newly absorbed adapter lands under `max_new_rel_err` (it was
      being served RAW, i.e. exactly).

    Returns ``dict(ok, serving_err, candidate_err, new_worst_rel_err)``
    — plain floats, consumable by the torch-free control plane."""
    n_old = serving.sigma.shape[0]
    old_m = clustered_reconstruction_errors(A[:n_old], B[:n_old], serving)
    cand = clustered_reconstruction_errors(A, B, candidate)
    old_err = float(old_m["mean_rel_err"])
    new_err = float(cand["rel_err"][:n_old].mean())
    new_worst = (float(cand["rel_err"][n_old:].max())
                 if A.shape[0] > n_old else 0.0)
    ok = (new_err <= old_err * (1.0 + max_regression) + abs_slack
          and new_worst <= max_new_rel_err)
    return dict(ok=bool(ok), serving_err=old_err, candidate_err=new_err,
                new_worst_rel_err=new_worst)


def parameter_counts(d_out: int, d_in: int, n: int, rank: int,
                     n_clusters: int = 1, diag: bool = False,
                     lora_rank: int = 16) -> dict:
    """§F parameter accounting: compressed vs uncompressed counts."""
    base = n * lora_rank * (d_out + d_in)
    shared = n_clusters * rank * (d_out + d_in)
    per = n * (rank if diag else rank * rank) + (n if n_clusters > 1 else 0)
    comp = shared + per
    return dict(uncompressed=base, compressed=comp,
                saved_ratio=1.0 - comp / base)
