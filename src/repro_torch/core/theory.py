"""Numeric checks of the paper's §4 theory (Prop. 1, Thm. 1, Cor. 1): the
port of ``core/theory.py``, in f32 ``torch.linalg``.

They show where a LoRA collection sits between the merged-model lower
bound and the spectral upper bound of what a rank-r JD-Full keeps.
"""
from __future__ import annotations

import torch

from .jd import JDResult


def tilde_r(A: torch.Tensor, B: torch.Tensor, tol: float = 1e-6) -> int:
    """Prop. 1 threshold: max(rank([A_1;...]), rank([B_1,...])), counting
    the singular values above ``tol`` (absolute, as the JAX module's
    ``matrix_rank(M, tol)`` does)."""
    n, r_pad, d_in = A.shape
    d_out = B.shape[1]
    A_cat = A.reshape(n * r_pad, d_in)
    B_cat = B.permute(1, 0, 2).reshape(d_out, n * r_pad)
    ra = int((torch.linalg.svdvals(A_cat) > tol).sum())
    rb = int((torch.linalg.svdvals(B_cat) > tol).sum())
    return max(ra, rb)


def theorem1_bounds(A: torch.Tensor, B: torch.Tensor, rank: int) -> dict:
    """Thm. 1: sum_j<=r sigbar_j^2 <= sum_i ||Sigma_i||^2 <= sum_j<=min(r^2,n) sig_j^2.

    sig_j  = singular values of L = [vec(B_1A_1) ... vec(B_nA_n)]
    sigbar = singular values of sum_i B_i A_i.
    Forms the products: for test-scale dims only.
    """
    n = A.shape[0]
    deltas = torch.einsum("nor,nri->noi", B, A)
    L = deltas.reshape(n, -1).T                     # (d_out*d_in, n)
    sig = torch.linalg.svdvals(L)                   # length min(d^2, n)
    sigbar = torch.linalg.svdvals(deltas.sum(0))
    lower = torch.sum(sigbar[:rank] ** 2)
    upper = torch.sum(sig[: min(rank * rank, n)] ** 2)
    total = torch.sum(sig ** 2)                     # = sum_i ||B_iA_i||^2
    # the paper's proof of the lower bound applies Jensen as
    # sum_i ||x_i||^2 >= ||sum_i x_i||^2, which misses the 1/n factor
    # (x_i identical is a counterexample); the corrected bound is
    # sum_i ||Sigma_i||^2 >= (1/n) * sum_{j<=r} sigbar_j^2
    return dict(lower=float(lower), lower_corrected=float(lower / n),
                upper=float(upper), total=float(total),
                sig=sig, sigbar=sigbar)


def retained_energy(res: JDResult) -> float:
    """sum_i ||Sigma_i||_F^2 (the quantity Thm. 1 bounds; requires
    orthogonal U, V, i.e. JD-Full)."""
    return float(torch.sum(res.sigma_full() ** 2))


def check_theorem1(A: torch.Tensor, B: torch.Tensor, res: JDResult,
                   atol: float = 1e-3) -> dict:
    b = theorem1_bounds(A, B, res.rank)
    kept = retained_energy(res)
    slack = atol * max(b["total"], 1.0)
    return dict(
        lower=b["lower"], lower_corrected=b["lower_corrected"], kept=kept,
        upper=b["upper"], total=b["total"],
        lower_ok=bool(kept >= b["lower_corrected"] - slack),
        lower_literal_ok=bool(kept >= b["lower"] - slack),
        upper_ok=bool(kept <= b["upper"] + slack),
        error_lb=float(1.0 - b["upper"] / max(b["total"], 1e-30)),
    )


def corollary1_regime(A: torch.Tensor, B: torch.Tensor) -> dict:
    """Cor. 1 preconditions: unit Frobenius norms + pairwise orthogonality."""
    n = A.shape[0]
    flat = torch.einsum("nor,nri->noi", B, A).reshape(n, -1)
    gram = flat @ flat.T
    norms = torch.sqrt(torch.diagonal(gram))
    off = gram - torch.diag(torch.diagonal(gram))
    return dict(norms=norms, max_off_diag=float(off.abs().max()))
