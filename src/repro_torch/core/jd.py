"""Joint-diagonalization compression of LoRA collections (the port of
``core/jd.py``).

Works on *stacked* adapter banks: every adapter targeting one linear
module,

    A: (n, r_pad, d_in)   B: (n, d_out, r_pad)

so that ``delta_i = B[i] @ A[i]``; heterogeneous ranks are zero-padded to
``r_pad`` (padding does not change the product).  No function here forms
an (n, d_out, d_in) stack of products.

- :func:`jd_full`      eq. (2), alternating eigendecomposition (App. A.1)
- :func:`jd_full_eig`  App. A.2, QR-orthogonalized power iteration
- :func:`jd_diag`      eq. (3), triple-least-squares coordinate descent
- :func:`svd_per_lora` eq. (4), the k = n degenerate case (r-SVD baseline)
- :func:`ties_merge`   TIES-merging baseline (App. H.3)

Every solver takes an optional per-adapter ``weights`` vector (the
clustering loop passes 0/1 membership masks) and optional explicit
random starts ``U0``/``V0`` (raw normal draws; the solver orthonormalizes
them).  Without them it draws from ``generator`` (default: seeded 0 on the
bank's device).  Everything runs in float32 ``torch.linalg``; set
``torch.backends.cuda.matmul.allow_tf32 = False`` on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JDResult:
    """Compressed representation of one bank: ``B_i A_i ~= U @ Sigma_i @ V^T``.

    ``sigma`` is (n, r, r) when ``diag`` is False, else (n, r).
    """

    U: torch.Tensor  # (d_out, r)
    V: torch.Tensor  # (d_in, r)
    sigma: torch.Tensor
    diag: bool = False

    @property
    def rank(self) -> int:
        return self.U.shape[-1]

    @property
    def n(self) -> int:
        return self.sigma.shape[0]

    def sigma_full(self) -> torch.Tensor:
        """Sigma as (n, r, r) regardless of parameterization."""
        if self.diag:
            return torch.diag_embed(self.sigma)
        return self.sigma

    def reconstruct(self, i: Optional[int] = None) -> torch.Tensor:
        """Materialize reconstructed delta(s). (n, d_out, d_in) or (d_out, d_in)."""
        sig = self.sigma_full()
        if i is not None:
            return self.U @ sig[i] @ self.V.T
        return torch.einsum("nos,is->noi",
                            torch.einsum("or,nrs->nos", self.U, sig), self.V)

    def scale_sigma(self, scales: torch.Tensor) -> "JDResult":
        shape = (-1,) + (1,) * (self.sigma.ndim - 1)
        return dataclasses.replace(self,
                                   sigma=self.sigma * scales.reshape(shape))


# ---------------------------------------------------------------------------
# bank helpers (work on stacked A/B without forming n x d_out x d_in products)
# ---------------------------------------------------------------------------


def product_frob_norms(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """||B_i A_i||_F for each adapter, without forming the products:
    tr(A^T B^T B A) = sum((B^T B) * (A A^T))."""
    BtB = torch.einsum("nor,nos->nrs", B, B)
    AAt = torch.einsum("nri,nsi->nrs", A, A)
    sq = (BtB * AAt).sum(dim=(-2, -1))
    return torch.sqrt(torch.clamp(sq, min=0.0))


def normalize_bank(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-12):
    """Frobenius-normalize each product to 1 (§6.1) by scaling A.

    Returns (A_hat, B, norms); de-normalize by ``result.scale_sigma(norms)``.
    """
    norms = product_frob_norms(A, B)
    return A / torch.clamp(norms, min=eps)[:, None, None], B, norms


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=like.dtype, device=like.device)


def reconstruction_errors(A, B, res: JDResult,
                          weights: Optional[torch.Tensor] = None) -> dict:
    """Per-adapter squared errors + relative metrics, product-free.

    ||BA - U S V^T||^2 = ||BA||^2 - 2 tr(A^T B^T U S V^T) + tr(S^T U^T U S V^T V)
    """
    sig = res.sigma_full()
    norms_sq = product_frob_norms(A, B) ** 2
    BtU = torch.einsum("nor,ok->nrk", B, res.U)
    AV = torch.einsum("nri,ik->nrk", A, res.V)
    cross = ((BtU @ sig) * AV).sum(dim=(-2, -1))
    UtU = res.U.T @ res.U
    VtV = res.V.T @ res.V
    gram = ((UtU @ sig @ VtV.T) * sig).sum(dim=(-2, -1))
    err_sq = torch.clamp(norms_sq - 2.0 * cross + gram, min=0.0)
    rel = torch.sqrt(err_sq / torch.clamp(norms_sq, min=1e-30))
    w = _ones(A.shape[0], A) if weights is None else weights
    wsum = torch.clamp(w.sum(), min=1e-30)
    return dict(
        err_sq=err_sq,
        norms_sq=norms_sq,
        rel_err=rel,
        mean_rel_err=(rel * w).sum() / wsum,
        # the paper's "reconstruction loss" (<= 0.6 rule in §6.5): energy ratio
        loss=(err_sq * w).sum() / torch.clamp((norms_sq * w).sum(), min=1e-30),
    )


def _weighted(x: torch.Tensor, weights: Optional[torch.Tensor]):
    if weights is None:
        return x
    return x * weights.reshape((-1,) + (1,) * (x.ndim - 1))


def _orthonormalize(M: torch.Tensor) -> torch.Tensor:
    """Column-orthonormalize via reduced QR, signs fixed so that diag(R)
    is nonnegative."""
    q, r = torch.linalg.qr(M)
    s = torch.sign(torch.diagonal(r))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return q * s[None, :]


def _top_r_eigvecs(M: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r eigenvectors of a PSD matrix (ascending eigh -> take tail)."""
    _, vecs = torch.linalg.eigh(M)
    return vecs[:, -r:].flip(-1)


def _sigma_full_from(U, V, A, B) -> torch.Tensor:
    """Sigma_i = U^T B_i A_i V  (eq. 6), computed as (U^T B_i)(A_i V)."""
    BtU = torch.einsum("nor,ok->nrk", B, U)
    AV = torch.einsum("nri,il->nrl", A, V)
    return torch.einsum("nrk,nrl->nkl", BtU, AV)


def default_generator(device, seed: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _start(M0, shape, generator, like: torch.Tensor) -> torch.Tensor:
    """The orthonormalized start: ``M0`` (a raw draw passed in) or a normal
    draw from ``generator`` (default: seeded 0 on ``like``'s device)."""
    if M0 is None and generator is None:
        generator = default_generator(like.device)
    if M0 is None:
        M0 = torch.randn(shape, generator=generator, device=generator.device,
                         dtype=torch.float32)
    M0 = torch.as_tensor(M0)
    if tuple(M0.shape) != tuple(shape):
        raise ValueError(f"start has shape {tuple(M0.shape)}, expected "
                         f"{tuple(shape)}")
    return _orthonormalize(M0.to(device=like.device, dtype=like.dtype))


# ---------------------------------------------------------------------------
# JD-Full: alternating eigendecomposition (App. A.1 case 1)
# ---------------------------------------------------------------------------


def jd_full(A, B, rank: int, iters: int = 10,
            weights: Optional[torch.Tensor] = None, V0=None,
            generator: Optional[torch.Generator] = None) -> JDResult:
    """JD-Full via alternating top-r eigendecompositions.

    U-iter: M = sum_i w_i G_i G_i^T with G_i = B_i (A_i V)   -> U = eigvecs_r(M)
    V-iter: N = sum_i w_i K_i K_i^T with K_i = A_i^T (B_i^T U) -> V = eigvecs_r(N)

    Two (d, d) eigendecompositions per iteration: at d = 4096 prefer
    :func:`jd_full_eig`.
    """
    d_in = A.shape[-1]
    V = _start(V0, (d_in, rank), generator, A)
    sw = None if weights is None else torch.sqrt(weights)

    def u_of(V):
        G = torch.einsum("nor,nrk->nok", B, torch.einsum("nri,ik->nrk", A, V))
        G = _weighted(G, sw)
        return _top_r_eigvecs(torch.einsum("nok,npk->op", G, G), rank)

    for _ in range(iters):
        U = u_of(V)
        K = torch.einsum("nri,nrk->nik", A, torch.einsum("nor,ok->nrk", B, U))
        K = _weighted(K, sw)
        V = _top_r_eigvecs(torch.einsum("nik,njk->ij", K, K), rank)
    U = u_of(V)                 # final U for the converged V, then sigma
    return JDResult(U=U, V=V, sigma=_sigma_full_from(U, V, A, B), diag=False)


# ---------------------------------------------------------------------------
# JD-Full: QR eigenvalue iteration (App. A.2)
# ---------------------------------------------------------------------------


def jd_full_eig(A, B, rank: int, iters: int = 30,
                weights: Optional[torch.Tensor] = None, U0=None, V0=None,
                generator: Optional[torch.Generator] = None) -> JDResult:
    """JD-Full via the paper's QR-orthogonalized power iteration.

    U0 <- sum_i B_i (A_i V)((A_i V)^T (B_i^T U));  U <- qr(U0)
    V0 <- sum_i A_i^T (B_i^T U)((B_i^T U)^T (A_i V));  V <- qr(V0)

    Only r-width matmuls + one QR per update: no d x d eigendecompositions.
    """
    d_in, d_out = A.shape[-1], B.shape[1]
    if generator is None:
        generator = default_generator(A.device)
    U = _start(U0, (d_out, rank), generator, A)
    V = _start(V0, (d_in, rank), generator, A)
    for _ in range(iters):
        AV = torch.einsum("nri,ik->nrk", A, V)
        BtU = torch.einsum("nor,ok->nrk", B, U)
        inner_u = torch.einsum("nrk,nrl->nkl", AV, BtU)
        U_new = _orthonormalize(torch.einsum(
            "nor,nrl->ol", B, _weighted(AV, weights) @ inner_u))
        BtU2 = torch.einsum("nor,ok->nrk", B, U_new)
        inner_v = torch.einsum("nrk,nrl->nkl", BtU2, AV)
        V = _orthonormalize(torch.einsum(
            "nri,nrl->il", A, _weighted(BtU2, weights) @ inner_v))
        U = U_new
    return JDResult(U=U, V=V, sigma=_sigma_full_from(U, V, A, B), diag=False)


def jd_convergence_gap(U_prev, U_next) -> torch.Tensor:
    """App. H.12 convergence criterion term: ||U+ - U U^T U+||_F / ||U+||_F."""
    resid = U_next - U_prev @ (U_prev.T @ U_next)
    return torch.linalg.norm(resid) / torch.clamp(torch.linalg.norm(U_next),
                                                  min=1e-30)


# ---------------------------------------------------------------------------
# JD-Diag: triple least squares (App. A.1 case 2)
# ---------------------------------------------------------------------------


def _ridge_solve(M, rhs):
    """(r, r) solve with a tiny Tikhonov floor for rank-deficient cases."""
    r = M.shape[0]
    eye = torch.eye(r, dtype=M.dtype, device=M.device)
    return torch.linalg.solve(M + 1e-8 * torch.trace(M) / r * eye, rhs)


def jd_diag(A, B, rank: int, iters: int = 10,
            weights: Optional[torch.Tensor] = None, U0=None, V0=None,
            generator: Optional[torch.Generator] = None) -> JDResult:
    """JD-Diag coordinate descent: solve U, V, then diag(Sigma_i) in cycle."""
    n, d_in, d_out = A.shape[0], A.shape[-1], B.shape[1]
    if generator is None:
        generator = default_generator(A.device)
    U = _start(U0, (d_out, rank), generator, A)
    V = _start(V0, (d_in, rank), generator, A)
    s = torch.ones((n, rank), dtype=A.dtype, device=A.device)
    w = _ones(n, A) if weights is None else weights
    for _ in range(iters):
        AV = torch.einsum("nri,ik->nrk", A, V)
        G = torch.einsum("nor,nrk->nok", B, AV)        # B_i A_i V
        # U = (sum_i w G_i diag(s_i)) (sum_i w diag(s_i) V^T V diag(s_i))^-1
        t1 = torch.einsum("n,nok,nk->ok", w, G, s)
        t2 = (V.T @ V) * torch.einsum("n,nk,nl->kl", w, s, s)
        U = _ridge_solve(t2.T, t1.T).T
        BtU = torch.einsum("nor,ok->nrk", B, U)
        H = torch.einsum("nri,nrk->nik", A, BtU)       # A_i^T B_i^T U
        t1v = torch.einsum("n,nik,nk->ik", w, H, s)
        t2v = (U.T @ U) * torch.einsum("n,nk,nl->kl", w, s, s)
        V = _ridge_solve(t2v.T, t1v.T).T
        # s_i = (U^T U o V^T V)^{-1} (U^T B_i o V^T A_i^T) 1
        AV = torch.einsum("nri,ik->nrk", A, V)
        BtU = torch.einsum("nor,ok->nrk", B, U)
        q = torch.einsum("nrk,nrk->nk", BtU, AV)
        s = _ridge_solve((U.T @ U) * (V.T @ V), q.T).T
    return JDResult(U=U, V=V, sigma=s, diag=True)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------


def svd_per_lora(A, B, rank: int) -> JDResult:
    """r-SVD baseline (eq. 4): per-adapter truncated SVD, batched.

    QR-factor B_i and A_i^T, SVD the small (r_pad x r_pad) core.  Returned
    with per-adapter bases U: (n, d_out, r), V: (n, d_in, r), sigma: (n, r).
    """
    qb, rb = torch.linalg.qr(B)
    qa, ra = torch.linalg.qr(A.transpose(-1, -2))
    u, s, vt = torch.linalg.svd(rb @ ra.transpose(-1, -2))
    U = qb @ u[..., :rank]
    V = qa @ vt[..., :rank, :].transpose(-1, -2)
    return JDResult(U=U, V=V, sigma=s[..., :rank], diag=True)


def svd_reconstruction_errors(A, B, res: JDResult) -> dict:
    """Reconstruction metrics for the per-adapter SVD baseline."""
    norms_sq = product_frob_norms(A, B) ** 2
    err_sq = torch.clamp(norms_sq - (res.sigma ** 2).sum(-1), min=0.0)
    rel = torch.sqrt(err_sq / torch.clamp(norms_sq, min=1e-30))
    return dict(err_sq=err_sq, norms_sq=norms_sq, rel_err=rel,
                mean_rel_err=rel.mean(),
                loss=err_sq.sum() / torch.clamp(norms_sq.sum(), min=1e-30))


def _quantile_rows(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row quantile with linear interpolation (``jnp.quantile``'s
    default), by a sort: ``torch.quantile`` refuses large inputs."""
    xs, _ = torch.sort(x, dim=1)
    pos = q * (x.shape[1] - 1)
    lo, frac = int(pos), pos - int(pos)
    hi = min(lo + 1, x.shape[1] - 1)
    return xs[:, lo] + frac * (xs[:, hi] - xs[:, lo])


def ties_merge(A, B, rank: int, trim_frac: float = 0.2) -> JDResult:
    """TIES-merging baseline: trim -> elect sign -> disjoint mean -> rank-r SVD.

    Consolidates every adapter into ONE rank-r LoRA (Table 7's Ties row).
    Materializes the (n, d_out, d_in) deltas (fine at test scale).
    """
    n = A.shape[0]
    deltas = torch.einsum("nor,nri->noi", B, A)
    mag = deltas.abs()
    kth = _quantile_rows(mag.reshape(n, -1), 1.0 - trim_frac)
    zero = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    trimmed = torch.where(mag >= kth[:, None, None], deltas, zero)
    sign = torch.sign(trimmed.sum(0))
    agree = torch.where(torch.sign(trimmed) == sign[None], trimmed, zero)
    cnt = torch.sign(agree).abs().sum(0)
    merged = agree.sum(0) / torch.clamp(cnt, min=1.0)
    u, s, vt = torch.linalg.svd(merged, full_matrices=False)
    return JDResult(U=u[:, :rank], V=vt[:rank, :].T,
                    sigma=s[:rank][None].repeat(n, 1), diag=True)


# ---------------------------------------------------------------------------
# objective (for tests / convergence monitoring)
# ---------------------------------------------------------------------------


def jd_objective(A, B, res: JDResult,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_i w_i ||B_i A_i - U Sigma_i V^T||_F^2 (eq. 1)."""
    errs = reconstruction_errors(A, B, res, weights)
    w = _ones(A.shape[0], A) if weights is None else weights
    return (errs["err_sq"] * w).sum()
