"""The port's compression core (``repro_torch.core``) on the CPU against the
JAX package's ``core``, on the fixtures of ``tests/test_jd.py`` and
``tests/test_cluster.py``, with the JAX random starts passed in.

Eigenvectors are determined only up to sign (and the two sides run other
LAPACK paths), so the tests compare what does not depend on the sign:
reconstruction errors and objectives (1e-4 relative to the adapters'
energy, see ``assert_errors_match``), reconstructed products
``U Sigma_i V^T``, cluster assignments up to relabelling, applied deltas.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcl
from repro.core import collection as jco
from repro.core import jd as jjd
from repro.kernels import ops as jax_ops
from repro_torch import convert
from repro_torch.core import cluster as tcl
from repro_torch.core import collection as tco
from repro_torch.core import jd as tjd
from repro_torch.kernels import ops

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return convert.array_to_tensor(np.asarray(a))


def random_bank(seed, n=8, r_l=4, d_in=48, d_out=32, scale=0.25):
    """``tests/test_jd.py``'s bank, as JAX arrays and CPU tensors."""
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    A = jax.random.normal(ka, (n, r_l, d_in)) * scale
    B = jax.random.normal(kb, (n, d_out, r_l)) * scale
    return (A, B), (_t(A), _t(B))


def two_group_bank(seed, per=6, r_l=2, d=24, noise=0.02):
    """``tests/test_cluster.py``'s two well-separated low-rank families."""
    k1, k2, k3, k4, kn = jax.random.split(jax.random.PRNGKey(seed), 5)
    A1 = jax.random.normal(k1, (1, r_l, d))
    B1 = jax.random.normal(k2, (1, d, r_l))
    A2 = jax.random.normal(k3, (1, r_l, d))
    B2 = jax.random.normal(k4, (1, d, r_l))
    A = jnp.concatenate([jnp.tile(A1, (per, 1, 1)), jnp.tile(A2, (per, 1, 1))])
    B = jnp.concatenate([jnp.tile(B1, (per, 1, 1)), jnp.tile(B2, (per, 1, 1))])
    A = A + noise * jax.random.normal(kn, A.shape)
    return (A, B), (_t(A), _t(B))


# -- the JAX draws, as each JAX solver makes them from its key --------------


def eig_starts(key, d_in, d_out, rank):
    """jd_full_eig / jd_diag: ku, kv = split(key)."""
    ku, kv = jax.random.split(key)
    return {"U0": np.array(jax.random.normal(ku, (d_out, rank))),
            "V0": np.array(jax.random.normal(kv, (d_in, rank)))}


def full_starts(key, d_in, d_out, rank):
    """jd_full: V from the key itself."""
    return {"V0": np.array(jax.random.normal(key, (d_in, rank)))}


def cluster_starts(key, n, d_in, d_out, rank, k, solver):
    """cluster_jd: k_init, k_km, k_solve = split(key, 3); one start per
    cluster from split(k_solve, k), reused by every outer iteration."""
    one = eig_starts if solver == "eig" else full_starts
    k_init, k_km, k_solve = jax.random.split(key, 3)
    return {"global": one(k_init, d_in, d_out, rank),
            "centroids": np.array(jax.random.choice(k_km, n, shape=(k,),
                                                    replace=False)),
            "clusters": [one(kk, d_in, d_out, rank)
                         for kk in jax.random.split(k_solve, k)]}


def assert_errors_match(got: dict, want: dict):
    """err_sq is ||B_i A_i||^2 - 2 cross + gram, a difference of terms of
    the size of the adapter's energy, so it is held to RTOL of that energy;
    the ratios (rel_err, mean_rel_err, loss) to RTOL absolute."""
    norms = np.asarray(want["norms_sq"])
    np.testing.assert_allclose(got["norms_sq"].numpy(), norms, rtol=1e-5)
    np.testing.assert_allclose(got["err_sq"].numpy(),
                               np.asarray(want["err_sq"]), rtol=0,
                               atol=RTOL * norms.max(), err_msg="err_sq")
    for name in ("rel_err", "loss", "mean_rel_err"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=RTOL, err_msg=name)


def assert_products_match(got, want, rtol=RTOL):
    """Reconstructed products, to rtol of the largest entry."""
    g, w = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(g, w, rtol=0, atol=rtol * np.abs(w).max())


def test_product_norms_and_normalize_match_jax():
    (A, B), (tA, tB) = random_bank(0)
    np.testing.assert_allclose(tjd.product_frob_norms(tA, tB).numpy(),
                               np.asarray(jjd.product_frob_norms(A, B)),
                               rtol=1e-6)
    _, _, n_t = tjd.normalize_bank(tA, tB)
    a_hat, _, n_j = jjd.normalize_bank(A, B)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-6)
    np.testing.assert_allclose(
        tjd.normalize_bank(tA, tB)[0].numpy(), np.asarray(a_hat), rtol=1e-6)


@pytest.mark.parametrize("solver,rank,iters,seed", [
    ("jd_full", 6, 8, 1),
    ("jd_full_eig", 8, 30, 5),
    ("jd_diag", 8, 20, 7),
])
def test_solver_matches_jax(solver, rank, iters, seed):
    (A, B), (tA, tB) = random_bank(seed)
    key = jax.random.PRNGKey(0)
    mk = full_starts if solver == "jd_full" else eig_starts
    starts = mk(key, A.shape[-1], B.shape[1], rank)
    want = getattr(jjd, solver)(A, B, rank=rank, iters=iters, key=key)
    got = getattr(tjd, solver)(tA, tB, rank=rank, iters=iters, **starts)
    assert got.diag == want.diag and tuple(got.sigma.shape) == \
        want.sigma.shape
    assert_errors_match(tjd.reconstruction_errors(tA, tB, got),
                        jjd.reconstruction_errors(A, B, want))
    np.testing.assert_allclose(float(tjd.jd_objective(tA, tB, got)),
                               float(jjd.jd_objective(A, B, want)),
                               rtol=RTOL)
    assert_products_match(got.reconstruct(), want.reconstruct())
    # and the port's result, carried across, scores the same under JAX
    back = convert.compressed_result(want)
    assert_errors_match(tjd.reconstruction_errors(tA, tB, back),
                        jjd.reconstruction_errors(A, B, want))


def test_weighted_solve_matches_jax():
    (A, B), (tA, tB) = random_bank(3)
    w = np.array([1, 0, 1, 1, 0, 1, 0, 1], np.float32)
    key = jax.random.PRNGKey(2)
    starts = eig_starts(key, A.shape[-1], B.shape[1], 5)
    want = jjd.jd_full_eig(A, B, rank=5, iters=20, weights=jnp.asarray(w),
                           key=key)
    got = tjd.jd_full_eig(tA, tB, rank=5, iters=20,
                          weights=torch.from_numpy(w), **starts)
    assert_errors_match(
        tjd.reconstruction_errors(tA, tB, got, torch.from_numpy(w)),
        jjd.reconstruction_errors(A, B, want, jnp.asarray(w)))


def test_convergence_gap_matches_jax():
    (A, B), (tA, tB) = random_bank(6)
    key = jax.random.PRNGKey(0)
    s = eig_starts(key, A.shape[-1], B.shape[1], 6)
    j1 = jjd.jd_full_eig(A, B, rank=6, iters=10, key=key)
    j2 = jjd.jd_full_eig(A, B, rank=6, iters=11, key=key)
    t1 = tjd.jd_full_eig(tA, tB, rank=6, iters=10, **s)
    t2 = tjd.jd_full_eig(tA, tB, rank=6, iters=11, **s)
    np.testing.assert_allclose(float(tjd.jd_convergence_gap(t1.U, t2.U)),
                               float(jjd.jd_convergence_gap(j1.U, j2.U)),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("method", ["svd", "ties"])
def test_baselines_match_jax(method):
    (A, B), (tA, tB) = random_bank(8, r_l=4)
    if method == "svd":
        want, got = jjd.svd_per_lora(A, B, 3), tjd.svd_per_lora(tA, tB, 3)
        assert_errors_match(tjd.svd_reconstruction_errors(tA, tB, got),
                            jjd.svd_reconstruction_errors(A, B, want))
        np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma),
                                   rtol=RTOL, atol=1e-6)
    else:
        want, got = jjd.ties_merge(A, B, 8), tjd.ties_merge(tA, tB, 8)
        assert_errors_match(tjd.reconstruction_errors(tA, tB, got),
                            jjd.reconstruction_errors(A, B, want))
        assert_products_match(got.reconstruct(2), want.reconstruct(2))


def test_stack_bank_and_parameter_counts_match_jax():
    rng = np.random.default_rng(10)
    pairs = [(rng.standard_normal((r, 20)).astype(np.float32),
              rng.standard_normal((16, r)).astype(np.float32))
             for r in (2, 4, 3)]
    want = jco.stack_bank([(jnp.asarray(a), jnp.asarray(b))
                           for a, b in pairs])
    got = tco.stack_bank([(torch.from_numpy(a), torch.from_numpy(b))
                          for a, b in pairs])
    for f in ("A", "B", "ranks"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.n == 3 and got.d_in == 20 and got.d_out == 16
    args = dict(d_out=4096, d_in=4096, n=1000, rank=16, n_clusters=25)
    assert tcl.parameter_counts(**args) == jcl.parameter_counts(**args)


def _same_partition(a, b):
    """Assignments equal up to relabelling of the clusters."""
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("solver", ["eig", "eigh"])
def test_cluster_jd_matches_jax(solver):
    (A, B), (tA, tB) = two_group_bank(0)
    key = jax.random.PRNGKey(0)
    kw = dict(rank=4, n_clusters=2, jd_iters=25, outer_iters=6,
              solver=solver)
    want = jcl.cluster_jd(A, B, key=key, **kw)
    starts = cluster_starts(key, 12, 24, 24, 4, 2, solver)
    got = tcl.cluster_jd(tA, tB, starts=starts, **kw)
    assert got.assign.dtype == torch.int32
    assert _same_partition(got.assign.numpy(), want.assign)
    assign = got.assign.numpy()
    assert len(set(assign[:6])) == 1 and assign[0] != assign[6]
    assert_errors_match(tcl.clustered_reconstruction_errors(tA, tB, got),
                        jcl.clustered_reconstruction_errors(A, B, want))
    for i in (0, 7):
        assert_products_match(got.reconstruct(i), want.reconstruct(i))


def test_kmeans_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal((10, 4)) + 4 * c
                        for c in range(3)]).astype(np.float32)
    key = jax.random.PRNGKey(1)
    idx = np.array(jax.random.choice(key, 30, shape=(3,), replace=False))
    want = jcl._kmeans(jnp.asarray(x), 3, 10, key)
    got = tcl._kmeans(torch.from_numpy(x), 3, 10, init_idx=idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _compress_both(A, B, tA, tB, cfg_kw, ranks):
    cfg_j = jco.CompressionConfig(**cfg_kw)
    cfg_t = tco.CompressionConfig(**cfg_kw)
    key = jax.random.PRNGKey(cfg_j.seed)
    n, d_in, d_out, r = A.shape[0], A.shape[-1], B.shape[1], cfg_j.rank
    if cfg_j.n_clusters > 1:
        solver = "eig" if cfg_j.method == "jd_full_eig" else "eigh"
        starts = cluster_starts(key, n, d_in, d_out, r, cfg_j.n_clusters,
                                solver)
    else:
        mk = full_starts if cfg_j.method == "jd_full" else eig_starts
        starts = mk(key, d_in, d_out, r)
    want = jco.compress_bank(jco.LoRABank(A=A, B=B, ranks=ranks), cfg_j)
    got = tco.compress_bank(convert.lora_bank(jco.LoRABank(
        A=A, B=B, ranks=ranks)), cfg_t, starts=starts)
    return got, want


@pytest.mark.parametrize("cfg_kw", [
    dict(method="jd_full_eig", rank=4, n_clusters=2, iters=20),
    dict(method="jd_full", rank=4, iters=15),
    dict(method="jd_diag", rank=4, iters=20),
])
def test_compress_bank_matches_jax(cfg_kw):
    (A, B), (tA, tB) = two_group_bank(2)
    ranks = jnp.full((12,), 2, jnp.int32)
    got, want = _compress_both(A, B, tA, tB, cfg_kw, ranks)
    assert got.clustered == want.clustered
    assert set(got.metrics) == set(want.metrics) == {"loss",
                                                      "mean_rel_err"}
    for k in got.metrics:            # ratios: RTOL absolute
        np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                   rtol=0, atol=RTOL, err_msg=k)
    # de-normalized sigma reconstructs the original products
    i = 3
    assert_products_match(got.result.reconstruct(i),
                          want.result.reconstruct(i))


@pytest.mark.parametrize("cfg_kw", [
    dict(method="jd_full_eig", rank=4, n_clusters=2, iters=20),
    dict(method="jd_diag", rank=4, iters=20),
])
def test_compress_export_apply_matches_jax(cfg_kw):
    """JAX compress_bank -> export_for_serving -> ops.jd_apply (Pallas in
    interpret mode) against the port's chain on the CPU, on f32 tokens of
    mixed adapters.  Tolerance: the chains agree to ~1e-5 relative in the
    compressed factors, so 1e-4 of the largest delta.

    The applied full-Sigma delta is ``U Sigma^T V^T x`` (the kernels take
    ``t @ Sigma``; ROADMAP queue 3), which depends on the sign of every
    basis column, not only on the product.  So the fixture's families
    have rank 4 = the compression rank: every basis direction is set by
    the data, and the sign-fixed QR picks the same signs on both sides."""
    (A, B), (tA, tB) = two_group_bank(4, r_l=4)
    ranks = jnp.full((12,), 4, jnp.int32)
    got, want = _compress_both(A, B, tA, tB, cfg_kw, ranks)
    jb = jco.export_for_serving(want)
    tb = tco.export_for_serving(got)
    assert (tb.kind, tb.param_bytes_shared, tb.param_bytes_per_adapter) == \
        (jb.kind, jb.param_bytes_shared, jb.param_bytes_per_adapter)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    ids = rng.integers(0, 12, size=40).astype(np.int32)
    ja = jb.arrays
    y_j = jax_ops.jd_apply(jnp.asarray(x), ja["U"], ja["V"], ja["sigma"],
                           ja["cluster_of"], jnp.asarray(ids), tile=8,
                           use_pallas="interpret")
    ta = tb.arrays
    y_t = ops.jd_apply_grouped(torch.from_numpy(x), ta["U"], ta["V"],
                               ta["sigma"], ta["cluster_of"],
                               torch.from_numpy(ids), tile=8)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=1e-4 * (1 + np.abs(np.asarray(y_j))).max())
    # the JAX bundle carried across applies the same in the port
    cb = convert.serving_bundle(jb)
    y_c = ops.jd_apply(torch.from_numpy(x), cb.arrays["U"], cb.arrays["V"],
                       cb.arrays["sigma"], cb.arrays["cluster_of"],
                       torch.from_numpy(ids))
    np.testing.assert_allclose(y_c.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    # the uncompressed export matches too
    ju = jco.export_uncompressed(jco.LoRABank(A=A, B=B, ranks=ranks))
    tu = tco.export_uncompressed(convert.lora_bank(jco.LoRABank(
        A=A, B=B, ranks=ranks)))
    assert tu.param_bytes_per_adapter == ju.param_bytes_per_adapter


def test_solvers_draw_from_a_generator_without_starts():
    (_, _), (tA, tB) = random_bank(11)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tjd.jd_full_eig(tA, tB, rank=4, iters=5, generator=g1)
    b = tjd.jd_full_eig(tA, tB, rank=4, iters=5, generator=g2)
    assert torch.equal(a.U, b.U) and torch.equal(a.sigma, b.sigma)
    c = tcl.cluster_jd(tA, tB, rank=3, n_clusters=2, jd_iters=5,
                       outer_iters=2)
    assert c.U.shape == (2, 32, 3) and c.assign.shape == (8,)
    with pytest.raises(ValueError):
        tjd.jd_full(tA, tB, rank=4, V0=np.zeros((3, 4), np.float32))


def test_compress_apply_entry_point_on_the_cpu():
    """The launcher's path at reduced width: every output finite and of
    its shape, the decode batch padded to whole tiles, and each compressed
    delta as far from the uncompressed one as the batch adapters'
    reconstruction error says (full Sigma applied as ``Sigma^T``, see the
    parity test above)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import compress_apply
    report, art = compress_apply.run(smoke_config("mistral-7b"),
                                     n_adapters=32, seqs=4, seq_len=32,
                                     device="cpu", iters=1)
    full = f"jd_full_eig_k{compress_apply.N_CLUSTERS}"
    assert set(report["modes"]) == {"lora", full, "jd_diag"}
    dec = report["batches"]["decode"]
    assert (dec["tokens"], dec["padded_rows"]) == (4, 4 * compress_apply.TILE)
    for (mode, bname), y in art["outputs"].items():
        x, ids = art["batches"][bname]
        assert y.shape == (ids.numel(), report["d_out"]) and y.dtype == x.dtype
        assert bool(torch.isfinite(y).all())
    bank = art["bank"]
    A, B = bank.A.float(), bank.B.float()
    x, ids = art["batches"]["prefill"]
    sel = torch.unique(ids.long())
    y_lora = art["outputs"][("lora", "prefill")].float()
    for mode, res in art["results"].items():
        errs = (tcl.clustered_reconstruction_errors(A, B, res)
                if mode == full else tjd.reconstruction_errors(A, B, res))
        want = float(errs["err_sq"][sel].sum() / errs["norms_sq"][sel].sum())
        a = art["bundles"][mode].arrays
        sig = a["sigma"] if a["sigma"].ndim == 2 else a["sigma"].transpose(
            1, 2)
        y = ops.jd_apply(x, a["U"], a["V"], sig, a["cluster_of"], ids)
        got = float(torch.linalg.norm(y.float() - y_lora)
                    / torch.linalg.norm(y_lora))
        assert abs(got - want ** 0.5) <= 0.1 * want ** 0.5 + 0.02, (mode, got,
                                                                   want)


def test_compress_collection_matches_jax():
    """Per-module compression of a collection (the deterministic SVD
    baseline, so no random start is involved) and its mean loss."""
    banks_j, banks_t = {}, {}
    for name, seed in (("layers.1.q", 12), ("layers.0.v", 13)):
        (A, B), _ = random_bank(seed, n=5, r_l=3, d_in=20, d_out=16)
        bank = jco.LoRABank(A=A, B=B, ranks=jnp.full((5,), 3, jnp.int32))
        banks_j[name], banks_t[name] = bank, convert.lora_bank(bank)
    seen = []
    got = tco.compress_collection(banks_t, tco.CompressionConfig(
        method="svd", rank=2), progress=lambda n, m: seen.append(n))
    want = jco.compress_collection(banks_j, jco.CompressionConfig(
        method="svd", rank=2))
    assert seen == sorted(banks_t) == list(got)
    np.testing.assert_allclose(tco.collection_loss(got),
                               jco.collection_loss(want), rtol=0, atol=RTOL)
    i = 1
    bank = banks_t["layers.0.v"]
    np.testing.assert_allclose(bank.delta(i).numpy(),
                               np.asarray(banks_j["layers.0.v"].delta(i)),
                               rtol=1e-5, atol=1e-6)
