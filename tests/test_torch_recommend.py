"""The port's §6.5 recommendation procedure and §4 theory checks against
`repro.core.recommend` and `repro.core.theory`, on fixed-seed banks; the
solvers' random starts are JAX's draws, passed in."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collection as jco
from repro.core import jd as jjd
from repro.core import theory as jth
from repro_torch import convert
from repro_torch.core import collection as tco
from repro_torch.core import recommend as trec
from repro_torch.core import theory as tth

# the module, not the function of the same name that repro.core exports
jrec = importlib.import_module("repro.core.recommend")
# f32 SVDs and solver iterations in two frameworks
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bank(seed, n=6, r=3, d=24, scale=0.3):
    rng = np.random.default_rng(seed)
    return ((scale * rng.standard_normal((n, r, d))).astype(np.float32),
            (scale * rng.standard_normal((n, d, r))).astype(np.float32))


def _families(n=120, d=24, seed=1, n_fam=4):
    """Families of rank-2 adapters around shared (A, B) pairs: the
    clustering regime (n > 100), where at rank 2 one basis misses the 0.6
    threshold (loss ~0.66) and two clusters meet it (~0.39)."""
    rng = np.random.default_rng(seed)
    A = np.concatenate([np.tile(rng.standard_normal((1, 2, d)),
                                (n // n_fam, 1, 1)) for _ in range(n_fam)])
    B = np.concatenate([np.tile(rng.standard_normal((1, d, 2)),
                                (n // n_fam, 1, 1)) for _ in range(n_fam)])
    A = A + 0.05 * rng.standard_normal((n, 2, d))
    return A.astype(np.float32), B.astype(np.float32)


# -- the JAX draws, as each JAX solver makes them from its key -------------


def _eig_starts(key, d_in, d_out, rank):
    ku, kv = jax.random.split(key)
    return {"U0": np.array(jax.random.normal(ku, (d_out, rank))),
            "V0": np.array(jax.random.normal(kv, (d_in, rank)))}


def _cluster_starts(key, n, d_in, d_out, rank, k):
    k_init, k_km, k_solve = jax.random.split(key, 3)
    return {"global": _eig_starts(k_init, d_in, d_out, rank),
            "centroids": np.array(jax.random.choice(k_km, n, shape=(k,),
                                                    replace=False)),
            "clusters": [_eig_starts(kk, d_in, d_out, rank)
                         for kk in jax.random.split(k_solve, k)]}


def test_rank_rule_and_probe_module():
    for n in (1, 2, 10, 64, 100, 101):
        assert trec.recommend_rank(n) == jrec.recommend_rank(n)
    names = [f"layers.{i}.q" for i in range(9)]
    assert trec.pick_probe_module(names) == jrec.pick_probe_module(names) \
        == sorted(names)[4]


def test_small_collection_needs_no_clustering():
    banks_t, banks_j = {}, {}
    for i, m in enumerate(("l0.q", "l1.q")):
        A, B = _bank(i, n=10, r=2)
        ranks = np.full((10,), 2, np.int32)
        banks_j[m] = jco.LoRABank(A=jnp.asarray(A), B=jnp.asarray(B),
                                  ranks=jnp.asarray(ranks))
        banks_t[m] = convert.lora_bank(jco.LoRABank(A=A, B=B, ranks=ranks))
    got, want = trec.recommend(banks_t), jrec.recommend(banks_j)
    assert (got.rank, got.n_clusters, got.probe_module, got.probe_losses) == \
        (want.rank, want.n_clusters, want.probe_module, want.probe_losses) \
        == (trec.recommend_rank(10), 1, None, {})


def test_large_collection_matches_jax():
    A, B = _families()
    n, ranks = A.shape[0], np.full((A.shape[0],), 2, np.int32)
    kw = dict(rank=2, max_clusters=8, iters=8, seed=3)
    want = jrec.recommend({"mid.q": jco.LoRABank(
        A=jnp.asarray(A), B=jnp.asarray(B), ranks=jnp.asarray(ranks))}, **kw)
    key = jax.random.PRNGKey(kw["seed"])
    starts = {1: _eig_starts(key, 24, 24, 2)}
    starts.update({k: _cluster_starts(key, n, 24, 24, 2, k)
                   for k in (2, 4, 8)})
    got = trec.recommend({"mid.q": convert.lora_bank(jco.LoRABank(
        A=A, B=B, ranks=ranks))}, starts=starts, **kw)
    assert want.n_clusters > 1                 # k = 1 missed the threshold
    assert got.n_clusters == want.n_clusters
    assert got.probe_module == want.probe_module == "mid.q"
    assert sorted(got.probe_losses) == sorted(want.probe_losses)
    for k, loss in want.probe_losses.items():
        assert abs(got.probe_losses[k] - loss) < RTOL, k
    assert min(got.probe_losses.values()) < got.threshold
    cfg = trec.to_config(got)
    assert cfg == tco.CompressionConfig(method="jd_full_eig", rank=2,
                                        n_clusters=got.n_clusters)
    assert jrec.to_config(want).n_clusters == cfg.n_clusters


def test_recommend_draws_its_own_starts():
    """Without starts the port draws from a generator seeded ``seed``: the
    same result twice, and the same regime as JAX's."""
    A, B = _families(seed=2)
    bank = convert.lora_bank(jco.LoRABank(
        A=A, B=B, ranks=np.full((A.shape[0],), 2, np.int32)))
    runs = [trec.recommend({"m": bank}, rank=2, max_clusters=8, iters=8)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert 1 < runs[0].n_clusters <= 8


@pytest.mark.parametrize("seed,n,rank", [(0, 3, 2), (5, 6, 3), (11, 8, 8)])
def test_theorem1_matches_jax(seed, n, rank):
    A, B = _bank(seed, n=n)
    want = jth.theorem1_bounds(jnp.asarray(A), jnp.asarray(B), rank)
    got = tth.theorem1_bounds(torch.from_numpy(A), torch.from_numpy(B), rank)
    for k in ("lower", "lower_corrected", "upper", "total"):
        assert abs(got[k] - want[k]) <= RTOL * want["total"], k
    for k in ("sig", "sigbar"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=RTOL * float(want["sig"][0]))
    res = jjd.jd_full(jnp.asarray(A), jnp.asarray(B), rank=rank, iters=40,
                      key=jax.random.PRNGKey(seed))
    tres = convert.compressed_result(res)
    assert abs(tth.retained_energy(tres) - jth.retained_energy(res)) \
        <= RTOL * want["total"]
    jc = jth.check_theorem1(jnp.asarray(A), jnp.asarray(B), res, atol=2e-2)
    tc = tth.check_theorem1(torch.from_numpy(A), torch.from_numpy(B), tres,
                            atol=2e-2)
    for k in ("lower_ok", "lower_literal_ok", "upper_ok"):
        assert tc[k] == jc[k], k
    assert tc["upper_ok"] and tc["lower_ok"]
    for k in ("kept", "error_lb"):
        assert abs(tc[k] - jc[k]) <= RTOL * max(want["total"], 1.0), k


def test_literal_lower_bound_fails_on_duplicates():
    """The paper's lower bound as stated misapplies Jensen: identical
    adapters break it, the corrected (1/n) bound holds (the JAX theory
    test's counterexample, in the port)."""
    A, B = _bank(1, n=1)
    A, B = np.tile(A, (6, 1, 1)), np.tile(B, (6, 1, 1))
    res = jjd.jd_full(jnp.asarray(A), jnp.asarray(B), rank=2, iters=25)
    chk = tth.check_theorem1(torch.from_numpy(A), torch.from_numpy(B),
                             convert.compressed_result(res))
    assert chk["upper_ok"] and chk["lower_ok"]
    assert not chk["lower_literal_ok"]


@pytest.mark.parametrize("seed", [0, 1])
def test_tilde_r_matches_jax(seed):
    A, B = _bank(seed, n=3, r=2, d=20)
    assert tth.tilde_r(torch.from_numpy(A), torch.from_numpy(B)) == \
        jth.tilde_r(jnp.asarray(A), jnp.asarray(B)) == 6
    # a repeated adapter adds no rank
    A2, B2 = np.concatenate([A, A[:1]]), np.concatenate([B, B[:1]])
    assert tth.tilde_r(torch.from_numpy(A2), torch.from_numpy(B2)) == \
        jth.tilde_r(jnp.asarray(A2), jnp.asarray(B2)) == 6


def test_corollary1_regime_matches_jax():
    d, n = 24, 6
    A = np.zeros((n, 1, d), np.float32)
    B = np.zeros((n, d, 1), np.float32)
    for i in range(n):
        A[i, 0, i] = 1.0
        B[i, i + n, 0] = 1.0
    want = jth.corollary1_regime(jnp.asarray(A), jnp.asarray(B))
    got = tth.corollary1_regime(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(got["norms"].numpy(), np.asarray(want["norms"]))
    assert got["max_off_diag"] == want["max_off_diag"] == 0.0
    A2, B2 = _bank(4, n=4)
    want = jth.corollary1_regime(jnp.asarray(A2), jnp.asarray(B2))
    got = tth.corollary1_regime(torch.from_numpy(A2), torch.from_numpy(B2))
    np.testing.assert_allclose(got["norms"].numpy(), np.asarray(want["norms"]),
                               rtol=RTOL)
    assert abs(got["max_off_diag"] - want["max_off_diag"]) \
        <= RTOL * want["max_off_diag"]
