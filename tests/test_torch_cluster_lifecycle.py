"""The port's online lifecycle math (``repro_torch.core.cluster``:
``assign_adapter``, ``add_adapter``, ``drop_adapter``, ``refresh_gate``)
against ``repro.core.cluster``'s, on the CPU.

A bank drawn with numpy from a seed (d 64, 40 adapters of LoRA rank 4
around three family centres) is compressed once by the JAX ``cluster_jd``
(JD rank 4, 3 clusters); both packages start from that result, the port's
converted across with ``convert.compressed_result``.  Tolerances: cluster
indices equal (the test asserts no near-tie between the best two
clusters), Sigma within 1e-5 of its largest magnitude, relative errors and
the gate's floats within 1e-5, the gate's verdict equal.

The last case runs the grounded churn phase of ``chip_smoke.py``
(``launch/grounded_churn.run``) at this width on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcl
from repro_torch import convert
from repro_torch.core import cluster as tcl
from repro_torch.launch import grounded_churn

D, N, R_LORA, RANK, K = 64, 40, 4, 4, 3
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw(rng, n, centres=None, noise=0.2):
    """n adapters around the given (A, B) centres in turn, or off every
    family (centres None)."""
    if centres is None:
        return (rng.standard_normal((n, R_LORA, D)).astype(np.float32),
                rng.standard_normal((n, D, R_LORA)).astype(np.float32))
    cA, cB = centres
    fam = np.arange(n) % len(cA)
    A = cA[fam] + noise * rng.standard_normal((n, R_LORA, D))
    B = cB[fam] + noise * rng.standard_normal((n, D, R_LORA))
    return A.astype(np.float32), B.astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    centres = (rng.standard_normal((K, R_LORA, D)),
               rng.standard_normal((K, D, R_LORA)))
    A, B = draw(rng, N, centres)
    new_A, new_B = draw(rng, 4, centres)
    off_A, off_B = draw(rng, 1)
    new_A = np.concatenate([new_A, off_A])
    new_B = np.concatenate([new_B, off_B])
    jc = jcl.cluster_jd(jnp.asarray(A), jnp.asarray(B), rank=RANK,
                        n_clusters=K, jd_iters=20, outer_iters=5)
    return dict(A=A, B=B, new_A=new_A, new_B=new_B, jc=jc,
                tc=convert.compressed_result(jc))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def assert_sigma_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("i", range(5))
def test_assign_adapter_matches_jax(setup, i):
    A_i, B_i = setup["new_A"][i], setup["new_B"][i]
    jj, jsig, jrel = jcl.assign_adapter(jnp.asarray(A_i), jnp.asarray(B_i),
                                        setup["jc"])
    tj, tsig, trel = tcl.assign_adapter(_t(A_i), _t(B_i), setup["tc"])
    scores = np.sort(np.asarray(jcl._assignment_scores(
        jnp.asarray(A_i[None]), jnp.asarray(B_i[None]), setup["jc"].U,
        setup["jc"].V))[0])
    assert scores[-1] - scores[-2] > 1e-3 * scores[-1]   # no near-tie
    assert tj == jj
    assert_sigma_close(tsig, jsig)
    assert abs(trel - jrel) <= TOL
    assert (trel > 0.9) == (i == 4)             # the last is off-family


def test_add_and_drop_adapter_match_jax(setup):
    jc, tc = setup["jc"], setup["tc"]
    for A_i, B_i in zip(setup["new_A"], setup["new_B"]):
        jc, jj, jrel = jcl.add_adapter(jc, jnp.asarray(A_i), jnp.asarray(B_i))
        tc, tj, trel = tcl.add_adapter(tc, _t(A_i), _t(B_i))
        assert tj == jj and abs(trel - jrel) <= TOL
    assert tc.assign.dtype == torch.int32
    assert tc.assign.tolist() == np.asarray(jc.assign).tolist()
    assert_sigma_close(tc.sigma, jc.sigma)
    assert torch.equal(tc.U, setup["tc"].U)             # bases untouched
    for i in (N + 2, 0, N - 1):
        jc, tc = jcl.drop_adapter(jc, i), tcl.drop_adapter(tc, i)
        assert tc.assign.tolist() == np.asarray(jc.assign).tolist()
        assert_sigma_close(tc.sigma, jc.sigma)
    assert tc.sigma.shape[0] == N + 5 - 3


def _gate_both(setup, cand_jax, n_new):
    A1 = np.concatenate([setup["A"], setup["new_A"][:n_new]])
    B1 = np.concatenate([setup["B"], setup["new_B"][:n_new]])
    kw = dict(max_regression=0.05, abs_slack=1e-3, max_new_rel_err=0.3)
    gj = jcl.refresh_gate(jnp.asarray(A1), jnp.asarray(B1), setup["jc"],
                          cand_jax, **kw)
    gt = tcl.refresh_gate(_t(A1), _t(B1), setup["tc"],
                          convert.compressed_result(cand_jax), **kw)
    assert gt["ok"] is gj["ok"]
    for k in ("serving_err", "candidate_err", "new_worst_rel_err"):
        assert isinstance(gt[k], float)
        assert abs(gt[k] - gj[k]) <= TOL, (k, gt[k], gj[k])
    return gt


def test_refresh_gate_passes_an_in_family_candidate(setup):
    """A re-solve over the bank plus two in-family adapters ships."""
    A1 = np.concatenate([setup["A"], setup["new_A"][:2]])
    B1 = np.concatenate([setup["B"], setup["new_B"][:2]])
    cand = jcl.cluster_jd(jnp.asarray(A1), jnp.asarray(B1), rank=RANK,
                          n_clusters=K, jd_iters=20, outer_iters=5)
    g = _gate_both(setup, cand, 2)
    assert g["ok"] and g["new_worst_rel_err"] < 0.3


def test_refresh_gate_rejects_random_bases(setup):
    """Random orthonormal bases with a zero Sigma
    (``tests/test_lifecycle.py``'s garbage candidate) must not ship."""
    rng = np.random.default_rng(3)
    qU = np.linalg.qr(rng.standard_normal((K, D, RANK)))[0]
    qV = np.linalg.qr(rng.standard_normal((K, D, RANK)))[0]
    jc = setup["jc"]
    bad = type(jc)(U=jnp.asarray(qU, jnp.float32),
                   V=jnp.asarray(qV, jnp.float32),
                   sigma=jnp.zeros((N + 2, RANK, RANK), jnp.float32),
                   assign=jnp.concatenate([jc.assign, jc.assign[:2]]),
                   diag=False)
    g = _gate_both(setup, bad, 2)
    assert not g["ok"] and g["candidate_err"] == pytest.approx(1.0)


def test_grounded_churn_phase_on_the_cpu():
    """The chip's lifecycle phase at this width: the churn cell served by
    the cost-model fleet, the hooks on CPU tensors (plain versions)."""
    rep = grounded_churn.run(width=D, rank=R_LORA, jd_rank=RANK,
                             clusters=K, n_base=N, device="cpu")
    grounded_churn.check(rep)
    assert rep["device"] == "cpu"
    assert rep["lifecycle"]["n_rollbacks"] >= 1
    assert rep["lifecycle"]["n_refreshes"] >= 1
