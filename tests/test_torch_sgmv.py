"""The port's grouped multi-adapter kernels (SGMV, JD apply, dequantize)
on the CPU, where each wrapper runs its plain version, against the JAX
package: ``kernels/ref.py`` and the Pallas kernels in interpret mode, on
the same inputs made with numpy from a seed.

Tolerances: f32 outputs sum the same products in another order,
1e-5 * (1 + |ref|); bf16 outputs add one bf16 rounding, 2**-7 * |ref| +
1e-3.  Dequantization is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as R
from repro.kernels import sgmv as jax_sgmv
from repro.kernels.adapter_quant import adapter_dequantize as jax_dequantize
from repro.kernels.jd_apply import jd_apply as jax_jd_apply
from repro_torch.convert import array_to_tensor
from repro_torch.kernels import ops, ref, sgmv
from repro_torch.kernels.adapter_quant import (adapter_dequantize,
                                               adapter_quantize)
from repro_torch.kernels.jd_apply import jd_apply, jd_shrink_scale


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def assert_close(got, want):
    """f32: 1e-5 * (1 + |ref|); bf16: 2**-7 * |ref| + 1e-3."""
    g, w = _np32(got), _np32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    bf16 = any(getattr(a, "dtype", None) in (torch.bfloat16, jnp.bfloat16)
               for a in (got, want))
    tol = 2.0 ** -7 * np.abs(w) + 1e-3 if bf16 else 1e-5 * (1 + np.abs(w))
    err = np.abs(g - w)
    assert (err <= tol).all(), f"max error {err.max():.3e}"


def _cast(a, dtype):
    """numpy f32 -> numpy in ``dtype`` ("f32" or "bf16"), rounded once."""
    a = np.asarray(a, np.float32)
    return a if dtype == "f32" else np.asarray(jnp.asarray(a, jnp.bfloat16))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [array_to_tensor(a) for a in arrays])


def grouped_inputs(seed, T, d_in, n, tile, dtype):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, size=T).astype(np.int32)
    x = _cast(rng.standard_normal((T, d_in)), dtype)
    perm, tile_ids, valid = R.group_tokens_by_adapter(ids, n, tile)
    perm = np.asarray(perm)
    return x[perm], ids[perm], np.asarray(tile_ids), rng


@pytest.mark.parametrize("T,n,tile", [(40, 4, 8), (33, 7, 16), (5, 3, 128),
                                      (64, 1, 8), (0, 3, 8)])
def test_group_tokens_matches_jax(T, n, tile):
    rng = np.random.default_rng(T + n)
    ids = rng.integers(0, n, size=T).astype(np.int32)
    want = R.group_tokens_by_adapter(ids, n, tile)
    got = ref.group_tokens_by_adapter(torch.from_numpy(ids), n, tile)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_tokens_refuses_an_id_past_the_bank():
    with pytest.raises(ValueError):
        ref.group_tokens_by_adapter(torch.tensor([0, 3], dtype=torch.int32),
                                    3, 8)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("T,d_in,d_out,n,r,tile", [
    (32, 128, 64, 3, 8, 8),
    (64, 256, 192, 5, 16, 8),
    (128, 512, 256, 2, 32, 16),
    (16, 64, 128, 7, 4, 8),
])
def test_sgmv_matches_jax(T, d_in, d_out, n, r, tile, dtype):
    xg, idg, tile_ids, rng = grouped_inputs(0, T, d_in, n, tile, dtype)
    A = _cast(rng.standard_normal((n, r, d_in)) / 8, dtype)
    B = _cast(rng.standard_normal((n, d_out, r)) / 4, dtype)
    (jx, jA, jB, jtid, jid), (tx, tA, tB, ttid, tid) = _both(
        xg, A, B, tile_ids, idg)
    t = sgmv.sgmv_shrink(tx, tA, ttid, block_t=tile)
    assert t.dtype == torch.float32 and t.shape == (xg.shape[0], r)
    jt = jax_sgmv.sgmv_shrink(jx, jA, jtid, block_t=tile, block_d=64)
    assert_close(t, jt)
    # the per-token plain versions agree with the JAX oracles too
    assert_close(ref.sgmv_shrink_ref(tx, tA, tid), R.sgmv_shrink_ref(jx, jA,
                                                                     jid))
    # expand from the same (JAX) t: only the expand is compared
    t_in = np.asarray(jt.astype(jx.dtype))
    y = sgmv.sgmv_expand(array_to_tensor(t_in), tB, ttid, block_t=tile)
    jy = jax_sgmv.sgmv_expand(jnp.asarray(t_in), jB, jtid, block_t=tile,
                              block_d=64)
    assert y.dtype == tx.dtype
    assert_close(y, jy)
    assert_close(ref.sgmv_expand_ref(array_to_tensor(t_in), tB, tid),
                 R.sgmv_expand_ref(jnp.asarray(t_in), jB, jid))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("r", [4, 16])
def test_sigma_bmm_matches_jax(r, dtype):
    T, n, tile = 48, 4, 8
    xg, idg, tile_ids, rng = grouped_inputs(2, T, r, n, tile, dtype)
    sig = (rng.standard_normal((n, r, r)) / 4).astype(np.float32)
    (jx, js, jtid, jid), (tx, ts, ttid, tid) = _both(xg, sig, tile_ids, idg)
    out = sgmv.sigma_bmm(tx, ts, ttid, block_t=tile)
    assert out.dtype == tx.dtype
    assert_close(out, jax_sgmv.sigma_bmm(jx, js, jtid, block_t=tile))
    assert_close(ref.sigma_bmm_ref(tx, ts, tid), R.sigma_bmm_ref(jx, js, jid))


def _jd_inputs(diag, k_clusters, dtype="bf16", seed=4):
    T, d_in, d_out, n, r, tile = 64, 192, 128, 6, 8, 8
    xg, idg, tile_ids, rng = grouped_inputs(seed, T, d_in, n, tile, dtype)
    U = _cast(rng.standard_normal((k_clusters, d_out, r)) / 4, dtype)
    V = _cast(rng.standard_normal((k_clusters, d_in, r)) / 8, dtype)
    cluster_of = (np.arange(n) % k_clusters).astype(np.int32)
    sig = (np.abs(rng.standard_normal((n, r))) if diag
           else rng.standard_normal((n, r, r)) / 4).astype(np.float32)
    return xg, idg, tile_ids, U, V, cluster_of, sig, tile


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("k_clusters", [1, 3])
def test_jd_apply_matches_jax(diag, k_clusters):
    xg, idg, tile_ids, U, V, cluster_of, sig, tile = _jd_inputs(diag,
                                                                k_clusters)
    tile_cids = cluster_of[tile_ids]
    jarr, tarr = _both(xg, U, V, sig, cluster_of, idg, tile_cids, tile_ids)
    jx, jU, jV, js, jco, jid, jtc, jti = jarr
    tx, tU, tV, ts, tco, tid, ttc, tti = tarr
    out = jd_apply(tx, tU, tV, ts, tid, ttc, tti)
    assert out.dtype == torch.bfloat16
    assert_close(out, jax_jd_apply(jx, jU, jV, js, jco, jid, jtc, jti))
    assert_close(ref.jd_apply_ref(tx, tU, tV, ts, tco, tid),
                 R.jd_apply_ref(jx, jU, jV, js, jco, jid))


@pytest.mark.parametrize("scaled", [True, False])
def test_jd_shrink_scale_matches_jax(scaled):
    from repro.kernels.jd_apply import jd_shrink_scale as jax_shrink_scale
    xg, idg, tile_ids, U, V, cluster_of, sig, tile = _jd_inputs(True, 3,
                                                                "f32", 5)
    tile_cids = cluster_of[tile_ids]
    sig_tok = (sig[idg] if scaled else np.ones((len(idg), sig.shape[1]),
                                               np.float32))
    (jx, jV, jst, jtc), (tx, tV, tst, ttc) = _both(xg, V, sig_tok, tile_cids)
    out = jd_shrink_scale(tx, tV, tst if scaled else None, ttc, block_t=tile)
    assert out.dtype == torch.float32
    assert_close(out, jax_shrink_scale(jx, jV, jst, jtc, block_t=tile,
                                       block_d=64))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ops_lora_apply_matches_jax(dtype):
    T, d_in, d_out, n, r = 40, 96, 64, 4, 8
    rng = np.random.default_rng(8)
    x = _cast(rng.standard_normal((T, d_in)), dtype)
    A = _cast(rng.standard_normal((n, r, d_in)) / 8, dtype)
    B = _cast(rng.standard_normal((n, d_out, r)) / 4, dtype)
    ids = rng.integers(0, n, size=T).astype(np.int32)
    (jx, jA, jB, jid), (tx, tA, tB, tid) = _both(x, A, B, ids)
    want = jax_ops.lora_apply(jx, jA, jB, jid, tile=8, scaling=0.5,
                              use_pallas="interpret")
    got = ops.lora_apply_grouped(tx, tA, tB, tid, tile=8, scaling=0.5)
    assert got.dtype == tx.dtype and got.shape == (T, d_out)
    assert_close(got, want)
    # the CPU entry point takes the plain version, as JAX's "ref" does
    assert_close(ops.lora_apply(tx, tA, tB, tid, scaling=0.5),
                 jax_ops.lora_apply(jx, jA, jB, jid, scaling=0.5,
                                    use_pallas="ref"))


@pytest.mark.parametrize("diag", [True, False])
def test_ops_jd_apply_matches_jax(diag):
    T, d_in, d_out, n, r, k = 40, 96, 64, 5, 8, 2
    rng = np.random.default_rng(9)
    x = _cast(rng.standard_normal((T, d_in)), "bf16")
    U = _cast(rng.standard_normal((k, d_out, r)) / 4, "bf16")
    V = _cast(rng.standard_normal((k, d_in, r)) / 8, "bf16")
    sig = (np.abs(rng.standard_normal((n, r))) if diag
           else rng.standard_normal((n, r, r)) / 4).astype(np.float32)
    cluster_of = (np.arange(n) % k).astype(np.int32)
    ids = rng.integers(0, n, size=T).astype(np.int32)
    jarr, tarr = _both(x, U, V, sig, cluster_of, ids)
    want = jax_ops.jd_apply(*jarr, tile=8, use_pallas="interpret")
    got = ops.jd_apply_grouped(*tarr, tile=8)
    assert_close(got, want)
    assert_close(ops.jd_apply(*tarr),
                 jax_ops.jd_apply(*jarr, use_pallas="ref"))


def test_tile_cost_matches_jax():
    for tile in (1, 8, 16, 32):
        for r in range(1, 65):
            assert sgmv.sgmv_tile_cost(r, tile) == \
                jax_sgmv.sgmv_tile_cost(r, tile)
            assert sgmv.sgmv_rank_efficiency(r, tile) == \
                jax_sgmv.sgmv_rank_efficiency(r, tile)
    for bad in ((0, 8), (4, 0)):
        with pytest.raises(ValueError):
            sgmv.sgmv_tile_cost(*bad)


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,axis", [((3, 16, 40), -1), ((3, 40, 16), -2),
                                        ((2, 2, 8, 24), -1)])
def test_adapter_dequantize_equals_jax(shape, axis, out_dtype):
    rng = np.random.default_rng(len(shape) + axis)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    q, s = adapter_quantize(torch.from_numpy(w), axis=axis)
    tdt = torch.float32 if out_dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if out_dtype == "f32" else jnp.bfloat16
    got = adapter_dequantize(q, s, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == q.shape
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    for want in (jax_dequantize(jq, js, out_dtype=jdt),
                 R.adapter_dequant_ref(jq, js, out_dtype=jdt)):
        np.testing.assert_array_equal(_np32(got), _np32(want))
