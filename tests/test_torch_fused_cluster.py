"""The fused decode kernels' kv-head limit, on the CPU.

On the card a fused call sums a sequence's kv-heads in one thread-block
cluster, which holds at most ``fused_decode.MAX_KV_HEADS`` (16) blocks.
All four entry points refuse more on every device, so the CPU (the plain
versions) and the card share one contract; at the limit the CPU answers
as the JAX package's plain reference does, on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.convert import array_to_tensor
from repro_torch.kernels import fused_decode as fu

ENTRY_POINTS = ["lora", "jd", "lora_paged", "jd_paged"]
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(kv, seed):
    """f32 numpy inputs of every entry point at Kv = ``kv`` (G 2, hd 8,
    16 positions in two pages of 8), and the paged pool and table."""
    rng = np.random.default_rng(seed)
    B, H, hd, S, n, r, d_out, page_t = 2, 2 * kv, 8, 16, 3, 4, 24, 8
    f = np.float32
    x = dict(q=rng.standard_normal((B, H, hd)).astype(f),
             k=rng.standard_normal((B, S, kv, hd)).astype(f),
             v=rng.standard_normal((B, S, kv, hd)).astype(f),
             kv_len=np.array([S, 5], np.int32),
             ids=np.array([2, 0], np.int32),
             A=(rng.standard_normal((n, r, H * hd)) / 8).astype(f),
             B=(rng.standard_normal((n, d_out, r)) / 4).astype(f),
             U=(rng.standard_normal((2, d_out, r)) / 4).astype(f),
             V=(rng.standard_normal((2, H * hd, r)) / 8).astype(f),
             sigma=(rng.standard_normal((n, r, r)) / 4).astype(f),
             cluster_of=np.array([0, 1, 0], np.int32))
    table = rng.permutation(2 * B)[:B * 2].astype(np.int32).reshape(B, 2)
    for name in ("k", "v"):
        pool = np.zeros((2 * B, page_t, kv, hd), f)
        pool[table.reshape(-1)] = x[name].reshape(B * 2, page_t, kv, hd)
        x[name + "_pages"] = pool
    x["page_table"] = table
    return x


def _call(entry, t):
    kv = (t["k_pages"], t["v_pages"], t["page_table"]) \
        if entry.endswith("paged") else (t["k"], t["v"])
    adapter = (t["A"], t["B"]) if entry.startswith("lora") else \
        (t["U"], t["V"], t["sigma"], t["cluster_of"])
    fn = getattr(fu, f"fused_decode_{entry}")
    return fn(t["q"], *kv, t["kv_len"], t["ids"], *adapter)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_more_kv_heads_than_a_cluster_are_refused(entry):
    x = _inputs(17, seed=0)
    t = {k: array_to_tensor(a) for k, a in x.items()}
    with pytest.raises(ValueError, match="at most 16"):
        _call(entry, t)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_the_cluster_limit_is_answered(entry):
    """Kv 16: the plain version answers, equal to JAX's reference (the
    paged modes on the pool's logical content)."""
    x = _inputs(fu.MAX_KV_HEADS, seed=1)
    t = {k: array_to_tensor(a) for k, a in x.items()}
    out, delta = _call(entry, t)
    j = {k: jnp.asarray(x[k]) for k in x}
    if entry.startswith("lora"):
        o_ref, d_ref = R.fused_decode_lora_ref(
            j["q"], j["k"], j["v"], j["kv_len"], j["ids"], j["A"], j["B"])
    else:
        o_ref, d_ref = R.fused_decode_jd_ref(
            j["q"], j["k"], j["v"], j["kv_len"], j["ids"], j["U"], j["V"],
            j["sigma"], j["cluster_of"])
    assert delta.shape == (2, 24) and delta.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(o_ref), **F32_TOL)
    np.testing.assert_allclose(delta.numpy(), np.asarray(d_ref), **F32_TOL)
