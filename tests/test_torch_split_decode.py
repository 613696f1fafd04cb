"""The split-sequence decode attention's arithmetic and the port's
``decode_attn`` config field, against the JAX package, on the CPU.

``ref.flash_decode_split_ref`` models ``csrc/decode_attention.cu``: per
chunk of ``split_s`` positions an unnormalised ``(acc, l, m)``, then the
merge in ascending chunk order (m = max m_i, w_i = exp(m_i - m),
l = sum w_i l_i, out = sum w_i acc_i / max(l, 1e-30)).  It is held against
JAX's ``repro.distributed.collectives._partial_decode`` applied per chunk
and merged with those formulas, and against ``ref.flash_decode_ref``.
Inputs come from a numpy seed; nothing in ``repro`` is edited.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.distributed.collectives import (_partial_decode,
                                           seq_sharded_decode_attention)
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as jtf
from repro.models.param import init_params as jax_init
from repro_torch import configs as tcfg
from repro_torch.convert import tensor_to_array, to_torch
from repro_torch.kernels import ref
from repro_torch.models import transformer as ttf

# f32 sums taken in other orders (the module docstring of kernels/checks.py)
F32_TOL = 1e-5
# tests/test_torch_model.py's f32 logits tolerance
F32_ATOL = 1e-4
B, H, KV, HD = 5, 4, 2, 32


def _inputs(split_s: int, seed: int):
    """q (B, H, hd), k/v (B, 3 * split_s, Kv, hd) with K of std 3 (sharp
    softmaxes), and lengths 1, split_s - 1, split_s, split_s + 1 and
    split_s + 5: every chunk edge, and empty last chunks."""
    rng = np.random.default_rng(seed)
    S = 3 * split_s
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    k = (3 * rng.standard_normal((B, S, KV, HD))).astype(np.float32)
    v = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    kv_len = np.array([1, split_s - 1, split_s, split_s + 1, split_s + 5],
                      np.int32)
    return q, k, v, kv_len


def _jax_chunk_merge(q, k, v, kv_len, split_s):
    """JAX's per-shard partial attention on each chunk, merged in
    ascending chunk order; returns (out (B, H, hd), l, m (B, Kv, G))."""
    parts = [_partial_decode(jnp.asarray(q[:, None]),
                             jnp.asarray(k[:, c0:c0 + split_s]),
                             jnp.asarray(v[:, c0:c0 + split_s]), c0,
                             jnp.asarray(kv_len))
             for c0 in range(0, k.shape[1], split_s)]
    o, l, m = (np.stack([np.asarray(p[i]) for p in parts]) for i in range(3))
    m_g = m.max(axis=0)
    w = np.exp(m - m_g)
    l_g = (w * l).sum(axis=0)
    out = (w[..., None] * o).sum(axis=0) / np.maximum(l_g, 1e-30)[..., None]
    return out.reshape(B, H, HD), l_g, m_g


def _close(got, want):
    np.testing.assert_array_less(np.abs(got - want),
                                 F32_TOL * (1 + np.abs(want)))


@pytest.mark.parametrize("split_s", [64, 256])
def test_split_merge_matches_jax_partials_and_plain(split_s):
    q, k, v, kv_len = _inputs(split_s, split_s)
    out, l, m = ref.flash_decode_split_ref(*map(torch.from_numpy,
                                               (q, k, v, kv_len)), split_s)
    out, l, m = out.numpy(), l[..., 0].numpy(), m[..., 0].numpy()
    j_out, j_l, j_m = _jax_chunk_merge(q, k, v, kv_len, split_s)
    _close(out, j_out)
    _close(l, j_l)
    _close(m, j_m)
    p_out, p_l, p_m = ref.flash_decode_ref(*map(torch.from_numpy,
                                                (q, k, v, kv_len)))
    _close(out, p_out.numpy())
    _close(l, p_l[..., 0].numpy())
    _close(m, p_m[..., 0].numpy())


def test_empty_chunks_merge_as_exact_zeros():
    """More chunks past kv_len leave out, l, m bit for bit unchanged: the
    kernel's paged and contiguous launches need not cover one S."""
    q, k, v, kv_len = map(torch.from_numpy, _inputs(64, 1))
    short = ref.flash_decode_split_ref(q, k[:, :128], v[:, :128],
                                       kv_len.clamp(max=128), 64)
    pad = torch.zeros((B, 320 - 128, KV, HD))
    longer = ref.flash_decode_split_ref(
        q, torch.cat([k[:, :128], pad], 1), torch.cat([v[:, :128], pad], 1),
        kv_len.clamp(max=128), 64)
    for a, b in zip(short, longer):
        assert torch.equal(a, b)


def test_jax_seq_sharded_merge_weights_the_partial_output_by_l():
    """A reference fact the port does not copy (ROADMAP queue 3):
    ``seq_sharded_decode_attention`` weights each shard's unnormalised
    output by exp(m_i - m) * l_i, so on one shard it returns the
    unnormalised sum p @ V rather than the attention output."""
    q, k, v, kv_len = _inputs(64, 2)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    got = np.asarray(seq_sharded_decode_attention(
        jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_len), mesh))[:, 0]
    o, _, _ = _partial_decode(jnp.asarray(q[:, None]), jnp.asarray(k),
                              jnp.asarray(v), 0, jnp.asarray(kv_len))
    _close(got, np.asarray(o).reshape(B, H, HD))
    plain = ref.flash_decode_ref(*map(torch.from_numpy,
                                      (q, k, v, kv_len)))[0].numpy()
    assert np.abs(got - plain).max() > 0.1


# -- cfg.decode_attn -----------------------------------------------------------


def _cfgs(decode_attn: str):
    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
              d_ff=128, vocab_size=64, decode_attn=decode_attn)
    return (dc.replace(smoke_config("mistral-7b"), **kw),
            dc.replace(tcfg.smoke_config("mistral-7b"), **kw))


def _prefill(cfg, params, tokens):
    return ttf.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                       ttf.init_cache(cfg, 2, 48, device="cpu"))


@pytest.fixture(scope="module")
def f32_params():
    jcfg, _ = _cfgs("gather")
    jp = jax.jit(lambda key: jax_init(jtf.model_defs(jcfg), key,
                                      dtype_override=jnp.float32))(
        jax.random.PRNGKey(0))
    return jp, to_torch(jax.tree.map(np.asarray, jp))


def test_seq_shard_decodes_as_the_jax_package_on_one_device(f32_params):
    """Without a mesh the JAX package's "seq_shard" runs its gather path,
    as the port does: prefill and two decode steps' logits agree."""
    jcfg, cfg = _cfgs("seq_shard")
    jp, tp = f32_params
    tokens = np.random.default_rng(3).integers(0, 64, (2, 12)).astype(
        np.int32)
    jl, jc = jtf.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                         jtf.init_cache(jcfg, 2, 48))
    tl, tc = _prefill(cfg, tp, tokens)
    for _ in range(2):
        np.testing.assert_allclose(tensor_to_array(tl), np.asarray(jl),
                                   rtol=0, atol=F32_ATOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc = jtf.decode_step(jp, jnp.asarray(nxt), jcfg, jc)
        tl, tc = ttf.decode_step(tp, torch.from_numpy(nxt), cfg, tc)
    np.testing.assert_allclose(tensor_to_array(tl), np.asarray(jl), rtol=0,
                               atol=F32_ATOL)


def test_lazy_decode_raises_and_unknown_values_are_refused(f32_params):
    """"lazy" decodes the dense family as its gather branch does (logits
    within the f32 tolerance; tests/test_torch_lazy.py holds it to JAX),
    raises on a family whose JAX stack loses the cache's history under it,
    and an unknown value is refused."""
    _, tp = f32_params
    tokens = np.random.default_rng(5).integers(0, 64, (2, 4)).astype(
        np.int32)
    _, cfg = _cfgs("lazy")
    _, gcfg = _cfgs("gather")
    _, cache = _prefill(cfg, tp, tokens)     # prefill has no lazy branch
    nxt = torch.zeros((2, 1), dtype=torch.int32)
    g_logits, _ = ttf.decode_step(tp, nxt, gcfg, cache)
    l_logits, l_cache = ttf.decode_step(tp, nxt, cfg,
                                        {**cache, "k": cache["k"].clone(),
                                         "v": cache["v"].clone()})
    np.testing.assert_allclose(l_logits.numpy(), g_logits.numpy(), rtol=0,
                               atol=F32_TOL)
    assert l_cache["index"] == 5
    moe = dc.replace(tcfg.smoke_config("granite-moe-3b-a800m"),
                     decode_attn="lazy")
    with pytest.raises(ValueError, match="lazy"):
        ttf.forward({}, moe, tokens=nxt, mode="decode",
                    cache=ttf.init_cache(moe, 2, 8, device="cpu"))
    _, bad = _cfgs("ring")
    with pytest.raises(ValueError, match="decode_attn"):
        _prefill(bad, tp, tokens)
