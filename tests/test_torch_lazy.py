"""The port's ``lazy`` decode branch against the JAX package, on the CPU.

``decode_attn == "lazy"`` attends over the old cache and the new token as
a two-part softmax (``layers._two_part_decode_attention``) and splices
every layer's new K/V into the stacked cache once a step.  Held against
``repro.models`` on the dense and vlm smoke configs with f32 weights
drawn with numpy (each matrix at 1/sqrt(its fan-in)), against the port's
own gather branch, and on the families where the JAX package's lazy
branch loses the cache's history, which the port refuses.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from families_common import compile_o0, one_torch_thread
from repro.configs import smoke_config
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import configs as tcfg
from repro_torch.convert import tensor_to_array, to_torch
from repro_torch.launch.families import fan_in_defs
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

__all__ = ["one_torch_thread"]   # the autouse fixture, imported to apply

# f32 logits: the two frameworks sum in other orders
F32_ATOL = 1e-5
B, PROMPT, S_MAX, STEPS = 2, 9, 32, 4


def _cfgs(arch, decode_attn="lazy"):
    return (dc.replace(smoke_config(arch), decode_attn=decode_attn),
            dc.replace(tcfg.smoke_config(arch), decode_attn=decode_attn))


def _draw(cfg, seed=0):
    """The port's ParamDef tree at 1/sqrt(fan-in), drawn with numpy in
    f32 (norm scales ones, biases zeros)."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init in ("zeros", "ones"):
            return getattr(np, d.init)(d.shape, np.float32)
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale if d.scale is not None else fan_in ** -0.5
        if d.init == "small":
            std = (d.scale or 1.0) * 0.02
        return (std * rng.standard_normal(d.shape)).astype(np.float32)

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else one(t)

    return walk(fan_in_defs(ttf.model_defs(cfg)))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _port_prefill(cfg, tparams, batch):
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    return ttf.prefill(tparams, tb, cfg,
                       ttf.init_cache(cfg, B, S_MAX, device="cpu",
                                      dtype=torch.float32))


@pytest.fixture(scope="module", params=["mistral-7b", "pixtral-12b"])
def model(request):
    jcfg, cfg = _cfgs(request.param)
    nparams = _draw(cfg)
    return jcfg, cfg, nparams, to_torch(nparams)


def _tokens(rng):
    return rng.integers(0, 64, (B, 1)).astype(np.int32)


def test_lazy_decode_matches_jax(model):
    """Prefill, then STEPS lazy decode steps, the port starting each step
    from JAX's cache: logits within 1e-5; the port's stacked cache equals
    JAX's bit for bit outside the step's new rows, and those rows (K/V
    projections, which torch and XLA sum in other orders) within 1e-5 of
    their magnitude; the index advances alike."""
    jcfg, cfg, nparams, tparams = model
    batch = _batch(cfg)
    jparams = jax.tree.map(jnp.asarray, nparams)
    jc = jtf.init_cache(jcfg, B, S_MAX, dtype=jnp.float32)
    args = (jparams, batch, jc)
    _, jc = compile_o0(lambda p, b, c: jtf.prefill(p, b, jcfg, c),
                       *args)(*args)
    rng = np.random.default_rng(2)
    nxt = _tokens(rng)
    decode = compile_o0(lambda p, t, c: jtf.decode_step(p, t, jcfg, c),
                        jparams, nxt, jc)
    for _ in range(STEPS):
        tc = to_torch(jax.tree.map(np.asarray, jc))
        idx = int(jc["index"])
        jl, jc = decode(jparams, nxt, jc)
        tl, tc = ttf.decode_step(tparams, torch.from_numpy(nxt).long(), cfg,
                                 tc)
        np.testing.assert_allclose(tensor_to_array(tl), np.asarray(jl),
                                   rtol=0, atol=F32_ATOL)
        assert tc["index"] == int(jc["index"]) == idx + 1
        for key in ("k", "v"):
            got, want = tensor_to_array(tc[key]), np.asarray(jc[key])
            others = np.arange(S_MAX) != idx
            assert np.array_equal(got[:, :, others], want[:, :, others]), key
            row, wrow = got[:, :, idx], want[:, :, idx]
            assert np.abs(row - wrow).max() <= F32_ATOL * np.abs(wrow).max()
        nxt = _tokens(rng)


def test_lazy_equals_gather_and_splices_in_place(model):
    """The port's lazy step against its gather step from the same cache:
    logits within 1e-5; the lazy step writes the new rows into the
    caller's tensors, leaves every other row as it was, and its rows
    match the gather step's (layer 0's bit for bit: its input is the
    same)."""
    _, cfg, _, tparams = model
    gcfg = dc.replace(cfg, decode_attn="gather")
    batch = _batch(cfg)
    _, cache = _port_prefill(cfg, tparams, batch)
    rng = np.random.default_rng(3)
    for _ in range(STEPS):
        nxt = torch.from_numpy(_tokens(rng)).long()
        idx = cache["index"]
        before = {k: cache[k].clone() for k in ("k", "v")}
        gl, gc = ttf.decode_step(tparams, nxt, gcfg, cache)
        for k in ("k", "v"):      # gather leaves the caller's cache alone
            assert torch.equal(cache[k], before[k])
        ll, lc = ttf.decode_step(tparams, nxt, cfg, cache)
        np.testing.assert_allclose(ll.numpy(), gl.numpy(), rtol=0,
                                   atol=F32_ATOL)
        assert lc["index"] == gc["index"] == idx + 1
        for k in ("k", "v"):
            assert lc[k] is cache[k]
            others = torch.ones(S_MAX, dtype=torch.bool)
            others[idx] = False
            assert torch.equal(lc[k][:, :, others], before[k][:, :, others])
            assert torch.equal(lc[k][0, :, idx], gc[k][0, :, idx])
            torch.testing.assert_close(lc[k], gc[k], rtol=0, atol=F32_ATOL)
        cache = lc


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_two_part_plain_matches_jax_function(dtype):
    """``_two_part_decode_attention`` against the JAX function, with a
    scalar and a per-row old length (0 included: the new token alone)."""
    rng = np.random.default_rng(4)
    Bq, H, Kv, hd, S = 4, 8, 2, 32, 40
    q = rng.standard_normal((Bq, 1, H, hd)).astype(np.float32)
    ck = (2 * rng.standard_normal((Bq, S, Kv, hd))).astype(np.float32)
    cv = rng.standard_normal((Bq, S, Kv, hd)).astype(np.float32)
    kn = (2 * rng.standard_normal((Bq, 1, Kv, hd))).astype(np.float32)
    vn = rng.standard_normal((Bq, 1, Kv, hd)).astype(np.float32)
    jarr = [jnp.asarray(a, dtype) for a in (q, ck, cv, kn, vn)]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tarr = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
            for a in jarr]
    tol = F32_ATOL if dtype == jnp.float32 else 8e-3
    for idx in (17, np.array([0, 1, 39, 40], np.int32)):
        want = jlayers._two_part_decode_attention(*jarr, jnp.asarray(idx))
        got = tlayers._two_part_decode_attention(
            *tarr, torch.as_tensor(idx) if np.ndim(idx) else idx)
        np.testing.assert_allclose(tensor_to_array(got),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-2.7b",
                                  "whisper-small"])
def test_lazy_refused_where_jax_loses_the_cache(arch):
    """JAX's moe, hybrid and audio stacks take each layer's output as the
    whole cache; under lazy that is the new token alone, so a decode step
    shrinks the cache's sequence axis to 1 (the reference fault, shown
    here on JAX's own decode).  The port refuses lazy there."""
    jcfg, cfg = _cfgs(arch)
    enc = 6 if cfg.family == "audio" else 0
    batch = {"tokens": np.zeros((B, 4), np.int32)}
    if cfg.family == "audio":
        batch["frames"] = np.zeros((B, enc, cfg.d_model), np.float32)
    jp = jax.tree.map(jnp.asarray, _draw(cfg))
    jc = jtf.init_cache(jcfg, B, S_MAX, enc_len=enc, dtype=jnp.float32)
    _, jc = jtf.prefill(jp, batch, jcfg, jc)
    _, jc2 = jtf.decode_step(jp, jnp.zeros((B, 1), jnp.int32), jcfg, jc)
    assert jc["k"].shape[-3] == S_MAX and jc2["k"].shape[-3] == 1
    tc = ttf.init_cache(cfg, B, S_MAX, enc_len=enc, device="cpu")
    with pytest.raises(ValueError, match="loses its history"):
        ttf.decode_step(to_torch(_draw(cfg)),
                        torch.zeros((B, 1), dtype=torch.long), cfg, tc)
