"""The port's dense model against `repro.models.transformer`: prefill and
decode logits on JAX-initialised parameters carried across by
`repro_torch.convert`, with raw-LoRA and JD adapters, in f32 and in bf16."""
import dataclasses as dc
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import transformer as jtf
from repro.models.lora import LoRAContext as JCtx
from repro.models.param import init_params as jax_init
from repro_torch import configs as tcfg
from repro_torch.convert import array_to_tensor, tensor_to_array, to_torch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.lora import LoRAContext as TCtx
from repro_torch.models.param import init_params

# f32 weights: the two frameworks sum in other orders; the bf16 KV cache
# (the JAX default, kept) rounds both sides' K/V the same way
F32_ATOL = 1e-4
# bf16 weights: the JAX package's own fused-vs-unfused tolerance, one bf16
# ulp at logit magnitude (tests/test_fused_executor.py)
BF16_ATOL = 8e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps torch from
    competing for the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
              d_ff=128, vocab_size=64)
    return (dc.replace(smoke_config("mistral-7b"), **kw),
            dc.replace(tcfg.smoke_config("mistral-7b"), **kw))


def _bundles(cfg, mode, n, r, seed):
    rng = np.random.default_rng(seed)
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, d)}
    out = {}
    for t, (di, do) in dims.items():
        if mode == "batched":
            out[t] = {"A": 0.05 * rng.standard_normal((L, n, r, di)),
                      "B": 0.05 * rng.standard_normal((L, n, do, r))}
        else:
            out[t] = {"U": 0.05 * rng.standard_normal((L, 2, do, r)),
                      "V": 0.05 * rng.standard_normal((L, 2, di, r)),
                      "sigma": rng.standard_normal((L, n, r, r)),
                      "cluster_of": np.tile(np.arange(n) % 2, (L, 1))}
        out[t] = {k: (a.astype(np.int32) if k == "cluster_of"
                      else a.astype(np.float32)) for k, a in out[t].items()}
    return {"layers": out}


CASES = [(mode, plen) for mode in (None, "batched", "jd")
         for plen in (12, 64)]
B, S_MAX, IDS = 2, 96, np.array([1, 2], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    """The JAX package's initialisation of the fixture (jitted: one compile
    instead of one per leaf), f32 or the configs' bf16."""
    jcfg, _ = _cfgs()
    override = jnp.float32 if dtype == "f32" else None
    return jax.jit(lambda key: jax_init(jtf.model_defs(jcfg), key,
                                        dtype_override=override))(
        jax.random.PRNGKey(0))


def _jax_reference(dtype, mode, prompt_len):
    """JAX prefill logits, two decode steps' logits and fed tokens, and the
    final K cache, as numpy."""
    jcfg, _ = _cfgs()
    params = _jax_params(dtype)
    ctx = JCtx(mode=mode, params=None, ids=jnp.asarray(IDS)) if mode \
        else None
    bundles = (jax.tree.map(jnp.asarray, _bundles(jcfg, mode, 3, 4, 5))
               if mode else None)
    tokens = np.random.default_rng(1).integers(0, 64, (B, prompt_len))
    prefill = jax.jit(lambda p, t, c, lp, cx: jtf.prefill(
        p, {"tokens": t}, jcfg, c, lora_params=lp, lora_ctx_proto=cx))
    decode = jax.jit(lambda p, t, c, lp, cx: jtf.decode_step(
        p, t, jcfg, c, lora_params=lp, lora_ctx_proto=cx))
    lg, cache = prefill(params, jnp.asarray(tokens, jnp.int32),
                        jtf.init_cache(jcfg, B, S_MAX), bundles, ctx)
    out = {"tokens": tokens, "logits0": np.asarray(lg, np.float32)}
    for step in (1, 2):
        nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
        lg, cache = decode(params, jnp.asarray(nxt, jnp.int32), cache,
                           bundles, ctx)
        out[f"fed{step}"] = nxt
        out[f"logits{step}"] = np.asarray(lg, np.float32)
    out["k"] = np.asarray(cache["k"], np.float32)
    return out


def _key(mode, plen):
    return f"{mode}_{plen}"


@pytest.fixture(scope="module")
def bf16_refs(tmp_path_factory):
    """The bf16 references, computed in a child process with XLA's excess
    precision off: by default XLA keeps fused bf16 intermediates (the
    residual adds) at f32, where eager torch rounds every op to bf16, and
    that alone moves the logits by up to ~3e-2 on this fixture.  With every
    op rounded on both sides the logits agree within BF16_ATOL."""
    path = tmp_path_factory.mktemp("bf16") / "refs.npz"
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                                      " --xla_allow_excess_precision=false"))
    subprocess.run([sys.executable, __file__, str(path)], env=env,
                   check=True, timeout=300)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode,prompt_len", CASES)
def test_prefill_and_decode_logits_match_jax(dtype, mode, prompt_len,
                                             request):
    if dtype == "f32":
        ref = _jax_reference("f32", mode, prompt_len)
    else:
        refs = request.getfixturevalue("bf16_refs")
        ref = {k.split("/", 1)[1]: v for k, v in refs.items()
               if k.startswith(_key(mode, prompt_len) + "/")}
    jcfg, cfg = _cfgs()
    params = to_torch(jax.tree.map(np.asarray, _jax_params(dtype)))
    ctx = TCtx(mode=mode, params=None, ids=torch.from_numpy(IDS).long()) \
        if mode else None
    bundles = to_torch(_bundles(jcfg, mode, 3, 4, 5)) if mode else None
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL

    logits, cache = ttf.prefill(
        params, {"tokens": torch.from_numpy(ref["tokens"])}, cfg,
        ttf.init_cache(cfg, B, S_MAX, device="cpu"),
        lora_params=bundles, lora_ctx_proto=ctx)
    assert logits.shape == (B, 1, cfg.padded_vocab)   # padded, unmasked
    assert cache["index"] == prompt_len
    np.testing.assert_allclose(tensor_to_array(logits), ref["logits0"],
                               rtol=0, atol=atol)
    for step in (1, 2):
        logits, cache = ttf.decode_step(
            params, torch.from_numpy(ref[f"fed{step}"].copy()), cfg, cache,
            lora_params=bundles, lora_ctx_proto=ctx)
        np.testing.assert_allclose(tensor_to_array(logits),
                                   ref[f"logits{step}"], rtol=0, atol=atol)
    # the bf16 cache holds K up to ~20 in magnitude: within one bf16 ulp
    # at that scale (0.125)
    np.testing.assert_allclose(tensor_to_array(cache["k"]), ref["k"],
                               rtol=0, atol=0.125)


def test_convert_is_bit_exact_for_bf16():
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    jb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    t = array_to_tensor(jb)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(tensor_to_array(t), jb.astype(np.float32))
    assert to_torch({"a": {"b": jb}})["a"]["b"].dtype == torch.bfloat16


def test_layer_pieces_match_jax():
    from repro.models import layers as jlayers
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 40, 1, 16)).astype(np.float32)
    pos = np.arange(5, 45, dtype=np.int32)
    jc, js = jlayers.rope_tables(jnp.asarray(pos), 16, 1e6)
    tc, ts = tlayers.rope_tables(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5)
    for causal in (True, False):
        want = jlayers.chunked_attention(
            jnp.asarray(x), jnp.asarray(kv), jnp.asarray(kv), causal=causal,
            chunk_q=8, chunk_kv=10, kv_len=33)
        for fn in (tlayers.chunked_attention, ):
            got = fn(torch.from_numpy(x), torch.from_numpy(kv),
                     torch.from_numpy(kv), causal=causal, chunk_q=8,
                     chunk_kv=10, kv_len=33)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
        got = tlayers.naive_attention(
            torch.from_numpy(x), torch.from_numpy(kv), torch.from_numpy(kv),
            causal=causal, kv_len=33)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_init_params_follows_the_std_rule():
    _, cfg = _cfgs()
    defs = ttf.model_defs(cfg)
    g = torch.Generator().manual_seed(0)
    p = init_params(defs, g, "cpu")
    assert p["layers"]["attn"]["wq"].shape == (2, 64, 2, 32)
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    # matrices: std 1/sqrt(shape[0]) (the layer count for stacked leaves)
    std = p["layers"]["mlp"]["w_up"].float().std().item()
    assert abs(std - 2 ** -0.5) < 0.02, std
    assert abs(p["embed"]["embed"].float().std().item() - 0.02) < 0.002
    assert torch.all(p["layers"]["ln1"] == 1)
    with pytest.raises(NotImplementedError):
        ttf.model_defs(tcfg.smoke_config("mamba2-2.7b"))


@pytest.mark.parametrize("mode", ["single", "batched", "jd"])
def test_lora_apply_matches_jax(mode):
    from repro.models import lora as jlora
    from repro_torch.models import lora as tlora
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    y = rng.standard_normal((3, 5, 24)).astype(np.float32)
    ids = np.array([2, 0, 1], np.int32)
    if mode == "single":
        p = {"a": rng.standard_normal((4, 16)), "b": rng.standard_normal((24, 4))}
    elif mode == "batched":
        p = {"A": rng.standard_normal((3, 4, 16)),
             "B": rng.standard_normal((3, 24, 4))}
    else:
        p = {"U": rng.standard_normal((2, 24, 4)),
             "V": rng.standard_normal((2, 16, 4)),
             "sigma": rng.standard_normal((3, 4)),
             "cluster_of": np.array([1, 0, 1])}
    p = {k: v.astype(np.int32 if k == "cluster_of" else np.float32)
         for k, v in p.items()}
    want = jlora.apply(jlora.LoRAContext(mode, {"o": jax.tree.map(
        jnp.asarray, p)}, jnp.asarray(ids), 0.5), "o", jnp.asarray(x),
        jnp.asarray(y))
    got = tlora.apply(tlora.LoRAContext(mode, {"o": to_torch(p)},
                                        torch.from_numpy(ids).long(), 0.5),
                      "o", torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(tlora.apply(None, "o", torch.from_numpy(x),
                                   torch.from_numpy(y)), torch.from_numpy(y))


if __name__ == "__main__":
    # child process of the bf16_refs fixture: write the bf16 references
    np.savez(sys.argv[1], **{
        f"{_key(mode, plen)}/{k}": v
        for mode, plen in CASES
        for k, v in _jax_reference("bf16", mode, plen).items()})
