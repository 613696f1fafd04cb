"""The port's model families (moe, ssm, hybrid, audio, vlm) against
`repro.models.transformer` on every family's smoke config, on f32
weights and adapters drawn with numpy and carried across by
`repro_torch.convert`: train, prefill and decode outputs, the aux loss and
the caches; decode against the full forward in the port; the full
configs' parameter trees; and the family launcher on the CPU.
`lm_loss` and its gradients are in test_torch_families_train.py, the
executor in test_torch_families_serve.py."""
import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from families_common import (ARCHS, B, JCTX, N_FRAMES, S_MAX, TCTX,
                             compile_o0, inputs, one_torch_thread, rel_err,
                             setup, th)
from repro.configs import get_config
from repro.models import transformer as jtf
from repro.models.param import count_defs
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.launch import families
from repro_torch.models import param as tparam
from repro_torch.models import transformer as ttf
from repro_torch.models.param import ParamDef, init_params, tree_leaves

__all__ = ["one_torch_thread"]   # the autouse fixture, imported to apply

# f32 throughout; the smoke configs' init (std 1/sqrt(shape[0]), the
# stacked leaf's layer count) makes the residual stream grow to ~1e4, so
# hidden states and caches are held relative to their largest magnitude;
# the two frameworks sum in other orders (measured: up to 9.1e-5 of it,
# whisper-small's hidden states after its encoder)
REL_TOL = 2e-4
# logits come after the final norm: absolute, four times the measured
# 2.4e-5
LOGIT_ATOL = 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_train_prefill_decode_match_jax(arch):
    jcfg, cfg, jparams, nparams, lora = setup(arch)
    tparams, tlora = to_torch(nparams), to_torch(lora)
    batch = inputs(jcfg)
    extra = [k for k in batch if k != "tokens"]

    args = (jparams, batch, lora)
    h, _, aux = compile_o0(lambda p, b, lp: jtf.forward(
        p, jcfg, tokens=b["tokens"], mode="train", lora_params=lp,
        lora_ctx_proto=JCTX, **{k: b[k] for k in extra}), *args)(*args)
    t_h, t_cache, t_aux = ttf.forward(
        tparams, cfg, mode="train", lora_params=tlora, lora_ctx_proto=TCTX,
        **th(batch))
    assert t_cache is None
    assert rel_err(t_h, h) < REL_TOL
    assert abs(float(t_aux) - float(aux)) < 1e-5
    assert (float(aux) > 0) == (cfg.family == "moe")

    enc = N_FRAMES if cfg.family == "audio" else 0
    jc = jtf.init_cache(jcfg, B, S_MAX, enc_len=enc, dtype=jnp.float32)
    tc = ttf.init_cache(cfg, B, S_MAX, enc_len=enc, device="cpu",
                        dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items() if k != "index"} == \
        {k: v.shape for k, v in jc.items() if k != "index"}
    args = (jparams, batch, jc, lora)
    lg, jc = compile_o0(lambda p, b, c, lp: jtf.prefill(
        p, b, jcfg, c, lora_params=lp, lora_ctx_proto=JCTX), *args)(*args)
    tl, tc = ttf.prefill(tparams, th(batch), cfg, tc, lora_params=tlora,
                         lora_ctx_proto=TCTX)
    np.testing.assert_allclose(tl.numpy(), np.asarray(lg), rtol=0,
                               atol=LOGIT_ATOL)
    nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(np.int32)
    decode = compile_o0(lambda p, t, c, lp: jtf.decode_step(
        p, t, jcfg, c, lora_params=lp, lora_ctx_proto=JCTX),
        jparams, nxt, jc, lora)
    for _ in range(3):
        lg, jc = decode(jparams, nxt, jc, lora)
        tl, tc = ttf.decode_step(tparams, torch.from_numpy(nxt).long(), cfg,
                                 tc, lora_params=tlora, lora_ctx_proto=TCTX)
        np.testing.assert_allclose(tl.numpy(), np.asarray(lg), rtol=0,
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(np.int32)
    assert tc["index"] == int(jc["index"])
    for k, v in jc.items():
        if k != "index":
            assert tc[k].dtype == torch.float32
            assert rel_err(tc[k], v) < REL_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill then three decode steps equal the train-mode forward over
    the whole sequence, in the port alone (tests/test_models.py's check,
    f32).  Decode attends over the cached cross K/V without the
    cross-attention adapters, as in the JAX module, so they are left out
    here."""
    _, cfg, _, nparams, lora = setup(arch)
    params = to_torch(nparams)
    tlora = to_torch({k: {t: v for t, v in banks.items()
                          if t not in ("xq", "xk", "xv")}
                      for k, banks in lora.items()})
    batch = th(inputs(cfg, seed=4))
    enc = N_FRAMES if cfg.family == "audio" else 0
    cache = ttf.init_cache(cfg, B, S_MAX, enc_len=enc, device="cpu",
                           dtype=torch.float32)
    kw = dict(lora_params=tlora, lora_ctx_proto=TCTX)
    _, cache = ttf.prefill(params, batch, cfg, cache, **kw)
    toks = torch.randint(0, cfg.vocab_size, (B, 3),
                         generator=torch.Generator().manual_seed(5))
    for i in range(3):
        lg, cache = ttf.decode_step(params, toks[:, i:i + 1], cfg, cache,
                                    **kw)
    full = dict(batch, tokens=torch.cat([batch["tokens"], toks], 1))
    h, _, _ = ttf.forward(params, cfg, mode="train", **full, **kw)
    ref = ttf.logits_fwd(params["embed"], h[:, -1:], cfg)
    np.testing.assert_allclose(lg.numpy(), ref.numpy(), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_trees_match_jax(arch):
    """The full configs' parameter and adapter trees (ParamDefs: nothing
    is allocated) have the JAX package's leaf shapes; the element count
    is count_defs' and, within its approximate count of the norms,
    cfg.param_count()'s."""
    def shapes(tree):
        return [tuple(d.shape) for d in jax.tree.leaves(
            tree, is_leaf=lambda x: hasattr(x, "shape"))]

    jcfg, cfg = get_config(arch), tcfg.get_config(arch)
    for name in ("model_defs", "lora_defs_tree"):
        got = getattr(ttf, name)(cfg)
        assert all(isinstance(d, ParamDef) for d in tree_leaves(got))
        assert [tuple(d.shape) for d in tree_leaves(got)] == \
            shapes(getattr(jtf, name)(jcfg))
    n = sum(math.prod(d.shape) for d in tree_leaves(ttf.model_defs(cfg)))
    assert n == count_defs(jtf.model_defs(jcfg))
    assert abs(n - cfg.param_count()) < 1e-4 * n


def test_unknown_family_raises():
    cfg = dc.replace(tcfg.smoke_config("mistral-7b"), family="rnn")
    for fn in (ttf.model_defs, ttf.lora_defs_tree):
        with pytest.raises(ValueError, match="rnn"):
            fn(cfg)
    with pytest.raises(ValueError, match="rnn"):
        ttf.init_cache(cfg, 1, 8, device="cpu")


def test_audio_prefill_needs_frames():
    _, cfg, _, nparams, _ = setup("whisper-small")
    cache = ttf.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        ttf.prefill(to_torch(nparams), {"tokens": torch.zeros(
            (1, 4), dtype=torch.long)}, cfg, cache)


def test_init_params_on_the_hybrid_tree(monkeypatch):
    """The nested (groups, period) stack keeps JAX's std rule (1/sqrt of
    shape[0], the group count), and a leaf larger than DRAW_PIECE is drawn
    in pieces: the same values as one draw of each piece."""
    cfg = tcfg.smoke_config("zamba2-2.7b")
    p = init_params(ttf.model_defs(cfg), torch.Generator().manual_seed(0),
                    "cpu", dtype_override=torch.float32)
    wx = p["layers"]["ssm"]["wx"]
    assert wx.shape == (2, 2, 128, 256)
    assert abs(wx.std().item() - 2 ** -0.5) < 0.02
    monkeypatch.setattr(tparam, "DRAW_PIECE", 1000)
    defs = {"w": ParamDef((3, 700), (None, None), scale=1.0)}
    got = init_params(defs, torch.Generator().manual_seed(1), "cpu",
                      dtype_override=torch.float32)["w"]
    g = torch.Generator().manual_seed(1)
    want = torch.cat([torch.randn(n, generator=g)
                      for n in (1000, 1000, 100)]).reshape(3, 700)
    assert torch.equal(got, want)


def test_families_launcher_on_the_cpu():
    """launch/families on the CPU: the card-vs-CPU check against itself,
    and the decode check at smoke size in bf16 and f32."""
    r = families.card_vs_cpu("granite-moe-3b-a800m", "cpu")
    assert r["max_abs_diff"] == 0.0 and r["routes_equal"]
    assert r["moe_calls"] == 4 * 4 and r["min_topk_margin"] > 0
    cfg = tcfg.smoke_config("pixtral-12b")
    r = families.decode_check(cfg, "cpu")
    assert r["finite"] and r["index"] == 8 + 16 + 3
    assert r["dtype"] == "bfloat16"
    assert r["max_abs_diff"] < 0.1       # bf16, tests/test_models.py's
    r = families.decode_check(cfg, "cpu", dtype=torch.float32)
    assert r["max_abs_diff"] < LOGIT_ATOL


def test_fan_in_defs_draws_each_matrix_at_its_fan_in():
    """The decode check's init: every default-std matrix at 1/sqrt of its
    input axes (stacking and output axes left out), explicit scales and
    constant leaves untouched."""
    for arch in ("deepseek-moe-16b", "zamba2-2.7b"):
        cfg = tcfg.get_config(arch)
        defs = families.fan_in_defs(ttf.model_defs(cfg))
        ref = ttf.model_defs(cfg)
        lay = defs["layers"]
        hd = cfg.resolved_head_dim
        if arch == "deepseek-moe-16b":
            attn, e = lay["attn"], cfg.moe
            assert attn["wq"].scale == 1 / math.sqrt(cfg.d_model)
            assert attn["wo"].scale == 1 / math.sqrt(cfg.num_heads * hd)
            assert lay["moe"]["w_down"].scale == 1 / math.sqrt(
                e.d_ff_expert)
            assert lay["moe"]["router"] == ref["layers"]["moe"]["router"]
        else:
            ssm = lay["ssm"]
            assert ssm["wx"].scale == 1 / math.sqrt(cfg.d_model)
            assert ssm["out_proj"].scale == 1 / math.sqrt(
                cfg.ssm.d_inner(cfg.d_model))
            assert ssm["conv_w"] == ref["layers"]["ssm"]["conv_w"]
            assert ssm["D"] == ref["layers"]["ssm"]["D"]
            assert defs["shared"]["attn"]["wq"].scale == 1 / math.sqrt(
                cfg.d_model)
        assert defs["embed"] == ref["embed"]
