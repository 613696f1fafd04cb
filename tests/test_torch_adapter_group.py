"""The port's grouped dequantize, ``adapter_dequantize_group``, on the CPU
(where it runs the plain version bank by bank) against the JAX package's
``adapter_dequantize`` (the Pallas kernel in interpret mode), on banks that
JAX's ``adapter_quantize`` (interpret mode) packed from numpy inputs made
from a seed; and the fused_q8 executor's use of it: one call a layer, and
none of the one-bank ``adapter_dequantize``.  Dequantization is exact, so
every output is compared bit for bit."""
import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adapter_quant import adapter_dequantize as jax_dequantize
from repro.kernels.adapter_quant import adapter_quantize as jax_quantize
from repro_torch import configs as tcfg
from repro_torch.kernels import adapter_quant
from repro_torch.launch.serve import make_bundles
from repro_torch.models import transformer as tf
from repro_torch.models.param import init_params
from repro_torch.serving import real_executor
from repro_torch.serving.request import Request

BANKS = [  # shape, axis, the layer sliced from a stacked bank (or None)
    ((16, 16, 64), -1, None),       # an A bank
    ((4, 64, 16), -1, None),        # a 16-wide B / U bank
    ((1, 64, 16), -2, None),        # a V basis, scales per column
    ((3, 50, 70), -2, None),        # odd widths
    ((2, 3, 7, 100), -2, None),
    ((3, 4, 16, 64), -1, 1),        # a layer's slice of a stacked bank
    ((3, 1, 64, 16), -2, 2),
    ((3, 16, 16, 16), -1, 0),       # a layer's full Sigma
]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _packed(seed=0):
    """[(jax q, jax scale, torch q, torch scale)], sliced alike on both
    sides where the bank is stacked."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, axis, li in BANKS:
        w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        jq, js = jax_quantize(jnp.asarray(w), axis=axis)
        tq, ts = (torch.from_numpy(np.array(a)) for a in (jq, js))
        if li is not None:
            jq, js, tq, ts = jq[li], js[li], tq[li], ts[li]
        out.append((jq, js, tq, ts))
    return out


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_group_equals_jax_bit_for_bit(out_dtype):
    banks = _packed()
    got = adapter_quant.adapter_dequantize_group(
        [(tq, ts) for _, _, tq, ts in banks], out_dtype=TDT[out_dtype])
    assert len(got) == len(banks)
    for (jq, js, tq, _), g in zip(banks, got):
        want = np.asarray(jax_dequantize(jq, js, out_dtype=JDT[out_dtype]))
        assert g.dtype == TDT[out_dtype] and tuple(g.shape) == want.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      want.astype(np.float32))


def test_group_keeps_order_past_the_cap():
    """More banks than one launch takes: the outputs stay in order and
    equal the one-bank wrapper's; an empty list and an empty bank give
    empty results."""
    pairs = [(tq, ts) for _, _, tq, ts in _packed(1)]
    pairs = [pairs[i % len(pairs)] for i in range(2 * adapter_quant.GROUP_CAP
                                                  + 3)]
    got = adapter_quant.adapter_dequantize_group(pairs)
    assert len(got) == len(pairs)
    for (q, s), g in zip(pairs, got):
        assert torch.equal(g, adapter_quant.adapter_dequantize(q, s))
    assert adapter_quant.adapter_dequantize_group([]) == []
    empty = adapter_quant.adapter_dequantize_group(
        [(torch.zeros((0, 16, 16), dtype=torch.int8),
          torch.ones((0, 16, 1)))])
    assert empty[0].shape == (0, 16, 16)


@pytest.mark.parametrize("first_on_cpu", [True, False])
def test_group_runs_the_plain_version_only_wholly_on_the_cpu(first_on_cpu):
    """A list with any bank off the CPU goes to the kernel's checks, which
    refuse a CPU bank beside it, in either order (a ``meta`` bank stands in
    for one on the card)."""
    q, s = _packed(2)[0][2:]
    host = (q, s)
    other = (q.to("meta"), s.to("meta"))
    pairs = [host, other] if first_on_cpu else [other, host]
    with pytest.raises(ValueError):
        adapter_quant.adapter_dequantize_group(pairs)
    with pytest.raises(ValueError):
        adapter_quant.adapter_dequantize(q, s.to("meta"))


def _executor(mode, n_layers=3):
    cfg = dc.replace(tcfg.smoke_config("mistral-7b"), num_layers=n_layers,
                     d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
                     vocab_size=64)
    params = init_params(tf.model_defs(cfg), torch.Generator().manual_seed(0),
                         "cpu", dtype_override=torch.float32)
    bundles = make_bundles(cfg, 4, mode, "fused_q8", 0, torch.device("cpu"))
    return cfg, real_executor.RealModelExecutor(
        cfg, params, bundles, mode, 4, 32, decode_path="fused_q8",
        device="cpu")


@pytest.mark.parametrize("mode,per_layer,per_prefill", [
    ("lora", 6, 8),     # A and B of q, k, v; of q, k, v, o at prefill
    ("jd", 10, 12),     # U, V, Sigma of q, k, v and o's Sigma; all four's
])
def test_fused_q8_dequantizes_once_per_layer(monkeypatch, mode, per_layer,
                                             per_prefill):
    cfg, ex = _executor(mode)
    calls = []
    grouped = real_executor.adapter_dequantize_group

    def counting(pairs, **kw):
        pairs = list(pairs)
        calls.append(len(pairs))
        return grouped(pairs, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the fused_q8 path dequantized one bank")
    monkeypatch.setattr(real_executor, "adapter_dequantize_group", counting)
    monkeypatch.setattr(adapter_quant, "adapter_dequantize", refuse)
    rng = np.random.default_rng(3)
    for rid in range(3):
        prompt = rng.integers(0, 64, size=5 + rid).astype(np.int32)
        ex.prefill_request(Request(rid=rid, adapter_id=rid,
                                   prompt_len=len(prompt), max_new_tokens=4),
                           prompt)
    assert calls == [per_prefill] * 3
    calls.clear()
    for _ in range(2):
        logits = ex.decode_logits()
        assert bool(torch.isfinite(logits).all())
    assert calls == [per_layer] * (2 * cfg.num_layers)
