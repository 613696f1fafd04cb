"""The port's serving of the model families against the JAX package's:
`run_real` refuses what the JAX launcher cannot serve, the executor on the
smoke configs of granite-moe-3b-a800m, mamba2-2.7b and pixtral-12b gives
the JAX executor's tokens, and an SSM family's cache migrates between
executors slot by slot."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from families_common import S_MAX, one_torch_thread, rel_err, setup
from repro.serving.real_executor import RealModelExecutor as JExecutor
from repro.serving.request import Request as JRequest
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.launch.serve import run_real
from repro_torch.serving import real_executor as trex
from repro_torch.serving.request import Request

__all__ = ["one_torch_thread"]   # the autouse fixture, imported to apply

# f32 weights and banks, bf16 KV caches on both sides (the executors'
# default): tests/test_torch_executor.py's logit tolerance
LOGIT_ATOL = 2e-4


@pytest.mark.parametrize("arch,why", [
    ("deepseek-moe-16b", "dense_layers"), ("zamba2-2.7b", "shared"),
    ("whisper-small", "frames")])
def test_run_real_refuses_what_the_reference_cannot_serve(arch, why):
    with pytest.raises(ValueError, match=why):
        run_real(tcfg.smoke_config(arch), 2, 2, device="cpu")


N_ADAPTERS, MAX_BATCH = 3, 4


def _serve_bundles(cfg, mode):
    """run_real's layout: q/k/v banks stacked over all layers."""
    rng = np.random.default_rng(7)
    L, d, hd, r = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim, 4
    out = {}
    for t, do in (("q", cfg.num_heads * hd), ("k", cfg.num_kv_heads * hd),
                  ("v", cfg.num_kv_heads * hd)):
        if mode == "lora":
            out[t] = {"A": rng.standard_normal((L, N_ADAPTERS, r, d)),
                      "B": rng.standard_normal((L, N_ADAPTERS, do, r))}
        else:
            out[t] = {"U": rng.standard_normal((L, 1, do, r)),
                      "V": rng.standard_normal((L, 1, d, r)),
                      "sigma": rng.standard_normal((L, N_ADAPTERS, r, r)),
                      "cluster_of": np.zeros((L, N_ADAPTERS), np.int32)}
        out[t] = {k: a if k == "cluster_of" else (0.05 * a).astype(np.float32)
                  for k, a in out[t].items()}
    return {"layers": out}


@pytest.mark.parametrize("arch,mode,path", [
    ("granite-moe-3b-a800m", "lora", "unfused"),
    ("granite-moe-3b-a800m", "jd", "unfused"),
    ("mamba2-2.7b", "lora", "unfused"),
    ("pixtral-12b", "jd", "unfused"),
    ("pixtral-12b", "lora", "fused")])
def test_executor_matches_jax(arch, mode, path):
    jcfg, cfg, jparams, nparams, _ = setup(arch)
    bundles = _serve_bundles(jcfg, mode)
    je = JExecutor(jcfg, jparams, jax.tree.map(jnp.asarray, bundles), mode,
                   MAX_BATCH, S_MAX, decode_path=path)
    te = trex.RealModelExecutor(cfg, to_torch(nparams), to_torch(bundles),
                                mode, MAX_BATCH, S_MAX, decode_path=path,
                                device="cpu")
    rng = np.random.default_rng(0)
    for rid in range(3):
        prompt = rng.integers(0, 100, size=5 + 4 * rid).astype(np.int32)
        kw = dict(rid=rid, adapter_id=rid % N_ADAPTERS,
                  prompt_len=len(prompt), max_new_tokens=4)
        je.prefill_request(JRequest(**kw), prompt)
        te.prefill_request(Request(**kw), prompt)
    np.testing.assert_array_equal(te.slot_tokens, je.slot_tokens)
    for _ in range(3):
        jout = je.decode_step_real()
        tl = te.decode_logits()[:, -1].float().numpy()
        # tokens compared where the top-2 margin clears the logit
        # tolerance (the near-tie rule of ROADMAP queue 3)
        top2 = np.sort(tl, axis=-1)[:, -2:]
        for rid, tok in jout.items():
            if top2[rid, 1] - top2[rid, 0] > 2 * LOGIT_ATOL:
                assert int(tl[rid].argmax()) == tok, (rid, tok)
        te.slot_tokens[:] = je.slot_tokens
    for k in je.cache:
        if k != "index":
            assert rel_err(te.cache[k], je.cache[k]) < 1e-2, k


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_executor_migrates_ssm_caches(arch):
    """export_slot / import_slot on every leaf of an SSM family's cache: a
    request moved into another executor decodes as it would have at home.
    On the hybrid cache the conv leaf's batch is on axis 2 (the JAX
    executor's rank rule says 1)."""
    _, cfg, _, nparams, _ = setup(arch)
    params = to_torch(nparams)
    ex = [trex.RealModelExecutor(cfg, params, {}, "lora", MAX_BATCH, S_MAX,
                                 device="cpu") for _ in range(2)]
    if cfg.family == "hybrid":
        assert trex._batch_dim(cfg, "conv") == 2
        assert trex._batch_dim(cfg, "state") == 2
        assert trex._batch_dim(cfg, "k") == 1
    for key, leaf in ex[0].cache.items():
        if key != "index":
            assert leaf.shape[trex._batch_dim(cfg, key)] == MAX_BATCH, key
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 100, size=n).astype(np.int32) for n in (7, 7)]
    for rid, prompt in enumerate(prompts):
        ex[0].prefill_request(Request(rid=rid, adapter_id=0,
                                      prompt_len=7, max_new_tokens=4), prompt)
    ex[1].prefill_request(Request(rid=0, adapter_id=0, prompt_len=7,
                                  max_new_tokens=4), prompts[0])
    state = ex[0].export_slot(1)
    ex[1].import_slot(Request(rid=1, adapter_id=0, prompt_len=7,
                              max_new_tokens=4), state)
    for key in ex[0].cache:
        if key != "index":
            assert torch.equal(ex[0].cache[key], ex[1].cache[key]), key
    assert ex[0].decode_step_real() == ex[1].decode_step_real()
