"""The port's RealModelExecutor against the JAX one, in both adapter modes
on all three decode paths, directly and under ServingEngine, on the
tests/test_fused_executor.py fixture (f32 weights, so token streams are
comparable)."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import transformer as jtf
from repro.models.param import init_params as jax_init
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.real_executor import RealModelExecutor as JExecutor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro.serving.workload import WorkloadSpec as JWorkloadSpec
from repro.serving.workload import make_workload as j_make_workload
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.launch.serve import run_real
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.real_executor import (DECODE_PATHS,
                                               RealModelExecutor,
                                               derive_cost_constants)
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.workload import WorkloadSpec, make_workload

# f32 weights and banks, bf16 KV cache on both sides: the logits agree to
# f32 summation-order noise amplified through two layers
LOGIT_ATOL = 2e-4
N_ADAPTERS, RANK, MAX_BATCH, S_MAX = 4, 8, 8, 64
PATHS = ["unfused", "fused", "fused_q8"]
MODES = ["lora", "jd"]


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


def _bundles(cfg, mode):
    rng = np.random.default_rng(7)
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    n, r = N_ADAPTERS, RANK
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, d)}
    out = {}
    for t, (di, do) in dims.items():
        if mode == "lora":
            out[t] = {"A": 0.05 * rng.standard_normal((L, n, r, di)),
                      "B": 0.05 * rng.standard_normal((L, n, do, r))}
        else:
            out[t] = {"U": 0.05 * rng.standard_normal((L, 2, do, r)),
                      "V": 0.05 * rng.standard_normal((L, 2, di, r)),
                      "sigma": 0.5 * rng.standard_normal((L, n, r, r)),
                      "cluster_of": np.tile(np.arange(n) % 2, (L, 1))}
        out[t] = {k: (a.astype(np.int32) if k == "cluster_of"
                      else a.astype(np.float32)) for k, a in out[t].items()}
    return {"layers": out}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    jparams = jax.jit(lambda key: jax_init(jtf.model_defs(jcfg), key,
                                           dtype_override=jnp.float32))(
        jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, nparams, {m: _bundles(jcfg, m) for m in MODES}


def _pair(setup, mode, path):
    jcfg, cfg, jparams, nparams, bundles = setup
    je = JExecutor(jcfg, jparams, jax.tree.map(jnp.asarray, bundles[mode]),
                   mode, MAX_BATCH, S_MAX, decode_path=path)
    te = RealModelExecutor(cfg, to_torch(nparams), to_torch(bundles[mode]),
                           mode, MAX_BATCH, S_MAX, decode_path=path,
                           device="cpu")
    return je, te


def _jax_step(e) -> np.ndarray:
    """One JAX decode step, returning its last-position logits."""
    tokens = jnp.asarray(e.slot_tokens[:, None])
    ids = jnp.asarray(e.slot_adapter)
    if e.decode_path == "unfused":
        logits, e.cache = e._decode(e.params, e.bundles, tokens, e.cache, ids)
    else:
        logits, e.cache = e._decode(e.params, e.bundles, tokens, e.cache,
                                    ids, bucket=e._bucket())
    e._host_len += 1
    return np.asarray(logits[:, -1], np.float32)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mode", MODES)
def test_decode_logits_and_tokens_match_jax(setup, mode, path):
    je, te = _pair(setup, mode, path)
    rng = np.random.default_rng(0)
    for rid in range(5):
        # two prompt lengths: ragged slots, and two prefill compiles in JAX
        prompt = rng.integers(0, 36, size=6 + 7 * (rid % 2)).astype(np.int32)
        kw = dict(rid=rid, adapter_id=rid % N_ADAPTERS,
                  prompt_len=len(prompt), max_new_tokens=8)
        je.prefill_request(JRequest(**kw), prompt)
        te.prefill_request(Request(**kw), prompt)
    np.testing.assert_array_equal(te.slot_tokens[:5], je.slot_tokens[:5])
    assert te._host_len == je._host_len and te._bucket() == je._bucket()
    for _ in range(4):
        jl = _jax_step(je)
        tl = te.decode_logits()[:, -1].float().numpy()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
        # tokens: compared wherever JAX's top-2 margin exceeds the logit
        # tolerance, then both sides are fed JAX's tokens
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL
        nxt = jl.argmax(-1)
        np.testing.assert_array_equal(tl.argmax(-1)[clear], nxt[clear])
        assert clear.sum() >= MAX_BATCH - 1
        je.slot_tokens[:] = nxt
        te.slot_tokens[:] = nxt
    assert te.cache["index"] == int(je.cache["index"])


def _engine_tokens(ex, engine_cls, cfg_cls, sched_cls, spec_cls, make, path):
    """Serve 10 requests; returns ({rid: [tokens]}, stats dict)."""
    streams = {}
    inner = ex.decode_step_real

    def recording():
        out = inner()
        for rid, tok in out.items():
            streams.setdefault(rid, []).append(tok)
        return out

    ex.decode_step_real = recording
    eng = engine_cls(cfg_cls(scheduler=sched_cls(max_batch=MAX_BATCH),
                             adapter_budget_bytes=1e12, mode="lora",
                             decode_path=path), ex)
    eng.on_finish = lambda req: ex.release(req.rid)
    eng.submit(make(spec_cls(n_requests=10, n_adapters=N_ADAPTERS,
                             prompt_len_mean=12, prompt_len_std=0,
                             new_tokens=5)))
    np.random.seed(0)              # prefill_time draws the prompts
    stats = eng.run()
    return streams, stats


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mode", MODES)
def test_serving_engine_streams_match_jax(setup, mode, path):
    je, te = _pair(setup, mode, path)
    j_streams, j_stats = _engine_tokens(
        je, JEngine, JEngineConfig, JSchedulerConfig, JWorkloadSpec,
        j_make_workload, path)
    t_streams, t_stats = _engine_tokens(
        te, ServingEngine, EngineConfig, SchedulerConfig, WorkloadSpec,
        make_workload, path)
    assert t_stats.n_requests == j_stats.n_requests == 10
    assert t_stats.n_tokens == j_stats.n_tokens == 50
    assert t_stats.peak_batch == j_stats.peak_batch
    assert t_streams == j_streams


def test_fused_q8_shrinks_residency(setup):
    _, cfg, _, nparams, bundles = setup
    ex = {p: RealModelExecutor(cfg, to_torch(nparams),
                               to_torch(bundles["lora"]), "lora", MAX_BATCH,
                               S_MAX, decode_path=p, device="cpu")
          for p in ("fused", "fused_q8")}
    ratio = ex["fused"].adapter_bytes(0) / ex["fused_q8"].adapter_bytes(0)
    assert ratio >= 3.0, ratio                 # int8 + per-channel scales
    assert ex["fused_q8"].bundles["layers"]["o"]["A_q"].dtype == torch.int8


def test_engine_rejects_decode_path_mismatch(setup):
    _, cfg, _, nparams, bundles = setup
    ex = RealModelExecutor(cfg, to_torch(nparams), to_torch(bundles["lora"]),
                           "lora", MAX_BATCH, S_MAX, decode_path="fused",
                           device="cpu")
    with pytest.raises(ValueError, match="decode_path"):
        ServingEngine(EngineConfig(scheduler=SchedulerConfig(max_batch=8),
                                   mode="lora", decode_path="unfused"), ex)
    with pytest.raises(ValueError):
        RealModelExecutor(cfg, to_torch(nparams), to_torch(bundles["lora"]),
                          "lora", MAX_BATCH, S_MAX, decode_path="nope",
                          device="cpu")
    assert set(DECODE_PATHS) == {"unfused", "fused", "fused_q8"}


def test_slot_export_import_round_trip(setup):
    _, cfg, _, nparams, bundles = setup
    src, dst = (RealModelExecutor(cfg, to_torch(nparams),
                                  to_torch(bundles["jd"]), "jd", MAX_BATCH,
                                  S_MAX, decode_path="fused", device="cpu")
                for _ in range(2))
    req = Request(rid=3, adapter_id=1, prompt_len=9, max_new_tokens=4)
    src.prefill_request(req, np.arange(9, dtype=np.int32))
    src.decode_step_real()
    dst.import_slot(req, src.export_slot(3))
    assert src.decode_step_real() == dst.decode_step_real()


def test_no_card_means_no_default_device(setup):
    """Entry points run on the card unless asked for the CPU: with no card
    and no explicit device they raise instead of running on the CPU."""
    _, cfg, _, nparams, bundles = setup
    if torch.cuda.is_available():
        ex = RealModelExecutor(cfg, to_torch(nparams),
                               to_torch(bundles["lora"]), "lora", MAX_BATCH,
                               S_MAX)
        assert ex.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RealModelExecutor(cfg, to_torch(nparams), to_torch(bundles["lora"]),
                          "lora", MAX_BATCH, S_MAX)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_real(cfg, 4, 2, "jd", decode_path="fused")


def test_run_real_serves_every_request_on_cpu():
    _, cfg = _cfgs()
    out = run_real(cfg, 4, 6, "lora", max_batch=4, decode_path="fused_q8",
                   device="cpu")
    assert out["n_requests"] == 6 and out["n_tokens"] == 48


def test_derive_cost_constants_fits_affine_model():
    samples = [(b, 1e-3 + 2e-4 * b) for b in (1, 2, 4, 8)]
    got = derive_cost_constants(samples)
    assert abs(got["step_overhead_s"] - 1e-3) < 1e-7
    assert abs(got["per_slot_s"] - 2e-4) < 1e-8
    with pytest.raises(ValueError):
        derive_cost_constants([(4, 1.0), (4, 1.1)])


def test_profile_decode_reports_a_step_on_cpu():
    from repro_torch.launch.profile_decode import profile_decode
    _, cfg = _cfgs()
    out = profile_decode(cfg, "lora", "fused", n_adapters=4, max_batch=4,
                         prompt_len=8, steps=2, device="cpu")
    assert out["host_ms_per_step"] > 0 and out["steps"] == 2
    assert out["device"] == "cpu" and out["device_idle_share"] is None
    assert out["device_ms_per_step"] is None and out["top_kernels"] == []
