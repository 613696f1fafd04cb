"""The port's paged KV decode (``flash_decode_paged`` and the fused paged
variants, their plain versions on the CPU) against the JAX package's
Pallas kernels in interpret mode and their oracles, on the same inputs made
with numpy from a seed; then the slice as a whole: both executors serve the
same requests, their caches are laid into pages under one table, and the
paged kernels and the KV wire quantization run on each."""
import dataclasses as dc
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.kernels import kv_quant as JKQ
from repro.kernels import ref as R
from repro.kernels.flash_decode import flash_decode_paged as jax_fd_paged
from repro.kernels.fused_decode import fused_decode_jd_paged as jax_jd_paged
from repro.kernels.fused_decode import \
    fused_decode_lora_paged as jax_lora_paged
from repro.models import transformer as jtf
from repro.models.param import init_params as jax_init
from repro.serving.real_executor import RealModelExecutor as JExecutor
from repro.serving.request import Request as JRequest
from repro_torch import configs as tcfg
from repro_torch.convert import array_to_tensor, to_torch
from repro_torch.kernels import checks, ref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.fused_decode import (fused_decode_jd,
                                              fused_decode_jd_paged,
                                              fused_decode_lora,
                                              fused_decode_lora_paged)
from repro_torch.kernels.kv_quant import kv_quantize
from repro_torch.launch import paged_kv
from repro_torch.serving.engine import ModelFootprint
from repro_torch.serving.real_executor import RealModelExecutor
from repro_torch.serving.request import Request

# f32 inputs: the two sides sum the same products in another order
F32_TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    competing for the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [array_to_tensor(a) for a in arrays])


def _pages(k, v, page_t, P, rng):
    """tests/test_kernels.py's ``_paged`` in numpy: contiguous (B, S, Kv,
    hd) K/V scattered into a pool of P pages under a permuted table."""
    B, S, Kv, hd = k.shape
    nb = S // page_t
    table = rng.permutation(P)[:B * nb].astype(np.int32).reshape(B, nb)
    kp = np.zeros((P, page_t, Kv, hd), k.dtype)
    vp = np.zeros_like(kp)
    kp[table.reshape(-1)] = k.reshape(B * nb, page_t, Kv, hd)
    vp[table.reshape(-1)] = v.reshape(B * nb, page_t, Kv, hd)
    return kp, vp, table


@pytest.mark.parametrize("seed,B,Kv,G,hd,n_blocks", [
    (0, 2, 2, 2, 64, 2),
    (1, 3, 4, 2, 64, 4),
    (2, 1, 1, 8, 128, 3),
])
def test_flash_decode_paged_matches_jax(seed, B, Kv, G, hd, n_blocks):
    """tests/test_paged.py's sweep: page_t 128, a pool larger than needed,
    a permuted table."""
    page_t = 128
    rng = np.random.default_rng(seed)
    P = B * n_blocks + 3
    H = Kv * G
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, page_t, Kv, hd)).astype(np.float32)
    vp = rng.normal(size=(P, page_t, Kv, hd)).astype(np.float32)
    pt = rng.permutation(P)[:B * n_blocks].reshape(B, n_blocks).astype(
        np.int32)
    kv_len = rng.integers(page_t, n_blocks * page_t, size=(B,)).astype(
        np.int32)
    (jq, jk, jv, jt, jl), tens = _both(q, kp, vp, pt, kv_len)
    out, l, m = flash_decode_paged(*tens)
    assert out.shape == (B, H, hd) and l.shape == m.shape == (B, Kv, G, 1)
    p_out, p_l, p_m = jax_fd_paged(jq, jk, jv, jt, jl)
    np.testing.assert_allclose(_np(out), _np(p_out), **F32_TOL)
    np.testing.assert_allclose(m.numpy(), _np(p_m), **F32_TOL)
    np.testing.assert_allclose(l.numpy(), _np(p_l), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        _np(out), _np(R.flash_decode_paged_ref(jq, jk, jv, jt, jl)),
        **F32_TOL)
    np.testing.assert_array_equal(
        ref.gather_pages_ref(tens[1], tens[3]).numpy(),
        np.asarray(R.gather_pages_ref(jk, jt)))


def _fused_fixture(mode):
    """tests/test_kernels.py's paged fused fixture (page_t 16), in numpy."""
    B, H, Kv, hd, S, n, r, d_out, page_t = 4, 4, 2, 32, 128, 3, 8, 64, 16
    rng = np.random.default_rng(20)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    kv_len = rng.integers(1, S + 1, size=B).astype(np.int32)
    ids = rng.integers(0, n, size=B).astype(np.int32)
    kp, vp, table = _pages(k, v, page_t, B * (S // page_t), rng)
    if mode == "lora":
        banks = ((rng.standard_normal((n, r, H * hd)) / 8).astype(np.float32),
                 (rng.standard_normal((n, d_out, r)) / 4).astype(np.float32))
    else:
        banks = ((rng.standard_normal((2, d_out, r)) / 4).astype(np.float32),
                 (rng.standard_normal((2, H * hd, r)) / 8).astype(np.float32),
                 (rng.standard_normal((n, r, r)) / 4).astype(np.float32),
                 (np.arange(n) % 2).astype(np.int32))
    return (q, k, v, kv_len, ids), (kp, vp, table), banks


@pytest.mark.parametrize("mode", ["lora", "jd"])
def test_fused_paged_matches_jax(mode):
    (q, k, v, kv_len, ids), (kp, vp, table), banks = _fused_fixture(mode)
    jx, tx = _both(q, kp, vp, table, kv_len, ids, *banks)
    port, jax_fn = ((fused_decode_lora_paged, jax_lora_paged)
                    if mode == "lora" else
                    (fused_decode_jd_paged, jax_jd_paged))
    out, delta = port(*tx)
    assert delta.dtype == torch.float32 and delta.shape == (4, 64)
    p_out, p_delta = jax_fn(*jx)
    np.testing.assert_allclose(_np(out), _np(p_out), **F32_TOL)
    np.testing.assert_allclose(delta.numpy(), _np(p_delta), **F32_TOL)
    # the contiguous port on the same logical content: the same function
    cont = fused_decode_lora if mode == "lora" else fused_decode_jd
    c_out, c_delta = cont(*[array_to_tensor(a) for a in
                            (q, k, v, kv_len, ids, *banks)])
    assert torch.equal(out, c_out) and torch.equal(delta, c_delta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_t", [16, 128])
def test_paged_plain_versions_equal_contiguous(page_t, dtype):
    """On the CPU each paged wrapper is its plain version: gather, then
    the contiguous plain version, so it equals the contiguous wrapper on
    the gathered content bit for bit (and so do the card's checks)."""
    gen = torch.Generator().manual_seed(page_t)
    case = checks.attention_case(3, 8, 2, 32, 300, 256, [1, 130, 256],
                                 dtype, gen, "cpu")
    case["ids"] = torch.tensor([2, 0, 2], dtype=torch.int32)
    pc = checks.paged_case(case, page_t, 5, gen)
    P = pc["k_pages"].shape[0]
    assert P == 3 * pc["page_table"].shape[1] + 5
    assert len(set(pc["page_table"].reshape(-1).tolist())) == \
        pc["page_table"].numel()
    out, l, m = flash_decode_paged(pc["q"], pc["k_pages"], pc["v_pages"],
                                   pc["page_table"], pc["kv_len"])
    for a, b in zip((out, l, m), flash_decode(
            pc["q"], pc["k_logical"], pc["v_logical"], pc["kv_len"])):
        assert torch.equal(a, b)
    assert checks.check_flash_decode_paged(pc)["max_abs_err"] == 0
    for quant in (False, True):
        lb = checks.lora_banks(3, 8, 8 * 32, 48, dtype, gen, "cpu", quant)
        assert checks.check_fused_lora_paged(pc, lb)["max_abs_err"] == 0
        for diag in (True, False):
            jb = checks.jd_banks(2, 3, 8, 8 * 32, 48, dtype, gen, "cpu",
                                 quant, diag)
            assert checks.check_fused_jd_paged(pc, jb)["max_abs_err"] == 0
    # the table entries the kernel reads: ceil(kv_len / page_t) a row
    want = sum(-(-n // page_t) for n in (1, 130, 256))
    assert checks.paged_table_bytes(pc) == 4 * want


def test_paged_checks_catch_a_wrong_page():
    gen = torch.Generator().manual_seed(1)
    case = checks.attention_case(2, 4, 1, 32, 64, 64, [64, 40], torch.float32,
                                 gen, "cpu")
    pc = checks.paged_case(case, 16, 2, gen)
    pc["page_table"] = pc["page_table"].flip(1).contiguous()
    with pytest.raises(AssertionError):
        checks.check_flash_decode_paged(pc)


# -- the slice as a whole -------------------------------------------------------

N_ADAPTERS, RANK, MAX_BATCH, S_MAX, PAGE_T = 4, 8, 4, 64, 16


def _cfgs():
    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
              d_ff=128, vocab_size=64)
    return (dc.replace(smoke_config("mistral-7b"), **kw),
            dc.replace(tcfg.smoke_config("mistral-7b"), **kw))


def _lora_bundles(cfg):
    """tests/test_torch_executor.py's lora bundles (f32, seed 7)."""
    rng = np.random.default_rng(7)
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, d)}
    return {"layers": {t: {
        "A": (0.05 * rng.standard_normal((L, N_ADAPTERS, RANK, di))
              ).astype(np.float32),
        "B": (0.05 * rng.standard_normal((L, N_ADAPTERS, do, RANK))
              ).astype(np.float32)} for t, (di, do) in dims.items()}}


@pytest.fixture(scope="module")
def served():
    """Both executors, fused path, lora mode, after serving 4 requests of
    20 and 36 tokens and two decode steps (the JAX side's steps as
    tests/test_torch_executor.py takes them, feeding both its tokens)."""
    jcfg, cfg = _cfgs()
    jparams = jax.jit(lambda key: jax_init(jtf.model_defs(jcfg), key,
                                           dtype_override=jnp.float32))(
        jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    bundles = _lora_bundles(jcfg)
    je = JExecutor(jcfg, jparams, jax.tree.map(jnp.asarray, bundles),
                   "lora", MAX_BATCH, S_MAX, decode_path="fused")
    te = RealModelExecutor(cfg, to_torch(nparams), to_torch(bundles), "lora",
                           MAX_BATCH, S_MAX, decode_path="fused",
                           device="cpu")
    rng = np.random.default_rng(0)
    for rid in range(MAX_BATCH):
        prompt = rng.integers(0, 36, size=20 + 16 * (rid % 2)).astype(
            np.int32)
        kw = dict(rid=rid, adapter_id=rid % N_ADAPTERS,
                  prompt_len=len(prompt), max_new_tokens=4)
        je.prefill_request(JRequest(**kw), prompt)
        te.prefill_request(Request(**kw), prompt)
    for _ in range(2):
        logits, je.cache = je._decode(
            je.params, je.bundles, jnp.asarray(je.slot_tokens[:, None]),
            je.cache, jnp.asarray(je.slot_adapter), bucket=je._bucket())
        je._host_len += 1
        te.decode_logits()
        nxt = np.asarray(logits[:, -1]).argmax(-1)
        je.slot_tokens[:] = nxt
        te.slot_tokens[:] = nxt
        je.slot_len += 1
        te.slot_len += 1
    return jcfg, cfg, je, te, bundles


def test_slice_paged_kernels_and_wire_match_jax(served):
    jcfg, cfg, je, te, bundles = served
    jk, jv = np.asarray(je.cache["k"]), np.asarray(je.cache["v"])
    tk, tv = te.cache["k"], te.cache["v"]
    # the two caches: bf16 values of f32 computations that sum in other
    # orders, so a value may round to a neighbouring bf16, and a small one
    # (terms that cancel) move by a few of its ulps
    np.testing.assert_allclose(_np(tk), jk.astype(np.float32), rtol=2 ** -7,
                               atol=1e-3)
    L, B, S, Kv, hd = tk.shape
    rng = np.random.default_rng(11)
    P = B * (S // PAGE_T) + 5
    kv_len = te.slot_len.astype(np.int32)
    np.testing.assert_array_equal(kv_len, je.slot_len)
    q = rng.standard_normal((B, cfg.num_heads, hd)).astype(np.float32)
    ids = te.slot_adapter.astype(np.int32)
    for li in range(L):
        # both caches laid into pages under the same table
        pools, tables = {}, []
        for side, (k, v) in (("jax", (jk[li], jv[li])),
                             ("port", (tk[li].float().numpy(),
                                       tv[li].float().numpy()))):
            kp, vp, table = _pages(k.astype(np.float32),
                                   v.astype(np.float32), PAGE_T, P,
                                   np.random.default_rng(li))
            pools[side] = (kp, vp)
            tables.append(table)
        np.testing.assert_array_equal(*tables)
        A = bundles["layers"]["o"]["A"][li]
        Bm = bundles["layers"]["o"]["B"][li]
        jx = [jnp.asarray(a) for a in (q, *pools["jax"], table, kv_len)]
        tx = [array_to_tensor(a) for a in (q, *pools["port"], table, kv_len)]
        # each kernel on its own side's cache
        j_out = np.asarray(jax_fd_paged(*jx)[0])
        t_out = flash_decode_paged(*tx)[0].numpy()
        np.testing.assert_allclose(t_out, j_out, rtol=1e-2, atol=1e-2)
        jl_out, jl_delta = jax_lora_paged(*jx, jnp.asarray(ids),
                                          jnp.asarray(A), jnp.asarray(Bm))
        tl_out, tl_delta = fused_decode_lora_paged(
            *tx, array_to_tensor(ids), array_to_tensor(A),
            array_to_tensor(Bm))
        np.testing.assert_allclose(tl_delta.numpy(), np.asarray(jl_delta),
                                   rtol=1e-2, atol=1e-3)
        # and both kernels on the port's cache: the same function
        jx_port = [jnp.asarray(a) for a in (q, *pools["port"], table,
                                            kv_len)]
        np.testing.assert_allclose(
            t_out, np.asarray(jax_fd_paged(*jx_port)[0]), **F32_TOL)
        _, jp_delta = jax_lora_paged(*jx_port, jnp.asarray(ids),
                                     jnp.asarray(A), jnp.asarray(Bm))
        np.testing.assert_allclose(tl_delta.numpy(), np.asarray(jp_delta),
                                   **F32_TOL)
        np.testing.assert_allclose(tl_out.numpy(), np.asarray(jl_out),
                                   rtol=1e-2, atol=1e-2)
    # the KV wire: one exported slot laid out as (T, C), K then V
    longest = int(np.argmax(te.slot_len))
    rid = te.slot_req[longest]
    x = paged_kv.wire_layout(te.export_slot(rid))
    fp = ModelFootprint.from_config(cfg)
    assert x.shape == (int(te.slot_len[longest]),
                       fp.kv_bytes_per_token // 2)
    state = je.export_slot(rid)
    jxw = np.concatenate(
        [np.asarray(state["kv"][n])[:, 0, :x.shape[0]].transpose(
            1, 0, 2, 3).reshape(x.shape[0], -1) for n in ("k", "v")], axis=1)
    np.testing.assert_allclose(_np(x), jxw.astype(np.float32), rtol=2 ** -7,
                               atol=1e-3)
    for bits in (8, 4):
        packed, scales = kv_quantize(x, bits)
        j_packed, j_scales = JKQ.kv_quantize(
            jnp.asarray(x.float().numpy()), bits=bits)
        np.testing.assert_allclose(scales.numpy(), np.asarray(j_scales),
                                   rtol=1e-6, atol=0)
        same = scales.numpy()[0] == np.asarray(j_scales)[0]
        np.testing.assert_array_equal(packed.numpy()[:, same],
                                      np.asarray(j_packed)[:, same])


def test_prompt_lengths_are_even_and_in_range():
    lens = paged_kv.prompt_lengths(64, 1024, 2044, 0)
    assert all(n % 2 == 0 and 1024 <= n <= 2044 for n in lens)
    assert len(set(lens)) > 32
    assert lens == paged_kv.prompt_lengths(64, 1024, 2044, 0)


def test_entry_point_runs_on_the_cpu():
    """``python -m repro_torch.launch.paged_kv --smoke --device cpu`` runs
    to its end: serve, paged decode and the KV wire in both modes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.paged_kv", "--smoke",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    report = json.loads(proc.stdout)
    for mode in ("lora", "jd"):
        row = report["modes"][mode]
        assert row["paged"]["bit_identical_with_contiguous"]
        assert row["paged"]["n_blocks"] >= 2
        assert len(set(row["paged"]["kv_len"])) > 1
        for bits in ("int8", "int4"):
            w = row["wire"]["bits"][bits]
            assert w["wire_bytes"] == w["sim_wire_bytes"]


def test_attention_slack_bounds_the_f32_error_over_a_long_cache():
    """The paged checks' extra term: on a long cache with large logits and
    values (as mistral-7b's served cache has), the f32 plain version sits
    within attention_slack of an f64 computation, and the slack stays far
    below the outputs' scale."""
    gen = torch.Generator().manual_seed(5)
    B, H, Kv, hd, S = 2, 4, 1, 128, 2048
    q = torch.randn((B, H, hd), generator=gen)
    k = torch.randn((B, S, Kv, hd), generator=gen) * 11
    v = torch.randn((B, S, Kv, hd), generator=gen) * 11
    kv_len = torch.tensor([2048, 1500], dtype=torch.int32)
    out32, _, _ = ref.flash_decode_ref(q, k, v, kv_len)
    qs = q.double().reshape(B, Kv, H, hd) * hd ** -0.5
    logits = torch.einsum("bkgh,bskh->bkgs", qs, k.double())
    mask = torch.arange(S)[None, :] < kv_len[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(-1e300, dtype=torch.float64))
    out64 = torch.einsum("bkgs,bskh->bkgh", torch.softmax(logits, -1),
                         v.double()).reshape(B, H, hd)
    slack = checks.attention_slack(q, k, v, kv_len)
    assert float(logits.max()) > 30               # a peaked softmax
    assert bool(((out32.double() - out64).abs() <= slack.double()).all())
    assert float(slack.max()) < 1e-2 * float(out64.abs().max())
