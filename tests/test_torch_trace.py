"""The port's host spans and counters (``repro_torch/spans.py``) on the
prefill path of ``RealModelExecutor``: nothing recorded while off, the
outputs the same bit for bit on and off, the tree of spans a prefill
leaves, self times, the token counter and the clock the spans are put on.
A small dense configuration with jd adapters on q, k, v and o."""
import dataclasses as dc
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch import spans
from repro_torch.models import transformer as tf
from repro_torch.models.param import init_params
from repro_torch.serving.real_executor import RealModelExecutor
from repro_torch.serving.request import Request

LAYERS, PROMPT, RANK, ADAPTERS, CLUSTERS = 2, 24, 4, 4, 2
TARGETS = ("q", "k", "v", "o")
CHILDREN = ["init_cache", "model", "splice", "answer_sync"]


@pytest.fixture(autouse=True)
def recording_ends():
    """Whatever a test leaves recording is ended after it."""
    yield
    spans.take()


@pytest.fixture(scope="module")
def setup():
    cfg = dc.replace(tcfg.smoke_config("mistral-7b"), num_layers=LAYERS,
                     d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
                     vocab_size=64)
    g = torch.Generator().manual_seed(0)
    params = init_params(tf.model_defs(cfg), g, "cpu")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, d)}
    bundles = {"layers": {t: {
        "U": 0.05 * torch.randn(LAYERS, CLUSTERS, do, RANK, generator=g),
        "V": 0.05 * torch.randn(LAYERS, CLUSTERS, di, RANK, generator=g),
        "sigma": 0.5 * torch.randn(LAYERS, ADAPTERS, RANK, RANK,
                                   generator=g),
        "cluster_of": torch.randint(0, CLUSTERS, (LAYERS, ADAPTERS),
                                    generator=g, dtype=torch.int32)}
        for t, (di, do) in dims.items()}}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, PROMPT)
    return cfg, params, bundles, prompt


def _executor(setup):
    cfg, params, bundles, _ = setup
    return RealModelExecutor(cfg, params, bundles, "jd", max_batch=2,
                             s_max=32, device="cpu")


def _prefill(ex, prompt, rid=7, adapter=3):
    ex.prefill_request(Request(rid=rid, adapter_id=adapter,
                               prompt_len=len(prompt), max_new_tokens=1),
                       prompt)


def _traced_prefill(setup):
    ex = _executor(setup)
    spans.start()
    _prefill(ex, setup[3])
    return spans.take()


def test_off_records_nothing(setup):
    assert spans.span("attention") is spans.span("mlp")
    _prefill(_executor(setup), setup[3])
    assert spans.take() is None


def test_outputs_bit_identical_on_and_off(setup):
    prompt = setup[3]
    out = []
    for on in (False, True):
        ex = _executor(setup)
        if on:
            spans.start()
        _prefill(ex, prompt)
        c1 = tf.init_cache(ex.cfg, 1, ex.s_max, device="cpu")
        logits, c1 = ex._prefill(torch.as_tensor(prompt[None]), c1,
                                 torch.tensor([3], dtype=torch.int32))
        taken = spans.take()
        assert (taken is not None) is on
        kv = ex.export_slot(7)["kv"]
        out.append((logits, c1, kv, int(ex.slot_tokens[0])))
    (la, ca, ka, ta), (lb, cb, kb, tb) = out
    assert torch.equal(la, lb)
    assert ta == tb
    for key in ("k", "v"):
        assert torch.equal(ca[key], cb[key])
        assert torch.equal(ka[key], kb[key])


def test_span_tree_of_a_prefill(setup):
    sp = _traced_prefill(setup)["spans"]
    roots = [i for i, s in enumerate(sp) if s.parent == -1]
    assert len(roots) == 1
    root = sp[roots[0]]
    assert root.name == "prefill_request"
    assert root.rid == 7

    def kids(i):
        return [j for j, s in enumerate(sp) if s.parent == i]

    assert [sp[j].name for j in kids(roots[0])] == CHILDREN
    model = kids(roots[0])[1]
    layer_names = [sp[j].name for j in kids(model)]
    assert layer_names == ["attention", "mlp"] * LAYERS
    for j in kids(model):
        if sp[j].name != "attention":
            assert kids(j) == []
            continue
        inner = kids(j)
        # the deltas of q, k and v, the attention, then the delta of o
        assert [sp[k].name for k in inner] == (
            ["adapter"] * (len(TARGETS) - 1) + ["attention_core", "adapter"])
        assert all(kids(k) == [] for k in inner)
    for s in sp:
        assert s.rid == 7
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_self_times_add_up_to_the_root(setup):
    sp = _traced_prefill(setup)["spans"]
    child_ns = [0] * len(sp)
    for s in sp:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    self_ns = [s.end_ns - s.start_ns - c for s, c in zip(sp, child_ns)]
    assert min(self_ns) >= 0
    root = sp[0]
    assert sum(self_ns) == root.end_ns - root.start_ns


def test_prompt_tokens_counted(setup):
    # beside the tokens, the adapter deltas by the path that ran them: on
    # the CPU every target of every layer on the einsums
    assert _traced_prefill(setup)["counters"] == {
        "prompt_tokens": PROMPT, "adapter_plain": LAYERS * len(TARGETS)}


def test_clock_fit_is_monotonic_and_on_the_system_clock():
    spans.start()
    wall = []
    for _ in range(3):
        with spans.span("x"):
            wall.append(time.time_ns())
        time.sleep(0.01)
    sp = spans.take()["spans"]
    for s, w in zip(sp, wall):
        assert abs(s.start_ns - w) < 1_000_000
    starts = [s.start_ns for s in sp]
    assert starts == sorted(starts)
    # a line through two readings: monotonic, exact at both
    to_wall = spans.clock_map((1_000, 1_700_000_000_000_000_000),
                              (2_001_000, 1_700_000_000_002_000_100))
    pts = [to_wall(p) for p in range(0, 3_000_000, 997)]
    assert pts == sorted(pts)
    assert to_wall(1_000) == 1_700_000_000_000_000_000
    assert to_wall(2_001_000) == 1_700_000_000_002_000_100
