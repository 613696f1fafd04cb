"""The plain reference against the port's prefill, both in float32, at a
size the CPU holds: the jd and lora adapter modes on the dense model and
lora on the MoE; and the control (the reference in float8 in the
program's place) through a whole run, against the cell's limits."""
import numpy as np
import pytest
import torch

from portbench import spec, weights
from portbench.control import control_executor
from portbench.reference.model import Reference
from portbench.run import run_cell
from portbench.tests.smoke import smoke_cell
from repro_torch.models import transformer as tf
from repro_torch.models.lora import LoRAContext

CASES = [("dense", "jd"), ("dense", "lora"), ("moe", "lora")]


def _setup(kind, mode, seed=5, dtype=torch.float32):
    cell = smoke_cell(kind)
    cell.config["serving"]["mode"] = mode
    conf, sv = cell.config, cell.config["serving"]
    cfg = spec.port_config(conf)
    rc = spec.reference_config(conf)
    g = torch.Generator()
    g.manual_seed(seed)
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t  # noqa
    params = _map(weights.model_weights(tf.model_defs(cfg), cfg, g, "cpu"),
                  cast)
    bundles = _map(weights.adapter_bundles(cfg, sv, g, "cpu"), cast)
    return cell, cfg, rc, params, bundles


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("kind,mode", CASES)
def test_reference_matches_the_port_in_f32(kind, mode):
    cell, cfg, rc, params, bundles = _setup(kind, mode)
    rng = np.random.default_rng(0)
    for S, aid in ((5, 3), (37, 6)):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, S))
        cache = tf.init_cache(cfg, 1, 64, device="cpu", dtype=torch.float32)
        ctx = LoRAContext(mode="batched" if mode == "lora" else "jd",
                          params=None, ids=torch.tensor([aid]), scaling=1.0)
        logits, c = tf.prefill(params, {"tokens": toks[None]}, cfg, cache,
                               lora_params=bundles, lora_ctx_proto=ctx)
        kv = {}
        ref = Reference(params, rc, bundles).run(
            [toks], [aid], on_kv=lambda li, j, k, v: kv.update({li: (k, v)}))
        want = ref[0][0]
        got = logits[0, -1]
        assert torch.allclose(got, want, rtol=1e-4,
                              atol=1e-4 * float(want.abs().max()))
        for li, (k, v) in kv.items():
            assert torch.allclose(c["k"][li, 0, :S], k, atol=1e-4)
            assert torch.allclose(c["v"][li, 0, :S], v, atol=1e-4)
            assert not c["k"][li, 0, S:].any()


@pytest.mark.parametrize("kind,mode", CASES)
def test_adapter_moves_the_reference(kind, mode):
    """The adapter deltas are part of the reference: another adapter
    gives other keys and logits."""
    _, cfg, rc, params, bundles = _setup(kind, mode)
    toks = torch.arange(20) % cfg.vocab_size
    ref = Reference(params, rc, bundles)
    a, b = ref.run([toks, toks], [1, 2])
    assert (a - b).abs().max() > 0.05 * a.abs().max()


@pytest.mark.parametrize("cell_kind", ["dense", "poisson"])
def test_control_fails_the_cells_limits(cell_kind):
    """The reference in float8 put in the program's place and driven
    through a whole run (window, sample, comparison) reads above the
    cell's limit on at least one number, on three seeds."""
    cell = smoke_cell(cell_kind)
    rc = spec.reference_config(cell.config)
    for seed in (1, 2, 3):
        res = run_cell(cell, seed, 0.4, False, "cpu", t_start=0.0,
                       executor=control_executor(rc))
        nums = {k: c for k, c in res["checks"].items() if k != "missing"}
        assert not res["correct"], res["checks"]
        assert any(c["value"] > c["limit"] for c in nums.values()), nums
        assert res["attempted"] >= 7 and res["failed"] == 0
