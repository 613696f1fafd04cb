"""The port's training path and checkpoints on the card.

Marked ``gpu``: they skip where there is no CUDA device, and run on the
H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py

This file imports neither jax nor the JAX package; whether a card is
present is decided inside the ``cuda`` fixture, never at import.
"""
import dataclasses as dc

import pytest
import torch

from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as tf
from repro_torch.models.param import init_params, tree_leaves, tree_map
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.step import make_lora_train_step, make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda", 0)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.randn(5, 7, generator=g).bfloat16(),
                       "c": torch.tensor(3, dtype=torch.int32)}}


def test_restore_onto_another_device(tmp_path, cuda):
    """Elastic restore: written from the card, restored onto the CPU, and
    the other way, bit for bit."""
    tree = _tree()
    on_card = tree_map(lambda t: t.to(cuda), tree)
    save_checkpoint(str(tmp_path / "card"), 1, on_card)
    back = restore_checkpoint(str(tmp_path / "card"), 1, tree)
    save_checkpoint(str(tmp_path / "cpu"), 1, tree)
    back_card = restore_checkpoint(str(tmp_path / "cpu"), 1, on_card)
    for want, got, got_card in zip(tree_leaves(tree), tree_leaves(back),
                                   tree_leaves(back_card)):
        assert got.device.type == "cpu" and got_card.device.type == "cuda"
        assert got.dtype == got_card.dtype == want.dtype
        assert torch.equal(got, want) and torch.equal(got_card.cpu(), want)


def _cfg():
    return dc.replace(smoke_config("mistral-7b"), num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_train_step_on_the_card_matches_the_cpu(cuda, kind):
    """One f32 step from the same weights on the card and on the CPU, as
    chip_smoke.py's phase 8 (a) holds it: AdamW's eps is 1, so that the
    first step is proportional to the gradient (at 1e-8 it is the
    gradient's sign, noise where the gradient is ~0), and the layers'
    matrices are scaled to std ~1/sqrt(d), which keeps f32 gradients
    well-conditioned.  Loss within 1e-5, gradients (mu) within 1e-5 of the
    largest, master weights within lr times that plus one f32 rounding."""
    cfg = _cfg()
    base = init_params(tf.model_defs(cfg), torch.Generator().manual_seed(0),
                       "cpu", dtype_override=torch.float32)
    base["layers"] = tree_map(lambda t: 0.1 * t if t.ndim >= 3 else t,
                              base["layers"])
    lora = init_params(tf.lora_defs_tree(cfg),
                       torch.Generator().manual_seed(1), "cpu",
                       dtype_override=torch.float32)
    g = torch.Generator().manual_seed(2)
    lora = tree_map(lambda t: 0.05 * torch.randn(t.shape, generator=g), lora)
    batch = {"tokens": torch.randint(0, 64, (4, 24), generator=g),
             "targets": torch.randint(-1, 64, (4, 24), generator=g)}
    opt_cfg = AdamWConfig(lr=1e-3, eps=1.0)
    out = {}
    for dev in ("cpu", cuda):
        b = tree_map(lambda t: t.to(dev), base)
        bt = {k: v.to(dev) for k, v in batch.items()}
        if kind == "full":
            _, opt, m = make_train_step(cfg, opt_cfg)(b, init_opt_state(b),
                                                      bt)
        else:
            lp = tree_map(lambda t: t.to(dev), lora)
            _, opt, m = make_lora_train_step(cfg, opt_cfg)(
                b, lp, init_opt_state(lp), bt)
        out[str(dev)] = (float(m["loss"]),
                         [t.cpu() for t in tree_leaves(opt["master"])],
                         [t.cpu() for t in tree_leaves(opt["mu"])])
    (lc, mc, uc), (lg, mg, ug) = out["cpu"], out[str(cuda)]
    assert abs(lc - lg) <= 1e-5
    scale = max(float(u.abs().max()) for u in uc)
    assert max(float((a - b).abs().max()) for a, b in zip(uc, ug)) \
        <= 1e-5 * scale
    tol = 1e-3 * 1e-5 + torch.finfo(torch.float32).eps * max(
        float(a.abs().max()) for a in mc)
    assert max(float((a - b).abs().max()) for a, b in zip(mc, mg)) <= tol
