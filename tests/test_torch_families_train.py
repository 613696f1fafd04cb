"""`lm_loss` of every model family (with the MoE aux loss at its 0.01
weight, the vlm patches sliced off, the audio frames) and its gradients
against `repro.models.transformer`, on the smoke configs in f32 with
remat, from the same numpy-drawn weights."""
import jax
import numpy as np
import pytest
import torch

from families_common import (ARCHS, B, S, compile_o0, inputs,
                             one_torch_thread, setup, th)
from repro.models import transformer as jtf
from repro_torch.convert import to_torch
from repro_torch.models import transformer as ttf
from repro_torch.models.param import tree_leaves, tree_map

__all__ = ["one_torch_thread"]   # the autouse fixture, imported to apply

# the loss is a token mean of f32 terms plus 0.01 x the aux loss
LOSS_ATOL = 1e-5
# gradients: at the smoke configs' init f32 gradients are ill-conditioned
# (measured: the port's f32 gradients sit 1e-6..2.4e-3 of the largest from
# its f64 ones, whisper-small the worst), so JAX's f32 gradients are held
# to the port's f64 ones within GRAD_FACTOR times the port's own f32
# distance from them (plus GRAD_FLOOR of the largest): a fault in the
# port's arithmetic would move its f64 gradients, not the f32 noise
# (measured ratio: up to 1.9)
GRAD_FACTOR = 3.0
GRAD_FLOOR = 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    jcfg, cfg, jparams, nparams, _ = setup(arch)
    batch = inputs(jcfg, seed=2)
    rng = np.random.default_rng(3)
    batch["targets"] = rng.integers(-1, cfg.vocab_size,
                                    (B, S)).astype(np.int32)
    jl, jg = compile_o0(jax.value_and_grad(
        lambda p, b: jtf.lm_loss(p, b, jcfg)), jparams, batch)(jparams, batch)
    grads = {}
    for dt in (torch.float32, torch.float64):
        tparams = tree_map(lambda t: t.to(dt).requires_grad_(True),
                           to_torch(nparams))
        tl = ttf.lm_loss(tparams, {k: v.to(dt) if v.is_floating_point()
                                   else v for k, v in th(batch).items()},
                         cfg)
        tl.backward()
        if dt == torch.float32:
            assert abs(tl.item() - float(jl)) < LOSS_ATOL
            if cfg.family == "moe":   # the routers learn from the aux loss
                router = tparams["layers"]["moe"]["router"].grad
                assert float(router.abs().max()) > 0
        grads[dt] = [t.grad.double().numpy() for t in tree_leaves(tparams)]
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert [w.shape for w in want] == [g.shape for g in grads[torch.float64]]
    scale = max(float(np.abs(w).max()) for w in want)

    def dist(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b)) / scale

    noise = dist(grads[torch.float32], grads[torch.float64])
    assert dist(want, grads[torch.float64]) <= GRAD_FACTOR * noise + GRAD_FLOOR
