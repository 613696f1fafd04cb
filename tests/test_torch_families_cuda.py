"""The model families on the card against the CPU: the reduced f32 check
of chip_smoke.py phase 9 (a) on two families (MoE and hybrid).

Marked ``gpu``: they skip where there is no CUDA device, and run on the
H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_families_cuda.py

This file imports neither jax nor the JAX package; whether a card is
present is decided inside the ``cuda`` fixture, never at import.
"""
import pytest
import torch

from repro_torch.launch.families import card_vs_cpu

pytestmark = pytest.mark.gpu

# f32 weights, activations and cache on both sides, TF32 off: the CPU
# tests' logit tolerance against the JAX package
ATOL = 1e-4


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-2.7b"])
def test_card_matches_cpu(arch, cuda):
    r = card_vs_cpu(arch, cuda)
    assert r["finite"]
    assert r["max_abs_diff"] < ATOL, r
    assert r["routes_equal"], r
    if arch.startswith("granite"):
        assert r["moe_calls"] > 0 and r["min_topk_margin"] > 0
