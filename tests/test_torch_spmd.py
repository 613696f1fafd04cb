"""The model sharded over a mesh, dense family (mistral-7b, qwen3-1.7b):
``launch/shardings.py::sharded_step_for`` (the step functions on DTensors
under the serve and train rules) against the JAX package's
``jax.jit(step, in_shardings=...)`` on fake devices, as
``tests/spmd_common.py`` sets out; and on the same gloo groups the
sharded checkpoint's elastic restore and the refusals.

- A checkpoint saved from DTensors on (2, 2) restores on (1, 2) bit for
  bit, JAX restores it, and the port restores one JAX saved from its
  (2, 2) mesh.
- Inside the sharded step a kernel wrapper refuses a DTensor and
  ``constrain`` a plain tensor.
- The sharded train step over two microbatches equals the replicated
  one over the same two.
- JAX's expert-parallel MoE gradient fault, pinned.

tests/test_torch_spmd_families.py runs the moe and ssm families.
"""
import numpy as np
import pytest
import torch

import spmd_common as sc
from spmd_common import _at

ARCHS = ("mistral-7b", "qwen3-1.7b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sc.run_all(str(tmp_path_factory.mktemp("spmd")), ARCHS, True)


@pytest.mark.parametrize("world", sorted(sc.MESHES))
@pytest.mark.parametrize("arch,kind", sc.cases(ARCHS))
def test_serve_step_shards_match_jax(runs, arch, kind, world):
    sc.check_serve(runs, arch, kind, world)


@pytest.mark.parametrize("world", sorted(sc.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_shards_match_jax(runs, arch, world):
    sc.check_train(runs, arch, world)


@pytest.mark.parametrize("world", sorted(sc.MESHES))
@pytest.mark.parametrize("kind", ("prefill", "decode", "train"))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_bytes_equal_dryrun_argument_bytes(runs, arch, kind, world):
    sc.check_bytes(runs, arch, kind, world)


@pytest.mark.parametrize("world", sorted(sc.MESHES))
def test_microbatched_train_step_matches_replicated(runs, world):
    """Two microbatches (the batch gathered, then split as the replicated
    step splits it) against the port's replicated step over the same two,
    at tests/test_torch_training.py's one-step tolerances."""
    for r in runs["steps"][world]:
        assert float(r["micro/dloss"]) <= sc.LOSS_ATOL
        assert float(r["micro/dmu"]) <= sc.GRAD_TOL * float(r["micro/mu_max"])


@pytest.mark.parametrize("source", ("port_dir", "jax_dir"))
def test_elastic_restore_bit_for_bit(runs, source):
    """Saved on (2, 2) (by the port, or by JAX), restored on (1, 2): each
    rank's block equals the saved array's there, bit for bit; JAX's
    restore of the port's checkpoint equals the arrays."""
    inp = runs["inp"]
    e_bits = torch.from_numpy(inp["ck/e"]).to(torch.bfloat16).view(
        torch.int16).numpy()
    for r in runs["restore"][source]:
        for name, full in (("w", inp["ck/w"]), ("b/e", e_bits),
                           ("count", inp["ck/count"])):
            local, off = r[name], r[name + "@off"]
            assert local.dtype == full.dtype, (name, local.dtype)
            assert np.array_equal(local, _at(full, local, off)), (source,
                                                                  name)
    jx = runs["jax"]
    assert np.array_equal(jx["ck/w"], inp["ck/w"])
    assert np.array_equal(jx["ck/e"].view(np.int16), e_bits)
    assert int(jx["ck/count"]) == int(inp["ck/count"])


@pytest.mark.parametrize("name", ("flash_decode", "lora_apply", "constrain"))
def test_wrong_kind_of_tensor_raises_inside_sharded_step(runs, name):
    for r in runs["refuse"]:
        assert "refused." + name in r, sorted(r)
        assert bool(r["outside.constrain"])


def test_jax_moe_token_gradient_loses_the_model_sum(runs):
    """The reference fault the moe train step steps round: JAX's
    ``_moe_ep`` under ``shard_map`` gives the tokens' gradient without the
    sum of the model ranks' parts, so on a model axis of 2 it differs from
    the same function's gradient on a model axis of 1 (its forward does
    not differ)."""
    one, two = runs["jax"]["moe/dx/1x1"], runs["jax"]["moe/dx/1x2"]
    assert np.abs(one - two).max() > 0.1 * np.abs(one).max()
