"""The model sharded over a mesh, moe and ssm families
(granite-moe-3b-a800m, mamba2-2.7b): ``launch/shardings.py::
sharded_step_for`` against the JAX package's ``jax.jit(step,
in_shardings=...)`` on fake devices, as ``tests/spmd_common.py`` sets out
(the dense family and the checkpoints: tests/test_torch_spmd.py)."""
import pytest

import spmd_common as sc

ARCHS = ("granite-moe-3b-a800m", "mamba2-2.7b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sc.run_all(str(tmp_path_factory.mktemp("spmd_fam")), ARCHS,
                      False)


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
