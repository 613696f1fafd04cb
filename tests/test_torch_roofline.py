"""The port's roofline (``launch/roofline.py``) and the dry run's per-rank
argument bytes (``launch/dryrun.py::argument_bytes``) against the JAX
package's, on the CPU and without devices: ``model_flops_for`` equal to
JAX's for every config of ``configs/`` and every shape, the ``Roofline``
record's keys and arithmetic on the H100 data sheet, and the argument
bytes of params, optimizer state, batch and cache on the meshes (2, 4),
(16, 16) and (2, 16, 16) equal to the sum of JAX's
``NamedSharding(AbstractMesh, spec).shard_shape`` bytes."""
import math

import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import smoke_shape as jsmoke_shape
from repro.launch import roofline as jroof
from repro.launch import shardings as jshard
from repro.models import api as japi
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro.training import optimizer as jopt
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_shape
from repro_torch.kernels import checks
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving import engine, resources

ARCHS = list_archs()
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    pairs = [(JSHAPES[n], SHAPES[n]) for n in SHAPES] + \
        [(jsmoke_shape(k), smoke_shape(k)) for k in KINDS]
    for jshape, shape in pairs:
        want = jroof.model_flops_for(jcfg, jshape)
        got = roofline.model_flops_for(cfg, shape)
        assert got == want and isinstance(got, float), (shape.name, got,
                                                        want)


def test_roofline_keys_and_h100_arithmetic():
    r = roofline.Roofline(flops_per_dev=2.0e15, hbm_bytes_per_dev=1.0e12,
                          coll_bytes_per_dev=3.0e11, n_devices=4,
                          model_flops=6.0e15)
    j = jroof.Roofline(2.0e15, 1.0e12, 3.0e11, 4, 6.0e15)
    assert set(r.to_dict()) == set(j.to_dict())
    assert r.t_compute == 2.0e15 / 989e12
    assert r.t_memory == 1.0e12 / 3.35e12
    assert r.t_collective == 3.0e11 / 450e9
    assert r.bottleneck == "compute"      # 2.02 s > 0.67 s > 0.30 s
    assert r.useful_flops_ratio == 6.0e15 / (2.0e15 * 4)
    assert r.roofline_fraction == (6.0e15 / (4 * 989e12)) / r.t_compute
    d = r.to_dict()
    assert d["t_compute_s"] == r.t_compute and d["bottleneck"] == "compute"
    mem = roofline.Roofline(1.0, 1.0e12, 0.0, 1, 0.0)
    assert mem.bottleneck == "memory" and mem.roofline_fraction == 0.0
    coll = roofline.Roofline(1.0, 1.0, 1.0e12, 1, 0.0)
    assert coll.bottleneck == "collective"
    zero = roofline.Roofline(0.0, 0.0, 0.0, 1, 0.0)
    assert zero.useful_flops_ratio == 0.0 and zero.roofline_fraction == 0.0


def test_ring_factors_match_jax():
    for op in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "other"):
        for g in (1, 2, 3, 4, 16, 256):
            assert roofline._ring_factor(op, g) == jroof._ring_factor(op, g)


def test_h100_peaks_written_once():
    """The data sheet's figures, and every other user reads them here."""
    assert (roofline.PEAK_FLOPS, roofline.F32_FLOPS, roofline.HBM_BW,
            roofline.NVLINK_BW, roofline.HBM_BYTES) == (
        989e12, 67e12, 3.35e12, 450e9, 80e9)
    assert checks.HBM_BYTES_PER_S is roofline.HBM_BW
    assert checks.F32_FLOPS is roofline.F32_FLOPS
    hw = engine.ServingHardware()
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) == (
        roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES)
    assert resources.KVCompressionConfig().mem_bw == roofline.HBM_BW


def _jax_bytes(tree, shardings, jm) -> int:
    leaves, shs = list(_leaves(tree)), list(_leaves(shardings))
    assert len(leaves) == len(shs)
    total = 0
    for x, s in zip(leaves, shs):
        shard = NamedSharding(jm, s.spec).shard_shape(tuple(x.shape))
        total += math.prod(shard) * jnp.dtype(x.dtype).itemsize
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _jax_argument_bytes(jcfg, jshape, jm) -> dict:
    jdefs = jtf.model_defs(jcfg)
    params = jparam.abstract_params(jdefs)
    p_sh = jshard.params_shardings(jdefs, jm, jshape.kind)
    batch = japi.batch_struct(jcfg, jshape)
    out = {"params": _jax_bytes(params, p_sh, jm),
           "batch": _jax_bytes(batch, jshard.batch_shardings(batch, jm), jm)}
    if jshape.kind == "train":
        out["opt_state"] = _jax_bytes(jopt.abstract_opt_state(params),
                                      jshard.opt_shardings(p_sh), jm)
    else:
        cache = japi.cache_struct(jcfg, jshape)
        out["cache"] = _jax_bytes(cache, jshard.cache_shardings(cache, jcfg,
                                                                jm), jm)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_per_rank_match_jax(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jm, m = AbstractMesh(sizes, names), make_mesh(sizes, names)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in SHAPES:
        got = dryrun.argument_bytes(cfg, SHAPES[name], m)
        want = _jax_argument_bytes(jcfg, JSHAPES[name], jm)
        assert got == want, (name, got, want)


def test_argument_bytes_on_one_rank_are_the_inputs():
    """Mesh "1": every input whole, as the step record's arguments (the
    cache's index, an int32 scalar here, is a host int in the step)."""
    cfg = get_config("mistral-7b")
    m = make_mesh((1, 1), ("data", "model"))
    train = dryrun.argument_bytes(cfg, SHAPES["train_4k"], m)
    # f32 master, mu and nu of the bf16 params, and the int32 count
    assert train["opt_state"] == 6 * train["params"] + 4
    assert train["batch"] == 2 * 4 * 256 * 4096     # int32 tokens, targets
    rec = dryrun.run_cell("mistral-7b", "decode_32k", "1")
    parts = rec["memory"]["argument_bytes_by_input"]
    assert parts == dryrun.argument_bytes(cfg, SHAPES["decode_32k"], m)
    assert rec["memory"]["step_argument_bytes"] == sum(parts.values()) - 4
