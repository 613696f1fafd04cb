"""The port's abstract trees, parameter counts and partition specs against
the JAX package's, on the CPU: every config of ``configs/`` and every
shape of ``configs/base.py``, on the meshes (2, 4), (16, 16) and
(2, 16, 16).  JAX's side resolves on an ``AbstractMesh`` (no devices);
the port's on a mesh description."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import smoke_shape as jsmoke_shape
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.launch import shardings as jshard
from repro.models import api as japi
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro.training import optimizer as jopt
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_shape
from repro_torch.convert import to_rank
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tshard
from repro_torch.models import api as tapi
from repro_torch.models import param as tparam
from repro_torch.models import transformer as ttf
from repro_torch.training import optimizer as topt

ARCHS = list_archs()
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPE_NAMES = sorted(SHAPES) + ["smoke_train", "smoke_prefill",
                                "smoke_decode"]


def _cells(cfg):
    """The shape names of the config's cells: every shape, less a vlm
    prompt too short for its patches (the smoke shapes' 64 tokens against
    pixtral-12b's 1024)."""
    return [n for n in SHAPE_NAMES
            if not (cfg.family == "vlm" and _shapes(n)[1].kind != "decode"
                    and _shapes(n)[1].seq_len <= cfg.vlm.num_patches)]


def _shapes(name):
    if name.startswith("smoke_"):
        kind = name.split("_")[1]
        return jsmoke_shape(kind), smoke_shape(kind)
    return JSHAPES[name], SHAPES[name]


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


def _same_structs(port, jax_tree):
    """Meta tensors against ShapeDtypeStructs: the same paths, shapes and
    dtypes."""
    p, j = _flat(port), _flat(jax_tree)
    assert set(p) == set(j)
    for path in j:
        assert p[path].device.type == "meta", path
        assert tuple(p[path].shape) == tuple(j[path].shape), path
        assert _dtype_name(p[path].dtype) == _dtype_name(j[path].dtype), path


def _same_specs(port, jax_tree):
    """Port specs (or NamedShardings) against JAX's, as tuples."""
    p, j = _flat(port), _flat(jax_tree)
    assert set(p) == set(j)
    for path in j:
        ps = p[path].spec if isinstance(p[path], tsh.NamedSharding) \
            else p[path]
        js = j[path].spec if hasattr(j[path], "spec") else j[path]
        assert isinstance(ps, tsh.P), path
        assert tuple(ps) == tuple(js), (path, ps, js)


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_abstract_trees_match_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jdefs, defs = jtf.model_defs(jcfg), ttf.model_defs(cfg)
    n = tparam.count_defs(defs)
    assert isinstance(n, int) and n == jparam.count_defs(jdefs) > 0
    for override in (None, torch.float32):
        _same_structs(tparam.abstract_params(defs, dtype_override=override),
                      jparam.abstract_params(
                          jdefs, dtype_override=None if override is None
                          else jnp.float32))
    abstract = tparam.abstract_params(defs)
    _same_structs(topt.abstract_opt_state(abstract),
                  jopt.abstract_opt_state(jparam.abstract_params(jdefs)))
    for name in _cells(cfg):
        jshape, shape = _shapes(name)
        _same_structs(tapi.batch_struct(cfg, shape),
                      japi.batch_struct(jcfg, jshape))
        _same_structs(tapi.input_specs(cfg, shape),
                      japi.input_specs(jcfg, jshape))
        c = tapi.cache_struct(cfg, shape)
        if shape.kind == "train":
            assert c is None and japi.cache_struct(jcfg, jshape) is None
        else:
            _same_structs(c, japi.cache_struct(jcfg, jshape))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_shardings_match_jax(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jm, m = AbstractMesh(sizes, names), tmesh.make_mesh(sizes, names)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jdefs, defs = jtf.model_defs(jcfg), ttf.model_defs(cfg)
    specs = tparam.param_specs(defs, m)
    jspecs = jparam.param_specs(jdefs, jm)
    _same_specs(specs, jspecs)
    _same_specs(tparam.param_shardings(defs, m),
                jparam.param_specs(jdefs, jm))
    _same_specs(topt.opt_state_specs(specs), jopt.opt_state_specs(jspecs))
    for kind in ("train", "serve"):
        sh = tshard.params_shardings(defs, m, kind)
        jsh_ = jshard.params_shardings(jdefs, jm, kind)
        _same_specs(sh, jsh_)
        _same_specs(tshard.opt_shardings(sh), jshard.opt_shardings(jsh_))
    with tsh.use_mesh(m):             # the current mesh by default
        _same_specs(tparam.param_specs(defs), jspecs)
    for name in _cells(cfg):
        jshape, shape = _shapes(name)
        _same_specs(tshard.batch_shardings(tapi.batch_struct(cfg, shape), m),
                    jshard.batch_shardings(japi.batch_struct(jcfg, jshape),
                                           jm))
        if shape.kind != "train":
            _same_specs(
                tshard.cache_shardings(tapi.cache_struct(cfg, shape), cfg, m),
                jshard.cache_shardings(japi.cache_struct(jcfg, jshape), jcfg,
                                       jm))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_helpers_match_jax(mesh_name):
    sizes, names = MESHES[mesh_name]
    jm, m = AbstractMesh(sizes, names), tmesh.make_mesh(sizes, names)
    assert tmesh.mesh_description(m) == jmesh.mesh_description(jm)
    assert tuple(tsh.batch_spec(m)) == tuple(jsh.batch_spec(jm))
    rules = {"d_model": "model", "heads": None}
    cases = [((64, 48, 128), ("batch", "heads", "head_dim")),
             ((24, 8, 4096), ("heads", "kv_heads", "d_model")),   # 24 % 16
             ((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None)),
             ((64, 4096, 14336), ("experts", "d_model", "expert_ff")),
             ((60, 4096, 1408), ("experts", "d_model", "expert_ff")),
             ((4096, 4096), ("d_model", "d_model"))]
    for shape, axes in cases:
        for r in (None, rules):
            assert tuple(tsh.spec_for(shape, axes, m, r and {
                **tsh.DEFAULT_RULES, **r})) == tuple(jsh.spec_for(
                    shape, axes, jm, r and {**jsh.DEFAULT_RULES, **r}))
    assert tsh.spec_for((4, 4), ("batch", None)) == tsh.P()   # no mesh
    with tsh.use_mesh(m, rules):
        assert tsh.current_mesh() is m
        assert tuple(tsh.spec_for((4096, 4096), ("d_model", None))) == \
            tuple(jsh.spec_for((4096, 4096), ("d_model", None), jm,
                               {**jsh.DEFAULT_RULES, **rules}))
        x = torch.ones(4, 4)
        assert tsh.constrain(x, "batch", None) is x   # plain tensor: identity
    assert tsh.current_mesh() is None


def test_elastic_and_production_meshes():
    assert tmesh.make_production_mesh() == tmesh.make_mesh(
        (16, 16), ("data", "model"))
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert tmesh.make_mesh_for(8, 2).shape == {"data": 4, "model": 2}
    assert tmesh.make_mesh_for(16, 2, pods=2).shape == {
        "pod": 2, "data": 4, "model": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh_for(6, 4)
    with pytest.raises(ValueError, match="description"):
        tmesh.make_mesh_for(4, 2).group("model")


def test_placements_local_blocks_and_rank_shards():
    """A spec's placements, and the blocks of all ranks tile an array once;
    ``to_rank`` hands each rank its block."""
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"))
    spec = tsh.P(("pod", "data"), "model", None)
    assert tsh.placements(spec, m) == [Shard(0), Shard(0), Shard(1)]
    assert tsh.placements(tsh.P(None, None), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        tsh.placements(tsh.P(("data", "pod")), m)
    a = np.arange(8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    seen = np.zeros_like(a)
    sharding = tsh.NamedSharding(m, spec)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                coords = {"pod": pod, "data": data, "model": model}
                block = tsh.local_block(a.shape, spec, m, coords)
                got = to_rank({"w": a}, {"w": sharding}, coords)["w"]
                assert tuple(got.shape) == sharding.local_shape(a.shape) \
                    == (2, 3, 3)
                assert np.array_equal(got.numpy(), a[block])
                # pod splits first: rank (pod, data) holds rows 4 pod + 2 data
                assert block[0].start == 4 * pod + 2 * data
                seen[block] += 1
    assert (seen == 1).all()            # 8 ranks, 8 disjoint blocks
