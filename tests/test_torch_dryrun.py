"""The port's dry run (``launch/op_cost.py``, ``launch/dryrun.py``,
``launch/perf.py``) on the CPU: its op cost held to the JAX package's HLO
parser, its meta record to the same step on CPU tensors, its loop
awareness, the kernel wrappers on ``meta``, and the CLIs.

Op cost against ``repro.launch.hlo_cost.analyze_hlo``: the smoke configs
of the dense, moe and ssm families through prefill, gather decode and the
train step, jitted on one CPU device at XLA level 0 on the same abstract
inputs.  The port counts flops of the matrix products (mm, bmm, ...) as
each op runs; the parser counts ``dot`` instructions.  Prefill and decode
agree within 2% (they are equal).  The train step (fwd, remat's
recompute, bwd, AdamW) is equal for the dense family, and the other two
differ by what each framework writes as a matrix product in the
backward, which :func:`train_gap` states exactly:

- moe: the combine ``y[t, d] = sum_e w[t, e] out[t, e, d]`` is a batched
  product over the experts in both; its gradient with respect to the
  experts' outputs is an outer product ``dy[t, d] w[t, e]``, which torch's
  einsum backward runs as a bmm of contraction length 1 ((T, d, 1) @ (T,
  1, E): 2 T d E flops a layer), and XLA as a broadcast multiply (no
  dot).  The port counts 2 T d E more a MoE layer.
- ssm: the SSD scan's products without a contraction (``x * dt`` over
  the head dim P, the B and C terms with the decay over the state and the
  chunk) are einsums in JAX and elementwise products in the port; forward
  both multiply, but JAX's transposes of them are contractions that stay
  dots in the backward ((B, nc, Q, H, P) . (B, nc, Q, H, P) over P, and
  two of 16 = N = Q over the heads and the state: 2 T H (P + N + Q)
  flops a layer), which the port's autograd forms as mul and sum (no
  matrix product).  The port counts 2 T H (P + N + Q) fewer a layer.
"""
import dataclasses as dc
import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from families_common import compile_o0, one_torch_thread  # noqa: F401
from repro.configs import smoke_config as jsmoke_config
from repro.configs import smoke_shape as jsmoke_shape
from repro.launch.hlo_cost import analyze_hlo
from repro.models import api as japi
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro.training import optimizer as jopt
from repro.training import step as jstep
from repro_torch.configs import smoke_config, smoke_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import (_build, adapter_quant, checks, flash_decode,
                                 fused_decode, jd_apply, kv_quant, ops, ref,
                                 sgmv)
from repro_torch.launch import dryrun, op_cost, perf
from repro_torch.models import api, transformer as tf
from repro_torch.models.param import abstract_params, tree_map
from repro_torch.training.optimizer import abstract_opt_state, init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILY_ARCHS = ("mistral-7b", "granite-moe-3b-a800m", "mamba2-2.7b")
KINDS = ("prefill", "decode", "train")


def _jax_dot_flops(arch: str, kind: str) -> float:
    cfg, shape = jsmoke_config(arch), jsmoke_shape(kind)
    params = jparam.abstract_params(jtf.model_defs(cfg))
    batch = japi.batch_struct(cfg, shape)
    if kind == "train":
        fn = jstep.make_train_step(cfg, n_micro=1)
        args = (params, jopt.abstract_opt_state(params), batch)
    else:
        fn = (japi.make_prefill_fn(cfg) if kind == "prefill"
              else japi.make_decode_fn(cfg))
        args = (params, batch, japi.cache_struct(cfg, shape))
    return analyze_hlo(compile_o0(fn, *args).as_text())["dot_flops_per_dev"]


def train_gap(cfg, shape) -> int:
    """The port's matrix-product flops less the parser's dot flops on the
    train step (the module docstring says why)."""
    T = shape.global_batch * shape.seq_len
    if cfg.family == "moe":
        layers = cfg.num_layers - cfg.moe.first_k_dense
        return layers * 2 * T * cfg.d_model * cfg.moe.num_experts
    if cfg.family == "ssm":
        s = cfg.ssm
        H = s.n_heads(cfg.d_model)
        return -cfg.num_layers * 2 * T * H * (s.head_dim + s.d_state
                                              + s.chunk)
    return 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_matmul_flops_match_jax_hlo_parser(arch, kind):
    cfg, shape = smoke_config(arch), smoke_shape(kind)
    rec = dryrun.step_record(cfg, shape)
    want = _jax_dot_flops(arch, kind)
    mm = sum(r["flops"] for r in rec["by_op"].values())
    assert mm == rec["flops"] > 0 and not rec["kernels"]
    if kind == "train":
        assert mm - want == train_gap(cfg, shape), (mm, want)
    else:
        assert abs(mm - want) <= 0.02 * want, (mm, want)


def _draw(defs, seed: int):
    """The port's ParamDef tree drawn with numpy under its init rule, in
    each leaf's dtype, on the CPU."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init in ("zeros", "ones"):
            x = getattr(np, d.init)(d.shape, np.float32)
        else:
            fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
            std = d.scale if d.scale is not None else fan_in ** -0.5
            x = (std * rng.standard_normal(d.shape)).astype(np.float32)
        return torch.from_numpy(x).to(d.dtype)

    return tree_map(one, defs)


def _cpu_step(cfg, shape, index=None, n_micro=1):
    """(fn, args) of the cell's step on CPU tensors drawn with numpy."""
    params = _draw(tf.model_defs(cfg), 0)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, v.shape)
                                 .astype(np.int32))
             for k, v in api.batch_struct(cfg, shape).items()}
    cache = opt = None
    if shape.kind == "train":
        opt = init_opt_state(params)
    else:
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device="cpu")
        cache["index"] = dryrun.default_index(shape, index)
    return dryrun.step_and_args(cfg, shape, params, batch, cache, opt,
                                n_micro)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_record_equals_cpu_record(arch, kind):
    """The dispatch-mode record on meta is the step's on real tensors, op
    for op (count, flops, bytes, launches), and so is the peak."""
    cfg, shape = smoke_config(arch), smoke_shape(kind)
    meta = dryrun.step_record(cfg, shape)
    fn, args = _cpu_step(cfg, shape)
    cpu = op_cost.analyze_step(fn, *args)
    assert meta["device"] == "meta" and cpu["device"] == "cpu"
    assert op_cost.compare(meta, cpu) == []
    for key in ("flops", "bytes", "launches", "ops", "argument_bytes",
                "peak_bytes", "temp_bytes"):
        assert meta[key] == cpu[key], key
    assert meta["temp_bytes"] > 0 and meta["launches"] > 0


@pytest.mark.parametrize("arch", ("mistral-7b", "granite-moe-3b-a800m"))
def test_microbatch_count_extrapolates_exactly(arch):
    """4 microbatches counted from the runs at 2 and 3 equal the unrolled
    step's record: flops, bytes, every op, and the peak."""
    cfg = smoke_config(arch)
    shape = ShapeConfig("smoke_train_b4", 16, 4, "train")
    params = abstract_params(tf.model_defs(cfg))
    fn, meta_args = dryrun.step_and_args(
        cfg, shape, params, api.batch_struct(cfg, shape),
        opt_state=abstract_opt_state(params), n_micro=4)
    ext = op_cost.analyze_step(fn, *meta_args, n_micro=4)
    unrolled = op_cost.analyze_step(lambda *a: fn(*a, n_micro=4), *meta_args)
    assert ext["n_micro"] == 4 and unrolled["n_micro"] == 1
    assert op_cost.compare(ext, unrolled) == []
    for key in ("flops", "bytes", "launches", "ops", "peak_bytes"):
        assert ext[key] == unrolled[key], key
    two = op_cost.analyze_step(fn, *meta_args, n_micro=2)
    assert 0 < two["flops"] < ext["flops"]


def _attention_case(B, H, Kv, hd, S, kv_len, dtype):
    g = torch.Generator().manual_seed(0)
    return {"q": torch.randn((B, H, hd), generator=g).to(dtype),
            "k": torch.randn((B, S, Kv, hd), generator=g).to(dtype),
            "v": torch.randn((B, S, Kv, hd), generator=g).to(dtype),
            "kv_len": torch.tensor(kv_len, dtype=torch.int32)}


@pytest.mark.parametrize("S,dtype", [(64, torch.bfloat16),
                                     (600, torch.float32)])
def test_flash_decode_on_meta(monkeypatch, S, dtype):
    """The shapes and dtypes of the plain version's outputs, the launches
    of ``attention_launches``, the bound's bytes and flops on the valid
    rows, no launch counted and no library loaded."""
    def no_lib():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "lib", no_lib)
    case = _attention_case(2, 8, 2, 64, S, [S - 7, S // 2], dtype)
    meta = {k: v.to("meta") for k, v in case.items() if k != "kv_len"}
    before = flash_decode.LAUNCHES
    rec = op_cost.analyze_step(flash_decode.flash_decode, meta["q"],
                               meta["k"], meta["v"], case["kv_len"])
    outs = flash_decode.flash_decode(meta["q"], meta["k"], meta["v"],
                                     case["kv_len"])
    want = ref.flash_decode_ref(case["q"], case["k"], case["v"],
                                case["kv_len"])
    for o, w in zip(outs, want):
        assert o.device.type == "meta"
        assert (o.shape, o.dtype) == (w.shape, w.dtype)
    assert flash_decode.LAUNCHES == before
    assert rec["kernels"] == {"flash_decode": {
        "count": 1, "launches": flash_decode.attention_launches(S),
        "bytes": checks.attention_bytes(case),
        "flops": checks.attention_flops(case)}}
    assert rec["by_op"] == {}                 # the outputs: not ops
    assert rec["launches"] == flash_decode.attention_launches(S)
    with pytest.raises(ValueError, match="kv_len"):
        flash_decode.flash_decode(meta["q"], meta["k"], meta["v"],
                                  case["kv_len"].to("meta"))


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


OTHER_WRAPPERS = {
    "flash_decode_paged": lambda: flash_decode.flash_decode_paged(
        _m(2, 8, 64), _m(4, 16, 2, 64), _m(4, 16, 2, 64), _i32(2, 2),
        _i32(2)),
    "fused_decode_lora": lambda: fused_decode.fused_decode_lora(
        _m(2, 8, 64), _m(2, 32, 2, 64), _m(2, 32, 2, 64), _i32(2), _i32(2),
        _m(3, 4, 512), _m(3, 256, 4)),
    "fused_decode_lora_paged": lambda: fused_decode.fused_decode_lora_paged(
        _m(2, 8, 64), _m(4, 16, 2, 64), _m(4, 16, 2, 64), _i32(2, 2),
        _i32(2), _i32(2), _m(3, 4, 512), _m(3, 256, 4)),
    "fused_decode_jd": lambda: fused_decode.fused_decode_jd(
        _m(2, 8, 64), _m(2, 32, 2, 64), _m(2, 32, 2, 64), _i32(2), _i32(2),
        _m(1, 256, 4), _m(1, 512, 4), _m(3, 4), _i32(3)),
    "fused_decode_jd_paged": lambda: fused_decode.fused_decode_jd_paged(
        _m(2, 8, 64), _m(4, 16, 2, 64), _m(4, 16, 2, 64), _i32(2, 2),
        _i32(2), _i32(2), _m(1, 256, 4), _m(1, 512, 4), _m(3, 4), _i32(3)),
    "adapter_quantize": lambda: adapter_quant.adapter_quantize(_m(3, 4, 64)),
    "adapter_dequantize": lambda: adapter_quant.adapter_dequantize(
        _m(3, 4, 64, dtype=torch.int8), _m(3, 4, 1, dtype=torch.float32)),
    "adapter_dequantize_group": lambda: adapter_quant.adapter_dequantize_group(
        [(_m(3, 4, 64, dtype=torch.int8), _m(3, 4, 1, dtype=torch.float32))]),
    "sgmv_shrink": lambda: sgmv.sgmv_shrink(_m(16, 64), _m(2, 4, 64),
                                            _i32(2), block_t=8),
    "sgmv_expand": lambda: sgmv.sgmv_expand(_m(16, 4), _m(2, 64, 4),
                                            _i32(2), block_t=8),
    "sigma_bmm": lambda: sgmv.sigma_bmm(_m(16, 4), _m(2, 4, 4), _i32(2),
                                        block_t=8),
    "jd_shrink_scale": lambda: jd_apply.jd_shrink_scale(
        _m(16, 64), _m(1, 64, 4), _m(16, 4), _i32(2), block_t=8),
    "jd_apply": lambda: jd_apply.jd_apply(
        _m(16, 64), _m(1, 32, 4), _m(1, 64, 4), _m(2, 4), _i32(16),
        _i32(2), _i32(2)),
    "kv_quantize": lambda: kv_quant.kv_quantize(_m(128, 64)),
    "kv_dequantize": lambda: kv_quant.kv_dequantize(
        _m(128, 64, dtype=torch.int8), _m(1, 64, dtype=torch.float32)),
    "lora_apply": lambda: ops.lora_apply(_m(16, 64), _m(2, 4, 64),
                                         _m(2, 32, 4), _i32(16)),
    "lora_apply_grouped": lambda: ops.lora_apply_grouped(
        _m(16, 64), _m(2, 4, 64), _m(2, 32, 4), _i32(16)),
    "jd_apply_grouped": lambda: ops.jd_apply_grouped(
        _m(16, 64), _m(1, 32, 4), _m(1, 64, 4), _m(2, 4), _i32(2),
        _i32(16)),
}


@pytest.mark.parametrize("name", sorted(OTHER_WRAPPERS))
def test_other_wrappers_refuse_meta(monkeypatch, name):
    def no_lib():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "lib", no_lib)
    with pytest.raises(ValueError, match=rf"^{name}: a meta tensor"):
        OTHER_WRAPPERS[name]()


def test_ops_jd_apply_refuses_meta():
    with pytest.raises(ValueError, match=r"^jd_apply: a meta tensor"):
        ops.jd_apply(_m(16, 64), _m(1, 32, 4), _m(1, 64, 4), _m(2, 4),
                     _i32(2), _i32(16))


@pytest.mark.parametrize("S", [64, 600])
def test_lazy_decode_on_meta_records_row1_launches(S):
    """The lazy smoke decode on meta: one flash_decode call a layer, each
    the launches ``attention_launches`` gives for the cache, at the
    bound's bytes for the valid rows (index + 0: the new token joins
    outside the kernel)."""
    cfg = dc.replace(smoke_config("mistral-7b"), decode_attn="lazy")
    shape = ShapeConfig("smoke_decode_lazy", S, 2, "decode")
    rec = dryrun.step_record(cfg, shape, index=S - 5)
    k = rec["kernels"]["flash_decode"]
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    assert k["count"] == L
    assert k["launches"] == L * flash_decode.attention_launches(S)
    case = {"q": torch.empty((2, H, hd)),
            "k": torch.empty((2, S, cfg.num_kv_heads, hd),
                             dtype=torch.bfloat16),
            "kv_len": torch.full((2,), S - 5, dtype=torch.int32)}
    assert k["bytes"] == L * checks.attention_bytes(case)
    assert k["flops"] == L * checks.attention_flops(case)
    gather = dryrun.step_record(smoke_config("mistral-7b"), shape,
                                index=S - 5)
    assert not gather["kernels"]
    assert gather["bytes"] > rec["bytes"]      # the per-layer cache copies


def test_collectives_recorded():
    """c10d ops are counted, with the ring bytes of the group's size (a
    one-rank gloo group moves nothing)."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        import torch.distributed._functional_collectives as funcol

        def step(x):
            dist.all_reduce(x)
            out = torch.empty(8)
            dist.all_gather_into_tensor(out, x)
            y = funcol.all_reduce(x, "sum", dist.group.WORLD)
            return out * 2 + y
        rec = op_cost.analyze_step(step, torch.ones(8))
    finally:
        dist.destroy_process_group()
    assert rec["collectives"] == {"counts": {"all-reduce": 2,
                                             "all-gather": 1},
                                  "bytes_moved": 0.0}
    assert rec["by_op"]["aten.mul.Tensor"]["bytes"] == 64


def _run(*args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_dryrun_cli(tmp_path):
    p = _run("repro_torch.launch.dryrun", "--arch", "qwen3-1.7b", "--shape",
             "decode_32k", "--out", str(tmp_path))
    assert p.returncode == 0, p.stderr[-2000:]
    assert "device: none" in p.stdout
    rec = json.loads((tmp_path / "qwen3-1.7b__decode_32k__mesh1.json")
                     .read_text())
    assert rec["ok"] and rec["step"] == "meta"
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert isinstance(rec["fits"], bool) and not rec["fits"]
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]
    assert rec["op_cost"]["flops"] > 0 and rec["op_cost"]["top"]


def _jax_launch_module(name: str):
    """``repro.launch.<name>``, whose import sets XLA_FLAGS for its own
    process: put back as it was (no JAX backend starts here)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def test_skips_meshes_and_names_follow_jax():
    jdry = _jax_launch_module("dryrun")
    for arch, shape in (("qwen3-32b", "long_500k"), ("mamba2-2.7b",
                                                     "long_500k"),
                        ("qwen3-1.7b", "decode_32k")):
        cfg = dryrun.get_config(arch)
        want = jdry.skip_reason(jdry.get_config(arch),
                                jdry.SHAPES[shape])
        assert dryrun.skip_reason(cfg, dryrun.SHAPES[shape]) == want
    rec = dryrun.run_cell("qwen3-32b", "long_500k")
    assert rec["skipped"] and rec["ok"] and rec["reason"] == jdry.skip_reason(
        jdry.get_config("qwen3-32b"), jdry.SHAPES["long_500k"])
    for mesh, multi in (("16x16", False), ("2x16x16", True)):
        assert dryrun.cell_name("a", "s", mesh) == jdry.cell_name("a", "s",
                                                                  multi)
    one = dryrun.run_cell("qwen3-1.7b", "decode_32k", "1x4")
    assert one["step"] is None and "no sharded step" in one["step_reason"]
    assert "roofline" not in one and "peak_bytes" not in one["memory"]
    full = dryrun.argument_bytes(dryrun.get_config("qwen3-1.7b"),
                                 dryrun.SHAPES["decode_32k"],
                                 dryrun._mesh("1"))
    assert 0 < one["memory"]["argument_bytes"] < sum(full.values())
    with pytest.raises(ValueError, match="mesh"):
        dryrun.run_cell("qwen3-1.7b", "decode_32k", "3x3")
    assert dryrun.RESULTS_DIR == ROOT / "results" / "dryrun_torch"
    assert perf.RESULTS_DIR == ROOT / "results" / "perf_torch"


def test_perf_cli(tmp_path):
    jperf = _jax_launch_module("perf")
    assert perf.VARIANTS == jperf.VARIANTS
    p = _run("repro_torch.launch.perf", "--out", str(tmp_path), "--layers",
             "1")
    assert p.returncode == 0, p.stderr[-2000:]
    names = {f"{a}__{s}__{v[0]}.json" for (a, s), vs in perf.VARIANTS.items()
             for v in vs}
    assert {f.name for f in tmp_path.iterdir()} == names
    applies = {}
    for f in tmp_path.iterdir():
        rec = json.loads(f.read_text())
        assert rec["ok"], rec.get("error")
        applies[rec["variant"], rec["arch"]] = rec["applies"]
        if rec["applies"]:
            assert rec["layers"] == 1 and rec["roofline"]["bottleneck"]
        else:
            assert rec["reason"] and "roofline" not in rec
    assert not applies["v1_cp_attn", "granite-moe-3b-a800m"]
    assert not applies["v1_seqshard_decode", "qwen3-32b"]
    assert applies["v3_lazy_cache_write", "qwen3-32b"]
    assert applies["v4_micro4_chunk4k", "mistral-large-123b"]
    lazy = json.loads((tmp_path / "qwen3-32b__decode_32k__"
                       "v3_lazy_cache_write.json").read_text())
    assert lazy["op_cost"]["kernels"]["flash_decode"]["count"] == 1
