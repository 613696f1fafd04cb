"""Dry run of one (arch x shape x mesh) cell on the H100 model (the port
of ``launch/dryrun.py``): does the step fit one card, and how far is it
from the card's roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape decode_32k --out /tmp/dryrun_torch

The JAX tool compiles the step for a TPU mesh and reads XLA's cost and
memory analyses.  Here the step (``models/api.py``'s step functions at the
config's full width and depth) runs on ``meta`` tensors under
``launch/op_cost.py``'s dispatch mode: what each op would read, write and
compute on the card, the live bytes by storage lifetime, and the port's
kernels (``flash_decode`` under ``decode_attn="lazy"``) at their own
bound's arithmetic.  No device is used, and the record says so.

A record holds ``params`` and ``active_params``; ``memory``: the
per-rank ``argument_bytes`` of params, optimizer state, batch and cache
under ``launch/shardings.py`` (XLA's ``argument_size_in_bytes``), and
the step's ``peak_bytes`` and ``temp_bytes`` (peak less the arguments)
with ``fits`` (peak <= ``roofline.HBM_BYTES``); ``op_cost``,
``collectives`` and ``roofline`` (``launch/roofline.py``, H100 data
sheet).  Decode takes the cache's ``index`` as a host integer,
``seq_len - 1``; prefill 0.  On a mesh of more than one rank these are
rank 0's: the sharded step (``launch/shardings.py::sharded_step_for``,
DTensors under the serve or train rules) runs on ``meta`` tensors as
rank 0 of a fake process group of the mesh's size, in this one process
(:func:`fake_group`): its local ops, its collectives, its peak.

:func:`measure_cell` runs the same step on the card and returns its
readings beside this prediction at the same depth.

The CLI writes one JSON file a cell under ``results/dryrun_torch/`` by
default; it never writes ``results/dryrun/``, whose files belong to the
JAX tool's sweep.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from ..configs import SHAPES, get_config, list_archs
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import local_shape
from ..models import api, transformer as tf
from ..models.param import abstract_params, tree_leaves
from ..training.optimizer import abstract_opt_state, init_opt_state
from ..training.step import auto_microbatches, make_train_step
from . import op_cost
from . import shardings as sh
from .mesh import device_mesh, make_mesh, mesh_description
from .roofline import HBM_BYTES, Roofline, model_flops_for

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# the meshes by name: one card, one host of four (tensor parallel, and
# JAX's make_mesh_for(4, model_parallel=2)), a pod, two pods
MESHES = {"1": ((1, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("long_500k needs sub-quadratic attention; skipped for pure "
                "full-attention archs (DESIGN.md §4)")
    return None


def cell_name(arch: str, shape: str, mesh: str = "1") -> str:
    tag = {"16x16": "pod16x16", "2x16x16": "pod2x16x16"}.get(mesh,
                                                             "mesh" + mesh)
    return f"{arch}__{shape}__{tag}"


def _mesh(name: str):
    if name not in MESHES:
        raise ValueError(f"mesh {name!r}: one of {sorted(MESHES)}")
    return make_mesh(*MESHES[name])


def _tree_bytes(tree, shardings, mesh) -> int:
    total = 0
    for t, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        n = 1
        for d in local_shape(t.shape, s.spec, mesh):
            n *= d
        total += n * t.element_size()
    return total


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Per-rank bytes of the step's inputs under the cell's shardings:
    params and opt_state (train) or cache (prefill, decode), and batch."""
    defs = tf.model_defs(cfg)
    params = abstract_params(defs)
    p_sh = sh.params_shardings(defs, mesh, shape.kind)
    batch = api.batch_struct(cfg, shape)
    out = {"params": _tree_bytes(params, p_sh, mesh),
           "batch": _tree_bytes(batch, sh.batch_shardings(batch, mesh),
                                mesh)}
    if shape.kind == "train":
        out["opt_state"] = _tree_bytes(abstract_opt_state(params),
                                       sh.opt_shardings(p_sh), mesh)
    else:
        cache = api.cache_struct(cfg, shape)
        out["cache"] = _tree_bytes(cache, sh.cache_shardings(cache, cfg,
                                                             mesh), mesh)
    return out


def _n_micro(cfg, shape, n_micro_override, mesh=None):
    """JAX's choice: the batch shards and the model axis (the sequence
    sharding of the rematted layer inputs) of the mesh."""
    if shape.kind != "train":
        return 1
    if n_micro_override is not None:
        return n_micro_override
    n_batch = seq = 1
    if mesh is not None:
        n_batch = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
        seq = mesh.shape.get("model", 1)
    return auto_microbatches(cfg, shape, n_batch, seq_shard=seq)


@contextlib.contextmanager
def fake_group(mesh):
    """``mesh`` with a DeviceMesh over a fake process group of its size,
    this process its rank 0: collectives return at once and move nothing,
    so a sharded step on ``meta`` tensors runs as rank 0 would run it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield device_mesh(mesh, "cpu")
    finally:
        dist.destroy_process_group()


def step_and_args(cfg: ModelConfig, shape: ShapeConfig, params, batch,
                  cache=None, opt_state=None, n_micro: int = 1):
    """(fn, args) of the cell's step for :func:`op_cost.analyze_step`: the
    train step (over ``n_micro`` microbatches of the batch, ``fn`` taking
    ``n_micro=k`` for the first k of them) or the serve step."""
    if shape.kind != "train":
        return api.step_fn_for(cfg, shape), (params, batch, cache)
    if n_micro <= 1:
        return make_train_step(cfg), (params, opt_state, batch)
    b = shape.global_batch // n_micro

    def fn(params, opt_state, batch, n_micro):
        part = {k: v[:n_micro * b] for k, v in batch.items()}
        return make_train_step(cfg, n_micro=n_micro)(params, opt_state,
                                                     part)

    return fn, (params, opt_state, batch)


def sharded_step_and_args(cfg: ModelConfig, shape: ShapeConfig, mesh,
                          index: Optional[int] = None, n_micro: int = 1):
    """(fn, args) of the cell's sharded step on ``meta`` DTensors placed on
    ``mesh`` (which carries a DeviceMesh), as :func:`step_and_args`."""
    params = abstract_params(tf.model_defs(cfg))
    trees = {"params": params, "batch": api.batch_struct(cfg, shape)}
    if shape.kind == "train":
        trees["opt_state"] = abstract_opt_state(params)
    else:
        trees["cache"] = api.cache_struct(cfg, shape)
        trees["cache"]["index"] = default_index(shape, index)
    placed = sh.place_inputs(cfg, shape, mesh, **trees)
    if shape.kind != "train":
        return (sh.sharded_step_for(cfg, shape, mesh),
                (placed["params"], placed["batch"], placed["cache"]))
    args = (placed["params"], placed["opt_state"], placed["batch"])
    if n_micro <= 1:
        return sh.sharded_step_for(cfg, shape, mesh), args
    b = shape.global_batch // n_micro

    def fn(params, opt_state, batch, n_micro):
        part = {k: v[:n_micro * b] for k, v in batch.items()}
        return sh.sharded_step_for(cfg, shape, mesh, n_micro=n_micro)(
            params, opt_state, part)

    return fn, args


def step_record(cfg: ModelConfig, shape: ShapeConfig,
                index: Optional[int] = None, n_micro: int = 1,
                mesh=None) -> dict:
    """``op_cost.analyze_step`` of the cell's step on ``meta`` tensors;
    ``index`` the decode cache's (default ``seq_len - 1``).  On a
    ``mesh`` of more than one rank (with a DeviceMesh: :func:`fake_group`)
    the sharded step's, as the rank of this process runs it."""
    if mesh is not None and mesh.size > 1:
        fn, args = sharded_step_and_args(cfg, shape, mesh, index, n_micro)
        return op_cost.analyze_step(fn, *args, n_micro=n_micro)
    defs = tf.model_defs(cfg)
    params = abstract_params(defs)
    batch = api.batch_struct(cfg, shape)
    cache = opt = None
    if shape.kind == "train":
        opt = abstract_opt_state(params)
    else:
        cache = api.cache_struct(cfg, shape)
        cache["index"] = default_index(shape, index)
    fn, args = step_and_args(cfg, shape, params, batch, cache, opt, n_micro)
    return op_cost.analyze_step(fn, *args, n_micro=n_micro)


def default_index(shape: ShapeConfig, index: Optional[int] = None) -> int:
    if index is not None:
        return index
    return shape.seq_len - 1 if shape.kind == "decode" else 0


OP_COST_KEYS = ("flops", "bytes", "launches", "ops", "n_micro", "kernels",
                "top", "by_op")


def predict(cfg: ModelConfig, shape: ShapeConfig, index: Optional[int] = None,
            n_micro: int = 1, mesh=None) -> dict:
    """The step part of a record, per rank: memory, fits, op_cost (the
    step's ``op_cost`` record less its memory), collectives, roofline and
    its bound (one card, or rank 0 of ``mesh``: :func:`step_record`)."""
    r = step_record(cfg, shape, index, n_micro, mesh)
    roof = Roofline(flops_per_dev=r["flops"], hbm_bytes_per_dev=r["bytes"],
                    coll_bytes_per_dev=r["collectives"]["bytes_moved"],
                    n_devices=mesh.size if mesh is not None else 1,
                    model_flops=model_flops_for(cfg, shape))
    return {
        "memory": {"peak_bytes": r["peak_bytes"],
                   "temp_bytes": r["temp_bytes"],
                   "step_argument_bytes": r["argument_bytes"]},
        "fits": r["peak_bytes"] <= HBM_BYTES,
        "op_cost": {k: r[k] for k in OP_COST_KEYS},
        "collectives": r["collectives"],
        "roofline": roof.to_dict(),
        "bound_ms": 1e3 * max(roof.t_compute, roof.t_memory,
                              roof.t_collective),
    }


def run_cell(arch: str, shape_name, mesh: str = "1",
             cfg_overrides: dict | None = None,
             n_micro_override: int | None = None) -> dict:
    """The dry-run record of one cell (``shape_name`` a key of ``SHAPES``
    or a ``ShapeConfig``)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh,
                 "kind": shape.kind, "ok": False,
                 "device": "none: meta tensors (shapes only), costs "
                           "modelled on the H100 data sheet"}
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(skipped=True, reason=reason, ok=True)
        return rec
    m = _mesh(mesh)
    rec["mesh_info"] = mesh_description(m)
    t0 = time.time()
    parts = argument_bytes(cfg, shape, m)
    rec["memory"] = {"argument_bytes": sum(parts.values()),
                     "argument_bytes_by_input": parts}
    rec["params"] = cfg.param_count()
    rec["active_params"] = cfg.active_param_count()
    n_micro = _n_micro(cfg, shape, n_micro_override, m)
    rec["n_micro"] = n_micro
    if shape.kind != "train":
        rec["index"] = default_index(shape)
    if m.size > 1:
        rec["rank"] = 0
        with fake_group(m) as dm:
            pred = predict(cfg, shape, n_micro=n_micro, mesh=dm)
    else:
        pred = predict(cfg, shape, n_micro=n_micro)
    rec["memory"].update(pred.pop("memory"))
    rec.update(pred)
    rec["step"] = "meta"
    rec["step_s"] = round(time.time() - t0, 2)
    rec["ok"] = True
    return rec


# ---------------------------------------------------------------------------
# the same step on the card
# ---------------------------------------------------------------------------


def _inputs(cfg, shape, dev, gen):
    """The batch of the cell on ``dev``: token ids below the vocab size,
    frames and patches at unit scale."""
    def one(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                 device=gen.device,
                                 dtype=torch.int32).to(dev)
        return torch.randn(t.shape, generator=gen, device=gen.device
                           ).to(device=dev, dtype=t.dtype)
    return {k: one(v) for k, v in api.batch_struct(cfg, shape).items()}


HOST_CALLS, PROFILE_CALLS = 3, 2


def _profile(call, dev) -> dict:
    """Device ms and launches a call from ``torch.profiler``'s device-side
    events over :data:`PROFILE_CALLS` calls.  The tracer drops a record now
    and then (each kernel's records must be a multiple of the calls): such
    a profile is taken again, up to three times, and where none is whole
    the one with the most device time is kept (a dropped record only takes
    time away)."""
    calls = PROFILE_CALLS
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    best = None
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize(dev)
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        whole = all(ev.count % calls == 0 for ev in evs)
        got = {"device_ms": sum(ev.self_device_time_total for ev in evs)
               / 1e3 / calls,
               "device_launches": sum(ev.count for ev in evs) / calls,
               "profile_attempts": attempt, "profile_whole": whole}
        if best is None or whole or got["device_ms"] > best["device_ms"]:
            best = got
        if whole:
            break
    return best


def measure_cell(arch: str, shape, overrides: dict | None = None,
                 layers: Optional[int] = None, device=None,
                 index: Optional[int] = None) -> dict:
    """The cell's step on the card beside its dry run at the same depth.

    Weights are drawn from a seeded generator at 1/sqrt(fan-in)
    (``launch/families.py::fan_in_defs``), the cache is zeros with
    ``index`` (default as the dry run's), the optimizer state
    ``init_opt_state``'s.  After one warm-up call: host ms a call
    (:data:`HOST_CALLS` calls, each ended by a sync); from ``torch.profiler``,
    device ms and device launches a call; ``torch.cuda.max_memory_allocated``
    over one call from a reset taken with the arguments resident, less
    what the process held before the inputs were made (``peak_bytes``),
    and its temp (peak less what was allocated at the reset); and the
    ``op_cost`` record of one call on the card's tensors, to hold against
    the meta record (``predicted["op_cost"]``) op for op."""
    from ..device import resolve_device, synchronize
    from ..models.param import init_params
    from .families import fan_in_defs
    dev = resolve_device(device)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    idx = default_index(shape, index)
    pred = predict(cfg, shape, idx)

    cuda = dev.type == "cuda"
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(fan_in_defs(tf.model_defs(cfg)), gen, dev)
    batch = _inputs(cfg, shape, dev, gen)
    cache = opt = None
    if shape.kind == "train":
        opt = init_opt_state(params)
    else:
        enc = shape.seq_len if cfg.family == "audio" else 0
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device=dev, enc_len=enc)
        cache["index"] = idx
    fn, args = step_and_args(cfg, shape, params, batch, cache, opt)

    def call():
        fn(*args)
        synchronize(dev)

    call()                                                # warm-up
    times = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter()
        call()
        times.append(1e3 * (time.perf_counter() - t0))
    measured = {"host_ms": sum(times) / len(times), "host_ms_all": times}
    if cuda:
        measured.update(_profile(call, dev))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        call()
        peak = torch.cuda.max_memory_allocated(dev)
        # the step's own peak: less what the process held before the
        # step's inputs were made
        measured.update(allocated_before_inputs=before,
                        argument_bytes=base - before,
                        max_memory_allocated=peak, peak_bytes=peak - before,
                        temp_bytes=peak - base)
    card = op_cost.analyze_step(fn, *args)
    measured["op_cost"] = {k: card[k] for k in OP_COST_KEYS}
    measured["record_memory"] = {k: card[k] for k in (
        "argument_bytes", "peak_bytes", "temp_bytes")}
    out = {"arch": arch, "shape": dataclasses.asdict(shape),
           "layers": cfg.num_layers, "overrides": overrides or {},
           "index": idx if shape.kind != "train" else None,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "predicted": pred, "measured": measured}
    if measured.get("device_ms"):
        out["share"] = pred["bound_ms"] / measured["device_ms"]
    return out


def summary(rec: dict) -> str:
    """One line of a record's figures: GB per rank, fits, flops, bound."""
    if not rec.get("ok") or rec.get("skipped"):
        return ""
    m = rec["memory"]
    out = f" arg={m['argument_bytes'] / 1e9:.3f}GB"
    if rec.get("step") is None:
        return out
    r = rec["roofline"]
    return (out + f" peak={m['peak_bytes'] / 1e9:.3f}GB"
            f" temp={m['temp_bytes'] / 1e9:.3f}GB fits={rec['fits']}"
            f" model_flops={r['model_flops']:.4g}"
            f" op_flops={r['flops_per_dev']:.4g}"
            f" op_bytes={r['hbm_bytes_per_dev']:.4g}"
            f" bound_ms={rec['bound_ms']:.4g} ({r['bottleneck']})")


def main():
    ap = argparse.ArgumentParser(description="dry run on the H100 model")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None,
                    help="comma-separated of " + ", ".join(MESHES)
                    + " (default 1)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the mesh 2x16x16")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the meshes 16x16 and 2x16x16")
    ap.add_argument("--all", action="store_true",
                    help="every config of configs/ and every shape")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args()

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    if args.mesh:
        meshes = args.mesh.split(",")
    elif args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    else:
        meshes = ["2x16x16"] if args.multi_pod else ["1"]
    print("device: none (meta tensors; the H100 data sheet's rates)",
          flush=True)
    n_ok = n_fail = 0
    for a in archs:
        for s in shapes:
            for mesh in meshes:
                name = cell_name(a, s, mesh)
                path = out_dir / (name + ".json")
                if path.exists() and not args.force:
                    print(f"[skip-cached] {name}")
                    continue
                print(f"[run] {name} ...", flush=True)
                t0 = time.time()
                try:
                    rec = run_cell(a, s, mesh)
                except Exception as e:
                    rec = {"arch": a, "shape": s, "mesh": mesh, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                rec["wall_s"] = round(time.time() - t0, 2)
                path.write_text(json.dumps(rec, indent=2, default=str))
                status = "OK" if rec.get("ok") else "FAIL"
                if rec.get("skipped"):
                    status = "SKIP"
                print(f"[{status}] {name} ({rec['wall_s']}s)"
                      + ("" if rec.get("ok") else f" :: {rec.get('error')}")
                      + summary(rec), flush=True)
                n_ok += int(bool(rec.get("ok")))
                n_fail += int(not rec.get("ok"))
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
