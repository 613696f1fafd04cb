"""One rank of a gloo process group on the CPU for tests/test_torch_spmd.py
(imports torch and the port, never JAX):

    python tests/torch_spmd_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR MODE

MODE ``steps``: the model's sharded steps (``launch/shardings.py::
sharded_step_for``) on the elastic mesh of WORLD ranks
(``launch/mesh.py::make_mesh_for(WORLD, model_parallel=2)``: (1, 2) or
(2, 2) over ("data", "model")) for every arch in the inputs: prefill, one
decode step from the prefill's cache under each decode branch the inputs
name, and one full train step.
Each output's local block is written with the global offset of its first
element, and the rank's bytes of each cell's inputs placed as the dry run
sizes them (``dryrun.argument_bytes``).

MODE ``save`` and ``restore``: a tree saved from DTensors on this mesh
(``checkpoint.save_checkpoint``), and restored onto this mesh
(``restore_checkpoint(..., shardings=)``), each rank's block written out.

MODE ``refuse``: a kernel wrapper and ``constrain`` given the wrong kind
of tensor inside the sharded step must raise.
"""
import dataclasses as dc
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as tcfg
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import to_dtensors, to_torch
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tshard
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttf
from repro_torch.models.param import abstract_params, tree_leaves
from repro_torch.training.optimizer import (AdamWConfig, abstract_opt_state,
                                            init_opt_state)
from repro_torch.training.step import make_train_step


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _put(out, name, x):
    """A DTensor's local block and where it starts, or a host value."""
    if tsh.is_dtensor(x):
        out[name] = x.to_local().detach().float().numpy()
        out[name + "@off"] = np.array([tsh.global_offset(x, d)
                                       for d in range(x.ndim)], np.int64)
        out[name + "@shape"] = np.array(x.shape, np.int64)
    elif isinstance(x, torch.Tensor):
        out[name] = x.detach().float().numpy()
    else:
        out[name] = np.asarray(x)


def _put_tree(out, prefix, tree):
    for k, v in _flat(tree, prefix).items():
        _put(out, k, v)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree) if tsh.is_dtensor(t))


def placed_bytes(cfg, shape, m) -> dict:
    """Each input's local bytes on this rank, placed from ``meta`` trees
    in the dtypes the dry run sizes."""
    params = abstract_params(ttf.model_defs(cfg))
    trees = {"params": params, "batch": tapi.batch_struct(cfg, shape)}
    if shape.kind == "train":
        trees["opt_state"] = abstract_opt_state(params)
    else:
        trees["cache"] = tapi.cache_struct(cfg, shape)
    placed = tshard.place_inputs(cfg, shape, m, **trees)
    return {k: _local_bytes(v) for k, v in placed.items()}


def _steps(inp, m, out):
    archs = [str(a) for a in inp["archs"]]
    B, S, S_max = (int(inp[k]) for k in ("B", "S", "S_max"))
    pre = ShapeConfig("spmd_prefill", S_max, B, "prefill")
    dec = ShapeConfig("spmd_decode", S_max, B, "decode")
    trn = ShapeConfig("spmd_train", S, B, "train")
    for a in archs:
        cfg = tcfg.smoke_config(a)
        params = to_torch(_unflatten({k[len(a) + 3:]: inp[k] for k in inp
                                      if k.startswith(a + "/p/")}))
        tok = torch.from_numpy(inp[a + "/tok"]).long()
        cache = ttf.init_cache(cfg, B, S_max, device="cpu",
                               dtype=torch.float32)
        placed = tshard.place_inputs(cfg, pre, m, params=params,
                                     batch={"tokens": tok}, cache=cache)
        logits, new = tshard.sharded_step_for(cfg, pre, m)(
            placed["params"], placed["batch"], placed["cache"])
        _put(out, f"{a}/prefill/logits", logits)
        _put_tree(out, f"{a}/prefill/cache/", new)
        nxt = torch.from_numpy(inp[a + "/next"]).long()
        for branch in [str(b) for b in inp[a + "/branches"]]:
            c = dc.replace(cfg, decode_attn=branch)
            batch = tshard.place_inputs(c, dec, m,
                                        batch={"tokens": nxt})["batch"]
            mine = {k: (v.clone() if tsh.is_dtensor(v) else v)
                    for k, v in new.items()}
            lg, cache2 = tshard.sharded_step_for(c, dec, m)(
                placed["params"], batch, mine)
            _put(out, f"{a}/decode_{branch}/logits", lg)
            _put_tree(out, f"{a}/decode_{branch}/cache/", cache2)
            # only the lazy branch writes into the caller's cache
            kept = all(torch.equal(mine[k].to_local(), new[k].to_local())
                       for k in new if tsh.is_dtensor(new[k]))
            out[f"{a}/decode_{branch}/kept"] = np.array(kept)
        ttok = torch.from_numpy(inp[a + "/ttok"]).long()
        ttgt = torch.from_numpy(inp[a + "/ttgt"]).long()
        tplaced = tshard.place_inputs(
            cfg, trn, m, params=params, opt_state=init_opt_state(params),
            batch={"tokens": ttok, "targets": ttgt})
        opt = AdamWConfig(**{k[4:]: v.item() for k, v in inp.items()
                             if k.startswith("opt/")})
        p2, o2, met = tshard.sharded_step_for(cfg, trn, m, opt_cfg=opt)(
            tplaced["params"], tplaced["opt_state"], tplaced["batch"])
        _put_tree(out, f"{a}/train/params/", p2)
        _put_tree(out, f"{a}/train/opt/", o2)
        _put(out, f"{a}/train/loss", met["loss"].full_tensor())
        if a == archs[0]:
            _microbatched(cfg, trn, m, params, tplaced, out)
        for kind, shape in (("prefill", pre), ("decode", dec),
                            ("train", trn)):
            for k, v in placed_bytes(cfg, shape, m).items():
                out[f"{a}/bytes/{kind}/{k}"] = np.array(v)
            for k, v in tdry.argument_bytes(cfg, shape, m).items():
                out[f"{a}/want_bytes/{kind}/{k}"] = np.array(v)


def _microbatched(cfg, shape, m, params, placed, out):
    """The sharded train step over 2 microbatches against the replicated
    step over the same 2 (both the port's; f32)."""
    _, o2, met = tshard.sharded_step_for(cfg, shape, m, n_micro=2)(
        placed["params"], placed["opt_state"], placed["batch"])
    batch = {k: v.full_tensor() for k, v in placed["batch"].items()}
    _, ro, rm = make_train_step(cfg, n_micro=2)(
        params, init_opt_state(params), batch)
    out["micro/dloss"] = np.array(abs(float(met["loss"].full_tensor())
                                      - float(rm["loss"])))
    mu = list(zip(tree_leaves(o2["mu"]), tree_leaves(ro["mu"])))
    out["micro/dmu"] = np.array(max(float((x.full_tensor() - y).abs().max())
                                    for x, y in mu))
    out["micro/mu_max"] = np.array(max(float(y.abs().max()) for _, y in mu))


def _ckpt_tree(inp, m):
    """The checkpoint test's tree: arrays of the inputs under specs on the
    mesh, a bf16 leaf among them."""
    full = {"w": torch.from_numpy(inp["ck/w"]),
            "b": {"e": torch.from_numpy(inp["ck/e"]).to(torch.bfloat16)},
            "count": torch.from_numpy(inp["ck/count"])}
    sh = {"w": tsh.NamedSharding(m, tsh.P("data", "model")),
          "b": {"e": tsh.NamedSharding(m, tsh.P("model", None))},
          "count": tsh.NamedSharding(m, tsh.P())}
    return full, sh


def _save(inp, m, out, ckpt_dir):
    full, sh = _ckpt_tree(inp, m)
    tree = to_dtensors(full, sh)
    tckpt.save_checkpoint(ckpt_dir, 3, tree)
    out["saved"] = np.array(1)


def _restore(inp, m, out, ckpt_dir):
    full, sh = _ckpt_tree(inp, m)
    back = tckpt.restore_checkpoint(ckpt_dir, 3, full, shardings=sh)
    for k, v in _flat(back, "").items():
        assert tsh.is_dtensor(v) and v.device_mesh.size() == m.size, k
        local = v.to_local()
        if local.dtype == torch.bfloat16:
            local = local.view(torch.int16)
        out[k] = local.numpy()
        out[k + "@off"] = np.array([tsh.global_offset(v, d)
                                    for d in range(v.ndim)], np.int64)


def _refuse(m, out):
    """Inside the sharded step a kernel wrapper refuses a DTensor and
    ``constrain`` a plain tensor."""
    from repro_torch.kernels import flash_decode, ops
    sh = tsh.NamedSharding(m, tsh.P(None, "model", None))
    q = to_dtensors(torch.zeros(2, 4, 32), sh)
    k = to_dtensors(torch.zeros(2, 8, 4, 32),
                    tsh.NamedSharding(m, tsh.P(None, None, "model", None)))
    cases = {
        "flash_decode": lambda: flash_decode.flash_decode(
            q, k, k, torch.full((2,), 3, dtype=torch.int32)),
        "lora_apply": lambda: ops.lora_apply(
            q.reshape(2, 128), torch.zeros(1, 4, 128), torch.zeros(1, 128, 4),
            torch.zeros(2, dtype=torch.int32)),
        "constrain": lambda: tsh.constrain(torch.zeros(2, 4), "batch",
                                           None),
    }
    for name, fn in cases.items():
        with tsh.sharded_step(m):
            try:
                fn()
            except TypeError as e:
                out["refused." + name] = np.array(str(e))
    # outside the sharded step a plain tensor passes constrain unchanged
    with tsh.use_mesh(m):
        x = torch.ones(2, 4)
        out["outside.constrain"] = np.array(
            tsh.constrain(x, "batch", None) is x)


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inp = dict(np.load(sys.argv[4]))
    out_dir, mode = sys.argv[5], sys.argv[6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    out = {}
    try:
        # JAX's elastic meshes: (2, 2) of 4 ranks, (1, 2) of 2
        m = tmesh.make_mesh_for(world, model_parallel=2, device_type="cpu")
        out["coords"] = np.array([m.coordinate(a) for a in m.axis_names])
        if mode == "steps":
            _steps(inp, m, out)
        elif mode == "save":
            _save(inp, m, out, os.path.join(out_dir, "ckpt"))
        elif mode == "restore":
            _restore(inp, m, out, str(inp["ck/dir"]))
        elif mode == "refuse":
            _refuse(m, out)
        else:
            raise ValueError(mode)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
