"""One rank of a gloo process group on the CPU, for
tests/test_torch_distributed.py (imports torch and the port, never JAX):

    python tests/torch_dist_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR

Reads the inputs the test drew with numpy, runs the port's multi-device
code as this rank on a mesh of WORLD ranks, and writes what it computed
to OUT_DIR/rank<RANK>.npz.  WORLD 2 runs the (1, 2) cases (the
sequence-sharded decode and the model's ``seq_shard`` branch, the int8
all-reduce, the expert-parallel MoE with experts and with ``expert_ff``
sharded); WORLD 4 the (2, 2) MoE and the DTensor placements.
"""
import dataclasses as dc
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as tcfg
from repro_torch.convert import to_rank, to_torch
from repro_torch.distributed import collectives, grad_compression
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tshard
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

MOE_ARCH = "granite-moe-3b-a800m"


def _moe(inp, prefix, m, full_weights: bool):
    """moe_fwd of this rank's share of the batch under ``m``; the expert
    weights whole (the path slices them) or as this rank's shards."""
    cfg = tcfg.smoke_config(MOE_ARCH)
    E = int(inp[prefix + "E"])
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, num_experts=E))
    params = {k[len(prefix) + 2:]: inp[k] for k in inp
              if k.startswith(prefix + "p.")}
    coords = m.coordinates()
    if full_weights:
        p = to_torch(params)
    else:
        sh = tshard.params_shardings(tmoe.moe_defs(cfg), m, "serve")
        sh["router"] = tsh.NamedSharding(m, tsh.P())    # routed replicated
        p = to_rank(params, sh, coords)
    x = inp[prefix + "x"]
    nd = m.shape["data"]
    b = x.shape[0] // nd
    x_loc = torch.from_numpy(x[coords["data"] * b:(coords["data"] + 1) * b])
    with tsh.use_mesh(m):
        y, aux = tmoe.moe_fwd(p, x_loc, cfg)
    return y.numpy()


def _seq_shard(inp, m, out):
    r, W = m.coordinate("model"), m.shape["model"]
    q, ck, cv, kn, vn, idx = (torch.from_numpy(inp["seq." + k]) for k in (
        "q", "ck", "cv", "kn", "vn", "idx"))
    S_loc = ck.shape[1] // W
    sl = slice(r * S_loc, (r + 1) * S_loc)
    o, k_sh, v_sh = collectives.seq_sharded_decode_step(
        q, ck[:, sl].clone(), cv[:, sl].clone(), kn, vn, idx, m)
    out["seq.step_out"], out["seq.k"], out["seq.v"] = (
        o.numpy(), k_sh.numpy(), v_sh.numpy())
    out["seq.attn_out"] = collectives.seq_sharded_decode_attention(
        q, ck[:, sl], cv[:, sl], idx, m).numpy()
    # the model's seq_shard branch: a lazy-free decode step on this rank's
    # slice of the prefilled cache (laid out by cache_shardings)
    cfg = dc.replace(tcfg.smoke_config("mistral-7b"), decode_attn="seq_shard")
    params = to_torch({k[6:]: inp[k] for k in inp
                       if k.startswith("model.")}, "cpu")
    params = _unflatten(params)
    tokens = torch.from_numpy(inp["tok.prompt"]).long()
    B = tokens.shape[0]
    cache = ttf.init_cache(cfg, B, int(inp["tok.s_max"]), device="cpu",
                           dtype=torch.float32)
    _, cache = ttf.prefill(params, {"tokens": tokens}, cfg, cache)
    sh = tshard.cache_shardings(cache, cfg, m)
    local = {k: (to_rank(v, sh[k], m.coordinates()) if k != "index" else v)
             for k, v in cache.items()}
    nxt = torch.from_numpy(inp["tok.next"]).long()
    with tsh.use_mesh(m):
        logits, new = ttf.decode_step(params, nxt, cfg, local)
    out["model.logits"], out["model.k"] = logits.numpy(), new["k"].numpy()
    out["model.local_k_before"] = local["k"].numpy()


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _psum(inp, rank, out):
    m = tmesh.device_mesh(tmesh.make_mesh((dist.get_world_size(),),
                                          ("data",)), "cpu")
    x = torch.from_numpy(inp["psum.x"][rank])
    payloads = []
    quant = grad_compression._quant

    def record(x, scale):
        q = quant(x, scale)
        payloads.append(q.numpy().copy())
        return q

    grad_compression._quant = record
    try:
        out["psum.out"] = grad_compression.compressed_psum(x, "data",
                                                           m).numpy()
    finally:
        grad_compression._quant = quant
    out["psum.q1"], out["psum.q2"] = payloads
    with tsh.use_mesh(m):                     # the current mesh by default
        out["psum.out_ctx"] = grad_compression.compressed_psum(x,
                                                               "data").numpy()
    dp = tmesh.device_mesh(tmesh.make_mesh((dist.get_world_size(), 1),
                                           ("data", "model")), "cpu")
    tree = {"a": torch.from_numpy(inp["dp.a"][rank]),
            "b": {"c": torch.from_numpy(inp["dp.c"][rank])}}
    red = grad_compression.make_compressed_dp_allreduce(dp)(tree)
    out["dp.a"], out["dp.c"] = red["a"].numpy(), red["b"]["c"].numpy()


def _placements(m, out, rank):
    """distribute_tensor by a spec's placements gives each rank the block
    that to_rank gives it."""
    from torch.distributed.tensor import distribute_tensor
    full = torch.arange(8 * 8 * 2, dtype=torch.float32).reshape(8, 8, 2)
    for i, spec in enumerate([tsh.P("data", "model", None),
                              tsh.P(None, ("data", "model"), None),
                              tsh.P("model", None, None)]):
        sharding = tsh.NamedSharding(m, spec)
        dt = distribute_tensor(full, m.device_mesh, sharding.placements())
        mine = to_rank({"w": full}, {"w": sharding}, m.coordinates())["w"]
        assert torch.equal(dt.to_local(), mine), (rank, spec)
        # constrain redistributes a DTensor to the spec of its logical axes
        with tsh.use_mesh(m):
            again = tsh.constrain(dt.redistribute(
                m.device_mesh, tsh.placements(tsh.P(), m)),
                "batch", "heads", None)
        assert list(again.placements) == tsh.placements(
            tsh.P("data", "model", None), m)
        assert torch.equal(again.full_tensor(), full)
        out[f"placements.{i}"] = np.array(1)


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inp = dict(np.load(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    out = {}
    try:
        if world == 2:
            m = tmesh.device_mesh(tmesh.make_mesh((1, 2), ("data", "model")),
                                  "cpu")
            _seq_shard(inp, m, out)
            _psum(inp, rank, out)
            out["moe12.y"] = _moe(inp, "moe12.", m, full_weights=False)
            out["moe12ff.y"] = _moe(inp, "moe12ff.", m, full_weights=True)
        else:
            m = tmesh.device_mesh(tmesh.make_mesh((2, 2), ("data", "model")),
                                  "cpu")
            out["moe22.y"] = _moe(inp, "moe22.", m, full_weights=False)
            _placements(m, out, rank)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(sys.argv[5], f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
