"""The port's multi-device code on four H100s of one host (NCCL), at
published widths.

Marked ``gpu``: the tests skip with fewer than four CUDA devices and run on
a four-card machine with

    PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_multi_cuda.py

The ``group`` fixture starts this file as a script in 4 processes (rank
r on card r, ``torch.cuda.set_device(r)``, a TCP rendezvous on a free
local port); each rank runs the cases below, asserts what it can see, and
writes its readings to a JSON file the tests read.  This file imports
neither jax nor the JAX package; whether there are four cards is decided
inside the fixture, never at import.

(a) ``seq_sharded_decode_step`` on one layer of qwen3-32b's ``decode_32k``
    cell (B 128, S 32768, H 64, Kv 8, hd 128, bf16; the cache 17.2 GB,
    4.3 GB a rank) on a (1, 4) mesh, lengths spread over 1..32767 so that
    some ranks hold nothing of some sequences: rank 0 holds the output
    against ``flash_decode`` over the whole cache and every rank's shard
    against the gather path's write, bit for bit; kernel device ms and
    all-reduce ms;
(b) granite-moe-3b-a800m at its published width and depth in f32
    (weights at 1/sqrt(fan-in)): a forward of 8 x 512 tokens under a
    (1, 4) mesh (10 experts a rank, each rank holding only its experts)
    against a (1, 1) mesh on card 0, the same capacity, the same routes;
    one layer with room for every token against ``_moe_dense``;
(c) ``compressed_psum_tree`` over mistral-7b's rank-16 q/k/v/o LoRA
    gradient tree (13.6 M f32 values a rank) against an f32 all-reduce,
    within the quantization bound, with wire bytes and ms of both;
(d) mistral-7b's parameters placed by ``params_shardings(defs, mesh,
    "serve")`` as DTensors on a (1, 4) DeviceMesh: each rank's bytes equal
    what the specs predict from ``count_defs``.
"""
import dataclasses as dc
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

pytestmark = pytest.mark.gpu

WORLD = 4
TIMEOUT = 420              # s for the ranks, their build and start included
NCCL_TIMEOUT = datetime.timedelta(seconds=180)  # a hung collective raises
SEQ = dict(B=128, S=32768, H=64, Kv=8, hd=128)     # qwen3-32b decode_32k
MOE_TOKENS = (8, 512)
F32_LOGIT_ATOL = 1e-4      # f32 logits, the families' parity tolerance


# --------------------------------------------------------------------------
# the ranks (run as a script)
# --------------------------------------------------------------------------


def _events_ms(fn, iters: int) -> float:
    """CUDA-event ms a call of ``fn``, every rank starting together: a
    collective, so every rank calls it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _case_seq(rank, dev, out):
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.kernels import checks
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.mesh import device_mesh, make_mesh
    mesh = device_mesh(make_mesh((1, WORLD), ("data", "model")))
    B, S, H, Kv, hd = (SEQ[k] for k in ("B", "S", "H", "Kv", "hd"))
    S_loc = S // WORLD

    def draw(seed, *shape):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    # each rank draws its slice; rank 0 draws all four for the reference
    ck = draw(100 + rank, B, S_loc, Kv, hd)
    cv = draw(200 + rank, B, S_loc, Kv, hd)
    q, kn, vn = draw(1, B, 1, H, hd), draw(2, B, 1, Kv, hd), \
        draw(3, B, 1, Kv, hd)
    idx = torch.linspace(1, S - 1, B, device=dev).to(torch.int32)
    start = rank * S_loc
    holds = ((idx + 1 - start) > 0).sum().item()
    o, ck, cv = collectives.seq_sharded_decode_step(q, ck, cv, kn, vn, idx,
                                                    mesh)
    out["seq_sequences_held"] = int(holds)
    # readings: the whole step, its partial (the kernel) and its merge
    local = torch.clamp(idx + 1 - start, 0, S_loc).to(torch.int32)
    qf = q[:, 0].float().contiguous()
    step_ms = _events_ms(lambda: collectives.seq_sharded_decode_step(
        q, ck, cv, kn, vn, idx, mesh), 10)
    part = collectives._kernel_partial(q, ck, cv, start, idx + 1)
    merge_ms = _events_ms(lambda: collectives._merge(
        *part, True, mesh.group("model")), 10)
    out["seq_step_ms"], out["seq_merge_ms"] = step_ms, merge_ms
    out["seq_kernel_ms"] = _events_ms(
        lambda: flash_decode(qf, ck, cv, local), 10)
    out["seq_kernel_device_ms"] = checks.device_ms(
        lambda: flash_decode(qf, ck, cv, local), [checks.ATTN_KERNEL],
        iters=10)
    if rank == 0:
        fk = torch.empty((B, S, Kv, hd), dtype=torch.bfloat16, device=dev)
        fv = torch.empty_like(fk)
        for r in range(WORLD):
            sl = slice(r * S_loc, (r + 1) * S_loc)
            fk[:, sl] = draw(100 + r, B, S_loc, Kv, hd)
            fv[:, sl] = draw(200 + r, B, S_loc, Kv, hd)
        rows = torch.arange(B, device=dev)
        fk[rows, idx.long()] = kn[:, 0]
        fv[rows, idx.long()] = vn[:, 0]
        want = flash_decode(q[:, 0].contiguous(), fk, fv, idx + 1)[0]
        out["seq_max_abs_err"] = checks._assert_close(
            "seq_sharded_decode_step", o[:, 0], want, checks._out_tol(want))
        out["seq_full_kernel_ms"] = checks.cuda_ms(      # rank 0 alone
            lambda: flash_decode(q[:, 0].contiguous(), fk, fv, idx + 1), 10)
        out["seq_full_kernel_device_ms"] = checks.device_ms(
            lambda: flash_decode(q[:, 0].contiguous(), fk, fv, idx + 1),
            [checks.ATTN_KERNEL], iters=10)
        buf = torch.empty((B, S_loc, Kv, hd), dtype=torch.bfloat16,
                          device=dev)
        for r in range(WORLD):
            sl = slice(r * S_loc, (r + 1) * S_loc)
            for name, full, mine in (("k", fk, ck), ("v", fv, cv)):
                if r:
                    dist.recv(buf, src=r)
                got = mine if r == 0 else buf
                assert torch.equal(got, full[:, sl]), (
                    f"rank {r}'s {name} shard differs from the gather write")
        out["seq_shards_bitwise"] = True
        del fk, fv
    else:
        for mine in (ck, cv):
            dist.send(mine, dst=0)


def _case_moe(rank, dev, out):
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as tsh
    from repro_torch.launch.families import fan_in_defs
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import logits_fwd
    from repro_torch.models.param import init_params
    mesh = device_mesh(make_mesh((1, WORLD), ("data", "model")))
    cfg = get_config("granite-moe-3b-a800m")
    E, E_loc = cfg.moe.num_experts, cfg.moe.num_experts // WORLD
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    full = init_params(fan_in_defs(tf.model_defs(cfg)), g, dev,
                       dtype_override=torch.float32)
    ep = dict(full, layers=dict(full["layers"]))
    ep["layers"]["moe"] = dict(full["layers"]["moe"])
    for name in ("w_gate", "w_up", "w_down"):   # (L, E, ...): rank's experts
        ep["layers"]["moe"][name] = full["layers"]["moe"][name][
            :, rank * E_loc:(rank + 1) * E_loc].clone()
    if rank:
        del full                               # ranks 1-3 hold their shards
    torch.cuda.empty_cache()
    out["moe_expert_bytes_rank"] = sum(
        ep["layers"]["moe"][n].numel() * 4 for n in ("w_gate", "w_up",
                                                     "w_down"))
    gt = torch.Generator(device=dev)
    gt.manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, MOE_TOKENS, generator=gt,
                           device=dev)
    with torch.no_grad():
        with moe.record_routes() as routes4, tsh.use_mesh(mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h4, _, _ = tf.forward(ep, cfg, tokens=tokens, mode="train")
            torch.cuda.synchronize()
            out["moe_forward_s_1x4"] = time.perf_counter() - t0
        logits4 = logits_fwd(ep["embed"], h4, cfg)
        out["moe_finite"] = bool(torch.isfinite(logits4).all())
        if rank == 0:
            with moe.record_routes() as routes1, tsh.use_mesh(
                    make_mesh((1, 1), ("data", "model"))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h1, _, _ = tf.forward(full, cfg, tokens=tokens, mode="train")
                torch.cuda.synchronize()
                out["moe_forward_s_1x1"] = time.perf_counter() - t0
            logits1 = logits_fwd(full["embed"], h1, cfg)
            # a route that flips (the two runs sum the experts in other
            # orders) changes its token and, through attention, the later
            # positions of its sequence: compare the positions before the
            # first flip of each sequence
            B, S = MOE_TOKENS
            first = torch.full((B,), S, dtype=torch.long)
            for (a, _), (b, _) in zip(routes4, routes1):
                diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
                pos = torch.where(diff.reshape(B, S), torch.arange(S),
                                  torch.tensor(S)).amin(-1)
                first = torch.minimum(first, pos)
            keep = (torch.arange(S)[None] < first[:, None]).to(dev)
            out["moe_route_calls"] = len(routes1)
            out["moe_sequences_with_a_flip"] = int((first < S).sum())
            out["moe_positions_compared"] = int(keep.sum())
            out["moe_min_margin"] = min(float(m.min()) for _, m in routes1)
            d = (logits4 - logits1).abs().amax(-1)
            out["moe_max_abs_dlogit"] = float(d[keep].max())
            out["moe_max_abs_logit"] = float(logits1.abs().max())
        # one layer with room for every token, against the dense path
        wide = dc.replace(cfg, moe=dc.replace(
            cfg.moe, capacity_factor=E / cfg.moe.top_k))
        p = {k: v[0] for k, v in ep["layers"]["moe"].items()}
        x = torch.randn((*MOE_TOKENS, cfg.d_model), generator=gt,
                        device=dev)
        with tsh.use_mesh(mesh):
            y, _ = moe.moe_fwd(p, x, wide)
        if rank == 0:
            pf = {k: v[0] for k, v in full["layers"]["moe"].items()}
            xt = x.reshape(-1, cfg.d_model)
            topw, topi, _ = moe._route(pf, xt, cfg)
            dense = moe._moe_dense(pf, xt, topw, topi, cfg)
            err = (y.reshape(-1, cfg.d_model) - dense).abs()
            out["moe_layer_vs_dense_max_abs"] = float(err.max())
            assert bool((err <= 1e-4 * (1 + dense.abs())).all()), \
                out["moe_layer_vs_dense_max_abs"]


def _case_psum(rank, dev, out):
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import grad_compression as gc
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import tree_leaves, tree_map
    mesh = device_mesh(make_mesh((WORLD, 1), ("data", "model")))
    cfg = get_config("mistral-7b")
    cfg = dc.replace(cfg, lora=dc.replace(cfg.lora,
                                          targets=("q", "k", "v", "o")))
    g = torch.Generator(device=dev)
    g.manual_seed(30 + rank)
    grads = tree_map(lambda d: 1e-3 * torch.randn(
        d.shape, generator=g, device=dev), tf.lora_defs_tree(cfg))
    leaves = tree_leaves(grads)
    n = sum(x.numel() for x in leaves)
    comp = gc.compressed_psum_tree(grads, "data", mesh)

    def exact_sum():
        ex = tree_map(lambda x: x.clone(), grads)
        for x in tree_leaves(ex):
            dist.all_reduce(x)
        return ex
    exact = exact_sum()
    worst = 0.0
    for x, c, e in zip(leaves, tree_leaves(comp), tree_leaves(exact)):
        s1 = x.abs().amax()
        dist.all_reduce(s1, op=dist.ReduceOp.MAX)
        s2 = e.abs().amax()      # the reduced chunk's scale is at most this
        # half a level a value on each rank, then half a level of the sum
        bound = float(WORLD * s1 / 254 + (s2 + WORLD * s1 / 254) / 254)
        bound *= 1 + 1e-5                      # the f32 sums' own rounding
        err = float((c - e).abs().max())
        assert err <= bound, (err, bound)
        worst = max(worst, err / float(s1))
    out["psum_values"] = n
    out["psum_leaves"] = len(leaves)
    out["psum_max_err_over_scale"] = worst
    out["psum_wire_bytes"] = sum(_int8_wire_bytes(x.numel())
                                 for x in leaves)
    out["f32_ring_wire_bytes"] = int(2 * (WORLD - 1) / WORLD * 4 * n)
    out["psum_ms"] = _events_ms(
        lambda: gc.compressed_psum_tree(grads, "data", mesh), 3)
    out["f32_allreduce_ms"] = _events_ms(exact_sum, 3)


def _int8_wire_bytes(n: int) -> int:
    """Bytes one rank sends in ``compressed_psum`` of ``n`` values: its
    int8 chunks to the other ranks in each of the two phases, and an f32
    scale to each in each of the two max all-reduces (counted as a direct
    exchange)."""
    return 2 * (WORLD - 1) * -(-n // WORLD) + 2 * (WORLD - 1) * 4


def _case_place(rank, dev, out):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.launch.shardings import params_shardings
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import count_defs, tree_leaves
    mesh = device_mesh(make_mesh((1, WORLD), ("data", "model")))
    defs = tf.model_defs(get_config("mistral-7b"))
    sh = params_shardings(defs, mesh, "serve")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    placed = {}

    def place(d, s):
        local = torch.empty(s.local_shape(d.shape), dtype=d.dtype,
                            device=dev)
        return DTensor.from_local(local, mesh.device_mesh, s.placements(),
                                  shape=torch.Size(d.shape),
                                  stride=torch.empty(d.shape,
                                                     device="meta").stride())
    flat_defs, flat_sh = tree_leaves(defs), tree_leaves(sh)
    for i, (d, s) in enumerate(zip(flat_defs, flat_sh)):
        placed[i] = place(d, s)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - before
    local_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in placed.values())
    predicted = 0
    for d, s in zip(flat_defs, flat_sh):
        split = 1
        for part in s.spec:
            for a in ((part,) if isinstance(part, str) else (part or ())):
                split *= mesh.shape[a]
        predicted += count_defs({"w": d}) // split * 2
    assert all(tuple(t.shape) == d.shape
               for t, d in zip(placed.values(), flat_defs))
    assert local_bytes == predicted, (local_bytes, predicted)
    assert 0 <= held - local_bytes < 512 * len(flat_defs), (held, local_bytes)
    out["place_local_bytes"] = local_bytes
    out["place_total_bytes"] = count_defs(defs) * 2
    out["place_leaves"] = len(flat_defs)
    out["place_allocated_bytes"] = held


def rank_main(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank, device_id=dev,
                            timeout=NCCL_TIMEOUT)
    out = {"device": torch.cuda.get_device_name(dev)}
    try:
        for case in (_case_seq, _case_moe, _case_psum, _case_place):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            print(f"[rank {rank}] {case.__name__}", file=sys.stderr,
                  flush=True)
            case(rank, dev, out)
            out[case.__name__ + "_s"] = time.perf_counter() - t0
            print(f"[rank {rank}] {case.__name__} done in "
                  f"{out[case.__name__ + '_s']:.1f} s", file=sys.stderr,
                  flush=True)
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices (run on a four-H100 host)")
    from repro_torch.kernels import _build
    _build.build()                  # once, before the ranks load it
    out_dir = str(tmp_path_factory.mktemp("multi_cuda"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(here),
                                                    "src")}
    # the ranks write to this process's stdout and stderr as they go
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), str(port), out_dir], env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, \
        [p.returncode for p in procs]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print("\nmulti_cuda cards: " + json.dumps(smi))
    for r, o in enumerate(ranks):
        print(f"multi_cuda rank {r}: " + json.dumps(o))
    return ranks


def test_seq_sharded_decode_on_four_cards(group):
    r0 = group[0]
    assert r0["seq_shards_bitwise"]
    assert r0["seq_max_abs_err"] >= 0
    held = [o["seq_sequences_held"] for o in group]
    assert held[0] == SEQ["B"] and 0 < held[-1] < SEQ["B"]
    assert all(o["seq_kernel_device_ms"] > 0 for o in group)


def test_expert_parallel_moe_on_four_cards(group):
    r0 = group[0]
    assert all(o["moe_finite"] for o in group)
    assert r0["moe_route_calls"] == 32
    B, S = MOE_TOKENS
    assert r0["moe_positions_compared"] >= B * S // 2, r0
    assert r0["moe_max_abs_dlogit"] < F32_LOGIT_ATOL, r0
    assert r0["moe_layer_vs_dense_max_abs"] >= 0
    assert len({o["moe_expert_bytes_rank"] for o in group}) == 1


def test_compressed_psum_on_four_cards(group):
    for o in group:
        assert o["psum_values"] == 13631488
        assert o["psum_wire_bytes"] < o["f32_ring_wire_bytes"] / 2


def test_params_placed_by_serve_shardings(group):
    for o in group:
        assert o["place_local_bytes"] * WORLD >= o["place_total_bytes"]
        assert o["place_local_bytes"] < o["place_total_bytes"] / 2


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
