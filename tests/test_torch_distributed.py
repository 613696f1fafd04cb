"""The port's multi-device code on spawned gloo process groups on the CPU,
against the JAX package on a fake mesh of the same size.

Two groups run ``tests/torch_dist_worker.py`` (which imports no JAX): 2
ranks on a (1, 2) ("data", "model") mesh, 4 ranks on (2, 2).  JAX's side
runs in one child process with 4 host devices
(``--xla_force_host_platform_device_count``, set before JAX is imported).
Inputs are drawn here with numpy from seeds and passed to both as one
``.npz``; each group binds a free port of its own.

- ``seq_sharded_decode_attention`` / ``_step``: attention over the whole
  cache (JAX's gather decode) within 1e-5 in f32, each rank's cache shard
  equal to JAX's ``seq_sharded_decode_step`` bit for bit, and some ranks
  holding nothing of some sequences; the model's ``seq_shard`` branch
  against its gather branch;
- ``compressed_psum``: int8 payloads equal JAX's exactly, the output
  within 1e-6; the dp all-reduce likewise;
- ``_moe_ep`` against JAX's ``_moe_ep`` on (1, 2) (experts sharded, and
  ``expert_ff`` sharded where the experts do not split) and on (2, 2);
- DTensor placements of a spec against the port's own rank blocks.
"""
import dataclasses as dc
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from families_common import draw
from repro.configs import smoke_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.launch.families import fan_in_defs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
F32_TOL = 1e-5
B, H, KV, HD, S = 6, 4, 1, 32, 64       # Kv 1 does not split over 2 ranks
MOE_ARCH = "granite-moe-3b-a800m"
TIMEOUT = 300

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses as dc
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import smoke_config
from repro.distributed import grad_compression as gc
from repro.distributed.collectives import seq_sharded_decode_step
from repro.distributed.sharding import use_mesh
from repro.launch.mesh import make_mesh_compat
from repro.models import layers, moe

inp = dict(np.load(sys.argv[1]))
out = {}
m12 = make_mesh_compat((1, 2), ("data", "model"))
a = {k: jnp.asarray(inp["seq." + k]) for k in ("q", "ck", "cv", "kn", "vn",
                                                "idx")}
o, ck, cv = jax.jit(lambda a: seq_sharded_decode_step(
    a["q"], a["ck"], a["cv"], a["kn"], a["vn"], a["idx"], m12))(a)
out["seq.k"], out["seq.v"] = np.asarray(ck), np.asarray(cv)
# JAX's gather decode: the new token written, attention over [0, idx + 1)
rows = jnp.arange(a["q"].shape[0])
keys = a["ck"].at[rows, a["idx"]].set(a["kn"][:, 0])
vals = a["cv"].at[rows, a["idx"]].set(a["vn"][:, 0])
out["seq.gather"] = np.asarray(layers.naive_attention(
    a["q"], keys, vals, causal=True, q_offset=a["idx"], kv_len=a["idx"] + 1))
out["seq.attn"] = np.asarray(layers.naive_attention(
    a["q"], a["ck"], a["cv"], causal=False, kv_len=a["idx"]))

W = inp["psum.x"].shape[0]
mw = make_mesh_compat((W,), ("data",))


def body(xs):
    stash, quant = [], gc._quant
    gc._quant = lambda x, s: stash.append(quant(x, s)) or stash[-1]
    try:
        res = gc.compressed_psum(xs[0], "data")
    finally:
        gc._quant = quant
    return res[None], stash[0][None], stash[1][None]


res, q1, q2 = jax.jit(shard_map(body, mesh=mw, in_specs=P("data"),
                                out_specs=P("data")))(
    jnp.asarray(inp["psum.x"]))
out["psum.out"], out["psum.q1"], out["psum.q2"] = map(np.asarray,
                                                     (res, q1, q2))
dp = make_compressed_dp_allreduce = gc.make_compressed_dp_allreduce(
    make_mesh_compat((W, 1), ("data", "model")))
tree = {"a": jnp.asarray(inp["dp.a"].reshape(-1, *inp["dp.a"].shape[2:])),
        "b": {"c": jnp.asarray(inp["dp.c"].reshape(-1,
                                                   *inp["dp.c"].shape[2:]))}}
red = jax.jit(dp)(tree)
out["dp.a"] = np.asarray(red["a"]).reshape(inp["dp.a"].shape)
out["dp.c"] = np.asarray(red["b"]["c"]).reshape(inp["dp.c"].shape)

for name, shape in (("moe12", (1, 2)), ("moe12ff", (1, 2)),
                    ("moe22", (2, 2))):
    cfg = smoke_config("granite-moe-3b-a800m")
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, num_experts=int(
        inp[name + ".E"])))
    p = {k[len(name) + 3:]: jnp.asarray(inp[k]) for k in inp
         if k.startswith(name + ".p.")}
    mesh = make_mesh_compat(shape, ("data", "model"))
    with use_mesh(mesh):
        y, _ = jax.jit(lambda p, x: moe.moe_fwd(p, x, cfg))(
            p, jnp.asarray(inp[name + ".x"]))
    out[name + ".y"] = np.asarray(y)
np.savez(sys.argv[2], **out)
print("jax reference done")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")
           + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return env


def _flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    # sequences whose lengths leave rank 1 (positions 32..63) empty for some
    inp["seq.q"] = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    inp["seq.ck"] = (2 * rng.standard_normal((B, S, KV, HD))).astype(
        np.float32)
    inp["seq.cv"] = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    inp["seq.kn"] = (2 * rng.standard_normal((B, 1, KV, HD))).astype(
        np.float32)
    inp["seq.vn"] = rng.standard_normal((B, 1, KV, HD)).astype(np.float32)
    inp["seq.idx"] = np.array([0, 5, 31, 32, 40, 63], np.int32)
    inp["psum.x"] = rng.standard_normal((2, 4 * 37 + 3)).astype(np.float32)
    inp["dp.a"] = rng.standard_normal((2, 3, 5)).astype(np.float32)
    inp["dp.c"] = (0.01 * rng.standard_normal((2, 2, 7))).astype(np.float32)
    for seed, (name, E) in enumerate((("moe12", 8), ("moe12ff", 5),
                                      ("moe22", 8))):
        cfg = smoke_config(MOE_ARCH)
        cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, num_experts=E))
        inp[name + ".E"] = np.array(E)
        # matrices at 1/sqrt(fan-in): outputs O(1), held at 1e-5
        for k, v in draw(fan_in_defs(jmoe.moe_defs(cfg)), 10 + seed).items():
            inp[f"{name}.p.{k}"] = v
        inp[name + ".x"] = rng.standard_normal((4, 6, cfg.d_model)).astype(
            np.float32)
    # the model's seq_shard branch: mistral-7b's smoke config (Kv 1)
    jcfg = smoke_config("mistral-7b")
    for k, v in _flat(draw(jtf.model_defs(jcfg), 3), "model.").items():
        inp[k] = v
    inp["tok.prompt"] = rng.integers(0, 64, (2, 20)).astype(np.int32)
    inp["tok.next"] = rng.integers(0, 64, (2, 1)).astype(np.int32)
    inp["tok.s_max"] = np.array(32)
    return inp


def _group(world, path, out_dir):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
         str(r), str(world), str(port), path, out_dir],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    path = str(d / "inputs.npz")
    np.savez(path, **inp)
    jax_out = str(d / "jax.npz")
    env = _env()
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, path, jax_out], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    two, four = d / "two", d / "four"
    two.mkdir()
    four.mkdir()
    try:
        ranks2 = _group(2, path, str(two))
        ranks4 = _group(4, path, str(four))
    finally:
        _, err = jax_proc.communicate(timeout=TIMEOUT)
    assert jax_proc.returncode == 0, err[-3000:]
    return inp, dict(np.load(jax_out)), ranks2, ranks4


def test_seq_sharded_decode_matches_jax(runs):
    inp, ref, ranks, _ = runs
    idx = inp["seq.idx"]
    # some sequences lie wholly on rank 0 (positions 0..31)
    assert (idx + 1 <= S // 2).any() and (idx >= S // 2).any()
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["seq.step_out"], ref["seq.gather"],
                                   rtol=0, atol=F32_TOL)
        sl = slice(r * S // 2, (r + 1) * S // 2)
        assert np.array_equal(out["seq.k"], ref["seq.k"][:, sl])
        assert np.array_equal(out["seq.v"], ref["seq.v"][:, sl])
    # attention without the write: idx 0 attends to nothing (all zeros)
    nonempty = idx > 0
    for out in ranks:
        np.testing.assert_allclose(out["seq.attn_out"][nonempty],
                                   ref["seq.attn"][nonempty], rtol=0,
                                   atol=F32_TOL)
        assert np.isfinite(out["seq.attn_out"]).all()


def test_model_seq_shard_branch_matches_gather(runs):
    """decode_step under a (1, 2) mesh with each rank's half of the
    prefilled cache against the gather branch on the whole cache, in the
    port on one process."""
    import torch
    from repro_torch import configs as tcfg
    from repro_torch.convert import to_torch
    from repro_torch.models import transformer as ttf
    inp, _, ranks, _ = runs
    cfg = tcfg.smoke_config("mistral-7b")
    params = {}
    for k, v in to_torch({k[6:]: inp[k] for k in inp
                          if k.startswith("model.")}).items():
        node = params
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    tokens = torch.from_numpy(inp["tok.prompt"]).long()
    cache = ttf.init_cache(cfg, 2, 32, device="cpu", dtype=torch.float32)
    _, cache = ttf.prefill(params, {"tokens": tokens}, cfg, cache)
    logits, new = ttf.decode_step(
        params, torch.from_numpy(inp["tok.next"]).long(), cfg, cache)
    idx = cache["index"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["model.logits"], logits.numpy(),
                                   rtol=0, atol=F32_TOL)
        sl = slice(r * 16, (r + 1) * 16)
        want = new["k"][:, :, sl].numpy()
        assert np.array_equal(out["model.local_k_before"],
                              cache["k"][:, :, sl].numpy())
        others = np.arange(16) + r * 16 != idx
        assert np.array_equal(out["model.k"][:, :, others],
                              want[:, :, others])
        np.testing.assert_allclose(out["model.k"], want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())


def test_compressed_psum_matches_jax(runs):
    _, ref, ranks, _ = runs
    g = len(ranks)
    for r, out in enumerate(ranks):
        assert out["psum.q1"].dtype == np.int8
        assert np.array_equal(out["psum.q1"], ref["psum.q1"][r])
        assert np.array_equal(out["psum.q2"], ref["psum.q2"][r])
        np.testing.assert_allclose(out["psum.out"], ref["psum.out"][r],
                                   rtol=0, atol=1e-6)
        assert np.array_equal(out["psum.out_ctx"], out["psum.out"])
        for key in ("dp.a", "dp.c"):
            np.testing.assert_allclose(out[key], ref[key][r], rtol=0,
                                       atol=1e-6)
    x = runs[0]["psum.x"]
    exact = x.sum(0)
    bound = 2 / 127 * np.abs(x).max() * g
    assert np.abs(ranks[0]["psum.out"] - exact).max() <= bound


@pytest.mark.parametrize("name", ["moe12", "moe12ff", "moe22"])
def test_moe_ep_matches_jax(runs, name):
    inp, ref, ranks2, ranks4 = runs
    ranks = ranks4 if name == "moe22" else ranks2
    nd = 2 if name == "moe22" else 1
    want = ref[name + ".y"]
    b = want.shape[0] // nd
    for r, out in enumerate(ranks):
        d = r // 2 if nd == 2 else 0          # row-major: rank = 2 d + m
        np.testing.assert_allclose(out[name + ".y"],
                                   want[d * b:(d + 1) * b], rtol=0,
                                   atol=F32_TOL)
    assert np.abs(want).max() > 0.1


def test_dtensor_placements_give_the_rank_blocks(runs):
    for out in runs[3]:
        assert all(int(out[f"placements.{i}"]) == 1 for i in range(3))
