"""What tests/test_torch_spmd.py and tests/test_torch_spmd_families.py
share: the inputs, JAX's child, the port's gloo groups and the checks.

The port runs in gloo groups that ``tests/torch_spmd_worker.py`` starts
(2 ranks on a (1, 2) ("data", "model") mesh, 4 on (2, 2); it imports no
JAX).  JAX's side runs in one child process with 4 host devices
(``--xla_force_host_platform_device_count``, set before JAX is imported)
and executes each jitted sharded step with ``in_shardings`` from
``repro.launch.shardings``.  Weights are drawn with numpy at 1/sqrt(fan-
in) (``families_common.draw``), tokens from seeds; caches are f32.

- Every output's block on every rank (prefill logits and cache; one
  decode step from that cache under ``gather``, ``lazy`` (dense) and
  ``seq_shard`` (mistral-7b, whose one KV head splits over no model
  axis); the train step's params and optimizer state) equals JAX's values
  there within :data:`F32_TOL` of the output's magnitude (:data:`MOE_TOL`
  for the moe family; forward) or the one-step tolerances of
  ``tests/test_torch_training.py`` (train, under :data:`TRAIN_OPT`: the
  master weights within lr times the gradients' tolerance plus the f32
  rounding ``rtol`` 1e-6, the bf16 params within one rounding of JAX's
  master); the blocks of the cache,
  params and state are the ones JAX's output shardings give that rank.
  JAX's ``seq_shard`` merge weights its partials wrongly (ROADMAP queue
  3), so the port's ``seq_shard`` step is held to JAX's ``gather`` step;
  JAX's expert-parallel MoE drops the sum over the model axis from its
  tokens' gradient (queue 3, pinned in tests/test_torch_spmd.py), so the
  moe train step is held to JAX's on the same data axis with a model axis
  of 1, the same function.
- Each rank's placed bytes equal ``dryrun.argument_bytes`` exactly.
"""
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from families_common import draw
from repro.configs import smoke_config
from repro.models import transformer as jtf
from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import local_block
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tshard
from repro_torch.models import transformer as ttf
from repro_torch.models.param import tree_leaves
from repro_torch.training.optimizer import AdamWConfig, lr_at

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = ("mistral-7b", "qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-2.7b")
BRANCHES = {"mistral-7b": ("gather", "lazy", "seq_shard"),
            "qwen3-1.7b": ("gather", "lazy"),
            "granite-moe-3b-a800m": ("gather",),
            "mamba2-2.7b": ("gather",)}
MESHES = {2: (1, 2), 4: (2, 2)}
# batch, prompt and cache; the train batch is tests/test_torch_training.py's
B, P, S_MAX, S = 4, 16, 32, 24
F32_TOL = 1e-5
# a MoE layer against JAX's in f32 (tests/test_torch_moe.py)
MOE_TOL = 5e-5
# tests/test_torch_training.py's one-step tolerances: the loss, and the
# gradients (here AdamW's first moment, (1 - b1) times the clipped
# gradient) relative to the largest; where the smoke config's f32
# gradients are worse conditioned than that (the moe family's), GRAD_FACTOR
# times their measured distance from f64 ones, as
# tests/test_torch_families_train.py holds them
LOSS_ATOL, GRAD_TOL, GRAD_FACTOR = 1e-5, 1e-4, 3.0
# the train step's AdamW on both sides: with eps 1 a weight moves by lr
# times g / (|g| + 1), in proportion to its gradient (with the default
# eps 1e-8 every weight moves by +-lr whatever its gradient); no warmup,
# so lr is what the first step takes, and a step that is not applied, or
# applied with another sign, lr or decay, is far outside the bound
TRAIN_OPT = dict(eps=1.0, lr=1e-3, warmup_steps=1)
# tests/test_torch_training.py's f32 rounding of the master (rtol, atol)
MASTER_RTOL, MASTER_ATOL = 1e-6, 1e-9
TIMEOUT = 300

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses as dc
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpoint import restore_checkpoint, save_checkpoint
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import use_mesh
from repro.launch import shardings as sh
from repro.launch.mesh import make_mesh_compat, make_mesh_for
from repro.models import api, transformer as tf
from repro.training import optimizer as jopt, step as jstep

inp = dict(np.load(sys.argv[1]))
out = {}
B, S, S_max = (int(inp[k]) for k in ("B", "S", "S_max"))


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(f"{prefix}/{k}", v)
    else:
        out[prefix] = np.asarray(jnp.asarray(tree, jnp.float32))


def run(fn, in_sh, out_sh, *args):
    c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(
        *args).compile(compiler_options={"xla_backend_optimization_level": 0})
    return c(*args)


for shape in ((1, 2), (2, 2)):
    mesh = make_mesh_compat(shape, ("data", "model"))
    tag = "%dx%d" % shape
    for a in [str(x) for x in inp["archs"]]:
        cfg = smoke_config(a)
        params = unflatten({k[len(a) + 3:]: inp[k] for k in inp
                            if k.startswith(a + "/p/")})
        defs = tf.model_defs(cfg)
        pre = ShapeConfig("spmd_prefill", S_max, B, "prefill")
        with use_mesh(mesh):
            p_sh = sh.params_shardings(defs, mesh, "prefill")
            cs = api.cache_struct(cfg, pre)
            cache = {k: jnp.zeros(v.shape, jnp.float32 if k != "index"
                                  else v.dtype) for k, v in cs.items()}
            c_sh = sh.cache_shardings(cs, cfg, mesh)
            tok = {"tokens": jnp.asarray(inp[a + "/tok"])}
            b_sh = sh.batch_shardings(tok, mesh)
            logits, cache1 = run(api.make_prefill_fn(cfg), (p_sh, b_sh, c_sh),
                                 (None, c_sh), params, tok, cache)
            put(f"{tag}/{a}/prefill/logits", logits)
            put(f"{tag}/{a}/prefill/cache", {k: v for k, v in cache1.items()
                                             if k != "index"})
            nxt = {"tokens": jnp.asarray(inp[a + "/next"])}
            n_sh = sh.batch_shardings(nxt, mesh)
            for br in [str(x) for x in inp[a + "/branches"]]:
                if br == "seq_shard":
                    continue                    # held to gather (above)
                c2 = dc.replace(cfg, decode_attn=br)
                lg, cache2 = run(api.make_decode_fn(c2), (p_sh, n_sh, c_sh),
                                 (None, c_sh), params, nxt, cache1)
                put(f"{tag}/{a}/decode_{br}/logits", lg)
                put(f"{tag}/{a}/decode_{br}/cache",
                    {k: v for k, v in cache2.items() if k != "index"})
        # JAX's expert-parallel MoE loses the sum over the model axis in
        # its gradient with respect to the tokens: the moe train step is
        # taken on the same data axis with a model axis of 1 (the same
        # function: the experts' sum and the capacity are the same)
        tmesh_ = (make_mesh_compat((shape[0], 1), ("data", "model"))
                  if cfg.family == "moe" else mesh)
        with use_mesh(tmesh_):
            t_sh = sh.params_shardings(defs, tmesh_, "train")
            o_sh = sh.opt_shardings(t_sh)
            batch = {"tokens": jnp.asarray(inp[a + "/ttok"]),
                     "targets": jnp.asarray(inp[a + "/ttgt"])}
            tb_sh = sh.batch_shardings(batch, tmesh_)
            state = jopt.init_opt_state(params)
            opt = jopt.AdamWConfig(**{k[4:]: v.item() for k, v in inp.items()
                                      if k.startswith("opt/")})
            p2, o2, met = run(jstep.make_train_step(cfg, opt, n_micro=1),
                              (t_sh, o_sh, tb_sh), (t_sh, o_sh, None),
                              params, state, batch)
            put(f"{tag}/{a}/train/params", p2)
            put(f"{tag}/{a}/train/opt", o2)
            out[f"{tag}/{a}/train/loss"] = np.asarray(met["loss"])

if "moe/x" not in inp:
    np.savez(sys.argv[2], **out)
    sys.exit(0)
# the fault above, on one MoE layer: the tokens' gradient on a model
# axis of 2 against a model axis of 1
from repro.models import moe as jmoe
mcfg = smoke_config("granite-moe-3b-a800m")
mp_ = unflatten({k[6:]: v for k, v in inp.items() if k.startswith("moe/p/")})
mx = jnp.asarray(inp["moe/x"])
for shape in ((1, 1), (1, 2)):
    mm = make_mesh_compat(shape, ("data", "model"))

    def f(x):
        with use_mesh(mm):
            y, aux = jmoe.moe_fwd(mp_, x, mcfg)
        return jnp.sum(y * mx) + aux
    out["moe/dx/%dx%d" % shape] = np.asarray(jax.jit(jax.grad(f))(mx))

# checkpoints: the port's (saved on (2, 2)) restored on (1, 2); one of
# JAX's own, saved from (2, 2), for the port to restore
m12 = make_mesh_for(2, model_parallel=2)
sh12 = {"w": NamedSharding(m12, P("data", "model")),
        "b": {"e": NamedSharding(m12, P("model", None))},
        "count": NamedSharding(m12, P())}
like = {"w": jnp.zeros(inp["ck/w"].shape, jnp.float32),
        "b": {"e": jnp.zeros(inp["ck/e"].shape, jnp.bfloat16)},
        "count": jnp.zeros((), jnp.int32)}
back = restore_checkpoint(str(inp["ck/port_dir"]), 3, like, shardings=sh12)
assert back["w"].sharding.mesh.size == 2
out["ck/w"] = np.asarray(back["w"])
out["ck/e"] = np.asarray(back["b"]["e"]).view(np.uint16)
out["ck/count"] = np.asarray(back["count"])
m22 = make_mesh_for(4, model_parallel=2)
tree = {"w": jax.device_put(jnp.asarray(inp["ck/w"]),
                            NamedSharding(m22, P("data", "model"))),
        "b": {"e": jax.device_put(jnp.asarray(inp["ck/e"], jnp.bfloat16),
                                  NamedSharding(m22, P("model", None)))},
        "count": jnp.asarray(inp["ck/count"])}
save_checkpoint(str(inp["ck/jax_dir"]), 3, tree)
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


def inputs(tmp, archs, extras: bool):
    rng = np.random.default_rng(0)
    inp = {"archs": np.array(archs), "B": np.array(B), "S": np.array(S),
           "S_max": np.array(S_MAX)}
    inp.update({"opt/" + k: np.array(v) for k, v in TRAIN_OPT.items()})
    for a in archs:                 # each arch's draws its own
        seed = ARCHS.index(a)
        rng = np.random.default_rng(100 + seed)
        cfg = smoke_config(a)
        for k, v in _flat(draw(jtf.model_defs(cfg), 20 + seed),
                          a + "/p/").items():
            inp[k] = v
        inp[a + "/branches"] = np.array(BRANCHES[a])
        inp[a + "/tok"] = rng.integers(0, cfg.vocab_size, (B, P)).astype(
            np.int32)
        inp[a + "/next"] = rng.integers(0, cfg.vocab_size, (B, 1)).astype(
            np.int32)
        inp[a + "/ttok"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        tgt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tgt[:, :3] = -1                         # positions without loss
        inp[a + "/ttgt"] = tgt
    if not extras:
        return inp
    rng = np.random.default_rng(0)
    from repro.models import moe as jmoe
    moe_cfg = smoke_config("granite-moe-3b-a800m")
    inp.update(_flat(draw(jmoe.moe_defs(moe_cfg), 7), "moe/p/"))
    inp["moe/x"] = rng.standard_normal((4, 6, moe_cfg.d_model)).astype(
        np.float32)
    inp["ck/w"] = rng.standard_normal((8, 6)).astype(np.float32)
    inp["ck/e"] = rng.standard_normal((4, 6)).astype(np.float32)
    inp["ck/count"] = np.array(7, np.int32)
    inp["ck/port_dir"] = np.array(os.path.join(tmp, "save", "ckpt"))
    inp["ck/jax_dir"] = np.array(os.path.join(tmp, "jax_ckpt"))
    return inp


def _start(world, path, out_dir, mode):
    os.makedirs(out_dir, exist_ok=True)
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_spmd_worker.py"),
         str(r), str(world), str(port), path, out_dir, mode],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def _join(procs, out_dir):
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(err[-4000:])
    assert not errs, "\n".join(errs)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(len(procs))]


def run_all(tmp: str, archs, extras: bool) -> dict:
    """The port's groups and JAX's child on ``archs``; with ``extras`` the
    checkpoint save and restores, the refusals and the pinned MoE
    gradient as well.  The groups run side by side: the port's save
    before JAX's child (which restores it), the restores after it (one
    restores JAX's checkpoint)."""
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **inputs(tmp, archs, extras))

    def start(world, mode, name, inp=path):
        return _start(world, inp, os.path.join(tmp, name), mode), name

    def join(group):
        return _join(group[0], os.path.join(tmp, group[1]))

    groups = {w: start(w, "steps", f"steps{w}") for w in MESHES}
    if extras:
        refuse = start(2, "refuse", "refuse")
        join(start(4, "save", "save"))
    ref = os.path.join(tmp, "jax.npz")
    jax_proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, path, ref],
                              env=_env(), cwd=ROOT, capture_output=True,
                              text=True, timeout=TIMEOUT)
    assert jax_proc.returncode == 0, jax_proc.stderr[-4000:]
    restores = {}
    if extras:
        for name in ("port_dir", "jax_dir"):
            inp = dict(np.load(path))
            inp["ck/dir"] = inp["ck/" + name]
            p2 = os.path.join(tmp, f"restore_{name}.npz")
            np.savez(p2, **inp)
            restores[name] = start(2, "restore", f"restore_{name}", p2)
    out = {"inp": dict(np.load(path)), "jax": dict(np.load(ref)),
           "steps": {w: join(g) for w, g in groups.items()}}
    if extras:
        out["restore"] = {k: join(g) for k, g in restores.items()}
        out["refuse"] = join(refuse)
    return out


def _blocks(rank_out, prefix):
    """(name, local block, offset) of every output under ``prefix``."""
    for k, v in rank_out.items():
        if k.startswith(prefix) and "@" not in k and k + "@off" in rank_out:
            yield k, v, rank_out[k + "@off"]


def _at(full, local, off):
    return full[tuple(slice(o, o + n) for o, n in zip(off, local.shape))]


@functools.lru_cache(maxsize=None)
def _f32_noise(arch) -> float:
    """The port's f32 gradients' distance from its f64 ones on the train
    batch (one process, no mesh), relative to the largest."""
    inp = inputs("", [arch], False)
    cfg = tcfg.smoke_config(arch)
    flat = {k[len(arch) + 3:]: v for k, v in inp.items()
            if k.startswith(arch + "/p/")}
    batch = {"tokens": torch.from_numpy(inp[arch + "/ttok"]).long(),
             "targets": torch.from_numpy(inp[arch + "/ttgt"]).long()}
    grads = {}
    for dt in (torch.float32, torch.float64):
        params = _unflatten({k: torch.from_numpy(v).to(dt).requires_grad_(
            True) for k, v in flat.items()})
        ttf.lm_loss(params, batch, cfg).backward()
        grads[dt] = [t.grad.double() for t in tree_leaves(params)]
    scale = max(float(g.abs().max()) for g in grads[torch.float64])
    return max(float((a - b).abs().max()) for a, b in zip(
        grads[torch.float32], grads[torch.float64])) / scale


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _port_sh(cfg, kind, m):
    shape = ShapeConfig("spmd_" + kind, S_MAX if kind != "train" else S, B,
                        kind)
    return tshard.cell_shardings(cfg, shape, m)


def _want_off(sharding, full_shape, coords):
    block = local_block(full_shape, sharding.spec, sharding.mesh, coords)
    return [s.start for s in block]


def cases(archs):
    """(arch, step) of every serve step the inputs of ``archs`` run."""
    return [(a, kind) for a in archs for kind in
            ("prefill",) + tuple("decode_" + b for b in BRANCHES[a])]


def check_serve(runs, arch, kind, world):
    """Each rank's blocks of a serve step's outputs against JAX's values
    there; the cache's blocks where JAX's output shardings put them."""
    tag = "%dx%d" % MESHES[world]
    ref_kind = "decode_gather" if kind == "decode_seq_shard" else kind
    cfg = tcfg.smoke_config(arch)
    m = tmesh.make_mesh(MESHES[world], ("data", "model"))
    c_sh = _port_sh(cfg, "prefill", m)["cache"]
    n = 0
    for r in runs["steps"][world]:
        coords = dict(zip(("data", "model"), r["coords"]))
        for name, local, off in _blocks(r, f"{arch}/{kind}/"):
            leaf = name.split("/")[-1]
            want = runs["jax"][f"{tag}/{arch}/{ref_kind}/"
                               + name.split("/", 2)[2]]
            got_full_shape = tuple(r[name + "@shape"])
            assert got_full_shape == want.shape, (name, want.shape)
            err = np.abs(local - _at(want, local, off)).max()
            # 1e-5 of the output's magnitude (the K/V rows reach ~20)
            tol = (MOE_TOL if cfg.family == "moe" else F32_TOL) * max(
                1.0, float(np.abs(want).max()))
            assert err <= tol, (name, world, err, tol)
            if "/cache/" in name:
                assert list(off) == _want_off(c_sh[leaf], want.shape,
                                              coords), (name, off)
            n += 1
    # a lazy step writes the caller's cache in place (on the ranks that hold
    # the new position), the others leave it as it was
    if kind.startswith("decode_"):
        kept = [bool(r[f"{arch}/{kind}/kept"]) for r in runs["steps"][world]]
        assert all(kept) == (kind != "decode_lazy"), kept
    assert n >= 2


def check_train(runs, arch, world):
    """Each rank's blocks of the train step's params and state against
    JAX's, where JAX's output shardings put them, and the loss."""
    tag = "%dx%d" % MESHES[world]
    cfg = tcfg.smoke_config(arch)
    m = tmesh.make_mesh(MESHES[world], ("data", "model"))
    t_sh = _port_sh(cfg, "train", m)
    flat_sh = _flat({"params": t_sh["params"], "opt": t_sh["opt_state"]},
                    "")
    jx = runs["jax"]
    mu_max, nu_max = (max(np.abs(v).max() for k, v in jx.items()
                          if k.startswith(f"{tag}/{arch}/train/opt/{m}/"))
                      for m in ("mu", "nu"))
    opt = AdamWConfig(**TRAIN_OPT)
    lr1 = float(lr_at(opt, torch.ones((), dtype=torch.int32)))
    grad_tol = max(GRAD_TOL, GRAD_FACTOR * _f32_noise(arch))
    # mu is (1 - b1) times the clipped gradient; a master weight moves by
    # lr times a function of its gradient whose slope is at most 1
    master_tol = lr1 * grad_tol * mu_max / (1 - opt.b1)
    for r in runs["steps"][world]:
        coords = dict(zip(("data", "model"), r["coords"]))
        assert abs(float(r[f"{arch}/train/loss"])
                   - float(jx[f"{tag}/{arch}/train/loss"])) <= LOSS_ATOL
        for name, local, off in _blocks(r, f"{arch}/train/"):
            rel = name.split("/", 2)[2]               # params/... opt/...
            want = jx[f"{tag}/{arch}/train/{rel}"]
            assert list(off) == _want_off(flat_sh[rel], want.shape,
                                          coords), (rel, off)
            got, ref = local, _at(want, local, off)
            part = rel.split("/")[1]
            if rel.startswith("opt/") and part == "count":
                assert got == ref
            elif part == "mu":
                assert np.abs(got - ref).max() <= grad_tol * mu_max, rel
            elif part == "nu":                 # (1 - b2) g^2
                assert np.abs(got - ref).max() <= 2 * grad_tol * nu_max, rel
            elif part == "master":
                bound = master_tol + MASTER_RTOL * np.abs(ref) + MASTER_ATOL
                assert (np.abs(got - ref) <= bound).all(), (
                    rel, float((np.abs(got - ref) - bound).max()))
            else:
                # the params are the port's master cast to bf16: within
                # one bf16 rounding (2^-8 of the value) of JAX's master
                # where the masters agree as above
                m_ref = _at(jx[f"{tag}/{arch}/train/opt/master/"
                               + rel.split("/", 1)[1]], local, off)
                m_bound = (master_tol + MASTER_RTOL * np.abs(m_ref)
                           + MASTER_ATOL)
                bound = 2.0 ** -8 * (np.abs(m_ref) + m_bound) + m_bound
                assert (np.abs(got - m_ref) <= bound).all(), rel


def check_bytes(runs, arch, kind, world):
    """Each rank's placed input bytes equal the dry run's, exactly."""
    for r in runs["steps"][world]:
        got = {k.rsplit("/", 1)[1]: int(v) for k, v in r.items()
               if k.startswith(f"{arch}/bytes/{kind}/")}
        want = {k.rsplit("/", 1)[1]: int(v) for k, v in r.items()
                if k.startswith(f"{arch}/want_bytes/{kind}/")}
        assert got == want and sum(got.values()) > 0




# ---------------------------------------------------------------------------
# the dry run's step on (2, 2) against JAX's per-device dot flops
# (tests/test_torch_spmd_dryrun*.py)
# ---------------------------------------------------------------------------

FLOPS_TOL = 0.10

DRYRUN_JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import smoke_config, smoke_shape
from repro.distributed.sharding import use_mesh
from repro.launch import shardings as sh
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.mesh import make_mesh_compat
from repro.models import api, transformer as tf
from repro.models.param import abstract_params
from repro.training.optimizer import abstract_opt_state
from repro.training.step import make_train_step

out = {}
mesh = make_mesh_compat((2, 2), ("data", "model"))
for a in sys.argv[1].split(","):
    for k in ("prefill", "decode", "train"):
        cfg, shape = smoke_config(a), smoke_shape(k)
        with use_mesh(mesh):
            defs = tf.model_defs(cfg)
            ps = abstract_params(defs)
            psh = sh.params_shardings(defs, mesh, k)
            bs = api.batch_struct(cfg, shape)
            bsh = sh.batch_shardings(bs, mesh)
            if k == "train":
                osh = sh.opt_shardings(psh)
                low = jax.jit(make_train_step(cfg, n_micro=1),
                              in_shardings=(psh, osh, bsh),
                              out_shardings=(psh, osh, None)).lower(
                    ps, abstract_opt_state(ps), bs)
            else:
                cs = api.cache_struct(cfg, shape)
                csh = sh.cache_shardings(cs, cfg, mesh)
                fn = (api.make_prefill_fn(cfg) if k == "prefill"
                      else api.make_decode_fn(cfg))
                low = jax.jit(fn, in_shardings=(psh, bsh, csh),
                              out_shardings=(None, csh)).lower(ps, bs, cs)
            c = low.compile(compiler_options={
                "xla_backend_optimization_level": 0})
            out[f"{a}/{k}"] = analyze_hlo(c.as_text())["dot_flops_per_dev"]
print(json.dumps(out))
"""


def start_jax_flops(archs):
    """JAX's per-device dot flops of the (2, 2) cells of ``archs``,
    computed in a child process (returned running)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")
           + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", DRYRUN_JAX_SCRIPT,
                             ",".join(archs)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def jax_flops_of(proc, memo):
    if "out" not in memo:
        out, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, err[-3000:]
        memo["out"] = json.loads(out.strip().splitlines()[-1])
    return memo["out"]


def check_rank0_flops(jax_out, arch, kind):
    """Rank 0's matrix-product flops of the sharded step on (2, 2) within
    :data:`FLOPS_TOL` of JAX's per device (after ``train_gap`` at the
    rank's tokens, for train)."""
    from test_torch_dryrun import train_gap
    from repro_torch.configs import smoke_config, smoke_shape
    from repro_torch.launch import dryrun
    cfg, shape = smoke_config(arch), smoke_shape(kind)
    with dryrun.fake_group(dryrun._mesh("2x2")) as mesh:
        rec = dryrun.step_record(cfg, shape, mesh=mesh)
    mm = sum(r["flops"] for r in rec["by_op"].values())
    assert mm == rec["flops"] > 0
    # a rank's collectives: the partial sums and the gathers GSPMD inserts
    assert rec["collectives"]["counts"].get("all-reduce", 0) > 0
    want = jax_out[f"{arch}/{kind}"]
    if kind == "train":
        # the gap at the rank's tokens: the batch splits over "data"
        rank = ShapeConfig(shape.name, shape.seq_len,
                           shape.global_batch // mesh.shape["data"], "train")
        mm -= train_gap(cfg, rank)
    assert abs(mm - want) <= FLOPS_TOL * want, (mm, want)


