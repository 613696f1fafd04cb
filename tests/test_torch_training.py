"""The port's training path against the JAX package: the AdamW schedule and
update, the loss and its gradients (full and LoRA) on every training
branch, 20-step loss trajectories of both train steps, and the LoRA
collection launcher's files.  Parameters, adapters and optimizer states
are initialised by JAX and carried across with `repro_torch.convert`."""
import dataclasses as dc
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.data import tasks as jtasks
from repro.data.pipeline import mixture_loader
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.models.lora import LoRAContext as JCtx
from repro.models.param import init_params as jax_init
from repro.training import optimizer as jopt
from repro.training import step as jstep
from repro_torch import configs as tcfg
from repro_torch.convert import to_numpy, to_torch
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttf
from repro_torch.models.lora import LoRAContext as TCtx
from repro_torch.training import optimizer as topt
from repro_torch.training import step as tstep

# the loss is a mean over tokens of f32 terms: both frameworks sum it in
# other orders
LOSS_ATOL = 1e-5
# gradients, relative to the largest gradient's magnitude: f32 runs of
# either framework sit ~7e-5 of it from an f64 run on this fixture (the
# embedding's gradient sums over positions), and 2e-5..5e-5 from each other
GRAD_TOL = 1e-4
# with grad_cast_bf16 each layer-boundary cotangent is rounded to bf16;
# where the two frameworks' f32 cotangents (which differ as above) straddle
# a rounding midpoint, the rounded values differ by one bf16 ulp, which is
# up to 2**-7 of the value: the gradients are held to that
GRAD_TOL_BF16_BOUNDARY = 2.0 ** -7
# bf16 runs: tests/test_torch_model.py's tolerance, one bf16 ulp at logit
# magnitude, against JAX with excess precision off
BF16_ATOL = 8e-3
# the f32 trajectories' losses, per step, relative
TRAJ_RTOL = 1e-4

FIXTURE = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
               d_ff=128, vocab_size=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**extra):
    return (dc.replace(smoke_config("mistral-7b"), **FIXTURE, **extra),
            dc.replace(tcfg.smoke_config("mistral-7b"), **FIXTURE, **extra))


@functools.lru_cache(maxsize=None)
def _jax_params(dtype="f32"):
    jcfg, _ = _cfgs()
    override = jnp.float32 if dtype == "f32" else None
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(jtf.model_defs(jcfg), key,
                             dtype_override=override))(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_lora(seed=1):
    """JAX-initialised f32 adapters with ``b`` drawn too (it starts at zero,
    which would leave ``a`` without a gradient)."""
    jcfg, _ = _cfgs()
    lp = jax.tree.map(np.asarray, jax_init(jtf.lora_defs_tree(jcfg),
                                           jax.random.PRNGKey(seed),
                                           dtype_override=jnp.float32))
    rng = np.random.default_rng(seed)
    for t in lp["layers"].values():
        t["b"] = (0.05 * rng.standard_normal(t["b"].shape)).astype(np.float32)
    return lp


def _batch(seed=0, B=4, S=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 64, (B, S)).astype(np.int32),
            "targets": rng.integers(-1, 64, (B, S)).astype(np.int32)}


def _jnp(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _th(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _proto(cfg, ctx_cls):
    return ctx_cls(mode="single", params=None,
                   scaling=cfg.lora.alpha / cfg.lora.rank)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(warmup_steps=10, total_steps=60),
                                dict(warmup_steps=0, total_steps=150,
                                     min_lr_ratio=0.0, lr=3e-3)])
def test_lr_schedule_matches_jax(kw):
    steps = np.arange(0, 201, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jopt.AdamWConfig(**kw),
                                                    s))(jnp.asarray(steps)))
    got = topt.lr_at(topt.AdamWConfig(**kw), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(clip, param_dtype):
    """Three updates carried on both sides from the same JAX state (the
    state crosses once, through convert), with gradients large enough that
    clipping at 1.0 binds."""
    jd = jnp.float32 if param_dtype == "f32" else jnp.bfloat16
    td = torch.float32 if param_dtype == "f32" else torch.bfloat16
    jcfg = jopt.AdamWConfig(grad_clip=clip, warmup_steps=2, total_steps=5)
    tcfg_ = topt.AdamWConfig(grad_clip=clip, warmup_steps=2, total_steps=5)
    params = _jax_params("f32")
    jstate = jopt.init_opt_state(jax.tree.map(jnp.asarray, params))
    tstate = to_torch(jax.tree.map(np.asarray, jstate))
    assert tstate["count"].shape == () and tstate["count"].dtype == torch.int32
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = jax.tree.map(lambda p: (0.3 * rng.standard_normal(p.shape))
                         .astype(np.float32), params)
        jp, jstate, jm = jopt.adamw_update(jcfg, jax.tree.map(jnp.asarray, g),
                                           jstate, param_dtype=jd)
        tp, tstate, tm = topt.adamw_update(tcfg_, to_torch(g), tstate,
                                           param_dtype=td)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        for part in ("master", "mu", "nu"):
            for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray,
                                                         jstate[part])),
                            jax.tree.leaves(to_numpy(tstate[part]))):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
        assert int(tstate["count"]) == int(jstate["count"])
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            assert b.dtype == td
            # the port's params are its own master cast; against JAX's
            # within one rounding of the cast
            ulp = 2.0 ** -7 if param_dtype == "bf16" else 1e-6
            np.testing.assert_allclose(
                to_numpy({"x": b})["x"], np.asarray(a, np.float32),
                rtol=ulp, atol=1e-9)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

# every training branch of the forward and the loss: S = 24 > attn_chunk_q
# runs chunked_attention; logits_chunk_vocab 64 splits the padded 256-token
# vocab into 4 chunks of the online logsumexp
BRANCHES = {
    "naive_attn": dict(attn_chunk_q=0),
    "chunked_attn": dict(attn_chunk_q=8, attn_chunk_kv=8),
    "chunked_ce": dict(logits_chunk_vocab=64),
    "no_remat": dict(remat=False),
    "grad_cast_bf16": dict(grad_cast_bf16=True),
}


def _max_rel(want_tree, got_tree):
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    got = jax.tree.leaves(to_numpy(got_tree))
    assert [w.shape for w in want] == [g.shape for g in got]
    scale = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(w - g).max()) for w, g in zip(want, got)) / scale


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("target", ["full", "lora"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_loss_and_grads_match_jax(branch, target, n_micro):
    jcfg, cfg = _cfgs(**BRANCHES[branch])
    params = _jax_params("f32")
    batch = _batch()
    if target == "full":
        jl, jg = jax.jit(jstep.make_train_step(
            jcfg, n_micro=n_micro, with_opt=False))(
            jax.tree.map(jnp.asarray, params), _jnp(batch))
        tl, tg = tstep.make_train_step(cfg, n_micro=n_micro,
                                       with_opt=False)(to_torch(params),
                                                       _th(batch))
    else:
        lora = _jax_lora()
        jbase = jax.tree.map(jnp.asarray, params)
        jproto = _proto(jcfg, JCtx)

        def jloss(lp, b):
            return jtf.lm_loss(jbase, b, jcfg, lora_params=lp,
                               lora_ctx_proto=jproto)

        jl, jg = jax.jit(lambda lp, b: jstep._microbatch_grads(
            jloss, lp, b, n_micro))(jax.tree.map(jnp.asarray, lora),
                                    _jnp(batch))
        tbase, tproto = to_torch(params), _proto(cfg, TCtx)
        tl, tg = tstep._microbatch_grads(
            lambda lp, b: ttf.lm_loss(tbase, b, cfg, lora_params=lp,
                                      lora_ctx_proto=tproto),
            to_torch(lora), _th(batch), n_micro)
    assert tl.dtype == torch.float32
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    tol = GRAD_TOL_BF16_BOUNDARY if branch == "grad_cast_bf16" else GRAD_TOL
    assert _max_rel(jg, tg) <= tol, (branch, target, _max_rel(jg, tg))


def test_bf16_grad_boundary_matches_jax_vjp():
    """The boundary alone, on one cotangent: identity forward, the f32
    cotangent rounded through bf16 bit for bit as JAX's custom VJP does, a
    bf16 cotangent passed unchanged."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    g = (rng.standard_normal((2, 5, 8)) * 10.0 ** rng.integers(
        -6, 6, (2, 5, 8))).astype(np.float32)
    _, vjp = jax.vjp(jtf._bf16_grad_boundary, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ttf._bf16_grad_boundary(xt)
    assert torch.equal(y, xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    xb = xt.detach().bfloat16().requires_grad_(True)
    gb = torch.from_numpy(g).bfloat16()
    (got_b,) = torch.autograd.grad(ttf._bf16_grad_boundary(xb), xb, gb)
    assert torch.equal(got_b, gb)


def test_remat_changes_no_bit():
    """Recomputing each layer in the backward pass gives the gradients of
    the plain backward bit for bit (the port's own two paths)."""
    out = []
    for remat in (True, False):
        _, cfg = _cfgs(remat=remat)
        out.append(tstep.make_train_step(cfg, with_opt=False)(
            to_torch(_jax_params("f32")), _th(_batch())))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(jax.tree.leaves(to_numpy(out[0][1])),
                    jax.tree.leaves(to_numpy(out[1][1]))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

TRAJ_STEPS, TRAJ_BATCH, TRAJ_SEQ = 20, 32, 24
DROP = {"full": 0.1, "lora": 0.01}


def _traj_specs():
    """tests/test_system.py's task family: rotations over a 32-token vocab
    with 8-token inputs (tokens reach id 36 of the 64)."""
    return [jtasks.TaskSpec(task_id=100 + i, kind="rotate", seed=s, vocab=32,
                            in_len=8, instr_len=2)
            for i, s in enumerate((3, 11, 29))]


def _traj_batches(n):
    gen = mixture_loader(_traj_specs(), TRAJ_BATCH, TRAJ_SEQ, base_seed=5)(0)
    return [next(gen) for _ in range(n)]


OPT = {"full": dict(lr=3e-3, warmup_steps=30, total_steps=600),
       "lora": dict(lr=1e-2, weight_decay=0.0, warmup_steps=10,
                    total_steps=120)}


def _jax_run(kind, dtype, n):
    """JAX's ``n`` steps of the fixture from its initialisation: ``full``
    through make_train_step (test_system.py's pretraining schedule),
    ``lora`` through make_lora_train_step on a frozen base.  Returns the
    base, the trained state before each step (numpy) and each step's loss."""
    jcfg, _ = _cfgs()
    base = jax.tree.map(jnp.asarray, _jax_params(dtype))
    cfg_opt = jopt.AdamWConfig(**OPT[kind])
    if kind == "full":
        f = jstep.make_train_step(jcfg, cfg_opt)
        step = jax.jit(lambda base, p, o, b: f(p, o, b))
        trained = base
    else:
        step = jax.jit(jstep.make_lora_train_step(jcfg, cfg_opt))
        trained = jax.tree.map(jnp.asarray, _jax_lora())
    state = (trained, jopt.init_opt_state(trained))
    states, losses = [], []
    for b in _traj_batches(n):
        states.append(jax.tree.map(np.asarray, state))
        p, o, m = step(base, *state, _jnp(b))
        state = (p, o)
        losses.append(float(m["loss"]))
    return jax.tree.map(np.asarray, base), states, np.asarray(losses)


def _port_step(kind):
    _, cfg = _cfgs()
    cfg_opt = topt.AdamWConfig(**OPT[kind])
    if kind == "full":
        f = tstep.make_train_step(cfg, cfg_opt)
        return lambda base, p, o, b: f(p, o, b)
    return tstep.make_lora_train_step(cfg, cfg_opt)


def _port_loss(kind, base, trained, batch):
    _, cfg = _cfgs()
    with torch.no_grad():
        if kind == "full":
            return float(ttf.lm_loss(trained, batch, cfg))
        return float(ttf.lm_loss(base, batch, cfg, lora_params=trained,
                                 lora_ctx_proto=_proto(cfg, TCtx)))


def _port_trajectory(kind, dtype, n):
    base = to_torch(_jax_params(dtype))
    trained = base if kind == "full" else to_torch(_jax_lora())
    state = (trained, topt.init_opt_state(trained))
    step = _port_step(kind)
    losses = []
    for b in _traj_batches(n):
        p, o, m = step(base, *state, _th(b))
        state = (p, o)
        losses.append(float(m["loss"]))
    return np.asarray(losses)


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_f32_trajectory_matches_jax(kind, monkeypatch):
    """20 steps in f32 along JAX's trajectory: at each step the port steps
    from JAX's state (parameters, moments, count), its loss within
    TRAJ_RTOL of JAX's, and the state it returns, evaluated on the next
    batch, within TRAJ_RTOL of JAX's next loss.

    Step by step, not free-running: on this fixture f32 training is
    chaotic, so two correct f32 runs part after ~6 steps (JAX's own jitted
    and op-by-op runs of this trajectory differ by up to 6.8e-3 of the loss
    at step 19, the port's free run by 1.4e-2), while each step agrees to
    ~4e-7.  The free run is held to learning as JAX does.

    A full step casts the updated parameters to bf16 in both packages; here
    both keep them in f32 (the same patch on each side), so that the whole
    trajectory runs in f32 (the bf16 path is the next test's)."""
    monkeypatch.setattr(jstep, "adamw_update", functools.partial(
        jopt.adamw_update, param_dtype=jnp.float32))
    monkeypatch.setattr(tstep, "adamw_update", functools.partial(
        topt.adamw_update, param_dtype=torch.float32))
    base, states, losses = _jax_run(kind, "f32", TRAJ_STEPS + 1)
    # the trajectory moves (a check that runs no update cannot pass): the
    # adapters on the random base learn less in 20 steps than the model
    assert losses[-1] < losses[0] - DROP[kind], losses
    tbase, step = to_torch(base), _port_step(kind)
    batches = [_th(b) for b in _traj_batches(TRAJ_STEPS + 1)]
    for i in range(TRAJ_STEPS):
        p, o, m = step(tbase, *map(to_torch, states[i]), batches[i])
        assert abs(float(m["loss"]) - losses[i]) <= TRAJ_RTOL * losses[i], i
        nxt = _port_loss(kind, tbase, p, batches[i + 1])
        assert abs(nxt - losses[i + 1]) <= TRAJ_RTOL * losses[i + 1], i
    free = _port_trajectory(kind, "f32", TRAJ_STEPS)
    assert np.all(np.isfinite(free)) and free[-1] < free[0] - DROP[kind], free


BF16_STEPS = 5


@pytest.fixture(scope="module")
def bf16_trajectories(tmp_path_factory):
    """JAX's bf16 trajectories, from a child process with XLA's excess
    precision off (as tests/test_torch_model.py computes its bf16
    references): XLA otherwise keeps fused bf16 intermediates at f32 where
    eager torch rounds every op."""
    path = tmp_path_factory.mktemp("bf16traj") / "losses.npz"
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                                      " --xla_allow_excess_precision=false"))
    subprocess.run([sys.executable, __file__, str(path)], env=env,
                   check=True, timeout=300)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_bf16_trajectory_matches_jax(kind, bf16_trajectories):
    """5 steps from the configs' bf16 parameters, the packages' defaults
    throughout (a full step keeps bf16 parameters, f32 master weights)."""
    got = _port_trajectory(kind, "bf16", BF16_STEPS)
    np.testing.assert_allclose(got, bf16_trajectories[kind], rtol=0,
                               atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# launcher and API
# ---------------------------------------------------------------------------


def test_lora_collection_writes_the_jax_launchers_files(tmp_path):
    jcfg, cfg = _cfgs()
    specs = _traj_specs()[:2]
    kw = dict(n_tasks=2, steps=2, batch=4, seq=24, specs=specs,
              log_every=10_000)
    jres = jtrain.train_lora_collection(
        jcfg, out_dir=str(tmp_path / "jax"),
        base_params=jax.tree.map(jnp.asarray, _jax_params("f32")), **kw)
    tres = ttrain.train_lora_collection(
        cfg, out_dir=str(tmp_path / "port"),
        base_params=to_torch(_jax_params("f32")), device="cpu", **kw)
    for t in range(2):
        with np.load(tmp_path / "jax" / f"lora_task{t}.npz") as zj, \
                np.load(tmp_path / "port" / f"lora_task{t}.npz") as zt:
            assert zt.files == zj.files
            for k in zj.files:
                assert (zt[k].shape, zt[k].dtype) == (zj[k].shape,
                                                      zj[k].dtype), k
                assert np.all(np.isfinite(zt[k]))
    sj = json.loads((tmp_path / "jax" / "summary.json").read_text())
    st = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert list(st) == list(sj) == ["0", "1"]
    for t in st:
        assert sorted(st[t]) == sorted(sj[t])
        assert st[t]["kind"] == sj[t]["kind"]
        assert np.isfinite(st[t]["final_loss"])
    assert [r["kind"] for r in tres.values()] == [s.kind for s in specs]
    assert set(jres) == set(tres)


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--lora-collection", "1"]):
        monkeypatch.setattr(sys, "argv", [
            "train", "--arch", "mistral-7b", "--smoke", "--steps", "1",
            "--out", str(tmp_path)] + extra)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main()


def test_api_step_functions():
    jcfg, cfg = _cfgs()
    params = to_torch(_jax_params("f32"))
    batch = _th(_batch())
    assert torch.equal(tapi.make_loss_fn(cfg)(params, batch),
                       ttf.lm_loss(params, batch, cfg))
    cache = ttf.init_cache(cfg, 4, 32, device="cpu", dtype=torch.float32)
    lg, cache = tapi.make_prefill_fn(cfg)(params, batch, cache)
    want, _ = ttf.prefill(params, batch, cfg, ttf.init_cache(
        cfg, 4, 32, device="cpu", dtype=torch.float32))
    assert torch.equal(lg, want)
    lg2, _ = tapi.make_decode_fn(cfg)(
        params, {"tokens": lg.argmax(-1)}, cache)
    assert lg2.shape == (4, 1, cfg.padded_vocab)
    for kind in ("train", "prefill", "decode"):
        fn = tapi.step_fn_for(cfg, ShapeConfig("x", 24, 4, kind))
        jfn = japi.step_fn_for(jcfg, ShapeConfig("x", 24, 4, kind))
        assert fn.__name__ == jfn.__name__, kind
    loss, grads = tapi.step_fn_for(cfg, ShapeConfig("x", 24, 4, "train"),
                                   with_opt=False)(params, batch)
    assert torch.equal(loss, tapi.make_loss_fn(cfg)(params, batch))


@pytest.mark.parametrize("arch,batch,seq,shards", [
    ("mistral-7b", 256, 4096, 16), ("mistral-7b", 8, 64, 1),
    ("qwen1.5-110b", 256, 4096, 32), ("whisper-small", 64, 1500, 4)])
def test_auto_microbatches_matches_jax(arch, batch, seq, shards):
    from repro.configs import get_config as jget
    shape = ShapeConfig("x", seq, batch, "train")
    assert tstep.auto_microbatches(tcfg.get_config(arch), shape, shards) == \
        jstep.auto_microbatches(jget(arch), shape, shards)


if __name__ == "__main__":
    # child process of the bf16_trajectories fixture
    np.savez(sys.argv[1], **{k: _jax_run(k, "bf16", BF16_STEPS)[2]
                             for k in ("full", "lora")})
