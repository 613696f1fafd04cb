"""The port's checkpoints, restart runner and data copies: the cases of
tests/test_ft.py on the port, checkpoints crossing between the two packages
bit for bit, the straggler case, a restarted training run equal to a clean
one, and the data pipeline's batches against the JAX package's."""
import ast
import dataclasses
import json
import pathlib
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jpipe
from repro.data import tasks as jtasks
from repro_torch.checkpoint.checkpoint import (latest_step,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               wait_for_async_saves)
from repro_torch.configs import smoke_config
from repro_torch.data import pipeline as tpipe
from repro_torch.data import tasks as ttasks
from repro_torch.ft.failures import (FailurePlan, FaultTolerantRunner,
                                     FTConfig)
from repro_torch.launch.train import train_full


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.randn(5, 7, generator=g).bfloat16(),
                       "c": torch.tensor(3, dtype=torch.int32),
                       "d": torch.randn(2, 3, 4, generator=g)},
            "seq": [torch.ones(2), torch.zeros((), dtype=torch.int32)]}


def _assert_same(a_tree, b_tree):
    fa, fb = jax.tree.leaves(a_tree), jax.tree.leaves(b_tree)
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    back = restore_checkpoint(str(tmp_path), 5, tree)
    _assert_same(tree, back)
    assert isinstance(back["seq"], list)


def test_checkpoint_gc_keeps_latest(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [4, 5]


def test_async_save(tmp_path):
    tree = {"x": torch.arange(1000.0)}
    save_checkpoint(str(tmp_path), 1, tree, blocking=False)
    # the host copy is taken before the call returns: a later change to
    # the tensor does not reach the file
    tree["x"].add_(1.0)
    wait_for_async_saves()
    assert latest_step(str(tmp_path)) == 1
    back = restore_checkpoint(str(tmp_path), 1, tree)
    assert torch.equal(back["x"], torch.arange(1000.0))


def _jax_tree(tree):
    """The same tree as JAX arrays (bf16 through its exact f32)."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(one, tree)


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _tree()
    jtree = _jax_tree(tree)
    jckpt.save_checkpoint(str(tmp_path), 3, jtree)
    assert latest_step(str(tmp_path)) == 3
    back = restore_checkpoint(str(tmp_path), 3, tree)
    _assert_same(tree, back)


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 4, tree)
    jtree = _jax_tree(tree)
    assert jckpt.latest_step(str(tmp_path)) == 4
    back = jckpt.restore_checkpoint(str(tmp_path), 4, jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the manifests' keys are the JAX package's
    keys = set(json.loads((tmp_path / "step_4" / "manifest.json")
                          .read_text())["arrays"])
    jckpt.save_checkpoint(str(tmp_path / "j"), 4, jtree)
    assert keys == set(json.loads((tmp_path / "j" / "step_4" /
                                   "manifest.json").read_text())["arrays"])
    assert "nested::b" in keys and "seq::#1" in keys


def _make_counter_runner(plan, ckpt_every=2, slow_at=None):
    """Deterministic integer 'training': state = prod of per-step factors.
    Step ``slow_at`` takes 0.3 s."""
    saves = {}

    def step_fn(state, i):
        if i == slow_at:
            time.sleep(0.3)
        return {"v": state["v"] * (i + 2) % 1_000_003}

    def save_fn(step, state):
        saves[step] = dict(state)

    def restore_fn():
        if not saves:
            return None
        s = max(saves)
        return s, dict(saves[s])

    return FaultTolerantRunner(FTConfig(ckpt_every=ckpt_every), step_fn,
                               save_fn, restore_fn, plan=plan), saves


def test_restart_resumes_and_matches_no_failure_run():
    clean, _ = _make_counter_runner(FailurePlan())
    ref = clean.run({"v": 1}, 9)
    faulty, _ = _make_counter_runner(FailurePlan(fail_at_steps=(3, 7)))
    out = faulty.run({"v": 1}, 9)
    assert out == ref
    assert faulty.state.restarts == 2


@pytest.mark.parametrize("slow_at", [None, 6])
def test_straggler_resumes_from_the_slow_steps_state(slow_at):
    """A straggler is flagged and the run goes on from the state the slow
    step returned, so the final state equals a clean run's.  The JAX
    runner goes on from the state its segment started with, which is stale
    by then: its restart test fails whenever a host hiccup raises a
    spurious straggler flag.  ``FailurePlan``'s injected delay sleeps
    before the timed step (as in the JAX copy), so it is flagged only when
    the step after the sleep happens to run slow; a step that is itself
    slow (``slow_at``) is always flagged."""
    clean, _ = _make_counter_runner(FailurePlan())
    ref = clean.run({"v": 1}, 10)
    runner, _ = _make_counter_runner(
        FailurePlan(straggle_at_steps=(6,), straggle_seconds=0.3),
        slow_at=slow_at)
    runner.cfg = FTConfig(ckpt_every=100, straggler_factor=5.0)
    out = runner.run({"v": 1}, 10)
    assert out == ref
    if slow_at is not None:
        assert runner.state.excluded_nodes >= 1
        assert any("step 6 took" in h["event"]
                   for h in runner.state.history)


def test_train_resume_bitwise(tmp_path):
    """Full train loop: a failure at step 6, resumed from the step-5
    checkpoint, ends on the parameters and optimizer state of an
    uninterrupted run, bit for bit."""
    cfg = smoke_config("qwen3-1.7b")
    kw = dict(steps=8, batch=2, seq=32, ckpt_every=5, device="cpu")
    ref = train_full(cfg, ckpt_dir=str(tmp_path / "ref"), **kw)
    out = train_full(cfg, ckpt_dir=str(tmp_path / "faulty"),
                     plan=FailurePlan(fail_at_steps=(6,)), **kw)
    _assert_same(ref, out)
    assert int(out["opt"]["count"]) == 8
    assert latest_step(str(tmp_path / "faulty")) == 8
    last = restore_checkpoint(str(tmp_path / "faulty"), 8, out)
    _assert_same(out, last)


SPECS = [jtasks.make_task(t, vocab=56) for t in range(7)] + [
    jtasks.TaskSpec(task_id=100, kind="rotate", seed=3, vocab=32, in_len=8,
                    instr_len=2)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s.kind}{s.task_id}")
def test_data_batches_match_jax(spec):
    tspec = ttasks.TaskSpec(**dataclasses.asdict(spec))
    jl = jpipe.TaskDataLoader(spec, 4, 40, base_seed=7)
    tl = tpipe.TaskDataLoader(tspec, 4, 40, base_seed=7)
    for step in (0, 1, 5, 123):
        want, got = jl.batch_at(step), tl.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert dataclasses.asdict(ttasks.make_task(spec.task_id, vocab=56)) == \
        dataclasses.asdict(jtasks.make_task(spec.task_id, vocab=56))


def test_mixture_and_resumable_iterator_match_jax():
    jspecs = SPECS[:3]
    tspecs = [ttasks.make_task(t, vocab=56) for t in range(3)]
    jg = jpipe.mixture_loader(jspecs, 4, 32, base_seed=5)(2)
    tg = tpipe.mixture_loader(tspecs, 4, 32, base_seed=5)(2)
    for _ in range(7):
        a, b = next(jg), next(tg)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    it = tpipe.TaskDataLoader(tspecs[1], 2, 32, base_seed=1).iterate(4)
    ref = jpipe.TaskDataLoader(jspecs[1], 2, 32, base_seed=1)
    for step in (4, 5, 6):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"],
                                      ref.batch_at(step)["tokens"])
    it.close()


PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    PORT.parents[1] / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(PORT.parents[1])))
def test_port_imports_no_ml_dtypes(path):
    """bf16 crosses through torch views: the card's machine has no
    ml_dtypes, so no port file (nor chip_smoke.py) may import it."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert "ml_dtypes" not in roots
