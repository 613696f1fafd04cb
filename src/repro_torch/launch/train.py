"""Training launcher: full fine-tuning or per-task LoRA-collection training,
with fault-tolerant checkpoint/restart (the port of
``repro/launch/train.py``).  Runs on the CUDA card unless ``--device cpu``
is given; weights are drawn from a seeded ``torch.Generator`` on the
target device.

Examples
--------
  # smoke-scale full training on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 64

  # train a collection of per-task LoRAs (the paper's §5.1 at small scale)
  PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-7b \\
      --smoke --device cpu --lora-collection 2 --steps 5 --out /tmp/loras
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                     save_checkpoint, wait_for_async_saves)
from ..configs import get_config, smoke_config
from ..convert import tensor_to_array
from ..data.pipeline import TaskDataLoader
from ..data.tasks import make_task
from ..device import resolve_device
from ..ft.failures import FailurePlan, FaultTolerantRunner, FTConfig
from ..models import transformer as tf
from ..models.param import init_params
from ..training.optimizer import AdamWConfig, init_opt_state
from ..training.step import make_lora_train_step, make_train_step


def _on(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_full(cfg, steps: int, batch: int, seq: int, ckpt_dir: str,
               seed: int = 0, ckpt_every: int = 10, log_every: int = 5,
               device=None, plan: Optional[FailurePlan] = None):
    """Full training from seeded weights under the fault-tolerant runner:
    an async checkpoint every ``ckpt_every`` steps, a restart from the
    newest one after a failure (``plan`` injects failures and stragglers),
    and a blocking checkpoint of the final state.  Returns the final
    ``{"params", "opt"}`` state."""
    device = resolve_device(device)
    defs = tf.model_defs(cfg)
    params = init_params(defs, torch.Generator(device).manual_seed(seed),
                         device)
    opt = init_opt_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(warmup_steps=10,
                                               total_steps=steps))
    loader = TaskDataLoader(make_task(0, vocab=cfg.vocab_size - 8), batch, seq,
                            base_seed=seed)

    state = {"params": params, "opt": opt}

    def one_step(state, i):
        p, o, metrics = step_fn(state["params"], state["opt"],
                                _on(loader.batch_at(i), device))
        if i % log_every == 0:
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return {"params": p, "opt": o}

    def save(step, state):
        save_checkpoint(ckpt_dir, step, state, blocking=False)

    def restore():
        # a save issued just before the failure may still be in flight;
        # land it so restart resumes from the newest checkpoint
        wait_for_async_saves()
        ls = latest_step(ckpt_dir)
        if ls is None:
            return None
        return ls, restore_checkpoint(ckpt_dir, ls, state)

    runner = FaultTolerantRunner(FTConfig(ckpt_every=ckpt_every), one_step,
                                 save, restore, plan=plan)
    final = runner.run(state, steps)
    save_checkpoint(ckpt_dir, steps, final, blocking=True)
    return final


def train_lora_collection(cfg, n_tasks: int, steps: int, batch: int, seq: int,
                          out_dir: str, seed: int = 0, log_every: int = 20,
                          base_params=None, specs=None, lr: float = 3e-3,
                          device=None):
    """Paper §5.1 at reproducible scale: one LoRA per task on a shared base.
    Writes ``lora_task{t}.npz`` (keys ``layers/<target>/<a|b>``) and
    ``summary.json`` (per task: final_loss, train_s, kind)."""
    device = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if base_params is None:
        base_params = init_params(tf.model_defs(cfg),
                                  torch.Generator(device).manual_seed(seed),
                                  device)
    lora_defs = tf.lora_defs_tree(cfg)
    step_fn = make_lora_train_step(
        cfg, AdamWConfig(lr=lr, weight_decay=0.0, warmup_steps=10,
                         total_steps=steps))

    results = {}
    for t in range(n_tasks):
        spec = specs[t] if specs is not None else \
            make_task(t, vocab=cfg.vocab_size - 8)
        loader = TaskDataLoader(spec, batch, seq, base_seed=seed + 17 * t)
        lp = init_params(lora_defs,
                         torch.Generator(device).manual_seed(seed + 1000 + t),
                         device, dtype_override=torch.float32)
        opt = init_opt_state(lp)
        t0 = time.time()
        loss = None
        for i in range(steps):
            lp, opt, m = step_fn(base_params, lp, opt,
                                 _on(loader.batch_at(i), device))
            loss = float(m["loss"])
            if i % log_every == 0:
                print(f"task {t:3d} step {i:4d} loss {loss:.4f}", flush=True)
        np.savez(out / f"lora_task{t}.npz",
                 **{k: tensor_to_array(v) for k, v in
                    _flatten_lora(lp).items()})
        results[t] = {"final_loss": loss, "train_s": time.time() - t0,
                      "kind": spec.kind}
    (out / "summary.json").write_text(json.dumps(results, indent=2))
    return results


def _flatten_lora(tree, prefix=()):
    """``{"layers": {"q": {"a": ...}}}`` -> ``{"layers/q/a": ...}``, in
    sorted-key order."""
    if not isinstance(tree, dict):
        return {"/".join(prefix): tree}
    flat = {}
    for k in sorted(tree):
        flat.update(_flatten_lora(tree[k], prefix + (str(k),)))
    return flat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lora-collection", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_train"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.lora_collection:
        train_lora_collection(cfg, args.lora_collection, args.steps,
                              args.batch, args.seq, args.out, args.seed,
                              device=args.device)
    else:
        train_full(cfg, args.steps, args.batch, args.seq, args.out, args.seed,
                   device=args.device)


if __name__ == "__main__":
    main()
