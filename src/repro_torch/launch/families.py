"""The model families at the model level: prefill (with the vlm patches or
the audio frames where the family takes them), then greedy or given
decode steps, held to the train-mode forward over the whole sequence, on
the card by default; and the same reduced model on a device against the
CPU.

  # full width and depth on the card, over the seeds SEEDS (random bf16
  # weights; --f32 for f32 weights, activations and cache)
  PYTHONPATH=src python -m repro_torch.launch.families --arch zamba2-2.7b

  # reduced model on the CPU
  PYTHONPATH=src python -m repro_torch.launch.families \\
      --arch deepseek-moe-16b --smoke --device cpu

``decode_check`` is what ``chip_smoke.py`` phase 9 (c) runs for the
families the serving launcher cannot serve (first-k-dense MoE, hybrid,
audio) and for vlm patches; ``card_vs_cpu`` is its part (a).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Dict

import torch

from ..configs import get_config, smoke_config
from ..device import resolve_device, synchronize
from ..models import transformer as tf
from ..models.layers import logits_fwd
from ..models.moe import record_routes
from ..models.param import init_params, tree_map

BATCH = 2        # sequences
PROMPT = 16      # prompt tokens (more where the model has SSM layers)
STEPS = 3        # decode steps
FRAMES = 1500    # audio encoder frames: whisper's 30 s window
SMOKE_FRAMES = 10  # at smoke size, the CPU tests' count against JAX
SEEDS = (0, 1, 2)  # the launcher runs each; the checks take the first
# leading axes that stack one matrix per layer, group or expert
STACK_AXES = ("layers", None, "experts")


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    g.manual_seed(seed)
    return g


def prompt_len(cfg) -> int:
    """``PROMPT``, or where the model has SSM layers, more than two of
    its SSD chunks and not a multiple of one, so that prefill runs the
    inter-chunk recurrence and the dt = 0 padding."""
    if cfg.ssm is None:
        return PROMPT
    return 2 * cfg.ssm.chunk + PROMPT + 1


def make_inputs(cfg, n_tokens: int, gen: torch.Generator, dev, dtype,
                n_frames: int) -> Dict:
    """``BATCH`` rows of random tokens, and the stub front ends' outputs
    where the family takes them: the config's vlm patch embeddings before
    the tokens, ``n_frames`` audio frames for the encoder (both std 1, in
    ``dtype``)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(
            device=dev, dtype=dtype)

    out = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, n_tokens),
                                   generator=gen, device=gen.device).to(dev)}
    if cfg.family == "vlm":
        out["patches"] = randn(BATCH, cfg.vlm.num_patches, cfg.d_model)
    if cfg.family == "audio":
        out["frames"] = randn(BATCH, n_frames, cfg.d_model)
    return out


def fan_in_defs(defs):
    """Every matrix drawn at std 1/sqrt(its fan-in), the product of its
    input axes (a stacked leaf's stacking axes and its output axes left
    out; an attention in-projection's output is heads x head_dim).  The
    reference rule takes 1/sqrt(shape[0]), for a stacked leaf its layer
    count, which gains each projection 10-17x at the published widths and
    so amplifies rounding; neither check here needs parity with it."""
    def one(d):
        if d.init != "normal" or d.scale is not None:
            return d
        dims = [n for n, a in zip(d.shape, d.axes) if a not in STACK_AXES]
        n_out = 2 if d.axes[-1] == "head_dim" else 1
        if len(dims) <= n_out:
            return d
        return dataclasses.replace(
            d, scale=1.0 / math.sqrt(math.prod(dims[:-n_out])))
    return tree_map(one, defs)


@torch.no_grad()
def greedy_decode(params, cfg, inputs: Dict, s_max: int, dev, cache_dtype,
                  feed=None) -> Dict:
    """Prefill ``inputs`` and run ``STEPS`` decode steps, fed ``feed``'s
    tokens (B, STEPS) or else the greedy ones.  Returns the logits of the
    prefill's last position and of every step (B, 1 + STEPS, Vp) on the
    host, the tokens fed, and the host seconds of the prefill and of each
    step (clock around synced work)."""
    frames = inputs.get("frames")
    cache = tf.init_cache(cfg, BATCH, s_max,
                          enc_len=0 if frames is None else frames.shape[1],
                          device=dev, dtype=cache_dtype)
    synchronize(dev)
    t0 = time.perf_counter()
    lg, cache = tf.prefill(params, inputs, cfg, cache)
    synchronize(dev)
    times = {"prefill_s": time.perf_counter() - t0, "step_s": []}
    logits, fed = [lg[:, -1].float().cpu()], []
    for i in range(STEPS):
        nxt = (feed[:, i:i + 1] if feed is not None
               else lg[:, -1].argmax(-1, keepdim=True))
        fed.append(nxt.cpu())
        t0 = time.perf_counter()
        lg, cache = tf.decode_step(params, nxt.to(dev), cfg, cache)
        synchronize(dev)
        times["step_s"].append(time.perf_counter() - t0)
        logits.append(lg[:, -1].float().cpu())
    return dict(times, logits=torch.stack(logits, 1),
                fed=torch.cat(fed, 1), index=cache["index"])


def _s_max(cfg) -> int:
    n_pre = cfg.vlm.num_patches if cfg.family == "vlm" else 0
    return n_pre + prompt_len(cfg) + STEPS


def card_vs_cpu(arch: str, device=None) -> Dict:
    """The smoke config of ``arch`` in f32 (weights at :func:`fan_in_defs`'
    std, activations and cache): prefill and ``STEPS`` greedy decode steps on ``device`` and on
    the CPU from the same weights and inputs, the card fed the CPU's
    tokens.  Returns the largest logit difference, whether every MoE
    routing decision chose the same experts, and the smallest top-k
    margin seen."""
    dev = resolve_device(device)
    cfg = smoke_config(arch)
    cpu = torch.device("cpu")
    g = _generator(cpu, SEEDS[0])
    params = init_params(fan_in_defs(tf.model_defs(cfg)), g, cpu,
                         dtype_override=torch.float32)
    inputs = make_inputs(cfg, prompt_len(cfg), g, cpu, torch.float32,
                         SMOKE_FRAMES)
    runs = []
    for d in (cpu, dev):
        with record_routes() as routes:
            out = greedy_decode(
                tree_map(lambda t: t.to(d), params), cfg,
                tree_map(lambda t: t.to(d), inputs), _s_max(cfg), d,
                torch.float32, feed=runs[0]["fed"] if runs else None)
        runs.append(dict(out, routes=routes))
    same = all(torch.equal(a[0], b[0])
               for a, b in zip(runs[0]["routes"], runs[1]["routes"]))
    margins = [float(m.min()) for _, m in runs[0]["routes"]]
    return {"arch": arch, "family": cfg.family, "prompt": prompt_len(cfg),
            "max_abs_diff": float((runs[0]["logits"]
                                   - runs[1]["logits"]).abs().max()),
            "finite": bool(torch.isfinite(runs[1]["logits"]).all()),
            "moe_calls": len(runs[1]["routes"]),
            "routes_equal": same and len(runs[0]["routes"]) ==
            len(runs[1]["routes"]),
            "min_topk_margin": min(margins) if margins else None}


def decode_check(cfg, device=None, dtype=torch.bfloat16,
                 seed: int = SEEDS[0]) -> Dict:
    """Random weights from a generator seeded ``seed`` (at
    :func:`fan_in_defs`' std), in ``dtype`` as are the activations and the
    cache; prefill of the prompt (after the patches, or with the encoder
    frames, where the family takes them), ``STEPS`` decode steps of given
    tokens, then the train-mode forward over the whole sequence: returns
    the largest difference between each decode logit and the forward's at
    the same position, host ms per step, decode tokens/s and the card's
    peak memory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # a first allocation sets up the device's allocator, whose peak
        # statistics are then reset
        torch.zeros((), device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    g = _generator(dev, seed)
    t0 = time.perf_counter()
    params = init_params(fan_in_defs(tf.model_defs(cfg)), g, dev,
                         dtype_override=dtype)
    synchronize(dev)
    init_s = time.perf_counter() - t0
    prompt = prompt_len(cfg)
    inputs = make_inputs(cfg, prompt + STEPS, g, dev, dtype, FRAMES)
    tokens = inputs["tokens"]
    out = greedy_decode(params, cfg, dict(inputs, tokens=tokens[:, :prompt]),
                        _s_max(cfg), dev, dtype, feed=tokens[:, prompt:])
    with torch.no_grad():
        h, _, aux = tf.forward(params, cfg, mode="train", **inputs)
        ref = logits_fwd(params["embed"], h[:, -(STEPS + 1):], cfg)
    ref = ref.float().cpu()
    step_ms = [1e3 * s for s in out["step_s"]]
    return {"arch": cfg.name, "family": cfg.family,
            "dtype": str(dtype).replace("torch.", ""), "seed": seed,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "batch": BATCH, "prompt": prompt, "steps": STEPS,
            "n_patches": inputs["patches"].shape[1]
            if "patches" in inputs else 0,
            "n_frames": inputs["frames"].shape[1]
            if "frames" in inputs else 0,
            "index": out["index"],
            "max_abs_diff": float((out["logits"] - ref).abs().max()),
            "logit_max_abs": float(ref.abs().max()),
            "finite": bool(torch.isfinite(out["logits"]).all()),
            "aux_loss": float(aux),
            "init_s": init_s, "prefill_s": out["prefill_s"],
            "step_ms": step_ms,
            "decode_tokens_per_s": BATCH * len(step_ms) / (
                sum(step_ms) / 1e3),
            "max_memory_allocated_gb": (
                torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--f32", action="store_true",
                    help="f32 weights, activations and cache (default bf16)")
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    for seed in SEEDS:
        out = decode_check(cfg, args.device, seed=seed,
                           dtype=torch.float32 if args.f32
                           else torch.bfloat16)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
