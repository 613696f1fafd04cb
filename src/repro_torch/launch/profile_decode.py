"""Profile the port's decode step: where a step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch mistral-7b --mode jd --decode-path fused

Builds the executor as ``run_real`` does (random weights and adapters from
seeded generators), prefills a full batch and prints one JSON line: the
host time per decode step (timed without the profiler; each step ends in
the argmax's copy to the host), then, from ``torch.profiler`` over as many
steps again, the device time per step (the sum of the device's own kernel
and copy times, each counted once), the device's idle share, the number of
device launches per step, and the device time by group (the port's
kernels, matrix products, everything else) and for the top kernels.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..configs import get_config, smoke_config
from ..kernels.checks import ATTN_KERNEL, EXPAND_KERNEL, QUANT_KERNELS
from ..serving.request import Request
from .serve import build_executor

PORT_KERNELS = (ATTN_KERNEL, EXPAND_KERNEL) + QUANT_KERNELS
GEMM_WORDS = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")


def _group(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port_kernels"
    if any(w in name.lower() for w in GEMM_WORDS):
        return "matmul"
    return "other"


def profile_decode(cfg, mode: str, decode_path: str, n_adapters: int = 16,
                   max_batch: int = 8, prompt_len: int = 24, steps: int = 6,
                   seed: int = 0, device=None, trace: str = "") -> dict:
    ex = build_executor(cfg, n_adapters, mode, max_batch, seed, decode_path,
                        device)
    rng = np.random.default_rng(seed)
    for rid in range(max_batch):
        prompt = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
        ex.prefill_request(Request(rid=rid, adapter_id=rid % n_adapters,
                                   prompt_len=prompt_len,
                                   max_new_tokens=2 * steps + 2), prompt)
    ex.decode_step_real()                                 # warm-up
    t0 = time.perf_counter()
    for _ in range(steps):
        ex.decode_step_real()                             # ends in a sync
    step_ms = 1e3 * (time.perf_counter() - t0) / steps

    cuda = ex.device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            ex.decode_step_real()
    if trace:
        prof.export_chrome_trace(trace)
    # device-side events only: a CPU op's entry repeats its kernels' time
    kernels = {ev.key: (ev.self_device_time_total / 1e3 / steps,
                        ev.count / steps)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    dev_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "mode": mode, "decode_path": decode_path, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "batch": max_batch, "steps": steps,
        "device": (torch.cuda.get_device_name(ex.device) if cuda else "cpu"),
        "host_ms_per_step": step_ms,
        "device_ms_per_step": dev_ms if cuda else None,
        "device_idle_share": (1.0 - dev_ms / step_ms) if cuda else None,
        "device_launches_per_step": (sum(c for _, c in kernels.values())
                                     if cuda else None),
        "device_ms_per_step_by_group": groups,
        "top_kernels": [{"name": n[:80], "ms_per_step": ms,
                         "calls_per_step": c} for n, (ms, c) in top],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="jd", choices=["jd", "lora"])
    ap.add_argument("--decode-path", default="fused",
                    choices=["unfused", "fused", "fused_q8"])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default="",
                    help="write a chrome trace of the profiled steps here")
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(json.dumps(profile_decode(cfg, args.mode, args.decode_path,
                                    steps=args.steps, device=args.device,
                                    trace=args.trace)), flush=True)


if __name__ == "__main__":
    main()
