"""Serving launcher (the port of the real-model half of
``launch/serve.py``): multi-LoRA continuous batching over the real model,
on the card by default.

  # mistral-7b at full width, fused kernels, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-7b \\
      --adapters 16 --requests 24 --decode-path fused

  # reduced model on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-7b \\
      --smoke --device cpu --adapters 8 --requests 24
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from ..configs import get_config, smoke_config
from ..device import resolve_device
from ..serving.engine import EngineConfig, ServingEngine
from ..serving.scheduler import SchedulerConfig
from ..serving.workload import WorkloadSpec, make_workload

# per-target offsets of the bundle generator's seed: fixed, where the JAX
# launcher's hash(tname) % 97 changes from process to process
TARGET_SEED = {"q": 1, "k": 2, "v": 3, "o": 4}


def make_bundles(cfg, n_adapters: int, mode: str, decode_path: str, seed: int,
                 device, targets: Optional[Sequence[str]] = None) -> dict:
    """Random bf16 adapters (paper §6.4 serves random LoRAs for
    throughput): raw A/B banks in "lora" mode, one-cluster U/V bases with a
    full per-adapter Sigma in "jd" mode.  By default the fused paths add an
    "o" target so the fused epilogue has an output delta to apply;
    ``targets`` picks the adapted projections instead (without "o" the
    fused step runs plain flash-decode attention)."""
    r, d = cfg.lora.rank, cfg.d_model
    hd, L = cfg.resolved_head_dim, cfg.num_layers
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd)}
    dims["o"] = (cfg.num_heads * hd, d)
    if targets is None:
        targets = ("q", "k", "v") + (("o",) if decode_path != "unfused"
                                     else ())
    dims = {t: dims[t] for t in targets}
    gen_dev = device if device.type == "cuda" else torch.device("cpu")
    bundles = {"layers": {}}
    for tname, (di, do) in dims.items():
        g = torch.Generator(device=gen_dev)
        g.manual_seed(seed * 1000 + TARGET_SEED[tname])

        def normal(shape, std):
            x = torch.randn(shape, generator=g, device=gen_dev,
                            dtype=torch.float32)
            return (x * std).to(dtype=torch.bfloat16, device=device)

        if mode == "lora":
            bundles["layers"][tname] = {
                "A": normal((L, n_adapters, r, di), 0.02),
                "B": normal((L, n_adapters, do, r), 0.02)}
        else:
            k_cl = 1
            bundles["layers"][tname] = {
                "U": normal((L, k_cl, do, r), 0.02),
                "V": normal((L, k_cl, di, r), 0.02),
                "sigma": normal((L, n_adapters, r, r), 0.1),
                "cluster_of": torch.zeros((L, n_adapters), dtype=torch.int32,
                                          device=device)}
    return bundles


def build_executor(cfg, n_adapters: int, mode: str, max_batch: int,
                   seed: int, decode_path: str, device=None,
                   targets: Optional[Sequence[str]] = None):
    """The executor ``run_real`` serves with: random weights and adapters
    from seeded generators, a 160-token cache per slot."""
    from ..models import transformer as tf
    from ..models.param import init_params
    from ..serving.real_executor import RealModelExecutor

    dev = resolve_device(device)
    gen_dev = dev if dev.type == "cuda" else torch.device("cpu")
    g = torch.Generator(device=gen_dev)
    g.manual_seed(seed)
    params = init_params(tf.model_defs(cfg), g, dev)
    bundles = make_bundles(cfg, n_adapters, mode, decode_path, seed + 1, dev,
                           targets)
    s_max = 160
    return RealModelExecutor(cfg, params, bundles, mode, max_batch, s_max,
                             decode_path=decode_path, device=dev)


def run_real(cfg, n_adapters: int, n_requests: int, mode: str = "jd",
             max_batch: int = 8, seed: int = 0,
             decode_path: str = "unfused", device=None,
             targets: Optional[Sequence[str]] = None) -> dict:
    """Real execution path: random weights and adapters (paper §6.4
    simulates random LoRAs for throughput), real prefill/decode with
    batched adapter math, wall-clock timed by the engine.  ``device``
    defaults to the card.  ``targets`` (as in :func:`make_bundles`) exists
    so that a fused run without an "o" adapter can serve through plain
    ``flash_decode`` attention; the default adapts q/k/v (and o on the
    fused paths)."""
    ex = build_executor(cfg, n_adapters, mode, max_batch, seed, decode_path,
                        device, targets)
    eng = ServingEngine(EngineConfig(
        scheduler=SchedulerConfig(max_batch=max_batch),
        adapter_budget_bytes=1e12, mode="lora",
        decode_path=decode_path), ex)
    wl = WorkloadSpec(n_requests=n_requests, n_adapters=n_adapters,
                      prompt_len_mean=24, prompt_len_std=4, new_tokens=8)

    def _release(req):
        ex.release(req.rid)

    eng.on_finish = _release
    eng.submit(make_workload(wl))
    stats = eng.run()
    return stats.to_dict()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--real", action="store_true",
                    help="accepted for the JAX launcher's command lines; "
                         "the port always serves the real model")
    ap.add_argument("--adapters", type=int, default=8)
    ap.add_argument("--mode", default="jd", choices=["jd", "lora"])
    ap.add_argument("--decode-path", default="unfused",
                    choices=["unfused", "fused", "fused_q8"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = run_real(cfg, args.adapters, args.requests, args.mode,
                   decode_path=args.decode_path, device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
