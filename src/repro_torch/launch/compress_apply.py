"""Compress a LoRA bank, then apply it to a batch of tokens that each
carry their own adapter (the port of ``benchmarks/microbench_lora_fwd.py``
and of the ``sgmv_pair`` / ``jd_apply`` rows of
``benchmarks/kernel_bench.py``), on the card by default.

  # mistral-7b's q projection (4096 -> 4096, LoRA rank 16), 1000 adapters
  PYTHONPATH=src python -m repro_torch.launch.compress_apply --arch mistral-7b

  # reduced widths on the CPU
  PYTHONPATH=src python -m repro_torch.launch.compress_apply \\
      --arch mistral-7b --smoke --device cpu --adapters 64 --seqs 8 \\
      --seq-len 16

It builds a bank of random bf16 adapters drawn around a few random family
centres (so that clustering has structure to find), compresses it twice
(clustered JD-Full by the QR iteration, and single-basis JD-Diag), exports
the uncompressed bank and both bundles, and applies each to two batches
through ``kernels/ops.py``: a prefill batch of ``seqs`` sequences of
``seq_len`` tokens, each sequence on its own adapter, and a decode batch of
one token per sequence, whose adapter groups are padded to a whole tile.
It prints one JSON report: adapter bytes (per adapter and shared), the
reconstruction loss, the compression seconds, the time per apply call of
each mode on each batch, and each compressed delta's relative difference
from the uncompressed one.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from ..configs import get_config, smoke_config
from ..core.collection import (CompressionConfig, LoRABank, compress_bank,
                               export_for_serving, export_uncompressed)
from ..device import resolve_device, synchronize
from ..kernels import checks, ops

FAMILIES = 8             # random family centres the adapters are drawn around
FAMILY_NOISE = 0.25      # each adapter's own share, relative to its centre
INIT_STD = 0.02          # scale of the LoRA factors
N_CLUSTERS = 8           # clusters of the JD-Full compression
TILE = 128               # token tile of the grouping (the TPU's, for parity)
SEED = 0


def make_bank(n: int, rank: int, d_in: int, d_out: int, seed: int,
              device, families: int = FAMILIES) -> LoRABank:
    """n random bf16 adapters, adapter i around centre i % families."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=g, device=device)

    fam = torch.arange(n, device=device) % families
    A = normal((families, rank, d_in))[fam] + FAMILY_NOISE * normal(
        (n, rank, d_in))
    B = normal((families, d_out, rank))[fam] + FAMILY_NOISE * normal(
        (n, d_out, rank))
    return LoRABank(A=(INIT_STD * A).to(torch.bfloat16),
                    B=(INIT_STD * B).to(torch.bfloat16),
                    ranks=torch.full((n,), rank, dtype=torch.int32,
                                     device=device))


def pick_adapters(assign: torch.Tensor, k: int) -> torch.Tensor:
    """k distinct adapters spread over the clusters: evenly spaced through
    the adapters sorted by cluster."""
    order = torch.argsort(assign.cpu(), stable=True)
    at = torch.linspace(0, assign.numel() - 1, k).round().long()
    return order[at].to(assign.device)


def make_batches(adapters: torch.Tensor, seq_len: int, d_in: int, seed: int,
                 device) -> Dict[str, tuple]:
    """{"prefill": (x, ids), "decode": (x, ids)}: bf16 tokens, prefill
    ``seq_len`` per adapter, decode one per adapter."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    out = {}
    for name, per in (("prefill", seq_len), ("decode", 1)):
        ids = adapters.repeat_interleave(per).to(torch.int32)
        x = torch.randn((ids.numel(), d_in), generator=g, device=device)
        out[name] = (x.to(torch.bfloat16), ids)
    return out


def padded_tokens(ids: torch.Tensor, tile: int) -> int:
    """Rows the grouped kernels compute: each adapter's group padded to a
    multiple of ``tile``."""
    counts = torch.bincount(ids.long().cpu())
    counts = counts[counts > 0]
    return int((-(-counts // tile) * tile).sum())


def time_ms(fn, device, iters: int) -> float:
    """Mean ms per call: CUDA events on the card (after warm-up), the
    host clock on the CPU."""
    if device.type == "cuda":
        return checks.cuda_ms(fn, iters=iters, warmup=3)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def resident_bytes(bundle) -> Dict[str, int]:
    """Bytes as the bundle's tensors hold them: shared (U, V) and per
    adapter (A + B, or Sigma + the cluster index)."""
    a = bundle.arrays
    nbytes = {k: v.numel() * v.element_size() for k, v in a.items()}
    if bundle.kind == "lora":
        n = a["A"].shape[0]
        return {"shared": 0, "per_adapter": (nbytes["A"] + nbytes["B"]) // n}
    n = a["sigma"].shape[0]
    return {"shared": nbytes["U"] + nbytes["V"],
            "per_adapter": (nbytes["sigma"] + nbytes["cluster_of"]) // n}


def _apply(kind: str, arrays: dict, x, ids):
    if kind == "lora":
        return ops.lora_apply(x, arrays["A"], arrays["B"], ids, tile=TILE)
    return ops.jd_apply(x, arrays["U"], arrays["V"], arrays["sigma"],
                        arrays["cluster_of"], ids, tile=TILE)


def run(cfg, n_adapters: int = 1000, seqs: int = 32, seq_len: int = 128,
        device=None, iters: int = 20):
    """Compress, export and apply (see the module docstring).  Returns
    (report, artifacts): the JSON-able report, and the bank, bundles,
    batches and outputs for checks against the plain versions."""
    dev = resolve_device(device)
    rank = cfg.lora.rank
    d_in, d_out = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    bank = make_bank(n_adapters, rank, d_in, d_out, SEED, dev)
    bundles = {"lora": export_uncompressed(bank)}
    report = {"arch": cfg.name, "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              "timing": "cuda_events" if dev.type == "cuda" else "host_clock",
              "n_adapters": n_adapters, "rank": rank, "d_in": d_in,
              "d_out": d_out, "tile": TILE, "modes": {}, "batches": {}}
    modes = {"lora": None}
    clustered_name = f"jd_full_eig_k{N_CLUSTERS}"
    configs = {
        clustered_name: CompressionConfig(
            method="jd_full_eig", rank=rank, n_clusters=N_CLUSTERS,
            seed=SEED),
        "jd_diag": CompressionConfig(method="jd_diag", rank=rank, seed=SEED)}
    for name, ccfg in configs.items():
        synchronize(dev)
        t0 = time.perf_counter()
        cm = compress_bank(bank, ccfg)
        synchronize(dev)
        modes[name] = {"compress_s": time.perf_counter() - t0,
                       "loss": cm.metrics["loss"],
                       "mean_rel_err": cm.metrics["mean_rel_err"],
                       "result": cm.result}
        bundles[name] = export_for_serving(cm)

    clustered = modes[clustered_name]["result"]
    adapters = pick_adapters(clustered.assign, seqs)
    batches = make_batches(adapters, seq_len, d_in, SEED, dev)
    for bname, (x, ids) in batches.items():
        T_pad = padded_tokens(ids, TILE)
        report["batches"][bname] = {
            "tokens": ids.numel(), "padded_rows": T_pad,
            "padding_share": 1.0 - ids.numel() / T_pad,
            "adapters": int(torch.unique(ids).numel()),
            "clusters": int(torch.unique(
                clustered.assign[adapters.long()]).numel())}

    outputs = {}
    for name, bundle in bundles.items():
        row = {"kind": bundle.kind, "bytes": resident_bytes(bundle),
               "apply_ms": {}, "rel_diff_vs_lora": {}}
        if modes[name] is not None:
            row.update({k: v for k, v in modes[name].items()
                        if k != "result"})
        for bname, (x, ids) in batches.items():
            y = _apply(bundle.kind, bundle.arrays, x, ids)
            outputs[(name, bname)] = y
            row["apply_ms"][bname] = time_ms(
                lambda: _apply(bundle.kind, bundle.arrays, x, ids), dev,
                iters)
            ref_y = outputs[("lora", bname)].float()
            row["rel_diff_vs_lora"][bname] = float(
                torch.linalg.norm(y.float() - ref_y)
                / torch.linalg.norm(ref_y))
        report["modes"][name] = row
    artifacts = {"bank": bank, "bundles": bundles, "batches": batches,
                 "outputs": outputs,
                 "results": {k: v["result"] for k, v in modes.items()
                             if v is not None}}
    return report, artifacts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced-width config of --arch")
    ap.add_argument("--adapters", type=int, default=1000)
    ap.add_argument("--seqs", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    # full f32 products in compression (PyTorch's default, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    report, _ = run(cfg, args.adapters, args.seqs, args.seq_len,
                    device=args.device,
                    iters=20 if args.device != "cpu" else 2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
