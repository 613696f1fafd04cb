"""The dry run's variant sweep on the H100 model (the port of
``launch/perf.py``): each variant of a cell through ``dryrun.run_cell`` on
the one-card mesh ``"1"``.

    PYTHONPATH=src python -m repro_torch.launch.perf --out /tmp/perf_torch

``VARIANTS`` are the JAX sweep's cells, names and overrides.  A variant
whose override the port does not act on is written with ``"applies":
false`` and the reason, not run as a result of its own:
``attn_cp_fallback`` (the config carries it; no model code of the port
reads it), and ``decode_attn="seq_shard"`` on one rank (the sequence-
sharded step runs only where a mesh's model axis does not divide the KV
heads; on one rank the step takes the gather branch).  ``--layers N``
cuts every variant's depth to N (recorded as ``layers``), for a quick
sweep.  The default output directory is ``results/perf_torch/``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from .dryrun import run_cell

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "perf_torch"

# hillclimb variants: cell -> [(variant_name, cfg_overrides, n_micro)]
VARIANTS = {
    # most collective-bound cell: FSDP/SP gather traffic scales with the
    # grad-accumulation factor
    ("mistral-large-123b", "train_4k"): [
        ("v1_micro1", {}, 1),
        ("v2_micro2", {}, 2),
        ("v3_micro1_chunk4k", {"attn_chunk_q": 2048, "attn_chunk_kv": 4096}, 1),
        ("v4_micro4_chunk4k", {"attn_chunk_q": 2048, "attn_chunk_kv": 4096}, 4),
    ],
    # worst useful-flops cell: 24 heads don't shard at TP16 -> replicated
    # attention; context-parallel fallback shards it over sequence
    ("granite-moe-3b-a800m", "prefill_32k"): [
        ("v1_cp_attn", {"attn_cp_fallback": True}, None),
        ("v2_cp_attn_chunk4k", {"attn_cp_fallback": True,
                                "attn_chunk_q": 2048,
                                "attn_chunk_kv": 4096}, None),
    ],
    # paper-representative serving cell: seq-sharded KV decode without
    # gathering the cache (flash-decode partial-softmax merge)
    ("qwen3-32b", "decode_32k"): [
        ("v1_seqshard_decode", {"decode_attn": "seq_shard"}, None),
        ("v2_fused_seqshard", {"decode_attn": "seq_shard"}, None),
        ("v3_lazy_cache_write", {"decode_attn": "lazy"}, None),
    ],
    # lazy cache write applied to the other big decode cells
    ("qwen1.5-110b", "decode_32k"): [
        ("v3_lazy_cache_write", {"decode_attn": "lazy"}, None),
    ],
    ("mistral-large-123b", "decode_32k"): [
        ("v3_lazy_cache_write", {"decode_attn": "lazy"}, None),
    ],
}


def not_applied(overrides: dict) -> str | None:
    """Why the port on one card does not act on ``overrides``, or None."""
    if overrides.get("attn_cp_fallback"):
        return ("attn_cp_fallback: configs/base.py carries it, but no model "
                "code of the port reads it (the port has no context-parallel "
                "attention)")
    if overrides.get("decode_attn") == "seq_shard":
        return ("decode_attn seq_shard on one rank: the sequence-sharded "
                "step runs only under a mesh whose model axis does not "
                "divide the KV heads; one rank takes the gather branch")
    return None


def run_variant(arch: str, shape: str, name: str, overrides: dict,
                n_micro, layers: int | None = None) -> dict:
    rec: dict = {"arch": arch, "shape": shape, "variant": name,
                 "overrides": {**overrides,
                               **({"n_micro": n_micro} if n_micro else {})}}
    reason = not_applied(overrides)
    if reason:
        rec.update(applies=False, reason=reason, ok=True)
        return rec
    cfg_overrides = dict(overrides)
    if layers is not None:
        cfg_overrides["num_layers"] = layers
        rec["layers"] = layers
    rec.update(run_cell(arch, shape, mesh="1", cfg_overrides=cfg_overrides,
                        n_micro_override=n_micro))
    rec["variant"] = name
    rec["applies"] = True
    return rec


def main():
    ap = argparse.ArgumentParser(description="perf variant sweep (H100 "
                                 "model, meta tensors)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every variant's depth to this many layers")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    for (arch, shape), variants in VARIANTS.items():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        for name, overrides, n_micro in variants:
            if args.variant and name != args.variant:
                continue
            path = out / f"{arch}__{shape}__{name}.json"
            if path.exists() and not args.force:
                print(f"[skip-cached] {path.name}")
                continue
            print(f"[run] {arch} {shape} {name} ...", flush=True)
            t0 = time.time()
            try:
                rec = run_variant(arch, shape, name, overrides, n_micro,
                                  args.layers)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "variant": name,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
            rec["wall_s"] = round(time.time() - t0, 2)
            path.write_text(json.dumps(rec, indent=2, default=str))
            status = "OK" if rec.get("ok") else "FAIL"
            extra = ""
            if rec.get("ok") and not rec.get("applies"):
                status, extra = "N/A", f" :: {rec['reason']}"
            elif rec.get("ok"):
                r = rec["roofline"]
                extra = (f" tc={r['t_compute_s']:.3f} tm={r['t_memory_s']:.3f}"
                         f" tx={r['t_collective_s']:.3f}"
                         f" frac={r['roofline_fraction']:.4f}"
                         f" temp={rec['memory']['temp_bytes']/1e9:.1f}GB")
            print(f"[{status}] {path.name}{extra}"
                  + ("" if rec.get("ok") else f" :: {rec.get('error')}"),
                  flush=True)


if __name__ == "__main__":
    main()
