"""The replicated decode step's wall time in two source trees.

    # the whole comparison: runs A B B A, one process each, the kernels
    # built once for both under build/kernels_ab (where the sources are
    # the same), readings in DIR/replicated_host_ab.json
    python scripts/replicated_host_ab.py --ab build/parent . --out DIR
    # one tree's run, its readings as JSON on the last line
    python scripts/replicated_host_ab.py --tree .

A run imports ``repro_torch`` from ``<tree>/src`` and builds mistral-7b at
full width and depth in bf16 (weights at 1/sqrt(fan-in), drawn from a
seeded generator on the card, so two trees see the same bits).  It
prefills a batch of :data:`BATCH` prompts of :data:`PROMPT` tokens
through the replicated prefill step (``models/api.py::step_fn_for``, no
mesh), then, from a copy of that cache for each decode branch (``gather``
and ``lazy``, the latter launching row 1, ``flash_decode``), takes
:data:`WARM` untimed and :data:`STEPS` timed decode steps fed each step's
argmax.  Each timed step reads the host clock from a synchronized start
to the step's return (``call_ms``: the host's dispatch) and to its logits
on the host (``wall_ms``); the step is host-bound, so the two differ by
the device's tail.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

BATCH, PROMPT, WARM, STEPS = 8, 1024, 2, 10
BRANCHES = ("gather", "lazy")


def run(tree: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.families import fan_in_defs
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mistral-7b")
    g = torch.Generator(device=dev).manual_seed(70)
    params = init_params(fan_in_defs(tf.model_defs(cfg)), g, dev,
                         dtype_override=torch.bfloat16)
    s_max = PROMPT + WARM + STEPS
    pre = ShapeConfig("prefill", s_max, BATCH, "prefill")
    dec = ShapeConfig("decode", s_max, BATCH, "decode")
    gt = torch.Generator(device=dev).manual_seed(71)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gt,
                           device=dev)
    with torch.no_grad():
        lg, cache = api.step_fn_for(cfg, pre)(
            params, {"tokens": tokens},
            tf.init_cache(cfg, BATCH, s_max, device=dev))
    first = lg[:, -1].argmax(-1)
    del lg
    out = {}
    for branch in BRANCHES:
        step = api.step_fn_for(dc.replace(cfg, decode_attn=branch), dec)
        c = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in cache.items()}
        nxt, call, wall = first, [], []
        for i in range(WARM + STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, c = step(params, {"tokens": nxt[:, None]}, c)
            t1 = time.perf_counter()
            nxt = lg[:, -1].float().cpu().argmax(-1).to(dev)
            t2 = time.perf_counter()
            if i >= WARM:
                call.append(1e3 * (t1 - t0))
                wall.append(1e3 * (t2 - t0))
        out[branch] = {"call_ms": call, "wall_ms": wall,
                       "call_ms_median": statistics.median(call),
                       "wall_ms_median": statistics.median(wall)}
        del c
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def ab(tree_a: str, tree_b: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    # one build for both trees (the library is keyed by the sources' hash)
    env = {**os.environ,
           "REPRO_TORCH_BUILD_DIR": os.path.abspath("build/kernels_ab")}
    runs = []
    for name, tree in (("A", tree_a), ("B", tree_b), ("B", tree_b),
                       ("A", tree_a)):
        p = subprocess.run([sys.executable, __file__, "--tree", tree],
                           env=env, capture_output=True, text=True)
        if p.returncode:
            print(p.stderr[-3000:], file=sys.stderr)
            return p.returncode
        runs.append({"run": name, "tree": tree,
                     **json.loads(p.stdout.strip().splitlines()[-1])})
    report = {"card": _card(), "batch": BATCH, "prompt": PROMPT,
              "steps": STEPS, "runs": runs}
    with open(os.path.join(out_dir, "replicated_host_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    for r in runs:
        print(r["run"], r["tree"], {b: (round(r[b]["call_ms_median"], 2),
                                        round(r[b]["wall_ms_median"], 2))
                                    for b in BRANCHES})
    print(report["card"])
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=".")
    p.add_argument("--ab", nargs=2, metavar=("TREE_A", "TREE_B"))
    p.add_argument("--out", default="build/replicated_host_ab")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("replicated_host_ab: no CUDA device", file=sys.stderr)
        return 1
    if a.ab:
        return ab(*a.ab, a.out)
    print(json.dumps(run(a.tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
