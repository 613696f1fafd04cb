"""The fused decode kernels of two source trees on identical inputs.

    # the whole comparison: both trees' kernels built at once, then runs
    # A B B A (one process each), delta and out bit for bit, timings
    python scripts/fused_decode_ab.py --ab build/parent . --out DIR
    # its parts: one tree's run, outputs saved; two runs compared
    python scripts/fused_decode_ab.py --tree build/parent --save A.pt
    python scripts/fused_decode_ab.py --compare A.pt B.pt

A run imports ``repro_torch`` from ``<tree>/src`` and draws every input
from seeded generators on the card with the tree's own
``kernels/checks.py`` helpers (unchanged between the trees compared), so
two trees see the same bits.  It calls ``fused_decode_lora`` and
``fused_decode_jd`` (diagonal and full Sigma) with bf16, f32 and int8
banks at the serving shape (B 8, H 32, Kv 8, hd 128, a 128-token bucket,
kv_len 32, rank 16, d_out 4096), at pixtral-12b's d_out 5120, with f32
attention, and over a long-context cache (kv_len 1028-2044) both
contiguous and paged in 128-token pages; it saves every ``out`` and
``delta``.  It then times the main path's calls (bf16 banks; lora and jd
with a full Sigma; ``flash_decode`` beside them) with one unfiltered
``torch.profiler`` record of 20 calls each: the device time and the
launches per call of every kernel name, so a tree's split between its
kernels shows.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ITERS = 20
N_ADAPTERS, R = 16, 16
SERVE = dict(B=8, H=32, Kv=8, hd=128, s_max=160, bucket=128, kv_len=32)
LONG = dict(SERVE, s_max=2048, bucket=2048,
            kv_len=[1028, 1044, 1300, 1500, 1700, 1896, 2000, 2044])
CASES = {  # name: (shape, d_out, q dtype, page_t or None)
    "serve": (SERVE, 4096, torch.bfloat16, None),
    "pixtral": (SERVE, 5120, torch.bfloat16, None),
    "serve_f32": (SERVE, 4096, torch.float32, None),
    "long": (LONG, 4096, torch.bfloat16, None),
    "long_paged": (LONG, 4096, torch.bfloat16, 128),
}
TIMED = ("serve", "pixtral", "long_paged")


def _import(tree: str):
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import checks, flash_decode, fused_decode
    return checks, flash_decode, fused_decode


def _kernel_split(fn) -> dict:
    """{kernel name: [launches per call, device ms per call]} over ITERS
    calls of fn, from one unfiltered profile."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return {ev.key.split("(")[0]: [ev.count / ITERS,
                                   ev.self_device_time_total / ITERS / 1e3]
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def run(tree: str, save: str) -> None:
    checks, fd, fu = _import(tree)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2121)
    results, timings = {}, {}
    for case_name, (shape, d_out, dtype, page_t) in CASES.items():
        s = shape
        case = checks.attention_case(s["B"], s["H"], s["Kv"], s["hd"],
                                     s["s_max"], s["bucket"], s["kv_len"],
                                     dtype, gen, dev)
        case["ids"] = torch.randint(0, N_ADAPTERS, (s["B"],), generator=gen,
                                    device=dev, dtype=torch.int32)
        q, kl, ids = case["q"], case["kv_len"], case["ids"]
        if page_t:
            pc = checks.paged_case(case, page_t, 37, gen)
            kv = (pc["k_pages"], pc["v_pages"], pc["page_table"])
            flash = lambda: fd.flash_decode_paged(q, *kv, kl)  # noqa: E731
            lora, jd = fu.fused_decode_lora_paged, fu.fused_decode_jd_paged
        else:
            kv = (case["k"], case["v"])
            flash = lambda: fd.flash_decode(q, *kv, kl)  # noqa: E731
            lora, jd = fu.fused_decode_lora, fu.fused_decode_jd
        calls = {}
        for bank in ("bf16", "f32", "int8"):
            wdt = torch.float32 if bank == "f32" else torch.bfloat16
            lb = checks.lora_banks(N_ADAPTERS, R, s["H"] * s["hd"], d_out,
                                   wdt, gen, dev, bank == "int8")
            calls[f"lora/{bank}"] = (lora, (ids, lb["A"], lb["B"],
                                            lb["a_scale"], lb["b_scale"]))
            for diag in (True, False):
                jb = checks.jd_banks(1, N_ADAPTERS, R, s["H"] * s["hd"],
                                     d_out, wdt, gen, dev, bank == "int8",
                                     diag)
                calls[f"jd_{'diag' if diag else 'full'}/{bank}"] = (jd, (
                    ids, jb["U"], jb["V"], jb["sigma"], jb["cluster_of"],
                    jb["u_scale"], jb["v_scale"]))
        for key, (fn, args) in calls.items():
            out, delta = fn(q, *kv, kl, *args)
            results[f"{case_name}/{key}"] = (out.cpu(), delta.cpu())
        if case_name not in TIMED:
            continue
        torch.cuda.synchronize()
        timed = {"flash_decode": flash,
                 "lora": lambda: calls["lora/bf16"][0](
                     q, *kv, kl, *calls["lora/bf16"][1]),
                 "jd_full": lambda: calls["jd_full/bf16"][0](
                     q, *kv, kl, *calls["jd_full/bf16"][1])}
        for name, fn in timed.items():
            split = _kernel_split(fn)
            timings[f"{case_name}/{name}"] = dict(
                kernels=split,
                device_ms=sum(ms for _, ms in split.values()),
                launches=sum(n for n, _ in split.values()),
                ms=checks.cuda_ms(fn))
    torch.save({"tree": tree, "results": results, "timings": timings}, save)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"tree": tree, "card": smi, "cases": len(results),
                      "timings": timings}), flush=True)


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    if a["results"].keys() != b["results"].keys():
        print("the two runs hold different cases", file=sys.stderr)
        return 1
    bad = []
    for key, (out_a, delta_a) in a["results"].items():
        out_b, delta_b = b["results"][key]
        if not torch.equal(out_a, out_b):
            bad.append(f"{key} out")
        if not torch.equal(delta_a, delta_b):
            n = int((delta_a != delta_b).sum())
            bad.append(f"{key} delta ({n} of {delta_a.numel()} differ)")
    for key in a["timings"]:
        ta, tb = a["timings"][key], b["timings"][key]
        print(json.dumps({"call": key,
                          "device_ms": [ta["device_ms"], tb["device_ms"]],
                          "launches": [ta["launches"], tb["launches"]],
                          "ms": [ta["ms"], tb["ms"]]}))
    print(json.dumps({"compared": len(a["results"]),
                      "bit_identical": not bad, "differ": bad,
                      "trees": [a["tree"], b["tree"]]}))
    return 1 if bad else 0


def ab(tree_a: str, tree_b: str, out: str) -> int:
    """Build both trees' kernels concurrently, run A B B A, compare the
    first A and B (and the second pair) bit for bit, with the timings."""
    os.makedirs(out, exist_ok=True)
    build = "from repro_torch.kernels import _build; _build.build()"
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{os.path.join(os.path.abspath(t), 'src')!r}); {build}"])
        for t in (tree_a, tree_b)]
    if any(p.wait() for p in procs):
        print("fused_decode_ab: a build failed", file=sys.stderr)
        return 1
    saves = []
    for i, tree in enumerate((tree_a, tree_b, tree_b, tree_a)):
        saves.append(os.path.join(out, f"run{i}.pt"))
        if subprocess.run([sys.executable, __file__, "--tree", tree,
                           "--save", saves[-1]]).returncode:
            return 1
    for i, j in ((0, 1), (3, 2)):
        if compare(saves[i], saves[j]):
            return 1
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=".")
    p.add_argument("--save")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    p.add_argument("--ab", nargs=2, metavar=("TREE_A", "TREE_B"))
    p.add_argument("--out", default="build/fused_ab")
    args = p.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.ab:
        return ab(*args.ab, args.out)
    if not torch.cuda.is_available():
        print("fused_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    if not args.save:
        p.error("--save is required for a run")
    run(args.tree, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
