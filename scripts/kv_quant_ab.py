"""The KV wire kernels (rows 13 and 14, ``csrc/kv_quant.cu``) of the
parent commit and of this tree on one card, in turns.

    # in a git checkout: the parent commit's kv_quant.cu and its
    # common.cuh under build/kv_quant_ab/src/parent (git-ignored, so a
    # copy of the working tree without .git still has them)
    python scripts/kv_quant_ab.py --prepare HEAD~1
    # on the card: the parent's sources against this tree's, and this
    # tree's with one part changed (ABLATIONS), readings in DIR
    python scripts/kv_quant_ab.py --out DIR
    python scripts/kv_quant_ab.py --ablate noquant divide --out DIR

Each source is built alone into its own library under
``build/kv_quant_ab/lib/<name>`` (one ``nvcc`` each, all started
together; ptxas' register and spill lines printed), loaded with
``ctypes`` and called through its C entry points on buffers the script
allocates once.  The input is a (128, 65536) bf16 block, the shape of
``launch/paged_kv.py``'s wire block at mistral-7b (32 layers x 8
kv-heads x 128, K and V), drawn from a seeded generator.  Six modes:
quantize to int8 and int4, dequantize int8 and int4 to f32 and to bf16
(the plain version's packed values and scales, the same for every
source).  Every mode of every source but an ablation is first held bit
for bit against the plain versions (``kernels/ref.py``).  Then the
sources are timed in turns, forward then backward (A B B A for two):
each mode's device ms per call (``checks.device_ms``: the kernel's own
time in ``torch.profiler``, 50 calls) warm (the same block again and
again, its 21-42 MB inside the 50 MB L2), cold (each call after writing
a 128 MiB scratch buffer, whose dirty lines the kernel's accesses must
write back) and on a clean L2 (after reading it), beside the mode's
bound (``checks.bound_ms`` of ``kv_quant_bytes`` / ``kv_dequant_bytes``).
The readings go to ``DIR/kv_quant_ab.json``; the summary prints each
source's readings and its cold share of the bound.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
WORK = ROOT / "build/kv_quant_ab"
FILES = ("kv_quant.cu", "common.cuh")
T, C = 128, 65536
ITERS = 50
MODES = ("quant_int8", "quant_int4", "dequant_int8_f32", "dequant_int4_f32",
         "dequant_int8_bf16", "dequant_int4_bf16")
# this tree's kv_quant.cu with one part changed, to time what it costs
# (the quantizer's results are then wrong, and not checked)
ABLATIONS = {
    # no levels and no stores: the loads, absmax and scales alone
    "noquant": ("""    if (exact)
      quantize(ch, std::true_type{});
    else
      quantize(ch, std::false_type{});""",
                """    if (n_tok < 0) quantize(ch, std::false_type{});"""),
    # every level through quant(): __fdiv_rn, its branch, rintf and the
    # int conversion, in place of the division-free quotient
    "divide": ("""    l[k] = EXACT ? (uint32_t)quant(v.get(k), s[k], qmax)""",
               """    l[k] = true ? (uint32_t)quant(v.get(k), s[k], qmax)"""),
}


def prepare(rev: str) -> None:
    """Write ``rev``'s kv_quant.cu and common.cuh under
    build/kv_quant_ab/src/parent."""
    sha = subprocess.run(["git", "rev-parse", rev], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    d = WORK / "src/parent"
    d.mkdir(parents=True, exist_ok=True)
    for f in FILES:
        (d / f).write_bytes(subprocess.run(
            ["git", "show", f"{sha}:{CSRC}/{f}"], cwd=ROOT, check=True,
            capture_output=True).stdout)
    (d / "REV").write_text(sha + "\n")
    print(f"{d}: " + " and ".join(FILES) + f" of {sha}")


def build(variants: dict) -> dict:
    """{name: the loaded library of that source}, built all at once."""
    from repro_torch.kernels import _build
    nvcc, procs = _build.nvcc_path(), {}
    for name, src in variants.items():
        lib = WORK / "lib" / name / "libkv_quant.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "kv_quant.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(f"== {name} ({variants[name]})")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print("  " + line.split("ptxas info    : ")[-1])
        h = ctypes.CDLL(str(lib))
        for fn in ("kv_quant_launch", "kv_dequant_launch"):
            f = getattr(h, fn)
            f.argtypes = _build.SIGNATURES["kv_quant"][fn]
            f.restype = ctypes.c_int
        libs[name] = h
    return libs


def _calls(lib, x, plain, bufs, stream) -> dict:
    """{mode: a function launching that mode's kernel once}"""
    from repro_torch.kernels import _build

    def quant(bits):
        packed, scales = bufs[f"packed{bits}"], bufs[f"scales{bits}"]
        return lambda: _build.check(lib.kv_quant_launch(
            x.data_ptr(), _build.DT_BF16, packed.data_ptr(),
            scales.data_ptr(), T, C, bits, stream), "kv_quant_launch")

    def dequant(bits, out):
        packed, scales = plain[bits]
        return lambda: _build.check(lib.kv_dequant_launch(
            packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
            _build.dtype_code(out.dtype), T, C, bits, stream),
            "kv_dequant_launch")

    return {"quant_int8": quant(8), "quant_int4": quant(4),
            "dequant_int8_f32": dequant(8, bufs["f32"]),
            "dequant_int4_f32": dequant(4, bufs["f32"]),
            "dequant_int8_bf16": dequant(8, bufs["bf16"]),
            "dequant_int4_bf16": dequant(4, bufs["bf16"])}


def ablate(name: str) -> pathlib.Path:
    """This tree's sources with ABLATIONS[name] applied, under
    build/kv_quant_ab/src/<name>."""
    d = WORK / "src" / name
    d.mkdir(parents=True, exist_ok=True)
    old, new = ABLATIONS[name]
    text = (ROOT / CSRC / "kv_quant.cu").read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the edit does not apply")
    (d / "kv_quant.cu").write_text(text.replace(old, new))
    (d / "common.cuh").write_text((ROOT / CSRC / "common.cuh").read_text())
    return d


def _check(name, fns, x, plain, bufs) -> None:
    """Every mode's output equal to the plain version's bit for bit."""
    import torch
    from repro_torch.kernels import ref
    for mode, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        bits = 8 if "int8" in mode else 4
        if mode.startswith("quant"):
            got = (bufs[f"packed{bits}"], bufs[f"scales{bits}"])
            want = plain[bits]
        else:
            od = bufs["f32" if mode.endswith("f32") else "bf16"]
            packed, scales = plain[bits]
            q = packed if bits == 8 else ref.unpack_int4(packed)
            got, want = (od,), (ref.kv_dequant_ref(q, scales, od.dtype),)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"{name} {mode}: not equal to the plain "
                                 f"version")
    print(f"{name}: all {len(fns)} modes equal to the plain versions")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def run(variants: dict, out_dir: str) -> int:
    import torch
    from repro_torch.kernels import checks, ref
    dev = torch.device("cuda", 0)
    libs = build(variants)
    g = torch.Generator(device=dev).manual_seed(2626)
    x = torch.randn((T, C), generator=g, device=dev).to(torch.bfloat16)
    plain = {}
    for bits in (8, 4):
        q, s = ref.kv_quant_ref(x, bits)
        plain[bits] = (q if bits == 8 else ref.pack_int4(q), s)
    bufs = {"packed8": torch.empty((T, C), dtype=torch.int8, device=dev),
            "packed4": torch.empty((T // 2, C), dtype=torch.uint8,
                                   device=dev),
            "scales8": torch.empty((1, C), device=dev),
            "scales4": torch.empty((1, C), device=dev),
            "f32": torch.empty((T, C), device=dev),
            "bf16": torch.empty((T, C), dtype=torch.bfloat16, device=dev)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {name: _calls(lib, x, plain, bufs, stream)
           for name, lib in libs.items()}
    for name in fns:
        if name not in ABLATIONS:
            _check(name, fns[name], x, plain, bufs)
    bound = {}
    for mode in MODES:
        bits = 8 if "int8" in mode else 4
        if mode.startswith("quant"):
            nbytes = checks.kv_quant_bytes(x, bits)
        else:
            od = torch.float32 if mode.endswith("f32") else torch.bfloat16
            nbytes = checks.kv_dequant_bytes(*plain[bits], bits, od)
        bound[mode] = checks.bound_ms(nbytes, 0)[0]
    names = list(fns)
    runs = []
    for i, name in enumerate(names + names[::-1]):
        for mode in MODES:
            fn = fns[name][mode]
            kernel = (checks.KV_QUANT_KERNEL if mode.startswith("quant")
                      else checks.KV_DEQUANT_KERNEL)
            runs.append({
                "run": i, "source": name, "mode": mode,
                "warm_ms": checks.device_ms(fn, [kernel], iters=ITERS),
                "cold_ms": checks.device_ms(checks.cold_l2(fn, dev),
                                            [kernel], iters=ITERS),
                "clean_ms": checks.device_ms(checks.cold_l2(fn, dev, "read"),
                                             [kernel], iters=ITERS)})
    report = {"card": _card(), "shape": [T, C], "iters": ITERS,
              "flush_bytes": checks.FLUSH_BYTES,
              "sources": {n: str(v) for n, v in variants.items()},
              "bound_ms": bound, "runs": runs}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "kv_quant_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])
    print("mode, source: device ms of each run, warm | cold | clean L2; "
          "bound ms, cold share of it")
    for mode in MODES:
        for name in names:
            rs = [r for r in runs if r["source"] == name and r["mode"] == mode]
            cold = [r["cold_ms"] for r in rs]
            print(f"{mode:18s} {name:8s} " + " | ".join(
                " ".join(f"{r[k]:.5f}" for r in rs)
                for k in ("warm_ms", "cold_ms", "clean_ms"))
                + f"; {bound[mode]:.5f}, {bound[mode] / max(cold):.1%}-"
                  f"{bound[mode] / min(cold):.1%}")
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prepare", metavar="REV")
    p.add_argument("--ablate", nargs="*", default=[], choices=ABLATIONS)
    p.add_argument("--out", default=str(WORK / "out"))
    a = p.parse_args()
    if a.prepare:
        prepare(a.prepare)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("kv_quant_ab: no CUDA device", file=sys.stderr)
        return 1
    parent = WORK / "src/parent"
    if not (parent / "kv_quant.cu").exists():
        raise SystemExit(f"no kv_quant.cu under {parent}: run --prepare REV "
                         f"first, in a git checkout")
    variants = {"parent": parent, "tree": ROOT / CSRC,
                **{name: ablate(name) for name in a.ablate}}
    return run(variants, a.out)


if __name__ == "__main__":
    sys.exit(main())
