"""Where the fused decode epilogue's time goes: variants of
``csrc/decode_attention.cu`` with one part taken out, timed on the card.

    python scripts/fused_epilogue_ablation.py            # every variant
    python scripts/fused_epilogue_ablation.py full noexch

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with a text
edit (VARIANTS), built into ``build/ablation/<variant>`` (all builds at
once), then timed in its own process: the device ms per call of every
``decode_attn*`` kernel (one unfiltered ``torch.profiler`` record of 20
calls) for ``flash_decode`` and the fused lora and jd (full Sigma) calls at
the serving shape and on the long-context paged cache of
``scripts/fused_decode_ab.py``, and the lora call right after a
4096 x 4096 bf16 product (caches cold, as in a decode step).  A variant
that takes a part out computes a wrong delta: its times say what that part
costs, nothing else.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/ablation"
EXPAND = """  if (e.w_dtype == DT_BF16)
    expand_typed<__nv_bfloat16>(e, t, s, f, b, Kv);
  else if (e.w_dtype == DT_I8)
    expand_typed<int8_t>(e, t, s, f, b, Kv);
  else
    expand_typed<float>(e, t, s, f, b, Kv);
"""
VARIANTS = {  # name: [(text, replacement)] in decode_attention.cu
    "full": [],
    # the expand (its staged rows are still waited for)
    "noexpand": [(EXPAND, "")],
    # the exchange: no cluster wait, no pushes, no wait for them
    "noexch": [
        ("  cluster_wait();                 // every block's barrier is set "
         "up\n", ""),
        ("    st_async(cluster_addr(f.recv + kvh * r + j, h), f.t[j],\n"
         "             cluster_addr(f.xbar, h));\n", ""),
        ("  mbar_wait(f.xbar);              // the Kv partials are in f.recv"
         "\n", "")],
    # no bulk copies at all (the barriers complete with nothing expected)
    "nostage": [
        ("                                                      int sbytes) "
         "{\n", "                                                      int "
         "sbytes) {\n  mbar_expect(f.sbar, 0);\n  mbar_expect(f.wbar, 0);\n"
         "  return;\n")],
    # the expand's rows and Sigma read from device memory, not staged
    "nowstage": [
        ("  e.w_stage = expand16(e) && wb <= EXPAND_MAX ? (int)wb : 0;",
         "  e.w_stage = 0;"),
        ("  e.sig_stage = sb % 16 == 0",
         "  e.sig_stage = false && sb % 16 == 0")],
}


def _setup(variant: str):
    """Point the kernels' build at ``variant``'s sources and directory
    (before their first use); returns the ``_build`` module."""
    d = OUT / variant
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(d / "lib")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    _build.CSRC = d / "csrc"
    return _build


def build(variants) -> None:
    procs = []
    for v in variants:
        d = OUT / v
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d / "csrc")
        p = d / "csrc/decode_attention.cu"
        text = p.read_text()
        for old, new in VARIANTS[v]:
            if text.count(old) != 1:
                raise SystemExit(f"{v}: the edit does not apply: {old!r}")
            text = text.replace(old, new)
        p.write_text(text)
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'scripts')!r}); "
                f"import fused_epilogue_ablation as a; "
                f"a._setup({v!r}).build()")
        procs.append((v, subprocess.Popen([sys.executable, "-c", code])))
    for v, p in procs:
        if p.wait():
            raise SystemExit(f"{v}: the build failed")


def time_variant(variant: str) -> dict:
    _setup(variant)
    import torch
    sys.path.insert(0, str(ROOT / "scripts"))
    import fused_decode_ab as ab
    from repro_torch.kernels import checks
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_decode as fu
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2121)
    big = torch.randn((4096, 4096), device=dev, dtype=torch.bfloat16)
    res = {}
    for name in ("serve", "long_paged"):
        s, d_out, dtype, page_t = ab.CASES[name]
        case = checks.attention_case(s["B"], s["H"], s["Kv"], s["hd"],
                                     s["s_max"], s["bucket"], s["kv_len"],
                                     dtype, gen, dev)
        q, kl = case["q"], case["kv_len"]
        ids = torch.randint(0, ab.N_ADAPTERS, (s["B"],), generator=gen,
                            device=dev, dtype=torch.int32)
        if page_t:
            pc = checks.paged_case(case, page_t, 37, gen)
            kv = (pc["k_pages"], pc["v_pages"], pc["page_table"])
            flash, lora, jd = (fd.flash_decode_paged,
                               fu.fused_decode_lora_paged,
                               fu.fused_decode_jd_paged)
        else:
            kv = (case["k"], case["v"])
            flash, lora, jd = (fd.flash_decode, fu.fused_decode_lora,
                               fu.fused_decode_jd)
        d_in = s["H"] * s["hd"]
        lb = checks.lora_banks(ab.N_ADAPTERS, ab.R, d_in, d_out,
                               torch.bfloat16, gen, dev, False)
        jb = checks.jd_banks(1, ab.N_ADAPTERS, ab.R, d_in, d_out,
                             torch.bfloat16, gen, dev, False, False)
        calls = {
            "flash_decode": lambda: flash(q, *kv, kl),
            "lora": lambda: lora(q, *kv, kl, ids, lb["A"], lb["B"]),
            "lora_after_gemm": lambda: (big @ big, lora(
                q, *kv, kl, ids, lb["A"], lb["B"])),
            "jd_full": lambda: jd(q, *kv, kl, ids, jb["U"], jb["V"],
                                  jb["sigma"], jb["cluster_of"])}
        for call, fn in calls.items():
            res[f"{name}/{call}"] = {
                k.split("<")[0].split()[-1]: ms
                for k, (_, ms) in ab._kernel_split(fn).items()
                if checks.ATTN_KERNEL in k}
    return res


def main() -> int:
    variants = sys.argv[1:] or list(VARIANTS)
    if len(variants) == 2 and variants[0] == "--time":
        print(json.dumps({"variant": variants[1],
                          "device_ms": time_variant(variants[1])}),
              flush=True)
        return 0
    build(variants)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for v in variants:
        if subprocess.run([sys.executable, __file__, "--time", v]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
