"""Drive the PyTorch/CUDA port on one H100 and check it.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code):

1. build: compile the four Hopper kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a and print ptxas' register, shared-memory
   and spill lines;
2. kernels: run each kernel at the main path's shapes (mistral-7b: B 8,
   H 32, Kv 8, hd 128, a 128-token bucket of a 160-token cache, rank 16,
   d_out 4096, 16 adapters, one cluster) in bf16, the fused kernels also
   with int8 banks and JD with a diagonal and a full Sigma; hold each
   against its plain version on the card (tolerances in
   ``repro_torch/kernels/checks.py``), check that the fused kernels'
   attention output equals flash_decode's bit for bit and that
   adapter_quantize equals its plain version exactly; time kernel, plain
   version and, for attention, ``scaled_dot_product_attention`` as a
   yardstick, with CUDA events, and the kernels' own device time per call
   with ``torch.profiler``;
3. parity: a reduced model (2 layers, d 64, 4 heads over 2 KV heads, so
   the expand kernel sums partials across heads) in f32, with an f32 KV
   cache, decoding through the fused kernels on the card against the
   plain unfused path on the CPU from the same prefilled cache;
4. serve: ``repro_torch.launch.serve.run_real`` at mistral-7b's full width
   and depth with random weights: jd and lora on fused and fused_q8, and
   one fused run without an o-projection adapter (plain flash_decode
   attention); every request must finish and every kernel's launch count
   must rise.  The counts are zeroed just before this phase and read just
   after it.

The last lines are the kernel names, the card's name and power limit, one
JSON object with each kernel's numbers, and the ok line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

N_ADAPTERS, N_REQUESTS, MAX_BATCH = 16, 24, 8
B, H, KV, HD, R, D_OUT = 8, 32, 8, 128, 16, 4096
S_MAX, BUCKET, KV_LEN = 160, 128, 32

KERNELS = {
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/flash_decode.py:80"),
    "fused_decode_lora": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu"
        " + src/repro_torch/kernels/csrc/fused_expand.cu",
        replaces="src/repro/kernels/fused_decode.py:178"),
    "fused_decode_jd": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu"
        " + src/repro_torch/kernels/csrc/fused_expand.cu",
        replaces="src/repro/kernels/fused_decode.py:298"),
    "adapter_quantize": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/adapter_quant.cu",
        replaces="src/repro/kernels/adapter_quant.py:71"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build(force=True)
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if line.startswith("==") or any(w in line for w in (
                "registers", "spill", "smem", "Compiling entry")):
            log(f"[ptxas] {line.strip()}")
    _build.lib()


def phase_kernels(dev):
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels.adapter_quant import adapter_quantize
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.fused_decode import (fused_decode_jd,
                                                  fused_decode_lora)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {}

    case = checks.attention_case(B, H, KV, HD, S_MAX, BUCKET, KV_LEN, bf16,
                                 gen, dev)
    case["ids"] = torch.randint(0, N_ADAPTERS, (B,), generator=gen,
                                device=dev, dtype=torch.int32)
    q, k, v, kl = case["q"], case["k"], case["v"], case["kv_len"]
    res = checks.check_flash_decode(case)
    # ragged lengths and the f32 variant, checked but not timed
    checks.check_flash_decode(checks.attention_case(
        B, H, KV, HD, S_MAX, BUCKET, [1, 7, 64, 65, 100, 127, 128, 33], bf16,
        gen, dev))
    checks.check_flash_decode(checks.attention_case(
        B, H, KV, HD, S_MAX, BUCKET, KV_LEN, torch.float32, gen, dev))
    checks.check_flash_decode(checks.attention_case(
        B, H, KV, HD, S_MAX, BUCKET, KV_LEN, torch.float32, gen, dev,
        kv_dtype=bf16))
    lib_err = checks.check_library_attention(case, res["out"])
    nbytes, flops = checks.attention_bytes(case), checks.attention_flops(case)
    rows["flash_decode"] = dict(
        max_abs_err=res["max_abs_err"], tolerance=res["tolerance"],
        ms=checks.cuda_ms(lambda: flash_decode(q, k, v, kl)),
        device_ms=checks.device_ms(lambda: flash_decode(q, k, v, kl),
                                   [checks.ATTN_KERNEL]),
        plain_ms=checks.cuda_ms(lambda: ref.flash_decode_ref(q, k, v, kl)),
        library_ms=checks.cuda_ms(checks.library_attention(case)),
        bound=checks.bound_ms(nbytes, flops))
    log(f"[kernels] flash_decode ok, max_abs_err {res['max_abs_err']:.3e} "
        f"(tol {res['tolerance']}); sdpa agrees within {lib_err:.3e}")

    for quant in (False, True):
        banks = checks.lora_banks(N_ADAPTERS, R, H * HD, D_OUT, bf16, gen,
                                  dev, quant)
        res = checks.check_fused_lora(case, banks)
        log(f"[kernels] fused_decode_lora int8={quant} ok, out == "
            f"flash_decode, delta max_abs_err {res['max_abs_err']:.3e} "
            f"(tol {res['tolerance']})")
    args = (banks["A"], banks["B"], banks["a_scale"], banks["b_scale"])
    bfp = checks.lora_banks(N_ADAPTERS, R, H * HD, D_OUT, bf16, gen, dev,
                            False)
    fargs = (bfp["A"], bfp["B"], None, None)
    res = checks.check_fused_lora(case, bfp)
    fused = [checks.ATTN_KERNEL, checks.EXPAND_KERNEL]
    rows["fused_decode_lora"] = dict(
        max_abs_err=res["max_abs_err"], tolerance=res["tolerance"],
        ms=checks.cuda_ms(lambda: fused_decode_lora(q, k, v, kl,
                                                    case["ids"], *fargs)),
        device_ms=checks.device_ms(lambda: fused_decode_lora(
            q, k, v, kl, case["ids"], *fargs), fused),
        plain_ms=checks.cuda_ms(lambda: ref.fused_decode_lora_ref(
            q, k, v, kl, case["ids"], *fargs)),
        ms_int8=checks.cuda_ms(lambda: fused_decode_lora(
            q, k, v, kl, case["ids"], *args)),
        library_ms=None,
        bound=checks.bound_ms(checks.fused_bytes(case, bfp, "lora"),
                              checks.fused_flops(case, bfp, "lora")))

    for quant in (False, True):
        for diag in (True, False):
            banks = checks.jd_banks(1, N_ADAPTERS, R, H * HD, D_OUT, bf16,
                                    gen, dev, quant, diag)
            res = checks.check_fused_jd(case, banks)
            log(f"[kernels] fused_decode_jd int8={quant} diag={diag} ok, "
                f"out == flash_decode, delta max_abs_err "
                f"{res['max_abs_err']:.3e} (tol {res['tolerance']})")
    # the main path's banks: bf16 bases with a full Sigma (run_real's jd)
    jfp = checks.jd_banks(1, N_ADAPTERS, R, H * HD, D_OUT, bf16, gen, dev,
                          False, False)
    res = checks.check_fused_jd(case, jfp)
    jargs = (jfp["U"], jfp["V"], jfp["sigma"], jfp["cluster_of"])
    rows["fused_decode_jd"] = dict(
        max_abs_err=res["max_abs_err"], tolerance=res["tolerance"],
        ms=checks.cuda_ms(lambda: fused_decode_jd(q, k, v, kl, case["ids"],
                                                  *jargs)),
        device_ms=checks.device_ms(lambda: fused_decode_jd(
            q, k, v, kl, case["ids"], *jargs), fused),
        plain_ms=checks.cuda_ms(lambda: ref.fused_decode_jd_ref(
            q, k, v, kl, case["ids"], *jargs)),
        library_ms=None,
        bound=checks.bound_ms(checks.fused_bytes(case, jfp, "jd"),
                              checks.fused_flops(case, jfp, "jd")))

    # adapter banks as run_real packs them at mistral-7b width (32 layers)
    L = 32
    a_bank = (torch.randn((L, N_ADAPTERS, R, H * HD), generator=gen,
                          device=dev) * 0.02).to(bf16)
    for w, axis in ((a_bank, -1),
                    ((torch.randn((L, N_ADAPTERS, D_OUT, R), generator=gen,
                                  device=dev) * 0.02).to(bf16), -1),
                    ((torch.randn((L, 1, H * HD, R), generator=gen,
                                  device=dev) * 0.02).to(bf16), -2),
                    (torch.randn((4, 64, 48), generator=gen, device=dev), -2)):
        checks.check_adapter_quantize(w, axis)
        log(f"[kernels] adapter_quantize {tuple(w.shape)} {w.dtype} "
            f"axis={axis} ok, exact")
    rows["adapter_quantize"] = dict(
        max_abs_err=0.0, tolerance="exact",
        ms=checks.cuda_ms(lambda: adapter_quantize(a_bank), iters=10),
        device_ms=checks.device_ms(lambda: adapter_quantize(a_bank),
                                   checks.QUANT_KERNELS, iters=10),
        plain_ms=checks.cuda_ms(lambda: ref.adapter_quant_ref(a_bank),
                                iters=10),
        library_ms=None,
        bound=checks.bound_ms(checks.quant_bytes(a_bank, -1),
                              3 * a_bank.numel()))
    return rows


def phase_parity(dev):
    """Fused kernels on the card against the plain path on the CPU, on a
    reduced model in f32 (the tests' fixture width, with two KV heads)."""
    import dataclasses as dc
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import make_bundles
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.serving.real_executor import RealModelExecutor
    from repro_torch.serving.request import Request
    cfg = dc.replace(smoke_config("mistral-7b"), num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
    g = torch.Generator().manual_seed(0)
    params = init_params(tf.model_defs(cfg), g, "cpu",
                         dtype_override=torch.float32)
    for mode in ("lora", "jd"):
        bundles = tree_map(
            lambda t: t.float() if t.is_floating_point() else t,
            make_bundles(cfg, 4, mode, "fused", 1, torch.device("cpu")))
        ex = [RealModelExecutor(cfg, params, bundles, mode, 8, 64,
                                decode_path=p, device=d)
              for d, p in (("cpu", "unfused"), (dev, "fused"))]
        # an f32 cache, so that no K/V value is rounded to bf16 on one
        # device and the other way on the other (one such flip moves these
        # logits by ~1e-4)
        for e in ex:
            e.cache = {k: v.float() if torch.is_tensor(v) else v
                       for k, v in e.cache.items()}
        for rid in range(5):
            prompt = torch.randint(0, 64, (6 + 3 * rid,), generator=g).numpy()
            for e in ex:
                e.prefill_request(Request(rid=rid, adapter_id=rid % 4,
                                          prompt_len=len(prompt),
                                          max_new_tokens=4), prompt)
        # the card decodes from the CPU's prefilled cache: the decode steps
        # are what is compared
        for key in ("k", "v"):
            ex[1].cache[key].copy_(ex[0].cache[key])
        err = 0.0
        for _ in range(3):
            lc = ex[0].decode_logits()[:, -1].float()
            lg = ex[1].decode_logits()[:, -1].float().cpu()
            assert lg.shape == (8, cfg.padded_vocab)
            assert bool(torch.isfinite(lg).all())
            err = max(err, float((lc - lg).abs().max()))
            # f32 throughout; dropping one KV head's share of the
            # o-projection delta moves these logits by ~1e-3
            assert err < 2e-5, f"{mode}: card vs cpu logits differ by {err}"
            nxt = lc.argmax(-1).numpy()
            for e in ex:
                e.slot_tokens[:] = nxt
        log(f"[parity] {mode}: fused on the card == unfused on the CPU, "
            f"max |dlogit| {err:.2e} (tol 2e-5, f32)")


def phase_serve(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import adapter_quant, flash_decode, fused_decode
    from repro_torch.launch.serve import run_real
    cfg = get_config("mistral-7b")
    runs = [("jd", "fused", None), ("jd", "fused_q8", None),
            ("lora", "fused", None), ("lora", "fused_q8", None),
            ("lora", "fused", ("q", "k", "v"))]
    flash_decode.LAUNCHES = 0
    fused_decode.LAUNCHES_LORA = fused_decode.LAUNCHES_JD = 0
    adapter_quant.LAUNCHES = 0
    results = []
    for mode, path, targets in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        stats = run_real(cfg, N_ADAPTERS, N_REQUESTS, mode,
                         max_batch=MAX_BATCH, seed=0, decode_path=path,
                         device=dev, targets=targets)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        assert stats["n_requests"] == N_REQUESTS, stats
        assert stats["n_tokens"] == N_REQUESTS * 8, stats
        row = dict(mode=mode, decode_path=path,
                   targets=list(targets or ("q", "k", "v", "o")),
                   layers=cfg.num_layers, d_model=cfg.d_model,
                   n_requests=stats["n_requests"], n_tokens=stats["n_tokens"],
                   throughput_tps=stats["throughput_tps"],
                   tpot_p50_s=stats["tpot_p50_s"],
                   tpot_p95_s=stats["tpot_p95_s"],
                   ttft_p50_s=stats["ttft_p50_s"],
                   compute_time_s=stats["compute_time_s"],
                   run_wall_s=wall,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                       dev) / 1e9)
        results.append(row)
        log("[serve] " + json.dumps(row))
    launches = {"flash_decode": flash_decode.LAUNCHES,
                "fused_decode_lora": fused_decode.LAUNCHES_LORA,
                "fused_decode_jd": fused_decode.LAUNCHES_JD,
                "adapter_quantize": adapter_quant.LAUNCHES}
    log("[serve] launches on the main path: " + json.dumps(launches)
        + ' (fused: an attention and an expand launch per layer per step);'
        ' reduced: [] (all 32 layers, full width)')
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    rows = phase_kernels(dev)
    phase_parity(dev)
    launches = phase_serve(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    kernels = []
    for name, meta in KERNELS.items():
        r = rows[name]
        b_ms, b_by = r["bound"]
        entry = {"name": name, **meta, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "device_ms": r["device_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": r["library_ms"],
                 "tolerance": r["tolerance"]}
        if "ms_int8" in r:
            entry["ms_int8_banks"] = r["ms_int8"]
        kernels.append(entry)
    log(json.dumps({"kernels": list(KERNELS)}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
