"""Drive the PyTorch/CUDA port on one H100 and check it.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code):

1. build: compile the Hopper kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, all started together) for sm_90a and
   print ptxas' register, shared-memory and spill lines;
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
   with ``torch.profiler``.  Then ``adapter_dequantize`` (exact, on the
   fused_q8 path's per-layer banks) and the grouped kernels
   (``sgmv_shrink``, ``sgmv_expand``, ``sigma_bmm``, ``jd_shrink_scale``)
   at ``tests/test_kernels.py``'s sweep shapes and at mistral-7b's width
   (4096 tokens: 32 sequences of 128 on their own adapters of 1000, and
   32 decode tokens), each against its plain version, timed beside one
   ``torch.bmm`` over the tiles where there is one.  The paged kernels run
   at the serving shapes too, over a pool of 16-token and 128-token pages;
3. parity: a reduced model (2 layers, d 64, 4 heads over 2 KV heads, so
   the expand kernel sums partials across heads) in f32, with an f32 KV
   cache, decoding through the fused kernels on the card against the
   plain unfused path on the CPU from the same prefilled cache;
4. serve: ``repro_torch.launch.serve.run_real`` at mistral-7b's full width
   and depth with random weights: jd and lora on fused and fused_q8, and
   one fused run without an o-projection adapter (plain flash_decode
   attention); every request must finish and every kernel's launch count
   must rise.  The counts are zeroed just before this phase and read just
   after it;
5. paged_kv: ``repro_torch.launch.paged_kv.run`` at mistral-7b's full
   width and depth: 8 requests of 1024-2044 prompt tokens (8-16 pages of
   128) served on the fused path in lora and jd mode, 4 decode steps;
   then, for all 32 layers, the cache laid into a pool of pages under a
   permuted table and ``flash_decode_paged`` and the fused paged kernel
   of the mode held bit for bit against the contiguous kernels (and
   against the plain versions); then one request's exported KV as
   (T, 65536) wire blocks of 128 tokens plus a tail, through
   ``kv_quantize`` / ``kv_dequantize`` at int8 and int4, bit for bit
   against the plain versions, within ``ERROR_BOUND``, at ``WIRE_RATIO``
   on the full blocks and at ``KVCompressionConfig.wire_bytes`` in all.
   The five kernels' counts are zeroed just before and read just after;
   then each is timed at this path's shapes (the paged kernels beside the
   contiguous kernel on the same lengths);
6. compress_apply: ``repro_torch.launch.compress_apply.run`` at
   mistral-7b's q-projection width (4096 -> 4096, rank 16) on 1000
   random bf16 adapters: clustered JD-Full (QR iteration, 8 clusters) and
   JD-Diag compression, then ``ops.lora_apply`` / ``ops.jd_apply`` on a
   4096-token prefill batch and a 32-token decode batch; every output is
   held against its plain chain on the card, and the compressed deltas'
   distance from the uncompressed ones against the reconstruction error.
   The grouped kernels' counts are zeroed just before and read just after.

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
    "adapter_dequantize": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/adapter_quant.cu",
        replaces="src/repro/kernels/adapter_quant.py:112"),
    "sgmv_shrink": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sgmv.cu"
        " + src/repro_torch/kernels/csrc/sgmv.cuh",
        replaces="src/repro/kernels/sgmv.py:81"),
    "sgmv_expand": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sgmv.cu",
        replaces="src/repro/kernels/sgmv.py:118"),
    "sigma_bmm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sgmv.cu",
        replaces="src/repro/kernels/sgmv.py:151"),
    "jd_shrink_scale": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/jd_apply.cu"
        " + src/repro_torch/kernels/csrc/sgmv.cuh",
        replaces="src/repro/kernels/jd_apply.py:50"),
    "flash_decode_paged": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/flash_decode.py:135"),
    "fused_decode_lora_paged": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu"
        " + src/repro_torch/kernels/csrc/fused_expand.cu",
        replaces="src/repro/kernels/fused_decode.py:238"),
    "fused_decode_jd_paged": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu"
        " + src/repro_torch/kernels/csrc/fused_expand.cu",
        replaces="src/repro/kernels/fused_decode.py:358"),
    "kv_quantize": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kv_quant.cu",
        replaces="src/repro/kernels/kv_quant.py:81"),
    "kv_dequantize": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kv_quant.cu",
        replaces="src/repro/kernels/kv_quant.py:128"),
}
# compress_apply: mistral-7b's q projection, 1000 adapters, 32 sequences
# of 128 prefill tokens (and one decode token each), 8 clusters, tile 128
CA_ADAPTERS, CA_SEQS, CA_SEQ_LEN, CA_CLUSTERS, TILE = 1000, 32, 128, 8, 128


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

    rows.update(paged_serve_rows(dev, gen, case, bfp, jfp))

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
    rows.update(grouped_kernel_rows(dev, gen))
    return rows


def paged_serve_rows(dev, gen, case, lora_banks, jd_banks):
    """The paged kernels at the serving shapes: checked bit for bit against
    the contiguous kernels over pools of 16- and 128-token pages (ragged
    lengths, int8 banks too), and timed on 16-token pages beside the
    contiguous kernels on the same content.  Returns the timings under
    "serve" for each paged row."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
    from repro_torch.kernels.fused_decode import (fused_decode_jd,
                                                  fused_decode_jd_paged,
                                                  fused_decode_lora,
                                                  fused_decode_lora_paged)
    bf16 = torch.bfloat16
    ragged = checks.attention_case(B, H, KV, HD, S_MAX, BUCKET,
                                   [1, 7, 64, 65, 100, 127, 128, 33], bf16,
                                   gen, dev)
    ragged["ids"] = case["ids"]
    for c in (case, ragged):
        for page_t in (16, 128):
            pc = checks.paged_case(c, page_t, 37, gen)
            checks.check_flash_decode_paged(pc)
            for quant in (False, True):
                checks.check_fused_lora_paged(pc, checks.lora_banks(
                    N_ADAPTERS, R, H * HD, D_OUT, bf16, gen, dev, quant))
                for diag in (True, False):
                    checks.check_fused_jd_paged(pc, checks.jd_banks(
                        1, N_ADAPTERS, R, H * HD, D_OUT, bf16, gen, dev,
                        quant, diag))
    log("[kernels] paged == contiguous bit for bit at the serving shapes "
        "(pages of 16 and 128 tokens, ragged lengths, fp and int8 banks)")
    pc = checks.paged_case(case, 16, 37, gen)
    pa = (pc["q"], pc["k_pages"], pc["v_pages"], pc["page_table"],
          pc["kv_len"])
    ca = (pc["q"], pc["k_logical"], pc["v_logical"], pc["kv_len"])
    la = (case["ids"], lora_banks["A"], lora_banks["B"])
    ja = (case["ids"], jd_banks["U"], jd_banks["V"], jd_banks["sigma"],
          jd_banks["cluster_of"])
    fused = [checks.ATTN_KERNEL, checks.EXPAND_KERNEL]
    specs = {"flash_decode_paged": (flash_decode_paged, flash_decode, (),
                                    [checks.ATTN_KERNEL]),
             "fused_decode_lora_paged": (fused_decode_lora_paged,
                                         fused_decode_lora, la, fused),
             "fused_decode_jd_paged": (fused_decode_jd_paged,
                                       fused_decode_jd, ja, fused)}
    rows = {}
    for name, (paged, cont, extra, kernels) in specs.items():
        rows[name] = {"serve": dict(
            page_t=16, ms=checks.cuda_ms(lambda: paged(*pa, *extra)),
            device_ms=checks.device_ms(lambda: paged(*pa, *extra), kernels),
            contiguous_ms=checks.cuda_ms(lambda: cont(*ca, *extra)),
            contiguous_device_ms=checks.device_ms(lambda: cont(*ca, *extra),
                                                  kernels))}
    return rows


def grouped_kernel_rows(dev, gen):
    """adapter_dequantize and the grouped kernels: checks at the sweep
    shapes and at full width, and the timed rows at the main paths'
    shapes."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels.adapter_quant import (adapter_dequantize,
                                                   adapter_quantize)
    from repro_torch.kernels.jd_apply import jd_shrink_scale
    from repro_torch.kernels.sgmv import sgmv_expand, sgmv_shrink, sigma_bmm
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    def randn(shape, std=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    # dequantize: the fused_q8 path's per-layer q/k/v banks and a full Sigma
    deq = [adapter_quantize(randn((N_ADAPTERS, R, H * HD), 0.02, bf16)),
           adapter_quantize(randn((N_ADAPTERS, D_OUT, R), 0.02, bf16)),
           adapter_quantize(randn((1, H * HD, R), 0.02, bf16), axis=-2),
           adapter_quantize(randn((N_ADAPTERS, R, R), 0.1, bf16)),
           adapter_quantize(randn((3, 50, 70)), axis=-2)]
    for q, sc in deq:
        for od in (f32, bf16):
            checks.check_adapter_dequantize(q, sc, od)
    log(f"[kernels] adapter_dequantize exact on {len(deq)} banks, f32 and "
        f"bf16 out")
    q, sc = deq[0]
    rows["adapter_dequantize"] = dict(
        max_abs_err=0.0, tolerance="exact",
        ms=checks.cuda_ms(lambda: adapter_dequantize(q, sc)),
        device_ms=checks.device_ms(lambda: adapter_dequantize(q, sc),
                                   [checks.DEQUANT_KERNEL]),
        plain_ms=checks.cuda_ms(lambda: ref.adapter_dequant_ref(q, sc)),
        library_ms=checks.cuda_ms(checks.library_dequant(q, sc)),
        bound=checks.bound_ms(checks.dequant_bytes(q, sc, f32), q.numel()))

    # tests/test_kernels.py's sweeps
    worst = {k: 0.0 for k in ("sgmv_shrink", "sgmv_expand", "sigma_bmm",
                              "jd_shrink_scale")}
    for dtype in (bf16, f32):
        for T, d_in, d_out, n, r, tile in checks.SGMV_SWEEP:
            case = checks.sweep_case(T, d_in, n, tile, dtype, gen, dev)
            res = checks.check_sgmv_shrink(case, randn((n, r, d_in), 1 / 8,
                                                       dtype))
            worst["sgmv_shrink"] = max(worst["sgmv_shrink"],
                                       res["max_abs_err"])
            res = checks.check_sgmv_expand(case, res["out"].to(dtype), randn(
                (n, d_out, r), 1 / 4, dtype))
            worst["sgmv_expand"] = max(worst["sgmv_expand"],
                                       res["max_abs_err"])
        for r in (4, 16):
            case = checks.sweep_case(48, r, 4, 8, dtype, gen, dev)
            res = checks.check_sigma_bmm(case, case["x"],
                                         randn((4, r, r), 1 / 4))
            worst["sigma_bmm"] = max(worst["sigma_bmm"], res["max_abs_err"])
    for diag in (True, False):
        for kcl in (1, 3):
            case = checks.sweep_case(64, 192, 6, 8, bf16, gen, dev)
            V, U = randn((kcl, 192, 8), 1 / 8, bf16), randn((kcl, 128, 8),
                                                            1 / 4, bf16)
            cluster_of = (torch.arange(6, device=dev) % kcl).to(torch.int32)
            sig = randn((6, 8)).abs() if diag else randn((6, 8, 8), 1 / 4)
            tile_cids = cluster_of[case["tile_ids"].long()]
            sig_tok = sig[case["ids"].long()].to(bf16) if diag else None
            res = checks.check_jd_shrink_scale(case, V, sig_tok, tile_cids,
                                               cluster_of)
            worst["jd_shrink_scale"] = max(worst["jd_shrink_scale"],
                                           res["max_abs_err"])
            t = res["out"].to(bf16)
            if not diag:
                t = checks.check_sigma_bmm(case, t, sig)["out"]
            cc = dict(case, ids=cluster_of[case["ids"].long()],
                      tile_ids=tile_cids)
            checks.check_sgmv_expand(cc, t, U)
    log(f"[kernels] grouped sweeps ok, max errors "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})} "
        f"({checks.GROUPED_TOL})")

    # full width: mistral-7b's q projection, 1000 adapters, rank 16
    n, r, d = CA_ADAPTERS, R, D_OUT
    adapters = torch.randperm(n, generator=gen, device=dev)[:CA_SEQS]
    A, Bk = randn((n, r, d), 0.02, bf16), randn((n, d, r), 0.02, bf16)
    U, V = randn((CA_CLUSTERS, d, r), 0.02), randn((CA_CLUSTERS, d, r), 0.02)
    sig_full, sig_diag = randn((n, r, r), 0.1), randn((n, r), 0.1)
    cluster_of = torch.randint(0, CA_CLUSTERS, (n,), generator=gen,
                               device=dev, dtype=torch.int32)
    cases = {}
    for bname, per in (("prefill", CA_SEQ_LEN), ("decode", 1)):
        ids = adapters.repeat_interleave(per).to(torch.int32)
        case = checks.grouped_case(ids, n, d, TILE, bf16, gen, dev)
        tile_cids = cluster_of[case["tile_ids"].long()]
        s = checks.check_sgmv_shrink(case, A)
        e = checks.check_sgmv_expand(case, s["out"].to(bf16), Bk)
        sig_tok = sig_diag[case["ids"].long()].to(bf16)
        j = checks.check_jd_shrink_scale(case, V, sig_tok, tile_cids,
                                         cluster_of)
        b = checks.check_sigma_bmm(case, j["out"].to(bf16), sig_full)
        cases[bname] = (case, tile_cids, sig_tok, s, e, j, b)
        log(f"[kernels] grouped {bname} at full width ok ({ids.numel()} "
            f"tokens, {case['x'].shape[0]} rows): shrink "
            f"{s['max_abs_err']:.3e}, expand {e['max_abs_err']:.3e}, "
            f"jd_shrink_scale {j['max_abs_err']:.3e}, sigma_bmm "
            f"{b['max_abs_err']:.3e}")

    # timed at the prefill batch's shapes (T_pad 4096, tile 128)
    case, tile_cids, sig_tok, s, e, j, b = cases["prefill"]
    x, ids, tid = case["x"], case["ids"], case["tile_ids"]
    t = s["out"].to(bf16)
    cids = cluster_of.long()[ids.long()]
    T = x.shape[0]
    specs = {
        "sgmv_shrink": (
            s, lambda: sgmv_shrink(x, A, tid), checks.SHRINK_KERNEL,
            lambda: ref.sgmv_shrink_ref(x.float(), A, ids),
            checks.library_grouped(x, A, tid, transpose=True),
            checks.shrink_bytes(case, A, tid, r), 2 * T * d * r),
        "sgmv_expand": (
            e, lambda: sgmv_expand(t, Bk, tid), checks.SGMV_EXPAND_KERNEL,
            lambda: ref.sgmv_expand_ref(t, Bk, ids),
            checks.library_grouped(t, Bk, tid, transpose=True),
            checks.expand_bytes(t, Bk, tid), 2 * T * d * r),
        "sigma_bmm": (
            b, lambda: sigma_bmm(t, sig_full, tid), checks.SIGMA_KERNEL,
            lambda: ref.sigma_bmm_ref(t, sig_full, ids),
            checks.library_grouped(t, sig_full, tid, transpose=False),
            checks.sigma_bytes(t, sig_full, tid), 2 * T * r * r),
        "jd_shrink_scale": (
            j, lambda: jd_shrink_scale(x, V, sig_tok, tile_cids),
            checks.SHRINK_KERNEL,
            lambda: ref.jd_shrink_scale_ref(x, V, sig_tok, cids), None,
            checks.shrink_bytes(case, V, tile_cids, r, (sig_tok,)),
            2 * T * d * r + T * r),
    }
    for name, (res, fn, kname, plain, lib, nbytes, flops) in specs.items():
        rows[name] = dict(
            max_abs_err=res["max_abs_err"], tolerance=res["tolerance"],
            ms=checks.cuda_ms(fn), device_ms=checks.device_ms(fn, [kname]),
            plain_ms=checks.cuda_ms(plain, iters=10),
            library_ms=None if lib is None else checks.cuda_ms(lib),
            bound=checks.bound_ms(nbytes, flops))
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
    adapter_quant.LAUNCHES = adapter_quant.LAUNCHES_DEQUANT = 0
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
                "adapter_quantize": adapter_quant.LAUNCHES,
                "adapter_dequantize": adapter_quant.LAUNCHES_DEQUANT}
    log("[serve] launches on the main path: " + json.dumps(launches)
        + ' (fused: an attention and an expand launch per layer per step);'
        ' reduced: [] (all 32 layers, full width)')
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    return launches


def phase_paged_kv(dev, rows):
    """The paged-KV and KV-wire path through its entry point at
    mistral-7b's full width and depth; then its five kernels timed at the
    path's shapes (the last layer's pool and table, the exported request's
    first 128-token wire block).  Fills the five kernels' rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import (checks, flash_decode, fused_decode,
                                     kv_quant, ref)
    from repro_torch.launch import paged_kv
    cfg = get_config("mistral-7b")
    flash_decode.LAUNCHES_PAGED = 0
    fused_decode.LAUNCHES_LORA_PAGED = fused_decode.LAUNCHES_JD_PAGED = 0
    kv_quant.LAUNCHES_QUANT = kv_quant.LAUNCHES_DEQUANT = 0
    t0 = time.perf_counter()
    report, art = paged_kv.run(cfg, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {"flash_decode_paged": flash_decode.LAUNCHES_PAGED,
                "fused_decode_lora_paged": fused_decode.LAUNCHES_LORA_PAGED,
                "fused_decode_jd_paged": fused_decode.LAUNCHES_JD_PAGED,
                "kv_quantize": kv_quant.LAUNCHES_QUANT,
                "kv_dequantize": kv_quant.LAUNCHES_DEQUANT}
    log("[paged_kv] launches on the path: " + json.dumps(launches)
        + f"; wall {wall:.1f} s")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the paged_kv path"
    for mode, row in report["modes"].items():
        srv = row["serve"]
        assert row["paged"]["layers"] == cfg.num_layers
        assert min(srv["prompt_lens"]) >= 1024, srv["prompt_lens"]
        log("[paged_kv] " + json.dumps({"mode": mode, **row}))
    log(f"[paged_kv] paged == contiguous bit for bit on all "
        f"{cfg.num_layers} layers in both modes; the KV wire exact, within "
        f"ERROR_BOUND, at WIRE_RATIO and at KVCompressionConfig.wire_bytes; "
        f"reduced: [] (all {cfg.num_layers} layers, full width, prompts "
        f"1024-2044)")

    # timed at this path's shapes: B 8, kv_len 1028-2048, pages of 128
    fused = [checks.ATTN_KERNEL, checks.EXPAND_KERNEL]
    specs = {  # name: (mode, paged, contiguous, plain, check, kernels)
        "flash_decode_paged": (
            "lora", flash_decode.flash_decode_paged, flash_decode.flash_decode,
            ref.flash_decode_paged_ref,
            lambda pc, banks: checks.check_flash_decode_paged(pc),
            [checks.ATTN_KERNEL]),
        "fused_decode_lora_paged": (
            "lora", fused_decode.fused_decode_lora_paged,
            fused_decode.fused_decode_lora, ref.fused_decode_lora_paged_ref,
            checks.check_fused_lora_paged, fused),
        "fused_decode_jd_paged": (
            "jd", fused_decode.fused_decode_jd_paged,
            fused_decode.fused_decode_jd, ref.fused_decode_jd_paged_ref,
            checks.check_fused_jd_paged, fused)}
    for name, (mode, paged, cont, plain, check, kernels) in specs.items():
        pc, banks = art[mode]["paged"]
        case = dict(pc, k=pc["k_logical"], v=pc["v_logical"])
        pa = (pc["q"], pc["k_pages"], pc["v_pages"], pc["page_table"],
              pc["kv_len"])
        ca = (pc["q"], pc["k_logical"], pc["v_logical"], pc["kv_len"])
        if name == "flash_decode_paged":
            extra = ()
            nbytes = checks.attention_bytes(case)
            flops = checks.attention_flops(case)
        else:
            extra = (pc["ids"],) + ((banks["A"], banks["B"]) if mode == "lora"
                                    else (banks["U"], banks["V"],
                                          banks["sigma"], banks["cluster_of"]))
            nbytes = checks.fused_bytes(case, banks, mode)
            flops = checks.fused_flops(case, banks, mode)
        res = check(pc, banks)
        rows[name].update(
            max_abs_err=res["max_abs_err"], tolerance=res["tolerance"],
            ms=checks.cuda_ms(lambda: paged(*pa, *extra)),
            device_ms=checks.device_ms(lambda: paged(*pa, *extra), kernels),
            contiguous_ms=checks.cuda_ms(lambda: cont(*ca, *extra)),
            contiguous_device_ms=checks.device_ms(lambda: cont(*ca, *extra),
                                                  kernels),
            plain_ms=checks.cuda_ms(lambda: plain(*pa, *extra), iters=10),
            library_ms=None,
            bound=checks.bound_ms(nbytes + checks.paged_table_bytes(pc),
                                  flops),
            shape=dict(B=B, kv_len=[int(n) for n in pc["kv_len"]],
                       page_t=pc["page_t"],
                       pool_pages=pc["k_pages"].shape[0]))

    x = art["lora"]["wire_block"]
    assert tuple(x.shape) == (128, 65536) and x.dtype == torch.bfloat16
    q8 = checks.check_kv_quantize(x, 8)
    q4 = checks.check_kv_quantize(x, 4)
    q, sc = q8["packed"], q8["scales"]
    checks.check_kv_dequantize(q, sc, 8, torch.float32)
    quant_ms = checks.cuda_ms(lambda: kv_quant.kv_quantize(x, 8))
    quant_dev = checks.device_ms(lambda: kv_quant.kv_quantize(x, 8),
                                 [checks.KV_QUANT_KERNEL])
    rows["kv_quantize"] = dict(
        max_abs_err=0.0, tolerance="exact", ms=quant_ms, device_ms=quant_dev,
        plain_ms=checks.cuda_ms(lambda: ref.kv_quant_ref(x, 8)),
        library_ms=None, bound=checks.bound_ms(checks.kv_quant_bytes(x, 8),
                                               3 * x.numel()),
        ms_int4=checks.cuda_ms(lambda: kv_quant.kv_quantize(x, 4)),
        device_ms_int4=checks.device_ms(lambda: kv_quant.kv_quantize(x, 4),
                                        [checks.KV_QUANT_KERNEL]),
        launch_overhead_ms=quant_ms - quant_dev,
        shape=dict(T=128, C=65536, bits=8, dtype="bf16"))
    rows["kv_dequantize"] = dict(
        max_abs_err=0.0, tolerance="exact",
        ms=checks.cuda_ms(lambda: kv_quant.kv_dequantize(q, sc, 8)),
        device_ms=checks.device_ms(lambda: kv_quant.kv_dequantize(q, sc, 8),
                                   [checks.KV_DEQUANT_KERNEL]),
        plain_ms=checks.cuda_ms(lambda: ref.kv_dequant_ref(q, sc)),
        library_ms=checks.cuda_ms(checks.library_dequant(q, sc)),
        bound=checks.bound_ms(checks.kv_dequant_bytes(q, sc, 8,
                                                      torch.float32),
                              q.numel()),
        ms_int4=checks.cuda_ms(lambda: kv_quant.kv_dequantize(
            q4["packed"], q4["scales"], 4)),
        shape=dict(T=128, C=65536, bits=8, out="f32"))
    log(f"[paged_kv] kv_quantize launch overhead (CUDA-event ms less device "
        f"ms, one call on a (128, 65536) bf16 block): "
        f"{rows['kv_quantize']['launch_overhead_ms']:.4f} ms")
    return launches


def phase_compress_apply(dev):
    """The compress-then-apply path at mistral-7b's width through its entry
    point, then its outputs against plain chains on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import clustered_reconstruction_errors
    from repro_torch.core.jd import reconstruction_errors
    from repro_torch.kernels import checks, jd_apply, ops, sgmv
    from repro_torch.launch import compress_apply
    cfg = get_config("mistral-7b")
    sgmv.LAUNCHES_SHRINK = sgmv.LAUNCHES_EXPAND = sgmv.LAUNCHES_SIGMA = 0
    jd_apply.LAUNCHES = 0
    t0 = time.perf_counter()
    assert (compress_apply.N_CLUSTERS, compress_apply.TILE) == (CA_CLUSTERS,
                                                                TILE)
    report, art = compress_apply.run(cfg, CA_ADAPTERS, CA_SEQS, CA_SEQ_LEN,
                                     device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {"sgmv_shrink": sgmv.LAUNCHES_SHRINK,
                "sgmv_expand": sgmv.LAUNCHES_EXPAND,
                "sigma_bmm": sgmv.LAUNCHES_SIGMA,
                "jd_shrink_scale": jd_apply.LAUNCHES}
    log("[compress_apply] launches on the path: " + json.dumps(launches)
        + f"; wall {wall:.1f} s")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the compress_apply path"

    bank, bundles = art["bank"], art["bundles"]
    A32, B32 = bank.A.float(), bank.B.float()
    for (mode, bname), y in art["outputs"].items():
        x, ids = art["batches"][bname]
        assert y.shape == (ids.numel(), report["d_out"]), y.shape
        assert y.dtype == x.dtype and bool(torch.isfinite(y).all())
        a = bundles[mode].arrays
        plain = (checks.lora_chain_plain(x, a["A"], a["B"], ids)
                 if mode == "lora" else
                 checks.jd_chain_plain(x, a["U"], a["V"], a["sigma"],
                                       a["cluster_of"], ids))
        err = checks.check_chain(f"{mode} {bname}", y, plain)
        report["modes"][mode].setdefault("max_abs_err", {})[bname] = err
    log(f"[compress_apply] every output within {checks.CHAIN_TOL} of its "
        f"plain chain on the card")

    # where an apply call's time goes: the device's own time per call, all
    # of it and in the port's kernels, beside the CUDA-event time per call
    port = [checks.SHRINK_KERNEL, checks.SGMV_EXPAND_KERNEL,
            checks.SIGMA_KERNEL]
    for mode, bundle in bundles.items():
        a = bundle.arrays
        row = report["modes"][mode]
        for bname, (x, ids) in art["batches"].items():
            if mode == "lora":
                def fn():
                    return ops.lora_apply(x, a["A"], a["B"], ids, tile=TILE)
            else:
                def fn():
                    return ops.jd_apply(x, a["U"], a["V"], a["sigma"],
                                        a["cluster_of"], ids, tile=TILE)
            dev_all = checks.device_ms(fn, [""])
            row.setdefault("device_ms", {})[bname] = dev_all
            row.setdefault("port_kernels_device_ms", {})[bname] = \
                checks.device_ms(fn, port)
            row.setdefault("idle_share", {})[bname] = \
                1.0 - dev_all / row["apply_ms"][bname]

    # the compressed deltas sit as far from the uncompressed ones as the
    # reconstruction error of the batch's adapters says (random tokens):
    # JD-Diag as served; JD-Full with Sigma^T, since the kernels apply
    # t @ Sigma, i.e. U Sigma^T V^T, where compression's Sigma_i is
    # U^T B_i A_i V (the reference's convention, kept by the port)
    for mode, res in art["results"].items():
        errs = (clustered_reconstruction_errors(A32, B32, res)
                if hasattr(res, "assign") else
                reconstruction_errors(A32, B32, res))
        a = bundles[mode].arrays
        for bname, (x, ids) in art["batches"].items():
            sel = torch.unique(ids.long())
            want = float(errs["err_sq"][sel].sum()
                         / errs["norms_sq"][sel].sum()) ** 0.5
            sig = a["sigma"]
            got = report["modes"][mode]["rel_diff_vs_lora"][bname]
            if sig.ndim == 3:
                y = ops.jd_apply(x, a["U"], a["V"],
                                 sig.transpose(1, 2).contiguous(),
                                 a["cluster_of"], ids, tile=TILE)
                yl = art["outputs"][("lora", bname)].float()
                got_t = float(torch.linalg.norm(y.float() - yl)
                              / torch.linalg.norm(yl))
                report["modes"][mode].setdefault(
                    "rel_diff_vs_lora_sigma_t", {})[bname] = got_t
            else:
                got_t = got
            report["modes"][mode].setdefault(
                "rel_err_of_batch_adapters", {})[bname] = want
            # 32 adapters' worth of random tokens: within 15% (decode: one
            # token per adapter) of the expected distance
            slack = 0.05 if bname == "prefill" else 0.15
            assert abs(got_t - want) <= slack * want + 0.01, (
                mode, bname, got_t, want)
    for mode, row in report["modes"].items():
        log("[compress_apply] " + json.dumps({"mode": mode, **row}))
    for bname, row in report["batches"].items():
        log("[compress_apply] batch " + json.dumps({"batch": bname, **row}))
    log("[compress_apply] reduced: [] (1000 adapters, full width)")
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
    launches.update(phase_paged_kv(dev, rows))
    launches.update(phase_compress_apply(dev))
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
        for key in ("contiguous_ms", "contiguous_device_ms", "serve",
                    "ms_int4", "device_ms_int4", "launch_overhead_ms",
                    "shape"):
            if key in r:
                entry[key] = r[key]
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
