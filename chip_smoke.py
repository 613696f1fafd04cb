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
   attention output equals flash_decode's bit for bit, that one fused
   call launches ``attention_launches(S)`` kernels, all ``decode_attn*``
   (an unfiltered ``torch.profiler`` record: no second stage), and that
   adapter_quantize equals its plain version exactly; time kernel, plain
   version and, for attention, ``scaled_dot_product_attention`` as a
   yardstick, with CUDA events, and the kernels' own device time per call
   with ``torch.profiler``; ``adapter_quantize`` is timed on the three
   packed layouts (A, B and V banks).  Then
   ``adapter_dequantize`` (exact, one bank at a time and grouped, on the
   fused_q8 path's per-layer banks; a lora and a jd layer's banks timed
   in one grouped launch beside one launch a bank) and the grouped kernels
   (``sgmv_shrink``, ``sgmv_expand``, ``sigma_bmm``, ``jd_shrink_scale``)
   at ``tests/test_kernels.py``'s sweep shapes and at mistral-7b's width
   (4096 tokens: 32 sequences of 128 on their own adapters of 1000, and
   32 decode tokens), each against its plain version, timed beside one
   ``torch.bmm`` over the tiles where there is one (the yardsticks also by
   their device time).  The paged kernels run at the serving shapes too,
   over a pool of 16-token and 128-token pages;
3. parity: a reduced model (2 layers, d 64, 4 heads over 2 KV heads, so
   the fused kernels' cluster sums partials across heads) in f32, with an f32 KV
   cache, decoding through the fused kernels on the card against the
   plain unfused path on the CPU from the same prefilled cache;
4. serve: ``repro_torch.launch.serve.run_real`` at mistral-7b's full width
   and depth with random weights: jd and lora on fused and fused_q8, and
   one fused run without an o-projection adapter (plain flash_decode
   attention); every request must finish and every kernel's launch count
   must rise.  The counts are zeroed just before this phase and read just
   after it, and the port's kernel launches per decode step are printed
   for each run (fused_q8: one ``adapter_dequantize_group`` launch a
   layer, plus the prefills' share);
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
   one fused paged call must launch two ``decode_attn*`` kernels (the
   chunks, then the merge with the delta) and nothing else; then each is
   timed at this path's shapes (the paged kernels beside the
   contiguous kernel on the same lengths, two calls held bit for bit, and
   one ``scaled_dot_product_attention`` call on the contiguous cache as the
   attention kernel's yardstick, with the kernel's share of its bound);
   the KV wire kernels on the exported request's first (128, 65536) bf16
   block in six modes (quantize to int8 and int4; dequantize each to f32
   and to bf16), each held bit for bit against its plain version, then
   timed warm, cold (after a 128 MiB write) and on a clean L2 (after a
   128 MiB read) beside its bound (``checks.cold_l2``);
6. compress_apply: ``repro_torch.launch.compress_apply.run`` at
   mistral-7b's q-projection width (4096 -> 4096, rank 16) on 1000
   random bf16 adapters: clustered JD-Full (QR iteration, 8 clusters) and
   JD-Diag compression, then ``ops.lora_apply`` / ``ops.jd_apply`` on a
   4096-token prefill batch and a 32-token decode batch; every output is
   held against its plain chain on the card, and the compressed deltas'
   distance from the uncompressed ones against the reconstruction error.
   The grouped kernels' counts are zeroed just before and read just after;
7. lifecycle: ``repro_torch.launch.grounded_churn.run`` at mistral-7b's
   q-projection width (4096 -> 4096, LoRA rank 16, bf16 weights, f32
   solves): 128 adapters around 7 family centres compressed by
   ``cluster_jd`` to the paper's setting for 128 (rank 16, 7 clusters),
   served by the cost-model fleet of ``benchmarks/adapter_churn.py``'s
   churn cell (3 replicas, cluster affinity, Zipf 1.0 at 90 requests/s,
   300 requests, 1.0 registrations/s, refresh every 2 s).  Hot-registered
   adapters are placed by ``assign_adapter`` on the card and serve raw
   through ``ops.lora_apply``'s kernels against the plain chain; each
   rollout's re-solved candidate passes ``refresh_gate`` and a kernel
   check through ``ops.jd_apply``'s kernels (full Sigma) on every
   replica; the first rollout's candidate is planted bad and must roll
   back; retirements drop their Sigma rows with ``drop_adapter``.  Every
   request must finish, the lifecycle's counters must match the events
   and the gates, and the four grouped kernels' counts, zeroed just
   before, must rise;
8. train: (a) one ``make_train_step`` and one ``make_lora_train_step``
   step of a reduced model (phase 3's, f32) on the card against the CPU
   from the same weights; (b) ``train_lora_collection`` (the paper's
   §5.1: one LoRA per task on a shared base) on mistral-7b at full width
   and depth (32 layers, d 4096, vocab 32000 in chunks of 8000, rank 16
   on q/k/v, bf16 base, remat), 2 tasks x 8 steps of batch 4 x seq 64,
   every loss finite; (c) ``train_full`` at mistral-7b's width cut to one
   layer (the optimizer state of all 32 does not fit the card): 6 steps,
   async checkpoints every 2 steps into a temporary directory, a node
   failure injected at step 5, and the restarted run's final parameters
   and optimizer state equal to a clean run's bit for bit under
   ``torch.use_deterministic_algorithms(True)``, in a child process
   started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (cuBLAS reads it when
   a process creates its first handle; set for the whole script it slowed
   the serve phase's host-bound steps).  Step times are host clock around
   synced work; no port kernel may launch here.
9. families: the other model families at the published widths, one model
   on the card at a time (random weights from seeded generators).  (a)
   each family's smoke config in f32 (weights, activations, cache;
   matrices at 1/sqrt(fan-in)): prefill and 3 decode steps on the card
   against the CPU from the same weights, within ``FAMILY_PARITY_ATOL``, every MoE routing decision on
   the same experts (the smallest top-k margin printed); (b) ``run_real``
   at full width and depth: granite-moe-3b-a800m (lora and jd) and
   mamba2-2.7b on the unfused path, pixtral-12b on ``fused`` in lora and
   jd and with q/k/v adapters only, after rows 1, 3 and 5 are held to
   their plain versions at pixtral's shape (d_out 5120) and timed there;
   every request must finish and rows 1, 3 and 5's counts, zeroed just
   before, must rise; then one profiled decode step of granite and mamba2
   (host and device ms, idle share); (c) at full width and depth, prefill
   and 3 decode steps held to the train-mode forward's logits at the same
   positions, in bf16 within ``FAMILY_BF16_ATOL`` and in f32 within
   ``FAMILY_F32_ATOL``, each matrix drawn at 1/sqrt(its fan-in):
   deepseek-moe-16b, mamba2-2.7b and zamba2-2.7b (529 prompt tokens:
   three SSD chunks, the last padded), whisper-small over 1500 frames,
   and pixtral-12b after 1024 patches.
10. lazy: mistral-7b at full width and depth (lora adapters on q/k/v,
   unfused, batch 8, a 2048-token cache, prompts of 1024-2039 tokens).
   (a) executors with ``decode_attn`` "gather" and "lazy" on one set of
   weights (at 1/sqrt(fan-in)) in lockstep for 8 steps, the lazy one
   starting each step from gather's cache, in f32 (weights and cache;
   the plain two-part version on the card beside the kernel path) and in
   bf16: logits within ``LZ_F32_ATOL`` / ``LZ_BF16_ATOL``, tokens equal
   where gather's top-2 margin exceeds the tolerance, the rows a step
   does not write and layer 0's new row bit for bit, f32 new rows within
   1e-5 of their magnitude; the two-part attention's kernel path held to
   its plain version on a prefilled layer and timed (with its launches a
   call); then each branch's host ms a step and, from one profile, its
   device ms, launches and idle share, row 1's count zeroed before each
   (gather must launch none, lazy 2 a layer a step).  (b) a one-rank
   NCCL group: ``seq_sharded_decode_step`` against ``flash_decode`` and
   the cache write, ``_moe_ep`` under a (1, 1) mesh at granite-moe's
   layer width against the plain dispatch/combine bit for bit (and, with
   room for every token, against ``_moe_dense``), and ``compressed_psum``
   over a one-rank axis as the identity.
11. dryrun: ``repro_torch.launch.dryrun`` against the card, mistral-7b in
   bf16 at full width: (a) prefill of 8 x 2048 and (b, c) one decode step
   of batch 8 against a 2048-token cache at index 2040 under "gather"
   and "lazy", at full depth; (d) ``train_full``'s step (AdamW) at depth
   1, phase 8's batch 4 x 64.  ``measure_cell`` runs each on the card
   (seeded weights at 1/sqrt(fan-in)) beside the meta dry run at the same
   depth, and prints predicted flops, bytes, launches, peak and temp
   bytes, roofline bound and model flops against device ms, host ms,
   device launches and ``max_memory_allocated``, with the bound's share
   of the device time.  It fails where the meta record differs from the
   card's record of the same call op for op (count, flops, bytes,
   launches, row 1's launches) other than the ops of
   ``DR_DEVICE_DECOMPOSED`` (totals then within 1%), the predicted peak
   is not within 5% of the card's, the temp not within max(15%, 64 MiB),
   a share exceeds 1.05, or the dry run judges (d)'s step at all 32
   layers to fit the card.  Row 1's count is zeroed before and read after.
12. sharded: the model's step over DTensors
   (``launch/shardings.py::sharded_step_for``) on a one-rank NCCL group,
   mistral-7b in bf16 at full width and depth (weights at 1/sqrt(fan-
   in)): (a) under the serve rules, the 8 prompts of phase 10 prefilled
   one by one into their slots (``place_inputs``, then each slot written
   with ``write_slice``), then ``SH_STEPS`` lazy decode steps, against
   the replicated step fed the same tokens: logits within ``LZ_BF16_ATOL``
   and tokens equal where the replicated top-2 margin exceeds it; row 1's
   count, zeroed just before the sharded run and read just after, must be
   2 a layer a step, its every call on local tensors; (b) one train step
   at depth 1 under the train rules (phase 8's batch, AdamW eps 1)
   against the replicated step, loss and gradients within phase 8 (a)'s
   bounds.  Host and device ms of both are printed; the phase must end
   within ``SH_PHASE_MAX_S``.

The last lines are the kernel names, the card's name and power limit, one
JSON object with each kernel's numbers, and the ok line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

N_ADAPTERS, N_REQUESTS, MAX_BATCH = 16, 24, 8
B, H, KV, HD, R, D_OUT = 8, 32, 8, 128, 16, 4096
LAYERS = 32    # mistral-7b's depth: the adapter banks are stacked over it
S_MAX, BUCKET, KV_LEN = 160, 128, 32

KERNELS = {
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/flash_decode.py:80"),
    "fused_decode_lora": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/fused_decode.py:178"),
    "fused_decode_jd": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
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
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/fused_decode.py:238"),
    "fused_decode_jd_paged": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
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
# lifecycle: the churn cell's 128-adapter collection (paper setting: JD
# rank 16, 7 clusters) at the q projection's width
LC_ADAPTERS = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build(force=True)
    log(f"[build] {sorted(p.name for p in paths.values())} at once in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if line.startswith("==") or any(w in line for w in (
                "registers", "spill", "smem", "Compiling entry")):
            log(f"[ptxas] {line.strip()}")
    # what a jd prefill's first run builds: its one library
    t0 = time.perf_counter()
    _build.build(force=True, names=["jd_delta"])
    log(f"[build] jd_delta alone in {time.perf_counter() - t0:.1f} s")
    for name in _build.SIGNATURES:
        _build.lib(name)


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
        library_device_ms=checks.device_ms(checks.library_attention(case),
                                           [""]),
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
    fused = [checks.ATTN_KERNEL]
    one_pass = checks.check_one_pass(
        "fused_decode_lora", lambda: fused_decode_lora(
            q, k, v, kl, case["ids"], *fargs), k.shape[1])
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
    checks.check_one_pass("fused_decode_jd", lambda: fused_decode_jd(
        q, k, v, kl, case["ids"], *jargs), k.shape[1])
    log(f"[kernels] one fused call = {one_pass} decode_attn launch and no "
        f"other kernel (unfiltered profile), lora and jd")
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

    # adapter banks as run_real packs them at mistral-7b width and depth
    a_bank = (torch.randn(QUANT_BANKS["A_bank"][0], generator=gen,
                          device=dev) * 0.02).to(bf16)
    for w, axis in ((a_bank, -1),
                    ((torch.randn(QUANT_BANKS["B_bank"][0], generator=gen,
                                  device=dev) * 0.02).to(bf16), -1),
                    ((torch.randn(QUANT_BANKS["V_bank"][0], generator=gen,
                                  device=dev) * 0.02).to(bf16), -2),
                    (torch.randn((4, 64, 48), generator=gen, device=dev), -2)):
        checks.check_adapter_quantize(w, axis)
        log(f"[kernels] adapter_quantize {tuple(w.shape)} {w.dtype} "
            f"axis={axis} ok, exact")
    rows["adapter_quantize"] = dict(
        quantize_readings(dev, gen, ("B_bank", "V_bank")),
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
    fused = [checks.ATTN_KERNEL]
    specs = {"flash_decode_paged": (flash_decode_paged, flash_decode, (),
                                    [checks.ATTN_KERNEL]),
             "fused_decode_lora_paged": (fused_decode_lora_paged,
                                         fused_decode_lora, la, fused),
             "fused_decode_jd_paged": (fused_decode_jd_paged,
                                       fused_decode_jd, ja, fused)}
    rows = {}
    for name, (paged, cont, extra, kernels) in specs.items():
        if name != "flash_decode_paged":
            checks.check_one_pass(name, lambda: paged(*pa, *extra),
                                  pc["page_table"].shape[1] * pc["page_t"])
        rows[name] = {"serve": dict(
            page_t=16, ms=checks.cuda_ms(lambda: paged(*pa, *extra)),
            device_ms=checks.device_ms(lambda: paged(*pa, *extra), kernels),
            contiguous_ms=checks.cuda_ms(lambda: cont(*ca, *extra)),
            contiguous_device_ms=checks.device_ms(lambda: cont(*ca, *extra),
                                                  kernels))}
    return rows


# the packed layouts of the fused_q8 path's banks: (shape, axis)
QUANT_BANKS = {"A_bank": ((LAYERS, N_ADAPTERS, R, H * HD), -1),
               "B_bank": ((LAYERS, N_ADAPTERS, D_OUT, R), -1),
               "V_bank": ((LAYERS, 1, H * HD, R), -2)}


def _timed(checks, fn, kernels, nbytes, flops, iters=50):
    """CUDA-event ms, the kernels' own device ms and the bound of fn."""
    b_ms, b_by = checks.bound_ms(nbytes, flops)
    dev = checks.device_ms(fn, kernels, iters=min(iters, 20))
    return dict(ms=checks.cuda_ms(fn, iters=iters), device_ms=dev,
                bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / dev)


def quantize_readings(dev, gen, names) -> dict:
    """adapter_quantize of the packed layouts ``names`` in bf16, each
    checked exact, then timed."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.adapter_quant import adapter_quantize
    out = {}
    for name in names:
        shape, axis = QUANT_BANKS[name]
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        checks.check_adapter_quantize(w, axis)
        out[name] = dict(shape=list(shape), axis=axis, **_timed(
            checks, lambda: adapter_quantize(w, axis=axis),
            list(checks.QUANT_KERNELS), checks.quant_bytes(w, axis),
            3 * w.numel(), iters=10))
    return out


def _layer_banks(dev, gen, mode: str):
    """Every decode layer's packed q/k/v banks (plus a jd o-target's full
    Sigma), as the fused_q8 path packs them: a list over the layers of
    each layer's ``(q, scale)`` slices of the stacked banks."""
    from repro_torch.kernels.adapter_quant import adapter_quantize
    d, d_kv = H * HD, KV * HD

    def packed(shape, axis=-1):
        w = (torch.randn((LAYERS,) + shape, generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
        return adapter_quantize(w, axis=axis)
    if mode == "lora":
        stacked = [b for do in (d, d_kv, d_kv)
                   for b in (packed((N_ADAPTERS, R, d)),
                             packed((N_ADAPTERS, do, R)))]
    else:
        stacked = [b for do in (d, d_kv, d_kv)
                   for b in (packed((1, do, R)), packed((1, d, R), -2),
                             packed((N_ADAPTERS, R, R)))]
        stacked.append(packed((N_ADAPTERS, R, R)))
    return [[(q[li], s[li]) for q, s in stacked] for li in range(LAYERS)]


def layer_readings(dev, gen) -> dict:
    """A lora and a jd decode layer's banks to f32, in one grouped launch
    and one launch a bank, each checked exact.  Each timed call walks all
    the layers in turn, as a decode step does, so a layer's banks are read
    cold (the layers' banks exceed the 50 MB L2); times are per layer."""
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels.adapter_quant import (adapter_dequantize,
                                                   adapter_dequantize_group)
    f32 = torch.float32
    out = {}
    for mode in ("lora", "jd"):
        layers = _layer_banks(dev, gen, mode)
        pairs = layers[0]
        nbytes = sum(checks.dequant_bytes(q, s, f32) for q, s in pairs)
        values = sum(q.numel() for q, _ in pairs)

        def per_layer(fn):
            r = _timed(checks, fn, [checks.DEQUANT_KERNEL],
                       LAYERS * nbytes, LAYERS * values, iters=10)
            r.update(ms=r["ms"] / LAYERS, device_ms=r["device_ms"] / LAYERS,
                     bound_ms=r["bound_ms"] / LAYERS)
            return r

        def each():
            for p in layers:
                for q, s in p:
                    adapter_dequantize(q, s)

        def grouped():
            for p in layers:
                adapter_dequantize_group(p)
        for (q, s), got in zip(pairs, adapter_dequantize_group(pairs)):
            want = ref.adapter_dequant_ref(q, s)
            assert torch.equal(got, want)
            assert torch.equal(adapter_dequantize(q, s), want)
        out[f"{mode}_layer"] = dict(
            banks=len(pairs), values=values, bytes=nbytes,
            grouped=per_layer(grouped), one_bank_launches=per_layer(each))
        del layers, pairs
    return out


# the score-backlog cell's prefill: one sequence of the median and the
# longest prompt, Mistral-7B's q/k/v and o, 1000 adapters in 8 clusters
JD_DELTA_TOKENS, JD_DELTA_ADAPTERS = (1020, 4096), 1000
JD_DELTA_GROUPS = {"qkv": [H * HD, KV * HD, KV * HD], "o": [H * HD]}


def _host_ms(fn, iters=50) -> float:
    """The host's ms a call of ``fn`` (enqueue only: no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def jd_delta_rows(dev) -> dict:
    """Row 15, jd_delta_ at the cell's shapes: checked against lora.apply's
    einsums, then the kernels' ms (CUDA events) and device ms, the bytes
    bound, the host's ms a call, the launches a call; the same for the
    plain path (all its kernels)."""
    from repro_torch.kernels import checks, jd_delta
    gen = torch.Generator(device=dev).manual_seed(30)
    out = {}
    for T in JD_DELTA_TOKENS:
        for name, outs in JD_DELTA_GROUPS.items():
            case = checks.jd_delta_case(1, T, H * HD, outs, 8,
                                        JD_DELTA_ADAPTERS, R, gen, dev)
            agree = checks.check_jd_delta(case)
            ys = [y.clone() for y in case["ys"]]

            def kernel():
                jd_delta.jd_delta_(case["x"], ys, case["banks"],
                                   case["ids"])

            def plain():
                checks.jd_delta_plain(case)
            row = _timed(checks, kernel, [checks.JD_DELTA_KERNEL],
                         checks.jd_delta_bytes(case), 0)
            seen = checks.kernel_launches(kernel)
            plain_seen = checks.kernel_launches(plain)
            row.update(
                max_abs_err=agree["max_abs_err"],
                equal_share=agree["equal_share"],
                tolerance=agree["tolerance"], host_ms=_host_ms(kernel),
                launches=sum(seen.values()) / 10, kernels=sorted(seen),
                plain_ms=checks.cuda_ms(plain),
                plain_device_ms=checks.device_ms(plain, [""]),
                plain_host_ms=_host_ms(plain),
                plain_launches=sum(plain_seen.values()) / 10,
                bytes=checks.jd_delta_bytes(case),
                **{f"{k}_device_ms": checks.device_ms(
                    kernel, [f"jd_delta_{k}"]) for k in ("shrink",
                                                         "expand")})
            out[f"{name}_T{T}"] = row
            log(f"[jd_delta] {name} T={T} " + json.dumps(row))
    return out


def phase_jd_prefill(dev) -> dict:
    """One ``RealModelExecutor.prefill_request`` as the score-backlog cell
    runs it: Mistral-7B at full width and depth, 1000 jd adapters in 8
    clusters on q, k, v and o, a 1,020-token prompt.  Every delta on the
    kernels (jd_delta's launches counted from 0 just before: 4 a layer;
    the recorder's ``adapter_kernel`` 128 targets, no ``adapter_plain``),
    and its logits as close to an f32 reference (the same weights and
    banks upcast, so every delta takes the einsums) as the plain einsums'
    (takes() patched to refuse): within 1.25x their relative L2 distance.
    Two layers hold the kernels to the einsums within 2**-6 (the GPU
    tests); over 32 layers of random weights the rare other rounding grows
    as any bf16 rounding does, so the two bf16 runs are held to the f32
    run, not to each other."""
    import numpy as np
    from repro_torch import spans
    from repro_torch.configs import get_config
    from repro_torch.kernels import checks, jd_delta
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.serving.real_executor import RealModelExecutor
    from repro_torch.serving.request import Request
    cfg = get_config("mistral-7b")
    L, T, n, k = cfg.num_layers, JD_DELTA_TOKENS[0], JD_DELTA_ADAPTERS, 8
    gen = torch.Generator(device=dev).manual_seed(31)
    params = init_params(tf.model_defs(cfg), gen, dev)
    widths = {"q": (H * HD, H * HD), "k": (H * HD, KV * HD),
              "v": (H * HD, KV * HD), "o": (H * HD, H * HD)}
    bundles = {"layers": {t: {
        "U": checks._randn((L, k, do, R), gen, dev, torch.bfloat16,
                           R ** -0.5),
        "V": checks._randn((L, k, di, R), gen, dev, torch.bfloat16,
                           di ** -0.5),
        "sigma": checks._randn((L, n, R, R), gen, dev, torch.bfloat16,
                               R ** -0.5),
        "cluster_of": (torch.arange(n, dtype=torch.int32, device=dev)
                       % k).expand(L, n).contiguous()}
        for t, (di, do) in widths.items()}}
    prompt = np.random.default_rng(31).integers(0, cfg.vocab_size, T)
    logits = {}

    def prefill(weights=params, banks=bundles):
        ex = RealModelExecutor(cfg, weights, banks, "jd", max_batch=1,
                               s_max=T + 4, decode_path="unfused",
                               device=dev)
        ex._prefill = _keep(ex._prefill, logits)
        ex.prefill_request(Request(rid=0, adapter_id=777, prompt_len=T,
                                   max_new_tokens=1), prompt)
        torch.cuda.synchronize(dev)
        return logits.pop("out")[0, -1].float()
    prefill()                                   # warm up
    jd_delta.LAUNCHES = 0
    spans.start()
    t0 = time.perf_counter()
    got = prefill()
    wall = time.perf_counter() - t0
    counters = spans.take()["counters"]
    launches = jd_delta.LAUNCHES
    assert launches == 4 * L, f"jd_delta launched {launches}, want {4 * L}"
    assert counters.get("adapter_kernel") == 4 * L and \
        "adapter_plain" not in counters, counters
    takes = jd_delta.takes
    jd_delta.takes = lambda *a: False
    try:
        prefill()
        t0 = time.perf_counter()
        want = prefill()
        plain_wall = time.perf_counter() - t0
    finally:
        jd_delta.takes = takes
    def f32(t):
        return t.float() if t.is_floating_point() else t
    ref = prefill(tree_map(f32, params), tree_map(f32, bundles))

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    out = dict(tokens=T, adapters=n, clusters=k, layers=L,
               jd_delta_launches=launches, counters=counters,
               kernels_vs_plain=rel(got, want), kernels_vs_f32=rel(got, ref),
               plain_vs_f32=rel(want, ref), prefill_s=wall,
               plain_prefill_s=plain_wall)
    log("[jd_prefill] " + json.dumps(out))
    assert out["kernels_vs_f32"] <= 1.25 * out["plain_vs_f32"], out
    del params, bundles
    torch.cuda.empty_cache()
    return out


def _keep(fn, store):
    """``fn``, keeping its first output (the logits) in ``store["out"]``."""
    def kept(*args, **kwargs):
        out = fn(*args, **kwargs)
        store["out"] = out[0]
        return out
    return kept


def grouped_kernel_rows(dev, gen):
    """adapter_dequantize and the grouped kernels: checks at the sweep
    shapes and at full width, and the timed rows at the main paths'
    shapes."""
    from repro_torch.kernels import adapter_quant, checks, ref
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
    # the same banks and per-layer slices of stacked ones in one launch
    qa, sa = adapter_quantize(randn((2, N_ADAPTERS, R, H * HD), 0.02, bf16))
    qv, sv = adapter_quantize(randn((2, 1, H * HD, R), 0.02, bf16), axis=-2)
    group = deq + [(qa[1], sa[1]), (qv[1], sv[1])]
    for od in (f32, bf16):
        before = adapter_quant.LAUNCHES_DEQUANT
        checks.check_adapter_dequantize_group(group, od)
        assert adapter_quant.LAUNCHES_DEQUANT == before + 1
    log(f"[kernels] adapter_dequantize exact on {len(deq)} banks one at a "
        f"time and on {len(group)} in one grouped launch, f32 and bf16 out")
    q, sc = deq[0]
    rows["adapter_dequantize"] = dict(
        max_abs_err=0.0, tolerance="exact",
        ms=checks.cuda_ms(lambda: adapter_dequantize(q, sc)),
        device_ms=checks.device_ms(lambda: adapter_dequantize(q, sc),
                                   [checks.DEQUANT_KERNEL]),
        plain_ms=checks.cuda_ms(lambda: ref.adapter_dequant_ref(q, sc)),
        library_ms=checks.cuda_ms(checks.library_dequant(q, sc)),
        library_device_ms=checks.device_ms(checks.library_dequant(q, sc),
                                           [""]),
        bound=checks.bound_ms(checks.dequant_bytes(q, sc, f32), q.numel()),
        # a decode layer's banks, one grouped launch beside one a bank
        layer_group=layer_readings(dev, gen))
    for mode in ("lora", "jd"):
        lg = rows["adapter_dequantize"]["layer_group"][f"{mode}_layer"]
        log(f"[kernels] adapter_dequantize, a {mode} layer's {lg['banks']} "
            f"banks: {lg['grouped']['device_ms']:.5f} device ms in one "
            f"launch ({lg['grouped']['bound_share']:.0%} of its bound), "
            f"{lg['one_bank_launches']['device_ms']:.5f} in one a bank")

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
            library_device_ms=(None if lib is None
                               else checks.device_ms(lib, [""])),
            bound=checks.bound_ms(nbytes, flops))
    # the other bank dtype of each tensor-core route: an f32 B (split into
    # three bf16 pieces) for the expand, a bf16 V for jd_shrink_scale
    B32, Vb = Bk.float(), V.to(bf16)
    variants = {
        ("sgmv_expand", "f32_bank"): (
            checks.check_sgmv_expand(case, t, B32),
            lambda: sgmv_expand(t, B32, tid), checks.SGMV_EXPAND_KERNEL,
            checks.expand_bytes(t, B32, tid), 2 * T * d * r),
        ("jd_shrink_scale", "bf16_bank"): (
            checks.check_jd_shrink_scale(case, Vb, sig_tok, tile_cids,
                                         cluster_of),
            lambda: jd_shrink_scale(x, Vb, sig_tok, tile_cids),
            checks.SHRINK_KERNEL,
            checks.shrink_bytes(case, Vb, tile_cids, r, (sig_tok,)),
            2 * T * d * r + T * r)}
    for (name, key), (res, fn, kname, nbytes, flops) in variants.items():
        b_ms, b_by = checks.bound_ms(nbytes, flops)
        rows[name][key] = dict(
            max_abs_err=res["max_abs_err"], ms=checks.cuda_ms(fn),
            device_ms=checks.device_ms(fn, [kname]), bound_ms=b_ms,
            bound_by=b_by)
    # the tensor-core kernels sum in a fixed order: two calls, same bits
    for fn in (specs["sgmv_shrink"][1], specs["sgmv_expand"][1],
               specs["sigma_bmm"][1], specs["jd_shrink_scale"][1],
               *(v[1] for v in variants.values())):
        assert torch.equal(fn(), fn()), "a grouped kernel is not repeatable"
    log("[kernels] grouped kernels repeat bit for bit at full width")
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


def _serve_launches(adapter_quant, flash_decode, fused_decode, jd_delta):
    return {"flash_decode": flash_decode.LAUNCHES,
            "fused_decode_lora": fused_decode.LAUNCHES_LORA,
            "fused_decode_jd": fused_decode.LAUNCHES_JD,
            "adapter_quantize": adapter_quant.LAUNCHES,
            "adapter_dequantize": adapter_quant.LAUNCHES_DEQUANT,
            "jd_delta": jd_delta.LAUNCHES}


def phase_serve(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import (adapter_quant, flash_decode,
                                     fused_decode, jd_delta)
    from repro_torch.launch.serve import run_real
    from repro_torch.serving.real_executor import RealModelExecutor
    cfg = get_config("mistral-7b")
    runs = [("jd", "fused", None), ("jd", "fused_q8", None),
            ("lora", "fused", None), ("lora", "fused_q8", None),
            ("lora", "fused", ("q", "k", "v"))]
    flash_decode.LAUNCHES = 0
    fused_decode.LAUNCHES_LORA = fused_decode.LAUNCHES_JD = 0
    adapter_quant.LAUNCHES = adapter_quant.LAUNCHES_DEQUANT = 0
    jd_delta.LAUNCHES = 0
    kernels = (adapter_quant, flash_decode, fused_decode, jd_delta)
    # count the decode steps and prefills, for the port's kernel launches
    # per step, and jd_delta's launches inside each
    steps, prefills = [0], [0]
    jd = {"decode": 0, "prefill": 0}
    decode_logits = RealModelExecutor.decode_logits
    prefill_request = RealModelExecutor.prefill_request

    def counted(self):
        steps[0] += 1
        n = jd_delta.LAUNCHES
        out = decode_logits(self)
        jd["decode"] += jd_delta.LAUNCHES - n
        return out

    def counted_prefill(self, req, prompt):
        prefills[0] += 1
        n = jd_delta.LAUNCHES
        prefill_request(self, req, prompt)
        jd["prefill"] += jd_delta.LAUNCHES - n
    results = []
    for mode, path, targets in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        before = _serve_launches(*kernels)
        steps[0] = prefills[0] = jd["decode"] = jd["prefill"] = 0
        t0 = time.perf_counter()
        RealModelExecutor.decode_logits = counted
        RealModelExecutor.prefill_request = counted_prefill
        try:
            stats = run_real(cfg, N_ADAPTERS, N_REQUESTS, mode,
                             max_batch=MAX_BATCH, seed=0, decode_path=path,
                             device=dev, targets=targets)
        finally:
            RealModelExecutor.decode_logits = decode_logits
            RealModelExecutor.prefill_request = prefill_request
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        after = _serve_launches(*kernels)
        per_step = {k: (after[k] - before[k]) / steps[0] for k in after
                    if after[k] > before[k]
                    and k not in ("adapter_quantize", "jd_delta")}
        assert stats["n_requests"] == N_REQUESTS, stats
        assert stats["n_tokens"] == N_REQUESTS * 8, stats
        # jd: q/k/v's and o's delta in prefill, two launches each; q/k/v's
        # in a fused decode step (o's rides in the attention kernel)
        L = cfg.num_layers
        want = ((4 * L * prefills[0], 2 * L * steps[0]) if mode == "jd"
                else (0, 0))
        assert (jd["prefill"], jd["decode"]) == want, (mode, path, jd, want)
        assert after["jd_delta"] - before["jd_delta"] == sum(want)
        row = dict(mode=mode, decode_path=path,
                   targets=list(targets or ("q", "k", "v", "o")),
                   layers=cfg.num_layers, d_model=cfg.d_model,
                   n_requests=stats["n_requests"], n_tokens=stats["n_tokens"],
                   throughput_tps=stats["throughput_tps"],
                   tpot_p50_s=stats["tpot_p50_s"],
                   tpot_p95_s=stats["tpot_p95_s"],
                   ttft_p50_s=stats["ttft_p50_s"],
                   compute_time_s=stats["compute_time_s"],
                   run_wall_s=wall, decode_steps=steps[0],
                   kernel_launches_per_step=per_step,
                   jd_delta_launches_per_layer={
                       "prefill": jd["prefill"] / (L * prefills[0]),
                       "decode_step": jd["decode"] / (L * steps[0])},
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                       dev) / 1e9)
        results.append(row)
        log("[serve] " + json.dumps(row))
    launches = _serve_launches(*kernels)
    log("[serve] launches on the main path: " + json.dumps(launches)
        + ' (fused: one attention launch per layer per step, the o-projection'
        ' delta in it);'
        ' reduced: [] (all 32 layers, full width)')
    log("[serve] the port's kernel launches per decode step: " + json.dumps(
        {f"{r['mode']}/{r['decode_path']}"
         + ("" if r["targets"] == ["q", "k", "v", "o"] else "/qkv"):
         r["kernel_launches_per_step"] for r in results})
        + f" (one attention launch per layer: the 128-token bucket is one "
        f"chunk of {flash_decode.SPLIT_S})")
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
    fused = [checks.ATTN_KERNEL]
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
        if name != "flash_decode_paged":
            n = checks.check_one_pass(
                name, lambda: paged(*pa, *extra),
                pc["page_table"].shape[1] * pc["page_t"])
            log(f"[paged_kv] one {name} call = {n} decode_attn launches "
                f"(the chunks, then the merge with the delta) and no other "
                f"kernel (unfiltered profile)")
        # two calls of the split kernels, same bits
        for fn in (lambda: paged(*pa, *extra), lambda: cont(*ca, *extra)):
            for a, b in zip(fn(), fn()):
                assert torch.equal(a, b), f"{name} is not repeatable"
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
        r = rows[name]
        if name == "flash_decode_paged":
            # the yardstick, never on the path: one
            # scaled_dot_product_attention call with GQA and a length mask
            # on the contiguous cache, held to the kernel as row 1's is
            sdpa = checks.library_attention(case)
            diff = checks.check_library_attention(case, cont(*ca)[0])
            r.update(
                contiguous_library_ms=checks.cuda_ms(sdpa),
                contiguous_library_device_ms=checks.device_ms(sdpa, [""]),
                contiguous_library_max_abs_diff=diff)
            log(f"[paged_kv] sdpa on the contiguous cache (yardstick): "
                f"{r['contiguous_library_device_ms']:.4f} device ms; max "
                f"|diff| from decode_attention {diff:.3e}")
        log(f"[paged_kv] {name}: {r['device_ms']:.4f} device ms paged, "
            f"{r['contiguous_device_ms']:.4f} contiguous (split over "
            f"{flash_decode.n_chunks(pc['page_table'].shape[1] * pc['page_t'])}"
            f" chunks, then merged), against sdpa's "
            f"{rows['flash_decode_paged']['contiguous_library_device_ms']:.4f};"
            f" bound {r['bound'][0]:.4f} ms = "
            f"{r['bound'][0] / r['device_ms']:.1%} of the paged time")

    x = art["lora"]["wire_block"]
    assert tuple(x.shape) == (128, 65536) and x.dtype == torch.bfloat16

    def wire_mode(name, fn, kernel, nbytes, flops):
        """One mode of rows 13 and 14: CUDA-event ms, the kernel's device
        ms warm (the block again and again, inside the L2) and cold (after
        a 128 MiB write, and after a 128 MiB read: a clean L2), and its
        bound.  200 untimed calls first, so that the first mode is not
        timed on a card still settling from the phase before."""
        for _ in range(200):
            fn()
        m = dict(ms=checks.cuda_ms(fn),
                 device_ms=checks.device_ms(fn, [kernel]),
                 device_ms_cold=checks.device_ms(checks.cold_l2(fn, dev),
                                                 [kernel]),
                 device_ms_cold_clean=checks.device_ms(
                     checks.cold_l2(fn, dev, "read"), [kernel]),
                 bound_ms=checks.bound_ms(nbytes, flops)[0])
        log(f"[paged_kv] {name}: device ms {m['device_ms']:.5f} warm, "
            f"{m['device_ms_cold']:.5f} cold ({m['device_ms_cold_clean']:.5f}"
            f" clean L2); bound {m['bound_ms']:.5f} = "
            f"{m['bound_ms'] / m['device_ms_cold']:.1%} of cold")
        return m

    quant, dequant, packs = {}, {}, {}
    for bits in (8, 4):                 # each mode bit for bit, then timed
        res = checks.check_kv_quantize(x, bits)
        packs[bits] = (res["packed"], res["scales"])
        quant[f"int{bits}"] = wire_mode(
            f"kv_quantize int{bits} from bf16",
            lambda bits=bits: kv_quant.kv_quantize(x, bits),
            checks.KV_QUANT_KERNEL, checks.kv_quant_bytes(x, bits),
            3 * x.numel())
    for bits in (8, 4):
        q, sc = packs[bits]
        for od, od_name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            checks.check_kv_dequantize(q, sc, bits, od)
            dequant[f"int{bits}_{od_name}"] = wire_mode(
                f"kv_dequantize int{bits} to {od_name}",
                lambda q=q, sc=sc, bits=bits, od=od: kv_quant.kv_dequantize(
                    q, sc, bits, od),
                checks.KV_DEQUANT_KERNEL,
                checks.kv_dequant_bytes(q, sc, bits, od), q.numel())
    q, sc = packs[8]
    rows["kv_quantize"] = dict(
        max_abs_err=0.0, tolerance="exact", ms=quant["int8"]["ms"],
        device_ms=quant["int8"]["device_ms"],
        plain_ms=checks.cuda_ms(lambda: ref.kv_quant_ref(x, 8)),
        library_ms=None, bound=checks.bound_ms(checks.kv_quant_bytes(x, 8),
                                               3 * x.numel()),
        modes=quant,
        launch_overhead_ms=quant["int8"]["ms"] - quant["int8"]["device_ms"],
        shape=dict(T=128, C=65536, bits=8, dtype="bf16"))
    rows["kv_dequantize"] = dict(
        max_abs_err=0.0, tolerance="exact", ms=dequant["int8_f32"]["ms"],
        device_ms=dequant["int8_f32"]["device_ms"],
        plain_ms=checks.cuda_ms(lambda: ref.kv_dequant_ref(q, sc)),
        library_ms=checks.cuda_ms(checks.library_dequant(q, sc)),
        library_device_ms=checks.device_ms(checks.library_dequant(q, sc),
                                           [""]),
        bound=checks.bound_ms(checks.kv_dequant_bytes(q, sc, 8,
                                                      torch.float32),
                              q.numel()),
        modes=dequant, shape=dict(T=128, C=65536, bits=8, out="f32"))
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


def phase_lifecycle(dev):
    """Online registration, update and retirement through the lifecycle's
    hooks on the card (``launch/grounded_churn.py``), at mistral-7b's
    q-projection width, under the churn cell's traffic."""
    from repro_torch.kernels import jd_apply, sgmv
    from repro_torch.launch import grounded_churn
    sgmv.LAUNCHES_SHRINK = sgmv.LAUNCHES_EXPAND = sgmv.LAUNCHES_SIGMA = 0
    jd_apply.LAUNCHES = 0
    t0 = time.perf_counter()
    rep = grounded_churn.run(width=D_OUT, rank=R, n_base=LC_ADAPTERS,
                             device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {"sgmv_shrink": sgmv.LAUNCHES_SHRINK,
                "sgmv_expand": sgmv.LAUNCHES_EXPAND,
                "sigma_bmm": sgmv.LAUNCHES_SIGMA,
                "jd_shrink_scale": jd_apply.LAUNCHES}
    grounded_churn.check(rep)
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the lifecycle path"
    assert (rep["jd_rank"], rep["clusters"]) == (16, 7), rep
    log(f"[lifecycle] launches on the path: {json.dumps(launches)}")
    log(f"[lifecycle] {rep['finished']} of {rep['n_requests']} requests "
        f"finished; events {json.dumps(rep['events'])}; lifecycle "
        f"{json.dumps(rep['lifecycle'])}")
    log(f"[lifecycle] bank: {rep['n_base']} adapters, {rep['width']} -> "
        f"{rep['width']}, LoRA rank {rep['rank']}, JD rank {rep['jd_rank']}, "
        f"{rep['clusters']} clusters, solved in {rep['base_solve_s']:.3f} s, "
        f"mean rel err {rep['base_mean_rel_err']:.4f}, gate floor "
        f"{rep['max_new_rel_err']:.4f}")
    for r in rep["registrations"]:
        log("[lifecycle] assign " + json.dumps(r))
    for r in rep["rollouts"]:
        log("[lifecycle] rollout " + json.dumps(r))
    for g in rep["gates"]:
        log("[lifecycle] gate " + json.dumps(g))
    ms = [r["assign_ms"] for r in rep["registrations"]]
    solves = sorted({g["solve_s"] for g in rep["gates"]
                     if g["solve_s"] is not None})
    log(f"[lifecycle] assign_adapter ms per adapter (CUDA events): "
        f"{json.dumps(ms)}; re-solve s per rollout: {json.dumps(solves)}; "
        f"gate s: {json.dumps([g['gate_s'] for g in rep['gates']])}; "
        f"agreement max_abs_err: "
        f"{json.dumps([g['max_abs_err'] for g in rep['gates']])}; raw "
        f"overlay max_abs_err: "
        f"{json.dumps([r['raw_max_abs_err'] for r in rep['registrations']])}")
    log(f"[lifecycle] phase {wall:.2f} s (fleet simulated over "
        f"{rep['n_requests']} requests, rps {rep['rps']:.3f} by the H100 "
        f"cost model)")
    return launches


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _reduced_cfg():
    """phase 3's reduced model: 2 layers, d 64, 4 heads over 2 KV heads."""
    import dataclasses as dc
    from repro_torch.configs import smoke_config
    return dc.replace(smoke_config("mistral-7b"), num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


def train_card_vs_cpu(dev) -> dict:
    """(a) One ``make_train_step`` and one ``make_lora_train_step`` step in
    f32 from the same weights on the card and on the CPU.  AdamW's eps is
    1 here: at the default 1e-8 a first step moves each weight by the
    learning rate times the sign of its gradient, so a weight whose
    gradient is ~0 steps by rounding noise on either device; with eps 1
    the step is proportional to the gradient (every op of the update still
    runs), and the updated weights differ by lr times the gradients'
    difference.  The layers' matrices are scaled by 0.1 to std ~1/sqrt(d):
    the stacked-leaf init rule draws them at 1/sqrt(2) (the layer count as
    fan-in), which grows the residual stream ~1e4-fold and makes f32
    gradients ill-conditioned (two f32 orders then differ by up to ~5e-4
    of the largest gradient; scaled, ~5e-7)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params, tree_leaves, tree_map
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.step import (make_lora_train_step,
                                           make_train_step)
    cfg = _reduced_cfg()
    base = init_params(tf.model_defs(cfg), torch.Generator().manual_seed(0),
                       "cpu", dtype_override=torch.float32)
    base["layers"] = tree_map(lambda t: 0.1 * t if t.ndim >= 3 else t,
                              base["layers"])
    lora = init_params(tf.lora_defs_tree(cfg),
                       torch.Generator().manual_seed(1), "cpu",
                       dtype_override=torch.float32)
    g = torch.Generator().manual_seed(2)
    # b starts at zero, which leaves a without a gradient: draw it too
    lora = tree_map(lambda t: t if t.abs().sum() > 0 else 0.05 * torch.randn(
        t.shape, generator=g), lora)
    batch = {"tokens": torch.randint(0, 64, (4, 24), generator=g),
             "targets": torch.randint(-1, 64, (4, 24), generator=g)}
    opt_cfg = {"full": AdamWConfig(eps=1.0),
               "lora": AdamWConfig(lr=1e-3, weight_decay=0.0, eps=1.0)}
    report = {}
    for kind in ("full", "lora"):
        out = []
        for d in ("cpu", dev):
            b = tree_map(lambda t: t.to(d), base)
            bt = {k: v.to(d) for k, v in batch.items()}
            if kind == "full":
                p, opt, m = make_train_step(cfg, opt_cfg[kind])(
                    b, init_opt_state(b), bt)
            else:
                lp = tree_map(lambda t: t.to(d), lora)
                p, opt, m = make_lora_train_step(cfg, opt_cfg[kind])(
                    b, lp, init_opt_state(lp), bt)
            out.append((float(m["loss"]),
                        [t.float().cpu() for t in tree_leaves(p)],
                        [t.cpu() for t in tree_leaves(opt["master"])],
                        [t.cpu() for t in tree_leaves(opt["mu"])]))
        (lc, pc, mc, uc), (lg, pg, mg, ug) = out
        d_loss = abs(lc - lg)
        d_master = max(float((a - b).abs().max()) for a, b in zip(mc, mg))
        # mu is (1 - b1) times the clipped gradient
        scale = max(float(a.abs().max()) for a in uc)
        d_mu = max(float((a - b).abs().max()) for a, b in zip(uc, ug)) / scale
        # full steps return bf16 params, each its master's cast: within one
        # bf16 rounding of each other where the masters straddle a midpoint
        d_param = max(float(((a - b).abs() / torch.clamp(
            torch.maximum(a.abs(), b.abs()), min=1e-30)).max())
            for a, b in zip(pc, pg)) if kind == "full" else d_master
        # f32 throughout: the loss within 1e-5; the gradients (mu) within
        # 1e-5 of the largest (JAX and the port on the CPU: 5e-7); the
        # weights within lr times that (the clipped gradients are at most
        # 1) plus one f32 rounding of the largest
        tol_master = (opt_cfg[kind].lr * 1e-5 + torch.finfo(
            torch.float32).eps * max(float(a.abs().max()) for a in mc))
        assert d_loss <= 1e-5, (kind, lc, lg)
        assert d_mu <= 1e-5, (kind, d_mu)
        assert d_master <= tol_master, (kind, d_master, tol_master)
        if kind == "full":
            assert d_param <= 2.0 ** -7, (kind, d_param)
        report[kind] = dict(loss_cpu=lc, loss_card=lg, max_abs_dloss=d_loss,
                            max_rel_dgrad=d_mu, max_abs_dmaster=d_master,
                            max_rel_dparam=d_param)
        log(f"[train] (a) {kind} step on the card == the CPU's: "
            + json.dumps(report[kind]) + f" (tol: loss 1e-5, gradients 1e-5 "
            f"of the largest, master {tol_master:.3g}, bf16 params one "
            f"rounding; f32, AdamW eps 1)")
    return report


def _timed_steps(module, name, dev, times, losses):
    """Wrap ``module.<name>`` (a train-step builder) so that each step is
    timed (host clock around synced work) and its loss kept; returns the
    original."""
    real = getattr(module, name)

    def build(*a, **kw):
        step = real(*a, **kw)

        def run(*args):
            _sync(dev)
            t0 = time.perf_counter()
            out = step(*args)
            losses.append(float(out[2]["loss"]))
            _sync(dev)
            times.append(time.perf_counter() - t0)
            return out
        return run

    setattr(module, name, build)
    return real


def train_lora_collection_run(dev, cfg, n_tasks, steps, batch, seq) -> dict:
    """(b) ``train_lora_collection`` on ``cfg``: one LoRA per task on a
    shared seeded base, every loss finite."""
    import shutil
    import tempfile
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params
    out = tempfile.mkdtemp(prefix="chip_smoke_loras_")
    times, losses = [], []
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    base = init_params(tf.model_defs(cfg),
                       torch.Generator(dev).manual_seed(0), dev)
    if torch.device(dev).type == "cuda":
        # the peak of training, not of the seeded draw's f32 temporaries
        torch.cuda.reset_peak_memory_stats(dev)
    real = _timed_steps(train, "make_lora_train_step", dev, times, losses)
    t0 = time.perf_counter()
    try:
        res = train.train_lora_collection(
            cfg, n_tasks, steps, batch, seq, out, base_params=base,
            device=dev, log_every=steps)
        files = sorted(os.listdir(out))
    finally:
        train.make_lora_train_step = real
        shutil.rmtree(out, ignore_errors=True)
    wall = time.perf_counter() - t0
    assert len(losses) == n_tasks * steps, losses
    assert all(map(math.isfinite, losses)), losses
    assert files == [f"lora_task{t}.npz" for t in range(n_tasks)] + [
        "summary.json"], files
    # the first step of each task pays for the allocator and cuBLAS warm-up
    steady = sorted(t for i, t in enumerate(times) if i % steps)
    step_s = steady[len(steady) // 2]
    rep = dict(layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, logits_chunk_vocab=cfg.logits_chunk_vocab,
               rank=cfg.lora.rank, targets=list(cfg.lora.targets),
               base_dtype="bfloat16", remat=cfg.remat, batch=batch, seq=seq,
               tasks=n_tasks, steps=steps, losses=losses,
               final_losses=[r["final_loss"] for r in res.values()],
               step_ms_median=1e3 * step_s, step_ms_all=[1e3 * t
                                                         for t in times],
               tokens_per_s=batch * seq / step_s, wall_s=wall)
    if torch.device(dev).type == "cuda":
        rep["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(
            dev) / 1e9
    del base
    return rep


def train_restart_run(dev, cfg, steps, batch, seq, ckpt_every,
                      fail_at) -> dict:
    """(c) ``train_full`` (the fault-tolerant runner, async checkpoints)
    clean, then with a node failure injected at step ``fail_at``: the final
    states must be equal bit for bit.  Deterministic algorithms are on for
    the two runs (the embedding's backward accumulates with index_put_)."""
    import shutil
    import tempfile
    from repro_torch.ft.failures import FailurePlan
    from repro_torch.launch import train
    from repro_torch.models.param import tree_leaves
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    times, losses, saves, restores = [], [], [], []
    real_step = _timed_steps(train, "make_train_step", dev, times, losses)
    real_save, real_restore = train.save_checkpoint, train.restore_checkpoint

    def save(*a, **kw):
        t0 = time.perf_counter()
        path = real_save(*a, **kw)
        saves.append(dict(step=a[1], blocking=kw.get("blocking", True),
                          s=time.perf_counter() - t0))
        return path

    def restore(*a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = real_restore(*a, **kw)
        _sync(dev)
        restores.append(dict(step=a[1], s=time.perf_counter() - t0))
        return out

    train.save_checkpoint, train.restore_checkpoint = save, restore
    was_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        kw = dict(steps=steps, batch=batch, seq=seq, ckpt_every=ckpt_every,
                  device=dev, log_every=steps)
        t0 = time.perf_counter()
        clean = train.train_full(cfg, ckpt_dir=os.path.join(tmp, "clean"),
                                 **kw)
        clean_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(tmp, "clean"))
        n_clean_saves = len(saves)
        t0 = time.perf_counter()
        faulty = train.train_full(cfg, ckpt_dir=os.path.join(tmp, "faulty"),
                                  plan=FailurePlan(fail_at_steps=(fail_at,)),
                                  **kw)
        faulty_s = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "faulty", f"step_{steps}")
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                     for f in os.listdir(ckpt))
        equal = all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(clean), tree_leaves(faulty)))
        n_leaves = len(tree_leaves(clean))
    finally:
        torch.use_deterministic_algorithms(was_det)
        train.make_train_step = real_step
        train.save_checkpoint, train.restore_checkpoint = (real_save,
                                                           real_restore)
        shutil.rmtree(tmp, ignore_errors=True)
    assert equal, "the restarted run's final state differs from the clean run's"
    assert len(restores) == 1 and restores[0]["step"] == (
        fail_at // ckpt_every) * ckpt_every, restores
    assert len(losses) == 2 * steps + fail_at % ckpt_every, losses
    assert all(map(math.isfinite, losses)), losses
    steady = sorted(times[1:steps])
    step_s = steady[len(steady) // 2]
    blocking = [s["s"] for s in saves if s["blocking"]]
    rep = dict(layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, d_ff=cfg.d_ff, batch=batch, seq=seq,
               steps=steps, ckpt_every=ckpt_every, fail_at=fail_at,
               final_state_equal_bitwise=equal, leaves=n_leaves,
               checkpoint_bytes=nbytes, checkpoint_gb=nbytes / 1e9,
               save_blocking_s=blocking,
               save_async_host_copy_s=[s["s"] for s in saves
                                       if not s["blocking"]],
               restore_s=[r["s"] for r in restores],
               saves_clean=n_clean_saves, saves_faulty=len(saves)
               - n_clean_saves, step_ms_median=1e3 * step_s,
               step_ms_min=1e3 * min(times),
               step_ms_all=[1e3 * t for t in times],
               tokens_per_s=batch * seq / step_s, clean_run_s=clean_s,
               faulty_run_s=faulty_s, losses=losses)
    if torch.device(dev).type == "cuda":
        rep["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(
            dev) / 1e9
    return rep


def _kernel_counts() -> dict:
    """Every kernel wrapper's launch counter, by module and name."""
    from repro_torch.kernels import (adapter_quant, flash_decode,
                                     fused_decode, jd_apply, kv_quant, sgmv)
    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
            for m in (adapter_quant, flash_decode, fused_decode, jd_apply,
                      kv_quant, sgmv)
            for k, v in vars(m).items() if k.startswith("LAUNCHES")}


def phase_train(dev):
    """Training and checkpoints on the card: no kernel of the port runs on
    this path (plain torch ops with autograd, as the JAX package's
    training runs no Pallas kernel); the counters confirm it, here and
    in the child process of part (c)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    before = _kernel_counts()
    train_card_vs_cpu(dev)
    cfg = get_config("mistral-7b")
    rep = train_lora_collection_run(dev, cfg, n_tasks=2, steps=8, batch=4,
                                    seq=64)
    log("[train] (b) lora collection " + json.dumps(rep))
    log("[train] (b) reduced: [] (mistral-7b: all 32 layers, d 4096, vocab "
        "32000, rank 16 on q/k/v, bf16 base, remat)")
    del rep
    torch.cuda.empty_cache()    # the child needs ~36 GB of the card
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), RESTART_CHILD],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, timeout=900)
    sys.stdout.write(child.stdout)
    assert child.returncode == 0, child.stderr[-4000:]
    log("[train] (c) reduced: [num_layers 32 -> 1] (bf16 params, f32 master,"
        " mu, nu and bf16 grads of all 32 layers are ~116 GB, over the "
        "card's 80 GB)")
    moved = {k: v - before[k] for k, v in _kernel_counts().items()
             if v != before[k]}
    assert not moved, f"the train path launched the port's kernels: {moved}"
    log(f"[train] the port's kernel launches on this path: 0 (all "
        f"{len(before)} counters unchanged)")
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")


RESTART_CHILD = "--train-restart-child"


def restart_child(dev) -> None:
    """Phase 8 (c) in its own process, under cuBLAS's deterministic
    workspace (the parent sets ``CUBLAS_WORKSPACE_CONFIG``)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8"
    # a first allocation sets up the device's allocator, whose peak
    # statistics train_restart_run resets
    torch.zeros((), device=dev)
    cfg = dc.replace(get_config("mistral-7b"), num_layers=1)
    before = _kernel_counts()
    rep = train_restart_run(dev, cfg, steps=6, batch=4, seq=64,
                            ckpt_every=2, fail_at=5)
    assert _kernel_counts() == before, "part (c) launched a port kernel"
    log("[train] (c) full training with a restart " + json.dumps(rep))


FAMILY_ARCHS = ("deepseek-moe-16b", "granite-moe-3b-a800m", "mamba2-2.7b",
                "zamba2-2.7b", "whisper-small", "pixtral-12b")
# (a) f32 on both sides, TF32 off: the CPU tests' logit tolerance against
# the JAX package (tests/test_torch_families.py, 4x its measured 2.4e-5)
FAMILY_PARITY_ATOL = 1e-4
# (c) decode against the train-mode forward at full width, in bf16 (the
# serving dtype) and in f32, each matrix at 1/sqrt(its fan-in).  Over seeds
# 0-2 (`python -m repro_torch.launch.families --arch X [--f32]` on an
# NVIDIA H100 80GB HBM3 at 700 W) the f32 runs differed by 2.9e-6-2.3e-4
# and the bf16 runs by 0.032-0.041 (whisper-small), 0.17-0.21
# (pixtral-12b), 0.19-0.48 (deepseek-moe-16b), 0.33-0.41 (mamba2-2.7b)
# and 0.42-0.59 (zamba2-2.7b), on logits up to 2.5-7: bf16 rounding in
# 12-64 random layers (and, in the MoE, near-tied experts) that f32 cuts
# 1700-80000x, so no fault of the decode path.  Each bound is ~2x its
# model's largest reading; a logic fault (a wrong cache slice or position)
# moves the logits by their own scale and fails both
FAMILY_BF16_ATOL = {"deepseek-moe-16b": 1.0, "mamba2-2.7b": 0.8,
                    "zamba2-2.7b": 1.2, "whisper-small": 0.1,
                    "pixtral-12b": 0.5}
FAMILY_F32_ATOL = 5e-4
FAMILY_SERVE = (("granite-moe-3b-a800m", "lora", "unfused", None),
                ("granite-moe-3b-a800m", "jd", "unfused", None),
                ("mamba2-2.7b", "lora", "unfused", None),
                ("pixtral-12b", "lora", "fused", None),
                ("pixtral-12b", "jd", "fused", None),
                ("pixtral-12b", "lora", "fused", ("q", "k", "v")))
FAMILY_CHECKS = ("deepseek-moe-16b", "mamba2-2.7b", "zamba2-2.7b",
                 "whisper-small", "pixtral-12b")
FAMILY_REQUESTS = 16


def _free(dev) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def pixtral_kernel_rows(dev) -> dict:
    """Rows 1, 3 and 5 at pixtral-12b's decode shape (H 32, Kv 8, hd 128,
    d_out 5120, rank 16, the serving bucket), held to their plain versions
    under checks' tolerances, then timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import checks, ref
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.fused_decode import (fused_decode_jd,
                                                  fused_decode_lora)
    cfg = get_config("pixtral-12b")
    h, kv, hd, d_out = (cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.d_model)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4321)
    case = checks.attention_case(B, h, kv, hd, S_MAX, BUCKET, KV_LEN, bf16,
                                 gen, dev)
    case["ids"] = torch.randint(0, N_ADAPTERS, (B,), generator=gen,
                                device=dev, dtype=torch.int32)
    q, k, v, kl, ids = (case[x] for x in ("q", "k", "v", "kv_len", "ids"))
    lora = checks.lora_banks(N_ADAPTERS, R, h * hd, d_out, bf16, gen, dev,
                             False)
    jd = checks.jd_banks(1, N_ADAPTERS, R, h * hd, d_out, bf16, gen, dev,
                         False, False)
    largs = (lora["A"], lora["B"], None, None)
    jargs = (jd["U"], jd["V"], jd["sigma"], jd["cluster_of"])
    fused = [checks.ATTN_KERNEL]
    out = {}
    for name, res, fn, plain, kernels, nbytes, flops in (
            ("flash_decode", checks.check_flash_decode(case),
             lambda: flash_decode(q, k, v, kl),
             lambda: ref.flash_decode_ref(q, k, v, kl), [checks.ATTN_KERNEL],
             checks.attention_bytes(case), checks.attention_flops(case)),
            ("fused_decode_lora", checks.check_fused_lora(case, lora),
             lambda: fused_decode_lora(q, k, v, kl, ids, *largs),
             lambda: ref.fused_decode_lora_ref(q, k, v, kl, ids, *largs),
             fused, checks.fused_bytes(case, lora, "lora"),
             checks.fused_flops(case, lora, "lora")),
            ("fused_decode_jd", checks.check_fused_jd(case, jd),
             lambda: fused_decode_jd(q, k, v, kl, ids, *jargs),
             lambda: ref.fused_decode_jd_ref(q, k, v, kl, ids, *jargs),
             fused, checks.fused_bytes(case, jd, "jd"),
             checks.fused_flops(case, jd, "jd"))):
        b_ms, b_by = checks.bound_ms(nbytes, flops)
        out[name] = dict(
            shape=f"B {B}, H {h}, Kv {kv}, hd {hd}, d_out {d_out}, bucket "
                  f"{BUCKET}, kv_len {KV_LEN}",
            max_abs_err=res["max_abs_err"], tolerance=res["tolerance"],
            ms=checks.cuda_ms(fn), device_ms=checks.device_ms(fn, kernels),
            plain_ms=checks.cuda_ms(plain), bound_ms=b_ms, bound_by=b_by)
        log(f"[families] pixtral-12b {name} ok at d_out {d_out}: "
            + json.dumps(out[name]))
    return out


def phase_families(dev, rows) -> dict:
    """Phase 9; returns rows 1, 3 and 5's launches on its serving runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode, fused_decode
    from repro_torch.launch import families
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import run_real
    from repro_torch.serving.real_executor import RealModelExecutor
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[families] card: {smi}")

    # (a) reduced f32 parity, card against the CPU
    for arch in FAMILY_ARCHS:
        r = families.card_vs_cpu(arch, dev)
        assert r["finite"], r
        assert r["routes_equal"], f"{arch}: the card routed otherwise: {r}"
        assert r["max_abs_diff"] < FAMILY_PARITY_ATOL, r
        log(f"[families] (a) {json.dumps(r)} (tol {FAMILY_PARITY_ATOL}, "
            f"f32)")

    # (b) served at full width and depth
    for name, r in pixtral_kernel_rows(dev).items():
        rows[name]["pixtral_12b"] = r
    flash_decode.LAUNCHES = 0
    fused_decode.LAUNCHES_LORA = fused_decode.LAUNCHES_JD = 0
    step_s = []
    decode_logits = RealModelExecutor.decode_logits

    def timed(self):
        _sync(self.device)
        t0 = time.perf_counter()
        out = decode_logits(self)
        _sync(self.device)
        step_s.append(time.perf_counter() - t0)
        return out
    for arch, mode, path, targets in FAMILY_SERVE:
        cfg = get_config(arch)
        _free(dev)
        step_s.clear()
        t0 = time.perf_counter()
        RealModelExecutor.decode_logits = timed
        try:
            stats = run_real(cfg, N_ADAPTERS, FAMILY_REQUESTS, mode,
                             max_batch=MAX_BATCH, seed=0, decode_path=path,
                             device=dev, targets=targets)
        finally:
            RealModelExecutor.decode_logits = decode_logits
        _sync(dev)
        assert stats["n_requests"] == FAMILY_REQUESTS, stats
        assert stats["n_tokens"] == FAMILY_REQUESTS * 8, stats
        row = dict(arch=arch, mode=mode, decode_path=path,
                   targets=list(targets or ("q", "k", "v") + (
                       ("o",) if path != "unfused" else ())),
                   layers=cfg.num_layers, d_model=cfg.d_model,
                   n_requests=stats["n_requests"], n_tokens=stats["n_tokens"],
                   throughput_tps=stats["throughput_tps"],
                   tpot_p50_s=stats["tpot_p50_s"],
                   host_ms_per_step_median=1e3 * sorted(step_s)[
                       len(step_s) // 2],
                   decode_steps=len(step_s),
                   run_wall_s=time.perf_counter() - t0,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                       dev) / 1e9, card=smi)
        log("[families] (b) serve " + json.dumps(row))
    launches = {"flash_decode": flash_decode.LAUNCHES,
                "fused_decode_lora": fused_decode.LAUNCHES_LORA,
                "fused_decode_jd": fused_decode.LAUNCHES_JD}
    log("[families] (b) launches on the served pixtral-12b runs: "
        + json.dumps(launches))
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched at pixtral's width"
    for arch in ("granite-moe-3b-a800m", "mamba2-2.7b"):
        _free(dev)
        prof = profile_decode(get_config(arch), "lora", "unfused",
                              n_adapters=N_ADAPTERS, device=dev)
        prof["card"] = smi
        prof["top_kernels"] = prof["top_kernels"][:3]
        log(f"[families] (b) profile {arch} " + json.dumps(prof))

    # (c) full width and depth, decode held to the train-mode forward
    for arch in FAMILY_CHECKS:
        for dtype, tol in ((torch.bfloat16, FAMILY_BF16_ATOL[arch]),
                           (torch.float32, FAMILY_F32_ATOL)):
            _free(dev)
            r = families.decode_check(get_config(arch), dev, dtype)
            r["card"] = smi
            log(f"[families] (c) {json.dumps(r)} (tol {tol})")
            assert r["finite"], r
            assert r["max_abs_diff"] < tol, r
    _free(dev)
    log("[families] reduced: (a) smoke configs; (b) "
        f"{FAMILY_REQUESTS} requests of ~24 + 8 tokens; (c) batch "
        f"{families.BATCH}, {families.PROMPT} prompt tokens (SSM models "
        f"2 chunks + {families.PROMPT + 1}) + {families.STEPS} steps; no "
        f"width or depth cut")
    log(f"[families] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 10: the lazy decode branch at mistral-7b's full width and depth
LZ_S_MAX, LZ_STEPS, LZ_PROFILE_STEPS = 2048, 8, 4
# prompts of 1024-2039 tokens: the longest reaches position 2047 after the
# 8 steps, so no write is clamped at the cache's end
LZ_PROMPTS = [1024 + 145 * i for i in range(MAX_BATCH)]
# f32 logits, lazy against gather at 32 layers: the port's f32 logits
# tolerance against the JAX package (tests/test_torch_model.py); the
# parity phase's 2e-5 (2 layers) is missed at this depth by the rounding
# of any two f32 attention sums (the plain two-part version against
# gather is printed beside the kernel path)
LZ_F32_ATOL = 1e-4
# bf16 logits, lazy against gather at 32 layers (weights at 1/sqrt(fan-in):
# the reference's init amplifies bf16 rounding, queue 3): pixtral-12b's
# bf16 bound of phase 9 (c), the dense family's; tokens are compared where
# gather's top-2 margin exceeds it
LZ_BF16_ATOL = 0.5


def _lazy_executors(dev, dtype):
    """Two executors over one set of mistral-7b weights (32 layers, lora
    adapters on q/k/v, unfused), ``decode_attn`` "gather" and "lazy", each
    prefilled with the same 8 prompts into a 2048-token cache of
    ``dtype``, weights drawn at 1/sqrt(fan-in)."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.families import fan_in_defs
    from repro_torch.launch.serve import make_bundles
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.serving.real_executor import RealModelExecutor
    from repro_torch.serving.request import Request
    cfg = get_config("mistral-7b")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    defs = tf.model_defs(cfg)
    params = init_params(fan_in_defs(defs), g, dev, dtype_override=dtype)
    bundles = tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                       else t, make_bundles(cfg, N_ADAPTERS, "lora",
                                            "unfused", 11, dev))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LZ_PROMPTS]
    exs = {}
    for branch in ("gather", "lazy"):
        e = RealModelExecutor(dc.replace(cfg, decode_attn=branch), params,
                              bundles, "lora", MAX_BATCH, LZ_S_MAX,
                              decode_path="unfused", device=dev)
        e.cache = {k: v.to(dtype) if torch.is_tensor(v) else v
                   for k, v in e.cache.items()}
        for rid, prompt in enumerate(prompts):
            e.prefill_request(Request(rid=rid, adapter_id=rid % N_ADAPTERS,
                                      prompt_len=len(prompt),
                                      max_new_tokens=4 * LZ_STEPS), prompt)
        exs[branch] = e
    return cfg, exs


def _lazy_lockstep(exs, dtype) -> dict:
    """LZ_STEPS steps of both branches, the lazy executor starting each
    step from the gather executor's cache and both fed gather's tokens:
    rows the step does not write equal bit for bit, layer 0's new row bit
    for bit (its input is the same), the other layers' new rows (after
    attention computed two ways) in f32 within a rounding of their
    magnitude (in bf16 their difference is printed); logits and tokens
    compared."""
    g_ex, l_ex = exs["gather"], exs["lazy"]
    out = dict(max_abs_dlogit=0.0, new_row_max_rel=0.0,
               new_row_elems_differing=0, new_row_elems=0,
               tokens_compared=0, tokens_equal=0, min_margin_compared=None)
    f32 = dtype == torch.float32
    row_tol = 1e-5 if f32 else None
    for _ in range(LZ_STEPS):
        idx = g_ex.cache["index"]
        for key in ("k", "v"):
            l_ex.cache[key].copy_(g_ex.cache[key])
        l_ex.cache["index"] = idx
        before = {key: g_ex.cache[key] for key in ("k", "v")}
        lg = g_ex.decode_logits()[:, -1].float()
        ll = l_ex.decode_logits()[:, -1].float()
        assert bool(torch.isfinite(ll).all())
        out["max_abs_dlogit"] = max(out["max_abs_dlogit"],
                                    float((lg - ll).abs().max()))
        top = torch.topk(lg, 2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        sure = margin > (LZ_F32_ATOL if f32 else LZ_BF16_ATOL)
        out["tokens_compared"] += int(sure.sum())
        out["tokens_equal"] += int((lg.argmax(-1) == ll.argmax(-1))[sure]
                                   .sum())
        if bool(sure.any()):
            m = float(margin[sure].min())
            out["min_margin_compared"] = m if out["min_margin_compared"] \
                is None else min(out["min_margin_compared"], m)
        for key in ("k", "v"):
            gk, lk = g_ex.cache[key], l_ex.cache[key]
            others = torch.ones(LZ_S_MAX, dtype=torch.bool, device=gk.device)
            others[idx] = False
            assert torch.equal(lk[:, :, others], before[key][:, :, others]), \
                f"lazy changed {key} rows it does not write"
            assert torch.equal(gk[:, :, others], before[key][:, :, others])
            assert torch.equal(lk[0, :, idx], gk[0, :, idx]), \
                f"layer 0's new {key} row differs"
            d = (lk[:, :, idx].float() - gk[:, :, idx].float()).abs()
            scale = gk[:, :, idx].float().abs().amax()
            out["new_row_max_rel"] = max(out["new_row_max_rel"],
                                         float(d.max() / scale))
            out["new_row_elems_differing"] += int((d > 0).sum())
            out["new_row_elems"] += d.numel()
        nxt = lg.argmax(-1).cpu().numpy()
        for e in (g_ex, l_ex):
            e.slot_tokens[:] = nxt
    out["new_row_tol"] = row_tol
    out["logit_tol"] = LZ_F32_ATOL if f32 else LZ_BF16_ATOL
    return out


def _check_lockstep(r) -> None:
    assert r["max_abs_dlogit"] < r["logit_tol"], r
    assert r["new_row_tol"] is None or \
        r["new_row_max_rel"] <= r["new_row_tol"], r
    assert r["tokens_equal"] == r["tokens_compared"] > 0, r


def lazy_kernel_row(dev, ex) -> dict:
    """The kernel path of the two-part attention against its plain
    version on one layer's prefilled cache (bf16), and both timed."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    cfg = ex.cfg
    hd = cfg.resolved_head_dim
    ck, cv = ex.cache["k"][5], ex.cache["v"][5]
    idx = ex.cache["index"]
    q = torch.randn((MAX_BATCH, 1, cfg.num_heads, hd), generator=gen,
                    device=dev).to(ck.dtype)
    kn, vn = (torch.randn((MAX_BATCH, 1, cfg.num_kv_heads, hd),
                          generator=gen, device=dev).to(ck.dtype)
              for _ in range(2))
    args = (q, ck, cv, kn, vn, idx)
    got = layers.two_part_decode_attention(*args)
    want = layers._two_part_decode_attention(*args)
    err = checks._assert_close("two-part attention", got, want,
                               checks._out_tol(want))
    launches = checks.kernel_launches(
        lambda: layers.two_part_decode_attention(*args), iters=4)
    per_call = {k: v // 4 for k, v in launches.items()}
    nbytes = 2 * MAX_BATCH * idx * cfg.num_kv_heads * hd * ck.element_size()
    return dict(shape=dict(B=MAX_BATCH, H=cfg.num_heads, Kv=cfg.num_kv_heads,
                           hd=hd, S=LZ_S_MAX, kv_len=idx),
                max_abs_err=err,
                ms=checks.cuda_ms(lambda: layers.two_part_decode_attention(
                    *args), iters=50),
                flash_decode_ms=checks.cuda_ms(
                    lambda: flash_decode(
                        q[:, 0].float().contiguous(), ck, cv,
                        torch.full((MAX_BATCH,), idx, dtype=torch.int32,
                                   device=dev)), iters=50),
                flash_decode_device_ms=checks.device_ms(
                    lambda: layers.two_part_decode_attention(*args),
                    [checks.ATTN_KERNEL]),
                plain_ms=checks.cuda_ms(
                    lambda: layers._two_part_decode_attention(*args),
                    iters=10),
                bound_ms=checks.bound_ms(nbytes, 0)[0],
                launches_per_call=sum(per_call.values()),
                kernels_per_call=per_call)


def phase_lazy(dev) -> dict:
    """Phase 10 (a): lazy against gather; returns row 1's launches on the
    lazy branch's readings run."""
    from repro_torch.kernels import flash_decode
    from repro_torch.launch.profile_decode import profile_steps
    from repro_torch.models import layers
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    # f32 weights and cache: the branches' logits within the parity
    # phase's tolerance
    torch.zeros((), device=dev)             # the allocator, if not yet
    _free(dev)
    cfg, exs = _lazy_executors(dev, torch.float32)
    start = {k: v.clone() for k, v in exs["gather"].cache.items()
             if torch.is_tensor(v)}
    index, tokens = exs["gather"].cache["index"], \
        exs["gather"].slot_tokens.copy()
    kernel_path = layers.two_part_decode_attention
    for name in ("kernel path", "plain two-part"):
        for k, v in start.items():
            exs["gather"].cache[k].copy_(v)
        exs["gather"].cache["index"] = index
        for e in exs.values():
            e.slot_tokens[:] = tokens
        if name == "plain two-part":
            layers.two_part_decode_attention = \
                layers._two_part_decode_attention
        try:
            r = _lazy_lockstep(exs, torch.float32)
        finally:
            layers.two_part_decode_attention = kernel_path
        log(f"[lazy] (a) f32 lockstep, lazy ({name}) against gather, "
            f"{LZ_STEPS} steps: {json.dumps(r)}")
        _check_lockstep(r)
    del exs, start
    # bf16 weights and cache, as served: tokens, then the readings
    _free(dev)
    cfg, exs = _lazy_executors(dev, torch.bfloat16)
    snap = {k: v.clone() for k, v in exs["gather"].cache.items()
            if torch.is_tensor(v)}
    index, tokens = exs["gather"].cache["index"], exs["gather"].slot_tokens
    tokens = tokens.copy()
    r = _lazy_lockstep(exs, torch.bfloat16)
    log(f"[lazy] (a) bf16 lockstep, {LZ_STEPS} steps: {json.dumps(r)} "
        f"(tokens compared where gather's top-2 margin > the logit tol)")
    _check_lockstep(r)
    row = lazy_kernel_row(dev, exs["lazy"])
    log(f"[lazy] (a) two-part attention, kernel path against plain: "
        f"{json.dumps(row)}")
    readings = {}
    launches = {}
    for branch, e in exs.items():
        for k, v in snap.items():
            e.cache[k].copy_(v)
        e.cache["index"], e._host_len = index, index
        e.slot_tokens[:] = tokens
        flash_decode.LAUNCHES = 0
        readings[branch] = profile_steps(e, LZ_PROFILE_STEPS)
        launches[branch] = flash_decode.LAUNCHES
        readings[branch]["top_kernels"] = readings[branch]["top_kernels"][:4]
        readings[branch]["card"] = smi
        log(f"[lazy] (a) {branch} readings (B {MAX_BATCH}, s_max "
            f"{LZ_S_MAX}, kv_len {index}+): {json.dumps(readings[branch])}")
    log(f"[lazy] (a) flash_decode launches: {json.dumps(launches)}")
    assert launches["gather"] == 0 and launches["lazy"] > 0, launches
    steps = 2 * LZ_PROFILE_STEPS + 1
    assert launches["lazy"] == steps * cfg.num_layers * 2, launches
    del exs, snap
    _free(dev)
    phase_lazy_one_rank(dev, smi)
    log(f"[lazy] phase {time.perf_counter() - t_phase:.1f} s")
    return {"flash_decode": launches["lazy"]}


def phase_lazy_one_rank(dev, smi) -> None:
    """Phase 10 (b): the multi-device code on a one-rank NCCL group."""
    import dataclasses as dc
    import socket
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives, grad_compression
    from repro_torch.distributed import sharding as tsh
    from repro_torch.kernels import checks, flash_decode
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import moe
    from repro_torch.models.param import init_params
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = device_mesh(make_mesh((1, 1), ("data", "model")))
        gen = torch.Generator(device=dev)
        gen.manual_seed(14)
        cfg = get_config("mistral-7b")
        hd, H, Kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        ck, cv = rnd(MAX_BATCH, LZ_S_MAX, Kv, hd), rnd(MAX_BATCH, LZ_S_MAX,
                                                       Kv, hd)
        q, kn, vn = rnd(MAX_BATCH, 1, H, hd), rnd(MAX_BATCH, 1, Kv, hd), \
            rnd(MAX_BATCH, 1, Kv, hd)
        idx = torch.tensor(LZ_PROMPTS, dtype=torch.int32, device=dev)
        rows = torch.arange(MAX_BATCH, device=dev)
        wk, wv = ck.clone(), cv.clone()
        wk[rows, idx.long()] = kn[:, 0]
        wv[rows, idx.long()] = vn[:, 0]
        want = flash_decode.flash_decode(q[:, 0].contiguous(), wk, wv,
                                         idx + 1)[0]
        out, k2, v2 = collectives.seq_sharded_decode_step(
            q, ck.clone(), cv.clone(), kn, vn, idx, mesh)
        assert torch.equal(k2, wk) and torch.equal(v2, wv)
        err = checks._assert_close("seq_sharded_decode_step", out[:, 0],
                                   want, checks._out_tol(want))
        log(f"[lazy] (b) seq_sharded_decode_step on a one-rank NCCL group "
            f"== flash_decode + the cache write (B {MAX_BATCH}, S "
            f"{LZ_S_MAX}, H {H}, Kv {Kv}, bf16): cache bit for bit, out "
            f"max |d| {err:.3e} (bf16 tol 2^-7 |ref| + 1e-5)")
        # _moe_ep at granite-moe-3b-a800m's layer width under (1, 1)
        gcfg = get_config("granite-moe-3b-a800m")
        p = init_params(moe.moe_defs(gcfg), gen, dev,
                        dtype_override=torch.float32)
        x = torch.randn((8, 512, gcfg.d_model), generator=gen, device=dev)
        xt = x.reshape(-1, gcfg.d_model)
        topw, topi, _ = moe._route(p, xt, gcfg)
        with tsh.use_mesh(mesh):
            y, _ = moe.moe_fwd(p, x, gcfg)
        m = gcfg.moe
        cap = max(int(xt.shape[0] * m.top_k / m.num_experts
                      * m.capacity_factor) + 1, 4)
        buf, eid, slot, valid = moe._dispatch(xt, topi, cap, m.num_experts)
        plain = moe._combine(moe._expert_ffn(buf, p["w_gate"], p["w_up"],
                                             p["w_down"]), eid, slot, valid,
                             topw)
        assert torch.equal(y.reshape(-1, gcfg.d_model), plain)
        dropped = int((~valid).sum())
        wide = dc.replace(gcfg, moe=dc.replace(
            m, capacity_factor=m.num_experts / m.top_k))    # room for all
        with tsh.use_mesh(mesh):
            y_wide, _ = moe.moe_fwd(p, x, wide)
        dense = moe._moe_dense(p, xt, topw, topi, gcfg)
        d_err = checks._assert_close("_moe_ep (no drops) vs _moe_dense",
                                     y_wide.reshape(-1, gcfg.d_model), dense,
                                     1e-4 * (1 + dense.abs()))
        log(f"[lazy] (b) _moe_ep under a (1, 1) mesh at granite-moe's layer "
            f"width (E {m.num_experts}, top-{m.top_k}, d {gcfg.d_model}, "
            f"8 x 512 tokens, f32) == the plain dispatch/combine bit for "
            f"bit ({dropped} of {valid.numel()} choices dropped at capacity "
            f"{cap}); with capacity for all, vs _moe_dense max |d| "
            f"{d_err:.3e}")
        g = rnd(4096, 16).float()
        assert grad_compression.compressed_psum(g, "data", mesh) is g
        log(f"[lazy] (b) compressed_psum over a one-rank axis is the "
            f"identity; card {smi}")
    finally:
        dist.destroy_process_group()


# phase 11: the dry run against the card (mistral-7b, bf16, full width)
DR_ARCH = "mistral-7b"
# (label, shape (name, seq_len, batch, kind), overrides, layers, index)
DR_RUNS = (("a", ("prefill_8x2048", 2048, 8, "prefill"), {}, None, None),
           ("b", ("decode_8x2048", 2048, 8, "decode"),
            {"decode_attn": "gather"}, None, 2040),
           ("c", ("decode_8x2048", 2048, 8, "decode"),
            {"decode_attn": "lazy"}, None, 2040),
           ("d", ("train_4x64", 64, 4, "train"), {}, 1, None))
# aten ops whose decomposition torch picks by device, so that the meta
# record may differ from the card's there (op -> why); none is known on
# these steps: the model code makes its constants with torch.full (not
# torch.tensor, which goes another way on meta) and its one-hot as a
# comparison (F.one_hot does)
DR_DEVICE_DECOMPOSED: dict = {}
DR_PEAK_TOL, DR_TEMP_TOL, DR_TEMP_FLOOR = 0.05, 0.15, 64 << 20
DR_TOTALS_TOL, DR_SHARE_MAX = 0.01, 1.05


def _dryrun_check(label: str, r: dict, diffs: list) -> None:
    """Phase 11's checks of one run (raised uncaught); ``diffs`` the meta
    record's differences from the card's."""
    pred, meas = r["predicted"], r["measured"]
    bad = [d for d in diffs if d[0] == "kernels"
           or d[1] not in DR_DEVICE_DECOMPOSED]
    assert not bad, f"({label}) the meta record differs from the card's: {bad}"
    for key in ("flops", "bytes"):
        a, b = pred["op_cost"][key], meas["op_cost"][key]
        assert abs(a - b) <= DR_TOTALS_TOL * max(b, 1), \
            f"({label}) {key}: meta {a} against the card's {b}"
    peak, want = pred["memory"]["peak_bytes"], meas["peak_bytes"]
    assert abs(peak - want) <= DR_PEAK_TOL * want, \
        f"({label}) peak {peak} predicted, {want} on the card"
    temp, want = pred["memory"]["temp_bytes"], meas["temp_bytes"]
    assert abs(temp - want) <= max(DR_TEMP_TOL * want, DR_TEMP_FLOOR), \
        f"({label}) temp {temp} predicted, {want} on the card"
    assert r["share"] <= DR_SHARE_MAX, \
        f"({label}) bound {pred['bound_ms']} ms over device " \
        f"{meas['device_ms']} ms = {r['share']}"


def phase_dryrun(dev, smi: str) -> dict:
    """Phase 11: the meta dry run against the card; returns row 1's
    launches in the phase."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_decode
    from repro_torch.launch import dryrun, op_cost
    t_phase = time.perf_counter()
    torch.zeros((), device=dev)             # the allocator, if not yet
    _free(dev)
    flash_decode.LAUNCHES = 0
    for label, shp, overrides, layers, index in DR_RUNS:
        shape = ShapeConfig(*shp)
        r = dryrun.measure_cell(DR_ARCH, shape, overrides, layers, dev,
                                index=index)
        pred, meas = r["predicted"], r["measured"]
        diffs = op_cost.compare(pred["op_cost"], meas["op_cost"])
        line = {
            "run": label, "arch": DR_ARCH, "shape": shp,
            "overrides": overrides, "layers": r["layers"],
            "index": r["index"], "card": smi,
            "predicted": {
                "flops": pred["op_cost"]["flops"],
                "bytes": pred["op_cost"]["bytes"],
                "launches": pred["op_cost"]["launches"],
                "port_kernels": pred["op_cost"]["kernels"],
                "peak_bytes": pred["memory"]["peak_bytes"],
                "temp_bytes": pred["memory"]["temp_bytes"],
                "argument_bytes": pred["memory"]["step_argument_bytes"],
                "bound_ms": pred["bound_ms"],
                "bottleneck": pred["roofline"]["bottleneck"],
                "model_flops": pred["roofline"]["model_flops"],
                "fits": pred["fits"]},
            "measured": {k: meas[k] for k in (
                "device_ms", "host_ms", "host_ms_all", "device_launches",
                "max_memory_allocated", "peak_bytes", "temp_bytes",
                "argument_bytes", "profile_attempts", "profile_whole")},
            "card_record": {k: meas["op_cost"][k] for k in (
                "flops", "bytes", "launches", "ops")},
            "share": r["share"],
            "op_diffs": diffs}
        log(f"[dryrun] ({label}) {json.dumps(line)}")
        _dryrun_check(label, r, diffs)
        del r
        _free(dev)
    # (d)'s step at all 32 layers, same batch: the optimizer state alone
    # is ~116 GB, so the dry run must judge that it does not fit
    full = dryrun.predict(get_config(DR_ARCH), ShapeConfig(*DR_RUNS[3][1]))
    log(f"[dryrun] (d) at 32 layers: peak {full['memory']['peak_bytes']} "
        f"bytes predicted, fits {full['fits']}")
    assert not full["fits"], "the dry run judged (d) at 32 layers to fit"
    n = flash_decode.LAUNCHES
    assert n > 0, "phase 11 (c) launched no flash_decode"
    log(f"[dryrun] flash_decode launches {n}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"flash_decode": n}


# phase 12: the sharded step on a one-rank NCCL group (mistral-7b, bf16)
SH_STEPS = 4            # lazy decode steps after the prefill
SH_TRAIN = ("train_4x64", 64, 4, "train")      # phase 8's batch
SH_PHASE_MAX_S = 120
# the loss and the gradients (AdamW's first moment) of the train step on
# the one-rank mesh against the replicated step: phase 8 (a)'s bounds
SH_LOSS_ATOL, SH_GRAD_TOL = 1e-5, 1e-5


def _sh_serve(dev, cfg, params, prompts, mesh=None, feed=None):
    """Prefill each prompt into its slot of a batch-8 cache (as
    ``RealModelExecutor.prefill_request`` does, batch 1 a prompt), then
    ``SH_STEPS`` lazy decode steps fed ``feed`` (each step's tokens; by
    default each step's argmax).  With ``mesh`` through the sharded step
    (``sharded_step_for``) on DTensors placed by ``place_inputs``, else
    through the replicated step.  Returns each prefill's last logits, each
    step's logits (host f32), the tokens fed, the decode steps' host ms,
    and (fn, args) of one more decode step for a profile."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import write_slice
    from repro_torch.launch import shardings as tshard
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    pre1 = ShapeConfig("prefill_1", LZ_S_MAX, 1, "prefill")
    dec = ShapeConfig("decode_8", LZ_S_MAX, MAX_BATCH, "decode")

    def host(x):
        return (x.full_tensor() if hasattr(x, "full_tensor") else x).float(
        ).cpu()

    def place(shape, **trees):
        return tshard.place_inputs(cfg, shape, mesh, device=dev, **trees) \
            if mesh is not None else trees

    def step(shape):
        return tshard.sharded_step_for(cfg, shape, mesh) \
            if mesh is not None else api.step_fn_for(cfg, shape)

    cache = place(dec, cache=tf.init_cache(cfg, MAX_BATCH, LZ_S_MAX,
                                           device=dev))["cache"]
    firsts, first_logits = [], []
    for slot, prompt in enumerate(prompts):
        ins = place(pre1, batch={"tokens": torch.as_tensor(
            prompt[None], dtype=torch.long, device=dev)},
            cache=tf.init_cache(cfg, 1, LZ_S_MAX, device=dev))
        lg, c1 = step(pre1)(params, ins["batch"], ins["cache"])
        for key in ("k", "v"):
            write_slice(cache[key], c1[key], slot, 1, inplace=True)
        cache["index"] = max(cache["index"], len(prompt))
        first_logits.append(host(lg)[0, -1])
        firsts.append(int(first_logits[-1].argmax()))
        del lg, c1, ins
    tokens = torch.tensor(firsts, dtype=torch.long)
    out = {"prefill_logits": torch.stack(first_logits), "logits": [],
           "fed": [], "host_ms": []}
    decode = step(dec)
    for i in range(SH_STEPS):
        fed = feed[i] if feed is not None else tokens
        batch = place(dec, batch={"tokens": fed[:, None].to(dev)})["batch"]
        _sync(dev)
        t0 = time.perf_counter()
        lg, cache = decode(params, batch, cache)
        lgh = host(lg)[:, -1]
        out["host_ms"].append(1e3 * (time.perf_counter() - t0))
        out["logits"].append(lgh)
        out["fed"].append(fed)
        tokens = lgh.argmax(-1)
    out["profile"] = (decode, (params, batch, cache))
    return out


def _sh_train(dev, cfg, params, batch, mesh=None):
    """One full train step (AdamW, eps 1 as phase 8 (a)) replicated or
    through the sharded step under the train rules; (loss, mu leaves,
    master leaves) on the host, the step's host ms, and (fn, args)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import shardings as tshard
    from repro_torch.models.param import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.step import make_train_step
    opt_cfg = AdamWConfig(eps=1.0)
    shape = ShapeConfig(*SH_TRAIN)
    if mesh is None:
        fn = make_train_step(cfg, opt_cfg)
        args = (params, init_opt_state(params), batch)
    else:
        ins = tshard.place_inputs(cfg, shape, mesh, device=dev,
                                  params=params, batch=batch)
        ins["opt_state"] = init_opt_state(ins["params"])
        fn = tshard.sharded_step_for(cfg, shape, mesh, opt_cfg=opt_cfg)
        args = (ins["params"], ins["opt_state"], ins["batch"])
    fn(*args)                                       # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    _, opt, m = fn(*args)
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)

    def host(x):
        return (x.full_tensor() if hasattr(x, "full_tensor") else x).float(
        ).cpu()
    return (float(host(m["loss"])), [host(t) for t in tree_leaves(opt["mu"])],
            [host(t) for t in tree_leaves(opt["master"])], ms, (fn, args))


def phase_sharded(dev, smi: str) -> dict:
    """Phase 12: mistral-7b through the sharded step (DTensors under the
    serve and train rules) on a one-rank NCCL group, against the
    replicated step; returns row 1's launches in the sharded decode."""
    import dataclasses as dc
    import socket
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode
    from repro_torch.launch.dryrun import _profile
    from repro_torch.launch.families import fan_in_defs
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import init_params
    from repro_torch.training.optimizer import AdamWConfig
    t_phase = time.perf_counter()
    torch.zeros((), device=dev)             # the allocator, if not yet
    _free(dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = device_mesh(make_mesh((1, 1), ("data", "model")))
        # (a) serve: prefill of 8 prompts of 1024-2039 tokens, then lazy
        # decode steps, at full width and depth in bf16
        cfg = dc.replace(get_config("mistral-7b"), decode_attn="lazy")
        g = torch.Generator(device=dev)
        g.manual_seed(40)
        params = init_params(fan_in_defs(tf.model_defs(cfg)), g, dev,
                             dtype_override=torch.bfloat16)
        rng = np.random.default_rng(41)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int64)
                   for n in LZ_PROMPTS]
        rep = _sh_serve(dev, cfg, params, prompts)
        rep_prof = _profile(lambda: rep["profile"][0](*rep["profile"][1]),
                            dev)
        del rep["profile"]
        _free(dev)
        seen = []
        real = layers.flash_decode

        def checked(q, k, v, kv_len, scale=None):
            seen.append(any(isinstance(t, DTensor) for t in (q, k, v,
                                                             kv_len)))
            return real(q, k, v, kv_len, scale=scale)

        layers.flash_decode = checked
        flash_decode.LAUNCHES = 0
        try:
            shd = _sh_serve(dev, cfg, params, prompts, mesh, rep["fed"])
            n_row1 = flash_decode.LAUNCHES
            shd_prof = _profile(
                lambda: shd["profile"][0](*shd["profile"][1]), dev)
        finally:
            layers.flash_decode = real
        del shd["profile"]
        assert seen and not any(seen), "row 1 was given a DTensor"
        assert n_row1 == SH_STEPS * cfg.num_layers * 2, n_row1
        d_pre = float((shd["prefill_logits"] - rep["prefill_logits"])
                      .abs().max())
        d_dec = max(float((a - b).abs().max())
                    for a, b in zip(shd["logits"], rep["logits"]))
        compared = equal = 0
        for a, b in zip(shd["logits"], rep["logits"]):
            top = torch.topk(b, 2, dim=-1).values
            sure = (top[:, 0] - top[:, 1]) > LZ_BF16_ATOL
            compared += int(sure.sum())
            equal += int((a.argmax(-1) == b.argmax(-1))[sure].sum())
        serve = dict(
            card=smi, batch=MAX_BATCH, prompts=LZ_PROMPTS, steps=SH_STEPS,
            s_max=LZ_S_MAX, max_abs_dlogit_prefill=d_pre,
            max_abs_dlogit_decode=d_dec, logit_tol=LZ_BF16_ATOL,
            tokens_compared=compared, tokens_equal=equal,
            flash_decode_launches=n_row1, flash_decode_inputs="local",
            host_ms_step={"replicated": rep["host_ms"],
                          "sharded": shd["host_ms"]},
            device={"replicated": rep_prof, "sharded": shd_prof})
        log(f"[sharded] (a) mistral-7b bf16 on a one-rank mesh, serve "
            f"rules, sharded against replicated: {json.dumps(serve)}")
        assert d_pre < LZ_BF16_ATOL and d_dec < LZ_BF16_ATOL, serve
        assert equal == compared > 0, serve
        del params, rep, shd
        _free(dev)
        # (b) one full train step at depth 1 under the train rules against
        # the replicated step (phase 8's batch)
        cfg1 = dc.replace(get_config("mistral-7b"), num_layers=1)
        g.manual_seed(42)
        params = init_params(fan_in_defs(tf.model_defs(cfg1)), g, dev,
                             dtype_override=torch.bfloat16)
        gb = torch.Generator(device=dev)
        gb.manual_seed(43)
        batch = {k: torch.randint(0, cfg1.vocab_size, SH_TRAIN[2:0:-1],
                                  generator=gb, device=dev)
                 for k in ("tokens", "targets")}
        runs = {}
        for name, m in (("replicated", None), ("sharded", mesh)):
            loss, mu, master, ms, (fn, args) = _sh_train(dev, cfg1, params,
                                                         batch, m)
            runs[name] = dict(loss=loss, mu=mu, master=master, host_ms=ms,
                              device=_profile(lambda: fn(*args), dev))
            del fn, args
            _free(dev)
        a, b = runs["sharded"], runs["replicated"]
        scale = max(float(t.abs().max()) for t in b["mu"])
        # phase 8 (a)'s bound on the master weights: lr times the
        # gradients' tolerance plus one f32 rounding of the largest
        tol_master = AdamWConfig(eps=1.0).lr * SH_GRAD_TOL + torch.finfo(
            torch.float32).eps * max(float(t.abs().max())
                                     for t in b["master"])
        train = dict(
            card=smi, layers=1, batch=SH_TRAIN[2], seq=SH_TRAIN[1],
            loss={k: r["loss"] for k, r in runs.items()},
            max_abs_dloss=abs(a["loss"] - b["loss"]),
            max_rel_dgrad=max(float((x - y).abs().max())
                              for x, y in zip(a["mu"], b["mu"])) / scale,
            max_abs_dmaster=max(float((x - y).abs().max())
                                for x, y in zip(a["master"], b["master"])),
            tol_master=tol_master,
            host_ms={k: r["host_ms"] for k, r in runs.items()},
            device={k: r["device"] for k, r in runs.items()})
        log(f"[sharded] (b) mistral-7b train step, depth 1, train rules on "
            f"a one-rank mesh against the replicated step: "
            f"{json.dumps(train)}")
        assert train["max_abs_dloss"] <= SH_LOSS_ATOL, train
        assert train["max_rel_dgrad"] <= SH_GRAD_TOL, train
        assert train["max_abs_dmaster"] <= tol_master, train
        del params, runs
    finally:
        dist.destroy_process_group()
        _free(dev)
    wall = time.perf_counter() - t_phase
    log(f"[sharded] flash_decode launches {n_row1}; phase {wall:.1f} s")
    assert wall < SH_PHASE_MAX_S, f"phase 12 took {wall:.1f} s"
    return {"flash_decode": n_row1}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == [RESTART_CHILD]:
        restart_child(dev)
        return 0
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    rows = phase_kernels(dev)
    jd_rows = jd_delta_rows(dev)
    jd_prefill = phase_jd_prefill(dev)
    phase_parity(dev)
    launches = phase_serve(dev)
    launches.update(phase_paged_kv(dev, rows))
    by_path = {"compress_apply": phase_compress_apply(dev)}
    launches.update(by_path["compress_apply"])
    by_path["lifecycle"] = phase_lifecycle(dev)
    for name, n in by_path["lifecycle"].items():
        launches[name] += n
    phase_train(dev)
    by_path["families"] = phase_families(dev, rows)
    for name, n in by_path["families"].items():
        launches[name] += n
    by_path["lazy"] = phase_lazy(dev)
    for name, n in by_path["lazy"].items():
        launches[name] += n
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    by_path["dryrun"] = phase_dryrun(dev, smi)
    for name, n in by_path["dryrun"].items():
        launches[name] += n
    by_path["sharded"] = phase_sharded(dev, smi)
    for name, n in by_path["sharded"].items():
        launches[name] += n
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
        paths = {path: counts[name] for path, counts in by_path.items()
                 if name in counts}
        if paths:
            entry["launches_by_path"] = paths
        for key in ("library_device_ms", "contiguous_ms",
                    "contiguous_device_ms", "contiguous_library_ms",
                    "contiguous_library_device_ms",
                    "contiguous_library_max_abs_diff", "serve",
                    "f32_bank", "bf16_bank", "layer_group", "B_bank",
                    "V_bank",
                    "modes", "launch_overhead_ms",
                    "shape", "pixtral_12b"):
            if key in r:
                entry[key] = r[key]
        kernels.append(entry)
    log(json.dumps({"kernels": list(KERNELS)}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"jd_delta": jd_rows, "jd_prefill": jd_prefill}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
