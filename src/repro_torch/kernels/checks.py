"""Holding each CUDA kernel against its plain version on the card, timing
both, and the least time the card could take: shared by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.

Every ``check_*`` runs the wrapper (the kernel, for CUDA tensors) and the
plain version on the same inputs, asserts agreement within the tolerance
it states, and returns the worst error.  The tolerances:

* attention ``out`` in bf16: one bf16 rounding of values that the two
  sides sum in other orders, ``2**-7 * |ref| + 1e-5``; in f32,
  ``1e-5 * (1 + |ref|)``.
* fused ``delta``: held against the plain version that contracts the
  f32 attention output before its cast, as the kernels (and the TPU
  kernel) do, so the two sum the same f32 products in other orders:
  ``1e-5 * (1 + |ref|)``.  (The default plain version contracts the
  ``out`` rounded to q's dtype, as ``kernels/ref.py`` does; that differs
  by one bf16 rounding of ``out`` carried through the adapter, about 1e-4
  at mistral-7b's width, and is what the CPU wrappers and the JAX parity
  tests use.)
* ``adapter_quantize`` and ``adapter_dequantize``: exact.
* the paged kernels (``flash_decode_paged``, ``fused_decode_*_paged``):
  bit-identical with the contiguous kernels on the same logical content
  (``out``, ``l``, ``m``, ``delta``), and within the contiguous
  tolerances of the plain versions plus :func:`attention_slack`, the f32
  error of an attention output over a long cache with large logits:
  ``2**-20 * M``, M = sum_i p_i (A_i + 1)(|v_i| + |out|), A_i the logit's
  sum of absolute products.  A logit's error moves the output by
  ``p_i * ds_i * |v_i - out|``: on mistral-7b's served cache (random
  weights: large logits, small outputs that cancel from large values,
  2048 rows) the kernel and the plain version, both right, can sit past
  ``2**-7 * |ref| + 1e-5`` apart.  The delta adds that slack carried
  through the adapter's absolute values.
* ``kv_quantize`` and ``kv_dequantize``: exact (packed bytes, scales and
  outputs), and the round trip within ``ERROR_BOUND[bits] * absmax *
  (1 + 1e-5)`` per channel.
* the grouped kernels (``sgmv_shrink``, ``sgmv_expand``, ``sigma_bmm``,
  ``jd_shrink_scale``) against their per-row plain versions on the same
  inputs: the same f32 products summed in another order, so
  ``1e-5 * (1 + |ref|) + 2**-20 * M`` with M the contraction on absolute
  values (``|x| @ |W|^T``): a sum of n products in two orders differs by
  a few ``2**-24 * M`` (at d_in 4096 the first term alone failed, by
  3.1e-5 on outputs of ~3); outputs in bf16 round once more,
  ``2**-7 * |ref|`` in place of ``1e-5 * |ref|``.
* the composed ``ops.lora_apply`` / ``ops.jd_apply`` against a plain chain
  with the same casts between stages: ``2**-7 * |ref| + 2**-6 * M + 1e-5``,
  M the last expand's contraction on absolute values (``|u| @ |W|^T``):
  an f32 sum that lands on the other side of a bf16 rounding in an earlier
  stage moves the output by up to 2**-8 of that stage's term, carried
  through the expand.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import ref
from .adapter_quant import adapter_dequantize, adapter_quantize
from .flash_decode import flash_decode, flash_decode_paged
from .fused_decode import (fused_decode_jd, fused_decode_jd_paged,
                           fused_decode_lora, fused_decode_lora_paged)
from .jd_apply import jd_shrink_scale
from .kv_quant import ERROR_BOUND, kv_dequantize, kv_quantize
from .sgmv import sgmv_expand, sgmv_shrink, sigma_bmm

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
# the __global__ functions of csrc/, as the profiler names them
ATTN_KERNEL, EXPAND_KERNEL = "decode_attn_kernel", "fused_expand_kernel"
QUANT_KERNELS = ("quant_rows_kernel", "quant_cols_kernel")
DEQUANT_KERNEL = "dequant_kernel"
KV_QUANT_KERNEL, KV_DEQUANT_KERNEL = "kv_quantize_kernel", "kv_dequantize_kernel"
# sgmv_shrink and jd_shrink_scale are instances of one template
SHRINK_KERNEL = "grouped_shrink_kernel"
SGMV_EXPAND_KERNEL, SIGMA_KERNEL = "sgmv_expand_kernel", "sigma_bmm_kernel"
# tests/test_kernels.py's sweeps: (T, d_in, d_out, n, r, tile)
SGMV_SWEEP = [(32, 128, 64, 3, 8, 8), (64, 256, 192, 5, 16, 8),
              (128, 512, 256, 2, 32, 16), (16, 64, 128, 7, 4, 8)]


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over HBM bandwidth and the f32 operations over the f32 peak."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations")


def cuda_ms(fn: Callable[[], object], iters: int = 50,
            warmup: int = 5) -> float:
    """Mean time of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable[[], object], kernels, iters: int = 20) -> float:
    """The device's own time per call of ``fn`` in the kernels whose names
    hold one of ``kernels``, from ``torch.profiler``'s device-side events:
    the kernel bodies without the host's wrapper and launch gaps."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA
             and any(k in ev.key for k in kernels))
    if us <= 0:
        raise RuntimeError(f"the profiler saw no device time in {kernels}")
    return us / 1e3 / iters


def _randn(shape, gen, device, dtype, std=1.0):
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return x.to(device=device, dtype=dtype)


def attention_case(B, H, Kv, hd, s_max, bucket, kv_len, dtype, gen, device,
                   kv_dtype=None):
    """q (B, H, hd) and k/v views ``cache[:, :bucket]`` of (B, s_max, Kv,
    hd) caches, as the fused decode step passes them; ``kv_len`` an int
    or a list per row; the cache in ``kv_dtype`` (default q's)."""
    kl = kv_len if isinstance(kv_len, (list, tuple)) else [kv_len] * B
    kvt = kv_dtype or dtype
    return {"q": _randn((B, H, hd), gen, device, dtype),
            "k": _randn((B, s_max, Kv, hd), gen, device, kvt)[:, :bucket],
            "v": _randn((B, s_max, Kv, hd), gen, device, kvt)[:, :bucket],
            "kv_len": torch.tensor(kl, dtype=torch.int32, device=device),
            "ids": None}


def attention_bytes(case, stats: bool = True) -> int:
    """q read and out written, the valid K/V rows read once, kv_len, and
    with ``stats`` the f32 l/m that flash_decode writes (the fused
    kernels do not)."""
    q, k = case["q"], case["k"]
    B, H, hd = q.shape
    Kv, es = k.shape[2], k.element_size()
    valid = int(torch.clamp(case["kv_len"], max=k.shape[1]).sum())
    G = H // Kv
    return (2 * q.numel() * es + 2 * valid * Kv * hd * es
            + 4 * case["kv_len"].numel() + (2 * 4 * B * Kv * G if stats
                                             else 0))


def attention_flops(case) -> int:
    B, H, hd = case["q"].shape
    valid = int(torch.clamp(case["kv_len"], max=case["k"].shape[1]).sum())
    return 4 * H * hd * valid


def _assert_close(name, got, want, tol):
    err = (got.float() - want.float()).abs()
    bad = err > tol
    if bool(bad.any()):
        i = tuple(bad.nonzero()[0].tolist())
        tol_i = (torch.broadcast_to(tol, err.shape)[i]
                 if isinstance(tol, torch.Tensor) else tol)
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond tolerance, max error "
            f"{float(err.max()):.3e}; first at {i}: got {float(got[i])!r}, "
            f"want {float(want[i])!r}, tolerance {float(tol_i):.3e}")
    return float(err.max())


def _out_tol(ref_out):
    r = ref_out.float().abs()
    if ref_out.dtype == torch.bfloat16:
        return 2.0 ** -7 * r + 1e-5
    return 1e-5 * (1.0 + r)


def check_flash_decode(case) -> Dict:
    q, k, v, kl = case["q"], case["k"], case["v"], case["kv_len"]
    out, l, m = flash_decode(q, k, v, kl)
    r_out, r_l, r_m = ref.flash_decode_ref(q, k, v, kl)
    err = _assert_close("flash_decode out", out, r_out, _out_tol(r_out))
    _assert_close("flash_decode m", m, r_m, 1e-5 * (1 + r_m.abs()))
    _assert_close("flash_decode l", l, r_l, 1e-4 * (1 + r_l.abs()))
    return {"max_abs_err": err, "out": out,
            "tolerance": "2**-7*|ref|+1e-5 (bf16 out); l, m rtol 1e-4/1e-5"}


def lora_banks(n, r, d_in, d_out, dtype, gen, device, quant: bool):
    A = _randn((n, r, d_in), gen, device, dtype, 0.02)
    Bm = _randn((n, d_out, r), gen, device, dtype, 0.02)
    if not quant:
        return {"A": A, "B": Bm, "a_scale": None, "b_scale": None}
    aq, a_s = adapter_quantize(A)
    bq, b_s = adapter_quantize(Bm)
    return {"A": aq, "B": bq, "a_scale": a_s, "b_scale": b_s}


def jd_banks(kcl, n, r, d_in, d_out, dtype, gen, device, quant: bool,
             diag: bool):
    U = _randn((kcl, d_out, r), gen, device, dtype, 0.02)
    V = _randn((kcl, d_in, r), gen, device, dtype, 0.02)
    sigma = _randn((n, r) if diag else (n, r, r), gen, device, dtype, 0.1)
    cluster_of = torch.arange(n, dtype=torch.int32, device=device) % kcl
    banks = {"U": U, "V": V, "sigma": sigma, "cluster_of": cluster_of,
             "u_scale": None, "v_scale": None}
    if quant:
        banks["U"], banks["u_scale"] = adapter_quantize(U)
        banks["V"], banks["v_scale"] = adapter_quantize(V, axis=-2)
    return banks


def _delta_tol(ref_delta):
    return 1e-5 * (1.0 + ref_delta.abs())


DELTA_TOL = "1e-5*(1+|ref|), ref on the f32 attention output"


def check_fused_lora(case, banks) -> Dict:
    q, k, v, kl, ids = (case[x] for x in ("q", "k", "v", "kv_len", "ids"))
    args = (banks["A"], banks["B"], banks["a_scale"], banks["b_scale"])
    out, delta = fused_decode_lora(q, k, v, kl, ids, *args)
    f_out, _, _ = flash_decode(q, k, v, kl)
    if not torch.equal(out, f_out):
        raise AssertionError("fused_decode_lora out differs from "
                             "flash_decode's")
    _, r_delta = ref.fused_decode_lora_ref(q, k, v, kl, ids, *args,
                                           f32_delta=True)
    err = _assert_close("fused_decode_lora delta", delta, r_delta,
                        _delta_tol(r_delta))
    return {"max_abs_err": err, "tolerance": DELTA_TOL}


def check_fused_jd(case, banks) -> Dict:
    q, k, v, kl, ids = (case[x] for x in ("q", "k", "v", "kv_len", "ids"))
    args = (banks["U"], banks["V"], banks["sigma"], banks["cluster_of"],
            banks["u_scale"], banks["v_scale"])
    out, delta = fused_decode_jd(q, k, v, kl, ids, *args)
    f_out, _, _ = flash_decode(q, k, v, kl)
    if not torch.equal(out, f_out):
        raise AssertionError("fused_decode_jd out differs from "
                             "flash_decode's")
    _, r_delta = ref.fused_decode_jd_ref(q, k, v, kl, ids, *args,
                                         f32_delta=True)
    err = _assert_close("fused_decode_jd delta", delta, r_delta,
                        _delta_tol(r_delta))
    return {"max_abs_err": err, "tolerance": DELTA_TOL}


def fused_bytes(case, banks, kind: str) -> int:
    """Attention bytes plus the adapter slices the slots' ids reach (each
    distinct adapter or cluster read once) plus the delta written."""
    ids = case["ids"].long()
    B = ids.numel()
    if kind == "lora":
        uniq = torch.unique(ids)
        sel = [banks["A"][uniq], banks["B"][uniq]]
        sel += [s[uniq] for s in (banks["a_scale"], banks["b_scale"])
                if s is not None]
        d_out = banks["B"].shape[1]
    else:
        uc = torch.unique(banks["cluster_of"].long()[ids])
        sel = [banks["U"][uc], banks["V"][uc], banks["sigma"][torch.unique(ids)]]
        sel += [s[uc] for s in (banks["u_scale"], banks["v_scale"])
                if s is not None]
        sel.append(banks["cluster_of"])
        d_out = banks["U"].shape[1]
    return (attention_bytes(case, stats=False)
            + sum(t.numel() * t.element_size() for t in sel)
            + 4 * ids.numel() + 4 * B * d_out)


def fused_flops(case, banks, kind: str) -> int:
    B, H, hd = case["q"].shape
    if kind == "lora":
        r, d_out = banks["A"].shape[1], banks["B"].shape[1]
        sig = 0
    else:
        r, d_out = banks["V"].shape[2], banks["U"].shape[1]
        sig = 2 * r * r if banks["sigma"].ndim == 3 else r
    return attention_flops(case) + B * (2 * r * H * hd + sig + 2 * r * d_out)


def check_adapter_quantize(w: torch.Tensor, axis: int) -> Dict:
    q, s = adapter_quantize(w, axis=axis)
    r_q, r_s = ref.adapter_quant_ref(w, axis=axis)
    if not (torch.equal(q, r_q) and torch.equal(s, r_s)):
        bad = int((q != r_q).sum()) + int((s != r_s).sum())
        raise AssertionError(f"adapter_quantize differs from its plain "
                             f"version in {bad} elements")
    return {"max_abs_err": 0.0, "tolerance": "exact"}


def quant_bytes(w: torch.Tensor, axis: int) -> int:
    channels = w.numel() // w.shape[axis]
    return w.numel() * w.element_size() + w.numel() + 4 * channels


# -- paged KV ------------------------------------------------------------------


def paged_case(case, page_t: int, spare_pages: int, gen) -> Dict:
    """``case``'s K/V laid into one pool of pages under a permuted table:
    the first ``n_blocks = ceil(max kv_len / page_t)`` blocks of each
    sequence go to pages drawn without repeats from a pool of
    ``B * n_blocks + spare_pages`` (the ``_paged`` helper of
    tests/test_kernels.py, with a pool larger than needed).  Adds
    ``k_pages``, ``v_pages``, ``page_table`` and ``k_logical`` /
    ``v_logical``, the contiguous (B, n_blocks * page_t, Kv, hd) content
    the pool holds."""
    k, v = case["k"], case["v"]
    B, S, Kv, hd = k.shape
    n_blocks = -(-int(case["kv_len"].max()) // page_t)
    P = B * n_blocks + spare_pages
    perm = torch.randperm(P, generator=gen, device=gen.device)[:B * n_blocks]
    table = perm.to(device=k.device, dtype=torch.int32).reshape(B, n_blocks)
    out = dict(case, page_table=table, page_t=page_t)
    for name, t in (("k", k), ("v", v)):
        n = min(S, n_blocks * page_t)
        logical = torch.zeros((B, n_blocks * page_t, Kv, hd), dtype=t.dtype,
                              device=t.device)
        logical[:, :n] = t[:, :n]
        pool = torch.zeros((P, page_t, Kv, hd), dtype=t.dtype,
                           device=t.device)
        pool[table.reshape(-1).long()] = logical.reshape(
            B * n_blocks, page_t, Kv, hd)
        out[name + "_pages"], out[name + "_logical"] = pool, logical
    return out


def _paged_args(pc):
    return (pc["q"], pc["k_pages"], pc["v_pages"], pc["page_table"],
            pc["kv_len"])


def _equal(name, got, want) -> None:
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} elements differ")


def attention_slack(q, k, v, kv_len) -> torch.Tensor:
    """(B, H, hd): ``2**-20 * M`` with M = sum_i p_i (A_i + 1)(|v_i| +
    |out|) and A_i = sum_d |q_d k_id| * hd**-0.5, the f32 error of an
    attention output whose logits and weighted sum two implementations
    take in other orders (see the module docstring)."""
    B, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qs = q.reshape(B, Kv, G, hd).float() * (hd ** -0.5)
    A = torch.einsum("bkgh,bskh->bkgs", qs.abs(), k.float().abs())
    logits = torch.einsum("bkgh,bskh->bkgs", qs, k.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_len.reshape(-1, 1).to(q.device))[:, None, None, :]
    p = torch.softmax(torch.where(valid, logits, torch.full_like(
        logits, ref.NEG_INF)), dim=-1)
    w = p * (A + 1.0)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    M = (torch.einsum("bkgs,bskh->bkgh", w, v.float().abs())
         + w.sum(-1, keepdim=True) * out.abs())
    return 2.0 ** -20 * M.reshape(B, H, hd)


def _slack_through(slack, banks, ids, kind: str) -> torch.Tensor:
    """The attention slack (B, H, hd) carried through the adapter's
    absolute values into (B, d_out), as the delta contracts it."""
    e = slack.reshape(slack.shape[0], -1)
    ids = ids.long()
    if kind == "lora":
        t = torch.einsum("bd,brd->br", e,
                         ref._deq(banks["A"], banks["a_scale"])[ids].abs())
        return torch.einsum("br,bor->bo", t, ref._deq(
            banks["B"], banks["b_scale"])[ids].abs())
    cid = banks["cluster_of"].long()[ids]
    t = torch.einsum("bd,bdr->br", e,
                     ref._deq(banks["V"], banks["v_scale"])[cid].abs())
    sig = banks["sigma"][ids].float().abs()
    t = t * sig if sig.ndim == 2 else torch.einsum("br,brq->bq", t, sig)
    return torch.einsum("br,bor->bo", t, ref._deq(
        banks["U"], banks["u_scale"])[cid].abs())


PAGED_OUT_TOL = ("bit-identical with the contiguous kernel; "
                 "2**-7*|ref|+1e-5 (bf16 out) + attention_slack of the "
                 "plain version")


def check_flash_decode_paged(pc) -> Dict:
    """Paged == contiguous bit for bit (out, l, m) on the pool's logical
    content, and close to the plain version."""
    out, l, m = flash_decode_paged(*_paged_args(pc))
    c_out, c_l, c_m = flash_decode(pc["q"], pc["k_logical"],
                                   pc["v_logical"], pc["kv_len"])
    for name, got, want in (("out", out, c_out), ("l", l, c_l),
                            ("m", m, c_m)):
        _equal(f"flash_decode_paged {name} against the contiguous kernel",
               got, want)
    r_out, _, _ = ref.flash_decode_paged_ref(*_paged_args(pc))
    slack = attention_slack(pc["q"], pc["k_logical"], pc["v_logical"],
                            pc["kv_len"])
    err = _assert_close("flash_decode_paged out", out, r_out,
                        _out_tol(r_out) + slack)
    return {"max_abs_err": err, "out": out, "tolerance": PAGED_OUT_TOL}


PAGED_DELTA_TOL = ("bit-identical with the contiguous kernel; " + DELTA_TOL
                   + " + attention_slack through |adapter|")


def _kernel_delta(pc) -> bool:
    """The plain version to hold ``delta`` to: on the card the one that
    contracts the f32 attention output, as the kernels do; on the CPU the
    wrapper is the plain version itself (the rounded ``out``)."""
    return pc["q"].is_cuda


def check_fused_lora_paged(pc, banks) -> Dict:
    args = (pc["ids"], banks["A"], banks["B"], banks["a_scale"],
            banks["b_scale"])
    out, delta = fused_decode_lora_paged(*_paged_args(pc), *args)
    c_out, c_delta = fused_decode_lora(pc["q"], pc["k_logical"],
                                       pc["v_logical"], pc["kv_len"], *args)
    _equal("fused_decode_lora_paged out against the contiguous kernel", out,
           c_out)
    _equal("fused_decode_lora_paged delta against the contiguous kernel",
           delta, c_delta)
    _, r_delta = ref.fused_decode_lora_paged_ref(
        *_paged_args(pc), *args, f32_delta=_kernel_delta(pc))
    slack = _slack_through(attention_slack(
        pc["q"], pc["k_logical"], pc["v_logical"], pc["kv_len"]), banks,
        pc["ids"], "lora")
    err = _assert_close("fused_decode_lora_paged delta", delta, r_delta,
                        _delta_tol(r_delta) + slack)
    return {"max_abs_err": err, "tolerance": PAGED_DELTA_TOL}


def check_fused_jd_paged(pc, banks) -> Dict:
    args = (pc["ids"], banks["U"], banks["V"], banks["sigma"],
            banks["cluster_of"], banks["u_scale"], banks["v_scale"])
    out, delta = fused_decode_jd_paged(*_paged_args(pc), *args)
    c_out, c_delta = fused_decode_jd(pc["q"], pc["k_logical"],
                                     pc["v_logical"], pc["kv_len"], *args)
    _equal("fused_decode_jd_paged out against the contiguous kernel", out,
           c_out)
    _equal("fused_decode_jd_paged delta against the contiguous kernel",
           delta, c_delta)
    _, r_delta = ref.fused_decode_jd_paged_ref(
        *_paged_args(pc), *args, f32_delta=_kernel_delta(pc))
    slack = _slack_through(attention_slack(
        pc["q"], pc["k_logical"], pc["v_logical"], pc["kv_len"]), banks,
        pc["ids"], "jd")
    err = _assert_close("fused_decode_jd_paged delta", delta, r_delta,
                        _delta_tol(r_delta) + slack)
    return {"max_abs_err": err, "tolerance": PAGED_DELTA_TOL}


def paged_table_bytes(pc) -> int:
    """The table entries the kernel reads: ceil(kv_len / page_t) a row."""
    n_blocks = pc["page_table"].shape[1]
    used = torch.clamp(-(-pc["kv_len"].long() // pc["page_t"]), max=n_blocks)
    return 4 * int(used.sum())


# -- KV wire quantization ---------------------------------------------------------


def check_kv_quantize(x: torch.Tensor, bits: int) -> Dict:
    """The kernel's packed bytes and scales equal the plain version's (the
    plain quantization, packed by ``ref.pack_int4`` under int4)."""
    packed, scales = kv_quantize(x, bits)
    r_q, r_s = ref.kv_quant_ref(x, bits)
    r_packed = r_q if bits == 8 else ref.pack_int4(r_q)
    _equal(f"kv_quantize int{bits} values", packed, r_packed)
    _equal(f"kv_quantize int{bits} scales", scales, r_s)
    return {"max_abs_err": 0.0, "tolerance": "exact", "packed": packed,
            "scales": scales}


def check_kv_dequantize(packed: torch.Tensor, scales: torch.Tensor,
                        bits: int, out_dtype) -> Dict:
    got = kv_dequantize(packed, scales, bits, out_dtype)
    q = packed if bits == 8 else ref.unpack_int4(packed)
    _equal(f"kv_dequantize int{bits}", got,
           ref.kv_dequant_ref(q, scales, out_dtype))
    return {"max_abs_err": 0.0, "tolerance": "exact", "out": got}


def check_kv_error(x: torch.Tensor, deq: torch.Tensor, bits: int) -> float:
    """|deq - x| per channel within ``ERROR_BOUND[bits]`` of the channel's
    absmax (times 1 + 1e-5); returns the worst ratio to the absmax."""
    xf = x.float()
    absmax = xf.abs().amax(dim=0, keepdim=True)
    err = (deq.float() - xf).abs()
    tol = ERROR_BOUND[bits] * absmax * (1 + 1e-5)
    bad = err > tol
    if bool(bad.any()):
        raise AssertionError(f"kv int{bits} round trip: {int(bad.sum())} "
                             f"values beyond ERROR_BOUND")
    return float((err / torch.where(absmax > 0, absmax,
                                    torch.ones_like(absmax))).max())


def kv_quant_bytes(x: torch.Tensor, bits: int) -> int:
    """x read once; the packed values and the f32 scales written."""
    T, C = x.shape
    return _nbytes(x) + (T * C if bits == 8 else T // 2 * C) + 4 * C


def kv_dequant_bytes(packed: torch.Tensor, scales: torch.Tensor, bits: int,
                     out_dtype) -> int:
    rows, C = packed.shape
    T = rows if bits == 8 else 2 * rows
    es = torch.empty((), dtype=out_dtype).element_size()
    return _nbytes(packed, scales) + T * C * es


def library_dequant(q: torch.Tensor, scales: torch.Tensor
                    ) -> Callable[[], torch.Tensor]:
    """One PyTorch call computing int8 dequantization to f32 (KV blocks or
    adapter banks), as a yardstick only: ``q * scales`` (int8 times f32
    promotes to f32: one multiply, no further rounding)."""
    return lambda: q * scales


def library_attention(case) -> Callable[[], torch.Tensor]:
    """One PyTorch call computing the same attention, as a yardstick
    only: ``scaled_dot_product_attention`` with GQA and a length mask."""
    q, k, v, kl = case["q"], case["k"], case["v"], case["kv_len"]
    B, H, hd = q.shape
    S = k.shape[1]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < kl[:, None])[:, None, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qs, ks, vs, attn_mask=mask, enable_gqa=True,
                     scale=hd ** -0.5)


def check_library_attention(case, out) -> float:
    """The yardstick computes the same function, to its own internal bf16
    roundings (it rounds the softmax weights too): within 2% of the
    output's scale."""
    lib = library_attention(case)()[:, :, 0]
    return _assert_close("scaled_dot_product_attention", lib, out,
                         0.02 * float(out.float().abs().max()))


def check_adapter_dequantize(q: torch.Tensor, scale: torch.Tensor,
                             out_dtype) -> Dict:
    got = adapter_dequantize(q, scale, out_dtype=out_dtype)
    want = ref.adapter_dequant_ref(q, scale, out_dtype)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"adapter_dequantize differs from its plain "
                             f"version in {bad} elements")
    return {"max_abs_err": 0.0, "tolerance": "exact"}


def dequant_bytes(q: torch.Tensor, scale: torch.Tensor, out_dtype) -> int:
    return (q.numel() + 4 * scale.numel()
            + q.numel() * torch.empty((), dtype=out_dtype).element_size())


# -- grouped multi-adapter kernels -------------------------------------------


def grouped_case(ids: torch.Tensor, n: int, d_in: int, tile: int, dtype,
                 gen, device) -> Dict:
    """Tokens with adapter ``ids``, grouped as ``ops`` groups them: x
    (T_pad, d_in) in ``dtype``, per-row ``ids`` and per-tile
    ``tile_ids``."""
    perm, tile_ids, _ = ref.group_tokens_by_adapter(ids, n, tile)
    x = _randn((ids.numel(), d_in), gen, device, dtype)
    pl = perm.long()
    return {"x": x[pl].contiguous(), "ids": ids[pl].contiguous(),
            "tile_ids": tile_ids, "tile": tile}


def sweep_case(T, d_in, n, tile, dtype, gen, device) -> Dict:
    ids = torch.randint(0, n, (T,), generator=gen, device=gen.device,
                        dtype=torch.int32).to(device)
    return grouped_case(ids, n, d_in, tile, dtype, gen, device)


GROUPED_TOL = ("f32 1e-5*(1+|ref|) + 2**-20*M, bf16 out 2**-7*|ref| + "
               "1e-5 + 2**-20*M; M = |x| @ |W|^T")


def _check_grouped(name, got, want, M) -> Dict:
    """``M``: the same contraction on absolute values, in f32."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    tol = rel * want.float().abs() + 1e-5 + 2.0 ** -20 * M
    err = _assert_close(name, got, want, tol)
    return {"max_abs_err": err, "tolerance": GROUPED_TOL, "out": got}


def _abs(t: torch.Tensor) -> torch.Tensor:
    return t.float().abs()


def check_sgmv_shrink(case, A) -> Dict:
    x, ids = case["x"], case["ids"]
    got = sgmv_shrink(x, A, case["tile_ids"], block_t=case["tile"])
    want = ref.sgmv_shrink_ref(x.float(), A, ids)
    M = ref.sgmv_shrink_ref(_abs(x), _abs(A), ids)
    return _check_grouped("sgmv_shrink", got, want, M)


def check_sgmv_expand(case, t, B) -> Dict:
    ids = case["ids"]
    got = sgmv_expand(t, B, case["tile_ids"], block_t=case["tile"])
    want = ref.sgmv_expand_ref(t, B, ids)
    M = ref.sgmv_expand_ref(_abs(t), _abs(B), ids)
    return _check_grouped("sgmv_expand", got, want, M)


def check_sigma_bmm(case, t, sigma) -> Dict:
    ids = case["ids"]
    got = sigma_bmm(t, sigma, case["tile_ids"], block_t=case["tile"])
    want = ref.sigma_bmm_ref(t, sigma, ids)
    M = ref.sigma_bmm_ref(_abs(t), _abs(sigma), ids)
    return _check_grouped("sigma_bmm", got, want, M)


def check_jd_shrink_scale(case, V, sig_tok, tile_cids, cluster_of) -> Dict:
    x = case["x"]
    got = jd_shrink_scale(x, V, sig_tok, tile_cids, block_t=case["tile"])
    cids = cluster_of.long()[case["ids"].long()]
    want = ref.jd_shrink_scale_ref(x, V, sig_tok, cids)
    M = ref.jd_shrink_scale_ref(_abs(x), _abs(V), None if sig_tok is None
                                else _abs(sig_tok), cids)
    return _check_grouped("jd_shrink_scale", got, want, M)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _reached(bank: torch.Tensor, tile_ids: torch.Tensor) -> torch.Tensor:
    """The slices of ``bank`` the tiles reach (each read once)."""
    return bank[torch.unique(tile_ids.long())]


def shrink_bytes(case, W, tile_ids, r: int, extra=()) -> int:
    """x read, the bank slices reached, the per-tile ids and any per-row
    extra input read once; the (T_pad, r) f32 output written."""
    return (_nbytes(case["x"], _reached(W, tile_ids), tile_ids, *extra)
            + 4 * case["x"].shape[0] * r)


def expand_bytes(t, W, tile_ids) -> int:
    T, d_out = t.shape[0], W.shape[1]
    return (_nbytes(t, _reached(W, tile_ids), tile_ids)
            + T * d_out * t.element_size())


def sigma_bytes(t, sigma, tile_ids) -> int:
    return 2 * _nbytes(t) + _nbytes(_reached(sigma, tile_ids), tile_ids)


def library_grouped(a: torch.Tensor, W: torch.Tensor,
                    tile_ids: torch.Tensor, transpose: bool
                    ) -> Callable[[], torch.Tensor]:
    """One ``torch.bmm`` over the tiles, as a yardstick only: ``a``
    (T_pad, K) viewed as (tiles, bt, K) against the per-tile weights,
    gathered beforehand (the gather is not timed).  ``transpose``: the
    weights are stored (n, N, K) (A, B) rather than (n, K, N) (Sigma)."""
    nt = tile_ids.shape[0]
    w = W[tile_ids.long()]
    w = w.transpose(1, 2) if transpose else w
    w = w.to(a.dtype).contiguous()
    a3 = a.reshape(nt, a.shape[0] // nt, a.shape[1])
    return lambda: torch.bmm(a3, w)


def _abs_contraction(u: torch.Tensor, W: torch.Tensor, rows: torch.Tensor
                     ) -> torch.Tensor:
    """M = |u| @ |W[rows]|^T per token: the expand's terms on absolute
    values.  u: (T, r); W: (n, d_out, r)."""
    return torch.einsum("tr,tor->to", u.float().abs(),
                        W[rows.long()].float().abs())


def lora_chain_plain(x, A, B, ids, scaling: float = 1.0):
    """``ops.lora_apply``'s function with its casts: f32 shrink, the
    rank-r intermediate rounded to x's dtype, expand.  Returns (y, M)."""
    t = ref.sgmv_shrink_ref(x.float(), A, ids).to(x.dtype)
    return (ref.sgmv_expand_ref(t, B, ids) * scaling,
            _abs_contraction(t, B, ids) * abs(scaling))


def jd_chain_plain(x, U, V, sigma, cluster_of, ids):
    """``ops.jd_apply``'s function with its casts (``kernels/jd_apply.py``).
    Returns (y, M)."""
    cids = cluster_of.long()[ids.long()]
    if sigma.ndim == 2:
        t = ref.jd_shrink_scale_ref(x, V, sigma[ids.long()].to(x.dtype),
                                    cids)
    else:
        t = ref.sigma_bmm_ref(ref.jd_shrink_scale_ref(x, V, None, cids).to(
            x.dtype), sigma, ids)
    t = t.to(x.dtype)
    return ref.sgmv_expand_ref(t, U, cids), _abs_contraction(t, U, cids)


CHAIN_TOL = "2**-7*|ref| + 2**-6*M + 1e-5, M = |u| @ |W|^T of the expand"


def check_chain(name, got, plain) -> float:
    want, M = plain
    tol = 2.0 ** -7 * want.float().abs() + 2.0 ** -6 * M + 1e-5
    return _assert_close(name, got, want, tol)
