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
* ``adapter_quantize``: exact.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import ref
from .adapter_quant import adapter_quantize
from .flash_decode import flash_decode
from .fused_decode import fused_decode_jd, fused_decode_lora

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
# the __global__ functions of csrc/, as the profiler names them
ATTN_KERNEL, EXPAND_KERNEL = "decode_attn_kernel", "fused_expand_kernel"
QUANT_KERNELS = ("quant_rows_kernel", "quant_cols_kernel")


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
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"tolerance, max error {float(err.max()):.3e}")
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
