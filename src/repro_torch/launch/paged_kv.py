"""Paged KV decode and KV wire quantization over a long-context cache, on
the card by default.

  # mistral-7b at full width and depth, 8 prompts of 1024-2044 tokens
  PYTHONPATH=src python -m repro_torch.launch.paged_kv --arch mistral-7b

  # the reduced config on the CPU (prompts of 256-510 tokens)
  PYTHONPATH=src python -m repro_torch.launch.paged_kv --arch mistral-7b \\
      --smoke --device cpu

Three parts, for each adapter mode (``lora`` and ``jd``):

1. serve: a ``RealModelExecutor`` on the ``fused`` decode path prefills
   ``batch`` requests whose prompt lengths are drawn from the seed, so
   each sequence spans several pages of ``PAGE_TOKENS`` = 128 tokens, and
   decodes ``DECODE_STEPS`` steps;
2. paged decode: for every layer, the executor's K/V cache is laid into
   one reused pool of ``batch * max_blocks + SPARE_PAGES`` pages under a
   permuted page table (the pool holds more pages than the sequences
   need), and ``flash_decode_paged`` and the fused paged kernel of the
   mode (with that layer's o-projection bank) run against their
   contiguous counterparts on the cache itself, with ragged ``kv_len``
   from each slot's own length.  The executor keeps no query, so the query
   is drawn from the seed.  Paged and contiguous must agree bit for bit,
   and both must lie within ``kernels/checks.py``'s tolerances of the
   plain versions;
3. KV wire: one request's KV (``export_slot``) is laid out as (T, C), C =
   2 x layers x kv-heads x head_dim (K then V, as
   ``ModelFootprint.kv_bytes_per_token`` counts them), cut into 128-token
   blocks plus a tail, and quantized and dequantized at int8 and int4.
   The packed bytes and scales must equal the plain version's, each
   channel's error must lie within ``ERROR_BOUND``, the full blocks' wire
   ratio must equal ``WIRE_RATIO``, and the summed wire bytes must equal
   ``KVCompressionConfig.wire_bytes``.

Prompt lengths are even, so every tail block packs under int4.  Any
failed check raises; the report is printed as JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..device import resolve_device
from ..kernels import checks
from ..kernels.kv_quant import BLOCK_T, WIRE_RATIO
from ..models import transformer as tf
from ..models.param import init_params
from ..serving.real_executor import RealModelExecutor
from ..serving.request import Request
from ..serving.resources import PAGE_TOKENS, KVCompressionConfig
from .serve import make_bundles

SPARE_PAGES = 37         # pool pages beyond what the sequences take
DECODE_STEPS = 4
MODES = ("lora", "jd")
SEED = 0
WIRE_MODES = {8: "int8", 4: "int4"}


def prompt_lengths(batch: int, lo: int, hi: int, seed: int) -> List[int]:
    """``batch`` even prompt lengths drawn from [lo, hi]."""
    rng = np.random.default_rng(seed)
    return [2 * int(n) for n in rng.integers(-(-lo // 2), hi // 2 + 1,
                                             size=batch)]


def serve(cfg, params, mode: str, n_adapters: int, lengths: List[int],
          decode_steps: int, s_max: int, seed: int, dev):
    """Prefill one request per length, then decode ``decode_steps`` steps
    on the fused path.  Returns (executor, serve report)."""
    bundles = make_bundles(cfg, n_adapters, mode, "fused", seed + 1, dev)
    ex = RealModelExecutor(cfg, params, bundles, mode, len(lengths), s_max,
                           decode_path="fused", device=dev)
    rng = np.random.default_rng(seed + 2)
    prefill_s = []
    for rid, n in enumerate(lengths):
        req = Request(rid=rid, adapter_id=rid % n_adapters, prompt_len=n,
                      max_new_tokens=decode_steps)
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        t0 = time.perf_counter()
        ex.prefill_request(req, prompt)          # ends in a host sync
        prefill_s.append(time.perf_counter() - t0)
    step_s = [ex.decode_step_time(None) for _ in range(decode_steps)]
    assert all(0 <= t < cfg.padded_vocab for t in ex.slot_tokens), \
        "a decoded token lies outside the vocabulary"
    return ex, {"prompt_lens": lengths, "prefill_s": prefill_s,
                "decode_step_s": step_s,
                "slot_len": [int(n) for n in ex.slot_len]}


def o_banks(ex, li: int) -> Dict:
    """Layer ``li``'s o-projection bank in the form ``checks`` takes."""
    o = ex.bundles["layers"]["o"]
    if ex.mode == "lora":
        return {"A": o["A"][li], "B": o["B"][li], "a_scale": None,
                "b_scale": None}
    return {"U": o["U"][li], "V": o["V"][li], "sigma": o["sigma"][li],
            "cluster_of": o["cluster_of"][li], "u_scale": None,
            "v_scale": None}


def paged_decode(ex, page_t: int, max_blocks: int, seed: int):
    """Part 2 of the module docstring.  Returns (report, the last layer's
    paged case and o-bank, for timing)."""
    cfg, dev = ex.cfg, ex.device
    ck, cv = ex.cache["k"], ex.cache["v"]
    L, B, _, Kv, hd = ck.shape
    kv_len = torch.as_tensor(ex.slot_len, dtype=torch.int32, device=dev)
    n_blocks = -(-int(ex.slot_len.max()) // page_t)
    assert n_blocks <= max_blocks, (n_blocks, max_blocks)
    P = B * max_blocks + SPARE_PAGES
    g = torch.Generator().manual_seed(seed + 3)
    table = torch.randperm(P, generator=g)[:B * n_blocks].to(
        device=dev, dtype=torch.int32).reshape(B, n_blocks)
    q = torch.randn((B, cfg.num_heads, hd), generator=g).to(
        device=dev, dtype=ck.dtype)
    ids = torch.as_tensor(ex.slot_adapter, dtype=torch.int32, device=dev)
    # one pool, reused by every layer; pages outside the table stay zero
    pools = {n: torch.zeros((P, page_t, Kv, hd), dtype=ck.dtype, device=dev)
             for n in ("k", "v")}
    rows = table.reshape(-1).long()
    check_fused = (checks.check_fused_lora_paged if ex.mode == "lora"
                   else checks.check_fused_jd_paged)
    worst = {"flash_decode_paged": 0.0, f"fused_decode_{ex.mode}_paged": 0.0}
    for li in range(L):
        pc = {"q": q, "kv_len": kv_len, "ids": ids, "page_table": table,
              "page_t": page_t}
        for n, c in (("k", ck), ("v", cv)):
            logical = c[li, :, :n_blocks * page_t]
            pools[n][rows] = logical.reshape(B * n_blocks, page_t, Kv, hd)
            pc[n + "_pages"], pc[n + "_logical"] = pools[n], logical
        res = checks.check_flash_decode_paged(pc)
        worst["flash_decode_paged"] = max(worst["flash_decode_paged"],
                                          res["max_abs_err"])
        banks = o_banks(ex, li)
        res = check_fused(pc, banks)
        key = f"fused_decode_{ex.mode}_paged"
        worst[key] = max(worst[key], res["max_abs_err"])
    report = {"layers": L, "page_t": page_t, "pool_pages": P,
              "n_blocks": n_blocks, "kv_len": [int(n) for n in ex.slot_len],
              "query": "drawn from the seed (the executor keeps no q)",
              "bit_identical_with_contiguous": True,
              "max_abs_err_vs_plain": worst,
              "tolerance": {"out": checks.PAGED_OUT_TOL,
                            "delta": checks.PAGED_DELTA_TOL}}
    return report, (pc, banks)


def wire_layout(state: Dict) -> torch.Tensor:
    """An exported slot's KV as (T, C): token t's K of every layer, head
    and dim, then its V, with T the slot's filled length."""
    T = state["len"]
    parts = []
    for n in ("k", "v"):
        kv = state["kv"][n][:, 0, :T]                  # (L, T, Kv, hd)
        parts.append(kv.permute(1, 0, 2, 3).reshape(T, -1))
    return torch.cat(parts, dim=1).contiguous()


def kv_wire(ex, rid: int):
    """Part 3 of the module docstring, on request ``rid``'s exported KV.
    Returns (report, the first full block, for timing)."""
    x = wire_layout(ex.export_slot(rid))
    T, C = x.shape
    blocks = [x[i:i + BLOCK_T] for i in range(0, T, BLOCK_T)]
    raw = x.numel() * x.element_size()
    report = {"rid": rid, "tokens": T, "channels": C, "raw_bytes": raw,
              "blocks": len(blocks), "tail_tokens": T % BLOCK_T, "bits": {}}
    for bits, mode in WIRE_MODES.items():
        wire, worst = 0, 0.0
        for i, blk in enumerate(blocks):
            res = checks.check_kv_quantize(blk, bits)
            packed, scales = res["packed"], res["scales"]
            nbytes = packed.nbytes + scales.nbytes
            wire += nbytes
            if blk.shape[0] == BLOCK_T:
                ratio = nbytes / blk.nbytes
                assert ratio == WIRE_RATIO[bits], (bits, ratio)
            deq = checks.check_kv_dequantize(packed, scales, bits,
                                             torch.float32)["out"]
            worst = max(worst, checks.check_kv_error(blk, deq, bits))
            if i == 0:
                checks.check_kv_dequantize(packed, scales, bits,
                                           torch.bfloat16)
        sim = KVCompressionConfig(mode=mode).wire_bytes(
            raw, bytes_per_token=2 * C)
        assert wire == sim, (mode, wire, sim)
        report["bits"][mode] = {
            "wire_bytes": wire, "sim_wire_bytes": sim,
            "wire_ratio": wire / raw, "full_block_ratio": WIRE_RATIO[bits],
            "max_err_over_absmax": worst}
    return report, blocks[0]


def run(cfg, n_adapters: int = 16, batch: int = 8, prompt_min: int = 1024,
        prompt_max: int = 2044, device=None):
    """Serve, then check the paged kernels and the KV wire on what the
    executor holds (see the module docstring).  Returns (report,
    artifacts): the JSON-able report, and per mode the last layer's paged
    case with its o-bank and the first wire block, for timing."""
    dev = resolve_device(device)
    page_t = PAGE_TOKENS
    max_blocks = -(-(prompt_max + DECODE_STEPS) // page_t)
    s_max = max_blocks * page_t
    g = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    g.manual_seed(SEED)
    params = init_params(tf.model_defs(cfg), g, dev)
    lengths = prompt_lengths(batch, prompt_min, prompt_max, SEED)
    report = {"arch": cfg.name, "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "n_adapters": n_adapters, "batch": batch, "s_max": s_max,
              "decode_path": "fused", "modes": {}}
    artifacts = {}
    for mode in MODES:
        ex, srv = serve(cfg, params, mode, n_adapters, lengths, DECODE_STEPS,
                        s_max, SEED, dev)
        paged, case = paged_decode(ex, page_t, max_blocks, SEED)
        longest = int(np.argmax(ex.slot_len))
        wire, block = kv_wire(ex, ex.slot_req[longest])
        report["modes"][mode] = {"serve": srv, "paged": paged, "wire": wire}
        artifacts[mode] = {"paged": case, "wire_block": block.clone()}
        del ex
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return report, artifacts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of --arch, prompts of 256-510 "
                         "tokens")
    ap.add_argument("--adapters", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lo, hi = (256, 510) if args.smoke else (1024, 2044)
    report, _ = run(cfg, args.adapters, args.batch, prompt_min=lo,
                    prompt_max=hi, device=args.device)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
