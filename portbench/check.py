"""How ``correct`` is decided for one-answer traffic: what the window's
calls produced, against the plain reference (``reference/model.py``).

The numbers, each against its limit where ``limits/<cell>.json`` names
it:

- ``answer_gap``: over a sample of the answered requests (those holding
  slots, among them the longest, and ``ANSWER_SAMPLE`` more drawn from the
  seed), the widest gap by which the reference's logit of the served token
  lies below its best logit at the last position.
- the K/V rows the call left in its slot (``export_slot``) of each request
  that held its slot, against the reference's rotated keys and values:
  per layer, the worst over those requests, keys and values, of the norm
  of the difference over the norm of the reference's rows (the slot's
  rows past the prompt, which must be zero, count in the difference).
  ``kv_err`` is the worst layer's, ``kv_err_median`` the median layer's.

The control (``control.py``) is the reference in float8 in the program's
place, driven through the same run and judged by this same comparison.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference.model import Reference

# some hundreds of answer tokens compared a run (a window answers 300-400)
ANSWER_SAMPLE = 200


def sample(served: Dict, seed: int) -> List[Dict]:
    """The answered requests compared: the held ones and ``ANSWER_SAMPLE``
    more drawn from the seed."""
    done = [r for r in served["requests"] if r["served"] is not None]
    held = set(served["held"])
    rest = [r for r in done if r["i"] not in held]
    rng = np.random.default_rng([int(seed), 0xA5])
    pick = rng.choice(len(rest), size=min(ANSWER_SAMPLE, len(rest)),
                      replace=False) if rest else []
    return [r for r in done if r["i"] in held] + [rest[j] for j in
                                                   sorted(pick)]


def export_held(ex, served: Dict) -> Dict[int, Dict]:
    """Each held request's K/V rows from its slot, (L, S, Kv, hd) bf16
    over the S tokens of the prompt it was sent, and the norm of its
    slot's rows past them."""
    sent = {r["i"]: r["tokens"] for r in served["requests"]}
    out = {}
    for rid in served["held"]:
        st = ex.export_slot(rid)
        S = sent[rid]
        kv = {}
        for key in ("k", "v"):
            t = st["kv"][key][:, 0]
            kv[key] = t[:, :S].clone()
            kv[key + "_tail"] = float(t[:, S:].float().norm())
        out[rid] = kv
        del st
    return out


def compare(weights, rc, bundles, prompts, adapters, cmp: List[Dict],
            kv: Dict[int, Dict], device) -> Dict[str, float]:
    """``answer_gap`` and ``kv_err`` of the program's answers ``cmp`` and
    K/V rows ``kv`` against the reference."""
    ref = Reference(weights, rc, bundles)
    toks = [torch.as_tensor(prompts[r["i"]], device=device) for r in cmp]
    aids = [int(adapters[r["i"]]) for r in cmp]
    layer_err = [0.0] * rc["layers"]

    def on_kv(li, j, k, v):
        got = kv.get(cmp[j]["i"])
        if got is None:
            return
        for key, want in (("k", k), ("v", v)):
            diff = (got[key][li].float() - want).norm()
            # the rows past the prompt, of every layer, count once
            tail = got[key + "_tail"] if li == 0 else 0.0
            num = math.sqrt(float(diff) ** 2 + tail ** 2)
            layer_err[li] = max(layer_err[li],
                                num / max(float(want.norm()), 1e-30))

    logits = ref.run(toks, aids, on_kv=on_kv)
    gaps = []
    for r, lg in zip(cmp, logits):
        lg = lg[0]
        tok = r["served"]
        ok = 0 <= tok < lg.shape[0]
        gaps.append(float(lg.max() - lg[tok]) if ok else math.inf)
    return {"answer_gap": max(gaps), **kv_numbers(layer_err),
            "compared": len(cmp), "held": len(kv)}


def kv_numbers(layer_err: List[float]) -> Dict[str, float]:
    return {"kv_err": max(layer_err),
            "kv_err_median": float(np.median(layer_err))}
