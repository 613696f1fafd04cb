"""Real-model executor (the port of ``serving/real_executor.py``): runs
prefill/decode of a dense model with batched per-slot adapters on the card
(or on the CPU when asked), behind the `ServingEngine` executor interface.

Slot model: a fixed decode batch of ``max_batch`` KV-cache slots; admitted
requests prefill into a free slot (batch-1 prefill, cache splice); each
engine decode step advances every occupied slot by one token with per-slot
adapter ids (mode "lora": stacked A/B banks; mode "jd": U/V/Sigma bundles).

Decode paths (``decode_path``, surfaced as `EngineConfig.decode_path`):

* ``"unfused"`` — the generic `transformer.decode_step` (functional
  cache, separate attention + adapter passes, plain torch ops).
* ``"fused"`` — a purpose-built decode step: the per-layer loop is
  unrolled, rope tables are built once, the new token's K/V is written
  into the cache in place, attention runs only over the occupied
  128-token bucket, and attention + the o-projection adapter delta run
  as the fused kernels (`kernels/fused_decode.py` via
  `kernels/ops.py::fused_lora_decode` / `fused_jd_decode`), or as
  `flash_decode` when the bundles have no "o" target.
* ``"fused_q8"`` — ``"fused"`` plus int8 per-output-channel adapter
  residency (`kernels/adapter_quant.py`): banks are packed at
  construction, `adapter_bytes` shrinks ~4x, the o-target bank is
  dequantized inside the fused kernels and q/k/v banks per layer with
  the plain dequantization.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.adapter_quant import adapter_quantize
from ..models import layers
from ..models import transformer as tf
from ..models.lora import LoRAContext
from ..models.param import tree_leaves, tree_map
from .request import Request

DECODE_PATHS = ("unfused", "fused", "fused_q8")


class RealModelExecutor:
    def __init__(self, cfg, params, bundles: Dict[str, Dict], mode: str,
                 max_batch: int, s_max: int,
                 cluster_of: Optional[np.ndarray] = None,
                 adapter_bytes_override: Optional[int] = None,
                 decode_path: str = "unfused", device=None):
        """bundles: layer-structured tensors for the adapters:
        mode 'lora': {"layers": {target: {"A": (L,n,r,d), "B": (L,n,d,r)}}}
        mode 'jd':   {"layers": {target: {"U","V","sigma","cluster_of"}}}

        ``device`` defaults to the card; every tensor is moved there."""
        if decode_path not in DECODE_PATHS:
            raise ValueError(f"decode_path must be one of {DECODE_PATHS}, "
                             f"got {decode_path!r}")
        self.device = resolve_device(device)
        self.cfg, self.mode = cfg, mode
        self.decode_path = decode_path
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_batch = max_batch
        self.s_max = s_max
        self.cluster_of = cluster_of
        self.cache = tf.init_cache(cfg, max_batch, s_max, device=self.device)
        self.slot_req: List[Optional[int]] = [None] * max_batch
        self.slot_adapter = np.zeros(max_batch, np.int32)
        self.slot_tokens = np.zeros(max_batch, np.int32)
        self.slot_len = np.zeros(max_batch, np.int32)
        # host mirror of the cache's scalar index: lets the fused paths pick
        # a KV bucket without a device sync
        self._host_len = 0
        bundles = tree_map(lambda t: t.to(self.device), bundles)
        if decode_path != "unfused":
            self._check_fusable()
            if decode_path == "fused_q8":
                bundles = _quantize_bundles(bundles, mode)
        self.bundles = bundles
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(self.bundles)) or 1
        n_adapters = self._n_adapters()
        self._adapter_bytes = adapter_bytes_override or max(
            nbytes // max(n_adapters, 1), 1)

    def _check_fusable(self) -> None:
        if self.cfg.family not in ("dense", "vlm"):
            raise ValueError("fused decode paths support dense-attention "
                             f"families only, not {self.cfg.family!r}")
        if self.cfg.sliding_window:
            raise ValueError("fused decode paths assume full attention "
                             "(sliding_window=0)")
        if self.mode not in ("lora", "jd"):
            raise ValueError(f"unknown adapter mode {self.mode!r}")

    def _n_adapters(self) -> int:
        # the first leaf in sorted-key order, as the JAX executor reads it
        for leaf in tree_leaves(self.bundles):
            return leaf.shape[1] if leaf.ndim > 1 else 1
        return 1

    def _ctx(self, ids: torch.Tensor) -> LoRAContext:
        return LoRAContext(mode="batched" if self.mode == "lora" else "jd",
                           params=None, ids=ids.long(), scaling=1.0)

    def _prefill(self, tokens, cache, ids):
        bundles = self.bundles
        if self.decode_path == "fused_q8":
            bundles = _dequantize_bundles(bundles)
        return tf.prefill(self.params, {"tokens": tokens}, self.cfg, cache,
                          lora_params=bundles,
                          lora_ctx_proto=self._ctx(ids))

    # -- fused decode step --------------------------------------------------
    def _bucket(self) -> int:
        """KV window for the fused step: the occupied prefix of the cache
        rounded up to 128 tokens (the page granule), so attention only
        touches ``ceil(len/128)`` blocks instead of ``s_max``."""
        need = self._host_len + 1
        return min(self.s_max, 128 * -(-need // 128))

    @torch.no_grad()
    def _fused_decode(self, tokens, ids, bucket: int):
        """Unrolled single-token decode with the o-projection adapter delta
        fused into the attention kernel.  Matches `transformer.decode_step`
        (scalar cache index, decode at max occupied length); writes the new
        token's K/V into ``self.cache`` in place and advances its index."""
        cfg = self.cfg
        quant = self.decode_path == "fused_q8"
        banks = self.bundles["layers"]
        qkv_banks = {t: tp for t, tp in banks.items() if t != "o"}
        o_bank = banks.get("o")
        proto = self._ctx(ids)

        x = layers.embed_tokens(self.params["embed"], tokens)
        Bt, S, _ = x.shape                       # S == 1
        idx = self.cache["index"]
        positions = idx + torch.arange(S, dtype=torch.int32,
                                       device=self.device)
        cos, sin = layers.rope_tables(positions, cfg.resolved_head_dim,
                                      cfg.rope_theta)
        ck, cv = self.cache["k"], self.cache["v"]
        w = min(idx, ck.shape[2] - S)            # XLA's clamped write index
        kv_len = torch.full((Bt,), idx + S, dtype=torch.int32,
                            device=self.device)
        for li in range(cfg.num_layers):
            p_l = tf.layer_params(self.params["layers"], li)
            lora_l = {t: (_dequantize_target(tf.layer_params(tp, li))
                          if quant else tf.layer_params(tp, li))
                      for t, tp in qkv_banks.items()} or None
            ctx = (LoRAContext(mode=proto.mode, params=lora_l, ids=proto.ids,
                               scaling=proto.scaling)
                   if lora_l is not None else None)
            xin = layers.rms_norm(x, p_l["ln1"], cfg.norm_eps)
            qh, kh, vh = layers._qkv(p_l["attn"], xin, cfg, ctx)
            qh = layers.apply_rope(qh, cos, sin)
            kh = layers.apply_rope(kh, cos, sin)
            ck[li, :, w:w + S] = kh.to(ck.dtype)
            cv[li, :, w:w + S] = vh.to(cv.dtype)
            attn, delta = self._fused_attn(qh[:, 0], ck[li, :, :bucket],
                                           cv[li, :, :bucket], kv_len,
                                           ids, o_bank, li)
            y = torch.einsum("bhk,hkd->bd", attn, p_l["attn"]["wo"])
            if delta is not None:
                y = y + (proto.scaling * delta).to(y.dtype)
            x = x + y[:, None]
            x = x + layers.mlp_fwd(
                p_l["mlp"], layers.rms_norm(x, p_l["ln2"], cfg.norm_eps))
        self.cache["index"] = idx + S
        return layers.logits_fwd(self.params["embed"], x, cfg)

    def _fused_attn(self, q1, k_l, v_l, kv_len, ids, o_bank, li):
        """One layer's decode attention (+ fused o-delta when the bundles
        carry an "o" target)."""
        if o_bank is None:
            return kops.decode_attention(q1, k_l, v_l, kv_len), None
        if self.mode == "lora":
            if self.decode_path == "fused_q8":
                return kops.fused_lora_decode(
                    q1, k_l, v_l, kv_len, ids,
                    o_bank["A_q"][li], o_bank["B_q"][li],
                    a_scale=o_bank["A_s"][li], b_scale=o_bank["B_s"][li])
            return kops.fused_lora_decode(q1, k_l, v_l, kv_len, ids,
                                          o_bank["A"][li], o_bank["B"][li])
        if self.decode_path == "fused_q8":
            sigma = (o_bank["sigma"][li] if "sigma" in o_bank else
                     kref.adapter_dequant_ref(o_bank["sigma_q"][li],
                                              o_bank["sigma_s"][li]))
            return kops.fused_jd_decode(
                q1, k_l, v_l, kv_len, ids, o_bank["U_q"][li],
                o_bank["V_q"][li], sigma, o_bank["cluster_of"][li],
                u_scale=o_bank["U_s"][li], v_scale=o_bank["V_s"][li])
        return kops.fused_jd_decode(
            q1, k_l, v_l, kv_len, ids, o_bank["U"][li], o_bank["V"][li],
            o_bank["sigma"][li], o_bank["cluster_of"][li])

    # -- engine interface ---------------------------------------------------
    def adapter_bytes(self, aid: int) -> int:
        return self._adapter_bytes

    def shared_bytes(self) -> int:
        return 0

    def _splice(self, kv: Dict, slot: int, index: int) -> None:
        """Write a one-slot cache into ``slot`` and advance the shared
        scalar index to the deeper of the two, so decode continues after
        the prompt instead of overwriting it."""
        self.cache["k"][:, slot:slot + 1] = kv["k"]
        self.cache["v"][:, slot:slot + 1] = kv["v"]
        self.cache["index"] = max(self.cache["index"], int(index))
        self._host_len = max(self._host_len, int(index))

    @torch.no_grad()
    def prefill_request(self, req: Request, prompt: np.ndarray) -> None:
        slot = self.slot_req.index(None)
        c1 = tf.init_cache(self.cfg, 1, self.s_max, device=self.device)
        tokens = torch.as_tensor(np.asarray(prompt)[None], dtype=torch.long,
                                 device=self.device)
        ids = torch.tensor([req.adapter_id], dtype=torch.int32,
                           device=self.device)
        logits, c1 = self._prefill(tokens, c1, ids)
        self._splice(c1, slot, req.prompt_len)
        self.slot_req[slot] = req.rid
        self.slot_adapter[slot] = req.adapter_id
        self.slot_tokens[slot] = int(torch.argmax(logits[0, -1]))
        self.slot_len[slot] = req.prompt_len

    @torch.no_grad()
    def decode_logits(self) -> torch.Tensor:
        """One decode step for every slot; returns its logits (B, 1, Vp)
        and advances the cache (the host-side slot state is left as is)."""
        tokens = torch.as_tensor(self.slot_tokens[:, None], dtype=torch.long,
                                 device=self.device)
        ids = torch.as_tensor(self.slot_adapter, device=self.device)
        # the cache index is shared by all slots: decode at the max
        # occupied length (padding slots attend junk but are ignored)
        if self.decode_path == "unfused":
            logits, self.cache = tf.decode_step(
                self.params, tokens, self.cfg, self.cache,
                lora_params=self.bundles, lora_ctx_proto=self._ctx(ids))
        else:
            logits = self._fused_decode(tokens, ids, self._bucket())
        self._host_len += 1
        return logits

    def decode_step_real(self) -> Dict[int, int]:
        """One decode step for all occupied slots; returns {rid: token}."""
        logits = self.decode_logits()
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        out = {}
        for slot, rid in enumerate(self.slot_req):
            if rid is not None:
                self.slot_tokens[slot] = nxt[slot]
                self.slot_len[slot] += 1
                out[rid] = int(nxt[slot])
        return out

    def release(self, rid: int) -> None:
        slot = self.slot_req.index(rid)
        self.slot_req[slot] = None

    # -- live migration -----------------------------------------------------
    def export_slot(self, rid: int) -> Dict:
        """Checkpoint a request's decode state for live migration: its KV
        slice, the last sampled token, and the filled depth.  The slot is
        NOT released; the engine frees it via :meth:`release`."""
        slot = self.slot_req.index(rid)
        kv = {"k": self.cache["k"][:, slot:slot + 1].clone(),
              "v": self.cache["v"][:, slot:slot + 1].clone(),
              "index": self.cache["index"]}
        return {"kv": kv,
                "adapter": int(self.slot_adapter[slot]),
                "token": int(self.slot_tokens[slot]),
                "len": int(self.slot_len[slot]),
                "index": int(self._host_len)}

    def import_slot(self, req: Request, state: Dict) -> None:
        """Re-admit a migrated request from :meth:`export_slot` state into
        a free slot; decode resumes from the checkpointed token."""
        slot = self.slot_req.index(None)
        self._splice(state["kv"], slot, state["index"])
        self.slot_req[slot] = req.rid
        self.slot_adapter[slot] = state["adapter"]
        self.slot_tokens[slot] = state["token"]
        self.slot_len[slot] = state["len"]

    # cost hooks: wall clock around work that ends in a device sync (the
    # argmax's .cpu() in decode, int() of it in prefill)
    def decode_step_time(self, batch) -> float:
        t0 = time.perf_counter()
        self.decode_step_real()
        return time.perf_counter() - t0

    def prefill_time(self, req: Request) -> float:
        t0 = time.perf_counter()
        prompt = np.random.randint(0, self.cfg.vocab_size,
                                   size=req.prompt_len).astype(np.int32)
        self.prefill_request(req, prompt)
        return time.perf_counter() - t0


def _quantize_bundles(bundles: Dict, mode: str) -> Dict:
    """Pack fp adapter banks into int8 values + per-output-channel f32
    scales (`kernels/adapter_quant.py`).  Diag Sigma (already tiny) stays
    fp; `cluster_of` passes through."""
    def one_target(tp):
        if "A" in tp:                              # raw LoRA
            aq, a_s = adapter_quantize(tp["A"])
            bq, b_s = adapter_quantize(tp["B"])
            return {"A_q": aq, "A_s": a_s, "B_q": bq, "B_s": b_s}
        uq, u_s = adapter_quantize(tp["U"])
        vq, v_s = adapter_quantize(tp["V"], axis=-2)
        out = {"U_q": uq, "U_s": u_s, "V_q": vq, "V_s": v_s,
               "cluster_of": tp["cluster_of"]}
        sigma = tp["sigma"]
        if sigma.ndim >= 4:                        # (L, n, r, r) full
            out["sigma_q"], out["sigma_s"] = adapter_quantize(sigma)
        else:                                      # (L, n, r) diag
            out["sigma"] = sigma
        return out
    return {"layers": {t: one_target(tp)
                       for t, tp in bundles["layers"].items()}}


def _dequantize_target(tp: Dict) -> Dict:
    """f32 view of one (possibly packed) target bank."""
    if "A_q" in tp:
        return {"A": kref.adapter_dequant_ref(tp["A_q"], tp["A_s"]),
                "B": kref.adapter_dequant_ref(tp["B_q"], tp["B_s"])}
    if "U_q" in tp:
        out = {"U": kref.adapter_dequant_ref(tp["U_q"], tp["U_s"]),
               "V": kref.adapter_dequant_ref(tp["V_q"], tp["V_s"]),
               "cluster_of": tp["cluster_of"]}
        out["sigma"] = (tp["sigma"] if "sigma" in tp else
                        kref.adapter_dequant_ref(tp["sigma_q"],
                                                 tp["sigma_s"]))
        return out
    return tp


def _dequantize_bundles(bundles: Dict) -> Dict:
    return {"layers": {t: _dequantize_target(tp)
                       for t, tp in bundles["layers"].items()}}


def derive_cost_constants(samples) -> Dict[str, float]:
    """Fit the simulator's decode cost model t(B) ~= c0 + c1 * B to real
    measured (batch, seconds) pairs."""
    b = np.asarray([s[0] for s in samples], np.float64)
    t = np.asarray([s[1] for s in samples], np.float64)
    if b.size < 2 or np.all(b == b[0]):
        raise ValueError("need samples at >= 2 distinct batch sizes")
    M = np.stack([np.ones_like(b), b], axis=1)
    coef, *_ = np.linalg.lstsq(M, t, rcond=None)
    pred = M @ coef
    denom = float(np.sum((t - t.mean()) ** 2)) or 1.0
    return {"step_overhead_s": float(max(coef[0], 0.0)),
            "per_slot_s": float(max(coef[1], 0.0)),
            "r2": 1.0 - float(np.sum((t - pred) ** 2)) / denom,
            "n_samples": int(b.size)}
