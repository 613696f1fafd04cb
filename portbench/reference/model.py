"""The plain reference of a one-answer prefill, in float32 torch.

It follows the published equations of the two decoder families the cells
run (Mistral's and GraniteMoe's, with the port's departures that the
configuration files list): token embedding; per layer an RMS norm, GQA
attention with rotary positions (the halves rotated), causal softmax,
the output projection, the request's adapter deltas on the adapted
projections, an RMS norm and a SwiGLU MLP or a softmax router with its
top-k experts (the chosen weights renormalised); a final RMS norm and the
unembedding.

It reads the benchmark's own weights and adapter banks (bfloat16, in the
port's layouts) and works everything else out itself; it imports nothing
of the program.  The requests run layer by layer, so that each layer's
weights are cast to float32 once for all of them.

Its matrix products run on TF32 operands (10 mantissa bits, float32
sums) on the card: eight times finer than the bfloat16 that the
configurations state and the program serves, and some eight times faster
than float32 products, so that a comparison of some hundreds of prompts
fits after a run's window.  Everything else is float32.

``lowp="fp8"`` is the control: every matrix product takes both operands
rounded to float8 e4m3 (weights per output channel, activations per row,
each scaled to the format's range), the rest as above.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

F8_MAX = 448.0          # the largest finite float8 e4m3 value
MATMUL_PRECISION = "high"   # torch's name for TF32 products
ATTN_BLOCK = 1024       # queries a block of the attention


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the scale maps the slice's largest magnitude to the format's)."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    def __init__(self, weights: Dict, rc: Dict, bundles: Dict,
                 lowp: Optional[str] = None):
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown precision {lowp!r}")
        self.w, self.rc, self.banks = weights, rc, bundles["layers"]
        self.lowp = lowp

    # -- pieces ---------------------------------------------------------
    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (n, k) @ w (k, m) in float32, or on float8 operands."""
        if self.lowp:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def _rms(self, x, scale):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.rc["eps"]) * scale.float()

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (S, n, hd) rotated at positions ``pos`` (the halves form the
        pairs); the angles in float64."""
        half = x.shape[-1] // 2
        inv = self.rc["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float64, device=x.device) / half)
        ang = pos.double()[:, None] * inv[None]
        cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _delta(self, target: str, li: int, aid: int, x: torch.Tensor):
        """The adapter's delta on ``target``'s output for input x (S, d_in),
        or None where the target is not adapted."""
        b = self.banks.get(target)
        if b is None:
            return None
        if self.rc["mode"] == "lora":
            a = b["A"][li, aid].float()                  # (r, d_in)
            bb = b["B"][li, aid].float()                 # (d_out, r)
            return self._mm(self._mm(x, a.T), bb.T)
        c = int(b["cluster_of"][li, aid])
        v = b["V"][li, c].float()                        # (d_in, r)
        u = b["U"][li, c].float()                        # (d_out, r)
        sig = b["sigma"][li, aid].float()                # (r, r)
        return self._mm(self._mm(self._mm(x, v), sig), u.T)

    def _proj(self, target, li, aid, x, w):
        y = self._mm(x, w)
        d = self._delta(target, li, aid, x)
        return y if d is None else y + d

    def _attention(self, q, k, v):
        """Causal GQA softmax attention; q (S, H, hd), k, v (S, Kv, hd)."""
        S, H, hd = q.shape
        Kv = k.shape[1]
        G = H // Kv
        if self.lowp:
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(hd)
        for i0 in range(0, S, ATTN_BLOCK):
            i1 = min(S, i0 + ATTN_BLOCK)
            qg = q[i0:i1].reshape(i1 - i0, Kv, G, hd)
            s = torch.einsum("qkgh,skh->kgqs", qg, k[:i1]) * scale
            qpos = torch.arange(i0, i1, device=q.device)
            kpos = torch.arange(i1, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("kgqs,skh->qkgh", p, v[:i1])
            out[i0:i1] = o.reshape(i1 - i0, H, hd)
        return out

    def _mlp(self, m, x):
        """``m``: one layer's SwiGLU weights, f32."""
        h = torch.nn.functional.silu(self._mm(x, m["w_gate"])) \
            * self._mm(x, m["w_up"])
        return self._mm(h, m["w_down"])

    def _moe(self, m, x):
        """``m``: one layer's router (d, E) and expert weights, f32."""
        logits = self._mm(x, m["router"])
        probs = torch.softmax(logits, dim=-1)
        topw, topi = torch.topk(probs, self.rc["top_k"], dim=-1)
        topw = topw / topw.sum(-1, keepdim=True)
        y = torch.zeros_like(x)
        flat = topi.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=m["router"].shape[1]).tolist()
        start = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            sel = order[start:start + n]
            start += n
            tok = sel // self.rc["top_k"]
            xs = x[tok]
            h = torch.nn.functional.silu(self._mm(xs, m["w_gate"][e])) \
                * self._mm(xs, m["w_up"][e])
            out = self._mm(h, m["w_down"][e]) * topw.reshape(-1)[sel, None]
            y.index_add_(0, tok, out)
        return y

    # -- the forward ----------------------------------------------------
    @torch.no_grad()
    def run(self, prompts: List[torch.Tensor], adapters: List[int],
            on_kv: Optional[Callable] = None) -> List[torch.Tensor]:
        """Prefill each prompt (a 1-D token tensor) on its adapter; returns
        each prompt's logits at its last position, (1, V).
        ``on_kv(layer, request, k, v)`` receives each layer's rotated keys
        and values (S, Kv, hd)."""
        torch.set_float32_matmul_precision(MATMUL_PRECISION)
        rc, w = self.rc, self.w
        H, Kv, hd, d = rc["heads"], rc["kv_heads"], rc["head_dim"], rc["d"]
        emb = w["embed"]["embed"]
        hs = [emb[t].float() for t in prompts]
        lay = w["layers"]
        for li in range(rc["layers"]):
            wq = lay["attn"]["wq"][li].float().reshape(d, H * hd)
            wk = lay["attn"]["wk"][li].float().reshape(d, Kv * hd)
            wv = lay["attn"]["wv"][li].float().reshape(d, Kv * hd)
            wo = lay["attn"]["wo"][li].float().reshape(H * hd, d)
            ffn = lay["moe" if rc["experts"] else "mlp"]
            ffn = {k: t[li].float() for k, t in ffn.items()}
            for i, (h, aid) in enumerate(zip(hs, adapters)):
                S = h.shape[0]
                pos = torch.arange(S, device=h.device)
                x = self._rms(h, lay["ln1"][li])
                q = self._proj("q", li, aid, x, wq).reshape(S, H, hd)
                k = self._proj("k", li, aid, x, wk).reshape(S, Kv, hd)
                v = self._proj("v", li, aid, x, wv).reshape(S, Kv, hd)
                q, k = self._rope(q, pos), self._rope(k, pos)
                if on_kv is not None:
                    on_kv(li, i, k, v)
                o = self._attention(q, k, v).reshape(S, H * hd)
                h = h + self._proj("o", li, aid, o, wo)
                x = self._rms(h, lay["ln2"][li])
                h = h + (self._moe(ffn, x) if rc["experts"]
                         else self._mlp(ffn, x))
                hs[i] = h
            del wq, wk, wv, wo, ffn
        unemb = (emb.T if rc["tied"] else w["embed"]["unembed"]).float()
        out = []
        for h in hs:
            out.append(self._mm(self._rms(h[-1:], w["embed"]["final_norm"]),
                                unemb))
        return out
