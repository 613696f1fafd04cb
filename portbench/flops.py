"""The yardstick's arithmetic: one H100's peak and the work a prefill
needs.

The peak is a frozen copy of the port's ``launch/roofline.py`` (NVIDIA's
H100 SXM data sheet, dense rates).  The model flops follow its
``model_flops_for`` (2 flops a multiply-add of every weight a token
meets, counting only the chosen experts of a MoE layer) with what it
leaves out added: the causal attention of the prompt, the adapters'
products, the router, and the unembedding of the one position whose
answer is read.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense tensor-core flop/s, one card


def _attn_weights(rc) -> int:
    """Weights of one layer's q, k, v and o projections."""
    d, H, Kv, hd = rc["d"], rc["heads"], rc["kv_heads"], rc["head_dim"]
    return d * H * hd + 2 * d * Kv * hd + H * hd * d


def _ffn_weights(rc, d_ff: int) -> int:
    """Weights one token meets in a layer's MLP, or in its chosen experts
    and the router."""
    d = rc["d"]
    if rc["experts"]:
        return 3 * d * d_ff * rc["top_k"] + d * rc["experts"]
    return 3 * d * d_ff


def _adapter_weights(rc, serving) -> int:
    """Adapter weights one token meets in a layer (one adapter)."""
    d, H, Kv, hd = rc["d"], rc["heads"], rc["kv_heads"], rc["head_dim"]
    dims = {"q": (d, H * hd), "k": (d, Kv * hd), "v": (d, Kv * hd),
            "o": (H * hd, d)}
    r = serving["rank"]
    n = 0
    for t in serving["targets"]:
        di, do = dims[t]
        n += r * (di + do) + (r * r if serving["mode"] == "jd" else 0)
    return n


def prefill_flops(rc, d_ff: int, vocab: int, serving, S: int) -> float:
    """Flops one prompt of S tokens needs: the linear layers with the
    adapter and the router, causal attention (S(S+1)/2 query-key pairs,
    a dot product and a weighted sum of hd each, per head), and the
    unembedding of the last position."""
    per_token = rc["layers"] * (_attn_weights(rc) + _ffn_weights(rc, d_ff)
                                + _adapter_weights(rc, serving))
    attn = rc["layers"] * 2.0 * rc["heads"] * rc["head_dim"] * S * (S + 1)
    return 2.0 * per_token * S + attn + 2.0 * rc["d"] * vocab

