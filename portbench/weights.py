"""The cell's weights and adapters, made on the card from ``--seed``.

Every matrix is drawn at std 1/sqrt(its fan-in) (a stacked leaf's fan-in
is that of one layer's matrix, never the layer count), in bfloat16, one
``torch.randn`` a leaf from one generator on the device.  Norm scales are
1.  The rows of the port's padded vocabulary past ``vocab_size`` are zero,
as in a converted checkpoint, so that no padding id can win an argmax.

The trees are in the port's layouts (``wq (L, d, H, hd)``, LoRA ``A (L,
n, r, d_in)``, jd ``U (L, k, d_out, r)``, ...): the program takes them as
its inputs, and the reference reads the same tensors, never anything the
program derived from them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

# the axes of each weight that one output sums over (its fan-in)
FAN_IN_AXES = {
    "wq": ("d_model",), "wk": ("d_model",), "wv": ("d_model",),
    "wo": ("heads", "head_dim"),
    "w_gate": ("d_model",), "w_up": ("d_model",),
    "w_down": ("d_ff", "expert_ff"),
    "router": ("d_model",),
    "embed": ("d_model",), "unembed": ("d_model",),
}


def _draw(shape, std: float, g: torch.Generator, device) -> torch.Tensor:
    out = torch.randn(shape, generator=g, device=device,
                      dtype=torch.bfloat16)
    return out.mul_(std)


def model_weights(defs: Dict, cfg, g: torch.Generator, device) -> Dict:
    """The port's parameter tree ``defs`` (``transformer.model_defs``)
    made as the module docstring says."""
    def one(name, d):
        if d.init == "ones":
            return torch.ones(d.shape, dtype=torch.bfloat16, device=device)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=torch.bfloat16, device=device)
        axes = FAN_IN_AXES[name]
        fan_in = math.prod(s for s, a in zip(d.shape, d.axes) if a in axes)
        return _draw(d.shape, 1.0 / math.sqrt(fan_in), g, device)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else one(k, v))
                for k, v in sorted(tree.items())}

    params = walk(defs)
    emb = params["embed"]
    emb["embed"][cfg.vocab_size:] = 0
    if "unembed" in emb:
        emb["unembed"][:, cfg.vocab_size:] = 0
    return params


def target_dims(cfg, target: str):
    """(d_in, d_out) of an adapted projection."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd),
            "o": (cfg.num_heads * hd, d)}[target]


def adapter_bundles(cfg, serving: Dict, g: torch.Generator, device) -> Dict:
    """``{"layers": {target: banks}}`` for the executor: raw LoRA ``A``,
    ``B`` in mode "lora"; in mode "jd" ``U``, ``V`` per cluster, a full
    ``sigma`` per adapter and each adapter's ``cluster_of`` (drawn from
    the seed per target and layer)."""
    L, n, r = cfg.num_layers, int(serving["adapters"]), int(serving["rank"])
    mode = serving["mode"]
    out = {}
    for t in serving["targets"]:
        di, do = target_dims(cfg, t)
        if mode == "lora":
            out[t] = {"A": _draw((L, n, r, di), di ** -0.5, g, device),
                      "B": _draw((L, n, do, r), r ** -0.5, g, device)}
        elif mode == "jd":
            k = int(serving["clusters"])
            if serving.get("sigma", "full") != "full":
                raise ValueError("the jd banks here carry a full Sigma")
            out[t] = {
                "U": _draw((L, k, do, r), r ** -0.5, g, device),
                "V": _draw((L, k, di, r), di ** -0.5, g, device),
                "sigma": _draw((L, n, r, r), r ** -0.5, g, device),
                "cluster_of": torch.randint(0, k, (L, n), generator=g,
                                            device=device,
                                            dtype=torch.int32)}
        else:
            raise ValueError(f"unknown adapter mode {mode!r}")
    return {"layers": out}
