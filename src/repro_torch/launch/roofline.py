"""Roofline terms of a step on one H100 (the port of ``launch/roofline.py``).

Hardware model: the H100 SXM data sheet, kept here and nowhere else (the
kernels' bound in ``kernels/checks.py`` imports its two figures from this
module).  The step's flops, HBM bytes and collective bytes per device come
from ``launch/op_cost.py``'s record of the step, not from HLO text: the
port's steps run eagerly, one kernel an op.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense tensor-core flop/s, one card
F32_FLOPS = 67e12            # f32 flop/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s, one card
NVLINK_BW = 450e9            # NVLink bytes/s each way, one card
HBM_BYTES = 80e9             # device memory, one card


# ring-model bytes moved per device, as a multiple of the RESULT bytes
# (g = group size)
def _ring_factor(op: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return (g - 1) / g            # result is the gathered tensor
    if op == "reduce-scatter":
        return float(g - 1)           # result is the scattered piece
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "all-to-all":
        return (g - 1) / g
    if op == "collective-permute":
        return 1.0
    return 1.0


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    n_devices: int
    model_flops: float           # analytic useful FLOPs (global)

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        tot = self.flops_per_dev * self.n_devices
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the peak-compute roofline achieved if the step ran at
        the max of the three terms: t_ideal_compute / t_bound."""
        t_ideal = self.model_flops / (self.n_devices * PEAK_FLOPS)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_ideal / t_bound if t_bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6ND train, 2ND prefill, 2·N_active·B decode
    (+ KV attention read FLOPs for decode)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    flops = 2.0 * n_active * shape.global_batch
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        hd = cfg.resolved_head_dim
        layers = cfg.num_layers
        flops += (4.0 * cfg.num_heads * hd * shape.seq_len
                  * shape.global_batch * layers)
    return flops
