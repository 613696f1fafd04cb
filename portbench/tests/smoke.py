"""Cells at a size the CPU holds: the cell's mix, limits and metrics with a
small configuration of the same family in place of its own, and prompts
of 8-64 tokens."""
from __future__ import annotations

import copy

from portbench import spec

BASE = "mistral-7b-jd1000.score-backlog"
# the MoE smoke cell takes granite's configuration file in place of the
# base cell's (granite's backlog has no cell yet: PERF.md, Open questions)
MOE_CONFIG = "granite-moe-3b-a800m-lora1000"

SMALL = {"hidden_size": 64, "intermediate_size": 96,
         "num_attention_heads": 4, "num_hidden_layers": 2,
         "num_key_value_heads": 2, "vocab_size": 500}
# granite's 40 experts and 8 a token, at a small width
SMALL_MOE = dict(SMALL, intermediate_size=32, num_local_experts=40,
                 num_experts_per_tok=8, vocab_size=300)
SERVING = {"adapters": 8, "rank": 4, "clusters": 2, "s_max": 64}


def smoke_cell(kind: str, rate: float = 50.0) -> spec.Cell:
    """kind: "dense" (mistral's backlog cell), "moe" (granite's
    configuration under it) or "poisson" (the base cell's mix as an open
    loop at ``rate`` requests a second)."""
    cell = copy.deepcopy(spec.load_cell(BASE))
    if kind == "moe":
        cell.config = spec.load_json(spec.HERE / "configs"
                                     / f"{MOE_CONFIG}.json")
    cell.config.update(SMALL_MOE if kind == "moe" else SMALL)
    cell.config["serving"].update(SERVING)
    cell.traffic["prompt_len"] = {"dist": "lognormal", "median": 24,
                                  "sigma": 0.6, "min": 8, "max": 64}
    cell.traffic["schedule_len"] = 4096
    if kind == "poisson":
        cell.traffic.update(arrival="poisson", rate_per_s=rate)
    return cell
