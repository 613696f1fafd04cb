"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``loops/<loop>.py``, ``metrics/<metric>.py``
beside this file.  Adding a configuration, a mix, a metric or a cell adds
files and entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A module from a file whose name need not be an identifier (metric
    names carry dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Dict = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def port_config(conf: Dict):
    """The port's ``ModelConfig`` for a configuration file: the port's
    registered architecture (``port_arch``: family and implementation
    settings) with every size and constant the file states put in."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LoRAConfig, MoEConfig

    base = get_config(conf["port_arch"])
    heads = conf["num_attention_heads"]
    sv = conf["serving"]
    fields = dict(
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=heads, num_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf.get("tie_word_embeddings", False)),
        sliding_window=int(conf.get("sliding_window") or 0),
        lora=LoRAConfig(rank=sv["rank"], targets=tuple(sv["targets"])))
    if "num_local_experts" in conf:
        fields["moe"] = MoEConfig(num_experts=conf["num_local_experts"],
                                  top_k=conf["num_experts_per_tok"],
                                  num_shared=0,
                                  d_ff_expert=conf["intermediate_size"])
    return dataclasses.replace(base, **fields)


def reference_config(conf: Dict) -> Dict:
    """The sizes the plain reference reads (plain numbers, no port type)."""
    heads = conf["num_attention_heads"]
    return {
        "layers": conf["num_hidden_layers"], "d": conf["hidden_size"],
        "heads": heads, "kv_heads": conf["num_key_value_heads"],
        "head_dim": conf.get("head_dim") or conf["hidden_size"] // heads,
        "rope_theta": float(conf["rope_theta"]),
        "eps": float(conf["rms_norm_eps"]),
        "tied": bool(conf.get("tie_word_embeddings", False)),
        "experts": conf.get("num_local_experts", 0),
        "top_k": conf.get("num_experts_per_tok", 0),
        "mode": conf["serving"]["mode"],
    }
