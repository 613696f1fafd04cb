"""The control of a cell's comparison: the plain reference in float8 put in
the program's place and driven through a whole run (``run.run_cell``):
the cell's warm-up, its window at its own load, its own sample of the
answered requests and ``check.compare`` against the cell's limits.  A
control's run has to come out ``correct: false``.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 90]

One JSON line a seed, all in one process.  The limits in
``limits/<cell>.json`` lie between the largest of the program's readings
and the smallest of the control's; the benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
from typing import Dict

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import spec  # noqa: E402
from portbench.reference.model import Reference  # noqa: E402


class ControlExecutor:
    """The executor's surface that the loop and the check use, served by
    ``Reference(lowp="fp8")``: each call prefills its prompt alone, keeps
    the rotated K/V rows it made as its slot's (bfloat16, the program's
    cache type) and answers with the argmax of its last position."""

    def __init__(self, weights: Dict, rc: Dict, bundles: Dict, slots: int,
                 device):
        self.ref = Reference(weights, rc, bundles, lowp="fp8")
        self.device = device
        self.slot_req = [None] * slots
        self.slot_tokens = [0] * slots
        self.kv: Dict[int, Dict[str, torch.Tensor]] = {}

    def prefill_request(self, req, prompt) -> None:
        slot = self.slot_req.index(None)
        ks, vs = [], []

        def keep(li, j, k, v):
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))

        toks = torch.as_tensor(np.asarray(prompt), device=self.device)
        logits = self.ref.run([toks], [int(req.adapter_id)], on_kv=keep)
        self.slot_req[slot] = req.rid
        self.slot_tokens[slot] = int(logits[0][0].argmax())
        # (L, 1, S, Kv, hd), as the executor's slot export
        self.kv[req.rid] = {"k": torch.stack(ks)[:, None],
                            "v": torch.stack(vs)[:, None]}

    def release(self, rid: int) -> None:
        self.slot_req[self.slot_req.index(rid)] = None
        del self.kv[rid]

    def export_slot(self, rid: int) -> Dict:
        return {"kv": self.kv[rid]}


def control_executor(rc: Dict):
    """A ``run.run_cell`` executor factory that builds the control."""
    def make(cfg, params, bundles, sv, dev):
        return ControlExecutor(params, rc, bundles, int(sv["slots"]), dev)
    return make


def main(argv=None) -> int:
    from portbench.run import forbidden_modules, run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma list")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window; the benchmark's run_seconds unless "
                         "given (a longer one lets the slower control "
                         "answer as many requests as a run compares)")
    args = ap.parse_args(argv)
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cell = spec.load_cell(args.workload, bench)
    seconds = args.seconds or float(bench["run_seconds"])
    make = control_executor(spec.reference_config(cell.config))
    for s in (int(x) for x in args.seeds.split(",")):
        res = run_cell(cell, s, seconds, False, "cuda", executor=make)
        print(json.dumps({"workload": cell.name, "seed": s,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
