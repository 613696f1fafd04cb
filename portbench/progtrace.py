"""The device trace of a cell's window put down to the program's own spans
(``repro_torch/spans.py``): which block of host code launched each
kernel, copy and set, how long they ran, and which block the host was in
when the device went idle.

    python3 portbench/progtrace.py --workload <cell> --seed <n> \\
        [--seconds 50]

One JSON line: a whole run of the cell (``run.run_cell``, its comparison
included) with the port's executor under ``TracedExecutor``, which turns
the program's recorder and a device trace on for the window.  One seed a
process, as the benchmark's runs: the comparison sets torch's float32
product precision for the rest of the process.  The line holds
``correct``, the rate, ``split`` (the quantities below, per 1000 prompt
tokens) and ``program_trace`` (the table of ``reduce``).  Its rate is
read under the profiler and the recorder, so it is not the benchmark's;
the benchmark's own runs never run this.

Three records, all on the system clock's nanoseconds:

- the program's spans, ``(name, start_ns, end_ns, parent, ...)``, nested
  (one host thread), and its counters;
- the device's records ``(start_ns, end_ns, correlation)``;
- the host's CUDA API calls ``(name, start_ns, end_ns, correlation)``
  (``correlated_records``).

Over ``[t0_ns, t1_ns]``, for each span name: its calls; its host self
milliseconds (its time less what its children cover); the launches made
inside it (an API call that shares its correlation id with a device
record, put down to the innermost span open at the call's start); the
device milliseconds of what those launches ran; and the idle time of the
device, each gap put down to the innermost span open at its start and
kept by length (``devtrace.GAP_CLASSES``).  Where no program span is
open, a launch or a gap goes to the harness's span open then, or to
``other_span``, as ``devtrace.summarize`` names them ("outside").
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Dict, List, Sequence, Tuple

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.devtrace import (  # noqa: E402
    DEVICE_ACTIVITIES, GAP_CLASSES, _gap_class, _union)

# device records whose launch lies outside the window or was not recorded
NO_LAUNCH = "launched outside the window"
# the harness span of a request, as loops/one_answer.py names it
HARNESS_SPAN = "inside prefill_request"
# the split: the spans whose idle (or device) time each quantity reads
IDLE = {"attention": ("attention", "attention_core"),
        "adapter": ("adapter",),
        "mlp": ("mlp",),
        "model": ("model",),
        "executor": ("prefill_request", "init_cache", "splice",
                     "answer_sync")}
DEVICE = {"attention_core": ("attention_core",), "adapter": ("adapter",)}


def correlated_records(raw) -> Tuple[List[Tuple[int, int, int]],
                                     List[Tuple[str, int, int, int]]]:
    """The device's records as ``(start_ns, end_ns, correlation)``, the
    records ``devtrace.device_events`` keeps; and the host's CUDA API
    calls (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
    ``cuLaunchKernel``, ...) as ``(name, start_ns, end_ns,
    correlation)``.  CUPTI records those under CUDA activity alone, on the
    device records' clock; a launch shares its correlation id with the
    kernel, copy or set it issued.  The profiler's own records on the
    host (buffer requests, module loading) do not start with "cu" and
    are left out."""
    from torch.autograd import DeviceType
    device, runtime = [], []
    for e in raw:
        if e.device_type() == DeviceType.CUDA:
            kind = getattr(e, "activity_type", None)
            if kind is not None and kind() not in DEVICE_ACTIVITIES:
                continue
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id() > 0:
            s = e.start_ns()
            runtime.append((e.name(), s, s + e.duration_ns(),
                            e.correlation_id()))
    return device, runtime


def _innermost(intervals: Sequence[Tuple[int, int]],
               points: Sequence[int]) -> List[int]:
    """For each point, the index of the innermost interval ``[s, e)``
    holding it (the one that started last among those open), or -1.
    The intervals nest or are disjoint, as one thread's spans are."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1]))
    out = [-1] * len(points)
    stack: List[int] = []
    j = 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        t = points[k]
        while j < len(order) and intervals[order[j]][0] <= t:
            s = intervals[order[j]][0]
            while stack and intervals[stack[-1]][1] <= s:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and intervals[stack[-1]][1] <= t:
            stack.pop()
        out[k] = stack[-1] if stack else -1
    return out


def _row() -> Dict:
    return {"launches": 0, "device_ms": 0.0,
            "idle_ms": {label: 0.0 for _, label in GAP_CLASSES}}


def reduce(device: List[Tuple[int, int, int]],
           runtime: List[Tuple[str, int, int, int]],
           program: Dict, t0_ns: int, t1_ns: int,
           harness: List[Tuple[str, int, int]],
           other_span: str = "harness bookkeeping") -> Dict:
    """The table above: ``{"spans": {name: row}, "outside": {name: row},
    "counters", "window_ms", "device_ms", "idle_ms", "launches"}``, a row
    being ``{"launches", "device_ms", "idle_ms": {gap class: ms}}`` and,
    for a span, ``calls`` and ``host_self_ms``."""
    sp = program["spans"]
    names = [s[0] for s in sp]
    # a span still open when recording ended runs to the window's close
    iv = [(s[1], s[2] if s[2] >= 0 else t1_ns) for s in sp]
    child_ns = [0] * len(sp)
    for s, (a, b) in zip(sp, iv):
        if s[3] >= 0:
            child_ns[s[3]] += b - a
    rows: Dict[str, Dict] = {}
    outside: Dict[str, Dict] = {}

    def span_row(name: str) -> Dict:
        return rows.setdefault(name, dict(_row(), calls=0,
                                          host_self_ms=0.0))

    for name, (a, b), c in zip(names, iv, child_ns):
        if t0_ns <= a < t1_ns:
            r = span_row(name)
            r["calls"] += 1
            r["host_self_ms"] += (b - a - c) * 1e-6
    hs = sorted(harness, key=lambda h: h[1])
    h_iv = [(h[1], h[2]) for h in hs]

    def row_at(points: List[int]) -> List[Dict]:
        """The row each point falls to: the innermost program span open
        there, else the harness's span, else ``other_span``."""
        return [span_row(names[i]) if i >= 0 else outside.setdefault(
                    hs[h][0] if h >= 0 else other_span, _row())
                for i, h in zip(_innermost(iv, points),
                                _innermost(h_iv, points))]

    clipped = [(max(s, t0_ns), min(e, t1_ns), c) for s, e, c in device
               if e > t0_ns and s < t1_ns]
    ran = {c for _, _, c in device}
    # a launch: the first API call of each correlation id the device ran
    first: Dict[int, int] = {}
    for _, s, _, c in runtime:
        if c in ran and t0_ns <= s < t1_ns and s < first.get(c, t1_ns):
            first[c] = s
    launched = sorted(first, key=first.__getitem__)
    launch_row = dict(zip(launched, row_at([first[c] for c in launched])))
    for r in launch_row.values():
        r["launches"] += 1
    for s, e, c in clipped:
        r = launch_row.get(c) or outside.setdefault(NO_LAUNCH, _row())
        r["device_ms"] += (e - s) * 1e-6

    busy = _union([(s, e) for s, e, _ in clipped])
    gaps, prev = [], t0_ns
    for s, e in busy + [(t1_ns, t1_ns)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    for (gs, ge), r in zip(gaps, row_at([g[0] for g in gaps])):
        r["idle_ms"][_gap_class((ge - gs) * 1e-9)] += (ge - gs) * 1e-6

    return {"window_ms": (t1_ns - t0_ns) * 1e-6,
            "device_ms": sum(e - s for s, e, _ in clipped) * 1e-6,
            "idle_ms": sum(ge - gs for gs, ge in gaps) * 1e-6,
            "launches": len(launched),
            "spans": rows, "outside": outside,
            "counters": dict(program["counters"])}


def split(table: Dict) -> Dict[str, float]:
    """Launches, idle ms by group of spans (``IDLE``, and ``outside`` for
    the harness's own) and device ms by group (``DEVICE``), each per 1000
    of the program's ``prompt_tokens``.  A group none of whose spans the
    program opened is left out (a MoE model opens no ``mlp``); the idle
    groups add up to ``idle_ms_per_ktok`` where every span is in one."""
    per = 1000.0 / table["counters"]["prompt_tokens"]
    spans = table["spans"]
    out = {"launches_per_ktok": per * table["launches"],
           "idle_ms_per_ktok": per * table["idle_ms"],
           "device_ms_per_ktok": per * table["device_ms"]}

    def rows(names):
        return [spans[n] for n in names if n in spans]

    for key, names in IDLE.items():
        if rows(names):
            out[f"idle_ms_per_ktok.{key}"] = per * sum(
                sum(r["idle_ms"].values()) for r in rows(names))
    out["idle_ms_per_ktok.outside"] = per * sum(
        sum(r["idle_ms"].values()) for r in table["outside"].values())
    for key, names in DEVICE.items():
        if rows(names):
            out[f"device_ms_per_ktok.{key}"] = per * sum(
                r["device_ms"] for r in rows(names))
    return out


class TracedExecutor:
    """The executor the loop and the check drive, with the program's
    recorder and a device trace (``torch.profiler``, CUDA activity alone,
    as ``devtrace.traced``) on over the window: both start at the first
    request of the window (the warm-up's rids are negative) and end at
    the first slot read back (``export_slot``), which the check does once
    the window has closed.  The window here runs from that first request
    to the end of the last; each request is a harness span named as the
    loop names it.  The table goes to ``sink``; ending fails where the
    program's ``prompt_tokens`` is not the sum of the requests' lengths."""

    def __init__(self, inner, sink: List[Dict], device_trace: bool = True):
        self.inner, self.sink, self.device_trace = inner, sink, device_trace
        self.prof = None
        self.on = self.done = False
        self.harness: List[Tuple[str, int, int]] = []
        self.tokens = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill_request(self, req, prompt) -> None:
        window = req.rid >= 0 and not self.done
        if window and not self.on:
            self._start()
        s = time.time_ns()
        self.inner.prefill_request(req, prompt)
        e = time.time_ns()
        if window:
            self.harness.append((HARNESS_SPAN, s, e))
            self.tokens += int(req.prompt_len)

    def export_slot(self, rid: int) -> Dict:
        if self.on:
            self.finish()
        return self.inner.export_slot(rid)

    def _start(self) -> None:
        from repro_torch import spans
        if self.device_trace:
            import torch
            act = torch.profiler.ProfilerActivity
            self.prof = torch.profiler.profile(activities=[act.CUDA])
            self.prof.start()
        spans.start()
        self.on = True

    def finish(self) -> None:
        from repro_torch import spans
        taken = spans.take()
        device, runtime = [], []
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            self.prof.stop()
            device, runtime = correlated_records(
                self.prof.profiler.kineto_results.events())
            self.prof = None
        self.on, self.done = False, True
        # what the window recorded, for a test of the two clocks
        self.taken, self.runtime = taken, runtime
        counted = taken["counters"].get("prompt_tokens", 0)
        if counted != self.tokens:
            raise RuntimeError(f"the program counted {counted} prompt "
                               f"tokens in the window, the harness "
                               f"{self.tokens}")
        self.sink.append(reduce(device, runtime, taken,
                                self.harness[0][1], self.harness[-1][2],
                                self.harness))


def traced_executor(sink: List[Dict]):
    """A ``run.run_cell`` executor factory: the port's executor under
    ``TracedExecutor``, its table appended to ``sink``; on the CPU
    without a device trace."""
    from portbench.run import port_executor

    def make(cfg, params, bundles, sv, dev):
        return TracedExecutor(port_executor(cfg, params, bundles, sv, dev),
                              sink, dev.type == "cuda")
    return make


def main(argv=None) -> int:
    from portbench import spec
    from portbench.run import forbidden_modules, run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window; the benchmark's run_seconds unless "
                         "given")
    args = ap.parse_args(argv)
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cell = spec.load_cell(args.workload, bench)
    seconds = args.seconds or float(bench["run_seconds"])
    sink: List[Dict] = []
    res = run_cell(cell, args.seed, seconds, False, "cuda",
                   executor=traced_executor(sink))
    (table,) = sink
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "correct": res["correct"],
                      "attempted": res["attempted"],
                      "metrics": res["metrics"], "device": res["device"],
                      "split": split(table), "program_trace": table}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
