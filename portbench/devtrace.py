"""The device trace of a window: ``torch.profiler`` with CUDA activity alone
(CUPTI's kernel, copy and set records; no CPU operator records, whose
cost per operator would make the host the bottleneck of the traced run),
kept in memory and read once from its raw events.  Nothing is written to
disk.

The grouping of device time is a frozen copy of the port's
``launch/profile_decode.py``: kernels whose names carry a GEMM word are
matrix products, the rest (softmax, masks, casts, norms, rope, routing,
copies and sets) are "other".  Idle time is the window less the union of
the device's intervals, and each idle gap is put down to what the harness
was doing when it began (its own spans, on the same clock as the
profiler's records: nanoseconds of the system clock).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

GEMM_WORDS = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96
TOP = 10
# idle gaps by length, so that many short gaps (launch-bound host) and a
# few long ones (host stalls) read apart
GAP_CLASSES = ((1e-5, "under 10 us"), (1e-4, "10-100 us"),
               (1e-3, "0.1-1 ms"), (float("inf"), "over 1 ms"))


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(w in low for w in GEMM_WORDS)


@contextlib.contextmanager
def traced(enabled: bool):
    """Yields a holder whose ``events`` is, after the block, the list of
    device records ``(name, start_ns, end_ns)`` (empty when disabled)."""
    holder = _Holder()
    if not enabled:
        yield holder
        return
    import torch
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(activities=[act.CUDA])
    prof.start()
    try:
        yield holder
    finally:
        torch.cuda.synchronize()
        prof.stop()
    holder.events = device_events(prof.profiler.kineto_results.events())


class _Holder:
    def __init__(self):
        self.events: List[Tuple[str, int, int]] = []


def device_events(raw) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every kernel, copy and set: the records
    on the device, less annotations where the record names its kind
    (torch 2.13 does; with CUDA activity alone and no annotations, the
    device's records are these three kinds anyway)."""
    from torch.autograd import DeviceType
    out = []
    for e in raw:
        if e.device_type() != DeviceType.CUDA:
            continue
        kind = getattr(e, "activity_type", None)
        if kind is not None and kind() not in DEVICE_ACTIVITIES:
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _gap_class(seconds: float) -> str:
    for limit, label in GAP_CLASSES:
        if seconds < limit:
            return label
    return GAP_CLASSES[-1][1]


def summarize(events: List[Tuple[str, int, int]], t0_ns: int, t1_ns: int,
              spans: List[Tuple[str, int, int]],
              other_span: str = "harness bookkeeping") -> Optional[Dict]:
    """Device busy time, GEMM and other device seconds, the top device
    operations and the idle gaps by harness span, over [t0_ns, t1_ns].
    ``spans`` are the harness's (name, start_ns, end_ns), not
    overlapping; a gap that starts outside every span is put down to
    ``other_span``.  None when the window holds no device record."""
    clipped = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in events
               if e > t0_ns and s < t1_ns]
    if not clipped:
        return None
    by_name: Dict[str, float] = {}
    for n, s, e in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    gemm = sum(v for n, v in by_name.items() if is_gemm(n))
    busy_iv = _union([(s, e) for _, s, e in clipped])
    busy = sum(e - s for s, e in busy_iv) * 1e-9
    gaps, prev = [], t0_ns
    for s, e in busy_iv + [(t1_ns, t1_ns)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans = sorted(spans, key=lambda sp: sp[1])
    idle: Dict[str, float] = {}
    j = 0
    for gs, ge in gaps:
        while j < len(spans) and spans[j][2] <= gs:
            j += 1
        name = spans[j][0] if j < len(spans) and spans[j][1] <= gs \
            else other_span
        sec = (ge - gs) * 1e-9
        key = f"{name}, gaps {_gap_class(sec)}"
        idle[key] = idle.get(key, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "busy_s": busy,
        "gemm_s": gemm,
        "other_s": sum(by_name.values()) - gemm,
        "device_ops": [[n[:NAME_CHARS], v] for n, v in top],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
        "records": len(clipped),
    }
