"""The program's spans on the device trace's clock, on the card: a run of
the dense smoke cell under ``progtrace.TracedExecutor``.  Marked ``gpu``;
whether a card is there is decided in the fixture.

    PYTHONPATH=src python -m pytest -q -s -m gpu portbench/tests
"""
import bisect

import pytest

from portbench import progtrace
from portbench.run import port_executor, run_cell
from portbench.tests.smoke import smoke_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def test_program_trace_on_the_card(cuda):
    """Every CUDA API call the window recorded lies inside a
    ``prefill_request`` span (the harness makes none between requests),
    within 20 us, near the window's start and near its end; the device ms
    put down to spans are at most the window's, and the idle of the rows
    is the window's."""
    sink, made = [], []

    def make(*args):
        made.append(progtrace.TracedExecutor(port_executor(*args), sink))
        return made[-1]

    res = run_cell(smoke_cell("dense"), 2**31 + 11, 5.0, False, cuda,
                   t_start=0.0, executor=make)
    assert res["correct"], res["checks"]
    (pt,) = sink
    rows = list(pt["spans"].values()) + list(pt["outside"].values())
    assert sum(sum(r["idle_ms"].values()) for r in rows) == pytest.approx(
        pt["idle_ms"], rel=1e-9)
    assert sum(r["device_ms"] for r in rows) <= pt["device_ms"] * (1 + 1e-9)
    assert 0 < pt["device_ms"] < pt["window_ms"]
    assert pt["launches"] > 0
    for name in ("adapter", "attention_core", "mlp"):
        assert pt["spans"][name]["launches"] > 0, name
        assert pt["spans"][name]["device_ms"] > 0, name
    print(progtrace.split(pt))

    ex = made[-1]
    t0, t1 = ex.harness[0][1], ex.harness[-1][2]
    roots = sorted((s.start_ns, s.end_ns) for s in ex.taken["spans"]
                   if s.name == "prefill_request")
    starts = [a for a, _ in roots]

    def outside_ns(s, e):
        """How far the call [s, e] reaches out of the nearer of the two
        request spans around its start."""
        k = bisect.bisect_right(starts, s) - 1
        return min(max(0, roots[j][0] - s, e - roots[j][1])
                   for j in (k, k + 1) if 0 <= j < len(roots))

    tenth = (t1 - t0) // 10
    calls = sorted(r[1:3] for r in ex.runtime if t0 <= r[1] < t1)
    call_starts = [s for s, _ in calls]

    def worst_and_slack(lo, hi):
        """Over the requests that begin in [lo, hi): the farthest a call
        reaches out of its request's span, and the least room from a span's
        start to its first call and from its last call to its end."""
        worst, room = 0, []
        for a, b in roots:
            if lo <= a < hi:
                mine = calls[bisect.bisect_left(call_starts, a):
                             bisect.bisect_left(call_starts, b)]
                if mine:
                    room.append((mine[0][0] - a,
                                 b - max(e for _, e in mine)))
        for s, e in calls:
            if lo <= s < hi:
                worst = max(worst, outside_ns(s, e))
        assert room
        return (worst, min(r for r, _ in room), min(r for _, r in room))

    first = worst_and_slack(t0, t0 + tenth)
    last = worst_and_slack(t1 - tenth, t1)
    print(f"{len(calls)} calls; (farthest out of their request's span, "
          f"least room after its start, before its end), us: first tenth "
          f"{tuple(v / 1e3 for v in first)}, last tenth "
          f"{tuple(v / 1e3 for v in last)}")
    assert first[0] <= 20_000 and last[0] <= 20_000
    assert max(outside_ns(s, e) for s, e in calls) <= 20_000
