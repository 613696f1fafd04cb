"""Host spans and counters of the port's serving path, off by default.

A span marks one block of host code: the executor's ``prefill_request``
and its steps, and in each layer the attention, the adapter deltas and
the MLP.  Each records its name, its start and end, its parent (the span
open around it) and the request it serves (the ``rid`` of the enclosing
``prefill_request``).  A counter adds up a quantity at the place where
the work happens (``prompt_tokens``).

    from repro_torch import spans
    spans.start()
    ...                       # the code under study
    taken = spans.take()      # {"spans": [Span, ...], "counters": {...}}

While recording is off, :func:`span` returns one shared object whose
``__enter__`` and ``__exit__`` do nothing, and :func:`count` returns at
once: a call site costs a global check and two empty method calls.
While it is on, spans go to flat lists in memory, written out only by
:func:`take`.

Spans are stamped with ``time.perf_counter_ns()`` (monotonic) and put on
the system clock's nanoseconds by :func:`take`, the scale of
``torch.profiler``'s records, through a straight line fitted to two
readings of both clocks, one at :func:`start` and one at :func:`take`:
a line through both follows the system clock's slew over the recording.

Nothing here imports torch: the module is the standard library alone.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

_PAIR_TRIES = 5


class Span(NamedTuple):
    name: str
    start_ns: int           # system clock, after take()
    end_ns: int
    parent: int             # index in the list of spans; -1 for a root
    rid: Optional[int]      # the enclosing prefill_request's rid


class _Off:
    """The span handed out while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self):
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.parents: List[int] = []
        self.rids: List[Optional[int]] = []
        self.stack: List[int] = []
        self.counters: Dict[str, int] = {}
        self.pair0 = clock_pair()


class _On:
    """One span while recording is on."""

    __slots__ = ("rec", "name", "rid", "i")

    def __init__(self, rec: _Recorder, name: str, rid: Optional[int]):
        self.rec, self.name, self.rid = rec, name, rid

    def __enter__(self):
        r = self.rec
        parent = r.stack[-1] if r.stack else -1
        rid = self.rid
        if rid is None and parent >= 0:
            rid = r.rids[parent]
        self.i = len(r.names)
        r.names.append(self.name)
        r.parents.append(parent)
        r.rids.append(rid)
        r.ends.append(-1)
        r.stack.append(self.i)
        r.starts.append(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        r = self.rec
        r.ends[self.i] = time.perf_counter_ns()
        r.stack.pop()
        return False


_rec: Optional[_Recorder] = None


def span(name: str, rid: Optional[int] = None):
    """A context manager marking a block as span ``name``; ``rid`` names
    the request of it and of its children (by default its parent's)."""
    if _rec is None:
        return _OFF
    return _On(_rec, name, rid)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` (nothing while recording is off)."""
    if _rec is None:
        return
    c = _rec.counters
    c[name] = c.get(name, 0) + n


def clock_pair():
    """(perf_counter_ns, time_ns) read as close together as this host
    allows: the system clock between two monotonic readings, the
    tightest of a few tries, the monotonic one at their middle."""
    best = None
    for _ in range(_PAIR_TRIES):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


def clock_map(pair0, pair1):
    """The straight line through two (perf_counter_ns, time_ns) readings,
    as a function from the first clock's nanoseconds to the second's
    (integers: the system clock's nanoseconds need more bits than a
    float holds)."""
    (p0, w0), (p1, w1) = pair0, pair1
    slope = (w1 - w0) / (p1 - p0) if p1 != p0 else 1.0

    def to_wall(p: int) -> int:
        return w0 + round((p - p0) * slope)

    return to_wall


def start() -> None:
    """Begin recording (what an earlier recording held is dropped)."""
    global _rec
    _rec = _Recorder()


def take() -> Optional[Dict]:
    """End recording; returns ``{"spans": [Span], "counters": {name: n}}``
    with the spans on the system clock's nanoseconds (a span still open
    has ``end_ns`` -1), or None when nothing was recording."""
    global _rec
    r, _rec = _rec, None
    if r is None:
        return None
    to_wall = clock_map(r.pair0, clock_pair())
    out = [Span(n, to_wall(s), to_wall(e) if e >= 0 else -1, p, rid)
           for n, s, e, p, rid in zip(r.names, r.starts, r.ends,
                                      r.parents, r.rids)]
    return {"spans": out, "counters": dict(r.counters)}
