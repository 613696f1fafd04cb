"""One-answer traffic: each request is one prompt on one adapter and needs
one answer token, served alone by the executor's ``prefill_request``
(a fresh one-slot cache a call, spliced into a free slot of the executor's
cache, the answer token read back to the host).

A FIFO queue in this loop stands in for the engine's admission (whose
step always runs a decode step after admitting).  A backlog takes request
after request until ``seconds`` have passed; the window closes when the
last one started has answered.  An open loop serves each request at its
due time or, behind a queue, as soon as the one before has answered;
every request due in the window is served, for up to ``DRAIN_S`` past its
close, and one not served by then is missing.

Of the answered requests, 6 drawn from the seed (a reservoir) and the
longest so far keep their slots, so that the K/V rows each call wrote can
be read back (``export_slot``) once the window has closed; every other
slot is released as soon as its answer is in.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.serving.request import Request

DRAIN_S = 60.0
RESERVOIR = 6           # with the longest, 7 of the executor's 8 slots
SPIN_S = 0.002          # an arrival closer than this is waited for awake


class Holder:
    """Which answered requests keep their slots: a reservoir sample of
    ``RESERVOIR`` drawn from ``rng``, and the longest answered so far."""

    def __init__(self, rng: np.random.Generator):
        self.rng, self.res, self.seen = rng, [], 0
        self.longest, self.longest_len = None, -1

    def held(self) -> List[int]:
        return sorted(set(self.res) | ({self.longest} - {None}))

    def offer(self, rid: int, length: int) -> List[int]:
        """Take answered request ``rid``; returns the rids whose slots are
        to be released now."""
        before = set(self.held())
        if len(self.res) < RESERVOIR:
            self.res.append(rid)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < RESERVOIR:
                self.res[j] = rid
        self.seen += 1
        if length > self.longest_len:
            self.longest, self.longest_len = rid, length
        after = set(self.held())
        return sorted((before | {rid}) - after)


def serve(ex, sched, prompts, adapters, seconds: float, arrival: str,
          rng: np.random.Generator) -> Dict:
    """Drive ``ex`` with the mix; returns the requests (times in seconds
    from the window's opening), the held rids and the harness's spans
    (name, start_ns, end_ns) on the system clock, the profiler's."""
    holder = Holder(rng)
    reqs: List[Dict] = []
    spans = []
    n = len(sched.lengths)
    # a monotonic clock, put on the system clock's scale once
    off = time.time_ns() - time.perf_counter_ns()
    t0 = time.perf_counter_ns()

    def now_s():
        return (time.perf_counter_ns() - t0) * 1e-9

    i = 0
    while i < n:
        due = float(sched.due_s[i])
        now = now_s()
        if arrival == "backlog":
            if now >= seconds:
                break
        elif due > seconds or now > seconds + DRAIN_S:
            break
        if now < due:
            w0 = time.perf_counter_ns()
            while (left := due - now_s()) > 0:
                if left > SPIN_S:
                    time.sleep(left - SPIN_S)
            spans.append(("waiting for an arrival", w0 + off,
                          time.perf_counter_ns() + off))
        length = int(sched.lengths[i])
        req = Request(rid=i, adapter_id=int(adapters[i]), prompt_len=length,
                      max_new_tokens=1, arrival_time=due)
        s_ns = time.perf_counter_ns()
        ex.prefill_request(req, prompts[i])
        e_ns = time.perf_counter_ns()
        spans.append(("inside prefill_request", s_ns + off, e_ns + off))
        token = int(ex.slot_tokens[ex.slot_req.index(i)])
        reqs.append({"i": i, "due": due, "start": (s_ns - t0) * 1e-9,
                     "end": (e_ns - t0) * 1e-9, "tokens": length,
                     "served": token})
        for rid in holder.offer(i, length):
            ex.release(rid)
        i += 1
    t1 = time.perf_counter_ns()
    if arrival == "backlog" and i == n and (t1 - t0) * 1e-9 < seconds:
        raise RuntimeError(f"the mix's {n} requests ran out before "
                           f"{seconds} s: raise its schedule_len")
    missing = 0
    if arrival != "backlog":
        due_in = int(np.searchsorted(sched.due_s, seconds, side="right"))
        for j in range(i, due_in):
            reqs.append({"i": j, "due": float(sched.due_s[j]), "start": None,
                         "end": None, "tokens": int(sched.lengths[j]),
                         "served": None})
            missing += 1
    return {"requests": reqs, "held": holder.held(), "missing": missing,
            "t0_ns": t0 + off, "t1_ns": t1 + off,
            "window_s": (t1 - t0) * 1e-9, "spans": spans}
