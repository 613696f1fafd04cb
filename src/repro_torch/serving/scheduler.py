"""Continuous-batching scheduler with adapter-aware and cluster-aware
admission (§6.4 + the paper's "clustering offers opportunities for efficient
scheduling" direction in §7).

Policy:
  1. running requests keep their decode slot unless explicitly preempted
     (:meth:`Scheduler.pick_victim` — mid-decode page exhaustion or a
     higher-priority tenant via the live-migration machinery,
     serving/migration.py; the default priority-0 stream never preempts);
  2. free slots admit waiting requests, highest `Request.priority` first,
     then preferring (a) adapters already resident, (b) adapters whose
     *cluster* basis is resident (compressed mode), (c) FIFO otherwise;
  3. per-batch distinct-adapter cap models the SGMV tile-efficiency limit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .request import Request


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 32              # decode slots
    max_adapters_per_batch: int = 32
    cluster_aware: bool = True


class Scheduler:
    def __init__(self, cfg: SchedulerConfig,
                 cluster_of: Optional[Dict[int, int]] = None):
        self.cfg = cfg
        self.cluster_of = cluster_of or {}

    def admit(self, running: List[Request], waiting: List[Request],
              resident: set, now: float) -> List[Request]:
        """Pick waiting requests to admit into free slots."""
        free = self.cfg.max_batch - len(running)
        if free <= 0 or not waiting:
            return []
        active_adapters = {r.adapter_id for r in running}
        active_clusters = {self.cluster_of.get(a) for a in active_adapters}

        def score(req: Request):
            resident_hit = req.adapter_id in resident
            same_adapter = req.adapter_id in active_adapters
            same_cluster = (self.cfg.cluster_aware and
                            self.cluster_of.get(req.adapter_id)
                            in active_clusters)
            # lower = better; priority dominates (all-zero priorities —
            # every pre-migration workload — leave the order unchanged),
            # then FIFO tiebreak by decode-readiness (equals the arrival
            # time for colocated serving)
            return (-req.priority, not same_adapter, not resident_hit,
                    not same_cluster, req.ready_time)

        ready = [r for r in waiting if r.ready_time <= now]
        ready.sort(key=score)
        admitted: List[Request] = []
        adapters = set(active_adapters)
        for r in ready:
            if len(admitted) >= free:
                break
            if r.adapter_id not in adapters and \
                    len(adapters) >= self.cfg.max_adapters_per_batch:
                continue
            adapters.add(r.adapter_id)
            admitted.append(r)
        return admitted

    @staticmethod
    def pick_victim(running: Sequence[Request],
                    below_priority: Optional[int] = None,
                    protect: Sequence[int] = (),
                    max_moves: Optional[int] = None) -> Optional[Request]:
        """Choose which running request to preempt, or None if nobody may
        be.  Eligibility: rid not in `protect`, priority strictly below
        `below_priority` (None = any), and fewer than `max_moves` prior
        evictions — the cap is the starvation guard (invariant M5): a
        request bounced `max_moves` times keeps its slot for good, so
        every victim eventually runs to completion.  Among the eligible,
        the victim is the lowest-priority request, ties broken by the
        smallest KV footprint (cheapest checkpoint to ship), then rid."""
        safe = set(protect)
        cands = [r for r in running
                 if r.rid not in safe
                 and (below_priority is None or r.priority < below_priority)
                 and (max_moves is None
                      or r.migrations + r.preemptions < max_moves)]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority,
                                         r.prompt_len + r.generated, r.rid))

    @staticmethod
    def group_by_adapter(batch: Sequence[Request]) -> Dict[int, List[Request]]:
        groups: Dict[int, List[Request]] = {}
        for r in batch:
            groups.setdefault(r.adapter_id, []).append(r)
        return groups
