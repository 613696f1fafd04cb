"""Live-migration policies over the :meth:`Fleet.migrate` primitive (the
port's copy of ``serving/migration.py``).

The primitive (router.py / engine.py / resources.py) checkpoints a running
request's KV, ships it wire-quantized over the contended fabric, and
re-admits it on the target replica token-exactly.  This module decides
WHEN to use it:

* **Preempt-and-migrate for priority tenants** — a ready high-priority
  request stuck behind a full batch evicts the lowest-priority running
  victim (:meth:`Scheduler.pick_victim
  <repro_torch.serving.scheduler.Scheduler.pick_victim>`), which is rehomed on
  the least-loaded surviving replica instead of being parked.
* **Instant scale-down** — ``retire_decode`` events and autoscaler
  shrink decisions pass ``migrate=True`` to :meth:`Fleet.retire_replica
  <repro_torch.serving.router.Fleet.retire_replica>`: the retired replica is
  emptied at retire time, so its budget slice frees immediately instead
  of after the drain tail (the `benchmarks/migration.py` acceptance
  cell).
* **Affinity defragmentation** — after membership or lifecycle churn
  re-homes an adapter/cluster, queued stragglers sitting on the wrong
  replica are migrated back to their sticky home, restoring pinned-base
  locality.  The move respects the router's bounded-spill guard, so
  defrag never re-creates the hot spot spill existed to break.
* **Page-pressure relief** — engines running ``kv_reserve="on_demand"``
  call ``on_preempt`` when mid-decode growth exhausts the pool;
  :meth:`MigrationPolicy.wire` routes the victim to another replica
  instead of the engine's local host-swap fallback.

All policies cap a single request's total moves
(``max_moves_per_request``): a bounced request eventually becomes
un-evictable and runs to completion — preemption never starves the
victim (invariant M5, ``tests/test_migration.py``).
"""
from __future__ import annotations

import dataclasses

from .request import Request
from .router import Fleet


@dataclasses.dataclass
class MigrationConfig:
    preempt_priority: bool = True    # priority tenants preempt-and-migrate
    migrate_on_retire: bool = True   # instant scale-down on retire events
    defrag: bool = True              # post-churn affinity defragmentation
    # starvation guard (M5): a request moved this many times (migrations +
    # preemptions) is no longer an eligible victim anywhere
    max_moves_per_request: int = 3
    # defrag churn bound: stragglers moved home per decision window
    defrag_max_per_window: int = 8


class MigrationPolicy:
    """Window-driven migration decisions; plugs into ``run_study`` as the
    ``migration`` hook and wires every engine's ``on_preempt``."""

    def __init__(self, cfg: MigrationConfig = None):
        self.cfg = cfg or MigrationConfig()
        self.fleet: Fleet = None

    # -- wiring -------------------------------------------------------------
    def attach(self, fleet: Fleet) -> None:
        """Bind to a fleet: page-pressure preemptions on every current
        replica rehome their victim through :meth:`Fleet.migrate` (the
        driver calls :meth:`wire` again for replicas added later)."""
        self.fleet = fleet
        for eng in fleet.engines:
            self.wire(eng)

    def wire(self, eng) -> None:
        eng.on_preempt = self._rehome

    def _rehome(self, victim: Request) -> bool:
        """``on_preempt`` handler: migrate `victim` off its replica.
        Declines (False -> engine falls back to a local host swap) when
        the fleet has nowhere else active or the victim hit its move cap."""
        fleet = self.fleet
        src = fleet.assignments.get(victim.rid, victim.replica)
        others = [i for i in fleet._active_idxs() if i != src]
        if not others:
            return False
        if victim.migrations + victim.preemptions \
                > self.cfg.max_moves_per_request:
            return False
        target = fleet._least_outstanding(others)
        fleet.migrate(victim, target, fleet.engines[src].clock)
        fleet.migration.n_preempt_migrations += 1
        return True

    # -- per-window hook ----------------------------------------------------
    def on_window(self, fleet: Fleet, t: float) -> None:
        if self.fleet is None:
            self.attach(fleet)
        if self.cfg.preempt_priority:
            self._preempt_for_priority(t)
        if self.cfg.defrag:
            self._defrag(t)

    def _preempt_for_priority(self, t: float) -> None:
        """On each replica whose batch is full while a strictly
        higher-priority request is ready, evict the lowest-priority
        victim (move-capped, M5) and rehome it on the least-loaded OTHER
        replica — the slot frees for the priority tenant at the next
        admission, the victim resumes elsewhere instead of queueing."""
        fleet = self.fleet
        idxs = fleet._active_idxs()
        if len(idxs) < 2:
            return
        for i in idxs:
            eng = fleet.engines[i]
            while len(eng.running) >= eng.cfg.scheduler.max_batch:
                ready = [r for r in eng.waiting if r.ready_time <= t]
                if not ready:
                    break
                top = max(r.priority for r in ready)
                victim = eng.scheduler.pick_victim(
                    eng.running, below_priority=top,
                    max_moves=self.cfg.max_moves_per_request)
                if victim is None:
                    break
                victim.preemptions += 1
                eng.stats.n_preempted += 1
                fleet.migrate(victim, fleet._least_outstanding(
                    [k for k in idxs if k != i]), t)
                fleet.migration.n_preempt_migrations += 1

    def _defrag(self, t: float) -> None:
        """Migrate queued stragglers back to their sticky affinity home.

        After churn (a retire re-homed a cluster, spill scattered a
        burst, an adapter retired and re-registered), an adapter's queued
        requests can sit on a replica that no longer matches
        ``Fleet._home`` — decoding there cold-starts a cache the home
        replica already has warm.  Only WAITING requests move (running
        ones finish where their KV is); the spill bound is re-checked so
        defrag never pushes load back onto an overloaded home."""
        fleet = self.fleet
        if fleet.cfg.policy not in ("adapter_affinity", "cluster_affinity"):
            return
        moved = 0
        idxs = fleet._active_idxs()
        slack = fleet.cfg.spill_requests * fleet._avg_request_work()
        for i in idxs:
            for req in list(fleet.engines[i].waiting):
                if moved >= self.cfg.defrag_max_per_window:
                    return
                home = fleet._home.get(fleet._affinity_key(req))
                if home is None or home == i or not fleet.active[home]:
                    continue
                if req.migrations + req.preemptions \
                        >= self.cfg.max_moves_per_request:
                    continue
                lightest = min(idxs,
                               key=lambda k: (fleet._routed_load[k], k))
                if fleet._routed_load[home] \
                        - fleet._routed_load[lightest] > slack:
                    continue         # home is hot again: spill stands
                fleet.migrate(req, home, t)
                fleet.migration.n_defrag_migrations += 1
                moved += 1
