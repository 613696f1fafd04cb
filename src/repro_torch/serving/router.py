"""Fleet-level serving: N engine replicas behind a pluggable router (the
port's copy of ``serving/router.py``).

The paper serves one replica; production serves fleets, and under skewed
adapter popularity the *routing policy* decides how much pinned-base reuse
each replica gets (S-LoRA §6; arXiv:2511.22880).  Policies:

  "round_robin"        — classic stateless spread.
  "least_outstanding"  — route to the replica with the fewest queued+running
                         requests at arrival time (live state: the fleet
                         advances each replica's simulated clock to the
                         arrival before deciding).
  "adapter_affinity"   — sticky adapter -> replica map; repeat requests for
                         an adapter land where it is already warm.
  "cluster_affinity"   — sticky JD-cluster -> replica map; co-locates
                         adapters sharing a compressed basis so each replica
                         streams few shared bases and maximizes pinned-base
                         reuse.  Bounded work-balance spill (route to the
                         least-loaded replica once the home replica is more
                         than `spill_requests` requests' worth of work ahead
                         of the lightest) prevents hot clusters from
                         hot-spotting the fleet under Zipf skew.

All policies are deterministic given the request stream.

Two orthogonal production extensions on top of the policies:

  * **Disaggregated prefill** — pass a
    :class:`~repro_torch.serving.prefill.PrefillTier`: requests are routed
    prefill-tier-first (the tier stamps ``decode_ready_time`` via the
    shared :class:`~repro_torch.serving.resources.KVFabric` — first chunk landed),
    then placed on decode replicas with the configured policy; decode
    engines admit a request only once enough of its KV has landed.
  * **Cross-tier adapter prefetch** — with
    ``FleetConfig.cross_tier_prefetch`` a request entering prefill hints
    its routed decode replica's :meth:`AdapterCache.prefetch` at prefill
    ADMISSION time: the adapter's background load overlaps the prefill
    compute and KV transfer, so it is warm when decode admits the request
    (hints are low priority — they never evict and never delay a demand
    load).
  * **Elastic membership** — :meth:`add_replica` / :meth:`retire_replica`
    let an autoscaler grow/shrink the decode tier mid-stream.  Retired
    replicas drain their queue but receive no new work; membership changes
    re-home JD clusters (sticky affinity maps are rebuilt against the new
    active set on next sighting).  The prefill tier has the symmetric
    operations (``PrefillTier.add_worker`` / ``retire_worker``), so a joint
    autoscaler can trade capacity between the tiers under one fixed
    :class:`~repro_torch.serving.resources.HardwareBudget`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from .engine import CostModelExecutor, ServingEngine
from .prefill import PrefillTier
from .request import Request, ServeStats, weight_key
from .resources import (FabricConfig, KVFabric, MigrationTicket,
                        kv_bytes_per_token, merge_mode_dict)

POLICIES = ("round_robin", "least_outstanding", "adapter_affinity",
            "cluster_affinity")


def rank_efficiency(rank: int, tile_rank: int = 8) -> float:
    """Useful fraction of the SGMV rank lanes a rank-`rank` adapter
    occupies on a slice whose native contraction tile is `tile_rank` wide:
    ``rank / (tile_rank * ceil(rank / tile_rank))``, in (0, 1].

    Torch-free mirror of :func:`repro_torch.kernels.sgmv.sgmv_rank_efficiency`
    (the router must stay importable without torch, the same reason
    PAGE_TOKENS is duplicated); ``tests/test_torch_control_plane.py``
    asserts the two agree (invariant H4)."""
    if rank < 1:
        raise ValueError("rank must be >= 1")
    if tile_rank < 1:
        raise ValueError("tile_rank must be >= 1")
    return rank / (tile_rank * -(-rank // tile_rank))


@dataclasses.dataclass
class FleetConfig:
    n_replicas: int = 1
    policy: str = "round_robin"
    # affinity policies: allowed routed-work imbalance (home vs lightest
    # replica) before a request spills, in units of average request work
    spill_requests: float = 1.0
    # disaggregated serving: route requests through a prefill tier before
    # decode placement (the tier itself is passed to Fleet — it owns
    # executors/caches that FleetConfig cannot describe)
    disaggregated: bool = False
    # cross-tier adapter prefetch: a request entering prefill is a perfect
    # predictor of the adapter its decode replica needs a few hundred ms
    # later, so hint that replica's AdapterCache.prefetch at prefill
    # admission time (low priority: never evicts, never delays demand)
    cross_tier_prefetch: bool = False
    # live migration: the decode→decode interconnect checkpointed
    # KV ships over in a COLOCATED fleet.  Disaggregated fleets ignore
    # this and reuse the prefill tier's contended fabric — migration
    # traffic competes with prefill handoffs for the same wire.  None
    # builds a default FabricConfig lazily on first migration.
    migration_fabric: Optional[FabricConfig] = None
    # rank-aware placement: bias the affinity policies by each
    # replica's rank-efficiency score — decode speed times the SGMV tile
    # efficiency of the request's adapter rank on that replica's slice
    # (rank_efficiency; the torch mirror is kernels/sgmv.py) — so high-rank
    # adapters land on wide-tile slices and skinny ranks on narrow ones.
    # Needs a Fleet built with `rank_of`; off (the default) is bit-exact
    # with the rank-blind router.
    rank_aware: bool = False
    # what a mid-run-attached replica's routed-load estimate starts at:
    # "zero" (legacy — the cold replica compares a full-history backlog
    # against warm peers and hot-spots until it catches up) or
    # "peer_mean" (the mean of its active peers' estimates, so it joins
    # the spill comparison as an average citizen and picks up work as
    # peers pull ahead)
    routed_load_seed: str = "zero"


@dataclasses.dataclass
class MigrationStats:
    """Fleet-level live-migration accounting (every :meth:`Fleet.migrate`),
    including the per-mode wire split so compressed checkpoint traffic is
    auditable against the handoff traffic sharing the same fabric."""

    n_migrations: int = 0            # completed live moves
    n_retire_migrations: int = 0     # moved by instant scale-down
    n_preempt_migrations: int = 0    # moved to make room (pages/priority)
    n_defrag_migrations: int = 0     # moved home by affinity defrag
    migration_time: float = 0.0      # sum of checkpoint -> KV-landed spans
    compress_time: float = 0.0       # wire quantize cost before shipping
    kv_raw_bytes: int = 0            # checkpointed KV across all moves
    kv_wire_bytes: int = 0           # bytes actually shipped
    n_by_mode: Dict[str, int] = dataclasses.field(default_factory=dict)
    wire_bytes_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    raw_bytes_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def empty(self) -> bool:
        return self.n_migrations == 0

    def _bump(self, mode: str, wire: int, raw: int) -> None:
        merge_mode_dict(self.n_by_mode, {mode: 1})
        merge_mode_dict(self.wire_bytes_by_mode, {mode: wire})
        merge_mode_dict(self.raw_bytes_by_mode, {mode: raw})

    def to_dict(self) -> Dict:
        return {
            "n_migrations": self.n_migrations,
            "n_retire_migrations": self.n_retire_migrations,
            "n_preempt_migrations": self.n_preempt_migrations,
            "n_defrag_migrations": self.n_defrag_migrations,
            "migration_time_s": self.migration_time,
            "compress_time_s": self.compress_time,
            "kv_raw_bytes": self.kv_raw_bytes,
            "kv_wire_bytes": self.kv_wire_bytes,
            "n_by_mode": dict(self.n_by_mode),
            "wire_bytes_by_mode": dict(self.wire_bytes_by_mode),
            "raw_bytes_by_mode": dict(self.raw_bytes_by_mode),
        }


@dataclasses.dataclass
class FleetStats:
    total: ServeStats
    per_replica: List[ServeStats]
    prefill: Optional[Dict] = None       # PrefillStats.to_dict() if disagg
    n_replicas_final: Optional[int] = None   # active replicas at drain time
    scale_events: int = 0                # autoscaler membership changes
    autoscaler: Optional[List] = None    # ScaleDecision history if autoscaled
    n_prefill_final: Optional[int] = None    # active prefill workers (joint)
    budget: Optional[Dict] = None        # HardwareBudget.to_dict() (joint)
    lifecycle: Optional[Dict] = None     # LifecycleStats.to_dict() (churn)
    migration: Optional[Dict] = None     # MigrationStats.to_dict()

    def to_dict(self) -> Dict:
        d = self.total.to_dict()
        d["n_replicas"] = len(self.per_replica)
        d["per_replica_rps"] = [s.throughput_rps for s in self.per_replica]
        d["per_replica_n_requests"] = [s.n_requests for s in self.per_replica]
        if self.prefill is not None:
            d.update(self.prefill)
        if self.n_replicas_final is not None:
            d["n_replicas_final"] = self.n_replicas_final
            d["scale_events"] = self.scale_events
        if self.n_prefill_final is not None:
            d["n_prefill_final"] = self.n_prefill_final
        if self.budget is not None:
            d["budget"] = self.budget
        if self.lifecycle is not None:
            d["lifecycle"] = self.lifecycle
        if self.migration is not None:
            d["migration"] = self.migration
        return d


class Fleet:
    """Routes a request stream across replicas and runs them to completion.

    Each replica is an independent :class:`ServingEngine` with its own
    simulated clock; fleet wall time is the slowest replica's clock.
    :meth:`submit` may be called repeatedly with successive arrival
    windows (routing state persists), :meth:`advance_to` steps every
    replica causally to a window boundary, and :meth:`run` drains the
    fleet and merges per-replica stats.  Membership is elastic
    (:meth:`add_replica` / :meth:`retire_replica`); sticky affinity state
    lives in a key -> replica home map that membership changes prune
    *scoped* (:meth:`rehome`) and the adapter lifecycle drains per key
    (:meth:`drop_home`).  `cluster_of` — shared with every replica's
    executor — maps adapter ids to JD clusters for the cluster-affinity
    policy; the lifecycle control plane mutates it in place when adapters
    register or retire, and every reader sees the update.
    """

    def __init__(self, cfg: FleetConfig, engines: Sequence[ServingEngine],
                 cluster_of: Optional[Dict[int, int]] = None,
                 prefill_tier: Optional[PrefillTier] = None,
                 rank_of: Optional[Dict[int, int]] = None):
        if len(engines) != cfg.n_replicas:
            raise ValueError(f"expected {cfg.n_replicas} engines, "
                             f"got {len(engines)}")
        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown policy {cfg.policy!r}; "
                             f"one of {POLICIES}")
        if cfg.routed_load_seed not in ("zero", "peer_mean"):
            raise ValueError(f"routed_load_seed must be 'zero' or "
                             f"'peer_mean', got {cfg.routed_load_seed!r}")
        if cfg.rank_aware and rank_of is None:
            raise ValueError("rank_aware routing needs a rank_of map "
                             "(adapter id -> LoRA rank)")
        if cfg.disaggregated != (prefill_tier is not None):
            raise ValueError("disaggregated fleets need a prefill_tier and "
                             "colocated fleets must not pass one: got "
                             f"disaggregated={cfg.disaggregated}, "
                             f"prefill_tier={prefill_tier!r}")
        self.cfg = cfg
        self.engines = list(engines)
        self.cluster_of = cluster_of or {}
        self.rank_of = rank_of or {}
        self.prefill_tier = prefill_tier
        self.active: List[bool] = [True] * len(engines)
        self._rr = 0
        self._home: Dict[int, int] = {}          # affinity key -> replica
        self._routed_load: List[float] = [0.0] * len(engines)  # est. seconds
        self.assignments: Dict[int, int] = {}    # rid -> replica
        self.scale_events = 0
        self.migration = MigrationStats()
        self._mig_fabric: Optional[KVFabric] = None  # colocated, lazy

    # -- elastic membership -------------------------------------------------
    def _active_idxs(self) -> List[int]:
        return [i for i, a in enumerate(self.active) if a]

    def add_replica(self, engine: ServingEngine, now: float = 0.0) -> int:
        """Join a fresh decode replica at simulated time `now`.

        Existing affinity homes stay valid (the new replica holds none), so
        warm adapters keep their cache locality; the new replica fills up
        through first sightings and bounded spill.

        Its routed-load estimate starts per ``FleetConfig.routed_load_seed``:
        at zero (legacy — against peers carrying a full run's cumulative
        estimate the newcomer looks infinitely light, so every spill and
        first sighting dumps there until it catches up), or at the mean of
        its active peers' estimates (``"peer_mean"`` — it enters the spill
        comparison as an average citizen and starts receiving work within
        a window as peers pull ahead, without the hot-spot)."""
        seed = 0.0
        if self.cfg.routed_load_seed == "peer_mean":
            peers = [self._routed_load[i] for i in self._active_idxs()]
            if peers:
                seed = sum(peers) / len(peers)
        engine.clock = max(engine.clock, now)
        self.engines.append(engine)
        self.active.append(True)
        self._routed_load.append(seed)
        self.scale_events += 1
        return len(self.engines) - 1

    def retire_replica(self, i: int, migrate: bool = False,
                       now: float = 0.0) -> None:
        """Stop routing to replica `i`.

        Drain-based (the default, bit-exact with the pre-migration
        fleet): the replica accepts no new work but runs its queue to
        completion, so its hardware is genuinely free only when the last
        request finishes.  Instant scale-down (``migrate=True``): every
        request still on the replica — running mid-decode or queued — is
        live-migrated to the least-loaded surviving replica at `now`, so
        the replica is EMPTY at retire time and its budget slice can be
        re-allocated immediately instead of after the drain tail."""
        if not self.active[i]:
            return
        if len(self._active_idxs()) == 1:
            raise ValueError("cannot retire the last active replica")
        self.active[i] = False
        self.scale_events += 1
        self.rehome(i)
        if migrate:
            eng = self.engines[i]
            for req in list(eng.running) + list(eng.waiting):
                self.migrate(req, self._least_outstanding(), now)
                self.migration.n_retire_migrations += 1

    def rehome(self, replica: Optional[int] = None) -> None:
        """Drop sticky affinity placements so affected adapters/JD-clusters
        re-place against the current active set on next sighting.

        Scoped to `replica` when given: only keys homed THERE are dropped —
        a membership change must not cold-start the cache locality of
        adapters homed on unrelated replicas (they keep their warm caches).
        With ``replica=None`` every home is dropped (a full re-shuffle,
        e.g. after an offline basis rebuild changes cluster_of wholesale)."""
        if replica is None:
            self._home.clear()
            return
        for key in [k for k, h in self._home.items() if h == replica]:
            del self._home[key]

    def drop_home(self, key: int) -> None:
        """Forget the sticky home for one affinity key (an adapter id, or a
        JD cluster id under ``cluster_affinity``) — the lifecycle's
        retirement drain uses this so a retired adapter stops pinning
        placement state (invariant L5)."""
        self._home.pop(key, None)

    # -- live migration ----------------------------------------------
    def migration_fabric(self) -> KVFabric:
        """The channel checkpointed KV ships over: the prefill tier's
        contended fabric when disaggregated (migrations compete with
        prefill handoffs for the same wire), else a lazily built
        decode→decode fabric from ``FleetConfig.migration_fabric``."""
        if self.prefill_tier is not None:
            return self.prefill_tier.fabric
        if self._mig_fabric is None:
            self._mig_fabric = KVFabric(self.cfg.migration_fabric
                                        or FabricConfig())
        return self._mig_fabric

    def migrate(self, req: Request, target: int, now: float) -> float:
        """Live-migrate `req` to replica `target` at simulated time `now`.

        The source engine checkpoints the request — decode slot vacated,
        KV pages freed immediately (invariant M3) — and the full decoded
        prefix (prompt + every generated token) ships over
        :meth:`migration_fabric` as ONE transfer, wire-quantized by the
        fabric's compression plan exactly like a prefill handoff.  The
        transfer is recorded against a :class:`MigrationTicket
        <repro_torch.serving.resources.MigrationTicket>` rather than the
        request, so the original handoff accounting survives and every
        wire byte is charged exactly once (M2); the stamped values fold
        into the request's cumulative ``mig_*`` counters.  The target
        pays the checkpoint's dequant at re-admission
        (`Request.kv_restore_cost`) and resumes decode at the same
        `generated` position (M1).  The quantize cost is charged to the
        transfer's start, not the source's decode clock — the source is
        shedding this request, its remaining batch must not stall.  The
        target's adapter cache is hinted through
        :meth:`AdapterCache.prefetch
        <repro_torch.serving.adapter_cache.AdapterCache.prefetch>`, which
        dedupes against residency and in-flight hints, so a stale hint
        for the source (or a repeat migration) never double-loads (M4).
        Returns the time decode may resume on the target (the first wire
        chunk's landing; `now` for zero-KV moves)."""
        source = self.assignments.get(req.rid, req.replica)
        if source is None:
            raise ValueError(f"request {req.rid} was never routed")
        if source == target:
            raise ValueError(f"request {req.rid} is already on {target}")
        if not self.active[target]:
            raise ValueError(f"cannot migrate to retired replica {target}")
        src_eng, dst_eng = self.engines[source], self.engines[target]
        nbytes = src_eng.checkpoint(req)
        src_eng.stats.n_migrated_out += 1
        dst_eng.cache.prefetch(
            weight_key(req), dst_eng.executor.adapter_bytes(req.adapter_id),
            now)
        if nbytes > 0:
            fabric = self.migration_fabric()
            tokens = req.prompt_len + req.generated
            ticket = MigrationTicket(rid=req.rid, prompt_len=tokens)
            comp = fabric.plan(ticket, now, nbytes)
            ready = now
            if comp is not None:
                ready += comp.compress_time(
                    nbytes, kv_bytes_per_token(nbytes, tokens))
            fabric.request(ticket, ready, nbytes, comp=comp)
            fabric.resolve()
            req.mig_raw_bytes += ticket.kv_raw_bytes
            req.mig_wire_bytes += ticket.kv_wire_bytes
            req.kv_restore_cost += ticket.kv_decompress_cost
            # not admissible on the target before its first chunk lands
            req.decode_ready_time = ticket.decode_ready_time
            resume, landed = ticket.decode_ready_time, ticket.kv_landed_time
            self.migration.compress_time += ready - now
            self.migration.kv_raw_bytes += ticket.kv_raw_bytes
            self.migration.kv_wire_bytes += ticket.kv_wire_bytes
            self.migration._bump(ticket.wire_mode, ticket.kv_wire_bytes,
                                 ticket.kv_raw_bytes)
        else:
            resume = landed = now
        req.replica = target
        req.migrated_from = source
        req.migrations += 1
        req.migration_time += landed - now
        self.assignments[req.rid] = target
        if self.cfg.policy in ("adapter_affinity", "cluster_affinity"):
            w = self._remaining_work(req)
            self._routed_load[source] = max(0.0,
                                            self._routed_load[source] - w)
            self._routed_load[target] += w
        dst_eng.stats.n_migrated_in += 1
        dst_eng.submit([req])
        self.migration.n_migrations += 1
        self.migration.migration_time += landed - now
        return resume

    def _remaining_work(self, req: Request) -> float:
        """`_work_estimate` restricted to the tokens `req` has left — the
        share of routed load that moves replicas with a migration."""
        ex = self.engines[0].executor
        if isinstance(ex, CostModelExecutor):
            bs = self.engines[0].cfg.scheduler.max_batch
            step = ex.decode_step_time([req] * bs)
            pre = 0.0 if req.prefilled else ex.prefill_time(req)
            return pre + (req.max_new_tokens - req.generated) * step / bs
        return float(req.max_new_tokens - req.generated)

    # -- live state helpers -------------------------------------------------
    def _advance_to(self, t: float) -> None:
        """Step every replica's simulation up to (at least) time t so that
        queue-depth observations at an arrival are causal."""
        for eng in self.engines:
            while (eng.running or
                   (eng.waiting and eng.waiting[0].ready_time <= t)) \
                    and eng.clock < t:
                if not eng.step():
                    break

    def advance_to(self, t: float) -> None:
        """Public window driver for elastic serving (see autoscaler)."""
        self._advance_to(t)

    def _outstanding(self, i: int) -> int:
        eng = self.engines[i]
        return len(eng.running) + len(eng.waiting)

    def _least_outstanding(self, among: Optional[Sequence[int]] = None) -> int:
        idxs = self._active_idxs() if among is None else among
        return min(idxs, key=lambda i: (self._outstanding(i), i))

    # -- policies -----------------------------------------------------------
    def _route_round_robin(self, req: Request) -> int:
        idxs = self._active_idxs()
        i = idxs[self._rr % len(idxs)]
        self._rr += 1
        return i

    def _route_least_outstanding(self, req: Request) -> int:
        self._advance_to(req.ready_time)
        return self._least_outstanding()

    def _affinity_key(self, req: Request) -> int:
        if self.cfg.policy == "cluster_affinity":
            return self.cluster_of.get(req.adapter_id, req.adapter_id)
        return req.adapter_id

    def _rank_score(self, i: int, rank: int) -> float:
        """Replica `i`'s effective decode throughput for a rank-`rank`
        adapter: the slice's decode-speed factor discounted by the SGMV
        tile efficiency of that rank on the slice's native tile width.
        Replicas without a slice type score as the legacy accelerator
        (speed 1.0, tile 8)."""
        st = getattr(self.engines[i], "slice_type", None)
        speed = st.decode_speed if st is not None else 1.0
        tile = st.sgmv_tile_rank if st is not None else 8
        return speed * rank_efficiency(rank, tile)

    def _route_affinity(self, req: Request) -> int:
        key = self._affinity_key(req)
        home = self._home.get(key)
        idxs = self._active_idxs()
        rank = (self.rank_of.get(req.adapter_id)
                if self.cfg.rank_aware else None)
        if rank is None:
            lightest = min(idxs, key=lambda i: (self._routed_load[i], i))
        else:
            # rank-aware: the best replica minimizes this request's
            # effective finish estimate — queued work plus one average
            # request, deflated by the replica's rank score — so a fast
            # wide-tile slice absorbs high-rank adapters (its padding is
            # free there) while skinny ranks prefer narrow-tile replicas
            # even when the wide slice has spare capacity.  Ties (notably
            # an idle fleet, where every estimate is zero) break toward
            # the higher rank score, then the lower index.
            w = self._avg_request_work()
            lightest = min(idxs, key=lambda i: (
                (self._routed_load[i] + w) / self._rank_score(i, rank),
                -self._rank_score(i, rank), i))
        if home is None or not self.active[home]:
            # first sighting (or home retired): place on the least-loaded
            # active replica
            self._home[key] = lightest
            return lightest
        # bounded spill: sticky only while the home replica's routed work
        # stays within `spill_requests` average requests of the lightest
        slack = self.cfg.spill_requests * self._avg_request_work()
        if self._routed_load[home] - self._routed_load[lightest] > slack:
            return lightest
        return home

    def _avg_request_work(self) -> float:
        n = len(self.assignments)
        return (sum(self._routed_load) / n) if n else 0.0

    def _work_estimate(self, req: Request) -> float:
        """Estimated replica-seconds this request costs (prefill + its share
        of full decode batches).  Falls back to a token count for executors
        without a cost model."""
        ex = self.engines[0].executor
        # only the analytic executor is side-effect free to probe; a real
        # executor's cost hooks actually run model steps
        if isinstance(ex, CostModelExecutor):
            bs = self.engines[0].cfg.scheduler.max_batch
            step = ex.decode_step_time([req] * bs)
            pre = 0.0 if req.prefilled else ex.prefill_time(req)
            return pre + req.max_new_tokens * step / bs
        return float(req.prompt_len + req.max_new_tokens)

    def _router(self) -> Callable[[Request], int]:
        return {
            "round_robin": self._route_round_robin,
            "least_outstanding": self._route_least_outstanding,
            "adapter_affinity": self._route_affinity,
            "cluster_affinity": self._route_affinity,
        }[self.cfg.policy]

    # -- public API ---------------------------------------------------------
    def submit(self, requests: Sequence[Request]) -> None:
        """Route `requests` to decode replicas (prefill-tier-first when
        disaggregated).  May be called repeatedly with successive arrival
        windows; routing state persists across calls."""
        if self.prefill_tier is not None:
            # prefill tier runs first and stamps decode_ready_time; decode
            # placement happens in KV-arrival order
            self.prefill_tier.process(requests)
        route = self._router()
        # routed-load accounting feeds the affinity policies' spill logic
        # only; skip the per-request cost probe for the stateless policies
        track_load = self.cfg.policy in ("adapter_affinity",
                                         "cluster_affinity")
        for r in sorted(requests, key=lambda r: r.ready_time):
            i = route(r)
            r.replica = i
            self.assignments[r.rid] = i
            if track_load:
                self._routed_load[i] += self._work_estimate(r)
            if self.prefill_tier is not None and self.cfg.cross_tier_prefetch:
                # hint the decode cache as of prefill ADMISSION — the KV
                # will not land for another prefill + transfer, which is
                # exactly the head start the background copy engine needs
                eng = self.engines[i]
                hint_at = (r.start_time if r.start_time is not None
                           else r.ready_time)
                eng.cache.prefetch(
                    weight_key(r), eng.executor.adapter_bytes(r.adapter_id),
                    hint_at)
            self.engines[i].submit([r])

    def run(self, max_steps: int = 10_000_000) -> FleetStats:
        per = [eng.run(max_steps) for eng in self.engines]
        # live migration can rehome work onto a replica drained earlier in
        # the pass — sweep again until a full pass leaves every queue
        # empty.  Bounded: each request's moves are capped (the M5
        # starvation guard declines over-cap rehomes, falling back to a
        # local host swap), so migration-free fleets exit after one pass,
        # bit-exact with the sequential drain.
        while any(eng.running or eng.waiting for eng in self.engines):
            per = [eng.run(max_steps) for eng in self.engines]
        return FleetStats(
            total=ServeStats.merged(per), per_replica=per,
            prefill=(self.prefill_tier.stats.to_dict()
                     if self.prefill_tier is not None else None),
            n_replicas_final=len(self._active_idxs()),
            scale_events=self.scale_events,
            migration=(None if self.migration.empty
                       else self.migration.to_dict()))

    def replicas_of_adapter(self, requests: Sequence[Request]) -> Dict[int, set]:
        """adapter_id -> set of replicas its requests were routed to."""
        out: Dict[int, set] = {}
        for r in requests:
            if r.rid in self.assignments:
                out.setdefault(r.adapter_id, set()).add(self.assignments[r.rid])
        return out
