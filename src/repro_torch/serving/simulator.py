"""The paper's throughput study driver (Figs. 1 & 4), fleet-capable (the
port's copy of ``serving/simulator.py``).

Replicates §6.4's setup in the terms of one NVIDIA H100 SXM (the port's
:class:`~repro_torch.serving.engine.ServingHardware`: the card's data-sheet
figures, with ``step_overhead`` not yet fitted to the card, so every number
it gives is the cost model's): N unique rank-16 LoRAs, asynchronous
request arrivals, inputs assigned to adapters uniformly at random, ten
generated tokens per request; memory-matched baseline (Appendix F): the
uncompressed engine gets an adapter budget equal to what the compressed
configuration consumes (shared bases + all Sigmas).

The study now drives a :class:`repro_torch.serving.router.Fleet` through the
workload generator in :mod:`repro_torch.serving.workload`.  The default
configuration — one replica, uniform popularity, round-robin routing — is
the special case that reproduces the original single-replica numbers
bit-exactly; `FleetConfig(n_replicas=..., policy=...)` plus a skewed
`WorkloadSpec` opens the production scenarios (Zipf popularity, bursty
arrivals, affinity routing).

**The unified study driver.**  Every serving study is one of two
shapes: submit-everything-and-drain (a fixed fleet), or a *window loop*
(arrivals and control-plane events interleaved in causal time order,
data plane advanced to each window edge, then control-plane decisions —
autoscaling, lifecycle rollouts, migrations).  :func:`run_study` is that
loop, once; ``run_autoscaled`` / ``run_joint_autoscaled``
(autoscaler.py), ``run_churn_study`` (lifecycle.py) and the entry points
here are thin wrappers over it, proven bit-exact against the committed
``BENCH_*.json`` baselines.  Scripted :class:`StudyEvent` hooks and a
:class:`~repro_torch.serving.migration.MigrationPolicy` plug into the same
loop instead of forking a sixth driver copy; results come back as one
:class:`StudyReport`.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .autoscaler import (Autoscaler, AutoscalerConfig, JointAutoscaler,
                         JointAutoscalerConfig, SLOConfig)
from .engine import (CostModelExecutor, EngineConfig, ModelFootprint,
                     ServingEngine, ServingHardware)
from .lifecycle import AdapterLifecycle, LifecycleEvent, apply_event
from .migration import MigrationPolicy
from .prefill import PrefillConfig, PrefillTier, PrefillWorker
from .request import Request
from .resources import (PAGE_TOKENS, BudgetConfig, HardwareBudget, SliceType,
                        merge_mode_dict)
from .router import Fleet, FleetConfig, FleetStats
from .scheduler import SchedulerConfig
from .workload import WorkloadSpec, make_workload

# Backwards-compatible names: the workload generator used to live here.
WorkloadConfig = WorkloadSpec


# paper Appendix F: compression setting per collection size
PAPER_SETTINGS = {
    4: dict(rank=16, clusters=1), 8: dict(rank=16, clusters=1),
    16: dict(rank=32, clusters=1), 32: dict(rank=64, clusters=1),
    64: dict(rank=64, clusters=1), 128: dict(rank=16, clusters=7),
    256: dict(rank=16, clusters=10), 512: dict(rank=16, clusters=25),
    1024: dict(rank=16, clusters=25),
}


def compression_setting(n_adapters: int) -> Dict:
    keys = sorted(PAPER_SETTINGS)
    for k in keys:
        if n_adapters <= k:
            return PAPER_SETTINGS[k]
    return PAPER_SETTINGS[keys[-1]]


def memory_matched_setup(model_cfg, n_adapters: int,
                         cluster_assign_seed: int = 0):
    """Appendix-F memory matching for a collection size.

    Returns (setting, cluster_of, budget): the paper's compression setting,
    a seeded random cluster assignment, and the per-replica adapter budget —
    the uncompressed baseline gets exactly what the compressed configuration
    consumes (shared bases + all Sigmas), floored at two resident LoRAs."""
    setting = compression_setting(n_adapters)
    rng = np.random.default_rng(cluster_assign_seed)
    cluster_of = {a: int(rng.integers(setting["clusters"]))
                  for a in range(n_adapters)}
    fp_jd = ModelFootprint.from_config(model_cfg, jd_rank=setting["rank"],
                                       n_clusters=setting["clusters"])
    fp_lora = ModelFootprint.from_config(model_cfg)
    jd_total = (fp_jd.jd_shared_bytes_per_cluster * setting["clusters"]
                + n_adapters * fp_jd.jd_sigma_bytes_per_adapter)
    budget = max(jd_total, 2 * fp_lora.lora_bytes_per_adapter)
    return setting, cluster_of, budget


def serving_footprint(model_cfg, mode: str, n_adapters: int,
                      setting: Dict) -> ModelFootprint:
    """The cost-model footprint build_fleet has always used for `mode`."""
    if mode == "jd":
        return ModelFootprint.from_config(model_cfg, jd_rank=setting["rank"],
                                          n_clusters=setting["clusters"])
    fp = ModelFootprint.from_config(model_cfg)
    if n_adapters <= 1:                # merged single-LoRA reference
        fp = dataclasses.replace(fp, lora_bytes_per_adapter=0)
    return fp


def slice_pool_bytes(fp: ModelFootprint, hw: ServingHardware) -> float:
    """The unified-pool region a replica on (slice-scaled) hardware `hw`
    actually has: the serving cap of its HBM minus the resident base
    weights, floored at one page so a tiny slice still constructs."""
    page = fp.kv_bytes_per_token * PAGE_TOKENS
    return max(hw.hbm_bytes * hw.mem_cap_frac - fp.weight_bytes, page)


def build_engine(model_cfg, mode: str, n_adapters: int, budget: float,
                 hw: ServingHardware, cluster_of: Dict[int, int],
                 setting: Dict, max_batch: int = 32,
                 prefetch: bool = False,
                 pool_bytes: Optional[float] = None,
                 pool_adapter_share: Optional[float] = None,
                 slice_type: Optional[SliceType] = None,
                 rank_of: Optional[Dict[int, int]] = None) -> ServingEngine:
    """One cost-model decode replica (also the autoscaler's engine factory).

    With `pool_bytes` the replica runs unified paging: adapter weights and
    KV blocks share one paged HBM region of that many bytes
    (`pool_adapter_share` carves the static-split baseline out of the same
    machinery); `budget` is then ignored.  Without it, the legacy
    byte-budget adapter cache is used, bit-exact with the pre-paging
    engine.

    With `slice_type` the replica is typed: its hardware is scaled by the
    slice's speed factors and HBM (``ServingHardware.for_slice``), the
    executor prices per-rank SGMV padding against the slice's tile, and
    ``pool_bytes="slice"`` sizes the paged pool from the slice's own HBM
    (:func:`slice_pool_bytes`) instead of a caller-fixed region."""
    fp = serving_footprint(model_cfg, mode, n_adapters, setting)
    hw = hw.for_slice(slice_type)
    if pool_bytes == "slice":
        pool_bytes = slice_pool_bytes(fp, hw)
    ex = CostModelExecutor(hw, fp, mode, cluster_of, rank_of=rank_of,
                           slice_type=slice_type)
    pool = (None if pool_bytes is None else
            fp.pool_config(pool_bytes, adapter_share=pool_adapter_share))
    return ServingEngine(
        EngineConfig(scheduler=SchedulerConfig(max_batch=max_batch),
                     adapter_budget_bytes=budget, mode=mode,
                     prefetch=prefetch, pool=pool),
        ex, cluster_of, slice_type=slice_type)


def build_prefill_worker(model_cfg, mode: str, n_adapters: int, budget: float,
                         prefill_cfg: PrefillConfig, hw: ServingHardware,
                         cluster_of: Dict[int, int], setting: Dict,
                         slice_type: Optional[SliceType] = None
                         ) -> PrefillWorker:
    """One prefill worker (also the joint autoscaler's prefill factory).
    With `slice_type` the worker's compute roofline is scaled by the
    slice's ``prefill_speed``."""
    fp = serving_footprint(model_cfg, mode, n_adapters, setting)
    hw = hw.for_slice(slice_type)
    cfg = dataclasses.replace(prefill_cfg, mode=mode,
                              adapter_budget_bytes=budget)
    return PrefillWorker(cfg, CostModelExecutor(hw, fp, mode, cluster_of),
                         cluster_of, slice_type=slice_type)


def build_prefill_tier(model_cfg, mode: str, n_adapters: int, budget: float,
                       prefill_cfg: PrefillConfig, hw: ServingHardware,
                       cluster_of: Dict[int, int], setting: Dict,
                       slice_type: Optional[SliceType] = None) -> PrefillTier:
    """Prefill workers with the same footprint/cost model and per-worker
    adapter budget as the decode tier (adapters must be resident on the
    prefill device too); all workers share the tier's KV fabric."""
    cfg = dataclasses.replace(prefill_cfg, mode=mode,
                              adapter_budget_bytes=budget)
    workers = [build_prefill_worker(model_cfg, mode, n_adapters, budget,
                                    prefill_cfg, hw, cluster_of, setting,
                                    slice_type=slice_type)
               for _ in range(cfg.n_workers)]
    return PrefillTier(cfg, workers)


def build_fleet(model_cfg, mode: str, n_adapters: int, budget: float,
                fleet_cfg: FleetConfig, hw: ServingHardware,
                cluster_of: Dict[int, int], setting: Dict,
                max_batch: int = 32, prefetch: bool = False,
                prefill_cfg: Optional[PrefillConfig] = None,
                pool_bytes: Optional[float] = None,
                pool_adapter_share: Optional[float] = None,
                decode_slice_types: Optional[Sequence[SliceType]] = None,
                prefill_slice_type: Optional[SliceType] = None,
                rank_of: Optional[Dict[int, int]] = None) -> Fleet:
    """N replicas of the cost-model engine for `mode`.

    Budget is per replica (each replica owns an HBM adapter region).  With
    `prefill_cfg` the fleet is disaggregated: a prefill tier (own workers,
    caches, and KV transfer link) feeds the decode replicas.  With
    `pool_bytes` each decode replica runs unified paging (see
    :func:`build_engine`).

    Heterogeneous fleets: `decode_slice_types` names each replica's slice
    class (one entry per replica — replicas need no longer be identical),
    `prefill_slice_type` types the whole prefill tier, and `rank_of`
    (adapter id -> LoRA rank) feeds both the executors' per-rank byte
    model and the router's rank-aware placement
    (``FleetConfig.rank_aware``)."""
    if (decode_slice_types is not None
            and len(decode_slice_types) != fleet_cfg.n_replicas):
        raise ValueError(f"decode_slice_types names "
                         f"{len(decode_slice_types)} replicas, fleet has "
                         f"{fleet_cfg.n_replicas}")
    engines = [build_engine(model_cfg, mode, n_adapters, budget, hw,
                            cluster_of, setting, max_batch, prefetch,
                            pool_bytes=pool_bytes,
                            pool_adapter_share=pool_adapter_share,
                            slice_type=(decode_slice_types[k]
                                        if decode_slice_types else None),
                            rank_of=rank_of)
               for k in range(fleet_cfg.n_replicas)]
    tier = None
    if prefill_cfg is not None:
        fleet_cfg = dataclasses.replace(fleet_cfg, disaggregated=True)
        tier = build_prefill_tier(model_cfg, mode, n_adapters, budget,
                                  prefill_cfg, hw, cluster_of, setting,
                                  slice_type=prefill_slice_type)
    return Fleet(fleet_cfg, engines, cluster_of, prefill_tier=tier,
                 rank_of=rank_of)


# ---------------------------------------------------------------------------
# the unified study driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StudyEvent:
    """A scripted control-plane action in a study's event stream.

    Fires once, in causal order against the arrival stream (an event at
    `t` is applied before any request arriving after `t` is routed).
    `fn` receives the live :class:`StudyState` — retire a replica, add a
    prefill worker, flip a config knob.  Lifecycle actions use
    :class:`~repro_torch.serving.lifecycle.LifecycleEvent` in the same stream."""
    t: float
    fn: Callable[["StudyState"], None]
    label: str = ""


@dataclasses.dataclass
class StudyState:
    """Live handles a :class:`StudyEvent` (or migration hook) can act on
    mid-study."""
    fleet: Fleet
    t: float = 0.0
    autoscaler: Optional[object] = None
    lifecycle: Optional[AdapterLifecycle] = None
    migration: Optional[MigrationPolicy] = None
    budget: Optional[HardwareBudget] = None
    decode_factory: Optional[Callable[[], ServingEngine]] = None
    prefill_factory: Optional[Callable[[], PrefillWorker]] = None
    _finished: Optional[List[Request]] = None

    def attach_engine(self, eng: ServingEngine) -> int:
        """Join a replica built outside the loop at time ``self.t``, wired
        into the study's callbacks (finish observation, lifecycle,
        migration) exactly like an autoscaler-added one."""
        if self._finished is not None:
            _chain_finish(eng, self._finished.append)
        if self.lifecycle is not None:
            self.lifecycle.attach_engine(eng)
        idx = self.fleet.add_replica(eng, now=self.t)
        if self.migration is not None:
            self.migration.wire(eng)
        return idx

    def retire_decode(self, i: Optional[int] = None,
                      migrate: Optional[bool] = None) -> None:
        """Retire replica `i` (default: the most recently added active
        one).  `migrate` defaults to instant scale-down when a migration
        policy with ``migrate_on_retire`` is attached, drain otherwise."""
        if i is None:
            i = self.fleet._active_idxs()[-1]
        if migrate is None:
            migrate = (self.migration is not None
                       and self.migration.cfg.migrate_on_retire)
        self.fleet.retire_replica(i, migrate=migrate, now=self.t)


@dataclasses.dataclass
class StudyReport:
    """The unified study result: merged fleet stats, the control plane's
    decision history, and per-mode wire accounting — plus the JSON /
    derived-cell helpers every benchmark previously hand-rolled."""
    stats: FleetStats
    decisions: Optional[List] = None     # autoscaler history, if any
    wire_by_mode: Optional[Dict] = None  # fabric wire bytes by mode
    migration: Optional[Dict] = None     # MigrationStats.to_dict()
    lifecycle: Optional[Dict] = None     # LifecycleStats.to_dict()
    budget: Optional[Dict] = None        # HardwareBudget.to_dict()

    @property
    def rps(self) -> float:
        return self.stats.total.throughput_rps

    def to_dict(self) -> Dict:
        d = self.stats.to_dict()
        if self.wire_by_mode:
            d["wire_bytes_by_mode"] = dict(self.wire_by_mode)
        return d

    def metrics(self, **extra) -> Dict[str, float]:
        """The perf-gate metric dict (`check_regression` compares names
        ending in rps/speedup/ratio); pass extras as keywords."""
        m = {"rps": self.rps}
        m.update(extra)
        return m

    def derived(self, slo_ttft: Optional[float] = None) -> str:
        """The benchmark CSV `derived` cell: headline latency percentiles
        plus whichever control-plane facts this study produced."""
        tot = self.stats.total
        s = (f"rps={tot.throughput_rps:.2f};"
             f"ttft_p95={tot.ttft_pct(95) * 1e3:.1f}ms;"
             f"tpot_p95={tot.tpot_pct(95) * 1e3:.2f}ms")
        if slo_ttft is not None:
            s += f";met_slo={tot.ttft_pct(95) <= slo_ttft}"
        if self.stats.n_prefill_final is not None:
            s += (f";split={self.stats.n_prefill_final}P:"
                  f"{self.stats.n_replicas_final}D"
                  f";scale_events={self.stats.scale_events}")
        if self.migration is not None:
            s += f";migrations={self.migration['n_migrations']}"
        return s


def _chain_finish(eng: ServingEngine, cb: Callable[[Request], None]) -> None:
    """Add `cb` to an engine's on_finish without clobbering an existing
    hook (the lifecycle chains its drain bookkeeping the same way)."""
    prev = eng.on_finish
    if prev is None:
        eng.on_finish = cb
    else:
        def chained(r, _prev=prev, _cb=cb):
            _prev(r)
            _cb(r)
        eng.on_finish = chained


def _call_factory(factory, slice_type: Optional[SliceType]):
    """Build a unit from an autoscaler factory, forwarding the chosen
    slice type only when the factory can take one — legacy zero-arg
    factories (and untyped budgets, where `slice_type` is None) keep
    working unchanged."""
    if slice_type is None:
        return factory()
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):   # builtins / odd callables
        return factory()
    return factory(slice_type) if params else factory()


def _apply_study_event(ev, state: StudyState) -> None:
    if isinstance(ev, LifecycleEvent):
        if state.lifecycle is None:
            raise ValueError(f"lifecycle event {ev} in a study with no "
                             f"lifecycle")
        apply_event(state.lifecycle, ev)
    else:
        ev.fn(state)


def run_study(fleet: Fleet,
              workload: Union[Sequence[Request], WorkloadSpec],
              *,
              autoscaler: Optional[object] = None,
              lifecycle: Optional[AdapterLifecycle] = None,
              events: Optional[Sequence] = None,
              migration: Optional[MigrationPolicy] = None,
              decode_factory: Optional[Callable[[], ServingEngine]] = None,
              prefill_factory: Optional[Callable[[], PrefillWorker]] = None,
              window: Optional[float] = None,
              max_steps: int = 10_000_000) -> StudyReport:
    """Drive `fleet` through a workload under any combination of control
    planes — THE window loop every legacy entry point now wraps.

    Two shapes, one function:

    * **One-shot** — no autoscaler, no lifecycle, no events, no migration
      policy, no explicit `window`: submit everything, drain, report.
      Bit-exact with the pre-unification fixed-fleet path (the shared
      fabric resolves all transfers in one batch, which windowed
      resolution deliberately does not reproduce).
    * **Window loop** — per window: (1) interleave scripted events
      (:class:`StudyEvent` / :class:`LifecycleEvent
      <repro_torch.serving.lifecycle.LifecycleEvent>`) and request arrivals in
      causal time order, stamping and routing arrivals as they come;
      (2) advance every replica to the window edge; (3) control plane —
      lifecycle rollout pacing, the migration policy's window hook
      (priority preemption + affinity defrag), then the autoscaler's
      decision (decode-only `Autoscaler` or two-tier `JointAutoscaler`,
      reproducing their original observation windows verbatim).  An
      autoscaler scale-down retires with live migration when the
      attached :class:`~repro_torch.serving.migration.MigrationPolicy` asks
      for instant scale-down.

    `window` defaults to the autoscaler's decision interval, else 0.25 s.
    `workload` may be a :class:`~repro_torch.serving.workload.WorkloadSpec`
    (generated here) or an explicit request list."""
    if isinstance(workload, WorkloadSpec):
        workload = make_workload(workload)
    reqs = list(workload)
    evs = sorted(events or [], key=lambda e: e.t)
    joint = isinstance(autoscaler, JointAutoscaler)
    if autoscaler is not None and decode_factory is None:
        raise ValueError("an autoscaled study needs decode_factory")
    if joint and (prefill_factory is None or fleet.prefill_tier is None):
        raise ValueError("joint autoscaling needs a disaggregated fleet "
                         "(prefill_tier) and prefill_factory")
    if migration is not None:
        migration.attach(fleet)

    one_shot = (autoscaler is None and lifecycle is None and not evs
                and migration is None and window is None)
    if one_shot:
        # submit in caller order (bit-exact with the legacy fixed path)
        fleet.submit(reqs)
        return _report(fleet, fleet.run(max_steps), None, None)
    reqs.sort(key=lambda r: r.arrival_time)

    tier = fleet.prefill_tier
    budget = autoscaler.budget if joint else None
    if joint:
        n_dec0 = len(fleet._active_idxs())
        # each live unit is charged for its *own* slice type (None on a
        # legacy unit resolves to the budget's default slice, so the
        # untyped path is arithmetically unchanged)
        pre_types = [getattr(tier.workers[k], "slice_type", None)
                     for k in tier._active_idxs()]
        dec_types = [getattr(fleet.engines[k], "slice_type", None)
                     for k in fleet._active_idxs()]
        need = (sum(budget.cfg.cost("prefill", s) for s in pre_types)
                + sum(budget.cfg.cost("decode", s) for s in dec_types))
        if need > budget.available:
            # fail at construction time with a clear message instead of
            # dying mid-run inside HardwareBudget.allocate
            raise ValueError(
                f"budget too small for the initial split: {tier.n_active} "
                f"prefill x {budget.cfg.cost('prefill')} accels + {n_dec0} "
                f"decode x {budget.cfg.cost('decode')} accels needs {need}, "
                f"{budget.available} free of {budget.cfg.total_units}")
        for s in pre_types:
            budget.allocate("prefill", s)
        for s in dec_types:
            budget.allocate("decode", s)
        if autoscaler.comp_policy is None and tier.fabric.policy is not None:
            autoscaler.bind_compression(tier.fabric.policy)

    finished: List[Request] = []
    if autoscaler is not None:
        for eng in fleet.engines:
            _chain_finish(eng, finished.append)
    state = StudyState(fleet=fleet, autoscaler=autoscaler,
                       lifecycle=lifecycle, migration=migration,
                       budget=budget, decode_factory=decode_factory,
                       prefill_factory=prefill_factory, _finished=finished)
    mig_retire = (migration is not None and migration.cfg.migrate_on_retire)

    dt = window if window is not None else (
        autoscaler.cfg.decision_interval if autoscaler is not None else 0.25)
    t = dt
    i = j = 0
    recent: List[Request] = []       # arrivals still possibly in prefill
    pending_decomp: List[Request] = []   # compressed, dequant not yet billed
    while True:
        # (1) interleave scripted events and arrivals inside this window
        # by time: an event is visible to the requests behind it
        win_arrivals: List[Request] = []
        while i < len(reqs) or j < len(evs):
            r_t = reqs[i].arrival_time if i < len(reqs) else float("inf")
            e_t = evs[j].t if j < len(evs) else float("inf")
            if min(r_t, e_t) >= t:
                break
            if e_t <= r_t:
                state.t = e_t
                _apply_study_event(evs[j], state)
                j += 1
            else:
                k = i                # batch arrivals up to the next event
                until = min(t, e_t)
                while k < len(reqs) and reqs[k].arrival_time < until:
                    k += 1
                batch = reqs[i:k]
                if lifecycle is not None:
                    lifecycle.stamp(batch)
                fleet.submit(batch)
                win_arrivals.extend(batch)
                i = k
        if joint:
            recent.extend(win_arrivals)
            pending_decomp.extend(r for r in win_arrivals
                                  if r.kv_decompress_cost > 0)
        # (2) advance the data plane through the window BEFORE the control
        # plane acts at its edge: a basis swap (or a migration) moves
        # clocks forward, and acting first would let it cut in line ahead
        # of arrivals queued within the window
        fleet.advance_to(t)
        state.t = t
        if lifecycle is not None:
            lifecycle.tick(t)
        if migration is not None:
            migration.on_window(fleet, t)
        # (3) observations + the autoscaler's decision
        ttfts = [r.ttft for r in finished if r.ttft is not None]
        tpots = [r.tpot for r in finished if r.tpot is not None]
        dwaits = [r.decode_wait for r in finished
                  if r.decode_wait is not None]
        if joint:
            # bill dequantization to the window it actually ran in
            # (admission stamps decompress_done_time), not the window the
            # request finishes
            decomp_total = sum(r.kv_decompress_cost for r in pending_decomp
                               if r.decompress_done_time is not None
                               and r.decompress_done_time <= t)
            pending_decomp = [r for r in pending_decomp
                              if r.decompress_done_time is None
                              or r.decompress_done_time > t]
        finished.clear()
        outstanding = sum(len(eng.running) + len(eng.waiting)
                          for eng in fleet.engines)
        if i >= len(reqs) and j >= len(evs) and outstanding == 0:
            break
        # drain phase (arrivals over): further decisions could only
        # inflate scale_events with idle capacity
        if autoscaler is not None and i < len(reqs):
            if joint:
                # the prefill tier simulates eagerly, so "queued at t" is
                # virtual: arrived but not yet prefill-complete by the
                # window end
                recent = [r for r in recent if r.prefill_done_time is None
                          or r.prefill_done_time > t]
                prefill_backlog = sum(1 for r in recent
                                      if r.arrival_time <= t)
                pre_lags = [r.prefill_lag for r in win_arrivals
                            if r.prefill_lag is not None]
                decode_backlog = sum(
                    len(eng.running)
                    + sum(1 for r in eng.waiting if r.ready_time <= t)
                    for eng in fleet.engines)
                n_dec_active = len(fleet._active_idxs())
                # unified paging: the worst active replica's page pressure
                # (0 for non-paged engines) — admissions block on pages,
                # so this sees a memory bottleneck percentiles can miss
                kv_page_util = max(
                    (1.0 - fleet.engines[k].pool.free_pages
                     / fleet.engines[k].pool.total_pages
                     for k in fleet._active_idxs()
                     if fleet.engines[k].pool is not None), default=0.0)
                # retirement always takes the newest unit, so tell the
                # autoscaler how many cost units *that* unit would free —
                # on a typed pool a trade must be priced in the donor's
                # actual slice, not the config-wide minimum
                retire_pre_units = retire_dec_units = None
                if budget.cfg.typed:
                    pact, dact = tier._active_idxs(), fleet._active_idxs()
                    if pact:
                        retire_pre_units = budget.cfg.cost(
                            "prefill",
                            getattr(tier.workers[pact[-1]],
                                    "slice_type", None))
                    if dact:
                        retire_dec_units = budget.cfg.cost(
                            "decode",
                            getattr(fleet.engines[dact[-1]],
                                    "slice_type", None))
                d_pre, d_dec = autoscaler.decide(
                    t, ttfts, tpots, dwaits, pre_lags, tier.n_active,
                    n_dec_active, prefill_backlog, decode_backlog,
                    decompress_util=decomp_total / (dt * max(n_dec_active,
                                                             1)),
                    fabric_lag_s=max(0.0, tier.fabric.free_at - t),
                    kv_page_util=kv_page_util,
                    retire_prefill_units=retire_pre_units,
                    retire_decode_units=retire_dec_units)
                if d_dec < 0:
                    victim = fleet._active_idxs()[-1]
                    vst = getattr(fleet.engines[victim], "slice_type", None)
                    fleet.retire_replica(victim, migrate=mig_retire, now=t)
                    budget.release("decode", vst)
                if d_pre < 0:
                    pv = tier._active_idxs()[-1]
                    vst = getattr(tier.workers[pv], "slice_type", None)
                    tier.retire_worker(pv)
                    budget.release("prefill", vst)
                if d_pre > 0:
                    st = autoscaler.pick_slice("prefill")
                    budget.allocate("prefill", st)
                    tier.add_worker(_call_factory(prefill_factory, st),
                                    now=t)
                if d_dec > 0:
                    st = autoscaler.pick_slice("decode")
                    budget.allocate("decode", st)
                    state.attach_engine(_call_factory(decode_factory, st))
            else:
                # decisions see only decode-actionable work: requests
                # whose KV is still in prefill/transfer (ready_time > t)
                # cannot be helped by another decode replica
                backlog = sum(
                    len(eng.running)
                    + sum(1 for r in eng.waiting if r.ready_time <= t)
                    for eng in fleet.engines)
                active = fleet._active_idxs()
                delta = autoscaler.decide(t, ttfts, tpots, len(active),
                                          backlog)
                if delta > 0:
                    for _ in range(delta):
                        state.attach_engine(decode_factory())
                elif delta < 0:
                    for _ in range(-delta):
                        fleet.retire_replica(fleet._active_idxs()[-1],
                                             migrate=mig_retire, now=t)
        t += dt
    stats = fleet.run(max_steps)
    if lifecycle is not None:
        # let a rollout that was mid-flight at drain finish against the
        # final fleet clock so its bookkeeping (versions, shrink) settles
        lifecycle.tick(stats.total.wall_time + lifecycle.cfg.refresh_interval)
        stats.lifecycle = lifecycle.stats.to_dict()
    if joint:
        stats.n_prefill_final = tier.n_active
        stats.scale_events += tier.scale_events
        stats.budget = budget.to_dict()
    return _report(fleet, stats, autoscaler, lifecycle)


def _report(fleet: Fleet, stats: FleetStats, autoscaler, lifecycle
            ) -> StudyReport:
    wire: Dict[str, int] = {}
    if fleet.prefill_tier is not None:
        merge_mode_dict(wire,
                        fleet.prefill_tier.fabric.stats.wire_bytes_by_mode)
    if fleet._mig_fabric is not None:
        merge_mode_dict(wire, fleet._mig_fabric.stats.wire_bytes_by_mode)
    if not fleet.migration.empty:
        stats.migration = fleet.migration.to_dict()
    if autoscaler is not None:
        stats.autoscaler = autoscaler.history
    return StudyReport(
        stats=stats,
        decisions=autoscaler.history if autoscaler is not None else None,
        wire_by_mode=wire or None,
        migration=stats.migration,
        lifecycle=stats.lifecycle,
        budget=stats.budget)


def run_elastic_study(model_cfg, mode: str, n_adapters: int,
                      requests: List[Request],
                      fleet_cfg: FleetConfig,
                      hw: Optional[ServingHardware] = None,
                      max_batch: int = 32,
                      cluster_assign_seed: int = 0,
                      prefill_cfg: Optional[PrefillConfig] = None,
                      autoscaler_cfg: Optional[AutoscalerConfig] = None,
                      slo: Optional[SLOConfig] = None,
                      budget_cfg: Optional[BudgetConfig] = None,
                      joint_cfg: Optional[JointAutoscalerConfig] = None,
                      pool_bytes: Optional[float] = None,
                      pool_adapter_share: Optional[float] = None,
                      migration: Optional[MigrationPolicy] = None,
                      events: Optional[Sequence] = None,
                      report: bool = False,
                      decode_slice_types: Optional[Sequence[SliceType]] = None,
                      prefill_slice_type: Optional[SliceType] = None,
                      rank_of: Optional[Dict[int, int]] = None
                      ) -> Union[FleetStats, StudyReport]:
    """One serving cell, optionally disaggregated and/or autoscaled.

    With `autoscaler_cfg` the fleet starts at ``fleet_cfg.n_replicas``
    decode replicas and elastically scales between the autoscaler's
    min/max against `slo`; otherwise the replica set is fixed.  With
    `budget_cfg` (requires `prefill_cfg`) the run is *jointly* autoscaled:
    both tiers start at their configured sizes and the
    :class:`~repro_torch.serving.autoscaler.JointAutoscaler` trades prefill
    workers against decode replicas under the fixed accelerator pool.
    KV wire compression is configured on the fabric —
    ``prefill_cfg=PrefillConfig(fabric=FabricConfig(...,
    compression=KVCompressionConfig(...)))`` — and threads through the
    whole cell: workers compress, chunks ship small, decode replicas pay
    dequantization, and the joint autoscaler sees that load.  With
    ``FabricConfig(..., adaptive=AdaptiveCompressionConfig(...))`` the
    mode is instead picked per transfer from live channel backlog, and a
    jointly autoscaled run additionally drives the policy's mode ceiling
    (raised under budget-exhausted wire pressure before any replica
    trade, relaxed in quiet windows — see ``JointScaleDecision.d_comp``).
    With `pool_bytes` every decode replica (including ones the autoscaler
    adds) runs unified paging over a pool of that size;
    `pool_adapter_share` selects the static-split baseline.
    Heterogeneous cells: `decode_slice_types` / `prefill_slice_type` type
    the starting fleet (see :func:`build_fleet`), `rank_of` feeds the
    per-rank byte model and rank-aware routing, and a typed `budget_cfg`
    lets the joint autoscaler pick *which* slice class each scale-up adds
    (the factories here accept the chosen type).
    Returns merged :class:`FleetStats` (``stats.autoscaler`` holds the
    decision history when autoscaled; the prefill dict carries per-mode
    wire-byte totals), or the full :class:`StudyReport` with
    ``report=True``."""
    hw = hw or ServingHardware()
    setting, cluster_of, budget = memory_matched_setup(
        model_cfg, n_adapters, cluster_assign_seed)
    fleet = build_fleet(model_cfg, mode, n_adapters, budget, fleet_cfg, hw,
                        cluster_of, setting, max_batch,
                        prefill_cfg=prefill_cfg, pool_bytes=pool_bytes,
                        pool_adapter_share=pool_adapter_share,
                        decode_slice_types=decode_slice_types,
                        prefill_slice_type=prefill_slice_type,
                        rank_of=rank_of)

    def decode_factory(slice_type: Optional[SliceType] = None
                       ) -> ServingEngine:
        return build_engine(model_cfg, mode, n_adapters, budget, hw,
                            cluster_of, setting, max_batch,
                            pool_bytes=pool_bytes,
                            pool_adapter_share=pool_adapter_share,
                            slice_type=slice_type, rank_of=rank_of)

    if budget_cfg is not None:
        if prefill_cfg is None:
            raise ValueError("joint autoscaling needs prefill_cfg "
                             "(disaggregated fleet)")
        scaler = JointAutoscaler(joint_cfg or JointAutoscalerConfig(),
                                 slo or SLOConfig(),
                                 HardwareBudget(budget_cfg))

        def prefill_factory(slice_type: Optional[SliceType] = None
                            ) -> PrefillWorker:
            return build_prefill_worker(model_cfg, mode, n_adapters, budget,
                                        prefill_cfg, hw, cluster_of, setting,
                                        slice_type=slice_type)

        rep = run_study(fleet, requests, autoscaler=scaler,
                        decode_factory=decode_factory,
                        prefill_factory=prefill_factory,
                        migration=migration, events=events)
        return rep if report else rep.stats
    if autoscaler_cfg is None:
        rep = run_study(fleet, requests, migration=migration, events=events)
        return rep if report else rep.stats
    scaler = Autoscaler(autoscaler_cfg, slo or SLOConfig())
    rep = run_study(fleet, requests, autoscaler=scaler,
                    decode_factory=decode_factory,
                    migration=migration, events=events)
    return rep if report else rep.stats


def run_throughput_study(model_cfg, n_adapters_list: List[int],
                         workload: Optional[WorkloadSpec] = None,
                         hw: Optional[ServingHardware] = None,
                         max_batch: int = 32,
                         cluster_assign_seed: int = 0,
                         fleet: Optional[FleetConfig] = None,
                         prefetch: bool = False) -> List[Dict]:
    """Compressed vs uncompressed vs single-LoRA throughput across N."""
    hw = hw or ServingHardware()
    fleet_cfg = fleet or FleetConfig()
    rows = []
    for n in n_adapters_list:
        wl = dataclasses.replace(workload or WorkloadSpec(), n_adapters=n)
        setting, cluster_of, budget = memory_matched_setup(
            model_cfg, n, cluster_assign_seed)

        results = {}
        for mode in ("jd", "lora"):
            fl = build_fleet(model_cfg, mode, n, budget, fleet_cfg, hw,
                             cluster_of, setting, max_batch, prefetch)
            results[mode] = run_study(fl, make_workload(wl)).stats.to_dict()

        # single-LoRA reference (merged into base: no adapter overhead)
        fl1 = build_fleet(model_cfg, "lora", 1, budget, fleet_cfg, hw, {},
                          setting, max_batch, prefetch)
        results["single"] = run_study(
            fl1, make_workload(dataclasses.replace(wl, n_adapters=1))
        ).stats.to_dict()

        rows.append({
            "n_adapters": n, "setting": setting,
            "budget_bytes": budget,
            "n_replicas": fleet_cfg.n_replicas, "policy": fleet_cfg.policy,
            "jd": results["jd"], "lora": results["lora"],
            "single": results["single"],
            "throughput_ratio_jd_vs_lora":
                results["jd"]["throughput_rps"]
                / max(results["lora"]["throughput_rps"], 1e-9),
            "jd_frac_of_single":
                results["jd"]["throughput_rps"]
                / max(results["single"]["throughput_rps"], 1e-9),
        })
    return rows
