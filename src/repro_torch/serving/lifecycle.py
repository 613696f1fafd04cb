"""Online adapter lifecycle: hot register / update / retire, no redeploys
(the port's copy of ``serving/lifecycle.py``).

The compressed-basis clusters (``core/cluster.py``) are built offline over
a fixed adapter collection, but production traffic is tenants and A/B
variants arriving and retiring all day (the SageMaker/vLLM runtime-LoRA
pattern).  :class:`AdapterLifecycle` is the control plane that closes the
gap over a live :class:`~repro_torch.serving.router.Fleet`:

- **register** — the adapter is servable *immediately*: every executor
  gets a raw overlay (``CostModelExecutor.mark_raw``) so it decodes
  through the uncompressed SGMV path
  (:func:`repro_torch.core.collection.export_uncompressed`) with no compression
  in its critical path (invariant L1).  Its nearest cluster basis is
  assigned incrementally at register time
  (:func:`repro_torch.core.cluster.assign_adapter` over the existing bases —
  no re-solve), which routing and scheduling use right away; the basis
  only *serves* it after a refresh ships fleet-wide.
- **background basis refresh** — on a cadence, a rollout walks the fleet
  one replica at a time (invariant L2): each replica hot-swaps its pinned
  bases (:meth:`ServingEngine.refresh_shared
  <repro_torch.serving.engine.ServingEngine.refresh_shared>` — the DMA stalls
  only that replica) after a quality gate checks the candidate on it.
  The gate reuses the kernel-vs-oracle agreement / reconstruction-error
  machinery (``tests/test_kvcomp``-style agreement plus
  :func:`repro_torch.core.cluster.refresh_gate`); a failure rolls every
  already-swapped replica back to the prior basis and aborts the rollout
  — the absorbed adapters keep serving raw (invariant L3).
- **update** — retire+register under the same id with a bumped weight
  *epoch*: requests are stamped with the epoch they were routed against
  and finish on it (:func:`~repro_torch.serving.request.weight_key` keys caches
  per epoch), so an update never swaps weights under an in-flight request
  (invariant L4).
- **retire** — routing affinity drains immediately
  (:meth:`Fleet.drop_home <repro_torch.serving.router.Fleet.drop_home>`), the
  adapter's cache/:class:`~repro_torch.serving.resources.PagedPool` pages are
  released once its last in-flight request finishes, and its Sigma row is
  dropped lazily at the next basis refresh (invariant L5).

The full state machine and the L1-L5 invariants are specified in
``docs/lifecycle.md`` and asserted by ``tests/test_lifecycle.py`` (the
JAX package's copy; ``tests/test_torch_control_plane.py`` holds this one
to it).  The control plane is simulation-side (torch-free): the grounded
assignment / gate computations plug in through ``assign_fn`` /
``gate_fn``, as ``launch/grounded_churn.py`` does on the card.

:func:`make_churn_workload` and :func:`run_churn_study` drive churn
scenarios — Poisson adapter arrival/retirement streams over a Zipf base
load — measured by ``benchmarks/adapter_churn.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .request import Request, weight_key
from .router import Fleet, FleetStats
from .workload import WorkloadSpec, make_workload

# adapter states (docs/lifecycle.md §1)
REGISTERED = "registered"        # accepted, raw overlay being installed
RAW_SERVING = "raw-serving"      # served via uncompressed SGMV path
REFRESHING = "refreshing"        # a rollout is absorbing it (still raw)
CLUSTER_ASSIGNED = "cluster-assigned"  # its cluster basis serves it
RETIRED = "retired"              # no new routing; draining / drained

LIFECYCLE_STATES = (REGISTERED, RAW_SERVING, REFRESHING, CLUSTER_ASSIGNED,
                    RETIRED)


@dataclasses.dataclass
class LifecycleConfig:
    """Control-plane knobs (defaults are the churn benchmark's)."""
    # seconds between basis-refresh rollouts (a rollout starts only when
    # raw adapters or drained retirements are pending)
    refresh_interval: float = 2.0
    # minimum spacing between consecutive per-replica base swaps inside
    # one rollout — the "one replica at a time" pacing (invariant L2)
    rollout_step_interval: float = 0.05
    # gate thresholds: a candidate basis ships to a replica only if the
    # gate's reconstruction error and kernel-vs-oracle agreement clear
    # these (otherwise: rollback, invariant L3)
    gate_max_rel_err: float = 0.5
    gate_min_agreement: float = 0.99


@dataclasses.dataclass
class GateResult:
    """Outcome of one per-replica gate check during a rollout.

    ``rel_err`` is the candidate's worst newly-absorbed relative
    reconstruction error (``refresh_gate``'s ``new_worst_rel_err``);
    ``agreement`` the kernel-vs-oracle match fraction on the replica
    (1.0 = bit-exact, the ``tests/test_kvcomp`` machinery).  ``ok``
    carries any additional gate-internal verdict (e.g. ``refresh_gate``'s
    no-regression check)."""
    ok: bool = True
    rel_err: float = 0.0
    agreement: float = 1.0
    reason: str = ""


@dataclasses.dataclass
class AdapterState:
    """One adapter's lifecycle record (state machine in docs/lifecycle.md)."""
    aid: int
    state: str
    epoch: int = 0
    cluster: Optional[int] = None
    registered_at: float = 0.0
    retired_at: Optional[float] = None
    # epoch -> requests routed but not yet finished.  An update bumps
    # `epoch`; stale epochs drain here and release their weights when
    # their count hits zero (invariant L4).
    inflight: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def live(self) -> bool:
        return self.state != RETIRED


@dataclasses.dataclass
class BasisRollout:
    """One in-flight replica-by-replica basis refresh (at most one
    fleet-wide, invariant L2)."""
    version: int                     # basis version this rollout ships
    adapters: Tuple[Tuple[int, int], ...]   # (aid, epoch) being absorbed
    shrinks: Tuple[int, ...]         # drained retirees whose Sigma row drops
    targets: Tuple[Tuple[str, int], ...]    # ("decode"|"prefill", index)
    started_at: float
    next_at: float                   # earliest time of the next swap
    next_idx: int = 0                # first not-yet-swapped target


@dataclasses.dataclass
class LifecycleStats:
    n_registered: int = 0
    n_updated: int = 0
    n_retired: int = 0
    n_refreshes: int = 0             # rollouts completed fleet-wide
    n_rollbacks: int = 0             # rollouts aborted by a failed gate
    n_gate_checks: int = 0
    n_gate_failures: int = 0
    n_shrunk: int = 0                # Sigma rows dropped at refreshes
    raw_requests: int = 0            # stamped while raw-serving/refreshing
    assigned_requests: int = 0       # stamped while cluster-assigned
    bytes_released: int = 0          # cache/pool bytes freed by drains

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _default_gate(rollout: BasisRollout,
                  target: Tuple[str, int]) -> GateResult:
    """Stand-in gate for pure-simulation runs: always ships.  Grounded
    runs plug :func:`repro_torch.core.cluster.refresh_gate` + a kernel agreement
    check in through ``AdapterLifecycle(gate_fn=...)``."""
    return GateResult(ok=True)


class AdapterLifecycle:
    """Control plane for online adapter register / update / retire.

    Owns the per-adapter state machine, request epoch stamping, and the
    background basis-refresh rollouts over a live
    :class:`~repro_torch.serving.router.Fleet`.  Construction hooks every
    decode replica's ``on_finish`` (chaining any existing callback) so
    drains are observed; replicas added later must be attached with
    :meth:`attach_engine`.

    ``assign_fn(aid) -> cluster`` supplies the incremental
    nearest-cluster assignment (grounded:
    :func:`repro_torch.core.cluster.assign_adapter` over the real bank; the
    default hashes over the footprint's cluster count).
    ``gate_fn(rollout, target) -> GateResult`` supplies the per-replica
    refresh gate (grounded: :func:`repro_torch.core.cluster.refresh_gate` plus
    a kernel-vs-oracle agreement check; the default always passes).
    """

    def __init__(self, fleet: Fleet, cfg: Optional[LifecycleConfig] = None,
                 assign_fn: Optional[Callable[[int], int]] = None,
                 gate_fn: Optional[
                     Callable[[BasisRollout, Tuple[str, int]],
                              GateResult]] = None):
        self.fleet = fleet
        self.cfg = cfg or LifecycleConfig()
        self.assign_fn = assign_fn or self._hash_assign
        self.gate_fn = gate_fn or _default_gate
        self.adapters: Dict[int, AdapterState] = {}
        self.basis_version = 0
        self.rollout: Optional[BasisRollout] = None
        self.stats = LifecycleStats()
        self._last_refresh = 0.0
        self._shrink_pending: set = set()
        self._mode = fleet.engines[0].cfg.mode
        for eng in fleet.engines:
            self.attach_engine(eng)

    # -- fleet plumbing -----------------------------------------------------
    def attach_engine(self, eng) -> None:
        """Chain this lifecycle onto a replica's completion callback."""
        prev = eng.on_finish

        def hook(r: Request, _prev=prev) -> None:
            self.note_finish(r)
            if _prev is not None:
                _prev(r)

        eng.on_finish = hook

    def _hash_assign(self, aid: int) -> int:
        fp = getattr(self.fleet.engines[0].executor, "fp", None)
        k = max(1, getattr(fp, "n_clusters", 1))
        return aid % k

    def _executors(self):
        for eng in self.fleet.engines:
            yield eng.executor
        if self.fleet.prefill_tier is not None:
            for w in self.fleet.prefill_tier.workers:
                yield w.executor

    def _caches(self):
        for eng in self.fleet.engines:
            yield eng.cache
        if self.fleet.prefill_tier is not None:
            for w in self.fleet.prefill_tier.workers:
                yield w.cache

    def _mark_raw(self, aid: int, raw: bool) -> None:
        for ex in self._executors():
            fn = getattr(ex, "mark_raw" if raw else "unmark_raw", None)
            if fn is not None:
                fn(aid)

    def _discard_weights(self, aid: int, epoch: int) -> None:
        key = aid if epoch == 0 else (aid, epoch)
        for cache in self._caches():
            self.stats.bytes_released += cache.discard(key)

    @property
    def refresh_active(self) -> bool:
        """True while a basis rollout walks the fleet — the signal wired
        into :meth:`JointAutoscaler.decide
        <repro_torch.serving.autoscaler.JointAutoscaler.decide>` as
        ``refresh_active`` (a mid-rollout fleet must not shed replicas)."""
        return self.rollout is not None

    def state_of(self, aid: int) -> Optional[str]:
        st = self.adapters.get(aid)
        return None if st is None else st.state

    # -- register / update / retire ------------------------------------------
    def register(self, aid: int, now: float = 0.0) -> AdapterState:
        """Hot-register `aid`: raw-servable immediately (invariant L1).

        The adapter enters ``registered`` and transitions to
        ``raw-serving`` in the same control-plane action: every executor
        (decode replicas and prefill workers) gets the raw SGMV overlay,
        and the nearest cluster basis is assigned incrementally — routing
        affinity uses the cluster at once, while decode stays raw until a
        refresh rollout completes fleet-wide."""
        st = self.adapters.get(aid)
        if st is not None and st.live:
            raise ValueError(f"adapter {aid} is already live ({st.state})")
        epoch = st.epoch + 1 if st is not None else 0
        st = AdapterState(aid=aid, state=REGISTERED, epoch=epoch,
                          registered_at=now)
        self.adapters[aid] = st
        self._shrink_pending.discard(aid)     # re-registered before shrink
        self._mark_raw(aid, True)
        st.cluster = self.assign_fn(aid)
        self.fleet.cluster_of[aid] = st.cluster
        st.state = RAW_SERVING
        self.stats.n_registered += 1
        return st

    def update(self, aid: int, now: float = 0.0) -> AdapterState:
        """Replace `aid`'s weights: retire+register under a bumped epoch.

        In-flight requests keep decoding against the epoch they were
        stamped with — the two weight versions are distinct cache entries
        (:func:`~repro_torch.serving.request.weight_key`) — and the stale
        epoch's weights are released when its last request drains
        (invariant L4).  The new weights serve raw until a refresh
        absorbs them (their old Sigma no longer matches)."""
        st = self.adapters.get(aid)
        if st is None or not st.live:
            raise ValueError(f"cannot update unknown/retired adapter {aid}")
        old_epoch = st.epoch
        self._unabsorb(aid)
        st.epoch += 1
        st.state = RAW_SERVING
        st.registered_at = now
        self._mark_raw(aid, True)
        st.cluster = self.assign_fn(aid)
        self.fleet.cluster_of[aid] = st.cluster
        if old_epoch not in st.inflight:
            self._discard_weights(aid, old_epoch)
        self.stats.n_updated += 1
        return st

    def retire(self, aid: int, now: float = 0.0) -> AdapterState:
        """Retire `aid`: no new routing, drain what is in flight.

        Routing affinity is dropped immediately; cache/pool pages are
        released when the last in-flight request finishes; the Sigma row
        is dropped at the next basis refresh (lazy shrink) — invariant
        L5."""
        st = self.adapters.get(aid)
        if st is None or not st.live:
            raise ValueError(f"cannot retire unknown/retired adapter {aid}")
        self._unabsorb(aid)
        st.state = RETIRED
        st.retired_at = now
        self._drop_affinity(aid)
        self.stats.n_retired += 1
        if not st.inflight:
            self._finish_retirement(st)
        return st

    def _unabsorb(self, aid: int) -> None:
        """Pull `aid` out of an in-flight rollout's absorption set (its
        weights changed or it retired; the candidate basis no longer
        describes it)."""
        if self.rollout is not None:
            self.rollout.adapters = tuple(
                (a, e) for a, e in self.rollout.adapters if a != aid)

    def _drop_affinity(self, aid: int) -> None:
        self.fleet.drop_home(aid)
        if self.fleet.cfg.policy == "cluster_affinity":
            ckey = self.fleet.cluster_of.get(aid)
            if ckey is not None and not any(
                    k != aid and v == ckey
                    for k, v in self.fleet.cluster_of.items()):
                self.fleet.drop_home(ckey)

    def _finish_retirement(self, st: AdapterState) -> None:
        """The last in-flight request drained: release every replica's
        pages for every epoch and queue the lazy basis shrink."""
        self._discard_weights(st.aid, st.epoch)
        self._mark_raw(st.aid, False)
        self.fleet.cluster_of.pop(st.aid, None)
        self._shrink_pending.add(st.aid)

    # -- request flow --------------------------------------------------------
    def stamp(self, reqs: Sequence[Request]) -> None:
        """Stamp each request with its adapter's current weight epoch and
        count it in flight.  Call before ``fleet.submit`` — retired
        adapters are not routable and raise.  Requests for adapters this
        lifecycle does not manage (the pre-existing offline collection)
        pass through untouched at epoch 0."""
        for r in reqs:
            st = self.adapters.get(r.adapter_id)
            if st is None:
                continue
            if not st.live:
                raise ValueError(
                    f"request {r.rid} targets retired adapter {r.adapter_id}")
            r.adapter_epoch = st.epoch
            st.inflight[st.epoch] = st.inflight.get(st.epoch, 0) + 1
            if st.state == CLUSTER_ASSIGNED:
                self.stats.assigned_requests += 1
            else:
                self.stats.raw_requests += 1

    def note_finish(self, r: Request) -> None:
        """Observe a completion (wired into each engine's ``on_finish``):
        decrement the epoch's in-flight count and run any drain-deferred
        release — a stale epoch's weights after an update, or the full
        page/affinity release after a retire."""
        st = self.adapters.get(r.adapter_id)
        if st is None:
            return
        n = st.inflight.get(r.adapter_epoch, 0) - 1
        if n > 0:
            st.inflight[r.adapter_epoch] = n
        else:
            st.inflight.pop(r.adapter_epoch, None)
            if r.adapter_epoch != st.epoch:
                self._discard_weights(r.adapter_id, r.adapter_epoch)
            elif not st.live:
                self._finish_retirement(st)

    # -- background basis refresh --------------------------------------------
    def tick(self, now: float) -> None:
        """Advance the control plane to simulated time `now`: step an
        in-flight rollout (one replica per ``rollout_step_interval``) or
        start one when the refresh cadence has elapsed and work is
        pending.  Drivers call this once per window."""
        if self.rollout is not None:
            self._advance_rollout(now)
        if (self.rollout is None and self._mode == "jd"
                and now - self._last_refresh >= self.cfg.refresh_interval):
            pending = [(st.aid, st.epoch) for st in self.adapters.values()
                       if st.state == RAW_SERVING]
            if pending or self._shrink_pending:
                self._start_rollout(now, pending)
                self._advance_rollout(now)

    def _rollout_targets(self) -> Tuple[Tuple[str, int], ...]:
        targets = [("decode", i) for i in self.fleet._active_idxs()]
        tier = self.fleet.prefill_tier
        if tier is not None:
            targets += [("prefill", i) for i in tier._active_idxs()]
        return tuple(targets)

    def _start_rollout(self, now: float,
                       pending: List[Tuple[int, int]]) -> None:
        self.rollout = BasisRollout(
            version=self.basis_version + 1,
            adapters=tuple(sorted(pending)),
            shrinks=tuple(sorted(self._shrink_pending)),
            targets=self._rollout_targets(),
            started_at=now, next_at=now)
        self._last_refresh = now
        for aid, epoch in self.rollout.adapters:
            st = self.adapters[aid]
            if st.epoch == epoch and st.state == RAW_SERVING:
                st.state = REFRESHING
        self.stats.n_shrunk += len(self.rollout.shrinks)

    def _target_obj(self, target: Tuple[str, int]):
        kind, i = target
        if kind == "decode":
            return self.fleet.engines[i]
        return self.fleet.prefill_tier.workers[i]

    def _swap(self, target: Tuple[str, int], now: float) -> None:
        obj = self._target_obj(target)
        obj.refresh_shared(obj.executor.shared_bytes(), now)

    def _advance_rollout(self, now: float) -> None:
        ro = self.rollout
        while ro is not None and ro.next_idx < len(ro.targets) \
                and ro.next_at <= now:
            target = ro.targets[ro.next_idx]
            self._swap(target, ro.next_at)       # load candidate bases
            self.stats.n_gate_checks += 1
            gate = self.gate_fn(ro, target)      # kernel-vs-oracle check
            if (not gate.ok
                    or gate.agreement < self.cfg.gate_min_agreement
                    or gate.rel_err > self.cfg.gate_max_rel_err):
                self.stats.n_gate_failures += 1
                self._rollback(ro, now)
                return
            ro.next_idx += 1
            ro.next_at += self.cfg.rollout_step_interval
        if ro is not None and ro.next_idx >= len(ro.targets):
            self._complete_rollout(now)

    def _rollback(self, ro: BasisRollout, now: float) -> None:
        """A gate failed on a replica: every replica that holds the
        candidate basis (including the failed one) re-pins the prior
        basis, the rollout aborts, and the absorbed adapters keep serving
        raw (invariant L3).  The next cadence retries with a fresh
        candidate."""
        for target in ro.targets[:ro.next_idx + 1]:
            self._swap(target, now)              # re-pin the prior basis
        for aid, epoch in ro.adapters:
            st = self.adapters.get(aid)
            if st is not None and st.epoch == epoch \
                    and st.state == REFRESHING:
                st.state = RAW_SERVING
        self.stats.n_rollbacks += 1
        self.rollout = None
        self._last_refresh = now

    def _complete_rollout(self, now: float) -> None:
        """Every replica holds the new basis: absorbed adapters flip to
        cluster-assigned (their raw weights are released — the basis
        serves them; Sigma demand-loads), shrinks land, the version
        bumps."""
        ro = self.rollout
        self.basis_version = ro.version
        for aid, epoch in ro.adapters:
            st = self.adapters.get(aid)
            if st is None or st.epoch != epoch or st.state != REFRESHING:
                continue                          # updated/retired mid-roll
            st.state = CLUSTER_ASSIGNED
            self._mark_raw(aid, False)
            self._discard_weights(aid, epoch)
        for aid in ro.shrinks:
            self._shrink_pending.discard(aid)
        self.stats.n_refreshes += 1
        self.rollout = None
        self._last_refresh = now


# ---------------------------------------------------------------------------
# churn workloads + study driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LifecycleEvent:
    """One control-plane action in a churn stream."""
    t: float
    action: str                      # register | update | retire
    adapter_id: int


@dataclasses.dataclass
class ChurnSpec:
    """Poisson adapter arrival/retirement over a Zipf(ish) base load.

    `base` describes the steady-state request stream over the offline
    collection (adapter ids ``0..n_adapters-1``).  Churn adapters take
    ids from ``n_adapters`` upward: they register at Poisson rate
    `churn_rate`, live an exponential `lifetime`, emit their own Poisson
    `request_rate` stream while live, may see one mid-life weight update
    (`update_prob`), and retire at end of life.  Deterministic per
    `seed`."""
    base: WorkloadSpec
    churn_rate: float = 1.0          # registrations per second
    lifetime: float = 3.0            # mean seconds live before retirement
    request_rate: float = 20.0       # req/s per live churn adapter
    update_prob: float = 0.25        # chance of one mid-life update
    seed: int = 0


def make_churn_workload(spec: ChurnSpec
                        ) -> Tuple[List[Request], List[LifecycleEvent]]:
    """Generate (requests, events) for a churn study.

    Guarantees the driver relies on: every churn adapter's requests
    arrive strictly inside its [register, retire) window, and event/
    request interleaving is consistent under time-ordered replay."""
    base = make_workload(spec.base)
    horizon = base[-1].arrival_time if base else 1.0
    rng = np.random.default_rng(spec.seed + 0xC0FFEE)
    events: List[LifecycleEvent] = []
    churn_reqs: List[Request] = []
    rid = len(base)
    aid = spec.base.n_adapters
    t = 0.0
    while spec.churn_rate > 0:
        t += rng.exponential(1.0 / spec.churn_rate)
        if t >= horizon:
            break
        life = max(rng.exponential(spec.lifetime), 0.05)
        events.append(LifecycleEvent(t=t, action="register", adapter_id=aid))
        if rng.random() < spec.update_prob:
            events.append(LifecycleEvent(
                t=t + rng.uniform(0.3, 1.0) * life, action="update",
                adapter_id=aid))
        events.append(LifecycleEvent(t=t + life, action="retire",
                                     adapter_id=aid))
        tt = t
        while True:
            tt += rng.exponential(1.0 / spec.request_rate)
            if tt >= t + life:
                break
            plen = int(np.clip(rng.normal(spec.base.prompt_len_mean,
                                          spec.base.prompt_len_std),
                               16, 4 * spec.base.prompt_len_mean))
            churn_reqs.append(Request(
                rid=rid, adapter_id=aid, prompt_len=plen,
                max_new_tokens=spec.base.new_tokens, arrival_time=tt))
            rid += 1
        aid += 1
    events.sort(key=lambda e: e.t)
    reqs = sorted(base + churn_reqs, key=lambda r: r.arrival_time)
    return reqs, events


def apply_event(lc: AdapterLifecycle, ev: LifecycleEvent) -> None:
    if ev.action == "register":
        lc.register(ev.adapter_id, now=ev.t)
    elif ev.action == "update":
        lc.update(ev.adapter_id, now=ev.t)
    elif ev.action == "retire":
        lc.retire(ev.adapter_id, now=ev.t)
    else:
        raise ValueError(f"unknown lifecycle action {ev.action!r}")


def run_churn_study(fleet: Fleet, lifecycle: AdapterLifecycle,
                    requests: Sequence[Request],
                    events: Sequence[LifecycleEvent],
                    window: float = 0.25,
                    max_steps: int = 10_000_000) -> FleetStats:
    """Drive a fleet through a request stream *and* a lifecycle event
    stream in causal time order.

    Per window: interleave arrivals and control-plane events by time (a
    register is visible to the requests behind it; a retire rejects
    nothing retroactively — in-flight requests drain per invariant L4/L5),
    advance the lifecycle (rollout pacing) and every replica to the window
    end.  Returns merged :class:`~repro_torch.serving.router.FleetStats` with
    ``stats.lifecycle`` filled in.

    Thin wrapper over the unified window loop
    (:func:`repro_torch.serving.simulator.run_study`), kept for its established
    signature; proven bit-exact against the committed churn baseline."""
    from .simulator import run_study     # local: simulator imports us
    return run_study(fleet, requests, lifecycle=lifecycle, events=events,
                     window=window, max_steps=max_steps).stats
