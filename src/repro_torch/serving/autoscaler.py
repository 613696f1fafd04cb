"""SLO-driven autoscaling for elastic fleets: decode-only and joint (the
port's copy of ``serving/autoscaler.py``).

The ROADMAP's autoscaling item: `Fleet` exposes per-replica load and latency
percentiles; this module closes the loop.  An :class:`Autoscaler` watches
windowed TTFT/TPOT percentiles against a :class:`SLOConfig` and decides to
add or retire decode replicas; :func:`run_autoscaled` drives a fleet through
the request stream in decision windows, applying those decisions and
re-homing JD clusters on every membership change (``Fleet.rehome``).

The policy is deliberately simple and deterministic (simulations must be
reproducible): threshold + hysteresis + cooldown, the shape production
autoscalers (KEDA/HPA-style) reduce to once jitter is removed.

  - scale UP when the window's p95 TTFT (or p95 TPOT) exceeds its SLO, or
    when the window starved (backlog but no finishes — the fleet is so far
    behind that latency samples stopped arriving);
  - scale DOWN when p95 TTFT sits below ``down_fraction`` of the SLO and
    the backlog is small — hysteresis so the fleet doesn't flap;
  - at most ``max_step`` replicas change per decision, with
    ``cooldown_intervals`` quiet windows after any change.

:class:`JointAutoscaler` generalizes this to *both* tiers of a
disaggregated fleet under a fixed
:class:`~repro_torch.serving.resources.HardwareBudget`: the decode tier is scaled
from TPOT and the decode-side TTFT component exactly as above, the prefill
tier from its queue depth and its TTFT contribution (arrival ->
decode-ready), and when the budget pool is exhausted the policy *trades* —
it retires a worker/replica from a comfortable tier to fund the pressured
one.  :func:`run_joint_autoscaled` is the matching window driver.

With compressed KV handoffs
(:class:`~repro_torch.serving.resources.KVCompressionConfig`) the decode tier
also pays a per-request dequantization cost at admission; the driver
reports that load as a window utilization fraction and the policy refuses
to classify a decode tier cold while it exceeds
``decompress_cold_util`` — wire compression must not trick the trader
into robbing the tier that is paying for it.

With unified paging (decode engines built over a
:class:`~repro_torch.serving.resources.PagedPool`) the joint autoscaler's budget
accounting sees *pages*, not just whole-replica footprints: the driver
reports the worst replica's pool utilization (``kv_page_util``, fraction of
pages in use) and the policy classifies a page-saturated decode tier hot —
admissions there are blocking on memory, which latency percentiles can
miss entirely when the running batch is small but its KV reservations are
large — and never cold, so a trade cannot retire the replica that is the
fleet's page headroom.

With an *adaptive* fabric policy
(:class:`~repro_torch.serving.resources.AdaptiveCompressionPolicy`) the joint
autoscaler gains a third axis: the policy's mode ceiling.  When the
prefill tier is hot, the pool is exhausted, and the fabric horizon
(``fabric_lag_s``) shows the wire is actually the pressure, the policy's
ceiling is raised — trading quantization error for bytes — *before* the
trader robs a cold decode tier of a replica; in quiet windows the ceiling
relaxes back so an idle fabric ships raw.  Both moves are recorded in
:class:`JointScaleDecision` (``d_comp`` / ``comp_ceiling``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .prefill import PrefillWorker
from .request import Request
from .resources import AdaptiveCompressionPolicy, HardwareBudget
from .router import Fleet, FleetStats
from .engine import ServingEngine


@dataclasses.dataclass
class SLOConfig:
    """Latency objectives, evaluated at p95 over each decision window."""
    ttft_p95: float = 0.25           # seconds arrival -> first token
    tpot_p95: float = float("inf")   # seconds/token after the first

    def violated(self, ttft_p95: float, tpot_p95: float) -> bool:
        return ttft_p95 > self.ttft_p95 or tpot_p95 > self.tpot_p95


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    decision_interval: float = 0.25  # simulated seconds per window
    down_fraction: float = 0.4       # scale down only below this SLO fraction
    backlog_per_replica: float = 4.0  # "small backlog" bound for scale-down
    cooldown_intervals: int = 2      # quiet windows after a change
    max_step: int = 1                # replicas changed per decision


@dataclasses.dataclass
class ScaleDecision:
    t: float
    n_active: int
    ttft_p95: float
    tpot_p95: float
    backlog: int
    delta: int


class Autoscaler:
    """Threshold/hysteresis policy over windowed latency percentiles."""

    def __init__(self, cfg: AutoscalerConfig, slo: SLOConfig):
        self.cfg = cfg
        self.slo = slo
        self.history: List[ScaleDecision] = []
        self._cooldown = 0

    def decide(self, now: float, ttfts: Sequence[float],
               tpots: Sequence[float], n_active: int, backlog: int) -> int:
        """Replica-count delta for this window (>0 add, <0 retire)."""
        ttft_p95 = float(np.percentile(ttfts, 95)) if len(ttfts) else 0.0
        tpot_p95 = float(np.percentile(tpots, 95)) if len(tpots) else 0.0
        starved = not ttfts and backlog > 0
        delta = 0
        if self._cooldown > 0:
            self._cooldown -= 1
        elif (starved or self.slo.violated(ttft_p95, tpot_p95)) \
                and n_active < self.cfg.max_replicas:
            delta = min(self.cfg.max_step, self.cfg.max_replicas - n_active)
        elif (ttfts and not self.slo.violated(ttft_p95, tpot_p95)
              and ttft_p95 < self.cfg.down_fraction * self.slo.ttft_p95
              and backlog <= self.cfg.backlog_per_replica * n_active
              and n_active > self.cfg.min_replicas):
            delta = -min(self.cfg.max_step, n_active - self.cfg.min_replicas)
        if delta:
            self._cooldown = self.cfg.cooldown_intervals
        self.history.append(ScaleDecision(
            t=now, n_active=n_active, ttft_p95=ttft_p95, tpot_p95=tpot_p95,
            backlog=backlog, delta=delta))
        return delta


# ---------------------------------------------------------------------------
# joint prefill/decode autoscaling under a fixed hardware budget
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JointAutoscalerConfig:
    """Policy knobs for two-tier scaling under a fixed budget.

    ``prefill_share`` splits the TTFT SLO between the tiers: the prefill
    tier (queueing + prefill compute + first-chunk transfer) is considered
    pressured when its p95 contribution exceeds ``prefill_share *
    slo.ttft_p95``; the decode tier when its p95 wait (decode-ready ->
    first token) exceeds the remaining share, when p95 TPOT violates, or
    when it starves.  Hysteresis and cooldown mirror the decode-only
    policy.
    """
    min_prefill: int = 1
    min_decode: int = 1
    decision_interval: float = 0.25  # simulated seconds per window
    prefill_share: float = 0.5       # TTFT-SLO fraction budgeted to prefill
    down_fraction: float = 0.4       # scale down only below this share frac
    backlog_per_replica: float = 4.0  # per-tier "small backlog" bound
    cooldown_intervals: int = 2      # quiet windows after any change
    # compressed-KV handoff: a decode tier spending more than this fraction
    # of its window capacity on KV decompression is never classified cold —
    # retiring a replica would re-concentrate that dequantization load on
    # the survivors even when per-request decode waits look comfortable
    decompress_cold_util: float = 0.25
    # unified paging (engines with a PagedPool): a decode tier whose
    # worst replica has page utilization above page_hot_util (fraction of
    # pool pages in use, 0..1) is classified hot even when latency looks
    # fine — admissions are blocking on MEMORY, and more replicas is the
    # only lever that adds pages; the same bound vetoes the cold
    # classification, so the trader never retires a replica whose pool is
    # nearly full
    page_hot_util: float = 0.92
    # adaptive-compression axis (needs a bound AdaptiveCompressionPolicy):
    # raise the fabric's mode ceiling when prefill is hot, the pool is
    # exhausted, and the fabric's resolved horizon extends this far past
    # the window end (the wire, not prefill compute, is the pressure);
    # relax the ceiling in windows where the horizon is below the relax
    # bound and nothing is hot — but never below the ceiling the policy
    # was bound with (the autoscaler only takes back headroom it granted)
    comp_escalate_lag_s: float = 0.05
    comp_relax_lag_s: float = 0.01


@dataclasses.dataclass
class JointScaleDecision:
    t: float
    n_prefill: int
    n_decode: int
    free_accels: int
    ttft_p95: float
    tpot_p95: float
    prefill_lag_p95: float
    decode_wait_p95: float
    prefill_backlog: int
    decode_backlog: int
    d_prefill: int
    d_decode: int
    decompress_util: float = 0.0     # decode-tier KV-dequant utilization
    d_comp: int = 0                  # mode-ceiling delta (+1 raise, -1 relax)
    comp_ceiling: Optional[str] = None   # ceiling mode after this decision
    fabric_lag_s: float = 0.0        # fabric horizon past the window end
    kv_page_util: float = 0.0        # worst decode replica's page pressure
    refresh_active: bool = False     # basis-refresh rollout in flight
    # typed pools only: which slice class a +1 delta should land on
    prefill_slice: Optional[str] = None
    decode_slice: Optional[str] = None


class JointAutoscaler:
    """Trades prefill vs decode capacity under a fixed hardware budget.

    Per window each tier is classified hot / cold / ok from its own SLO
    share and backlog; a hot tier grows from the free pool when possible,
    and otherwise *takes* capacity from the other tier if that tier is
    cold (retire + drain there, add here).  Both-hot spends any free
    budget on the tier that is proportionally worse.  At most one
    worker/replica moves per tier per decision.

    Two extra signals refine the classification: ``kv_page_util`` (worst
    replica's unified-pool occupancy) marks decode hot on page pressure
    before eviction churn reaches the percentiles, and ``refresh_active``
    (a basis rollout is walking the fleet) vetoes treating decode as cold
    — comfortable mid-rollout percentiles are the rollout hiding load.
    """

    def __init__(self, cfg: JointAutoscalerConfig, slo: SLOConfig,
                 budget: HardwareBudget,
                 comp_policy: Optional[AdaptiveCompressionPolicy] = None):
        need = (cfg.min_prefill * budget.cfg.cost("prefill")
                + cfg.min_decode * budget.cfg.cost("decode"))
        if need > budget.cfg.total_units:
            raise ValueError(
                f"budget too small for the tier floors: min_prefill="
                f"{cfg.min_prefill} x {budget.cfg.cost('prefill')} accels + "
                f"min_decode={cfg.min_decode} x "
                f"{budget.cfg.cost('decode')} accels needs {need}, pool has "
                f"{budget.cfg.total_units}")
        self.cfg = cfg
        self.slo = slo
        self.budget = budget
        self.comp_policy = None
        self._comp_floor = 0
        if comp_policy is not None:
            self.bind_compression(comp_policy)
        self.history: List[JointScaleDecision] = []
        self._cooldown = 0
        # previous window's decompress_util: "sustained" decode-side
        # dequant pressure = above the cold threshold two windows running
        self._prev_decompress_util = 0.0

    def bind_compression(self, policy: AdaptiveCompressionPolicy) -> None:
        """Attach the fabric's adaptive policy as the compression axis.

        The ceiling at bind time becomes this autoscaler's relax floor: it
        only lowers a ceiling it previously raised, so a fabric configured
        to own its full ladder (``initial_ceiling=None``) is never quietly
        ratcheted down to raw by warm-up windows."""
        self.comp_policy = policy
        self._comp_floor = policy.ceiling

    def _escalate(self, fabric_lag_s: float) -> bool:
        """Raise the bound policy's mode ceiling when the wire (not
        compute) is the pressure — the free compute-for-bytes lever tried
        before any replica trade."""
        return (self.comp_policy is not None
                and fabric_lag_s > self.cfg.comp_escalate_lag_s
                and self.comp_policy.raise_ceiling())

    @staticmethod
    def _p95(xs: Sequence[float]) -> float:
        return float(np.percentile(xs, 95)) if len(xs) else 0.0

    def pick_slice(self, role: str, extra_units: int = 0):
        """Which slice class a +1 `role` delta should land on (None for an
        untyped pool — the legacy accelerator).

        Preference order encodes the tiers' rooflines: **prefill** wants
        the fastest compute per worker (big slices first — prefill is
        compute-bound and one fast worker beats two slow ones on p95 lag),
        **decode** wants the best bandwidth *per cost unit* (small slices
        first at equal efficiency — decode scales out and more replicas
        mean more aggregate HBM streams and more pool pages).  The first
        affordable type in preference order wins, where "affordable"
        includes `extra_units` a same-decision trade is about to free;
        with nothing affordable the cheapest type is returned so the
        caller's exhaustion handling (escalate / trade) sees the floor
        price."""
        cfg = self.budget.cfg
        if not cfg.typed:
            return None
        if role == "prefill":
            def key(st):
                return (-st.prefill_speed, st.cost(role), st.name)
        else:
            def key(st):
                return (-(st.decode_speed / st.cost(role)),
                        st.cost(role), st.name)
        ranked = sorted(cfg.types(), key=key)
        affordable = self.budget.available + extra_units
        for st in ranked:
            if st.cost(role) <= affordable:
                return st
        return min(ranked, key=lambda st: st.cost(role))

    def _trade_frees_enough(self, donor: str, receiver: str,
                            donor_units: Optional[int] = None) -> bool:
        """Retiring one `donor` unit must free enough cost units for one
        `receiver` unit.  Footprints differ per role AND per slice type:
        `donor_units` is the actual cost of the unit that would retire (a
        typed fleet's donor tier can hold mixed slice classes — the
        driver reports what its scale-down victim occupies); left None,
        the legacy per-role footprint / cheapest-type floor is assumed.
        The receiver side prices the slice :meth:`pick_slice` would
        choose given the freed units."""
        du = (donor_units if donor_units is not None
              else self.budget.cfg.cost(donor))
        ru = self.budget.cfg.cost(
            receiver, self.pick_slice(receiver, extra_units=du))
        return self.budget.available + du >= ru

    def decide(self, now: float, ttfts: Sequence[float],
               tpots: Sequence[float], decode_waits: Sequence[float],
               prefill_lags: Sequence[float], n_prefill: int, n_decode: int,
               prefill_backlog: int, decode_backlog: int,
               decompress_util: float = 0.0,
               fabric_lag_s: float = 0.0,
               kv_page_util: float = 0.0,
               refresh_active: bool = False,
               retire_prefill_units: Optional[int] = None,
               retire_decode_units: Optional[int] = None) -> Tuple[int, int]:
        """(prefill delta, decode delta) for this window, each in -1/0/+1.

        Units: latency sequences are per-request **seconds** observed in
        the window; backlogs are request **counts**; ``decompress_util``,
        ``kv_page_util`` are dimensionless fractions in [0, 1];
        ``fabric_lag_s`` is **seconds**.

        ``decompress_util`` is the decode tier's window-fraction spent
        dequantizing compressed KV handoffs (0 when the fabric ships raw
        KV); it vetoes the cold classification — see
        :attr:`JointAutoscalerConfig.decompress_cold_util`.

        ``fabric_lag_s`` is how far the KV fabric's resolved horizon
        extends past the window end — the wire-saturation signal that
        gates the compression axis: a bound adaptive policy's ceiling is
        raised (instead of a trade) only when the wire is actually the
        pressure, and relaxed only in windows where it is quiet.

        ``kv_page_util`` is the worst decode replica's unified-pool page
        utilization (0 for non-paged engines): above
        :attr:`JointAutoscalerConfig.page_hot_util` the decode tier is
        memory-pressured — hot regardless of latency, and never cold.

        ``refresh_active`` is the adapter lifecycle's rollout signal: a
        basis refresh is walking the decode replicas one at a time
        (``AdapterLifecycle``, docs/lifecycle.md).  It vetoes the cold
        classification — replicas take turns stalled on base swaps, so a
        comfortable window percentile is the rollout hiding load, and
        retiring a replica mid-rollout would churn the replica set the
        rollout is walking.

        ``retire_prefill_units`` / ``retire_decode_units`` (typed pools):
        the cost units the tier's scale-down victim actually occupies —
        what a trade would free.  None falls back to the per-role
        footprint (exact for untyped pools, the cheapest-type floor for
        typed ones)."""
        cfg = self.cfg
        ttft_p95 = self._p95(ttfts)
        tpot_p95 = self._p95(tpots)
        pre_p95 = self._p95(prefill_lags)
        dwait_p95 = self._p95(decode_waits)

        pre_slo = cfg.prefill_share * self.slo.ttft_p95
        dec_slo = (1.0 - cfg.prefill_share) * self.slo.ttft_p95
        pre_hot = (pre_p95 > pre_slo
                   or prefill_backlog > cfg.backlog_per_replica * n_prefill)
        pre_cold = (not pre_hot
                    and pre_p95 < cfg.down_fraction * pre_slo
                    and prefill_backlog <= n_prefill)
        starved = not ttfts and decode_backlog > 0
        dec_hot = (starved or tpot_p95 > self.slo.tpot_p95
                   or dwait_p95 > dec_slo
                   or decode_backlog > cfg.backlog_per_replica * n_decode
                   or kv_page_util > cfg.page_hot_util)
        dec_cold = (not dec_hot and bool(ttfts)
                    and dwait_p95 < cfg.down_fraction * dec_slo
                    and tpot_p95 <= cfg.down_fraction * min(self.slo.tpot_p95,
                                                            1e12)
                    and decode_backlog <= n_decode
                    and decompress_util < cfg.decompress_cold_util
                    and not refresh_active)

        d_pre = d_dec = d_comp = 0
        if self._cooldown > 0:
            self._cooldown -= 1
        elif pre_hot and dec_hot:
            # both pressured: spend free budget on the proportionally worse
            # tier (no trade — robbing a hot tier makes things worse)
            pre_sev = pre_p95 / max(pre_slo, 1e-12)
            dec_sev = dwait_p95 / max(dec_slo, 1e-12)
            if starved or tpot_p95 > self.slo.tpot_p95:
                dec_sev = max(dec_sev, 2.0 * pre_sev + 1.0)
            order = (["decode", "prefill"] if dec_sev >= pre_sev
                     else ["prefill", "decode"])
            for role in order:
                if self.budget.can_allocate(role):
                    if role == "prefill":
                        d_pre = 1
                    else:
                        d_dec = 1
                    break
            else:
                # nothing allocatable and no tier may be robbed; shrinking
                # wire bytes is the one lever that helps both tiers
                if self._escalate(fabric_lag_s):
                    d_comp = 1
        elif pre_hot:
            if self.budget.can_allocate("prefill"):
                d_pre = 1
            elif self._escalate(fabric_lag_s):
                # the pool is exhausted and the wire is the pressure:
                # spend quantization error before robbing the other tier
                d_comp = 1
            elif (dec_cold and n_decode > cfg.min_decode
                  and self._trade_frees_enough("decode", "prefill",
                                               retire_decode_units)):
                d_pre, d_dec = 1, -1             # trade: decode funds prefill
        elif dec_hot:
            if self.budget.can_allocate("decode"):
                d_dec = 1
            elif (pre_cold and n_prefill > cfg.min_prefill
                  and self._trade_frees_enough("prefill", "decode",
                                               retire_prefill_units)):
                d_pre, d_dec = -1, 1             # trade: prefill funds decode
        elif (decompress_util >= cfg.decompress_cold_util
              and self._prev_decompress_util >= cfg.decompress_cold_util
              and self.comp_policy is not None
              and self.comp_policy.ceiling > self._comp_floor
              and self.comp_policy.lower_ceiling()):
            # sustained decode-side dequant pressure (a full window above
            # the cold threshold on both sides of this decision): the
            # compression that saved wire bytes is now taxing decode
            # compute every window — relax the ceiling one level even
            # though the wire isn't quiet.  Without this branch the high
            # decompress_util itself vetoes dec_cold, so nothing on the
            # decode axis ever moved and the tax was permanent.
            d_comp = -1
        elif pre_cold and n_prefill > cfg.min_prefill:
            d_pre = -1                           # release to the pool
        elif dec_cold and n_decode > cfg.min_decode:
            d_dec = -1
        elif (self.comp_policy is not None
              and fabric_lag_s < cfg.comp_relax_lag_s
              and self.comp_policy.ceiling > self._comp_floor
              and self.comp_policy.lower_ceiling()):
            d_comp = -1                          # quiet window: ship raw again
        if d_pre or d_dec or d_comp:
            self._cooldown = cfg.cooldown_intervals
        self._prev_decompress_util = decompress_util
        pre_slice = dec_slice = None
        if self.budget.cfg.typed:
            if d_pre > 0:
                freed = (retire_decode_units
                         or self.budget.cfg.cost("decode")) if d_dec < 0 else 0
                pre_slice = self.pick_slice("prefill", extra_units=freed)
            if d_dec > 0:
                freed = (retire_prefill_units
                         or self.budget.cfg.cost("prefill")) if d_pre < 0 else 0
                dec_slice = self.pick_slice("decode", extra_units=freed)
        self.history.append(JointScaleDecision(
            t=now, n_prefill=n_prefill, n_decode=n_decode,
            free_accels=self.budget.available, ttft_p95=ttft_p95,
            tpot_p95=tpot_p95, prefill_lag_p95=pre_p95,
            decode_wait_p95=dwait_p95, prefill_backlog=prefill_backlog,
            decode_backlog=decode_backlog, d_prefill=d_pre, d_decode=d_dec,
            decompress_util=decompress_util, d_comp=d_comp,
            comp_ceiling=(self.comp_policy.ceiling_mode
                          if self.comp_policy is not None else None),
            fabric_lag_s=fabric_lag_s, kv_page_util=kv_page_util,
            refresh_active=refresh_active,
            prefill_slice=pre_slice.name if pre_slice else None,
            decode_slice=dec_slice.name if dec_slice else None))
        return d_pre, d_dec


def run_joint_autoscaled(fleet: Fleet, requests: Sequence[Request],
                         autoscaler: JointAutoscaler,
                         decode_factory: Callable[[], ServingEngine],
                         prefill_factory: Callable[[], PrefillWorker],
                         max_steps: int = 10_000_000) -> FleetStats:
    """Drive a *disaggregated* fleet through `requests`, scaling both tiers
    under the autoscaler's :class:`~repro_torch.serving.resources.HardwareBudget`.

    Per window: route the window's arrivals (the prefill tier runs eagerly
    and stamps decode-readiness), advance every decode replica to the
    window end, observe the tiers' latency components, then apply the
    joint decision.  Membership changes are symmetric: retired decode
    replicas and prefill workers drain what they hold but receive no new
    work, and their accelerators return to the pool at retire time (the
    drain tail is the hand-over cost).  JD clusters re-home on decode
    membership changes.

    Thin wrapper over the unified window loop
    (:func:`repro_torch.serving.simulator.run_study`), kept for its established
    signature; proven bit-exact against the committed joint baselines.
    """
    from .simulator import run_study     # local: simulator imports us
    return run_study(fleet, requests, autoscaler=autoscaler,
                     decode_factory=decode_factory,
                     prefill_factory=prefill_factory,
                     max_steps=max_steps).stats


def run_autoscaled(fleet: Fleet, requests: Sequence[Request],
                   autoscaler: Autoscaler,
                   engine_factory: Callable[[], ServingEngine],
                   max_steps: int = 10_000_000) -> FleetStats:
    """Drive `fleet` through `requests` in decision windows.

    Per window: route the window's arrivals (prefill-tier-first when the
    fleet is disaggregated), advance every replica to the window end,
    observe TTFT/TPOT of requests that finished inside the window, then
    apply the autoscaler's decision — ``engine_factory()`` builds a decode
    replica that joins at the window boundary; scale-down retires the most
    recently added active replica (drains, no new work).  Membership
    changes re-home JD clusters.  After the last arrival the fleet runs to
    completion and merged stats are returned.

    Thin wrapper over the unified window loop
    (:func:`repro_torch.serving.simulator.run_study`), kept for its established
    signature; proven bit-exact against the committed elastic baselines.
    """
    from .simulator import run_study     # local: simulator imports us
    return run_study(fleet, requests, autoscaler=autoscaler,
                     decode_factory=engine_factory,
                     max_steps=max_steps).stats
