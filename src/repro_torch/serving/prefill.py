"""Disaggregated prefill tier: prefill as schedulable work + KV handoff
(the port's copy of ``serving/prefill.py``).

The colocated engine serializes prefill inside ``ServingEngine._admit``,
so a long prompt blocks every decode slot on the replica (head-of-line
blocking).  Disaggregated serving (InfiniLoRA, arXiv:2604.07173; Splitwise)
moves prefill to a dedicated tier:

  - :class:`PrefillWorker` — one prefill replica with its own simulated
    clock, batch queue, and :class:`~repro_torch.serving.adapter_cache.AdapterCache`
    (adapters must be resident on the *prefill* device too; compressed "jd"
    collections pin their shared bases here exactly as on decode).
    Admission reuses the decode scheduler's adapter/cluster-aware ordering;
    prefill compute within an admitted batch is serialized (compute-bound).
  - :class:`~repro_torch.serving.resources.KVFabric` — the shared, contended
    prefill->decode interconnect.  Workers *record* each produced KV cache
    on the fabric as its prefill completes (handoff never blocks the
    worker's next prefill); the fabric schedules chunks across all workers'
    transfers and stamps ``decode_ready_time`` (first chunk) /
    ``kv_landed_time`` (last chunk).  A standalone worker owns a private
    single-link-equivalent fabric, which reproduces the private-link
    :class:`TransferLink` times bit-exactly.
  - :class:`PrefillTier` — routes requests across *active* workers
    (least-outstanding, deterministic) and supports elastic membership
    symmetric with the decode fleet: :meth:`add_worker` joins a worker
    mid-stream, :meth:`retire_worker` stops routing to one while it drains
    its remaining queue — so the joint autoscaler can shrink this tier to
    fund the other under a fixed :class:`~repro_torch.serving.resources.HardwareBudget`.

The tier is feed-forward: decode never blocks prefill, so the whole tier
can be simulated eagerly as requests are submitted (window-by-window under
the autoscaler) without a global event queue; the fabric resolves at each
drain, carrying channel backlog across windows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .adapter_cache import AdapterCache, CacheConfig
from .request import Request, weight_key
from .resources import (FabricConfig, FabricStats, KVFabric, PagedPool,
                        PagedPoolConfig, kv_bytes_per_token, merge_mode_dict)
from .scheduler import Scheduler, SchedulerConfig


@dataclasses.dataclass
class TransferLink:
    """Compatibility: one private prefill->decode link.

    Kept as the configuration surface for the degenerate fabric (a
    single-worker fabric with serial chunks is bit-exact with this model:
    ``latency + nbytes / bandwidth``, serialized per link).  New code should
    configure :class:`~repro_torch.serving.resources.FabricConfig` instead.
    """
    bandwidth: float = 50e9          # bytes/s prefill -> decode
    latency: float = 200e-6          # per-handoff fixed cost

    def time_for(self, nbytes: int) -> float:
        return self.latency + nbytes / self.bandwidth


@dataclasses.dataclass
class PrefillConfig:
    n_workers: int = 1
    max_batch: int = 8               # admission group (adapter reuse window)
    adapter_budget_bytes: float = 2e9
    mode: str = "lora"               # lora | jd (pins shared bases)
    link: TransferLink = dataclasses.field(default_factory=TransferLink)
    # shared-fabric override: when set, the tier builds one KVFabric from
    # this config and all workers contend on it (chunked/streamed handoff);
    # when None, the tier's fabric is derived from `link` (aggregate
    # bandwidth = one link's worth, serial chunks)
    fabric: Optional[FabricConfig] = None
    # unified paging: when set, each worker's adapter cache allocates whole
    # pages from its own PagedPool (same allocator as decode replicas —
    # prefill holds no decode KV, so only adapter/pinned pages are used);
    # None keeps the legacy byte-budget cache
    pool: Optional[PagedPoolConfig] = None

    def fabric_config(self) -> FabricConfig:
        return self.fabric or FabricConfig(bandwidth=self.link.bandwidth,
                                           latency=self.link.latency,
                                           chunk_bytes=0)


@dataclasses.dataclass
class PrefillStats:
    n_prefills: int = 0
    compute_time: float = 0.0        # prefill FLOP time
    swap_time: float = 0.0           # adapter-residency stalls
    compress_time: float = 0.0       # KV wire-compression (quantize) time
    transfer_time: float = 0.0       # sum of per-request KV handoff times
    kv_bytes_moved: int = 0          # bytes on the wire (post-compression)
    kv_raw_bytes: int = 0            # bytes produced by prefill
    n_swaps: int = 0
    n_chunks: int = 0                # fabric chunks shipped (disagg)
    # per-wire-mode fabric accounting (adaptive compression picks a mode
    # per transfer; "raw" keys the uncompressed ones)
    kv_wire_bytes_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    kv_raw_bytes_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    n_mode_switches: int = 0         # adaptive-policy level changes

    @classmethod
    def merged(cls, parts: Sequence["PrefillStats"]) -> "PrefillStats":
        out = cls()
        for s in parts:
            out.n_prefills += s.n_prefills
            out.compute_time += s.compute_time
            out.swap_time += s.swap_time
            out.compress_time += s.compress_time
            out.transfer_time += s.transfer_time
            out.kv_bytes_moved += s.kv_bytes_moved
            out.kv_raw_bytes += s.kv_raw_bytes
            out.n_swaps += s.n_swaps
            out.n_chunks += s.n_chunks
            merge_mode_dict(out.kv_wire_bytes_by_mode,
                            s.kv_wire_bytes_by_mode)
            merge_mode_dict(out.kv_raw_bytes_by_mode, s.kv_raw_bytes_by_mode)
            out.n_mode_switches += s.n_mode_switches
        return out

    def add_fabric(self, fs: FabricStats) -> "PrefillStats":
        self.transfer_time += fs.transfer_time
        self.kv_bytes_moved += fs.kv_bytes_moved
        self.kv_raw_bytes += fs.kv_raw_bytes
        self.n_chunks += fs.n_chunks
        merge_mode_dict(self.kv_wire_bytes_by_mode, fs.wire_bytes_by_mode)
        merge_mode_dict(self.kv_raw_bytes_by_mode, fs.raw_bytes_by_mode)
        self.n_mode_switches += fs.n_mode_switches
        return self

    def to_dict(self) -> Dict:
        return {
            "n_prefills": self.n_prefills,
            "prefill_compute_s": self.compute_time,
            "prefill_swap_s": self.swap_time,
            "kv_compress_s": self.compress_time,
            "kv_transfer_s": self.transfer_time,
            "kv_bytes_moved": self.kv_bytes_moved,
            "kv_raw_bytes": self.kv_raw_bytes,
            "kv_chunks": self.n_chunks,
            "kv_wire_bytes_by_mode": dict(self.kv_wire_bytes_by_mode),
            "kv_raw_bytes_by_mode": dict(self.kv_raw_bytes_by_mode),
            "kv_mode_switches": self.n_mode_switches,
            "prefill_n_swaps": self.n_swaps,
        }


class PrefillWorker:
    """One prefill replica: batch queue + adapter cache + serialized compute.

    The executor provides ``prefill_time(req)``, ``adapter_bytes(aid)``,
    ``shared_bytes()`` and ``kv_bytes(req)`` (see
    :class:`~repro_torch.serving.engine.CostModelExecutor`).

    KV handoff goes through ``self.fabric``.  A worker constructed without
    one owns a private fabric derived from ``cfg`` (single-link
    semantics) and resolves it on :meth:`drain`; a worker inside a
    :class:`PrefillTier` is re-bound to the tier's shared fabric, which the
    tier resolves after all workers drain.
    """

    def __init__(self, cfg: PrefillConfig, executor,
                 cluster_of: Optional[Dict[int, int]] = None,
                 fabric: Optional[KVFabric] = None,
                 slice_type=None):
        if cfg.max_batch < 1:
            raise ValueError("PrefillConfig.max_batch must be >= 1")
        self.cfg = cfg
        self.executor = executor
        # the hardware slice class this worker occupies (None: the legacy
        # interchangeable accelerator); run_study releases the matching
        # budget allocation when the worker retires
        self.slice_type = slice_type
        self.scheduler = Scheduler(SchedulerConfig(max_batch=cfg.max_batch),
                                   cluster_of)
        self.pool = None if cfg.pool is None else PagedPool(cfg.pool)
        self.cache = AdapterCache(CacheConfig(cfg.adapter_budget_bytes),
                                  pool=self.pool)
        if cfg.mode == "jd":
            self.cache.pin_shared(executor.shared_bytes())
        self.fabric = fabric or KVFabric(cfg.fabric_config())
        self._owns_fabric = fabric is None
        self.clock = 0.0
        self.waiting: List[Request] = []
        self.stats = PrefillStats()

    @property
    def outstanding(self) -> int:
        return len(self.waiting)

    def submit(self, reqs: Sequence[Request]) -> None:
        self.waiting.extend(reqs)
        self.waiting.sort(key=lambda r: r.arrival_time)

    def refresh_shared(self, nbytes: int, now: float) -> float:
        """Swap this worker's pinned shared bases (basis-refresh rollout
        step / rollback) — symmetric with
        :meth:`repro_torch.serving.engine.ServingEngine.refresh_shared`: the DMA
        stalls this worker's clock while the rest of the tier serves."""
        self.clock = max(self.clock, now)
        t_done = self.cache.repin_shared(nbytes, self.clock)
        self.stats.swap_time += t_done - self.clock
        self.clock = t_done
        return t_done

    def _handoff(self, req: Request) -> None:
        """Record the produced KV cache on the fabric (never blocks this
        worker's next prefill); the fabric stamps readiness at resolve.

        The fabric plans the transfer's wire mode first (the static
        per-fabric mode, or the adaptive policy's live-backlog pick).
        When it compresses, the quantize / projection kernel runs on THIS
        worker between prefills — the compression cost is serialized on
        the worker's clock before the handoff is recorded, so a
        compressed transfer starts later but ships fewer bytes.  A raw
        pick (and a raw-locked adaptive policy) charges nothing, exactly
        like a ``compression=None`` fabric."""
        nbytes = self.executor.kv_bytes(req)
        comp = self.fabric.plan(req, self.clock, nbytes)
        if comp is not None:
            t_comp = comp.compress_time(
                nbytes, kv_bytes_per_token(nbytes, req.prompt_len))
            self.clock += t_comp
            self.stats.compress_time += t_comp
        req.prefill_done_time = self.clock
        req.prefilled = True
        self.fabric.request(req, self.clock, nbytes, comp=comp)

    def step(self) -> bool:
        """Prefill one admitted batch; returns False when drained."""
        if not self.waiting:
            return False
        self.clock = max(self.clock, self.waiting[0].arrival_time)
        batch = self.scheduler.admit([], self.waiting,
                                     self.cache.resident_ids, self.clock)
        if not batch:
            # unreachable by construction (clock was advanced to the head
            # arrival and max_batch >= 1); fail loudly rather than letting
            # drain() spin forever if a scheduler change breaks that
            raise RuntimeError("prefill scheduler admitted nothing while "
                               f"{len(self.waiting)} requests wait")
        # overlapped DMA for the batch's adapters; stall on the max
        t_ready = self.clock
        for r in batch:
            t_ready = max(t_ready, self.cache.ensure(
                weight_key(r), self.executor.adapter_bytes(r.adapter_id),
                self.clock))
        stall = max(0.0, t_ready - self.clock)
        self.clock += stall
        self.stats.swap_time += stall
        # prefill is compute-bound: serialize within the batch; each request
        # hands its KV to the fabric as soon as its own prefill finishes
        for r in batch:
            self.waiting.remove(r)
            r.start_time = self.clock
            t_pre = self.executor.prefill_time(r)
            self.clock += t_pre
            self.stats.compute_time += t_pre
            self.stats.n_prefills += 1
            self._handoff(r)
        return True

    def drain(self) -> None:
        while self.step():
            pass
        self.stats.n_swaps = self.cache.n_swaps
        if self._owns_fabric:
            self.fabric.resolve()
            fs = self.fabric.stats
            self.stats.transfer_time = fs.transfer_time
            self.stats.kv_bytes_moved = fs.kv_bytes_moved
            self.stats.kv_raw_bytes = fs.kv_raw_bytes
            self.stats.n_chunks = fs.n_chunks
            self.stats.kv_wire_bytes_by_mode = dict(fs.wire_bytes_by_mode)
            self.stats.kv_raw_bytes_by_mode = dict(fs.raw_bytes_by_mode)
            self.stats.n_mode_switches = fs.n_mode_switches


class PrefillTier:
    """Routes requests across active prefill workers, runs them eagerly,
    and resolves the shared KV fabric.

    Routing is least-outstanding with a deterministic index tiebreak (the
    tier has no adapter-affinity pressure of its own at jd mode — shared
    bases are pinned on every worker — and lora-mode affinity is dominated
    by keeping the tier's queues short).

    Membership is elastic and symmetric with the decode fleet:
    :meth:`add_worker` joins a worker at a simulated time,
    :meth:`retire_worker` stops routing to one (it drains what it has), so
    an autoscaler can shrink this tier to fund decode replicas under a
    fixed hardware budget — and vice versa.
    """

    def __init__(self, cfg: PrefillConfig, workers: Sequence[PrefillWorker],
                 fabric: Optional[KVFabric] = None):
        if len(workers) != cfg.n_workers:
            raise ValueError(f"expected {cfg.n_workers} workers, "
                             f"got {len(workers)}")
        self.cfg = cfg
        self.workers = list(workers)
        self.fabric = fabric or KVFabric(cfg.fabric_config())
        for w in self.workers:
            self._bind(w)
        self.active: List[bool] = [True] * len(self.workers)
        self.scale_events = 0

    def _bind(self, worker: PrefillWorker) -> None:
        worker.fabric = self.fabric
        worker._owns_fabric = False

    # -- elastic membership -------------------------------------------------
    def _active_idxs(self) -> List[int]:
        return [i for i, a in enumerate(self.active) if a]

    @property
    def n_active(self) -> int:
        return len(self._active_idxs())

    def add_worker(self, worker: PrefillWorker, now: float = 0.0) -> int:
        """Join a fresh prefill worker at simulated time `now`."""
        worker.clock = max(worker.clock, now)
        self._bind(worker)
        self.workers.append(worker)
        self.active.append(True)
        self.scale_events += 1
        return len(self.workers) - 1

    def retire_worker(self, i: int) -> None:
        """Stop routing to worker `i`; it drains its remaining queue."""
        if not self.active[i]:
            return
        if self.n_active == 1:
            raise ValueError("cannot retire the last active prefill worker")
        self.active[i] = False
        self.scale_events += 1

    # -- request flow -------------------------------------------------------
    def submit(self, reqs: Sequence[Request]) -> None:
        idxs = self._active_idxs()
        for r in sorted(reqs, key=lambda r: r.arrival_time):
            i = min(idxs, key=lambda j: (self.workers[j].outstanding,
                                         self.workers[j].clock, j))
            r.prefill_replica = i
            self.workers[i].submit([r])

    def drain(self) -> None:
        for w in self.workers:
            w.drain()
        self.fabric.resolve()

    def process(self, reqs: Sequence[Request]) -> List[Request]:
        """Submit + drain; returns the same requests, now KV-ready-stamped.
        Incremental: worker clocks/queues and fabric backlog persist across
        calls, so the autoscaler can feed arrival windows one at a time."""
        self.submit(reqs)
        self.drain()
        return list(reqs)

    @property
    def stats(self) -> PrefillStats:
        merged = PrefillStats.merged([w.stats for w in self.workers])
        return merged.add_fabric(self.fabric.stats)
