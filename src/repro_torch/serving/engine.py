"""Multi-LoRA serving engine: continuous batching + adapter cache + executor.

Two executors share one engine loop:

- :class:`CostModelExecutor` — roofline analytic step times for one
  serving replica (:class:`ServingHardware`: one NVIDIA H100 SXM's data
  sheet figures); used for the paper-scale throughput studies (Figs. 1 &
  4) where 1000s of adapters are simulated.
- ``serving/real_executor.py::RealModelExecutor`` — actually runs
  prefill/decode of the model on the card (or the CPU) with batched LoRA
  application (real logits, real adapter math, wall-clock timing).

Serving modes:
  "lora"  — uncompressed multi-LoRA baseline (vLLM-style swap on miss)
  "jd"    — compressed: shared bases pinned, Sigmas resident (tiny), no swap
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


from .adapter_cache import AdapterCache, CacheConfig
from .request import Request, ServeStats, weight_key
from .resources import (PAGE_TOKENS, PagedPool, PagedPoolConfig,
                        merge_mode_dict)
from .scheduler import Scheduler, SchedulerConfig


# ---------------------------------------------------------------------------
# cost-model executor (production target)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingHardware:
    """One serving replica: by default one NVIDIA H100 SXM, with NVIDIA's
    data-sheet figures (dense bf16 tensor-core rate, HBM bandwidth as
    ``kernels/checks.HBM_BYTES_PER_S``, HBM size).  No measured fit of the
    card's decode step replaces ``step_overhead`` yet."""
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
    mem_cap_frac: float = 0.4        # paper: cap at 40% of device memory
    mfu_prefill: float = 0.45
    step_overhead: float = 3e-4      # host/dispatch per decode step

    def for_slice(self, slice_type) -> "ServingHardware":
        """This hardware scaled by a :class:`SliceType
        <repro.serving.resources.SliceType>`'s factors: ``prefill_speed``
        scales peak compute (the prefill roofline), ``decode_speed``
        scales HBM bandwidth (the weight-streaming decode roofline), and
        the slice's ``hbm_bytes`` replaces the replica's HBM when set.
        The default slice (all factors 1.0, no HBM override) returns
        bit-identical figures — ``x * 1.0`` is exact in IEEE 754."""
        if slice_type is None:
            return self
        return dataclasses.replace(
            self,
            peak_flops=self.peak_flops * slice_type.prefill_speed,
            hbm_bw=self.hbm_bw * slice_type.decode_speed,
            hbm_bytes=(slice_type.hbm_bytes
                       if slice_type.hbm_bytes is not None
                       else self.hbm_bytes))


@dataclasses.dataclass
class ModelFootprint:
    """Serving-relevant sizes (derived from a ModelConfig)."""
    n_active_params: int
    weight_bytes: int                # resident base weights (bf16)
    lora_bytes_per_adapter: int      # uncompressed A+B across modules
    jd_shared_bytes_per_cluster: int  # U_j+V_j across modules
    jd_sigma_bytes_per_adapter: int
    n_clusters: int = 1
    kv_bytes_per_token: int = 0      # bf16 K+V across layers (disagg handoff)
    lora_rank: int = 16              # the rank lora_bytes_per_adapter prices

    @staticmethod
    def from_config(cfg, rank: int = 16, jd_rank: int = 16,
                    n_clusters: int = 1, diag: bool = False,
                    adapter_bits: int = 16) -> "ModelFootprint":
        """``adapter_bits=16`` prices bf16 resident adapters (the default,
        bit-exact with every committed baseline); ``adapter_bits=8`` prices
        the int8 per-output-channel packing of `kernels/adapter_quant.py`
        (1 byte per value + one f32 scale per output channel), the
        residency the ``fused_q8`` decode path actually keeps in the
        `PagedPool` — roughly a 2x page cut vs bf16 and ~4x vs the float32
        training-output banks `RealModelExecutor` holds."""
        d = cfg.d_model
        hd = cfg.resolved_head_dim
        dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
                "v": (d, cfg.num_kv_heads * hd)}
        if adapter_bits == 16:
            lora_b = sum(2 * rank * (di + do) for di, do in dims.values())
            shared_b = sum(2 * jd_rank * (di + do)
                           for di, do in dims.values())
            sig_b = 2 * (jd_rank if diag else jd_rank * jd_rank) * len(dims)
        elif adapter_bits == 8:
            # int8 values + one f32 scale per output channel:
            # A (r, di): r scales; B (do, r): do scales — per module.
            lora_b = sum(rank * (di + do) + 4 * (rank + do)
                         for di, do in dims.values())
            # shared basis: U (do, jd_rank) do scales; V (di, jd_rank)
            # jd_rank scales (per-column, the rank axis is the output)
            shared_b = sum(jd_rank * (di + do) + 4 * (do + jd_rank)
                           for di, do in dims.values())
            # diag Sigma stays fp (tiny); full Sigma packs per row
            sig_b = ((2 * jd_rank if diag
                      else jd_rank * jd_rank + 4 * jd_rank) * len(dims))
        else:
            raise ValueError(f"adapter_bits must be 16 or 8, got "
                             f"{adapter_bits}")
        return ModelFootprint(
            n_active_params=cfg.active_param_count(),
            weight_bytes=2 * cfg.param_count(),
            lora_bytes_per_adapter=lora_b * cfg.num_layers,
            jd_shared_bytes_per_cluster=shared_b * cfg.num_layers,
            jd_sigma_bytes_per_adapter=sig_b * cfg.num_layers,
            n_clusters=n_clusters,
            kv_bytes_per_token=2 * 2 * cfg.num_layers * cfg.num_kv_heads * hd,
            lora_rank=rank)

    def pool_config(self, total_bytes: float,
                    adapter_share: Optional[float] = None) -> PagedPoolConfig:
        """The unified paged pool sized for this model: one page is one
        :data:`PAGE_TOKENS`-token KV block across all layers/heads.
        `total_bytes` is the HBM region shared by KV blocks and adapter
        weights (e.g. ``hw.hbm_bytes * hw.mem_cap_frac`` minus the base
        weights); `adapter_share` carves the pre-paging static split out
        of the same machinery (see :class:`PagedPoolConfig
        <repro.serving.resources.PagedPoolConfig>`)."""
        if self.kv_bytes_per_token <= 0:
            raise ValueError("pool_config needs kv_bytes_per_token > 0")
        return PagedPoolConfig(
            total_bytes=total_bytes,
            page_bytes=self.kv_bytes_per_token * PAGE_TOKENS,
            adapter_share=adapter_share)


class CostModelExecutor:
    """Roofline step-time model; decode is weight-streaming bound.

    Supports a **raw overlay** for the online lifecycle: adapters in
    ``raw_ids`` are served through the uncompressed SGMV path even in
    "jd" mode (a hot-registered adapter decodes from its full A/B weights
    — :func:`repro.core.collection.export_uncompressed` — until a basis
    refresh absorbs it into a cluster, invariant L1).  A jd decode step
    with mixed raw/compressed slots streams each raw adapter's LoRA
    weights plus the compressed slots' bases and Sigmas.  With
    ``raw_ids`` empty the model is bit-exact with the pre-lifecycle
    executor.

    Heterogeneous adapters (PR 10): with ``rank_of`` (adapter id ->
    LoRA rank) the SGMV-path byte model is per-rank — a rank-r adapter
    streams ``lora_bytes_per_adapter * padded(r) / lora_rank`` bytes,
    where ``padded(r)`` rounds r up to the replica slice's native SGMV
    contraction tile (``slice_type.sgmv_tile_rank``; see
    :func:`repro_torch.kernels.sgmv.sgmv_tile_cost`).  The padding is what
    makes placement matter: a rank-4 adapter on a tile-32 slice streams
    8x its useful bytes.  ``rank_of=None`` keeps the homogeneous
    per-adapter constant, bit-exact with every committed baseline."""

    def __init__(self, hw: ServingHardware, fp: ModelFootprint, mode: str,
                 cluster_of: Optional[Dict[int, int]] = None,
                 rank_of: Optional[Dict[int, int]] = None,
                 slice_type=None):
        self.hw, self.fp, self.mode = hw, fp, mode
        self.cluster_of = cluster_of or {}
        self.rank_of = rank_of
        self.slice_type = slice_type
        self.raw_ids: set = set()

    def mark_raw(self, aid: int) -> None:
        """Serve `aid` through the uncompressed SGMV path (hot register)."""
        self.raw_ids.add(aid)

    def unmark_raw(self, aid: int) -> None:
        """`aid`'s cluster basis now serves it (refresh rollout complete)."""
        self.raw_ids.discard(aid)

    def lora_adapter_bytes(self, aid: int) -> int:
        """Bytes one SGMV (uncompressed) adapter streams per decode step.

        Homogeneous (``rank_of=None``): the footprint's per-adapter
        constant, unchanged.  Heterogeneous: scale it to `aid`'s rank
        padded up to the slice's native SGMV contraction tile — the
        per-rank cost :func:`repro_torch.kernels.sgmv.sgmv_tile_cost` prices
        (a tile of 1 means no padding)."""
        if self.rank_of is None:
            return self.fp.lora_bytes_per_adapter
        r = self.rank_of.get(aid, self.fp.lora_rank)
        tile = self.slice_type.sgmv_tile_rank if self.slice_type else 1
        padded = tile * -(-r // tile)
        return (self.fp.lora_bytes_per_adapter * padded) // self.fp.lora_rank

    def adapter_bytes(self, aid: int) -> int:
        if self.mode == "jd" and aid not in self.raw_ids:
            return self.fp.jd_sigma_bytes_per_adapter
        return self.lora_adapter_bytes(aid)

    def shared_bytes(self) -> int:
        if self.mode == "jd":
            return self.fp.jd_shared_bytes_per_cluster * self.fp.n_clusters
        return 0

    def decode_step_time(self, batch: Sequence[Request]) -> float:
        B = len(batch)
        if B == 0:
            return 0.0
        uniq = {r.adapter_id for r in batch}
        t_w = self.fp.weight_bytes / self.hw.hbm_bw
        t_f = 2.0 * self.fp.n_active_params * B / self.hw.peak_flops
        if self.mode == "jd":
            raw = uniq & self.raw_ids
            n_raw_slots = sum(1 for r in batch if r.adapter_id in raw)
            ucl = {self.cluster_of.get(a, 0) for a in uniq - raw}
            extra = (len(ucl) * self.fp.jd_shared_bytes_per_cluster
                     + (B - n_raw_slots) * self.fp.jd_sigma_bytes_per_adapter
                     + sum(self.lora_adapter_bytes(a) for a in raw)
                     ) / self.hw.hbm_bw
        else:
            extra = (sum(self.lora_adapter_bytes(a) for a in uniq)
                     + 0) / self.hw.hbm_bw
        return max(t_w + extra, t_f) + self.hw.step_overhead

    def prefill_time(self, req: Request) -> float:
        fl = 2.0 * self.fp.n_active_params * req.prompt_len
        return fl / (self.hw.peak_flops * self.hw.mfu_prefill)

    def kv_bytes(self, req: Request) -> int:
        """KV-cache bytes produced by prefill (shipped on disagg handoff)."""
        return self.fp.kv_bytes_per_token * req.prompt_len


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineConfig:
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    adapter_budget_bytes: float = 2e9
    mode: str = "lora"               # lora | jd
    prefetch: bool = False           # opportunistic warm-up of queued adapters
    # waiting-queue lookahead for prefetch; None = adaptive — follow the
    # router-fed queue depth (every request already known to the engine),
    # so bursts warm proportionally more adapters ahead of admission
    prefetch_depth: Optional[int] = None
    # unified paging (PR 6): when set, adapter weights and KV blocks share
    # ONE paged HBM pool — KV pages are reserved (worst case) at admission
    # and adapter eviction funds decode pages and vice versa;
    # ``adapter_budget_bytes`` is ignored.  None = legacy static split,
    # bit-exact with the pre-paging engine.
    pool: Optional[PagedPoolConfig] = None
    # KV page reservation policy (paged engines only).  "worst_case"
    # reserves prompt + max_new_tokens pages at admission — decode never
    # fails mid-request (bit-exact with every committed baseline).
    # "on_demand" reserves only the prompt (+1 token) and grows the
    # reservation page by page as decode crosses 128-token boundaries, so
    # long-max_new_tokens tails stop holding idle pages; when the pool is
    # exhausted mid-growth the engine preempts a running victim through
    # the live-migration machinery (ServingEngine.preempt).
    kv_reserve: str = "worst_case"
    # eviction-fairness cap consulted by the growth path: a request
    # already bounced this many times is not picked as a victim while an
    # uncapped candidate exists (Scheduler.pick_victim, invariant M5)
    max_preemptions: int = 3
    # real-executor decode path (PR 8): "unfused" keeps the generic
    # transformer decode step (bit-exact with every committed baseline);
    # "fused" runs the one-pass flash-decode + adapter-delta kernel
    # (kernels/fused_decode.py) with a donated in-place KV cache;
    # "fused_q8" additionally serves adapters from int8 per-channel banks
    # (kernels/adapter_quant.py).  Ignored by CostModelExecutor; a
    # RealModelExecutor must be constructed with the matching path.
    decode_path: str = "unfused"


class ServingEngine:
    """Simulated-clock continuous-batching engine."""

    def __init__(self, cfg: EngineConfig, executor,
                 cluster_of: Optional[Dict[int, int]] = None,
                 slice_type=None):
        self.cfg = cfg
        self.executor = executor
        # the hardware slice class this replica occupies (None: the legacy
        # interchangeable accelerator); the Fleet's rank-aware routing
        # reads decode_speed and sgmv_tile_rank off it
        self.slice_type = slice_type
        ex_path = getattr(executor, "decode_path", None)
        if ex_path is not None and ex_path != cfg.decode_path:
            raise ValueError(f"engine decode_path={cfg.decode_path!r} but "
                             f"the executor was built with {ex_path!r}")
        if cfg.kv_reserve not in ("worst_case", "on_demand"):
            raise ValueError(f"kv_reserve must be 'worst_case' or "
                             f"'on_demand', got {cfg.kv_reserve!r}")
        if cfg.kv_reserve == "on_demand" and cfg.pool is None:
            raise ValueError("kv_reserve='on_demand' requires a paged pool")
        self.scheduler = Scheduler(cfg.scheduler, cluster_of)
        self.pool: Optional[PagedPool] = None
        if cfg.pool is not None:
            fp = getattr(executor, "fp", None)
            if fp is None or fp.kv_bytes_per_token <= 0:
                raise ValueError("a paged engine needs an executor with a "
                                 "ModelFootprint (kv_bytes_per_token > 0)")
            self.pool = PagedPool(cfg.pool)
            self.pool.set_reclaimer(
                lambda n: self.cache.reclaim(n, self._protected()))
        self.cache = AdapterCache(CacheConfig(cfg.adapter_budget_bytes),
                                  pool=self.pool)
        if cfg.mode == "jd":
            self.cache.pin_shared(executor.shared_bytes())
        self.clock = 0.0
        self.stats = ServeStats()
        self.running: List[Request] = []
        self.waiting: List[Request] = []
        self.on_finish = None        # optional callback(req) on completion
        # optional callback(req) -> bool when the growth path must evict a
        # running request: return True if the victim was live-migrated to
        # another replica (MigrationPolicy wires Fleet.migrate here); False
        # (or no handler) falls back to a local host swap (see preempt)
        self.on_preempt = None
        self._kv_held: Dict[int, int] = {}   # rid -> reserved KV pages
        self._admitting: Optional[int] = None  # adapter id mid-reservation
        self._page_blocked = False   # last _admit deferred a ready request

    # -- unified paging helpers ---------------------------------------------
    def _protected(self) -> set:
        """Weight keys a reclaim must not evict: the running batch's, plus
        the adapter of the request being admitted right now."""
        prot = {weight_key(r) for r in self.running}
        if self._admitting is not None:
            prot.add(self._admitting)
        return prot

    def _kv_pages(self, req: Request) -> int:
        """KV pages to reserve for `req` at admission: the full worst case
        (``prompt + max_new_tokens``) so decode never fails mid-request, or
        just the blocks its KV occupies *now* plus the next token under
        ``kv_reserve="on_demand"`` (grown per step by `_grow_kv`; see
        docs/architecture.md)."""
        if self.cfg.kv_reserve == "on_demand":
            tokens = req.prompt_len + req.generated + 1
        else:
            tokens = req.prompt_len + req.max_new_tokens
        return self.pool.pages_for(tokens * self.executor.fp.kv_bytes_per_token)

    def _reserve(self, req: Request, pending_adapter_pages: int
                 ) -> Optional[int]:
        """Try to fund `req`'s admission from the pool: its KV reservation
        (`_kv_pages`; reclaiming cold adapters if needed) AND, if its adapter is
        not resident, the adapter's pages.  `pending_adapter_pages` counts
        adapters of requests admitted earlier in the same round whose load
        has not been issued yet, so one round cannot overcommit.  Returns
        the adapter pages this request will add (0 if resident), or None
        when it cannot fit even after evicting every unprotected adapter
        (the request stays waiting)."""
        kv_need = self._kv_pages(req)
        a_need = (0 if self.cache.is_resident(weight_key(req)) else
                  self.pool.pages_for(
                      self.executor.adapter_bytes(req.adapter_id)))
        self._admitting = weight_key(req)
        try:
            if not self.pool.feasible(
                    kv_need, a_need + pending_adapter_pages,
                    self.cache.evictable_pages(self._protected())):
                return None
            if not self.pool.alloc_with_reclaim("kv", kv_need):
                return None          # unreachable given feasible(); belt
            self._kv_held[req.rid] = kv_need
            return a_need
        finally:
            self._admitting = None

    def submit(self, reqs: Sequence[Request]) -> None:
        self.waiting.extend(reqs)
        self.waiting.sort(key=lambda r: r.ready_time)

    def refresh_shared(self, nbytes: int, now: float) -> float:
        """Swap this replica's pinned shared bases for a refreshed set of
        `nbytes` (one step of a basis-refresh rollout, or its rollback).

        The replica decodes nothing while its bases are in flight — the
        DMA stalls this clock (charged as swap time), which is exactly why
        the lifecycle rolls replicas one at a time (invariant L2): the
        rest of the fleet keeps serving.  Returns the completion time."""
        self.clock = max(self.clock, now)
        t_done = self.cache.repin_shared(nbytes, self.clock)
        self.stats.swap_time += t_done - self.clock
        self.clock = t_done
        return t_done

    def _admit(self) -> None:
        admitted = self.scheduler.admit(self.running, self.waiting,
                                        self.cache.resident_ids, self.clock)
        pending_adapter_pages = 0
        self._page_blocked = False
        for r in admitted:
            if self.pool is not None:
                a_need = self._reserve(r, pending_adapter_pages)
                if a_need is None:
                    # stays waiting; retried when pages free up (a finished
                    # decode or an adapter eviction)
                    self.stats.n_page_blocked += 1
                    self._page_blocked = True
                    continue
                if r.prefilled:
                    # disagg: the adapter load is issued in step(); account
                    # for it so this round cannot overcommit the pool
                    pending_adapter_pages += a_need
            self.waiting.remove(r)
            if r.start_time is None:     # disagg requests keep prefill start
                r.start_time = self.clock
            if not r.prefilled:
                # colocated serving: prefill runs inline at admission.
                # adapter must be resident before prefill
                t_ready = self.cache.ensure(
                    weight_key(r),
                    self.executor.adapter_bytes(r.adapter_id),
                    self.clock,
                    protected=self._protected() | {weight_key(r)})
                stall = max(0.0, t_ready - self.clock)
                t_pre = self.executor.prefill_time(r)
                self.clock += stall + t_pre
                self.stats.swap_time += stall
                self.stats.compute_time += t_pre
                r.prefilled = True
            else:
                if (r.kv_decompress_cost > 0
                        and r.decompress_done_time is None):
                    # compressed disagg handoff: the KV arrives quantized
                    # and is dequantized on THIS replica, charging the
                    # compute to the decode tier.  Dequant streams per
                    # landed chunk and overlaps the transfer tail
                    # (mirroring the first-chunk admission model), so the
                    # WHOLE cost is charged once here —
                    # decompress_done_time marks when the replica paid it,
                    # which can precede kv_landed_time
                    self.clock += r.kv_decompress_cost
                    self.stats.decompress_time += r.kv_decompress_cost
                    merge_mode_dict(self.stats.decompress_by_mode,
                                    {r.wire_mode: r.kv_decompress_cost})
                    r.decompress_done_time = self.clock
                if r.kv_restore_cost > 0:
                    # migrated-in checkpoint (wire dequant) or a locally
                    # preempted request returning from host (swap round
                    # trip): the admitting replica pays the pending
                    # restore exactly once, then the request resumes at
                    # the same `generated` position it was stopped at
                    self.clock += r.kv_restore_cost
                    self.stats.restore_time += r.kv_restore_cost
                    r.kv_restore_cost = 0.0
            self.running.append(r)

    # -- live migration / preemption (PR 9) ---------------------------------
    def checkpoint(self, req: Request) -> int:
        """Detach `req` from this engine for migration or preemption.

        Removes it from its decode slot (or the waiting queue) and frees
        its KV page reservation IMMEDIATELY — the pages are back in the
        source pool at checkpoint time, not when the checkpoint lands on
        its target (invariant M3) — and returns the raw KV bytes that
        must move: the prompt's blocks plus every generated token's (the
        full decoded prefix; token-exact resume needs all of it).  A
        request with no KV on this replica yet (colocated, still
        waiting) checkpoints at zero bytes.  The caller owns what
        happens next: `Fleet.migrate` ships the bytes over the fabric,
        :meth:`preempt`'s local fallback swaps them to host."""
        if req in self.running:
            self.running.remove(req)
        elif req in self.waiting:
            self.waiting.remove(req)
        else:
            raise ValueError(f"request {req.rid} is not on this engine")
        if self.pool is not None:
            self.pool.free("kv", self._kv_held.pop(req.rid, 0))
        if not req.prefilled and req.generated == 0:
            return 0
        fp = getattr(self.executor, "fp", None)
        if fp is None:
            return 0
        return (req.prompt_len + req.generated) * fp.kv_bytes_per_token

    def preempt(self, victim: Request) -> None:
        """Evict `victim` from its decode slot (page pressure, or a
        higher-priority tenant via serving/migration.py).

        The preferred path is live migration: `on_preempt` checkpoints
        the victim and rehomes it on another replica over the fabric.
        Without a handler — or when it declines (single-replica fleet) —
        the checkpoint swaps to HOST memory instead: pages free now, and
        the swap-out + swap-in DMA round trip is charged when the victim
        is re-admitted (`Request.kv_restore_cost`, counted as
        restore_time).  Either way the victim keeps its `generated`
        position: preemption delays a request, never restarts it."""
        victim.preemptions += 1
        self.stats.n_preempted += 1
        if self.on_preempt is not None and self.on_preempt(victim):
            return
        nbytes = self.checkpoint(victim)
        if nbytes > 0:
            dma = self.cache.cfg.dma
            victim.kv_restore_cost += 2 * (dma.latency
                                           + nbytes / dma.bandwidth)
        self.submit([victim])

    def _grow_kv(self) -> None:
        """Mid-decode reservation growth (``kv_reserve="on_demand"``):
        before the step writes each running request's next token, extend
        its reservation to cover ``prompt + generated + 1`` tokens.
        Growth that cannot be funded even after reclaiming cold adapters
        preempts a victim (lowest priority, then smallest KV — never the
        grower itself) and retries."""
        bpt = self.executor.fp.kv_bytes_per_token
        for r in list(self.running):
            if r not in self.running:    # preempted by an earlier grower
                continue
            need = self.pool.pages_for((r.prompt_len + r.generated + 1) * bpt)
            while need > self._kv_held.get(r.rid, 0):
                held = self._kv_held.get(r.rid, 0)
                if self.pool.alloc_with_reclaim("kv", need - held):
                    self._kv_held[r.rid] = need
                    break
                victim = (self.scheduler.pick_victim(
                              self.running, protect=(r.rid,),
                              max_moves=self.cfg.max_preemptions)
                          # all candidates at the fairness cap: progress
                          # beats fairness when the alternative is aborting
                          or self.scheduler.pick_victim(self.running,
                                                        protect=(r.rid,)))
                if victim is None:
                    raise MemoryError(
                        f"cannot grow the KV reservation of request "
                        f"{r.rid} and no running request is preemptible: "
                        f"{self.pool.to_dict()}")
                self.preempt(victim)

    def _prefetch_waiting(self) -> None:
        """Opportunistically warm adapters of queued requests.  Low priority:
        never stalls this step and never delays a later demand load (see
        AdapterCache.prefetch).  With ``prefetch_depth=None`` the lookahead
        is adaptive: it tracks the routed queue itself rather than a static
        depth, so a deep backlog warms more adapters ahead."""
        if not self.cfg.prefetch:
            return
        depth = self.cfg.prefetch_depth
        if depth is None:
            depth = len(self.waiting)
        for r in self.waiting[:depth]:
            if r.ready_time > self.clock:       # not yet known to the engine
                break
            self.cache.prefetch(weight_key(r),
                                self.executor.adapter_bytes(r.adapter_id),
                                self.clock)

    def step(self) -> bool:
        """One engine iteration; returns False when fully drained."""
        if not self.running and not self.waiting:
            return False
        if not self.running and self.waiting:
            # jump to next arrival (KV-ready time for disaggregated requests)
            self.clock = max(self.clock, self.waiting[0].ready_time)
        self._admit()
        if not self.running:
            if self.pool is not None and self._page_blocked:
                # an empty engine has every KV page free and every adapter
                # evictable — if the head request STILL cannot be funded it
                # never will be, and retrying would spin the clock forever
                raise MemoryError(
                    f"paged pool cannot fit a single request: "
                    f"{self.pool.to_dict()}")
            return True
        if self.pool is not None and self.cfg.kv_reserve == "on_demand":
            self._grow_kv()
            if not self.running:     # the whole batch was preempted away
                return True
        # ensure all batch adapters resident (overlapped DMA; stall on max)
        batch_ids = {weight_key(r) for r in self.running}
        t_ready = self.clock
        for r in self.running:
            t_ready = max(t_ready, self.cache.ensure(
                weight_key(r), self.executor.adapter_bytes(r.adapter_id),
                self.clock, protected=batch_ids))
        stall = max(0.0, t_ready - self.clock)
        self._prefetch_waiting()
        self.stats.peak_batch = max(self.stats.peak_batch, len(self.running))
        self.stats.peak_resident_adapters = max(
            self.stats.peak_resident_adapters, len(self.cache.resident_ids))
        t_step = self.executor.decode_step_time(self.running)
        self.clock += stall + t_step
        self.stats.swap_time += stall
        self.stats.compute_time += t_step
        self.stats.n_tokens += len(self.running)
        for r in self.running:
            r.generated += 1
            if r.generated == 1:
                r.first_token_time = self.clock
            if r.done:
                r.finish_time = self.clock
                if self.pool is not None:   # release the KV reservation
                    self.pool.free("kv", self._kv_held.pop(r.rid, 0))
                self.stats.record_finish(r)
                if self.on_finish is not None:
                    self.on_finish(r)
        self.running = [r for r in self.running if not r.done]
        return True

    def run(self, max_steps: int = 10_000_000) -> ServeStats:
        steps = 0
        while self.step() and steps < max_steps:
            steps += 1
        self.stats.wall_time = self.clock
        self.stats.n_swaps = self.cache.n_swaps
        if self.pool is not None:
            self.stats.peak_kv_pages = self.pool.peak["kv"]
            self.stats.peak_adapter_pages = self.pool.peak["adapter"]
            self.stats.n_page_reclaims = self.pool.n_reclaims
            self.stats.pages_reclaimed = self.pool.pages_reclaimed
        return self.stats
