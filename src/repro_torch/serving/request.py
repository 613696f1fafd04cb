"""Serving request/response types + per-request latency accounting."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .resources import merge_mode_dict


def weight_key(req: "Request"):
    """Cache key for the adapter weights `req` decodes against.

    Epoch 0 (every request outside the lifecycle) keys by the bare adapter
    id — bit-exact with pre-lifecycle behavior.  Updated adapters key by
    ``(adapter_id, epoch)`` so two weight versions can be resident at once
    while the old epoch's in-flight requests drain (invariant L4)."""
    if req.adapter_epoch == 0:
        return req.adapter_id
    return (req.adapter_id, req.adapter_epoch)


@dataclasses.dataclass
class Request:
    rid: int
    adapter_id: int
    prompt_len: int
    max_new_tokens: int
    arrival_time: float = 0.0
    # online lifecycle (serving/lifecycle.py): which weight epoch of the
    # adapter this request was routed against.  An update is retire+register
    # with a bumped epoch; in-flight requests keep decoding against the
    # epoch they were stamped with (invariant L4, docs/lifecycle.md).
    # Epoch 0 is the default and keys caches by the bare adapter id, so
    # request streams that never touch the lifecycle are unchanged.
    adapter_epoch: int = 0
    # runtime state
    generated: int = 0
    start_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    prefilled: bool = False
    replica: Optional[int] = None    # set by fleet routing
    # disaggregated serving: set by the prefill tier when prefill runs on a
    # separate replica and the KV cache is shipped to decode over the shared
    # fabric.  With chunked/streamed handoff `decode_ready_time` is the
    # FIRST chunk's landing (enough KV to start decoding) and
    # `kv_landed_time` the last chunk's; they coincide on the serial path.
    prefill_replica: Optional[int] = None
    prefill_done_time: Optional[float] = None
    transfer_time: float = 0.0       # KV handoff span (prefill -> all landed)
    decode_ready_time: Optional[float] = None
    kv_landed_time: Optional[float] = None
    # KV wire compression (stamped by the fabric when the handoff is
    # recorded): raw bytes prefill produced, bytes actually shipped, the
    # mode, and the decode-side dequantization cost the decode replica pays
    # at admission (decompress_done_time is set when it does).  With an
    # adaptive fabric policy the mode is a PER-TRANSFER pick from live
    # channel backlog, so it varies request to request; None means the
    # transfer shipped raw (see `wire_mode`).
    kv_raw_bytes: int = 0
    kv_wire_bytes: int = 0
    kv_compression: Optional[str] = None
    kv_decompress_cost: float = 0.0
    decompress_done_time: Optional[float] = None
    # scheduler-visible tenant priority: higher admits first, and with a
    # MigrationPolicy attached a ready high-priority request may
    # preempt-and-migrate a lower-priority running one (serving/migration.py)
    priority: int = 0
    # live migration / preemption (Fleet.migrate, ServingEngine.preempt).
    # Wire accounting is CUMULATIVE across hops and kept separate from the
    # prefill-handoff fields above, so the original handoff's bytes are
    # never overwritten and no byte is charged twice (invariant M2).
    migrations: int = 0              # completed live moves between replicas
    preemptions: int = 0             # times evicted from a decode slot
    migrated_from: Optional[int] = None  # source replica of the last move
    migration_time: float = 0.0      # total checkpoint -> KV-landed span
    mig_raw_bytes: int = 0           # KV bytes checkpointed across moves
    mig_wire_bytes: int = 0          # bytes actually shipped (post-quant)
    # pending target-side restore charge (wire dequant for a migrated
    # checkpoint, host swap round-trip for a local preemption); the
    # admitting engine pays it once and zeroes it (M1: the request then
    # resumes decode at the same `generated` position it was stopped at)
    kv_restore_cost: float = 0.0

    @property
    def wire_mode(self) -> str:
        """The handoff's wire mode with raw spelled out — the key the
        per-mode fabric/prefill/decode stats aggregate under."""
        return self.kv_compression or "raw"

    @property
    def ready_time(self) -> float:
        """Earliest time a decode engine may admit this request: the arrival
        for colocated serving, the first KV chunk's landing when prefill ran
        on a disaggregated prefill tier."""
        if self.decode_ready_time is not None:
            return self.decode_ready_time
        return self.arrival_time

    @property
    def prefill_lag(self) -> Optional[float]:
        """The prefill tier's contribution to this request's TTFT: arrival ->
        decode-ready (queueing + prefill compute + first-chunk transfer).
        None for colocated serving."""
        if self.decode_ready_time is None:
            return None
        return self.decode_ready_time - self.arrival_time

    @property
    def decode_wait(self) -> Optional[float]:
        """The decode tier's contribution to TTFT: decode-ready (or arrival,
        when colocated) -> first token."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.ready_time

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival -> first decoded token)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first (0 for 1-token requests)."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if self.generated <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (self.generated - 1)


@dataclasses.dataclass
class ServeStats:
    n_requests: int = 0
    n_tokens: int = 0
    wall_time: float = 0.0
    swap_time: float = 0.0
    compute_time: float = 0.0
    decompress_time: float = 0.0     # decode-side KV dequantization
    # dequant cost split by the wire mode the fabric picked per transfer
    decompress_by_mode: dict = dataclasses.field(default_factory=dict)
    n_swaps: int = 0
    sum_latency: float = 0.0
    latencies: List[float] = dataclasses.field(default_factory=list)
    ttfts: List[float] = dataclasses.field(default_factory=list)
    tpots: List[float] = dataclasses.field(default_factory=list)
    # unified paging (engines with a PagedPool; all zero otherwise).
    # Counters are in PAGES except the two peaks marked otherwise.
    peak_kv_pages: int = 0           # high-water decode KV reservation
    peak_adapter_pages: int = 0      # high-water adapter-weight footprint
    peak_resident_adapters: int = 0  # count of cache-resident adapters
    peak_batch: int = 0              # count of concurrent decode slots used
    n_page_reclaims: int = 0         # KV-pressure adapter-eviction rounds
    pages_reclaimed: int = 0         # adapter pages evicted to fund KV
    n_page_blocked: int = 0          # admissions deferred for lack of pages
    # live migration / preemption (all zero when no request ever moves)
    n_migrated_in: int = 0           # checkpoints re-admitted here
    n_migrated_out: int = 0          # requests checkpointed away
    n_preempted: int = 0             # decode-slot evictions (pages/priority)
    restore_time: float = 0.0        # checkpoint restore paid at admission

    def record_finish(self, req: Request) -> None:
        self.n_requests += 1
        self.sum_latency += req.latency
        self.latencies.append(req.latency)
        if req.ttft is not None:
            self.ttfts.append(req.ttft)
        if req.tpot is not None:
            self.tpots.append(req.tpot)

    @property
    def throughput_rps(self) -> float:
        return self.n_requests / self.wall_time if self.wall_time else 0.0

    @property
    def throughput_tps(self) -> float:
        return self.n_tokens / self.wall_time if self.wall_time else 0.0

    @property
    def mean_latency(self) -> float:
        return self.sum_latency / self.n_requests if self.n_requests else 0.0

    @staticmethod
    def _pct(xs: List[float], q: float) -> float:
        return float(np.percentile(xs, q)) if xs else 0.0

    def latency_pct(self, q: float) -> float:
        return self._pct(self.latencies, q)

    def ttft_pct(self, q: float) -> float:
        return self._pct(self.ttfts, q)

    def tpot_pct(self, q: float) -> float:
        return self._pct(self.tpots, q)

    @classmethod
    def merged(cls, parts: List["ServeStats"]) -> "ServeStats":
        """Fleet-level aggregate: additive counters, wall = slowest replica."""
        out = cls()
        for s in parts:
            out.n_requests += s.n_requests
            out.n_tokens += s.n_tokens
            out.wall_time = max(out.wall_time, s.wall_time)
            out.swap_time += s.swap_time
            out.compute_time += s.compute_time
            out.decompress_time += s.decompress_time
            merge_mode_dict(out.decompress_by_mode, s.decompress_by_mode)
            out.n_swaps += s.n_swaps
            out.sum_latency += s.sum_latency
            out.latencies.extend(s.latencies)
            out.ttfts.extend(s.ttfts)
            out.tpots.extend(s.tpots)
            # peaks keep the worst single replica; counters are additive
            out.peak_kv_pages = max(out.peak_kv_pages, s.peak_kv_pages)
            out.peak_adapter_pages = max(out.peak_adapter_pages,
                                         s.peak_adapter_pages)
            out.peak_resident_adapters = max(out.peak_resident_adapters,
                                             s.peak_resident_adapters)
            out.peak_batch = max(out.peak_batch, s.peak_batch)
            out.n_page_reclaims += s.n_page_reclaims
            out.pages_reclaimed += s.pages_reclaimed
            out.n_page_blocked += s.n_page_blocked
            out.n_migrated_in += s.n_migrated_in
            out.n_migrated_out += s.n_migrated_out
            out.n_preempted += s.n_preempted
            out.restore_time += s.restore_time
        return out

    def to_dict(self):
        return {
            "n_requests": self.n_requests, "n_tokens": self.n_tokens,
            "wall_time_s": self.wall_time, "swap_time_s": self.swap_time,
            "compute_time_s": self.compute_time, "n_swaps": self.n_swaps,
            "decompress_time_s": self.decompress_time,
            "decompress_by_mode_s": dict(self.decompress_by_mode),
            "throughput_rps": self.throughput_rps,
            "throughput_tps": self.throughput_tps,
            "mean_latency_s": self.mean_latency,
            "latency_p50_s": self.latency_pct(50),
            "latency_p95_s": self.latency_pct(95),
            "latency_p99_s": self.latency_pct(99),
            "ttft_p50_s": self.ttft_pct(50),
            "ttft_p95_s": self.ttft_pct(95),
            "ttft_p99_s": self.ttft_pct(99),
            "tpot_p50_s": self.tpot_pct(50),
            "tpot_p95_s": self.tpot_pct(95),
            "tpot_p99_s": self.tpot_pct(99),
            "peak_kv_pages": self.peak_kv_pages,
            "peak_adapter_pages": self.peak_adapter_pages,
            "peak_resident_adapters": self.peak_resident_adapters,
            "peak_batch": self.peak_batch,
            "n_page_reclaims": self.n_page_reclaims,
            "pages_reclaimed": self.pages_reclaimed,
            "n_page_blocked": self.n_page_blocked,
            "n_migrated_in": self.n_migrated_in,
            "n_migrated_out": self.n_migrated_out,
            "n_preempted": self.n_preempted,
            "restore_time_s": self.restore_time,
        }
