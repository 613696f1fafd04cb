"""The part of the serving resources that the engine needs: the unified
paged HBM pool shared by KV blocks and adapter weights, and the per-mode
counter merge.

A copy of the matching definitions in the JAX package's
``serving/resources.py``, with the KV wire compression's configuration
(:class:`KVCompressionConfig`, priced from the packed output of
``kernels/kv_quant.py``); the hardware budget, the KV fabric and the
adaptive compression policy are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

# tokens per KV page — one page is one 128-token KV block, the same
# granularity the wire-quantization kernels use (kv_quant.BLOCK_T; the
# serving code stays free of torch, so the constant is duplicated and
# tests/test_torch_kvquant.py asserts the two agree)
PAGE_TOKENS = 128


@dataclasses.dataclass
class PagedPoolConfig:
    """One paged HBM region per replica, shared by KV blocks and adapter
    weights (S-LoRA's unified paging).

    Units: ``total_bytes`` is the HBM region in **bytes**; ``page_bytes``
    is the size of one page in **bytes** — one :data:`PAGE_TOKENS`-token
    KV block across all layers/heads, i.e.
    ``ModelFootprint.kv_bytes_per_token * PAGE_TOKENS`` (see
    :meth:`ModelFootprint.pool_config
    <repro.serving.engine.ModelFootprint.pool_config>`).  Everything the
    pool hands out is counted in whole **pages**.

    ``adapter_share`` reproduces the pre-unified STATIC SPLIT as a
    degenerate configuration: when set, adapter + pinned pages are capped
    at ``floor(adapter_share * total_pages)`` and KV pages at the
    remainder, so neither side can borrow the other's headroom.  ``None``
    (the default) is the unified pool — the only caps are the pool itself.
    ``benchmarks/paged_pool.py`` measures the two against each other.
    """

    total_bytes: float               # bytes: the pool's HBM region
    page_bytes: int                  # bytes: one PAGE_TOKENS-token KV block
    adapter_share: Optional[float] = None    # static-split baseline knob

    def __post_init__(self):
        if self.total_bytes <= 0:
            raise ValueError("pool total_bytes must be > 0")
        if self.page_bytes < 1:
            raise ValueError("page_bytes must be >= 1")
        if self.adapter_share is not None \
                and not 0.0 < self.adapter_share < 1.0:
            raise ValueError("adapter_share must be in (0, 1) or None")
        if self.total_pages < 1:
            raise ValueError(
                f"pool smaller than one page: {self.total_bytes:.0f} B total "
                f"vs {self.page_bytes} B/page")

    @property
    def total_pages(self) -> int:
        return int(self.total_bytes // self.page_bytes)


class PagedPool:
    """Page-granular allocation ledger over one HBM region.

    Pages are fungible (no placement, so no fragmentation — the gathered-
    page decode kernel reads them through a page table) and every page is
    in exactly one state at a time:

      ``free`` — available to either side;
      ``kv`` — holds a decode request's KV block (reserved at admission,
        freed when the request finishes; never evicted mid-request);
      ``adapter`` — holds adapter weights, owned by an
        :class:`~repro.serving.adapter_cache.AdapterCache` entry, the ONLY
        evictable state;
      ``pinned`` — compressed shared bases (U/V), never evicted.

    Allocation invariants (asserted by ``tests/test_paged.py`` and
    documented in ``docs/architecture.md``):

      I1 — conservation: ``free_pages + sum(used.values())`` equals
           ``total_pages`` after every operation;
      I2 — no negative balances: ``free(kind, n)`` with ``n`` larger than
           the kind's balance raises instead of underflowing;
      I3 — no overcommit: an allocation never succeeds beyond capacity
           (``free_pages`` >= 0 always; with ``adapter_share`` set, also
           never beyond the side's static cap);
      I4 — reclaim only evicts ``adapter`` pages: ``kv`` and ``pinned``
           pages are never taken by :meth:`alloc_with_reclaim`;
      I5 — no fragmentation: any request for ``n <= free_pages`` (within
           caps) succeeds, regardless of prior alloc/free churn.

    Usage::

        pool = PagedPool(PagedPoolConfig(total_bytes=1e9, page_bytes=2**20))
        pool.alloc("adapter", 4)
        pool.set_reclaimer(lambda n: cache.reclaim(n, protected=set()))
        pool.alloc_with_reclaim("kv", pool.free_pages + 2)  # evicts adapters
        pool.free("kv", 2)
    """

    KINDS = ("kv", "adapter", "pinned")

    def __init__(self, cfg: PagedPoolConfig):
        self.cfg = cfg
        self.used: Dict[str, int] = {k: 0 for k in self.KINDS}
        self.peak: Dict[str, int] = {k: 0 for k in self.KINDS}
        self.n_reclaims = 0              # alloc_with_reclaim eviction rounds
        self.pages_reclaimed = 0         # adapter pages evicted to fund KV
        self._reclaimer: Optional[Callable[[int], int]] = None

    # -- sizing ------------------------------------------------------------
    @property
    def total_pages(self) -> int:
        return self.cfg.total_pages

    @property
    def free_pages(self) -> int:
        return self.total_pages - sum(self.used.values())

    @property
    def adapter_cap(self) -> int:
        """Page cap on adapter + pinned pages (the static split's adapter
        side); the whole pool when ``adapter_share`` is None."""
        if self.cfg.adapter_share is None:
            return self.total_pages
        return int(self.cfg.adapter_share * self.total_pages)

    @property
    def kv_cap(self) -> int:
        """Page cap on KV pages; the whole pool when unified."""
        if self.cfg.adapter_share is None:
            return self.total_pages
        return self.total_pages - self.adapter_cap

    def pages_for(self, nbytes: float) -> int:
        """Whole pages covering `nbytes` (0 for empty)."""
        if nbytes <= 0:
            return 0
        return int(math.ceil(nbytes / self.cfg.page_bytes))

    # -- allocation --------------------------------------------------------
    def _check_kind(self, kind: str) -> None:
        if kind not in self.KINDS:
            raise ValueError(f"unknown page kind {kind!r}; "
                             f"one of {self.KINDS}")

    def can_alloc(self, kind: str, n_pages: int) -> bool:
        self._check_kind(kind)
        if n_pages <= 0:
            return True
        if n_pages > self.free_pages:
            return False
        if kind == "kv":
            return self.used["kv"] + n_pages <= self.kv_cap
        return (self.used["adapter"] + self.used["pinned"] + n_pages
                <= self.adapter_cap)

    def try_alloc(self, kind: str, n_pages: int) -> bool:
        if not self.can_alloc(kind, n_pages):
            return False
        self.used[kind] += n_pages
        self.peak[kind] = max(self.peak[kind], self.used[kind])
        return True

    def alloc(self, kind: str, n_pages: int) -> None:
        if not self.try_alloc(kind, n_pages):
            raise MemoryError(
                f"paged pool exhausted: {kind} needs {n_pages} pages, "
                f"{self.free_pages} free of {self.total_pages} "
                f"(kv={self.used['kv']}, adapter={self.used['adapter']}, "
                f"pinned={self.used['pinned']})")

    def free(self, kind: str, n_pages: int) -> None:
        self._check_kind(kind)
        if n_pages < 0 or n_pages > self.used[kind]:
            raise ValueError(f"cannot free {n_pages} {kind} pages; "
                             f"{self.used[kind]} held")
        self.used[kind] -= n_pages

    # -- adapter-for-KV pressure -------------------------------------------
    def set_reclaimer(self, fn: Callable[[int], int]) -> None:
        """Register the adapter side's eviction hook: ``fn(n_pages)`` frees
        up to `n_pages` of ``adapter`` pages (prefetched-but-unused first,
        then LRU — see :meth:`AdapterCache.reclaim
        <repro.serving.adapter_cache.AdapterCache.reclaim>`) and returns
        how many it actually freed."""
        self._reclaimer = fn

    def alloc_with_reclaim(self, kind: str, n_pages: int) -> bool:
        """Allocate, evicting adapter pages to cover a shortfall.

        This is the page-granular pressure of the unified pool: a KV
        reservation that does not fit asks the adapter cache to release
        cold pages (invariant I4 — only ``adapter`` pages move).  Returns
        False if the allocation still cannot fit (caps, pinned pages, or
        nothing evictable)."""
        if self.try_alloc(kind, n_pages):
            return True
        if kind == "kv" and self._reclaimer is not None:
            shortfall = n_pages - self.free_pages
            if 0 < shortfall <= self.used["adapter"]:
                freed = self._reclaimer(shortfall)
                if freed > 0:
                    self.n_reclaims += 1
                    self.pages_reclaimed += freed
        return self.try_alloc(kind, n_pages)

    def feasible(self, kv_more: int, adapter_more: int,
                 evictable_adapter_pages: int) -> bool:
        """Would `kv_more` KV pages AND `adapter_more` adapter pages fit if
        up to `evictable_adapter_pages` of the current adapter pages were
        evicted first?  The engine's admission check: a request is admitted
        only when both its KV reservation and its (possibly non-resident)
        adapter can be funded without touching protected pages."""
        evictable = min(evictable_adapter_pages, self.used["adapter"])
        if kv_more + adapter_more > self.free_pages + evictable:
            return False
        if self.used["kv"] + kv_more > self.kv_cap:
            return False
        return (self.used["adapter"] - evictable + adapter_more
                + self.used["pinned"] <= self.adapter_cap)

    def to_dict(self) -> Dict:
        return {
            "total_pages": self.total_pages,
            "page_bytes": self.cfg.page_bytes,
            "kv_pages": self.used["kv"],
            "adapter_pages": self.used["adapter"],
            "pinned_pages": self.used["pinned"],
            "free_pages": self.free_pages,
            "peak_kv_pages": self.peak["kv"],
            "peak_adapter_pages": self.peak["adapter"],
            "n_reclaims": self.n_reclaims,
            "pages_reclaimed": self.pages_reclaimed,
        }


def merge_mode_dict(into: Dict, other: Dict) -> None:
    """Accumulate per-mode counters (shared by the fabric / prefill /
    decode per-mode stats dicts)."""
    for k, v in other.items():
        into[k] = into.get(k, 0) + v


# ---------------------------------------------------------------------------
# KV wire compression
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCompressionConfig:
    """Compress-then-serve applied to the KV handoff itself: prefill
    quantizes (or projects) each produced KV cache before it goes on the
    fabric, and the decode replica dequantizes it.

    Modes:

      ``int8`` / ``int4`` — per-channel symmetric quantization.  The wire
        ratios and worst-case error bounds are not free parameters: they
        are the packed output of ``kernels/kv_quant.py`` (values + one f32
        scale per channel per 128-token block), and
        tests/test_torch_kvquant.py asserts this class and the kernel
        module agree.
      ``lowrank`` — keep ``lowrank_ratio`` of the KV channels through a
        learned projection; the wire ratio is the kept fraction, and no
        static error bound is exported.

    Cost model: quantize/dequantize stream the block once (read one side,
    write the other), so both are bound by memory bandwidth —
    ``overhead + (raw + wire) / mem_bw`` — with ``mem_bw`` the H100's HBM
    rate, as ``ServingHardware.hbm_bw``.
    """

    mode: str = "int8"               # int8 | int4 | lowrank
    lowrank_ratio: float = 0.25      # kept channel fraction (lowrank only)
    # (de)quant streaming bandwidth: one H100 SXM's HBM, 3.35 TB/s (NVIDIA's
    # data sheet); mirrors engine.ServingHardware.hbm_bw, kept in sync by
    # tests/test_torch_kvquant.py
    mem_bw: float = 3.35e12
    # the launch and wrapper cost per handoff, s: one kv_quantize call's
    # CUDA-event time less its device time on a (128, 65536) bf16 block
    # (chip_smoke.py's kv_quantize row, launch_overhead_ms; NVIDIA H100
    # 80GB HBM3, 700.00 W): the median of three runs' 0.0091, 0.0155 and
    # 0.0319 ms (the host's share moves from run to run)
    kernel_overhead: float = 1.55e-5

    MODES = ("int8", "int4", "lowrank")
    # kernels/kv_quant.py's WIRE_RATIO and ERROR_BOUND at the canonical
    # 128-token block, duplicated so this module imports no torch
    WIRE_RATIO = {"int8": 33 / 64, "int4": 17 / 64}
    ERROR_BOUND = {"int8": 1 / 254, "int4": 1 / 14}
    # packed-artifact structure, per channel: quantized values (1/2 or 1/4
    # of the raw bf16 bytes) plus one f32 scale per BLOCK_TOKENS tokens —
    # a tail block smaller than BLOCK_TOKENS carries a full scale, so its
    # wire ratio is strictly worse than the full-block aggregate above
    VALUE_RATIO = {"int8": 1 / 2, "int4": 1 / 4}
    BLOCK_TOKENS = PAGE_TOKENS       # kv_quant.BLOCK_T
    BLOCK_RAW_BYTES = 256            # one channel-block of bf16 tokens
    SCALE_BYTES = 4                  # one f32 scale per channel per block

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(f"unknown compression mode {self.mode!r}; "
                             f"one of {self.MODES}")
        if not 0.0 < self.lowrank_ratio <= 1.0:
            raise ValueError("lowrank_ratio must be in (0, 1]")
        if self.mem_bw <= 0:
            raise ValueError("mem_bw must be > 0")

    @property
    def wire_ratio(self) -> float:
        if self.mode == "lowrank":
            return self.lowrank_ratio
        return self.WIRE_RATIO[self.mode]

    @property
    def error_bound(self) -> Optional[float]:
        """Worst-case per-channel relative error (None for lowrank)."""
        return self.ERROR_BOUND.get(self.mode)

    def wire_bytes(self, raw_bytes: int,
                   bytes_per_token: Optional[int] = None) -> int:
        """On-the-wire size of one raw KV span, block-granularly.

        Scales are per channel per ``BLOCK_TOKENS``-token block, so a
        partial tail block pays a full scale: with ``bytes_per_token``
        known (see :func:`kv_bytes_per_token`) the scale count is exact,
        ``ceil(tokens / 128) * channels``; without it the span is modeled
        as per-channel 256-raw-byte blocks, one scale per full-or-partial
        block.  Both reduce to the aggregate ``WIRE_RATIO`` on
        block-aligned spans."""
        if raw_bytes <= 0:
            return 0
        if self.mode == "lowrank":
            return max(1, math.ceil(raw_bytes * self.lowrank_ratio))
        value_bytes = math.ceil(raw_bytes * self.VALUE_RATIO[self.mode])
        if (bytes_per_token is not None and bytes_per_token >= 2
                and bytes_per_token % 2 == 0):
            n_channels = bytes_per_token // 2
            n_blocks = math.ceil(
                raw_bytes / (bytes_per_token * self.BLOCK_TOKENS))
            return value_bytes + self.SCALE_BYTES * n_blocks * n_channels
        return (value_bytes
                + self.SCALE_BYTES * math.ceil(raw_bytes
                                               / self.BLOCK_RAW_BYTES))

    def compress_time(self, raw_bytes: int,
                      bytes_per_token: Optional[int] = None) -> float:
        """Prefill-side quantize/project cost for one KV cache."""
        if raw_bytes <= 0:
            return 0.0
        wire = self.wire_bytes(raw_bytes, bytes_per_token)
        return self.kernel_overhead + (raw_bytes + wire) / self.mem_bw

    def decompress_time(self, raw_bytes: int,
                        bytes_per_token: Optional[int] = None) -> float:
        """Decode-side dequantize cost (same streaming roofline)."""
        return self.compress_time(raw_bytes, bytes_per_token)


def kv_bytes_per_token(nbytes: int, prompt_len: int) -> Optional[int]:
    """Recover the bf16 KV bytes/token of a handoff from its request, or
    None when `nbytes` does not decompose into whole per-token channels
    (hand-built executors with synthetic KV sizes fall back to the
    byte-granular block model)."""
    if prompt_len > 0 and nbytes > 0 and nbytes % prompt_len == 0:
        bpt = nbytes // prompt_len
        if bpt % 2 == 0:
            return bpt
    return None
