"""Unified serving resources: hardware budget, paged HBM pool, shared KV
fabric, and KV wire compression (the port of ``serving/resources.py``).

Abstractions the rest of the serving stack draws from instead of owning
capacity itself:

  - :class:`HardwareBudget` — N accelerators total, with per-role
    footprints (accelerators per prefill worker / per decode replica), or
    a typed pool of :class:`SliceType` classes priced in cost units.  Both
    tiers allocate from the same pool, so the joint autoscaler can only
    grow one tier by leaving room in — or actively shrinking — the other.

  - :class:`PagedPool` — ONE paged HBM region per replica shared by KV
    blocks and adapter weights (S-LoRA's unified paging).  A page is one
    :data:`PAGE_TOKENS`-token KV block, the granularity of
    ``kernels/kv_quant.py``, and adapter weights occupy whole pages of the
    same pool.  The memory-architecture spec is ``docs/architecture.md``.

  - :class:`KVFabric` — the prefill->decode KV interconnect as one shared,
    contended resource: chunks of all in-flight transfers serialize onto
    one channel (aggregate bandwidth, per-chunk latency), interleaved
    fairly (fewest-chunks-sent first); the first landed chunk unblocks
    decode admission (``decode_ready_time``) and the tail overlaps decode
    (``kv_landed_time``).

  - :class:`KVCompressionConfig` — compress-then-serve applied to the
    handoff: prefill quantizes (int8/int4 per channel, the packed output
    of ``kernels/kv_quant.py``) or projects each KV cache before it ships,
    and the decode replica pays dequantization at admission.

  - :class:`AdaptiveCompressionPolicy` — the wire mode picked per
    transfer from the channel's backlog, up a raw -> int8 -> int4 ladder
    with hysteresis, under a ceiling the joint autoscaler owns.  A ladder
    locked at raw reproduces the ``compression=None`` fabric bit for bit.

The classes are copies of the JAX package's, with one NVIDIA H100 SXM's
figures where those describe the chip: the (de)quantization streaming
rate (``mem_bw``, 3.35 TB/s, as ``ServingHardware.hbm_bw``) and the
launch cost per handoff (``kernel_overhead``).  Figures that describe no
chip (the fabric's 50 GB/s, the budget's footprints, the paging) are the
JAX package's.

Degenerate configurations are exact by construction:

  * one worker, ``chunk_bytes == 0`` (whole-KV serial handoff) gives the
    per-worker link's times — ``start = max(free_at, prefill_done)``,
    ``done = start + latency + nbytes / bandwidth``;
  * ``chunk_bytes >= nbytes`` is a single chunk, i.e. the serial path.

The fabric is resolved lazily: prefill workers *record* transfers as their
simulated prefill completes, and :meth:`KVFabric.resolve` then schedules
all recorded chunks on the shared channel and stamps the requests, once
per drain (window by window under the autoscaler), so channel backlog
carries across windows through ``free_at``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from ..launch.roofline import HBM_BW


# ---------------------------------------------------------------------------
# hardware budget (typed slice pool)
# ---------------------------------------------------------------------------


_ROLES = ("prefill", "decode")


@dataclasses.dataclass(frozen=True)
class SliceType:
    """One accelerator slice class in a heterogeneous pool.

    A slice type prices and scales everything placement needs to know
    about one hardware class:

      - ``cost_units`` — what one slice of this type costs against the
        pool's fixed budget; equal-cost comparisons across types happen
        in these units, not replica counts.
      - ``prefill_slices`` / ``decode_slices`` — per-role footprint
        multipliers: slices of this type one prefill worker / decode
        replica occupies (the typed generalization of the legacy
        ``prefill_accels_per_worker`` / ``decode_accels_per_replica``).
      - ``hbm_bytes`` — the slice's HBM; a replica's :class:`PagedPool`
        is sized from it.  ``None`` inherits the base
        :class:`~repro_torch.serving.engine.ServingHardware` figure.
      - ``fabric_bw`` — interconnect bandwidth (bytes/s) for sizing a
        :class:`FabricConfig` fed by workers of this type.
      - ``prefill_speed`` / ``decode_speed`` — factors on the base
        hardware's prefill compute / HBM streaming rooflines (see
        :meth:`ServingHardware.for_slice
        <repro_torch.serving.engine.ServingHardware.for_slice>`).
      - ``sgmv_tile_rank`` — native contraction-tile width (ranks) of
        the slice's SGMV pipeline: a rank-r adapter's tiles pad to the
        next multiple of this, so skinny ranks waste a wide slice and
        the router should bias them toward narrow ones.  The pure cost
        model is :func:`repro_torch.kernels.sgmv.sgmv_rank_efficiency`.

    The defaults describe the legacy interchangeable accelerator — unit
    cost, unit footprints, unit speed factors — so a pool of only this
    type is arithmetically identical to the pre-typed budget.
    """

    name: str
    cost_units: int = 1
    prefill_slices: int = 1          # per-role footprint multipliers
    decode_slices: int = 1
    hbm_bytes: Optional[float] = None    # None: inherit base hardware
    fabric_bw: Optional[float] = None    # bytes/s; None: fabric default
    prefill_speed: float = 1.0       # scales peak compute (prefill roofline)
    decode_speed: float = 1.0        # scales HBM bandwidth (decode roofline)
    sgmv_tile_rank: int = 8          # native SGMV contraction tile (ranks)

    def footprint(self, role: str) -> int:
        if role == "prefill":
            return self.prefill_slices
        if role == "decode":
            return self.decode_slices
        raise ValueError(f"unknown role {role!r}; one of {_ROLES}")

    def cost(self, role: str) -> int:
        """Cost units one `role` allocation on this slice type consumes."""
        return self.cost_units * self.footprint(role)


@dataclasses.dataclass
class BudgetConfig:
    """A fixed pool of accelerator capacity shared by both serving tiers.

    Two shapes, one config:

    * **Legacy single-type** (the default): the three count fields are
      whole **accelerator counts** — ``total_accelerators`` is the pool
      size, ``prefill_accels_per_worker`` / ``decode_accels_per_replica``
      the per-role footprints one allocation consumes.  This path stays
      bit-exact with every committed baseline.
    * **Typed** (``slice_types`` set): the pool is ``total_cost_units``
      cost units (defaulting to ``total_accelerators``) that allocations
      spend through a :class:`SliceType`'s ``cost(role)``.  A mixed-slice
      fleet at the same ``total_cost_units`` is *equal cost* to any
      homogeneous one — the comparison ``benchmarks/hetero_placement.py``
      makes.
    """

    total_accelerators: int = 8
    prefill_accels_per_worker: int = 1
    decode_accels_per_replica: int = 1
    # typed pool: the slice classes allocations may draw from, and the
    # fixed cost-unit budget they share; None keeps the legacy pool
    slice_types: Optional[Tuple[SliceType, ...]] = None
    total_cost_units: Optional[int] = None

    @property
    def typed(self) -> bool:
        return bool(self.slice_types)

    @property
    def total_units(self) -> int:
        """Pool size in cost units (== accelerators when untyped)."""
        if self.total_cost_units is not None:
            return self.total_cost_units
        return self.total_accelerators

    def default_slice(self) -> SliceType:
        """The single slice class a legacy config describes."""
        return SliceType(name="accel",
                         prefill_slices=self.prefill_accels_per_worker,
                         decode_slices=self.decode_accels_per_replica)

    def types(self) -> Tuple[SliceType, ...]:
        if self.slice_types:
            return tuple(self.slice_types)
        return (self.default_slice(),)

    def type_named(self, name: str) -> SliceType:
        for st in self.types():
            if st.name == name:
                return st
        raise ValueError(f"unknown slice type {name!r}; one of "
                         f"{[s.name for s in self.types()]}")

    def cost(self, role: str, slice_type: Optional[SliceType] = None) -> int:
        """Cost units one `role` allocation consumes on `slice_type`.

        With ``slice_type=None``: the legacy per-role footprint for an
        untyped pool (arithmetic identical to the pre-typed budget), or
        the *cheapest* type's cost for a typed one — the floor that
        feasibility checks compare against ``available``."""
        if slice_type is not None:
            return slice_type.cost(role)
        if not self.typed:
            return self.default_slice().cost(role)
        return min(st.cost(role) for st in self.types())


class HardwareBudget:
    """Allocation ledger over a :class:`BudgetConfig`.

    The budget owns capacity; tiers merely hold allocations.  ``allocate``
    raises when the pool is exhausted — callers must check
    :meth:`can_allocate` (or free capacity by retiring from the other role)
    first, which is exactly the trade the joint autoscaler implements.
    All quantities are **cost units** (plain accelerator counts for a
    legacy single-type config — see :class:`BudgetConfig`); per-replica
    HBM is accounted separately, in pages, by each replica's
    :class:`PagedPool`.

    Conservation invariants, asserted per slice type by
    ``tests/test_hetero.py``: ``in_use + available == cfg.total_units``
    after every operation (H1); an allocation whose cost exceeds
    ``available`` raises instead of overcommitting, and releasing a
    (role, type) pair with no live allocation raises (H2).

    Usage::

        budget = HardwareBudget(BudgetConfig(total_accelerators=6))
        budget.allocate("prefill")           # 1 worker  (5 accels free)
        budget.allocate("decode")            # 1 replica (4 accels free)
        if budget.can_allocate("decode"):
            budget.allocate("decode")
        budget.release("prefill")            # retire a worker -> pool

    Typed pools name the slice class per allocation::

        big, small = SliceType("big", cost_units=4), SliceType("small")
        budget = HardwareBudget(BudgetConfig(
            slice_types=(big, small), total_cost_units=8))
        budget.allocate("prefill", big)      # 4 units (4 free)
        budget.allocate("decode", small)     # 1 unit  (3 free)
        budget.release("prefill", big)
    """

    def __init__(self, cfg: BudgetConfig):
        if cfg.total_units < 1:
            raise ValueError("budget needs at least one accelerator")
        if cfg.typed:
            names = [st.name for st in cfg.types()]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate slice type names: {names}")
        self.cfg = cfg
        # role -> slice type name -> live allocation count
        self._alloc: Dict[str, Dict[str, int]] = {r: {} for r in _ROLES}

    def _resolve(self, role: str,
                 slice_type: Optional[SliceType]) -> SliceType:
        if role not in _ROLES:
            raise ValueError(f"unknown role {role!r}; one of {_ROLES}")
        if slice_type is None:
            if self.cfg.typed:
                raise ValueError(
                    f"typed budget needs an explicit slice type; one of "
                    f"{[s.name for s in self.cfg.types()]}")
            return self.cfg.default_slice()
        return self.cfg.type_named(slice_type.name)

    @property
    def allocated(self) -> Dict[str, int]:
        """Legacy view: role -> total allocation count over all types."""
        return {role: sum(d.values()) for role, d in self._alloc.items()}

    @property
    def in_use(self) -> int:
        return sum(n * self.cfg.type_named(t).cost(role)
                   for role, d in self._alloc.items()
                   for t, n in d.items())

    @property
    def available(self) -> int:
        return self.cfg.total_units - self.in_use

    def count(self, role: str,
              slice_type: Optional[SliceType] = None) -> int:
        if slice_type is not None:
            return self._alloc[role].get(slice_type.name, 0)
        return sum(self._alloc[role].values())

    def can_allocate(self, role: str,
                     slice_type: Optional[SliceType] = None) -> bool:
        """Whether one `role` allocation fits: on `slice_type` when named,
        else on the legacy type (untyped pool) / the cheapest type."""
        return self.cfg.cost(role, slice_type) <= self.available

    def allocate(self, role: str,
                 slice_type: Optional[SliceType] = None) -> SliceType:
        """Spend one `role` allocation; returns the slice type it landed
        on.  An untyped pool resolves ``slice_type=None`` to the legacy
        accelerator; a typed pool requires the caller to name the type
        (the autoscaler's ``pick_slice`` choice)."""
        st = self._resolve(role, slice_type)
        if st.cost(role) > self.available:
            raise MemoryError(
                f"hardware budget exhausted: {role} needs "
                f"{st.cost(role)} accelerators, {self.available} free "
                f"of {self.cfg.total_units}")
        d = self._alloc[role]
        d[st.name] = d.get(st.name, 0) + 1
        return st

    def release(self, role: str,
                slice_type: Optional[SliceType] = None) -> None:
        if slice_type is None and self.cfg.typed:
            held = [t for t, n in self._alloc[role].items() if n > 0]
            if len(held) == 1:       # unambiguous: only one type held
                slice_type = self.cfg.type_named(held[0])
        st = self._resolve(role, slice_type)
        if self._alloc[role].get(st.name, 0) < 1:
            raise ValueError(f"no {role} allocation to release")
        self._alloc[role][st.name] -= 1

    def to_dict(self) -> Dict:
        d = {
            "total_accelerators": self.cfg.total_units,
            "prefill_workers": self.count("prefill"),
            "decode_replicas": self.count("decode"),
            "accelerators_free": self.available,
        }
        if self.cfg.typed:
            d["slices"] = {role: {t: n for t, n in alloc.items() if n}
                           for role, alloc in self._alloc.items()}
        return d


# ---------------------------------------------------------------------------
# unified paged HBM pool (KV blocks + adapter weights)
# ---------------------------------------------------------------------------


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
    <repro_torch.serving.engine.ModelFootprint.pool_config>`).  Everything the
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
        :class:`~repro_torch.serving.adapter_cache.AdapterCache` entry, the ONLY
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
        <repro_torch.serving.adapter_cache.AdapterCache.reclaim>`) and returns
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
    mem_bw: float = HBM_BW
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


# ---------------------------------------------------------------------------
# adaptive per-transfer compression policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdaptiveCompressionConfig:
    """Per-transfer wire-mode selection from live channel backlog.

    ``modes`` is the escalation ladder, level 0 first; the floor must be
    ``"raw"`` so an idle fabric pays neither quantization error nor
    (de)quant compute.  A transfer recorded while the channel's estimated
    backlog (see :meth:`KVFabric.backlog_seconds`) exceeds
    ``escalate_backlog_s[i - 1]`` ships at ladder level ``i`` (highest
    threshold crossed wins — a spike jumps straight to int4).  Hysteresis
    is asymmetric: escalation is immediate (latency protection), relaxing
    drops one level at a time and only after ``min_dwell`` transfers at
    the current level AND the backlog has fallen below ``relax_fraction``
    of that level's threshold — so a backlog oscillating inside the band
    does not thrash the mode.

    ``initial_ceiling`` caps the ladder (None = top).  The joint
    autoscaler owns the ceiling at runtime: it starts it low, raises it
    under budget-exhausted prefill pressure *before* trading a replica
    away from a cold tier, and relaxes it in quiet windows.

    ``modes=("raw",)`` (or a ceiling pinned at 0) is the raw-locked
    policy: bit-exact with a ``compression=None`` fabric.
    """

    modes: Tuple[str, ...] = ("raw", "int8", "int4")
    escalate_backlog_s: Tuple[float, ...] = (0.02, 0.04)
    relax_fraction: float = 0.25     # relax below this fraction of the band
    min_dwell: int = 8               # transfers at a level before relaxing
    initial_ceiling: Optional[int] = None    # None = top of the ladder
    # per-mode cost knobs, forwarded to each level's KVCompressionConfig
    lowrank_ratio: float = 0.25
    # one H100 SXM's HBM rate and the measured launch cost per handoff,
    # as KVCompressionConfig's own defaults
    mem_bw: float = HBM_BW
    kernel_overhead: float = 1.55e-5

    def __post_init__(self):
        known = ("raw",) + KVCompressionConfig.MODES
        if not self.modes or self.modes[0] != "raw":
            raise ValueError("the ladder floor must be 'raw' (level 0)")
        if len(set(self.modes)) != len(self.modes):
            raise ValueError("duplicate ladder modes")
        for m in self.modes:
            if m not in known:
                raise ValueError(f"unknown ladder mode {m!r}; one of {known}")
        if len(self.escalate_backlog_s) < len(self.modes) - 1:
            raise ValueError("need one escalate threshold per non-raw level")
        steps = self.escalate_backlog_s[:len(self.modes) - 1]
        if any(t <= 0 for t in steps) or list(steps) != sorted(set(steps)):
            raise ValueError("escalate thresholds must be positive and "
                             "strictly increasing")
        if not 0.0 < self.relax_fraction < 1.0:
            raise ValueError("relax_fraction must be in (0, 1)")
        if self.min_dwell < 1:
            raise ValueError("min_dwell must be >= 1")
        if (self.initial_ceiling is not None
                and not 0 <= self.initial_ceiling < len(self.modes)):
            raise ValueError("initial_ceiling outside the ladder")


class AdaptiveCompressionPolicy:
    """Stateful ladder walker over an :class:`AdaptiveCompressionConfig`.

    :meth:`decide` is called once per recorded transfer with the channel's
    backlog estimate **in seconds** and returns the transfer's
    :class:`KVCompressionConfig` (None for raw).  ``ceiling`` is the
    autoscaler-owned cap; ``n_switches`` counts level changes (the
    hysteresis tests bound it).

    Usage::

        policy = AdaptiveCompressionPolicy(AdaptiveCompressionConfig(
            modes=("raw", "int8", "int4"),
            escalate_backlog_s=(0.02, 0.04), initial_ceiling=1))
        cfg = policy.decide(backlog_s=0.03)  # climbs raw -> int8
        policy.raise_ceiling()               # autoscaler grants int4
        policy.lower_ceiling()               # quiet window: clamp back

    Normally :class:`KVFabric` drives it — workers just call
    ``fabric.plan(...)``.
    """

    def __init__(self, cfg: AdaptiveCompressionConfig):
        self.cfg = cfg
        self.level = 0
        self.ceiling = (self.top if cfg.initial_ceiling is None
                        else cfg.initial_ceiling)
        self.n_switches = 0
        self.n_decisions = 0
        self._dwell = 0
        self._configs = {
            m: KVCompressionConfig(mode=m, lowrank_ratio=cfg.lowrank_ratio,
                                   mem_bw=cfg.mem_bw,
                                   kernel_overhead=cfg.kernel_overhead)
            for m in cfg.modes if m != "raw"}

    @property
    def top(self) -> int:
        return len(self.cfg.modes) - 1

    @property
    def mode(self) -> str:
        return self.cfg.modes[self.level]

    @property
    def ceiling_mode(self) -> str:
        return self.cfg.modes[self.ceiling]

    def _move(self, level: int) -> None:
        self.level = level
        self._dwell = 0
        self.n_switches += 1

    def decide(self, backlog_s: float) -> Optional[KVCompressionConfig]:
        """Mode for the next transfer given the channel backlog estimate."""
        cfg = self.cfg
        self.n_decisions += 1
        self._dwell += 1
        target = 0
        for i in range(1, len(cfg.modes)):
            if backlog_s > cfg.escalate_backlog_s[i - 1]:
                target = i
        target = min(target, self.ceiling)
        if target > self.level:
            self._move(target)               # escalate immediately
        elif (target < self.level and self._dwell >= cfg.min_dwell
              and backlog_s < (cfg.relax_fraction
                               * cfg.escalate_backlog_s[self.level - 1])):
            self._move(self.level - 1)       # relax one step, out of band
        return self._configs.get(self.mode)

    # -- autoscaler-owned ceiling ------------------------------------------
    def raise_ceiling(self) -> bool:
        """One ladder level more headroom; False when already at the top."""
        if self.ceiling >= self.top:
            return False
        self.ceiling += 1
        return True

    def lower_ceiling(self) -> bool:
        """One level less; clamps the live level down with it."""
        if self.ceiling <= 0:
            return False
        self.ceiling -= 1
        if self.level > self.ceiling:
            self._move(self.ceiling)
        return True


# ---------------------------------------------------------------------------
# shared KV fabric
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FabricConfig:
    """Shared prefill->decode interconnect.

    ``bandwidth`` is the *aggregate* fabric bandwidth all prefill workers
    contend for (per-worker private links would be ``n_workers`` times
    this).  ``latency`` is paid per chunk — small chunks stream the first
    bytes to decode sooner but occupy the channel longer in total, which is
    the real chunking trade-off.  ``chunk_bytes == 0`` ships each KV cache
    as one chunk (the serial path).
    """

    bandwidth: float = 50e9          # aggregate bytes/s prefill -> decode
    latency: float = 200e-6          # per-chunk fixed cost
    chunk_bytes: int = 0             # 0 = whole-KV serial handoff
    # wire compression; None ships raw KV (bit-exact with the uncompressed fabric)
    compression: Optional[KVCompressionConfig] = None
    # per-transfer adaptive mode selection (mutually exclusive with the
    # static `compression` mode); see AdaptiveCompressionPolicy
    adaptive: Optional[AdaptiveCompressionConfig] = None

    def __post_init__(self):
        if self.bandwidth <= 0:
            raise ValueError("fabric bandwidth must be > 0")
        if self.latency < 0:
            raise ValueError("fabric latency must be >= 0")
        if self.chunk_bytes < 0:
            raise ValueError("chunk_bytes must be >= 0 (0 = serial)")
        if self.compression is not None and self.adaptive is not None:
            raise ValueError("configure either a static compression mode or "
                             "an adaptive policy, not both")

    def n_chunks(self, nbytes: int) -> int:
        if self.chunk_bytes <= 0 or nbytes <= self.chunk_bytes:
            return 1
        return math.ceil(nbytes / self.chunk_bytes)


@dataclasses.dataclass
class FabricStats:
    n_transfers: int = 0
    n_chunks: int = 0
    transfer_time: float = 0.0       # sum of per-request ready->landed spans
    kv_bytes_moved: int = 0          # bytes on the wire (post-compression)
    kv_raw_bytes: int = 0            # bytes produced by prefill
    busy_time: float = 0.0           # channel occupancy (latency + wire time)
    # per-wire-mode accounting ("raw" / "int8" / "int4" / "lowrank"): how
    # many transfers each mode carried and the wire/raw bytes it covered
    n_transfers_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    wire_bytes_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    raw_bytes_by_mode: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    n_mode_switches: int = 0         # adaptive-policy level changes

    def _bump_mode(self, mode: str, wire: int, raw: int) -> None:
        merge_mode_dict(self.n_transfers_by_mode, {mode: 1})
        merge_mode_dict(self.wire_bytes_by_mode, {mode: wire})
        merge_mode_dict(self.raw_bytes_by_mode, {mode: raw})


class _Transfer:
    """One in-flight KV handoff (all chunks available at ``ready_at``).

    Chunking is over the RAW KV (token ranges — the same 128-token blocks
    the quantization kernel works on); ``wire_chunks`` holds each chunk's
    on-the-wire size after compression.  With compression off the wire
    chunks equal the raw chunk sizes, reproducing the uncompressed arithmetic
    bit-exactly."""

    __slots__ = ("req", "ready_at", "nbytes", "raw_bytes", "wire_chunks",
                 "n_chunks", "chunks_sent", "mode")

    def __init__(self, req, ready_at: float, raw_bytes: int,
                 wire_chunks: List[int], mode: str = "raw"):
        self.req = req
        self.ready_at = ready_at
        self.raw_bytes = raw_bytes
        self.wire_chunks = wire_chunks
        self.nbytes = sum(wire_chunks)
        self.n_chunks = len(wire_chunks)
        self.chunks_sent = 0
        self.mode = mode

    def next_chunk_bytes(self) -> int:
        return self.wire_chunks[self.chunks_sent]


class KVFabric:
    """Deterministic chunk scheduler over one shared serialized channel.

    Transfers are recorded with :meth:`request` as prefill completes and
    scheduled by :meth:`resolve`: chunks are non-preemptive; among in-flight
    transfers the next chunk goes to the one with the fewest chunks already
    sent (ties: earlier ``ready_at``, then lower rid) — a fair round-robin
    that bounds head-of-line blocking by one chunk, so a short handoff slips
    between a long transfer's chunks instead of waiting out the whole thing.

    Units: ``bandwidth`` bytes/s, ``latency`` seconds/chunk, ``chunk_bytes``
    bytes (0 = whole-KV serial handoff); all times are absolute simulated
    seconds.

    Usage::

        fabric = KVFabric(FabricConfig(bandwidth=64e9, latency=5e-6,
                                       chunk_bytes=1 << 20))
        comp = fabric.plan(req, at=done, nbytes=kv_bytes)   # pick wire mode
        fabric.request(req, ready_at=done + compress_time,
                       nbytes=kv_bytes, comp=comp)
        fabric.resolve()    # schedule chunks; stamps req.decode_ready_time
    """

    _PLAN = object()                 # sentinel: request() plans its own mode

    def __init__(self, cfg: FabricConfig):
        self.cfg = cfg
        self.free_at = 0.0
        self.stats = FabricStats()
        self._pending: List[_Transfer] = []
        self.policy = (AdaptiveCompressionPolicy(cfg.adaptive)
                       if cfg.adaptive is not None else None)

    @classmethod
    def from_link(cls, link) -> "KVFabric":
        """A fabric equivalent to one ``TransferLink`` (serial chunks)."""
        return cls(FabricConfig(bandwidth=link.bandwidth,
                                latency=link.latency, chunk_bytes=0))

    def backlog_seconds(self, at: float) -> float:
        """Estimated channel time committed ahead of a transfer becoming
        ready at `at`: the resolved horizon (``free_at``) beyond `at`,
        plus the wire time and per-chunk latencies of every
        recorded-but-unresolved transfer that is *already ready* at `at`.

        Causality: the tier simulates workers eagerly and sequentially, so
        when one worker plans a transfer, other workers' *future* handoffs
        (``ready_at > at``) can already sit in ``_pending``.  A live
        controller could not see those, so they are excluded — the
        estimate only reads traffic that exists at `at`.  A policy (or
        ladder) locked at raw ignores this signal entirely, so the raw
        path is unaffected (``tests/test_adaptive.py`` locks it bit-exact
        against the ``compression=None`` baseline)."""
        pending = sum(tr.nbytes / self.cfg.bandwidth
                      + tr.n_chunks * self.cfg.latency
                      for tr in self._pending if tr.ready_at <= at)
        return max(0.0, self.free_at - at) + pending

    def plan(self, req, at: float, nbytes: int) -> \
            Optional[KVCompressionConfig]:
        """Pick this transfer's wire mode: the static per-fabric mode, or
        the adaptive policy's per-transfer backlog decision (None = raw).
        Prefill workers call this BEFORE charging compression to their
        clock, then pass the result to :meth:`request`."""
        if nbytes <= 0:
            return None
        if self.policy is not None:
            return self.policy.decide(self.backlog_seconds(at))
        return self.cfg.compression

    def _wire_chunks(self, nbytes: int,
                     comp: Optional[KVCompressionConfig],
                     bytes_per_token: Optional[int]) -> List[int]:
        """Per-chunk wire sizes for a raw KV of `nbytes`.  Chunk boundaries
        are raw token ranges (compression quantizes each block
        independently, so a compressed chunk is a *smaller* wire unit —
        the first chunk lands sooner and every slot in the fair interleave
        shortens); an uncompressed transfer ships the raw spans
        unchanged.  Wire sizes are block-granular: a tail chunk smaller
        than a 128-token block pays its full per-channel scales."""
        n = self.cfg.n_chunks(nbytes)
        if n == 1:
            raw_spans = [nbytes]
        else:
            cb = self.cfg.chunk_bytes
            raw_spans = [cb] * (n - 1) + [nbytes - cb * (n - 1)]
        if comp is None:
            return raw_spans
        return [comp.wire_bytes(s, bytes_per_token) for s in raw_spans]

    def request(self, req, ready_at: float, nbytes: int,
                comp=_PLAN) -> None:
        """Record a KV handoff; scheduled at the next :meth:`resolve`.

        `nbytes` is the RAW KV size prefill produced; with wire
        compression in play each raw chunk ships at its compressed size
        and the request is stamped with its mode and decode-side
        decompression cost (charged by the decode engine at admission).
        `comp` is the planned mode for this transfer (see :meth:`plan`);
        left unset, the fabric plans it here.

        An empty KV (``nbytes <= 0``) has nothing to ship: it lands at
        ``ready_at`` with no chunk, no per-chunk latency, and no channel
        occupancy or stats traffic."""
        if comp is self._PLAN:
            comp = self.plan(req, ready_at, nbytes)
        if nbytes <= 0:
            req.kv_raw_bytes = max(0, nbytes)
            req.kv_wire_bytes = 0
            req.decode_ready_time = ready_at
            req.kv_landed_time = ready_at
            req.transfer_time = 0.0
            return
        bpt = kv_bytes_per_token(nbytes, req.prompt_len)
        wire_chunks = self._wire_chunks(nbytes, comp, bpt)
        req.kv_raw_bytes = nbytes
        req.kv_wire_bytes = sum(wire_chunks)
        mode = "raw"
        if comp is not None:
            mode = comp.mode
            req.kv_compression = comp.mode
            req.kv_decompress_cost = comp.decompress_time(nbytes, bpt)
        self._pending.append(_Transfer(req, ready_at, nbytes, wire_chunks,
                                       mode))

    def resolve(self) -> None:
        """Schedule all recorded transfers' chunks and stamp the requests:
        ``decode_ready_time`` at the first chunk's landing,
        ``kv_landed_time`` (and ``transfer_time``) at the last."""
        if self.policy is not None:
            # sync even with nothing pending: ceiling clamps between
            # windows also count as level switches
            self.stats.n_mode_switches = self.policy.n_switches
        if not self._pending:
            return
        pending = sorted(self._pending,
                         key=lambda tr: (tr.ready_at, tr.req.rid))
        self._pending = []
        active: List[_Transfer] = []
        i = 0
        t = self.free_at
        while i < len(pending) or active:
            if not active:
                t = max(t, pending[i].ready_at)
            while i < len(pending) and pending[i].ready_at <= t:
                active.append(pending[i])
                i += 1
            tr = min(active, key=lambda x: (x.chunks_sent, x.ready_at,
                                            x.req.rid))
            size = tr.next_chunk_bytes()
            start = max(t, tr.ready_at)
            done = start + self.cfg.latency + size / self.cfg.bandwidth
            self.stats.busy_time += done - start
            self.stats.n_chunks += 1
            t = done
            tr.chunks_sent += 1
            if tr.chunks_sent == 1:
                tr.req.decode_ready_time = done
            if tr.chunks_sent == tr.n_chunks:
                tr.req.kv_landed_time = done
                tr.req.transfer_time = done - tr.ready_at
                self.stats.n_transfers += 1
                self.stats.transfer_time += tr.req.transfer_time
                self.stats.kv_bytes_moved += tr.nbytes
                self.stats.kv_raw_bytes += tr.raw_bytes
                self.stats._bump_mode(tr.mode, tr.nbytes, tr.raw_bytes)
                active.remove(tr)
        self.free_at = t


@dataclasses.dataclass
class MigrationTicket:
    """Fabric proxy for a decode→decode KV move (live request migration).

    :meth:`KVFabric.request` stamps whatever object it is given with the
    transfer's wire accounting and landing times.  A *migration* must not
    clobber the request's original prefill-handoff fields — those already
    hold the first hop's bytes and the paid (or pending) decompression
    charge — so ``Fleet.migrate`` ships a ticket instead and folds the
    stamped values into the request's cumulative ``mig_*`` counters
    afterwards.  Every wire byte is therefore charged exactly once, on
    the hop that moved it (invariant M2, ``tests/test_migration.py``).

    ``prompt_len`` is the number of KV *tokens* checkpointed (the prompt
    plus every token generated so far), not the request's original prompt
    length: ``kv_bytes_per_token`` must recover the per-token stride from
    ``nbytes / prompt_len`` for block-granular wire sizing, and a
    mid-stream checkpoint carries the whole decoded prefix."""

    rid: int
    prompt_len: int                  # KV tokens on the move (prompt + generated)
    # stamped by KVFabric.request / KVFabric.resolve
    kv_raw_bytes: int = 0
    kv_wire_bytes: int = 0
    kv_compression: Optional[str] = None
    kv_decompress_cost: float = 0.0
    decode_ready_time: Optional[float] = None
    kv_landed_time: Optional[float] = None
    transfer_time: float = 0.0

    @property
    def wire_mode(self) -> str:
        return self.kv_compression or "raw"
