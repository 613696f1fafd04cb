"""Accelerator-memory adapter cache: HBM budget, LRU eviction, DMA cost model.

Models the paper's core serving bottleneck: with many adapters, the working
set exceeds the device budget and adapters are continuously loaded/offloaded
(host DRAM -> HBM over PCIe on TPU hosts).  Compressed collections pin the
shared bases (U_j, V_j) once and stream only tiny Sigma_i on miss — usually
the whole Sigma set fits, eliminating swaps entirely.

Transfers are modeled non-blocking (vLLM-style): a single copy engine whose
busy-until time overlaps compute; a step stalls only if it needs an adapter
whose transfer hasn't completed.

Two capacity regimes (PR 6, unified paging — spec in ``docs/architecture.md``):

  * ``pool=None`` (legacy): a private byte budget, ``cfg.capacity_bytes``.
    Bit-exact with the pre-paging cache — all regression-locked benchmark
    numbers run this path.
  * ``pool=PagedPool``: adapter weights occupy whole pages of the replica's
    shared HBM pool (S-LoRA's unified paging), competing with KV blocks.
    Capacity checks go through the pool; ``cfg.capacity_bytes`` is ignored.
    The engine registers :meth:`reclaim` as the pool's pressure valve, so a
    KV reservation that does not fit evicts cold adapters — and an adapter
    miss can, symmetrically, use pages freed by finished decodes.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Set

from .resources import PagedPool


@dataclasses.dataclass
class DMAModel:
    bandwidth: float = 16e9          # bytes/s host->device (PCIe gen4-ish)
    latency: float = 50e-6           # per-transfer fixed cost


@dataclasses.dataclass
class CacheConfig:
    capacity_bytes: float            # HBM budget (bytes); unused when pooled
    dma: DMAModel = dataclasses.field(default_factory=DMAModel)


class AdapterCache:
    """LRU over adapter entries + pinned shared entries.

    Entries are keyed by adapter id — or, for adapters updated through the
    online lifecycle, by an ``(adapter_id, epoch)`` tuple
    (:func:`~repro.serving.request.weight_key`), so two weight versions of
    one adapter can be resident while the old epoch's in-flight requests
    drain.  The demand path is :meth:`ensure`; :meth:`prefetch` fills idle
    capacity in the background; :meth:`reclaim` is the pool's pressure
    valve; :meth:`discard` and :meth:`repin_shared` are the lifecycle
    control plane's release/refresh hooks (docs/lifecycle.md)."""

    def __init__(self, cfg: CacheConfig, pool: Optional[PagedPool] = None):
        self.cfg = cfg
        self.pool = pool
        self._resident: "OrderedDict[int, int]" = OrderedDict()  # id -> bytes
        self._inflight_prefetch: Dict[int, float] = {}  # id -> ready_at
        self._pinned_bytes = 0
        self._used = 0
        self.copy_engine_free_at = 0.0
        self.n_swaps = 0
        self.n_prefetches = 0
        self.bytes_swapped = 0

    # -- sizing ------------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        return self._used + self._pinned_bytes

    @property
    def capacity(self) -> float:
        if self.pool is not None:
            return self.pool.total_pages * self.pool.cfg.page_bytes
        return self.cfg.capacity_bytes

    def fits(self, n_more: int) -> bool:
        if self.pool is not None:
            return self.pool.can_alloc("adapter", self.pool.pages_for(n_more))
        return self.used_bytes + n_more <= self.capacity

    def _pages(self, nbytes: int) -> int:
        return 0 if self.pool is None else self.pool.pages_for(nbytes)

    def _evict(self, aid: int) -> None:
        """Drop a resident entry and release its bytes/pages."""
        b = self._resident.pop(aid)
        self._inflight_prefetch.pop(aid, None)
        self._used -= b
        if self.pool is not None:
            self.pool.free("adapter", self._pages(b))

    # -- pinned shared state (compressed bases) ----------------------------
    def pin_shared(self, nbytes: int) -> None:
        if self.pool is not None:
            self.pool.alloc("pinned", self._pages(nbytes))  # raises if full
            self._pinned_bytes += nbytes
            return
        if self._pinned_bytes + self._used + nbytes > self.capacity:
            raise MemoryError(
                f"shared bases ({nbytes/1e6:.1f} MB) exceed adapter budget "
                f"({self.capacity/1e6:.1f} MB)")
        self._pinned_bytes += nbytes

    def repin_shared(self, nbytes: int, now: float) -> float:
        """Hot-swap the pinned shared-base region (basis refresh/rollback).

        Frees the currently pinned pages/bytes, pins a region of `nbytes`
        (evicting cold adapters when the new bases need more room than the
        old ones freed), and queues the transfer on the copy engine exactly
        like a demand load.  Returns the completion time — the replica
        must not decode against the new bases before it."""
        if self.pool is not None:
            self.pool.free("pinned", self._pages(self._pinned_bytes))
            self._pinned_bytes = 0
            need = self._pages(nbytes)
            while not self.pool.can_alloc("pinned", need) and self._resident:
                self._evict(next(iter(self._resident)))
            self.pool.alloc("pinned", need)      # raises if genuinely too big
        else:
            self._pinned_bytes = 0
            while self._used + nbytes > self.capacity and self._resident:
                evicted, b = self._resident.popitem(last=False)
                self._inflight_prefetch.pop(evicted, None)
                self._used -= b
            if self._used + nbytes > self.capacity:
                raise MemoryError(
                    f"refreshed shared bases ({nbytes/1e6:.1f} MB) exceed "
                    f"adapter budget ({self.capacity/1e6:.1f} MB)")
        self._pinned_bytes = nbytes
        start = max(now, self.copy_engine_free_at)
        t_done = start + self.cfg.dma.latency + nbytes / self.cfg.dma.bandwidth
        self.copy_engine_free_at = t_done
        self.n_swaps += 1
        self.bytes_swapped += nbytes
        return t_done

    # -- lookup / load ------------------------------------------------------
    def is_resident(self, aid: int) -> bool:
        return aid in self._resident

    def touch(self, aid: int) -> None:
        if aid in self._resident:
            self._resident.move_to_end(aid)

    def ensure(self, aid: int, nbytes: int, now: float,
               protected: Optional[Set[int]] = None) -> float:
        """Make `aid` resident; returns the time the adapter is usable.

        Eviction is free (drop); transfer is queued on the copy engine and
        overlaps compute — the caller stalls only until the returned time.
        In pooled mode, adapters in `protected` (the engine's running
        batch) are never chosen as eviction victims."""
        if aid in self._resident:
            self._resident.move_to_end(aid)
            # promoted prefetch: usable once its background transfer lands —
            # unless a fresh demand transfer would land sooner (the prefetch
            # sits behind other background loads), in which case the demand
            # path re-issues it on the copy engine: a promotion never waits
            # longer than a cold demand load would have
            ready = self._inflight_prefetch.pop(aid, now)
            if ready > now:
                nbytes = self._resident[aid]
                cold = (max(now, self.copy_engine_free_at)
                        + self.cfg.dma.latency + nbytes / self.cfg.dma.bandwidth)
                if cold < ready:
                    self.copy_engine_free_at = cold
                    self.n_swaps += 1
                    self.bytes_swapped += nbytes
                    ready = cold
            return max(now, ready)
        # evict LRU until it fits
        if self.pool is not None:
            need = self._pages(nbytes)
            safe = protected or ()
            while not self.pool.can_alloc("adapter", need):
                victim = next((a for a in self._resident if a not in safe),
                              None)
                if victim is None:
                    break
                self._evict(victim)
            if not self.pool.try_alloc("adapter", need):
                raise MemoryError(
                    f"adapter ({need} pages) larger than the pool's adapter "
                    f"capacity ({self.pool.adapter_cap} pages, "
                    f"{self.pool.used['pinned']} pinned, "
                    f"{self.pool.used['kv']} held by KV)")
        else:
            while self._used + self._pinned_bytes + nbytes > self.capacity \
                    and self._resident:
                evicted, b = self._resident.popitem(last=False)
                self._inflight_prefetch.pop(evicted, None)
                self._used -= b
            if self._used + self._pinned_bytes + nbytes > self.capacity:
                raise MemoryError("adapter larger than total budget")
        start = max(now, self.copy_engine_free_at)
        t_done = start + self.cfg.dma.latency + nbytes / self.cfg.dma.bandwidth
        self.copy_engine_free_at = t_done
        self._resident[aid] = nbytes
        self._used += nbytes
        self.n_swaps += 1
        self.bytes_swapped += nbytes
        return t_done

    def ensure_many(self, pairs: Iterable[tuple], now: float) -> float:
        t = now
        for aid, nbytes in pairs:
            t = max(t, self.ensure(aid, nbytes, now))
        return t

    def prefetch(self, aid: int, nbytes: int, now: float) -> None:
        """Opportunistic background load at LOW priority.

        Unlike :meth:`ensure`, a prefetch must never get in the way of the
        demand path, so it

        - does NOT advance ``copy_engine_free_at`` — a demand miss issued
          right after a prefetch preempts it rather than queueing behind it;
        - does NOT evict anything — it only fills otherwise-idle capacity;
        - counts as ``n_prefetches``, not ``n_swaps``.

        The loaded adapter becomes usable at its background completion time;
        an :meth:`ensure` that arrives earlier stalls only until then
        (promotion), never longer than a cold demand load would have.
        """
        if self.is_resident(aid):
            return
        if self.pool is not None:
            if not self.pool.try_alloc("adapter", self._pages(nbytes)):
                return                # would need eviction: not worth it
        elif self._used + self._pinned_bytes + nbytes > self.capacity:
            return                    # would need eviction: not worth it
        start = max(now, self.copy_engine_free_at,
                    max(self._inflight_prefetch.values(), default=0.0))
        t_done = start + self.cfg.dma.latency + nbytes / self.cfg.dma.bandwidth
        self._resident[aid] = nbytes
        self._resident.move_to_end(aid, last=False)  # LRU: coldest entry
        self._used += nbytes
        self._inflight_prefetch[aid] = t_done
        self.n_prefetches += 1

    def discard(self, key) -> int:
        """Release a resident entry's bytes/pages outright (retire/update).

        The lifecycle control plane calls this once an adapter (or a stale
        weight epoch of one) has no in-flight requests left — invariant L5:
        a retired adapter holds no pool pages after its drain.  Callers are
        responsible for that drain; the cache does not know the running
        batch.  Returns the bytes freed (0 if the key was not resident)."""
        if key not in self._resident:
            return 0
        freed = self._resident[key]
        self._evict(key)
        return freed

    @property
    def resident_ids(self) -> Set[int]:
        return set(self._resident)

    # -- page-granular pressure (pooled mode only) --------------------------
    def evictable_pages(self, protected: Set[int]) -> int:
        """Pages that :meth:`reclaim` could free without touching adapters
        in `protected` (the running batch + the one being admitted)."""
        if self.pool is None:
            return 0
        return sum(self._pages(b) for aid, b in self._resident.items()
                   if aid not in protected)

    def reclaim(self, n_pages: int, protected: Set[int]) -> int:
        """Evict cold adapters to free up to `n_pages` of pool pages.

        Registered with the pool (:meth:`PagedPool.set_reclaimer
        <repro.serving.resources.PagedPool.set_reclaimer>`) by the engine:
        this is how a KV reservation pushes adapters out.  Eviction order —
        prefetched-but-never-used entries first (speculative bytes are the
        cheapest to drop), then true LRU; `protected` ids are never evicted.
        Returns the pages actually freed (may be < `n_pages`)."""
        if self.pool is None:
            return 0
        freed = 0
        # two passes over a snapshot: OrderedDict order IS coldest-first,
        # and prefetched-but-unused entries sit at the cold end by
        # construction, but a promoted prefetch leaves the map, so walk
        # the inflight set explicitly first.
        victims = [aid for aid in self._resident
                   if aid in self._inflight_prefetch and aid not in protected]
        victims += [aid for aid in self._resident
                    if aid not in self._inflight_prefetch
                    and aid not in protected]
        for aid in victims:
            if freed >= n_pages:
                break
            freed += self._pages(self._resident[aid])
            self._evict(aid)
        return freed
