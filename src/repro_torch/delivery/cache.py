"""Tiered chunk cache: in-memory LRU over the log-structured ``ChunkStore``.

Both sides of the wire use it — the registry frontend serves hot chunks
without touching the chunk log (many pullers upgrading the same lineage hit
the same few-hundred-KB working set), and clients keep recently materialized
chunks resident for swarm serving.

Accounting lives in a :class:`~repro_torch.obs.MetricsRegistry` (``cache_*``
series — hits, misses, evictions, resident bytes; see
``docs/OBSERVABILITY.md``), so a registry scrape reports cache behavior
live.  :class:`CacheStats` remains the in-process view: an adapter built
from the same metric children, field-compatible with the original
dataclass.  Eviction bookkeeping (``_resident``, the warm set) stays in
plain attributes under the cache lock — correctness never depends on the
metrics being enabled.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

from repro_torch.core.store import ChunkStore
from repro_torch.obs import MetricsRegistry

DEFAULT_CAPACITY = 32 << 20  # 32 MiB — plenty for the scaled-down corpus


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    puts: int = 0
    resident_bytes: int = 0
    capacity_bytes: int = 0
    warmed: int = 0                # entries pre-loaded via warm()
    warm_hits: int = 0             # hits served by a pre-warmed entry

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class TieredChunkCache:
    """Write-through LRU in front of a ``ChunkStore``.

    * ``get`` — memory first (hit), else backing store (miss + promote);
    * ``put`` — write-through: backing store then memory;
    * eviction — strict LRU by bytes against ``capacity_bytes``.

    Thread-safe: the registry frontend calls it from many puller threads.
    Chunks larger than the capacity bypass the memory tier entirely.

    ``metrics`` is the registry the ``cache_*`` series land in — pass the
    owning server's so one scrape covers both; by default the cache keeps a
    private one (a swarm node's cache must not pollute a registry's).
    """

    def __init__(self, backing: ChunkStore,
                 capacity_bytes: int = DEFAULT_CAPACITY,
                 metrics: Optional[MetricsRegistry] = None):
        self.backing = backing
        self.capacity_bytes = capacity_bytes
        self._lru: "OrderedDict[bytes, bytes]" = OrderedDict()  # guarded-by: _lock
        self._resident = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._warm: set = set()    # guarded-by: _lock
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_hits = m.counter(
            "cache_hits_total", "chunk reads served from the memory tier"
        ).labels()
        self._m_misses = m.counter(
            "cache_misses_total", "chunk reads that fell through to the "
            "backing store").labels()
        self._m_evictions = m.counter(
            "cache_evictions_total", "LRU evictions").labels()
        self._m_puts = m.counter(
            "cache_puts_total", "write-through puts").labels()
        self._m_warmed = m.counter(
            "cache_warmed_total", "entries pre-loaded via warm()").labels()
        self._m_warm_hits = m.counter(
            "cache_warm_hits_total", "hits served by a pre-warmed entry"
        ).labels()
        self._m_resident = m.gauge(
            "cache_resident_bytes", "bytes resident in the memory tier"
        ).labels()
        self._m_capacity = m.gauge(
            "cache_capacity_bytes", "memory tier capacity").labels()
        self._m_capacity.set(capacity_bytes)

    # ---------------------------------------------------------------- reads

    def get(self, fp: bytes) -> bytes:
        with self._lock:
            data = self._lru.get(fp)
            if data is not None:
                self._lru.move_to_end(fp)
                self._m_hits.inc()
                if fp in self._warm:
                    self._m_warm_hits.inc()
                return data
        self._m_misses.inc()
        data = self.backing.get(fp)        # may raise KeyError: truly absent
        with self._lock:
            self._admit(fp, data)
        return data

    def has(self, fp: bytes) -> bool:
        with self._lock:
            if fp in self._lru:
                return True
        return self.backing.has(fp)

    # --------------------------------------------------------------- writes

    def put(self, fp: bytes, data: bytes) -> bool:
        """Write-through store; returns True if the chunk was new."""
        new = self.backing.put(fp, data)
        self._m_puts.inc()
        with self._lock:
            self._warm.discard(fp)         # freshly written, no longer "warm"
            self._admit(fp, data)
        return new

    def warm(self, fp: bytes, data: bytes) -> bool:
        """Pre-load an already-stored chunk into the memory tier (restart
        warm-up from a recovered chunk index).  No write-through, no
        eviction of existing residents: returns False — without admitting —
        once admission would displace anything, so warming fills only the
        cache's free budget."""
        with self._lock:
            if fp in self._lru:
                return True                # already resident
            if (len(data) > self.capacity_bytes
                    or self._resident + len(data) > self.capacity_bytes):
                return False
            self._lru[fp] = data
            self._resident += len(data)
            self._warm.add(fp)
            # meter inside the lock (like get/_admit): reading _resident
            # after release can publish a stale gauge out of order with a
            # concurrent put/eviction
            self._m_warmed.inc()
            self._m_resident.set(self._resident)
        return True

    def _admit(self, fp: bytes, data: bytes) -> None:  # requires-lock: _lock
        if len(data) > self.capacity_bytes:
            return
        prev = self._lru.pop(fp, None)
        if prev is not None:
            self._resident -= len(prev)
        self._lru[fp] = data
        self._resident += len(data)
        evicted = 0
        while self._resident > self.capacity_bytes:
            victim_fp, victim = self._lru.popitem(last=False)
            self._resident -= len(victim)
            self._warm.discard(victim_fp)
            evicted += 1
        if evicted:
            self._m_evictions.inc(evicted)
        self._m_resident.set(self._resident)

    # ----------------------------------------------------------- accounting

    @property
    def resident_bytes(self) -> int:
        """Current memory-tier occupancy (cheap — no stats object built)."""
        with self._lock:
            return self._resident

    @property
    def stats(self) -> CacheStats:
        return CacheStats(hits=self._m_hits.value(),
                          misses=self._m_misses.value(),
                          evictions=self._m_evictions.value(),
                          puts=self._m_puts.value(),
                          resident_bytes=self.resident_bytes,
                          capacity_bytes=self.capacity_bytes,
                          warmed=self._m_warmed.value(),
                          warm_hits=self._m_warm_hits.value())

    def resident_fps(self) -> List[bytes]:
        with self._lock:
            return list(self._lru.keys())
