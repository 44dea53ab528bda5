"""Concurrent registry frontend — serves many simultaneous pullers.

Wraps a ``repro_torch.core.registry.Registry`` behind the wire format:

  * every response is a serialized frame, and every byte that crosses the
    boundary is metered (``egress_bytes`` / ``ingress_bytes`` are *actual*
    frame lengths, not estimates);
  * chunk reads go through the tiered LRU cache (:mod:`repro_torch.delivery.cache`);
  * identical in-flight chunk requests **coalesce**: when N pullers ask for
    the same fingerprint concurrently, one thread performs the store/cache
    read and the rest wait on its result (``coalesced_reads`` counts the
    piggy-backers) — under a thundering herd of upgrades the chunk log sees
    the working set once;
  * chunk responses are **batched**: a WANT list is answered with one or more
    CHUNK_BATCH frames of at most ``max_batch_chunks`` chunks, so a session
    can pipeline decode/ingest against later batches;
  * error paths are protocol-level: unknown lineages/tags surface as
    :class:`repro_torch.core.errors.DeliveryError`, rejected pushes as
    :class:`repro_torch.core.registry.PushRejected` — never a bare ``KeyError``.
    (Unknown fingerprints in a WANT are still silently omitted; the session
    layer decides whether absence is an error.)

Accounting is metrics-first: every handler increments ``registry_*`` series
in the server's :class:`~repro_torch.obs.MetricsRegistry` (request counts and
latency histograms by ``op``, egress/ingress byte counters, an in-flight
gauge, per-replica standby lag — catalog in ``docs/OBSERVABILITY.md``), and
:class:`ServerStats` / :meth:`RegistryServer.snapshot` are *adapters* built
from those same series, field-compatible with the original ad-hoc
dataclass.  The metrics registry is internally locked, which also closes
the old unsynchronized-increment hazard under the threaded socket server.
:meth:`RegistryServer.handle_metrics` serves the whole registry (server +
cache + core) as one METRICS frame for the ``Op.METRICS`` scrape.

When the wrapped registry is directory-backed, an accepted ``handle_push``
is durable before the receipt returns (chunk fsync + journaled commit — see
:mod:`repro_torch.core.registry`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.errors import DeliveryError
from repro_torch.core.registry import PushReceipt, Registry
from repro_torch.core.store import Recipe
from repro_torch.obs import MetricsRegistry

from . import wire
from .cache import DEFAULT_CAPACITY, TieredChunkCache

# every request op the frontend answers (labels of registry_requests_total)
_OPS = ("index", "recipe", "want", "has", "tags", "ship", "repl_ack",
        "push", "metrics", "snapshot")


@dataclasses.dataclass
class ServerStats:
    egress_bytes: int = 0          # serialized frames out (index/recipe/chunks)
    ingress_bytes: int = 0         # serialized frames in (wants/pushes)
    index_requests: int = 0
    recipe_requests: int = 0
    want_requests: int = 0
    has_requests: int = 0          # HAS presence queries answered
    tags_requests: int = 0         # TAGS listing queries answered
    ship_requests: int = 0         # JOURNAL_SHIP requests answered
    records_shipped: int = 0       # journal records streamed to standbys
    repl_acks: int = 0             # REPL_ACK progress reports received
    snapshot_requests: int = 0     # SNAPSHOT_SHIP bootstrap streams served
    chunks_served: int = 0
    chunk_bytes_served: int = 0
    store_reads: int = 0           # chunk reads that reached cache/store
    coalesced_reads: int = 0       # piggy-backed on an identical in-flight read
    pushes: int = 0
    warmed_chunks: int = 0         # cache entries pre-loaded at startup
    warm_hits: int = 0             # cache hits served by a warmed entry

    def snapshot(self) -> "ServerStats":
        return dataclasses.replace(self)


class _InFlight:
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value: Optional[bytes] = None
        self.error: Optional[BaseException] = None


class RegistryServer:
    """Thread-safe wire frontend over an in-process ``Registry``."""

    def __init__(self, registry: Registry,
                 cache_bytes: int = DEFAULT_CAPACITY,
                 max_batch_chunks: int = 64,
                 warm_start: bool = True,
                 warm_scan_limit: int = 50_000,
                 metrics: Optional[MetricsRegistry] = None):
        self.registry = registry
        # one registry per server by default: the core Registry's own
        # metrics, so a scrape covers commit latency + frontend + cache in
        # a single snapshot.  Independent servers over different registries
        # therefore never share counters.
        if metrics is None:
            metrics = getattr(registry, "metrics", None)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.cache = TieredChunkCache(registry.store.chunks, cache_bytes,
                                      metrics=self.metrics)
        self.max_batch_chunks = max_batch_chunks
        self._stats_lock = threading.Lock()       # legacy name; unused fields
        self._registry_lock = threading.RLock()   # Registry itself is not MT-safe
        self._inflight: Dict[bytes, _InFlight] = {}  # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        # replica name -> last acked replication offset (observability: a
        # primary can report standby lag without polling the standbys)
        self.replica_offsets: Dict[str, int] = {}  # guarded-by: _registry_lock
        m = self.metrics
        req = m.counter("registry_requests_total",
                        "requests answered by the registry frontend",
                        ("op",))
        lat = m.histogram("registry_request_seconds",
                          "registry frontend request latency", ("op",))
        self._m_req = {op: req.labels(op) for op in _OPS}
        self._m_lat = {op: lat.labels(op) for op in _OPS}
        self._m_egress = m.counter(
            "registry_egress_bytes_total",
            "serialized frame bytes out (index/recipe/chunks)").labels()
        self._m_ingress = m.counter(
            "registry_ingress_bytes_total",
            "serialized frame bytes in (wants/pushes)").labels()
        self._m_chunks = m.counter(
            "registry_chunks_served_total", "chunk payloads served").labels()
        self._m_chunk_bytes = m.counter(
            "registry_chunk_bytes_served_total",
            "chunk payload bytes served").labels()
        self._m_store_reads = m.counter(
            "registry_store_reads_total",
            "chunk reads that reached cache/store").labels()
        self._m_coalesced = m.counter(
            "registry_coalesced_reads_total",
            "reads piggy-backed on an identical in-flight read").labels()
        self._m_records_shipped = m.counter(
            "registry_records_shipped_total",
            "journal records streamed to standbys").labels()
        self._m_inflight_gauge = m.gauge(
            "registry_inflight_requests",
            "requests currently being answered").labels()
        self._m_lag = m.gauge(
            "replication_standby_lag",
            "primary log head minus the replica's last acked offset "
            "(records)", ("replica",))
        if warm_start and registry.store.chunks.directory is not None:
            self._warm_from_store(warm_scan_limit)

    @contextlib.contextmanager
    def _track(self, op: str):
        """Meter one request: count by op, time it, track in-flight."""
        self._m_inflight_gauge.inc()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._m_lat[op].observe(time.perf_counter() - t0)
            self._m_req[op].inc()
            self._m_inflight_gauge.dec()

    def _warm_from_store(self, scan_limit: int) -> int:
        """Pre-load the memory tier from the recovered chunk index so a
        restarted registry serves its first wave from RAM instead of cold
        (ROADMAP: "registry restart under load").  Most recently appended
        chunks first — the heads of each lineage are what pullers hit —
        until the cache's capacity budget is full.

        A chunk too large for the remaining budget is *skipped*, not a stop
        condition: smaller (older) chunks behind it may still fit, so one
        big recent chunk must not leave the rest of the budget cold.  The
        index sizes are known up-front, so a skip costs no chunk read; the
        walk is bounded by ``scan_limit`` entries so startup stays O(bounded)
        even over a huge store whose budget filled early."""
        store = self.registry.store.chunks
        entries = sorted(store.index_entries(),
                         key=lambda e: e[1], reverse=True)  # offset desc
        warmed = 0
        for fp, _off, size in entries[:max(0, scan_limit)]:
            free = self.cache.capacity_bytes - self.cache.resident_bytes
            if free <= 0:
                break
            if size > free:
                continue                   # skip-and-continue, no read done
            if self.cache.warm(fp, store.get(fp)):
                warmed += 1
        return warmed

    # ------------------------------------------------------------ index/recipe

    # api-boundary
    def get_index(self, lineage: str, tag: str) -> bytes:
        """Serialized INDEX frame for ``lineage:tag``.  An unknown lineage or
        tag raises the protocol-level :class:`repro_torch.core.errors.DeliveryError`
        (never a bare ``KeyError``), so wire clients see a clean error."""
        with self._track("index"):
            with self._registry_lock:
                idx = self.registry.index_for_tag(lineage, tag)
                frame = wire.encode_index(idx)
            self._m_egress.inc(len(frame))
            return frame

    # api-boundary
    def get_latest_index(self, lineage: str) -> Optional[bytes]:
        """Serialized INDEX frame of the lineage head, or None (new lineage)."""
        with self._registry_lock:
            idx = self.registry.latest_index(lineage)
            frame = wire.encode_index(idx) if idx is not None else None
        if frame is not None:
            with self._track("index"):
                self._m_egress.inc(len(frame))
        return frame

    # api-boundary
    def get_recipe(self, lineage: str, tag: str) -> bytes:
        """Serialized RECIPE frame; :class:`DeliveryError` when unknown."""
        with self._track("recipe"):
            with self._registry_lock:
                frame = wire.encode_recipe(
                    self.registry.recipe_for(lineage, tag))
            self._m_egress.inc(len(frame))
            return frame

    # ----------------------------------------------------------------- chunks

    # api-boundary
    def handle_want(self, want_frame: bytes) -> List[bytes]:
        """Answer a WANT frame with batched CHUNK_BATCH frames.

        Unknown fingerprints are silently omitted (the client's decode sees
        which fps arrived); the session layer decides whether absence is an
        error.
        """
        _, frames = self.want_plan(want_frame)
        return list(frames)

    # api-boundary
    def want_plan(self, want_frame: bytes
                  ) -> Tuple[int, Iterable[bytes]]:
        """``(n_frames, frame iterator)`` for one WANT — the streaming form
        of :meth:`handle_want`.  The frame count is known before a single
        chunk is read (it depends only on the want length and the batch
        split), so a socket server can commit a response header and then
        write each CHUNK_BATCH as it is built, overlapping store reads with
        the client's decode of earlier batches."""
        fps = wire.decode_want(want_frame)
        self._m_ingress.inc(len(want_frame))
        n_frames = max(1, -(-len(fps) // self.max_batch_chunks))
        return n_frames, self._want_frames(fps)

    def _want_frames(self, fps: Sequence[bytes]) -> Iterable[bytes]:
        # the request is metered around actual frame production, so the
        # latency histogram covers the store reads a streamed WANT overlaps
        # with the client's decode
        with self._track("want"):
            produced = False
            for start in range(0, len(fps), self.max_batch_chunks):
                batch: Dict[bytes, bytes] = {}
                for fp in fps[start:start + self.max_batch_chunks]:
                    data = self._read_chunk(fp)
                    if data is not None:
                        batch[fp] = data
                frame = wire.encode_chunk_batch(batch)
                produced = True
                self._m_egress.inc(len(frame))
                self._m_chunks.inc(len(batch))
                self._m_chunk_bytes.inc(sum(len(v) for v in batch.values()))
                yield frame
            if not produced:                 # empty WANT still gets an answer
                frame = wire.encode_chunk_batch({})
                self._m_egress.inc(len(frame))
                yield frame

    # api-boundary
    def handle_has(self, has_frame: bytes) -> bytes:
        """Answer a HAS presence query with a MISSING frame — the fps the
        registry does *not* hold.  A pusher then ships exactly these,
        getting cross-lineage server-side dedup for free."""
        with self._track("has"):
            fps = wire.decode_has(has_frame)
            with self._registry_lock:
                missing = self.registry.has_chunks(fps)
            resp = wire.encode_missing(missing)
            self._m_ingress.inc(len(has_frame))
            self._m_egress.inc(len(resp))
            return resp

    # api-boundary
    def handle_tags(self, tags_frame: bytes) -> bytes:
        """Answer a TAGS listing query with a TAG_LIST frame.

        Tag names are control-plane *protocol data*: routing them through a
        frame (instead of a Python attribute reach into the registry) keeps
        them metered and makes the query answerable over a socket."""
        with self._track("tags"):
            lineage = wire.decode_tags_request(tags_frame)
            with self._registry_lock:
                resp = wire.encode_tag_list(self.registry.tags(lineage))
            self._m_ingress.inc(len(tags_frame))
            self._m_egress.inc(len(resp))
            return resp

    # ------------------------------------------------------------ replication

    # api-boundary
    def handle_ship(self, ship_frame: bytes) -> List[bytes]:
        """Answer a SHIP request: one REPL_ACK frame carrying the primary's
        epoch + log head, then up to ``limit`` RECORD frames from the
        requested offset.

        ``limit == 0`` is a pure status probe (freshness query) and is
        answered regardless of the follower's epoch; with ``limit > 0`` an
        epoch mismatch raises :class:`DeliveryError` — offsets from another
        epoch are meaningless and replaying across one would corrupt the
        standby.
        """
        with self._track("ship"):
            replica, epoch, start, limit = wire.decode_ship(ship_frame)
            log = self.registry.replication
            with self._registry_lock:
                if limit and epoch != log.epoch:
                    raise DeliveryError(
                        f"replication epoch mismatch: primary is at epoch "
                        f"{log.epoch}, {replica or 'standby'} asked for "
                        f"epoch {epoch} — the standby must full-resync from "
                        f"an empty directory")
                records = log.records_from(start, limit) if limit else []
                head = log.head()
                cur_epoch = log.epoch
            frames = [wire.encode_repl_ack("", cur_epoch, head)]
            frames += [wire.encode_record_frame(r) for r in records]
            self._m_records_shipped.inc(len(records))
            self._m_ingress.inc(len(ship_frame))
            self._m_egress.inc(sum(len(f) for f in frames))
            return frames

    # api-boundary
    def handle_repl_ack(self, ack_frame: bytes) -> bytes:
        """Record a standby's applied offset; reply with the primary's
        current epoch + head so the follower knows its remaining lag.

        An ack from another epoch (a late report racing a GC rollover)
        carries a meaningless offset: it is dropped — and any offset the
        replica reported under the old epoch is forgotten — so the lag
        table never mixes offsets across epochs."""
        with self._track("repl_ack"):
            replica, epoch, offset = wire.decode_repl_ack(ack_frame)
            log = self.registry.replication
            with self._registry_lock:
                head = log.head()
                if epoch == log.epoch:
                    self.replica_offsets[replica] = offset
                    self._m_lag.labels(replica).set(max(0, head - offset))
                    # every tracked replica has applied everything below the
                    # minimum acked offset: trim the log prefix so in-epoch
                    # memory is bounded by the slowest replica's lag, not by
                    # history (a fresh standby joins via SNAPSHOT_SHIP, so
                    # nothing ever needs the trimmed records again)
                    self.registry.trim_replication(
                        min(self.replica_offsets.values()))
                else:
                    self.replica_offsets.pop(replica, None)
                resp = wire.encode_repl_ack(replica, log.epoch, head)
            self._m_ingress.inc(len(ack_frame))
            self._m_egress.inc(len(resp))
            return resp

    # api-boundary
    def handle_snapshot(self, snapshot_frame: bytes) -> List[bytes]:
        """Answer a SNAPSHOT_SHIP bootstrap request in one buffer — the
        non-streaming form of :meth:`snapshot_plan`."""
        _, frames = self.snapshot_plan(snapshot_frame)
        return list(frames)

    # api-boundary
    def snapshot_plan(self, snapshot_frame: bytes
                      ) -> Tuple[int, Iterable[bytes]]:
        """``(n_frames, frame iterator)`` for one SNAPSHOT_SHIP request —
        the streaming form, mirroring :meth:`want_plan`: one SNAPSHOT
        header frame (the primary's epoch + the resume offset the shipped
        state corresponds to) followed by one RECORD frame per collapsed
        state record.  The frame count is committed before streaming; the
        state records are materialized under the registry lock (they are
        KB-sized, like the index) so the stream itself holds no lock."""
        replica, _epoch, _offset = wire.decode_snapshot(snapshot_frame)
        self._m_ingress.inc(len(snapshot_frame))
        with self._registry_lock:
            epoch, head, raws = self.registry.state_snapshot()
        return 1 + len(raws), self._snapshot_frames(epoch, head, raws)

    def _snapshot_frames(self, epoch: int, head: int,
                         raws: Sequence[bytes]) -> Iterable[bytes]:
        with self._track("snapshot"):
            header = wire.encode_snapshot("", epoch, head)
            self._m_egress.inc(len(header))
            yield header
            for raw in raws:
                frame = wire.encode_record_frame(raw)
                self._m_egress.inc(len(frame))
                self._m_records_shipped.inc()
                yield frame

    def _read_chunk(self, fp: bytes) -> Optional[bytes]:
        """Cache/store read with request coalescing."""
        while True:
            with self._inflight_lock:
                slot = self._inflight.get(fp)
                leader = slot is None
                if leader:
                    slot = _InFlight()
                    self._inflight[fp] = slot
            if leader:
                try:
                    try:
                        slot.value = self.cache.get(fp)
                        self._m_store_reads.inc()
                    except KeyError:
                        slot.value = None    # registry does not have it
                    except BaseException as e:
                        slot.error = e       # followers must retry, not
                        raise                # treat the chunk as absent
                finally:
                    with self._inflight_lock:
                        del self._inflight[fp]
                    slot.event.set()
                return slot.value
            slot.event.wait()
            if slot.error is not None:       # leader failed (I/O error etc.)
                continue                     # retry as a fresh leader
            self._m_coalesced.inc()
            return slot.value

    # ------------------------------------------------------------------- push

    # api-boundary
    def handle_push(self, header_frame: bytes, recipe_frame: bytes,
                    chunk_frames: Sequence[bytes]) -> PushReceipt:
        """Accept a wire push: decode, verify, commit.

        The chunk batches are decoded with fingerprint verification and the
        registry additionally checks the rebuilt CDMT root against the
        client-claimed root in the header (paper Sec. V authentication).
        Ingress is metered up-front: the frames crossed the wire whether or
        not the push is ultimately accepted.
        """
        with self._track("push"):
            nbytes = (len(header_frame) + len(recipe_frame)
                      + sum(len(f) for f in chunk_frames))
            self._m_ingress.inc(nbytes)
            hdr = wire.decode_push_header(header_frame)
            recipe = wire.decode_recipe(recipe_frame)
            if hdr.root is None and recipe.fps:
                # only an empty artifact may omit the root — otherwise
                # omission would bypass the registry's index verification
                raise wire.WireError(
                    f"push {hdr.lineage}:{hdr.tag}: non-empty recipe with "
                    f"no claimed root")
            chunks: Dict[bytes, bytes] = {}
            for f in chunk_frames:
                chunks.update(wire.decode_chunk_batch(f))  # hashes payloads
            with self._registry_lock:
                receipt = self.registry.receive_push(
                    hdr.lineage, hdr.tag, recipe, chunks,
                    parent_version=hdr.parent_version, claimed_root=hdr.root,
                    claimed_params=hdr.params, chunks_verified=True)
            for fp, data in chunks.items():
                self.cache.put(fp, data)     # warm the cache for pullers
            return receipt

    # ---------------------------------------------------------------- metrics

    # api-boundary
    def handle_metrics(self) -> bytes:
        """One METRICS frame: the whole registry (frontend + cache + core)
        serialized as a JSON snapshot — the ``Op.METRICS`` scrape body."""
        with self._track("metrics"):
            frame = wire.encode_metrics(
                self.metrics.snapshot().to_json().encode("utf-8"))
            self._m_egress.inc(len(frame))
            return frame

    # ------------------------------------------------------------- accounting

    @property
    def stats(self) -> ServerStats:
        """Adapter: the legacy stats dataclass, read from the metric
        children (field names unchanged, values always current)."""
        cache_stats = self.cache.stats
        return ServerStats(
            egress_bytes=self._m_egress.value(),
            ingress_bytes=self._m_ingress.value(),
            index_requests=self._m_req["index"].value(),
            recipe_requests=self._m_req["recipe"].value(),
            want_requests=self._m_req["want"].value(),
            has_requests=self._m_req["has"].value(),
            tags_requests=self._m_req["tags"].value(),
            ship_requests=self._m_req["ship"].value(),
            records_shipped=self._m_records_shipped.value(),
            repl_acks=self._m_req["repl_ack"].value(),
            snapshot_requests=self._m_req["snapshot"].value(),
            chunks_served=self._m_chunks.value(),
            chunk_bytes_served=self._m_chunk_bytes.value(),
            store_reads=self._m_store_reads.value(),
            coalesced_reads=self._m_coalesced.value(),
            pushes=self._m_req["push"].value(),
            warmed_chunks=cache_stats.warmed,
            warm_hits=cache_stats.warm_hits)

    def snapshot(self) -> ServerStats:
        return self.stats

    def cache_hit_rate(self) -> float:
        return self.cache.stats.hit_rate
