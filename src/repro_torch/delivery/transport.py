"""Pluggable transports — one client API over every delivery backend.

A :class:`Transport` answers the five questions the paper's client protocol
needs (and nothing else): *give me the index*, *give me the recipe*, *fetch
these chunks*, *take this push*, *which of these do you already have*.
:class:`repro_torch.delivery.client.ImageClient` runs identical Algorithm-2
logic against any implementation:

  * :class:`LocalTransport` — wraps a :class:`~repro_torch.core.registry.Registry`
    in-process.  No frames are materialized; byte accounting uses the exact
    arithmetic sizing helpers in :mod:`repro_torch.delivery.wire`, so reported
    bytes equal what the wire path would serialize.
  * :class:`WireTransport` — wraps a
    :class:`~repro_torch.delivery.server.RegistryServer`.  Every exchange is a
    real encoded frame; payloads are fingerprint-verified on decode.

The peer-first (``SwarmTransport``) and replicated (``ReplicatedTransport``)
transports of the JAX package are not part of this package yet.

Control-plane methods (``has_chunks``, ``tags``) are KB-sized; data-plane
chunk traffic flows only through ``fetch_chunks``/``push``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

from repro_torch.core.cdmt import CDMT, CDMTParams
from repro_torch.core.registry import PushReceipt, Registry
from repro_torch.core.store import Recipe
from repro_torch.obs import MetricsRegistry, MetricsSnapshot

from . import wire
from .plan import SourceLeg
from .server import RegistryServer

REGISTRY_SOURCE = "registry"

# client-side transport operations (labels of transport_op_seconds)
_METER_OPS = ("index", "recipe", "fetch", "push", "has", "tags")
# byte categories — chosen to mirror TransferReport exactly: after one pull
# on a fresh transport, index == report.index_bytes, recipe ==
# report.recipe_bytes, want == report.want_bytes, chunk ==
# report.chunk_bytes (the conformance test in tests/test_transport.py
# asserts this per transport)
_METER_CATEGORIES = ("index", "recipe", "want", "chunk")


class TransportMeter:
    """Pre-bound instrument set one transport instance records into.

    Byte accounting is taken from the same values the client folds into its
    :class:`~repro_torch.delivery.plan.TransferReport` (returned frame lengths,
    source-leg want/chunk bytes), so per-transport metric totals and report
    totals agree to the byte.  Only successful operations are metered —
    a failed call contributed no report bytes either.
    """

    def __init__(self, metrics: MetricsRegistry, transport_name: str):
        lat = metrics.histogram(
            "transport_op_seconds",
            "client-side transport operation latency",
            ("transport", "op"))
        byt = metrics.counter(
            "transport_bytes_total",
            "wire bytes by TransferReport category",
            ("transport", "category"))
        self._lat = {op: lat.labels(transport_name, op)
                     for op in _METER_OPS}
        self._bytes = {cat: byt.labels(transport_name, cat)
                       for cat in _METER_CATEGORIES}

    def rec(self, op: str, t0: float, **categories: int) -> None:
        """Record one completed op: latency since ``t0`` plus any byte
        deltas (``index=``/``recipe=``/``want=``/``chunk=``)."""
        self._lat[op].observe(time.perf_counter() - t0)
        for cat, n in categories.items():
            if n:
                self._bytes[cat].inc(n)

    def rec_legs(self, t0: float, legs: Sequence[SourceLeg]) -> None:
        """Record one completed ``fetch_chunks`` from its source legs."""
        self.rec("fetch", t0,
                 want=sum(l.want_bytes for l in legs),
                 chunk=sum(l.chunk_bytes for l in legs))


@dataclasses.dataclass
class FetchResult:
    """Chunks obtained for one batch, with per-source accounting."""
    chunks: Dict[bytes, bytes]
    legs: List[SourceLeg]


@dataclasses.dataclass
class PushOutcome:
    """What one push cost on the wire, per byte category."""
    receipt: PushReceipt
    header_bytes: int              # PUSH_HDR (wire) / index upload (local)
    recipe_bytes: int
    chunk_bytes: int
    rounds: int


@runtime_checkable
class Transport(Protocol):
    """The client-facing delivery protocol (duck-typed)."""

    name: str
    verifies_payloads: bool        # True: fetched payloads already hashed

    def get_index(self, lineage: str, tag: str) -> Tuple[CDMT, int]:
        """``(index, wire_bytes)``; :class:`DeliveryError` when unknown."""
        ...

    def get_latest_index(self, lineage: str
                         ) -> Tuple[Optional[CDMT], int]:
        """Lineage head index (None for a new lineage) + wire bytes."""
        ...

    def get_recipe(self, lineage: str, tag: str) -> Tuple[Recipe, int]:
        ...

    def fetch_chunks(self, lineage: str, tag: str,
                     fps: Sequence[bytes]) -> FetchResult:
        """Fetch one batch of chunk payloads.  Absent fps are omitted from
        the result (the caller decides whether absence is an error)."""
        ...

    def push(self, lineage: str, tag: str, recipe: Recipe,
             chunks: Dict[bytes, bytes], *,
             parent_version: Optional[int] = None,
             claimed_root: Optional[bytes] = None,
             claimed_params: Optional[CDMTParams] = None) -> PushOutcome:
        ...

    def has_chunks(self, fps: Sequence[bytes]
                   ) -> Tuple[List[bytes], int]:
        """``(missing_on_remote, control_wire_bytes)`` — lets a push ship
        only chunks the backend truly lacks (cross-lineage dedup)."""
        ...

    def tags(self, lineage: str) -> List[str]:
        ...

    def notify_pulled(self, lineage: str, tag: str) -> None:
        """Hook invoked after a successful pull fully ingests."""
        ...


# ----------------------------------------------------------------- in-process

class LocalTransport:
    """In-process transport over a :class:`Registry`.

    Byte accounting matches the wire path arithmetically (same sizing
    formulas, no frames built), with two deliberate differences inherited
    from the original in-process protocol: WANT frames cost nothing (the
    fetch is a function call) and a push uploads the full index instead of a
    PUSH_HDR (the in-process registry receives the tree object, it does not
    rebuild one from the recipe).
    """

    name = "local"
    verifies_payloads = False      # payloads come straight off local storage

    def __init__(self, registry: Registry,
                 metrics: Optional[MetricsRegistry] = None):
        self.registry = registry
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._meter = TransportMeter(self.metrics, self.name)

    # api-boundary
    def get_index(self, lineage: str, tag: str) -> Tuple[CDMT, int]:
        t0 = time.perf_counter()
        idx = self.registry.index_for_tag(lineage, tag)
        nbytes = wire.index_wire_bytes(idx)
        self._meter.rec("index", t0, index=nbytes)
        return idx, nbytes

    # api-boundary
    def get_latest_index(self, lineage: str) -> Tuple[Optional[CDMT], int]:
        t0 = time.perf_counter()
        idx = self.registry.latest_index(lineage)
        nbytes = wire.index_wire_bytes(idx) if idx is not None else 0
        self._meter.rec("index", t0, index=nbytes)
        return idx, nbytes

    # api-boundary
    def get_recipe(self, lineage: str, tag: str) -> Tuple[Recipe, int]:
        t0 = time.perf_counter()
        recipe = self.registry.recipe_for(lineage, tag)
        nbytes = wire.recipe_wire_bytes(recipe)
        self._meter.rec("recipe", t0, recipe=nbytes)
        return recipe, nbytes

    # api-boundary
    def fetch_chunks(self, lineage: str, tag: str,
                     fps: Sequence[bytes]) -> FetchResult:
        t0 = time.perf_counter()
        chunks = self.registry.serve_chunks(fps)
        leg = SourceLeg(source=REGISTRY_SOURCE, chunks=len(chunks),
                        chunk_bytes=(wire.chunk_batch_wire_bytes(chunks)
                                     if chunks else 0),
                        rounds=1)
        self._meter.rec_legs(t0, [leg])
        return FetchResult(chunks=chunks, legs=[leg])

    # api-boundary
    def push(self, lineage: str, tag: str, recipe: Recipe,
             chunks: Dict[bytes, bytes], *,
             parent_version: Optional[int] = None,
             claimed_root: Optional[bytes] = None,
             claimed_params: Optional[CDMTParams] = None) -> PushOutcome:
        t0 = time.perf_counter()
        receipt = self.registry.receive_push(
            lineage, tag, recipe, chunks, parent_version=parent_version,
            claimed_root=claimed_root, claimed_params=claimed_params)
        idx = self.registry.index_for_tag(lineage, tag)
        outcome = PushOutcome(
            receipt=receipt,
            header_bytes=wire.index_wire_bytes(idx),   # index upload
            recipe_bytes=wire.recipe_wire_bytes(recipe),
            chunk_bytes=wire.chunk_batch_wire_bytes(chunks) if chunks else 0,
            rounds=1 if chunks else 0)
        self._meter.rec("push", t0, index=outcome.header_bytes,
                        recipe=outcome.recipe_bytes,
                        chunk=outcome.chunk_bytes)
        return outcome

    # api-boundary
    def has_chunks(self, fps: Sequence[bytes]) -> Tuple[List[bytes], int]:
        t0 = time.perf_counter()
        missing = self.registry.has_chunks(fps)
        self._meter.rec("has", t0)
        return missing, 0

    # api-boundary
    def tags(self, lineage: str) -> List[str]:
        t0 = time.perf_counter()
        out = self.registry.tags(lineage)
        self._meter.rec("tags", t0)
        return out

    # api-boundary
    def notify_pulled(self, lineage: str, tag: str) -> None:
        pass

    def replication_status(self) -> Tuple[int, int]:
        """The registry's replication ``(epoch, head)`` — liveness and
        freshness probe used by :class:`ReplicatedTransport`."""
        log = self.registry.replication
        return log.epoch, log.head()

    def fetch_snapshot(self, replica: str = "standby"
                       ) -> Tuple[int, int, List[Tuple[int, bytes, bytes]]]:
        """In-process SNAPSHOT_SHIP: the registry's collapsed state as
        ``(epoch, head, (rtype, payload, raw) records)`` — what a fresh
        standby bootstraps from instead of replaying history from offset
        0 (which a trimmed replication log no longer holds)."""
        epoch, head, raws = self.registry.state_snapshot()
        records = []
        for raw in raws:
            rtype, payload, _ = wire.decode_record(raw, 0)
            records.append((rtype, payload, raw))
        return epoch, head, records


# ----------------------------------------------------------------------- wire

class WireTransport:
    """Frame-level transport over a :class:`RegistryServer`.

    Every byte reported crossed the server boundary as a serialized frame;
    chunk payloads are blake2b-verified during ``decode_chunk_batch``.
    """

    name = "wire"
    verifies_payloads = True

    def __init__(self, server: RegistryServer, batch_chunks: int = 64,
                 metrics: Optional[MetricsRegistry] = None):
        self.server = server
        self.batch_chunks = max(1, batch_chunks)   # push CHUNK_BATCH framing
        # the server splits each WANT into frames of at most this many
        # chunks — pull plans use it to quote response framing exactly
        self.response_batch_chunks = server.max_batch_chunks
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._meter = TransportMeter(self.metrics, self.name)

    # api-boundary
    def get_index(self, lineage: str, tag: str) -> Tuple[CDMT, int]:
        t0 = time.perf_counter()
        frame = self.server.get_index(lineage, tag)
        self._meter.rec("index", t0, index=len(frame))
        return wire.decode_index(frame), len(frame)

    # api-boundary
    def get_latest_index(self, lineage: str) -> Tuple[Optional[CDMT], int]:
        t0 = time.perf_counter()
        frame = self.server.get_latest_index(lineage)
        self._meter.rec("index", t0,
                        index=len(frame) if frame is not None else 0)
        if frame is None:
            return None, 0
        return wire.decode_index(frame), len(frame)

    # api-boundary
    def get_recipe(self, lineage: str, tag: str) -> Tuple[Recipe, int]:
        t0 = time.perf_counter()
        frame = self.server.get_recipe(lineage, tag)
        self._meter.rec("recipe", t0, recipe=len(frame))
        return wire.decode_recipe(frame), len(frame)

    # api-boundary
    def fetch_chunks(self, lineage: str, tag: str,
                     fps: Sequence[bytes]) -> FetchResult:
        t0 = time.perf_counter()
        want = wire.encode_want(fps)
        frames = self.server.handle_want(want)
        chunks: Dict[bytes, bytes] = {}
        nbytes = 0
        for f in frames:
            nbytes += len(f)
            chunks.update(wire.decode_chunk_batch(f))
        leg = SourceLeg(source=REGISTRY_SOURCE, chunks=len(chunks),
                        chunk_bytes=nbytes, want_bytes=len(want), rounds=1)
        self._meter.rec_legs(t0, [leg])
        return FetchResult(chunks=chunks, legs=[leg])

    # api-boundary
    def push(self, lineage: str, tag: str, recipe: Recipe,
             chunks: Dict[bytes, bytes], *,
             parent_version: Optional[int] = None,
             claimed_root: Optional[bytes] = None,
             claimed_params: Optional[CDMTParams] = None) -> PushOutcome:
        t0 = time.perf_counter()
        hdr = wire.encode_push_header(wire.PushHeader(
            lineage=lineage, tag=tag, root=claimed_root,
            parent_version=parent_version, params=claimed_params))
        recipe_frame = wire.encode_recipe(recipe)
        chunk_frames: List[bytes] = []
        fps = list(chunks)
        for start in range(0, len(fps), self.batch_chunks):
            part = {fp: chunks[fp]
                    for fp in fps[start:start + self.batch_chunks]}
            chunk_frames.append(wire.encode_chunk_batch(part))
        receipt = self.server.handle_push(hdr, recipe_frame, chunk_frames)
        # the registry rebuilds the index from the recipe, so no INDEX frame
        # is uploaded — the claimed root rides in the header
        outcome = PushOutcome(receipt=receipt, header_bytes=len(hdr),
                              recipe_bytes=len(recipe_frame),
                              chunk_bytes=sum(len(f) for f in chunk_frames),
                              rounds=len(chunk_frames))
        self._meter.rec("push", t0, index=outcome.header_bytes,
                        recipe=outcome.recipe_bytes,
                        chunk=outcome.chunk_bytes)
        return outcome

    # api-boundary
    def has_chunks(self, fps: Sequence[bytes]) -> Tuple[List[bytes], int]:
        t0 = time.perf_counter()
        req = wire.encode_has(fps)
        resp = self.server.handle_has(req)
        self._meter.rec("has", t0, want=len(req) + len(resp))
        return wire.decode_missing(resp), len(req) + len(resp)

    # api-boundary
    def tags(self, lineage: str) -> List[str]:
        # control-plane query, but still protocol data: a TAGS frame in, a
        # TAG_LIST frame back, both metered by the server — the same frames
        # the socket path sends, so no byte silently skips the meters
        t0 = time.perf_counter()
        resp = self.server.handle_tags(wire.encode_tags_request(lineage))
        self._meter.rec("tags", t0)
        return wire.decode_tag_list(resp)

    def scrape_metrics(self) -> MetricsSnapshot:
        """The server's live metrics as a decoded
        :class:`repro_torch.obs.MetricsSnapshot` (in-process analogue of the
        socket path's ``Op.METRICS`` scrape)."""
        frame = self.server.handle_metrics()
        return MetricsSnapshot.from_json(
            wire.decode_metrics(frame).decode("utf-8"))

    # api-boundary
    def notify_pulled(self, lineage: str, tag: str) -> None:
        pass

    # ---------------------------------------------------------- replication

    def ship_journal(self, replica: str, epoch: int, start: int,
                     limit: int = 512
                     ) -> Tuple[int, int, List[Tuple[int, bytes, bytes]]]:
        """In-process JOURNAL_SHIP (same frames the socket path ships):
        ``(epoch, head, checksum-verified (rtype, payload, raw) records)``."""
        frames = self.server.handle_ship(
            wire.encode_ship(replica, epoch, start, limit))
        _, srv_epoch, head = wire.decode_repl_ack(frames[0])
        return srv_epoch, head, [wire.decode_record_frame(f)
                                 for f in frames[1:]]

    def ack_journal(self, replica: str, epoch: int,
                    offset: int) -> Tuple[int, int]:
        resp = self.server.handle_repl_ack(
            wire.encode_repl_ack(replica, epoch, offset))
        _, srv_epoch, head = wire.decode_repl_ack(resp)
        return srv_epoch, head

    def replication_status(self) -> Tuple[int, int]:
        epoch, head, _ = self.ship_journal("", 0, 0, 0)
        return epoch, head

    def fetch_snapshot(self, replica: str = "standby"
                       ) -> Tuple[int, int, List[Tuple[int, bytes, bytes]]]:
        """In-process SNAPSHOT_SHIP (same frames the socket path streams):
        one SNAPSHOT header carrying the primary's ``(epoch, head)``
        resume position, then checksum-verified state records."""
        frames = self.server.handle_snapshot(
            wire.encode_snapshot(replica, 0, 0))
        _, epoch, head = wire.decode_snapshot(frames[0])
        return epoch, head, [wire.decode_record_frame(f)
                             for f in frames[1:]]
