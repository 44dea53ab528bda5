"""Pull plans and unified transfer accounting for the delivery API.

The redesigned client splits every pull into an inspectable pair:

  * :meth:`repro_torch.delivery.client.ImageClient.plan_pull` runs Algorithm 2
    against the transport's index and returns a :class:`PullPlan` — which
    fingerprints must move, what they should cost on the wire, and how many
    node comparisons the diff took — **without moving a single chunk**;
  * :meth:`repro_torch.delivery.client.ImageClient.execute` streams the plan in
    batches and returns a :class:`TransferReport`.

:class:`TransferReport` is the one stats object for every transport (it
unifies the former ``WireStats`` / ``DeliveryStats`` / ``SwarmStats``
split): top-level counters carry the totals, and ``sources`` breaks chunk
traffic down per origin (``registry``, ``peer:<name>``, …) so multi-source
pulls — swarm offload, failover — are accounted exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.cdmt import CDMT
from repro_torch.core.pushpull import WireStats
from repro_torch.core.store import Recipe


@dataclasses.dataclass
class SourceLeg:
    """Chunk traffic attributed to one source during a transfer.

    ``source`` is ``"registry"`` for the authoritative backend (in-process
    or wire) and ``"peer:<name>"`` for swarm providers.  ``failures`` counts
    requests this source failed to answer (dead peer, I/O error) — each one
    is a failover the client absorbed.
    """
    source: str
    chunks: int = 0
    chunk_bytes: int = 0        # CHUNK_BATCH frame bytes from this source
    want_bytes: int = 0         # WANT frame bytes sent to this source
    rounds: int = 0             # request round-trips to this source
    failures: int = 0

    def absorb(self, other: "SourceLeg") -> None:
        assert other.source == self.source
        self.chunks += other.chunks
        self.chunk_bytes += other.chunk_bytes
        self.want_bytes += other.want_bytes
        self.rounds += other.rounds
        self.failures += other.failures


def _is_peer(source: str) -> bool:
    return source.startswith("peer:")


@dataclasses.dataclass
class TransferReport(WireStats):
    """Unified per-transfer accounting — one shape for every transport.

    Extends the byte categories of the core :class:`WireStats` with the
    session-protocol traffic (WANT frames, round-trips) and a per-source
    breakdown.  The legacy names still import — ``DeliveryStats`` and
    ``SwarmStats`` are deprecation aliases of this class — and every field
    the old three classes exposed is available here (the swarm-specific
    counters are now derived from ``sources``).
    """
    transport: str = ""
    want_bytes: int = 0            # WANT / has-chunks control frames
    rounds: int = 0                # registry round-trips
    failovers: int = 0             # source failures absorbed mid-transfer
    sources: Dict[str, SourceLeg] = dataclasses.field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> int:
        return (self.index_bytes + self.recipe_bytes + self.want_bytes
                + self.chunk_bytes)

    # ------------------------------------------------------------- per-source

    def leg(self, source: str) -> SourceLeg:
        got = self.sources.get(source)
        if got is None:
            got = self.sources[source] = SourceLeg(source=source)
        return got

    def merge_leg(self, leg: SourceLeg) -> None:
        """Fold one source leg into the totals and the per-source table."""
        self.leg(leg.source).absorb(leg)
        self.chunk_bytes += leg.chunk_bytes
        self.want_bytes += leg.want_bytes
        self.chunks_moved += leg.chunks
        self.failovers += leg.failures
        if _is_peer(leg.source):
            return
        self.rounds += leg.rounds

    # ------------------------------------- legacy SwarmStats-derived counters

    @property
    def peer_chunk_bytes(self) -> int:
        return sum(l.chunk_bytes for l in self.sources.values()
                   if _is_peer(l.source))

    @property
    def registry_chunk_bytes(self) -> int:
        return sum(l.chunk_bytes for l in self.sources.values()
                   if not _is_peer(l.source))

    @property
    def chunks_from_peers(self) -> int:
        return sum(l.chunks for l in self.sources.values()
                   if _is_peer(l.source))

    @property
    def peer_rounds(self) -> int:
        return sum(l.rounds for l in self.sources.values()
                   if _is_peer(l.source))

    @property
    def peer_offload_fraction(self) -> float:
        total = self.peer_chunk_bytes + self.registry_chunk_bytes
        return self.peer_chunk_bytes / total if total else 0.0


@dataclasses.dataclass
class PullPlan:
    """Everything a pull will do, decided before any chunk moves.

    Produced by ``ImageClient.plan_pull``: the transport supplied the index
    and recipe (both KB-sized), Algorithm 2 diffed the index against the
    client's local tree, and the local store was consulted for cross-lineage
    dedup.  ``missing`` is the exact fetch list ``execute`` will stream;
    the ``expected_*`` fields are exact for single-source transports and a
    lower bound for swarm (empty peer replies add a few frame-header bytes).
    """
    lineage: str
    tag: str
    transport: str
    index: CDMT = dataclasses.field(repr=False)
    recipe: Recipe = dataclasses.field(repr=False)
    missing: List[bytes] = dataclasses.field(repr=False)
    chunks_total: int = 0
    already_local: int = 0         # diffed-as-missing but found in the store
    raw_bytes: int = 0             # full artifact size (naive transfer cost)
    expected_chunk_bytes: int = 0  # payload bytes expected to move
    expected_wire_bytes: int = 0   # index + recipe + framed chunk batches
    comparisons: int = 0           # Algorithm-2 node comparisons
    index_bytes: int = 0
    recipe_bytes: int = 0

    @property
    def chunks_to_fetch(self) -> int:
        return len(self.missing)

    @property
    def expected_savings_vs_raw(self) -> float:
        if not self.raw_bytes:
            return 0.0
        return 1.0 - self.expected_wire_bytes / self.raw_bytes
