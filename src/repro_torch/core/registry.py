"""Container/artifact registry (paper Sec. V).

Hosts all versions of each artifact lineage plus **one CDMT index per
lineage** (maintained with node-copying as new versions are pushed).  The
registry never re-chunks on push — the client ships chunk fps + new chunks +
the new CDMT leaf sequence; the registry *incrementally* extends the
versioned index against the parent version's tree (cheap: only subtrees
whose leaf spans changed are re-hashed) and verifies the root matches the
client's claim, which doubles as the authentication mechanism.

Durability (``directory`` mode): registry state — version records, recipes,
tags, metadata — is persisted in an append-only, checksummed journal
(``registry.journal``, see :mod:`repro_torch.core.journal`) with fsync-on-commit;
chunk payloads live in the :class:`~repro_torch.core.store.ChunkStore` log and are
fsynced *before* the commit record is appended, so an acknowledged push
never references non-durable chunks.  ``Registry.__init__`` recovers by
replaying the snapshot (``registry.snap``, written by :meth:`compact`) and
then the journal, truncating any torn tail; replay rebuilds each lineage's
CDMT incrementally from the recorded recipes, so recovery hashing is
proportional to total *change* size, not versions × image size.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, \
    Tuple

from repro_torch.obs import MetricsRegistry

from . import faults, hashing
from .cdmt import CDMT, CDMTParams, DEFAULT_PARAMS
from .errors import DeliveryError, JournalError
from .journal import Journal, ReplicationLog, scan_records, \
    write_snapshot_raw
from .store import DedupStore, Recipe
from .versioning import VersionedCDMT, VersionRecord

# journal record types
_J_COMMIT = 1
_J_META = 2
_J_EPOCH = 3    # replication epoch marker: journal/snapshot only, never
                # shipped — it describes the log, it is not part of it
_J_COMPACT = 4  # compaction boundary: first record of a freshly reset
                # journal, carrying the replication (epoch, head) its
                # snapshot covers — the durable signal that distinguishes
                # post-compact records from a stale journal whose
                # truncation was interrupted (including across GC epochs)
_J_TRIM = 5     # replication-base marker: snapshot-only, never shipped —
                # replay *resets* the log (empty, based at the recorded
                # offset), so a trimmed primary (or a snapshot-bootstrapped
                # standby) recovers with its absolute offsets intact
_J_TAIL = 6     # log-only record wrapper: snapshot-only, never shipped —
                # payload is a raw checksummed record that belongs to the
                # replication log *tail* (offsets base..head) but whose
                # state is already covered by the snapshot's collapsed
                # state records; replay feeds it to the log verbatim
                # without re-applying it


def _wire():
    from repro_torch.delivery import wire   # lazy: see core.journal layering note
    return wire


class PushRejected(ValueError):
    """Push failed server-side verification (root mismatch / bad chunk /
    tag conflict)."""


@dataclasses.dataclass
class PushReceipt:
    lineage: str
    tag: str
    version: int
    chunks_received: int
    bytes_received: int
    index_bytes: int
    root: bytes
    nodes_created: int = 0      # CDMT nodes this push materialized
    nodes_hashed: int = 0       # node ids fingerprinted (O(k·depth) incr.)
    hash_calls: int = 0         # nodes_hashed + rolling-window cut tests
    deduplicated: bool = False  # tag+root already present; no new version


@dataclasses.dataclass
class SweepReport:
    """What :meth:`Registry.sweep` found (and, with ``drop``, reclaimed)."""
    live_chunks: int
    live_bytes: int
    unreferenced_chunks: int
    unreferenced_bytes: int
    retained_versions: int
    dropped_versions: int = 0
    dropped_chunks: int = 0
    reclaimed_bytes: int = 0


class Registry:
    """A registry: global chunk store + per-lineage versioned CDMT.

    With ``directory`` set the registry is durable: every committed push and
    metadata write is journaled (fsynced by default) and ``__init__``
    recovers the full index from disk.  Lineages are only durable through
    this API (``receive_push`` / ``put_metadata``) — commits made directly
    on a :class:`VersionedCDMT` bypass the journal.
    """

    def __init__(self, directory: Optional[str] = None,
                 cdmt_params: CDMTParams = DEFAULT_PARAMS,
                 sync: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.store = DedupStore(directory)
        self.cdmt_params = cdmt_params
        self.lineages: Dict[str, VersionedCDMT] = {}  # guarded-by: external(Registry is not MT-safe; RegistryServer._registry_lock serializes served access)
        self.recipes: Dict[Tuple[str, str], Recipe] = {}   # guarded-by: external(RegistryServer._registry_lock)
        self.metadata: Dict[Tuple[str, str], bytes] = {}   # guarded-by: external(RegistryServer._registry_lock)
        self._journal: Optional[Journal] = None
        self._snap_path: Optional[str] = None
        # standby role: a JournalFollower marks its registry read-only so a
        # misdirected client push fails loudly instead of forking the
        # lineage history away from the primary; promote() clears it
        self.read_only = False  # guarded-by: external(RegistryServer._registry_lock)
        # per-instance metrics: the delivery frontends adopt this registry's
        # so one scrape covers commit latency + frontend + cache together
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_commit = self.metrics.histogram(
            "registry_commit_seconds",
            "receive_push latency: verify + store + journal + index"
        ).labels()
        self._m_apply = self.metrics.histogram(
            "replication_apply_seconds",
            "standby apply latency for one shipped record").labels()
        self._m_repl_head = self.metrics.gauge(
            "replication_log_head", "replication log head (records this "
            "epoch)").labels()
        self._m_repl_epoch = self.metrics.gauge(
            "replication_epoch", "current replication epoch").labels()
        self._m_repl_base = self.metrics.gauge(
            "replication_log_base", "replication log base (lowest offset "
            "still held after trimming)").labels()
        self._m_repl_records = self.metrics.gauge(
            "replication_log_records", "records currently held in the "
            "in-memory replication log (head - base)").labels()
        self._m_repl_trimmed = self.metrics.counter(
            "replication_log_trimmed_total", "replication log records "
            "dropped by trimming below the minimum acked offset").labels()
        self._m_bootstrap_bytes = self.metrics.counter(
            "bootstrap_snapshot_bytes_total", "encoded state-record bytes "
            "adopted via snapshot bootstrap").labels()
        self._m_bootstrap = self.metrics.histogram(
            "bootstrap_apply_seconds", "snapshot-bootstrap latency: "
            "verify + persist + install").labels()
        # replication tap: every committed record, in commit order — what a
        # standby follows over JOURNAL_SHIP (socket layer not ported yet).  Fed
        # during recovery too, so resume offsets survive a primary restart.
        self.replication = ReplicationLog()
        if directory is not None:
            self._snap_path = os.path.join(directory, "registry.snap")
            if os.path.exists(self._snap_path):
                # snapshots are written atomically (temp + fsync + rename),
                # so unlike the append-only journal they have no legitimate
                # torn tail: any undecodable record is real corruption and
                # must fail loudly, not silently drop the versions after it
                records, good_end, size = scan_records(self._snap_path)
                if good_end != size:
                    raise JournalError(
                        f"snapshot {self._snap_path} is corrupt at byte "
                        f"{good_end} of {size}")
                for rtype, payload in records:
                    self._recover_record(rtype, payload)
            had_snapshot = os.path.exists(self._snap_path)
            self._journal = Journal(
                os.path.join(directory, "registry.journal"), sync=sync,
                metrics=self.metrics)
            self._recover_journal(self._journal.replay(),
                                  has_snapshot=had_snapshot)

    # -- recovery -------------------------------------------------------------

    def _recover_record(self, rtype: int, payload: bytes) -> None:
        """Replay one persisted record at startup: epoch markers restore
        the replication epoch (compaction boundaries are structural and
        skipped here); everything else is applied AND fed to the
        replication log in persisted order, so resume offsets survive a
        restart."""
        if rtype == _J_EPOCH:
            epoch, _ = _wire().decode_uvarint(payload, 0)
            self.replication.set_epoch(epoch)
            return
        if rtype == _J_TRIM:
            base, _ = _wire().decode_uvarint(payload, 0)
            # reset, not trim: any records fed so far were the snapshot's
            # collapsed *state* section, which is not part of the log tail
            self.replication.reset_to(self.replication.epoch, base)
            return
        if rtype == _J_TAIL:
            self.replication.append_raw(payload)
            return
        if rtype == _J_COMPACT:
            return
        self._apply(rtype, payload)
        self.replication.append(rtype, payload)

    def _recover_journal(self, jrecords: List[Tuple[int, bytes]],
                         has_snapshot: bool) -> None:
        """Replay the journal after the snapshot, deciding whether its
        records are post-compaction state (feed them) or a stale journal
        a crash left un-truncated (skip them — replaying would double-feed
        the replication tap, shift every standby's offset, or resurrect
        GC-dropped versions).

        The decision is the ``_J_COMPACT`` boundary marker ``compact()``
        writes as the first record of every freshly reset journal, carrying
        the replication ``(epoch, head)`` its snapshot covers:

        * journal epoch **behind** the snapshot's → the whole journal
          predates a GC rollover the snapshot includes (sweep died between
          its snapshot and the journal reset) → stale, skip;
        * same epoch, marker head == snapshot head → the journal continues
          the snapshot → feed;
        * same epoch, marker head behind → a later compact's truncation was
          interrupted; the body must byte-match the snapshot's tail
          (anything else is corruption) → stale, skip;
        * journal ahead of the snapshot (epoch or head) → the snapshot
          regressed — real corruption, fail loudly.

        A snapshot with a trimmed base (``_J_TRIM`` — a trimmed primary or
        a snapshot-bootstrapped standby) adds one rule: a journal whose
        marker head lies **below the base** predates the trim/bootstrap
        point entirely (bootstrap crashed between the snapshot rename and
        the journal reset), as does a marker-less journal next to a
        trimmed snapshot (a follower's plain journal at bootstrap time) —
        both are stale, no byte comparison possible or needed.

        Without a snapshot the journal is the sole authority and is fed
        whole.  Journals from before the marker existed fall back to the
        byte-suffix comparison.  A detected stale journal is truncated on
        the spot (the interrupted compaction is finished), so post-crash
        appends never mix stale and fresh records.
        """
        wire = _wire()
        snap_epoch = self.replication.epoch    # as set by the snapshot (or 0)
        snap_head = self.replication.head()
        snap_base = self.replication.base
        marker: Optional[Tuple[int, int]] = None
        if jrecords and jrecords[0][0] == _J_COMPACT:
            m_epoch, off = wire.decode_uvarint(jrecords[0][1], 0)
            m_head, _ = wire.decode_uvarint(jrecords[0][1], off)
            marker = (m_epoch, m_head)
            jrecords = jrecords[1:]
        epochs = [(t, p) for t, p in jrecords if t == _J_EPOCH]
        body = [(t, p) for t, p in jrecords
                if t not in (_J_EPOCH, _J_COMPACT)]
        journal_epoch = marker[0] if marker is not None else 0
        for _t, p in epochs:
            e, _ = wire.decode_uvarint(p, 0)
            journal_epoch = max(journal_epoch, e)
        stale = False
        if body and has_snapshot:
            if journal_epoch > snap_epoch:
                raise JournalError(
                    f"journal is at replication epoch {journal_epoch} but "
                    f"the snapshot only covers epoch {snap_epoch} — the "
                    f"snapshot regressed")
            if journal_epoch < snap_epoch:
                stale = True               # predates the GC rollover
            elif marker is not None:
                if marker[1] > snap_head:
                    raise JournalError(
                        f"journal claims a compaction at replication head "
                        f"{marker[1]} but the snapshot only covers "
                        f"{snap_head}")
                if marker[1] < snap_base:
                    stale = True   # predates the trim/bootstrap point
                elif marker[1] < snap_head:
                    if not self._is_replication_tail(body):
                        raise JournalError(
                            "journal and snapshot disagree about the "
                            "records after the last compaction")
                    stale = True
            else:
                stale = snap_base > 0 or self._is_replication_tail(body)
        if stale:
            # finish the interrupted truncation: later appends must land on
            # a clean post-compact journal, never after stale records
            self._journal.reset()
            self._journal.append(_J_COMPACT,
                                 wire.encode_uvarint(snap_epoch)
                                 + wire.encode_uvarint(snap_head))
            return
        for rtype, payload in epochs:      # epochs first: idempotent values
            self._recover_record(rtype, payload)
        for rtype, payload in body:
            self._recover_record(rtype, payload)

    def _is_replication_tail(self, records: Sequence[Tuple[int, bytes]]
                             ) -> bool:
        """True iff ``records`` re-encode byte-identically to the last
        ``len(records)`` records already fed to the replication log."""
        wire = _wire()
        raws = [wire.encode_record(t, p) for t, p in records]
        return raws == self.replication.tail(len(raws))

    # -- server-side API (what the wire protocol calls) -----------------------

    def lineage(self, name: str) -> VersionedCDMT:
        if name not in self.lineages:
            self.lineages[name] = VersionedCDMT(params=self.cdmt_params)
        return self.lineages[name]

    def latest_index(self, lineage: str) -> Optional[CDMT]:
        lin = self.lineages.get(lineage)
        if lin is None or not lin.roots:
            return None
        return lin.get_version(lin.roots[-1].version)

    # api-boundary
    def index_for_tag(self, lineage: str, tag: str) -> CDMT:
        """CDMT for ``lineage:tag``; :class:`DeliveryError` (a clean
        protocol-level error, not a bare ``KeyError``) when unknown."""
        lin = self.lineages.get(lineage)
        if lin is None:
            raise DeliveryError(f"unknown lineage {lineage!r}")
        version = lin.version_of(tag)
        if version is None:
            raise DeliveryError(f"unknown tag {lineage}:{tag}")
        return lin.get_version(version)

    # api-boundary
    def branch_root_at(self, lineage: str, branch: str,
                       version: int) -> Optional[bytes]:
        """Branch-at-version query: the CDMT root the branch head
        ``branch`` (tags follow ``branch@rev``) held at ``version`` in
        ``lineage``; ``None`` if the branch had no commit yet.

        Answers survive restart and compaction: the backing
        ``mod_history`` is rebuilt from journaled commit records during
        recovery (see ``VersionedCDMT.branch_root_at``)."""
        lin = self.lineages.get(lineage)
        if lin is None:
            raise DeliveryError(f"unknown lineage {lineage!r}")
        return lin.branch_root_at(branch, version)

    def has_chunks(self, fps: Iterable[bytes]) -> List[bytes]:
        """Which of ``fps`` the registry is missing."""
        return self.store.missing(fps)

    # api-boundary
    def receive_push(self, lineage: str, tag: str, recipe: Recipe,
                     chunks: Dict[bytes, bytes],
                     parent_version: Optional[int] = None,
                     claimed_root: Optional[bytes] = None,
                     claimed_params: Optional[CDMTParams] = None,
                     chunks_verified: bool = False) -> PushReceipt:
        """Accept a push: verify, store new chunks, extend the versioned CDMT.

        Verification (paper Sec. V — the root check doubles as the
        authentication mechanism):

        * every pushed chunk's blake2b must equal its claimed fingerprint
          (skipped with ``chunks_verified`` — the wire frontend already
          hashes every payload during ``decode_chunk_batch``);
        * every fingerprint the recipe references must be covered — either
          pushed now or already stored — so a committed version is always
          reconstructable, and every pushed chunk must be referenced by the
          recipe, so no unreachable data enters the store;
        * with ``claimed_root`` given, the CDMT built from the recipe's leaf
          sequence must hash to exactly that root.  When the claim's params
          match the registry's, this build is **incremental** against the
          parent version's tree (O(changed subtrees), not O(n_leaves)) and
          is the very tree the commit then installs — one build serves both
          verification and maintenance, with no throwaway full rebuild.
          With foreign ``claimed_params`` the claim is verified against a
          throwaway build with those params (a differently-cut tree cannot
          be donated to the lineage);
        * re-pushing an existing tag with the same root is idempotent
          (``deduplicated`` receipt, no new version); with a different root
          it is rejected — a tag binds one root, forever.

        All checks run *before* any state is mutated (new CDMT nodes land in
        a copy-on-write overlay); a failed push leaves the registry
        untouched and raises :class:`PushRejected`.  On success, chunks are
        fsynced and the commit is journaled before the receipt is returned.
        """
        t0 = time.perf_counter()
        if self.read_only:
            raise PushRejected(
                f"push {lineage}:{tag}: registry is a read-only standby — "
                f"push to the primary, or promote this replica first")
        if len(recipe.fps) != len(recipe.sizes):
            raise PushRejected(
                f"push {lineage}:{tag}: recipe has {len(recipe.fps)} "
                f"fingerprints but {len(recipe.sizes)} sizes")
        if not chunks_verified:
            for fp, data in chunks.items():
                if hashing.chunk_fingerprint(data) != fp:
                    raise PushRejected(
                        f"push {lineage}:{tag}: chunk {fp.hex()[:12]} payload "
                        f"does not hash to its fingerprint")
        referenced = set(recipe.fps)
        stray = [fp for fp in chunks if fp not in referenced]
        if stray:
            raise PushRejected(
                f"push {lineage}:{tag}: {len(stray)} pushed chunk(s) not "
                f"referenced by the recipe (first: {stray[0].hex()[:12]}) — "
                f"refusing to store unreachable data")
        unavailable = [fp for fp in self.store.missing(recipe.fps)
                       if fp not in chunks]
        if unavailable:
            raise PushRejected(
                f"push {lineage}:{tag}: recipe references "
                f"{len(unavailable)} chunk(s) neither pushed nor stored "
                f"(first: {unavailable[0].hex()[:12]})")

        lin = self.lineages.get(lineage)
        new_lineage = lin is None
        if new_lineage:
            lin = VersionedCDMT(params=self.cdmt_params)
        if parent_version is not None and not 0 <= parent_version < len(lin.roots):
            raise PushRejected(
                f"push {lineage}:{tag}: unknown parent version "
                f"{parent_version}")
        params = claimed_params or self.cdmt_params
        if claimed_root is not None and params != self.cdmt_params:
            # foreign tree parameters: verify the claim against a throwaway
            # build with those params; the lineage index below still uses
            # the registry's own params (a differently-cut tree cannot be
            # donated)
            check = CDMT.build(recipe.fps, params=params)
            if check.root != claimed_root:
                raise PushRejected(
                    f"push {lineage}:{tag}: rebuilt CDMT root "
                    f"{check.root.hex()[:12] if check.root else None} != "
                    f"claimed {claimed_root.hex()[:12]}")
            claimed_root = None        # claim consumed; registry-params build
        tree, new_nodes, stats = lin.build_next(recipe.fps,
                                                parent=parent_version)
        if claimed_root is not None and tree.root != claimed_root:
            raise PushRejected(
                f"push {lineage}:{tag}: rebuilt CDMT root "
                f"{tree.root.hex()[:12] if tree.root else None} != "
                f"claimed {claimed_root.hex()[:12]}")
        existing = lin.version_of(tag)
        if existing is not None:
            prev = lin.roots[existing]
            if prev.root != tree.root:
                raise PushRejected(
                    f"push {lineage}:{tag}: tag is already bound to a "
                    f"different root — push under a new tag")
            self._m_commit.observe(time.perf_counter() - t0)
            return PushReceipt(lineage=lineage, tag=tag, version=prev.version,
                               chunks_received=0, bytes_received=0,
                               index_bytes=tree.index_size_bytes(),
                               root=prev.root, hash_calls=stats.hash_calls,
                               nodes_hashed=stats.nodes_hashed,
                               deduplicated=True)

        # -- verified: mutate (chunks → journal → recipes → index) ------------
        # Write-ahead order: the commit record is journaled BEFORE any
        # in-memory index state changes.  If the append fails (ENOSPC, closed
        # journal) the push errors out with the index untouched, so a client
        # retry re-runs verification and re-journals — never a success
        # receipt for a version that would vanish on restart.  (Chunks land
        # first: they are content-addressed, so an orphan from a failed push
        # is idle data, not corruption.)
        nbytes = 0
        nchunks = 0
        for fp, data in chunks.items():
            if self.store.chunks.put(fp, data):
                nchunks += 1
                nbytes += len(data)
        self.store.chunks.sync()       # chunks durable before the commit record
        parent_resolved = (parent_version if parent_version is not None
                           else lin.head_version())
        pending = VersionRecord(version=len(lin.roots), tag=tag,
                                root=tree.root, parent=parent_resolved,
                                n_leaves=len(recipe.fps), new_nodes=0)
        # encode ONCE: the journal and the replication log get the same
        # bytes, so a shipped record is byte-identical to the journaled one
        commit_raw = _wire().encode_record(
            _J_COMMIT, _encode_commit(lineage, tag, pending, recipe))
        if self._journal is not None:
            self._journal.append_raw(commit_raw)
        self.recipes[(lineage, tag)] = recipe
        self.store.recipes[f"{lineage}:{tag}"] = recipe
        rec = lin.commit(recipe.fps, tag=tag, parent=parent_version,
                         tree=tree, new_nodes=new_nodes)
        assert rec.version == pending.version and rec.root == pending.root
        if new_lineage:
            self.lineages[lineage] = lin
        # replication tap: only *committed* records are shipped to standbys
        self.replication.append_raw(commit_raw)
        self._m_repl_head.set(self.replication.head())
        self._m_commit.observe(time.perf_counter() - t0)
        return PushReceipt(lineage=lineage, tag=tag, version=rec.version,
                           chunks_received=nchunks, bytes_received=nbytes,
                           index_bytes=tree.index_size_bytes(), root=rec.root,
                           nodes_created=rec.new_nodes,
                           nodes_hashed=stats.nodes_hashed,
                           hash_calls=stats.hash_calls)

    # api-boundary
    def serve_chunks(self, fps: Sequence[bytes]) -> Dict[bytes, bytes]:
        """Chunk payloads for ``fps``; an unknown fingerprint raises a clean
        :class:`DeliveryError` instead of leaking a bare ``KeyError``
        through the wire frontend."""
        out: Dict[bytes, bytes] = {}
        for fp in fps:
            try:
                out[fp] = self.store.chunks.get(fp)
            except KeyError:
                raise DeliveryError(
                    f"registry cannot serve unknown chunk "
                    f"{fp.hex()[:12]}") from None
        return out

    # api-boundary
    def recipe_for(self, lineage: str, tag: str) -> Recipe:
        recipe = self.recipes.get((lineage, tag))
        if recipe is None:
            raise DeliveryError(f"no recipe for {lineage}:{tag}")
        return recipe

    def tags(self, lineage: str) -> List[str]:
        lin = self.lineages.get(lineage)
        return lin.tags() if lin else []

    # -- small metadata blobs (checkpoint manifests etc.) ---------------------

    # api-boundary
    def put_metadata(self, lineage: str, tag: str, blob: bytes) -> None:
        if self.read_only:
            raise PushRejected(
                f"metadata write {lineage}:{tag}: registry is a read-only "
                f"standby — write to the primary, or promote this replica")
        # write-ahead like receive_push: journal first, so a failed append
        # never leaves in-memory state a later compact() would resurrect
        raw = _wire().encode_record(_J_META, _encode_meta(lineage, tag, blob))
        if self._journal is not None:
            self._journal.append_raw(raw)
        self.metadata[(lineage, tag)] = blob
        self.replication.append_raw(raw)

    # api-boundary
    def get_metadata(self, lineage: str, tag: str) -> bytes:
        blob = self.metadata.get((lineage, tag))
        if blob is None:
            raise DeliveryError(f"no metadata for {lineage}:{tag}")
        return blob

    # -- garbage collection --------------------------------------------------

    # api-boundary
    def sweep(self, retain_tags: Optional[Mapping[str, Iterable[str]]] = None,
              drop: bool = False) -> SweepReport:
        """Mark-and-sweep over recipes: report — and with ``drop=True``
        reclaim — chunks no retained version references.

        ``retain_tags`` maps lineage → the tags to pin; lineages absent from
        the mapping retain **all** their tags, and ``None`` (the default)
        retains everything — the sweep then reports only true orphans
        (chunks referenced by no recipe at all).  Unknown pins raise
        ``ValueError``: a typo in a retention policy must not silently
        widen the sweep.

        With ``drop=True`` the un-pinned versions are forgotten first (each
        affected lineage's versioned CDMT is rebuilt from the retained
        recipes — version numbers are reassigned densely; tags remain the
        stable names), then the journal is compacted so a restart replays
        only retained state, and only *then* is the chunk log compacted.
        That ordering is what makes the sweep journal-safe: a crash between
        journal and chunk compaction leaves garbage chunks (harmless,
        re-sweepable), never a journaled version whose chunks are gone.
        """
        pins: Optional[Dict[str, Set[str]]] = None
        if retain_tags is not None:
            # normalize up front: a one-shot iterator as a value must not be
            # consumed by validation and then read as empty by the sweep —
            # that would silently drop the pinned versions themselves
            pins = {lin: set(tags) for lin, tags in retain_tags.items()}
            for lin, tags in pins.items():
                if lin not in self.lineages:
                    raise ValueError(f"sweep: unknown lineage {lin!r}")
                for t in tags:
                    if (lin, t) not in self.recipes:
                        raise ValueError(f"sweep: unknown pin {lin}:{t}")
        retained: Set[Tuple[str, str]] = set()
        dropped_pairs: List[Tuple[str, str]] = []
        for lineage, tag in self.recipes:
            if pins is None or lineage not in pins or tag in pins[lineage]:
                retained.add((lineage, tag))
            else:
                dropped_pairs.append((lineage, tag))

        live: Set[bytes] = set()
        for pair in retained:
            live.update(self.recipes[pair].fps)
        chunks = self.store.chunks
        dead = [fp for fp in chunks.fingerprints() if fp not in live]
        dead_bytes = sum(chunks.chunk_size(fp) for fp in dead)
        report = SweepReport(
            live_chunks=chunks.n_chunks() - len(dead),
            live_bytes=chunks.stored_bytes() - dead_bytes,
            unreferenced_chunks=len(dead),
            unreferenced_bytes=dead_bytes,
            retained_versions=len(retained),
            dropped_versions=len(dropped_pairs))
        if not drop:
            return report

        # 1) forget un-pinned versions: rebuild each affected lineage from
        #    its retained recipes (in original version order)
        by_lineage: Dict[str, List[str]] = {}
        for lineage, tag in dropped_pairs:
            by_lineage.setdefault(lineage, []).append(tag)
        for lineage in by_lineage:
            old = self.lineages[lineage]
            keep = [rec for rec in old.version_records()
                    if (lineage, rec.tag) in retained]
            if keep:
                fresh = VersionedCDMT(params=self.cdmt_params)
                for rec in keep:
                    fresh.commit(self.recipes[(lineage, rec.tag)].fps,
                                 tag=rec.tag)
                self.lineages[lineage] = fresh
            else:
                del self.lineages[lineage]
        for lineage, tag in dropped_pairs:
            del self.recipes[(lineage, tag)]
            self.store.recipes.pop(f"{lineage}:{tag}", None)
            self.metadata.pop((lineage, tag), None)
        # dropping versions reassigns version numbers, so every standby's
        # resume offset is now meaningless: roll the replication log into a
        # new epoch and re-seed it with the retained-only state (a *fresh*
        # standby can still sync from offset 0; followers at the old epoch
        # are refused and must full-resync)
        if dropped_pairs:
            self.replication.rollover()
            for rtype, payload in self._state_records():
                self.replication.append(rtype, payload)
            self._m_repl_epoch.set(self.replication.epoch)
            self._m_repl_head.set(self.replication.head())
        # 2) journal safety: persist the retained-only state BEFORE any
        #    chunk payload disappears
        if self._journal is not None:
            self.compact()
        # 3) reclaim the chunk log
        dropped_chunks, reclaimed = chunks.compact(live)
        report.dropped_chunks = dropped_chunks
        report.reclaimed_bytes = reclaimed
        return report

    # -- durability ----------------------------------------------------------

    def _apply(self, rtype: int, payload: bytes) -> None:
        """Replay one journal/snapshot record.  Unknown record types are
        skipped (forward compatibility); inconsistent records raise
        :class:`JournalError`."""
        if rtype == _J_COMMIT:
            lineage, tag, version, parent, root, recipe = \
                _decode_commit(payload)
            lin = self.lineage(lineage)
            try:
                rec = lin.commit(recipe.fps, tag=tag, parent=parent)
            except ValueError as e:
                raise JournalError(f"replay {lineage}:{tag}: {e}") from None
            if rec.version != version:
                raise JournalError(
                    f"replay {lineage}:{tag}: assigned version {rec.version} "
                    f"!= journaled {version}")
            if rec.root != root:
                raise JournalError(
                    f"replay {lineage}:{tag}: rebuilt root "
                    f"{rec.root.hex()[:12] if rec.root else None} != "
                    f"journaled {root.hex()[:12] if root else None}")
            self.recipes[(lineage, tag)] = recipe
            self.store.recipes[f"{lineage}:{tag}"] = recipe
        elif rtype == _J_META:
            lineage, tag, blob = _decode_meta(payload)
            self.metadata[(lineage, tag)] = blob

    # api-boundary
    def apply_replicated(self, rtype: int, payload: bytes,
                         expected_seq: Optional[int] = None,
                         raw: Optional[bytes] = None) -> bool:
        """Apply one record shipped from a primary (standby-side replay).

        ``expected_seq`` is the record's offset in the primary's replication
        log; a record at an offset this registry has already applied is
        **skipped** (returns ``False``) — duplicate delivery after a lost
        ack or a crash between apply and ack is idempotent — while a gap
        (offset ahead of our head) raises :class:`JournalError` instead of
        silently corrupting version numbering.

        Write order mirrors ``receive_push``: any chunk payloads the record
        references must already be in the store (the follower fetches them
        first); they are fsynced, then the record is journaled, then applied
        — so an acked offset never points at non-durable standby state.

        The record itself was checksum-verified on decode
        (:func:`repro_torch.delivery.wire.decode_record_frame`) before it reaches
        this method; ``raw`` is that verified encoding — passing it through
        avoids re-encoding and re-journals the primary's exact bytes.
        """
        if expected_seq is not None:
            head = self.replication.head()
            if expected_seq < head:
                return False               # duplicate delivery: already applied
            if expected_seq > head:
                raise JournalError(
                    f"replication gap: record offset {expected_seq} but "
                    f"standby has only applied {head}")
        t0 = time.perf_counter()
        if raw is None:
            raw = _wire().encode_record(rtype, payload)
        if self._journal is not None:
            self.store.chunks.sync()   # referenced chunks durable first
            self._journal.append_raw(raw)
        self._apply(rtype, payload)
        self.replication.append_raw(raw)
        self._m_repl_head.set(self.replication.head())
        self._m_apply.observe(time.perf_counter() - t0)
        return True

    def set_replication_epoch(self, epoch: int) -> None:
        """Adopt a replication epoch (standby role: a fresh follower learns
        the primary's epoch on first contact).  Journaled as an epoch
        marker, so the pairing of *offset × epoch* survives a standby
        restart — a follower must never resume an old-epoch offset against
        a newer-epoch primary."""
        if self._journal is not None:
            self._journal.append(_J_EPOCH, _wire().encode_uvarint(epoch))
        self.replication.set_epoch(epoch)
        self._m_repl_epoch.set(epoch)

    def _state_records(self) -> List[Tuple[int, bytes]]:
        """The current committed state as a compacted record sequence —
        what a snapshot persists and what a rolled-over replication log is
        re-seeded with."""
        records: List[Tuple[int, bytes]] = []
        for lineage, lin in self.lineages.items():
            for rec in lin.version_records():
                recipe = self.recipes.get((lineage, rec.tag))
                if recipe is not None:
                    records.append(
                        (_J_COMMIT, _encode_commit(lineage, rec.tag, rec,
                                                   recipe)))
        for (lineage, tag), blob in self.metadata.items():
            records.append((_J_META, _encode_meta(lineage, tag, blob)))
        return records

    def compact(self) -> None:
        """Write the current state as a snapshot and truncate the journal.

        The snapshot has three sections, replayed in order by
        ``_recover_record``:

        1. the replication epoch marker, then the **collapsed state
           records** (one commit per retained version plus current
           metadata) — these rebuild the registry's state; the trimmed
           record-history prefix no longer exists anywhere, so the state
           must be self-contained;
        2. a ``_J_TRIM`` marker carrying the log's trimmed ``base`` —
           replay *resets* the replication log (wiping the state section's
           feed) to an empty log based at that offset;
        3. the **live log tail** (offsets ``base..head``), each raw record
           wrapped in ``_J_TAIL`` so replay feeds it to the log verbatim
           without re-applying state the collapsed section already covers.

        A restart therefore rebuilds both the state and the log
        byte-identically (base included), so every standby's resume offset
        stays valid across primary compactions and restarts.  The log no
        longer grows with the epoch's whole record history:
        :meth:`trim_replication` drops the prefix every tracked replica
        has acked, and fresh standbys join from :meth:`state_snapshot`
        (``Op.SNAPSHOT_SHIP``) instead of offset 0 — closing the trade
        this docstring used to document.

        Crash-safe in every window: the snapshot lands by atomic rename;
        the reset journal immediately receives a ``_J_COMPACT`` boundary
        marker naming the head the snapshot covers, so recovery can tell a
        post-compaction journal from a stale one whose truncation was
        interrupted (and in the latter case skips it and finishes the
        truncation — no double-apply, no offset shift).
        """
        if self._journal is None:
            return
        wire = _wire()
        epoch = self.replication.epoch
        head = self.replication.head()
        epoch_raw = wire.encode_record(_J_EPOCH, wire.encode_uvarint(epoch))
        state_raws = [wire.encode_record(t, p)
                      for t, p in self._state_records()]
        trim_raw = wire.encode_record(
            _J_TRIM, wire.encode_uvarint(self.replication.base))
        tail_raws = [wire.encode_record(_J_TAIL, r)
                     for r in self.replication.dump()]
        write_snapshot_raw(self._snap_path,
                           [epoch_raw] + state_raws + [trim_raw] + tail_raws)
        faults.fire("compact.after_snapshot")
        self._journal.reset()
        faults.fire("compact.before_marker")
        self._journal.append(_J_COMPACT, wire.encode_uvarint(epoch)
                             + wire.encode_uvarint(head))

    def trim_replication(self, min_acked: int) -> int:
        """Drop replication-log records below ``min_acked`` (the lowest
        offset every tracked replica has acked — the serving frontend calls
        this after recording each ack) and, when records were dropped,
        persist the bounded log via :meth:`compact`.  Returns the number of
        records dropped.

        In-memory trim first, durable compact second: a crash between the
        two recovers the *untrimmed* log from the previous snapshot — a
        larger memory footprint until the next trim, never a lost record.
        """
        dropped = self.replication.trim_to(min_acked)
        if dropped:
            self._m_repl_trimmed.inc(dropped)
            faults.fire("trim.before_compact")
            if self._journal is not None:
                self.compact()
        self._m_repl_base.set(self.replication.base)
        self._m_repl_records.set(self.replication.head()
                                 - self.replication.base)
        return dropped

    def state_snapshot(self) -> Tuple[int, int, List[bytes]]:
        """The collapsed current state as encoded checksummed records, plus
        the replication position ``(epoch, head)`` it corresponds to — what
        ``Op.SNAPSHOT_SHIP`` streams to a bootstrapping standby.

        Collapsed means O(live state), not O(record history): one commit
        record per retained version plus each metadata key's current value.
        The caller must hold the serving lock so position and state agree.
        """
        wire = _wire()
        epoch = self.replication.epoch
        head = self.replication.head()
        raws = [wire.encode_record(t, p) for t, p in self._state_records()]
        return epoch, head, raws

    # api-boundary
    def bootstrap_from_snapshot(self, epoch: int, head: int,
                                records: Sequence[Tuple[int, bytes, bytes]]
                                ) -> int:
        """Adopt a primary's collapsed state snapshot (standby bootstrap).

        ``records`` are ``(rtype, payload, raw)`` triples as verified by
        :func:`repro_torch.delivery.wire.decode_record_frame`; ``(epoch, head)``
        is the replication position the snapshot corresponds to — after
        this returns, ordinary ``JOURNAL_SHIP`` resumes from ``head``.
        Any chunk payloads the records reference must already be in the
        store (the follower fetches them first, like ordinary replay).

        Trust-but-reverify: before anything is persisted the records are
        replayed into a scratch registry, re-verifying every commit's CDMT
        root against its recipe — adopted state from a lying or corrupted
        primary is rejected (:class:`JournalError`) with this registry
        untouched.  Persistence is then strictly before installation: the
        snapshot file lands atomically (epoch + state records + a
        ``_J_TRIM`` marker at ``head``), the journal is reset behind a
        ``_J_COMPACT`` marker, and only then is the verified state
        installed in memory — so every crash window either recovers the
        pre-bootstrap state (the bootstrap restarts idempotently) or the
        complete post-bootstrap state, never a torn mixture.

        Returns the number of state records adopted.
        """
        t0 = time.perf_counter()
        wire = _wire()
        # 1) re-verify into a scratch registry (same CDMT params): a bad
        #    record is detected before any durable state changes
        scratch = Registry(cdmt_params=self.cdmt_params)
        for rtype, payload, _raw in records:
            scratch._apply(rtype, payload)
        raws = [raw for _t, _p, raw in records]
        faults.fire("bootstrap.before_snapshot")
        # 2) persist: recovery of this snapshot rebuilds exactly the state
        #    installed below (records applied; log empty, based at head)
        if self._journal is not None:
            self.store.chunks.sync()   # referenced chunks durable first
            epoch_raw = wire.encode_record(_J_EPOCH,
                                           wire.encode_uvarint(epoch))
            trim_raw = wire.encode_record(_J_TRIM,
                                          wire.encode_uvarint(head))
            write_snapshot_raw(self._snap_path,
                               [epoch_raw] + raws + [trim_raw])
            faults.fire("bootstrap.after_snapshot")
            self._journal.reset()
            faults.fire("bootstrap.before_marker")
            self._journal.append(_J_COMPACT, wire.encode_uvarint(epoch)
                                 + wire.encode_uvarint(head))
        faults.fire("bootstrap.after_persist")
        # 3) install: adopt the verified scratch state wholesale
        self.lineages = scratch.lineages
        self.recipes = scratch.recipes
        self.metadata = scratch.metadata
        self.store.recipes.clear()
        self.store.recipes.update(scratch.store.recipes)
        self.replication.reset_to(epoch, head)
        self._m_repl_epoch.set(epoch)
        self._m_repl_head.set(head)
        self._m_repl_base.set(head)
        self._m_repl_records.set(0)
        self._m_bootstrap_bytes.inc(sum(len(r) for r in raws))
        self._m_bootstrap.observe(time.perf_counter() - t0)
        return len(raws)

    def journal_size_bytes(self) -> int:
        return self._journal.size_bytes() if self._journal is not None else 0

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
        self.store.close()


# ---------------------------------------------------- journal record payloads

def record_chunk_fps(rtype: int, payload: bytes) -> List[bytes]:
    """The chunk fingerprints a replicated record references — what a
    standby must hold *before* replaying it (a commit record's recipe fps;
    metadata records reference none).  Unknown record types reference none
    (forward compatibility: they are skipped by ``_apply`` too)."""
    if rtype != _J_COMMIT:
        return []
    return list(_decode_commit(payload)[5].fps)


def _encode_commit(lineage: str, tag: str, rec: VersionRecord,
                   recipe: Recipe) -> bytes:
    from repro_torch.delivery import wire     # lazy: see journal layering note
    out = bytearray()
    for s in (lineage, tag):
        b = s.encode("utf-8")
        out += wire.encode_uvarint(len(b))
        out += b
    out += wire.encode_uvarint(rec.version)
    if rec.parent is None:
        out += wire.encode_uvarint(0)
    else:
        out += wire.encode_uvarint(1)
        out += wire.encode_uvarint(rec.parent)
    if rec.root is None:
        out += wire.encode_uvarint(0)
    else:
        out += wire.encode_uvarint(1)
        out += rec.root
    out += wire.encode_recipe(recipe)   # trailing self-verifying RECIPE frame
    return bytes(out)


def _decode_commit(payload: bytes
                   ) -> Tuple[str, str, int, Optional[int], Optional[bytes],
                              Recipe]:
    from repro_torch.delivery import wire
    off = 0
    strs: List[str] = []
    for _ in range(2):
        n, off = wire.decode_uvarint(payload, off)
        if off + n > len(payload):
            raise JournalError("truncated commit record string")
        strs.append(payload[off:off + n].decode("utf-8"))
        off += n
    version, off = wire.decode_uvarint(payload, off)
    has_parent, off = wire.decode_uvarint(payload, off)
    parent: Optional[int] = None
    if has_parent:
        parent, off = wire.decode_uvarint(payload, off)
    has_root, off = wire.decode_uvarint(payload, off)
    root: Optional[bytes] = None
    if has_root:
        root = payload[off:off + hashing.DIGEST_SIZE]
        if len(root) != hashing.DIGEST_SIZE:
            raise JournalError("truncated commit record root")
        off += hashing.DIGEST_SIZE
    recipe = wire.decode_recipe(payload[off:])
    return strs[0], strs[1], version, parent, root, recipe


def _encode_meta(lineage: str, tag: str, blob: bytes) -> bytes:
    from repro_torch.delivery import wire
    out = bytearray()
    for b in (lineage.encode("utf-8"), tag.encode("utf-8"), blob):
        out += wire.encode_uvarint(len(b))
        out += b
    return bytes(out)


def _decode_meta(payload: bytes) -> Tuple[str, str, bytes]:
    from repro_torch.delivery import wire
    off = 0
    parts: List[bytes] = []
    for _ in range(3):
        n, off = wire.decode_uvarint(payload, off)
        if off + n > len(payload):
            raise JournalError("truncated metadata record")
        parts.append(payload[off:off + n])
        off += n
    return parts[0].decode("utf-8"), parts[1].decode("utf-8"), parts[2]
