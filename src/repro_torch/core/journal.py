"""Append-only, checksummed journal — the registry's crash-safe state log.

Record framing reuses the delivery wire format's checksummed records
(:func:`repro_torch.delivery.wire.encode_record`): ``magic | version | type |
uvarint(len) | payload | blake2b-8``.  A reader stops at the first record
that fails to decode — a torn tail from a crash mid-append — and
:class:`Journal` truncates the file back to the last complete record before
appending again, so one crash never poisons subsequent recoveries.

Durability contract: with ``sync=True`` (the default) :meth:`Journal.append`
returns only after ``fsync``, so a registry commit acknowledged to the client
survives a crash of the registry process *and* of the host.

Snapshots (:func:`write_snapshot`) are just compacted record files written
via temp-file + ``fsync`` + atomic rename: recovery replays snapshot then
journal, and because the registry's record application is idempotent, a crash
between snapshot rename and journal truncation only causes harmless
re-application.

Replication: :class:`ReplicationLog` is the in-memory, offset-addressed tap
a primary registry feeds with every committed record (in commit order — the
same order the journal sees them).  Standby registries follow it over the
socket protocol's ``JOURNAL_SHIP``/``REPL_ACK`` ops (the JAX package's
``repro.delivery.net``; not ported yet), resuming from the count of records
they have already applied; because the log stores the *encoded* checksummed record
bytes, a shipped record is re-verified end to end before a standby replays
it.  The log is logical — journal compaction does not disturb its offsets;
only a GC sweep that drops versions rolls it over to a new ``epoch``
(standbys at an older epoch must full-resync from an empty directory).

Concurrency contract
    ``Journal`` is **single-writer**: exactly one thread (the registry
    commit path, which the delivery frontends already serialize behind
    ``RegistryServer._registry_lock``) may call :meth:`Journal.append` /
    :meth:`Journal.reset`.  ``scan_records`` / recovery run before any
    writer exists.  :class:`ReplicationLog` by contrast is **thread-safe**
    (internal lock): one committer appends while any number of
    ``JOURNAL_SHIP`` handler threads read ``records_from`` concurrently.

Crash-recovery contract
    A record is *committed* iff it decodes cleanly (checksum included) from
    the snapshot-then-journal sequence.  After any crash, reopening a
    ``Journal`` truncates the torn tail, so the journal is always left in a
    state where every byte on disk belongs to a committed record; appends
    with ``sync=True`` make the record durable before returning.  The
    ``ReplicationLog`` is rebuilt on recovery from exactly those committed
    records, so a standby's resume offset (records applied) stays valid
    across primary *and* standby restarts.

Layering note: like ``core.pushpull``, this module's wire-format use is the
deliberate upward reference from core to the delivery layer; it is imported
lazily (call time) so ``import repro_torch.core`` never recurses into
``repro_torch.delivery``'s package init.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, List, Optional, Tuple

from repro_torch.obs import MetricsRegistry, NULL_REGISTRY

from .errors import JournalError

__all__ = ["Journal", "JournalError", "ReplicationLog", "scan_records",
           "write_snapshot", "write_snapshot_raw"]


def _wire():
    from repro_torch.delivery import wire   # lazy: see layering note above
    return wire


def scan_records(path: str) -> Tuple[List[Tuple[int, bytes]], int, int]:
    """Read every complete record of ``path``.

    Returns ``(records, good_end, file_size)`` where ``records`` is a list of
    ``(type, payload)`` and ``good_end`` is the byte offset after the last
    record that decoded cleanly — everything past it is a torn tail.
    A missing file is an empty journal, not an error.
    """
    if not os.path.exists(path):
        return [], 0, 0
    with open(path, "rb") as f:
        buf = f.read()
    wire = _wire()
    records: List[Tuple[int, bytes]] = []
    off = 0
    while off < len(buf):
        try:
            rtype, payload, noff = wire.decode_record(buf, off)
        except wire.WireError:
            break                       # torn/corrupt tail: stop here
        records.append((rtype, payload))
        off = noff
    return records, off, len(buf)


class Journal:
    """Writable journal over one file: recover, replay, append, reset.

    ``metrics`` (a :class:`repro_torch.obs.MetricsRegistry`) receives the
    ``journal_*`` series — append latency (fsync cost included) and the
    on-disk size gauge.  The owning registry passes its own; a bare journal
    defaults to the no-op registry, so metering never changes behavior.
    """

    def __init__(self, path: str, sync: bool = True,
                 metrics: MetricsRegistry = NULL_REGISTRY):
        self.path = path
        self.sync_writes = sync
        records, good_end, size = scan_records(path)
        self.torn_bytes_discarded = size - good_end
        if self.torn_bytes_discarded:
            with open(path, "r+b") as f:
                f.truncate(good_end)
        self._pending: List[Tuple[int, bytes]] = records  # guarded-by: external(single-writer: registry commit path behind RegistryServer._registry_lock)
        self._f = open(path, "ab")  # guarded-by: external(single-writer: registry commit path)
        self._size = good_end  # guarded-by: external(single-writer: registry commit path)
        self._m_append = metrics.histogram(
            "journal_append_seconds",
            "journal record append latency (fsync included)").labels()
        self._m_size = metrics.gauge(
            "journal_size_bytes", "journal file size on disk").labels()
        self._m_size.set(self._size)

    # ------------------------------------------------------------------ read

    def replay(self) -> List[Tuple[int, bytes]]:
        """The records recovered at open time (consumed on first call)."""
        records, self._pending = self._pending, []
        return records

    # ----------------------------------------------------------------- write

    def append(self, rtype: int, payload: bytes) -> None:
        self.append_raw(_wire().encode_record(rtype, payload))

    def append_raw(self, raw_record: bytes) -> None:
        """Append an already-encoded checksummed record — the commit path
        encodes each record once and hands the same bytes to the journal
        and the replication log, so shipped bytes are byte-identical to
        journaled ones."""
        if self._f is None:
            raise JournalError(f"journal {self.path} is closed")
        t0 = time.perf_counter()
        self._f.write(raw_record)
        self._f.flush()
        if self.sync_writes:
            os.fsync(self._f.fileno())
        self._m_append.observe(time.perf_counter() - t0)
        self._size += len(raw_record)
        self._m_size.set(self._size)

    def reset(self) -> None:
        """Truncate to empty — call only after the state the journal covers
        has been snapshotted durably elsewhere."""
        if self._f is None:
            raise JournalError(f"journal {self.path} is closed")
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._size = 0
        self._m_size.set(0)

    # ------------------------------------------------------------ accounting

    def size_bytes(self) -> int:
        return os.path.getsize(self.path) if os.path.exists(self.path) else 0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ReplicationLog:
    """Offset-addressed stream of committed records — the replication tap.

    Every committed registry record (push commit, metadata write) is
    appended here as its **encoded checksummed bytes**
    (:func:`repro_torch.delivery.wire.encode_record`), so shipping a record to a
    standby is a copy of bytes whose integrity the standby re-verifies
    before replay.  Offsets are dense record ordinals: a standby that has
    applied ``k`` records resumes from offset ``k``.  Once every tracked
    replica has acked past an offset the primary trims the prefix below it
    (:meth:`trim_to`) — offsets stay absolute, so a follower behind the
    trimmed ``base`` is told to bootstrap from a snapshot instead of
    replaying history that no longer exists.

    ``epoch`` starts at 0 and increments only on :meth:`rollover` (a GC
    sweep that dropped versions — offsets from the old epoch are
    meaningless afterwards and followers at the old epoch are refused).

    Thread-safe: one committer appends while ship handlers read.
    """

    def __init__(self):
        self._epoch = 0  # guarded-by: _lock
        self._base = 0                     # guarded-by: _lock
        self._records: List[bytes] = []    # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def epoch(self) -> int:
        """Current epoch.  Read under the lock: ship handlers read it from
        server threads while recovery/apply paths bump it via
        :meth:`set_epoch` and GC via :meth:`rollover`."""
        with self._lock:
            return self._epoch

    def set_epoch(self, epoch: int) -> None:
        """Adopt a shipped/recovered epoch (standby catching up, or replay
        of an epoch record).  Writes must go through here, not attribute
        assignment — the guarded-by lint enforces it."""
        with self._lock:
            self._epoch = epoch

    def append(self, rtype: int, payload: bytes) -> int:
        """Record one committed ``(rtype, payload)``; returns its offset."""
        return self.append_raw(_wire().encode_record(rtype, payload))

    def append_raw(self, raw_record: bytes) -> int:
        """Record one already-encoded checksummed record (what the journal
        wrote / what a ship delivered) without re-encoding it."""
        with self._lock:
            self._records.append(raw_record)
            return self._base + len(self._records) - 1

    def head(self) -> int:
        """The next offset to be assigned == number of records ever logged
        this epoch."""
        with self._lock:
            return self._base + len(self._records)

    @property
    def base(self) -> int:
        """Lowest offset still held — everything below it was trimmed away
        once every tracked replica had acked past it."""
        with self._lock:
            return self._base

    def trim_to(self, offset: int) -> int:
        """Advance the log's base to ``offset``, dropping the record prefix
        below it.  Returns the number of records dropped.

        The primary calls this with ``min(replica_offsets)`` so in-epoch
        memory stays bounded by the slowest replica's lag; a standby's
        snapshot bootstrap calls it with the primary's head to adopt the
        shipped resume offset.  ``offset`` may exceed the current head (the
        bootstrap case: collapsed state has fewer records than the history
        it replaces) — the log is then empty with its next offset at
        ``offset``, so offsets are never re-issued.  Trimming at or below
        the current base is a no-op.
        """
        with self._lock:
            if offset <= self._base:
                return 0
            dropped = min(offset, self._base + len(self._records)) - self._base
            if dropped > 0:
                del self._records[:dropped]
            self._base = offset
            return dropped

    def records_from(self, start: int,
                     limit: Optional[int] = None) -> List[bytes]:
        """Encoded records from offset ``start`` (at most ``limit``).

        ``start == head()`` is a caught-up follower (empty list); beyond it
        — or behind a trimmed base — is a divergence and raises
        :class:`JournalError`.
        """
        with self._lock:
            if start < self._base:
                raise JournalError(
                    f"replication offset {start} is behind the log base "
                    f"{self._base} — full resync required")
            end = self._base + len(self._records)
            if start > end:
                raise JournalError(
                    f"replication offset {start} is ahead of the log head "
                    f"{end} — follower has diverged")
            out = self._records[start - self._base:]
            if limit is not None:
                out = out[:limit]
            return list(out)

    def dump(self) -> List[bytes]:
        """Every raw record this epoch, in order — what a snapshot persists
        so offsets survive a restart-after-compaction."""
        with self._lock:
            return list(self._records)

    def tail(self, n: int) -> List[bytes]:
        """The last ``n`` raw records (fewer if the log is shorter) — used
        by recovery to detect a journal that is a byte-identical suffix of
        the snapshot (crash between snapshot rename and journal truncate)."""
        with self._lock:
            return list(self._records[-n:]) if n > 0 else []

    def reset_to(self, epoch: int, base: int) -> None:
        """Adopt a snapshot-bootstrap position: ``epoch``, an empty log
        whose next offset is ``base`` — the in-memory equivalent of
        recovering a bootstrap snapshot (state records trimmed at the
        resume offset)."""
        with self._lock:
            self._epoch = epoch
            self._base = base
            self._records = []

    def rollover(self) -> int:
        """Start a new epoch with an empty log (after a version-dropping GC
        sweep; the caller re-seeds it from the retained state).  Returns the
        new epoch."""
        with self._lock:
            self._epoch += 1
            self._base = 0
            self._records = []
            return self._epoch


def write_snapshot(path: str, records: Iterable[Tuple[int, bytes]]) -> None:
    """Atomically write a compacted record file: temp + fsync + rename +
    directory fsync.  Readers either see the old snapshot or the complete
    new one, never a partial write."""
    wire = _wire()
    write_snapshot_raw(path, (wire.encode_record(rtype, payload)
                              for rtype, payload in records))


def write_snapshot_raw(path: str, raw_records: Iterable[bytes]) -> None:
    """:func:`write_snapshot` for already-encoded records (what a
    :class:`ReplicationLog` stores) — persisting the log's exact bytes with
    no decode/re-encode round-trip."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for raw in raw_records:
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")


def fsync_dir(dirname: str) -> None:
    """fsync a directory, making a completed rename inside it durable —
    an ``os.replace`` alone updates the directory entry only in memory;
    a crash before the directory inode reaches disk can undo the swap.
    Every atomic-rename site in the durable stores must call this (the
    durability lint enforces it)."""
    dfd = os.open(dirname, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
