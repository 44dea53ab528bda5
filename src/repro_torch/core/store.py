"""Deduplicated storage — the paper's three-component prototype (Sec. V):

  (i)   **container store**  — unique CDC chunks in log-structured storage,
  (ii)  **fingerprint index** — fp → physical location (here, the CDMT serves
        as the *comparison* index; the flat map is the location index),
  (iii) **recipe store**     — per-artifact ordered fp list for reconstruction.

Backed either by memory (tests/benchmarks) or a directory (examples /
checkpointing).  All writes are append-only; chunks are immutable.

Crash safety (directory mode): ``chunks.log`` is written before its
``chunks.idx`` entry, so recovery (:meth:`ChunkStore._load`) can always
repair a torn write — a partial index record is truncated, an index entry
pointing past the end of the log is dropped (with everything after it), and
an orphan log tail with no index entry is truncated.  ``sync()`` fsyncs both
files and then atomically updates a ``chunks.clean`` marker recording the
synced sizes; on recovery, entries within the marker are trusted, while
entries written *after* the last sync are verified against their payload's
blake2b (the OS may persist an index entry and the log's length without the
log's data blocks — a flush is not an fsync), with the first mismatch
treated as the torn tail.  The registry calls ``sync()`` before journaling a
commit so an acknowledged push never references non-durable chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from . import cdc, hashing
from .errors import DeliveryError
from .journal import fsync_dir


@dataclasses.dataclass
class Recipe:
    """Ordered fingerprint sequence reconstructing one artifact (layer)."""
    name: str
    fps: List[bytes]
    sizes: List[int]

    @property
    def total_size(self) -> int:
        return sum(self.sizes)

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "fps": [f.hex() for f in self.fps],
            "sizes": self.sizes,
        })

    @classmethod
    def from_json(cls, s: str) -> "Recipe":
        """Parse + validate: a malformed recipe must fail here with a clear
        ``ValueError``, not later as an opaque KeyError/size mismatch."""
        d = json.loads(s)
        name = d["name"]
        fps = [bytes.fromhex(f) for f in d["fps"]]
        sizes = [int(x) for x in d["sizes"]]
        if len(fps) != len(sizes):
            raise ValueError(
                f"recipe {name!r}: {len(fps)} fingerprints but "
                f"{len(sizes)} sizes")
        for f in fps:
            if len(f) != hashing.DIGEST_SIZE:
                raise ValueError(
                    f"recipe {name!r}: fingerprint length {len(f)} != "
                    f"digest size {hashing.DIGEST_SIZE}")
        if any(x < 0 for x in sizes):
            raise ValueError(f"recipe {name!r}: negative chunk size")
        return cls(name=name, fps=fps, sizes=sizes)


class ChunkStore:
    """Log-structured unique-chunk store with a fingerprint→location index."""

    _IDX_ENTRY = hashing.DIGEST_SIZE + 16       # fp + <QQ>(offset, size)

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self._mem: Dict[bytes, bytes] = {}
        self._index: Dict[bytes, Tuple[int, int]] = {}   # fp -> (offset, size)
        self._log_path: Optional[str] = None
        self._idx_path: Optional[str] = None
        self._clean_path: Optional[str] = None
        self._flag_path: Optional[str] = None
        self._log_size = 0
        self._idx_size = 0
        self._log_f = None
        self._idx_f = None
        self._read_fd: Optional[int] = None
        self.recovered_torn_bytes = 0           # crash debris dropped at open
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._log_path = os.path.join(directory, "chunks.log")
            self._idx_path = os.path.join(directory, "chunks.idx")
            self._clean_path = os.path.join(directory, "chunks.clean")
            self._flag_path = os.path.join(directory, "chunks.compacting")
            self._finish_compaction()
            self._load()
            # persistent handles: append once, not reopen-per-put; reads use
            # pread on a dedicated fd (positionless ⇒ thread-safe)
            self._log_f = open(self._log_path, "ab")
            self._idx_f = open(self._idx_path, "ab")
            self._read_fd = os.open(self._log_path, os.O_RDONLY)

    # -- persistence ---------------------------------------------------------

    def _finish_compaction(self) -> None:
        """Recover from a crash during :meth:`compact`.

        Compaction writes fully-fsynced ``.new`` log/idx files, then commits
        by creating ``chunks.compacting`` (the durable intent), then swaps
        each ``.new`` file into place.  Recovery is therefore idempotent:
        without the flag, leftover ``.new`` files are an uncommitted
        compaction and are discarded; with the flag, any ``.new`` file still
        present is swapped in, the (stale) clean marker is dropped so
        ``_load`` re-verifies payloads, and the flag is removed."""
        new_log = self._log_path + ".new"
        new_idx = self._idx_path + ".new"
        if not os.path.exists(self._flag_path):
            for path in (new_log, new_idx):
                if os.path.exists(path):
                    os.unlink(path)
            return
        for src, dst in ((new_log, self._log_path), (new_idx, self._idx_path)):
            if os.path.exists(src):
                os.replace(src, dst)  # durability-ok: .new files were fsynced before the durable intent flag landed; recovery only completes the rename
        fsync_dir(self.directory)
        if os.path.exists(self._clean_path):
            os.unlink(self._clean_path)    # sized for the pre-compaction files
        os.unlink(self._flag_path)

    def _read_marker(self) -> Tuple[int, int]:
        """(log bytes, idx bytes) known durable from the last ``sync()``."""
        try:
            with open(self._clean_path, "rb") as f:
                raw = f.read(16)
            if len(raw) == 16:
                return struct.unpack("<QQ", raw)
        except OSError:
            pass
        return 0, 0

    def _load(self) -> None:
        """Rebuild the in-memory index, repairing any torn tail.  Entries
        past the ``chunks.clean`` marker (written after the last fsync) are
        verified against their payload hash: an fsync-less crash can persist
        the index entry and the log length without the log's data blocks."""
        log_size = (os.path.getsize(self._log_path)
                    if os.path.exists(self._log_path) else 0)
        data = b""
        if os.path.exists(self._idx_path):
            with open(self._idx_path, "rb") as f:
                data = f.read()
        trusted_log, trusted_idx = self._read_marker()
        log_f = open(self._log_path, "rb") if log_size else None
        good = 0
        end = 0
        off = 0
        try:
            while off + self._IDX_ENTRY <= len(data):
                fp = data[off:off + hashing.DIGEST_SIZE]
                o, s = struct.unpack_from("<QQ", data,
                                          off + hashing.DIGEST_SIZE)
                if o + s > log_size:
                    break   # entry references bytes the log never durably got
                if off + self._IDX_ENTRY > trusted_idx or o + s > trusted_log:
                    log_f.seek(o)
                    if hashing.chunk_fingerprint(log_f.read(s)) != fp:
                        break                   # unsynced data never landed
                self._index[fp] = (o, s)
                end = max(end, o + s)
                off += self._IDX_ENTRY
                good = off
        finally:
            if log_f is not None:
                log_f.close()
        if len(data) > good:                    # partial/invalid idx records
            self.recovered_torn_bytes += len(data) - good
            with open(self._idx_path, "r+b") as f:
                f.truncate(good)
        if log_size > end:                      # orphan chunk bytes, no entry
            self.recovered_torn_bytes += log_size - end
            with open(self._log_path, "r+b") as f:
                f.truncate(end)
        self._log_size = end
        self._idx_size = good

    # -- API -----------------------------------------------------------------

    def has(self, fp: bytes) -> bool:
        return fp in self._index or fp in self._mem

    def put(self, fp: bytes, data: bytes) -> bool:
        """Store chunk if absent.  Returns True if newly stored.  Log bytes
        are flushed before the index entry is written, preserving the
        log-before-index recovery invariant."""
        if self.has(fp):
            return False
        if self.directory is not None:
            if self._log_f is None:
                raise RuntimeError(
                    f"ChunkStore {self.directory} is closed — refusing to "
                    f"degrade to the in-memory backend")
            self._log_f.write(data)
            self._log_f.flush()
            self._idx_f.write(fp + struct.pack("<QQ", self._log_size, len(data)))
            self._idx_f.flush()
            self._index[fp] = (self._log_size, len(data))
            self._log_size += len(data)
            self._idx_size += self._IDX_ENTRY
        else:
            self._mem[fp] = data
            self._index[fp] = (0, len(data))
        return True

    def get(self, fp: bytes) -> bytes:
        if fp in self._mem:
            return self._mem[fp]
        if self.directory is not None and fp in self._index:
            if self._read_fd is None:
                raise RuntimeError(
                    f"ChunkStore {self.directory} is closed")
            off, size = self._index[fp]
            return os.pread(self._read_fd, size, off)
        raise KeyError(fp.hex())  # raises-ok: mapping protocol — every boundary caller wraps (Registry.serve_chunks, DedupStore restore paths)

    def sync(self) -> None:
        """fsync log then index, then atomically advance the clean marker —
        after this returns, every acknowledged ``put`` survives a host crash
        and is trusted without re-verification on the next open.  No-op for
        the memory backend."""
        if self._log_f is not None:
            self._log_f.flush()
            os.fsync(self._log_f.fileno())
            self._idx_f.flush()
            os.fsync(self._idx_f.fileno())
            self._write_marker()

    def _write_marker(self) -> None:
        tmp = self._clean_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<QQ", self._log_size, self._idx_size))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._clean_path)
        fsync_dir(self.directory)

    def compact(self, live: Iterable[bytes]) -> Tuple[int, int]:
        """Drop every chunk not in ``live`` and compact the log.

        Returns ``(dropped_chunks, reclaimed_bytes)``.  Crash-safe on the
        directory backend: live chunks are streamed into fsynced ``.new``
        log/idx files, the swap is committed by the durable
        ``chunks.compacting`` intent flag, and each rename is individually
        idempotent — :meth:`_finish_compaction` completes (or discards) a
        half-done compaction on the next open, so no crash window can mix
        old index entries with new log offsets.
        """
        live = set(live)
        dead = [fp for fp in self._index if fp not in live]
        if not dead:
            return 0, 0
        reclaimed = sum(self._index[fp][1] for fp in dead)
        if self.directory is None:
            for fp in dead:
                self._mem.pop(fp, None)
                del self._index[fp]
            return len(dead), reclaimed
        if self._log_f is None:
            raise RuntimeError(
                f"ChunkStore {self.directory} is closed — cannot compact")
        self._log_f.flush()                # stream from a settled log
        new_log_path = self._log_path + ".new"
        new_idx_path = self._idx_path + ".new"
        new_index: Dict[bytes, Tuple[int, int]] = {}
        off = 0
        with open(new_log_path, "wb") as lf, open(new_idx_path, "wb") as xf:
            # keep current log order (offset-ascending) for locality
            for fp, (o, s) in sorted(self._index.items(),
                                     key=lambda kv: kv[1][0]):
                if fp not in live:
                    continue
                lf.write(os.pread(self._read_fd, s, o))
                xf.write(fp + struct.pack("<QQ", off, s))
                new_index[fp] = (off, s)
                off += s
            lf.flush()
            os.fsync(lf.fileno())
            xf.flush()
            os.fsync(xf.fileno())
        # durable intent: from here on, recovery completes the swap
        with open(self._flag_path, "wb") as f:
            f.write(b"compact")
            f.flush()
            os.fsync(f.fileno())
        self._log_f.close()
        self._idx_f.close()
        os.close(self._read_fd)
        os.replace(new_log_path, self._log_path)
        os.replace(new_idx_path, self._idx_path)
        fsync_dir(self.directory)
        self._index = new_index
        self._log_size = off
        self._idx_size = len(new_index) * self._IDX_ENTRY
        self._write_marker()               # sized for the compacted files
        os.unlink(self._flag_path)
        self._log_f = open(self._log_path, "ab")
        self._idx_f = open(self._idx_path, "ab")
        self._read_fd = os.open(self._log_path, os.O_RDONLY)
        return len(dead), reclaimed

    def close(self) -> None:
        if self._log_f is not None:
            self.sync()
            self._log_f.close()
            self._idx_f.close()
            os.close(self._read_fd)
            self._log_f = self._idx_f = self._read_fd = None

    def chunk_size(self, fp: bytes) -> int:
        return self._index[fp][1]

    def n_chunks(self) -> int:
        return len(self._index)

    def stored_bytes(self) -> int:
        return sum(s for _, s in self._index.values())

    def fingerprints(self) -> Iterable[bytes]:
        return self._index.keys()

    def index_entries(self) -> List[Tuple[bytes, int, int]]:
        """``(fp, offset, size)`` for every stored chunk — offset ordering
        reflects append order, which restart warm-up uses as a recency
        proxy.  Offsets are 0 on the memory backend."""
        return [(fp, off, size) for fp, (off, size) in self._index.items()]


class DedupStore:
    """Client/registry-side deduplicated store: chunks + recipes + accounting.

    ``device`` is where :meth:`ingest` scans for chunk boundaries: gear
    chunking runs the CUDA kernel on ``"cuda"`` and its plain PyTorch version
    on ``"cpu"``.  Only :meth:`ingest` touches the device, so a registry's
    store, which never ingests raw bytes, never needs a card."""

    def __init__(self, directory: Optional[str] = None,
                 cdc_params: cdc.CDCParams = cdc.DEFAULT_PARAMS,
                 device: torch.device | str = "cuda"):
        self.chunks = ChunkStore(directory)
        self.recipes: Dict[str, Recipe] = {}
        self.cdc_params = cdc_params
        self.device = torch.device(device)
        # accounting
        self.ingested_bytes = 0
        self.new_chunk_bytes = 0
        self.dup_chunk_bytes = 0

    # -- ingest --------------------------------------------------------------

    def ingest(self, name: str, data: bytes) -> Recipe:
        """CDC-chunk ``data``, dedup-store new chunks, record the recipe."""
        fps: List[bytes] = []
        sizes: List[int] = []
        start = 0
        for end in self._boundaries(data):
            chunk = data[start:end]
            start = end
            fp = hashing.chunk_fingerprint(chunk)
            if self.chunks.put(fp, chunk):
                self.new_chunk_bytes += len(chunk)
            else:
                self.dup_chunk_bytes += len(chunk)
            fps.append(fp)
            sizes.append(len(chunk))
        self.ingested_bytes += len(data)
        recipe = Recipe(name=name, fps=fps, sizes=sizes)
        self.recipes[name] = recipe
        return recipe

    def _boundaries(self, data: bytes) -> List[int]:
        params = self.cdc_params
        if params.algorithm == "gear":
            return ops.chunk_boundaries_accelerated(data, params, self.device)
        if self.device.type != "cpu":
            raise ValueError(
                f"CDC algorithm {params.algorithm!r} has no kernel: only gear "
                f"chunking runs on {self.device}; use device='cpu' for the "
                f"host {params.algorithm} chunker")
        return cdc.chunk_boundaries(data, params)

    def ingest_chunks(self, name: str, fps: Sequence[bytes],
                      chunks: Dict[bytes, bytes],
                      sizes: Sequence[int],
                      verify: bool = True) -> Recipe:
        """Store pre-chunked data (pull path: only missing chunks provided).

        Before any mutation, coverage is checked — every fp must already be
        stored or provided in ``chunks`` — and with ``verify`` (default)
        each provided payload is hashed against its fingerprint.  A bad pull
        therefore fails *here* with a clear :class:`DeliveryError` and
        nothing half-committed, instead of surfacing later as an opaque
        ``KeyError`` in :meth:`restore`.  Callers whose transport already
        verified payloads (wire ``decode_chunk_batch`` does) pass
        ``verify=False`` to skip the second hash.
        """
        fps = list(fps)
        sizes = list(sizes)
        if len(fps) != len(sizes):
            raise DeliveryError(
                f"ingest {name}: {len(fps)} fingerprints but "
                f"{len(sizes)} sizes")
        missing = [fp for fp in fps
                   if fp not in chunks and not self.chunks.has(fp)]
        if missing:
            raise DeliveryError(
                f"ingest {name}: {len(missing)} chunk(s) neither provided "
                f"nor stored (first: {missing[0].hex()[:12]})")
        if verify:
            for fp in set(fps):
                data = chunks.get(fp)
                if data is not None and hashing.chunk_fingerprint(data) != fp:
                    raise DeliveryError(
                        f"ingest {name}: chunk {fp.hex()[:12]} payload does "
                        f"not hash to its fingerprint")
        for fp in fps:
            if fp in chunks:
                self.chunks.put(fp, chunks[fp])
        recipe = Recipe(name=name, fps=fps, sizes=sizes)
        self.recipes[name] = recipe
        return recipe

    # -- restore -------------------------------------------------------------

    def restore(self, name: str) -> bytes:
        recipe = self._recipe_for_restore(name)
        return b"".join(self._chunk_for_restore(name, fp)
                        for fp in recipe.fps)

    def restore_into(self, name: str, out: np.ndarray) -> None:
        """Zero-extra-copy restore into a preallocated uint8 buffer."""
        recipe = self._recipe_for_restore(name)
        off = 0
        for fp in recipe.fps:
            c = self._chunk_for_restore(name, fp)
            out[off:off + len(c)] = np.frombuffer(c, dtype=np.uint8)
            off += len(c)

    def _recipe_for_restore(self, name: str) -> "Recipe":
        recipe = self.recipes.get(name)
        if recipe is None:
            raise DeliveryError(f"restore: unknown recipe {name!r}")
        return recipe

    def _chunk_for_restore(self, name: str, fp: bytes) -> bytes:
        try:
            return self.chunks.get(fp)
        except KeyError:
            raise DeliveryError(
                f"restore {name}: chunk {fp.hex()[:12]} referenced by the "
                f"recipe is missing from the store") from None

    # -- accounting ----------------------------------------------------------

    def dedup_ratio(self) -> float:
        """raw ingested bytes / stored bytes (higher = better; Fig. 6/7)."""
        stored = self.chunks.stored_bytes()
        return self.ingested_bytes / stored if stored else 1.0

    def missing(self, fps: Iterable[bytes]) -> List[bytes]:
        return [fp for fp in fps if not self.chunks.has(fp)]

    def close(self) -> None:
        self.chunks.close()
