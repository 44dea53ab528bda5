"""Fingerprints for chunks and CDMT nodes.

The paper uses Blake2b (RFC 7693) for chunk and internal-node hashes
(Sec. IV, VI-D).  We keep blake2b for all *identifiers* (dedup correctness
depends on it) and expose a truncated digest size — the paper notes the index
is ~KBs, and 16-byte digests keep it that way without meaningful collision
risk at registry scale (2^64 birthday bound).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List

DIGEST_SIZE = 16  # bytes


def chunk_fingerprint(data: bytes) -> bytes:
    """blake2b fingerprint of a data chunk (leaf node id)."""
    return hashlib.blake2b(data, digest_size=DIGEST_SIZE).digest()


def node_fingerprint(child_hashes: Iterable[bytes]) -> bytes:
    """blake2b over the concatenation of child hashes (internal node id)."""
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    for c in child_hashes:
        h.update(c)
    return h.digest()


def checksum(data: bytes, size: int = 8) -> bytes:
    """Short blake2b integrity checksum (journal/wire records).  Not an
    identifier — dedup never keys on it — so a shorter digest is fine: it
    only needs to catch torn writes and bit rot."""
    return hashlib.blake2b(data, digest_size=size).digest()


def fingerprint_many(chunks: Iterable[bytes]) -> List[bytes]:
    return [chunk_fingerprint(c) for c in chunks]


def hex_short(fp: bytes, n: int = 8) -> str:
    return fp.hex()[:n]
