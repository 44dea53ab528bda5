"""Core library: the paper's contribution.

Content-defined chunking (CDC), the baseline Merkle tree, the Content-Defined
Merkle Tree (CDMT) index, node-copy versioning, deduplicated storage, the
registry, and chunk-granular push/pull protocols.
"""

from . import cdc, cdmt, hashing, merkle, pushpull, registry, store, versioning
from .cdc import CDCParams, chunk_boundaries, chunk_bytes
from .cdmt import CDMT, CDMTParams, compare, diff_chunks
from .merkle import MerkleTree
from .pushpull import Client, WireStats
from .registry import Registry, SweepReport
from .store import DedupStore, Recipe
from .versioning import VersionedCDMT

__all__ = [
    "cdc", "cdmt", "hashing", "merkle", "pushpull", "registry", "store",
    "versioning", "CDCParams", "chunk_boundaries", "chunk_bytes", "CDMT",
    "CDMTParams", "compare", "diff_chunks", "MerkleTree", "Client",
    "WireStats", "Registry", "SweepReport", "DedupStore", "Recipe",
    "VersionedCDMT",
]
