"""Chunk-granular push/pull protocols (paper Sec. V, items 1–2).

The client holds a ``DedupStore`` + its own CDMT per lineage; the registry is
``repro_torch.core.registry.Registry``.  Both operations exchange the KB-sized CDMT
index first, run Algorithm 2 locally, and move only the missing chunks.

As of the unified delivery API, :class:`Client` is a thin compatibility shim:
all compare/transfer/accounting logic lives in
:class:`repro_torch.delivery.client.ImageClient`, which this class drives through a
:class:`repro_torch.delivery.transport.LocalTransport` bound to the target
registry.  ``WireStats`` remains the base accounting dataclass; the values
returned by :meth:`Client.push`/:meth:`Client.pull` are
:class:`repro_torch.delivery.plan.TransferReport` instances (a ``WireStats``
subclass adding per-source legs), so existing callers keep working.

Layering note: ``repro_torch.delivery`` depends on this module at import time
(``plan``/``delta`` import :class:`WireStats`/:class:`Client`), so the
delivery imports here happen lazily inside methods — the one deliberate
upward reference from core to the delivery layer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from . import cdc
from .cdmt import CDMT, CDMTParams, DEFAULT_PARAMS
from .registry import Registry
from .store import DedupStore, Recipe


@dataclasses.dataclass
class WireStats:
    op: str
    lineage: str
    tag: str
    chunk_bytes: int = 0          # payload chunks moved
    index_bytes: int = 0          # CDMT index moved
    recipe_bytes: int = 0         # recipe (fp list) moved
    chunks_moved: int = 0
    chunks_total: int = 0         # chunks in the artifact
    raw_bytes: int = 0            # full artifact size (what naive transfer costs)
    comparisons: int = 0

    @property
    def total_wire_bytes(self) -> int:
        return self.chunk_bytes + self.index_bytes + self.recipe_bytes

    @property
    def savings_vs_raw(self) -> float:
        return 1.0 - self.total_wire_bytes / self.raw_bytes if self.raw_bytes else 0.0


class Client:
    """A client node: local dedup store + local CDMT per lineage.

    Compatibility shim over :class:`repro_torch.delivery.client.ImageClient` —
    each ``push``/``pull`` binds the shared local state to a
    ``LocalTransport`` for the given registry and delegates.
    """

    def __init__(self, cdc_params: cdc.CDCParams = cdc.DEFAULT_PARAMS,
                 cdmt_params: CDMTParams = DEFAULT_PARAMS,
                 directory: Optional[str] = None,
                 device: str = "cuda"):
        from repro_torch.delivery.client import ImageClient   # lazy: layering note
        self._ic = ImageClient(None, device=device, cdc_params=cdc_params,
                               cdmt_params=cdmt_params, directory=directory)
        self.store: DedupStore = self._ic.store
        self.cdmt_params = cdmt_params
        self.indexes: Dict[str, CDMT] = self._ic.indexes  # lineage -> CDMT
        self.tag_trees: Dict[str, CDMT] = self._ic.tag_trees
        self.log: List[WireStats] = []

    def _bound(self, registry: Registry):
        from repro_torch.delivery.transport import LocalTransport  # lazy: layering
        return self._ic.bind(LocalTransport(registry))

    # ---------------------------------------------------------------- commit

    def commit(self, lineage: str, tag: str, data: bytes) -> Recipe:
        """Chunk + locally store a new artifact version, build local CDMT."""
        return self._ic.commit(lineage, tag, data)

    def index_for_tag(self, lineage: str, tag: str) -> CDMT:
        """The CDMT for a committed tag — served from the per-tag tree cache
        (built incrementally against the head on a cold non-head tag)."""
        return self._ic.index_for_tag(lineage, tag)

    # ------------------------------------------------------------------ push

    def push(self, registry: Registry, lineage: str, tag: str,
             parent_version: Optional[int] = None) -> WireStats:
        """Push the last committed version of ``lineage``.

        New image  → ship all chunks + index (paper push case 1).
        Committed  → fetch registry's latest CDMT, Alg. 2 diff, ship only
                     changed chunks + the new index (paper push case 2).
        """
        stats = self._bound(registry).push(lineage, tag,
                                           parent_version=parent_version)
        self.log.append(stats)
        return stats

    # ------------------------------------------------------------------ pull

    def pull(self, registry: Registry, lineage: str, tag: str) -> WireStats:
        """Pull a version: download its CDMT, Alg. 2 against local CDMT,
        fetch only missing chunks, reconstruct via the recipe."""
        stats = self._bound(registry).pull(lineage, tag)
        self.log.append(stats)
        return stats

    def materialize(self, lineage: str, tag: str) -> bytes:
        return self.store.restore(f"{lineage}:{tag}")


def naive_pull_bytes(recipe: Recipe) -> int:
    """What a no-index pull costs: every chunk moves (the >40% baseline)."""
    return recipe.total_size


def merkle_pull_chunk_bytes(client_tree, server_tree, recipe: Recipe,
                            store: DedupStore) -> Tuple[int, int]:
    """Chunk bytes a *plain Merkle* index would move: leaves not detected as
    shared (chunk-shift makes this large) — used by bench_pushpull_io."""
    from .merkle import compare_trees
    shared, comps = compare_trees(client_tree, server_tree)
    moved = 0
    for fp, size in zip(recipe.fps, recipe.sizes):
        if fp not in shared:
            moved += size
    return moved, comps
