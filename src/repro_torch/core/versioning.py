"""Versioned CDMT maintenance (paper Sec. V-A).

Two forms of versioning, both kept inside ONE index per artifact lineage:

* **Layering (COW)** — successive committed versions of the *same* branch
  (paper: new file versions in upper layers).  Realized as a per-node
  *modification history*: each logical node slot records (version → fp), so a
  traversal at version v resolves each slot to its hash at v.  Access slowdown
  is O(log m) in the number of modifications, as the paper analyzes — we store
  the history sorted and bisect.
* **Branching** — user-visible forks (tagged images / fine-tune forks).
  Realized by **node-copying**: because node ids are content-addressed, a new
  version's tree shares every unchanged subtree with its parent by
  construction; only the changed root-to-leaf paths materialize new nodes.
  The lineage keeps an **array of roots** (paper: "array of roots where each
  root corresponds to a 'taggable' container branch").

The shared ``node_store`` dict is the hashmap ``hm`` of Algorithm 1 — it is
what makes node-copying free.

Commits are **incremental**: :meth:`VersionedCDMT.commit` builds the new
version's tree with :meth:`CDMT.build_incremental` against the parent
version's tree, re-hashing only content-defined subtrees whose leaves
changed.  :meth:`VersionedCDMT.build_next` exposes the same build *without
mutating the lineage* (new nodes land in a copy-on-write overlay) so a
registry can verify a claimed root before committing anything.

Tag semantics: a tag binds exactly one root, forever.  Re-committing a tag
with the same root is idempotent (returns the existing record — what makes
journal replay after a partial compaction safe); re-committing it with a
different root raises ``ValueError`` instead of silently rebinding the tag
and leaving a duplicate in ``tags()``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .cdmt import (BuildStats, CDMT, CDMTNode, CDMTParams, DEFAULT_PARAMS,
                   OverlayNodeStore, compare)

_TREE_CACHE_MAX = 4     # reconstructed-version cache (head + recent parents)


@dataclasses.dataclass
class VersionRecord:
    version: int
    tag: str
    root: bytes
    parent: Optional[int]          # parent version number (branch point)
    n_leaves: int
    new_nodes: int                 # nodes materialized by this version


class VersionedCDMT:
    """A lineage of CDMT versions over a shared node store."""

    def __init__(self, params: CDMTParams = DEFAULT_PARAMS):
        self.params = params
        self.node_store: Dict[bytes, CDMTNode] = {}  # guarded-by: external(lineages live inside a Registry; RegistryServer._registry_lock serializes access)
        self.roots: List[VersionRecord] = []           # guarded-by: external(RegistryServer._registry_lock)
        self._by_tag: Dict[str, int] = {}  # guarded-by: external(RegistryServer._registry_lock)
        # layering modification history: slot-path -> sorted [(version, fp)].
        # Rebuilt deterministically from journaled commit records on
        # recovery, so branch-at-version queries survive restart (see
        # resolve_at / Registry.branch_root_at and the durability tests).
        self.mod_history: Dict[bytes, List[Tuple[int, bytes]]] = {}  # guarded-by: external(RegistryServer._registry_lock)
        # small cache of reconstructed trees; the head stays warm so the next
        # incremental commit never pays an O(n) reconstruction
        self._tree_cache: Dict[int, CDMT] = {}

    # ------------------------------------------------------------------ write

    def build_next(self, leaf_fps: Sequence[bytes],
                   parent: Optional[int] = None
                   ) -> Tuple[CDMT, Dict[bytes, CDMTNode], BuildStats]:
        """Build the tree a commit of ``leaf_fps`` would produce — WITHOUT
        mutating the lineage.  New nodes land in a copy-on-write overlay over
        ``node_store``; returns ``(tree, overlay_nodes, stats)``.  On a
        verification failure the caller simply drops the overlay and the
        lineage is untouched; on success it hands both back to
        :meth:`commit`, which merges O(new nodes) and rebuilds nothing."""
        stats = BuildStats()
        overlay = OverlayNodeStore(self.node_store)
        if parent is None:
            parent = self.head_version()
        parent_tree = None
        if parent is not None and leaf_fps:
            parent_tree = self.get_version(parent)
        if parent_tree is not None and parent_tree.root is not None:
            tree = CDMT.build_incremental(parent_tree, leaf_fps,
                                          params=self.params,
                                          node_store=overlay, stats=stats)
        else:
            tree = CDMT.build(leaf_fps, params=self.params,
                              node_store=overlay, stats=stats)
        return tree, overlay.overlay, stats

    def commit(self, leaf_fps: Sequence[bytes], tag: str,
               parent: Optional[int] = None,
               tree: Optional[CDMT] = None,
               new_nodes: Optional[Dict[bytes, CDMTNode]] = None
               ) -> VersionRecord:
        """Commit a new version (push of a committed image).  Node-copying:
        only nodes absent from the shared store are created, and the build
        is incremental against the parent version's tree.

        ``tree`` lets a caller that already built this version's CDMT with
        identical params (e.g. registry push verification via
        :meth:`build_next`) donate it instead of rebuilding; with
        ``new_nodes`` (the overlay from :meth:`build_next`) the merge is
        O(new nodes) instead of O(tree).
        """
        if parent is None and self.roots:
            parent = self.roots[-1].version
        if tree is None:
            tree, new_nodes, _ = self.build_next(leaf_fps, parent)
        existing = self._by_tag.get(tag)
        if existing is not None:
            rec = self.roots[existing]
            if rec.root == tree.root:
                return rec                 # idempotent re-commit of the tag
            raise ValueError(
                f"tag {tag!r} is already bound to version {existing} with a "
                f"different root — re-binding would orphan it; commit under "
                f"a new tag")
        created = 0
        merge = new_nodes if new_nodes is not None else tree.nodes
        for fp, node in merge.items():
            if fp not in self.node_store:
                self.node_store[fp] = node
                created += 1
        version = len(self.roots)
        rec = VersionRecord(version=version, tag=tag, root=tree.root,
                            parent=parent, n_leaves=len(leaf_fps),
                            new_nodes=created)
        self.roots.append(rec)
        self._by_tag[tag] = version
        # layering history: record the root evolution per branch head
        hist = self.mod_history.setdefault(b"root:" + tag.split("@")[0].encode(), [])
        hist.append((version, tree.root))
        self._remember(version, tree)
        return rec

    # ------------------------------------------------------------------- read

    def head_version(self) -> Optional[int]:
        return self.roots[-1].version if self.roots else None

    def version_of(self, tag: str) -> Optional[int]:
        return self._by_tag.get(tag)

    def get_version(self, version: int) -> CDMT:
        """The CDMT of a version: cached for recent versions, otherwise
        reconstructed in time linear in tree size (paper Sec. I: 'a given
        version ... obtained in linear time').  Returned trees are shared —
        treat them as immutable."""
        cached = self._tree_cache.get(version)
        if cached is not None:
            return cached
        tree = self._reconstruct(version)
        self._remember(version, tree)
        return tree

    def _reconstruct(self, version: int) -> CDMT:
        rec = self.roots[version]
        t = CDMT(params=self.params)
        if rec.root is None:
            return t
        stack = [rec.root]
        seen: Set[bytes] = set()
        while stack:
            fp = stack.pop()
            if fp in seen:
                continue
            seen.add(fp)
            node = self.node_store[fp]
            t.nodes[fp] = node
            stack.extend(node.children)
        t.root = rec.root
        t.levels = _levels_from_root(t)
        return t

    def _remember(self, version: int, tree: CDMT) -> None:
        self._tree_cache[version] = tree
        while len(self._tree_cache) > _TREE_CACHE_MAX:
            self._tree_cache.pop(next(iter(self._tree_cache)))

    def get_tag(self, tag: str) -> CDMT:
        return self.get_version(self._by_tag[tag])

    def resolve_at(self, slot: bytes, version: int) -> Optional[bytes]:
        """Layering lookup: the fp a slot held at ``version`` — O(log m)."""
        hist = self.mod_history.get(slot)
        if not hist:
            return None
        idx = bisect.bisect_right(hist, (version, b"\xff" * 32)) - 1
        return hist[idx][1] if idx >= 0 else None

    def branch_root_at(self, branch: str, version: int) -> Optional[bytes]:
        """Branch-at-version query: the root the branch head ``branch`` had
        at ``version`` (tags follow the ``branch@rev`` convention; the part
        before ``@`` names the branch).  ``None`` if the branch had no
        commit at or before ``version``.

        Durable by construction: ``mod_history`` is re-derived from the
        journaled commit records on recovery, so the answer is identical
        before and after a restart or a snapshot compaction.
        """
        return self.resolve_at(b"root:" + branch.encode("utf-8"), version)

    def branch_history(self, branch: str) -> List[Tuple[int, bytes]]:
        """Full ``[(version, root)]`` evolution of one branch head, in
        version order (a copy; safe to hold across later commits)."""
        return list(self.mod_history.get(
            b"root:" + branch.encode("utf-8"), []))

    def diff(self, old_version: Optional[int], new_version: int) -> Set[bytes]:
        """Leaf fps in ``new`` missing from ``old`` (Algorithm 2)."""
        old = self.get_version(old_version) if old_version is not None else None
        new = self.get_version(new_version)
        return compare(old, new)[0]

    # ------------------------------------------------------------- accounting

    def total_nodes(self) -> int:
        return len(self.node_store)

    def version_records(self) -> List[VersionRecord]:
        return list(self.roots)

    def tags(self) -> List[str]:
        return [r.tag for r in self.roots]


def _levels_from_root(t: CDMT) -> List[List[bytes]]:
    """Recover bottom-up levels for a tree reconstructed from a node store."""
    if t.root is None:
        return []
    levels_down: List[List[bytes]] = [[t.root]]
    while True:
        nxt: List[bytes] = []
        for fp in levels_down[-1]:
            nxt.extend(t.nodes[fp].children)
        if not nxt:
            break
        levels_down.append(nxt)
    return list(reversed(levels_down))
