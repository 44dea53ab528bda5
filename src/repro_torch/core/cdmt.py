"""Content-Defined Merkle Tree (CDMT) — the paper's core contribution (Sec. IV).

A Merkle tree whose *internal-node* boundaries are content-defined, exactly as
CDC makes *chunk* boundaries content-defined.  Building a level, children are
appended to the open parent one at a time; after the parent holds at least
``window`` children, a rolling hash over the **last ``window`` child
fingerprints** is tested against a pattern rule (low ``rule_bits`` bits zero).
On a match the parent is "cut" (closed) — so parent extents are functions of
child *content*, not child *position*, and a chunk split/merge only perturbs
the O(height) path above the edit (Fig. 3).

Node identifiers remain Merkle-style — blake2b over the concatenation of ALL
child fingerprints — so the authentication-path property (Sec. III-B) and
content-addressed node sharing both hold.

Implements:
  * Algorithm 1 (build)  — ``CDMT.build``          O(N) expected
  * Algorithm 2 (compare) — ``compare`` / ``diff_chunks``  BFS with pruning
  * authentication paths over the variable-fanout structure
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import hashing


@dataclasses.dataclass(frozen=True)
class CDMTParams:
    window: int = 8          # rolling window of child fingerprints (paper: 8)
    rule_bits: int = 2       # boundary rule: low bits zero (paper: ~1/4 fanout)
    max_fanout: int = 64     # hard cap so adversarial content can't flatten the tree

    @property
    def rule_mask(self) -> int:
        return (1 << self.rule_bits) - 1


DEFAULT_PARAMS = CDMTParams()


@dataclasses.dataclass
class CDMTNode:
    fp: bytes
    children: Tuple[bytes, ...]     # () for leaves
    is_leaf: bool
    n_leaves: int                   # leaves under this node (for accounting)


@dataclasses.dataclass
class BuildStats:
    """Work accounting for one build: the paper's "indexing ≪ hashing" and
    the incremental path's O(changed-subtrees) claim are both statements
    about how many blake2b calls a push costs."""
    nodes_hashed: int = 0           # node-id fingerprints computed
    boundary_tests: int = 0         # rolling-window cut tests (also blake2b)
    nodes_created: int = 0          # nodes newly added to the store

    @property
    def hash_calls(self) -> int:
        return self.nodes_hashed + self.boundary_tests


class OverlayNodeStore:
    """Copy-on-write view over a base node store.

    Reads fall through to ``base``; writes land only in ``overlay``.  Lets a
    registry *verify* a push by building the claimed tree against the shared
    store without mutating it — on success the overlay (exactly the new
    nodes) is merged, on rejection it is dropped and the store is untouched.
    """

    __slots__ = ("base", "overlay")

    def __init__(self, base: Dict[bytes, CDMTNode]):
        self.base = base
        self.overlay: Dict[bytes, CDMTNode] = {}

    def __contains__(self, fp: bytes) -> bool:
        return fp in self.overlay or fp in self.base

    def __getitem__(self, fp: bytes) -> CDMTNode:
        node = self.overlay.get(fp)
        if node is not None:
            return node
        return self.base[fp]

    def __setitem__(self, fp: bytes, node: CDMTNode) -> None:
        if fp not in self.base:
            self.overlay[fp] = node

    def get(self, fp: bytes, default=None):
        node = self.overlay.get(fp)
        if node is not None:
            return node
        return self.base.get(fp, default)


def _window_matches(children: Sequence[bytes], params: CDMTParams) -> bool:
    """Rolling-window boundary test: blake2b over the last ``window`` child
    fps, low ``rule_bits`` bits zero.  Uses full blake2b (not a weaker rolling
    poly) because the window is tiny — ≤ window × 16 bytes per test."""
    w = children[-params.window:]
    h = hashing.node_fingerprint(w)
    return (h[-1] & params.rule_mask) == 0


def _make_parent(kids: Tuple[bytes, ...], hm, stats: Optional[BuildStats],
                 fallback: Optional[Dict[bytes, CDMTNode]] = None) -> bytes:
    """Close a parent over ``kids``: hash its id, intern it in the store.
    ``fallback`` resolves children reused from a parent tree that are not
    (yet) in ``hm`` — the incremental path's shared subtrees."""
    fp = hashing.node_fingerprint(kids)
    if stats is not None:
        stats.nodes_hashed += 1
    if fp not in hm:
        def _n_leaves(c: bytes) -> int:
            node = hm.get(c)
            if node is None and fallback is not None:
                node = fallback[c]
            return node.n_leaves
        hm[fp] = CDMTNode(fp=fp, children=kids, is_leaf=False,
                          n_leaves=sum(_n_leaves(c) for c in kids))
        if stats is not None:
            stats.nodes_created += 1
    return fp


def _build_level(children: Sequence[bytes], params: CDMTParams, hm,
                 stats: Optional[BuildStats],
                 fallback: Optional[Dict[bytes, CDMTNode]] = None
                 ) -> List[bytes]:
    """One full level pass of Algorithm 1 (lines 12–28)."""
    out: List[bytes] = []
    open_children: List[bytes] = []
    for i, child in enumerate(children):
        open_children.append(child)               # line 14–15: extend window
        is_last = i == len(children) - 1
        cut = False
        if len(open_children) >= params.window:
            if stats is not None:
                stats.boundary_tests += 1
            cut = _window_matches(open_children, params)       # line 17
        if len(open_children) >= params.max_fanout:
            cut = True
        if cut or is_last:                        # line 18 / lines 23–24
            out.append(_make_parent(tuple(open_children), hm, stats,
                                    fallback=fallback))
            open_children = []
    return out


class CDMT:
    """The CDMT index for one artifact version."""

    def __init__(self, params: CDMTParams = DEFAULT_PARAMS):
        self.params = params
        self.nodes: Dict[bytes, CDMTNode] = {}
        self.root: Optional[bytes] = None
        self.levels: List[List[bytes]] = []

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, leaf_fps: Sequence[bytes], params: CDMTParams = DEFAULT_PARAMS,
              node_store: Optional[Dict[bytes, CDMTNode]] = None,
              stats: Optional[BuildStats] = None) -> "CDMT":
        """Algorithm 1.  ``node_store`` (the hashmap ``hm`` of the paper) lets
        multiple versions share node objects — node-copying persistence falls
        out of content addressing: only nodes on changed paths are new."""
        t = cls(params=params)
        hm = node_store if node_store is not None else t.nodes
        if not leaf_fps:
            return t

        level: List[bytes] = []
        for fp in leaf_fps:                       # lines 4–10: insert leaves
            if fp not in hm:
                hm[fp] = CDMTNode(fp=fp, children=(), is_leaf=True, n_leaves=1)
                if stats is not None:
                    stats.nodes_created += 1
            t.nodes[fp] = hm[fp]
            level.append(fp)
        t.levels.append(list(level))

        while len(level) > 1:                     # lines 12–28: level passes
            level = _build_level(level, params, hm, stats)
            t.levels.append(list(level))
        t.root = level[0]
        t._adopt_reachable(hm)
        return t

    @classmethod
    def build_incremental(cls, parent: "CDMT", leaf_fps: Sequence[bytes],
                          params: Optional[CDMTParams] = None,
                          node_store: Optional[Dict[bytes, CDMTNode]] = None,
                          stats: Optional[BuildStats] = None) -> "CDMT":
        """Incremental Algorithm 1: reuse the parent version's unchanged
        content-defined subtrees, re-hashing only spans whose leaves changed.

        Because the cut rule is a deterministic function of (params, child
        sequence) alone, the result is **bit-identical** to
        ``CDMT.build(leaf_fps, params)`` — same levels, same root — while
        computing only O(k · depth · fanout) fingerprints for k changed
        leaves: per level, parents whose child spans lie in the unchanged
        prefix are reused directly; the edited span is re-cut; and as soon as
        a new cut lands on an old parent boundary inside the unchanged
        suffix, the build resynchronizes and reuses every remaining parent
        (the content-defined analogue of CDC's bounded chunk-shift, Fig. 3).

        Falls back to a full build when the parent is empty or was built
        with different params (its cut structure is incompatible).
        """
        if params is None:
            params = parent.params
        if parent.root is None or parent.params != params or not leaf_fps:
            return cls.build(leaf_fps, params=params, node_store=node_store,
                             stats=stats)
        t = cls(params=params)
        hm = node_store if node_store is not None else t.nodes

        level: List[bytes] = []
        for fp in leaf_fps:
            if fp not in hm:
                hm[fp] = CDMTNode(fp=fp, children=(), is_leaf=True, n_leaves=1)
                if stats is not None:
                    stats.nodes_created += 1
            level.append(fp)
        t.levels.append(list(level))

        li = 0
        while len(level) > 1:
            old_parents = (parent.levels[li + 1]
                           if li + 1 < len(parent.levels) else [])
            level = _rebuild_level(old_parents, level, params,
                                   hm, parent.nodes, stats)
            t.levels.append(list(level))
            li += 1
        t.root = level[0]
        t._adopt_reachable(hm, fallback=parent.nodes)
        return t

    def _adopt_reachable(self, hm,
                         fallback: Optional[Dict[bytes, CDMTNode]] = None
                         ) -> None:
        """Pull every node reachable from the root into ``self.nodes``
        (shared from ``hm``, or from ``fallback`` for subtrees reused from a
        parent tree) — pointer chasing only, no hashing."""
        if self.root is None or (hm is self.nodes and fallback is None):
            return
        stack = [self.root]
        seen: Set[bytes] = set()
        while stack:
            fp = stack.pop()
            if fp in seen:
                continue
            seen.add(fp)
            node = self.nodes.get(fp) or hm.get(fp)
            if node is None and fallback is not None:
                node = fallback[fp]
            self.nodes[fp] = node
            stack.extend(c for c in node.children if c not in seen)

    # ---------------------------------------------------------------- queries

    def node_set(self) -> Set[bytes]:
        return set(self.nodes.keys())

    def leaf_fps(self) -> List[bytes]:
        return list(self.levels[0]) if self.levels else []

    def height(self) -> int:
        return len(self.levels)

    def n_nodes(self) -> int:
        return len(self.nodes)

    def index_size_bytes(self) -> int:
        """Serialized index footprint (the paper: "~KBs")."""
        total = 0
        for n in self.nodes.values():
            total += len(n.fp) + sum(len(c) for c in n.children) + 2
        return total

    def authentication_path(self, leaf_fp: bytes) -> List[bytes]:
        """Sibling fps of every node on the path from ``leaf_fp`` to root."""
        # parent map (variable fanout ⇒ walk levels)
        parent: Dict[bytes, bytes] = {}
        for lvl in self.levels[1:]:
            for pfp in lvl:
                for c in self.nodes[pfp].children:
                    parent[c] = pfp
        path: List[bytes] = []
        cur = leaf_fp
        while cur != self.root:
            p = parent[cur]
            path.extend(c for c in self.nodes[p].children if c != cur)
            cur = p
        return path


_MAX_REUSE_CANDIDATES = 8     # bound probing under degenerate duplicate content


def _rebuild_level(old_parents: Sequence[bytes],
                   new_children: Sequence[bytes],
                   params: CDMTParams, hm,
                   parent_nodes: Dict[bytes, CDMTNode],
                   stats: Optional[BuildStats]) -> List[bytes]:
    """One level of the incremental build.

    Correctness rests on one property of the cut rule: a cut decision
    depends only on the children of the *currently open* parent (the rolling
    window never crosses a cut, and ``max_fanout`` counts from the parent
    start).  So whenever the build stands at a fresh parent start and the
    upcoming children exactly equal some old parent's child sequence, the
    full build would reproduce that parent verbatim — no early cut inside it
    (the same window tests failed when the old level was built) and the same
    close at its end — provided the old close was itself content-defined.
    Old parents that were not the last of their level necessarily closed on
    a cut, so only reuse of a level's *final* parent needs a window re-test.

    This is position-independent, so the build resynchronizes right after
    every edited span (not just around a single edit): k scattered leaf
    changes cost O(k · fanout) fingerprints per level, while unchanged runs
    cost only cheap sequence comparisons.
    """
    if not old_parents:
        return _build_level(new_children, params, hm, stats,
                            fallback=parent_nodes)
    n_new = len(new_children)

    # reuse candidates: first-child fp -> [(old parent fp, children, interior)]
    cand: Dict[bytes, List[Tuple[bytes, Tuple[bytes, ...], bool]]] = {}
    seen_kids: Set[Tuple[bytes, ...]] = set()
    last = len(old_parents) - 1
    for i, pfp in enumerate(old_parents):
        node = parent_nodes.get(pfp)
        if node is None:
            node = hm[pfp]
        kids = node.children
        if kids and kids not in seen_kids:
            seen_kids.add(kids)
            lst = cand.setdefault(kids[0], [])
            if len(lst) < _MAX_REUSE_CANDIDATES:
                lst.append((pfp, kids, i < last))

    out: List[bytes] = []
    open_children: List[bytes] = []
    j = 0
    while j < n_new:
        if not open_children:                      # at a fresh parent start
            reused = None
            for pfp, kids, interior in cand.get(new_children[j], ()):
                w = len(kids)
                if tuple(new_children[j:j + w]) != kids:
                    continue
                if j + w < n_new and not interior:
                    # old level's final parent: closed by end-of-level, which
                    # recurs here only if the close was also a content cut
                    cut = w >= params.max_fanout
                    if not cut and w >= params.window:
                        if stats is not None:
                            stats.boundary_tests += 1
                        cut = _window_matches(kids, params)
                    if not cut:
                        continue
                reused = (pfp, w)
                break
            if reused is not None:
                out.append(reused[0])
                j += reused[1]
                continue
        open_children.append(new_children[j])
        is_last = j == n_new - 1
        cut = False
        if len(open_children) >= params.window:
            if stats is not None:
                stats.boundary_tests += 1
            cut = _window_matches(open_children, params)
        if len(open_children) >= params.max_fanout:
            cut = True
        if cut or is_last:
            out.append(_make_parent(tuple(open_children), hm, stats,
                                    fallback=parent_nodes))
            open_children = []
        j += 1
    return out


# -------------------------------------------------------------------- compare

def iter_missing_leaves(client: Optional[CDMT], server: CDMT,
                        on_compare=None):
    """Streaming Algorithm 2 — BFS over the server tree, pruning subtrees
    whose node id the client already has, yielding missing leaf fps *as the
    walk discovers them* (deduplicated) so transfer can overlap comparison.

    ``on_compare`` is invoked once per node comparison (accounting hook).
    With ``client=None`` (fresh pull of a new image) every leaf is missing
    and zero comparisons are needed — the paper's "push of a new image" case.
    """
    if server.root is None:
        return
    yielded: Set[bytes] = set()
    if client is None:
        for fp in server.leaf_fps():
            if fp not in yielded:
                yielded.add(fp)
                yield fp
        return
    have = client.node_set()
    queue: "deque[bytes]" = deque([server.root])
    while queue:                                    # lines 3–11
        fp = queue.popleft()
        if on_compare is not None:
            on_compare()
        if fp in have:                              # subtree shared: prune
            continue
        node = server.nodes[fp]
        if node.children:                           # line 5–6: descend
            queue.extend(node.children)
        elif fp not in yielded:                     # line 8: yield leaf
            yielded.add(fp)
            yield fp


def compare(client: Optional[CDMT], server: CDMT) -> Tuple[Set[bytes], int]:
    """Algorithm 2 — returns (leaf fps the client is MISSING, number of node
    comparisons performed).  Set-materialized form of
    :func:`iter_missing_leaves` (the single BFS implementation)."""
    comparisons = [0]

    def tick():
        comparisons[0] += 1

    missing = set(iter_missing_leaves(client, server, on_compare=tick))
    return missing, comparisons[0]


def diff_chunks(old: Optional[CDMT], new: CDMT) -> Set[bytes]:
    """Leaf fingerprints present in ``new`` but not detectable via ``old``."""
    return compare(old, new)[0]


def common_node_ratio(a: CDMT, b: CDMT) -> float:
    """|shared node ids| / |nodes of b| — CDMT side of Fig. 8."""
    if not b.nodes:
        return 1.0
    return len(a.node_set() & b.node_set()) / len(b.nodes)


def comparison_ratio(client: CDMT, server: CDMT) -> float:
    """Fig. 9 metric: comparisons via CDMT ÷ comparisons via flat key-value
    lookup (= number of server leaves).  < 1 ⇒ authentication-path pruning
    is saving work."""
    n_leaves = len(server.leaf_fps())
    if n_leaves == 0:
        return 0.0
    _, comps = compare(client, server)
    return comps / n_leaves
