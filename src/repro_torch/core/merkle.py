"""Baseline k-ary Merkle tree (the paper's comparison point, Sec. III-B/C).

A *complete* k-ary tree over a list of leaf fingerprints: internal node id =
blake2b over the concatenation of its (up to) k children's ids.  This is the
structure the paper shows to be brittle under the **chunk-shift problem**
(Sec. III-C): when CDC splits or merges a chunk, every node to the right of
the edit changes child-positions, so nearly all internal node ids change and
tree comparison degenerates to "everything differs".

We keep it deliberately faithful (position-sensitive, fixed fan-out) so the
benchmarks reproduce Fig. 8's contrast with CDMT.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import hashing


@dataclasses.dataclass
class MerkleNode:
    fp: bytes                       # fingerprint (node id)
    children: Tuple[bytes, ...]     # child fingerprints ('' for leaves)
    is_leaf: bool

    @property
    def key(self) -> bytes:
        return self.fp


class MerkleTree:
    """Complete k-ary Merkle tree over leaf fingerprints."""

    def __init__(self, k: int = 4):
        self.k = k
        self.nodes: Dict[bytes, MerkleNode] = {}
        self.root: Optional[bytes] = None
        self.levels: List[List[bytes]] = []   # bottom-up, levels[0] = leaves

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, leaf_fps: Sequence[bytes], k: int = 4) -> "MerkleTree":
        t = cls(k=k)
        if not leaf_fps:
            return t
        level = []
        for fp in leaf_fps:
            node = MerkleNode(fp=fp, children=(), is_leaf=True)
            t.nodes[fp] = node
            level.append(fp)
        t.levels.append(list(level))
        while len(level) > 1:
            nxt: List[bytes] = []
            for i in range(0, len(level), k):
                kids = tuple(level[i:i + k])
                fp = hashing.node_fingerprint(kids)
                t.nodes[fp] = MerkleNode(fp=fp, children=kids, is_leaf=False)
                nxt.append(fp)
            t.levels.append(list(nxt))
            level = nxt
        t.root = level[0]
        return t

    # -- queries -------------------------------------------------------------

    def node_set(self) -> Set[bytes]:
        return set(self.nodes.keys())

    def leaf_fps(self) -> List[bytes]:
        return list(self.levels[0]) if self.levels else []

    def height(self) -> int:
        return len(self.levels)

    def authentication_path(self, leaf_index: int) -> List[bytes]:
        """Siblings of every node on the leaf→root path (Sec. III-B, Fig. 1)."""
        path: List[bytes] = []
        idx = leaf_index
        for lvl in range(len(self.levels) - 1):
            group = idx // self.k * self.k
            for j in range(group, min(group + self.k, len(self.levels[lvl]))):
                if j != idx:
                    path.append(self.levels[lvl][j])
            idx //= self.k
        return path


def compare_trees(a: MerkleTree, b: MerkleTree) -> Tuple[Set[bytes], int]:
    """Common-node detection by id intersection with top-down pruning.

    Returns (set of *leaf* fps of ``b`` detected as shared with ``a``,
    number of node comparisons performed).  A subtree of ``b`` whose root id
    appears anywhere in ``a`` is entirely shared (Merkle property) and is
    pruned without descending.
    """
    if b.root is None:
        return set(), 0
    a_ids = a.node_set()
    shared: Set[bytes] = set()
    comparisons = 0
    stack = [b.root]
    while stack:
        fp = stack.pop()
        comparisons += 1
        node = b.nodes[fp]
        if fp in a_ids:
            # whole subtree shared: collect its leaves without comparing.
            sub = [fp]
            while sub:
                sfp = sub.pop()
                snode = b.nodes[sfp]
                if snode.is_leaf:
                    shared.add(sfp)
                else:
                    sub.extend(snode.children)
            continue
        if not node.is_leaf:
            stack.extend(node.children)
    return shared, comparisons


def common_node_ratio(a: MerkleTree, b: MerkleTree) -> float:
    """|shared internal+leaf node ids| / |nodes of b| — the Fig. 8 metric."""
    if not b.nodes:
        return 1.0
    inter = a.node_set() & b.node_set()
    return len(inter) / len(b.nodes)


def positional_compare(a: MerkleTree, b: MerkleTree):
    """The paper's Merkle comparison semantics (Sec. III-B/C): nodes are
    compared via authentication paths, i.e. POSITIONALLY — node (level, i)
    of ``b`` against node (level, i) of ``a``.  A chunk shift misaligns
    every position right of the edit, so those chunks are reported changed
    even when their hashes exist elsewhere in ``a`` (the "falsely claims
    all chunk nodes as changed" failure).

    Returns (set of b's leaf fps detected shared, comparisons performed).
    Pruning: when positions match, the whole subtree is skipped.
    """
    if b.root is None:
        return set(), 0
    if a.root is None:
        return set(), 1
    shared = set()
    comparisons = 0
    # walk top-down by (level, index) pairs; levels are bottom-up lists
    la, lb = len(a.levels), len(b.levels)
    stack = [(lb - 1, 0)]                      # (level in b, index)
    while stack:
        lvl, idx = stack.pop()
        comparisons += 1
        a_lvl = lvl + (la - lb)                # align roots
        fp_b = b.levels[lvl][idx]
        fp_a = None
        if 0 <= a_lvl < la and idx < len(a.levels[a_lvl]):
            fp_a = a.levels[a_lvl][idx]
        if fp_a == fp_b:
            # identical subtree at identical position: all leaves shared
            sub = [fp_b]
            while sub:
                f = sub.pop()
                n = b.nodes[f]
                if n.is_leaf:
                    shared.add(f)
                else:
                    sub.extend(n.children)
            continue
        node = b.nodes[fp_b]
        if not node.is_leaf:
            base = idx * b.k
            for j, _ in enumerate(node.children):
                stack.append((lvl - 1, base + j))
    return shared, comparisons
