"""Retained per-element reference implementations (pre-vectorization).

The port of `repro.core.reference`: the seed's pure-Python loop versions of
tree construction, dual traversal, LET extraction and body padding, kept
verbatim over the port's `Tree` and `LETData` so the frontier-vectorized
rewrites in `tree.py`, `traversal.py`, `let.py` and `plan.py` stay pinned by
golden-equivalence tests (identical pair sets, identical LET contents).

Do not optimise this module — its value is being the slow, obviously-correct
baseline.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.let import LETData
from repro_torch.core.tree import Tree, _morton_sort

__all__ = [
    "reference_build_tree",
    "reference_dual_traversal",
    "reference_extract_let",
    "reference_pad_bodies",
    "reference_padded_leaf_bodies",
]


def reference_build_tree(x: np.ndarray, q: np.ndarray, ncrit: int = 64,
                         max_depth: int = 21, bbox=None) -> Tree:
    """Seed `build_tree`: per-cell split stack + per-cell bbox loop."""
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n = len(x)
    xs, qs, keys, order, depth = _morton_sort(x, q, max_depth=max_depth, bbox=bbox)

    parent, child_start, n_child = [0], [0], [0]
    body_start, n_body, level = [0], [n], [0]
    # recursion over (cell, body range, depth); children appended breadth-last
    stack = [(0, 0, n, 0)]
    while stack:
        cid, s, e, lvl = stack.pop()
        body_start[cid], n_body[cid] = s, e - s
        if e - s <= ncrit or lvl >= depth:
            continue
        # split by the 3-bit Morton digit at this level
        shift = 3 * (depth - lvl - 1)
        digits = (keys[s:e] >> np.uint64(shift)) & np.uint64(7)
        counts = np.bincount(digits.astype(np.int64), minlength=8)
        first_child = len(parent)
        nc = 0
        off = s
        for oct_ in range(8):
            c = counts[oct_]
            if c == 0:
                continue
            parent.append(cid)
            child_start.append(0)
            n_child.append(0)
            body_start.append(off)
            n_body.append(c)
            level.append(lvl + 1)
            stack.append((first_child + nc, off, off + c, lvl + 1))
            nc += 1
            off += c
        child_start[cid], n_child[cid] = first_child, nc

    C = len(parent)
    bmin = np.empty((C, 3))
    bmax = np.empty((C, 3))
    for c in range(C):
        s, nb = body_start[c], n_body[c]
        pts = xs[s:s + nb]
        bmin[c] = pts.min(axis=0)
        bmax[c] = pts.max(axis=0)
    centerc = (bmin + bmax) / 2
    radius = 0.5 * np.linalg.norm(bmax - bmin, axis=1)
    return Tree(
        x=xs, q=qs, perm=order,
        parent=np.asarray(parent, dtype=np.int64),
        child_start=np.asarray(child_start, dtype=np.int64),
        n_child=np.asarray(n_child, dtype=np.int64),
        body_start=np.asarray(body_start, dtype=np.int64),
        n_body=np.asarray(n_body, dtype=np.int64),
        center=centerc, radius=radius, bbox_min=bmin, bbox_max=bmax,
        level=np.asarray(level, dtype=np.int64), ncrit=ncrit,
    )


def reference_dual_traversal(tgt_tree, src_tree, theta: float = 0.5,
                             with_m2p: bool = False):
    """Seed `dual_traversal`: explicit per-pair Python stack."""
    m2l, p2p, m2p = [], [], []
    tc, tr = tgt_tree.center, tgt_tree.radius
    sc, sr = src_tree.center, src_tree.radius
    t_leaf, s_leaf = tgt_tree.is_leaf, src_tree.is_leaf
    truncated = getattr(src_tree, "truncated", None)
    if truncated is None:
        truncated = np.zeros(len(sc), dtype=bool)
    stack = [(0, 0)]
    while stack:
        a, b = stack.pop()
        d = np.linalg.norm(tc[a] - sc[b])
        if (tr[a] + sr[b]) < theta * d:
            m2l.append((a, b))
            continue
        if t_leaf[a] and s_leaf[b]:
            if truncated[b]:
                m2p.append((a, b))
            else:
                p2p.append((a, b))
            continue
        # split the larger cell (or the only splittable one)
        split_target = (not t_leaf[a]) and (s_leaf[b] or tr[a] >= sr[b])
        if split_target:
            cs, nc = tgt_tree.child_start[a], tgt_tree.n_child[a]
            for c in range(cs, cs + nc):
                stack.append((c, b))
        else:
            cs, nc = src_tree.child_start[b], src_tree.n_child[b]
            for c in range(cs, cs + nc):
                stack.append((a, c))
    m2l = np.asarray(m2l, dtype=np.int64).reshape(-1, 2)
    p2p = np.asarray(p2p, dtype=np.int64).reshape(-1, 2)
    m2p = np.asarray(m2p, dtype=np.int64).reshape(-1, 2)
    if with_m2p:
        return m2l, p2p, m2p
    assert len(m2p) == 0, "truncated source cells require with_m2p=True"
    return m2l, p2p


def _dist_point_box(p: np.ndarray, box_lo: np.ndarray, box_hi: np.ndarray) -> float:
    d = np.maximum(np.maximum(box_lo - p, p - box_hi), 0.0)
    return float(np.linalg.norm(d))


def reference_extract_let(tree: Tree, M: np.ndarray, box_lo, box_hi,
                          theta: float = 0.5) -> LETData:
    """Seed `extract_let`: dict-based per-cell BFS over a deque."""
    M = np.asarray(M)
    box_lo = np.asarray(box_lo, dtype=np.float64)
    box_hi = np.asarray(box_hi, dtype=np.float64)

    # BFS so that every cell's children are CONTIGUOUS in the output arrays
    # (the traversal contract: children = child_start .. child_start+n_child)
    cells = [dict(src=0, child_start=0, n_child=0, body_start=0,
                  n_body=0, truncated=False)]
    bodies_x, bodies_q = [], []
    n_bodies = 0
    queue = deque([0])          # output indices awaiting expansion
    while queue:
        out = queue.popleft()
        c = cells[out]["src"]
        dist = _dist_point_box(tree.center[c], box_lo, box_hi)
        if 2.0 * tree.radius[c] < theta * dist and c != 0:
            cells[out]["truncated"] = True
            continue
        if tree.n_child[c] == 0:
            # boundary leaf: ship bodies
            s, nb = tree.body_start[c], tree.n_body[c]
            cells[out]["body_start"] = n_bodies
            cells[out]["n_body"] = int(nb)
            n_bodies += int(nb)
            bodies_x.append(tree.x[s:s + nb])
            bodies_q.append(tree.q[s:s + nb])
            continue
        first = len(cells)
        nc = int(tree.n_child[c])
        for k in range(tree.child_start[c], tree.child_start[c] + nc):
            cells.append(dict(src=int(k), child_start=0, n_child=0,
                              body_start=0, n_body=0, truncated=False))
            queue.append(len(cells) - 1)
        cells[out]["child_start"] = first
        cells[out]["n_child"] = nc

    src = np.array([c["src"] for c in cells], dtype=np.int64)
    return LETData(
        center=tree.center[src].copy(),
        radius=tree.radius[src].copy(),
        M=M[src].copy(),
        child_start=np.array([c["child_start"] for c in cells], dtype=np.int64),
        n_child=np.array([c["n_child"] for c in cells], dtype=np.int64),
        body_start=np.array([c["body_start"] for c in cells], dtype=np.int64),
        n_body=np.array([c["n_body"] for c in cells], dtype=np.int64),
        truncated=np.array([c["truncated"] for c in cells], dtype=bool),
        x=(np.concatenate(bodies_x) if bodies_x else np.zeros((0, 3))),
        q=(np.concatenate(bodies_q) if bodies_q else np.zeros((0,))),
    )


def reference_pad_bodies(tree, cells: np.ndarray, width: int | None = None):
    """Seed `fmm._pad_bodies`: per-cell fill loop."""
    width = width or max(int(tree.ncrit), 1)
    out = -np.ones((len(cells), width), dtype=np.int64)
    for i, c in enumerate(cells):
        s, n = tree.body_start[c], tree.n_body[c]
        out[i, :n] = np.arange(s, s + n)
    return out


def reference_padded_leaf_bodies(tree):
    """Seed `Tree.padded_leaf_bodies`: per-leaf fill loop."""
    leaves = tree.leaves
    out = -np.ones((len(leaves), tree.ncrit), dtype=np.int64)
    for i, c in enumerate(leaves):
        s, n = tree.body_start[c], tree.n_body[c]
        out[i, :n] = np.arange(s, s + n)
    return out
