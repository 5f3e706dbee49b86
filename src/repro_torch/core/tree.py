"""Adaptive octree with tight (squeezed) cell bounding boxes.

Host-side NumPy, identical to the JAX reference (`repro.core.tree`): the
tree emits static-shape index arrays that the device engine consumes.  Cells
squeeze their bounding box to the particles they own (the paper's Fig 1(d)),
which is what makes the hybrid-ORB local-tree scheme competitive.

Construction is *level-synchronous*: each refinement level splits every
over-full cell in one batch of array ops, so the only Python loop is over
tree levels.  Cell ids come out in BFS order — levels are contiguous index
ranges and children of one parent are contiguous.  Tight bounding boxes are
computed with segment reductions over the Morton-sorted leaf ranges, then a
level-wise scatter-min/max up the tree.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.partition.sfc import morton_encode

__all__ = ["Tree", "build_tree", "bucket_size", "flat_cell_tables"]


def bucket_size(n: int, lo: int = 16) -> int:
    """Smallest power-of-two >= n (at least `lo`) — shared JIT cache shapes.
    Lives here (the bottom layer) so both the plan padding and the device
    cell-table padding round with ONE rule; re-exported by plan.py."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class Tree:
    """Flat adaptive octree. Bodies are stored Morton-sorted; `perm` maps
    sorted position -> original index."""
    x: np.ndarray            # (N, 3) sorted bodies
    q: np.ndarray            # (N,)   sorted charges
    perm: np.ndarray         # (N,)   sorted -> original
    # per-cell arrays (C cells, root = 0)
    parent: np.ndarray       # (C,) int
    child_start: np.ndarray  # (C,) first child cell id (0 if leaf)
    n_child: np.ndarray      # (C,) number of children (0 for leaf)
    body_start: np.ndarray   # (C,) first body (in sorted order)
    n_body: np.ndarray       # (C,)
    center: np.ndarray       # (C, 3) tight bbox center (expansion center)
    radius: np.ndarray       # (C,)   tight half-diagonal
    bbox_min: np.ndarray     # (C, 3) tight
    bbox_max: np.ndarray     # (C, 3)
    level: np.ndarray        # (C,)
    ncrit: int = 64

    @property
    def n_cells(self) -> int:
        return len(self.parent)

    @property
    def is_leaf(self) -> np.ndarray:
        return self.n_child == 0

    @property
    def leaves(self) -> np.ndarray:
        return np.nonzero(self.is_leaf)[0]

    def levels_desc(self):
        """Cell ids grouped by level, deepest first (for the upward pass)."""
        for lvl in range(self.level.max(), -1, -1):
            yield np.nonzero(self.level == lvl)[0]

    def device_tables(self, pad_cells: int | None = None) -> dict:
        """Device-friendly flat cell tables (see `flat_cell_tables`)."""
        return flat_cell_tables(self, pad_cells=pad_cells)

    def padded_leaf_bodies(self):
        """(n_leaf, ncrit) body indices padded with -1, aligned with .leaves."""
        leaves = self.leaves
        nb = self.n_body[leaves]
        if int(nb.max(initial=0)) > self.ncrit:
            # depth-capped leaves can exceed ncrit; never truncate silently
            raise ValueError("leaf population exceeds ncrit; use a wider gather")
        col = np.arange(self.ncrit, dtype=np.int64)
        out = self.body_start[leaves, None] + col[None, :]
        return np.where(col[None, :] < nb[:, None], out, -1)


def _morton_sort(x: np.ndarray, q: np.ndarray, max_depth: int = 21, bbox=None):
    """Morton-sort bodies over the *local* bounding box (paper §3: the tree is
    completely local — no global key).  Returns (xs, qs, keys, order, depth)."""
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    if bbox is None:
        lo, hi = x.min(axis=0), x.max(axis=0)
    else:
        lo, hi = np.asarray(bbox[0], dtype=np.float64), np.asarray(bbox[1], dtype=np.float64)
    span = np.maximum((hi - lo).max(), 1e-12)
    # cubic box (slightly inflated) for key generation only
    ctr = (lo + hi) / 2
    lo_cube = ctr - span * 0.5000001
    depth = min(max_depth, 21)
    keys = morton_encode(((x - lo_cube) / (span * 1.0000002) * (1 << depth)).astype(np.uint64), depth)
    order = np.argsort(keys, kind="stable")
    return x[order], q[order], keys[order], order, depth


def _segmented_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated — the cumsum/repeat idiom."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))


def flat_cell_tables(tree, pad_cells: int | None = None) -> dict:
    """Flat per-cell tables the device traversal consumes in one gather each.

    Works for any tree-like object (Tree or a grafted LET view): the MAC
    frontier loop only needs center/radius for scoring, child_start/n_child
    for expansion, and is_leaf/truncated for classification.  Cell counts are
    padded to a power of two (`pad_cells` overrides) so trees of similar size
    share one traced traversal program; padded slots are inert leaves
    (radius 0, no children, never reached by valid frontier entries).

    dtypes are the device convention: f32 geometry, i32 structure — the f64
    host arrays stay the traversal *reference* (core.traversal).
    """
    C = len(np.asarray(tree.radius))
    Cpad = pad_cells or bucket_size(max(C, 1))
    if Cpad < C:
        raise ValueError(f"pad_cells={Cpad} < {C} cells")
    center = np.zeros((Cpad, 3), np.float32)
    radius = np.zeros(Cpad, np.float32)
    child_start = np.zeros(Cpad, np.int32)
    n_child = np.zeros(Cpad, np.int32)
    is_leaf = np.ones(Cpad, bool)
    truncated = np.zeros(Cpad, bool)
    center[:C] = np.asarray(tree.center, np.float32)
    radius[:C] = np.asarray(tree.radius, np.float32)
    child_start[:C] = np.asarray(tree.child_start, np.int32)
    n_child[:C] = np.asarray(tree.n_child, np.int32)
    is_leaf[:C] = np.asarray(tree.is_leaf, bool)
    t = getattr(tree, "truncated", None)
    if t is not None:
        truncated[:C] = np.asarray(t, bool)
    return {"center": center, "radius": radius, "child_start": child_start,
            "n_child": n_child, "is_leaf": is_leaf, "truncated": truncated,
            "n_cells": C}


def build_tree(x: np.ndarray, q: np.ndarray, ncrit: int = 64,
               max_depth: int = 21, bbox=None) -> Tree:
    """Build an adaptive octree with level-synchronous array passes."""
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n = len(x)
    if n == 0:
        raise ValueError("build_tree requires at least one body")
    xs, qs, keys, order, depth = _morton_sort(x, q, max_depth=max_depth, bbox=bbox)

    # --- structure: split every over-full frontier cell per level ----------
    parent_ch, cstart_ch, nchild_ch, bstart_ch, nbody_ch, level_ch = [], [], [], [], [], []
    f_parent = np.zeros(1, dtype=np.int64)   # seed convention: parent[0] == 0
    f_start = np.zeros(1, dtype=np.int64)
    f_end = np.array([n], dtype=np.int64)
    next_id, lvl = 1, 0
    while len(f_parent):
        k = len(f_parent)
        nb = f_end - f_start
        cs = np.zeros(k, dtype=np.int64)
        nc = np.zeros(k, dtype=np.int64)
        split = (nb > ncrit) & (lvl < depth)
        sidx = np.nonzero(split)[0]
        if len(sidx):
            # 3-bit Morton digit histogram for all bodies of all split cells
            shift = np.uint64(3 * (depth - lvl - 1))
            per_cell = nb[sidx]
            body_idx = np.repeat(f_start[sidx], per_cell) + _segmented_arange(per_cell)
            owner = np.repeat(np.arange(len(sidx)), per_cell)
            digits = ((keys[body_idx] >> shift) & np.uint64(7)).astype(np.int64)
            cnt = np.zeros((len(sidx), 8), dtype=np.int64)
            np.add.at(cnt, (owner, digits), 1)
            childmask = cnt > 0
            nchild = childmask.sum(axis=1)
            nc[sidx] = nchild
            cs[sidx] = next_id + np.cumsum(nchild) - nchild
            # children are contiguous because bodies are Morton-sorted
            off = f_start[sidx, None] + np.cumsum(cnt, axis=1) - cnt
            new_start = off[childmask]
            new_n = cnt[childmask]
            # this level's cells hold ids [next_id - k, next_id)
            this_level_ids = next_id - k + np.arange(k, dtype=np.int64)
            new_parent = np.repeat(this_level_ids[sidx], nchild)
            total_new = int(nchild.sum())
        else:
            new_start = new_n = new_parent = np.zeros(0, dtype=np.int64)
            total_new = 0
        parent_ch.append(f_parent)
        cstart_ch.append(cs)
        nchild_ch.append(nc)
        bstart_ch.append(f_start)
        nbody_ch.append(nb)
        level_ch.append(np.full(k, lvl, dtype=np.int64))
        f_parent, f_start, f_end = new_parent, new_start, new_start + new_n
        next_id += total_new
        lvl += 1

    parent = np.concatenate(parent_ch)
    child_start = np.concatenate(cstart_ch)
    n_child = np.concatenate(nchild_ch)
    body_start = np.concatenate(bstart_ch)
    n_body = np.concatenate(nbody_ch)
    level = np.concatenate(level_ch)
    C = len(parent)

    # --- tight bboxes: segment reductions at leaves, scatter-min/max up ----
    bmin = np.full((C, 3), np.inf)
    bmax = np.full((C, 3), -np.inf)
    leaf_ids = np.nonzero(n_child == 0)[0]
    lorder = np.argsort(body_start[leaf_ids], kind="stable")
    ls = leaf_ids[lorder]
    starts = body_start[ls]  # leaf body ranges partition [0, n): starts[0] == 0
    bmin[ls] = np.minimum.reduceat(xs, starts, axis=0)
    bmax[ls] = np.maximum.reduceat(xs, starts, axis=0)
    for top in range(int(level.max()), 0, -1):
        ids = np.nonzero(level == top)[0]
        np.minimum.at(bmin, parent[ids], bmin[ids])
        np.maximum.at(bmax, parent[ids], bmax[ids])

    centerc = (bmin + bmax) / 2
    radius = 0.5 * np.linalg.norm(bmax - bmin, axis=1)
    return Tree(
        x=xs, q=qs, perm=order,
        parent=parent, child_start=child_start, n_child=n_child,
        body_start=body_start, n_body=n_body,
        center=centerc, radius=radius, bbox_min=bmin, bbox_max=bmax,
        level=level, ncrit=ncrit,
    )
