"""Dual-tree traversal with the flexible multipole acceptance criterion.

MAC (exaFMM convention): a cell pair (A, B) is *well separated* iff
    R_A + R_B < theta * |c_A - c_B|
with *tight* radii/centers (squeezed bounding boxes).  The flexible MAC is
what lets the hybrid-ORB scheme tolerate misaligned local trees (paper §2.2).

The traversal is *frontier-vectorized*: it keeps a (K, 2) array of undecided
(target, source) cell pairs and advances the whole frontier at once — one
vectorized MAC test, one vectorized leaf/truncation classification, and
child expansion via the `np.repeat`/`np.cumsum` segmented-arange idiom.  The
only Python loop is over frontier generations (O(tree depth)).

This is the f64 host traversal of the JAX reference
(`repro.core.traversal`), unchanged: the pinned reference of the device
traversal (`repro_torch.core.engine.traversal`), and the planning traversal
on the CPU or with `traversal_backend="host"`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tree import _segmented_arange

__all__ = ["dual_traversal", "mac_ok"]


def mac_ok(ca, ra, cb, rb, theta: float) -> bool:
    d = float(np.linalg.norm(ca - cb))
    return (ra + rb) < theta * d


def dual_traversal(tgt_tree, src_tree, theta: float = 0.5, with_m2p: bool = False):
    """Returns (m2l_pairs, p2p_pairs[, m2p_pairs]) as (*,2) int arrays of
    (target_cell, source_cell).

    If the source tree is a grafted LET, some source cells are *truncated*:
    multipole-sufficient leaves with no children and no bodies (see let.py).
    A truncated cell that fails the MAC against a local *leaf* falls back to
    M2P (direct multipole evaluation at the leaf's bodies), which is accurate
    because the sender's acceptance criterion 2 R_c < theta * dist(c, box)
    bounds R_c / |y - c| < theta/2 for every body y in the remote box.
    """
    tc, tr = tgt_tree.center, tgt_tree.radius
    sc, sr = src_tree.center, src_tree.radius
    t_leaf = np.asarray(tgt_tree.is_leaf)
    s_leaf = np.asarray(src_tree.is_leaf)
    truncated = getattr(src_tree, "truncated", None)
    if truncated is None:
        truncated = np.zeros(len(sc), dtype=bool)
    t_cs, t_nc = tgt_tree.child_start, tgt_tree.n_child
    s_cs, s_nc = src_tree.child_start, src_tree.n_child

    m2l_ch, p2p_ch, m2p_ch = [], [], []
    A = np.zeros(1, dtype=np.int64)
    B = np.zeros(1, dtype=np.int64)
    while len(A):
        d = np.linalg.norm(tc[A] - sc[B], axis=1)
        far = (tr[A] + sr[B]) < theta * d
        if far.any():
            m2l_ch.append(np.stack([A[far], B[far]], axis=1))
            A, B = A[~far], B[~far]
        both_leaf = t_leaf[A] & s_leaf[B]
        if both_leaf.any():
            tb = both_leaf & truncated[B]
            pb = both_leaf & ~tb
            if tb.any():
                m2p_ch.append(np.stack([A[tb], B[tb]], axis=1))
            if pb.any():
                p2p_ch.append(np.stack([A[pb], B[pb]], axis=1))
            A, B = A[~both_leaf], B[~both_leaf]
        if not len(A):
            break
        # split the larger cell (or the only splittable one)
        split_t = (~t_leaf[A]) & (s_leaf[B] | (tr[A] >= sr[B]))
        At, Bt = A[split_t], B[split_t]
        As, Bs = A[~split_t], B[~split_t]
        nt = t_nc[At]
        rep_t = np.repeat(np.arange(len(At)), nt)
        child_t = t_cs[At][rep_t] + _segmented_arange(nt)
        ns = s_nc[Bs]
        rep_s = np.repeat(np.arange(len(Bs)), ns)
        child_s = s_cs[Bs][rep_s] + _segmented_arange(ns)
        A = np.concatenate([child_t, As[rep_s]])
        B = np.concatenate([Bt[rep_t], child_s])

    def _cat(chunks):
        if not chunks:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(chunks, axis=0)

    m2l, p2p, m2p = _cat(m2l_ch), _cat(p2p_ch), _cat(m2p_ch)
    if with_m2p:
        return m2l, p2p, m2p
    assert len(m2p) == 0, "truncated source cells require with_m2p=True"
    return m2l, p2p
