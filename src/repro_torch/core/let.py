"""Local essential tree (LET): sender-initiated extraction + grafting (§3).

Each partition owns a *completely local* tree (built from the local bounding
box — no global key).  For every remote partition box, the sender traverses
its own tree and ships the minimal subtree:

  - a cell is ACCEPTED (shipped as a truncated multipole leaf, recursion
    stops) iff      2 * R_cell < theta * dist(center, remote_box)
    — conservative enough that the receiver's dual traversal never needs the
    cell's children (see traversal.dual_traversal docstring for the bound);
  - a leaf that fails the criterion ships its bodies (P2P near the boundary);
  - interior cells that fail ship geometry only (structure for the receiver's
    traversal) and recurse.

The receiver *grafts* the received subtree roots — the global tree is never
materialized (the paper's simplification that keeps the serial code reusable).

Extraction is a *frontier BFS over arrays*: one (box, cell) row per frontier
entry, a vectorized point-to-box distance / acceptance test per generation,
and child allocation via segmented prefix sums — so `extract_lets` serves all
P−1 remote partition boxes of one sender in a single joint pass (Kailasa et
al.'s "precompute communication metadata once" discipline).  The only Python
loops are over BFS generations and, at assembly time, over boxes — never over
cells.  This is the JAX reference's `repro.core.let`, unchanged; the tests
hold its output equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.tree import Tree, _segmented_arange

__all__ = ["LETData", "extract_let", "extract_lets", "graft", "refresh_let",
           "let_nbytes", "CELL_BYTES", "BODY_BYTES"]

# wire format: center(3f8) + radius(f8) + M(20f8) + 4 structure int32s
CELL_BYTES = (3 + 1 + 20) * 8 + 16
BODY_BYTES = 4 * 8          # x(3f8) + q(f8)


@dataclass
class LETData:
    """A pruned subtree (what one partition sends to one other partition)."""
    center: np.ndarray       # (S, 3)
    radius: np.ndarray       # (S,)
    M: np.ndarray            # (S, nk) multipoles
    child_start: np.ndarray  # (S,)
    n_child: np.ndarray      # (S,)
    body_start: np.ndarray   # (S,)
    n_body: np.ndarray       # (S,)
    truncated: np.ndarray    # (S,) bool — multipole-sufficient leaf
    x: np.ndarray            # (B, 3) shipped bodies
    q: np.ndarray            # (B,)
    # refresh bookkeeping (NOT part of the wire format; nbytes is unchanged):
    # sender-side indices that let `refresh_let` rebind the numeric payload to
    # updated coordinates/charges, and the minimum truncation-criterion margin
    # used by the MAC-slack revalidation of stepping (a later slice).
    cell_src: np.ndarray | None = None   # (S,) sender-tree cell ids
    body_src: np.ndarray | None = None   # (B,) sender-tree sorted body ids
    trunc_margin: float = float("inf")   # min over truncated cells of
                                         # theta * dist(center, box) - 2 R

    @property
    def n_cells(self) -> int:
        return len(self.radius)

    @property
    def nbytes(self) -> int:
        return self.n_cells * CELL_BYTES + len(self.q) * BODY_BYTES


def _group_exclusive_cumsum(vals: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """Row-order exclusive prefix sum of non-negative `vals` within each group."""
    if len(vals) == 0:
        return vals.astype(np.int64)
    order = np.argsort(groups, kind="stable")
    v = vals[order]
    g = groups[order]
    cs = np.cumsum(v) - v                      # exclusive over the grouped rows
    first = np.ones(len(v), dtype=bool)
    first[1:] = g[1:] != g[:-1]
    # cs is nondecreasing (vals >= 0), so a running max of the group-start
    # values forward-fills each group's base offset
    base = np.maximum.accumulate(np.where(first, cs, 0))
    out = np.empty(len(v), dtype=np.int64)
    out[order] = cs - base
    return out


def extract_lets(tree: Tree, M: np.ndarray, boxes_lo, boxes_hi,
                 theta: float = 0.5) -> list[LETData]:
    """Sender-side LET extraction for G remote partition boxes in ONE joint
    frontier BFS (columns: box id, source cell, per-box output slot)."""
    M = np.asarray(M)
    lo = np.atleast_2d(np.asarray(boxes_lo, dtype=np.float64))
    hi = np.atleast_2d(np.asarray(boxes_hi, dtype=np.float64))
    G = len(lo)
    if G == 0:
        return []
    center, radius = tree.center, tree.radius
    t_cs, t_nc, t_bs, t_nb = (tree.child_start, tree.n_child,
                              tree.body_start, tree.n_body)

    # frontier columns
    f_g = np.arange(G, dtype=np.int64)
    f_c = np.zeros(G, dtype=np.int64)
    f_out = np.zeros(G, dtype=np.int64)
    cell_count = np.ones(G, dtype=np.int64)    # root slot already allocated
    body_count = np.zeros(G, dtype=np.int64)

    rec_ch = []          # per-generation record arrays (row order = BFS order)
    body_g_ch, body_idx_ch = [], []
    trunc_margin = np.full(G, np.inf)
    while len(f_g):
        c = f_c
        dd = np.maximum(np.maximum(lo[f_g] - center[c], center[c] - hi[f_g]), 0.0)
        dist = np.linalg.norm(dd, axis=1)
        trunc = (2.0 * radius[c] < theta * dist) & (c != 0)
        leaf = ~trunc & (t_nc[c] == 0)
        expand = ~trunc & ~leaf

        ti = np.nonzero(trunc)[0]
        if len(ti):
            np.minimum.at(trunc_margin, f_g[ti],
                          theta * dist[ti] - 2.0 * radius[c[ti]])

        bstart = np.zeros(len(f_g), dtype=np.int64)
        nbody = np.zeros(len(f_g), dtype=np.int64)
        cstart = np.zeros(len(f_g), dtype=np.int64)
        nchild = np.zeros(len(f_g), dtype=np.int64)

        li = np.nonzero(leaf)[0]
        if len(li):
            nb = t_nb[c[li]]
            bstart[li] = body_count[f_g[li]] + _group_exclusive_cumsum(nb, f_g[li])
            nbody[li] = nb
            # gather shipped body indices (per-box order follows row order)
            body_idx_ch.append(np.repeat(t_bs[c[li]], nb) + _segmented_arange(nb))
            body_g_ch.append(np.repeat(f_g[li], nb))
            np.add.at(body_count, f_g[li], nb)

        ei = np.nonzero(expand)[0]
        if len(ei):
            nc = t_nc[c[ei]]
            first = cell_count[f_g[ei]] + _group_exclusive_cumsum(nc, f_g[ei])
            cstart[ei] = first
            nchild[ei] = nc
            np.add.at(cell_count, f_g[ei], nc)
            rep = np.repeat(np.arange(len(ei)), nc)
            seg = _segmented_arange(nc)
            child_c = t_cs[c[ei]][rep] + seg
            child_g = f_g[ei][rep]
            child_out = first[rep] + seg
        else:
            child_c = child_g = child_out = np.zeros(0, dtype=np.int64)

        rec_ch.append((f_g, f_out, c, trunc, cstart, nchild, bstart, nbody))
        f_g, f_c, f_out = child_g, child_c, child_out

    g_all = np.concatenate([r[0] for r in rec_ch])
    out_all = np.concatenate([r[1] for r in rec_ch])
    src_all = np.concatenate([r[2] for r in rec_ch])
    trunc_all = np.concatenate([r[3] for r in rec_ch])
    cstart_all = np.concatenate([r[4] for r in rec_ch])
    nchild_all = np.concatenate([r[5] for r in rec_ch])
    bstart_all = np.concatenate([r[6] for r in rec_ch])
    nbody_all = np.concatenate([r[7] for r in rec_ch])
    bg_all = (np.concatenate(body_g_ch) if body_g_ch else np.zeros(0, np.int64))
    bidx_all = (np.concatenate(body_idx_ch) if body_idx_ch else np.zeros(0, np.int64))

    lets = []
    for b in range(G):                      # box-level loop only
        sel = np.nonzero(g_all == b)[0]
        sel = sel[np.argsort(out_all[sel], kind="stable")]
        src = src_all[sel]
        bsel = bidx_all[bg_all == b]
        lets.append(LETData(
            center=center[src].copy(),
            radius=radius[src].copy(),
            M=M[src].copy(),
            child_start=cstart_all[sel],
            n_child=nchild_all[sel],
            body_start=bstart_all[sel],
            n_body=nbody_all[sel],
            truncated=trunc_all[sel],
            x=(tree.x[bsel].copy() if len(bsel) else np.zeros((0, 3))),
            q=(tree.q[bsel].copy() if len(bsel) else np.zeros((0,))),
            cell_src=src, body_src=bsel,
            trunc_margin=float(trunc_margin[b]),
        ))
    return lets


def extract_let(tree: Tree, M: np.ndarray, box_lo, box_hi,
                theta: float = 0.5) -> LETData:
    """Sender-side LET extraction for one remote partition box."""
    return extract_lets(tree, M, np.asarray(box_lo)[None, :],
                        np.asarray(box_hi)[None, :], theta)[0]


def let_nbytes(let: LETData) -> int:
    return let.nbytes


def refresh_let(let: LETData, tree: Tree, M: np.ndarray) -> LETData:
    """Rebind a LET's numeric payload (multipoles, shipped bodies) to the
    sender's updated coordinates/charges while keeping the pruned *structure*
    byte-for-byte — valid as long as the sender's drift stays within the MAC
    slack budget (stepping, a later slice).  The wire size is unchanged, so the
    bytes matrix and every protocol schedule stay valid too."""
    if let.cell_src is None or let.body_src is None:
        raise ValueError("LET lacks refresh bookkeeping "
                         "(extracted by the reference path?)")
    M = np.asarray(M)
    return replace(
        let, M=M[let.cell_src].copy(),
        x=(tree.x[let.body_src].copy() if len(let.body_src) else let.x),
        q=(tree.q[let.body_src].copy() if len(let.body_src) else let.q))


class _GraftedTree:
    """Tree-like view over a received LETData (duck-typed for traversal).

    `ncrit` is only a hint here: the plan layer buckets P2P source widths by
    actual leaf population, so one huge boundary leaf no longer forces every
    pair to pad to `n_body.max()` (see plan.build_interaction_plan).
    """

    def __init__(self, let: LETData):
        self.center = let.center
        self.radius = let.radius
        self.child_start = let.child_start
        self.n_child = let.n_child
        self.body_start = let.body_start
        self.n_body = let.n_body
        self.truncated = let.truncated
        self.x = let.x
        self.q = let.q
        self.M = let.M
        self.ncrit = int(let.n_body.max()) if len(let.n_body) else 1

    @property
    def n_cells(self):
        return len(self.radius)

    @property
    def is_leaf(self):
        return self.n_child == 0

    @property
    def leaves(self):
        return np.nonzero(self.is_leaf)[0]


def graft(let: LETData) -> _GraftedTree:
    """Graft a received subtree root (no global tree is ever built)."""
    return _GraftedTree(let)
