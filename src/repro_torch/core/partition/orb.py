"""Hybrid ORB: orthogonal recursive *multisection* along the longest dimension
with histogram-refined bisectors, producing tight partition boxes.

This is the paper's partitioner of choice (§2.2): combined with completely
local trees + tight cell bounding boxes it fixes ORB's partition/cell
misalignment defect.  Multisection (not just bisection) supports non-power-of-
two process counts [Makino 2004].
"""
from __future__ import annotations

import numpy as np

__all__ = ["orb_partition", "find_splitter"]


def find_splitter(vals: np.ndarray, frac: float, n_bins: int = 64,
                  max_iter: int = 30, n_proc_chunks: int = 8) -> float:
    """Histogram-refined coordinate splitter: smallest v with
    count(vals < v) >= frac * n.  Communicates only histogram counts."""
    n = len(vals)
    target = int(round(frac * n))
    lo, hi = float(vals.min()), float(vals.max())
    below = 0
    shards = np.array_split(vals, n_proc_chunks)
    for _ in range(max_iter):
        if hi - lo < 1e-12 * max(1.0, abs(hi)):
            break
        edges = np.linspace(lo, hi, n_bins + 1)
        counts = np.zeros(n_bins, dtype=np.int64)
        for sh in shards:
            c, _ = np.histogram(sh, bins=edges)
            counts += c                                    # "MPI_Allreduce"
        cum = below + np.cumsum(counts)
        idx = int(np.argmax(cum >= target)) if (cum >= target).any() else n_bins - 1
        below = below if idx == 0 else int(cum[idx - 1])
        lo, hi = edges[idx], edges[idx + 1]
    return hi


def orb_partition(x: np.ndarray, nparts: int, regions: bool = False):
    """Returns (part_id (N,), tight_boxes (nparts, 2, 3)).

    With regions=True also returns the ORB *region* boxes — the recursive
    split rectangles that partition space exactly.  Tight boxes drive the
    MAC/LET (paper Fig 1d); region boxes share faces by construction and
    define the Lemma-1 adjacency for HSDX.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    part = np.zeros(n, dtype=np.int32)
    boxes = np.zeros((nparts, 2, 3))
    rboxes = np.zeros((nparts, 2, 3))

    def recurse(idx: np.ndarray, p0: int, np_: int, rlo, rhi):
        if len(idx) == 0:           # more parts than points: this whole
            for p in range(p0, p0 + np_):   # subtree gets empty-box sentinels
                boxes[p, 0], boxes[p, 1] = np.inf, -np.inf
                rboxes[p, 0], rboxes[p, 1] = np.inf, -np.inf
            return
        if np_ == 1:
            pts = x[idx]
            part[idx] = p0
            boxes[p0, 0] = pts.min(axis=0)
            boxes[p0, 1] = pts.max(axis=0)
            rboxes[p0, 0], rboxes[p0, 1] = rlo, rhi
            return
        pts = x[idx]
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        dim = int(np.argmax(hi - lo))                       # longest dimension
        n_left = np_ // 2
        frac = n_left / np_
        s = find_splitter(pts[:, dim], frac)
        left = pts[:, dim] < s
        # guard degenerate splits (duplicated coordinates)
        if left.sum() == 0 or left.sum() == len(idx):
            order = np.argsort(pts[:, dim], kind="stable")
            k = int(round(frac * len(idx)))
            left = np.zeros(len(idx), dtype=bool)
            left[order[:k]] = True
            s = float(pts[order[k - 1], dim]) if k else float(lo[dim])
        rhi_l = rhi.copy()
        rhi_l[dim] = s
        rlo_r = rlo.copy()
        rlo_r[dim] = s
        recurse(idx[left], p0, n_left, rlo.copy(), rhi_l)
        recurse(idx[~left], p0 + n_left, np_ - n_left, rlo_r, rhi.copy())

    dom_lo, dom_hi = x.min(axis=0), x.max(axis=0)
    recurse(np.arange(n), 0, nparts, dom_lo.copy(), dom_hi.copy())
    if regions:
        return part, boxes, rboxes
    return part, boxes
