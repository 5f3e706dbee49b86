"""Partition-quality metrics reproducing the paper's §2.2 demonstration
(host-side NumPy, the port of `repro.core.partition.metrics`):
Hilbert interval partitions of *boundary* (surface) distributions are
spatially discontinuous (Fig 3), which inflates the distributed interaction
lists; hybrid ORB partitions are compact.
"""
from __future__ import annotations

import numpy as np

__all__ = ["load_balance", "connected_components", "partition_report"]


def load_balance(part: np.ndarray, nparts: int) -> float:
    counts = np.bincount(part, minlength=nparts)
    return counts.max() / max(counts.mean(), 1e-12)


def connected_components(x: np.ndarray, grid_depth: int = 3) -> int:
    """Number of connected components of the point set, measured on an
    occupancy grid with 26-neighbor connectivity.  A spatially continuous
    partition has exactly 1; Hilbert-on-sphere partitions show > 1 (Fig 3)."""
    lo, hi = x.min(axis=0), x.max(axis=0)
    span = max((hi - lo).max(), 1e-12)
    g = np.minimum(((x - lo) / (span * (1 + 1e-9)) * (1 << grid_depth)).astype(np.int64),
                   (1 << grid_depth) - 1)
    occ = set(map(tuple, g))
    seen = set()
    comps = 0
    for cell in occ:
        if cell in seen:
            continue
        comps += 1
        stack = [cell]
        seen.add(cell)
        while stack:
            cx, cy, cz = stack.pop()
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        nb = (cx + dx, cy + dy, cz + dz)
                        if nb in occ and nb not in seen:
                            seen.add(nb)
                            stack.append(nb)
    return comps


def partition_report(x: np.ndarray, part: np.ndarray, nparts: int,
                     grid_depth: int = 3) -> dict:
    """Aggregate quality metrics for a partitioning."""
    comps = [connected_components(x[part == p], grid_depth)
             for p in range(nparts) if (part == p).any()]
    # bbox overlap volume proxy: compact partitions have disjoint tight boxes
    boxes = []
    for p in range(nparts):
        pts = x[part == p]
        if len(pts):
            boxes.append((pts.min(axis=0), pts.max(axis=0)))
    overlap = 0.0
    for i in range(len(boxes)):
        for j in range(i + 1, len(boxes)):
            lo = np.maximum(boxes[i][0], boxes[j][0])
            hi = np.minimum(boxes[i][1], boxes[j][1])
            if np.all(hi > lo):
                overlap += float(np.prod(hi - lo))
    return {
        "balance": load_balance(part, nparts),
        "mean_components": float(np.mean(comps)),
        "max_components": int(np.max(comps)),
        "bbox_overlap_volume": overlap,
    }
