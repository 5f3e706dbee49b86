"""HOT partitioning: split the SFC-key-ordered particle sequence into equal
intervals, with splitter keys found by the paper's histogram refinement
(Fig 2): only global histogram *counts* are communicated (an allreduce of a
few integers), never particle data.  The structure below mirrors that — local
counts per "process" chunk are summed, and bins are refined iteratively.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.partition.sfc import keys_for_points

__all__ = ["histogram_splitters", "hot_partition"]


def histogram_splitters(keys: np.ndarray, nparts: int, key_hi: int,
                        n_bins: int = 64, max_iter: int = 24,
                        n_proc_chunks: int = 8):
    """Find nparts-1 splitter keys s.t. intervals carry ~equal counts.

    Emulates the distributed algorithm: `keys` is viewed as `n_proc_chunks`
    process-local shards; each refinement step computes local histograms and
    "allreduces" them (np.sum over shards).
    """
    n = len(keys)
    shards = np.array_split(keys, n_proc_chunks)
    targets = (np.arange(1, nparts) * n) // nparts         # global ranks wanted
    lo = np.zeros(nparts - 1, dtype=np.float64)
    hi = np.full(nparts - 1, float(key_hi), dtype=np.float64)
    below_lo = np.zeros(nparts - 1, dtype=np.int64)        # counts < lo
    for _ in range(max_iter):
        if np.all(hi - lo <= 1):
            break
        # bins per splitter: [lo, hi) split n_bins ways
        edges = lo[:, None] + (hi - lo)[:, None] * np.arange(n_bins + 1) / n_bins
        counts = np.zeros((nparts - 1, n_bins), dtype=np.int64)
        for sh in shards:                                   # local histograms
            f = sh.astype(np.float64)
            for s in range(nparts - 1):
                c, _ = np.histogram(f, bins=edges[s])
                counts[s] += c                              # "MPI_Allreduce"
        cum = below_lo[:, None] + np.cumsum(counts, axis=1)
        # bin whose cumulative count first reaches the target rank
        idx = np.argmax(cum >= targets[:, None], axis=1)
        reached = cum[np.arange(nparts - 1), idx] >= targets
        idx = np.where(reached, idx, n_bins - 1)
        new_lo = edges[np.arange(nparts - 1), idx]
        new_hi = edges[np.arange(nparts - 1), idx + 1]
        prev_cum = np.where(idx > 0, cum[np.arange(nparts - 1), idx - 1], below_lo)
        below_lo = prev_cum
        lo, hi = new_lo, new_hi
    return np.ceil(hi).astype(np.uint64)


def hot_partition(x: np.ndarray, nparts: int, curve: str = "hilbert",
                  depth: int = 10):
    """Returns (part_id (N,), splitters)."""
    keys = keys_for_points(x, depth=depth, curve=curve)
    splitters = histogram_splitters(keys, nparts, key_hi=1 << (3 * depth))
    part = np.searchsorted(splitters, keys, side="right").astype(np.int32)
    return part, splitters
