"""Partition adjacency for the geometry plan (paper §4.2, Lemma 1).

The two functions `plan_geometry` needs from the JAX reference's
`repro.core.hsdx`, copied unchanged: the Lemma-1 adjacency graph of the
partition boxes and its diameter.  The HSDX schedules themselves come with
the protocol layer in a later slice.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["adjacency_from_boxes", "graph_diameter"]


def adjacency_from_boxes(boxes: np.ndarray, eps: float = 1e-9) -> list[list[int]]:
    """Lemma 1: P' is adjacent to P iff their boxes overlap within eps in
    every dimension (face/edge/vertex sharing).  boxes: (P, 2, 3).

    A partition with no bodies carries the empty-box sentinel (lo > hi, i.e.
    lo=+inf / hi=-inf) and is adjacent to nothing — it neither sends nor
    receives LET payloads, so routing must never relay through it."""
    P = len(boxes)
    adj = [[] for _ in range(P)]
    empty = np.any(boxes[:, 1] < boxes[:, 0], axis=1)
    for i in range(P):
        if empty[i]:
            continue
        for j in range(i + 1, P):
            if empty[j]:
                continue
            lo = np.maximum(boxes[i, 0], boxes[j, 0])
            hi = np.minimum(boxes[i, 1], boxes[j, 1])
            if np.all(hi - lo >= -eps):
                adj[i].append(j)
                adj[j].append(i)
    return adj


def graph_diameter(adj: list[list[int]]) -> int:
    P = len(adj)
    diam = 0
    for s in range(P):
        dist = np.full(P, -1)
        dist[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for v in adj[u]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    q.append(v)
        diam = max(diam, int(dist.max()))
    return diam
