"""HSDX — hierarchical sparse data exchange (paper §4.2, Algorithm 1).

Host-side NumPy, copied from the JAX reference (`repro.core.hsdx`) so that
the schedules are exactly the reference's.  Communication happens strictly
between *spatially adjacent* partitions (Lemma 1: bounding boxes sharing a
face/edge/vertex within eps).  For every target process a breadth-first
comm tree is built over the adjacency graph (BuildCommTree); payloads for
non-neighbors are relayed hop by hop, one `MPI_Neighbor_alltoallv`-style
aggregated exchange per stage.  Edges are "hardwired" so relay load spreads
evenly over direct neighbors — the uniform-grid balance bound is Eq (1):
NB = ceil((5^D - 3^D) / (3^D - 1)).

A `protocols.Schedule` *stage* is a sparse set of directed transfers; a
collective moves one buffer per rank per op, so a stage executes as one or
more *rounds*, each a partial permutation of ranks (every rank sends at
most once and receives at most once).  `decompose_rounds` is that
decomposition; `protocols.schedule_stats` counts its rounds as `n_rounds`.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["adjacency_from_boxes", "nb_bound", "build_comm_tree",
           "relay_routes", "graph_diameter", "decompose_rounds"]


def nb_bound(D: int = 3) -> int:
    """Eq (1) for a uniform D-dim grid: avg messages received per neighbor
    per stage under balanced hardwiring."""
    return int(np.ceil((5 ** D - 3 ** D) / (3 ** D - 1)))


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


def build_comm_tree(adj: list[list[int]], root: int) -> np.ndarray:
    """BFS tree toward `root` with *balanced* parent selection: among the
    candidate parents (BFS-level-below neighbors), pick the least-loaded one,
    so relay traffic spreads per Eq (1).  Returns parent[] (root's = -1)."""
    P = len(adj)
    level = np.full(P, -1, dtype=np.int64)
    parent = np.full(P, -1, dtype=np.int64)
    load = np.zeros(P, dtype=np.int64)
    level[root] = 0
    q = deque([root])
    order = []
    while q:
        u = q.popleft()
        order.append(u)
        for v in adj[u]:
            if level[v] < 0:
                level[v] = level[u] + 1
                q.append(v)
    # assign parents by increasing level; balanced choice among candidates
    for v in sorted(range(P), key=lambda v: level[v]):
        if v == root or level[v] < 0:
            continue
        cands = [u for u in adj[v] if level[u] == level[v] - 1]
        u = min(cands, key=lambda u: (load[u], u))
        parent[v] = u
        load[u] += 1
    return parent


def relay_routes(adj: list[list[int]]) -> dict[tuple[int, int], list[int]]:
    """Hop sequences: routes[(src, dst)] = [src, r1, ..., dst] along the
    balanced BFS tree rooted at each destination."""
    P = len(adj)
    routes: dict[tuple[int, int], list[int]] = {}
    for dst in range(P):
        parent = build_comm_tree(adj, dst)
        for src in range(P):
            if src == dst:
                continue
            path = [src]
            u = src
            while u != dst:
                u = int(parent[u])
                if u < 0:  # disconnected graph — direct fallback
                    path = [src, dst]
                    break
                path.append(u)
            routes[(src, dst)] = path
    return routes


def decompose_rounds(
    edges: list[tuple[int, int]],
) -> list[list[tuple[int, int]]]:
    """Partition a directed edge set into *rounds*, each a partial
    permutation: within a round every rank sends at most once and receives
    at most once, so a round maps onto one point-to-point collective.

    Greedy first-fit over the (deduplicated, sorted) edge list.  The result
    is deterministic, covers every edge exactly once, and is what the
    modeled accounting (`protocols.schedule_stats` `n_rounds`) counts: one
    source of truth for "how many collectives does this stage cost".
    """
    remaining = sorted(set((int(u), int(v)) for (u, v) in edges))
    if any(u == v for (u, v) in remaining):
        raise ValueError("self-edge in round decomposition")
    rounds: list[list[tuple[int, int]]] = []
    while remaining:
        srcs: set[int] = set()
        dsts: set[int] = set()
        rnd: list[tuple[int, int]] = []
        rest: list[tuple[int, int]] = []
        for (u, v) in remaining:
            if u not in srcs and v not in dsts:
                rnd.append((u, v))
                srcs.add(u)
                dsts.add(v)
            else:
                rest.append((u, v))
        rounds.append(rnd)
        remaining = rest
    return rounds


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
