"""Communication protocol schedules for the LET exchange (§4).

Host-side NumPy, the port of `repro.core.protocols`: the schedules, the
delivery simulator, the per-edge bytes, the stats and the LogGP times are
exactly the reference's.  Four protocols over the same payload matrix
B[i, j] = bytes partition i must deliver to partition j:

  alltoallv : 1 bulk-synchronous stage, every nonzero pair sends directly
              (the conventional baseline the paper beats);
  nbx       : direct sparse sends (Hoefler et al.), 1 data stage + a modeled
              log2(P) nonblocking-barrier consensus;
  pairwise  : hypercube / butterfly (P xor 2^i), log2(P) stages, payloads
              routed by bit-correction with relaying (§4.3);
  hsdx      : neighbor-only relay over the Lemma-1 adjacency graph, one
              Neighbor_alltoallv per stage (§4.2, Algorithm 1).

Every schedule is *executed* by a store-and-forward simulator so tests can
assert identical delivery, and costed with a LogGP model including the
eager->rendezvous protocol cliff the paper tunes around (Fig 6).  The
LogGP times are the model's output, not measurements of an exchange.

`make_schedule` / `loggp_time` are cheap pure functions over a frozen bytes
matrix B and the Lemma-1 adjacency boxes, so `api.schedule_comm` sweeps all
four protocols against one `GeometryPlan` with no geometry work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch import obs
from repro_torch.core import hsdx as hsdx_mod

__all__ = ["LogGPParams", "Transfer", "Schedule", "make_schedule",
           "simulate_delivery", "schedule_stats", "schedule_edge_bytes",
           "loggp_time", "PROTOCOLS"]

PROTOCOLS = ("alltoallv", "nbx", "pairwise", "hsdx")


@dataclass
class LogGPParams:
    """LogGP + MPI eager/rendezvous cliff (Cray MPICH defaults, Fig 6)."""
    L: float = 2.0e-6           # latency per stage (s)
    o: float = 1.0e-6           # per-message overhead (s)
    G: float = 1.0 / 10e9       # per-byte gap (s/B) ~ 10 GB/s links
    eager_limit: int = 8192     # bytes; above this, rendezvous
    rendezvous_penalty: float = 4.0e-6  # extra handshake per large message


@dataclass
class Transfer:
    src: int
    dst: int
    nbytes: int
    payloads: list = field(default_factory=list)  # [(origin, final_dst, nbytes)]


@dataclass
class Schedule:
    name: str
    nparts: int
    stages: list  # list[list[Transfer]]

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def _payloads(B: np.ndarray):
    out = []
    P = len(B)
    for i in range(P):
        for j in range(P):
            if i != j and B[i, j] > 0:
                out.append((i, j, int(B[i, j])))
    return out


def _alltoallv(B: np.ndarray) -> Schedule:
    stage = [Transfer(i, j, b, [(i, j, b)]) for (i, j, b) in _payloads(B)]
    return Schedule("alltoallv", len(B), [stage])


def _nbx(B: np.ndarray) -> Schedule:
    # data movement identical to alltoallv (direct sparse sends); the
    # difference is the consensus cost, handled in loggp_time.
    s = _alltoallv(B)
    return Schedule("nbx", len(B), s.stages)


def _pairwise(B: np.ndarray) -> Schedule:
    """Hypercube bit-correction routing: at stage i, forward every held
    payload whose destination differs from the holder in bit i."""
    P = len(B)
    nbits = max(1, math.ceil(math.log2(P)))
    held = {r: [] for r in range(P)}
    for (i, j, b) in _payloads(B):
        held[i].append((i, j, b))
    stages = []
    for bit in range(nbits):
        agg: dict[tuple[int, int], Transfer] = {}
        new_held = {r: [] for r in range(P)}
        for r in range(P):
            partner = r ^ (1 << bit)
            for pl in held[r]:
                origin, dst, b = pl
                if dst != r and ((dst ^ r) >> bit) & 1 and partner < P:
                    t = agg.setdefault((r, partner), Transfer(r, partner, 0))
                    t.nbytes += b
                    t.payloads.append(pl)
                    new_held[partner].append(pl)
                else:
                    new_held[r].append(pl)
        held = new_held
        if agg:
            stages.append(list(agg.values()))
    # non-power-of-two P: bit-correction can strand payloads whose partner
    # rank does not exist; deliver the remainder with one direct stage
    # (the classical fold step for non-pow2 hypercubes)
    agg = {}
    for r in range(P):
        for pl in held[r]:
            origin, dst, b = pl
            if dst != r:
                t = agg.setdefault((r, dst), Transfer(r, dst, 0))
                t.nbytes += b
                t.payloads.append(pl)
    if agg:
        stages.append(list(agg.values()))
    return Schedule("pairwise", P, stages)


def _hsdx(B: np.ndarray, boxes: np.ndarray) -> Schedule:
    """Neighbor-relay over Lemma-1 adjacency; one aggregated neighbor
    exchange per stage (Algorithm 1)."""
    P = len(B)
    adj = hsdx_mod.adjacency_from_boxes(boxes)
    routes = hsdx_mod.relay_routes(adj)
    # position of each payload along its route
    inflight = [(i, j, b, routes[(i, j)]) for (i, j, b) in _payloads(B)]
    stages = []
    hop = 0
    while True:
        agg: dict[tuple[int, int], Transfer] = {}
        active = False
        for (i, j, b, path) in inflight:
            if hop + 1 < len(path):
                active = True
                u, v = path[hop], path[hop + 1]
                t = agg.setdefault((u, v), Transfer(u, v, 0))
                t.nbytes += b
                t.payloads.append((i, j, b))
        if not active:
            break
        stages.append(list(agg.values()))
        hop += 1
    return Schedule("hsdx", P, stages)


def make_schedule(name: str, B: np.ndarray, boxes: np.ndarray | None = None) -> Schedule:
    if name == "alltoallv":
        sched = _alltoallv(B)
    elif name == "nbx":
        sched = _nbx(B)
    elif name == "pairwise":
        sched = _pairwise(B)
    elif name == "hsdx":
        if boxes is None:
            raise ValueError("hsdx needs partition boxes (Lemma 1 adjacency)")
        sched = _hsdx(B, boxes)
    else:
        raise ValueError(f"unknown protocol {name!r}")
    if obs.enabled():
        obs.event("protocols.make_schedule",
                  {"protocol": name, "nparts": int(sched.nparts),
                   "n_stages": len(sched.stages),
                   "total_bytes": int(schedule_edge_bytes(sched).sum())})
    return sched


def simulate_delivery(sched: Schedule) -> dict[tuple[int, int], int]:
    """Store-and-forward execution; returns delivered {(origin, dst): bytes}.
    Used by tests to assert every protocol delivers the identical multiset."""
    delivered: dict[tuple[int, int], int] = {}
    for stage in sched.stages:
        for t in stage:
            for (origin, dst, b) in t.payloads:
                if t.dst == dst:
                    delivered[(origin, dst)] = delivered.get((origin, dst), 0) + b
    return delivered


def schedule_edge_bytes(sched: Schedule) -> np.ndarray:
    """Modeled per-edge wire traffic: E[u, v] = bytes rank u sends directly
    to rank v summed over all stages (relayed payloads count at every hop).

    The bytes a real exchange of this schedule carries equal this matrix."""
    E = np.zeros((sched.nparts, sched.nparts), dtype=np.int64)
    for stage in sched.stages:
        for t in stage:
            E[t.src, t.dst] += int(t.nbytes)
    return E


def schedule_stats(sched: Schedule) -> dict:
    msgs = sum(len(st) for st in sched.stages)
    wire_bytes = sum(t.nbytes for st in sched.stages for t in st)
    # payload bytes = unique origin->dst volume (count each payload once)
    seen = set()
    payload_bytes = 0
    for st in sched.stages:
        for t in st:
            for pl in t.payloads:
                if pl not in seen:
                    seen.add(pl)
                    payload_bytes += pl[2]
    max_inbox = 0
    for st in sched.stages:
        per_dst: dict[int, int] = {}
        for t in st:
            per_dst[t.dst] = per_dst.get(t.dst, 0) + 1
        if per_dst:
            max_inbox = max(max_inbox, max(per_dst.values()))
    # n_rounds: collective rounds, one per partial permutation of the ranks
    # (hsdx.decompose_rounds)
    n_rounds = sum(
        len(hsdx_mod.decompose_rounds([(t.src, t.dst) for t in st]))
        for st in sched.stages if st)
    return dict(n_stages=sched.n_stages, n_msgs=msgs, wire_bytes=wire_bytes,
                payload_bytes=payload_bytes, relay_factor=wire_bytes / max(payload_bytes, 1),
                max_msgs_per_dst_stage=max_inbox, n_rounds=n_rounds)


def loggp_time(sched: Schedule, prm: LogGPParams | None = None,
               grain_bytes: int | None = None) -> float:
    """Per-stage critical path: L + max over processes of (send overhead +
    serialization), with the eager/rendezvous cliff; optional grain size
    splits messages (granularity spectrum, Fig 6).

    `prm=None` constructs fresh `LogGPParams` per call — the default is never
    a shared instance, so callers mutating their params cannot leak state
    into other calls."""
    prm = LogGPParams() if prm is None else prm
    total = 0.0
    for stage in sched.stages:
        per_proc: dict[int, float] = {}
        for t in stage:
            n_m, sz = 1, t.nbytes
            if grain_bytes and t.nbytes > grain_bytes:
                n_m = math.ceil(t.nbytes / grain_bytes)
                sz = grain_bytes
            cost = 0.0
            for _ in range(n_m):
                cost += prm.o + sz * prm.G
                if sz > prm.eager_limit:
                    cost += prm.rendezvous_penalty
            per_proc[t.src] = per_proc.get(t.src, 0.0) + cost
        total += prm.L + (max(per_proc.values()) if per_proc else 0.0)
    if sched.name == "nbx":
        total += math.log2(max(sched.nparts, 2)) * (prm.L + prm.o)  # consensus
    return total
