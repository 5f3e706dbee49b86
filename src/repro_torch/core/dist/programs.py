"""The paper's three LET exchange protocols as rank programs.

Host-side NumPy (the programs, exactly the reference's
`repro.core.dist.programs`) and the round executor `apply_exchange` over a
`dist.comm` communicator.  Every program is a sequence of *rounds* over the
shared pool word space (`dist.layout`), each round exactly one collective:

  bulk  (§4, baseline) : ONE padded `all_to_all`: every rank's outgoing
         spans packed into equal (D, seg) segments;
  grain (§4.1)         : the granularity-tuned variant: D-1 ring offsets,
         each edge's payload chunked into `ceil(words / grain_words)`
         `ppermute` rounds sized by the CommSchedule's grain;
  hsdx  (§4.2)         : hierarchical sparse data exchange: the
         `protocols.make_schedule("hsdx", ...)` relay stages over the
         Lemma-1 rank adjacency, each stage decomposed into partial
         permutations by `hsdx.decompose_rounds` and executed as one
         `ppermute` per round, parking in-flight spans at their canonical
         pool offsets between hops.

Single source of truth: programs are BUILT from the same `protocols.Schedule`
tables the LogGP model costs: at build time each program verifies that the
bytes its collectives carry equal `protocols.schedule_edge_bytes` of its
schedule, and that the delivered (origin rank -> dst rank) volume equals the
rank-aggregated `GeometryPlan` bytes matrix.  Tests check the same from
outside.

`moved_bytes` counts real payload words; `padded_wire_bytes` also counts the
padding a fixed-size collective moves (each round is one equal-size buffer
per participating rank): the denominator to compare a measured exchange time
with the LogGP prediction.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import hsdx as hsdx_mod
from repro_torch.core import protocols as proto
from repro_torch.core.dist.layout import WireLayout
from repro_torch.resilience import faults as _faults

__all__ = ["DIST_PROTOCOLS", "Round", "ExchangeProgram",
           "build_exchange_program", "rank_schedule", "round_tables",
           "apply_exchange", "predicted_time"]

DIST_PROTOCOLS = ("bulk", "grain", "hsdx")

# the modeled protocol each exchange program executes: bulk and grain both
# move the direct-send (alltoallv) schedule — grain only re-chunks it — and
# hsdx moves the neighbor-relay schedule
_MODEL_OF = {"bulk": "alltoallv", "grain": "alltoallv", "hsdx": "hsdx"}


@dataclass(frozen=True)
class Round:
    """One collective: an `all_to_all` of (D, seg) segments or a `ppermute`
    of (cap,) buffers along a static permutation."""
    kind: str                    # "all_to_all" | "ppermute"
    perm: tuple                  # ((src, dst), ...); empty for all_to_all
    send_idx: np.ndarray = field(repr=False)  # a2a: (D, D, seg); pp: (D, cap)
    recv_idx: np.ndarray = field(repr=False)  # same shape; pads -> trash

    @property
    def wire_words(self) -> int:
        """Words this round physically moves, padding included."""
        if self.kind == "all_to_all":
            D, _, seg = self.send_idx.shape
            return D * (D - 1) * seg         # self-segments never hit a wire
        return len(self.perm) * self.send_idx.shape[1]


@dataclass(frozen=True)
class ExchangeProgram:
    protocol: str
    layout: WireLayout
    sched: proto.Schedule        # the rank-level schedule the program executes
    rounds: tuple                # tuple[Round, ...]
    moved_bytes: np.ndarray      # (D, D) real payload bytes per directed edge
    delivered_bytes: np.ndarray  # (D, D) origin->final-dst bytes delivered
    padded_wire_bytes: int       # physical bytes incl. padding, all rounds
    grain_bytes: int | None = None

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def stats(self) -> dict:
        return dict(
            protocol=self.protocol, n_rounds=self.n_rounds,
            moved_bytes=int(self.moved_bytes.sum()),
            delivered_bytes=int(self.delivered_bytes.sum()),
            padded_wire_bytes=int(self.padded_wire_bytes),
            per_rank_sent=self.moved_bytes.sum(axis=1).tolist(),
            per_rank_recv=self.moved_bytes.sum(axis=0).tolist(),
            grain_bytes=self.grain_bytes)


def rank_schedule(layout: WireLayout, protocol: str) -> proto.Schedule:
    """The modeled rank-level schedule an exchange program executes."""
    if protocol not in DIST_PROTOCOLS:
        raise ValueError(f"unknown dist protocol {protocol!r}; "
                         f"expected one of {DIST_PROTOCOLS}")
    return proto.make_schedule(_MODEL_OF[protocol], layout.rank_bytes,
                               boxes=layout.rank_boxes)


def predicted_time(program: ExchangeProgram,
                   prm: proto.LogGPParams | None = None) -> float:
    """LogGP prediction for the schedule this program executes (the grain
    variant charges its chunking through `loggp_time`'s grain knob)."""
    return proto.loggp_time(program.sched, prm=prm,
                            grain_bytes=program.grain_bytes)


def _edge_words(layout: WireLayout, ri: int, rj: int) -> np.ndarray:
    """Pool word indices of everything rank ri originates for rank rj —
    contiguous by construction (layout sorts spans by rank pair)."""
    w = layout.rankpair_words.get((ri, rj), 0)
    if not w:
        return np.zeros(0, dtype=np.int64)
    off = layout.rankpair_off[(ri, rj)]
    return np.arange(off, off + w, dtype=np.int64)


def _bulk(layout: WireLayout) -> tuple:
    D, trash = layout.n_ranks, layout.trash
    seg = max((layout.rankpair_words.get((r, s), 0)
               for r in range(D) for s in range(D) if r != s), default=0)
    moved = np.zeros((D, D), np.int64)
    if seg == 0:
        return (), moved, 0
    send = np.zeros((D, D, seg), np.int64)
    recv = np.full((D, D, seg), trash, np.int64)
    for r in range(D):
        for s in range(D):
            if r == s:
                recv[r, s] = trash
                continue
            words = _edge_words(layout, r, s)
            if len(words):
                # all_to_all: dst s's received block r = src r's segment s
                send[r, s, :len(words)] = words
                recv[s, r, :len(words)] = words
                moved[r, s] = 4 * len(words)
    rnd = Round(kind="all_to_all", perm=(), send_idx=send, recv_idx=recv)
    return (rnd,), moved, 4 * rnd.wire_words


def _grain(layout: WireLayout, grain_bytes: int) -> tuple:
    D, trash = layout.n_ranks, layout.trash
    gw = max(1, int(grain_bytes) // 4)
    rounds = []
    moved = np.zeros((D, D), np.int64)
    padded = 0
    for k in range(1, D):
        perm = tuple((r, (r + k) % D) for r in range(D))
        edge_words = {r: _edge_words(layout, r, (r + k) % D)
                      for r in range(D)}
        maxw = max((len(w) for w in edge_words.values()), default=0)
        if maxw == 0:
            continue
        for c in range(math.ceil(maxw / gw)):
            cap = min(gw, maxw - c * gw)
            send = np.zeros((D, cap), np.int64)
            recv = np.full((D, cap), trash, np.int64)
            for r in range(D):
                chunk = edge_words[r][c * gw:c * gw + cap]
                if len(chunk):
                    send[r, :len(chunk)] = chunk
                    recv[(r + k) % D, :len(chunk)] = chunk
                    moved[r, (r + k) % D] += 4 * len(chunk)
            rnd = Round(kind="ppermute", perm=perm, send_idx=send,
                        recv_idx=recv)
            rounds.append(rnd)
            padded += 4 * rnd.wire_words
    return tuple(rounds), moved, padded


def _hsdx(layout: WireLayout, sched: proto.Schedule) -> tuple:
    """Execute the relay schedule: stages -> partial-permutation rounds.
    Tracks which rank holds which (origin, dst) span set so a relay can
    never forward words it has not yet received (build-time invariant)."""
    D, trash = layout.n_ranks, layout.trash
    held = {r: {(ri, rj) for (ri, rj) in layout.rankpair_words
                if ri == r} for r in range(D)}
    rounds = []
    moved = np.zeros((D, D), np.int64)
    delivered = np.zeros((D, D), np.int64)
    padded = 0
    for stage in sched.stages:
        tmap = {(t.src, t.dst): t for t in stage}
        for rnd_edges in hsdx_mod.decompose_rounds(list(tmap)):
            words = {}
            for (u, v) in rnd_edges:
                t = tmap[(u, v)]
                chunks = []
                for (ro, rd, nb) in t.payloads:
                    if (ro, rd) not in held[u]:
                        raise RuntimeError(
                            f"hsdx program: rank {u} relays span "
                            f"{(ro, rd)} before receiving it")
                    if nb != 4 * layout.rankpair_words[(ro, rd)]:
                        raise RuntimeError(
                            "hsdx program: partial span payloads are not "
                            "supported by the pool layout")
                    chunks.append(_edge_words(layout, ro, rd))
                words[(u, v)] = (np.concatenate(chunks) if chunks
                                 else np.zeros(0, np.int64))
            cap = max((len(w) for w in words.values()), default=0)
            if cap == 0:
                continue
            send = np.zeros((D, cap), np.int64)
            recv = np.full((D, cap), trash, np.int64)
            for (u, v) in rnd_edges:
                w = words[(u, v)]
                send[u, :len(w)] = w
                recv[v, :len(w)] = w
                moved[u, v] += 4 * len(w)
                for (ro, rd, nb) in tmap[(u, v)].payloads:
                    held[v].add((ro, rd))
                    if v == rd:
                        delivered[ro, rd] += nb
            rnd = Round(kind="ppermute", perm=tuple(rnd_edges),
                        send_idx=send, recv_idx=recv)
            rounds.append(rnd)
            padded += 4 * rnd.wire_words
    return tuple(rounds), moved, delivered, padded


def build_exchange_program(layout: WireLayout, protocol: str, *,
                           grain_bytes: int | None = None) -> ExchangeProgram:
    """Build (and self-verify) one protocol's collective program."""
    _faults.fire("dist.build_program")
    sched = rank_schedule(layout, protocol)
    offdiag = layout.rank_bytes.copy()
    np.fill_diagonal(offdiag, 0)
    if protocol == "bulk":
        rounds, moved, padded = _bulk(layout)
        delivered = moved.copy()
    elif protocol == "grain":
        gb = (proto.LogGPParams().eager_limit if grain_bytes is None
              else int(grain_bytes))
        rounds, moved, padded = _grain(layout, gb)
        delivered = moved.copy()
        grain_bytes = gb
    else:
        rounds, moved, delivered, padded = _hsdx(layout, sched)
    # single-source-of-truth invariants: the bytes the collectives carry are
    # exactly the modeled schedule's edge bytes, and every rank receives
    # exactly its slice of the GeometryPlan bytes matrix
    model = proto.schedule_edge_bytes(sched)
    if not np.array_equal(moved, model):
        raise RuntimeError(
            f"{protocol}: program moves {moved.tolist()} but the modeled "
            f"schedule says {model.tolist()}")
    if not np.array_equal(delivered, offdiag):
        raise RuntimeError(
            f"{protocol}: delivered {delivered.tolist()} != bytes matrix "
            f"{offdiag.tolist()}")
    if obs.enabled():
        obs.event("dist.program_built",
                  {"protocol": protocol, "n_rounds": len(rounds),
                   "moved_bytes": int(moved.sum()),
                   "delivered_bytes": int(delivered.sum()),
                   "padded_wire_bytes": int(padded)})
    return ExchangeProgram(
        protocol=protocol, layout=layout, sched=sched, rounds=rounds,
        moved_bytes=moved, delivered_bytes=delivered,
        padded_wire_bytes=int(padded), grain_bytes=grain_bytes)


def round_tables(program: ExchangeProgram) -> list:
    """The program's gather/scatter tables as int32 copies, one dict per
    round, stacked on the (D,) rank axis (the rank programs index with the
    rounds' own int64 `send_idx` / `recv_idx`)."""
    return [dict(send=r.send_idx.astype(np.int32),
                 recv=r.recv_idx.astype(np.int32)) for r in program.rounds]


def apply_exchange(pools: torch.Tensor, program: ExchangeProgram, tabs,
                   comm) -> torch.Tensor:
    """Run the program's rounds over the pools of the ranks `comm` holds.

    `pools` is (L, W + 1) float32, row l the pool of rank
    `comm.local_ranks[l]`; `tabs[k]["send"/"recv"]` are round k's int64
    tables of those ranks on the pools' device, (L, D, seg) for an
    all_to_all and (L, cap) for a ppermute.  Each round gathers every
    rank's send buffer from its pool, moves it through `comm` (an
    all_to_all: rank s's received block r is rank r's block s; a ppermute:
    a rank that is nobody's destination receives zeros) and scatters it
    into the pool at `recv`, whose padding lanes all land on the trash
    slot (its value is undefined).  Returns the post-exchange pools; the
    input is not modified."""
    pools = pools.clone()
    L = pools.shape[0]
    for rnd, t in zip(program.rounds, tabs):
        send, recv = t["send"], t["recv"]
        buf = torch.gather(pools, 1, send.reshape(L, -1)).reshape(send.shape)
        if rnd.kind == "all_to_all":
            buf = comm.all_to_all(buf)
        else:
            buf = comm.ppermute(buf, rnd.perm)
        pools.scatter_(1, recv.reshape(L, -1), buf.reshape(L, -1))
    return pools
