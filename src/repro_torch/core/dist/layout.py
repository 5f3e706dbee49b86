"""Wire layout for the multi-rank LET exchange: one global word space.

Host-side NumPy, the port of `repro.core.dist.layout` (tables exactly the
reference's).  The paper's exchange moves, for every (sender i, receiver j)
partition pair, the frozen-size LET payload `geo.bytes_matrix[i, j]` =
`n_cells * CELL_BYTES + n_bodies * BODY_BYTES` (repro_torch.core.let).  The
rank programs ship the same byte count as float32 *words*:

  cell record : 52 words = 208 B  (center x3, radius, child_start, n_child,
                body_start, n_body, then the nk multipole coefficients,
                zero-padded to the frozen record size)
  body record :  8 words =  32 B  (x x3, q, 4 pad words)

so `span_words[(i, j)] * 4 == bytes_matrix[i, j]` exactly: the words each
exchange program moves are comparable to (and checked equal to) the
modeled bytes matrix.

Every inter-rank pair gets a contiguous span in ONE shared word space; each
rank holds a `(total_words + 1,)` float32 *pool* (last slot = scatter trash
for padding).  Because the layout is identical on all ranks, a receiver's
scatter indices equal the sender's gather indices, and HSDX relays can park
in-flight spans at their canonical offsets: no per-hop reindexing.

Intra-rank pairs never touch the wire: the sharded engine reads co-resident
senders' multipoles/bodies directly (as the single-device engine does for
all pairs), so `rank_bytes` has a zero diagonal by construction.  Only the
structure of the pool (offsets, frozen header words) lives here; the
dynamic words (multipoles, body coordinates/charges) are packed from the
device payload each evaluation by `dist.engine`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import let as let_mod

__all__ = ["CELL_WORDS", "BODY_WORDS", "CELL_M_WORD", "WireLayout",
           "WireTables", "build_wire_layout", "build_wire_tables"]

CELL_WORDS = let_mod.CELL_BYTES // 4      # 52 f32 words per LET cell
BODY_WORDS = let_mod.BODY_BYTES // 4      # 8 f32 words per LET body
CELL_M_WORD = 8                           # multipoles start after the header


@dataclass(frozen=True)
class WireLayout:
    """Rank grouping + the global word space of all inter-rank LET spans."""
    n_ranks: int
    parts_per_rank: int
    part_rank: np.ndarray        # (P,) owning rank of each partition
    rank_bytes: np.ndarray       # (D, D) int64 inter-rank LET bytes, diag 0
    rank_boxes: np.ndarray       # (D, 2, 3) union adjacency boxes per rank
    pairs: tuple                 # ((i, j), ...) inter-rank partition pairs,
                                 # sorted by (rank_i, rank_j, i, j)
    span_off: dict = field(repr=False)    # (i, j) -> word offset
    span_words: dict = field(repr=False)  # (i, j) -> word count
    rankpair_off: dict = field(repr=False)   # (ri, rj) -> word offset
    rankpair_words: dict = field(repr=False)
    total_words: int = 0

    @property
    def trash(self) -> int:
        """Pool slot that absorbs every padding scatter/gather."""
        return self.total_words


@dataclass(frozen=True)
class WireTables:
    """Per-rank pack / unpack index tables over the shared pool layout.

    All arrays are stacked with a leading (D,) rank axis; each rank program
    takes its own row.
    """
    layout: WireLayout
    pool_template: np.ndarray    # (D, W+1) f32: frozen header words of the
                                 # spans each rank ORIGINATES, zeros elsewhere
    pack_src: np.ndarray         # (D, K) i32 into [M_flat | x_flat | q_flat]
    pack_dst: np.ndarray         # (D, K) i32 into the pool (pad -> trash)
    halo_M_idx: np.ndarray       # (D, HM, nk) i32 pool word gathers
    halo_x_idx: np.ndarray       # (D, HB, 3)
    halo_q_idx: np.ndarray       # (D, HB)
    halo_cell_off: dict = field(repr=False)   # (i, j) -> halo row offset
    halo_body_off: dict = field(repr=False)   # on the RECEIVER's rank
    halo_cells: np.ndarray = field(repr=False)   # (D,) real halo rows
    halo_bodies: np.ndarray = field(repr=False)


def build_wire_layout(geo, n_ranks: int) -> WireLayout:
    """Group partitions into `n_ranks` contiguous blocks and lay out one
    span per inter-rank pair with `bytes_matrix[i, j] > 0`."""
    B = np.asarray(geo.bytes_matrix)
    P = len(B)
    D = int(n_ranks)
    if D < 1 or P % D:
        raise ValueError(
            f"dist engine needs nparts divisible by the mesh size: "
            f"nparts={P}, n_ranks={D}")
    ppr = P // D
    part_rank = np.arange(P, dtype=np.int64) // ppr

    rank_bytes = np.zeros((D, D), dtype=np.int64)
    for i in range(P):
        for j in range(P):
            if part_rank[i] != part_rank[j]:
                rank_bytes[part_rank[i], part_rank[j]] += int(B[i, j])

    # union of the owned partitions' (inflated) adjacency boxes; a rank whose
    # partitions are all empty keeps the lo=+inf / hi=-inf sentinel
    adj = np.asarray(geo.adj_boxes, dtype=np.float64)
    rank_boxes = np.empty((D, 2, 3))
    for r in range(D):
        own = adj[r * ppr:(r + 1) * ppr]
        rank_boxes[r, 0] = own[:, 0].min(axis=0)
        rank_boxes[r, 1] = own[:, 1].max(axis=0)

    pairs = sorted(
        ((i, j) for i in range(P) for j in range(P)
         if B[i, j] > 0 and part_rank[i] != part_rank[j]),
        key=lambda ij: (part_rank[ij[0]], part_rank[ij[1]], ij[0], ij[1]))
    span_off, span_words = {}, {}
    rankpair_off, rankpair_words = {}, {}
    off = 0
    for (i, j) in pairs:
        nb = int(B[i, j])
        if nb % 4:
            raise ValueError(f"LET bytes not word-aligned for pair {(i, j)}")
        rk = (int(part_rank[i]), int(part_rank[j]))
        if rk not in rankpair_off:
            rankpair_off[rk] = off
            rankpair_words[rk] = 0
        span_off[(i, j)] = off
        span_words[(i, j)] = nb // 4
        rankpair_words[rk] += nb // 4
        off += nb // 4
    # spans are sorted by rank pair, so every rank pair's spans are one
    # contiguous word range — what lets the exchange programs address a whole
    # (src rank, dst rank) edge as a single arange
    for rk, w in rankpair_words.items():
        assert w * 4 == rank_bytes[rk[0], rk[1]], "span/rank bytes mismatch"
    return WireLayout(
        n_ranks=D, parts_per_rank=ppr, part_rank=part_rank,
        rank_bytes=rank_bytes, rank_boxes=rank_boxes, pairs=tuple(pairs),
        span_off=span_off, span_words=span_words,
        rankpair_off=rankpair_off, rankpair_words=rankpair_words,
        total_words=off)


def _stack_ragged(chunks, fill, dtype, tail_shape=()):
    """Stack per-rank ragged index arrays into (D, max, *tail), `fill`-pad."""
    D = len(chunks)
    cap = max((len(c) for c in chunks), default=0)
    out = np.full((D, cap) + tail_shape, fill, dtype=dtype)
    for r, c in enumerate(chunks):
        if len(c):
            out[r, :len(c)] = c
    return out


def build_wire_tables(geo, layout: WireLayout, *, n_cells_max: int,
                      n_bodies_max: int, nk: int) -> WireTables:
    """Freeze the pack/unpack tables: pure layout + LET structure, no numeric
    payload (the dynamic words are gathered from the device payload at
    evaluation time)."""
    if CELL_M_WORD + nk > CELL_WORDS:
        raise ValueError(
            f"multipole order too large for the frozen {CELL_WORDS}-word "
            f"cell record: needs {CELL_M_WORD + nk} words (nk={nk}); the "
            f"wire format caps nk at {CELL_WORDS - CELL_M_WORD}")
    D, ppr = layout.n_ranks, layout.parts_per_rank
    Cmax, Nmax = n_cells_max, n_bodies_max
    W = layout.total_words
    trash = layout.trash
    m_total = ppr * Cmax * nk            # per-rank pack-source vector layout:
    x_total = ppr * Nmax * 3             # [M_flat | x_flat | q_flat]

    template = np.zeros((D, W + 1), np.float32)
    pack_src = [[] for _ in range(D)]
    pack_dst = [[] for _ in range(D)]
    for (i, j) in layout.pairs:
        let = geo.lets[(i, j)]
        r = int(layout.part_rank[i])
        il = i % ppr
        off = layout.span_off[(i, j)]
        S, Bn = let.n_cells, len(let.q)
        cbase = off + np.arange(S, dtype=np.int64) * CELL_WORDS
        # frozen header words (structure never changes within a geometry)
        template[r, cbase + 0] = let.center[:, 0]
        template[r, cbase + 1] = let.center[:, 1]
        template[r, cbase + 2] = let.center[:, 2]
        template[r, cbase + 3] = let.radius
        template[r, cbase + 4] = let.child_start
        template[r, cbase + 5] = let.n_child
        template[r, cbase + 6] = let.body_start
        template[r, cbase + 7] = let.n_body
        # dynamic multipole words, gathered from the sender's device M
        k = np.arange(nk, dtype=np.int64)
        pack_dst[r].append((cbase[:, None] + CELL_M_WORD + k).ravel())
        pack_src[r].append(
            (((il * Cmax + let.cell_src)[:, None]) * nk + k).ravel())
        if Bn:
            bbase = off + S * CELL_WORDS + \
                np.arange(Bn, dtype=np.int64) * BODY_WORDS
            ax = np.arange(3, dtype=np.int64)
            pack_dst[r].append((bbase[:, None] + ax).ravel())
            pack_src[r].append(
                (m_total + ((il * Nmax + let.body_src)[:, None]) * 3
                 + ax).ravel())
            pack_dst[r].append(bbase + 3)
            pack_src[r].append(m_total + x_total + il * Nmax + let.body_src)

    def cat(chunks):
        return (np.concatenate(chunks) if chunks
                else np.zeros(0, dtype=np.int64))

    src_chunks = [cat(c) for c in pack_src]
    dst_chunks = [cat(c) for c in pack_dst]
    pack_src_t = _stack_ragged(src_chunks, 0, np.int32)
    pack_dst_t = _stack_ragged(dst_chunks, trash, np.int32)

    # receiver-side halo gathers: for each rank, every inter-rank span it
    # receives, receivers ascending then senders ascending — the same order
    # dist.engine walks when translating graft-local ids to halo rows
    halo_cell_off: dict = {}
    halo_body_off: dict = {}
    hM = [[] for _ in range(D)]
    hx = [[] for _ in range(D)]
    hq = [[] for _ in range(D)]
    halo_cells = np.zeros(D, np.int64)
    halo_bodies = np.zeros(D, np.int64)
    k = np.arange(nk, dtype=np.int64)
    ax = np.arange(3, dtype=np.int64)
    for r in range(D):
        for j in range(r * ppr, (r + 1) * ppr):
            for i in range(len(layout.part_rank)):
                if (i, j) not in layout.span_off:
                    continue
                let = geo.lets[(i, j)]
                off = layout.span_off[(i, j)]
                S, Bn = let.n_cells, len(let.q)
                halo_cell_off[(i, j)] = int(halo_cells[r])
                halo_body_off[(i, j)] = int(halo_bodies[r])
                halo_cells[r] += S
                halo_bodies[r] += Bn
                cbase = off + np.arange(S, dtype=np.int64) * CELL_WORDS
                hM[r].append(cbase[:, None] + CELL_M_WORD + k)
                if Bn:
                    bbase = off + S * CELL_WORDS + \
                        np.arange(Bn, dtype=np.int64) * BODY_WORDS
                    hx[r].append(bbase[:, None] + ax)
                    hq[r].append(bbase + 3)

    def cat2(chunks, tail):
        return (np.concatenate(chunks, axis=0) if chunks
                else np.zeros((0,) + tail, dtype=np.int64))

    halo_M = _stack_ragged([cat2(c, (nk,)) for c in hM], trash, np.int32,
                           (nk,))
    halo_x = _stack_ragged([cat2(c, (3,)) for c in hx], trash, np.int32, (3,))
    halo_q = _stack_ragged([cat(c) for c in hq], trash, np.int32)
    return WireTables(
        layout=layout, pool_template=template,
        pack_src=pack_src_t, pack_dst=pack_dst_t,
        halo_M_idx=halo_M, halo_x_idx=halo_x, halo_q_idx=halo_q,
        halo_cell_off=halo_cell_off, halo_body_off=halo_body_off,
        halo_cells=halo_cells, halo_bodies=halo_bodies)
