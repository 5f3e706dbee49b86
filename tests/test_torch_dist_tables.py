"""The port's multi-rank exchange tables (repro_torch.core.dist) against the
JAX reference's (repro.core.dist), exactly, and their host-side invariants.

Both packages plan the same points into the same geometry, then build the
wire layout, the wire tables, the three exchange programs (every round's
permutation and int64 gather / scatter tables, moved / delivered / padded
bytes) and the sharded engine's compute tables for D in {2, 4, 8} ranks on
the reference tests' two geometries (tests/test_dist_engine.py): a
stretched slab whose HSDX schedule relays, and duplicated sites that leave
>= 3 of 8 partitions empty, so the lo = +inf / hi = -inf sentinel boxes
cross the wire.  The reference engine's tables are NumPy and need no mesh
devices: it is built over a stand-in 1-D mesh.  The stacked communicator's
collectives are held against a NumPy model of `jax.lax.all_to_all` and
`jax.lax.ppermute`.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.api import PartitionSpec as JSpec
from repro.core.api import plan_geometry as jplan
from repro.core.dist import ShardedEngine as JSharded
from repro.core.dist import build_exchange_program as jprogram
from repro.core.dist import build_wire_layout as jlayout
from repro_torch.core import protocols as proto
from repro_torch.core.api import PartitionSpec, plan_geometry
from repro_torch.core.dist import (DIST_PROTOCOLS, ShardedEngine,
                                   apply_exchange, build_exchange_program,
                                   build_wire_layout, round_tables)
from repro_torch.core.dist.comm import StackedComm
from repro_torch.core.hsdx import decompose_rounds
from repro_torch.launch.mesh import stacked_mesh

SPEC = dict(nparts=8, method="morton", ncrit=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab():
    """Stretched slab: rank adjacency diameter >= 2, so HSDX must relay."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (800, 3))
    x[:, 0] *= 4.0
    return x, rng.uniform(-1, 1, 800)


def _clustered():
    """Duplicated sites -> >= 3 of 8 morton partitions empty."""
    pts = np.array([[.1, .1, .1], [.8, .2, .3], [.3, .9, .5],
                    [.6, .6, .9], [.9, .9, .1]])
    x = np.repeat(pts, 60, axis=0)
    return x, np.random.default_rng(1).uniform(-1, 1, len(x))


@pytest.fixture(scope="module")
def geos():
    """{case: (port geometry, reference geometry)} of the same points."""
    out = {}
    for name, make in (("slab", _slab), ("clustered", _clustered)):
        x, q = make()
        out[name] = (plan_geometry(x, q, PartitionSpec(**SPEC),
                                   device="cpu"),
                     jplan(x, q, JSpec(traversal_backend="host", **SPEC)))
    return out


def _jmesh(D):
    return SimpleNamespace(axis_names=("ranks",), devices=np.empty(D, object))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


CASES = [(c, D) for c in ("slab", "clustered") for D in (2, 4, 8)]


def test_clustered_case_puts_sentinels_on_the_wire(geos):
    g, _ = geos["clustered"]
    empty = [p for p in range(8) if len(g.owners[p]) == 0]
    assert len(empty) >= 3
    lay = build_wire_layout(g, 8)
    assert np.isinf(lay.rank_boxes[empty]).all()


@pytest.mark.parametrize("case,D", CASES)
def test_wire_layout_equals_reference(geos, case, D):
    g, r = geos[case]
    a, b = build_wire_layout(g, D), jlayout(r, D)
    assert (a.n_ranks, a.parts_per_rank, a.pairs, a.total_words, a.trash) \
        == (b.n_ranks, b.parts_per_rank, b.pairs, b.total_words, b.trash)
    for f in ("part_rank", "rank_bytes", "rank_boxes"):
        _same(getattr(a, f), getattr(b, f), f)
    for f in ("span_off", "span_words", "rankpair_off", "rankpair_words"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("case,D", CASES)
def test_wire_tables_equal_reference(geos, case, D):
    g, r = geos[case]
    a = ShardedEngine(g, stacked_mesh(D, "cpu")).wire
    b = JSharded(r, _jmesh(D)).wire
    for f in ("pool_template", "pack_src", "pack_dst", "halo_M_idx",
              "halo_x_idx", "halo_q_idx", "halo_cells", "halo_bodies"):
        _same(getattr(a, f), getattr(b, f), f)
    assert a.halo_cell_off == b.halo_cell_off
    assert a.halo_body_off == b.halo_body_off


@pytest.mark.parametrize("case,D", CASES)
def test_exchange_programs_equal_reference(geos, case, D):
    g, r = geos[case]
    la, lb = build_wire_layout(g, D), jlayout(r, D)
    for name in DIST_PROTOCOLS:
        for gb in ((None, 2048) if name == "grain" else (None,)):
            a = build_exchange_program(la, name, grain_bytes=gb)
            b = jprogram(lb, name, grain_bytes=gb)
            assert (a.protocol, a.n_rounds, a.padded_wire_bytes,
                    a.grain_bytes) == (b.protocol, b.n_rounds,
                                       b.padded_wire_bytes, b.grain_bytes)
            _same(a.moved_bytes, b.moved_bytes, "moved_bytes")
            _same(a.delivered_bytes, b.delivered_bytes, "delivered_bytes")
            assert a.stats() == b.stats()
            for k, (ra, rb) in enumerate(zip(a.rounds, b.rounds)):
                assert (ra.kind, ra.perm, ra.wire_words) \
                    == (rb.kind, rb.perm, rb.wire_words), (name, k)
                _same(ra.send_idx, rb.send_idx, f"{name} round {k} send")
                _same(ra.recv_idx, rb.recv_idx, f"{name} round {k} recv")
                assert ra.send_idx.dtype == np.int64


@pytest.mark.parametrize("case,D", CASES)
def test_compute_tables_equal_reference(geos, case, D):
    g, r = geos[case]
    a = ShardedEngine(g, stacked_mesh(D, "cpu"))
    b = JSharded(r, _jmesh(D))
    for f in ("m2l", "m2p"):
        ta, tb = getattr(a, f), getattr(b, f)
        assert (ta is None) == (tb is None), f
        if ta is not None:
            assert sorted(ta) == sorted(tb)
            for k in ta:
                _same(ta[k], tb[k], f"{f}/{k}")
    assert len(a.p2p_buckets) == len(b.p2p_buckets)
    for i, (ba, bb) in enumerate(zip(a.p2p_buckets, b.p2p_buckets)):
        for k in ba:
            _same(ba[k], bb[k], f"p2p/{i}/{k}")
        _same(a._bucket_gidx[i], b._bucket_gidx[i], f"bucket_gidx/{i}")
    for f in ("_l2p_idx", "_l2p_valid", "_orig_idx", "_flat_idx"):
        _same(getattr(a, f), getattr(b, f), f)
    if a._m2p_gidx is not None:
        _same(a._m2p_gidx, b._m2p_gidx, "m2p_gidx")
    assert sorted(a._part_tabs) == sorted(b._part_tabs)
    assert sorted(a._rank_tabs) == sorted(b._rank_tabs)
    for k in a._part_tabs:
        _same(a._part_tabs[k], b._part_tabs[k], k)
    for k in a._rank_tabs:
        _same(a._rank_tabs[k], b._rank_tabs[k], k)
    _same(a._x_pad, b._x_pad, "x_pad")
    _same(a._q_pad, b._q_pad, "q_pad")


# -------------------------------------------- host-side invariants -------
def test_wire_layout_rejects_uneven_grouping(geos):
    g, _ = geos["clustered"]
    with pytest.raises(ValueError):
        build_wire_layout(g, 3)          # 8 % 3 != 0
    with pytest.raises(ValueError):
        ShardedEngine(g, stacked_mesh(3, "cpu"))


@pytest.mark.parametrize("case", ["slab", "clustered"])
def test_wire_layout_bytes_match_geometry_plan(geos, case):
    """Span words x 4 == the frozen bytes matrix; rank_bytes is its
    inter-rank block aggregation with a zero diagonal."""
    g, _ = geos[case]
    lay = build_wire_layout(g, 4)
    B = g.bytes_matrix
    for (i, j) in lay.pairs:
        assert lay.part_rank[i] != lay.part_rank[j]
        assert lay.span_words[(i, j)] * 4 == B[i, j]
    assert lay.total_words == sum(lay.span_words.values())
    want = np.zeros((4, 4), np.int64)
    for i in range(8):
        for j in range(8):
            ri, rj = lay.part_rank[i], lay.part_rank[j]
            if ri != rj:
                want[ri, rj] += B[i, j]
    np.testing.assert_array_equal(lay.rank_bytes, want)
    assert np.all(np.diag(lay.rank_bytes) == 0)


@pytest.mark.parametrize("case", ["slab", "clustered"])
def test_program_bytes_equal_modeled_schedule(geos, case):
    """Bytes put on the wire == the schedule's edge bytes (what LogGP
    costs), and delivered bytes == rank_bytes exactly."""
    g, _ = geos[case]
    lay = build_wire_layout(g, 4)
    off = lay.rank_bytes * (1 - np.eye(4, dtype=np.int64))
    for name in DIST_PROTOCOLS:
        prog = build_exchange_program(lay, name)
        np.testing.assert_array_equal(prog.moved_bytes,
                                      proto.schedule_edge_bytes(prog.sched))
        np.testing.assert_array_equal(prog.delivered_bytes, off)
        if name != "hsdx":               # direct protocols never relay
            np.testing.assert_array_equal(prog.moved_bytes,
                                          prog.delivered_bytes)


def test_hsdx_relays_through_neighbors(geos):
    """On the stretched slab the HSDX relay tree moves strictly more bytes
    than it delivers (store-and-forward), in the modeled round count."""
    prog = build_exchange_program(build_wire_layout(geos["slab"][0], 4),
                                  "hsdx")
    assert prog.moved_bytes.sum() > prog.delivered_bytes.sum()
    assert prog.n_rounds == proto.schedule_stats(prog.sched)["n_rounds"]


def test_grain_rounds_scale_with_grain_bytes(geos):
    lay = build_wire_layout(geos["slab"][0], 4)
    coarse = build_exchange_program(lay, "grain", grain_bytes=8192)
    fine = build_exchange_program(lay, "grain", grain_bytes=2048)
    assert fine.n_rounds > coarse.n_rounds
    np.testing.assert_array_equal(fine.delivered_bytes,
                                  coarse.delivered_bytes)
    default = build_exchange_program(lay, "grain")
    assert default.grain_bytes == proto.LogGPParams().eager_limit == 8192
    assert default.n_rounds == coarse.n_rounds


def test_decompose_rounds_matches_schedule_stats(geos):
    lay = build_wire_layout(geos["slab"][0], 4)
    for name in ("alltoallv", "hsdx"):
        sched = proto.make_schedule(name, lay.rank_bytes,
                                    boxes=lay.rank_boxes)
        want = sum(len(decompose_rounds([(t.src, t.dst) for t in st]))
                   for st in sched.stages if st)
        assert proto.schedule_stats(sched)["n_rounds"] == want


def test_round_tables_are_int32_copies(geos):
    prog = build_exchange_program(build_wire_layout(geos["slab"][0], 4),
                                  "grain")
    tabs = round_tables(prog)
    assert len(tabs) == prog.n_rounds
    for t, r in zip(tabs, prog.rounds):
        assert t["send"].dtype == t["recv"].dtype == np.int32
        np.testing.assert_array_equal(t["send"], r.send_idx)
        np.testing.assert_array_equal(t["recv"], r.recv_idx)


def test_unknown_protocol_raises(geos):
    with pytest.raises(ValueError):
        build_exchange_program(build_wire_layout(geos["slab"][0], 4),
                               "alltoallv")


# ------------------------------- stacked collectives vs a NumPy model -----
def _np_all_to_all(buf):
    """jax.lax.all_to_all(buf, axis, 0, 0) over the rank axis: rank s's
    received block r is rank r's block s."""
    D = buf.shape[0]
    return np.stack([np.stack([buf[r, s] for r in range(D)])
                     for s in range(D)])


def _np_ppermute(buf, perm):
    """jax.lax.ppermute: rank d gets rank s's buffer for (s, d) in perm;
    a rank that is nobody's destination gets zeros."""
    out = np.zeros_like(buf)
    for s, d in perm:
        out[d] = buf[s]
    return out


@pytest.mark.parametrize("D,seg", [(1, 3), (2, 5), (4, 7), (8, 1)])
def test_stacked_all_to_all_matches_jax_semantics(D, seg):
    buf = np.random.default_rng(D).normal(size=(D, D, seg)).astype(np.float32)
    got = StackedComm(D, "cpu").all_to_all(torch.as_tensor(buf))
    np.testing.assert_array_equal(got.numpy(), _np_all_to_all(buf))


@pytest.mark.parametrize("perm", [((0, 1), (1, 2), (2, 3), (3, 0)),
                                  ((0, 2), (3, 1)), ((1, 0),), ()])
def test_stacked_ppermute_matches_jax_semantics_with_zero_fill(perm):
    buf = np.random.default_rng(7).normal(size=(4, 6)).astype(np.float32)
    comm = StackedComm(4, "cpu")
    for _ in range(2):                       # the second call: cached perm
        got = comm.ppermute(torch.as_tensor(buf), perm)
        np.testing.assert_array_equal(got.numpy(), _np_ppermute(buf, perm))
    dsts = {d for _, d in perm}
    for r in range(4):
        if r not in dsts:
            assert not got[r].any()


@pytest.mark.parametrize("case", ["slab", "clustered"])
@pytest.mark.parametrize("name", DIST_PROTOCOLS)
def test_apply_exchange_matches_numpy_model(geos, case, name):
    """Every round of a program executed over random pools equals the
    reference's round semantics run in NumPy (gather at send, the
    collective, scatter at recv), the trash slot aside."""
    g, _ = geos[case]
    lay = build_wire_layout(g, 4)
    prog = build_exchange_program(lay, name, grain_bytes=4096)
    pools = np.random.default_rng(11).normal(
        size=(4, lay.total_words + 1)).astype(np.float32)
    want = pools.copy()
    for rnd in prog.rounds:
        buf = np.take_along_axis(want, rnd.send_idx.reshape(4, -1), 1)
        buf = buf.reshape(rnd.send_idx.shape)
        buf = (_np_all_to_all(buf) if rnd.kind == "all_to_all"
               else _np_ppermute(buf, rnd.perm))
        for r in range(4):
            want[r, rnd.recv_idx[r].ravel()] = buf[r].ravel()
    comm = StackedComm(4, "cpu")
    tabs = [{"send": torch.as_tensor(r.send_idx),
             "recv": torch.as_tensor(r.recv_idx)} for r in prog.rounds]
    src = torch.as_tensor(pools)
    got = apply_exchange(src, prog, tabs, comm).numpy()
    np.testing.assert_array_equal(src.numpy(), pools)     # input untouched
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    for (i, j) in lay.pairs:                 # every span reached its rank
        off, w = lay.span_off[(i, j)], lay.span_words[(i, j)]
        np.testing.assert_array_equal(
            got[lay.part_rank[j], off:off + w],
            pools[lay.part_rank[i], off:off + w])
