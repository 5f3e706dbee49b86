"""The port's protocol layer (repro_torch.core.{hsdx,protocols} and
partition/metrics.py) against the JAX reference's, on the same inputs.

Everything here is host NumPy in both packages, so every comparison is
exact: comm trees, relay routes, round decompositions, each stage's
transfers, the delivery map, the per-edge bytes, the stats dict and the
LogGP times (the cost model's output, bit for bit).  The bytes matrices
are random with zeros, and the bytes matrix and adjacency boxes of a
64-partition plan of 4,000 sphere bodies, where HSDX relays over several
hops (diameter > 1).
"""
import numpy as np
import pytest

from repro.core import hsdx as jhsdx
from repro.core import protocols as jproto
from repro.core.partition import metrics as jmetrics
from repro_torch.core import hsdx, protocols as proto
from repro_torch.core.api import PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.partition import metrics
from repro_torch.core.partition.hot import hot_partition
from repro_torch.core.partition.orb import orb_partition

GRAINS = (None, 4096, 65536)
OTHER_PRM = dict(L=5e-6, o=2e-6, G=1 / 25e9, eager_limit=4096,
                 rendezvous_penalty=1e-5)


def _chain_boxes(n=5):
    """n unit boxes in a row along x: adjacency is a path, diameter n - 1."""
    b = np.zeros((n, 2, 3))
    b[:, 0, 0] = np.arange(n)
    b[:, 1, 0] = np.arange(n) + 1
    b[:, 1, 1:] = 1
    return b


def _grid_boxes():
    """A 2 x 2 x 1 grid of unit boxes: every pair touches (face or edge)."""
    b = []
    for i in range(2):
        for j in range(2):
            b.append([[i, j, 0], [i + 1, j + 1, 1]])
    return np.asarray(b, dtype=np.float64)


@pytest.fixture(scope="module")
def plan64():
    x = make_distribution("sphere", 4000, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, 4000)
    return plan_geometry(x, q, PartitionSpec(nparts=64), device="cpu")


def _boxes(name, plan64):
    if name == "chain":
        return _chain_boxes()
    if name == "grid":
        return _grid_boxes()
    return plan64.adj_boxes


@pytest.mark.parametrize("name", ["chain", "grid", "plan64"])
def test_hsdx_graph_functions_match_reference(name, plan64):
    boxes = _boxes(name, plan64)
    adj = hsdx.adjacency_from_boxes(boxes)
    assert adj == jhsdx.adjacency_from_boxes(boxes)
    assert hsdx.graph_diameter(adj) == jhsdx.graph_diameter(adj)
    for root in range(len(adj)):
        np.testing.assert_array_equal(hsdx.build_comm_tree(adj, root),
                                      jhsdx.build_comm_tree(adj, root))
    routes = hsdx.relay_routes(adj)
    assert routes == jhsdx.relay_routes(adj)
    hops = [(r[k], r[k + 1]) for r in routes.values()
            for k in range(len(r) - 1)]
    rounds = hsdx.decompose_rounds(hops)
    assert rounds == jhsdx.decompose_rounds(hops)
    assert sorted(e for rnd in rounds for e in rnd) == sorted(set(hops))
    for rnd in rounds:          # each round is a partial permutation
        assert len({u for u, _ in rnd}) == len({v for _, v in rnd}) == len(rnd)
    if name == "chain":
        assert hsdx.graph_diameter(adj) == 4
        assert routes[(0, 4)] == [0, 1, 2, 3, 4]
    if name == "plan64":
        assert hsdx.graph_diameter(adj) > 1        # HSDX relays here


def test_nb_bound_and_round_errors_match_reference():
    assert [hsdx.nb_bound(d) for d in (1, 2, 3)] == \
        [jhsdx.nb_bound(d) for d in (1, 2, 3)] == [1, 2, 4]
    assert hsdx.decompose_rounds([]) == [] == jhsdx.decompose_rounds([])
    with pytest.raises(ValueError, match="self-edge"):
        hsdx.decompose_rounds([(0, 1), (2, 2)])


def _random_case(P, seed=0):
    """A bytes matrix with zeros (about a third of the pairs send nothing)
    and the ORB regions of P partitions of a sphere as adjacency boxes."""
    rng = np.random.default_rng(seed + P)
    B = rng.integers(1, 50_000, (P, P)) * (rng.random((P, P)) > 0.35)
    np.fill_diagonal(B, 0)
    x = make_distribution("sphere", 64 * P, seed=P)
    _, _, regions = orb_partition(x, P, regions=True)
    return B.astype(np.int64), regions


def _transfers(sched):
    return [[(t.src, t.dst, t.nbytes, list(t.payloads)) for t in st]
            for st in sched.stages]


@pytest.mark.parametrize("case", ["P1", "P2", "P5", "P8", "P16", "plan64"])
@pytest.mark.parametrize("name", ["alltoallv", "nbx", "pairwise", "hsdx"])
def test_schedules_match_reference_exactly(name, case, plan64):
    if case == "plan64":
        B, boxes = plan64.bytes_matrix, plan64.adj_boxes
    else:
        B, boxes = _random_case(int(case[1:]))
    s = proto.make_schedule(name, B, boxes=boxes)
    r = jproto.make_schedule(name, B, boxes=boxes)
    assert (s.name, s.nparts, s.n_stages) == (r.name, r.nparts, r.n_stages)
    assert _transfers(s) == _transfers(r)
    delivered = proto.simulate_delivery(s)
    assert delivered == jproto.simulate_delivery(r)
    assert delivered == {(i, j): int(B[i, j]) for i in range(len(B))
                         for j in range(len(B)) if i != j and B[i, j] > 0}
    np.testing.assert_array_equal(proto.schedule_edge_bytes(s),
                                  jproto.schedule_edge_bytes(r))
    assert proto.schedule_stats(s) == jproto.schedule_stats(r)
    for grain in GRAINS:
        assert proto.loggp_time(s, grain_bytes=grain) == \
            jproto.loggp_time(r, grain_bytes=grain)
        assert proto.loggp_time(s, proto.LogGPParams(**OTHER_PRM), grain) == \
            jproto.loggp_time(r, jproto.LogGPParams(**OTHER_PRM), grain)
    if name == "hsdx" and case == "plan64":
        assert s.n_stages > 1                       # relayed over hops
        assert proto.schedule_stats(s)["relay_factor"] > 1.0


def test_loggp_default_params_are_fresh_per_call():
    B, boxes = _random_case(5)
    s = proto.make_schedule("pairwise", B, boxes=boxes)
    t0 = proto.loggp_time(s)
    prm = proto.LogGPParams()
    prm.L *= 100
    assert proto.loggp_time(s, prm) > t0
    assert proto.loggp_time(s) == t0


def test_protocol_errors():
    B, boxes = _random_case(5)
    for make in (proto.make_schedule, jproto.make_schedule):
        with pytest.raises(ValueError, match="unknown protocol"):
            make("gossip", B, boxes=boxes)
    with pytest.raises(ValueError, match="boxes"):
        proto.make_schedule("hsdx", B)
    with pytest.raises(AssertionError):
        jproto.make_schedule("hsdx", B)


@pytest.mark.parametrize("method", ["orb", "hilbert"])
def test_partition_metrics_match_reference(method):
    x = make_distribution("sphere", 3000, seed=7)
    if method == "orb":
        part, _ = orb_partition(x, 8)
    else:
        part, _ = hot_partition(x, 8, curve="hilbert")
    assert metrics.load_balance(part, 8) == jmetrics.load_balance(part, 8)
    for p in range(8):
        assert metrics.connected_components(x[part == p]) == \
            jmetrics.connected_components(x[part == p])
    assert metrics.partition_report(x, part, 8) == \
        jmetrics.partition_report(x, part, 8)
