"""The port's multi-rank engine (repro_torch.core.dist.ShardedEngine) and
`FMMSession(mesh=...)` on the CPU, with the ranks stacked in this process.

Each protocol's potential on the reference tests' two geometries (a
stretched slab whose HSDX schedule relays; duplicated sites with >= 3
empty partitions) is held against the port's single-device CPU engine and
against `repro`'s `DeviceEngine(geo, use_kernels=False, fused=False)` at
tests/test_dist_engine.py's rtol 1e-6 / atol 2e-5 (float32 terms summed in
float64 in other groupings).  `verify_exchange` must count every span and
catch one corrupted in a copied round table; a mesh session's within-slack
and rebuild steps are held against a mesh-less session's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.api import PartitionSpec as JSpec
from repro.core.api import plan_geometry as jplan
from repro.core.engine import DeviceEngine as JEngine
from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
from repro_torch.core.dist import (DIST_PROTOCOLS, ExchangeVerificationError,
                                   ShardedEngine)
from repro_torch.kernels import p2p as kp2p
from repro_torch.launch.mesh import group_mesh, stacked_mesh

RTOL, ATOL = 1e-6, 2e-5
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
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (800, 3))
    x[:, 0] *= 4.0
    return x, rng.uniform(-1, 1, 800)


def _clustered():
    pts = np.array([[.1, .1, .1], [.8, .2, .3], [.3, .9, .5],
                    [.6, .6, .9], [.9, .9, .1]])
    x = np.repeat(pts, 60, axis=0)
    return x, np.random.default_rng(1).uniform(-1, 1, len(x))


@pytest.fixture(scope="module")
def cases():
    """{case: (x, q, port geometry, port engine phi, reference phi)}."""
    out = {}
    for name, make in (("slab", _slab), ("clustered", _clustered)):
        x, q = make()
        g = plan_geometry(x, q, PartitionSpec(**SPEC), device="cpu")
        r = jplan(x, q, JSpec(traversal_backend="host", **SPEC))
        ref = JEngine(r, use_kernels=False, fused=False).evaluate()
        out[name] = (x, q, g, FMMSession(g, device="cpu").evaluate(),
                     np.asarray(ref))
    return out


@pytest.mark.parametrize("case", ["slab", "clustered"])
@pytest.mark.parametrize("protocol", DIST_PROTOCOLS)
@pytest.mark.parametrize("D", [2, 4, 8])
def test_stacked_potential_matches_engine_and_reference(cases, case,
                                                        protocol, D):
    _, _, g, eng_phi, ref = cases[case]
    k1 = kp2p.launches
    phi = FMMSession(g, device="cpu", mesh=stacked_mesh(D, "cpu"),
                     dist_protocol=protocol).evaluate()
    assert kp2p.launches == k1              # the CPU runs K1's plain version
    assert phi.shape == (g.n,) and np.isfinite(phi).all()
    assert not phi.flags.writeable
    np.testing.assert_allclose(phi, eng_phi, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["slab", "clustered"])
def test_protocols_agree_bit_for_bit(cases, case):
    """The three programs deliver the same words, so the same potential."""
    g = cases[case][2]
    eng = ShardedEngine(g, stacked_mesh(4, "cpu"))
    phis = [eng.evaluate(p) for p in DIST_PROTOCOLS]
    for phi in phis[1:]:
        np.testing.assert_array_equal(phi, phis[0])


@pytest.mark.parametrize("protocol", DIST_PROTOCOLS)
def test_verify_exchange_counts_every_span(cases, protocol):
    g = cases["slab"][2]
    eng = ShardedEngine(g, stacked_mesh(4, "cpu"))
    assert eng.verify_exchange(protocol) == len(eng.layout.pairs) > 0


@pytest.mark.parametrize("protocol", DIST_PROTOCOLS)
def test_verify_exchange_catches_a_corrupted_span(cases, protocol):
    """A copy of the program whose last round scatters one span's first
    word to the trash slot: verify_exchange must name the span."""
    g = cases["slab"][2]
    eng = ShardedEngine(g, stacked_mesh(4, "cpu"))
    good = eng.program(protocol)
    rnd = good.rounds[-1]
    recv = rnd.recv_idx.copy()
    hit = np.argwhere(recv != eng.layout.trash)[0]
    recv[tuple(hit)] = eng.layout.trash
    bad = dataclasses.replace(good, rounds=good.rounds[:-1] + (
        dataclasses.replace(rnd, recv_idx=recv),))
    eng._programs[protocol] = bad
    with pytest.raises(ExchangeVerificationError, match="corrupted") as e:
        eng.verify_exchange(protocol)
    assert e.value.site == "dist.exchange.verify"
    eng._programs[protocol] = good
    assert eng.verify_exchange(protocol) == len(eng.layout.pairs)


def test_session_verifies_once_per_version(cases, monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY_EXCHANGE", "1")
    g = cases["slab"][2]
    sess = FMMSession(g, device="cpu", mesh=stacked_mesh(4, "cpu"),
                      dist_protocol="hsdx")
    calls = []
    real = ShardedEngine.verify_exchange

    def counting(self, protocol="bulk"):
        calls.append(protocol)
        return real(self, protocol)

    monkeypatch.setattr(ShardedEngine, "verify_exchange", counting)
    sess.evaluate()
    sess.evaluate()
    assert calls == ["hsdx"]


def test_session_raises_on_a_corrupted_exchange(cases, monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY_EXCHANGE", "1")
    g = cases["slab"][2]
    sess = FMMSession(g, device="cpu", mesh=stacked_mesh(4, "cpu"))
    eng = sess.dist
    good = eng.program("bulk")
    rnd = good.rounds[0]
    recv = rnd.recv_idx.copy()
    recv[recv != eng.layout.trash] = eng.layout.trash
    eng._programs["bulk"] = dataclasses.replace(
        good, rounds=(dataclasses.replace(rnd, recv_idx=recv),))
    with pytest.raises(ExchangeVerificationError):
        sess.evaluate()


@pytest.mark.parametrize("protocol", DIST_PROTOCOLS)
def test_mesh_session_steps_match_meshless_session(cases, protocol):
    """A within-slack step (payload refreshed, dist engine kept) and a
    beyond-slack step (one partition rebuilt, dist engine rebuilt), each
    against a mesh-less session stepped the same way."""
    x, q, g, _, _ = cases["slab"]
    mesh_s = FMMSession(g, device="cpu", mesh=stacked_mesh(4, "cpu"),
                        dist_protocol=protocol)
    plain = FMMSession(g, device="cpu")
    mesh_s.evaluate()
    plain.evaluate()
    eng = mesh_s.dist
    eps = float(g.slack.min())
    x1 = x + np.random.default_rng(2).uniform(-eps / 4, eps / 4, x.shape)
    a, b = mesh_s.step(x1), plain.step(x1)
    assert a.rebuilt == b.rebuilt == () and a.refreshed == b.refreshed
    assert len(a.refreshed) == 8
    assert mesh_s.dist is eng              # kept, payload rebound
    np.testing.assert_allclose(mesh_s.evaluate(), plain.evaluate(),
                               rtol=RTOL, atol=ATOL)
    x2 = x1.copy()
    x2[g.owners[1]] += np.array([0.15, -0.1, 0.2])
    a, b = mesh_s.step(x2), plain.step(x2)
    assert a.rebuilt == b.rebuilt == (1,)
    assert mesh_s.dist is not eng          # rebuilt with the structure
    np.testing.assert_allclose(mesh_s.evaluate(), plain.evaluate(),
                               rtol=RTOL, atol=ATOL)


def test_exchange_stats_with_and_without_mesh(cases):
    g = cases["slab"][2]
    off = FMMSession(g, device="cpu").exchange_stats
    assert off["enabled"] is False and off["n_rounds"] == 0
    assert off["moved_bytes"] == 0 and off["rank_bytes"] == []
    for protocol in DIST_PROTOCOLS:
        sess = FMMSession(g, device="cpu", mesh=stacked_mesh(4, "cpu"),
                          dist_protocol=protocol, dist_grain_bytes=4096)
        st = sess.exchange_stats
        prog = sess.dist.program(protocol)
        assert st["enabled"] is True and st["protocol"] == protocol
        assert st["n_rounds"] == prog.n_rounds >= 1
        assert st["moved_bytes"] == int(prog.moved_bytes.sum())
        assert st["delivered_bytes"] == int(
            sess.dist.layout.rank_bytes.sum())
        assert st["loggp_time"] > 0
        assert st["grain_bytes"] == prog.grain_bytes == 4096


def test_measure_exchange_reports_rounds_beside_loggp(cases):
    g = cases["slab"][2]
    eng = ShardedEngine(g, stacked_mesh(4, "cpu"))
    for protocol in DIST_PROTOCOLS:
        st = eng.measure_exchange(protocol, reps=2, per_round=True)
        assert st["measured_s"] > 0 and st["loggp_s"] > 0
        assert len(st["rounds"]) == st["n_rounds"]
        assert all(r["measured_s"] > 0 for r in st["rounds"])
        sums = eng.exchange_fn(protocol)()
        assert sums.shape == (4,) and torch.isfinite(sums).all()
    # the sub-program timings left the full program's tables in place
    assert eng._rounds(eng.program("grain")) is eng._round_tabs["grain"][1]


def test_mesh_session_checks_its_arguments(cases):
    g = cases["slab"][2]
    with pytest.raises(ValueError, match="dist_protocol"):
        FMMSession(g, device="cpu", mesh=stacked_mesh(4, "cpu"),
                   dist_protocol="alltoallv")
    with pytest.raises(ValueError, match="device"):
        FMMSession(g, device="cpu", mesh=stacked_mesh(4, "meta"))
    with pytest.raises(TypeError, match="communicator"):
        ShardedEngine(g, object())


def test_mesh_without_a_card_raises(cases):
    """Without a card and without device="cpu", a mesh and a mesh session
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    x, q, g, _, _ = cases["slab"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stacked_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FMMSession(g, mesh=stacked_mesh(4, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FMMSession.from_points(x, q, PartitionSpec(**SPEC),
                               mesh=stacked_mesh(4, "cpu"))


def test_gloo_group_refuses_cuda_tensors(tmp_path):
    """A one-process gloo group: a CUDA device raises at the mesh, and a
    buffer on another device than the mesh's raises at the collective."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="gloo"):
            group_mesh(device="cuda")
        mesh = group_mesh(device="cpu")
        assert (mesh.n_ranks, mesh.local_ranks) == (1, (0,))
        buf = torch.arange(6, dtype=torch.float32).reshape(1, 1, 6)
        assert torch.equal(mesh.all_to_all(buf), buf)
        assert torch.equal(mesh.ppermute(buf[:, 0], ()),
                           torch.zeros(1, 6))
        with pytest.raises(ValueError, match="communicator on cpu"):
            mesh.all_to_all(buf.to("meta"))
    finally:
        dist.destroy_process_group()
