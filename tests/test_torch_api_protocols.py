"""The port's protocol layer in the session API (repro_torch.core.api:
`schedule_comm`, `CommSchedule`, `SessionResult`, `FMMSession.comm`,
`.potentials`, `.sweep`, `engine=False`), the legacy shims
(repro_torch.core.distributed_fmm) and the loop baselines
(repro_torch.core.reference), on the CPU, against the JAX reference's on
the same inputs and against the port's own layered path.

Schedules, stats, LogGP times, bytes matrices, degree and diameter are host
NumPy in both packages and compared exactly; potentials across the two
packages at rtol 1e-6 / atol 2e-5 (tests/test_engine.py), and within the
port (shims against the layered path, sweep against single protocols) bit
for bit.  The reference's potential comes from its engine
(`DeviceEngine` dispatch), which compiles a few programs, not one per
partition.
"""
import warnings

import numpy as np
import pytest

from repro.core import api as japi
from repro.core import reference as jref
from repro_torch.core import distributed_fmm as dfmm
from repro_torch.core import engine as eng_mod
from repro_torch.core import protocols as proto
from repro_torch.core import reference as ref
from repro_torch.core.api import (FMMSession, PartitionSpec, execute_geometry,
                                  plan_geometry, schedule_comm)
from repro_torch.core.distributed_fmm import (build_distributed_plan,
                                              execute_distributed_plan,
                                              run_distributed_fmm)
from repro_torch.core.distributions import make_distribution
from repro_torch.core.fmm import direct_potential, upward_pass
from repro_torch.core.let import extract_let, extract_lets
from repro_torch.core.multipole import get_operators
from repro_torch.core.partition.orb import orb_partition
from repro_torch.core.plan import padded_body_gather
from repro_torch.core.traversal import dual_traversal
from repro_torch.core.tree import build_tree

RTOL, ATOL = 1e-6, 2e-5
SPEC = dict(nparts=4, ncrit=48)
LET_FIELDS = ("center", "radius", "M", "child_start", "n_child",
              "body_start", "n_body", "truncated", "x", "q")


def _problem(n=1200, seed=5, qseed=6):
    x = make_distribution("sphere", n, seed=seed)
    q = np.random.default_rng(qseed).uniform(-1, 1, n)
    return x, q


def _mixed(n, seed):
    """Half volume (cube), half boundary (sphere surface)."""
    rng = np.random.default_rng(seed)
    a = make_distribution("cube", n // 2, seed=seed)
    b = make_distribution("sphere", n - n // 2, seed=seed + 1)
    x = np.concatenate([a, b])
    return x[rng.permutation(len(x))]


class _Count:
    """Counts the calls of an evaluate method, passing them through."""

    def __init__(self, monkeypatch, owner, name="evaluate"):
        self.n = 0
        real = getattr(owner, name)

        def counted(*args, **kw):
            self.n += 1
            return real(*args, **kw)

        monkeypatch.setattr(owner, name, counted)


@pytest.fixture(scope="module")
def pair():
    """One ORB geometry planned by both packages; the reference's sweep."""
    x, q = _problem()
    g = plan_geometry(x, q, PartitionSpec(**SPEC), device="cpu")
    r = japi.plan_geometry(x, q, japi.PartitionSpec(traversal_backend="host",
                                                    **SPEC))
    sweep = japi.FMMSession(r, engine=True, use_kernels=False).sweep()
    return x, q, g, r, sweep


def test_schedule_comm_pure_over_frozen_geometry(pair):
    _, _, g, _, _ = pair
    B = g.bytes_matrix.copy()
    for name in proto.PROTOCOLS:
        cs = schedule_comm(g, name)
        assert cs.n_stages >= 1 and cs.protocol == name
        assert sum(proto.simulate_delivery(cs.schedule).values()) == \
            B[B > 0].sum()
    assert np.array_equal(g.bytes_matrix, B)


def test_schedule_comm_checks_delivery(pair, monkeypatch):
    _, _, g, _, _ = pair
    monkeypatch.setattr(proto, "simulate_delivery", lambda s: {})
    with pytest.raises(RuntimeError, match="failed to deliver"):
        schedule_comm(g, "hsdx")
    assert schedule_comm(g, "hsdx", check_delivery=False).n_stages >= 1


@pytest.mark.parametrize("name", proto.PROTOCOLS)
def test_comm_and_session_result_match_reference(name, pair):
    _, _, g, r, rsweep = pair
    cs = schedule_comm(g, name, grain_bytes=4096)
    jcs = japi.schedule_comm(r, name, grain_bytes=4096)
    assert (cs.stats, cs.loggp_time, cs.n_stages, cs.grain_bytes) == \
        (jcs.stats, jcs.loggp_time, jcs.n_stages, jcs.grain_bytes)
    res, jres = FMMSession(g, device="cpu").potentials(name), rsweep[name]
    assert res.protocol == jres.protocol == name
    assert res.schedule_stats == jres.schedule_stats
    assert res.loggp_time == jres.loggp_time
    assert res.n_stages == jres.n_stages
    np.testing.assert_array_equal(res.bytes_matrix, jres.bytes_matrix)
    assert res.adjacency_degree == jres.adjacency_degree
    assert res.diameter == jres.diameter
    assert res.partition_stats == jres.partition_stats
    np.testing.assert_allclose(res.phi, jres.phi, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", [True, False])
def test_sweep_is_one_evaluation_bitwise_equal_to_single_protocols(
        engine, pair, monkeypatch):
    _, _, g, _, _ = pair
    singles = {name: FMMSession(g, device="cpu", engine=engine)
               .potentials(name).phi for name in proto.PROTOCOLS}
    sess = FMMSession(g, device="cpu", engine=engine)
    count = _Count(monkeypatch, sess)
    out = sess.sweep()
    assert count.n == 1 and list(out) == list(proto.PROTOCOLS)
    phis = [res.phi for res in out.values()]
    assert all(p is phis[0] for p in phis) and not phis[0].flags.writeable
    for name, res in out.items():
        np.testing.assert_array_equal(res.phi, singles[name])
        assert res.comm is sess.comm(name)
    sess.sweep()
    assert count.n == 1                 # answered from the cached potential


def test_comm_cache_survives_slack_step_and_clears_on_rebuild():
    x, q = _problem(900)
    sess = FMMSession.from_points(x, q, PartitionSpec(**SPEC), device="cpu")
    cs = sess.comm("hsdx")
    assert sess.comm("hsdx") is cs
    assert sess.comm("hsdx", prm=proto.LogGPParams()) is not cs
    eps = float(sess.geometry.slack.min())
    x1 = x + np.random.default_rng(2).uniform(-eps / 4, eps / 4, x.shape)
    assert sess.step(x1).rebuilt == ()
    assert sess.comm("hsdx") is cs
    x2 = x1.copy()
    x2[sess.geometry.owners[1]] += np.array([0.15, -0.1, 0.2])
    assert sess.step(x2).rebuilt == (1,)
    cs2 = sess.comm("hsdx")
    assert cs2 is not cs
    assert cs2.stats == schedule_comm(sess.geometry, "hsdx").stats


def test_potential_cache_invalidated_by_any_step_that_moves_a_body(
        monkeypatch):
    x, q = _problem(900)
    sess = FMMSession.from_points(x, q, PartitionSpec(**SPEC), device="cpu")
    count = _Count(monkeypatch, sess)
    phi0 = sess.potentials().phi
    assert sess.step(x.copy()).cache_hit
    assert sess.potentials().phi is phi0 and count.n == 1
    x1 = x.copy()
    x1[7] += 1e-5                       # one body, within its slack
    rep = sess.step(x1)
    assert not rep.cache_hit and rep.rebuilt == ()
    phi1 = sess.potentials().phi
    assert count.n == 2 and phi1 is not phi0
    assert sess.step(x1, q * 2.0).refreshed      # charges only
    np.testing.assert_allclose(sess.potentials().phi, 2.0 * phi1,
                               rtol=RTOL, atol=ATOL)
    assert count.n == 3


def test_reference_dispatch_session_matches_engine_session(monkeypatch):
    x, q = _problem(1000)
    spec = PartitionSpec(**SPEC)
    ref_s = FMMSession.from_points(x, q, spec, device="cpu", engine=False)
    eng_s = FMMSession.from_points(x, q, spec, device="cpu")
    assert ref_s.engine is None and ref_s.memo.misses == 0
    count = _Count(monkeypatch, eng_mod.DeviceEngine)
    np.testing.assert_allclose(ref_s.evaluate(), eng_s.evaluate(),
                               rtol=RTOL, atol=ATOL)
    assert count.n == 1 and ref_s.memo.misses > 0
    np.testing.assert_array_equal(ref_s.evaluate(),
                                  execute_geometry(ref_s.geometry,
                                                   device="cpu"))
    eps = float(eng_s.geometry.slack.min())
    x1 = x + np.random.default_rng(3).uniform(-eps / 4, eps / 4, x.shape)
    x2 = x1.copy()
    x2[eng_s.geometry.owners[2]] += np.array([0.1, 0.2, -0.1])
    for xk in (x1, x2):
        ra, rb = ref_s.step(xk), eng_s.step(xk)
        assert (ra.rebuilt, ra.refreshed) == (rb.rebuilt, rb.refreshed)
        # the reference dispatch refreshes the host multipoles eagerly
        assert ref_s.geometry.Ms_stale == ()
        np.testing.assert_allclose(ref_s.evaluate(), eng_s.evaluate(),
                                   rtol=RTOL, atol=ATOL)
    assert count.n == 3


# ------------------------------------------------------- legacy shims ------
def test_legacy_shims_bitwise_equal_to_layered_path():
    x, q = _problem(1200)
    spec = PartitionSpec(**SPEC)
    geo = plan_geometry(x, q, spec, device="cpu")
    cs = schedule_comm(geo, "hsdx")
    phi = execute_geometry(geo, device="cpu")
    old = run_distributed_fmm(x, q, nparts=4, method="orb", protocol="hsdx",
                              theta=0.5, ncrit=48, device="cpu")
    np.testing.assert_array_equal(old.phi, phi)
    np.testing.assert_array_equal(old.bytes_matrix, geo.bytes_matrix)
    assert old.schedule_stats == cs.stats
    assert old.loggp_time == cs.loggp_time and old.n_stages == cs.n_stages
    assert (old.adjacency_degree, old.diameter) == \
        (geo.adjacency_degree, geo.diameter)
    plan = build_distributed_plan(x, q, nparts=4, method="orb",
                                  protocol="hsdx", theta=0.5, ncrit=48,
                                  device="cpu")
    np.testing.assert_array_equal(execute_distributed_plan(plan,
                                                           device="cpu"), phi)
    np.testing.assert_array_equal(plan.bytes_matrix, geo.bytes_matrix)
    assert plan.schedule_stats == cs.stats


def test_legacy_shims_warn_exactly_once():
    x, q = _problem(400)
    dfmm._DEPRECATION_WARNED.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(2):
            run_distributed_fmm(x, q, nparts=2, ncrit=48, device="cpu")
            build_distributed_plan(x, q, nparts=2, ncrit=48, device="cpu")
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)
           and "repro_torch.core.api" in str(w.message)]
    assert sorted(str(w.message).split(" ")[0] for w in dep) == \
        ["build_distributed_plan", "run_distributed_fmm"]


def test_quickstart_assertions_hold_on_cpu():
    """examples/quickstart.py's call and checks, through the port."""
    n, nparts = 4000, 8
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)
    res = run_distributed_fmm(x, q, nparts=nparts, method="orb",
                              protocol="hsdx", theta=0.5, ncrit=64,
                              device="cpu")
    d = direct_potential(x, q, device="cpu")
    err = np.linalg.norm(res.phi - d) / np.linalg.norm(d)
    assert err < 3e-3
    assert res.n_stages >= 1 and res.bytes_matrix.sum() > 0
    st = res.schedule_stats
    assert st["n_msgs"] > 0 and st["relay_factor"] >= 1.0
    assert res.loggp_time > 0 and res.diameter >= 1


# ----------------------------------------------------- loop baselines ------
def test_reference_build_tree_matches_reference_and_vectorized():
    x = _mixed(2000, seed=11)
    q = np.random.default_rng(0).uniform(-1, 1, len(x))
    r = ref.reference_build_tree(x, q, ncrit=48)
    j = jref.reference_build_tree(x, q, ncrit=48)
    for f in ("x", "q", "perm", "parent", "child_start", "n_child",
              "body_start", "n_body", "center", "radius", "bbox_min",
              "bbox_max", "level"):
        np.testing.assert_array_equal(getattr(r, f), getattr(j, f), f)
    t = build_tree(x, q, ncrit=48)
    np.testing.assert_array_equal(t.perm, r.perm)
    assert t.n_cells == r.n_cells

    def cells(tt):
        return sorted(zip(tt.body_start.tolist(), tt.n_body.tolist(),
                          tt.level.tolist(), tt.n_child.tolist(),
                          map(tuple, np.round(tt.bbox_min, 12).tolist()),
                          map(tuple, np.round(tt.bbox_max, 12).tolist())))
    assert cells(t) == cells(r)
    np.testing.assert_array_equal(t.padded_leaf_bodies(),
                                  ref.reference_padded_leaf_bodies(t))
    np.testing.assert_array_equal(ref.reference_padded_leaf_bodies(t),
                                  jref.reference_padded_leaf_bodies(t))
    idx, valid = padded_body_gather(t, t.leaves, t.ncrit)
    np.testing.assert_array_equal(np.where(valid, idx, -1),
                                  ref.reference_pad_bodies(t, t.leaves))


def _pairset(pairs):
    return set(map(tuple, np.asarray(pairs).tolist()))


def test_reference_traversal_and_let_match_reference_and_vectorized():
    x = _mixed(2500, seed=23)
    q = np.random.default_rng(1).uniform(-1, 1, len(x))
    t = build_tree(x, q, ncrit=32)
    for got, want, vec in zip(ref.reference_dual_traversal(t, t, 0.5),
                              jref.reference_dual_traversal(t, t, 0.5),
                              dual_traversal(t, t, 0.5)):
        np.testing.assert_array_equal(got, want)
        assert _pairset(got) == _pairset(vec)
    part, boxes = orb_partition(x, 5)
    i0 = np.nonzero(part == 0)[0]
    t0 = build_tree(x[i0], q[i0], ncrit=48)
    M = upward_pass(t0, get_operators(4, "cpu")).numpy()
    others = np.arange(1, 5)
    batched = extract_lets(t0, M, boxes[others, 0], boxes[others, 1], 0.5)
    for k, j in enumerate(others):
        got = ref.reference_extract_let(t0, M, boxes[j, 0], boxes[j, 1], 0.5)
        want = jref.reference_extract_let(t0, M, boxes[j, 0], boxes[j, 1],
                                          0.5)
        one = extract_let(t0, M, boxes[j, 0], boxes[j, 1], 0.5)
        for f in LET_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            np.testing.assert_array_equal(getattr(got, f), getattr(one, f))
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(batched[k], f))
