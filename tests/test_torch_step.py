"""The port's `FMMSession.step` against the JAX reference's
`FMMSession(engine=True, use_kernels=False)` stepped the same way, on the
CPU.

One module-scoped run drives both sessions through the same sequence — an
unmoved step, a within-slack step, a step that also changes the charges, a
beyond-slack step of one partition — and the tests read it.  Reports must
agree exactly in what was rebuilt and refreshed; the per-partition drift in
`shift` at rtol 1e-5 (float32 on the device in both, reduced in another
order); potentials at rtol 1e-6 / atol 2e-5, the engine tolerance of
tests/test_engine.py, and after the rebuild plus 1e-7 of sum_j |q_j|/r_ij:
the moved partition's bodies land among the others', so single float32
terms reach 10^3 where potentials of ~10 cancel, and the two frameworks'
float32 sums, reordered, differ by up to 1e-7 of the sum of |terms| (the
same scaling as chip_smoke.py's card-against-CPU check); host multipole
mirrors at rtol 1e-5 / atol 1e-6 of
the largest |M| (float32 sums of two frameworks, as test_torch_geometry).
"""
import numpy as np
import pytest

from repro.core.api import FMMSession as JSession
from repro.core.api import PartitionSpec as JSpec
from repro_torch.core.api import FMMSession, PartitionSpec
from repro_torch.core.distributions import make_distribution
from repro_torch.core.fmm import direct_potential

RTOL, ATOL = 1e-6, 2e-5
SPEC = dict(nparts=4, ncrit=48)
MOVER = 1
SHIFT = np.array([0.15, -0.1, 0.2])


def _problem(n=1500, seed=5, qseed=6):
    x = make_distribution("sphere", n, seed=seed)
    q = np.random.default_rng(qseed).uniform(-1, 1, n)
    return x, q


def _assert_reports_agree(mine, ref):
    assert mine.cache_hit == ref.cache_hit
    assert mine.rebuilt == ref.rebuilt
    assert mine.refreshed == ref.refreshed
    assert mine.version == ref.version
    np.testing.assert_allclose(mine.shift, ref.shift, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(mine.slack, ref.slack)


@pytest.fixture(scope="module")
def run():
    x, q = _problem()
    mine = FMMSession.from_points(x, q, PartitionSpec(**SPEC), device="cpu")
    ref = JSession.from_points(x, q, JSpec(traversal_backend="host", **SPEC),
                               engine=True, use_kernels=False)
    out = {"x": x, "q": q, "mine": mine, "ref": ref}
    out["phi0"] = (mine.evaluate(), ref.evaluate())
    out["geo0"] = mine.geometry
    engine0 = mine.engine
    out["unmoved"] = (mine.step(x), ref.step(x))
    out["unmoved_kept"] = (mine.geometry is out["geo0"]
                           and mine.engine is engine0
                           and engine0.payload_refreshes == 0)

    eps = float(mine.geometry.slack.min())
    assert eps > 0
    rng = np.random.default_rng(2)
    x1 = x + rng.uniform(-eps / 4, eps / 4, size=x.shape)
    out["within"] = (mine.step(x1), ref.step(x1))
    out["stale1"] = (mine.geometry.Ms_stale, ref.geometry.Ms_stale)
    out["phi1"] = (mine.evaluate(), ref.evaluate())
    out["x1"] = x1

    calls = []
    real = mine.engine.step_drift
    mine.engine.step_drift = lambda *a: calls.append(a) or real(*a)
    x2 = x1 + rng.uniform(-eps / 8, eps / 8, size=x.shape)
    q2 = q * 1.25
    out["charges"] = (mine.step(x2, q2), ref.step(x2, q2))
    out["step_drift_calls"] = len(calls)
    out["phi2"] = (mine.evaluate(), ref.evaluate())

    x3 = x2.copy()
    x3[mine.geometry.owners[MOVER]] += SHIFT
    out["rebuild"] = (mine.step(x3), ref.step(x3))
    out["stale3"] = (mine.geometry.Ms_stale, ref.geometry.Ms_stale)
    out["phi3"] = (mine.evaluate(), ref.evaluate())
    out["x3"], out["q3"] = x3, q2
    return out


def test_unmoved_step_is_a_cache_hit(run):
    mine, ref = run["unmoved"]
    _assert_reports_agree(mine, ref)
    assert mine.cache_hit and mine.rebuilt == mine.refreshed == ()
    assert run["unmoved_kept"]


def test_within_slack_step_refreshes_every_partition(run):
    mine, ref = run["within"]
    _assert_reports_agree(mine, ref)
    assert mine.rebuilt == () and mine.refreshed == (0, 1, 2, 3)
    assert run["stale1"][0] == run["stale1"][1] == (0, 1, 2, 3)
    np.testing.assert_allclose(*run["phi1"], rtol=RTOL, atol=ATOL)
    assert not np.array_equal(run["phi1"][0], run["phi0"][0])


def test_charge_change_falls_back_to_host_revalidation(run):
    mine, ref = run["charges"]
    _assert_reports_agree(mine, ref)
    assert mine.rebuilt == () and len(mine.refreshed) == 4
    assert run["step_drift_calls"] == 0
    np.testing.assert_allclose(*run["phi2"], rtol=RTOL, atol=ATOL)


def test_beyond_slack_rebuild_affects_only_the_mover(run):
    mine, ref = run["rebuild"]
    _assert_reports_agree(mine, ref)
    assert mine.rebuilt == (MOVER,)
    assert run["stale3"] == ((), ())
    x3, q3 = run["x3"], run["q3"]
    phi, phi_ref = run["phi3"]
    absum = direct_potential(x3, np.abs(q3), device="cpu")
    tol = ATOL + RTOL * np.abs(phi_ref) + 1e-7 * absum
    assert np.all(np.abs(phi - phi_ref) <= tol)
    d = direct_potential(x3, q3, device="cpu")
    assert np.linalg.norm(phi - d) / np.linalg.norm(d) < 3e-3


def test_rebuild_syncs_host_mirrors_like_the_reference(run):
    geo, ref = run["mine"].geometry, run["ref"].geometry
    assert geo.Ms_stale == ref.Ms_stale == ()
    np.testing.assert_array_equal(geo.bytes_matrix, ref.bytes_matrix)
    np.testing.assert_array_equal(geo.slack, ref.slack)
    np.testing.assert_array_equal(geo.x_ref, ref.x_ref)
    for a, b in zip(geo.Ms, ref.Ms):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    assert geo.lets.keys() == ref.lets.keys()
    for k in geo.lets:
        np.testing.assert_array_equal(geo.lets[k].x, ref.lets[k].x)
        np.testing.assert_allclose(geo.lets[k].M, ref.lets[k].M, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref.lets[k].M).max())
    for rg, rr in zip(geo.receivers, ref.receivers):
        np.testing.assert_array_equal(rg.tree.x, rr.tree.x)
        for bg, br in zip(rg.remote, rr.remote):
            np.testing.assert_array_equal(bg.graft.x, br.graft.x)


def test_device_planned_rebuild_matches_reference():
    """A rebuild re-traverses on the resolved backend: with
    traversal_backend="device" both packages re-plan the mover's pairs with
    their device traversals (K3's plain version here)."""
    x, q = _problem(n=1200, seed=7, qseed=8)
    spec = dict(SPEC, traversal_backend="device")
    mine = FMMSession.from_points(x, q, PartitionSpec(**spec), device="cpu")
    ref = JSession.from_points(x, q, JSpec(**spec), engine=True,
                               use_kernels=False)
    mine.evaluate()
    ref.evaluate()
    x1 = x.copy()
    x1[mine.geometry.owners[MOVER]] += SHIFT
    _assert_reports_agree(mine.step(x1), ref.step(x1))
    for rg, rr in zip(mine.geometry.receivers, ref.geometry.receivers):
        for pg, pr in [(rg.local, rr.local)] + [
                (u.inter, v.inter) for u, v in zip(rg.remote, rr.remote)]:
            np.testing.assert_array_equal(pg.m2l_a, pr.m2l_a)
            np.testing.assert_array_equal(pg.m2l_b, pr.m2l_b)
            np.testing.assert_array_equal(pg.m2p_b, pr.m2p_b)
    np.testing.assert_allclose(mine.evaluate(), ref.evaluate(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bad", ["x_shape", "x_nan", "q_shape", "q_inf"])
def test_step_rejects_bad_inputs(bad):
    x, q = _problem(n=300)
    sess = FMMSession.from_points(x, q, PartitionSpec(nparts=2), device="cpu")
    new_x, new_q = x.copy(), None
    if bad == "x_shape":
        new_x = x[:-1]
    elif bad == "x_nan":
        new_x[5, 2] = np.nan
    elif bad == "q_shape":
        new_q = q[:, None]
    else:
        new_q = q.copy()
        new_q[7] = np.inf
    geo = sess.geometry
    with pytest.raises(ValueError):
        sess.step(new_x, new_q)
    assert sess.geometry is geo
