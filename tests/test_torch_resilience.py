"""The port's resilience tier (repro_torch.resilience) and the session's
degradation ladder, held against the reference's (repro.resilience).

The first part ports tests/test_resilience.py, apart from its tests of
the autotune disk cache (`p2p.cache.read` / `p2p.cache.write`), which
tests/test_torch_autotune.py ports beside the rest of the autotune.  Each
site is fired exactly once against a session whose knobs make
that seam load-bearing, and the test asserts the precise consequence: the
potential still lands within the engine-parity tolerance (rtol 1e-6 /
atol 2e-5, tests/test_engine.py's) of the clean one via a counted ladder
fallback, or a typed `ResilienceError` naming the site surfaces.  Plus
retry/backoff with an injectable clock, input validation, the health
sentinels and the step's fallbacks, the report surface, and the two
performance pins (disarmed `fire()` allocates nothing; resilience on with
no faults keeps one compiled call per warm evaluate).

The second part runs both packages on the same inputs (numpy, seeded):
`parse_spec` on the reference's strings, a seeded probabilistic plan's
firing sequence, `RetryPolicy`'s delays, the potential after each
downgrade against `repro`'s, the site of an exhausted ladder, and the
dist -> engine transition.
"""
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from repro.core.api import FMMSession as JSession
from repro.core.api import PartitionSpec as JSpec
from repro.resilience import faults as jfaults
from repro.resilience import fallback as jfb
from repro.resilience import inject_faults as jinject
from repro_torch.core import dist as tdist
from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
from repro_torch.core.dist import programs as prog_mod
from repro_torch.core.engine import DeviceEngine, ExecutableCache
from repro_torch.launch.mesh import stacked_mesh
from repro_torch import resilience
from repro_torch.resilience import fallback as res_fb
from repro_torch.resilience import faults as res_faults
from repro_torch.resilience import (ExchangeVerificationError, InjectedFault,
                                    InjectedResourceExhausted,
                                    ResilienceError, RetryPolicy,
                                    call_with_retry, inject_faults)

RTOL, ATOL = 1e-6, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_isolation():
    """The port's fault plan, ledgers and warn-once set are process-wide,
    as the reference's are (tests/conftest.py resets those): reset them
    around every test."""
    def reset():
        res_faults.disarm()
        res_faults.reset_stats()
        res_fb.reset_ledger()
    reset()
    yield
    reset()


def _problem(n=192, nparts=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(n, 3))
    q = rng.uniform(0.1, 1.0, size=n)
    return x, q, PartitionSpec(nparts=nparts, ncrit=48)


def _session(x, q, spec, **kw):
    return FMMSession.from_points(x, q, spec, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference_phi():
    """The port's clean potential (the per-partition executor) and
    `repro`'s (its per-phase engine) on `_problem()`'s points."""
    x, q, spec = _problem()
    port = _session(x, q, spec, engine=False).evaluate()
    ref = JSession.from_points(x, q, JSpec(nparts=spec.nparts, ncrit=48),
                               engine=True, fused=False, use_kernels=False,
                               p2p_stream=False).evaluate()
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)
    return np.asarray(port, np.float64), np.asarray(ref, np.float64)


def _close_to_both(phi, reference_phi):
    port, ref = reference_phi
    np.testing.assert_allclose(phi, port, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- matrix ---
# site -> session knobs that make the seam load-bearing on the CPU.  Each
# case fires the site once; the resilient session lands one rung lower with
# exactly one counted fallback.
MATRIX = {
    "exe_cache.compile": dict(fused=True),
    "fused.launch": dict(fused=True),
    "p2p.stream.tables": dict(fused=False, p2p_stream=True),
    "kernels.p2p.launch": dict(fused=False),
}
DOWN = {"exe_cache.compile": ("gathered", "per_phase"),
        "fused.launch": ("gathered", "per_phase"),
        "p2p.stream.tables": ("streaming", "gathered"),
        "kernels.p2p.launch": ("per_phase", "reference")}


@pytest.mark.parametrize("site", sorted(MATRIX))
def test_chaos_matrix_fallback_preserves_phi(site, reference_phi):
    x, q, spec = _problem()
    sess = _session(x, q, spec, resilience=True,
                    exe_cache=ExecutableCache(), **MATRIX[site])
    rung_before = sess._current_rung()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with inject_faults(site):
            phi = sess.evaluate()
    st = sess.resilience
    assert st.degraded
    assert len(st.fallbacks) == 1
    assert st.fallbacks[0]["site"] == site
    assert (st.fallbacks[0]["from"], st.fallbacks[0]["to"]) == DOWN[site]
    assert st.fallbacks[0]["from"] == rung_before
    assert st.rung == DOWN[site][1] == sess._current_rung()
    assert res_faults.fired_counts() == {site: 1}
    assert res_fb.ledger_counts()["fallbacks"] == {site: 1}
    assert sess.report()["resilience"]["fallbacks"] == st.fallbacks
    _close_to_both(phi, reference_phi)


@pytest.mark.parametrize("site", sorted(MATRIX) + ["memo.upload"])
def test_without_resilience_each_site_raises(site):
    """Resilience off (the default): an injected fault raises, typed, and
    nothing is counted as a fallback."""
    x, q, spec = _problem(n=96, nparts=2)
    knobs = MATRIX.get(site, dict(engine=False))
    sess = _session(x, q, spec, exe_cache=ExecutableCache(), **knobs)
    assert not sess.resilience.enabled
    want = (torch.cuda.OutOfMemoryError if site == "fused.launch"
            else InjectedFault)
    with pytest.raises(want) as ei:
        with inject_faults(site):
            sess.evaluate()
    assert ei.value.site == site
    assert res_fb.fallback_total() == 0 and not sess.resilience.degraded


def test_chaos_dist_build_program_falls_back_to_engine(reference_phi):
    """dist -> engine on 4 ranks stacked on the CPU; the reference takes
    the same transition (from "dist" to the rung its knobs select) on its
    1-device mesh."""
    from repro.launch.mesh import host_device_mesh
    x, q, spec = _problem()
    sess = _session(x, q, spec, mesh=stacked_mesh(4, "cpu"),
                    resilience=True, fused=False)
    assert sess._current_rung() == "dist"
    jsess = JSession.from_points(x, q, JSpec(nparts=spec.nparts, ncrit=48),
                                 mesh=host_device_mesh(1), resilience=True,
                                 engine=True, fused=False, use_kernels=False,
                                 p2p_stream=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with inject_faults("dist.build_program"):
            phi = sess.evaluate()
        with jinject("dist.build_program"):
            jsess.evaluate()
    st = sess.resilience
    assert st.degraded and st.fallbacks[0]["from"] == "dist"
    assert sess.mesh is None and sess._dist is None
    assert st.rung != "dist"
    assert [(f["site"], f["from"], f["to"]) for f in st.fallbacks] == \
        [(f["site"], f["from"], f["to"]) for f in jsess.resilience.fallbacks]
    _close_to_both(phi, reference_phi)


def test_ladder_walks_multiple_rungs(reference_phi):
    # streaming -> (kernel launch fault) -> gathered -> (again) -> per_phase
    x, q, spec = _problem()
    sess = _session(x, q, spec, resilience=True, fused=True, p2p_stream=True,
                    exe_cache=ExecutableCache())
    assert sess._current_rung() == "streaming"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with inject_faults({"kernels.p2p.launch": {"count": 2}}):
            phi = sess.evaluate()
    transitions = [(f["from"], f["to"]) for f in sess.resilience.fallbacks]
    assert transitions == [("streaming", "gathered"), ("gathered", "per_phase")]
    assert sess.resilience.rung == "per_phase"
    _close_to_both(phi, reference_phi)


def test_ladder_exhaustion_raises_typed_error_like_reference():
    # the reference rung still uploads through the memo: an unlimited fault
    # there leaves nowhere to go, in both packages
    x, q, spec = _problem(n=96, nparts=2)
    sess = _session(x, q, spec, resilience=True, engine=False)
    assert sess._current_rung() == "reference"
    with pytest.raises(ResilienceError) as ei:
        with inject_faults({"memo.upload": {"count": None}}):
            sess.evaluate()
    assert ei.value.site == "memo.upload"
    assert res_fb.ledger_counts()["typed_errors"] == {"memo.upload": 1}
    jsess = JSession.from_points(x, q, JSpec(nparts=2, ncrit=48),
                                 resilience=True, engine=False)
    with pytest.raises(jfb.ResilienceError) as ej:
        with jinject({"memo.upload": {"count": None}}):
            jsess.evaluate()
    assert ej.value.site == ei.value.site


def test_without_resilience_faults_propagate():
    x, q, spec = _problem(n=96, nparts=2)
    sess = _session(x, q, spec, engine=False)   # default: off
    with pytest.raises(InjectedFault):
        with inject_faults("memo.upload"):
            sess.evaluate()
    assert not sess.resilience.enabled


def test_accounting_identity_across_matrix():
    # every fired fault is a counted fallback or a typed error — the
    # check_counters gate, asserted in-process across a mixed run
    x, q, spec = _problem(n=96, nparts=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s1 = _session(x, q, spec, resilience=True, fused=True,
                      exe_cache=ExecutableCache())
        with inject_faults("fused.launch"):
            s1.evaluate()
        s2 = _session(x, q, spec, resilience=True, engine=False)
        with pytest.raises(ResilienceError):
            with inject_faults({"memo.upload": {"count": None}}):
                s2.evaluate()
    fired = res_faults.fired_total()
    assert fired >= 2
    assert fired == res_fb.fallback_total() + res_fb.typed_error_total()


def test_warn_once_per_transition():
    """One RuntimeWarning per (site, from, to) in a process: the second
    identical downgrade is counted but silent; `reset_ledger` re-arms it."""
    x, q, spec = _problem(n=96, nparts=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            sess = _session(x, q, spec, resilience=True, fused=True,
                            exe_cache=ExecutableCache())
            with inject_faults("fused.launch"):
                sess.evaluate()
    assert len([m for m in w if issubclass(m.category, RuntimeWarning)
                and "fused.launch" in str(m.message)]) == 1
    assert res_fb.fallback_total() == 2


# ---------------------------------------------------------------- retry ---
def test_transient_faults_retry_with_deterministic_backoff(reference_phi):
    delays, jdelays = [], []
    x, q, spec = _problem()
    sess = _session(x, q, spec, resilience=True, engine=False)
    sess.resilience.retry = RetryPolicy(max_retries=2, base_delay=0.05,
                                        max_delay=1.0, sleep=delays.append)
    with inject_faults({"memo.upload": {"count": 2, "transient": True}}):
        phi = sess.evaluate()
    assert delays == [0.05, 0.1]            # base * 2**k, injectable clock
    assert sess.resilience.retries == 2
    assert not sess.resilience.degraded     # retried in place, no downgrade
    assert res_fb.retry_total() == 2
    _close_to_both(phi, reference_phi)
    jsess = JSession.from_points(x, q, JSpec(nparts=spec.nparts, ncrit=48),
                                 resilience=True, engine=True, fused=False,
                                 use_kernels=False, p2p_stream=False)
    jsess.resilience.retry = jfb.RetryPolicy(max_retries=2, base_delay=0.05,
                                             max_delay=1.0,
                                             sleep=jdelays.append)
    with jinject({"memo.upload": {"count": 2, "transient": True}}):
        jsess.evaluate()
    assert jdelays == delays


def test_call_with_retry_gives_up_after_budget():
    calls = []

    def always_fails():
        calls.append(1)
        raise InjectedFault("exe_cache.compile", transient=True)

    with pytest.raises(InjectedFault):
        call_with_retry(always_fails, site="exe_cache.compile",
                        policy=RetryPolicy(max_retries=2,
                                           sleep=lambda s: None))
    assert len(calls) == 3                  # initial + 2 retries


def test_retry_delay_caps_at_max():
    p = RetryPolicy(max_retries=8, base_delay=0.05, max_delay=0.15)
    assert [p.delay(k) for k in range(4)] == [0.05, 0.1, 0.15, 0.15]


@pytest.mark.parametrize("kw", [{}, dict(base_delay=0.05, max_delay=0.15),
                                dict(base_delay=0.3, max_delay=2.0)])
def test_retry_delays_match_reference(kw):
    mine, ref = RetryPolicy(**kw), jfb.RetryPolicy(**kw)
    assert [mine.delay(k) for k in range(10)] == \
        [ref.delay(k) for k in range(10)]
    assert mine.max_retries == ref.max_retries


def test_non_transient_never_retries():
    calls = []

    def fails():
        calls.append(1)
        raise InjectedFault("fused.launch")     # transient=False

    with pytest.raises(InjectedFault):
        call_with_retry(fails, site="fused.launch",
                        policy=RetryPolicy(sleep=lambda s: None))
    assert len(calls) == 1


def test_transient_capture_fault_is_retried_then_one_capture():
    """`exe_cache.compile` fires before each build attempt: a transient
    fault is retried in place (no downgrade), and the entry is built once."""
    x, q, spec = _problem(n=96, nparts=2)
    cache = ExecutableCache()
    sess = _session(x, q, spec, resilience=True, fused=True, exe_cache=cache)
    sess.resilience.retry = RetryPolicy(sleep=lambda s: None)
    with inject_faults({"exe_cache.compile": {"count": 1,
                                              "transient": True}}):
        sess.evaluate()
    assert res_fb.ledger_counts()["retries"] == {"exe_cache.compile": 1}
    assert not sess.resilience.degraded
    assert cache.misses == 1 and len(cache) == 1


def test_sites_and_ladder_match_reference():
    assert res_faults.SITES == jfaults.SITES
    assert res_fb.LADDER == jfb.LADDER


# ----------------------------------------------------------- validation ---
def test_plan_geometry_rejects_bad_inputs():
    x, q, spec = _problem(n=32, nparts=2)

    def plan(*a, **kw):
        return plan_geometry(*a, device="cpu", **kw)

    with pytest.raises(ValueError, match="x: expected positions"):
        plan(np.zeros((8, 2)), np.ones(8), spec)
    with pytest.raises(ValueError, match="x: at least one body"):
        plan(np.zeros((0, 3)), np.zeros(0), spec)
    with pytest.raises(ValueError, match="q: expected charges"):
        plan(x, q[:-1], spec)
    bad = x.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="x: positions contain non-finite"):
        plan(bad, q, spec)
    bad_q = q.copy()
    bad_q[0] = np.inf
    with pytest.raises(ValueError, match="q: charges contain non-finite"):
        plan(x, bad_q, spec)
    with pytest.raises(ValueError, match="theta: MAC opening angle"):
        plan(x, q, PartitionSpec(nparts=2, theta=-0.5))
    with pytest.raises(ValueError, match="theta"):
        plan(x, q, PartitionSpec(nparts=2, theta=float("nan")))


def test_session_rejects_non_plan_geometry():
    with pytest.raises(ValueError, match="geometry: expected a GeometryPlan"):
        FMMSession(np.zeros((4, 3)), device="cpu")


def test_step_rejects_non_finite_updates():
    x, q, spec = _problem(n=64, nparts=2)
    sess = _session(x, q, spec, engine=False)
    bad = x.copy()
    bad[5, 0] = np.nan
    with pytest.raises(ValueError, match="new_x: positions contain"):
        sess.step(bad)
    bad_q = q.copy()
    bad_q[1] = -np.inf
    with pytest.raises(ValueError, match="new_q: charges contain"):
        sess.step(x, bad_q)


def test_empty_partition_sentinel_still_works():
    # n < nparts leaves empty partitions: the inf/-inf box sentinel path —
    # deliberately NOT rejected by validation (clustered problems do this)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(5, 3))
    q = rng.uniform(0.1, 1.0, size=5)
    phi = _session(x, q, PartitionSpec(nparts=8, ncrit=16),
                   engine=False).evaluate()
    ref = _session(x, q, PartitionSpec(nparts=1, ncrit=16),
                   engine=False).evaluate()
    assert np.isfinite(phi).all()
    np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ health sentinels --
def test_health_check_catches_nan_phi(reference_phi, monkeypatch):
    x, q, spec = _problem()
    sess = _session(x, q, spec, resilience=True, health_checks=True,
                    fused=False)
    monkeypatch.setattr(DeviceEngine, "evaluate",
                        lambda self: np.full(sess.geometry.n, np.nan),
                        raising=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        phi = sess.evaluate()
    st = sess.resilience
    assert st.health["failures"] >= 1
    assert st.degraded and st.fallbacks[0]["site"] == "health.phi"
    assert st.rung == "reference"
    _close_to_both(phi, reference_phi)


def test_health_check_catches_nan_multipoles(reference_phi, monkeypatch):
    """A finite potential over non-finite device multipoles fails the
    sentinel too (`torch.isfinite` on the engine's multipoles)."""
    x, q, spec = _problem()
    sess = _session(x, q, spec, resilience=True, health_checks=True,
                    fused=False)

    def poisoned(self):
        self._M = torch.full((2, 3), float("nan"))
        return np.zeros(self.tables.n)

    monkeypatch.setattr(DeviceEngine, "evaluate", poisoned, raising=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        phi = sess.evaluate()
    st = sess.resilience
    assert st.health == {"checks": 2, "failures": 1}
    assert st.fallbacks[0]["site"] == "health.phi"
    _close_to_both(phi, reference_phi)


def test_health_check_passes_clean_run():
    x, q, spec = _problem(n=96, nparts=2)
    sess = _session(x, q, spec, resilience=True, health_checks=True,
                    engine=False)
    sess.evaluate()
    st = sess.resilience
    assert st.health == {"checks": 1, "failures": 0}
    assert not st.degraded


def _step_case():
    """Points with a far field and a finite slack, and a within-slack drift
    of them."""
    rng = np.random.default_rng(0)
    x, q = rng.uniform(-1, 1, (192, 3)), rng.uniform(-1, 1, 192)
    spec = PartitionSpec(nparts=4, ncrit=24)
    geo = plan_geometry(x, q, spec, device="cpu")
    eps = float(geo.slack.min())
    assert np.isfinite(eps)
    x1 = x + np.random.default_rng(1).uniform(-eps / 4, eps / 4, x.shape)
    return geo, x1


def test_step_drift_failure_degrades_to_host_revalidation():
    geo, x1 = _step_case()
    sess = FMMSession(geo, device="cpu", resilience=True, fused=False)
    sess.evaluate()
    eng = sess.engine

    def boom(new_x):
        raise RuntimeError("device revalidation died")

    eng.step_drift = boom
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rep = sess.step(x1)
    assert sess.resilience.degraded
    fb = sess.resilience.fallbacks[0]
    assert (fb["site"], fb["from"], fb["to"]) == \
        ("engine.step_drift", "device_revalidation", "host")
    assert rep.version == sess.geometry.version and rep.rebuilt == ()
    plain = FMMSession(geo, device="cpu", fused=False)
    plain.evaluate()
    assert plain.step(x1).refreshed == rep.refreshed
    np.testing.assert_allclose(sess.evaluate(), plain.evaluate(), rtol=RTOL,
                               atol=ATOL)
    plain = FMMSession(geo, device="cpu", fused=False)
    plain.evaluate()
    plain.engine.step_drift = boom
    with pytest.raises(RuntimeError, match="revalidation died"):
        plain.step(x1)                     # resilience off: it raises


def test_mac_slack_audit_sends_a_bad_device_drift_to_the_host():
    """With resilience and health checks on, a within-slack step audits up
    to 4 partitions' device drifts against the exact host float64 ones: a
    clean step passes every audit, an underestimated device drift fails
    one, and the step takes the host revalidation's answer."""
    geo, x1 = _step_case()
    clean = FMMSession(geo, device="cpu", fused=False, resilience=True,
                       health_checks=True)
    clean.evaluate()
    rep_clean = clean.step(x1)
    assert clean.resilience.audits == {"checks": 4, "failures": 0}
    sess = FMMSession(geo, device="cpu", fused=False, resilience=True,
                      health_checks=True)
    sess.evaluate()
    real = sess.engine.step_drift

    def underestimate(new_x):
        delta, stale = real(new_x)
        return np.zeros_like(delta), stale

    sess.engine.step_drift = underestimate
    rep = sess.step(x1)
    assert sess.resilience.audits == {"checks": 1, "failures": 1}
    exact = [np.sqrt(((x1[i] - geo.x_ref[i]) ** 2).sum(axis=1).max())
             for i in geo.owners]
    assert rep.shift == tuple(exact)         # the host's float64 drifts
    assert rep.refreshed == rep_clean.refreshed and rep.rebuilt == ()
    np.testing.assert_allclose(sess.evaluate(), clean.evaluate(), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------- report -----
def test_report_resilience_block():
    x, q, spec = _problem(n=96, nparts=2)
    sess = _session(x, q, spec, resilience=True, engine=False)
    sess.evaluate()
    blk = sess.report()["resilience"]
    assert blk["enabled"] is True
    assert blk["degraded"] is False
    assert blk["rung"] == "reference"
    assert blk["fallbacks"] == []
    assert set(blk) >= {"retries", "health", "audits", "exchange_verified",
                        "health_checks"}
    jsess = JSession.from_points(x, q, JSpec(nparts=2, ncrit=48),
                                 resilience=True, engine=False)
    assert set(blk) == set(jsess.resilience.snapshot())


@pytest.mark.parametrize("rung", ["streaming", "gathered", "per_phase",
                                  "reference"])
def test_rung_mapping_round_trips(rung):
    """Applying a single-device rung and classifying the session returns
    it; `xla_slab` (the reference's plain near field) has no rung here."""
    x, q, spec = _problem(n=96, nparts=2)
    for start in (dict(), dict(fused=False), dict(p2p_stream=True),
                  dict(engine=False)):
        sess = _session(x, q, spec, **start)
        sess._apply_rung(rung)
        assert sess._current_rung() == rung and sess._engine is None
    with pytest.raises(ValueError, match="xla_slab"):
        sess._apply_rung("xla_slab")


# ------------------------------------------------------------ env / spec --
REF_SPECS = ["memo.upload, exe_cache.compile:3, fused.launch:*:0.5",
             "kernels.p2p.launch:2", "dist.build_program:*",
             " p2p.stream.tables:1:0.25 ,", ""]


def test_parse_spec_grammar():
    spec = res_faults.parse_spec(
        "memo.upload, exe_cache.compile:3, fused.launch:*:0.5")
    assert spec["memo.upload"] == {}
    assert spec["exe_cache.compile"] == {"count": 3}
    assert spec["fused.launch"] == {"count": None, "prob": 0.5}
    with pytest.raises(ValueError, match="unknown fault site"):
        res_faults.parse_spec("no.such.site")
    with pytest.raises(ValueError, match="malformed"):
        res_faults.parse_spec("memo.upload:1:0.5:oops")


@pytest.mark.parametrize("text", REF_SPECS)
def test_parse_spec_matches_reference(text):
    assert res_faults.parse_spec(text) == jfaults.parse_spec(text)


def test_env_arming(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "memo.upload:2")
    res_faults._arm_from_env()
    try:
        assert res_faults.active_plan() is not None
        with pytest.raises(InjectedFault):
            res_faults.fire("memo.upload")
    finally:
        res_faults.disarm()


def _firing_sequence(pkg, seed):
    """Which of 64 arrivals at a p = 0.5 site fire, in one package."""
    out = []
    with pkg.inject_faults({"memo.upload": {"count": None, "prob": 0.5}},
                           seed=seed):
        for _ in range(64):
            try:
                pkg.fire("memo.upload")
                out.append(0)
            except pkg.InjectedFault:
                out.append(1)
    pkg.reset_stats()
    return out


def test_probabilistic_plan_is_seed_deterministic():
    a, b = _firing_sequence(res_faults, 7), _firing_sequence(res_faults, 7)
    assert a == b and 0 < sum(a) < 64


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_probabilistic_plan_fires_like_reference(seed):
    assert _firing_sequence(res_faults, seed) == \
        _firing_sequence(jfaults, seed)


def test_nested_arming_rejected():
    with inject_faults("memo.upload"):
        with pytest.raises(RuntimeError, match="already armed"):
            with inject_faults("fused.launch"):
                pass


def test_fused_launch_fault_is_out_of_memory():
    with pytest.raises(torch.cuda.OutOfMemoryError, match="out of memory"):
        with inject_faults("fused.launch"):
            res_faults.fire("fused.launch")
    assert issubclass(InjectedResourceExhausted, InjectedFault)


def test_default_resilience_env(monkeypatch):
    x, q, spec = _problem(n=32, nparts=2)
    monkeypatch.setenv("REPRO_RESILIENCE", "1")
    assert _session(x, q, spec).resilience.enabled
    monkeypatch.setenv("REPRO_RESILIENCE", "0")
    assert not _session(x, q, spec).resilience.enabled


def test_exchange_verification_error_lives_in_resilience():
    assert tdist.ExchangeVerificationError is ExchangeVerificationError
    assert resilience.ExchangeVerificationError is \
        res_fb.ExchangeVerificationError
    err = ExchangeVerificationError("dist.exchange.verify", "bad span")
    assert err.site == "dist.exchange.verify" and str(err) == "bad span"


# ------------------------------------------------------ performance pins --
def test_disabled_fire_allocates_nothing():
    res_faults.disarm()
    for _ in range(100):                    # warm any lazy state
        res_faults.fire("memo.upload")
    tracemalloc.start()
    for _ in range(10_000):
        res_faults.fire("memo.upload")
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 8192, f"disabled fire() allocated {peak} bytes over 10k calls"


def test_warm_compiled_one_call_with_resilience_enabled():
    x, q, spec = _problem()
    sess = _session(x, q, spec, resilience=True, fused=True,
                    exe_cache=ExecutableCache())
    sess.evaluate()
    sess.evaluate()
    launches = sess.report()["launches"]
    assert launches["evaluate"]["calls"] == 2
    assert launches["fused_dispatches"] == 2
    assert not sess.resilience.degraded and sess.resilience.rung == "gathered"


# ------------------------------------------------ 4 stacked ranks, dist ---
def _dist_problem():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0, 1.0, size=(256, 3))
    q = rng.uniform(0.1, 1.0, size=256)
    return x, q, PartitionSpec(nparts=8, ncrit=48)


def test_dist_verify_and_fallback(monkeypatch):
    x, q, spec = _dist_problem()
    ref = _session(x, q, spec, engine=False).evaluate()

    # 1. exchange verification on 4 ranks: every span word-exact
    sess = _session(x, q, spec, mesh=stacked_mesh(4, "cpu"), fused=False)
    for protocol in ("bulk", "grain", "hsdx"):
        assert sess.dist.verify_exchange(protocol) > 0, protocol

    # 2. the REPRO_VERIFY_EXCHANGE session hook: once per (protocol, version)
    monkeypatch.setenv("REPRO_VERIFY_EXCHANGE", "1")
    sess.evaluate()
    sess.evaluate()
    assert sess.resilience.exchange_verified == 1

    # 3. a corrupted wire -> ExchangeVerificationError naming the check;
    #    raised without resilience, a dist -> engine fallback with it
    real_apply = prog_mod.apply_exchange

    def corrupt_apply(pools, program, rounds, mesh):
        out = real_apply(pools, program, rounds, mesh).clone()
        out[:, 0] += 1.0                    # a word in every rank's pool
        return out

    monkeypatch.setattr(prog_mod, "apply_exchange", corrupt_apply)
    sess2 = _session(x, q, spec, mesh=stacked_mesh(4, "cpu"))
    with pytest.raises(ExchangeVerificationError) as ei:
        sess2.evaluate()
    assert ei.value.site == "dist.exchange.verify"
    sess3 = _session(x, q, spec, mesh=stacked_mesh(4, "cpu"),
                     resilience=True, fused=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        phi = sess3.evaluate()
    fb = sess3.resilience.fallbacks
    assert [(f["site"], f["from"], f["to"]) for f in fb] == \
        [("dist.exchange.verify", "dist", "per_phase")]
    np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(prog_mod, "apply_exchange", real_apply)
    monkeypatch.delenv("REPRO_VERIFY_EXCHANGE")

    # 4. a dist failure -> single-device fallback, phi parity kept
    sess4 = _session(x, q, spec, mesh=stacked_mesh(4, "cpu"),
                     resilience=True, fused=False)
    assert sess4._current_rung() == "dist"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with inject_faults("dist.build_program"):
            phi = sess4.evaluate()
    st = sess4.resilience
    assert st.degraded and st.fallbacks[0]["from"] == "dist"
    assert st.fallbacks[0]["site"] == "dist.build_program"
    assert sess4.mesh is None
    np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)
