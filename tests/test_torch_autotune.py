"""The port's launch autotune and its disk cache (repro_torch.kernels.p2p:
`best_p2p_warps`, `best_stream_params`, `_load_persisted` /
`_save_persisted`; `kernels.ops.p2p_auto`), against the reference's
(repro.kernels.p2p), on the CPU.

The first part ports the reference's own tests of the cache:
tests/test_kernels.py's autotune-persistence tests, tests/test_resilience.py's
cache-hardening tests and tests/test_engine.py's shape-class key.  A timed
sweep runs only on the card, so the measured path is driven here through a
fake: `measurable` answers True, `_time_k1` returns set times (K1's warps
8 the fastest) and `backend_key` a fixed card key; the stream sweep takes a
fake `measure`, as the reference's test does.  K1's candidates are warps a
block (1..16) where the reference's are target blocks (128..512).

The second part holds the two packages together: the stream heuristic and
`effective_block_t` equal over a grid, one cache file written by both
packages' `_save_persisted` read by each for its own entries only, an
engine's stream route on the CPU choosing the reference's block_t, and a
CPU session writing no file.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core.api import FMMSession as JSession
from repro.core.api import PartitionSpec as JSpec
from repro.kernels import p2p as jkp
from repro_torch import obs
from repro_torch.core.api import FMMSession, PartitionSpec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import p2p as kp
from repro_torch.resilience import fallback as res_fb
from repro_torch.resilience import faults as res_faults
from repro_torch.resilience import inject_faults

CARD = "cuda:fake card:sm_90:p2p-0123456789abcdef:p2p_stream-fedcba9876543210"
FAKE_MS = {1: 4.0, 2: 3.0, 4: 2.0, 8: 1.0, 16: 1.5}   # warps 8 wins


def _reset_port_state():
    obs.configure(enabled=False)
    obs.reset()
    res_faults.disarm()
    res_faults.reset_stats()
    res_fb.reset_ledger()


@pytest.fixture(autouse=True)
def _port_state():
    """The port's recorder, fault plan and ledgers reset around each test
    (tests/conftest.py resets the reference's only)."""
    _reset_port_state()
    yield
    _reset_port_state()


@pytest.fixture
def sandbox(monkeypatch, tmp_path):
    """A tmp cache file and a cold in-memory state of the port's autotune."""
    path = tmp_path / "cache.json"
    monkeypatch.setenv("REPRO_P2P_CACHE_PATH", str(path))
    monkeypatch.delenv("REPRO_P2P_CACHE", raising=False)
    monkeypatch.setattr(kp, "_WARPS_CACHE", {})
    monkeypatch.setattr(kp, "_STREAM_CACHE", {})
    monkeypatch.setattr(kp, "_PERSIST_LOADED", False)
    monkeypatch.setattr(kp, "_PERSIST_BROKEN", False)
    monkeypatch.setattr(kp, "_QUARANTINED", False)
    monkeypatch.setattr(kp, "sweeps", [])
    return path


@pytest.fixture
def measured(monkeypatch, sandbox):
    """K1's sweep through a fake timer on the card's key; returns the
    warps timed, in order."""
    calls = []

    def fake_time(sample, warps):
        calls.append(warps)
        return FAKE_MS[warps]

    monkeypatch.setattr(kp, "measurable", lambda t: True)
    monkeypatch.setattr(kp, "_time_k1", fake_time)
    monkeypatch.setattr(kp, "backend_key", lambda: CARD)
    return calls


def _sample(P, S, T):
    return (torch.zeros(P, S), torch.zeros(P, S, 3), torch.zeros(P, T, 3))


def _entries(path):
    data = json.loads(path.read_text())
    assert data["version"] == kp._SCHEMA_VERSION
    return data["entries"]


def _fresh_process(monkeypatch):
    """What a new process sees: empty in-memory caches, the file unread."""
    monkeypatch.setattr(kp, "_WARPS_CACHE", {})
    monkeypatch.setattr(kp, "_STREAM_CACHE", {})
    monkeypatch.setattr(kp, "_PERSIST_LOADED", False)


# ------------------------------------------------ autotune persistence ----
def test_autotune_persists_measured_choice(monkeypatch, sandbox, measured):
    """A measured sweep writes its choice under (card key, "S,n,T"); a
    fresh process reloads it without timing anything."""
    choice = kp.best_p2p_warps(64, 2, 40, sample=_sample(2, 64, 40))
    assert choice == 8 and measured == list(kp.WARP_CANDIDATES)
    assert _entries(sandbox)[CARD]["64,2,40"] == 8
    (rec,) = kp.sweeps
    assert rec["kind"] == "K1" and rec["key"] == (64, 2, 40)
    assert rec["ms"] == FAKE_MS and rec["heuristic"] == 1

    _fresh_process(monkeypatch)
    measured.clear()
    assert kp.best_p2p_warps(64, 2, 40, sample=_sample(2, 64, 40)) == 8
    assert measured == []               # served from disk, no sweep


def test_autotune_legacy_unversioned_cache_migrates(monkeypatch, sandbox,
                                                    measured):
    """The unversioned v1 layout loads silently; the first save rewrites the
    file as version 2 keeping the migrated entries; a future version is
    ignored, never misread."""
    sandbox.write_text(json.dumps({CARD: {"64,2,40": 2}}))
    assert kp.best_p2p_warps(64, 2, 40, sample=_sample(2, 64, 40)) == 2
    assert measured == []

    kp.best_p2p_warps(128, 2, 200, sample=_sample(2, 128, 200))
    entries = _entries(sandbox)
    assert entries[CARD]["64,2,40"] == 2          # survived migration
    assert entries[CARD]["128,2,200"] == 8

    sandbox.write_text(json.dumps(
        {"version": 99, "entries": {CARD: {"64,2,40": 16}}}))
    _fresh_process(monkeypatch)
    measured.clear()
    assert kp.best_p2p_warps(64, 2, 40, sample=_sample(2, 64, 40)) == 8
    assert measured                     # not served from the future file


def test_stream_autotune_heuristic_and_persistence(monkeypatch, sandbox):
    """Without a measure (the CPU) `best_stream_params` caches the
    reference's block_t and no warps, touching no disk; a measured sweep
    over (block_t, warps) persists [block_t, warps] under "stream:", and a
    fresh process reloads it without measuring."""
    bt, w = kp.best_stream_params(256, 40, 64)
    assert (bt, w) == (jkp._heuristic_stream_params(256, 64)[0], None)
    assert not sandbox.exists()

    monkeypatch.setattr(kp, "backend_key", lambda: CARD)
    seen = []

    def fake_measure(block_t, warps):
        seen.append((block_t, warps))
        return 0.1 if (block_t, warps) == (256, 2) else 1.0

    monkeypatch.setattr(kp, "_STREAM_CACHE", {})
    assert kp.best_stream_params(256, 40, 200, measure=fake_measure) \
        == (256, 2)
    # block_t candidates collapse to the 128-aligned cover of wt_max = 200
    assert sorted(set(seen)) == [(bt, w) for bt in (128, 256)
                                 for w in kp.WARP_CANDIDATES]
    assert len(seen) == 3 * 2 * len(kp.WARP_CANDIDATES)  # 3 measures each
    assert _entries(sandbox)[CARD]["stream:256,40,200"] == [256, 2]

    _fresh_process(monkeypatch)
    seen.clear()
    assert kp.best_stream_params(256, 40, 200, measure=fake_measure) \
        == (256, 2)
    assert seen == []                   # served from disk, no sweep


def test_autotune_persistence_env_opt_out(monkeypatch, sandbox, measured):
    monkeypatch.setenv("REPRO_P2P_CACHE", "0")
    assert kp.best_p2p_warps(64, 1, 40, sample=_sample(1, 64, 40)) == 8
    assert measured                     # measured in-process...
    assert not sandbox.exists()         # ...but never persisted


def test_autotune_on_the_cpu_never_touches_disk(sandbox):
    """On the CPU (a sample of CPU tensors, or none) the choice is K1's
    heuristic, cached in memory; the file is never read or written."""
    w = kp.best_p2p_warps(64, 3, 32, sample=_sample(3, 64, 32))
    assert w == kp.p2p_launch_params(3) and w in kp.WARP_CANDIDATES
    assert kp.best_p2p_warps(64, 900, 32) == kp.p2p_launch_params(900)
    assert not sandbox.exists()
    assert kp._PERSIST_LOADED is False  # load path skipped entirely
    assert kp.sweeps == [] and kp.sweep_launches == 0


def test_autotune_unwritable_cache_degrades_warn_once(monkeypatch, sandbox,
                                                      measured, tmp_path):
    """A cache path under a regular file warns exactly once, flips to
    in-memory-only operation, keeps tuning, and never warns or touches the
    disk again."""
    blocker = tmp_path / "blocker"
    blocker.write_text("a file, not a cache directory")
    monkeypatch.setenv("REPRO_P2P_CACHE_PATH", str(blocker / "cache.json"))

    def sweep(S):
        return kp.best_p2p_warps(S, 2, 40, sample=_sample(2, S, 40))

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert sweep(64) == 8                     # degraded, still tuned
    assert kp._PERSIST_BROKEN is True
    runtime = [x for x in w if issubclass(x.category, RuntimeWarning)]
    assert len(runtime) == 1
    assert "p2p autotune cache disabled" in str(runtime[0].message)
    assert "REPRO_P2P_CACHE" in str(runtime[0].message)

    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        c2 = sweep(128)
        measured.clear()
        assert sweep(128) == c2                   # in-memory hit
        assert measured == []
    assert not [x for x in w2 if issubclass(x.category, RuntimeWarning)]
    assert not blocker.is_dir()


# -------------------------------------------------- cache hardening ------
def test_corrupt_cache_quarantined_warn_once(sandbox):
    sandbox.write_text('{"version": 2, "entries": {"' + CARD + '": {TRUNC')
    obs.configure(enabled=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        kp._load_persisted(CARD)            # must not raise
        kp._PERSIST_LOADED = False
        kp._load_persisted(CARD)            # second sight: silent
    assert len([m for m in w if "corrupt" in str(m.message)]) == 1
    assert os.path.exists(str(sandbox) + ".corrupt")
    assert obs.metrics_snapshot()["counters"]["p2p.cache.quarantined"] == 1
    assert not kp._PERSIST_BROKEN           # location usable: persistence on
    kp._save_persisted(CARD, "64,4,128", 4)
    assert _entries(sandbox)[CARD]["64,4,128"] == 4


def test_corrupt_cache_on_save_merge_quarantines(sandbox):
    sandbox.write_text("not json at all")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        kp._save_persisted(CARD, "64,4,128", 16)
    assert any("corrupt" in str(m.message) for m in w)
    assert _entries(sandbox)[CARD]["64,4,128"] == 16


@pytest.mark.parametrize("site,action", [("p2p.cache.read", "read"),
                                         ("p2p.cache.write", "write")])
def test_injected_cache_io_fault_absorbed_locally(sandbox, site, action):
    """Each seam arms, fires once, and is absorbed where it fires: one
    warning, the fallback disk_cache -> in_memory recorded, no typed
    error, persistence off."""
    sandbox.write_text('{"version": 2, "entries": {}}')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with inject_faults(site):
            if action == "read":
                kp._load_persisted(CARD)
            else:
                kp._save_persisted(CARD, "64,4,128", 4)
    assert kp._PERSIST_BROKEN
    assert len([m for m in w if issubclass(m.category, RuntimeWarning)]) == 1
    assert res_fb.ledger_counts()["fallbacks"] == {site: 1}
    assert res_fb.typed_error_total() == 0
    assert res_faults.fired_counts() == {site: 1}


# ------------------------------------------------ shape-class cache key --
def test_p2p_autotune_cache_keyed_by_bucket_shape(sandbox):
    """One decision per (S, n_pairs, T); repeats are hits.  The heuristic
    is `p2p_launch_params`, fewer warps for small row counts."""
    obs.configure(enabled=True)
    w1 = kp.best_p2p_warps(64, 7, 32)
    assert kp.best_p2p_warps(64, 7, 32) == w1
    assert list(kp._WARPS_CACHE) == [(64, 7, 32)]
    kp.best_p2p_warps(128, 3, 32)
    assert len(kp._WARPS_CACHE) == 2
    kp.best_p2p_warps(64, 7, 512)      # another target width: another class
    assert len(kp._WARPS_CACHE) == 3
    assert kp.best_p2p_warps(64, 1 << 16, 32) == 4
    counters = obs.metrics_snapshot()["counters"]
    assert counters["p2p.autotune.decisions"] == 4
    assert counters["p2p.autotune.cache_hits"] == 1
    ev = [e for e in obs.get_tracer().events
          if isinstance(e, dict) and e["name"] == "p2p.autotune"]
    assert [e["attrs"]["mode"] for e in ev] == ["heuristic"] * 4


def test_p2p_auto_on_the_cpu_is_the_plain_version(sandbox):
    """`p2p_auto` on CPU tensors is `p2p_ref`, and consults no cache, as
    the reference's engine on the CPU launches no kernel."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(-1, 1, (3, 16)).astype(np.float32))
    xs = torch.as_tensor(rng.uniform(-1, 1, (3, 16, 3)).astype(np.float32))
    xt = torch.as_tensor(rng.uniform(-1, 1, (3, 24, 3)).astype(np.float32))
    assert torch.equal(tops.p2p_auto(q, xs, xt), kp.p2p_ref(q, xs, xt))
    assert kp._WARPS_CACHE == {}
    with pytest.raises(TypeError, match="float32"):
        tops.p2p_auto(q.double(), xs, xt)


# ------------------------------------------------------- across packages --
@pytest.mark.parametrize("smax", [16, 64, 256, 1024, 4096])
def test_stream_heuristic_and_effective_block_t_match_reference(smax):
    for wt_max in (1, 40, 64, 128, 129, 200, 256, 300, 512, 1000):
        assert kp.heuristic_stream_params(smax, wt_max) \
            == jkp._heuristic_stream_params(smax, wt_max)
        for bt in kp.BLOCK_CANDIDATES:
            assert kp.effective_block_t(wt_max, bt) \
                == jkp.effective_block_t(wt_max, bt)


def test_shared_cache_file_keeps_each_package_to_its_entries(
        monkeypatch, sandbox):
    """One file written by both packages' `_save_persisted`: each reads its
    own backend's entries only; the port's backend never names the
    reference's."""
    monkeypatch.setattr(jkp, "_BLOCK_CACHE", {})
    monkeypatch.setattr(jkp, "_STREAM_CACHE", {})
    monkeypatch.setattr(jkp, "_PERSIST_LOADED", False)
    monkeypatch.setattr(jkp, "_PERSIST_BROKEN", False)
    jkp._save_persisted("cpu", "64,4,128", 256)
    kp._save_persisted(CARD, "64,4,128", 8)
    jkp._save_persisted("cpu", "stream:64,10,40", [128, 3])
    kp._save_persisted(CARD, "stream:64,10,40", [128, 16])
    entries = _entries(sandbox)
    assert set(entries) == {"cpu", CARD}
    jkp._load_persisted("cpu")
    kp._load_persisted(CARD)
    assert jkp._BLOCK_CACHE == {(64, 4, 128): 256}
    assert jkp._STREAM_CACHE == {(64, 10, 40): (128, 3)}
    assert kp._WARPS_CACHE == {(64, 4, 128): 8}
    assert kp._STREAM_CACHE == {(64, 10, 40): (128, 16)}
    # the reference's values are no launch shape of the port's kernels
    _fresh_process(monkeypatch)
    kp._load_persisted("cpu")
    assert kp._WARPS_CACHE == {} and kp._STREAM_CACHE == {}


def _points(n=192, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 3)), rng.uniform(-1, 1, n)


def test_cpu_stream_route_chooses_the_reference_block_t(monkeypatch,
                                                        sandbox):
    """The engine's stream tables on the CPU: the autotune gives the
    reference's heuristic block_t (its interpret-mode choice) and K2's
    heuristic warps, with one decision counted as the reference counts."""
    monkeypatch.setattr(jkp, "_STREAM_CACHE", {})
    x, q = _points()
    js = JSession.from_points(x, q, JSpec(nparts=4, ncrit=24), engine=True,
                              fused=False, use_kernels=False,
                              p2p_stream=True)
    js.evaluate()
    obs.configure(enabled=True)
    ts = FMMSession.from_points(x, q, PartitionSpec(nparts=4, ncrit=24),
                                device="cpu", fused=False, p2p_stream=True)
    phi = ts.evaluate()
    stream = ts.engine.stream_tables()
    assert stream["block_t"] == js.engine._stream_params[0]
    assert stream["warps"] is None
    np.testing.assert_allclose(phi, js.evaluate(), rtol=1e-5, atol=1e-5)
    counters = obs.metrics_snapshot()["counters"]
    assert counters["p2p.autotune.decisions"] == 1
    assert not sandbox.exists()


@pytest.mark.parametrize("stream", [False, True])
def test_cpu_session_writes_no_cache_file(sandbox, stream):
    """A CPU session, compiled or not, on either route, evaluates without
    creating the cache file or timing a launch."""
    x, q = _points(seed=1)
    for fused in (False, True):
        sess = FMMSession.from_points(x, q, PartitionSpec(nparts=4, ncrit=24),
                                      device="cpu", fused=fused,
                                      p2p_stream=stream)
        assert np.isfinite(sess.evaluate()).all()
    assert not sandbox.exists()
    assert kp._PERSIST_LOADED is False
    assert kp.sweeps == []
