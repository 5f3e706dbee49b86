"""The port's compiled serving tier (repro_torch.core.engine.fused /
exe_cache) on the CPU, mirroring the reference's tests/test_fused.py where
its tests apply to the port.

On the CPU nothing is captured: a compiled entry runs its closure eagerly
over its own static buffers, so the cache counters, the table and payload
binding and the launch log are the same code as on the card, and the
compiled evaluate must equal the per-phase engine bit for bit (the same
phase functions, the same float64 accumulation).  Against the reference's
fused engine under x64 (device float64 accumulation) it is held at the
engine tolerance of tests/test_engine.py, rtol 1e-6 / atol 2e-5.

The tests share one module-scoped session and a private cache, and then
count cache traffic; the reference's oracle compiles one jitted program
per shape (~3 s), so it is built once.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine import (DeviceEngine, ExecutableCache,
                                     default_fused_enabled,
                                     shape_class_digest)
from repro_torch.core.engine import fused as fused_mod
from repro_torch.core.engine.exe_cache import CompiledEntry

RTOL, ATOL = 1e-6, 2e-5          # x64 engine tolerances (test_engine.py)
CPU = torch.device("cpu")


def _problem(n=700, seed=11, qseed=12):
    x = make_distribution("sphere", n, seed=seed)
    q = np.random.default_rng(qseed).uniform(-1, 1, n)
    return x, q


@pytest.fixture(scope="module")
def shared():
    """One compiled session with a private cache, and the per-phase session
    on the same geometry."""
    x, q = _problem()
    spec = PartitionSpec(nparts=3, ncrit=48)
    cache = ExecutableCache()
    sess = FMMSession.from_points(x, q, spec, device="cpu", fused=True,
                                  exe_cache=cache)
    per_phase = FMMSession(sess.geometry, device="cpu", fused=False)
    return {"x": x, "q": q, "spec": spec, "cache": cache, "sess": sess,
            "per_phase": per_phase, "phi": per_phase.evaluate()}


# ------------------------------------------------------------- numerics ----
@pytest.mark.parametrize("stream", [False, True])
def test_fused_matches_per_phase_bitwise(shared, stream):
    """The compiled evaluate runs the per-phase engine's phase functions
    and accumulation over copies of the same tensors: equal bit for bit, on
    the gathered route and on the stream route."""
    if not stream:
        assert shared["sess"].engine.fused
        np.testing.assert_array_equal(shared["sess"].evaluate(),
                                      shared["phi"])
        return
    geo = shared["sess"].geometry
    got = FMMSession(geo, device="cpu", p2p_stream=True, fused=True,
                     exe_cache=ExecutableCache())
    want = FMMSession(geo, device="cpu", p2p_stream=True, fused=False)
    np.testing.assert_array_equal(got.evaluate(), want.evaluate())
    assert got.engine._entries["evaluate"].key[-1] == "stream"


@pytest.fixture(scope="module")
def reference_fused():
    """repro's fused engine (float64 accumulation under x64) and the port's
    compiled engine on the same geometry inputs (N = 500, 3 parts)."""
    import jax

    from repro.core.api import PartitionSpec as JSpec
    from repro.core.api import plan_geometry as jplan
    from repro.core.engine import DeviceEngine as JEngine
    from repro.core.engine import ExecutableCache as JCache
    x, q = _problem(n=500, seed=21, qseed=22)
    geo_r = jplan(x, q, JSpec(nparts=3, ncrit=48, traversal_backend="host"))
    jax.config.update("jax_enable_x64", True)
    try:
        eng = JEngine(geo_r, use_kernels=False, fused=True,
                      exe_cache=JCache())
        want = np.asarray(eng.evaluate_device())
    finally:
        jax.config.update("jax_enable_x64", False)
    geo = plan_geometry(x, q, PartitionSpec(nparts=3, ncrit=48),
                        device="cpu")
    return geo, want


def test_fused_matches_reference_fused_x64(reference_fused):
    geo, want = reference_fused
    got = DeviceEngine.from_geometry(geo, device="cpu", fused=True,
                                     exe_cache=ExecutableCache()).evaluate()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -------------------------------------------------------- call counting ----
def test_fused_warm_evaluate_is_one_call(shared):
    """A warm compiled evaluate is exactly one call of one entry (one replay
    on the card), logged once, with no rebinding of tables or payload."""
    sess = shared["sess"]
    sess.evaluate()
    eng = sess.engine
    entry = eng._entries["evaluate"]
    calls, n_log = entry.calls, len(eng.launch_log)
    x_buf = entry.inputs["x"]
    sess.evaluate()
    assert entry.calls == calls + 1
    assert [k for k, _ in eng.launch_log[n_log:]] == ["evaluate"]
    assert entry.inputs["x"] is x_buf and entry.owner == eng._token


def test_fused_step_within_slack_matches_per_phase(shared):
    """A within-slack step through the compiled session is one call of the
    step entry, and the evaluate after it equals the per-phase session
    stepped the same way, bit for bit."""
    x, q = shared["x"], shared["q"]
    sess = FMMSession.from_points(x, q, shared["spec"], device="cpu",
                                  fused=True, exe_cache=ExecutableCache())
    pp = FMMSession(sess.geometry, device="cpu", fused=False)
    sess.evaluate()
    pp.evaluate()
    eng = sess.engine
    new_x = x + np.random.default_rng(31).uniform(
        -1, 1, x.shape) * float(sess.geometry.slack.min()) / 4
    n_log = len(eng.launch_log)
    rep, rep_pp = sess.step(new_x), pp.step(new_x)
    assert rep.rebuilt == rep_pp.rebuilt == ()
    assert rep.refreshed == rep_pp.refreshed and rep.refreshed
    assert rep.shift == rep_pp.shift
    assert [k for k, _ in eng.launch_log[n_log:]] == ["step"]
    assert eng._entries["step"].calls == 1
    assert sess.engine is eng
    np.testing.assert_array_equal(sess.evaluate(), pp.evaluate())


# --------------------------------------------------- shape-class caching ---
def test_second_same_shape_class_geometry_zero_compiles(shared):
    """A new geometry over identical points shares the shape class: its
    session is served from the cache with no new compile and one hit."""
    cache = shared["cache"]
    shared["sess"].evaluate()
    stats0 = cache.stats()
    sess2 = FMMSession.from_points(shared["x"].copy(), shared["q"].copy(),
                                   shared["spec"], device="cpu", fused=True,
                                   exe_cache=cache)
    phi2 = sess2.evaluate()
    assert cache.misses == stats0["misses"]
    assert cache.hits == stats0["hits"] + 1
    assert sess2.exe_cache_stats["misses"] == cache.misses
    assert sess2.engine._entries["evaluate"] is \
        shared["sess"].engine._entries["evaluate"]
    np.testing.assert_array_equal(phi2, shared["phi"])


def test_different_shape_class_geometry_compiles(shared):
    """Another partition count changes the stacked envelopes: a new shape
    class, one miss."""
    cache = shared["cache"]
    misses0 = cache.misses
    sess = FMMSession.from_points(shared["x"], shared["q"],
                                  PartitionSpec(nparts=2, ncrit=48),
                                  device="cpu", fused=True, exe_cache=cache)
    sess.evaluate()
    assert cache.misses == misses0 + 1


def test_alternating_geometries_of_one_shape_class(shared):
    """The points reflected through the origin plan to the same shape class
    with other table values.  Evaluated alternately with the first session
    through one shared entry, each session rebinds its own tables and gets
    its own per-phase potential, bit for bit."""
    cache = ExecutableCache()
    a = FMMSession(shared["sess"].geometry, device="cpu", fused=True,
                   exe_cache=cache)
    b = FMMSession.from_points(-shared["x"], shared["q"], shared["spec"],
                               device="cpu", fused=True, exe_cache=cache)
    fa = fused_mod.flatten_eval_tables(a.engine.tables)
    fb = fused_mod.flatten_eval_tables(b.engine.tables)
    assert shape_class_digest(fa) == shape_class_digest(fb)
    assert any(not torch.equal(fa[k], fb[k]) for k in fa)
    want_b = FMMSession(b.geometry, device="cpu", fused=False).evaluate()
    assert not np.array_equal(want_b, shared["phi"])
    for sess, want in [(a, shared["phi"]), (b, want_b)] * 2:
        np.testing.assert_array_equal(sess.evaluate(), want)
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 1
    assert a.engine._entries["evaluate"].rebinds == 3


def test_executable_key_sensitivity():
    """The key separates every field that changes the captured call, and
    thetas within one 1/16 bucket share an entry."""
    kw = dict(n=100, n_parts=4, p=4, theta=0.5, backend="cpu",
              launch=(4, 4), p2p_impl="gathered")
    base = fused_mod.executable_key("evaluate", "digest0", **kw)
    assert base == fused_mod.executable_key("evaluate", "digest0", **kw)
    assert base != fused_mod.executable_key("step", "digest0", **kw)
    assert base != fused_mod.executable_key("evaluate", "digest1", **kw)
    for field, value in [("n", 101), ("n_parts", 5), ("p", 6),
                         ("theta", 0.6), ("backend", "cuda:0"),
                         ("launch", (4, 2)), ("p2p_impl", "stream")]:
        assert base != fused_mod.executable_key(
            "evaluate", "digest0", **{**kw, field: value}), field
    assert fused_mod.theta_bucket(0.5) == fused_mod.theta_bucket(0.52)
    assert base == fused_mod.executable_key("evaluate", "digest0",
                                            **{**kw, "theta": 0.52})


def test_shape_class_digest_reads_dtypes_and_shapes_only():
    a = {"i": torch.arange(6), "f": torch.zeros(2, 3)}
    assert shape_class_digest(a) == shape_class_digest(
        {"i": torch.arange(6) + 7, "f": torch.ones(2, 3)})
    assert shape_class_digest(a) != shape_class_digest(
        {"i": torch.arange(6, dtype=torch.int32), "f": torch.zeros(2, 3)})
    assert shape_class_digest(a) != shape_class_digest(
        {"i": torch.arange(6), "f": torch.zeros(3, 2)})


def test_exe_cache_lru_eviction_and_counters():
    """LRU order refreshed on a hit, eviction at the bound, exact counters,
    an undersized bound rejected, a failed compile inserting nothing."""
    cache = ExecutableCache(maxsize=2)
    made = []

    def compiler(tag):
        def fn():
            made.append(tag)
            return CompiledEntry(tag, lambda: (), {}, CPU)
        return fn

    a = cache.get_or_compile("a", compiler("a"))
    cache.get_or_compile("b", compiler("b"))
    assert cache.get_or_compile("a", compiler("a2")) is a
    cache.get_or_compile("c", compiler("c"))                # evicts b
    assert made == ["a", "b", "c"]
    assert "b" not in cache and "a" in cache and "c" in cache
    assert len(cache) == 2 and cache.keys() == ["a", "c"]
    assert cache.stats() == {"hits": 1, "misses": 3, "evictions": 1,
                             "size": 2, "maxsize": 2}
    cache.get_or_compile("b", compiler("b2"))
    assert made[-1] == "b2"

    def broken():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get_or_compile("d", broken)
    assert "d" not in cache and cache.misses == 5
    with pytest.raises(ValueError, match="maxsize"):
        ExecutableCache(maxsize=0)


def test_evicted_entry_keeps_serving_its_engine(shared):
    """An entry the LRU evicts keeps working for the engine holding it."""
    cache = ExecutableCache(maxsize=1)
    sess = FMMSession(shared["sess"].geometry, device="cpu", fused=True,
                      exe_cache=cache)
    sess.evaluate()
    other = FMMSession.from_points(shared["x"], shared["q"],
                                   PartitionSpec(nparts=2, ncrit=48),
                                   device="cpu", fused=True, exe_cache=cache)
    other.evaluate()
    assert cache.evictions == 1 and len(cache) == 1
    np.testing.assert_array_equal(sess.evaluate(), shared["phi"])


# ------------------------------------------------------- no-alias contract --
def test_memo_guard_rejects_resident_tensor(shared):
    """A `DeviceMemo`-resident tensor is never taken as a payload buffer:
    the engine writes its payload in place, and the memo serves the same
    tensor to every other consumer."""
    sess = shared["sess"]
    eng = sess.engine
    host_arr = np.zeros((3, 4), np.float32)      # the memo keys on it
    view = sess.memo(host_arr)
    assert sess.memo.is_resident(view)
    with pytest.raises(TypeError, match="DeviceMemo"):
        eng._bindable(view)
    t = eng.tables
    host_pad = np.zeros((t.n_parts, t.n_bodies_max, 3), np.float32)
    x_pad = sess.memo(host_pad)
    with pytest.raises(TypeError, match="DeviceMemo"):
        DeviceEngine(t, x_pad, np.zeros((t.n_parts, t.n_bodies_max)),
                     device="cpu", memo=sess.memo)
    host = eng._bindable(np.ones((4, 3)))
    assert host.dtype == torch.float32 and not sess.memo.is_resident(host)
    own = torch.ones(4, 3)
    assert eng._bindable(own) is not own


def test_fused_default_off_on_cpu():
    """Compiled serving is the default on a CUDA device only; on the CPU
    it is opt-in (nothing is captured there)."""
    assert default_fused_enabled("cpu") is False
    assert default_fused_enabled("cuda") is True
    x, q = _problem(n=200)
    geo = plan_geometry(x, q, PartitionSpec(nparts=2, ncrit=48),
                        device="cpu")
    assert DeviceEngine.from_geometry(geo, device="cpu").fused is False
    assert FMMSession(geo, device="cpu").engine.fused is False
    sess = FMMSession(geo, device="cpu", fused=True,
                      exe_cache=ExecutableCache())
    sess.evaluate()
    entry = sess.engine._entries["evaluate"]
    assert entry.call.graph is None and entry.launches == {}


def test_dropped_compiled_session_frees_its_entry_without_the_collector():
    """A compiled entry holds no reference back to its engine or session
    (its call closes over the fused function and its own static buffers),
    so with the cyclic collector off a session and its engine go when
    dropped, and the entry with them once no cache holds it."""
    import gc
    import weakref
    x, q = _problem(n=300)
    spec = PartitionSpec(nparts=3, ncrit=48)
    collecting = gc.isenabled()
    gc.disable()
    try:
        cache = ExecutableCache()
        sess = FMMSession.from_points(x, q, spec, device="cpu", fused=True,
                                      exe_cache=cache)
        sess.evaluate()
        sess.evaluate()
        (key,) = cache.keys()
        entry = cache.get_or_compile(key, None)
        refs = (weakref.ref(sess), weakref.ref(sess.engine),
                weakref.ref(entry.call), weakref.ref(entry.inputs["x"]))
        del sess, entry
        assert [r() for r in refs[:2]] == [None, None]
        assert refs[2]() is not None            # the cache still holds it
        cache.clear()
        assert [r() for r in refs] == [None] * 4
    finally:
        if collecting:
            gc.enable()
