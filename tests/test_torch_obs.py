"""The port's flight recorder (repro_torch.obs) and its hooks, held against
the reference's (repro.obs).

The first part ports tests/test_obs.py's 18 tests: span nesting and
ordering, the disabled-mode zero-allocation pin (tracemalloc), the
chrome-trace schema, metrics-registry isolation, the non-raising stats
surfaces, one compiled call per warm evaluate under tracing, and the
exchange probe on 4 ranks (stacked in this process, on the CPU: wire bytes
== rank-aggregated `GeometryPlan.bytes_matrix`, a finite `model_drift` per
protocol).

The second part runs both packages on the same inputs (numpy, seeded):
with tracing on, `plan_geometry`, `evaluate`, a within-slack `step` and
`sweep()` give the same set of (span, parent span) names and the same
counters, apart from the names listed in `LEFT_OUT`; on 4 ranks (the port
stacked, the reference on 4 virtual XLA devices in a subprocess) the same
`dist.*` spans and events with the same byte accounting.
"""
import json
import os
import subprocess
import sys
import textwrap
import tracemalloc

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.api import FMMSession as JSession
from repro.core.api import PartitionSpec as JSpec
from repro.kernels import p2p as jkp
from repro_torch import obs
from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
from repro_torch.core.engine import ExecutableCache
from repro_torch.kernels import p2p as tkp
from repro_torch.launch.mesh import stacked_mesh
from repro_torch.resilience import fallback as res_fb
from repro_torch.resilience import faults as res_faults

ROOT = os.path.join(os.path.dirname(__file__), "..")

# counters one package has and the other has not, by design:
#   engine.donate.*  the reference donates its payload to the fused program,
#                    the port copies into a compiled entry's static buffers;
#   memo.*           each package meters the uploads of its own table layout
#                    (the reference's engine uploads its tables through the
#                    session memo, the port's engine holds them itself).
# `p2p.autotune.*` is held alike: on the CPU both packages consult the
# autotune on the stream route only (the heuristic block_t, once an engine).
LEFT_OUT = ("engine.donate.", "memo.")


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
    """The port's recorder, fault plan and ledgers are process-wide, as the
    reference's are (tests/conftest.py resets those): reset them around
    every test."""
    def reset():
        obs.configure(enabled=False)
        obs.reset()
        res_faults.disarm()
        res_faults.reset_stats()
        res_fb.reset_ledger()
    reset()
    yield
    reset()


def _toy_points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)), rng.uniform(-1, 1, n)


# ------------------------------------------------------------- tracer -----
def test_span_nesting_and_ordering():
    tr = obs.configure(enabled=True)
    with obs.span("outer", {"k": 1}):
        with obs.span("inner.a"):
            pass
        with obs.span("inner.b"):
            pass
    spans = tr.spans()
    assert [s.name for s in spans] == ["inner.a", "inner.b", "outer"]
    outer = spans[2]
    assert outer.attrs == {"k": 1}
    assert spans[0].parent == outer.sid == spans[1].parent
    assert outer.parent == -1
    assert spans[0].sid < spans[1].sid          # monotonic ids
    for s in spans:
        assert s.t1_ns >= s.t0_ns >= 0
    assert outer.t0_ns <= spans[0].t0_ns and spans[1].t1_ns <= outer.t1_ns


def test_span_set_merges_attrs_and_summary_aggregates():
    tr = obs.configure(enabled=True)
    for i in range(3):
        with obs.span("work", {"i": i}) as sp:
            sp.set({"extra": i * 10})
    assert tr.spans("work")[1].attrs == {"i": 1, "extra": 10}
    summ = tr.summary()
    assert summ["work"]["count"] == 3
    assert summ["work"]["total_s"] >= summ["work"]["max_s"] > 0
    assert summ["work"]["mean_s"] == pytest.approx(
        summ["work"]["total_s"] / 3)


def test_events_record_instants_with_parent_span():
    tr = obs.configure(enabled=True)
    with obs.span("phase") as sp:
        obs.event("probe", {"x": 1})
    evs = [e for e in tr.events if isinstance(e, dict)]
    assert len(evs) == 1 and evs[0]["name"] == "probe"
    assert evs[0]["parent"] == sp.sid
    assert evs[0]["attrs"] == {"x": 1}


def test_ring_drop_bounds_memory():
    tr = obs.configure(enabled=True, max_events=100)
    for _ in range(500):
        obs.event("e")
    assert len(tr.events) <= 100
    assert tr.dropped >= 400


def test_disabled_mode_is_zero_allocation():
    """The overhead pin: with tracing off, span/event/counter calls on a hot
    loop must not allocate (NULL_SPAN singleton, early-return helpers)."""
    obs.configure(enabled=False)
    d = {"n": 7}                     # pre-built attrs, as the contract asks

    def hot(iters):
        for _ in iters:
            with obs.span("hot.loop", d) as sp:
                sp.fence(d)
            obs.event("hot.event", d)
            obs.counter_add("hot.counter")
            obs.observe("hot.hist", 1.0)

    import itertools
    hot(itertools.repeat(None, 100))            # warm any lazy init
    it = itertools.repeat(None, 10_000)
    tracemalloc.start()
    hot(it)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 8192, f"disabled obs hot path allocated {peak} bytes"


def test_chrome_trace_schema():
    tr = obs.configure(enabled=True)
    with obs.span("a", {"n": 2}):
        obs.event("marker", {"why": "test"})
    ct = tr.to_chrome_trace()
    json.dumps(ct)                               # serializable
    assert ct["displayTimeUnit"] == "ms"
    assert ct["otherData"]["dropped_events"] == 0
    evs = ct["traceEvents"]
    assert len(evs) == 2
    for e in evs:
        assert e["ph"] in ("X", "i")
        assert isinstance(e["name"], str)
        assert e["ts"] >= 0 and "pid" in e and "tid" in e
        assert "sid" in e["args"] and "parent" in e["args"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert xs[0]["dur"] >= 0 and xs[0]["args"]["n"] == 2
    ins = [e for e in evs if e["ph"] == "i"]
    assert ins[0]["s"] == "t" and ins[0]["args"]["why"] == "test"


def test_tracer_disable_keeps_history_reset_drops_it():
    tr = obs.configure(enabled=True)
    with obs.span("kept"):
        pass
    obs.configure(enabled=False)
    assert not obs.enabled()
    assert obs.get_tracer() is tr and len(tr.spans("kept")) == 1
    obs.reset()
    assert obs.get_tracer() is None


def test_fences_wait_for_cpu_tensors_without_a_device_call():
    """A fence synchronizes the CUDA devices of the tensors it was given;
    CPU tensors and host arrays name none, so on the CPU it returns the
    value and never touches `torch.cuda` (whose calls raise in a CPU-only
    build)."""
    tr = obs.configure(enabled=True, fences=True)
    t = torch.ones(3)
    with obs.span("fenced") as sp:
        assert sp.fence((t, {"a": [t]}, np.ones(2))) is not None
    assert obs.fence(t) is t and obs.fences_enabled()
    assert len(tr.spans("fenced")) == 1
    assert obs.block_until_ready(t) is t


# ------------------------------------------------------------- metrics ----
def test_metrics_counters_gauges_histograms():
    obs.configure(enabled=True)
    obs.counter_add("c", 2)
    obs.counter_add("c")
    obs.gauge_set("g", 4.5)
    for v in (1.0, 3.0):
        obs.observe("h", v)
    snap = obs.metrics_snapshot()
    assert snap["counters"]["c"] == 3.0
    assert snap["gauges"]["g"] == 4.5
    h = snap["histograms"]["h"]
    assert (h["count"], h["sum"], h["min"], h["max"], h["mean"]) == \
        (2, 4.0, 1.0, 3.0, 2.0)


def test_metrics_disabled_records_nothing():
    obs.configure(enabled=False)
    obs.counter_add("never")
    assert obs.metrics_snapshot()["counters"] == {}


def test_metrics_family_conflict_raises():
    reg = obs.MetricsRegistry()
    reg.counter_add("name")
    with pytest.raises(ValueError):
        reg.gauge_set("name", 1.0)


def test_metrics_reset_isolation():
    """The isolation fixture calls obs.reset(); a prior test's counters
    must never be visible (this test relies on the fixture having run)."""
    assert obs.metrics_snapshot()["counters"] == {}
    obs.configure(enabled=True)
    obs.counter_add("leaky")
    obs.reset()
    assert obs.metrics_snapshot()["counters"] == {}


# ----------------------------------------------------- session surfaces ---
def test_meshless_exchange_stats_is_structured_not_raising():
    x, q = _toy_points()
    sess = FMMSession.from_points(x, q, nparts=4, device="cpu", engine=False)
    st = sess.exchange_stats
    assert st["enabled"] is False
    assert "reason" in st and st["n_rounds"] == 0
    assert st["protocol"] == "bulk"


def test_meshless_report_structure():
    obs.configure(enabled=True)
    x, q = _toy_points()
    sess = FMMSession.from_points(x, q, nparts=4, device="cpu", engine=False)
    sess.evaluate()
    rep = sess.report()
    assert rep["obs"]["enabled"] is True
    assert "session.evaluate" in rep["timings"]
    assert "plan.geometry" in rep["timings"]
    assert rep["metrics"]["counters"]["session.evaluations"] == 1
    assert rep["metrics"]["counters"]["memo.misses"] == rep["memo"]["misses"]
    assert rep["exchange"] == {"enabled": False, "protocols": {}}
    assert rep["launches"] == {"enabled": False}
    assert rep["memo"]["misses"] > 0
    assert rep["geometry"]["bytes_matrix_total"] == \
        int(sess.geometry.bytes_matrix.sum())
    json.dumps(rep)                              # report must be exportable


@pytest.mark.parametrize("stream", [False, True])
def test_traced_compiled_evaluate_is_still_one_call(stream):
    """Tracing must not break the one-call guarantee: spans fence nothing
    by default, and a warm compiled evaluate is one call of its entry (a
    CUDA graph replay on the card; on the CPU the entry runs eagerly)."""
    obs.configure(enabled=True)
    x, q = _toy_points(400, seed=2)
    sess = FMMSession.from_points(x, q, nparts=4, device="cpu", fused=True,
                                  p2p_stream=stream,
                                  exe_cache=ExecutableCache())
    sess.evaluate()
    sess.evaluate()
    rep = sess.report()
    la = rep["launches"]["evaluate"]
    assert la["calls"] == 2 and rep["launches"]["fused_dispatches"] == 2
    assert la["captured"] is False and la["entry_computations"] == 0
    assert rep["exe_cache"]["misses"] == 1       # one capture, ever
    counters = rep["metrics"]["counters"]
    assert counters["exe_cache.misses"] == 1
    assert counters["engine.fused_launches"] == 2
    assert counters.get("p2p.stream.launches", 0) == (2 if stream else 0)
    assert "exe_cache.compile" in rep["timings"]
    assert rep["timings"]["engine.fused_evaluate"]["count"] == 2
    built = [e["attrs"]["p2p_impl"] for e in obs.get_tracer().events
             if isinstance(e, dict) and e["name"] == "engine.fused_build"]
    assert built == ["stream" if stream else "gathered"]


def test_plan_geometry_spans_nest_under_plan():
    tr = obs.configure(enabled=True)
    x, q = _toy_points()
    plan_geometry(x, q, PartitionSpec(nparts=4), device="cpu")
    parent = tr.spans("plan.geometry")[0]
    for sub in ("plan.partition", "plan.trees", "plan.lets",
                "plan.receivers"):
        sp = tr.spans(sub)
        assert len(sp) == 1 and sp[0].parent == parent.sid
    assert parent.attrs["nparts"] == 4
    assert obs.metrics_snapshot()["counters"]["plan.builds"] == 1


# ---------------------------------------------- exchange probe, 4 ranks ---
def _slab():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (800, 3))
    x[:, 0] *= 4.0
    return x, rng.uniform(-1, 1, 800)


@pytest.fixture(scope="module")
def port_probe():
    """The port's mesh session on 4 ranks stacked on the CPU, traced:
    `report(measure_exchange=True)` on a fresh session (its dist.* records
    are what the reference is held to), then one evaluate."""
    obs.configure(enabled=True)
    obs.reset()
    x, q = _slab()
    geo = plan_geometry(x, q, PartitionSpec(nparts=8, method="morton",
                                            ncrit=64), device="cpu")
    sess = FMMSession(geo, device="cpu", mesh=stacked_mesh(4, "cpu"),
                      dist_protocol="bulk")
    rep = sess.report(measure_exchange=True, reps=2)
    records = _dist_records(_dist_events(obs.get_tracer()))
    sess.evaluate()
    lay = sess.dist.layout
    inter = int(sum(int(geo.bytes_matrix[i, j])
                    for i in range(len(lay.part_rank))
                    for j in range(len(lay.part_rank))
                    if lay.part_rank[i] != lay.part_rank[j]))
    out = {"inter_rank_bytes": inter,
           "rank_bytes_sum": int(lay.rank_bytes.sum()),
           "protocols": rep["exchange"]["protocols"], "dist": records,
           "tree": _span_tree(obs.get_tracer().spans()),
           "counters": obs.metrics_snapshot()["counters"]}
    obs.configure(enabled=False)
    obs.reset()
    return out


# (kind, name, parent name, attrs) of every dist.* span and event of a
# tracer; the reference's subprocess below runs the same lines
_DIST_EVENTS = """
def _dist_events(tracer):
    names = {}
    for e in tracer.events:
        d = e if isinstance(e, dict) else {"sid": e.sid, "name": e.name}
        names[d["sid"]] = d["name"]
    out = []
    for e in tracer.events:
        span = not isinstance(e, dict)
        name = e.name if span else e["name"]
        if name.startswith("dist."):
            out.append(["span" if span else "event", name,
                        names.get(e.parent if span else e["parent"]),
                        None if span else e["attrs"]])
    return out
"""
exec(_DIST_EVENTS)


def _dist_records(events) -> dict:
    """{(kind, name, parent name): count} of dist.* records, and the wire
    accounting of each `dist.program_built` and `dist.exchange_probe`
    event by protocol."""
    shape, built, probes = {}, {}, {}
    for kind, name, parent, attrs in events:
        key = (kind, name, parent)
        shape[key] = shape.get(key, 0) + 1
        if name == "dist.program_built":
            built[attrs["protocol"]] = [
                attrs["n_rounds"], attrs["moved_bytes"],
                attrs["delivered_bytes"], attrs["padded_wire_bytes"]]
        elif name == "dist.exchange_probe":
            probes[attrs["protocol"]] = [attrs["n_rounds"],
                                         attrs["moved_bytes"]]
    return {"shape": shape, "built": built, "probes": probes}


@pytest.mark.parametrize("protocol", ["bulk", "grain", "hsdx"])
def test_exchange_probe_wire_bytes_match_bytes_matrix(port_probe, protocol):
    """The probe's delivered bytes equal the inter-rank aggregation of
    `GeometryPlan.bytes_matrix` — the paper's byte accounting, measured."""
    st = port_probe["protocols"][protocol]
    assert st["delivered_bytes"] == port_probe["inter_rank_bytes"]
    assert st["delivered_bytes"] == port_probe["rank_bytes_sum"]
    assert st["moved_bytes"] >= st["delivered_bytes"]
    assert len(st["rounds"]) == st["n_rounds"]


@pytest.mark.parametrize("protocol", ["bulk", "grain", "hsdx"])
def test_exchange_probe_model_drift(port_probe, protocol):
    st = port_probe["protocols"][protocol]
    assert np.isfinite(st["model_drift"]) and st["model_drift"] > 0
    assert st["measured_s"] > 0 and st["loggp_s"] > 0
    assert st["model_drift"] == pytest.approx(
        st["measured_s"] / st["loggp_s"])


def test_exchange_probe_emitted_events(port_probe):
    assert sorted(port_probe["dist"]["probes"]) == ["bulk", "grain", "hsdx"]


# ------------------------------------------------------ across packages ---
def _span_tree(spans) -> set:
    by_sid = {s.sid: s.name for s in spans}
    return {(s.name, by_sid.get(s.parent)) for s in spans}


def _kept(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if not k.startswith(LEFT_OUT)}


@pytest.mark.parametrize("stream", [False, True])
def test_span_tree_and_counters_match_reference(stream, monkeypatch):
    """plan_geometry, evaluate, a within-slack step and sweep() of the
    per-phase engine, traced in both packages on the same points (with a
    far field and a finite slack): the same (span, parent span) names,
    the same events (apart from LEFT_OUT's families) and the same counters
    with the same values."""
    rng = np.random.default_rng(0)
    x, q = rng.uniform(-1, 1, (192, 3)), rng.uniform(-1, 1, 192)
    # both autotune caches cold, so both count a decision, then hits
    monkeypatch.setattr(jkp, "_STREAM_CACHE", {})
    monkeypatch.setattr(tkp, "_STREAM_CACHE", {})
    jt = jobs.configure(enabled=True)
    js = JSession.from_points(x, q, JSpec(nparts=4, ncrit=24), engine=True,
                              fused=False, use_kernels=False,
                              p2p_stream=stream)
    js.evaluate()
    eps = float(js.geometry.slack.min())
    x1 = x + np.random.default_rng(1).uniform(-eps / 4, eps / 4, x.shape)
    js.step(x1)
    js.sweep()
    tt = obs.configure(enabled=True)
    ts = FMMSession.from_points(x, q, PartitionSpec(nparts=4, ncrit=24),
                                device="cpu", fused=False,
                                p2p_stream=stream)
    ts.evaluate()
    assert ts.step(x1).rebuilt == ()
    ts.sweep()

    tree = _span_tree(tt.spans())
    assert tree == _span_tree(jt.spans())
    assert ("engine.step_drift", "session.step") in tree
    assert (("engine.p2p_stream" if stream else "engine.p2p_bucket"),
            "session.evaluate") in tree
    ev_t = {e["name"] for e in tt.events if isinstance(e, dict)}
    ev_j = {e["name"] for e in jt.events if isinstance(e, dict)
            and not e["name"].startswith(LEFT_OUT)}
    assert ev_t == ev_j
    ct = obs.metrics_snapshot()["counters"]
    cj = jobs.metrics_snapshot()["counters"]
    assert ct == _kept(cj)
    assert ct["session.evaluations"] == 2 and ct["session.steps"] == 1


_REF_PROBE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import numpy as np
    from repro import obs
    obs.configure(enabled=True)
    from repro.core.api import FMMSession, PartitionSpec, plan_geometry
    from repro.launch.mesh import host_device_mesh

    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (800, 3))
    x[:, 0] *= 4.0
    q = rng.uniform(-1, 1, 800)
    geo = plan_geometry(x, q, PartitionSpec(nparts=8, method="morton",
                                            ncrit=64))
    sess = FMMSession(geo, mesh=host_device_mesh(4), dist_protocol="bulk")
    sess.report(measure_exchange=True, reps=2)
""").strip() + "\n" + _DIST_EVENTS + \
    "\nprint(json.dumps(_dist_events(obs.get_tracer())))\n"


def test_dist_events_match_reference_on_four_ranks(port_probe):
    """`report(measure_exchange=True)` of a fresh mesh session, the
    reference on 4 virtual XLA devices (a subprocess: the device count is
    fixed when JAX starts) and the port on 4 stacked ranks: the same dist.*
    spans and events under the same parents, each protocol's program built
    with the same rounds and moved / delivered / padded bytes, the same
    probe accounting; then the port's evaluate records `dist.evaluate` under
    `session.evaluate` and counts it."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    env.pop("REPRO_FAULTS", None)
    env.pop("REPRO_TRACE", None)
    out = subprocess.run([sys.executable, "-c", _REF_PROBE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = _dist_records(json.loads(out.stdout.strip().splitlines()[-1]))
    mine = port_probe["dist"]
    assert mine == ref
    assert sorted(mine["built"]) == ["bulk", "grain", "hsdx"]
    for _, _, delivered, _ in mine["built"].values():
        assert delivered == port_probe["inter_rank_bytes"]
    assert ("dist.evaluate", "session.evaluate") in port_probe["tree"]
    assert port_probe["counters"]["dist.evaluations"] == 1
