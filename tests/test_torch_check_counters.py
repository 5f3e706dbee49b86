"""The port's counters gate, `python -m repro_torch.analysis.check_counters`,
on the CPU (`--device cpu`): every check passes and is printed, the report
and chrome trace land under `--out`, a broken invariant exits non-zero,
and without `--device` and without a card it refuses to run.

On the CPU nothing is captured, so the gate counts entry calls where the
card counts CUDA graph replays, and it says so in its output.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import check_counters
from repro_torch.core.engine import exe_cache
from repro_torch.resilience import fallback as res_fb
from repro_torch.resilience import faults as res_faults
from repro_torch import obs

ROOT = os.path.join(os.path.dirname(__file__), "..")
CHECKS = 19         # lines the gate prints as "ok" or "FAIL"
REPORT_KEYS = {"obs", "timings", "metrics", "memo", "exe_cache", "geometry",
               "resilience", "launches", "exchange"}


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
    """The gate turns tracing on and fills the process-wide ledgers: reset
    them around every test."""
    def reset():
        obs.configure(enabled=False)
        obs.reset()
        res_faults.disarm()
        res_faults.reset_stats()
        res_fb.reset_ledger()
    reset()
    yield
    reset()


def _lines(out: str, tag: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(tag)]


def test_gate_fails_on_a_broken_invariant(monkeypatch, capsys):
    """An entry cache that compiles every time breaks the zero-recapture
    invariant on both routes: the gate prints those checks as FAIL and
    exits 1 (the other checks still run and pass)."""
    real = exe_cache.ExecutableCache.get_or_compile

    def always_compile(self, key, compile_fn):
        self._entries.pop(key, None)
        return real(self, key, compile_fn)

    monkeypatch.setattr(exe_cache.ExecutableCache, "get_or_compile",
                        always_compile)
    rc = check_counters.main(["--device", "cpu", "--n", "400"])
    out = capsys.readouterr().out
    fails = _lines(out, "FAIL")
    assert rc == 1
    assert len(fails) == 2 and all("0 new captures" in f for f in fails)
    assert len(_lines(out, "ok  ")) == CHECKS - 2
    assert "2 invariant violation(s)" in out


def test_gate_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_counters.main([])


def test_gate_passes_on_cpu_as_a_module_and_writes_artifacts(tmp_path):
    """`python -m repro_torch.analysis.check_counters --device cpu` exits
    0 with every check printed as passed, and leaves the mesh session's
    report (the reference's keys) and the chrome trace under `--out`."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    for var in ("REPRO_FAULTS", "REPRO_TRACE", "REPRO_RESILIENCE"):
        env.pop(var, None)
    env["OMP_NUM_THREADS"] = "1"    # small tensors; other workers share
    proc = subprocess.run([sys.executable, "-m",
                           "repro_torch.analysis.check_counters", "--device",
                           "cpu", "--out", str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    assert len(_lines(out, "ok  ")) == CHECKS and not _lines(out, "FAIL")
    assert "count entry calls" in out and "all counter invariants hold" in out
    rep = json.loads((tmp_path / "session_report.json").read_text())
    assert set(rep) == REPORT_KEYS
    assert sorted(rep["exchange"]["protocols"]) == ["bulk", "grain", "hsdx"]
    trace = json.loads((tmp_path / "session_trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"session.evaluate", "dist.evaluate", "exe_cache.compile",
            "engine.fused_evaluate", "faults.fire",
            "resilience.fallback"} <= names
