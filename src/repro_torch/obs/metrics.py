"""Process-wide metrics registry: counters, gauges, histograms.

The port of `repro.obs.metrics`, the always-on half of `repro_torch.obs`.
Where spans answer "where did the wall time go", metrics answer "how many /
how much": graph captures, cache hits, device uploads, exchange bytes.  Three instrument kinds:

  - **counter** — monotonically increasing float (`counter_add`).
  - **gauge** — last-write-wins float (`gauge_set`).
  - **histogram** — streaming count/sum/min/max of observations (`observe`);
    no buckets — the report surface wants summary stats, not percentiles,
    and bucketless updates keep the hot path to a dict lookup + 4 updates.

All updates go through `repro_torch.obs` module-level helpers which no-op
(zero allocations) when observability is disabled; the registry itself
never checks an enabled flag.  `snapshot()` returns plain nested dicts for
`FMMSession.report()`; `reset()` restores a pristine registry (the tests'
isolation fixtures call it, so counter assertions can't leak between
tests).
"""
from __future__ import annotations

import threading

__all__ = ["MetricsRegistry", "GLOBAL_METRICS"]


class MetricsRegistry:
    """Named counters/gauges/histograms behind one lock.

    Names are flat dotted strings (`"exe_cache.miss"`, `"dist.wire_bytes"`).
    A name lives in exactly one instrument family — re-using a counter name
    as a gauge raises, catching instrumentation typos early.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    def _check_unique(self, name, family):
        for fam, store in (("counter", self._counters),
                           ("gauge", self._gauges),
                           ("histogram", self._hists)):
            if fam != family and name in store:
                raise ValueError(
                    f"metric {name!r} already registered as a {fam}")

    # ---------------------------------------------------------- updates --
    def counter_add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            if name not in self._counters:
                self._check_unique(name, "counter")
                self._counters[name] = 0.0
            self._counters[name] += value

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._gauges:
                self._check_unique(name, "gauge")
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                self._check_unique(name, "histogram")
                h = self._hists[name] = {"count": 0, "sum": 0.0,
                                         "min": float("inf"),
                                         "max": float("-inf")}
            h["count"] += 1
            h["sum"] += value
            if value < h["min"]:
                h["min"] = value
            if value > h["max"]:
                h["max"] = value

    # ------------------------------------------------------------ reads --
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def histogram(self, name: str) -> dict | None:
        with self._lock:
            h = self._hists.get(name)
            return dict(h) if h is not None else None

    def snapshot(self) -> dict:
        """Plain-dict copy: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count,sum,min,max,mean}}}."""
        with self._lock:
            hists = {}
            for name, h in self._hists.items():
                d = dict(h)
                d["mean"] = d["sum"] / d["count"] if d["count"] else 0.0
                hists[name] = d
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": hists}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# One process-wide registry: instrumentation across tiers accumulates into
# the same namespace so `FMMSession.report()` sees everything.
GLOBAL_METRICS = MetricsRegistry()
