"""Tracer: nested host-wall-time spans with a Perfetto-loadable export.

The port of `repro.obs.trace`, the flight-recorder half of
`repro_torch.obs` (the other half is the metrics registry, `obs.metrics`).
A `Tracer` records two event kinds:

  - **spans** — `with tracer.span("engine.upward"):` measures host wall time
    between enter and exit.  Spans nest (a per-thread stack tracks the open
    parent), carry a process-monotonic id, optional `key=value` attributes,
    and an optional *device fence*: `sp.fence(value)` registers tensors whose
    CUDA devices are synchronized at span exit (`block_until_ready`), so the
    recorded duration covers the device work the span launched rather than
    just the dispatch.  Fencing is opt-in per tracer (`fences=True`) AND per
    span — the compiled single-replay paths stay unfenced by default, so a
    traced warm evaluate is still one replay queued without a wait.
  - **instant events** — `tracer.event("memo.upload", {...})` records a
    point-in-time marker (cache events, table builds, probes).

Export: `to_chrome_trace()` renders the Chrome Trace Event Format (`"X"`
duration events + `"i"` instants) that both `chrome://tracing` and Perfetto
(https://ui.perfetto.dev) load directly; `summary()` aggregates span wall
time by name for `FMMSession.report()`.

Disabled mode lives one layer up: `repro_torch.obs.span()` returns the
shared `NULL_SPAN` singleton when no tracer is installed — zero
allocations, no clock reads — which `tests/test_torch_obs.py` pins.  The
classes here therefore never check an enabled flag themselves.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

__all__ = ["Span", "NullSpan", "NULL_SPAN", "Tracer", "block_until_ready"]


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in `value` (a tensor, or a tuple,
    list or dict of them, nested); anything else holds none."""
    import torch
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


def block_until_ready(value):
    """Wait until the device work behind `value` is done: one
    `torch.cuda.synchronize(device)` for each CUDA device among its
    tensors; CPU tensors and host arrays need nothing.  Skipped while the
    current stream is capturing a CUDA graph, where a synchronize would
    invalidate the capture.  Returns `value`."""
    devices = _cuda_devices(value, set())
    if devices:
        import torch
        if not torch.cuda.is_current_stream_capturing():
            for dev in devices:
                torch.cuda.synchronize(dev)
    return value


class NullSpan:
    """The do-nothing span served while tracing is disabled.  A process-wide
    singleton (`NULL_SPAN`): entering, exiting, annotating and fencing all
    return immediately without allocating, so instrumented hot paths cost a
    global load and an `is None` check when the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, attrs=None):
        return self

    def fence(self, value):
        return value


NULL_SPAN = NullSpan()


class Span:
    """One recorded interval.  Times are `time.perf_counter_ns` ticks
    relative to the owning tracer's epoch; `sid`/`parent` are the tracer's
    monotonic span ids (parent -1 = top level)."""

    __slots__ = ("tracer", "name", "attrs", "sid", "parent", "tid",
                 "t0_ns", "t1_ns", "_fenced")

    def __init__(self, tracer, name, attrs, sid, parent, tid):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.sid = sid
        self.parent = parent
        self.tid = tid
        self.t0_ns = -1
        self.t1_ns = -1
        self._fenced = None

    def set(self, attrs=None):
        """Merge `attrs` into the span's attributes (post-hoc annotation:
        results only known at the end of the measured region)."""
        if attrs:
            if self.attrs is None:
                self.attrs = dict(attrs)
            else:
                self.attrs.update(attrs)
        return self

    def fence(self, value):
        """Register `value` (a tensor or a nest of them) to be fenced with
        `block_until_ready` at span exit — only when the tracer was built
        with `fences=True`; otherwise a pass-through no-op.  Returns `value`
        so call sites can fence inline: `out = sp.fence(fn())`."""
        if self.tracer.fences:
            self._fenced = value
        return value

    def __enter__(self):
        self.tracer._push(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._fenced is not None:
            block_until_ready(self._fenced)
            self._fenced = None
        self.t1_ns = time.perf_counter_ns()
        self.tracer._pop(self)
        return False

    @property
    def dur_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


class Tracer:
    """Span + instant-event recorder.

    Parameters
    ----------
    fences : honor `Span.fence` registrations with a device synchronize at
        span exit (per-phase *device* timing).  Off by default so traced
        sessions keep the exact asynchronous dispatch of untraced ones.
    max_events : ring bound on retained finished events; the oldest half is
        dropped when exceeded (a flight recorder must never exhaust memory).
    """

    def __init__(self, *, fences: bool = False, max_events: int = 100_000):
        self.fences = bool(fences)
        self.max_events = int(max_events)
        self.epoch_ns = time.perf_counter_ns()
        self.events: list = []          # finished Spans + instant dicts
        self.dropped = 0
        self._ids = itertools.count()
        self._tls = threading.local()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- record --
    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, attrs=None) -> Span:
        st = self._stack()
        parent = st[-1].sid if st else -1
        return Span(self, name, dict(attrs) if attrs else None,
                    next(self._ids), parent, threading.get_ident())

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        else:                            # tolerate misnested exits
            try:
                st.remove(span)
            except ValueError:
                pass
        self._record(span)

    def event(self, name: str, attrs=None) -> None:
        """Record an instant event at the current time."""
        st = self._stack()
        self._record({"name": name,
                      "attrs": dict(attrs) if attrs else None,
                      "sid": next(self._ids),
                      "parent": st[-1].sid if st else -1,
                      "tid": threading.get_ident(),
                      "t_ns": time.perf_counter_ns()})

    def _record(self, ev) -> None:
        with self._lock:
            self.events.append(ev)
            if len(self.events) > self.max_events:
                drop = len(self.events) // 2
                del self.events[:drop]
                self.dropped += drop

    # ------------------------------------------------------------- export --
    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0
        self.epoch_ns = time.perf_counter_ns()

    def spans(self, name: str | None = None) -> list:
        """Finished spans, oldest first, optionally filtered by name."""
        with self._lock:
            evs = list(self.events)
        return [e for e in evs if isinstance(e, Span)
                and (name is None or e.name == name)]

    def summary(self) -> dict:
        """Aggregate wall time by span name:
        {name: {count, total_s, mean_s, max_s}} — the `timings` block of
        `FMMSession.report()`."""
        agg: dict = {}
        for s in self.spans():
            a = agg.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                        "max_s": 0.0})
            d = s.dur_s
            a["count"] += 1
            a["total_s"] += d
            a["max_s"] = max(a["max_s"], d)
        for a in agg.values():
            a["mean_s"] = a["total_s"] / a["count"]
        return agg

    def to_chrome_trace(self) -> dict:
        """Chrome Trace Event Format JSON (dict — `json.dump` it).  Loadable
        by Perfetto (ui.perfetto.dev) and chrome://tracing: spans become
        complete ("X") duration events, instants become "i" events; `ts` and
        `dur` are microseconds since the tracer epoch."""
        pid = os.getpid()
        out = []
        with self._lock:
            evs = list(self.events)
        for e in evs:
            if isinstance(e, Span):
                rec = {"name": e.name, "cat": "span", "ph": "X",
                       "ts": (e.t0_ns - self.epoch_ns) / 1e3,
                       "dur": (e.t1_ns - e.t0_ns) / 1e3,
                       "pid": pid, "tid": e.tid,
                       "args": {"sid": e.sid, "parent": e.parent,
                                **(e.attrs or {})}}
            else:
                rec = {"name": e["name"], "cat": "event", "ph": "i",
                       "s": "t",
                       "ts": (e["t_ns"] - self.epoch_ns) / 1e3,
                       "pid": pid, "tid": e["tid"],
                       "args": {"sid": e["sid"], "parent": e["parent"],
                                **(e["attrs"] or {})}}
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}
