"""repro_torch.obs — the flight recorder: tracing + metrics for every tier.

The port of `repro.obs`: one switchboard in front of two instruments,

  - `obs.trace.Tracer` — nested host-wall-time spans (optional device
    fences for per-phase device timing) + instant events, exported as
    Perfetto-loadable chrome-trace JSON;
  - `obs.metrics.MetricsRegistry` — process-wide counters/gauges/histograms.

Instrumented code never talks to either directly; it calls the module-level
helpers below::

    from repro_torch import obs
    with obs.span("plan.partition", {"nparts": nparts}) as sp:
        parts = partition(...)
        sp.set({"max_part": int(counts.max())})
    obs.counter_add("plan.builds")
    obs.event("memo.upload", {"nbytes": nbytes})

**Disabled is the default and must cost nothing.**  When tracing is off,
`span()` returns the shared `NULL_SPAN` singleton and `event` /
`counter_add` / `gauge_set` / `observe` return immediately — no allocations
(attrs are a positional arg, never `**kwargs`), no clock reads, no locks.
`tests/test_torch_obs.py` pins zero allocations per disabled call with
tracemalloc.  Because of this contract, helpers take `attrs` as an
*already-built dict or None*; call sites must not build attr dicts
unconditionally on hot paths — gate them on `obs.enabled()` or pass None.

Enable programmatically::

    obs.configure(enabled=True)                # spans + metrics, no fences
    obs.configure(enabled=True, fences=True)   # per-phase device timing

or via environment (read once at import): ``REPRO_TRACE=1`` enables,
``REPRO_TRACE_FENCES=1`` additionally fences span boundaries.  A fence is
`torch.cuda.synchronize` on each CUDA device among the tensors a span
registered (nothing for CPU tensors), skipped while a stream is capturing
a CUDA graph.  Fences are opt-in because they serialize the asynchronous
dispatch: the compiled single-replay path should be measured unfenced
unless you explicitly want per-phase device occupancy.

Spans and counters sit outside every captured callable (`graphs.py`): a
captured function's Python runs at capture only, never on a replay, so
they would record the capture and miss every replay.

`obs.cost` is apart from both: the hook through which kernels,
communicators and stacked-rank code report their cost to a per-rank walker
(`analysis.hlo_walk`) while one runs.

`configure(enabled=False)` detaches the tracer but leaves recorded history
readable via `get_tracer()`; `reset()` clears spans, events and metrics
(the test-isolation hook).
"""
from __future__ import annotations

import os as _os

from .metrics import GLOBAL_METRICS, MetricsRegistry
from .trace import NULL_SPAN, NullSpan, Span, Tracer, block_until_ready

__all__ = [
    "Tracer", "Span", "NullSpan", "NULL_SPAN",
    "MetricsRegistry", "GLOBAL_METRICS",
    "configure", "enabled", "fences_enabled", "get_tracer", "reset",
    "span", "event", "fence", "block_until_ready",
    "counter_add", "gauge_set", "observe", "metrics_snapshot",
]

# Module state.  `_TRACER is None` IS the disabled flag — the hot-path check
# is one global load + identity test.
_TRACER: Tracer | None = None
_LAST_TRACER: Tracer | None = None      # history stays readable after disable


def configure(enabled: bool = True, *, fences: bool = False,
              max_events: int = 100_000) -> Tracer | None:
    """Install (or detach) the process tracer.  Returns the active tracer,
    or None when disabling.  Re-configuring replaces the tracer — prior
    history remains readable through `get_tracer()` until the next enable."""
    global _TRACER, _LAST_TRACER
    if enabled:
        _TRACER = Tracer(fences=fences, max_events=max_events)
        _LAST_TRACER = _TRACER
    else:
        _TRACER = None
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def fences_enabled() -> bool:
    return _TRACER is not None and _TRACER.fences


def get_tracer() -> Tracer | None:
    """The active tracer, or the most recently active one (so reports can
    still read history after `configure(enabled=False)`), or None."""
    return _TRACER if _TRACER is not None else _LAST_TRACER


def reset() -> None:
    """Clear all recorded spans/events and zero every metric.  Used by the
    tests' isolation fixtures."""
    global _LAST_TRACER
    if _TRACER is not None:
        _TRACER.clear()
    elif _LAST_TRACER is not None:
        _LAST_TRACER = None
    GLOBAL_METRICS.reset()


# ------------------------------------------------------------- hot path --
def span(name: str, attrs=None):
    """Context manager measuring the enclosed host wall time.  Disabled →
    the shared NULL_SPAN (no allocation)."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, attrs)


def event(name: str, attrs=None) -> None:
    """Record an instant event (cache event, table build, probe)."""
    t = _TRACER
    if t is None:
        return
    t.event(name, attrs)


def fence(value):
    """`block_until_ready(value)` iff fencing is configured; returns value.
    For call sites that want a fence *between* operations rather than at a
    span boundary."""
    t = _TRACER
    if t is not None and t.fences:
        block_until_ready(value)
    return value


def counter_add(name: str, value: float = 1.0) -> None:
    if _TRACER is None:
        return
    GLOBAL_METRICS.counter_add(name, value)


def gauge_set(name: str, value: float) -> None:
    if _TRACER is None:
        return
    GLOBAL_METRICS.gauge_set(name, value)


def observe(name: str, value: float) -> None:
    if _TRACER is None:
        return
    GLOBAL_METRICS.observe(name, value)


def metrics_snapshot() -> dict:
    return GLOBAL_METRICS.snapshot()


# Environment opt-in, read once at import: REPRO_TRACE=1 [REPRO_TRACE_FENCES=1]
if _os.environ.get("REPRO_TRACE", "").strip() in ("1", "true", "on"):
    configure(enabled=True,
              fences=_os.environ.get("REPRO_TRACE_FENCES", "").strip()
              in ("1", "true", "on"))
