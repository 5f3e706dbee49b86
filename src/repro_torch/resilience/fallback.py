"""Graceful degradation: retry policy, the rung ladder, and the ledgers.

The port of `repro.resilience.fallback`.  The ladder orders the evaluation
paths that ALREADY exist in the port, fastest first, and a resilient
`FMMSession` walks DOWN it when a rung fails (see
`api.FMMSession._evaluate_resilient`):

  dist        ShardedEngine over a mesh (`FMMSession(mesh=...)`)
  streaming   DeviceEngine, streaming near field (K2, `p2p_stream=True`)
  gathered    DeviceEngine, gathered buckets (K1), `fused` at its default
              (compiled on a CUDA device)
  xla_slab    the reference's plain near field over the stream tables: no
              rung in the port, which runs no plain near field on the card;
              every device skips it, and the name stays so that
              `report()["resilience"]` has the reference's keys
  per_phase   DeviceEngine, gathered buckets (K1), `fused=False`
  reference   the per-partition executor `api.execute_geometry` (K1 once
              a P2P block on the card)

A dist failure (exchange-program build, collective execution, a failed
exchange verification) drops the mesh and re-enters the ladder at whatever
single-device rung the session's knobs select — the "dist engine ->
single-device engine" arm.  Every downgrade is recorded three ways: the
session's `ResilienceState` (surfaced as `report()["resilience"]` with the
`degraded` flag), a `resilience.fallback` obs counter, and a warn-once
RuntimeWarning per (site, from, to) transition, kept in a process-wide set
(`reset_ledger` clears it).  Transient errors (marked by a `transient`
attribute — e.g. `faults.InjectedFault(transient=True)`) are retried in
place with deterministic exponential backoff before any downgrade; the
clock is injectable so tests assert exact delays.

Module-level ledgers (`record_fallback` / `record_typed_error` /
`record_retry`) let `analysis.check_counters` gate the accounting identity
"every fired fault is either absorbed by a counted fallback or surfaced as
a typed `ResilienceError`" across whole processes, not just one session.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

from repro_torch import obs

__all__ = ["LADDER", "ResilienceError", "ExchangeVerificationError",
           "RetryPolicy", "ResilienceState", "is_transient",
           "call_with_retry", "record_fallback", "record_typed_error",
           "record_retry", "fallback_total", "typed_error_total",
           "retry_total", "ledger_counts", "reset_ledger",
           "default_resilience_enabled"]

LADDER = ("dist", "streaming", "gathered", "xla_slab", "per_phase",
          "reference")


class ResilienceError(RuntimeError):
    """Terminal: the ladder is exhausted (or has no rung below the failing
    one) and the session cannot produce a trustworthy potential.  Carries
    the `site` of the originating failure — the injected site name for
    injected faults, the failing rung otherwise — so chaos tests assert
    exactly which seam surfaced."""

    def __init__(self, site: str, message: str):
        super().__init__(message)
        self.site = site
        record_typed_error(site)


class ExchangeVerificationError(RuntimeError):
    """A delivered wire span did not match its sender-side payload
    (`dist.ShardedEngine.verify_exchange`, run once per (protocol, geometry
    version) under REPRO_VERIFY_EXCHANGE=1).  `site` names the check.
    Non-terminal: the ladder treats it like any dist failure and falls back
    to the single-device engine rather than serving a corrupted halo;
    without resilience it raises."""

    def __init__(self, site: str, message: str):
        super().__init__(message)
        self.site = site


@dataclass
class RetryPolicy:
    """Bounded retry with deterministic exponential backoff.  `sleep` is the
    injectable clock: tests pass a recorder and assert the exact delay
    sequence `base_delay * 2**k` capped at `max_delay`."""
    max_retries: int = 2
    base_delay: float = 0.05
    max_delay: float = 1.0
    sleep: object = None                # None -> time.sleep

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * (2 ** attempt), self.max_delay)

    def pause(self, attempt: int) -> None:
        import time
        (time.sleep if self.sleep is None else self.sleep)(self.delay(attempt))


def is_transient(exc: BaseException) -> bool:
    """Retry-worthy errors carry an explicit `transient` marker; everything
    else (a real OOM, a table-build bug, a non-transient injected fault)
    goes straight to the downgrade path — retrying a deterministic failure
    just delays the fallback."""
    return bool(getattr(exc, "transient", False))


def call_with_retry(fn, *, site: str, policy: RetryPolicy | None = None,
                    state: "ResilienceState | None" = None):
    """Run `fn()`, retrying transient failures up to `policy.max_retries`
    times with deterministic backoff.  Non-transient errors propagate
    unchanged on first sight, so the wrapper costs one frame on the happy
    path and changes no semantics for ordinary exceptions."""
    policy = policy or RetryPolicy()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            if not is_transient(exc) or attempt >= policy.max_retries:
                raise
            record_retry(site)
            if state is not None:
                state.retries += 1
            obs.counter_add("resilience.retries")
            if obs.enabled():
                obs.event("resilience.retry",
                          {"site": site, "attempt": attempt,
                           "delay_s": policy.delay(attempt)})
            policy.pause(attempt)
            attempt += 1


# ------------------------------------------------------ process ledgers ---
_FALLBACKS: dict = {}                   # site -> counted downgrades
_TYPED_ERRORS: dict = {}                # site -> ResilienceError raises
_RETRIES: dict = {}                     # site -> transient retries
_WARNED: set = set()                    # warn-once keys (site, frm, to)


def record_fallback(site: str, frm: str, to: str, *,
                    warn: bool = True) -> None:
    """Count one degradation (a ladder downgrade, or a failure absorbed in
    place such as the step's device revalidation -> host) and warn once per
    (site, from, to).  `warn=False` for call sites that emit their own
    warning — the ledger entry lands either way."""
    _FALLBACKS[site] = _FALLBACKS.get(site, 0) + 1
    obs.counter_add("resilience.fallback")
    obs.counter_add(f"resilience.fallback.{frm}->{to}")
    if obs.enabled():
        obs.event("resilience.fallback", {"site": site, "from": frm,
                                          "to": to})
    key = (site, frm, to)
    if warn and key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(
            f"resilience: degrading {frm!r} -> {to!r} after failure at "
            f"{site!r} (counted at resilience.fallback; this transition "
            "warns once)", RuntimeWarning, stacklevel=3)


def record_typed_error(site: str) -> None:
    _TYPED_ERRORS[site] = _TYPED_ERRORS.get(site, 0) + 1
    obs.counter_add("resilience.typed_errors")


def record_retry(site: str) -> None:
    _RETRIES[site] = _RETRIES.get(site, 0) + 1


def fallback_total() -> int:
    return sum(_FALLBACKS.values())


def typed_error_total() -> int:
    return sum(_TYPED_ERRORS.values())


def retry_total() -> int:
    return sum(_RETRIES.values())


def ledger_counts() -> dict:
    return {"fallbacks": dict(_FALLBACKS), "typed_errors": dict(_TYPED_ERRORS),
            "retries": dict(_RETRIES)}


def reset_ledger() -> None:
    _FALLBACKS.clear()
    _TYPED_ERRORS.clear()
    _RETRIES.clear()
    _WARNED.clear()


def default_resilience_enabled() -> bool:
    import os
    return os.environ.get("REPRO_RESILIENCE", "").lower() in (
        "1", "on", "yes", "true")


# ------------------------------------------------------- session state ----
@dataclass
class ResilienceState:
    """Per-session resilience bookkeeping, surfaced verbatim (snapshot) as
    `FMMSession.report()["resilience"]`."""
    enabled: bool = False
    health_checks: bool = False
    rung: str | None = None             # committed rung of the last evaluate
    fallbacks: list = field(default_factory=list)
    retries: int = 0
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    health: dict = field(default_factory=lambda: {"checks": 0, "failures": 0})
    audits: dict = field(default_factory=lambda: {"checks": 0, "failures": 0})
    exchange_verified: int = 0

    @property
    def degraded(self) -> bool:
        return bool(self.fallbacks)

    def note_fallback(self, site: str, frm: str, to: str,
                      exc: BaseException | None) -> None:
        self.fallbacks.append({"site": site, "from": frm, "to": to,
                               "error": repr(exc) if exc is not None else None})
        record_fallback(site, frm, to)

    def snapshot(self) -> dict:
        return {"enabled": self.enabled, "degraded": self.degraded,
                "rung": self.rung, "fallbacks": list(self.fallbacks),
                "retries": self.retries,
                "health_checks": self.health_checks,
                "health": dict(self.health), "audits": dict(self.audits),
                "exchange_verified": self.exchange_verified}
