"""Resilience tier: fault injection, retry/backoff, degradation ladder.

The port of `repro.resilience`.  Two halves, both zero-overhead when idle
(the obs tier's no-op discipline, tracemalloc-pinned):

  `faults`   — named injection sites at the stack's real failure seams,
               armed via `inject_faults(...)` or `REPRO_FAULTS=`; disarmed,
               each seam costs one module-global load.
  `fallback` — the `streaming -> gathered -> per_phase -> reference` ladder
               (`xla_slab` is kept by name and skipped; plus `dist ->
               single-device`), bounded retry with deterministic backoff,
               and the process ledgers `analysis.check_counters` reconciles
               against fired faults.

Enable on a session with `FMMSession(..., resilience=True)` (or
`REPRO_RESILIENCE=1`); inspect via `session.report()["resilience"]`.
Resilience is off by default: an injected or real failure then raises.
"""
from repro_torch.resilience.faults import (InjectedFault,
                                           InjectedResourceExhausted, SITES,
                                           fire, inject_faults)
from repro_torch.resilience.fallback import (LADDER,
                                             ExchangeVerificationError,
                                             ResilienceError,
                                             ResilienceState, RetryPolicy,
                                             call_with_retry,
                                             default_resilience_enabled)

__all__ = ["SITES", "LADDER", "InjectedFault", "InjectedResourceExhausted",
           "ResilienceError", "ExchangeVerificationError", "ResilienceState",
           "RetryPolicy", "inject_faults", "fire", "call_with_retry",
           "default_resilience_enabled"]
