"""Deterministic, seedable fault injection at the stack's real failure seams.

The port of `repro.resilience.faults`.  The degradation ladder
(`resilience.fallback`) is only credible if the failures it guards against
can be produced ON PURPOSE, exactly, in CI.  This module registers one
named injection site at each seam where the stack touches something that
can fail in production — a graph capture, a kernel launch, a host->device
upload, the construction of a collective program — and arms them with
per-site count/probability budgets so a chaos test can fire a site exactly
once and assert the precise consequence.

Sites (`SITES`) and where they fire in the port:

  exe_cache.compile  engine.exe_cache.ExecutableCache.get_or_compile
                     (inside the retried build closure, before the warm-up
                     and capture of the CUDA graph)
  p2p.stream.tables  engine.schedules.build_p2p_stream_tables
  kernels.p2p.launch engine.p2p.{p2p_bucket_vals,p2p_stream_vals}, before
                     K1 / K2 (Python dispatch: inside a compiled entry that
                     is its warm-up or its capture, never a replay)
  memo.upload        api.DeviceMemo.__call__ miss path (host->device upload;
                     the reference executor's tables)
  dist.build_program dist.programs.build_exchange_program
  fused.launch       engine.DeviceEngine._evaluate_fused, before the replay
                     — raises `InjectedResourceExhausted`, which is a
                     `torch.cuda.OutOfMemoryError`
  p2p.cache.read     kernels.p2p._load_persisted, before the autotune cache
                     file is opened
  p2p.cache.write    kernels.p2p._save_persisted, before the read-merge-write
                     of a measured choice (both absorbed where they fire:
                     one warning, the fallback `disk_cache -> in_memory`
                     recorded, the autotune goes on in memory)

Activation: the `inject_faults(...)` context manager, or `REPRO_FAULTS=`
in the environment (comma-separated `site[:count[:prob]]`, e.g.
`REPRO_FAULTS="exe_cache.compile:1"` — parsed once at import; the
reference package reads the same variable).  Arming an unknown site raises
immediately, so a typo cannot silently test nothing.

Disabled mode is zero-overhead in the obs tier's style: `fire(site)` is one
module-global load and a None test — no allocation, no dict lookup
(tracemalloc-pinned by tests/test_torch_resilience.py).  Every fire is
recorded in a module-level ledger (`fired_counts`) that
`analysis.check_counters` reconciles against the fallback/typed-error
ledgers: a fault that fires but is neither absorbed by a counted fallback
nor surfaced as a typed error is an accounting violation, not a shrug.
"""
from __future__ import annotations

import os
import random
from contextlib import contextmanager

import torch

from repro_torch import obs

__all__ = ["SITES", "InjectedFault",
           "InjectedResourceExhausted", "inject_faults", "fire", "arm",
           "disarm", "active_plan", "fired_counts", "fired_total",
           "reset_stats", "parse_spec"]

SITES = (
    "p2p.cache.read",
    "p2p.cache.write",
    "exe_cache.compile",
    "p2p.stream.tables",
    "kernels.p2p.launch",
    "memo.upload",
    "dist.build_program",
    "fused.launch",
)


class InjectedFault(RuntimeError):
    """A deliberately injected failure at a registered site.

    `transient=True` marks the fault as the retryable kind (a flaky capture,
    a transient device error): `fallback.call_with_retry` and the session
    ladder retry those with deterministic backoff instead of downgrading."""

    def __init__(self, site: str, *, transient: bool = False):
        super().__init__(f"injected fault at {site!r}")
        self.site = site
        self.transient = transient


class InjectedResourceExhausted(InjectedFault, torch.cuda.OutOfMemoryError):
    """Simulated device out-of-memory on the compiled launch path (what an
    oversubscribed card raises), a `torch.cuda.OutOfMemoryError` — the
    port's counterpart of the reference's RESOURCE_EXHAUSTED.
    Non-transient by construction, so the ladder downgrades instead of
    hammering the same allocation."""

    def __init__(self, site: str, *, transient: bool = False):
        super().__init__(site, transient=transient)
        self.args = (f"CUDA out of memory (injected) at {site!r}",)


class _SiteState:
    __slots__ = ("remaining", "prob", "transient")

    def __init__(self, count, prob, transient):
        self.remaining = count          # None = unlimited
        self.prob = prob
        self.transient = transient


class FaultPlan:
    """Armed sites with per-site count/probability budgets and a seeded RNG
    (`random.Random(seed)`, as in the reference, so a seeded probabilistic
    plan fires the same sequence in both packages; count-only plans are
    exact)."""

    def __init__(self, spec: dict, seed: int = 0):
        unknown = sorted(set(spec) - set(SITES))
        if unknown:
            raise ValueError(f"unknown fault site(s) {unknown}; "
                             f"registered sites: {list(SITES)}")
        self._rng = random.Random(seed)
        self._sites = {}
        for site, cfg in spec.items():
            cfg = dict(cfg)
            count = cfg.pop("count", 1)
            prob = float(cfg.pop("prob", 1.0))
            transient = bool(cfg.pop("transient", False))
            if cfg:
                raise ValueError(f"unknown fault options {sorted(cfg)} "
                                 f"for site {site!r}")
            self._sites[site] = _SiteState(
                None if count is None else int(count), prob, transient)

    def maybe_raise(self, site: str) -> None:
        st = self._sites.get(site)
        if st is None or st.remaining == 0:
            return
        if st.prob < 1.0 and self._rng.random() >= st.prob:
            return
        if st.remaining is not None:
            st.remaining -= 1
        _FIRED[site] = _FIRED.get(site, 0) + 1
        obs.counter_add("faults.injected")
        if obs.enabled():
            obs.event("faults.fire", {"site": site,
                                      "transient": st.transient})
        cls = (InjectedResourceExhausted if site == "fused.launch"
               else InjectedFault)
        raise cls(site, transient=st.transient)


# Module state: None = disarmed (the common case — fire() is one global
# load + a None test, nothing else).
_PLAN: FaultPlan | None = None
_FIRED: dict = {}                       # site -> times fired (ledger)


def fire(site: str) -> None:
    """Hot-path hook at every registered seam: no-op unless a plan is armed.
    Call sites pass literal site names; an armed plan validates names at arm
    time, so this stays lookup-free when disarmed."""
    p = _PLAN
    if p is None:
        return
    p.maybe_raise(site)


def active_plan() -> FaultPlan | None:
    return _PLAN


def arm(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def fired_counts() -> dict:
    return dict(_FIRED)


def fired_total() -> int:
    return sum(_FIRED.values())


def reset_stats() -> None:
    _FIRED.clear()


def parse_spec(text: str) -> dict:
    """Parse the REPRO_FAULTS grammar: comma-separated `site[:count[:prob]]`.
    `count` of `*` means unlimited.  Returns an `inject_faults`-shaped spec
    dict; raises ValueError on unknown sites and malformed entries."""
    spec: dict = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        site = parts[0].strip()
        cfg: dict = {}
        if len(parts) > 1:
            cfg["count"] = None if parts[1] == "*" else int(parts[1])
        if len(parts) > 2:
            cfg["prob"] = float(parts[2])
        if len(parts) > 3:
            raise ValueError(f"malformed REPRO_FAULTS entry {item!r}")
        spec[site] = cfg
    if spec:
        FaultPlan(spec)                 # validate sites eagerly
    return spec


@contextmanager
def inject_faults(spec=None, *, seed: int = 0, **sites):
    """Arm a fault plan for the duration of the block.

        with inject_faults({"exe_cache.compile": {"count": 1}}):
            sess.evaluate()
        with inject_faults("memo.upload"): ...          # one shot, p=1
        with inject_faults(**{"fused.launch": {}}): ... # kwargs form

    Each site's config accepts `count` (fires at most N times; None =
    unlimited; default 1), `prob` (per-arrival firing probability, drawn
    from a RNG seeded by `seed`; default 1.0) and `transient` (mark fired
    faults retryable; default False).  Nested arming is rejected — a chaos
    test must own its plan."""
    if _PLAN is not None:
        raise RuntimeError("inject_faults: a fault plan is already armed")
    full: dict = {}
    if spec is not None:
        if isinstance(spec, str):
            full[spec] = {}
        else:
            full.update({k: dict(v) for k, v in dict(spec).items()})
    full.update({k: dict(v) for k, v in sites.items()})
    arm(FaultPlan(full, seed=seed))
    try:
        yield
    finally:
        disarm()


def _arm_from_env() -> None:
    text = os.environ.get("REPRO_FAULTS", "")
    if not text:
        return
    seed = int(os.environ.get("REPRO_FAULTS_SEED", "0"))
    arm(FaultPlan(parse_spec(text), seed=seed))


_arm_from_env()
