"""Compiled-entry cache: capture once per *shape class*, replay forever.

The port of `repro.core.engine.exe_cache`.  A compiled FMM entry
(`engine.fused`) depends only on its geometry's shape class (the dtype and
shape of every flat table, n_parts, the kernels' launch shapes, the
device), never on the table values, which live in the entry's static
buffers.  Two geometries with equal shape-class keys can therefore share
one entry: the second copies its tables into the entry's buffers and pays
no capture.

`ExecutableCache` holds these entries under an LRU bound, with hit / miss
/ eviction counters surfaced on `FMMSession.exe_cache_stats`:

  - `misses` counts captures (on the CPU, entries built without one);
  - `hits` counts engines served an entry that already exists;
  - every `CompiledEntry` counts its `calls` and keeps the kernel launches
    its capture recorded.

The process-wide default (`GLOBAL_CACHE`) is shared by every session that
brings no cache of its own, so a process holding many sessions captures
once per shape class.  Pass a private `ExecutableCache` for isolated
counters (benchmarks, tests).

Memory: a graph's private pool keeps the peak of the call it captured for
as long as the graph lives.  At N = 2^20 that is GBs (the far field's M2L
chunks hold (2^19, 35, 35) float32 translation matrices), so
`DEFAULT_MAXSIZE` entries of that size would not fit one card; PERF.md
states the measured pool per entry.  An evicted entry keeps working (and
holding its pool) for the engines that hold it.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch import obs
from repro_torch.graphs import CapturedCall
from repro_torch.resilience import fallback as _fb
from repro_torch.resilience import faults as _faults

__all__ = ["CompiledEntry", "ExecutableCache", "GLOBAL_CACHE",
           "resolve_cache", "DEFAULT_MAXSIZE"]

DEFAULT_MAXSIZE = 32


class CompiledEntry:
    """One compiled entry: `fn(**inputs)` over static buffers, captured on
    CUDA (`CapturedCall`), called eagerly on the CPU.

    `inputs` holds the entry's static buffers (payload tensors and a `tab`
    dict of flat tables); the entry owns them, so no caller's tensor is
    ever bound into the graph.  `owner` and `payload` record whose tables
    and which payload version the buffers hold (the engine's rebinding
    state); `rebinds` counts table copies for another engine."""

    __slots__ = ("key", "inputs", "call", "calls", "owner", "payload",
                 "rebinds")

    def __init__(self, key, fn, inputs: dict, device):
        self.key = key
        self.inputs = inputs
        self.call = CapturedCall(lambda: fn(**inputs), device)
        self.calls = 0
        self.owner = self.payload = None
        self.rebinds = 0

    @property
    def launches(self) -> dict:
        """{kernel id: launches} of one call, as recorded at capture."""
        return dict(self.call.launches)

    def __call__(self) -> tuple:
        self.calls += 1
        return self.call.replay()


class ExecutableCache:
    """LRU-bounded map: shape-class key -> `CompiledEntry`.

    `get_or_compile` is the only population path, so `misses` is exactly
    the number of shape classes this cache was asked to compile (a build
    that failed on every attempt counts too).  A failed compile (warm-up
    or capture) inserts nothing and raises.  Eviction drops the
    least recently resolved entry; engines resolve an entry once per
    lifetime and then hold it, so an evicted entry keeps serving them and
    only new engines compile again."""

    def __init__(self, maxsize: int = DEFAULT_MAXSIZE):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_compile(self, key, compile_fn) -> CompiledEntry:
        """The entry for `key`, built by `compile_fn()` (-> CompiledEntry,
        captured on CUDA) on first sight of the shape class.

        Failure semantics: a failed build inserts NOTHING — the cache is
        never poisoned by a partial entry, and the next call builds from
        scratch (a raise inside a capture ends the capture first:
        `torch.cuda.graph` closes it on the way out).  TRANSIENT errors
        (exceptions carrying `transient=True`, e.g. injected ones) are
        retried in place with the default deterministic backoff
        (`resilience.fallback.call_with_retry`) before propagating;
        deterministic errors propagate on first sight.  The
        `exe_cache.compile` fault seam fires before each attempt's warm-up
        and capture."""
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            obs.counter_add("exe_cache.hits")
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        obs.counter_add("exe_cache.misses")

        def attempt():
            _faults.fire("exe_cache.compile")
            return compile_fn()

        # the capture-vs-replay split: every capture this process pays
        # appears as one of these spans; entry calls are the replay side
        with obs.span("exe_cache.compile",
                      {"key": str(key)} if obs.enabled() else None):
            entry = _fb.call_with_retry(attempt, site="exe_cache.compile")
        self._entries[key] = entry
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
            self.evictions += 1
            obs.counter_add("exe_cache.evictions")
        return entry

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "maxsize": self.maxsize}

    def clear(self) -> None:
        self._entries.clear()

    def keys(self):
        return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries


GLOBAL_CACHE = ExecutableCache()


def resolve_cache(cache: ExecutableCache | None) -> ExecutableCache:
    return GLOBAL_CACHE if cache is None else cache
