"""Device evaluation engine: batched multi-tree FMM execution.

The port of `repro.core.engine` on its per-phase route.  A `DeviceEngine`
holds one geometry's stacked tables (`schedules.build_engine_tables`,
uploaded once) and the stacked (x, q) payload on its device; `evaluate()`
then runs

  1. the batched upward pass (`upward.batched_upward_kernel`): P2M + M2M for
     all partitions at once;
  2. the far field (`m2l.far_tail_kernel`): the segment-summed M2L over
     every (receiver, sender) pair, the stacked downward sweep, and L2P;
  3. the near field: one K1 launch per P2P width-class bucket
     (`p2p.p2p_bucket_vals`), or with `p2p_stream=True` one K2 launch over
     the unified tile table (`p2p.p2p_stream_vals`);
  4. the batched M2P fallback (`m2l.m2p_vals_kernel`);

and accumulates every phase's float32 values into the potential in float64
on the device with `index_add_`.  Only the final (N,) potential moves to the
host.  Each phase is a public method, so a caller can time them one by one.

Timesteps: the index tables do not depend on the payload, so a
within-slack `FMMSession.step` revalidates with `step_drift` (one `new_x`
upload, restacked on the device, every partition's drift in one pass) and
rebinds with `refresh_payload`; the multipoles are cached per payload and
recomputed by the next evaluation.

Compiled serving (`fused=True`, the default on a CUDA device): a warm
`evaluate()` is one CUDA graph replay of the whole pipeline above, and a
`step_drift()` one replay of the restack and both reductions
(`engine.fused`), each captured once per shape class through
`engine.exe_cache`.  The entry owns static buffers; the engine copies its
payload into them when it changed, and its tables when the entry last
served another engine (`CompiledEntry.rebinds`).  The per-phase methods
stay available on the same engine and are the pinned comparison.

Observability (`repro_torch.obs`, the reference's names): the per-phase
route records the spans `engine.upward`, `engine.far_field`,
`engine.p2p_bucket` (one a K1 bucket) or `engine.p2p_stream`, and
`engine.m2p`, each fenced under `REPRO_TRACE_FENCES`; a compiled evaluate
records `engine.fused_evaluate` around the replay (the `fused.launch`
fault seam fires in it, before the replay) and counts
`engine.fused_launches` and the `p2p.stream.*` counters after it, outside
the captured call; `step_drift` records `engine.step_drift`; the stream
tables count `p2p.stream.builds` / `p2p.stream.fallbacks`; the launch
autotune counts `p2p.autotune.*` as the reference's does (K1's warps a
block per bucket shape class through `kernels.ops.p2p_auto`, resolved
before any capture by `fused.bucket_launch_params`; the stream route's
(block_t, warps) once per engine in `stream_tables`).  Left out: the
reference's `engine.donate.*` counters (static buffers replace donation).
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import fused as fused_mod
from repro_torch.core.engine.exe_cache import (GLOBAL_CACHE, CompiledEntry,
                                               ExecutableCache, resolve_cache)
from repro_torch.core.engine.m2l import far_tail_kernel, m2p_vals_kernel
from repro_torch.core.engine.p2p import (p2p_bucket_vals, p2p_stream_vals,
                                         stream_payload)
from repro_torch.core.engine.schedules import (EngineTables,
                                               build_engine_tables,
                                               build_p2p_stream_tables,
                                               shape_class_digest,
                                               stack_bodies,
                                               stack_reference_bodies,
                                               to_device, to_numpy)
from repro_torch.core.engine.traversal import (partition_drift,
                                               restack_payload)
from repro_torch.core.engine.upward import batched_upward_kernel
from repro_torch.core.multipole import get_operators
from repro_torch.device import resolve_device
from repro_torch.kernels.p2p import best_stream_params, measurable
from repro_torch.kernels.p2p_stream import timed_ms
from repro_torch.resilience import faults as _faults

__all__ = ["DeviceEngine", "EngineTables", "build_engine_tables",
           "build_p2p_stream_tables", "stack_bodies", "default_fused_enabled",
           "ExecutableCache", "GLOBAL_CACHE", "resolve_cache",
           "shape_class_digest"]

_TOKENS = itertools.count(1)      # engine identities for entry rebinding


def default_fused_enabled(device) -> bool:
    """Compiled-serving default: on for a CUDA device, where a warm
    evaluate's few thousand device operations become one graph replay (the
    reference's fused tier is on for every device backend); off on the CPU,
    where nothing is captured.  Opt in anywhere with `fused=True`."""
    return torch.device(device).type == "cuda"


class DeviceEngine:
    """Batched executor for one geometry's stacked tables and payload.

    Parameters
    ----------
    tables : `schedules.EngineTables`, NumPy (as built) or tensors
        (`convert.engine_tables_from_numpy`).
    x_pad, q_pad : the stacked payload, (P, Nmax, 3) and (P, Nmax).
    device : where to run; None means the CUDA device (raises without one).
    p2p_stream : run the near field through K2 over the unified tile table
        instead of one K1 launch per width-class bucket.  Falls back to the
        gathered buckets when the stream-table contiguity invariant does not
        hold (`stream_fallbacks` counts it).
    geometry : the `GeometryPlan` the tables were built from (`geo`); the
        step methods need it, evaluation does not.
    fused : serve a warm `evaluate()` / `step_drift()` as one replay of a
        compiled entry (`engine.fused`); default `default_fused_enabled`
        (on iff the device is CUDA).  On the CPU an entry runs its closure
        eagerly over the same static buffers.
    exe_cache : `exe_cache.ExecutableCache` of compiled entries; the
        process-wide `GLOBAL_CACHE` when omitted, so geometries of one
        shape class share one capture across sessions.
    memo : the session's `DeviceMemo`; a tensor resident there is never
        taken as a payload buffer (`_bindable` raises TypeError).
    """

    def __init__(self, tables: EngineTables, x_pad, q_pad, *, device=None,
                 p2p_stream: bool = False, geometry=None,
                 fused: bool | None = None, exe_cache=None, memo=None):
        self.device = resolve_device(device)
        self.memo = memo
        self.tables = tables.to(self.device)
        self._token = next(_TOKENS)
        self._payload_version = 0
        self._set_payload(x_pad, q_pad)
        self.ops = get_operators(tables.p, self.device)
        self.p2p_stream = bool(p2p_stream)
        self.stream_fallbacks = 0
        self._stream = None
        self.geo = geometry
        self._M = None               # multipoles of the current payload
        self._x_ref_pad = None       # stacked slack reference, built lazily
        self._pending_x = None       # payload staged by step_drift
        self.payload_refreshes = 0
        self.fused = (default_fused_enabled(self.device) if fused is None
                      else bool(fused))
        self.exe_cache = resolve_cache(exe_cache)
        self._entries: dict = {}     # kind -> CompiledEntry
        self._flat: dict = {}        # kind -> this engine's flat tables
        self.launch_log: list = []   # (kind, key) per compiled call
        # float32 guard band of drift-vs-slack decisions: step_drift measures
        # in float32, so its absolute error is a few ulps of the coordinate
        # scale; the session revalidates on the host in float64 within it
        self.drift_guard = (None if geometry is None else float(
            4 * np.finfo(np.float32).eps
            * max(np.abs(geometry.x_ref).max(), 1.0)))

    @classmethod
    def from_geometry(cls, geometry, *, device=None, p2p_stream: bool = False,
                      fused: bool | None = None, exe_cache=None,
                      memo=None) -> "DeviceEngine":
        tables = build_engine_tables(geometry)
        x_pad, q_pad = stack_bodies(geometry.trees, tables.n_bodies_max)
        return cls(tables, x_pad, q_pad, device=device,
                   p2p_stream=p2p_stream, geometry=geometry, fused=fused,
                   exe_cache=exe_cache, memo=memo)

    # ----------------------------------------------------------- payload --
    def _bindable(self, arr) -> torch.Tensor:
        """A float32 copy of `arr` on the engine's device, which the engine
        may write in place and copy into compiled entries.  A tensor
        resident in the session's `DeviceMemo` is refused: the memo serves
        it to every other consumer, so it may never become a payload
        buffer (the counterpart of the reference's donation guard)."""
        if isinstance(arr, torch.Tensor):
            if self.memo is not None and self.memo.is_resident(arr):
                raise TypeError(
                    "refusing to bind a DeviceMemo-resident tensor as a "
                    "payload buffer: the engine writes its payload in place "
                    "and the memo would serve the changed tensor; pass a "
                    "fresh array instead")
            return arr.to(device=self.device, dtype=torch.float32, copy=True)
        return torch.tensor(np.asarray(arr, np.float32), device=self.device)

    def _set_payload(self, x_pad, q_pad) -> None:
        self.x, self.q = self._bindable(x_pad), self._bindable(q_pad)
        self._payload_version += 1

    def refresh_payload(self, geometry, *, use_pending: bool = False) -> None:
        """Rebind to a same-structure geometry (a within-slack step): take
        the new (x, q) payload and drop the cached multipoles; the index
        tables stay on the device untouched.  With `use_pending=True` the
        payload that the last `step_drift` restacked on the device is
        copied into the x payload buffer (the session guarantees q is
        unchanged on that path)."""
        self.geo = geometry
        if use_pending and self._pending_x is not None:
            self.x.copy_(self._pending_x)
            self._payload_version += 1
        else:
            self._set_payload(*stack_bodies(geometry.trees,
                                            self.tables.n_bodies_max))
        self._pending_x = None
        self._M = None
        self.payload_refreshes += 1

    def discard_pending(self) -> None:
        self._pending_x = None

    def step_drift(self, new_x) -> tuple:
        """Batched MAC-slack revalidation: upload `new_x` once, restack it
        into the (P, Nmax, 3) payload envelope on the device, and reduce
        every partition's drift (against the slack reference `x_ref`) and
        changed flag (against the current payload) in one pass.  The
        restacked payload is staged for `refresh_payload(use_pending=True)`.

        Returns (drift (P,) float64, changed (P,) bool) host arrays.

        Compiled (`fused`): one upload of `new_x` into the step entry's
        buffer and one replay; the staged payload is the entry's output
        buffer until `refresh_payload` copies it."""
        if self.geo is None:
            raise ValueError("step_drift needs the engine's geometry: build "
                             "it with DeviceEngine.from_geometry")
        t = self.tables
        with obs.span("engine.step_drift"):
            if self._x_ref_pad is None:
                self._x_ref_pad = torch.as_tensor(
                    stack_reference_bodies(self.geo, t), device=self.device)
            new_x = torch.as_tensor(np.asarray(new_x, np.float32))
            if self.fused:
                entry = self._fused_entry("step")
                self._bind(entry, "step")
                entry.inputs["new_x"].copy_(new_x)
                drift, changed, x_pad = entry()
                self.launch_log.append(("step", entry.key))
                obs.counter_add("engine.fused_launches")
            else:
                x_pad = restack_payload(new_x.to(self.device), t.orig_idx,
                                        t.flat_idx, t.n_parts,
                                        t.n_bodies_max)
                drift, changed = partition_drift(x_pad, self._x_ref_pad,
                                                 self.x)
            self._pending_x = x_pad
            return (drift.cpu().numpy().astype(np.float64),
                    changed.cpu().numpy())

    # ----------------------------------------------------------- compiled --
    def _fused_entry(self, kind: str):
        """This engine's compiled entry of `kind` ("evaluate" or "step"),
        resolved through the shape-class cache once per engine lifetime, so
        the cache's hit / miss counters meter per-geometry resolutions: a
        second geometry of the same shape class is one hit and no capture.
        A new entry is built from copies of this engine's tables and
        payload (captured on CUDA)."""
        entry = self._entries.get(kind)
        if entry is not None:
            return entry
        t = self.tables
        if kind == "evaluate":
            stream = self.stream_tables()
            flat = fused_mod.flatten_eval_tables(t, stream)
            if stream is not None:
                statics = {k: stream[k]
                           for k in ("pad", "block_t", "smax", "warps")}
                impl, launch = "stream", (stream["smax"], stream["block_t"],
                                          stream["warps"])
            else:
                impl = "gathered"
                launch = fused_mod.bucket_launch_params(t, self.x, self.q)
                statics = None
            fn = fused_mod.build_fused_evaluate(self.ops, t, statics)
            payload = {"x": self.x, "q": self.q}
        elif kind == "step":
            flat = fused_mod.flatten_step_tables(t, self._x_ref_pad)
            impl, launch = "gathered", ()        # the step runs no P2P
            fn = fused_mod.build_fused_step(t)
            payload = {"new_x": torch.zeros(t.n, 3, dtype=torch.float32,
                                            device=self.device),
                       "x": self.x}
        else:
            raise ValueError(f"unknown compiled entry kind {kind!r}")
        key = fused_mod.executable_key(
            kind, shape_class_digest(flat), n=t.n, n_parts=t.n_parts, p=t.p,
            theta=None if self.geo is None else self.geo.theta,
            backend=str(self.device), launch=launch, p2p_impl=impl)

        def compile_entry():
            inputs = {k: v.clone() for k, v in payload.items()}
            inputs["tab"] = {k: v.clone() for k, v in flat.items()}
            entry = CompiledEntry(key, fn, inputs, self.device)
            entry.owner, entry.payload = self._token, self._payload_version
            return entry

        entry = self.exe_cache.get_or_compile(key, compile_entry)
        self._flat[kind] = flat
        self._entries[kind] = entry
        return entry

    def _bind(self, entry, kind: str) -> None:
        """Make `entry`'s static buffers hold this engine's tables (copied
        when the entry last served another engine: a rebind) and its
        current payload (copied when it changed since)."""
        if entry.owner != self._token:
            if entry.owner is not None:
                entry.rebinds += 1
            for k, buf in entry.inputs["tab"].items():
                buf.copy_(self._flat[kind][k])
            entry.owner, entry.payload = self._token, None
        if entry.payload != self._payload_version:
            entry.inputs["x"].copy_(self.x)
            if "q" in entry.inputs:
                entry.inputs["q"].copy_(self.q)
            entry.payload = self._payload_version

    def _evaluate_fused(self) -> np.ndarray:
        """One replay: payload and tables in the entry's buffers, the
        potential out; only the (N,) potential moves to the host.  The
        multipoles the entry returns stay in its buffer (another engine's
        replay may overwrite them), so `upward()` does not take them."""
        with obs.span("engine.fused_evaluate") as sp:
            # simulated out-of-memory seam: what an oversubscribed card
            # raises on the launch, and what the resilience ladder
            # downgrades past
            _faults.fire("fused.launch")
            entry = self._fused_entry("evaluate")
            self._bind(entry, "evaluate")
            phi, _ = sp.fence(entry())
            self.launch_log.append(("evaluate", entry.key))
            obs.counter_add("engine.fused_launches")
            if self._stream is not None:
                # K2 launches a replay, as its capture recorded them; an
                # entry on the CPU captures nothing and calls the near
                # field's plain version once
                obs.counter_add("p2p.stream.launches",
                                entry.launches.get("K2", 1))
                obs.counter_add("p2p.stream.tiles",
                                self._stream["n_live_tiles"])
                obs.counter_add("p2p.stream.dma_tiles",
                                2 * self._stream["n_live_tiles"])
        return phi.cpu().numpy()

    # ---------------------------------------------------------- streaming --
    def _measure_stream(self, block_t: int, warps: int, built: dict) -> float:
        """Device ms of one K2 launch at candidate (block_t, warps): the
        `best_stream_params` measure on the card (the reference's
        `_measure_stream`).  The stream tables depend on block_t, so they
        are built for each candidate block_t, once, into `built` (the
        sweep measures each candidate several times); one warm-up launch,
        then one timed by CUDA events (`p2p_stream.timed_ms`), neither
        counted in `kernels.p2p_stream.launches`."""
        if block_t not in built:
            stream = build_p2p_stream_tables(to_numpy(self.tables.p2p_buckets),
                                             block_t)
            built[block_t] = (None if stream is None
                              else to_device(stream, self.device))
        stream = built[block_t]
        if stream is None:
            return float("inf")
        payload = stream_payload(self.x, self.q, stream["pad"])
        return timed_ms(stream["meta"], payload, block_t=block_t,
                        smax=stream["smax"], warps=warps)

    def stream_tables(self) -> dict | None:
        """The unified stream tables on the device (built once), or None on
        the gathered route.  (block_t, warps) come from the autotune
        (`kernels.p2p.best_stream_params`): measured by `_measure_stream`
        on the card, the reference's heuristic block_t on the CPU; K2
        launches with them.  A geometry whose bucket rows break the
        contiguity invariant falls back to the gathered buckets, counted in
        `stream_fallbacks`."""
        if not self.p2p_stream:
            return None
        if self._stream is not None:
            return self._stream
        buckets = to_numpy(self.tables.p2p_buckets)
        if not buckets:
            self.p2p_stream = False
            return None
        smax = max(b["s_idx"].shape[1] for b in buckets)
        wt_max = max(b["t_idx"].shape[1] for b in buckets)
        n_rows = sum(len(b["mask"]) for b in buckets)
        built: dict = {}
        measure = (functools.partial(self._measure_stream, built=built)
                   if measurable(self.x) else None)
        block_t, warps = best_stream_params(smax, n_rows, wt_max,
                                            measure=measure)
        stream = built.get(block_t)
        if stream is None and block_t not in built:
            stream = build_p2p_stream_tables(buckets, block_t)
            if stream is not None:
                stream = to_device(stream, self.device)
        if stream is None:
            self.stream_fallbacks += 1
            obs.counter_add("p2p.stream.fallbacks")
            self.p2p_stream = False
            return None
        self._stream = dict(stream, warps=warps)
        obs.counter_add("p2p.stream.builds")
        if obs.enabled():
            obs.event("p2p.stream.tables",
                      {"n_tiles": stream["n_tiles"],
                       "n_live_tiles": stream["n_live_tiles"],
                       "smax": stream["smax"], "block_t": block_t,
                       "warps": warps, "n_buckets": len(buckets)})
        return self._stream

    # ------------------------------------------------------------ phases --
    def upward(self) -> torch.Tensor:
        """Multipoles (P, n_cells_max, nk) f32, cached per payload."""
        if self._M is None:
            t = self.tables
            with obs.span("engine.upward") as sp:
                self._M = sp.fence(batched_upward_kernel(
                    self.ops, self.x, self.q, t.up.tables, t.n_cells_max))
        return self._M

    def far_field(self, M) -> tuple:
        """(idx, valid, vals): the L2P values of the far field."""
        t = self.tables
        with obs.span("engine.far_field") as sp:
            vals = sp.fence(far_tail_kernel(self.ops, M, self.x, t.m2l,
                                            t.up.tables))
        return t.l2p_t_idx, t.up.tables["leaf_valid"], vals

    def near_field(self) -> list:
        """[(idx, valid, vals)]: one entry per K1 bucket, or one K2 entry."""
        stream = self.stream_tables()
        if stream is not None:
            with obs.span("engine.p2p_stream") as sp:
                vals = sp.fence(p2p_stream_vals(self.x, self.q, stream))
                obs.counter_add("p2p.stream.launches")
                obs.counter_add("p2p.stream.tiles", stream["n_live_tiles"])
                # two slab reads (sources + targets) per live tile
                obs.counter_add("p2p.stream.dma_tiles",
                                2 * stream["n_live_tiles"])
            return [(stream["out_idx"], stream["out_valid"], vals)]
        out = []
        for b in self.tables.p2p_buckets:
            with obs.span("engine.p2p_bucket") as sp:
                vals = sp.fence(p2p_bucket_vals(self.x, self.q, b))
            out.append((b["t_idx"], b["t_valid"], vals))
        return out

    def m2p(self, M) -> tuple | None:
        """(idx, valid, vals) of the M2P fallback, or None without rows."""
        m = self.tables.m2p
        if m["b"].shape[0] == 0:
            return None
        with obs.span("engine.m2p") as sp:
            vals = sp.fence(m2p_vals_kernel(self.ops, M, self.x, m["b"],
                                            m["centers"], m["mask"],
                                            m["t_idx"]))
        return m["t_idx"], m["t_valid"], vals

    def accumulate(self, parts) -> np.ndarray:
        """Sum (idx, valid, vals) value tables into the potential in float64
        on the device (`fused.accumulate`); returns it in original body
        order on the host."""
        t = self.tables
        return fused_mod.accumulate(parts, t.n, t.n_parts * t.n_bodies_max,
                                    t.orig_idx, t.flat_idx).cpu().numpy()

    def evaluate(self) -> np.ndarray:
        """Full potential in original body order (float64, host): one
        compiled call with `fused`, else the phases one by one."""
        if self.fused:
            return self._evaluate_fused()
        M = self.upward()
        parts = [self.far_field(M), *self.near_field()]
        m2p = self.m2p(M)
        if m2p is not None:
            parts.append(m2p)
        return self.accumulate(parts)
