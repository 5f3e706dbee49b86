"""Regression gate of the port: fresh sessions and `FMMSession.report()`
held to the invariants the port's guarantees rest on.

    PYTHONPATH=src python -m repro_torch.analysis.check_counters \\
        [--n 800] [--device cpu] [--out DIR]

The port of `repro.analysis.check_counters`.  It runs on the card unless
`--device cpu` is given (no card and no `--device` raises).  With tracing
enabled it checks

  1. one replay per warm compiled evaluate, on the gathered route (K1) and
     on the stream route (K2): the entry's calls and the engine's launch
     log advance by one, and on the card the entry is a captured CUDA graph
     whose replay advances the route's kernel counter by exactly the
     launches its capture recorded (the counterpart of the reference's
     `hlo_walk.count_entry_launches`).  On the CPU nothing is captured
     (`graphs.py`), so it counts entry calls, and says so;
  2. zero captures for a second geometry of the same shape class (the
     points reflected through the origin), on both routes;
  3. the bytes every dist protocol (bulk, grain, hsdx) delivers on
     `stacked_mesh(4)` equal the rank-aggregated off-diagonal
     `GeometryPlan.bytes_matrix`;
  4. each protocol's `model_drift` (exchange alone timed / LogGP time) is
     finite and positive;
  5. with resilience on and no faults: one replay per warm evaluate, the
     `degraded` flag False, no fault fired;
  6. after a chaos drive (an injected `fused.launch` absorbed by a ladder
     fallback, an unlimited `memo.upload` on a reference session exhausting
     the ladder), faults fired = counted fallbacks + typed errors.

It prints each check, exits non-zero on any violation (no check is
skipped), and with `--out` writes the mesh session's `report()` JSON and
the chrome trace there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="counters gate of the port (one replay per warm "
                    "evaluate, zero recaptures, exchange bytes, resilience "
                    "accounting)")
    ap.add_argument("--out", default=None,
                    help="directory for the report JSON and chrome trace")
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--nparts", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
    from repro_torch.core.engine import ExecutableCache
    from repro_torch.device import resolve_device
    from repro_torch.graphs import KERNELS
    from repro_torch.launch.mesh import stacked_mesh
    from repro_torch.resilience import ResilienceError, inject_faults
    from repro_torch.resilience import fallback as res_fb
    from repro_torch.resilience import faults as res_faults

    dev = resolve_device(args.device)
    captured = dev.type == "cuda"
    obs.configure(enabled=True)
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if captured else ""))
    if not captured:
        print("note: nothing is captured on the CPU; the one-replay checks "
              "count entry calls instead of CUDA graph replays")

    failures: list[str] = []

    def check(ok: bool, label: str) -> None:
        print(f"{'ok  ' if ok else 'FAIL'} {label}", flush=True)
        if not ok:
            failures.append(label)

    rng = np.random.default_rng(11)
    x = rng.normal(size=(args.n, 3))
    q = rng.uniform(-1, 1, args.n)
    spec = PartitionSpec(nparts=args.nparts, method="orb", ncrit=64)

    def plan(points):
        return plan_geometry(points, q, spec, device=dev)

    def warm_is_one_replay(label: str, sess, kern: str) -> None:
        sess.evaluate()                       # cold: build (and capture)
        eng = sess.engine
        entry = eng._entries["evaluate"]
        calls, log = entry.calls, len(eng.launch_log)
        before = KERNELS[kern].launches
        sess.evaluate()                       # warm
        if captured:
            torch.cuda.synchronize(dev)
        per = entry.launches.get(kern, 0)
        ok = entry.calls == calls + 1 and len(eng.launch_log) == log + 1
        if captured:
            ok = (ok and entry.call.graph is not None and per > 0
                  and KERNELS[kern].launches - before == per)
            what = (f"one CUDA graph replay ({kern} launches "
                    f"{KERNELS[kern].launches - before}, {per} a replay)")
        else:
            what = "one entry call"
        check(ok, f"{label}: a warm compiled evaluate is {what}")

    # --- 1-2: compiled routes (private caches: isolated counters) ---------
    for stream, kern in ((False, "K1"), (True, "K2")):
        route = "stream (K2)" if stream else "gathered (K1)"
        cache = ExecutableCache()
        sess = FMMSession(plan(x), device=dev, fused=True, p2p_stream=stream,
                          exe_cache=cache)
        warm_is_one_replay(route, sess, kern)
        key = sess.engine._entries["evaluate"].key
        check(key[-1] == ("stream" if stream else "gathered"),
              f"{route}: the entry key records the route (key[-1] = "
              f"{key[-1]!r})")
        misses, hits = cache.misses, cache.hits
        sess_b = FMMSession(plan(-x), device=dev, fused=True,
                            p2p_stream=stream, exe_cache=cache)
        sess_b.evaluate()
        check(cache.misses == misses and cache.hits == hits + 1,
              f"{route}: a second geometry of the shape class (the points "
              f"reflected through the origin) -> 0 new captures (misses "
              f"{misses} -> {cache.misses}, hits {hits} -> {cache.hits})")
        del sess, sess_b, cache

    # --- 3-4: the exchange on 4 ranks stacked on the device ---------------
    msess = FMMSession(plan(x), device=dev, mesh=stacked_mesh(4, dev),
                       dist_protocol="bulk")
    msess.evaluate()
    rep = msess.report(measure_exchange=True, reps=2)
    geo, lay = msess.geometry, msess.dist.layout
    expect = int(lay.rank_bytes.sum())        # zero diagonal by construction
    for name, st in rep["exchange"]["protocols"].items():
        check(st["delivered_bytes"] == expect,
              f"{name}: delivered_bytes {st['delivered_bytes']} == rank "
              f"off-diagonal bytes matrix {expect}")
        drift = st["model_drift"]
        check(bool(np.isfinite(drift)) and drift > 0,
              f"{name}: model_drift finite and positive ({drift:.3g})")
    inter = int(sum(geo.bytes_matrix[i, j]
                    for i in range(len(lay.part_rank))
                    for j in range(len(lay.part_rank))
                    if lay.part_rank[i] != lay.part_rank[j]))
    check(inter == expect,
          "rank_bytes aggregates GeometryPlan.bytes_matrix's inter-rank "
          f"entries exactly ({inter} == {expect})")

    # --- 5-6: resilience ----------------------------------------------------
    res_faults.reset_stats()
    res_fb.reset_ledger()
    rsess = FMMSession(plan(x), device=dev, fused=True,
                       exe_cache=ExecutableCache(), resilience=True)
    warm_is_one_replay("resilience on, no faults", rsess, "K1")
    check(not rsess.resilience.degraded and rsess.resilience.rung
          == "gathered", "resilience on, no faults -> degraded stays False "
          f"(rung {rsess.resilience.rung!r})")
    check(res_faults.fired_total() == 0, "no armed plan -> no fault fired")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        c1 = FMMSession(plan(x), device=dev, fused=True,
                        exe_cache=ExecutableCache(), resilience=True)
        with inject_faults("fused.launch"):
            c1.evaluate()
        fb = c1.resilience.fallbacks
        check(len(fb) == 1 and fb[0]["site"] == "fused.launch"
              and (fb[0]["from"], fb[0]["to"]) == ("gathered", "per_phase"),
              "injected fused.launch (out of memory) -> one counted "
              f"fallback {[(f['site'], f['from'], f['to']) for f in fb]}")
        c2 = FMMSession(plan(x), device=dev, engine=False, resilience=True)
        got_typed = False
        try:
            with inject_faults({"memo.upload": {"count": None}}):
                c2.evaluate()
        except ResilienceError as exc:
            got_typed = exc.site == "memo.upload"
        check(got_typed, "an exhausted ladder raises a typed "
              "ResilienceError naming the site (memo.upload)")
    fired = res_faults.fired_total()
    absorbed = res_fb.fallback_total() + res_fb.typed_error_total()
    check(fired > 0 and fired == absorbed,
          f"chaos accounting: injected faults ({fired}) == counted "
          f"fallbacks + typed errors ({absorbed})")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        rep_path = os.path.join(args.out, "session_report.json")
        with open(rep_path, "w") as fh:
            json.dump(rep, fh, indent=1, sort_keys=True, default=str)
        trace_path = os.path.join(args.out, "session_trace.json")
        with open(trace_path, "w") as fh:
            json.dump(obs.get_tracer().to_chrome_trace(), fh, default=str)
        print(f"wrote {rep_path} and {trace_path}")

    if failures:
        print(f"\n{len(failures)} invariant violation(s)")
        return 1
    print("\nall counter invariants hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
