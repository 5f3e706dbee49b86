#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # N = 2^20 bodies, the default
    python3 chip_smoke.py --n 65536  # a smaller run of the same phases

Drives the port's main path — `FMMSession.from_points(x, q, spec).evaluate()`
on the card — on the repository's default workload: a sphere-surface
(boundary) distribution from `make_distribution("sphere", N, seed=42)`,
charges uniform in [-1, 1] from `default_rng(0)`, and
`PartitionSpec(nparts=8, method="orb", theta=0.5, ncrit=64, p=4)`.

Phases, in order; any failed check raises and ends the run non-zero:

  1. the card's name and power limit; build both CUDA kernels from
     `src/repro_torch/kernels/csrc` with nvcc (sm_90a, one process each);
  2. plan the N-body geometry, then hold each kernel against its plain
     PyTorch version on the card at the main path's shapes (K1 on every
     P2P bucket, K2 on the stream table) and K1 against K2 bit for bit on
     identical slabs; time kernel and plain version with CUDA events;
  3. at N = 20,000 the engine on the card against the engine on the CPU,
     at rtol 1e-5 / atol 1e-4 plus 1e-6 of sum_j |q_j| / r_ij: both sum
     float32 terms in different orders (the card's atomics change order
     from run to run), so each potential's rounding scales with the sum of
     its absolute terms (~1e4 here), not with the potential, which cancels;
  4. the main path at N, gathered (K1) then streaming (K2), with every
     launch count set to 0 just before and read just after; the two
     potentials agree, and both match a float64 direct sum on 4,096
     sampled targets (computed on the card);
  5. one JSON line listing every ported kernel;
  6. the last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, at the full 700 W
# power limit): float32 outside the tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per (target, source) pair in the P2P tile body
# (p2p_common.cuh): 3 subtractions, r^2 as 1 multiply + 2 fma (5), the
# rsqrt (1), and the fma into the sum (2); an fma counts as 2.
FLOPS_PER_PAIR = 11
RTOL_KERNEL = 2e-5
BITWISE_TILES = 1 << 20      # live tiles in the K1 == K2 bitwise check


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[phase] {name}: start", flush=True)
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median warm time of fn() in ms, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_close(name, got, want, absum):
    """|got - want| <= RTOL_KERNEL * (|want| + absum) elementwise, where
    absum = sum_s |q_s| / r_ts: the error of a float32 sum reordered is
    proportional to the sum of its absolute terms, and at N = 2^20 single
    terms reach 10^3 while cancellation leaves some sums near 0."""
    err = (got - want).abs()
    tol = RTOL_KERNEL * (want.abs() + absum)
    bad = int((err > tol).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"  {name}: max_abs_err {max_err:.3e}, max |plain| "
          f"{float(want.abs().max()):.3e}, over tolerance {bad}", flush=True)
    if bad:
        raise AssertionError(f"{name}: {bad} values outside tolerance")
    return max_err


def profile_evaluate(torch, label: str, sess, top: int = 8) -> None:
    """One warm evaluate under torch.profiler: the device-busy share (time
    of the device's own events over wall time) and the kernels that take
    the most device time.  Only device-side events are summed: a CPU op's
    device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    if not rows:
        print(f"  {label} profile: device time not measured (the profiler "
              f"recorded no device events); wall {wall:.4f} s", flush=True)
        return
    print(f"  {label} profile: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, "
          f"{sum(r[2] for r in rows)} device ops", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"    {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.api import FMMSession, PartitionSpec
    from repro_torch.core.distributions import make_distribution
    from repro_torch.core.engine.p2p import _gather_bucket, stream_payload
    from repro_torch.core.fmm import direct_potential
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import p2p as kp2p
    from repro_torch.kernels import p2p_stream as kstream

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # ------------------------------------------------------------- 1 -----
    with phase("build kernels (nvcc, sm_90a, one process per source)"):
        logs = kbuild.build()
        for src, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")

    # ------------------------------------------------------------- 2 -----
    n = args.n
    spec = PartitionSpec(nparts=8, method="orb", theta=0.5, ncrit=64, p=4)
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)
    t0 = time.perf_counter()
    sess_g = FMMSession.from_points(x, q, spec, device=dev)
    t_plan = time.perf_counter() - t0
    print(f"planning (from_points, N={n}): {t_plan:.3f} s", flush=True)
    sess_s = FMMSession(sess_g.geometry, device=dev, p2p_stream=True)

    results = {}
    with phase("kernels against their plain versions at the main path's "
               "shapes"):
        eng = sess_g.engine
        k1 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "pairs": 0,
              "max_abs_err": 0.0}
        for b in eng.tables.p2p_buckets:
            xt, xs, qs = _gather_bucket(eng.x, eng.q, b["t_idx"], b["s_idx"],
                                        b["s_valid"])
            P, S = qs.shape
            T = xt.shape[1]
            got = kp2p.p2p(qs, xs, xt)
            want = kp2p.p2p_ref(qs, xs, xt)
            absum = kp2p.p2p_ref(qs.abs(), xs, xt)
            err = check_close(f"K1 bucket (rows {P}, T {T}, S {S})",
                              got, want, absum)
            live = b["mask"] > 0
            pairs = int((b["t_valid"][live].sum(1).double()
                         * b["s_valid"][live].sum(1).double()).sum())
            ms = cuda_ms(torch, lambda: kp2p.p2p(qs, xs, xt))
            pms = cuda_ms(torch, lambda: kp2p.p2p_ref(qs, xs, xt), reps=3)
            nbytes = 4.0 * (P * S + 3 * P * S + 3 * P * T + P * T)
            bms, by = bound_ms(nbytes, FLOPS_PER_PAIR * pairs)
            print(f"  K1 bucket (rows {P}, T {T}, S {S}): {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, live pairs {pairs}, bound {bms:.4f} ms "
                  f"({by}), power limit {card.split(',')[-1].strip()}",
                  flush=True)
            k1["ms"] += ms
            k1["plain_ms"] += pms
            k1["bytes"] += nbytes
            k1["pairs"] += pairs
            k1["max_abs_err"] = max(k1["max_abs_err"], err)
            del xt, xs, qs, got, want, absum
        bms, by = bound_ms(k1["bytes"], FLOPS_PER_PAIR * k1["pairs"])
        results["K1"] = dict(ms=k1["ms"], plain_ms=k1["plain_ms"],
                             bound_ms=bms, bound_by=by,
                             max_abs_err=k1["max_abs_err"],
                             pairs=k1["pairs"])

        engs = sess_s.engine
        stream = engs.stream_tables()
        if stream is None:
            raise AssertionError("stream tables fell back to the gathered "
                                 "buckets")
        meta, bt, smax = stream["meta"], stream["block_t"], stream["smax"]
        payload = stream_payload(engs.x, engs.q, stream["pad"])
        got = kstream.p2p_stream(meta, payload, block_t=bt, smax=smax)
        want = kstream.p2p_stream_gathered(meta, payload, block_t=bt,
                                           smax=smax)
        pay_abs = payload.clone()
        pay_abs[3].abs_()
        absum = kstream.p2p_stream_gathered(meta, pay_abs, block_t=bt,
                                            smax=smax)
        err = check_close(f"K2 (tiles {meta.shape[0]}, block_t {bt}, "
                          f"smax {smax})", got, want, absum)
        del want, absum, pay_abs
        live = meta[:, 3] > 0
        pairs = int((meta[live, 1].double() * meta[live, 3].double()).sum())
        ms = cuda_ms(torch, lambda: kstream.p2p_stream(meta, payload,
                                                       block_t=bt, smax=smax))
        pms = cuda_ms(torch, lambda: kstream.p2p_stream_gathered(
            meta, payload, block_t=bt, smax=smax), reps=3)
        nbytes = 4.0 * (meta.numel() + payload.numel() + meta.shape[0] * bt)
        bms, by = bound_ms(nbytes, FLOPS_PER_PAIR * pairs)
        print(f"  K2 (tiles {meta.shape[0]}, live {int(live.sum())}): "
              f"{ms:.4f} ms, plain {pms:.4f} ms, live pairs {pairs}, bound "
              f"{bms:.4f} ms ({by}), power limit "
              f"{card.split(',')[-1].strip()}", flush=True)
        results["K2"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                             max_abs_err=err, pairs=pairs)

        ml = meta[live]
        if ml.shape[0] > BITWISE_TILES:       # an evenly strided sample
            ml = ml[::-(-ml.shape[0] // BITWISE_TILES)].contiguous()
        qs, xs, xt = kstream.stream_slabs(ml, payload, block_t=bt, smax=smax)
        a = kp2p.p2p(qs, xs, xt)
        b2 = kstream.p2p_stream(ml.contiguous(), payload, block_t=bt,
                                smax=smax)
        if not torch.equal(a, b2):
            raise AssertionError(
                f"K1 and K2 differ on identical slabs: "
                f"{int((a != b2).sum())} of {a.numel()} values")
        print(f"  K1 == K2 bitwise on {ml.shape[0]} identical slabs",
              flush=True)
        del qs, xs, xt, a, b2, got, ml
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- 3 -----
    with phase("card against CPU, N = 20000"):
        from repro_torch.core.api import plan_geometry
        ns = 20000
        xs_ = make_distribution("sphere", ns, seed=42)
        qs_ = np.random.default_rng(0).uniform(-1, 1, ns)
        geo = plan_geometry(xs_, qs_, spec, device="cpu")
        # sum_j |q_j| / r_ij, the scale of each potential's float32 rounding
        phi_abs = FMMSession(plan_geometry(xs_, np.abs(qs_), spec,
                                           device="cpu"),
                             device="cpu").evaluate()
        for stream_on in (False, True):
            phi_c = FMMSession(geo, device=dev,
                               p2p_stream=stream_on).evaluate()
            phi_h = FMMSession(geo, device="cpu",
                               p2p_stream=stream_on).evaluate()
            diff = np.abs(phi_c - phi_h)
            plain = int((diff > 1e-4 + 1e-5 * np.abs(phi_h)).sum())
            bad = int((diff > 1e-4 + 1e-5 * np.abs(phi_h)
                       + 1e-6 * phi_abs).sum())
            print(f"  stream={stream_on}: max |card - cpu| {diff.max():.3e}, "
                  f"max |phi| {np.abs(phi_h).max():.3e}, max sum|q|/r "
                  f"{phi_abs.max():.3e}; over rtol 1e-5 + atol 1e-4: {plain}"
                  f", over that + 1e-6 sum|q|/r: {bad}", flush=True)
            if bad:
                raise AssertionError("card and CPU engines disagree")

    # ------------------------------------------------------------- 4 -----
    with phase(f"main path, N = {n}"):
        kp2p.launches = 0
        kstream.launches = 0
        out = {}
        for label, sess in (("gathered", sess_g), ("stream", sess_s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phi = sess.evaluate()
            cold = time.perf_counter() - t0
            warm = []
            for _ in range(3):
                t0 = time.perf_counter()
                phi = sess.evaluate()
                warm.append(time.perf_counter() - t0)
            out[label] = phi
            print(f"  {label}: evaluate cold {cold:.4f} s, warm median "
                  f"{statistics.median(warm):.4f} s "
                  f"(runs {', '.join(f'{w:.4f}' for w in warm)})", flush=True)
        launches = {"K1": kp2p.launches, "K2": kstream.launches}
        print(f"  launches on the main path: K1 {launches['K1']}, "
              f"K2 {launches['K2']}", flush=True)
        for k, v in launches.items():
            if v <= 0:
                raise AssertionError(f"{k} was not launched on the main path")

        for label, sess in (("gathered", sess_g), ("stream", sess_s)):
            e = sess.engine
            tm = {}

            def timed(key, fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn()
                torch.cuda.synchronize()
                tm[key] = time.perf_counter() - t0
                return r

            M = timed("upward", e.upward)
            far = timed("far_field", lambda: e.far_field(M))
            near = timed("p2p", e.near_field)
            m2p = timed("m2p", lambda: e.m2p(M))
            parts = [far, *near] + ([m2p] if m2p is not None else [])
            timed("accumulate", lambda: e.accumulate(parts))
            print(f"  {label} phases (warm, s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in tm.items()),
                  flush=True)

        for label, sess in (("gathered", sess_g), ("stream", sess_s)):
            profile_evaluate(torch, label, sess)

        phi_g, phi_s = out["gathered"], out["stream"]
        for label, phi in out.items():
            if phi.shape != (n,) or not np.isfinite(phi).all():
                raise AssertionError(f"{label}: bad potential")
        # rtol 1e-5; atol 1e-5 of the largest |phi|: the float32
        # index_add_ segment sums (P2M, M2L) use atomics whose order changes
        # from run to run, so two evaluations differ by float32 rounding of
        # terms as large as the largest potential, also where values cancel
        atol = 1e-5 * float(np.abs(phi_g).max())
        diff = np.abs(phi_s - phi_g)
        print(f"  stream vs gathered: max diff {diff.max():.3e}, max |phi| "
              f"{np.abs(phi_g).max():.3e}, values differing "
              f"{int((diff > 0).sum())}", flush=True)
        if not np.allclose(phi_s, phi_g, rtol=1e-5, atol=atol):
            raise AssertionError("stream and gathered potentials disagree")
        idx = np.random.default_rng(1).choice(n, size=min(4096, n),
                                              replace=False)
        t0 = time.perf_counter()
        d = direct_potential(x, q, x_tgt=x[idx], chunk=64, device=dev)
        print(f"  float64 direct sum on {len(idx)} targets: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for label, phi in out.items():
            rel = float(np.linalg.norm(phi[idx] - d) / np.linalg.norm(d))
            print(f"  {label}: rel-L2 error vs direct sum {rel:.3e}",
                  flush=True)
            if not rel < 3e-3:
                raise AssertionError(f"{label}: rel-L2 {rel} >= 3e-3")

    # ------------------------------------------------------------- 5 -----
    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    replaces = {
        "K1": ("csrc/p2p.cu", "src/repro/kernels/p2p.py:248"),
        "K2": ("csrc/p2p_stream.cu", "src/repro/kernels/p2p_stream.py:111"),
    }
    kernels = []
    for name, (src, rep) in replaces.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}", "replaces": rep,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
