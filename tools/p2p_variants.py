#!/usr/bin/env python3
"""Times K1 (csrc/p2p.cu) and K2 (csrc/p2p_stream.cu) at the FMM main
path's shapes for every build setting and launch shape they were tried
with, on one NVIDIA GPU.

    python3 tools/p2p_variants.py              # N = 2^20, every variant
    python3 tools/p2p_variants.py --n 65536    # a smaller geometry

Plans chip_smoke.py's workload (sphere, N bodies, seed 42, charges from
default_rng(0), nparts 8, orb, theta 0.5, ncrit 64, p 4) on the card, then
builds each source once per entry of K1_VARIANTS / K2_VARIANTS (-D flags
of csrc/p2p_common.cuh and the two sources: the source loop's unroll, a
register cap as blocks of 512 threads an SM, K1's rows and K2's tiles a
warp, rsqrtf in place of the flush-to-zero rsqrt, a timing probe without
the pair arithmetic) into build/repro_torch/, prints ptxas's registers and
spills for each, and times it (`chip_smoke.device_ms`, launches queued
behind a sleep kernel) at each of WARPS warps a block: K1 summed over the
P2P buckets, K2 over the stream table.  Every variant must give the
shipped kernel's bits (the settings change neither the summation order nor
the arithmetic); a variant that does not fails the run, except the probe,
which computes something else.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import card_line, device_ms  # noqa: E402

# (unroll, blocks of 512 threads an SM or 0 for no cap, rows a warp,
# extra): K1, the shipped settings first
K1_VARIANTS = ((2, 0, 8, ""), (2, 0, 8, "plain"), (2, 0, 8, "probe"),
               (4, 0, 4, ""), (8, 0, 4, ""), (2, 0, 1, ""), (2, 0, 2, ""),
               (2, 0, 4, ""), (2, 3, 8, ""))
# (unroll, blocks an SM or 0, tiles a warp, extra): K2, the shipped first
K2_VARIANTS = ((4, 0, 8, ""), (4, 0, 8, "plain"), (4, 0, 8, "probe"),
               (2, 0, 8, ""), (8, 0, 8, ""), (4, 0, 1, ""), (4, 0, 4, ""),
               (4, 0, 16, ""), (4, 4, 8, ""))
WARPS = (2, 4, 8, 16)
# extra: "plain" keeps rsqrtf (with its denormal test) in the pair body;
# "probe" replaces the pair body by one fma, to time all but the arithmetic
EXTRA = {"": [], "plain": ["-DREPRO_P2P_RSQRT_PLAIN"],
         "probe": ["-DREPRO_P2P_PROBE"]}


def flags(unroll, blocks, extra, **per_warp) -> list:
    out = [f"-DREPRO_P2P_UNROLL={unroll}", *EXTRA[extra]]
    if blocks:
        out.append(f"-DREPRO_P2P_MIN_BLOCKS={blocks}")
    out += [f"-DREPRO_P2P_{k.upper()}={v}" for k, v in per_warp.items()]
    return out


def tag(*parts) -> str:
    return "-".join(str(p) for p in parts if p != "")


def build_all(kbuild, jobs) -> dict:
    """jobs: {tag: (source, flags)} -> {tag: CDLL}, one nvcc each, all at
    once; prints each build's ptxas register and spill lines."""
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, extra) in jobs.items():
        out = kbuild.BUILD_DIR / f"variant-{tag}.so"
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, *extra, "-I",
               str(kbuild.CSRC), "-o", str(out), str(kbuild.CSRC / src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    libs = {}
    for tag, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {tag}: {line.strip()}", flush=True)
        libs[tag] = ctypes.CDLL(str(out))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("p2p_variants: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.api import FMMSession, PartitionSpec
    from repro_torch.core.distributions import make_distribution
    from repro_torch.core.engine.p2p import _gather_bucket, stream_payload
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import p2p as kp2p
    from repro_torch.kernels import p2p_stream as kstream

    card = card_line()
    print(f"card: {card}", flush=True)
    jobs = {tag("k1", u, b, r, e): ("p2p.cu", flags(u, b, e, rows=r))
            for u, b, r, e in K1_VARIANTS}
    jobs.update({tag("k2", u, b, t, e): ("p2p_stream.cu",
                                         flags(u, b, e, tiles=t))
                 for u, b, t, e in K2_VARIANTS})
    libs = build_all(kbuild, jobs)

    dev = torch.device("cuda", 0)
    x = make_distribution("sphere", args.n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, args.n)
    spec = PartitionSpec(nparts=8, method="orb", theta=0.5, ncrit=64, p=4)
    sess = FMMSession.from_points(x, q, spec, device=dev)
    eng = sess.engine
    buckets = [_gather_bucket(eng.x, eng.q, b["t_idx"], b["s_idx"],
                              b["s_valid"]) for b in eng.tables.p2p_buckets]
    s_eng = FMMSession(sess.geometry, device=dev, p2p_stream=True).engine
    stream = s_eng.stream_tables()
    meta, bt, smax = stream["meta"], stream["block_t"], stream["smax"]
    payload = stream_payload(s_eng.x, s_eng.q, stream["pad"])
    cur = torch.cuda.current_stream(dev).cuda_stream
    ok = True

    k1_want = [kp2p.p2p(qs, xs, xt) for xt, xs, qs in buckets]
    for u, b, r, e in K1_VARIANTS:
        lib = libs[tag("k1", u, b, r, e)]
        for w in WARPS:
            outs = [torch.empty(qs.shape[0], xt.shape[1], device=dev)
                    for xt, xs, qs in buckets]

            def run():
                for (xt, xs, qs), o in zip(buckets, outs):
                    err = lib.repro_p2p_gathered(
                        ctypes.c_void_p(qs.data_ptr()),
                        ctypes.c_void_p(xs.data_ptr()),
                        ctypes.c_void_p(xt.data_ptr()),
                        ctypes.c_void_p(o.data_ptr()),
                        ctypes.c_longlong(qs.shape[0]), qs.shape[1],
                        xt.shape[1], w, ctypes.c_void_p(cur))
                    if err:
                        raise RuntimeError(f"K1 launch failed ({err})")
            ms = device_ms(torch, run, reps=10)
            same = all(torch.equal(o, g) for o, g in zip(outs, k1_want))
            ok &= same or e == "probe"
            print(f"  K1 unroll {u}, blocks {b or '-'}, rows {r}, "
                  f"{e or 'as shipped'}, {w} warps a block: {ms:.4f} ms "
                  f"device time over "
                  f"{len(buckets)} buckets; bits of the shipped kernel: "
                  f"{same}; {card}", flush=True)

    k2_want = kstream.p2p_stream(meta, payload, block_t=bt, smax=smax)
    for u, b, t, e in K2_VARIANTS:
        lib = libs[tag("k2", u, b, t, e)]
        for w in WARPS:
            out = torch.empty_like(k2_want)

            def run():
                err = lib.repro_p2p_stream(
                    ctypes.c_void_p(meta.data_ptr()),
                    ctypes.c_void_p(payload.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_longlong(meta.shape[0]),
                    ctypes.c_longlong(payload.shape[1]), bt, smax, w,
                    ctypes.c_void_p(cur))
                if err:
                    raise RuntimeError(f"K2 launch failed ({err})")
            ms = device_ms(torch, run, reps=10)
            same = torch.equal(out, k2_want)
            ok &= same or e == "probe"
            print(f"  K2 unroll {u}, blocks {b or '-'}, tiles {t}, "
                  f"{e or 'as shipped'}, {w} warps a block: {ms:.4f} ms "
                  f"device time; bits of the shipped kernel: {same}; {card}",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
