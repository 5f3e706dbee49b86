#!/usr/bin/env python3
"""Times K5 (csrc/wkv.cu) at rwkv6-1.6b's prefill shapes for every launch
shape it was tried with, on one NVIDIA GPU.

    python3 tools/wkv_variants.py               # every variant
    python3 tools/wkv_variants.py 16,16,4,8     # only the (G, JC, JL, TC) given

Builds csrc/wkv.cu with -DREPRO_WKV_VARIANTS (the shipped launch shapes and
the others tried, WKV_VARIANTS) into build/repro_torch/, prints ptxas's
registers and spills for each entry, then, for each (G, JC, JL, TC) of
VARIANTS at (BH, C, D) = (128, 1024, 64) and (32, 4096, 64), bfloat16
r/k/v, float32 w in (0.8, 1) and a random state: the device time of one
launch (`chip_smoke.device_ms`: 50 launches queued behind a sleep kernel)
and the largest difference from `wkv_ref`, held to K5's limits (y rtol
1e-2 / atol 1e-4, state 1e-4).  Exits non-zero without a CUDA device or
when a variant breaks a limit.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import WKV_ENTRY, card_line, device_ms  # noqa: E402

# (G, JC, JL, TC): lanes a column, columns a block, columns a lane, tokens a
# chunk.  First the three (G, JC) at one column a lane, then JL > 1; the
# shipped two are (16, 16, 4, 8) (BH 128) and (16, 16, 2, 16) (BH 32).
VARIANTS = ((8, 16, 1, 16), (16, 16, 1, 16), (4, 16, 1, 16), (16, 16, 2, 8),
            (8, 16, 2, 8), (16, 16, 4, 8), (8, 16, 4, 8), (16, 16, 2, 16),
            (8, 8, 1, 16), (16, 8, 2, 8), (16, 8, 2, 16), (16, 8, 4, 8),
            (16, 16, 4, 16), (8, 16, 2, 16))
SHAPES = ((128, 1024, 64), (32, 4096, 64))


def build_variants(kbuild) -> ctypes.CDLL:
    logs = kbuild.build(("wkv.cu",), ("REPRO_WKV_VARIANTS",))
    name = ""
    for line in logs.get("wkv.cu", "").splitlines():
        m = WKV_ENTRY.search(line)
        if m:
            name = (f"<{'f32' if m[1] == 'f' else 'bf16'}, D {m[2]}, G {m[3]}"
                    f", JC {m[4]}, JL {m[5]}, TC {m[6]}>")
        elif name and ("registers" in line or "spill" in line):
            print(f"  wkv_kernel{name}: {line.strip()}", flush=True)
    lib = kbuild.library("wkv.cu", ("REPRO_WKV_VARIANTS",))
    lib.repro_wkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.repro_wkv.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wkv_variants: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import rwkv as krwkv
    card = card_line()
    print(f"card: {card}", flush=True)
    lib = build_variants(kbuild)
    variants = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ok = True
    for BH, C, D in SHAPES:
        def normal(shape, scale):
            return torch.as_tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device=dev)
        r, k, v = (normal((BH, C, D), 0.5).bfloat16() for _ in range(3))
        w = torch.as_tensor(rng.uniform(0.8, 1.0, (BH, C, D)).astype(
            np.float32), device=dev)
        u, s0 = normal((BH, D), 0.1), normal((BH, D, D), 0.1)
        y_p, s_p = krwkv.wkv_ref(r, k, v, w, u, s0)
        for G, JC, JL, TC in variants or VARIANTS:
            y, s1 = torch.empty_like(r), torch.empty_like(s0)

            def call():
                err = lib.repro_wkv(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), s0.data_ptr(), y.data_ptr(), s1.data_ptr(),
                    1, BH, C, D, G, JC, JL, TC,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed ({err}) at G {G}, "
                                       f"JC {JC}, JL {JL}, TC {TC}")
            ms = device_ms(torch, call)
            ey = (y.float() - y_p.float()).abs()
            es = (s1 - s_p).abs()
            good = (bool((ey <= 1e-4 + 1e-2 * y_p.float().abs()).all())
                    and bool((es <= 1e-4 + 1e-4 * s_p.abs()).all()))
            ok &= good
            print(f"  K5 bf16 ({BH}, {C}, {D}) G {G} JC {JC} JL {JL} TC {TC}"
                  f": {ms:.4f} ms device time; max |y - plain| "
                  f"{float(ey.max()):.3e}, |state - plain| "
                  f"{float(es.max()):.3e}, within limits: {good}; {card}",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
