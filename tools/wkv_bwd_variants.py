#!/usr/bin/env python3
"""Times K5's backward kernel (csrc/wkv_bwd.cu) at rwkv6-1.6b's training
shapes for every launch it was tried with, on one NVIDIA GPU.

    python3 tools/wkv_bwd_variants.py                 # every variant
    python3 tools/wkv_bwd_variants.py 4,2,4,8         # only those given

A variant is a launch shape (JL, A, NW, TB) of the one kernel: columns and
rows a lane, warps a block, tokens a stage.  Builds csrc/wkv_bwd.cu with
-DREPRO_WKV_BWD_VARIANTS (the shipped launches and the others tried,
WKV_BWD_VARIANTS) into build/repro_torch/, prints
ptxas's registers and spills for each entry, then launches each variant
through the port's wrapper (`_launch_bwd(..., params=)`) at (BH, C, D) in
SHAPES (rwkv6-1.6b's 32 heads at batch 4 and 2, one of 2 data ranks and
one of 4 model ranks at batch 2), bfloat16 r/k/v/dy, float32 w in (0.8,
1), a random state and final-state gradient: the device time of one launch
(`chip_smoke.device_ms`: 20 launches queued behind a sleep kernel) beside
the bound, the blocks an SM and the registers the card reports, and the
largest difference of each gradient from `wkv_bwd`, held to the card
tests' limits (K5_BWD_ATOL of each gradient's largest |value|, bf16 dr,
dk, dv also K5_BWD_BF16_RTOL).  Exits non-zero without a CUDA device or
when a variant breaks a limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (K5_BWD_ATOL, K5_BWD_BF16_RTOL,  # noqa: E402
                        WKV_BWD_ENTRY, bound_ms, card_line, device_ms,
                        wkv_bwd_entry)

# (JL, A, NW, TB): the shipped four first ((4, 4, 4, 4) where 2 rows a lane
# would take two waves, (4, 2, 4, 8) from BH 33, (4, 1, 4, 16) from BH 17,
# (2, 1, 8, 16) below), then the others tried: 4-token stages at 2 rows a
# lane (4 blocks an SM), other splits of a row's columns and rows and of a
# block's warps
VARIANTS = ((4, 4, 4, 4), (4, 2, 4, 8), (4, 1, 4, 16), (2, 1, 8, 16),
            (4, 2, 4, 4), (4, 1, 4, 8), (2, 2, 8, 8), (4, 2, 2, 8))
SHAPES = ((128, 512, 64), (64, 512, 64), (32, 512, 64), (16, 512, 64))
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


def print_ptxas(kbuild) -> None:
    """Build the variants' library and print ptxas's registers and spills
    for each entry."""
    logs = kbuild.build(("wkv_bwd.cu",), ("REPRO_WKV_BWD_VARIANTS",))
    name = ""
    for line in logs.get("wkv_bwd.cu", "").splitlines():
        m = WKV_BWD_ENTRY.search(line)
        if m:
            name = wkv_bwd_entry(m)
        elif name and ("registers" in line or "spill" in line):
            print(f"  {name}: {line.strip()}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wkv_bwd_variants: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import rwkv as krwkv
    card = card_line()
    print(f"card: {card}", flush=True)
    print_ptxas(kbuild)
    variants = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ok = True
    for BH, C, D in SHAPES:
        def normal(shape, scale):
            return torch.as_tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device=dev)
        r, k, v, dy = (normal((BH, C, D), 0.5).bfloat16() for _ in range(4))
        w = torch.as_tensor(rng.uniform(0.8, 1.0, (BH, C, D)).astype(
            np.float32), device=dev)
        u, s0, ds = normal((BH, D), 0.1), normal((BH, D, D), 0.1), normal(
            (BH, D, D), 1.0)
        ins = (r, k, v, w, u, s0, dy, ds)
        plain = krwkv.wkv_bwd(*ins)
        bms, by = bound_ms(BH * C * D * (7 * 2 + 2 * 4) + 12.0 * BH * D * D,
                           14.0 * BH * C * D * D)
        for params in variants or VARIANTS:
            outs = krwkv._launch_bwd(*ins, params=params)
            ms = device_ms(torch, lambda: krwkv._launch_bwd(
                *ins, params=params), reps=20)
            errs = []
            for name, g, p in zip(NAMES, outs, plain):
                g, p = g.float(), p.float()
                rtol = K5_BWD_BF16_RTOL if name in ("dr", "dk", "dv") else 0
                lim = K5_BWD_ATOL * float(p.abs().max()) + rtol * p.abs()
                good = bool(((g - p).abs() <= lim).all())
                ok &= good
                errs.append(f"{name} {float((g - p).abs().max()):.2e}"
                            f"{'' if good else ' OVER'}")
            nrb, _, _ = krwkv._bwd_blocks(C, D, params)
            fit = krwkv.bwd_fit(torch.bfloat16, D, params, variants=True)
            print(f"  K5.bwd bf16 ({BH}, {C}, {D}) {params} (JL, A, NW, TB): "
                  f"{ms:.4f} ms device time (bound {bms:.4f} ms ({by}), "
                  f"{100 * bms / ms:.2f}%; {BH * nrb} blocks, "
                  f"{fit['blocks_per_sm']} an SM, {fit['registers']} registers, "
                  f"{fit['spill_bytes']} B spilled, {fit['smem_bytes']} B "
                  f"shared); max |kernel - wkv_bwd| "
                  f"{', '.join(errs)}; {card}", flush=True)
            del outs
        del plain
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
