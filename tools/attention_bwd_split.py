#!/usr/bin/env python3
"""Where K4's backward kernel (csrc/attention_bwd.cu) spends its time at
the training shapes of `chip_smoke.K4_GRAD_CASES`, beside the backward of
`F.scaled_dot_product_attention`, on one NVIDIA GPU.

    python3 tools/attention_bwd_split.py

For each shape, in bfloat16 from a seeded generator: the launch parameters
(`attention_bwd_launch_params`: a GQA group's parts, the tiles), the device
time of each of K4.bwd's kernels (prep, dq, dkdv and, with more than one
part, the reduction that adds the parts) and of the kernels SDPA's backward
launches (autograd over SDPA's saved graph, `retain_graph`), each averaged
over REPS calls under `torch.profiler`; and the work of the heaviest block
of each of K4.bwd's two main kernels beside the mean over its blocks
(query steps of a dkdv block, key steps of a dq block, as the kernel's
tile bounds count them) with the number of blocks against the card's SMs:
a kernel with few blocks and one heavy block waits on that block alone.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import K4_GRAD_CASES, PEAK_BF16_FLOPS, card_line  # noqa: E402

REPS = 20
BQD = 64           # dq: query rows a block (csrc: tc::kBQd)


def dkdv_steps(kattn, sq, sk, G, causal, window, parts, bq, d) -> list:
    """Query steps of each dkdv block of one (batch, kv head): its part's
    heads times the query tiles that see its key tile, twice at D = 256
    (dK and dV in two halves)."""
    return [len(run) * n * (1 if d <= 128 else 2)
            for n in kattn._bwd_query_steps(sq, sk, bq, causal, window)
            for run in kattn.group_parts(G, parts)]


def dq_steps(sq, sk, causal, window, bkd) -> list:
    """Key steps of each dq block of one (batch, head)."""
    out = []
    for q0 in range(0, sq, BQD):
        lo = max(0, q0 - window + 1) // bkd if window else 0
        last = sk - 1
        if causal:
            last = min(last, q0 + BQD - 1)
        out.append(max(0, last // bkd + 1 - lo))
    return out


def profile_ms(torch, fn) -> dict:
    """Device ms a call of fn by kernel name, over REPS calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0:
            out[ev.key] = t / 1e3 / REPS
    return out


def short(name: str) -> str:
    for key in ("attn_bwd_prep", "attn_bwd_dkdv", "attn_bwd_dq",
                "attn_bwd_reduce"):
        if key in name:
            return key
    return name[:60]


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import attention as kattn
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card {card_line()}, {sms} SMs; device ms a call, mean of {REPS}",
          flush=True)
    rng = np.random.default_rng(5)

    def normal(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev).to(torch.bfloat16)

    for label, (b, h, hk, sq, sk, d), causal, window in K4_GRAD_CASES:
        q, do = normal((b, h, sq, d)), normal((b, h, sq, d))
        k, v = normal((b, hk, sk, d)), normal((b, hk, sk, d))
        stats = torch.empty(2, b, h, sq, dtype=torch.float32, device=dev)
        o = kattn._launch(q, k, v, causal, window, stats)
        ours = profile_ms(torch, lambda: kattn._launch_bwd(
            q, k, v, o, do, stats, causal, window))
        mask = (None if window is None
                else kattn._mask(sq, sk, causal, window, dev))
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        so = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        lib = profile_ms(torch, lambda: torch.autograd.grad(
            so, leaves, do, retain_graph=True))
        G = h // hk
        parts, bq, bkd = kattn.attention_bwd_launch_params(b, h, hk, sq, sk,
                                                           d, causal, window)
        kv = dkdv_steps(kattn, sq, sk, G, causal, window, parts, bq, d)
        qs = dq_steps(sq, sk, causal, window, bkd)
        print(f"{label} (q {(b, h, sq, d)}, k/v {(b, hk, sk, d)}"
              f"{', causal' if causal else ''}"
              f"{f', window {window}' if window else ''}; launch: parts "
              f"{parts} of {G} heads, bq {bq}, bkd {bkd}):", flush=True)
        print("  K4.bwd " + ", ".join(
            f"{short(n)} {t:.4f}" for n, t in sorted(
                ours.items(), key=lambda x: -x[1])) + f"; sum "
              f"{sum(ours.values()):.4f}", flush=True)
        print(f"  dkdv: {b * hk * len(kv)} blocks, query steps a block max "
              f"{max(kv)}, mean {np.mean(kv):.1f}; dq: {b * h * len(qs)} "
              f"blocks, key steps max {max(qs)}, mean {np.mean(qs):.1f}; "
              f"{sms} SMs", flush=True)
        # each kernel's products over the admitted pairs (2 D operations a
        # pair each: dkdv 4, 6 at D = 256; dq 3) against the bf16 peak
        pairs = kattn.admitted_pairs(sq, sk, causal, window) * b * h
        for kern, n in (("attn_bwd_dkdv", 4 if d <= 128 else 6),
                        ("attn_bwd_dq", 3)):
            t = sum(v for k, v in ours.items() if kern in k)
            rate = n * 2.0 * d * pairs / (t * 1e-3) if t else 0.0
            print(f"  {kern}: {rate / 1e12:.1f} TFLOP/s on the admitted pairs,"
                  f" {100 * rate / PEAK_BF16_FLOPS:.1f}% of the bf16 peak",
                  flush=True)
        print("  SDPA backward " + ", ".join(
            f"{short(n)} {t:.4f}" for n, t in sorted(
                lib.items(), key=lambda x: -x[1])[:4]) + f"; sum "
              f"{sum(lib.values()):.4f}", flush=True)
        del q, k, v, o, do, stats, so, leaves
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
