"""Bucketed and streaming P2P execution.

The port of `repro.core.engine.p2p`.  `schedules.build_engine_tables` merges
the plans' P2P blocks across all (receiver, sender) pairs into a handful of
width-class buckets; `p2p_bucket_vals` gathers one bucket's operands over
global body ids and runs K1 on them at the warps a block the autotune chose
for the bucket's shape class (`kernels.ops.p2p_auto`), as the reference's
buckets go through its `p2p_auto`.

Streaming alternative (`p2p_stream_vals`): ALL width classes as one grid of
target tiles over the unified stream table
(`schedules.build_p2p_stream_tables`), the slab gathers done inside K2
(`kernels.p2p_stream.p2p_stream`) instead of materialising per-bucket
operands, at the (block_t, warps) the engine's stream tables carry
(`kernels.p2p.best_stream_params`).  `p2p_stream_gathered` is its plain
version.

The kernel wrappers pick the kernel for CUDA tensors and the plain version
for CPU tensors, so this module has one code path for both.  Both entry
points fire the `kernels.p2p.launch` fault seam (`resilience.faults`)
before the kernel: Python dispatch, so inside a compiled entry it fires
during the entry's warm-up or capture, never on a replay.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import p2p_auto
from repro_torch.kernels.p2p_stream import p2p_stream, p2p_stream_gathered
from repro_torch.resilience import faults as _faults

__all__ = ["p2p_bucket_vals", "p2p_stream_vals", "p2p_stream_gathered",
           "stream_payload"]


def _gather_bucket(x, q, t_idx, s_idx, s_valid):
    """Global-id gathers for one bucket: x (P, N, 3), q (P, N) payload."""
    x_flat = x.reshape(-1, 3)
    q_flat = q.reshape(-1)
    xt = x_flat[t_idx]                                      # (B, wt, 3)
    xs = x_flat[s_idx]                                      # (B, ws, 3)
    qs = torch.where(s_valid, q_flat[s_idx],
                     torch.zeros((), dtype=q.dtype, device=q.device))
    return xt, xs, qs


def p2p_bucket_vals(x, q, bucket: dict):
    """Evaluate one width-class bucket (device tables) -> (B, wt) f32
    masked values."""
    xt, xs, qs = _gather_bucket(x, q, bucket["t_idx"], bucket["s_idx"],
                                bucket["s_valid"])
    _faults.fire("kernels.p2p.launch")
    return p2p_auto(qs, xs, xt) * bucket["mask"][:, None]


def stream_payload(x, q, pad: int):
    """Flatten the (P, Nmax, ...) payload into the streaming kernel's
    structure-of-arrays slab source: (4, P*Nmax + pad) f32 rows [x; y; z; q],
    zero-padded so fixed-size slab reads never run past the end."""
    x_flat = x.reshape(-1, 3).to(torch.float32)
    q_flat = q.reshape(-1).to(torch.float32)
    soa = torch.cat([x_flat.T, q_flat[None, :]], dim=0)
    return torch.nn.functional.pad(soa, (0, pad)).contiguous()


def p2p_stream_vals(x, q, stream: dict):
    """Evaluate the unified stream table (device `meta`; statics `pad`,
    `block_t`, `smax` and `warps`, None for K2's heuristic) -> (Ti,
    block_t) f32 values.  Lanes past a tile's target count (0.0 from the kernel,
    sums from the plain version) are dropped by the caller's accumulation
    through `out_valid`."""
    payload = stream_payload(x, q, stream["pad"])
    _faults.fire("kernels.p2p.launch")
    return p2p_stream(stream["meta"], payload, block_t=stream["block_t"],
                      smax=stream["smax"], warps=stream.get("warps"))
