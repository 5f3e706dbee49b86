"""Compiled FMM entries: a whole warm evaluate, and a within-slack step's
revalidation, each as one closure over static buffers that
`exe_cache.CompiledEntry` captures into one CUDA graph.

The port of `repro.core.engine.fused`.  The per-phase engine
(`DeviceEngine.evaluate` with `fused=False`) dispatches every phase from
Python: the upward pass, the far field, one K1 launch per P2P width-class
bucket (or one K2 launch), M2P and the accumulation, each a few to a few
hundred device operations.  The functions below close over the static
structure (expansion order, bucket count, padded dims, the stream statics)
and call the SAME phase functions (`batched_upward_kernel`,
`far_tail_kernel`, `p2p_bucket_vals` / `p2p_stream_vals`,
`m2p_vals_kernel`) and the same float64 accumulation (`accumulate`), so on
the CPU, where nothing is captured, an entry's potential is the per-phase
one bit for bit; on the card a replay runs the same kernels, and its
potential differs from an eager evaluate's only where `index_add_`'s
atomics add in another order.

Static buffers instead of donation.  The reference donates its payload to
the XLA program and threads it back out.  A CUDA graph bakes in addresses
instead, so a compiled entry owns its inputs (the (P, Nmax, 3) / (P, Nmax)
payload, the step's (N, 3) `new_x`, every flat table) and its outputs; the
engine copies into them (`DeviceEngine._bind`) and never binds a tensor of
its own, or a `DeviceMemo`-resident one, into a graph.

Entry identity: `executable_key` folds `schedules.shape_class_digest` of
the flat tables with the scalar statics; `exe_cache.ExecutableCache`
memoizes the entry per key, so a new geometry of an already-seen shape
class pays no capture.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.engine.m2l import far_tail_kernel, m2p_vals_kernel
from repro_torch.core.engine.p2p import (_gather_bucket, p2p_bucket_vals,
                                         p2p_stream_vals)
from repro_torch.core.engine.traversal import (partition_drift,
                                               restack_payload)
from repro_torch.core.engine.upward import batched_upward_kernel
from repro_torch.kernels.p2p import best_p2p_warps, p2p_launch_params

__all__ = ["flatten_eval_tables", "flatten_step_tables",
           "bucket_launch_params", "build_fused_evaluate",
           "build_fused_step", "accumulate", "accumulate_flat",
           "executable_key", "theta_bucket"]

_M2L_KEYS = ("src", "tgt", "mask", "d")
_P2P_KEYS = ("t_idx", "t_valid", "s_idx", "s_valid", "mask")


# ------------------------------------------------------------- table views --
def flatten_eval_tables(tables, stream: dict | None = None) -> dict:
    """Flat {name: tensor} of every frozen table the compiled evaluate
    reads.  Names are stable across geometries, so the entry depends only
    on the shape class.  With `stream` (the engine's device stream tables)
    the per-bucket tables are replaced by the unified stream tables."""
    flat = dict(tables.up.tables)
    for k, v in tables.m2l.items():
        flat[f"m2l_{k}"] = v
    for k, v in tables.m2p.items():
        flat[f"m2p_{k}"] = v
    if stream is not None:
        flat["p2ps_meta"] = stream["meta"]
        flat["p2ps_out_idx"] = stream["out_idx"]
        flat["p2ps_out_valid"] = stream["out_valid"]
    else:
        for i, b in enumerate(tables.p2p_buckets):
            for k, v in b.items():
                flat[f"p2p{i}_{k}"] = v
    flat["l2p_t_idx"] = tables.l2p_t_idx
    flat["orig_idx"] = tables.orig_idx
    flat["flat_idx"] = tables.flat_idx
    return flat


def flatten_step_tables(tables, x_ref_pad) -> dict:
    """Flat tables of the compiled step revalidation: the orig -> flat
    restack gathers and the stacked slack reference."""
    return {"orig_idx": tables.orig_idx, "flat_idx": tables.flat_idx,
            "x_ref_pad": x_ref_pad}


def bucket_launch_params(tables, x=None, q=None) -> tuple:
    """K1's launch shape (warps a block) for each P2P bucket, in bucket
    order: the counterpart of the reference's `bucket_block_ts`, baked
    into the captured launches and therefore part of the key.  Resolved on
    the host at build time, before any capture, since a timed sweep cannot
    run inside one: on the card each bucket's shape class goes through the
    autotune (`kernels.p2p.best_p2p_warps`) with the bucket's operands
    gathered from the payload (x, q) as its sample, so the captured
    `p2p_auto` finds every class cached.  On the CPU (nothing is launched)
    it is `p2p_launch_params`, as the reference resolves nothing without
    kernels."""
    out = []
    for b in tables.p2p_buckets:
        n_pairs, ws = b["s_idx"].shape
        if x is None or x.device.type != "cuda":
            out.append(p2p_launch_params(int(n_pairs)))
            continue
        xt, xs, qs = _gather_bucket(x, q, b["t_idx"], b["s_idx"],
                                    b["s_valid"])
        out.append(best_p2p_warps(ws, n_pairs, b["t_idx"].shape[1],
                                  sample=(qs, xs, xt)))
    return tuple(out)


# ------------------------------------------------------ compiled closures --
def accumulate_flat(parts, n_flat: int, device) -> torch.Tensor:
    """Sum (idx, valid, vals) value tables into a (n_flat,) float64 flat
    potential on `device` with `index_add_`, in the order given."""
    phi_flat = torch.zeros(n_flat, dtype=torch.float64, device=device)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    for idx, valid, vals in parts:
        contrib = torch.where(valid.reshape(-1),
                              vals.reshape(-1).to(torch.float64), zero)
        phi_flat.index_add_(0, idx.reshape(-1), contrib)
    return phi_flat


def accumulate(parts, n: int, n_flat: int, orig_idx, flat_idx):
    """Sum (idx, valid, vals) value tables into the potential in float64 on
    the device with `index_add_`; returns it (n,) in original body order,
    on the device.  `DeviceEngine.accumulate` and the compiled evaluate
    both run this."""
    dev = orig_idx.device
    phi_flat = accumulate_flat(parts, n_flat, dev)
    phi = torch.zeros(n, dtype=torch.float64, device=dev)
    phi[orig_idx] = phi_flat[flat_idx]
    return phi


def build_fused_evaluate(ops, tables, stream: dict | None = None):
    """Close over the static structure and return the compiled evaluate
    `fused(x, q, tab) -> (phi (N,) float64, M (P, Cmax, nk) float32)`, both
    on the device.  `tab` is `flatten_eval_tables` (the entry's copies).
    `stream`, on the stream route, holds its statics (pad, block_t, smax);
    the near field is then one K2 launch, else one K1 launch per bucket."""
    if obs.enabled():
        obs.event("engine.fused_build",
                  {"kind": "evaluate", "n": tables.n,
                   "n_parts": tables.n_parts,
                   "n_buckets": len(tables.p2p_buckets),
                   "p2p_impl": "stream" if stream is not None else "gathered"})
    P, Cmax = tables.n_parts, tables.n_cells_max
    n_flat, n = P * tables.n_bodies_max, tables.n
    up_keys = tuple(tables.up.tables)
    n_buckets = len(tables.p2p_buckets)
    has_m2p = tables.m2p["b"].shape[0] > 0

    def fused(x, q, tab):
        up = {k: tab[k] for k in up_keys}
        M = batched_upward_kernel(ops, x, q, up, Cmax)
        m2l = {k: tab[f"m2l_{k}"] for k in _M2L_KEYS}
        parts = [(tab["l2p_t_idx"], tab["leaf_valid"],
                  far_tail_kernel(ops, M, x, m2l, up))]
        if stream is not None:
            vals = p2p_stream_vals(x, q, dict(stream, meta=tab["p2ps_meta"]))
            parts.append((tab["p2ps_out_idx"], tab["p2ps_out_valid"], vals))
        for i in range(0 if stream is not None else n_buckets):
            b = {k: tab[f"p2p{i}_{k}"] for k in _P2P_KEYS}
            parts.append((b["t_idx"], b["t_valid"], p2p_bucket_vals(x, q, b)))
        if has_m2p:
            vals = m2p_vals_kernel(ops, M, x, tab["m2p_b"], tab["m2p_centers"],
                                   tab["m2p_mask"], tab["m2p_t_idx"])
            parts.append((tab["m2p_t_idx"], tab["m2p_t_valid"], vals))
        phi = accumulate(parts, n, n_flat, tab["orig_idx"], tab["flat_idx"])
        return phi, M

    return fused


def build_fused_step(tables):
    """The compiled within-slack step revalidation
    `fused(new_x, x, tab) -> (drift (P,), changed (P,), x_new (P, Nmax, 3))`:
    restack the uploaded `new_x` into the payload envelope and reduce every
    partition's drift (against `tab["x_ref_pad"]`) and changed flag
    (against the current payload `x`), as `DeviceEngine.step_drift` does
    eagerly."""
    if obs.enabled():
        obs.event("engine.fused_build",
                  {"kind": "step", "n": tables.n,
                   "n_parts": tables.n_parts})
    P, Nmax = tables.n_parts, tables.n_bodies_max

    def fused(new_x, x, tab):
        x_new = restack_payload(new_x, tab["orig_idx"], tab["flat_idx"], P,
                                Nmax)
        drift, changed = partition_drift(x_new, tab["x_ref_pad"], x)
        return drift, changed, x_new

    return fused


# --------------------------------------------------------------- cache key --
def theta_bucket(theta: float | None) -> int | None:
    """MAC parameter bucketed to 1/16ths: theta only shapes the tables (the
    compiled call does not depend on it), but keying on the bucket keeps one
    entry per serving configuration.  None (an engine built from tables
    alone) stays None."""
    return None if theta is None else int(round(float(theta) * 16.0))


def executable_key(kind: str, digest: str, *, n: int, n_parts: int, p: int,
                   theta: float | None, backend: str, launch=(),
                   p2p_impl: str = "gathered") -> tuple:
    """Shape-class key of one compiled entry: everything that can change
    the captured call (digest = per-table dtypes and shapes as bound,
    padded dims, statics, the device).  `launch` is K1's per-bucket launch
    shapes on the gathered route (`bucket_launch_params`) and
    `(smax, block_t, warps)` on the stream route."""
    return (kind, digest, int(n), int(n_parts), int(p), theta_bucket(theta),
            str(backend), tuple(launch), str(p2p_impl))
