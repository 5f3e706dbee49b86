"""Mixture-of-experts FFN: top-k routing with fixed per-expert capacity.

The port's copy of the reference's single-shard path,
`repro.models.moe._moe_dense`: tokens are routed with a float32 router
(softmax, top-k, gates renormalised), each (token, k) slot takes the next
free row of its expert's capacity in token-major order (a cumulative sum
over the (T * k, E) one-hot), slots past the capacity are dropped (their
rows go to a trash row of the send buffer, and their gate counts 0), the
experts run as one batched product over the (E, C, D) buffer, and the rows
come back weighted by their gates.  The reference calls expert dispatch a
sparse data exchange: on one card it is this scatter and gather.  The
reference's expert-parallel route (`_moe_shard_map`, an all-to-all over a
mesh axis, and `core/collectives.py`) is not ported: it waits for the
sharding slice (ROADMAP.md).

Nothing here reads the device from the host (no `.item()`, `nonzero` or
boolean index; the one-hot compares with `arange(E)`), so a decode step
with MoE sublayers captures as one CUDA graph.  The router product runs in
float32 as written: with `torch.backends.cuda.matmul.allow_tf32` left False
(PyTorch's default) it is not rounded to TF32 on the card.

`routing_log()` records, while it is open, each `_moe_dense` call's expert
choices, kept slots and top-k margins, so a caller can tell whether two
runs routed alike, dropped nothing, or met a near tie.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

__all__ = ["moe_defs", "moe_ffn", "routing_log"]

_log: list | None = None


@contextmanager
def routing_log():
    """Within the block, every MoE sublayer appends (expert_idx (T, k),
    keep (T, k), margin (T,)) of its call to the yielded list, on the
    device: margin is the gap between a token's k-th and (k+1)-th router
    logits, under which two runs that round the router's input differently
    may choose differently."""
    global _log
    prev, _log = _log, []
    try:
        yield _log
    finally:
        _log = prev


def moe_defs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, e), dtype="float32"),
        "w_gate": ParamDef((e, d, f)),
        "w_up": ParamDef((e, d, f)),
        "w_down": ParamDef((e, f, d)),
    }


def _route(x2d, router_w, n_experts, top_k, capacity):
    """Common routing math.  x2d: (T, D) -> (gate_vals, expert_idx, pos,
    keep, aux), the first four (T, k)."""
    logits = x2d.float() @ router_w.float()                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, k) slot within its expert's capacity
    experts = torch.arange(n_experts, device=x2d.device)
    flat = (expert_idx.reshape(-1, 1) == experts).long()        # (T*k, E)
    pos = flat.cumsum(0) - flat                                 # pos before me
    pos = (pos * flat).sum(-1).reshape(-1, top_k)               # (T, k)
    keep = pos < capacity
    # aux losses: load-balance (switch) + router z-loss
    frac = flat.reshape(-1, top_k, n_experts).sum(1).float().mean(0)
    imp = probs.mean(0)
    aux = n_experts * (frac * imp).sum() + 1e-3 * torch.logsumexp(
        logits, dim=-1).square().mean()
    return gate_vals, expert_idx, pos, keep, aux


def _dispatch(x2d, expert_idx, pos, keep, n_experts, capacity):
    """Scatter tokens into the (E, C, D) send buffer (dropped slots into a
    trash row past the last expert's)."""
    T, D = x2d.shape
    k = expert_idx.shape[1]
    slot = (expert_idx * capacity + pos).reshape(-1)            # (T*k,)
    slot = torch.where(keep.reshape(-1), slot, n_experts * capacity)
    buf = torch.zeros(n_experts * capacity + 1, D, dtype=x2d.dtype,
                      device=x2d.device)
    buf.index_add_(0, slot, x2d.repeat_interleave(k, dim=0))
    return buf[:-1].reshape(n_experts, capacity, D)


def _combine(y_buf, gate_vals, expert_idx, pos, keep):
    """Gather expert outputs back to tokens, weighted by gates."""
    E, C, D = y_buf.shape
    T, k = expert_idx.shape
    slot = (expert_idx * C + pos).reshape(-1)
    rows = y_buf.reshape(E * C, D)[torch.where(keep.reshape(-1), slot, 0)]
    rows = rows * (keep.reshape(-1, 1) * gate_vals.reshape(-1, 1)).to(
        rows.dtype)
    return rows.reshape(T, k, D).sum(dim=1)


def _expert_ffn(xb, w_gate, w_up, w_down):
    """xb: (E, C, D); weights (E, D, F) / (E, F, D): SwiGLU per expert as
    batched products (the reference's einsums, outside Pallas)."""
    h = F.silu(torch.bmm(xb, w_gate)) * torch.bmm(xb, w_up)
    return torch.bmm(h, w_down)


def _capacity(tokens: int, cfg) -> int:
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _margin(x2d, router_w, top_k):
    """(T,) the gap between each token's k-th and (k+1)-th router logits
    (inf when every expert is chosen)."""
    logits = x2d.float() @ router_w.float()
    if top_k >= logits.shape[-1]:
        return torch.full(logits.shape[:1], float("inf"), device=x2d.device)
    top = torch.topk(logits, top_k + 1, dim=-1).values
    return top[:, -2] - top[:, -1]


def _moe_dense(x, p, cfg):
    """Single-shard MoE: x (B, S, D) -> (y, aux)."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    C = _capacity(x2d.shape[0], cfg)
    gate, eidx, pos, keep, aux = _route(x2d, p["router"], cfg.n_experts,
                                        cfg.top_k, C)
    if _log is not None:
        _log.append((eidx, keep, _margin(x2d, p["router"], cfg.top_k)))
    buf = _dispatch(x2d, eidx, pos, keep, cfg.n_experts, C)
    y_buf = _expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    y = _combine(y_buf, gate, eidx, pos, keep)
    return y.reshape(B, S, D), aux


def moe_ffn(x, p, cfg):
    """x: (B, S, D) -> (y, aux_loss), on one card."""
    return _moe_dense(x, p, cfg)
