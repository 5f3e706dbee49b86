"""Mixture-of-experts FFN: top-k routing with fixed per-expert capacity.

The port's copy of the reference's single-shard path,
`repro.models.moe._moe_dense`: tokens are routed with a float32 router
(softmax, top-k, gates renormalised), each (token, k) slot takes the next
free row of its expert's capacity in token-major order (a cumulative sum
over the (T * k, E) one-hot), slots past the capacity are dropped (their
rows go to a trash row of the send buffer, and their gate counts 0), the
experts run as one batched product over the (E, C, D) buffer, and the rows
come back weighted by their gates.  The reference calls expert dispatch a
sparse data exchange: on one rank it is this scatter and gather.

Under a `Parallelism` whose mesh has a model axis of more than one rank,
`moe_ffn` takes the reference's expert-parallel route (`_moe_shard_map`)
step by step, as a rank program over the ranks this process holds
(`core.dist.comm`: every rank of a stacked mesh, or this process's one
rank of a group mesh): tokens split over the data axes and replicated
over the model axis; each rank routes its tokens with the capacity of its
own token count (`_capacity`) into an (E, C, D) buffer; its experts'
weights (E / n_model of them, the model axis's block) are all-gathered
over the data axes (the FSDP shards: `w_gate` / `w_up` on dim 1, `w_down`
on dim 2); the buffer goes to the experts' ranks by an all-to-all over
the model axis in the reference's destination-major layout, the rank's
experts run as one batched product over (E / n_model, n_model * C, D),
the rows come back by the reverse all-to-all and are combined.  With
`moe_seq_shard` and T % n_model == 0 each model rank routes only its
slice of the tokens, and the outputs are all-gathered over the model
axis; the aux loss is averaged over the model axis then, and over the
data axes always.  On a stacked mesh the input and weights are whole and
the output is the whole (B, S, D) array; on a group mesh the input is
this rank's data shard, the weights whole (each rank cuts its block), and
the output its shard.  The stacked route is differentiable end to end.

Nothing here reads the device from the host (no `.item()`, `nonzero` or
boolean index; the one-hot compares with `arange(E)`; the stacked
collectives are reshapes, transposes and sums), so a decode step with MoE
sublayers captures as one CUDA graph, under a stacked mesh too.  The router product runs in
float32 as written: with `torch.backends.cuda.matmul.allow_tf32` left False
(PyTorch's default) it is not rounded to TF32 on the card.

On a stacked mesh the route runs inside `obs.cost.stacked(L)` (L the
mesh's ranks), which tells an active cost walker that L ranks' work runs
here (a no-op otherwise).

`routing_log()` records, while it is open, each routing's expert choices,
kept slots and top-k margins (one entry a `_moe_dense` call, one a rank
of the expert-parallel route), so a caller can tell whether two runs
routed alike, dropped nothing, or met a near tie.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.core.dist.comm import StackedComm
from repro_torch.models.params import ParamDef, Sharding
from repro_torch.obs import cost
from repro_torch.sharding.parallel import NONE

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
        "router": ParamDef((d, e), (None, None), dtype="float32"),
        "w_gate": ParamDef((e, d, f), ("model", "data", None)),
        "w_up": ParamDef((e, d, f), ("model", "data", None)),
        "w_down": ParamDef((e, f, d), ("model", None, "data")),
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


def moe_ffn(x, p, cfg, par=NONE):
    """x: (B, S, D) -> (y, aux_loss): `_moe_dense` without a mesh, a model
    axis, or with one model rank; else the expert-parallel route."""
    if par.mesh is None or par.model_axis is None or par.tp_size() == 1:
        return _moe_dense(x, p, cfg)
    return _moe_shard_map(x, p, cfg, par)


def _rank_blocks(mesh, w, specs):
    """(L, *block) of a whole leaf: each local rank's block under `specs`
    (the reference's shard_map in_specs), views stacked."""
    sh = Sharding(mesh, specs)
    return torch.stack([sh.block(w, r) for r in mesh.local_ranks])


def _moe_shard_map(x, p, cfg, par):
    if isinstance(par.mesh, StackedComm):
        with cost.stacked(par.mesh.n_ranks):
            return _moe_ranks(x, p, cfg, par)
    return _moe_ranks(x, p, cfg, par)


def _moe_ranks(x, p, cfg, par):
    mesh = par.mesh
    n_model = mesh.shape[par.model_axis]
    assert cfg.n_experts % n_model == 0, (cfg.n_experts, n_model)
    dp, model = tuple(par.data_axes), par.model_axis
    E, D = cfg.n_experts, x.shape[-1]
    E_loc = E // n_model
    stacked = isinstance(mesh, StackedComm)
    # the tokens of each local rank: its data shard (B_loc, S, D),
    # REPLICATED over the model axis
    if stacked:
        n_dp = par.dp_size()
        if x.shape[0] % n_dp:
            raise ValueError(f"moe_ffn: a batch of {x.shape[0]} does not "
                             f"split over {n_dp} data ranks")
        shards = x.reshape(n_dp, -1, *x.shape[1:])
        # (host indices: nothing is copied from the host, so a CUDA graph
        # can capture this)
        xl = torch.stack([shards[j] for j in (mesh.axis_index(dp) if dp
                                              else [0] * mesh.n_ranks)])
    else:
        xl = x[None]
    L, B_loc, S = xl.shape[:3]
    T_full = B_loc * S
    # expert weights enter un-gathered on their FSDP (data) dim: the
    # rank's block of the reference's in_specs, all-gathered below
    fsdp = dp if dp else None
    w_gate = _rank_blocks(mesh, p["w_gate"], (model, fsdp, None))
    w_up = _rank_blocks(mesh, p["w_up"], (model, fsdp, None))
    w_down = _rank_blocks(mesh, p["w_down"], (model, None, fsdp))
    router = p["router"].float()
    # without sequence sharding every model rank routes the SAME tokens,
    # so dispatch and a2a bytes are replicated n_model times; slicing
    # tokens over the model axis first removes the redundancy
    seq_shard = par.moe_seq_shard and T_full % n_model == 0
    me = mesh.axis_index(model)
    Tl = T_full // n_model if seq_shard else T_full
    C = _capacity(Tl, cfg)
    sends, meta, auxs = [], [], []
    for i in range(L):
        x2d = xl[i].reshape(-1, D)
        if seq_shard:
            x2d = x2d[me[i] * Tl:(me[i] + 1) * Tl]
        gate, eidx, pos, keep, aux = _route(x2d, router, E, cfg.top_k, C)
        if _log is not None:
            _log.append((eidx, keep, _margin(x2d, router, cfg.top_k)))
        buf = _dispatch(x2d, eidx, pos, keep, E, C)            # (E, C, D)
        sends.append(buf.reshape(n_model, E_loc * C, D))
        meta.append((gate, eidx, pos, keep))
        auxs.append(aux)
    # FSDP gather of the expert weights over the data axes (ZeRO-3)
    for ax in dp:
        w_gate = mesh.all_gather(w_gate, ax, dim=1, tiled=True)
        w_up = mesh.all_gather(w_up, ax, dim=1, tiled=True)
        w_down = mesh.all_gather(w_down, ax, dim=2, tiled=True)
    # a2a over the model axis, destination-major: expert rows contiguous
    # per rank
    recv = mesh.all_to_all(torch.stack(sends), model)
    recv = recv.reshape(L, n_model, E_loc, C, D).transpose(1, 2) \
               .reshape(L, E_loc, n_model * C, D)
    y = torch.stack([_expert_ffn(recv[i], w_gate[i], w_up[i], w_down[i])
                     for i in range(L)])                  # (L, E_loc, nC, D)
    y4 = y.reshape(L, E_loc, n_model, C, D).transpose(1, 2) \
          .reshape(L, n_model, E_loc * C, D)
    back = mesh.all_to_all(y4, model).reshape(L, E, C, D)
    out = torch.stack([_combine(back[i], *meta[i]) for i in range(L)])
    aux = torch.stack(auxs)
    if seq_shard:
        # reconstruct the full token set
        out = mesh.all_gather(out, model, dim=0, tiled=True)
        aux = mesh.pmean(aux, model)
    # aux identical across model (replicated routing); average over data
    for ax in dp:
        aux = mesh.pmean(aux, ax)
    out = out.reshape(L, B_loc, S, D)
    if not stacked:
        return out[0], aux[0]
    # every model rank holds its data shard's output: take, for each data
    # shard in order, the first rank that holds it
    shard = mesh.axis_index(dp) if dp else [0] * L
    first = [shard.index(j) for j in range(par.dp_size())]
    return torch.stack([out[i] for i in first]).reshape(x.shape), aux[0]
