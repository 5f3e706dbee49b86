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
the MoE sublayer takes the reference's expert-parallel route
(`_moe_shard_map`) as a step of the rank program of `models.tp`, over
the ranks this process holds (`core.dist.comm`: every rank of a stacked
mesh, or this process's one rank of a group mesh).  Each rank holds only
its expert block, (E / n_model) experts (`tp.model_shardings`: the
'model' entries of the reference's specs), cut on their D dim over the
data axes where the mesh has more than one data rank (the 'data'
entries: FSDP), and a copy of the router.  The cut blocks are
all-gathered over the data axes before the experts run, ZeRO-3, as the
reference's body all-gathers them (`src/repro/models/moe.py:138-142`):
inside a model with the rest of the superblock at its entry
(`tp.TP.gather`, one flat buffer), through `moe_ffn` here; the gather's
backward reduce-scatters the experts' gradients back to the cuts.  The
tokens of a rank
are its data shard, replicated over the model axis; each rank routes its
tokens with the capacity of its own token count (`_capacity`) into an
(E, C, D) buffer; the buffer goes to the experts' ranks by an all-to-all
over the model axis in the reference's destination-major layout, the
rank's experts run as one batched product over (E / n_model, n_model *
C, D), the rows come back by the reverse all-to-all and are combined.
With `moe_seq_shard` and T % n_model == 0 each model rank routes only its
slice of the tokens, and the outputs are all-gathered over the model
axis; the aux loss is averaged over the model axis then, and over the
data axes always.  Every model rank ends with the same output, so, as
`shard_map` transposes a replicated output, the output's and the aux
loss's cotangents are divided by n_model, and the input and the router
enter through `copy_into` (their gradients psummed over the model axis):
a rank's backward then gives its expert block's gradient and the whole
router gradient.  The all-to-alls, the all-gather and the means are the
communicators' differentiable collectives, on a stacked and a group mesh
alike.  `moe_ffn` keeps its batch convention (stacked: the whole (B, S,
D); group: the rank's shard), with the weights as blocks.

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
routed alike, dropped nothing, or met a near tie.  A routing recomputed in
backward (a superblock under `torch.utils.checkpoint`) is not recorded
again.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.core.dist.comm import scale_grad
from repro_torch.models.params import ParamDef
from repro_torch.sharding.parallel import NONE

__all__ = ["moe_defs", "moe_ffn", "moe_ranks", "routing_log"]

_log: list | None = None


def _record(eidx, keep, margin_fn) -> None:
    """Append a routing to the open log, unless it is a recompute in
    backward."""
    if _log is not None and torch._C._current_autograd_node() is None:
        with torch.no_grad():
            _log.append((eidx, keep, margin_fn()))


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
    _record(eidx, keep, lambda: _margin(x2d, p["router"], cfg.top_k))
    buf = _dispatch(x2d, eidx, pos, keep, cfg.n_experts, C)
    y_buf = _expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    y = _combine(y_buf, gate, eidx, pos, keep)
    return y.reshape(B, S, D), aux


def moe_ffn(x, p, cfg, par=NONE):
    """x: (B, S, D) -> (y, aux_loss): `_moe_dense` where `par` runs no
    rank program (no mesh, one data rank and no model axis of more than
    one rank); else the rank program's route on the rank blocks `p`
    (`tp.shard_model`'s of `moe_defs`, gathered here), x and y the batch
    (stacked: whole; group: the rank's shard)."""
    from repro_torch.models import tp as tp_mod
    if tp_mod.plan(cfg, par) is None:
        return _moe_dense(x, p, cfg)
    return _moe_shard_map(x, p, cfg, par)


def _moe_shard_map(x, p, cfg, par):
    from repro_torch.models import tp as tp_mod
    defs = moe_defs(cfg)
    cut = tp_mod.infer_cut(p, defs, par.mesh, par.data_axes)
    tp = tp_mod.TP(cfg, par, cut)
    sh = tp_mod.model_shardings(
        defs, cfg, par.mesh, par.model_axis,
        data_axes=tp_mod._data_axes(par.mesh, par.data_axes),
        fsdp=bool(cut), fsdp_pod=cut == ("pod", "data"))
    with tp.scope():
        g = tp.gather(p, sh)
        xl = tp.enter(x)
        if tp.covered:
            y, aux = moe_ranks(xl, g, cfg, par, tp)
        else:
            outs = [_moe_dense(xl[i], tp_mod.rank_tree(g, i), cfg)
                    for i in range(tp.L)]
            y = torch.stack([o[0] for o in outs])
            aux = torch.stack([o[1] for o in outs])
        return tp.leave(y), tp.leave_mean(aux)


def moe_ranks(xl, p, cfg, par, tp):
    """The expert-parallel route (module docstring) on each local rank's
    tokens xl (L, B_l, S, D) and its gathered weights p (every leaf (L,
    ...), `tp.TP.gather`'s) -> (y (L, B_l, S, D), aux (L,))."""
    mesh, model = tp.mesh, tp.axis
    n_model = tp.M
    assert cfg.n_experts % n_model == 0, (cfg.n_experts, n_model)
    dp = tuple(par.data_axes)
    E, D = cfg.n_experts, xl.shape[-1]
    E_loc = E // n_model
    xl = tp.f(xl)
    router = tp.f(p["router"].float())
    L, B_loc, S = xl.shape[:3]
    T_full = B_loc * S
    # without sequence sharding every model rank routes the SAME tokens,
    # so dispatch and a2a bytes are replicated n_model times; slicing
    # tokens over the model axis first removes the redundancy
    seq_shard = par.moe_seq_shard and T_full % n_model == 0
    me = tp.midx
    Tl = T_full // n_model if seq_shard else T_full
    C = _capacity(Tl, cfg)
    sends, meta, auxs = [], [], []
    for i in range(L):
        x2d = xl[i].reshape(-1, D)
        if seq_shard:
            x2d = x2d[me[i] * Tl:(me[i] + 1) * Tl]
        gate, eidx, pos, keep, aux = _route(x2d, router[i], E, cfg.top_k, C)
        _record(eidx, keep, lambda: _margin(x2d, router[i], cfg.top_k))
        buf = _dispatch(x2d, eidx, pos, keep, E, C)            # (E, C, D)
        sends.append(buf.reshape(n_model, E_loc * C, D))
        meta.append((gate, eidx, pos, keep))
        auxs.append(aux)
    # a2a over the model axis, destination-major: expert rows contiguous
    # per rank
    recv = mesh.all_to_all(torch.stack(sends), model)
    recv = recv.reshape(L, n_model, E_loc, C, D).transpose(1, 2) \
               .reshape(L, E_loc, n_model * C, D)
    y = torch.stack([_expert_ffn(recv[i], *(p[k][i] for k in (
        "w_gate", "w_up", "w_down"))) for i in range(L)])
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
    out = scale_grad(out.reshape(L, B_loc, S, D), 1.0 / n_model)
    return out, scale_grad(aux, 1.0 / n_model)
