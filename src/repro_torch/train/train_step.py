"""The train step: gradient accumulation over micro-batches + AdamW, the
reference's `repro.train.train_step`.

The reference jits the step and scans over micro-batches; the port runs
eagerly and loops.  Gradients come from `torch.autograd.grad` over the
weight tree's leaves (a leaf the loss does not reach gets zeros, as
`jax.value_and_grad` gives).  With `n_micro` > 1 the micro-batches' float32
gradients and losses are summed and divided by `n_micro`.  The
reference's `chunked_attn` is dropped: K4 serves every length.

Under a mesh (`par` with a mesh whose data axes hold more than one
rank, or a model axis of more than one rank; `models.tp.COVERED` names
every family) the step runs the rank program of
`models.tp` over every rank this process holds (all of a stacked mesh
at once, or this process's one of a group mesh): the batch splits over
the data ranks (row-major over the data axes, as the reference's batch
spec splits it; each data rank's slice into `n_micro` micro-batches), and
each rank's loss is its slice's mean, whose gradient the rank takes by
itself (its loss seeds its own backward).  The reference leaves the
reduction to GSPMD; its docstring promises the hierarchical all-reduce,
but its code never calls one (ROADMAP.md, faults of the reference).  The
port reduces explicitly:

  FSDP leaves (a 'data' entry in the spec, cut over the data axes,
  `tp.cut_axes`): each superblock's gather reduce-scatters their
  gradient back to the cuts in its backward (stage 1: over 'data', or
  ('pod', 'data') with `fsdp_pod`, float32); then an all-reduce of the
  cuts over the data axes not cut, `par.pod_axis` (stage 2).  These are
  the first two stages of `core.collectives.hierarchical_all_reduce`,
  without its all-gather;
  the other leaves (norms, biases, the router), and every leaf with
  `fsdp=False` (whole on every data rank), and the loss: flattened into
  one float32 buffer and summed by `hierarchical_all_reduce`
  (reduce-scatter over the inner data axis, all-reduce over the pod
  axis, all-gather; with `par.hierarchical` and a pod axis among the
  data axes), else one flat all-reduce over the data axes.

Divided by the number of data ranks, that is the gradient of the whole
batch's mean loss.  A leaf the data ranks of a stacked mesh share (held
one a model rank) runs as one copy a rank, so that every gradient is a
rank's own and every sum adds in group order: a stacked and a group mesh
give the same bits.  Then the model axis's partial sums (`tp.sync_grads`:
q_norm / k_norm over the model axis, a key/value head several ranks hold
over them); the clipping norm counts each element of the whole gradient
once (`tp.grad_sq_sum`); AdamW applies on the blocks and cuts each rank
holds, its float32 master and moments shaped alike.  `train_step.comm`
holds the last step's reduction stages ({"stage", "axes",
"bytes_per_rank"}: the bytes a rank puts into each: its float32 gathered
gradients for the reduce-scatter, its reduced part for the others).
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import _stage, hierarchical_all_reduce
from repro_torch.core.dist.comm import grad_log
from repro_torch.models import tp as tp_mod
from repro_torch.models import transformer as tf
from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten
from repro_torch.obs import cost
from repro_torch.sharding.parallel import NONE, Parallelism
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["make_train_step", "value_and_grad", "reduction_axes"]


def value_and_grad(params, batch, cfg, par=NONE):
    """(loss, parts, grads): `transformer.loss_fn` of the weight tree (its
    leaves require grad) on the batch, and its gradient as a tree of the
    params' structure and types (under a model axis, `tp.sync_grads`
    applied; nothing reduced over data ranks)."""
    loss, parts = tf.loss_fn(params, batch, cfg, par)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    grads = tree_unflatten(params, grads)
    tp = tp_mod.plan(cfg, par, params)
    if tp is not None:
        grads = tp_mod.sync_grads(grads, tp.sh)
    return loss.detach(), parts, grads


def _accumulated(params, batch, cfg, n_micro, par):
    """(loss, grads) of a batch over `n_micro` micro-batches."""
    B = batch["tokens"].shape[0]
    if B % n_micro:
        raise ValueError(f"train_step: batch {B} is not a multiple of "
                         f"n_micro {n_micro}")
    if n_micro == 1:
        loss, _, grads = value_and_grad(params, batch, cfg, par)
        return loss, grads
    acc = map_tree(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    acc_leaves = tree_leaves(acc)
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    mb = B // n_micro
    for i in range(n_micro):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l, _, g = value_and_grad(params, micro, cfg, par)
        torch._foreach_add_(acc_leaves, tree_leaves(g))
        loss = loss + l
    torch._foreach_div_(acc_leaves, n_micro)
    return loss / n_micro, acc


def reduction_axes(par: Parallelism) -> tuple:
    """(inner, outer) axes of the all-reduce of the leaves without a cut:
    the inner data axes then the pod axis with `par.hierarchical` and a
    pod axis among the data axes, else (every data axis, None), one flat
    all-reduce."""
    dp = tuple(par.data_axes)
    pod = par.pod_axis if par.pod_axis in dp else None
    inner = tuple(a for a in dp if a != pod)
    if par.hierarchical and pod is not None and len(inner) > 0:
        return (inner[0] if len(inner) == 1 else inner), pod
    return dp, None


def _micro(batch, n_dp: int, n_micro: int, i: int) -> dict:
    """Micro-batch i of a batch whose rows split over n_dp data ranks:
    the i-th 1/n_micro of each data rank's slice, in data-rank order."""
    if n_micro == 1:
        return batch
    B = batch["tokens"].shape[0]
    b = B // n_dp
    mb = b // n_micro
    return {k: torch.cat([v[j * b + i * mb:j * b + (i + 1) * mb]
                          for j in range(n_dp)]) for k, v in batch.items()}


def _rank_step(params, batch, cfg, n_micro, par, tp, stats):
    """(loss, grads) under the rank program (module docstring): the loss
    a 0-d float32 tensor, the gradients float32 in the params' layout,
    reduced over the data axes and divided by the data ranks, the model
    axis's partial sums not yet added."""
    L = tp.L
    leaves = tree_leaves(params)
    sh = tree_leaves(tp.sh)
    # a leaf the local data ranks share runs as one copy a rank
    work = [p if p.shape[0] == L else
            tp.per_rank(p.detach()).requires_grad_() for p in leaves]
    wtree = tree_unflatten(params, work)
    B = batch["tokens"].shape[0]
    if B % (tp.n_dp * n_micro):
        raise ValueError(f"train_step: batch {B} does not split over "
                         f"{tp.n_dp} data ranks x {n_micro} micro-batches")
    acc, loss = None, None
    with grad_log() as rs:
        for i in range(n_micro):
            losses, _, _ = tf.rank_losses(wtree, _micro(batch, tp.n_dp,
                                                        n_micro, i), cfg,
                                          par, tp)
            g = torch.autograd.grad(losses, work, torch.ones_like(losses),
                                    allow_unused=True)
            g = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                 if gi is None else gi.float() for w, gi in zip(work, g)]
            acc = g if acc is None else list(torch._foreach_add(acc, g))
            loss = losses.detach().float() if loss is None \
                else loss + losses.detach().float()
    if n_micro > 1:
        acc = list(torch._foreach_div(acc, n_micro))
        loss = loss / n_micro
    cut = [i for i, s in enumerate(sh) if s is not None and s.cut_axes]
    rest = [i for i, s in enumerate(sh) if s is None or not s.cut_axes]
    dp = tuple(par.data_axes)
    n_dp = par.dp_size()
    if n_dp > 1:
        mesh = tp.mesh
        if cut:
            _stage(stats, "reduce_scatter", tp.cut, sum(rs))
            outer = tuple(a for a in dp if a not in tp.cut)
            if outer:
                flat = torch.cat([acc[i].reshape(L, -1) for i in cut], 1)
                _stage(stats, "all_reduce", outer,
                       flat[0].numel() * flat.element_size())
                flat = mesh.psum(flat, outer)
                _unflat(acc, cut, flat)
        inner, outer = reduction_axes(par)
        flat = torch.cat([acc[i].reshape(L, -1) for i in rest]
                         + [loss.reshape(L, 1)], 1)
        flat = hierarchical_all_reduce(flat, mesh, inner, outer,
                                       stats=stats)
        loss = flat[:, -1] / n_dp
        _unflat(acc, rest, flat[:, :-1])
        acc = list(torch._foreach_div(acc, n_dp))
    # back to the params' layout: a shared leaf's copy of its first rank
    for i, p in enumerate(leaves):
        if p.shape[0] != L:
            firsts = [tp.rows.index(r) for r in range(p.shape[0])]
            acc[i] = acc[i][firsts]
    return loss[0], tree_unflatten(params, acc)


def _unflat(acc, idx, flat) -> None:
    """Write the (L, n) columns of a flat buffer back into acc[idx]."""
    at = 0
    for i in idx:
        n = acc[i][0].numel()
        acc[i] = flat[:, at:at + n].reshape(acc[i].shape)
        at += n


def make_train_step(model_or_cfg, opt_cfg: AdamWConfig = AdamWConfig(),
                    n_micro: int = 1, par: Parallelism = NONE):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): one AdamW step over a batch of `tokens` / `labels` (and
    `frames` / `vis`), B a multiple of `n_micro` (of n_micro times the data
    ranks under a mesh; on a group mesh the batch is this rank's slice).
    Under a rank program the params are the blocks and cuts the ranks
    hold (`tp.shard_model`).  The new params are leaf tensors in the
    config's type that require grad; metrics hold `loss` (a 0-d tensor),
    `grad_norm` (a 0-d tensor) and `lr`."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    dtype = getattr(torch, cfg.dtype)

    def train_step(params, opt_state, batch):
        tp = tp_mod.plan(cfg, par, params)
        shardings = tp.sh if tp is not None else None
        ranks = tp.L if tp is not None and tp.stacked else 1
        with cost.stacked(ranks):
            gnorm = None
            if tp is None:
                loss, grads = _accumulated(params, batch, cfg, n_micro, par)
            else:
                stats = []
                loss, grads = _rank_step(params, batch, cfg, n_micro, par,
                                         tp, stats)
                train_step.comm = stats
                grads = tp_mod.sync_grads(grads, shardings)
                gnorm = torch.sqrt(tp_mod.grad_sq_sum(grads, shardings))
            new_params, new_opt, metrics = adamw_update(
                grads, opt_state, opt_cfg, param_dtype=dtype, gnorm=gnorm)
            new_params = map_tree(lambda p: p.requires_grad_(), new_params)
        return new_params, new_opt, dict(metrics, loss=loss)

    train_step.comm = []
    return train_step
