"""The train step: gradient accumulation over micro-batches + AdamW, the
reference's `repro.train.train_step`.

The reference jits the step and scans over micro-batches; the port runs
eagerly and loops.  Gradients come from `torch.autograd.grad` over the
weight tree's leaves (a leaf the loss does not reach gets zeros, as
`jax.value_and_grad` gives).  With `n_micro` > 1 the micro-batches' float32
gradients and losses are summed and divided by `n_micro`.  The
reference's `chunked_attn` is dropped: K4 serves every length.

Data parallelism (`par` with a mesh whose data axes hold more than one
rank).  The reference leaves the gradient reduction to GSPMD; its
docstring promises the hierarchical all-reduce, but its code never calls
one (ROADMAP.md, faults of the reference).  The port has no GSPMD, so the
reduction is explicit: the batch splits over the data ranks (row-major
over the data axes, as the reference's batch spec splits it), each data
rank takes the gradient of its slice's loss, every rank's float32
gradients and loss are flattened into one buffer, and the buffers are
summed over the data axes by `core.collectives.hierarchical_all_reduce`:
reduce-scatter over the inner data axis, all-reduce over `par.pod_axis`,
all-gather back (with `par.hierarchical` and a pod axis among the data
axes), else one flat all-reduce over the data axes.  Divided by the
number of data ranks, that is the gradient of the whole batch's mean
loss; AdamW then applies once, identically on every rank.

Each data rank's forward runs the rank program of its model ranks (a
mesh of the model axis alone; `models.tp`): the weights are the blocks a
model rank holds (`tp.shard_model`), the same on every data rank, and the
expert-parallel MoE's capacity is that of the data rank's slice, as in
the reference's route; the aux loss's mean over the data axes does not
run inside it, since the gradient reduction already averages over the
data ranks (a rank is not counted twice).  A rank's gradient is its own
blocks' (`value_and_grad` applies `tp.sync_grads`: q_norm / k_norm summed
over the model axis, a key/value head several ranks hold summed over
them), so a model-sharded leaf's gradient is reduced over the data axes
only, and a replicated leaf (norms, the router) has the same gradient on
every model rank.  The clipping norm counts each element of the whole
gradient once (`tp.grad_sq_sum`, psummed over the model axis).  On a
stacked mesh the data ranks run one after another in this process, each
over its model ranks stacked, inside `obs.cost.stacked`; on a group mesh
each process is one rank and holds its slice of the batch and its blocks,
and the model axis's collectives are the group's (differentiable,
`core.dist.comm`).  `train_step.comm` holds the last step's reduction
stages (`hierarchical_all_reduce`'s stats: the bytes a rank puts into
each stage, and over which axes).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.core.collectives import hierarchical_all_reduce
from repro_torch.core.dist.comm import StackedComm
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
    params' structure and types."""
    loss, parts = tf.loss_fn(params, batch, cfg, par)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    grads = tree_unflatten(params, grads)
    sh = _tp_shardings(cfg, par)
    if sh is not None:
        grads = tp_mod.sync_grads(grads, sh)
    return loss.detach(), parts, grads


def _tp_shardings(cfg, par):
    """The weight blocks' placement where `par` runs `cfg` on them."""
    if tp_mod.plan(cfg, par) is None:
        return None
    return tp_mod.model_shardings(tf.model_defs(cfg), cfg, par.mesh,
                                  par.model_axis)


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


def _data_ranks(par: Parallelism, cfg):
    """(the mesh the gradients are reduced over, the `Parallelism` of one
    data rank's forward, whether the data ranks are stacked here)."""
    mesh, dp = par.mesh, tuple(par.data_axes)
    model = tp_mod.plan(cfg, par) is not None
    local = replace(par, mesh=None, data_axes=(), pod_axis=None)
    if not isinstance(mesh, StackedComm):
        if model:
            local = replace(local, mesh=mesh)
        return mesh, local, False
    if model:
        local = replace(local, mesh=StackedComm(
            par.tp_size(), mesh.device, axis_names=(par.model_axis,)))
    red = StackedComm(par.dp_size(), mesh.device, axis_names=dp,
                      shape=[mesh.shape[a] for a in dp])
    return red, local, True


def reduction_axes(par: Parallelism) -> tuple:
    """(inner, outer) axes of the gradient reduction: the inner data axes
    then the pod axis with `par.hierarchical` and a pod axis among the data
    axes, else (every data axis, None), one flat all-reduce."""
    dp = tuple(par.data_axes)
    pod = par.pod_axis if par.pod_axis in dp else None
    inner = tuple(a for a in dp if a != pod)
    if par.hierarchical and pod is not None and len(inner) > 0:
        return (inner[0] if len(inner) == 1 else inner), pod
    return dp, None


def make_train_step(model_or_cfg, opt_cfg: AdamWConfig = AdamWConfig(),
                    n_micro: int = 1, par: Parallelism = NONE):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): one AdamW step over a batch of `tokens` / `labels` (and
    `frames` / `vis`), B a multiple of `n_micro` (of n_micro times the data
    ranks under a mesh; on a group mesh the batch is this rank's slice).
    The new params are leaf tensors in the config's type that require
    grad; metrics hold `loss` (a 0-d tensor), `grad_norm` (a 0-d tensor)
    and `lr`."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    dtype = getattr(torch, cfg.dtype)
    parallel = par.mesh is not None and par.dp_size() > 1
    local = par
    if parallel:
        red, local, stacked = _data_ranks(par, cfg)
        inner, outer = reduction_axes(par)
    shardings = _tp_shardings(cfg, local)
    tp = tp_mod.plan(cfg, local)
    ranks = tp.L if tp is not None and tp.stacked else 1

    def reduced(params, batch):
        n_dp = par.dp_size()
        if stacked:
            B = batch["tokens"].shape[0]
            if B % n_dp:
                raise ValueError(f"train_step: batch {B} does not split "
                                 f"over {n_dp} data ranks")
            b = B // n_dp
            slices = [{k: v[j * b:(j + 1) * b] for k, v in batch.items()}
                      for j in range(n_dp)]
        else:
            slices = [batch]
        bufs = []
        for sl in slices:
            loss, grads = _accumulated(params, sl, cfg, n_micro, local)
            bufs.append(torch.cat([g.float().reshape(-1)
                                   for g in tree_leaves(grads)]
                                  + [loss.float().reshape(1)]))
        stats = []
        buf = hierarchical_all_reduce(torch.stack(bufs), red, inner, outer,
                                      stats=stats)
        train_step.comm = stats
        flat = buf[0] / n_dp
        out, at = [], 0
        for p in tree_leaves(params):
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        return flat[-1], tree_unflatten(params, out)

    def train_step(params, opt_state, batch):
        with cost.stacked(ranks):
            if parallel:
                loss, grads = reduced(params, batch)
            else:
                loss, grads = _accumulated(params, batch, cfg, n_micro, par)
            gnorm = None
            if shardings is not None:
                gnorm = torch.sqrt(tp_mod.grad_sq_sum(grads, shardings))
            new_params, new_opt, metrics = adamw_update(
                grads, opt_state, opt_cfg, param_dtype=dtype, gnorm=gnorm)
            new_params = map_tree(lambda p: p.requires_grad_(), new_params)
        return new_params, new_opt, dict(metrics, loss=loss)

    train_step.comm = []
    return train_step
