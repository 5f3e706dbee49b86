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

Each data rank's forward runs the expert-parallel MoE over its own model
ranks (a mesh of the model axis alone): its capacity is that of its slice,
as in the reference's route, and neither the FSDP gather nor the aux
loss's mean over the data axes runs inside it, since the gradient
reduction already averages over the data ranks (a rank is not counted
twice).  On a stacked mesh the data ranks run one after another in this
process; on a group mesh each process is one rank and holds its slice of
the batch.  A group mesh with experts spread over a model axis of more
than one rank is not ported for training (its collectives are not
differentiable): it raises.  `train_step.comm` holds the last step's
reduction stages (`hierarchical_all_reduce`'s stats: the bytes a rank
puts into each stage, and over which axes).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.core.collectives import hierarchical_all_reduce
from repro_torch.core.dist.comm import StackedComm
from repro_torch.models import transformer as tf
from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten
from repro_torch.sharding.parallel import NONE, Parallelism
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["make_train_step", "value_and_grad"]


def value_and_grad(params, batch, cfg, par=NONE):
    """(loss, parts, grads): `transformer.loss_fn` of the weight tree (its
    leaves require grad) on the batch, and its gradient as a tree of the
    params' structure and types."""
    loss, parts = tf.loss_fn(params, batch, cfg, par)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), parts, tree_unflatten(params, grads)


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
    experts = bool(cfg.n_experts) and par.tp_size() > 1
    local = replace(par, mesh=None, data_axes=(), pod_axis=None)
    if not isinstance(mesh, StackedComm):
        if experts:
            raise NotImplementedError(
                "training with experts spread over the model axis of a "
                "torch.distributed mesh is not ported (ROADMAP.md): use "
                "a stacked mesh")
        return mesh, local, False
    if experts:
        local = replace(local, mesh=StackedComm(
            par.tp_size(), mesh.device, axis_names=(par.model_axis,)))
    red = StackedComm(par.dp_size(), mesh.device, axis_names=dp,
                      shape=[mesh.shape[a] for a in dp])
    return red, local, True


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
    if parallel:
        red, local, stacked = _data_ranks(par, cfg)
        dp = tuple(par.data_axes)
        pod = par.pod_axis if par.pod_axis in dp else None
        inner = tuple(a for a in dp if a != pod)
        hier = par.hierarchical and pod is not None and len(inner) > 0
        # hierarchical: inner data axes, then the pod axis; else flat
        inner, outer = ((inner[0] if len(inner) == 1 else inner, pod)
                        if hier else (dp, None))

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
        if parallel:
            loss, grads = reduced(params, batch)
        else:
            loss, grads = _accumulated(params, batch, cfg, n_micro, par)
        new_params, new_opt, metrics = adamw_update(grads, opt_state, opt_cfg,
                                                    param_dtype=dtype)
        new_params = map_tree(lambda p: p.requires_grad_(), new_params)
        return new_params, new_opt, dict(metrics, loss=loss)

    train_step.comm = []
    return train_step
