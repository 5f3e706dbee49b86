"""The train step: gradient accumulation over micro-batches + AdamW, the
reference's `repro.train.train_step`.

The reference jits the step and scans over micro-batches; the port runs
eagerly and loops.  Gradients come from `torch.autograd.grad` over the
weight tree's leaves (a leaf the loss does not reach gets zeros, as
`jax.value_and_grad` gives).  With `n_micro` > 1 the micro-batches' float32
gradients and losses are summed and divided by `n_micro`.  The
reference's `par` (sharding, its hierarchical all-reduce) and
`chunked_attn` arguments are dropped: the port trains on one card, and K4
serves every length.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["make_train_step", "value_and_grad"]


def value_and_grad(params, batch, cfg):
    """(loss, parts, grads): `transformer.loss_fn` of the weight tree (its
    leaves require grad) on the batch, and its gradient as a tree of the
    params' structure and types."""
    loss, parts = tf.loss_fn(params, batch, cfg)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), parts, tree_unflatten(params, grads)


def make_train_step(model_or_cfg, opt_cfg: AdamWConfig = AdamWConfig(),
                    n_micro: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): one AdamW step over a batch of `tokens` / `labels` (and
    `frames` / `vis`), B a multiple of `n_micro`.  The new params are leaf
    tensors in the config's type that require grad; metrics hold `loss`
    (a 0-d tensor), `grad_norm` (a 0-d tensor) and `lr`."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    dtype = getattr(torch, cfg.dtype)

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"train_step: batch {B} is not a multiple of "
                             f"n_micro {n_micro}")
        if n_micro == 1:
            loss, _, grads = value_and_grad(params, batch, cfg)
        else:
            acc = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            acc_leaves = tree_leaves(acc)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            mb = B // n_micro
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _, g = value_and_grad(params, micro, cfg)
                torch._foreach_add_(acc_leaves, tree_leaves(g))
                loss = loss + l
            torch._foreach_div_(acc_leaves, n_micro)
            grads, loss = acc, loss / n_micro
        new_params, new_opt, metrics = adamw_update(grads, opt_state, opt_cfg,
                                                    param_dtype=dtype)
        new_params = map_tree(lambda p: p.requires_grad_(), new_params)
        return new_params, new_opt, dict(metrics, loss=loss)

    return train_step
