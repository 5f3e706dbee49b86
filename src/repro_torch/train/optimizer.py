"""Hand-rolled AdamW with float32 master weights and global-norm clipping,
the reference's `repro.train.optimizer`.

Params live in the model's type (bfloat16) for the forward and backward;
the optimizer state keeps float32 master copies and first and second
moments, leaf for leaf the params' tree.  Every function works on whole
trees with `torch._foreach_*` (one launch per group of leaves, not per
leaf and operation); `torch.optim.AdamW` is not used, since it does not
take the schedule, the clipping and the master copy as the reference does.
The step count is a host integer (the host drives the loop), so the
schedule and the bias corrections are computed on the host in float64,
where the reference computes them in float32; the clip scale stays on the
device, so an update never waits for the gradient norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "global_norm",
           "lr_schedule", "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    master: Any      # float32 copies of params
    m: Any
    v: Any
    step: int


def init_opt_state(params) -> OptState:
    """Master copies (float32, detached) and zero moments of a tree."""
    master = map_tree(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return OptState(master, map_tree(zeros, params), map_tree(zeros, params),
                    0)


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in float32 (a 0-d tensor)."""
    leaves = [g.float() for g in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup to cfg.lr over `warmup` steps, then a cosine down to
    0.1 of it at `total_steps`."""
    warm = min(step / max(cfg.warmup, 1), 1.0)
    prog = min(max((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                   0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_update(grads, opt: OptState, cfg: AdamWConfig,
                 param_dtype=torch.bfloat16):
    """Returns (new_params, new_opt_state, metrics): the gradients clipped
    to a global norm of cfg.clip_norm, Adam moments with bias correction,
    decoupled weight decay (master - lr (update + wd master)), and the
    params cast from the new masters to `param_dtype` (new tensors, not
    requiring grad).  metrics: grad_norm (before clipping, a 0-d tensor)
    and lr.  The state's tensors are updated in place."""
    with torch.no_grad():
        g = [t.float() for t in tree_leaves(grads)]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = opt.step + 1
        lr = lr_schedule(cfg, step)
        bc1 = 1 - cfg.b1 ** step
        bc2 = 1 - cfg.b2 ** step
        master, m, v = (tree_leaves(t) for t in (opt.master, opt.m, opt.v))
        g = torch._foreach_mul(g, scale)
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, master, alpha=cfg.weight_decay)
        torch._foreach_add_(master, upd, alpha=-lr)
        params = tree_unflatten(opt.master, [
            t.to(param_dtype, copy=True) for t in master])
    return params, opt._replace(step=step), {"grad_norm": gnorm, "lr": lr}
