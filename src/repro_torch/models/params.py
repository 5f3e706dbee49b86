"""Parameter definitions and their random init.

`ParamDef` describes one weight (shape, init, scale, type), as in the
reference's `repro.models.params`; its sharding spec is dropped, since the
port runs on one card.  The reference stacks the defs of every superblock
on a leading axis for its scan over layers; the port runs the layers as a
Python loop and keeps one tree per superblock, so `stack_defs` returns a
list of n trees.  `init_params` draws every normal weight from one seeded
`torch.Generator` on its device, in the order the tree lists them; the
numbers differ from the reference's `jax.random` draws.  `param_structs`
gives the same tree as tensors on the meta device (shapes and types, no
storage), the reference's `param_structs`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ParamDef", "stack_defs", "init_params", "param_structs",
           "map_tree", "tree_leaves", "tree_unflatten"]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"        # normal | zeros | ones
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    dtype: str = "bfloat16"


def stack_defs(defs, n: int) -> list:
    """One def tree per superblock: a list of n copies of `defs`."""
    return [defs] * n


def map_tree(fn, tree):
    """Apply fn to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in `map_tree`'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` in `tree_leaves`'s
    order."""
    it = iter(leaves)
    return map_tree(lambda _: next(it), like)


def init_params(defs, generator: torch.Generator):
    """Materialise a def tree on the generator's device: zeros, ones, or
    normal(0, 1) * scale drawn in float32 and rounded to the def's type."""
    dev = generator.device

    def one(d: ParamDef):
        dt = getattr(torch, d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / np.sqrt(fan_in)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * scale).to(dt)

    return map_tree(one, defs)


def param_structs(defs):
    """A def tree as empty tensors on the meta device."""
    return map_tree(lambda d: torch.empty(
        d.shape, dtype=getattr(torch, d.dtype), device="meta"), defs)
