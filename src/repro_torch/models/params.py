"""Parameter definitions and their random init.

`ParamDef` describes one weight (shape, sharding spec, init, scale, type),
as in the reference's `repro.models.params`.  The reference stacks the
defs of every superblock on a leading axis for its scan over layers (its
spec gains a leading None); the port runs the layers as a Python loop and
keeps one tree per superblock, so `stack_defs` returns a list of n trees,
each with its own spec.  `init_params` draws every normal weight from one seeded
`torch.Generator` on its device, in the order the tree lists them; the
numbers differ from the reference's `jax.random` draws.  `param_structs`
gives the same tree as tensors on the meta device (shapes and types, no
storage), the reference's `param_structs`.

`param_shardings(defs, mesh)` gives, per leaf, the mesh and its spec
entries (the reference's `NamedSharding`); `shard_params` cuts each leaf
into the blocks the ranks of this process hold on that mesh, stacked on a
leading axis (all D ranks of a stacked mesh: one copy; this process's rank
of a group mesh), and `unshard_params` reassembles the whole leaves.  A
spec entry names a mesh axis, a tuple of them (the leaf's dim split over
their product, row-major), or None (not split); a rank whose coordinate
on an axis no entry names holds the same block as its peers there.  The
models read whole leaves (the port has no GSPMD to keep them sharded
between layers): the expert-parallel MoE cuts its blocks itself
(`models.moe`), and sharded leaves are for checkpoints and memory.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ParamDef", "Sharding", "stack_defs", "init_params",
           "param_structs", "param_shardings", "shard_params",
           "unshard_params", "map_tree", "tree_leaves", "tree_unflatten"]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    spec: tuple = ()            # sharding spec entries (axis names / None)
    init: str = "normal"        # normal | zeros | ones
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class Sharding:
    """A leaf's layout on a mesh: the reference's `NamedSharding(mesh,
    PartitionSpec(*spec))`."""
    mesh: object
    spec: tuple

    def _split(self, shape) -> list:
        """Per dim: (mesh axes splitting it, their total size)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} for a leaf of shape "
                             f"{tuple(shape)}")
        out = []
        for n, e in zip(shape, tuple(self.spec) + (None,) * (
                len(shape) - len(self.spec))):
            axes = () if e is None else (e,) if isinstance(e, str) \
                else tuple(e)
            k = self.mesh.axis_size(axes) if axes else 1
            if n % k:
                raise ValueError(f"a dim of {n} does not split over "
                                 f"{axes} ({k} ranks); spec {self.spec}")
            out.append((axes, k))
        return out

    def block_shape(self, shape) -> tuple:
        """The shape of one rank's block of a leaf of `shape`."""
        return tuple(n // k for n, (_, k) in zip(shape, self._split(shape)))

    def block(self, t, rank: int):
        """Rank `rank`'s block of the whole leaf t (a view)."""
        c = dict(zip(self.mesh.axis_names, self.mesh.coords(rank)))
        for dim, (axes, k) in enumerate(self._split(t.shape)):
            if axes:
                i = 0
                for a in axes:
                    i = i * self.mesh.shape[a] + c[a]
                b = t.shape[dim] // k
                t = t.narrow(dim, i * b, b)
        return t

    def offsets(self, shape, rank: int) -> tuple:
        """Where rank `rank`'s block starts in the whole leaf."""
        c = dict(zip(self.mesh.axis_names, self.mesh.coords(rank)))
        out = []
        for n, (axes, k) in zip(shape, self._split(shape)):
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + c[a]
            out.append(i * (n // k))
        return tuple(out)


def stack_defs(defs, n: int) -> list:
    """One def tree per superblock (its spec kept): a list of n copies of
    `defs`."""
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


def param_shardings(defs, mesh, fsdp_pod: bool = False):
    """Per leaf, its `Sharding` on `mesh` (None without a mesh).
    `fsdp_pod=True` widens every 'data' entry to ('pod', 'data') on a mesh
    with a pod axis: flat ZeRO-3 across pods, the baseline the
    hierarchical layout beats on the pod axis."""
    def one(d: ParamDef):
        if mesh is None:
            return None
        spec = tuple(("pod", "data") if (fsdp_pod and e == "data"
                                         and "pod" in mesh.axis_names) else e
                     for e in d.spec)
        return Sharding(mesh, spec)
    return map_tree(one, defs)


def _zip_tree(fn, tree, other):
    """fn(leaf, other's leaf) over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_tree(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def shard_leaf(t: torch.Tensor, sh: Sharding | None) -> torch.Tensor:
    """The blocks of `t` that this process's ranks hold, stacked (L, ...),
    on the mesh's device; `t` as it is without a sharding."""
    if sh is None:
        return t
    dev = sh.mesh.device
    return torch.stack([sh.block(t, r) for r in sh.mesh.local_ranks]).to(dev)


def shard_params(params, shardings):
    """Each leaf cut into the blocks this process's ranks hold (see the
    module docstring): (L, *block) tensors on the mesh's device."""
    return _zip_tree(shard_leaf, params, shardings)


def unshard_leaf(t: torch.Tensor, sh: Sharding | None) -> torch.Tensor:
    """The whole leaf from its stacked blocks (L, *block): every rank's
    block (gathered over a group mesh) written where it starts."""
    if sh is None:
        return t
    mesh = sh.mesh
    if t.shape[0] != len(mesh.local_ranks):
        raise ValueError(f"blocks {tuple(t.shape)} for "
                         f"{len(mesh.local_ranks)} local ranks")
    blocks = mesh.all_gather(t.contiguous())           # (D, *block)
    spec = tuple(sh.spec) + (None,) * (t.dim() - 1 - len(sh.spec))
    shape = tuple(b * mesh.axis_size(() if e is None else e)
                  for b, e in zip(t.shape[1:], spec))
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    for r in range(mesh.n_ranks):
        view = out
        for dim, (o, b) in enumerate(zip(sh.offsets(shape, r),
                                         t.shape[1:])):
            view = view.narrow(dim, o, b)
        view.copy_(blocks[r])
    return out


def unshard_params(sharded, shardings):
    """The whole leaves from `shard_params`'s blocks."""
    return _zip_tree(unshard_leaf, sharded, shardings)
