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
on an axis no entry names holds the same block as its peers there.  These
are the reference's full specs, for checkpoints and memory figures.

The models run on the port's own placement, `ModelBlocks`
(`models.tp.model_shardings`): the 'model' entries cut into one block a
model rank, padded to one width (an uneven dim rounds up, as XLA pads
it), a leaf no 'model' entry names held whole by every model rank; and,
FSDP, the 'data' entry of each leaf that has one cuts that block again
over the data axes ('data', or ('pod', 'data') with `fsdp_pod`): data
rank j holds the j-th 1/|data| of it on that dim, the last cuts padded
with zeros.  Blocks without a cut are stacked one per model rank this
process holds (every model rank of a stacked mesh, whose data ranks
share them; this process's one of a group mesh); cut blocks one per rank
this process holds (every rank of a stacked mesh; its own of a group
mesh), since no two data ranks hold the same cut.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ParamDef", "Sharding", "ModelBlocks", "stack_defs",
           "init_params",
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


@dataclass(frozen=True)
class ModelBlocks:
    """A leaf's blocks over a mesh's model axis and its cut over the data
    axes (module docstring).  `dim` is the dim the model ranks split (None:
    every model rank holds the whole leaf; `axis` None: one model rank);
    model rank m holds [starts[m], stops[m]) of it, zero-padded to
    `width`.  `reduce` says how a rank's gradient of its block becomes the
    leaf's: None (it is already), "model" (a psum over the model axis: a
    replicated leaf each rank reads only a part of, as q_norm / k_norm),
    "sharers" (a psum over the model ranks that hold the same range: a key
    or value head held by several ranks).  With `cut_axes` the block is
    cut again on `cut_dim` (of length `cut_len`) over those mesh axes:
    their group rank j holds [j c, (j + 1) c), c = ceil(cut_len / |cut|),
    zero-padded to c."""
    mesh: object
    axis: str | None
    dim: int | None = None
    starts: tuple = ()
    stops: tuple = ()
    width: int = 0
    reduce: str | None = None
    cut_dim: int | None = None
    cut_axes: tuple = ()
    cut_len: int = 0

    @property
    def n_model(self) -> int:
        return 1 if self.axis is None else self.mesh.shape[self.axis]

    @property
    def n_cut(self) -> int:
        return self.mesh.axis_size(self.cut_axes) if self.cut_axes else 1

    @property
    def cut_width(self) -> int:
        return -(-self.cut_len // self.n_cut)

    def model_of(self, rank: int) -> int:
        if self.axis is None:
            return 0
        return self.mesh.coords(rank)[self.mesh.axis_names.index(self.axis)]

    def model_rows(self) -> list:
        """The model ranks whose blocks this process holds, in order."""
        return list(dict.fromkeys(self.model_of(r)
                                  for r in self.mesh.local_ranks))

    def live(self, m: int) -> int:
        return 0 if self.dim is None else self.stops[m] - self.starts[m]

    def block_shape(self, shape) -> tuple:
        """One rank's block (its cut, with `cut_axes`) of a leaf."""
        out = [self.width if d == self.dim else n
               for d, n in enumerate(shape)]
        if self.cut_axes:
            out[self.cut_dim] = self.cut_width
        return tuple(out)

    def block(self, t, m: int):
        """Model rank m's block of the whole leaf t (a new tensor)."""
        if self.dim is None:
            return t.clone()
        shape = [self.width if d == self.dim else n
                 for d, n in enumerate(t.shape)]
        out = t.new_zeros(shape)
        n = self.live(m)
        if n:
            out.narrow(self.dim, 0, n).copy_(
                t.narrow(self.dim, self.starts[m], n))
        return out

    def cut(self, blk, j: int):
        """Data group rank j's cut of a model block (a new tensor)."""
        c = self.cut_width
        shape = list(blk.shape)
        shape[self.cut_dim] = c
        out = blk.new_zeros(shape)
        n = max(0, min(c, self.cut_len - j * c))
        if n:
            out.narrow(self.cut_dim, 0, n).copy_(
                blk.narrow(self.cut_dim, j * c, n))
        return out

    def shard(self, t) -> torch.Tensor:
        """(M, *block) without a cut: this process's model ranks' blocks;
        (L, *cut) with one: each local rank's cut."""
        if not self.cut_axes:
            return torch.stack([self.block(t, m) for m in self.model_rows()])
        cut = self.mesh.axis_index(self.cut_axes)
        return torch.stack([self.cut(self.block(t, self.model_of(r)), j)
                            for r, j in zip(self.mesh.local_ranks, cut)])

    def unshard(self, blocks) -> torch.Tensor:
        """The whole leaf from `shard`'s stack (gathered over the mesh on
        a group rank)."""
        if self.cut_axes:
            blocks = self._uncut(blocks)
        else:
            rows = self.model_rows()
            if len(rows) != blocks.shape[0]:
                raise ValueError(f"blocks {tuple(blocks.shape)} for model "
                                 f"ranks {rows}")
            if self.dim is None:
                return blocks[0].clone()
            if len(rows) < self.n_model:                # a group rank
                blocks = self.mesh.all_gather(blocks, self.axis, dim=0)[0]
        if self.dim is None:
            return blocks[0].clone()
        shape = list(blocks.shape[1:])
        shape[self.dim] = max(self.stops)
        out = blocks.new_zeros(shape)
        for m in range(self.n_model):
            n = self.live(m)
            if n:
                out.narrow(self.dim, self.starts[m], n).copy_(
                    blocks[m].narrow(self.dim, 0, n))
        return out

    def _uncut(self, cuts) -> torch.Tensor:
        """(M, *block) from every local rank's cut (L, *cut): each model
        rank's block put together from its cuts, the padding dropped."""
        mesh = self.mesh
        if cuts.shape[0] != len(mesh.local_ranks):
            raise ValueError(f"cuts {tuple(cuts.shape)} for "
                             f"{len(mesh.local_ranks)} local ranks")
        if len(mesh.local_ranks) < mesh.n_ranks:
            if len(mesh.local_ranks) != 1:
                raise ValueError("cuts of a partial stacked mesh cannot be "
                                 "put together")
            cuts = mesh.all_gather(cuts.contiguous())   # (D, *cut)
        ks = mesh._axes(self.cut_axes)
        at = {}
        for r in range(mesh.n_ranks):
            at.setdefault((self.model_of(r), mesh._group_index(r, ks)), r)
        return torch.stack([torch.cat(
            [cuts[at[(m, j)]] for j in range(self.n_cut)],
            self.cut_dim).narrow(self.cut_dim, 0, self.cut_len)
            for m in range(self.n_model)])


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
    on the mesh's device (`ModelBlocks`: on the leaf's, so a meta mesh
    can place weights on the card, as the dry run's check does); `t` as it
    is without a sharding."""
    if sh is None:
        return t
    dev = sh.mesh.device
    if isinstance(sh, ModelBlocks):
        return sh.shard(t)
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
    if isinstance(sh, ModelBlocks):
        return sh.unshard(t)
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
