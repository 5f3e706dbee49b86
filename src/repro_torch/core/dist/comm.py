"""The collectives a rank program runs: stacked ranks or a process group.

The counterpart of `shard_map`'s collectives in `repro.core.dist`.  A
`shard_map` rank function calls its collectives from inside; one process
cannot loop over ranks that way, so the port's rank programs run in steps
(pack, exchange, compute) over the pools of every rank a process holds,
and a communicator moves the buffers of one exchange round between them.
Both implementations have one small interface:

  local_ranks : the ranks this process holds, in the order of the leading
                axis of every buffer it passes (L of them);
  n_ranks     : D, the ranks of the whole program;
  device      : where the buffers live;
  all_to_all(buf)        : (L, D, seg) -> (L, D, seg), rank s's received
                           block r is rank r's block s;
  ppermute(buf, perm)    : (L, cap) -> (L, cap) along ((src, dst), ...),
                           zeros at a rank that is nobody's destination;
  all_gather(t)          : (L, ...) -> (D, ...), every rank's row.

`StackedComm` holds all D ranks in this process on one device: an
all_to_all is a transpose of the stacked buffers and a ppermute an indexed
copy (on the card, copies within its memory).  `GroupComm` holds one rank
per process of a `torch.distributed` group: `all_to_all_single` on the
contiguous (D * seg) buffer, `batch_isend_irecv` over the pairs that involve
this rank, and `all_gather`.  A gloo group moves CPU tensors only: CUDA
tensors over it raise instead of being copied through the host.

A communicator is also a named mesh (`launch.mesh.make_mesh_compat`):
`axis_names`, `shape` (a dict, as `jax.sharding.Mesh.shape`) and ranks
numbered row-major over the axes, as `jax.make_mesh` numbers devices
(`stacked_mesh(n)` and `group_mesh()` have one axis, "ranks").  Along a
named axis, or a tuple of them, the ranks that share every other
coordinate form a group, numbered row-major over the given axes; the
collectives of `core.collectives`, the expert-parallel MoE and the
data-parallel train step use these, on the same (L, ...) buffers:

  axis_index(axes)               : the group index of each local rank
                                   (host ints, L of them);
  psum(buf, axes) / pmean        : every rank gets its group's sum (mean);
  psum_scatter(buf, axes, dim, tiled)
                                 : per rank, dim d of size G (or G * c,
                                   tiled) split into G blocks, and group
                                   rank i gets the sum of every member's
                                   block i;
  all_gather(buf, axes, dim, tiled)
                                 : every member's buffer, stacked on a new
                                   dim (or concatenated along dim, tiled),
                                   in group order;
  all_to_all(buf, axes, dim)     : dim split into G chunks, chunk j to
                                   group rank j, received chunks
                                   concatenated in source order (JAX's
                                   all_to_all with split = concat axis);
  ppermute(buf, perm, axes)      : along the group's indices.

Every sum adds the members' values one at a time in group order, so a
stacked and a group run give the same bits.

While a cost walker is active (`obs.cost.ACTIVE`: the dry run, and its
check on the card), every collective call records itself there: its
category (all-reduce, reduce-scatter, all-gather, all-to-all,
collective-permute), the bytes of one rank's result (the reference's
convention) and whether its group crosses the pod axis.  Without a walker
this costs one `None` check; counters and results are the same.

The collectives along named axes are differentiable on both communicators,
with the same backward: one `torch.autograd.Function` (`_Collective`)
runs the forward and, in backward, the adjoint collective on the
cotangents of the ranks this process holds: psum's is psum, all-gather's
reduce-scatter (`psum_scatter`, tiled alike), reduce-scatter's
all-gather, and all-to-all's the same all-to-all (it is its own inverse).
So a backward is the SPMD one, rank by rank, and a stacked and a group
run give the same bits backward too.  Two more Functions mark a tensor
parallel region (Megatron's f and g): `copy_into(buf, axes)`, forward the
identity and backward a psum of the cotangents, where each rank holds a
copy of one value and its consumers on each rank see only their part of
it; and `reduce_from(buf, axes)`, forward a psum and backward the
identity, where each rank's partial result is summed into one value every
rank holds.  `scale_grad(buf, s)` is the identity with its cotangent
scaled by s (an output each rank of a group computes alike, as
`shard_map` transposes an output its specs replicate).  The exchange
engine's `all_to_all` / `all_gather` without axes and `ppermute` stay
plain: on a stacked mesh autograd runs through their reshapes and copies,
and a group mesh's are not differentiable.

FSDP (`models.tp`): `gather_cuts(buf, axes)` is the all-gather of a flat
buffer of weight cuts, (L, N) -> (L, G, N), whose backward reduce-scatters
the cotangents in float32 (added in group order, rounded once to the
buffer's type); while `grad_log()` is open each such backward appends the
bytes one rank puts into it.  Where no gradient flows a stacked mesh
makes each group's gathered buffer once (`gather_groups`): its members
would hold equal copies.  `RowComm` is one row of a mesh on the meta
device, for the dry run: the ranks that differ only on the row's axes,
stacked; collectives within the row run as a `StackedComm`'s, the others
give meta results of their shape and record themselves against the whole
mesh.
"""
from __future__ import annotations

import math

import torch

from repro_torch.obs import cost as _cost

from contextlib import contextmanager

__all__ = ["StackedComm", "GroupComm", "RowComm", "scale_grad", "grad_log"]

# the collective whose backward a collective's is (module docstring)
_ADJOINT = {"psum": "psum", "all_gather": "psum_scatter",
            "psum_scatter": "all_gather", "all_to_all": "all_to_all"}


def _wants_grad(buf: torch.Tensor) -> bool:
    return buf.requires_grad and torch.is_grad_enabled()


class _Collective(torch.autograd.Function):
    """A collective along named axes; backward, its adjoint collective
    on the cotangents (module docstring)."""

    @staticmethod
    def forward(ctx, buf, mesh, kind, axes, dim, tiled):
        ctx.args = (mesh, kind, axes, dim, tiled)
        return mesh._collective(kind, buf, axes, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        mesh, kind, axes, dim, tiled = ctx.args
        with _cost.stacked(len(mesh.local_ranks)):
            out = mesh._collective(_ADJOINT[kind], g.contiguous(), axes,
                                   dim, tiled)
        return out, None, None, None, None, None


class _CopyInto(torch.autograd.Function):
    """Megatron's f: forward the identity, backward a psum."""

    @staticmethod
    def forward(ctx, buf, mesh, axes):
        ctx.args = (mesh, axes)
        return buf.view_as(buf)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        with _cost.stacked(len(mesh.local_ranks)):
            return (mesh._collective("psum", g.contiguous(), axes, 0,
                                     False), None, None)


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: forward a psum, backward the identity."""

    @staticmethod
    def forward(ctx, buf, mesh, axes):
        return mesh._collective("psum", buf, axes, 0, False)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, s):
        ctx.s = s
        return buf.view_as(buf)

    @staticmethod
    def backward(ctx, g):
        with _cost.stacked(g.shape[0] if g.dim() else 1):
            return g * ctx.s, None


_grad_bytes: list | None = None


@contextmanager
def grad_log():
    """Within the block, each `gather_cuts` backward appends one rank's
    bytes into its reduce-scatter (the float32 cotangent) to the yielded
    list."""
    global _grad_bytes
    prev, _grad_bytes = _grad_bytes, []
    try:
        yield _grad_bytes
    finally:
        _grad_bytes = prev


class _GatherCuts(torch.autograd.Function):
    """The FSDP all-gather (module docstring); backward, a float32
    reduce-scatter."""

    @staticmethod
    def forward(ctx, buf, mesh, axes):
        ctx.args = (mesh, axes, buf.dtype)
        return mesh._collective("all_gather", buf, axes, 0, False)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dtype = ctx.args
        g = g.float().contiguous()
        if _grad_bytes is not None:
            _grad_bytes.append(g[0].numel() * g.element_size())
        with _cost.stacked(len(mesh.local_ranks)):
            out = mesh._collective("psum_scatter", g, axes, 0, False)
        return out.to(dtype), None, None


def scale_grad(buf: torch.Tensor, s: float) -> torch.Tensor:
    """`buf` forward; its cotangent times `s` backward."""
    return _ScaleGrad.apply(buf, s) if _wants_grad(buf) else buf


class _NamedMesh:
    """Axis names, sizes and row-major rank coordinates, shared by both
    communicators."""

    def _name_axes(self, axis_names, dims) -> None:
        axis_names = tuple(axis_names)
        dims = tuple(int(d) for d in dims)
        if len(axis_names) != len(dims) or len(set(axis_names)) != len(dims):
            raise ValueError(f"mesh axes {axis_names} for shape {dims}: need "
                             f"one distinct name a dimension")
        if math.prod(dims) != self.n_ranks:
            raise ValueError(f"mesh shape {dims} holds {math.prod(dims)} "
                             f"ranks, the communicator {self.n_ranks}")
        self.axis_names, self.dims = axis_names, dims

    @property
    def shape(self) -> dict:
        """{axis name: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return self.n_ranks

    def _axes(self, axes) -> tuple:
        """Mesh dimensions of an axis name or a tuple of them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"no axis {a!r} in mesh {self.axis_names}")
        return tuple(self.axis_names.index(a) for a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.dims[k] for k in self._axes(axes))

    def coords(self, rank: int) -> tuple:
        """The row-major coordinates of a rank."""
        out = []
        for d in reversed(self.dims):
            rank, c = divmod(rank, d)
            out.append(c)
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        r = 0
        for c, d in zip(coords, self.dims):
            r = r * d + c
        return r

    def _group_index(self, rank: int, ks: tuple) -> int:
        c = self.coords(rank)
        i = 0
        for k in ks:
            i = i * self.dims[k] + c[k]
        return i

    def axis_index(self, axes) -> list:
        """Each local rank's index in its group along `axes` (host ints)."""
        ks = self._axes(axes)
        return [self._group_index(r, ks) for r in self.local_ranks]

    def group_ranks(self, rank: int, axes) -> list:
        """The ranks of `rank`'s group along `axes`, in group order."""
        ks = self._axes(axes)
        c = list(self.coords(rank))
        out = []
        for i in range(self.axis_size(axes)):
            for k in reversed(ks):
                i, c[k] = divmod(i, self.dims[k])
            out.append(self.rank_of(c))
        return out

    def pmean(self, buf: torch.Tensor, axes) -> torch.Tensor:
        return self.psum(buf, axes) / self.axis_size(axes)

    # ---- along named axes: differentiable (module docstring) -----------
    def _run(self, kind, buf, axes, dim=0, tiled=False):
        if _wants_grad(buf):
            return _Collective.apply(buf, self, kind, axes, dim, tiled)
        return self._collective(kind, buf, axes, dim, tiled)

    def _collective(self, kind, buf, axes, dim, tiled):
        if kind == "psum":
            out = self._psum(buf, axes)
        elif kind == "psum_scatter":
            out = self._psum_scatter(buf, axes, dim, tiled)
        elif kind == "all_gather":
            out = self._all_gather_axes(buf, axes, dim, tiled)
        else:
            out = self._all_to_all_axes(buf, axes, dim)
        if _cost.ACTIVE is not None:
            _note(self, kind, axes, out)
        return out

    def psum(self, buf: torch.Tensor, axes) -> torch.Tensor:
        return self._run("psum", buf, axes)

    def psum_scatter(self, buf: torch.Tensor, axes, dim: int = 0,
                     tiled: bool = False) -> torch.Tensor:
        return self._run("psum_scatter", buf, axes, dim, tiled)

    def copy_into(self, buf: torch.Tensor, axes) -> torch.Tensor:
        """Megatron's f along `axes`: `buf` forward, a psum of the
        cotangents backward."""
        return _CopyInto.apply(buf, self, axes) if _wants_grad(buf) \
            else buf

    def reduce_from(self, buf: torch.Tensor, axes) -> torch.Tensor:
        """Megatron's g along `axes`: a psum forward, the cotangent as
        it is backward."""
        if _wants_grad(buf):
            return _ReduceFrom.apply(buf, self, axes)
        return self._collective("psum", buf, axes, 0, False)

    def gather_cuts(self, buf: torch.Tensor, axes) -> torch.Tensor:
        """(L, N) -> (L, G, N): every member's buffer along `axes`; its
        backward a float32 reduce-scatter (module docstring)."""
        if _wants_grad(buf):
            return _GatherCuts.apply(buf, self, axes)
        return self._collective("all_gather", buf, axes, 0, False)


def _note(comm, method: str, axes, out: torch.Tensor, whole: bool = False):
    """Record one collective in the active walker: one rank's result bytes
    (`whole`: every rank gets all of `out`)."""
    n = out.numel() * out.element_size()
    _cost.record_collective(comm, method, axes,
                            n if whole else n // len(comm.local_ranks))


def _ordered_sum(parts):
    """parts[0] + parts[1] + ... in that order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class StackedComm(_NamedMesh):
    """All `n_ranks` ranks in this process, their buffers stacked (D, ...)
    on one device; a mesh of `shape` over `axis_names` (default: one axis
    "ranks")."""

    def __init__(self, n_ranks: int, device, *, axis_names=("ranks",),
                 shape=None):
        if int(n_ranks) < 1:
            raise ValueError(f"n_ranks: need at least one rank, got "
                             f"{n_ranks}")
        self.n_ranks = int(n_ranks)
        self.local_ranks = tuple(range(self.n_ranks))
        self.device = torch.device(device)
        self._perms: dict = {}
        self._name_axes(axis_names, (self.n_ranks,) if shape is None
                        else shape)

    # ---- along named axes: (D, *X) <-> (O, G, *X), O the other coords --
    def _along(self, buf: torch.Tensor, ks: tuple) -> torch.Tensor:
        self._check(buf)
        nd, rest = len(self.dims), buf.shape[1:]
        others = [k for k in range(nd) if k not in ks]
        v = buf.reshape(*self.dims, *rest).permute(
            *others, *ks, *range(nd, nd + len(rest)))
        return v.reshape(-1, math.prod(self.dims[k] for k in ks), *rest)

    def _back(self, w: torch.Tensor, ks: tuple) -> torch.Tensor:
        nd, rest = len(self.dims), w.shape[2:]
        others = [k for k in range(nd) if k not in ks]
        order = others + list(ks)
        v = w.reshape(*(self.dims[k] for k in order), *rest)
        inv = [order.index(k) for k in range(nd)]
        v = v.permute(*inv, *range(nd, nd + len(rest)))
        return v.reshape(self.n_ranks, *rest)

    def _psum(self, buf: torch.Tensor, axes) -> torch.Tensor:
        ks = self._axes(axes)
        w = self._along(buf, ks)
        s = _ordered_sum(w.unbind(1))
        return self._back(s.unsqueeze(1).expand_as(w), ks)

    def _psum_scatter(self, buf: torch.Tensor, axes, dim: int = 0,
                      tiled: bool = False) -> torch.Tensor:
        ks = self._axes(axes)
        w = self._along(buf, ks).movedim(2 + dim, 2)   # (O, G, n, ...)
        G = w.shape[1]
        w = w.reshape(w.shape[0], G, G, -1, *w.shape[3:])
        s = _ordered_sum(w.unbind(1))                  # (O, G, c, ...)
        return (self._back(s, ks).movedim(1, 1 + dim) if tiled
                else self._back(s.squeeze(2), ks))

    def all_gather(self, t: torch.Tensor, axes=None, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Without `axes`: (D, ...) -> (D, ...), every rank's row (the
        exchange engine's form).  Along `axes`: every member's buffer, on a
        new per-rank dim `dim` (or concatenated along it, `tiled`)."""
        self._check(t)
        if axes is None:
            if _cost.ACTIVE is not None:
                _note(self, "all_gather", None, t, whole=True)
            return t
        return self._run("all_gather", t, axes, dim, tiled)

    def _all_gather_axes(self, t: torch.Tensor, axes, dim: int,
                         tiled: bool) -> torch.Tensor:
        ks = self._axes(axes)
        w = self._along(t, ks)                          # (O, G, *X)
        per = w.movedim(1, 1 + dim)                     # a member's result
        if tiled:
            per = per.flatten(1 + dim, 2 + dim)
        return self._back(per.unsqueeze(1).expand(-1, w.shape[1],
                                                  *per.shape[1:]), ks)

    def _all_to_all_axes(self, buf: torch.Tensor, axes,
                         dim: int) -> torch.Tensor:
        ks = self._axes(axes)
        w = self._along(buf, ks).movedim(2 + dim, 2)   # (O, Gsrc, n, ...)
        G = w.shape[1]
        w = w.reshape(w.shape[0], G, G, -1, *w.shape[3:]).transpose(1, 2)
        w = w.flatten(2, 3)
        return self._back(w, ks).movedim(1, 1 + dim)

    def _check(self, buf: torch.Tensor) -> None:
        if buf.shape[0] != self.n_ranks:
            raise ValueError(f"stacked buffers need a leading axis of "
                             f"{self.n_ranks} ranks, got {tuple(buf.shape)}")

    def gather_groups(self, buf: torch.Tensor, axes) -> tuple:
        """`gather_cuts` without its copies, where no gradient flows: the
        members of a group along `axes` would all receive the same
        buffer, so each group's is made once.  Returns ((O, G, N): every
        group's members' buffers, each local rank's group), the
        all-gather recorded as each rank would run it."""
        ks = self._axes(axes)
        w = self._along(buf, ks)
        others = [k for k in range(len(self.dims)) if k not in ks]
        group = []
        for r in self.local_ranks:
            c, o = self.coords(r), 0
            for k in others:
                o = o * self.dims[k] + c[k]
            group.append(o)
        if _cost.ACTIVE is not None:
            _cost.record_collective(self, "all_gather", axes,
                                    w[0].numel() * w.element_size())
        return w, group

    def all_to_all(self, buf: torch.Tensor, axes=None,
                   dim: int = 0) -> torch.Tensor:
        self._check(buf)
        if axes is not None:
            return self._run("all_to_all", buf, axes, dim)
        out = buf.transpose(0, 1).contiguous()
        if _cost.ACTIVE is not None:
            _note(self, "all_to_all", axes, out)
        return out

    def ppermute(self, buf: torch.Tensor, perm, axes=None) -> torch.Tensor:
        self._check(buf)
        if axes is not None:
            ks = self._axes(axes)
            w = self._along(buf, ks)
            key = (tuple(perm), ks, buf.device)
            if key not in self._perms:
                G = w.shape[1]
                src = torch.zeros(G, dtype=torch.int64)
                hit = torch.zeros(G, dtype=torch.bool)
                for s_, d_ in perm:
                    src[d_], hit[d_] = s_, True
                self._perms[key] = (src.to(buf.device), hit.to(buf.device))
            src, hit = self._perms[key]
            got = w.index_select(1, src)
            hit = hit.reshape(1, -1, *([1] * (w.dim() - 2)))
            out = self._back(torch.where(hit, got, torch.zeros_like(got)),
                             ks)
        else:
            out = torch.zeros_like(buf)
            if perm:
                key = (tuple(perm), buf.device)
                idx = self._perms.get(key)
                if idx is None:
                    idx = torch.tensor(perm, dtype=torch.int64,
                                       device=buf.device).T
                    self._perms[key] = idx
                out[idx[1]] = buf[idx[0]]
        if _cost.ACTIVE is not None:
            _note(self, "ppermute", axes, out)
        return out


class GroupComm(_NamedMesh):
    """One rank per process of an initialised `torch.distributed` group
    (`group=None`: the default group); a mesh of `shape` over
    `axis_names` (default: one axis "ranks")."""

    def __init__(self, group=None, device=None, *, axis_names=("ranks",),
                 shape=None):
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("GroupComm needs an initialised "
                               "torch.distributed process group")
        self._dist = dist
        self.group = group
        self.n_ranks = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local_ranks = (self.rank,)
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        if self.backend == "gloo" and self.device.type != "cpu":
            raise ValueError(f"a gloo group moves CPU tensors only; got "
                             f"device {self.device} (use an nccl group for "
                             f"CUDA tensors)")
        self._name_axes(axis_names, (self.n_ranks,) if shape is None
                        else shape)
        self._groups: dict = {}

    def _peer(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def _check(self, buf: torch.Tensor) -> None:
        if buf.device != self.device:
            raise ValueError(f"buffer on {buf.device}, communicator on "
                             f"{self.device}")
        if buf.shape[0] != 1:
            raise ValueError(f"a group rank passes its own buffer only: "
                             f"leading axis 1, got {tuple(buf.shape)}")

    def all_to_all(self, buf: torch.Tensor, axes=None,
                   dim: int = 0) -> torch.Tensor:
        if axes is not None:
            return self._run("all_to_all", buf, axes, dim)
        self._check(buf)
        send = buf.contiguous()
        out = torch.empty_like(send)
        self._dist.all_to_all_single(out.view(-1), send.view(-1),
                                     group=self.group)
        if _cost.ACTIVE is not None:
            _note(self, "all_to_all", axes, out)
        return out

    def ppermute(self, buf: torch.Tensor, perm, axes=None) -> torch.Tensor:
        if axes is not None:
            out = self._ppermute_axes(buf, perm, axes)
        else:
            out = self._ppermute_rows(buf, perm)
        if _cost.ACTIVE is not None:
            _note(self, "ppermute", axes, out)
        return out

    def _ppermute_rows(self, buf: torch.Tensor, perm) -> torch.Tensor:
        self._check(buf)
        send = buf.contiguous()
        out = torch.zeros_like(send)
        ops = []
        for s, d in perm:
            if s == self.rank:
                ops.append(self._dist.P2POp(self._dist.isend, send[0],
                                            self._peer(d), self.group))
            if d == self.rank:
                ops.append(self._dist.P2POp(self._dist.irecv, out[0],
                                            self._peer(s), self.group))
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def _all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        self._check(t)
        row = t[0].contiguous()
        parts = [torch.empty_like(row) for _ in range(self.n_ranks)]
        self._dist.all_gather(parts, row, group=self.group)
        return torch.stack(parts)

    # ---- along named axes: one process group per slice, made once -----
    def _sub(self, axes, buf: torch.Tensor):
        """(my group's process group, its members in group order, the
        position of each member in the process group's rank order)."""
        self._check(buf)
        ks = self._axes(axes)
        if ks not in self._groups:
            # every process makes every slice's group, in the same order
            mine = None
            for r in range(self.n_ranks):
                members = self.group_ranks(r, axes)
                if members[0] != r:
                    continue
                glob = [self._peer(m) for m in members]
                pg = self._dist.new_group(glob)
                if self.rank in members:
                    order = sorted(range(len(glob)), key=glob.__getitem__)
                    mine = (pg, members, order)
            self._groups[ks] = mine
        return self._groups[ks]

    def _gather(self, buf: torch.Tensor, axes) -> list:
        """Every member's buffer (leading axis dropped), in group order."""
        pg, members, order = self._sub(axes, buf)
        row = buf[0].contiguous()
        parts = [torch.empty_like(row) for _ in members]
        self._dist.all_gather(parts, row, group=pg)
        out = [None] * len(members)
        for pos, i in enumerate(order):     # process-group rank pos
            out[i] = parts[pos]
        return out

    def _psum(self, buf: torch.Tensor, axes) -> torch.Tensor:
        return _ordered_sum(self._gather(buf, axes))[None]

    def _psum_scatter(self, buf: torch.Tensor, axes, dim: int = 0,
                      tiled: bool = False) -> torch.Tensor:
        recv = self._a2a_parts(buf, axes, dim)
        s = _ordered_sum(recv)
        return (s if tiled else s.squeeze(dim))[None]

    def all_gather(self, t: torch.Tensor, axes=None, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Without `axes`: (1, ...) -> (D, ...), every rank's row.  Along
        `axes`: every member's buffer on a new per-rank dim `dim` (or
        concatenated along it, `tiled`)."""
        if axes is not None:
            return self._run("all_gather", t, axes, dim, tiled)
        out = self._all_gather_rows(t)
        if _cost.ACTIVE is not None:
            _note(self, "all_gather", axes, out, whole=True)
        return out

    def _all_gather_axes(self, t, axes, dim, tiled):
        parts = self._gather(t, axes)
        return (torch.cat(parts, dim) if tiled
                else torch.stack(parts, dim))[None]

    def _a2a_parts(self, buf: torch.Tensor, axes, dim: int) -> list:
        """Chunk j of `dim` to member j; the chunks received, in group
        order."""
        pg, members, order = self._sub(axes, buf)
        G = len(members)
        chunks = buf[0].movedim(dim, 0)
        chunks = chunks.reshape(G, -1, *chunks.shape[1:])
        send = torch.stack([chunks[i] for i in order]).contiguous()
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=pg)
        out = [None] * G
        for pos, i in enumerate(order):
            out[i] = recv[pos].movedim(0, dim)
        return out

    def _all_to_all_axes(self, buf, axes, dim):
        return torch.cat(self._a2a_parts(buf, axes, dim), dim)[None]

    def _ppermute_axes(self, buf, perm, axes):
        pg, members, _ = self._sub(axes, buf)
        me = members.index(self.rank)
        send = buf.contiguous()
        out = torch.zeros_like(send)
        ops = []
        for s_, d_ in perm:
            if s_ == d_ == me:            # a fixed point: no wire
                out[0].copy_(send[0])
                continue
            if s_ == me:
                ops.append(self._dist.P2POp(self._dist.isend, send[0],
                                            self._peer(members[d_])))
            if d_ == me:
                ops.append(self._dist.P2POp(self._dist.irecv, out[0],
                                            self._peer(members[s_])))
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return out


class RowComm(StackedComm):
    """One row of a mesh of `shape` over `axis_names` on the meta device:
    the ranks whose coordinates are 0 on every axis but `row_axes`,
    stacked.  Collectives along axes of the row run over it as a
    `StackedComm`'s; along any other axis their result is a meta tensor
    of its shape (on meta nothing is computed, so no peer outside the row
    is needed), recorded against the whole mesh (module docstring)."""

    def __init__(self, shape, axis_names, row_axes, device="meta"):
        self.device = torch.device(device)
        if self.device.type != "meta":
            raise ValueError("RowComm: meta tensors only (a peer outside "
                             "the row sends nothing)")
        self.n_ranks = math.prod(int(d) for d in shape)
        self._name_axes(axis_names, shape)
        row_axes = (row_axes,) if isinstance(row_axes, str) else \
            tuple(row_axes)
        ks = self._axes(row_axes)
        self.local_ranks = tuple(
            r for r in range(self.n_ranks)
            if all(c == 0 for k, c in enumerate(self.coords(r))
                   if k not in ks))
        self._row = StackedComm(len(self.local_ranks), self.device,
                                axis_names=row_axes,
                                shape=[self.dims[k] for k in ks])
        self._perms = {}

    def _check(self, buf: torch.Tensor) -> None:
        if buf.shape[0] != len(self.local_ranks):
            raise ValueError(f"row buffers need a leading axis of "
                             f"{len(self.local_ranks)} ranks, got "
                             f"{tuple(buf.shape)}")

    def _inside(self, axes) -> bool:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return set(names) <= set(self._row.axis_names)

    def _psum(self, buf, axes):
        if self._inside(axes):
            return self._row._psum(buf, axes)
        self._check(buf)
        return torch.zeros_like(buf)

    def _psum_scatter(self, buf, axes, dim=0, tiled=False):
        if self._inside(axes):
            return self._row._psum_scatter(buf, axes, dim, tiled)
        self._check(buf)
        shape = list(buf.shape)
        if tiled:
            shape[1 + dim] //= self.axis_size(axes)
        else:
            del shape[1 + dim]
        return buf.new_zeros(shape)

    def _all_gather_axes(self, t, axes, dim, tiled):
        if self._inside(axes):
            return self._row._all_gather_axes(t, axes, dim, tiled)
        self._check(t)
        shape, G = list(t.shape), self.axis_size(axes)
        if tiled:
            shape[1 + dim] *= G
        else:
            shape.insert(1 + dim, G)
        return t.new_zeros(shape)

    def _all_to_all_axes(self, buf, axes, dim):
        if self._inside(axes):
            return self._row._all_to_all_axes(buf, axes, dim)
        self._check(buf)
        return torch.zeros_like(buf)

    def all_gather(self, t, axes=None, dim=0, tiled=False):
        if axes is None:
            raise NotImplementedError("RowComm: no all-gather of whole rows")
        return self._run("all_gather", t, axes, dim, tiled)
