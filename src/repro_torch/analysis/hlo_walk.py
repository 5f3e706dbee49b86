"""Per-rank cost walker, the port's counterpart of `repro.analysis.hlo_walk`.

The reference parses XLA's post-partitioning HLO text: it recovers while-loop
trip counts, weights every computation by them, and sums dot FLOPs,
collective result bytes and the result bytes of the instructions that write
HBM, per device.  The port has no HLO.  It runs one rank's program eagerly
(on the `meta` device for the dry run, `launch.dryrun`, and on the card to
check the dry run), and `Walker`, a `TorchDispatchMode` used as a context
manager, counts what that program dispatches:

  dot_flops      2 * prod(result) * contracted over every product that
                 reaches the dispatcher (`mm`, `bmm`, `addmm`, `baddbmm`,
                 `addbmm`, `mv`, `addmv`, `dot`; `einsum` and `matmul`
                 arrive as these), plus the reference's dot FLOPs for
                 what the hand-written kernels compute (K4: every
                 (query, key) pair; K5: the chunkwise products), so that
                 the figure keeps the reference's convention;
  result_bytes   the bytes each op writes: a new output's bytes, the
                 written part of an in-place or out= op (the source of an
                 indexed write), the kernels' outputs; views, reshapes that
                 keep the storage and bare allocations (`empty*`) write
                 nothing;
  collectives    each call of a `core.dist.comm` communicator's collective
                 (`psum` all-reduce, `psum_scatter` reduce-scatter,
                 `all_gather` all-gather, `all_to_all` all-to-all,
                 `ppermute` collective-permute), with its per-rank result
                 bytes (the reference's convention) and whether its group
                 crosses the pod axis (`crosses_pod`).

Eager execution runs every loop trip, so no trip counts are needed: the
reference's `compute_multipliers` and `_trip_count` have no counterpart.
`count_entry_launches` has none either: the port counts CUDA-graph replays
instead (`analysis/check_counters.py`).

The port's own figures go under `port` in `result()`: per kernel its
launches, the operations its mask admits and its bytes (inputs read once,
outputs written once, the formulas of `PERF.md` §6's bounds);
`dot_flops_card`, the products as the card runs them (`dot_flops` with
each kernel's operations in place of the reference's dots, so K4 counts
only the pairs its mask admits), which the roofline's H100 compute term
reads; `read_bytes`
(the tensors each counted op reads); and `peak_bytes`, the most bytes live
at once on the walked device.  Peak bytes follow storage lifetimes: an op's
output on a storage none of its inputs holds adds that storage's bytes
(rounded up to the card allocator's 512-byte blocks), and a
`weakref.finalize` on the storage takes them off when it is freed, so views
share their base's bytes and autograd's saved tensors count as long as they
live.  Tensors that exist before the walk count only if `track` is given
them (the step's arguments).  Ops whose tensors all lie on the CPU (host
index tables, scalars) are not counted.

On meta the walker also takes `F.rms_norm` the card's way.  CUDA's
composite `rms_norm` calls the fused `_fused_rms_norm` (and autograd its
fused backward), where the CPU's and meta's decompose it into pow, mean,
rsqrt and products (and meta's `_fused_rms_norm` decomposes alike).  The
walker stands an autograd Function in for meta inputs, which allocates
the fused op's outputs (the output and the float32 rstd, one per row),
saves what its backward saves, and counts what the fused forward and
backward read and write, so that meta counts what the card dispatches (a
run of both on the card found it the one op of the models' steps that
differs).

Stacked ranks.  Where one process runs several ranks' work on stacked
(L, ...) buffers (the expert-parallel MoE over a model axis,
`models/moe.py`; a gradient reduction over stacked data ranks), the code
opens `obs.cost.stacked(L)` around it.  `result()` gives per-rank figures:
what runs outside such a scope counts as it is, what runs inside counts
1/L of it, and so do the backwards of the autograd nodes made inside
(the scope marks them, and the walker reads the node the engine is
running); a storage allocated there adds 1/L of its bytes to the per-rank
live bytes.
Collective records are per rank already and are never divided.  The
totals as run are `result()["port"]["stacked"]`.  `track(tree, L)` counts
arguments that L stacked ranks hold alike (their weight blocks, optimizer
state and caches): 1/L of their bytes a rank.

While it runs the walker is `obs.cost.ACTIVE`, the hook that the
communicators, the kernels' wrappers and the stacked scopes report
through; without a walker they cost one `None` check.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.hlo import collective_bytes
from repro_torch.obs import cost

__all__ = ["Walker", "crosses_pod", "CATEGORY", "BLOCK"]

# the reference's five categories, by the communicators' method names
CATEGORY = {"psum": "all-reduce", "psum_scatter": "reduce-scatter",
            "all_gather": "all-gather", "all_to_all": "all-to-all",
            "ppermute": "collective-permute"}
BLOCK = 512     # the card allocator's block: every allocation rounds up to it

_aten = torch.ops.aten
_ALLOC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
          _aten.new_empty, _aten.new_empty_strided}
# indexed writes: what they write is their source's bytes, not self's
_INDEXED = {_aten.index_copy_, _aten.index_copy, _aten.index_put_,
            _aten.index_put, _aten._index_put_impl_, _aten.index_add_,
            _aten.index_add, _aten.scatter_, _aten.scatter_add_,
            _aten.scatter_reduce_, _aten.masked_scatter_,
            _aten.index_fill_}


def _dot_flops(packet, args, out) -> float:
    """2 * prod(result) * contracted of one product op (0 for others)."""
    if packet in (_aten.mm, _aten.bmm):
        return 2.0 * out.numel() * args[0].shape[-1]
    if packet in (_aten.addmm, _aten.baddbmm):
        return 2.0 * out.numel() * args[1].shape[-1]
    if packet is _aten.addbmm:
        return 2.0 * out.numel() * args[1].shape[0] * args[1].shape[-1]
    if packet is _aten.mv:
        return 2.0 * out.numel() * args[0].shape[-1]
    if packet is _aten.addmv:
        return 2.0 * out.numel() * args[1].shape[-1]
    if packet in (_aten.dot, _aten.vdot):
        return 2.0 * args[0].numel()
    return 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors in an argument (a tensor, or a list / tuple of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st


def _schema(func):
    """(arg names, indices of the args it writes, indices of the returns
    that alias an argument) of an op, from its schema."""
    sc = func._schema
    names = [a.name for a in sc.arguments]
    writes = [i for i, a in enumerate(sc.arguments)
              if a.alias_info is not None and a.alias_info.is_write]
    aliased = [i for i, r in enumerate(sc.returns)
               if r.alias_info is not None]
    return names, writes, aliased


class _Counts:
    __slots__ = ("dot_flops", "card_flops", "result_bytes", "read_bytes",
                 "kernels")

    def __init__(self):
        self.dot_flops = 0.0
        self.card_flops = 0.0
        self.result_bytes = 0.0
        self.read_bytes = 0.0
        self.kernels = defaultdict(lambda: {"launches": 0.0,
                                            "operations": 0.0, "bytes": 0.0})

    def as_dict(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "dot_flops_card": self.card_flops,
                "result_bytes": self.result_bytes,
                "read_bytes": self.read_bytes,
                "kernels": {k: dict(v) for k, v in sorted(
                    self.kernels.items())}}


_TAG = "repro_stacked_ranks"


class _TagNodes(TorchFunctionMode):
    """Inside a stacked scope: marks the autograd node of every output
    with the scope's rank count, so that its backward counts per rank
    too."""

    def __init__(self, L: int):
        super().__init__()
        self.L = L

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor) and t.grad_fn is not None:
                t.grad_fn.metadata[_TAG] = self.L
        return out


class _FusedRmsNorm(torch.autograd.Function):
    """CUDA's `_fused_rms_norm` and its backward, on meta: outputs
    allocated, reads and writes counted (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, n_dims):
        out = torch.empty_like(x)
        rstd = x.new_empty(tuple(x.shape[:x.dim() - n_dims]) + (1,) * n_dims,
                           dtype=torch.float32)
        _fused_counts([x, weight], [out, rstd])
        ctx.save_for_backward(x, rstd, weight)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, rstd, weight = ctx.saved_tensors
        dx = torch.empty_like(x)
        dw = (torch.empty_like(weight) if weight is not None
              and ctx.needs_input_grad[1] else None)
        _fused_counts([grad, x, rstd, weight], [dx, dw])
        return dx, dw, None


def _fused_counts(reads, writes) -> None:
    w = cost.ACTIVE
    if w is not None:
        w._add(w._ranks(),
               result_bytes=sum(_nbytes(t) for t in writes if t is not None),
               read_bytes=sum(_nbytes(t) for t in reads if t is not None))


class _CardDecomp(TorchFunctionMode):
    """`rms_norm` of meta tensors as CUDA's composite takes it (see the
    module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _RMS_NORM and args[0].device.type == "meta":
            names = ("input", "normalized_shape", "weight", "eps")
            a = dict(zip(names, args), **kwargs)
            return _FusedRmsNorm.apply(a["input"], a.get("weight"),
                                       len(a["normalized_shape"]))
        return func(*args, **kwargs)


_RMS_NORM = (torch.nn.functional.rms_norm, torch.rms_norm)


class Walker(TorchDispatchMode):
    """Counts one rank's program on `device_type` ('meta' or 'cuda'); see
    the module docstring.  Use as `with Walker() as w: ...; w.result()`."""

    def __init__(self, device_type: str = "meta"):
        super().__init__()
        self.device_type = device_type
        self.rank, self.raw = _Counts(), _Counts()
        self.records: list = []
        self._pods: dict = {}
        self._schemas: dict = {}
        self._live: dict = {}
        self.live_raw = self.peak_raw = 0
        self.live_rank = self.peak_rank = 0.0
        self.held_raw, self.held_rank = 0, 0.0     # tracked arguments
        self._L = 1                 # the open stacked scope's ranks
        self.ranks_seen: set = set()
        self._prev = None

    # ---- context -------------------------------------------------------
    def __enter__(self):
        self._prev, cost.ACTIVE = cost.ACTIVE, self
        self._decomp = _CardDecomp() if self.device_type == "meta" else None
        if self._decomp is not None:
            self._decomp.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        cost.ACTIVE = self._prev
        out = super().__exit__(*exc)
        if self._decomp is not None:
            self._decomp.__exit__(*exc)
        return out

    def recompute_context(self):
        """What a checkpoint's recompute needs (`obs.cost.
        checkpoint_contexts`): on meta the card's `rms_norm`, since a
        recompute runs with the torch-function modes cleared."""
        return _CardDecomp() if self.device_type == "meta" else nullcontext()

    def _ranks(self) -> int:
        """The stacked ranks the current op runs for: the open scope's, or
        in a backward the tag of the node being run."""
        if self._L > 1:
            return self._L
        node = torch._C._current_autograd_node()
        if node is not None:
            return node.metadata.get(_TAG, 1)
        return 1

    # ---- storages ------------------------------------------------------
    def _on_device(self, t: torch.Tensor) -> bool:
        return t.device.type == self.device_type

    def _alloc(self, t: torch.Tensor, L: int = 1) -> None:
        key, st = _storage_key(t)
        if key in self._live:
            return
        n = -(-st.nbytes() // BLOCK) * BLOCK
        self._live[key] = (n, n / L)
        self.live_raw += n
        self.live_rank += n / L
        weakref.finalize(st, self._free, key)
        self.peak_raw = max(self.peak_raw, self.live_raw)
        self.peak_rank = max(self.peak_rank, self.live_rank)

    def _free(self, key) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self.live_raw -= n[0]
            self.live_rank -= n[1]

    def track(self, tree, L: int = 1) -> int:
        """Count the storages of the tensors in `tree` (nested dicts,
        lists, tuples) as live: the step's arguments, held for L stacked
        ranks (each rank's share 1/L).  Returns one rank's bytes added;
        `held_raw` / `held_rank` sum what every call added."""
        before, before_raw = self.live_rank, self.live_raw
        stack = [tree]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
            elif isinstance(x, torch.Tensor) and self._on_device(x):
                self._alloc(x, L)
        self.held_raw += self.live_raw - before_raw
        self.held_rank += self.live_rank - before
        return int(round(self.live_rank - before))

    # ---- counting ------------------------------------------------------
    def _add(self, L: int, **counts) -> None:
        for c, div in ((self.raw, 1), (self.rank, L)):
            for key, val in counts.items():
                setattr(c, key, getattr(c, key) + val / div)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for a in list(args) + list(kwargs.values())
               for t in _tensors(a)]
        ret = out if isinstance(out, (list, tuple)) else (out,)
        outs = [t for o in ret for t in _tensors(o)]
        if not any(self._on_device(t) for t in ins + outs):
            return out
        L = self._ranks()
        if L > 1:
            self.ranks_seen.add(L)
        packet = func.overloadpacket
        flops = _dot_flops(packet, args, outs[0]) if outs else 0.0
        if func not in self._schemas:
            self._schemas[func] = _schema(func)
        names, writes, aliased = self._schemas[func]
        written = 0
        if writes:                              # in-place / out= ops
            if packet in _INDEXED:
                written = _source_bytes(packet, args, kwargs)
            else:
                for i in writes:
                    a = args[i] if i < len(args) else kwargs.get(names[i])
                    written += sum(_nbytes(t) for t in _tensors(a))
        in_keys = {_storage_key(t)[0] for t in ins}
        fresh = [t for j, o in enumerate(ret) if j not in aliased
                 for t in _tensors(o) if _storage_key(t)[0] not in in_keys]
        read = 0
        if packet not in _ALLOC:
            written += sum(_nbytes(t) for t in fresh)
            if written:
                read = sum(_nbytes(t) for t in ins if self._on_device(t))
        self._add(L, dot_flops=flops, card_flops=flops, result_bytes=written,
                  read_bytes=read)
        for t in fresh:
            if self._on_device(t):
                self._alloc(t, L)
        return out

    # ---- reports from kernels and communicators --------------------------
    def kernel(self, name: str, *, operations: float, read_bytes: float,
               write_bytes: float, dot_flops: float) -> None:
        L = self._ranks()
        self._add(L, dot_flops=float(dot_flops),
                  card_flops=float(operations),
                  result_bytes=float(write_bytes),
                  read_bytes=float(read_bytes))
        for c, div in ((self.raw, 1), (self.rank, L)):
            k = c.kernels[name]
            k["launches"] += 1 / div
            k["operations"] += float(operations) / div
            k["bytes"] += float(read_bytes + write_bytes) / div

    def collective(self, mesh, method: str, axes, per_rank_bytes) -> None:
        axes = None if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        key = (id(mesh), axes)
        if key not in self._pods:
            self._pods[key] = crosses_pod(mesh, axes)
        self.records.append({"category": CATEGORY[method],
                             "bytes": int(per_rank_bytes), "axes": axes,
                             "inter_pod": self._pods[key]})

    @contextmanager
    def stacked(self, L: int):
        """A scope of L stacked ranks (see the module docstring); opened
        through `obs.cost.stacked`."""
        if self._L > 1 or int(L) <= 1:          # nested, or one rank
            yield
            return
        self._L = int(L)
        try:
            with _TagNodes(self._L):
                yield
        finally:
            self._L = 1

    # ---- results -------------------------------------------------------
    def result(self) -> dict:
        """`weighted_analysis`'s keys, per rank, and `port`: the kernels,
        read bytes and peak bytes (tracked arguments included) per rank,
        and the same figures as run (`port.stacked`, with the stacked rank
        counts seen)."""
        coll = collective_bytes(self.records)
        inter = sum(r["bytes"] for r in self.records if r["inter_pod"])
        rank, raw = self.rank.as_dict(), self.raw.as_dict()
        return {
            "collective_bytes": coll["bytes"],
            "collective_counts": coll["counts"],
            "total_collective_bytes": coll["total_bytes"],
            "inter_pod_bytes": inter,
            "intra_pod_bytes": coll["total_bytes"] - inter,
            "dot_flops": rank["dot_flops"],
            "result_bytes": rank["result_bytes"],
            "port": {
                "kernels": rank["kernels"],
                "dot_flops_card": rank["dot_flops_card"],
                "read_bytes": rank["read_bytes"],
                "peak_bytes": int(round(self.peak_rank)),
                "held_bytes": int(round(self.held_rank)),
                "stacked": {"ranks": sorted(self.ranks_seen),
                            "held_bytes": int(self.held_raw),
                            "dot_flops": raw["dot_flops"],
                            "dot_flops_card": raw["dot_flops_card"],
                            "result_bytes": raw["result_bytes"],
                            "read_bytes": raw["read_bytes"],
                            "peak_bytes": int(self.peak_raw),
                            "kernels": raw["kernels"]},
            },
        }


def _source_bytes(packet, args, kwargs) -> int:
    """The bytes an indexed write copies in: index_copy_'s source,
    index_put_'s values, scatter's src; with a scalar (index_fill_,
    scatter_ of a value), the entries the index names along dim."""
    for key in ("source", "values", "src"):
        if isinstance(kwargs.get(key), torch.Tensor):
            return _nbytes(kwargs[key])
    if packet in (_aten.index_put_, _aten.index_put, _aten._index_put_impl_,
                  _aten.masked_scatter_):
        return _nbytes(args[2])
    if len(args) > 3 and isinstance(args[3], torch.Tensor):
        return _nbytes(args[3])
    self_, dim, idx = args[0], args[1], args[2]
    per = self_.numel() // max(self_.shape[dim], 1)
    return idx.numel() * per * self_.element_size()


def _pod_size(mesh) -> int | None:
    """Ranks per pod of a mesh with a 'pod' axis (row-major numbering, so a
    pod is a block of consecutive ranks when 'pod' is the first axis), None
    without one."""
    names = getattr(mesh, "axis_names", ())
    if "pod" not in names:
        return None
    return mesh.n_ranks // mesh.shape["pod"]


def crosses_pod(mesh, axes) -> bool:
    """Does the group of `axes` (a name, a tuple of names, or None for all
    ranks) span more than one pod?  The counterpart of the reference's
    `_crosses_pod`, from the mesh's row-major rank numbering instead of
    HLO replica groups: a group crosses when two of its members' ranks lie
    in different pods (rank // ranks-per-pod differs)."""
    pod = _pod_size(mesh)
    if pod is None:
        return False
    if axes is None:
        return mesh.n_ranks > pod
    for r in range(mesh.n_ranks):
        members = mesh.group_ranks(r, axes)
        if len({m // pod for m in members}) > 1:
            return True
    return False
