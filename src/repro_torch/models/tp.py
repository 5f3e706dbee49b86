"""Tensor parallelism over the model axis: the LM tier's rank program.

The reference shards its weights by their `ParamDef.spec` and lets GSPMD
keep each rank's block between layers.  The port has no GSPMD, so it runs
what GSPMD would have made of the 'model' entries, Megatron's tensor
parallelism, as an SPMD program over the ranks a process holds (every rank
of a stacked mesh, or its one rank of a `torch.distributed` group):

  attention  the query, key and value projections column-parallel over
             heads, each rank's heads attended by K4 (`attention_flash`,
             or `attention_full` in a decode step), the output projection
             row-parallel, then one all-reduce over 'model';
  MLP        w_gate / w_up column-parallel over d_ff, w_down row-parallel,
             one all-reduce;
  MoE        the expert-parallel route (`models.moe`) on the rank's expert
             block, the router replicated;
  vocabulary the embedding's rows and the logits' columns over 'model':
             each rank looks up the tokens its rows hold (zeros for the
             rest) and an all-reduce adds them; the loss all-gathers the
             row maxima and all-reduces the sums of exponentials and the
             gold logits; serving all-gathers the logits;
  rwkv6      the time mix on whole heads, ceil(H / M) a rank (w_r, w_k,
             w_v, w_w, w_g column-parallel, K5 on the rank's heads, w_o
             row-parallel): `ln_x` normalises over all D channels, so the
             per-token sums of squares are all-reduced in float32 first;
             the channel mix's value relu(xk cw_k)^2 cw_v is row-parallel
             and its gate sigmoid(xr cw_r) column-parallel, so the value is
             reduce-scattered to cw_r's column ranges, multiplied by the
             rank's gate and all-gathered (the bytes of one all-reduce);
  hymba      the attention heads as above and the SSM on the rank's d_model
             channels (in_proj columns, conv_w columns, A_log and out_proj
             rows), whose dt / B / C projections contract over the cut
             channels: one float32 all-reduce of the (B, S, 1 + 2N)
             partial products; one all-reduce of 0.5 (attention + SSM)
             for both heads, then the MLP.

Heads are placed by one rule (`head_placement`) that gives every rank
whole key/value heads and one group size, so K4 runs on (H_local,
Hkv_local) unchanged: with tp >= Hkv the ranks are dealt to the KV groups
as evenly as possible, else the KV groups to the ranks; then each group's
query heads to its ranks as evenly as possible.  A rank may hold no query
head (smollm at tp 16): it launches nothing for the sublayer and adds
zeros.  A KV head its group's ranks share is held by each of them.
Other 'model' dims split evenly, an uneven one rounded up.

FSDP.  With more than one rank on the data axes (and `Parallelism.fsdp`,
the default), every leaf whose spec has a 'data' entry is held cut on
that dim over 'data' (or ('pod', 'data') with `fsdp_pod`): the
reference's `param_shardings`.  A superblock's cuts are all-gathered at
its entry as one flat buffer a type (`gather`; a superblock of more than
GATHER_BUCKET bytes a rank in buckets of at most that), inside the
superblock's checkpoint, so a recompute gathers again and the gathered block lives
only while the superblock runs; the embedding, `final_ln`, `lm_head` and
the encoder's leaves likewise.  The gather's backward reduce-scatters the
gradient back to the cut (`core.dist.comm.gather_cuts`).  Leaves without
a 'data' entry (norms, biases, the router) stay whole over the data
axes.  Every family gathers so, rwkv6 and hymba included; a mesh without
a model axis of more than one rank runs a whole-leaf rank program when
its leaves are cut: each rank its data shard on its gathered whole
leaves.

Layout.  Weights are `ModelBlocks` blocks (`models.params`): a leaf
without a cut stacked one per model rank this process holds, (M, *block)
on a stacked mesh, whose data ranks share them, (1, *block) on a group
rank; a cut leaf one per rank, (L, *cut).  Each sublayer reads its
superblock as `gather` gives it: every leaf (L, *block), one per local
rank.  Inside a model the
residual stream is one copy a rank, (L, B_l, S, D), L the local ranks and
B_l the rank's data shard of the batch.  The model's entry points take
and give the batch as before (stacked: the whole batch; group: the rank's
shard): `enter` cuts each rank's rows out, `leave` takes the first rank of
each data shard.  Their backwards keep the SPMD convention: `leave` hands
every rank its rows' cotangent, `enter` takes one rank's gradient a shard
(every model rank's is the same).

Gradients follow Megatron (`core.dist.comm`): `copy_into` (f) before each
column-parallel product, `reduce_from` (g) after each row-parallel one, so
a rank's backward gives exactly its own block's gradient, and a
replicated leaf (norms, the router) the same whole gradient on every rank.
Two kinds of leaf need more, applied by `sync_grads` to a gradient tree:
the whole leaves each rank reads only on its own heads or channels (a
psum over 'model': q_norm / k_norm; rwkv6's w_bias, u_bonus, ln_x;
hymba's D_skip, dt_proj, B_proj, C_proj) and key/value heads several
ranks hold (a psum over the ranks that hold one).  rwkv6's token-shift
mixes (mu_*, cmu_*) are taken before f, so their gradients come out
whole on every rank.  The global gradient norm counts each element once
(`grad_sq_sum`: each rank's squares over the ranks that hold the same
elements, psummed over the whole mesh).  The MoE's outputs are the same on every model rank,
so their cotangents are divided by the model ranks (`shard_map`'s rule)
and the router and the input psum theirs back.

Covered: every family (dense, moe, ssm, hybrid, encdec, vlm).  On a
stacked mesh the program runs inside `obs.cost.stacked(L)`, so a cost
walker counts one rank's share.
"""
from __future__ import annotations

import functools
from dataclasses import replace

import torch
import torch.nn.functional as F

from repro_torch.core.dist.comm import StackedComm
from repro_torch.models import layers as lay
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import (ModelBlocks, ParamDef, map_tree,
                                       tree_leaves, tree_unflatten)

__all__ = ["COVERED", "head_placement", "cut_axes", "model_shardings",
           "plan", "TP", "shard_model", "unshard_model", "sync_grads",
           "grad_sq_sum", "n_holders"]

COVERED = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
ATTN_KEYS = ("wq", "wk", "wv", "wo")
# rwkv6's time-mix leaves, split on head boundaries (K5 runs whole heads)
RWKV_HEAD_KEYS = ("w_r", "w_k", "w_v", "w_w", "w_g", "w_o")
# per kind of sublayer tree, the whole leaves a rank reads only on its own
# heads or channels: their gradients are psummed over 'model'
PARTIAL = {"attn": ("q_norm", "k_norm"),
           "rwkv": ("w_bias", "u_bonus", "ln_x"),
           "ssm": ("D_skip", "dt_proj", "B_proj", "C_proj")}
# the most gathered weights a rank one FSDP gather carries (`_buckets`)
GATHER_BUCKET = 1 << 30


# ============================================================ placement ====
def head_placement(H: int, Hkv: int, tp: int) -> list:
    """Per model rank, (q0, q1, k0, k1): its query heads [q0, q1) and
    key/value heads [k0, k1) (module docstring)."""
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    G = H // Hkv
    out = []
    if tp >= Hkv:
        base, extra = divmod(tp, Hkv)
        for g in range(Hkv):
            n = base + (g < extra)
            qb, qe = divmod(G, n)
            q = g * G
            for j in range(n):
                w = qb + (j < qe)
                out.append((q, q + w, g, g + 1))
                q += w
    else:
        base, extra = divmod(Hkv, tp)
        g = 0
        for r in range(tp):
            n = base + (r < extra)
            out.append((g * G, (g + n) * G, g, g + n))
            g += n
    return out


def _even(n: int, M: int) -> tuple:
    """(starts, stops, width): n split over M ranks in blocks of
    ceil(n / M), the last ones shorter or empty."""
    b = -(-n // M)
    starts = tuple(min(m * b, n) for m in range(M))
    stops = tuple(min((m + 1) * b, n) for m in range(M))
    return starts, stops, b


def _head_blocks(mesh, axis, heads, hd, which, dim, reduce=None):
    lo, hi = (0, 1) if which == "q" else (2, 3)
    starts = tuple(h[lo] * hd for h in heads)
    stops = tuple(h[hi] * hd for h in heads)
    width = max(b - a for a, b in zip(starts, stops))
    return ModelBlocks(mesh, axis, dim, starts, stops, width, reduce)


def _data_axes(mesh, data_axes) -> tuple:
    """The data axes: as given, else the mesh's 'pod' and 'data'."""
    if data_axes is not None:
        return tuple(data_axes)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def cut_axes(mesh, data_axes=None, fsdp: bool = True,
             fsdp_pod: bool = False) -> tuple:
    """The mesh axes the 'data' entries are cut over: ('data',), or
    ('pod', 'data') with `fsdp_pod` and a pod axis among the data axes;
    () with `fsdp` off, no 'data' data axis, or one rank on them."""
    dp = _data_axes(mesh, data_axes)
    if not fsdp or "data" not in dp:
        return ()
    axes = ("pod", "data") if fsdp_pod and "pod" in dp else ("data",)
    return axes if mesh.axis_size(axes) > 1 else ()


def _model_axis(mesh, axis):
    """`axis` if the mesh has it with more than one rank, else None."""
    if axis is None or axis not in mesh.axis_names \
            or mesh.shape[axis] == 1:
        return None
    return axis


def _kind(t: dict):
    """The kind of a sublayer's leaf tree: "attn", "rwkv", "ssm" or
    None."""
    for key, kind in (("wq", "attn"), ("w_r", "rwkv"), ("in_proj", "ssm")):
        if key in t:
            return kind
    return None


def model_shardings(defs, cfg, mesh, axis: str = "model", *,
                    data_axes=None, fsdp: bool = True,
                    fsdp_pod: bool = False):
    """Per leaf of a def tree, its `ModelBlocks` over `mesh`: the 'model'
    entries over `axis` (attention by `head_placement`, rwkv6's time mix
    on whole heads in blocks of ceil(H / M), the other 'model' dims
    evenly), each 'data' entry cut over `cut_axes(mesh, data_axes, fsdp,
    fsdp_pod)`.  None for every leaf where `plan` runs no rank program: no
    model axis of more than one rank and one data rank (`data_axes`:
    default the mesh's 'pod' and 'data')."""
    dp = _data_axes(mesh, data_axes)
    cut = cut_axes(mesh, dp, fsdp, fsdp_pod)
    axis = _model_axis(mesh, axis)
    M = 1 if axis is None else mesh.shape[axis]
    covered = cfg.family in COVERED and axis is not None
    if not covered and (not dp or mesh.axis_size(dp) == 1):
        return map_tree(lambda d: None, defs)
    if covered:
        heads = head_placement(cfg.n_heads, cfg.n_kv_heads, M)
        shared = M > cfg.n_kv_heads
        rwkv_hd = cfg.d_model // cfg.n_heads
        hs, he, hb = _even(cfg.n_heads, M)
    hd = cfg.hd

    def model_leaf(d: ParamDef, name: str, kind):
        if not covered:
            return ModelBlocks(mesh, axis)
        if kind == "attn" and name in ATTN_KEYS:
            if name == "wq":
                return _head_blocks(mesh, axis, heads, hd, "q", 1)
            if name == "wo":
                return _head_blocks(mesh, axis, heads, hd, "q", 0)
            return _head_blocks(mesh, axis, heads, hd, "k", 1,
                                "sharers" if shared else None)
        if kind == "rwkv" and name in RWKV_HEAD_KEYS:
            return ModelBlocks(mesh, axis, d.spec.index("model"),
                               tuple(h * rwkv_hd for h in hs),
                               tuple(h * rwkv_hd for h in he), hb * rwkv_hd)
        if "model" in d.spec:
            dim = d.spec.index("model")
            starts, stops, width = _even(d.shape[dim], M)
            return ModelBlocks(mesh, axis, dim, starts, stops, width)
        return ModelBlocks(mesh, axis, reduce="model" if name in PARTIAL.get(
            kind, ()) else None)

    def leaf(d: ParamDef, name: str, kind):
        mb = model_leaf(d, name, kind)
        if cut and "data" in d.spec:
            dim = d.spec.index("data")
            mb = replace(mb, cut_dim=dim, cut_axes=cut, cut_len=d.shape[dim])
        return mb

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        kind = _kind(t)
        return {k: (walk(v) if not isinstance(v, ParamDef)
                    else leaf(v, k, kind)) for k, v in t.items()}

    return walk(defs)


@functools.lru_cache(maxsize=64)
def _shardings(cfg, mesh, axis, data_axes, fsdp, fsdp_pod):
    from repro_torch.models.transformer import model_defs
    return model_shardings(model_defs(cfg), cfg, mesh, axis,
                           data_axes=data_axes, fsdp=fsdp, fsdp_pod=fsdp_pod)


def shard_model(params, cfg, mesh, axis: str = "model", *, data_axes=None,
                fsdp: bool = True, fsdp_pod: bool = False):
    """A whole weight tree -> its blocks on `mesh` (`model_shardings`):
    (M, *block) leaves, cut leaves (L, *cut), on the mesh's device; whole
    leaves where no rank program runs."""
    from repro_torch.models.params import shard_params
    return shard_params(params, _shardings(
        cfg, mesh, axis, _data_axes(mesh, data_axes), fsdp, fsdp_pod))


def unshard_model(blocks, cfg, mesh, axis: str = "model", *,
                  data_axes=None, fsdp: bool = True, fsdp_pod: bool = False):
    """The whole weight tree from `shard_model`'s blocks."""
    from repro_torch.models.params import unshard_params
    return unshard_params(blocks, _shardings(
        cfg, mesh, axis, _data_axes(mesh, data_axes), fsdp, fsdp_pod))


def par_shardings(cfg, par, cut: tuple | None = None):
    """`model_shardings` of `cfg`'s whole tree under `par` with the
    weights cut over `cut` (default: 'data', as `shard_model` cuts)
    (cached)."""
    dp = _data_axes(par.mesh, par.data_axes)
    cut = cut_axes(par.mesh, dp) if cut is None else tuple(cut)
    return _shardings(cfg, par.mesh, par.model_axis, dp, bool(cut),
                      cut == ("pod", "data"))


def infer_cut(tree, defs, mesh, data_axes=None) -> tuple:
    """The axes a weight tree as the ranks hold it was cut over (`()`:
    the 'data' entries whole), read off its first leaf whose spec has a
    'data' entry: its length on that dim is the whole one, or a cut's
    over ('data',) or ('pod', 'data')."""
    dp = _data_axes(mesh, data_axes)
    for t, d in zip(tree_leaves(tree), tree_leaves(defs)):
        if "data" not in d.spec or t.dim() != len(d.shape) + 1:
            continue
        dim = d.spec.index("data")
        n, held = d.shape[dim], t.shape[1 + dim]
        for cand in ((), cut_axes(mesh, dp), cut_axes(mesh, dp,
                                                      fsdp_pod=True)):
            k = mesh.axis_size(cand) if cand else 1
            if held == -(-n // k):
                return cand
        raise ValueError(f"a leaf of {tuple(d.shape)} held as "
                         f"{tuple(t.shape)}: not a cut over the data axes "
                         f"{dp} of mesh {mesh.shape}")
    return ()


# ========================================================= rank program ====
class _Enter(torch.autograd.Function):
    """(B, ...) -> (L, B_l, ...): each local rank's data shard; backward,
    one rank's gradient a shard."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.shape = tp, x.shape
        shards = x.reshape(tp.n_dp, -1, *x.shape[1:])
        return torch.stack([shards[j] for j in tp.didx])

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return (torch.stack([g[i] for i in tp.first]).reshape(ctx.shape),
                None)


class _Leave(torch.autograd.Function):
    """(L, B_l, ...) -> (B, ...): the first rank of each data shard;
    backward, every rank its shard's cotangent."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        out = torch.stack([y[i] for i in tp.first])
        return out.reshape(-1, *y.shape[2:])

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        gs = g.reshape(tp.n_dp, -1, *g.shape[1:])
        return torch.stack([gs[j] for j in tp.didx]), None


class _LeaveMean(torch.autograd.Function):
    """(L,) per-rank scalars -> their mean over the data shards (the
    first rank of each); backward, every rank 1 / n_dp of the
    cotangent."""

    @staticmethod
    def forward(ctx, v, tp):
        ctx.tp, ctx.shape = tp, v.shape
        acc = v[tp.first[0]]
        for i in tp.first[1:]:
            acc = acc + v[i]
        return acc / tp.n_dp

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.tp.n_dp).expand(ctx.shape).contiguous(), None


class TP:
    """The rank program of `cfg` under `par` (module docstring): the mesh,
    the local ranks' model and data coordinates, the FSDP cut, and each
    rank's heads (`hq`, `hkv`; rwkv6: `hq` its heads from `h0`), d_model
    channels (`ch`: (start, count), `ch_width` the widest), d_ff columns
    and vocabulary rows.  `covered`: the sublayers over a model axis of
    more than one rank; else each rank runs the whole-leaf model on its
    data shard (no model axis)."""

    def __init__(self, cfg, par, cut: tuple | None = None):
        mesh = par.mesh
        axis = _model_axis(mesh, par.model_axis)
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.M = 1 if axis is None else mesh.shape[axis]
        self.covered = cfg.family in COVERED and axis is not None
        self.stacked = isinstance(mesh, StackedComm)
        self.L = len(mesh.local_ranks)
        self.midx = mesh.axis_index(axis) if axis else [0] * self.L
        rows = list(dict.fromkeys(self.midx))
        self.rows = [rows.index(m) for m in self.midx]
        dp = _data_axes(mesh, par.data_axes)
        if self.stacked:
            idx = mesh.axis_index(dp) if dp else [0] * self.L
            order = sorted(set(idx))
            self.didx = [order.index(i) for i in idx]
            self.n_dp = len(order)
            self.first = [self.didx.index(j) for j in range(self.n_dp)]
        else:
            self.n_dp, self.didx, self.first = 1, [0], [0]
        self.cut = cut_axes(mesh, dp) if cut is None else tuple(cut)
        self.sh = par_shardings(cfg, par, self.cut)
        self.block_sh = self.sh["blocks"][0]
        if not self.covered:
            return
        if cfg.family == "ssm":
            hs, he, _ = _even(cfg.n_heads, self.M)
            self.h0 = [hs[m] for m in self.midx]
            self.hq = [he[m] - hs[m] for m in self.midx]
            self.hkv = list(self.hq)
        else:
            heads = [head_placement(cfg.n_heads, cfg.n_kv_heads, self.M)[m]
                     for m in self.midx]
            self.hq = [q1 - q0 for q0, q1, _, _ in heads]
            self.hkv = [k1 - k0 for _, _, k0, k1 in heads]
        cs, ce, self.ch_width = _even(cfg.d_model, self.M)
        self.ch = [(cs[m], ce[m] - cs[m]) for m in self.midx]
        ff = _even(cfg.d_ff, self.M)
        self.ff = [ff[1][m] - ff[0][m] for m in self.midx]
        from repro_torch.models.transformer import padded_vocab
        vs, ve, self.v_width = _even(padded_vocab(cfg), self.M)
        self.vocab = [(vs[m], ve[m] - vs[m]) for m in self.midx]

    # ---- entering and leaving the program ---------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The batch (stacked: whole; group: the rank's shard) -> (L, B_l,
        ...)."""
        if not self.stacked:
            return x[None]
        if x.shape[0] % self.n_dp:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{self.n_dp} data ranks")
        return _Enter.apply(x, self)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        return _Leave.apply(y, self) if self.stacked else y[0]

    def leave_mean(self, v: torch.Tensor) -> torch.Tensor:
        return _LeaveMean.apply(v, self) if self.stacked else v[0]

    def scope(self):
        """`obs.cost.stacked(L)` on a stacked mesh (a cost walker counts
        one rank's share); a no-op on a group rank."""
        from repro_torch.obs import cost
        return cost.stacked(self.L if self.stacked else 1)

    # ---- weights ------------------------------------------------------------
    def per_rank(self, leaf: torch.Tensor) -> torch.Tensor:
        """(L, ...): each local rank's row of a leaf held one a model rank
        (M_l, ...); a leaf held one a rank as it is."""
        if leaf.shape[0] == self.L:
            return leaf
        return torch.stack([leaf[r] for r in self.rows])

    def gather(self, tree, sh):
        """A weight tree as the ranks hold it (`sh` its `ModelBlocks`) ->
        every leaf (L, *block), one per local rank: the cut leaves
        all-gathered over the cut axes as one flat buffer a type and
        bucket (`_buckets`; the padding dropped; backward, a float32
        reduce-scatter to the cuts), the others each local rank's row.
        Where no gradient flows to them on a stacked mesh a cut leaf is
        one block a group of ranks that would gather the same (`_Rows`,
        indexed by rank)."""
        leaves, shs = tree_leaves(tree), tree_leaves(sh)
        out, groups = [None] * len(leaves), {}
        for i, (t, s) in enumerate(zip(leaves, shs)):
            if s is not None and s.cut_axes:
                groups.setdefault(t.dtype, []).append(i)
            else:
                out[i] = self.per_rank(t)
        whole = self.stacked and \
            len(self.mesh.local_ranks) == self.mesh.n_ranks
        for idx in _buckets(groups.values(), leaves, shs):
            flat = torch.cat([leaves[i].reshape(self.L, -1) for i in idx], 1)
            share = whole and not (torch.is_grad_enabled()
                                   and flat.requires_grad)
            if share:                                       # (O, G, N)
                g, group = self.mesh.gather_groups(flat, self.cut)
            else:                                           # (L, G, N)
                g = self.mesh.gather_cuts(flat, self.cut)
            at = 0
            for i in idx:
                t, s = leaves[i], shs[i]
                n = t[0].numel()
                part = g[:, :, at:at + n].reshape(g.shape[0], g.shape[1],
                                                  *t.shape[1:])
                d = 1 + s.cut_dim
                out[i] = part.movedim(1, d).flatten(d, d + 1).narrow(
                    d, 0, s.cut_len)
                if share:
                    out[i] = _Rows(out[i], group)
                at += n
        return tree_unflatten(tree, out)

    def top(self, params, *keys) -> dict:
        """The top-level leaves `keys` of a weight tree, gathered."""
        return self.gather({k: params[k] for k in keys},
                           {k: self.sh[k] for k in keys})

    def head_key(self) -> str:
        return "embed" if self.cfg.tie_embeddings else "lm_head"

    # ---- collectives and rows ---------------------------------------------
    def f(self, x):
        return x if self.axis is None else self.mesh.copy_into(x, self.axis)

    def g(self, x):
        return x if self.axis is None else self.mesh.reduce_from(x, self.axis)

    def norm(self, h, gamma, eps):
        """rms_norm of each rank's rows with its own copy of gamma."""
        g = self.per_rank(gamma)
        return lay.rms_norm(h, g.reshape(self.L, *([1] * (h.dim() - 2)),
                                         g.shape[-1]), eps)


class _Rows:
    """A gathered leaf whose ranks share blocks (`TP.gather` where no
    gradient flows, on a stacked mesh): rank i's row is base[group[i]]."""

    def __init__(self, base, group):
        self.base, self.group = base, group

    def __getitem__(self, i):
        return self.base[self.group[i]]


def _buckets(groups, leaves, shs) -> list:
    """The cut leaves' indices in buckets to gather as one flat buffer
    each: one a type, a bucket closed before it would pass GATHER_BUCKET
    bytes of gathered weights a rank (a larger leaf alone).  The gathered
    copies of a bucket are made from its flat buffer before the next one
    is gathered, so a superblock's gather holds its gathered weights and
    one bucket's buffer at a time, not two copies of the whole block."""
    out = []
    for idx in groups:
        cur, size = [], 0
        for i in idx:
            t = leaves[i]
            n = t[0].numel() * t.element_size() * shs[i].n_cut
            if cur and size + n > GATHER_BUCKET:
                out.append(cur)
                cur, size = [], 0
            cur.append(i)
            size += n
        out.append(cur)
    return out


def plan(cfg, par, params=None):
    """The `TP` of `cfg` under `par`, or None where the model runs on
    whole leaves: no mesh, or one data rank and no model axis of more
    than one rank.  Where there are data ranks, the cuts of the 'data'
    entries are gathered a superblock at a time (`TP.gather`) in every
    family.  With `params` (the weights as the ranks hold them) the cut
    is read off them (`infer_cut`); else it is `shard_model`'s
    default."""
    if par.mesh is None:
        return None
    covered = cfg.family in COVERED and _model_axis(
        par.mesh, par.model_axis) is not None
    if not covered and par.dp_size() == 1:
        return None
    cut = None
    if params is not None:
        from repro_torch.models.transformer import model_defs
        cut = infer_cut(params, model_defs(cfg), par.mesh, par.data_axes)
    return TP(cfg, par, cut)


def rank_tree(tree, i: int):
    """Rank i's leaves of a tree of (L, ...) leaves."""
    return map_tree(lambda t: t[i], tree)


# ============================================================ sublayers ====
def _nothing(x, src):
    """Zeros (B, S, D) that depend on x (and src), for a rank with no
    query head: it computes nothing, yet its backward runs the same
    collectives as its peers'."""
    z = x.narrow(-1, 0, 0).sum(-1, keepdim=True)
    if src is not None:
        z = z + src.narrow(-1, 0, 0).sum((-2, -1))[:, None, None]
    return z.expand(*x.shape)


def attn_sublayer(h, p, cfg, tp, *, positions, causal=True, window=None,
                  memory=None, kv_len=None, cache=None):
    """Pre-norm attention with residual on each rank's heads (module
    docstring): h (L, B, S, D); memory (L, B, Sm, D) for cross-attention.
    `kv_len` without `cache`: a decode step's query over the memory
    (`attention_full`).  `cache` = (kc, vc, at, kv_len): a decode step's
    self-attention, k / v written into the rank caches (L, B, S_max,
    Hkv_pad, hd) at `at` and attended over their first kv_len rows.
    Returns (h, ks, vs): per rank its keys and values (B, Sk, Hkv_l, hd),
    None where it has no query head.  `p` is `TP.gather`'s: each leaf
    (L, *block)."""
    x = tp.f(tp.norm(h, p["ln"], cfg.norm_eps))
    ys, ks, vs = _attn_heads(x, p, cfg, tp, positions=positions,
                             causal=causal, window=window,
                             memory=None if memory is None
                             else tp.f(memory), kv_len=kv_len, cache=cache)
    return h + tp.g(ys), ks, vs


def _attn_heads(x, p, cfg, tp, *, positions, causal=True, window=None,
                memory=None, kv_len=None, cache=None, q_offset=0):
    """`attn_sublayer` after its f, before its residual and g: x (L, B, S,
    D) the normalised input, memory (L, B, Sm, D) past its f.  A decode
    step's `cache` attends within `window` keys of the query at position
    `q_offset` when a window is given (hymba's full caches).  Returns
    (each rank's partial output (L, B, S, D), ks, vs)."""
    L, B, S, D = x.shape
    hd, eps = cfg.hd, cfg.norm_eps
    src = x if memory is None else memory
    ys, ks, vs = [], [], []
    for i in range(L):
        nq, nk = tp.hq[i], tp.hkv[i]
        if nq == 0:
            ys.append(_nothing(x[i], None if memory is None else src[i]))
            ks.append(None)
            vs.append(None)
            continue
        q = (x[i] @ p["wq"][i].narrow(1, 0, nq * hd)).reshape(B, S, nq, hd)
        k = (src[i] @ p["wk"][i].narrow(1, 0, nk * hd)).reshape(
            B, -1, nk, hd)
        v = (src[i] @ p["wv"][i].narrow(1, 0, nk * hd)).reshape(
            B, -1, nk, hd)
        if cfg.qk_norm:
            q = lay.rms_norm(q, p["q_norm"][i], eps)
            k = lay.rms_norm(k, p["k_norm"][i], eps)
        if memory is None:
            q = lay.apply_rope(q, positions, cfg.rope_theta)
            k = lay.apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:
            kc, vc, at, kvl = cache
            kci, vci = kc[i].narrow(2, 0, nk), vc[i].narrow(2, 0, nk)
            kci.index_copy_(1, at, k.to(kci.dtype))
            vci.index_copy_(1, at, v.to(vci.dtype))
            o = lay.attention_full(q, kci.to(q.dtype), vci.to(q.dtype),
                                   causal=False, window=window,
                                   q_offset=q_offset, kv_len=kvl)
        elif kv_len is not None:
            o = lay.attention_full(q, k, v, causal=False, kv_len=kv_len)
        elif memory is not None:
            o = lay.attention_flash(q, k, v, causal=False)
        else:
            o = lay.attention_flash(q, k, v, causal=causal, window=window)
        ys.append(o.reshape(B, S, nq * hd) @ p["wo"][i].narrow(0, 0,
                                                               nq * hd))
        ks.append(k)
        vs.append(v)
    return torch.stack(ys), ks, vs


def mlp_sublayer(h, p, cfg, tp):
    """Pre-norm SwiGLU with residual on each rank's d_ff columns."""
    x = tp.f(tp.norm(h, p["ln"], cfg.norm_eps))
    ys = []
    for i in range(tp.L):
        n = tp.ff[i]
        if n == 0:
            ys.append(_nothing(x[i], None))
            continue
        ys.append(lay.swiglu(x[i], p["w_gate"][i].narrow(1, 0, n),
                             p["w_up"][i].narrow(1, 0, n),
                             p["w_down"][i].narrow(0, 0, n)))
    return h + tp.g(torch.stack(ys))


class _GatherOwn(torch.autograd.Function):
    """(L, ..., b) each rank's columns -> (L, ..., M b), all-gathered over
    'model' in rank order: a value every rank then holds alike, so each
    rank's cotangent is the whole one and its backward is the rank's own
    columns of it (no collective)."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp, ctx.b = tp, y.shape[-1]
        return tp.mesh._collective("all_gather", y, tp.axis, y.dim() - 2,
                                   True)

    @staticmethod
    def backward(ctx, g):
        tp, b = ctx.tp, ctx.b
        with tp.scope():
            return torch.stack([g[i].narrow(-1, tp.midx[i] * b, b)
                                for i in range(tp.L)]), None


def _gather_own(tp, y):
    if y.requires_grad and torch.is_grad_enabled():
        return _GatherOwn.apply(y.contiguous(), tp)
    return tp.mesh._collective("all_gather", y.contiguous(), tp.axis,
                               y.dim() - 2, True)


def _link(out, t):
    """`out` plus nothing from `t`: a rank that uses none of a
    collective's result still takes the collective's backward, as its
    peers do."""
    return out + t.narrow(-1, 0, 0).sum(-1, keepdim=True).to(out.dtype)


def _mixes(x, prev, p, keys, tp):
    """rwkv6's token-shift mixes x + (shift(x) - x) mu of each mu in
    `keys`, stacked (L, len(keys), B, S, D) behind one f: each rank reads
    them on its own columns, so the cotangents psummed there make every
    mu's gradient whole on every rank."""
    L, B, S, D = x.shape
    if prev is None:
        prev = x.new_zeros(L, B, 1, D)
    xs = torch.cat([prev, x[:, :, :-1]], dim=2)
    mus = torch.stack([p[k] for k in keys], 1)                # (L, K, D)
    return tp.f(x[:, None] + (xs - x)[:, None] * mus[:, :, None, None, :])


def _time_mix(x, p, cfg, tp, prev=None, state=None):
    """rwkv6's time mix on each rank's heads (module docstring): x (L, B,
    S, D) normalised; prev (L, B, 1, D) the token-shift tail; state (L, B,
    H_pad, hd, hd) float32, a rank's heads first.  Returns (the reduced
    output (L, B, S, D), the new tail, each rank's new WKV state (B, H_l,
    hd, hd) or None without a head)."""
    L, B, S, D = x.shape
    hd = D // cfg.n_heads
    m = _mixes(x, prev, p, ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"), tp)
    ys, gs, ss, states = [], [], [], []
    for i in range(L):
        n = tp.hq[i]
        if n == 0:
            ys.append(None)
            gs.append(None)
            ss.append(m[i, 0].narrow(-1, 0, 0).float().sum(-1, keepdim=True))
            states.append(None)
            continue
        c, c0 = n * hd, tp.h0[i] * hd
        mr, mk, mv, mw, mg = m[i].unbind(0)

        def cols(key):
            return p[key][i].narrow(1, 0, c)

        def heads(a):                      # (B, S, c) -> (B n, S, hd)
            return a.reshape(B, S, n, hd).transpose(1, 2).reshape(
                B * n, S, hd)

        r = heads(mr @ cols("w_r"))
        k = heads(mk @ cols("w_k"))
        v = heads(mv @ cols("w_v"))
        gs.append(F.silu(mg @ cols("w_g")))
        w = torch.exp(-torch.exp((mw @ cols("w_w") + p["w_bias"][i].narrow(
            0, c0, c)).float()))
        w = heads(w.clamp(1e-5, 1.0))
        u = p["u_bonus"][i].narrow(0, c0, c).reshape(1, n, hd).expand(
            B, n, hd).reshape(B * n, hd)
        s0 = (state[i].narrow(1, 0, n) if state is not None else
              torch.zeros(B, n, hd, hd, dtype=torch.float32,
                          device=x.device))
        y, s1 = rwkv_mod.rwkv6_wkv(r, k, v, w, u, s0.reshape(B * n, hd, hd),
                                   chunk=min(rwkv_mod.CHUNK, S))
        y = y.reshape(B, n, S, hd).transpose(1, 2).reshape(B, S, c)
        ys.append(y)
        ss.append(y.float().square().sum(-1, keepdim=True))
        states.append(s1.reshape(B, n, hd, hd))
    # ln_x: an rms_norm over all D channels of the heads' output
    var = tp.mesh.psum(torch.stack(ss), tp.axis) / D          # (L, B, S, 1)
    outs = []
    for i in range(L):
        y = ys[i]
        if y is None:
            outs.append(_link(_nothing(m[i, 0], None), var[i]))
            continue
        c, c0 = y.shape[-1], tp.h0[i] * hd
        yn = (y.float() * torch.rsqrt(var[i] + 1e-5)).to(y.dtype) * \
            p["ln_x"][i].narrow(0, c0, c)
        outs.append((yn * gs[i]) @ p["w_o"][i].narrow(0, 0, c))
    return tp.g(torch.stack(outs)), x[:, :, -1:], states


def _channel_mix(x, p, cfg, tp, prev=None):
    """rwkv6's channel mix (module docstring): the value row-parallel over
    the d_ff columns, reduce-scattered to the gate's `_even` d_model
    columns, gated there and all-gathered.  Returns (the output (L, B, S,
    D), the new token-shift tail)."""
    L, B, S, D = x.shape
    m = _mixes(x, prev, p, ("cmu_k", "cmu_r"), tp)
    width = tp.ch_width * tp.M
    vals, gates = [], []
    for i in range(L):
        xk, xr = m[i].unbind(0)
        k = torch.square(F.relu(xk @ p["cw_k"][i]))
        vals.append(F.pad(k @ p["cw_v"][i], (0, width - D)))
        gates.append(torch.sigmoid(xr @ p["cw_r"][i]))
    part = tp.mesh.psum_scatter(torch.stack(vals), tp.axis, dim=2,
                                tiled=True)                   # (L, B, S, b)
    return _gather_own(tp, torch.stack(gates) * part).narrow(
        -1, 0, D), x[:, :, -1:]


def rwkv_block(h, p, cfg, tp, state=None):
    """One rwkv6 block (`rwkv6.rwkv_block`) on each rank's heads and
    channels: h (L, B, S, D); p the block's gathered leaves; state the
    layer's rank cache entry (`tm_tok`, `wkv`, `cm_tok` in h's type) of a
    decode step, or None (from zeros).  Returns (h, (tm_tok, [each rank's
    WKV state or None], cm_tok))."""
    st = state or {}
    y, tm_tok, wkv = _time_mix(tp.norm(h, p["ln1"], 1e-5), p, cfg, tp,
                               st.get("tm_tok"), st.get("wkv"))
    h = h + y
    y, cm_tok = _channel_mix(tp.norm(h, p["ln2"], 1e-5), p, cfg, tp,
                             st.get("cm_tok"))
    return h + y, (tm_tok, wkv, cm_tok)


def ssm_ranks(x, p, cfg, tp, conv=None, state=None):
    """hymba's SSM head (`ssm.ssm_head`) on each rank's d_model channels
    (module docstring): x (L, B, S, D) past f.  The dt / B / C partial
    products are all-reduced in float32 and rounded once to x's type.
    Without `state`, a whole sequence from 0: (partial output (L, B, S,
    D), [each rank's last state (B, C_l, N) float32]).  With `conv` (L, B,
    4, C_pad) and `state` (L, B, C_pad, N), one token (`ssm.ssm_step`):
    (partial output, [new states], [new conv tails (B, 4, C_l)])."""
    N = cfg.ssm_state
    xis, parts, tails = [], [], []
    for i in range(tp.L):
        c0, n = tp.ch[i]
        xi = x[i] @ p["in_proj"][i].narrow(1, 0, n)
        w = p["conv_w"][i].narrow(1, 0, n)
        if state is None:
            xi = F.silu(ssm_mod._causal_conv(xi, w) + xi)
        else:
            tail = torch.cat([conv[i][:, 1:, :n], xi.to(conv.dtype)], dim=1)
            tails.append(tail)
            xi = F.silu((tail.to(xi.dtype) * w[None]).sum(1, keepdim=True)
                        + xi)
        proj = torch.cat([p[k][i].narrow(0, c0, n) for k in
                          ("dt_proj", "B_proj", "C_proj")], dim=1)
        parts.append(xi.float() @ proj.float())
        xis.append(xi)
    red = tp.mesh.psum(torch.stack(parts), tp.axis)     # (L, B, S, 1 + 2N)
    outs, hs = [], []
    for i in range(tp.L):
        c0, n = tp.ch[i]
        xi = xis[i]
        r = red[i].to(xi.dtype)
        dt = F.softplus(r[..., :1])
        Bm, Cm = r[..., 1:1 + N], r[..., 1 + N:]
        A = -torch.exp(p["A_log"][i].narrow(0, 0, n).float())
        a = torch.exp(dt[..., None] * A[None, None])
        b = (dt[..., None] * Bm[:, :, None, :]) * xi[..., None]
        D_skip = p["D_skip"][i].narrow(0, c0, n)
        if state is None:
            y_state, hl = ssm_mod.selective_scan(a.float(), b.float(),
                                                 Cm.float())
            y = y_state.to(x.dtype) + xi * D_skip
        else:
            hl = a[:, 0] * state[i][:, :n] + b[:, 0].float()
            y = torch.einsum("bdn,bn->bd", hl.to(xi.dtype), Cm[:, 0])
            y = (y + xi[:, 0] * D_skip)[:, None]
        outs.append(y @ p["out_proj"][i].narrow(0, 0, n))
        hs.append(hl)
    out = torch.stack(outs)
    return (out, hs) if state is None else (out, hs, tails)


def hybrid_layer(h, pb, cfg, tp, *, positions, window, cache=None,
                 pos=None):
    """One hymba layer (`transformer.hybrid_block`) on each rank's heads
    and SSM channels: the attention and the SSM read one normalised input
    past one f, their partial outputs averaged and all-reduced once, then
    the MLP.  pb the layer's gathered leaves; h (L, B, S, D).  Without
    `cache` over a whole sequence; with `cache` (the layer's rank cache
    entry) one token at `pos`, its keys and values written there.
    Returns (h, entry): per rank its last SSM state (`ssm_h`, (B, C_l, N)
    float32) and conv tail (`conv`, (B, 4, C_l): the input projection of
    the last 4 rows, zeros before a short prompt), and over a whole
    sequence its keys and values (`k`, `v`)."""
    pa, ps = pb["attn0"], pb["ssm0"]
    x = tp.f(tp.norm(h, pa["ln"], cfg.norm_eps))
    if cache is None:
        o_attn, ks, vs = _attn_heads(x, pa, cfg, tp, positions=positions,
                                     window=window)
        o_ssm, hs = ssm_ranks(x, ps, cfg, tp)
        tails = [x[i][:, -4:] @ ps["in_proj"][i].narrow(1, 0, tp.ch[i][1])
                 for i in range(tp.L)]
        entry = {"k": ks, "v": vs, "ssm_h": hs, "conv": [
            F.pad(t, (0, 0, 4 - t.shape[1], 0)) for t in tails]}
    else:
        o_attn, _, _ = _attn_heads(
            x, pa, cfg, tp, positions=positions, window=window,
            cache=(cache["k"], cache["v"], positions, pos + 1), q_offset=pos)
        o_ssm, hs, tails = ssm_ranks(x, ps, cfg, tp, cache["conv"],
                                     cache["ssm_h"])
        entry = {"ssm_h": hs, "conv": tails}
    h = h + tp.g(0.5 * (o_attn + o_ssm))
    return mlp_sublayer(h, pb["mlp0"], cfg, tp), entry


def embed(params, tokens, cfg, tp):
    """(L, B, S) token ids -> (L, B, S, D), the embedding gathered: each
    rank's rows of the vocabulary looked up, the rest zero, summed over
    'model' (`covered`), or each rank's whole table."""
    dt = getattr(torch, cfg.dtype)
    e = tp.top(params, "embed")["embed"]
    if not tp.covered:
        return torch.stack([e[i][tokens[i].long()].to(dt)
                            for i in range(tp.L)])
    parts = []
    for i in range(tp.L):
        v0, n = tp.vocab[i]
        t = tokens[i].long() - v0
        ok = (t >= 0) & (t < n)
        ei = e[i][t.clamp(0, max(n - 1, 0))].to(dt)
        parts.append(torch.where(ok[..., None], ei, torch.zeros(
            (), dtype=dt, device=ei.device)))
    return tp.g(torch.stack(parts))


def _head_rows(w, cfg, tp, i):
    """Rank i's (D, V_l) block of the output projection, from the gathered
    embedding (tied) or `lm_head`."""
    if not tp.covered:
        return w[i].T if cfg.tie_embeddings else w[i]
    n = tp.vocab[i][1]
    if cfg.tie_embeddings:
        return w[i].narrow(0, 0, n).T
    return w[i].narrow(1, 0, n)


def logits(params, h, cfg, tp):
    """Final hidden states (L, B, S, D) -> the whole logits (L, B, S, vp),
    each rank's columns all-gathered over 'model'."""
    w = tp.top(params, tp.head_key())[tp.head_key()]
    x = tp.f(h)
    parts = []
    for i in range(tp.L):
        y = x[i] @ _head_rows(w, cfg, tp, i).to(x.dtype)
        pad = (tp.v_width - y.shape[-1]) if tp.covered else 0
        parts.append(torch.nn.functional.pad(y, (0, pad)) if pad else y)
    y = torch.stack(parts)
    return _gather_cols(tp, y) if tp.covered else y


def _gather_cols(tp, y):
    """(L, ..., V_pad) rank columns -> (L, ..., vp): all-gathered over
    'model' in rank order, each rank's padding dropped."""
    g = tp.mesh.all_gather(y.movedim(-1, 1), tp.axis, dim=0, tiled=True)
    g = g.movedim(1, -1)                                 # (L, ..., M*V_pad)
    from repro_torch.models.transformer import padded_vocab
    if tp.v_width * tp.M == padded_vocab(tp.cfg):
        return g
    starts, stops, w = _even(padded_vocab(tp.cfg), tp.M)
    return torch.cat([g[..., m * w:m * w + stops[m] - starts[m]]
                      for m in range(tp.M)], -1)


def _xent_ranks(hs, ls, *ws, tp):
    """One chunk's per-rank sums of logsumexp - gold (L,): each rank's
    logits (B, c, V_l) in h's type then float32; the row max all-gathered
    (no gradient), the sums of exponentials and the gold logits reduced
    over 'model'."""
    lg = [(hs[i] @ w.to(hs.dtype)).float() for i, w in enumerate(ws)]
    mx = torch.stack([t.detach().amax(-1) for t in lg])        # (L, B, c)
    m = tp.mesh.all_gather(mx, tp.axis).amax(1)                # (L, B, c)
    se, gold = [], []
    for i, t in enumerate(lg):
        v0, n = tp.vocab[i]
        se.append(torch.exp(t - m[i][..., None]).sum(-1))
        lab = ls[i] - v0
        ok = (lab >= 0) & (lab < n)
        gl = t.gather(-1, lab.clamp(0, max(n - 1, 0))[..., None])[..., 0]
        gold.append(torch.where(ok, gl, torch.zeros_like(gl)))
    s = tp.g(torch.stack(se))
    gold = tp.g(torch.stack(gold))
    return (torch.log(s) + m - gold).sum((1, 2))


def chunked_xent(params, h, labels, cfg, tp, chunk: int = 512):
    """Per-rank mean cross-entropy (L,) of h (L, B, S, D) against labels
    (L, B, S), vocabulary-parallel, over sequence chunks of min(chunk, S)
    as `transformer.chunked_xent` (each chunk recomputed in backward); a
    rank of the whole-leaf program runs `transformer.chunked_xent`."""
    from torch.utils.checkpoint import checkpoint
    L, B, S, _ = h.shape
    key = tp.head_key()
    w = tp.top(params, key)[key]
    if not tp.covered:
        from repro_torch.models.transformer import chunked_xent as xent
        return torch.stack([xent({key: w[i]}, h[i], labels[i], cfg, chunk)
                            for i in range(L)])
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_xent: {S} tokens are not a whole number "
                         f"of chunks of {chunk}")
    x = tp.f(h)
    ws = [_head_rows(w, cfg, tp, i) for i in range(L)]
    labels = labels.long()
    total = torch.zeros(L, dtype=torch.float32, device=h.device)

    def one(hs, ls, *w):
        return _xent_ranks(hs, ls, *w, tp=tp)

    for a in range(0, S, chunk):
        args = (x[:, :, a:a + chunk], labels[:, :, a:a + chunk], *ws)
        total = total + (checkpoint(one, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else one(*args))
    return total / (B * S)


# ============================================================ gradients ====
def _rows_of(g, sh: ModelBlocks) -> list:
    """The model rank of each row of a gradient as the ranks hold it: one
    a local rank for a cut leaf, one a model row otherwise."""
    if sh.cut_axes:
        return [sh.model_of(r) for r in sh.mesh.local_ranks]
    return sh.model_rows()


def _sharer_sum(g, sh: ModelBlocks, comm, axis):
    """Each row's gradient of a shared head block summed over the ranks
    that hold the same heads: scattered into the leaf's whole width,
    psummed over 'model', and read back."""
    rows = _rows_of(g, sh)
    whole = max(sh.stops)
    buf = g.new_zeros(g.shape[0], *[whole if d == sh.dim else n
                                    for d, n in enumerate(g.shape[1:])])
    for i, m in enumerate(rows):
        n = sh.live(m)
        buf[i].narrow(sh.dim, sh.starts[m], n).copy_(
            g[i].narrow(sh.dim, 0, n))
    s = comm.psum(buf, axis)
    out = torch.zeros_like(g)
    for i, m in enumerate(rows):
        n = sh.live(m)
        out[i].narrow(sh.dim, 0, n).copy_(s[i].narrow(sh.dim, sh.starts[m],
                                                      n))
    return out


def _model_comm(sh: ModelBlocks):
    """The communicator of a gradient's rows: the mesh for a cut leaf (a
    row a local rank); for the others on a stacked mesh a model-axis-only
    one (the data ranks share rows)."""
    mesh = sh.mesh
    if isinstance(mesh, StackedComm) and not sh.cut_axes:
        if mesh.axis_names == (sh.axis,):
            return mesh
        return StackedComm(sh.n_model, mesh.device, axis_names=(sh.axis,))
    return mesh


def sync_grads(grads, shardings):
    """A block gradient tree made whole per rank (module docstring):
    q_norm / k_norm psummed over 'model', shared key/value heads over
    their holders; every other leaf as it is."""
    def one(g, sh):
        if not isinstance(sh, ModelBlocks) or sh.reduce is None:
            return g
        comm = _model_comm(sh)
        if sh.reduce == "model":
            return comm.psum(g, sh.axis)
        return _sharer_sum(g, sh, comm, sh.axis)

    from repro_torch.models.params import _zip_tree
    with torch.no_grad():
        return _zip_tree(one, grads, shardings)


def n_holders(sh: ModelBlocks, m: int) -> int:
    """How many model ranks hold model rank m's range of a leaf."""
    if sh.dim is None:
        return sh.n_model
    return sum(1 for a, b in zip(sh.starts, sh.stops)
               if (a, b) == (sh.starts[m], sh.stops[m]))


def grad_sq_sum(grads, shardings) -> torch.Tensor:
    """The squared global norm of a block gradient tree, each element of
    the whole gradient counted once: per local rank, its blocks' squares
    in leaf order, each weighted by 1 / (the ranks of the mesh that hold
    the same elements: the model ranks that hold its range, times the
    data ranks a cut leaf is not cut over or a leaf without a cut is
    whole on), then psummed over every axis of the mesh (a 0-d float32
    tensor)."""
    gl, sl = tree_leaves(grads), tree_leaves(shardings)
    mesh = next(s for s in sl if isinstance(s, ModelBlocks)).mesh
    per = []
    with torch.no_grad():
        for li, r in enumerate(mesh.local_ranks):
            acc = torch.zeros((), dtype=torch.float32, device=gl[0].device)
            for g, sh in zip(gl, sl):
                m = sh.model_of(r)
                i = li if g.shape[0] == len(mesh.local_ranks) else \
                    sh.model_rows().index(m)
                k = n_holders(sh, m) * (mesh.n_ranks // (
                    sh.n_model * sh.n_cut))
                sq = g[i].float().square().sum()
                acc = acc + (sq / k if k > 1 else sq)
            per.append(acc)
        tot = mesh.psum(torch.stack(per), mesh.axis_names)
    return tot[0]
