"""Batched multi-tree schedules: stack every partition's frozen per-tree
tables into `(n_parts, ...)` arrays one device launch can consume.

Host-side NumPy, output-identical to the JAX reference
(`repro.core.engine.schedules`).  Conventions shared by every stacked table:

  - Global cell ids:  cell `c` of partition `p`  ->  `p * n_cells_max + c`;
    multipoles/locals live in one `(P * n_cells_max, nk)` flat array.
  - Global body ids:  sorted body `b` of partition `p` -> `p * n_bodies_max
    + b`; coordinates/charges live in `(P, n_bodies_max, ...)` payload arrays
    (`stack_bodies`) while every index table here stays frozen (and
    therefore uploads to the device exactly once).
  - Empty partitions carry all-zero masks: their rows gather partition 0's
    slot 0 (always in range) and contribute exactly 0.
  - Level schedules are stacked twice: bottom-aligned for the upward pass
    (slot 0 = each tree's deepest level, so M2M runs children-first no matter
    how depths differ) and top-aligned for the downward pass.
  - Grafted-LET indices are translated to *sender-global* ids at build time
    via `LETData.cell_src` / `body_src`: remote M2L/M2P/P2P read the
    sender's device-resident multipoles and bodies directly.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.plan import bucket_size
from repro_torch.resilience import faults as _faults

__all__ = ["BatchedUpwardSchedule", "EngineTables", "build_batched_upward",
           "build_engine_tables", "build_p2p_stream_tables",
           "shape_class_digest", "stack_bodies", "stack_reference_bodies",
           "to_device", "to_numpy"]


def shape_class_digest(tables: dict) -> str:
    """Digest of a flat {name: tensor} table set's *shape class*: every
    entry's name, dtype and shape, never its values.  Two geometries with
    equal digests give the same compiled entry (`engine.fused`), which is
    what lets `exe_cache.ExecutableCache` serve the second one without a
    capture.  Hash the tensors as the entry binds them, so the digest sees
    torch's dtypes (the reference's digest sees JAX's, which turn int64
    into int32 without x64: digests of the two packages do not compare)."""
    h = hashlib.sha1()
    for name in sorted(tables):
        a = tables[name]
        h.update(f"{name}:{str(a.dtype).removeprefix('torch.')}:"
                 f"{tuple(a.shape)};".encode())
    return h.hexdigest()


# ---------------------------------------------------------------- helpers --
def _stack(arrs, shape, dtype, fill=0):
    """Stack ragged per-partition arrays into (P, *shape), padding with
    `fill`; None entries (empty partitions) stay all-fill."""
    out = np.full((len(arrs),) + tuple(shape), fill, dtype=dtype)
    for i, a in enumerate(arrs):
        if a is None:
            continue
        a = np.asarray(a)
        out[i][tuple(slice(0, s) for s in a.shape)] = a
    return out


def _pad_rows(rows: dict, n: int, bucket: int, replicate: bool) -> dict:
    """Pad every array in `rows` from n to `bucket` rows.  `replicate=True`
    repeats row 0 (keeps M2L/M2P displacement vectors nonzero, exactly like
    plan.pad_pairs); masks are always zero-padded."""
    out = {}
    for k, a in rows.items():
        if n == bucket:
            out[k] = a
            continue
        pad = np.repeat(a[:1], bucket - n, axis=0) if (replicate and n) else \
            np.zeros((bucket - n,) + a.shape[1:], dtype=a.dtype)
        out[k] = np.concatenate([a, pad], axis=0)
    if "mask" in out and n < bucket:
        out["mask"] = out["mask"].copy()
        out["mask"][n:] = 0.0
    return out


# ------------------------------------------------------------ dataclasses --
@dataclass(frozen=True)
class BatchedUpwardSchedule:
    """Stacked P2M/M2M index tables for a list of trees (None = empty)."""
    n_parts: int
    n_cells_max: int             # power-of-two cell envelope per partition
    n_bodies_max: int            # power-of-two body envelope per partition
    tables: dict = field(repr=False)   # stacked np arrays, keys below

    # tables: leaves (P,Bl) i64 · leaf_mask (P,Bl) f32 · leaf_centers
    # (P,Bl,3) f32 · leaf_idx (P,Bl,W) i64 · leaf_valid (P,Bl,W) bool ·
    # up_ids/up_parents (P,L,Bv) i64 · up_mask (P,L,Bv) f32 · up_d (P,L,Bv,3)
    # f32 · down_* (same shapes, top-aligned)


@dataclass(frozen=True)
class EngineTables:
    """Every frozen table one geometry needs for batched device evaluation."""
    n: int                       # total bodies, original order
    n_parts: int
    n_cells_max: int
    n_bodies_max: int
    p: int                       # expansion order
    up: BatchedUpwardSchedule
    m2l: dict = field(repr=False)        # src/tgt (B,) i64 global cells ·
                                         # mask (B,) f32 · d (B,3) f32
    m2p: dict = field(repr=False)        # b (B,) i64 global cells · mask f32
                                         # · centers (B,3) f32 · t_idx (B,wt)
                                         # i64 global bodies · t_valid bool
    p2p_buckets: tuple = field(repr=False)  # dicts: t_idx/t_valid/s_idx/
                                         # s_valid/mask, widths per bucket
    l2p_t_idx: np.ndarray = field(repr=False)   # (P,Bl,W) global body ids
    orig_idx: np.ndarray = field(repr=False)    # (N,) original body order
    flat_idx: np.ndarray = field(repr=False)    # (N,) matching flat slots

    def to(self, device) -> "EngineTables":
        """The same tables as tensors on `device` (dtypes kept: int64 ids,
        float32 masks/geometry, bool validity).  Accepts NumPy or tensor
        tables."""
        up = replace(self.up, tables=to_device(self.up.tables, device))
        return replace(self, up=up, m2l=to_device(self.m2l, device),
                       m2p=to_device(self.m2p, device),
                       p2p_buckets=to_device(self.p2p_buckets, device),
                       l2p_t_idx=to_device(self.l2p_t_idx, device),
                       orig_idx=to_device(self.orig_idx, device),
                       flat_idx=to_device(self.flat_idx, device))


def to_device(obj, device):
    """NumPy arrays or tensors (inside dicts/tuples) -> tensors on `device`."""
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(to_device(v, device) for v in obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(obj).to(device)
    return obj


def to_numpy(obj):
    """Tensors (inside dicts/tuples) -> host NumPy arrays."""
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(to_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    return obj


# --------------------------------------------------------------- builders --
def build_batched_upward(trees, scheds) -> BatchedUpwardSchedule:
    """Stack per-tree `TreeSchedules` into one batched upward schedule."""
    P = len(trees)
    live = [(t, s) for t, s in zip(trees, scheds) if t is not None]
    if not live:
        raise ValueError("build_batched_upward: every partition is empty")
    Cmax = bucket_size(max(s.n_cells for _, s in live))
    Nmax = bucket_size(max(len(t.x) for t, _ in live))
    Bl = bucket_size(max(len(s.leaves) for _, s in live))
    W = max(s.leaf_idx.shape[1] for _, s in live)
    Lmax = max((len(s.levels) for _, s in live), default=0)
    Bv = bucket_size(max((len(ls.ids) for _, s in live for ls in s.levels),
                         default=1))

    def per_part(fn):
        return [None if s is None else fn(s) for s in scheds]

    t = {
        "leaves": _stack(per_part(lambda s: s.leaves), (Bl,), np.int64),
        "leaf_mask": _stack(per_part(lambda s: s.leaf_mask), (Bl,), np.float32),
        "leaf_centers": _stack(per_part(lambda s: s.leaf_centers), (Bl, 3),
                               np.float32),
        "leaf_idx": _stack(per_part(lambda s: s.leaf_idx), (Bl, W), np.int64),
        "leaf_valid": _stack(per_part(lambda s: s.leaf_valid), (Bl, W), bool),
    }
    for name, order in (("up", lambda s: tuple(reversed(s.levels))),
                        ("down", lambda s: s.levels)):
        ids = np.zeros((P, Lmax, Bv), np.int64)
        parents = np.zeros((P, Lmax, Bv), np.int64)
        mask = np.zeros((P, Lmax, Bv), np.float32)
        d = np.zeros((P, Lmax, Bv, 3), np.float32)
        for p, s in enumerate(scheds):
            if s is None:
                continue
            for l, ls in enumerate(order(s)):
                k = len(ls.ids)
                ids[p, l, :k] = ls.ids
                parents[p, l, :k] = ls.parents
                mask[p, l, :k] = ls.mask
                d[p, l, :k] = ls.d
        t[f"{name}_ids"], t[f"{name}_parents"] = ids, parents
        t[f"{name}_mask"], t[f"{name}_d"] = mask, d
    return BatchedUpwardSchedule(n_parts=P, n_cells_max=Cmax,
                                 n_bodies_max=Nmax, tables=t)


def stack_bodies(trees, n_bodies_max: int):
    """Stack the (Morton-sorted) bodies of every tree into the payload pair
    `(x_pad (P, Nmax, 3) f32, q_pad (P, Nmax) f32)`.  This is the ONLY array
    pair that changes across within-slack timesteps: one upload refreshes the
    whole geometry's numeric state."""
    P = len(trees)
    x_pad = np.zeros((P, n_bodies_max, 3), np.float32)
    q_pad = np.zeros((P, n_bodies_max), np.float32)
    for p, t in enumerate(trees):
        if t is None:
            continue
        x_pad[p, :len(t.x)] = t.x
        q_pad[p, :len(t.q)] = t.q
    return x_pad, q_pad


def stack_reference_bodies(geo, tables) -> np.ndarray:
    """Stack the geometry's slack-reference positions `x_ref` into the
    payload envelope `(P, Nmax, 3) f32` through the orig->flat gather tables
    (NumPy or tensors).  Built once per engine (x_ref only changes on a
    rebuild, which drops the engine): one leg of the batched step-drift
    revalidation."""
    ref = np.zeros((tables.n_parts * tables.n_bodies_max, 3), np.float32)
    ref[to_numpy(tables.flat_idx)] = geo.x_ref[to_numpy(tables.orig_idx)]
    return ref.reshape(tables.n_parts, tables.n_bodies_max, 3)


def _let_bookkeeping(let):
    if let.cell_src is None or let.body_src is None:
        raise ValueError(
            "engine tables need LET refresh bookkeeping (cell_src/body_src); "
            "this LET was extracted by the reference path")
    return let.cell_src, let.body_src


def build_p2p_stream_tables(p2p_buckets, block_t: int) -> dict | None:
    """Collapse every P2P width-class bucket into ONE unified tile table for
    the streaming kernel (repro_torch.kernels.p2p_stream).

    The gathered path launches one kernel + one gather per width class; the
    streaming kernel instead runs ALL classes as one grid of target tiles,
    reading each tile's source/target slabs from the flat payload inside the
    kernel.  That only works because the bucket gather rows are *contiguous
    runs* of flat body ids (`plan.padded_body_gather` emits
    `body_start + arange`, and LET body translation preserves per-leaf
    runs), so a row reduces to `(start, length)`.  This builder VERIFIES
    that invariant row by row and returns None when any row violates it (the
    engine then falls back to the gathered buckets for that geometry —
    correctness never depends on the fast path).

    Returns a dict of frozen tables (payload-independent):

      meta     (Ti, 4) int32 — per-tile [src_start, src_len, tgt_start,
               tgt_len]; dead padding tiles carry tgt_len == 0 and are
               skipped inside the kernel (no loads, zero output).
      out_idx  (Ti, block_t) int64 — flat output slot per target lane
               (dead lanes point at slot 0).
      out_valid (Ti, block_t) bool — lane < tgt_len.

    plus statics: smax (power-of-two max source width, the slab size),
    block_t, n_tiles (== Ti, padded to a bucket_size envelope),
    n_live_tiles, and pad (payload zero-padding rows so fixed-size slab
    reads never run past the end: max(smax, block_t))."""
    _faults.fire("p2p.stream.tables")
    if not p2p_buckets:
        return None
    metas = []
    smax = 8
    for b in p2p_buckets:
        sv, tv = b["s_valid"], b["t_valid"]
        ws, wt = sv.shape[1], tv.shape[1]
        live = b["mask"] != 0.0
        if not np.all((b["mask"] == 0.0) | (b["mask"] == 1.0)):
            return None              # non-binary mask: gathered path only
        s_len = sv.sum(axis=1).astype(np.int64)
        t_len = tv.sum(axis=1).astype(np.int64)
        col_s = np.arange(ws, dtype=np.int64)
        col_t = np.arange(wt, dtype=np.int64)
        # valid-prefix + contiguous-run invariants (checked on live rows)
        ok = (np.array_equal(sv[live], col_s[None, :] < s_len[live, None])
              and np.array_equal(tv[live], col_t[None, :] < t_len[live, None])
              and np.all(np.where(sv[live],
                                  b["s_idx"][live] - b["s_idx"][live, :1]
                                  == col_s[None, :], True))
              and np.all(np.where(tv[live],
                                  b["t_idx"][live] - b["t_idx"][live, :1]
                                  == col_t[None, :], True)))
        if not ok:
            return None
        smax = max(smax, ws)
        s0 = b["s_idx"][live, 0]
        t0 = b["t_idx"][live, 0]
        sl, tl = s_len[live], t_len[live]
        # tile each row's targets into block_t-lane tiles
        n_t = np.maximum((tl + block_t - 1) // block_t, 1)
        rep = np.repeat(np.arange(len(tl)), n_t)
        k = np.arange(len(rep)) - np.repeat(np.cumsum(n_t) - n_t, n_t)
        metas.append(np.stack([
            s0[rep], sl[rep],
            t0[rep] + k * block_t,
            np.minimum(block_t, tl[rep] - k * block_t)], axis=1))
    meta = (np.concatenate(metas, axis=0) if metas
            else np.zeros((0, 4), np.int64))
    meta = meta[meta[:, 3] > 0]      # rows with zero targets contribute 0
    n_live = len(meta)
    if n_live == 0:
        return None
    ti = bucket_size(n_live)
    meta = np.concatenate(
        [meta, np.zeros((ti - n_live, 4), np.int64)], axis=0)
    if int(meta.max()) + max(smax, block_t) >= np.iinfo(np.int32).max:
        return None                  # flat ids must survive int32 meta
    lane = np.arange(block_t, dtype=np.int64)
    out_valid = lane[None, :] < meta[:, 3:4]
    out_idx = np.where(out_valid, meta[:, 2:3] + lane[None, :], 0)
    return {"meta": meta.astype(np.int32), "out_idx": out_idx,
            "out_valid": out_valid, "smax": int(smax),
            "block_t": int(block_t), "n_tiles": int(ti),
            "n_live_tiles": int(n_live),
            "pad": int(max(smax, block_t))}


def build_engine_tables(geo) -> EngineTables:
    """Freeze every stacked table for one GeometryPlan.

    Payload-independent: only index structure, masks and build-time expansion
    centers/displacements are captured, so within-slack timesteps reuse the
    tables (and their device uploads) unchanged."""
    up = build_batched_upward(geo.trees, geo.scheds)
    P, Cmax, Nmax = up.n_parts, up.n_cells_max, up.n_bodies_max

    m2l_rows = {"src": [], "tgt": [], "mask": [], "d": []}
    m2p_rows = {"b": [], "mask": [], "centers": [], "t_idx": [], "t_valid": []}
    bucket_rows: dict = {}       # (wt, ws) -> row lists

    def add_m2l(inter, tgt_off, src_map):
        n = inter.n_m2l
        if n == 0:
            return
        m2l_rows["tgt"].append(tgt_off + inter.m2l_a[:n])
        m2l_rows["src"].append(src_map(inter.m2l_b[:n]))
        m2l_rows["mask"].append(inter.m2l_mask[:n])
        m2l_rows["d"].append(inter.m2l_d[:n])

    def add_m2p(inter, body_off, src_map):
        n = inter.n_m2p
        if n == 0:
            return
        m2p_rows["b"].append(src_map(inter.m2p_b[:n]))
        m2p_rows["mask"].append(inter.m2p_mask[:n])
        m2p_rows["centers"].append(inter.m2p_centers[:n])
        m2p_rows["t_idx"].append(body_off + inter.m2p_t_idx[:n])
        m2p_rows["t_valid"].append(inter.m2p_t_valid[:n])

    def add_p2p(inter, tgt_body_off, body_map):
        for blk in inter.p2p_blocks:
            n = blk.n
            key = (blk.t_idx.shape[1], blk.s_idx.shape[1])
            rows = bucket_rows.setdefault(
                key, {"t_idx": [], "t_valid": [], "s_idx": [], "s_valid": [],
                      "mask": []})
            rows["t_idx"].append(tgt_body_off + blk.t_idx[:n])
            rows["t_valid"].append(blk.t_valid[:n])
            rows["s_idx"].append(body_map(blk.s_idx[:n], blk.s_valid[:n]))
            rows["s_valid"].append(blk.s_valid[:n])
            rows["mask"].append(blk.mask[:n])

    for j, r in enumerate(geo.receivers):
        if r is None:
            continue
        coff, boff = j * Cmax, j * Nmax
        add_m2l(r.local, coff, lambda b, o=coff: o + b)
        add_p2p(r.local, boff, lambda s, v, o=boff: o + s)
        for rb in r.remote:
            cell_src, body_src = _let_bookkeeping(geo.lets[(rb.sender, j)])
            soff_c, soff_b = rb.sender * Cmax, rb.sender * Nmax
            add_m2l(rb.inter, coff,
                    lambda b, cs=cell_src, o=soff_c: o + cs[b])
            add_m2p(rb.inter, boff,
                    lambda b, cs=cell_src, o=soff_c: o + cs[b])
            # clipped-safe: invalid source slots stay at a masked in-range 0
            add_p2p(rb.inter, boff,
                    lambda s, v, bs=body_src, o=soff_b:
                    np.where(v, o + bs[np.where(v, s, 0)], 0))

    def cat(rows):
        return {k: np.concatenate(v, axis=0) for k, v in rows.items()}

    if m2l_rows["src"]:
        m2l = cat(m2l_rows)
        n = len(m2l["src"])
        m2l = _pad_rows(m2l, n, bucket_size(n), replicate=True)
    else:
        m2l = {"src": np.zeros(0, np.int64), "tgt": np.zeros(0, np.int64),
               "mask": np.zeros(0, np.float32), "d": np.zeros((0, 3), np.float32)}
    if m2p_rows["b"]:
        m2p = cat(m2p_rows)
        n = len(m2p["b"])
        m2p = _pad_rows(m2p, n, bucket_size(n), replicate=True)
    else:
        wt = up.tables["leaf_idx"].shape[2]
        m2p = {"b": np.zeros(0, np.int64), "mask": np.zeros(0, np.float32),
               "centers": np.zeros((0, 3), np.float32),
               "t_idx": np.zeros((0, wt), np.int64),
               "t_valid": np.zeros((0, wt), bool)}
    buckets = []
    for (wt, ws) in sorted(bucket_rows):
        b = cat(bucket_rows[(wt, ws)])
        n = len(b["mask"])
        # zero-padding is safe for P2P (r == 0 guard), no replication needed
        buckets.append(_pad_rows(b, n, bucket_size(n), replicate=False))

    l2p_t_idx = (up.tables["leaf_idx"]
                 + (np.arange(P, dtype=np.int64) * Nmax)[:, None, None])
    orig_chunks, flat_chunks = [], []
    for j, t in enumerate(geo.trees):
        if t is None:
            continue
        orig_chunks.append(geo.owners[j][t.perm])
        flat_chunks.append(j * Nmax + np.arange(len(t.x), dtype=np.int64))
    return EngineTables(
        n=geo.n, n_parts=P, n_cells_max=Cmax, n_bodies_max=Nmax, p=geo.p,
        up=up, m2l=m2l, m2p=m2p, p2p_buckets=tuple(buckets),
        l2p_t_idx=l2p_t_idx,
        orig_idx=np.concatenate(orig_chunks),
        flat_idx=np.concatenate(flat_chunks))
