"""ShardedEngine: the batched FMM engine over the ranks of a mesh.

The port of `repro.core.dist.engine`.  Partitions are grouped into
contiguous blocks of `nparts / n_ranks` per rank; every stacked `(n_parts,
...)` envelope of the single-device engine is split on its leading axis, so
each rank runs the SAME phase functions the `DeviceEngine` runs, on its own
partitions only, with the exchange wedged between the upward pass and the
far field.  The reference's `shard_map` rank function holds its collectives
inside; here a rank program runs in three steps over every rank the mesh
(`dist.comm`) holds in this process:

  1. pack     : `engine.upward.batched_upward_kernel` on the rank's
                (P_r, ...) slice, then gather the dynamic words (multipoles,
                bodies) of every LET span the rank originates into its pool
                (`dist.layout`);
  2. exchange : one protocol's program (`dist.programs.apply_exchange`):
                bulk all_to_all, grain-chunked ppermute rounds, or the HSDX
                relay tree;
  3. compute  : M2L / M2P / P2P over `[local | halo]` sources (the received
                halo rows appended after the rank's own cells and bodies),
                the downward sweep and L2P (`engine.m2l.far_tail_kernel`),
                one K1 launch per P2P width-class bucket
                (`kernels.p2p.p2p(qs, xs, xt) * mask`, targets gathered from
                the rank's own bodies, sources from `[x | x_halo]`), and
                the rank's float64 potential (`engine.fused.accumulate_flat`).

On the card the near field is K1; on the CPU the wrapper runs its plain
version, which is `fmm._p2p_vals`.  The ranks' float64 potentials are
all-gathered, so every process returns the full (N,) potential, and only
that moves to the host.  Each rank's accumulation order is the reference's
host accumulation order for its bodies (L2P, the buckets, M2P).

The compute tables differ from `engine.schedules.build_engine_tables` only
in id spaces: targets are rank-local (`j_local * Cmax + c`), co-resident
senders stay direct reads, and off-rank senders index the halo block.  They
are NumPy, exactly the reference's.  Everything crossing the wire is
float32 words of the frozen LET format, so the bytes each collective
carries are exactly `GeometryPlan.bytes_matrix` aggregated to rank
granularity, checked when a program is built.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.dist import programs as prog_mod
from repro_torch.core.dist.layout import build_wire_layout, build_wire_tables
from repro_torch.core.engine.fused import accumulate_flat
from repro_torch.core.engine.m2l import far_tail_kernel, m2p_vals_kernel
from repro_torch.core.engine.schedules import (build_batched_upward,
                                               stack_bodies)
from repro_torch.core.engine.upward import batched_upward_kernel
from repro_torch.core.multipole import get_operators
from repro_torch.kernels.p2p import p2p
from repro_torch.resilience.fallback import ExchangeVerificationError

__all__ = ["ShardedEngine", "ExchangeVerificationError"]

# padded-row fills that keep every masked lane finite: a zero displacement /
# coincident target-center pair would send the kernel's 1/r derivatives to
# inf, and inf * 0-mask is NaN
_SAFE_D = np.array([1.0, 0.0, 0.0], np.float32)
_FAR_CENTER = np.array([1e6, 1e6, 1e6], np.float32)

_UP_KEYS = ("leaves", "leaf_mask", "leaf_centers", "leaf_idx", "leaf_valid",
            "up_ids", "up_parents", "up_mask", "up_d", "down_ids",
            "down_parents", "down_mask", "down_d")
_MESH_ATTRS = ("n_ranks", "local_ranks", "device", "all_to_all", "ppermute",
               "all_gather")


def _pad_rank_rows(rows: dict, cap: int, fills: dict) -> dict:
    out = {}
    n = len(next(iter(rows.values()))) if rows else 0
    for k, a in rows.items():
        if n == cap:
            out[k] = a
            continue
        pad = np.broadcast_to(fills[k], (cap - n,) + a.shape[1:]).astype(
            a.dtype)
        out[k] = np.concatenate([a, pad], axis=0) if n else pad.copy()
    return out


def _sync(device: torch.device) -> None:
    """Wait for the device (not while a stream captures a CUDA graph, where
    a synchronize would invalidate the capture)."""
    if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        torch.cuda.synchronize(device)


class ShardedEngine:
    """Evaluation of one `GeometryPlan` over the ranks of a mesh.

    Parameters
    ----------
    geometry : api.GeometryPlan (nparts must divide evenly over the mesh)
    mesh : a `dist.comm` communicator (`launch.mesh.stacked_mesh(n)` or
        `launch.mesh.group_mesh()`); the engine runs on its device.
    grain_bytes : chunk size of the "grain" protocol's ppermute rounds;
        default the LogGP eager limit (the granularity the paper tunes
        around, Fig 6).
    """

    def __init__(self, geometry, mesh, *, grain_bytes: int | None = None):
        missing = [a for a in _MESH_ATTRS if not hasattr(mesh, a)]
        if missing:
            raise TypeError(f"mesh: expected a dist.comm communicator "
                            f"(launch.mesh.stacked_mesh / group_mesh), got "
                            f"{type(mesh).__name__} without {missing}")
        self.geo = geometry
        self.mesh = mesh
        self.device = torch.device(mesh.device)
        self.n_ranks = int(mesh.n_ranks)
        self.grain_bytes = grain_bytes
        self._ops = get_operators(geometry.p, self.device)

        up = build_batched_upward(geometry.trees, geometry.scheds)
        self.up = up
        Cmax, Nmax = up.n_cells_max, up.n_bodies_max
        self.layout = build_wire_layout(geometry, self.n_ranks)
        self.wire = build_wire_tables(geometry, self.layout,
                                      n_cells_max=Cmax, n_bodies_max=Nmax,
                                      nk=self._ops.nk)
        self._build_compute_tables()
        self._x_pad, self._q_pad = stack_bodies(geometry.trees, Nmax)
        self._ranks = [int(r) for r in mesh.local_ranks]
        self._upload()
        self._programs: dict = {}
        self._round_tabs: dict = {}
        self._ex_fns: dict = {}

    # ------------------------------------------------------------- tables --
    def _build_compute_tables(self) -> None:
        geo, up = self.geo, self.up
        lay, wire = self.layout, self.wire
        D, ppr = lay.n_ranks, lay.parts_per_rank
        P, Cmax, Nmax = up.n_parts, up.n_cells_max, up.n_bodies_max

        m2l_rk = [{"src": [], "tgt": [], "mask": [], "d": []}
                  for _ in range(D)]
        m2p_rk = [{"b": [], "mask": [], "centers": [], "t_idx": [],
                   "t_valid": []} for _ in range(D)]
        buckets_rk: list = [dict() for _ in range(D)]

        def add_m2l(r, inter, tgt_off, src_map):
            n = inter.n_m2l
            if n:
                m2l_rk[r]["tgt"].append(tgt_off + inter.m2l_a[:n])
                m2l_rk[r]["src"].append(src_map(inter.m2l_b[:n]))
                m2l_rk[r]["mask"].append(inter.m2l_mask[:n])
                m2l_rk[r]["d"].append(inter.m2l_d[:n])

        def add_m2p(r, inter, body_off, src_map):
            n = inter.n_m2p
            if n:
                m2p_rk[r]["b"].append(src_map(inter.m2p_b[:n]))
                m2p_rk[r]["mask"].append(inter.m2p_mask[:n])
                m2p_rk[r]["centers"].append(inter.m2p_centers[:n])
                m2p_rk[r]["t_idx"].append(body_off + inter.m2p_t_idx[:n])
                m2p_rk[r]["t_valid"].append(inter.m2p_t_valid[:n])

        def add_p2p(r, inter, tgt_off, s_map):
            for blk in inter.p2p_blocks:
                n = blk.n
                key = (blk.t_idx.shape[1], blk.s_idx.shape[1])
                rows = buckets_rk[r].setdefault(
                    key, {"t_idx": [], "t_valid": [], "s_idx": [],
                          "s_valid": [], "mask": []})
                rows["t_idx"].append(tgt_off + blk.t_idx[:n])
                rows["t_valid"].append(blk.t_valid[:n])
                rows["s_idx"].append(s_map(blk.s_idx[:n], blk.s_valid[:n]))
                rows["s_valid"].append(blk.s_valid[:n])
                rows["mask"].append(blk.mask[:n])

        for j, recv in enumerate(geo.receivers):
            if recv is None:
                continue
            r, jl = j // ppr, j % ppr
            coff, boff = jl * Cmax, jl * Nmax
            add_m2l(r, recv.local, coff, lambda b, o=coff: o + b)
            add_p2p(r, recv.local, boff, lambda s, v, o=boff: o + s)
            for rb in recv.remote:
                i = rb.sender
                let = geo.lets[(i, j)]
                if lay.part_rank[i] == r:
                    # co-resident sender: read its device cells/bodies
                    # directly, exactly like the single-device engine
                    cs, bs = let.cell_src, let.body_src
                    soff_c = (i % ppr) * Cmax
                    soff_b = (i % ppr) * Nmax
                    add_m2l(r, rb.inter, coff,
                            lambda b, cs=cs, o=soff_c: o + cs[b])
                    add_m2p(r, rb.inter, boff,
                            lambda b, cs=cs, o=soff_c: o + cs[b])
                    add_p2p(r, rb.inter, boff,
                            lambda s, v, bs=bs, o=soff_b:
                            np.where(v, o + bs[np.where(v, s, 0)], 0))
                else:
                    # off-rank sender: graft-local ids index the received
                    # halo rows appended after this rank's own block
                    hco = ppr * Cmax + wire.halo_cell_off[(i, j)]
                    hbo = ppr * Nmax + wire.halo_body_off[(i, j)]
                    add_m2l(r, rb.inter, coff, lambda b, o=hco: o + b)
                    add_m2p(r, rb.inter, boff, lambda b, o=hco: o + b)
                    add_p2p(r, rb.inter, boff,
                            lambda s, v, o=hbo: np.where(v, o + s, 0))

        def cat(rows):
            return {k: np.concatenate(v, axis=0) for k, v in rows.items()}

        # ---- m2l: (D, Bm) stacked, NaN-safe padded ------------------------
        m2l_cat = [cat(r) if r["src"] else None for r in m2l_rk]
        m2l_cap = max((len(r["src"]) for r in m2l_cat if r), default=0)
        m2l_fill = {"src": np.int64(0), "tgt": np.int64(0),
                    "mask": np.float32(0.0), "d": _SAFE_D}
        m2l_stk = {k: [] for k in m2l_fill}
        for r in range(D):
            rows = _pad_rank_rows(m2l_cat[r] or {
                "src": np.zeros(0, np.int64), "tgt": np.zeros(0, np.int64),
                "mask": np.zeros(0, np.float32),
                "d": np.zeros((0, 3), np.float32)}, m2l_cap, m2l_fill)
            for k in m2l_stk:
                m2l_stk[k].append(rows[k])
        self.m2l = {k: np.stack(v) for k, v in m2l_stk.items()} \
            if m2l_cap else None

        # ---- m2p: (D, Bf, ...) ------------------------------------------
        wt = up.tables["leaf_idx"].shape[2]
        m2p_cat = [cat(r) if r["b"] else None for r in m2p_rk]
        m2p_cap = max((len(r["b"]) for r in m2p_cat if r), default=0)
        m2p_fill = {"b": np.int64(0), "mask": np.float32(0.0),
                    "centers": _FAR_CENTER, "t_idx": np.int64(0),
                    "t_valid": np.False_}
        m2p_stk = {k: [] for k in m2p_fill}
        for r in range(D):
            rows = _pad_rank_rows(m2p_cat[r] or {
                "b": np.zeros(0, np.int64), "mask": np.zeros(0, np.float32),
                "centers": np.zeros((0, 3), np.float32),
                "t_idx": np.zeros((0, wt), np.int64),
                "t_valid": np.zeros((0, wt), bool)}, m2p_cap, m2p_fill)
            for k in m2p_stk:
                m2p_stk[k].append(rows[k])
        self.m2p = {k: np.stack(v) for k, v in m2p_stk.items()} \
            if m2p_cap else None

        # ---- p2p: globally sorted width classes, rows padded per rank ----
        keys = sorted({k for br in buckets_rk for k in br})
        self.p2p_buckets = []
        for key in keys:
            wt_b, ws_b = key
            fill = {"t_idx": np.int64(0), "t_valid": np.False_,
                    "s_idx": np.int64(0), "s_valid": np.False_,
                    "mask": np.float32(0.0)}
            empty = {"t_idx": np.zeros((0, wt_b), np.int64),
                     "t_valid": np.zeros((0, wt_b), bool),
                     "s_idx": np.zeros((0, ws_b), np.int64),
                     "s_valid": np.zeros((0, ws_b), bool),
                     "mask": np.zeros(0, np.float32)}
            per_rank = [cat(buckets_rk[r][key]) if key in buckets_rk[r]
                        else empty for r in range(D)]
            cap = max(len(p["mask"]) for p in per_rank)
            stk = {k: np.stack([_pad_rank_rows(p, cap, fill)[k]
                                for p in per_rank]) for k in fill}
            self.p2p_buckets.append(stk)

        # ---- accumulation indices (global flat body ids) ------------------
        self._l2p_idx = (up.tables["leaf_idx"]
                         + (np.arange(P, dtype=np.int64)
                            * Nmax)[:, None, None])
        self._l2p_valid = up.tables["leaf_valid"]
        rank_body_off = (np.arange(D, dtype=np.int64)
                         * ppr * Nmax)[:, None, None]
        self._bucket_gidx = [b["t_idx"] + rank_body_off
                             for b in self.p2p_buckets]
        self._m2p_gidx = (self.m2p["t_idx"] + rank_body_off
                          if self.m2p is not None else None)
        orig_chunks, flat_chunks = [], []
        for j, t in enumerate(geo.trees):
            if t is None:
                continue
            orig_chunks.append(geo.owners[j][t.perm])
            flat_chunks.append(j * Nmax + np.arange(len(t.x), dtype=np.int64))
        self._orig_idx = np.concatenate(orig_chunks)
        self._flat_idx = np.concatenate(flat_chunks)

        # ---- every rank's inputs, stacked on the (D,) rank axis ----------
        ut = up.tables
        self._part_tabs = {k: ut[k] for k in _UP_KEYS}
        rt = {"pool_template": wire.pool_template,
              "pack_src": wire.pack_src, "pack_dst": wire.pack_dst,
              "halo_M_idx": wire.halo_M_idx, "halo_x_idx": wire.halo_x_idx,
              "halo_q_idx": wire.halo_q_idx}
        if self.m2l is not None:
            for k, v in self.m2l.items():
                rt[f"m2l_{k}"] = v
        if self.m2p is not None:
            for k, v in self.m2p.items():
                rt[f"m2p_{k}"] = v
        for bi, b in enumerate(self.p2p_buckets):
            for k, v in b.items():
                rt[f"pb{bi}_{k}"] = v
        self._rank_tabs = rt

    def _upload(self) -> None:
        """The tables and payload of this process's ranks on the device,
        each stacked (L, ...) in `mesh.local_ranks` order; index tables as
        int64."""
        D, ppr = self.layout.n_ranks, self.layout.parts_per_rank
        Nmax = self.up.n_bodies_max
        ranks, dev = self._ranks, self.device

        def put(a):
            t = torch.as_tensor(np.ascontiguousarray(a[ranks]))
            if t.dtype == torch.int32:
                t = t.long()
            return t.to(dev)

        def by_rank(a):          # (P, ...) -> (D, ppr, ...)
            return a.reshape((D, ppr) + a.shape[1:])

        self._pt = {k: put(by_rank(v)) for k, v in self._part_tabs.items()}
        self._rt = {k: put(v) for k, v in self._rank_tabs.items()}
        r_off = (np.asarray(ranks, np.int64) * ppr * Nmax)[:, None, None,
                                                           None]
        self._l2p_loc = torch.as_tensor(
            by_rank(self._l2p_idx)[ranks] - r_off, device=dev)
        self._l2p_loc_valid = put(by_rank(self._l2p_valid))
        self._orig_t = torch.as_tensor(self._orig_idx, device=dev)
        self._flat_t = torch.as_tensor(self._flat_idx, device=dev)
        self._set_payload()

    def _set_payload(self) -> None:
        D, ppr = self.layout.n_ranks, self.layout.parts_per_rank
        self.x = torch.as_tensor(self._x_pad.reshape(
            (D, ppr) + self._x_pad.shape[1:])[self._ranks]).to(self.device)
        self.q = torch.as_tensor(self._q_pad.reshape(
            (D, ppr) + self._q_pad.shape[1:])[self._ranks]).to(self.device)

    # ----------------------------------------------------------- programs --
    def program(self, protocol: str) -> prog_mod.ExchangeProgram:
        if protocol not in self._programs:
            with obs.span("dist.build_program"):
                self._programs[protocol] = prog_mod.build_exchange_program(
                    self.layout, protocol, grain_bytes=self.grain_bytes)
        return self._programs[protocol]

    def exchange_stats(self, protocol: str) -> dict:
        """Wire accounting of one protocol's program plus the LogGP
        prediction for the schedule it executes."""
        p = self.program(protocol)
        s = p.stats()
        s["loggp_time"] = prog_mod.predicted_time(p)
        s["rank_bytes"] = self.layout.rank_bytes.tolist()
        return s

    def _rounds(self, program: prog_mod.ExchangeProgram,
                cache: bool = True) -> list:
        """The program's round tables of this process's ranks on the device
        (int64), cached per protocol while `program(protocol)` is this
        object."""
        hit = self._round_tabs.get(program.protocol)
        if hit is not None and hit[0] is program:
            return hit[1]
        ranks = self._ranks
        tabs = [{"send": torch.as_tensor(r.send_idx[ranks],
                                         device=self.device),
                 "recv": torch.as_tensor(r.recv_idx[ranks],
                                         device=self.device)}
                for r in program.rounds]
        if cache:
            self._round_tabs[program.protocol] = (program, tabs)
        return tabs

    # ------------------------------------------------------- rank steps --
    def _rank_part_tabs(self, l: int) -> dict:
        return {k: v[l] for k, v in self._pt.items()}

    def _pack(self) -> tuple:
        """Step 1 for every local rank: the upward pass and the rank's
        originated words packed into its pool.  Returns (pools (L, W + 1)
        float32, [M_flat (ppr * Cmax, nk) per rank])."""
        ppr = self.layout.parts_per_rank
        Cmax, nk = self.up.n_cells_max, self._ops.nk
        pools = self._rt["pool_template"].clone()
        Ms = []
        for l in range(len(self._ranks)):
            x, q = self.x[l], self.q[l]
            M = batched_upward_kernel(self._ops, x, q,
                                      self._rank_part_tabs(l), Cmax)
            M_flat = M.reshape(ppr * Cmax, nk)
            src = torch.cat([M_flat.reshape(-1), x.reshape(-1),
                             q.reshape(-1)])
            pools[l, self._rt["pack_dst"][l]] = src[self._rt["pack_src"][l]]
            Ms.append(M_flat)
        return pools, Ms

    def _halo(self, l: int, pool) -> tuple:
        """Local rank l's bodies followed by its received halo bodies:
        (x_src (ppr * Nmax + HB, 3), q_src (ppr * Nmax + HB,))."""
        rt = self._rt
        x_src = torch.cat([self.x[l].reshape(-1, 3),
                           pool[rt["halo_x_idx"][l]]])
        q_src = torch.cat([self.q[l].reshape(-1), pool[rt["halo_q_idx"][l]]])
        return x_src, q_src

    def _bucket_operands(self, l: int, bi: int, x_src, q_src) -> tuple:
        """K1's operands of local rank l's bucket bi: charges (masked by
        s_valid) and sources gathered from [x | x_halo], targets from the
        rank's own bodies -> (qs (B, S), xs (B, S, 3), xt (B, T, 3))."""
        rt = self._rt
        s_idx = rt[f"pb{bi}_s_idx"][l]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        qs = torch.where(rt[f"pb{bi}_s_valid"][l], q_src[s_idx], zero)
        return qs, x_src[s_idx], self.x[l].reshape(-1, 3)[
            rt[f"pb{bi}_t_idx"][l]]

    def near_field_operands(self, protocol: str = "bulk"):
        """Yield (rank, bucket index, qs, xs, xt) of every K1 launch an
        evaluation makes, gathered after a real exchange of `protocol`:
        what a caller holds K1 to its plain version on."""
        program = self.program(protocol)
        pools, _ = self._pack()
        pools = prog_mod.apply_exchange(pools, program,
                                        self._rounds(program), self.mesh)
        for l, r in enumerate(self._ranks):
            x_src, q_src = self._halo(l, pools[l])
            for bi in range(len(self.p2p_buckets)):
                yield (r, bi, *self._bucket_operands(l, bi, x_src, q_src))

    def _compute(self, l: int, M_flat, pool) -> torch.Tensor:
        """Step 3 for local rank l: far field, near field and M2P over
        [local | halo] sources -> the rank's (ppr * Nmax,) float64 flat
        potential."""
        rt, ops = self._rt, self._ops
        ppr = self.layout.parts_per_rank
        Cmax, Nmax, nk = self.up.n_cells_max, self.up.n_bodies_max, ops.nk
        x = self.x[l]
        M_src = torch.cat([M_flat, pool[rt["halo_M_idx"][l]]])
        x_src, q_src = self._halo(l, pool)
        M = M_flat.reshape(ppr, Cmax, nk)
        pt = self._rank_part_tabs(l)

        if self.m2l is not None:
            m2l = {k: rt[f"m2l_{k}"][l] for k in ("src", "tgt", "mask", "d")}
        else:
            m2l = {"src": torch.zeros(0, dtype=torch.int64,
                                      device=self.device)}
        parts = [(self._l2p_loc[l], self._l2p_loc_valid[l],
                  far_tail_kernel(ops, M, x, m2l, pt, M_src=M_src))]
        for bi in range(len(self.p2p_buckets)):
            qs, xs, xt = self._bucket_operands(l, bi, x_src, q_src)
            vals = p2p(qs, xs, xt) * rt[f"pb{bi}_mask"][l][:, None]
            parts.append((rt[f"pb{bi}_t_idx"][l], rt[f"pb{bi}_t_valid"][l],
                          vals))
        if self.m2p is not None:
            vals = m2p_vals_kernel(ops, M, x, rt["m2p_b"][l],
                                   rt["m2p_centers"][l], rt["m2p_mask"][l],
                                   rt["m2p_t_idx"][l], M_src=M_src)
            parts.append((rt["m2p_t_idx"][l], rt["m2p_t_valid"][l], vals))
        return accumulate_flat(parts, ppr * Nmax, self.device)

    # ----------------------------------------------------------- evaluate --
    def evaluate(self, protocol: str = "bulk") -> np.ndarray:
        """Full potential in original body order (float64, host): pack,
        exchange and compute on every rank this process holds, the ranks'
        float64 potentials all-gathered over the mesh."""
        with obs.span("dist.evaluate") as sp:
            program = self.program(protocol)
            pools, Ms = self._pack()
            pools = prog_mod.apply_exchange(pools, program,
                                            self._rounds(program), self.mesh)
            phis = torch.stack([self._compute(l, Ms[l], pools[l])
                                for l in range(len(self._ranks))])
            phi_flat = sp.fence(self.mesh.all_gather(phis).reshape(-1))
            obs.counter_add("dist.evaluations")
            if obs.enabled():
                sp.set({"protocol": protocol, "n_ranks": self.n_ranks})
        phi = torch.zeros(self.geo.n, dtype=torch.float64,
                          device=self.device)
        phi[self._orig_t] = phi_flat[self._flat_t]
        return phi.cpu().numpy()

    def refresh_payload(self, geometry) -> None:
        """Rebind to a same-structure geometry (a within-slack step): restack
        and upload the (x, q) payload only.  Multipoles and LET payloads are
        recomputed on the device from it each evaluation, so no host-side
        multipole or LET refresh is needed here."""
        self.geo = geometry
        self._x_pad, self._q_pad = stack_bodies(geometry.trees,
                                                self.up.n_bodies_max)
        self._set_payload()

    # ------------------------------------------------------- verification --
    def exchange_pools(self, protocol: str = "bulk") -> tuple:
        """Pack (the real upward-pass payload) and exchange only, returning
        every rank's pool before and after the exchange as host arrays
        (D, W + 1), all-gathered over the mesh."""
        program = self.program(protocol)
        packed, _ = self._pack()
        exchanged = prog_mod.apply_exchange(packed, program,
                                            self._rounds(program), self.mesh)
        return (self.mesh.all_gather(packed).cpu().numpy(),
                self.mesh.all_gather(exchanged).cpu().numpy())

    def verify_exchange(self, protocol: str = "bulk") -> int:
        """Audit one protocol's wire: check word-exact on the host that each
        inter-rank span landed at its receiver unchanged,
        `packed[rank(i), off:off+w] == exchanged[rank(j), off:off+w]` for
        every layout pair (i, j).  Raises `ExchangeVerificationError` on the
        first corrupted span; returns the number of verified spans.  A
        session runs it once per (protocol, geometry version) under
        `REPRO_VERIFY_EXCHANGE=1`."""
        with obs.span("dist.verify_exchange"):
            packed, exchanged = self.exchange_pools(protocol)
        lay = self.layout
        for (i, j) in lay.pairs:
            off, w = lay.span_off[(i, j)], lay.span_words[(i, j)]
            ri, rj = int(lay.part_rank[i]), int(lay.part_rank[j])
            sent = packed[ri, off:off + w]
            got = exchanged[rj, off:off + w]
            if not np.array_equal(sent, got):
                nbad = int((sent != got).sum())
                raise ExchangeVerificationError(
                    "dist.exchange.verify",
                    f"protocol {protocol!r}: span ({i}, {j}) "
                    f"[rank {ri} -> rank {rj}, {w} words @ {off}] arrived "
                    f"corrupted: {nbad} mismatched words")
        obs.counter_add("dist.exchange.verified")
        return len(lay.pairs)

    # ---------------------------------------------------------- benchmark --
    def _build_exchange_fn(self, program: prog_mod.ExchangeProgram,
                           cache: bool = True):
        """`fn()` running ONLY the exchange (no FMM phases, the pool
        templates as payload) of an arbitrary program, including the
        single-round sub-programs `measure_exchange(per_round=True)` times;
        returns the (L,) per-rank pool sums on the device."""
        tabs = self._rounds(program, cache)
        template = self._rt["pool_template"]
        mesh = self.mesh

        def fn():
            return prog_mod.apply_exchange(template, program, tabs,
                                           mesh).sum(dim=1)
        return fn

    def exchange_fn(self, protocol: str):
        """Memoized `_build_exchange_fn` for one protocol's full program."""
        if protocol not in self._ex_fns:
            self._ex_fns[protocol] = self._build_exchange_fn(
                self.program(protocol))
        return self._ex_fns[protocol]

    def _time(self, fn, reps: int) -> float:
        fn()                                  # warm: tables, allocator
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(self.device)
        return (time.perf_counter() - t0) / reps

    def measure_exchange(self, protocol: str, *, reps: int = 3,
                         per_round: bool = False) -> dict:
        """Time one protocol's exchange-only program (host clock, the device
        synchronized) beside its LogGP prediction: `measured_s`, `loggp_s`
        and `model_drift` = measured_s / loggp_s, plus the program's
        `stats()` and a per-round breakdown (kind, wire bytes, and with
        `per_round=True` each round timed as its own sub-program).  On a
        stacked mesh the rounds are copies within one device's memory, not
        a network: there the ratio is not the model's drift on a wire."""
        p = self.program(protocol)
        measured = self._time(self.exchange_fn(protocol), reps)
        loggp = prog_mod.predicted_time(p)
        drift = measured / loggp if loggp > 0 else float("inf")
        rounds = [{"kind": r.kind, "wire_bytes": 4 * r.wire_words}
                  for r in p.rounds]
        if per_round:
            for k, rec in enumerate(rounds):
                sub = dataclasses.replace(p, rounds=(p.rounds[k],))
                rec["measured_s"] = self._time(
                    self._build_exchange_fn(sub, cache=False), reps)
        st = p.stats()
        st.update(measured_s=measured, loggp_s=loggp, model_drift=drift,
                  reps=reps, rounds=rounds,
                  rank_bytes=self.layout.rank_bytes.tolist())
        obs.observe(f"dist.model_drift.{protocol}", drift)
        if obs.enabled():
            obs.event("dist.exchange_probe",
                      {"protocol": protocol, "measured_s": measured,
                       "loggp_s": loggp, "model_drift": drift,
                       "moved_bytes": int(p.moved_bytes.sum()),
                       "n_rounds": p.n_rounds})
        return st
