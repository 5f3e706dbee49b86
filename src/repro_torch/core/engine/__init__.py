"""Device evaluation engine: batched multi-tree FMM execution.

The port of `repro.core.engine` on its per-phase route.  A `DeviceEngine`
holds one geometry's stacked tables (`schedules.build_engine_tables`,
uploaded once) and the stacked (x, q) payload on its device; `evaluate()`
then runs

  1. the batched upward pass (`upward.batched_upward_kernel`): P2M + M2M for
     all partitions at once;
  2. the far field (`m2l.far_tail_kernel`): the segment-summed M2L over
     every (receiver, sender) pair, the stacked downward sweep, and L2P;
  3. the near field: one K1 launch per P2P width-class bucket
     (`p2p.p2p_bucket_vals`), or with `p2p_stream=True` one K2 launch over
     the unified tile table (`p2p.p2p_stream_vals`);
  4. the batched M2P fallback (`m2l.m2p_vals_kernel`);

and accumulates every phase's float32 values into the potential in float64
on the device with `index_add_`.  Only the final (N,) potential moves to the
host.  Each phase is a public method, so a caller can time them one by one.

Timesteps: the index tables do not depend on the payload, so a
within-slack `FMMSession.step` revalidates with `step_drift` (one `new_x`
upload, restacked on the device, every partition's drift in one pass) and
rebinds with `refresh_payload`; the multipoles are cached per payload and
recomputed by the next evaluation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.m2l import far_tail_kernel, m2p_vals_kernel
from repro_torch.core.engine.p2p import p2p_bucket_vals, p2p_stream_vals
from repro_torch.core.engine.schedules import (EngineTables,
                                               build_engine_tables,
                                               build_p2p_stream_tables,
                                               stack_bodies,
                                               stack_reference_bodies,
                                               to_device, to_numpy)
from repro_torch.core.engine.traversal import (partition_drift,
                                               restack_payload)
from repro_torch.core.engine.upward import batched_upward_kernel
from repro_torch.core.multipole import get_operators
from repro_torch.device import resolve_device
from repro_torch.kernels.p2p import heuristic_stream_params

__all__ = ["DeviceEngine", "EngineTables", "build_engine_tables",
           "build_p2p_stream_tables", "stack_bodies"]


class DeviceEngine:
    """Batched executor for one geometry's stacked tables and payload.

    Parameters
    ----------
    tables : `schedules.EngineTables`, NumPy (as built) or tensors
        (`convert.engine_tables_from_numpy`).
    x_pad, q_pad : the stacked payload, (P, Nmax, 3) and (P, Nmax).
    device : where to run; None means the CUDA device (raises without one).
    p2p_stream : run the near field through K2 over the unified tile table
        instead of one K1 launch per width-class bucket.  Falls back to the
        gathered buckets when the stream-table contiguity invariant does not
        hold (`stream_fallbacks` counts it).
    geometry : the `GeometryPlan` the tables were built from (`geo`); the
        step methods need it, evaluation does not.
    """

    def __init__(self, tables: EngineTables, x_pad, q_pad, *, device=None,
                 p2p_stream: bool = False, geometry=None):
        self.device = resolve_device(device)
        self.tables = tables.to(self.device)
        self._set_payload(x_pad, q_pad)
        self.ops = get_operators(tables.p, self.device)
        self.p2p_stream = bool(p2p_stream)
        self.stream_fallbacks = 0
        self._stream = None
        self.geo = geometry
        self._M = None               # multipoles of the current payload
        self._x_ref_pad = None       # stacked slack reference, built lazily
        self._pending_x = None       # payload staged by step_drift
        self.payload_refreshes = 0
        # float32 guard band of drift-vs-slack decisions: step_drift measures
        # in float32, so its absolute error is a few ulps of the coordinate
        # scale; the session revalidates on the host in float64 within it
        self.drift_guard = (None if geometry is None else float(
            4 * np.finfo(np.float32).eps
            * max(np.abs(geometry.x_ref).max(), 1.0)))

    @classmethod
    def from_geometry(cls, geometry, *, device=None,
                      p2p_stream: bool = False) -> "DeviceEngine":
        tables = build_engine_tables(geometry)
        x_pad, q_pad = stack_bodies(geometry.trees, tables.n_bodies_max)
        return cls(tables, x_pad, q_pad, device=device,
                   p2p_stream=p2p_stream, geometry=geometry)

    # ----------------------------------------------------------- payload --
    def _set_payload(self, x_pad, q_pad) -> None:
        self.x = torch.as_tensor(np.asarray(x_pad, np.float32),
                                 device=self.device)
        self.q = torch.as_tensor(np.asarray(q_pad, np.float32),
                                 device=self.device)

    def refresh_payload(self, geometry, *, use_pending: bool = False) -> None:
        """Rebind to a same-structure geometry (a within-slack step): take
        the new (x, q) payload and drop the cached multipoles; the index
        tables stay on the device untouched.  With `use_pending=True` the
        payload that the last `step_drift` restacked on the device becomes
        the x payload directly (the session guarantees q is unchanged on
        that path)."""
        self.geo = geometry
        if use_pending and self._pending_x is not None:
            self.x = self._pending_x
        else:
            self._set_payload(*stack_bodies(geometry.trees,
                                            self.tables.n_bodies_max))
        self._pending_x = None
        self._M = None
        self.payload_refreshes += 1

    def discard_pending(self) -> None:
        self._pending_x = None

    def step_drift(self, new_x) -> tuple:
        """Batched MAC-slack revalidation: upload `new_x` once, restack it
        into the (P, Nmax, 3) payload envelope on the device, and reduce
        every partition's drift (against the slack reference `x_ref`) and
        changed flag (against the current payload) in one pass.  The
        restacked payload is staged for `refresh_payload(use_pending=True)`.

        Returns (drift (P,) float64, changed (P,) bool) host arrays."""
        if self.geo is None:
            raise ValueError("step_drift needs the engine's geometry: build "
                             "it with DeviceEngine.from_geometry")
        t = self.tables
        if self._x_ref_pad is None:
            self._x_ref_pad = torch.as_tensor(
                stack_reference_bodies(self.geo, t), device=self.device)
        xd = torch.as_tensor(np.asarray(new_x, np.float32),
                             device=self.device)
        x_pad = restack_payload(xd, t.orig_idx, t.flat_idx, t.n_parts,
                                t.n_bodies_max)
        drift, changed = partition_drift(x_pad, self._x_ref_pad, self.x)
        self._pending_x = x_pad
        return (drift.cpu().numpy().astype(np.float64),
                changed.cpu().numpy())

    # ---------------------------------------------------------- streaming --
    def stream_tables(self) -> dict | None:
        """The unified stream tables on the device (built once), or None on
        the gathered route.  block_t comes from the reference's heuristic;
        a geometry whose bucket rows break the contiguity invariant falls
        back to the gathered buckets, counted in `stream_fallbacks`."""
        if not self.p2p_stream:
            return None
        if self._stream is not None:
            return self._stream
        buckets = to_numpy(self.tables.p2p_buckets)
        if not buckets:
            self.p2p_stream = False
            return None
        smax = max(b["s_idx"].shape[1] for b in buckets)
        wt_max = max(b["t_idx"].shape[1] for b in buckets)
        block_t, _ = heuristic_stream_params(smax, wt_max)
        stream = build_p2p_stream_tables(buckets, block_t)
        if stream is None:
            self.stream_fallbacks += 1
            self.p2p_stream = False
            return None
        self._stream = to_device(stream, self.device)
        return self._stream

    # ------------------------------------------------------------ phases --
    def upward(self) -> torch.Tensor:
        """Multipoles (P, n_cells_max, nk) f32, cached per payload."""
        if self._M is None:
            t = self.tables
            self._M = batched_upward_kernel(self.ops, self.x, self.q,
                                            t.up.tables, t.n_cells_max)
        return self._M

    def far_field(self, M) -> tuple:
        """(idx, valid, vals): the L2P values of the far field."""
        t = self.tables
        vals = far_tail_kernel(self.ops, M, self.x, t.m2l, t.up.tables)
        return t.l2p_t_idx, t.up.tables["leaf_valid"], vals

    def near_field(self) -> list:
        """[(idx, valid, vals)]: one entry per K1 bucket, or one K2 entry."""
        stream = self.stream_tables()
        if stream is not None:
            vals = p2p_stream_vals(self.x, self.q, stream)
            return [(stream["out_idx"], stream["out_valid"], vals)]
        return [(b["t_idx"], b["t_valid"], p2p_bucket_vals(self.x, self.q, b))
                for b in self.tables.p2p_buckets]

    def m2p(self, M) -> tuple | None:
        """(idx, valid, vals) of the M2P fallback, or None without rows."""
        m = self.tables.m2p
        if m["b"].shape[0] == 0:
            return None
        vals = m2p_vals_kernel(self.ops, M, self.x, m["b"], m["centers"],
                               m["mask"], m["t_idx"])
        return m["t_idx"], m["t_valid"], vals

    def accumulate(self, parts) -> np.ndarray:
        """Sum (idx, valid, vals) value tables into the potential in float64
        on the device; returns it in original body order on the host."""
        t = self.tables
        phi_flat = torch.zeros(t.n_parts * t.n_bodies_max,
                               dtype=torch.float64, device=self.device)
        zero = torch.zeros((), dtype=torch.float64, device=self.device)
        for idx, valid, vals in parts:
            contrib = torch.where(valid.reshape(-1),
                                  vals.reshape(-1).to(torch.float64), zero)
            phi_flat.index_add_(0, idx.reshape(-1), contrib)
        phi = torch.zeros(t.n, dtype=torch.float64, device=self.device)
        phi[t.orig_idx] = phi_flat[t.flat_idx]
        return phi.cpu().numpy()

    def evaluate(self) -> np.ndarray:
        """Full potential in original body order (float64, host)."""
        M = self.upward()
        parts = [self.far_field(M), *self.near_field()]
        m2p = self.m2p(M)
        if m2p is not None:
            parts.append(m2p)
        return self.accumulate(parts)
