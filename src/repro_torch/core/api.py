"""Layered FMM API of the port: GeometryPlan -> CommSchedule -> FMMSession.

The port of `repro.core.api`:

  1. `plan_geometry(x, q, PartitionSpec) -> GeometryPlan` — all host-side
     geometry, built once with no protocol argument: partitioning,
     completely local trees, batched sender-side LET extraction
     (`extract_lets` runs once per sender for all remote boxes),
     per-receiver frozen interaction plans against every grafted subtree,
     the (P, P) bytes matrix and the MAC slack budget.  It is NumPy
     throughout except for the per-tree upward pass that fills the LET
     payload multipoles, which runs in PyTorch on `device`.
  2. `schedule_comm(geometry, protocol) -> CommSchedule` — a cheap pure
     function over the frozen bytes matrix and the Lemma-1 adjacency boxes
     (`protocols.py`, host NumPy): sweeping the four protocols reuses one
     `GeometryPlan` with no geometry work.
  3. `FMMSession` — holds a `GeometryPlan`, evaluates it through the
     batched `DeviceEngine` (repro_torch.core.engine), with `mesh=` through
     the multi-rank `dist.ShardedEngine` (the LET moved between ranks by
     one of the exchange programs), or, with `engine=False`, the
     per-partition reference executor `execute_geometry` (its uploads
     memoized by a `DeviceMemo`), caches the potential per geometry version
     so `.sweep()` answers every protocol from one evaluation, and advances
     in time with `step(new_x[, new_q])`.

Planning traversal: `PartitionSpec.traversal_backend` None/"auto" plans
with the device dual traversal and its MAC kernel K3
(`engine.traversal.device_dual_traversal`) when the planning device is a
CUDA device, and with the float64 NumPy traversal on the CPU; "host" and
"device" force one.  The device route takes each pair's minimum M2L margin
from the traversal itself.

Stepping (MAC-slack revalidation, as in the reference): each partition's
drift against the positions its structure was built from is tested against
its slack budget, the minimum MAC / truncation margin of every plan and LET
it takes part in, over 2*sqrt(3)*(1 + theta).  Unmoved bodies are a cache
hit.  Drift within the slack keeps the structure and rebinds the payload:
the engine restacks it on the device and recomputes the multipoles, and the
host mirrors (multipoles, LET payloads, grafted views) are filled lazily by
`sync_host_multipoles` (`GeometryPlan.Ms_stale`).  Drift beyond it rebuilds
that partition and exactly the LETs and receiver plans that touch it,
re-traversed on the resolved backend.

Observability (`repro_torch.obs`): planning records the `plan.*` spans,
the memo its `memo.*` counters and upload events, a session the
`session.evaluate` / `session.step` spans and counters; `FMMSession.report()`
gathers them with the cache, launch, resilience and exchange accounting.
Resilience (`repro_torch.resilience`): with `FMMSession(resilience=True)`
a failed evaluation walks down the degradation ladder instead of raising
(`_evaluate_resilient`), a failed device revalidation in `step` falls back
to the host float64 one, and `health_checks=True` adds the finite-potential
sentinel and the sampled MAC-slack audit.
"""
from __future__ import annotations

import math
import os
import weakref
from dataclasses import dataclass, field, replace as dc_replace

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import protocols as proto
from repro_torch.core.dist import DIST_PROTOCOLS, ShardedEngine
from repro_torch.core.engine import DeviceEngine, resolve_cache
from repro_torch.core.engine.traversal import (device_dual_traversal,
                                               resolve_traversal_backend)
from repro_torch.core.fmm import (downward_pass, executor_device, l2p_pass,
                                  m2l_apply, m2p_apply, p2p_apply,
                                  resolve_use_kernels, upward_pass)
from repro_torch.core.hsdx import adjacency_from_boxes, graph_diameter
from repro_torch.core.let import LETData, extract_lets, graft, refresh_let
from repro_torch.core.multipole import get_operators
from repro_torch.core.partition.hot import hot_partition
from repro_torch.core.partition.orb import orb_partition
from repro_torch.core.plan import (InteractionPlan, TreeSchedules,
                                   build_interaction_plan,
                                   build_tree_schedules)
from repro_torch.core.tree import bucket_size, build_tree
from repro_torch.device import resolve_device
from repro_torch.resilience import fallback as _rfb
from repro_torch.resilience import faults as _rfaults

__all__ = ["PartitionSpec", "GeometryPlan", "CommSchedule", "SessionResult",
           "StepReport", "RemoteBlock", "ReceiverPlan", "DeviceMemo",
           "plan_geometry", "schedule_comm", "execute_geometry",
           "sync_host_multipoles", "FMMSession", "DEFAULT_SFC_BOX_INFLATION"]

# default eps-inflation of SFC partitions' tight boxes when deriving the
# adjacency graph (fraction of the global span); ORB regions share split
# planes exactly and need no inflation
DEFAULT_SFC_BOX_INFLATION = 0.03

_EMPTY_LO, _EMPTY_HI = np.inf, -np.inf      # empty-partition box sentinel


# ------------------------------------------------------------------ specs --
@dataclass(frozen=True)
class PartitionSpec:
    """Geometry parameters: everything `plan_geometry` needs.

    `traversal_backend`: "host" (NumPy, float64), "device" (the frontier
    loop with K3 on the planning device), or None/"auto" ("device" on a
    CUDA device, "host" on the CPU)."""
    nparts: int = 8
    method: str = "orb"          # "orb" | "hilbert" | "morton"
    theta: float = 0.5
    ncrit: int = 64
    p: int = 4
    sfc_box_inflation: float = DEFAULT_SFC_BOX_INFLATION
    traversal_backend: str | None = None


@dataclass
class RemoteBlock:
    """One sender's grafted LET at one receiver: the frozen interaction plan
    plus the minimum M2L MAC margin (absolute units)."""
    sender: int
    graft: object                # let._GraftedTree view over lets[(sender, j)]
    inter: InteractionPlan
    margin: float


@dataclass
class ReceiverPlan:
    """One partition's frozen receiver-side geometry."""
    tree: object
    sched: TreeSchedules
    local: InteractionPlan       # own tree vs own tree
    local_margin: float
    remote: list                 # [RemoteBlock], ascending sender id


@dataclass
class GeometryPlan:
    """Every protocol-independent artifact, built once per geometry.
    `FMMSession.step` derives a successor that shares all untouched
    components and bumps `version`."""
    spec: PartitionSpec
    n: int
    x0: np.ndarray               # (N, 3) current positions, original order
    q0: np.ndarray               # (N,)   current charges
    x_ref: np.ndarray            # (N, 3) positions the structure was built from
    part: np.ndarray
    owners: list                 # per-partition original body indices
    boxes: np.ndarray            # (P, 2, 3) tight boxes (empty => sentinel)
    adj_boxes: np.ndarray        # (P, 2, 3) Lemma-1 adjacency boxes
    trees: list                  # Tree per partition (None if empty)
    scheds: list                 # TreeSchedules per partition (None if empty)
    Ms: list                     # per-partition multipoles, NumPy (None if empty)
    lets: dict                   # (i, j) -> LETData
    receivers: list              # ReceiverPlan per partition (None if empty)
    bytes_matrix: np.ndarray     # (P, P) LET bytes i -> j
    adjacency_degree: float
    diameter: int
    slack: np.ndarray            # (P,) per-partition MAC drift budget
    partition_stats: dict = field(default_factory=dict)
    version: int = 0
    # Partitions whose host-side numeric mirrors (Ms, LET payloads, grafted
    # views) are deferred: within-slack steps recompute multipoles on the
    # device, and `sync_host_multipoles` fills the mirrors only when the
    # host path needs them.  Structure, margins, slack and the bytes matrix
    # are never stale.
    Ms_stale: tuple = ()

    @property
    def nparts(self) -> int:
        return self.spec.nparts

    @property
    def theta(self) -> float:
        return self.spec.theta

    @property
    def p(self) -> int:
        return self.spec.p


@dataclass(frozen=True)
class CommSchedule:
    """Layer 2: one protocol's schedule over a frozen GeometryPlan."""
    protocol: str
    schedule: proto.Schedule
    stats: dict
    loggp_time: float
    grain_bytes: int | None

    @property
    def n_stages(self) -> int:
        return self.schedule.n_stages


@dataclass(frozen=True)
class SessionResult:
    """One protocol's end-to-end answer: the (shared) potential plus this
    protocol's communication accounting."""
    phi: np.ndarray
    protocol: str
    comm: CommSchedule
    bytes_matrix: np.ndarray
    partition_stats: dict
    adjacency_degree: float
    diameter: int

    @property
    def schedule_stats(self) -> dict:
        return self.comm.stats

    @property
    def loggp_time(self) -> float:
        return self.comm.loggp_time

    @property
    def n_stages(self) -> int:
        return self.comm.n_stages


@dataclass(frozen=True)
class StepReport:
    """What `FMMSession.step` did: which partitions kept their cached
    structure, which were numerically refreshed, which were rebuilt."""
    cache_hit: bool              # True iff nothing changed at all
    rebuilt: tuple               # partitions whose drift exceeded their slack
    refreshed: tuple             # structure kept; payload rebound
    shift: tuple                 # per-partition max drift vs x_ref
    slack: tuple                 # per-partition budget the shift was tested against
    version: int                 # geometry version after the step


# ------------------------------------------------------------ device memo --
class DeviceMemo:
    """Memoized host->device uploads keyed by (array identity, dtype).

    The `asarray=` hook of the per-tree executors (`fmm.py`): the first
    execution uploads each frozen plan table once to `device`; later
    executions reuse the cached tensor (no transfer).  Entries are anchored
    by a *weak* reference to the host array: while the array lives, `id()`
    stays unique and the tensor is served from cache; when a `step` replaces
    it (new positions, multipoles, LET payloads) and the old geometry is
    dropped, the entry evicts itself, so a long-running session does not
    accumulate stale host or device buffers.  Uploads are copies
    (`torch.tensor`), so no cached tensor keeps its host array alive.

    `misses` counts uploads and `hits` counts served tensors, so `misses` is
    the session's host->device transfer meter (also counted as the obs
    counters `memo.hits` / `memo.misses`, with one `memo.upload` event per
    upload; the `memo.upload` fault seam fires before each).  A tensor
    passed in is returned as is, moved to `device` and `dtype` where it is
    not there already, and never cached."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._views: dict = {}
        self.hits = 0
        self.misses = 0

    def __call__(self, arr, dtype=None):
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=dtype)
        key = (id(arr), None if dtype is None else str(dtype))
        hit = self._views.get(key)
        if hit is not None:
            self.hits += 1
            obs.counter_add("memo.hits")
            return hit[1]
        _rfaults.fire("memo.upload")
        self.misses += 1
        obs.counter_add("memo.misses")
        a = np.asarray(arr)
        if obs.enabled():
            obs.event("memo.upload", {"nbytes": int(a.nbytes),
                                      "shape": list(a.shape),
                                      "dtype": str(a.dtype if dtype is None
                                                   else dtype)})
        dev = torch.tensor(a, dtype=dtype, device=self.device)
        try:
            anchor = weakref.ref(arr, lambda _, k=key: self._views.pop(k, None))
        except TypeError:                   # not weakly referenceable: pin it
            anchor = arr
        self._views[key] = (anchor, dev)
        return dev

    def is_resident(self, arr) -> bool:
        """True iff `arr` IS one of the memoized tensors (identity, not
        equality)."""
        return any(view is arr for _, view in self._views.values())

    def __len__(self) -> int:
        return len(self._views)


# --------------------------------------------------------------- layer 1 ---
def _validate_geometry_inputs(x, q, spec: PartitionSpec) -> None:
    """Reject degenerate inputs at the API boundary with the offending
    argument NAMED.  Deliberately NOT rejected: n < nparts — partitions
    holding no points carry the empty-box sentinel and are skipped by
    adjacency and LET extraction."""
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"x: expected positions of shape (n, 3), got "
                         f"{x.shape}")
    if len(x) == 0:
        raise ValueError("x: at least one body is required (got 0); empty "
                         "PARTITIONS are fine, an empty problem is not")
    if q.shape != (len(x),):
        raise ValueError(f"q: expected charges of shape ({len(x)},) to "
                         f"match x, got {q.shape}")
    if not np.isfinite(x).all():
        raise ValueError("x: positions contain non-finite values "
                         "(NaN or +-inf)")
    if not np.isfinite(q).all():
        raise ValueError("q: charges contain non-finite values (NaN or "
                         "+-inf)")
    if not spec.theta > 0.0:
        raise ValueError(f"theta: MAC opening angle must be > 0, got "
                         f"{spec.theta}")
    if spec.nparts < 1:
        raise ValueError(f"nparts: need at least one partition, got "
                         f"{spec.nparts}")


def _partition(x, nparts, method,
               sfc_box_inflation: float = DEFAULT_SFC_BOX_INFLATION):
    """Returns (part, tight_boxes, adjacency_boxes).  ORB regions share split
    planes exactly; SFC partitions fall back to eps-inflated tight boxes.
    Partitions holding no points carry the empty-box sentinel (lo=+inf,
    hi=-inf)."""
    if method == "orb":
        part, tight, regions = orb_partition(x, nparts, regions=True)
        return part, tight, regions
    if method in ("hilbert", "morton"):
        part, _ = hot_partition(x, nparts, curve=method)
        boxes = np.empty((nparts, 2, 3))
        boxes[:, 0], boxes[:, 1] = _EMPTY_LO, _EMPTY_HI
        for p in range(nparts):
            pts = x[part == p]
            if len(pts):
                boxes[p, 0], boxes[p, 1] = pts.min(axis=0), pts.max(axis=0)
        span = (x.max(axis=0) - x.min(axis=0)).max()
        infl = boxes.copy()
        infl[:, 0] -= sfc_box_inflation * span
        infl[:, 1] += sfc_box_inflation * span
        return part, boxes, infl
    raise ValueError(method)


def _m2l_margin(inter: InteractionPlan, tgt, src, theta: float) -> float:
    """Min over the plan's valid M2L pairs of theta*d - (R_a + R_b)."""
    if inter.n_m2l == 0:
        return float("inf")
    a = inter.m2l_a[:inter.n_m2l]
    b = inter.m2l_b[:inter.n_m2l]
    d = np.linalg.norm(np.asarray(tgt.center)[a] - np.asarray(src.center)[b],
                       axis=1)
    return float(np.min(theta * d
                        - (np.asarray(tgt.radius)[a] + np.asarray(src.radius)[b])))


def _slack_budget(nparts: int, theta: float, receivers: list,
                  lets: dict) -> np.ndarray:
    """Per-partition drift budget from the minimum MAC / truncation margin of
    every plan and LET the partition participates in."""
    margin = np.full(nparts, np.inf)
    for j, r in enumerate(receivers):
        if r is None:
            continue
        margin[j] = min(margin[j], r.local_margin)
        for rb in r.remote:
            margin[rb.sender] = min(margin[rb.sender], rb.margin)
            margin[j] = min(margin[j], rb.margin)
    for (i, j), let in lets.items():
        margin[i] = min(margin[i], let.trunc_margin)
        margin[j] = min(margin[j], let.trunc_margin)
    return np.maximum(margin, 0.0) / (2.0 * math.sqrt(3.0) * (1.0 + theta))


def _geometry_pad_cells(trees) -> int | None:
    """One padded-cell envelope for every traversal of a geometry, so all
    (receiver, sender) pairs share one set of capacities (grafted LETs never
    exceed their sender's cell count)."""
    live = [t.n_cells for t in trees if t is not None]
    if not live:
        return None
    return bucket_size(max(live))


def _plan_pair(tgt, src, theta: float, with_m2p: bool, backend: str,
               pad_cells: int | None = None, device=None):
    """Traverse one (target, source) pair on the chosen backend and freeze
    its interaction plan; returns (inter, min accepted M2L margin).  The
    device route takes the traversal's own margin output; `_m2l_margin`
    scores the host route."""
    if backend == "device":
        m2l, p2p, m2p, margin = device_dual_traversal(
            tgt, src, theta, with_m2p=True, pad_cells=pad_cells,
            device=device)
        assert with_m2p or len(m2p) == 0, \
            "truncated source cells require with_m2p=True"
        inter = build_interaction_plan(
            tgt, src, theta, with_m2p=with_m2p, m2l_pairs=m2l, p2p_pairs=p2p,
            m2p_pairs=(m2p if with_m2p else None))
        return inter, float(margin)
    inter = build_interaction_plan(tgt, src, theta, with_m2p=with_m2p,
                                   traversal_backend="host")
    return inter, _m2l_margin(inter, tgt, src, theta)


def _remote_block(i: int, let: LETData, tree, theta: float,
                  backend: str = "host", pad_cells: int | None = None,
                  device=None) -> RemoteBlock:
    g = graft(let)
    inter, margin = _plan_pair(tree, g, theta, True, backend, pad_cells,
                               device)
    return RemoteBlock(sender=i, graft=g, inter=inter, margin=margin)


def _rebind_remote(rb: RemoteBlock, let: LETData) -> RemoteBlock:
    """Rebind a drifted sender's refreshed LET payload onto the cached
    interaction plan: new graft view, same inter/margin (structure and MAC
    margins are drift-invariant within slack)."""
    return RemoteBlock(sender=rb.sender, graft=graft(let), inter=rb.inter,
                       margin=rb.margin)


def plan_geometry(x, q, spec: PartitionSpec | None = None, *, device=None,
                  **overrides) -> GeometryPlan:
    """Partition, build local trees, extract every LET (one batched
    `extract_lets` call per sender), traverse every receiver pair.  Keyword
    overrides patch the spec: `plan_geometry(x, q, nparts=16)`.  The LET
    payload multipoles are computed on `device` (None: the card), and the
    device traversal runs there."""
    spec = dc_replace(spec or PartitionSpec(), **overrides)
    dev = resolve_device(device)
    backend = resolve_traversal_backend(spec.traversal_backend, dev)
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    _validate_geometry_inputs(x, q, spec)
    n = len(x)
    P = spec.nparts
    with obs.span("plan.geometry") as sp_plan:
        with obs.span("plan.partition"):
            part, boxes, adj_boxes = _partition(
                x, P, spec.method, sfc_box_inflation=spec.sfc_box_inflation)
        ops = get_operators(spec.p, dev)

        # --- completely local trees (local bounding box, tight cells; §3) --
        with obs.span("plan.trees"):
            owners, trees, scheds, Ms = [], [], [], []
            for pid in range(P):
                idx = np.nonzero(part == pid)[0]
                owners.append(idx)
                if len(idx) == 0:
                    trees.append(None)
                    scheds.append(None)
                    Ms.append(None)
                    continue
                t = build_tree(x[idx], q[idx], ncrit=spec.ncrit)
                trees.append(t)
                scheds.append(build_tree_schedules(t))
                Ms.append(upward_pass(t, ops, sched=scheds[-1]).cpu().numpy())

        # --- sender-initiated LET extraction: all remote boxes per sender in
        #     one batched frontier pass; empty partitions neither send nor
        #     receive -----------------------------------------------------
        with obs.span("plan.lets"):
            lets: dict[tuple[int, int], LETData] = {}
            B = np.zeros((P, P), dtype=np.int64)
            for i in range(P):
                if trees[i] is None:
                    continue
                others = np.array([j for j in range(P)
                                   if j != i and trees[j] is not None],
                                  dtype=np.int64)
                if len(others) == 0:
                    continue
                for j, let in zip(others, extract_lets(trees[i], Ms[i],
                                                       boxes[others, 0],
                                                       boxes[others, 1],
                                                       spec.theta)):
                    lets[(i, int(j))] = let
                    B[i, j] = let.nbytes

        # --- receiver side: graft + traverse ONCE into frozen plans --------
        with obs.span("plan.receivers"):
            pad_cells = _geometry_pad_cells(trees)
            receivers: list = []
            for j in range(P):
                if trees[j] is None:
                    receivers.append(None)
                    continue
                t = trees[j]
                local, local_margin = _plan_pair(t, t, spec.theta, False,
                                                 backend, pad_cells, dev)
                remote = [_remote_block(i, lets[(i, j)], t, spec.theta,
                                        backend, pad_cells, dev)
                          for i in range(P) if (i, j) in lets]
                receivers.append(ReceiverPlan(
                    tree=t, sched=scheds[j], local=local,
                    local_margin=local_margin, remote=remote))

        adj = adjacency_from_boxes(adj_boxes)
        deg = float(np.max([len(a) for a in adj]))
        obs.counter_add("plan.builds")
        if obs.enabled():
            sp_plan.set({"n": int(n), "nparts": int(P),
                         "method": spec.method, "backend": backend,
                         "let_bytes": int(B.sum())})
        return GeometryPlan(
            spec=spec, n=n, x0=x.copy(), q0=q.copy(), x_ref=x.copy(),
            part=part, owners=owners, boxes=boxes, adj_boxes=adj_boxes,
            trees=trees, scheds=scheds, Ms=Ms, lets=lets,
            receivers=receivers, bytes_matrix=B,
            adjacency_degree=deg, diameter=graph_diameter(adj),
            slack=_slack_budget(P, spec.theta, receivers, lets),
            partition_stats=dict(nparts=P, method=spec.method),
        )


# --------------------------------------------------------------- layer 2 ---
def schedule_comm(geometry, protocol: str = "hsdx",
                  prm: proto.LogGPParams | None = None,
                  grain_bytes: int | None = None,
                  check_delivery: bool = True) -> CommSchedule:
    """Layer 2: a pure function over the geometry's frozen bytes matrix and
    adjacency boxes — no partitioning, trees, traversal or LET work, so a
    protocol sweep costs four cheap schedule constructions, not four
    geometry builds.  `check_delivery` runs the store-and-forward simulator
    and raises unless the schedule delivers exactly the bytes matrix."""
    B = geometry.bytes_matrix
    sched = proto.make_schedule(protocol, B, boxes=geometry.adj_boxes)
    if check_delivery:
        delivered = proto.simulate_delivery(sched)
        expect = {(i, j): int(B[i, j]) for i in range(len(B))
                  for j in range(len(B)) if i != j and B[i, j] > 0}
        if delivered != expect:
            raise RuntimeError(f"{protocol} failed to deliver the LET")
    return CommSchedule(
        protocol=protocol, schedule=sched, stats=proto.schedule_stats(sched),
        loggp_time=proto.loggp_time(sched, prm=prm, grain_bytes=grain_bytes),
        grain_bytes=grain_bytes)


# --------------------------------------------------------- host mirrors ---
def sync_host_multipoles(geo, device=None) -> None:
    """Fill the deferred host-side numeric mirrors of `geo.Ms_stale`
    partitions: recompute their multipoles about the build-time expansion
    centers (on `device`, None: the card), rebind every LET payload they
    send, and re-graft the receiver views over the refreshed LETs.  In
    place: a cache fill with exactly what an eager step would have produced,
    not a semantic change; a no-op when nothing is stale."""
    stale = set(getattr(geo, "Ms_stale", ()))
    if not stale:
        return
    ops = get_operators(geo.spec.p, resolve_device(device))
    for j in sorted(stale):
        geo.Ms[j] = upward_pass(geo.trees[j], ops,
                                sched=geo.scheds[j]).cpu().numpy()
    for (i, j), let in list(geo.lets.items()):
        if i in stale:
            geo.lets[(i, j)] = refresh_let(let, geo.trees[i], geo.Ms[i])
    for j, r in enumerate(geo.receivers):
        if r is None:
            continue
        if j not in stale and not any(rb.sender in stale for rb in r.remote):
            continue
        remote = [_rebind_remote(rb, geo.lets[(rb.sender, j)])
                  if rb.sender in stale else rb
                  for rb in r.remote]
        # the receiver's own tree too: the deferred step kept the old
        # ReceiverPlan, whose tree holds the pre-step coordinates
        geo.receivers[j] = ReceiverPlan(tree=geo.trees[j], sched=r.sched,
                                        local=r.local,
                                        local_margin=r.local_margin,
                                        remote=remote)
    geo.Ms_stale = ()


# --------------------------------------------------------------- executor --
def execute_geometry(geo, use_kernels: bool | None = None, asarray=None, *,
                     device=None) -> np.ndarray:
    """Reference executor — kernels + gathers only, one partition at a time:
    no traversal, no list building, no padding.  Works on any plan-shaped
    object (GeometryPlan or the legacy DistributedPlan).  The batched
    engine (repro_torch.core.engine) is pinned against this path.

    Runs on `device`, else the hook's device (`asarray=DeviceMemo(...)`
    uploads every frozen table at most once across calls), else the card.
    On a CUDA device every P2P block is one K1 launch (`use_kernels=False`
    raises there); on the CPU, False runs the plain near field of
    `fmm.p2p_apply` in place of K1's plain version.
    Each partition's potential is summed in float64 on the device; the
    potential comes to the host once, in original body order."""
    dev = executor_device(asarray, device)
    resolve_use_kernels(use_kernels, dev)
    sync_host_multipoles(geo, dev)
    ops = get_operators(geo.p, dev)
    order, parts = [], []
    for j in range(geo.nparts):
        r = geo.receivers[j]
        if r is None:
            continue
        t = r.tree
        L = m2l_apply(ops, geo.Ms[j], r.local, asarray=asarray)
        phi_local = p2p_apply(t, t, r.local, use_kernels=use_kernels,
                              asarray=asarray, device=dev)
        for rb in r.remote:
            if rb.inter.n_m2l:
                L = L + m2l_apply(ops, rb.graft.M, rb.inter, asarray=asarray)
            if rb.inter.n_p2p:
                phi_local += p2p_apply(t, rb.graft, rb.inter,
                                       use_kernels=use_kernels,
                                       asarray=asarray, device=dev)
            if rb.inter.n_m2p:
                phi_local += m2p_apply(t, rb.graft.M, rb.inter, p=geo.p,
                                       asarray=asarray, device=dev)
        L = downward_pass(t, ops, L, sched=r.sched, asarray=asarray)
        phi_local += l2p_pass(t, ops, L, sched=r.sched, asarray=asarray)
        order.append(geo.owners[j][t.perm])
        parts.append(phi_local)
    phi = np.zeros(geo.n)
    if parts:
        phi[np.concatenate(order)] = torch.cat(parts).cpu().numpy()
    return phi


# --------------------------------------------------------------- layer 3 ---
class FMMSession:
    """Layer 3: one geometry, all protocols, many timesteps.

    Evaluation runs through the batched `DeviceEngine` (`engine=None` or
    True) or the per-partition reference executor `execute_geometry`
    (`engine=False`), whose frozen tables the session's `DeviceMemo`
    uploads once.  `potentials` caches the (protocol-independent) potential
    per geometry version, so `.sweep()` answers all four protocols from one
    evaluation; `comm` memoizes the schedules until a step rebuilds a
    partition.

    `device=None` runs on the card (raises without one); pass
    `device="cpu"` to run on the CPU, where the kernel wrappers use their
    plain versions; on the card the near field always runs the kernels
    (K1 / K2).  `p2p_stream` selects the engine's streaming near
    field (K2) over the gathered buckets (K1, the default).

    `fused` serves a warm evaluate and a within-slack step's revalidation
    as one replay of a compiled entry (a CUDA graph; default on for a CUDA
    device, `engine.default_fused_enabled`); `fused=False` keeps the
    per-phase engine.  `exe_cache` is the entry cache the engine resolves
    against (the process-wide `GLOBAL_CACHE` when omitted), read through
    `exe_cache_stats`.

    `mesh` (`launch.mesh.stacked_mesh(n)` or `group_mesh()`, on the
    session's device) evaluates through the multi-rank `ShardedEngine`
    (`.dist`), its LET moved by the `dist_protocol` program ("bulk",
    "grain" with `dist_grain_bytes` chunks, or "hsdx"); with
    `REPRO_VERIFY_EXCHANGE=1` every delivered span is checked once per
    (protocol, geometry version) first.

    `resilience` (default `REPRO_RESILIENCE`, off): off, a failed exchange,
    capture, launch or upload raises.  On, it costs one rung of the
    degradation ladder (`resilience.fallback.LADDER`; the session's knobs
    classify it, `_current_rung`): dist -> streaming (K2) -> gathered (K1,
    compiled on a CUDA device) -> per_phase (K1, `fused=False`) ->
    reference (`execute_geometry`, K1 once a block); `xla_slab` has no rung
    in the port and is skipped, and no rung runs a plain near field on a
    CUDA device.  A failed exchange or exchange verification drops the mesh
    for the single-device engine.  Transient errors retry in place first.
    Every downgrade is counted, warned once and listed in
    `report()["resilience"]`; an exhausted ladder raises
    `ResilienceError`.  `health_checks=True` adds the finite-potential and
    finite-multipole sentinel and the sampled MAC-slack audit of a step."""

    def __init__(self, geometry: GeometryPlan, *, device=None,
                 engine: bool | None = None,
                 p2p_stream: bool = False, fused: bool | None = None,
                 exe_cache=None, mesh=None, dist_protocol: str = "bulk",
                 dist_grain_bytes: int | None = None,
                 resilience: bool | None = None,
                 health_checks: bool | None = None):
        if not (hasattr(geometry, "receivers")
                and hasattr(geometry, "bytes_matrix")):
            raise ValueError(
                f"geometry: expected a GeometryPlan (plan_geometry(...) "
                f"output), got {type(geometry).__name__}")
        self._geo = geometry
        self.device = resolve_device(device)
        self.engine_enabled = engine is not False
        self.p2p_stream = bool(p2p_stream)
        self.fused = fused               # None -> default_fused_enabled()
        self.exe_cache = exe_cache       # None -> the process-wide cache
        if dist_protocol not in DIST_PROTOCOLS:
            raise ValueError(f"unknown dist_protocol {dist_protocol!r}; "
                             f"expected one of {DIST_PROTOCOLS}")
        if mesh is not None and torch.device(mesh.device) != self.device:
            raise ValueError(f"mesh: its device {mesh.device} is not the "
                             f"session's {self.device}")
        self.mesh = mesh                 # a dist.comm mesh -> dist dispatch
        self.dist_protocol = dist_protocol
        self.dist_grain_bytes = dist_grain_bytes
        self.resilience = _rfb.ResilienceState(
            enabled=(_rfb.default_resilience_enabled() if resilience is None
                     else bool(resilience)),
            health_checks=bool(health_checks))
        self._engine = None
        self._dist = None
        self._memo = DeviceMemo(self.device)
        self._comm_cache: dict = {}
        self._phi: np.ndarray | None = None
        self._phi_version = -1
        self._exchange_verified: set = set()

    @classmethod
    def from_points(cls, x, q, spec: PartitionSpec | None = None, *,
                    device=None, engine: bool | None = None,
                    p2p_stream: bool = False, fused: bool | None = None,
                    exe_cache=None, mesh=None, dist_protocol: str = "bulk",
                    dist_grain_bytes: int | None = None,
                    resilience: bool | None = None,
                    health_checks: bool | None = None,
                    **overrides) -> "FMMSession":
        dev = resolve_device(device)
        return cls(plan_geometry(x, q, spec, device=dev, **overrides),
                   device=dev, engine=engine, p2p_stream=p2p_stream,
                   fused=fused, exe_cache=exe_cache, mesh=mesh,
                   dist_protocol=dist_protocol,
                   dist_grain_bytes=dist_grain_bytes, resilience=resilience,
                   health_checks=health_checks)

    @property
    def geometry(self) -> GeometryPlan:
        return self._geo

    @property
    def memo(self) -> DeviceMemo:
        return self._memo

    @property
    def engine(self) -> DeviceEngine | None:
        """The session's `DeviceEngine`, built on first access and again
        after a step that rebuilt a partition; None under reference
        dispatch (`engine=False`)."""
        if not self.engine_enabled:
            return None
        if self._engine is None or self._engine.geo is not self._geo:
            self._engine = DeviceEngine.from_geometry(
                self._geo, device=self.device, p2p_stream=self.p2p_stream,
                fused=self.fused, exe_cache=self.exe_cache, memo=self._memo)
        return self._engine

    @property
    def dist(self) -> ShardedEngine | None:
        """The session's `ShardedEngine` (mesh dispatch), built on first
        access and again after a step that rebuilt a partition; None
        without a mesh."""
        if self.mesh is None:
            return None
        if self._dist is None or self._dist.geo is not self._geo:
            self._dist = ShardedEngine(self._geo, self.mesh,
                                       grain_bytes=self.dist_grain_bytes)
        return self._dist

    @property
    def exchange_stats(self) -> dict:
        """Per-rank wire accounting of the session's dist protocol (moved /
        delivered bytes, rounds, padding) and its LogGP prediction; without
        a mesh, a payload marked `enabled: False`."""
        if self.mesh is None:
            return {"enabled": False, "protocol": self.dist_protocol,
                    "reason": "no mesh: pass FMMSession(mesh=...) for "
                              "multi-rank exchange accounting",
                    "n_rounds": 0, "moved_bytes": 0, "delivered_bytes": 0,
                    "padded_wire_bytes": 0, "per_rank_sent": [],
                    "per_rank_recv": [], "grain_bytes": None,
                    "loggp_time": 0.0, "rank_bytes": []}
        st = dict(self.dist.exchange_stats(self.dist_protocol))
        st["enabled"] = True
        return st

    @property
    def exe_cache_stats(self) -> dict:
        """Hit / miss / eviction counters of the compiled-entry cache this
        session resolves against.  `misses` counts captures: a second
        geometry of the same shape class must not move it."""
        eng = self._engine
        cache = (eng.exe_cache if eng is not None
                 else resolve_cache(self.exe_cache))
        return cache.stats()

    def report(self, *, measure_exchange: bool | None = None,
               protocols=None, reps: int = 3) -> dict:
        """One structured flight-recorder dict for this session, with the
        reference's keys: `obs` (tracer state), `timings` (span wall time
        by name), `metrics` (counters, gauges, histograms), `memo`,
        `exe_cache`, `geometry`, `resilience` (the ladder's state and every
        fallback), `launches` and `exchange`.

        `launches`, per compiled entry kind: its `calls`, the CUDA graph
        replays one call makes (`entry_computations`: 1 when captured, 0 on
        the CPU, where nothing is captured), `captured`, and the kernel
        launches a replay makes as its capture recorded them
        (`kernel_launches`); plus `fused_dispatches`, the engine's compiled
        calls.  `exchange`, on a mesh session, per dist protocol: the wire
        accounting, and with `measure_exchange` (default: tracing enabled)
        the exchange alone timed `reps` times beside its LogGP prediction
        (`ShardedEngine.measure_exchange`, with `model_drift`).  Never
        raises on mesh-less or engine-less sessions: those blocks are
        marked `{"enabled": False}`."""
        tracer = obs.get_tracer()
        rep: dict = {
            "obs": {"enabled": obs.enabled(),
                    "fences": obs.fences_enabled(),
                    "events": len(tracer.events) if tracer else 0,
                    "dropped": tracer.dropped if tracer else 0},
            "timings": tracer.summary() if tracer else {},
            "metrics": obs.metrics_snapshot(),
            "memo": {"hits": self._memo.hits, "misses": self._memo.misses,
                     "resident_views": len(self._memo._views)},
            "exe_cache": self.exe_cache_stats,
            "geometry": {"n": int(self._geo.n),
                         "nparts": int(self._geo.spec.nparts),
                         "version": int(self._geo.version),
                         "bytes_matrix_total":
                             int(self._geo.bytes_matrix.sum())},
            "resilience": self.resilience.snapshot(),
        }
        eng = self._engine
        if eng is not None and eng._entries:
            launches: dict = {}
            for kind, entry in eng._entries.items():
                captured = entry.call.graph is not None
                launches[kind] = {"calls": entry.calls,
                                  "entry_computations": int(captured),
                                  "captured": captured,
                                  "kernel_launches": entry.launches}
            launches["fused_dispatches"] = len(eng.launch_log)
            rep["launches"] = launches
        else:
            rep["launches"] = {"enabled": False}

        if self.mesh is None:
            rep["exchange"] = {"enabled": False, "protocols": {}}
        else:
            do_measure = (obs.enabled() if measure_exchange is None
                          else bool(measure_exchange))
            names = tuple(protocols) if protocols else DIST_PROTOCOLS
            per_proto = {}
            for name in names:
                if do_measure:
                    per_proto[name] = self.dist.measure_exchange(name,
                                                                 reps=reps)
                else:
                    per_proto[name] = self.dist.exchange_stats(name)
            rep["exchange"] = {"enabled": True,
                               "protocol": self.dist_protocol,
                               "measured": do_measure,
                               "protocols": per_proto}
        return rep

    # ------------------------------------------------------------- comm ---
    def comm(self, protocol: str = "hsdx", grain_bytes: int | None = None,
             prm: proto.LogGPParams | None = None,
             check_delivery: bool = True) -> CommSchedule:
        """Memoized `schedule_comm` (dropped when a step rebuilds any
        partition, i.e. whenever the bytes matrix can change)."""
        key = (protocol, grain_bytes, check_delivery)
        if prm is None and key in self._comm_cache:
            return self._comm_cache[key]
        cs = schedule_comm(self._geo, protocol, prm=prm,
                           grain_bytes=grain_bytes,
                           check_delivery=check_delivery)
        if prm is None:
            self._comm_cache[key] = cs
        return cs

    # ------------------------------------------------------- resilience ---
    def _current_rung(self) -> str:
        """Classify the session's knobs onto the degradation ladder
        (`fallback.LADDER`): a mesh is "dist", `engine=False` "reference",
        `p2p_stream` "streaming", `fused=False` "per_phase", else
        "gathered" (`fused` at its default or on).  The inverse of
        `_apply_rung`: applying a rung and then classifying returns it."""
        if self.mesh is not None:
            return "dist"
        if not self.engine_enabled:
            return "reference"
        if self.p2p_stream:
            return "streaming"
        return "per_phase" if self.fused is False else "gathered"

    def _apply_rung(self, rung: str) -> None:
        """Set the session's knobs to a single-device ladder rung and drop
        the engine, so the next evaluation rebuilds on the new route (the
        memo and the entry cache are kept; an entry's key holds its route,
        so no entry of the route given up serves the new one)."""
        if rung == "streaming":
            self.engine_enabled, self.p2p_stream = True, True
        elif rung == "gathered":
            self.engine_enabled, self.p2p_stream = True, False
            if self.fused is False:
                self.fused = None
        elif rung == "per_phase":
            self.engine_enabled, self.p2p_stream = True, False
            self.fused = False
        elif rung == "reference":
            self.engine_enabled = False
        else:
            raise ValueError(f"no single-device ladder rung {rung!r} in the "
                             "port")
        self._engine = None

    def _downgrade(self, exc: BaseException) -> None:
        """Step one rung DOWN the ladder after `exc` killed the current one
        (`xla_slab` skipped).  Dist failures drop the mesh and re-enter at
        whatever single-device rung the knobs select; below `reference`
        the ladder is exhausted and the typed `ResilienceError` carrying
        the failing site is raised."""
        frm = self._current_rung()
        site = getattr(exc, "site", frm)
        if frm == "dist":
            self.mesh = None
            self._dist = None
            to = self._current_rung()
        else:
            below = [r for r in _rfb.LADDER[_rfb.LADDER.index(frm) + 1:]
                     if r != "xla_slab"]
            if not below:
                raise _rfb.ResilienceError(
                    site, f"resilience ladder exhausted at {frm!r}: "
                          f"{exc}") from exc
            to = below[0]
            self._apply_rung(to)
        self.resilience.note_fallback(site, frm, to, exc)

    def _phi_healthy(self, phi) -> bool:
        """Opt-in numerical sentinel: phi (and, under engine dispatch, the
        engine's cached multipoles) must be finite.  A failure is treated
        like any rung failure: downgrade and recompute on the next rung."""
        st = self.resilience
        st.health["checks"] += 1
        ok = bool(np.isfinite(phi).all())
        eng = self._engine
        if ok and eng is not None and eng._M is not None:
            ok = bool(torch.isfinite(eng._M).all())
        if not ok:
            st.health["failures"] += 1
            obs.counter_add("resilience.health_failures")
        return ok

    def _verify_exchange_once(self) -> None:
        """`REPRO_VERIFY_EXCHANGE=1`: check every delivered wire span
        against its sender-side payload, once per (protocol, geometry
        version); raises `ExchangeVerificationError` on a mismatch —
        terminal without resilience, a dist -> engine downgrade with it."""
        key = (self.dist_protocol, self._geo.version)
        if key in self._exchange_verified:
            return
        self.dist.verify_exchange(self.dist_protocol)
        self._exchange_verified.add(key)
        self.resilience.exchange_verified += 1

    def _dispatch_evaluate(self) -> tuple:
        """One evaluation attempt on the CURRENT rung -> (phi, dispatch)."""
        if self.mesh is not None:
            if os.environ.get("REPRO_VERIFY_EXCHANGE", "") in (
                    "1", "on", "yes", "true"):
                self._verify_exchange_once()
            return self.dist.evaluate(self.dist_protocol), "dist"
        if self.engine_enabled:
            return self.engine.evaluate(), "engine"
        return execute_geometry(self._geo, asarray=self._memo), "reference"

    def _evaluate_resilient(self) -> tuple:
        """Walk the ladder until a rung produces a (healthy) potential.
        Transient failures retry in place with backoff; anything else costs
        one rung.  Terminates: every iteration either returns or strictly
        descends the finite ladder (`_downgrade` raises at the bottom)."""
        st = self.resilience
        while True:
            rung = self._current_rung()
            try:
                phi, dispatch = _rfb.call_with_retry(
                    self._dispatch_evaluate, site=rung,
                    policy=st.retry, state=st)
            except _rfb.ResilienceError:
                raise                       # already terminal + counted
            except Exception as exc:
                self._downgrade(exc)
                continue
            if st.health_checks and not self._phi_healthy(phi):
                exc = RuntimeError(
                    f"non-finite potential from rung {rung!r}")
                exc.site = "health.phi"
                self._downgrade(exc)
                continue
            st.rung = rung
            return phi, dispatch

    # ------------------------------------------------------------ kernels -
    def evaluate(self) -> np.ndarray:
        """Evaluate now (ignoring the potential cache) and refresh the cached
        potential; returns it in original body order (float64, host).  With
        `resilience=True` a failing route degrades down the ladder instead
        of raising (`_evaluate_resilient`).  The array is read-only: every
        SessionResult of this geometry version shares it."""
        with obs.span("session.evaluate") as sp:
            if self.resilience.enabled:
                phi, dispatch = self._evaluate_resilient()
            else:
                phi, dispatch = self._dispatch_evaluate()
            obs.counter_add("session.evaluations")
            if obs.enabled():
                sp.set({"dispatch": dispatch, "n": int(self._geo.n),
                        "version": int(self._geo.version)})
        phi.setflags(write=False)
        self._phi, self._phi_version = phi, self._geo.version
        return phi

    def potentials(self, protocol: str = "hsdx",
                   grain_bytes: int | None = None,
                   prm: proto.LogGPParams | None = None,
                   check_delivery: bool = True) -> SessionResult:
        """Potential (original body order) + this protocol's communication
        accounting.  The potential is protocol-independent and computed once
        per geometry version."""
        cs = self.comm(protocol, grain_bytes=grain_bytes, prm=prm,
                       check_delivery=check_delivery)
        if self._phi is None or self._phi_version != self._geo.version:
            self.evaluate()
        return SessionResult(
            phi=self._phi, protocol=protocol, comm=cs,
            bytes_matrix=self._geo.bytes_matrix,
            partition_stats=self._geo.partition_stats,
            adjacency_degree=self._geo.adjacency_degree,
            diameter=self._geo.diameter)

    def sweep(self, protocols=proto.PROTOCOLS,
              grain_bytes: int | None = None,
              prm: proto.LogGPParams | None = None,
              check_delivery: bool = True) -> dict:
        """All protocols from one GeometryPlan and one evaluation."""
        return {name: self.potentials(name, grain_bytes=grain_bytes, prm=prm,
                                      check_delivery=check_delivery)
                for name in protocols}

    # ------------------------------------------------------------- step ---
    def step(self, new_x, new_q=None) -> StepReport:
        """Advance to new body positions (and charges), reusing every cached
        structure the MAC slack margins still cover (module docstring).

        Unmoved bodies are a cache hit: the geometry object, its version,
        the engine, the memo and the cached potential are untouched.  Drift
        within a partition's slack rebinds that partition's payload onto
        the cached structure; drift beyond it rebuilds the partition and
        exactly the LETs and receiver plans that touch it.

        With `resilience=True` a failed device revalidation (`step_drift`)
        falls back to the host float64 one, counted; with `health_checks`
        as well, up to 4 partitions' device drifts are audited against the
        exact host float64 ones, and a disagreement beyond the float32
        guard band sends the step to the host revalidation."""
        with obs.span("session.step") as sp:
            report = self._step_impl(new_x, new_q)
            obs.counter_add("session.steps")
            if obs.enabled():
                sp.set({"cache_hit": report.cache_hit,
                        "rebuilt": len(report.rebuilt),
                        "refreshed": len(report.refreshed)})
        return report

    def _step_impl(self, new_x, new_q=None) -> StepReport:
        geo = self._geo
        P = geo.spec.nparts
        new_x = np.array(new_x, dtype=np.float64)
        if new_x.shape != (geo.n, 3):
            raise ValueError(f"step: expected positions {(geo.n, 3)}, "
                             f"got {new_x.shape}")
        if not np.isfinite(new_x).all():
            raise ValueError("new_x: positions contain non-finite values "
                             "(NaN/Inf); refusing to poison the cached "
                             "geometry")
        q_unchanged = new_q is None
        new_q = geo.q0 if new_q is None else np.array(new_q, dtype=np.float64)
        if new_q.shape != (geo.n,):
            raise ValueError(f"step: expected charges {(geo.n,)}, "
                             f"got {new_q.shape}")
        if not np.isfinite(new_q).all():
            raise ValueError("new_q: charges contain non-finite values "
                             "(NaN/Inf)")
        q_unchanged = q_unchanged or np.array_equal(new_q, geo.q0)

        # Batched device revalidation: a warm engine scores every
        # partition's drift and changed flag in one pass from one new_x
        # upload; the restacked payload becomes the next evaluation's.
        eng = (self._engine if self.engine_enabled
               and self._engine is not None and self._engine.geo is geo
               else None)
        use_dev = eng is not None and q_unchanged
        res = self.resilience
        if use_dev:
            try:
                delta, stale = eng.step_drift(new_x)
            except Exception as exc:
                if not res.enabled:
                    raise
                # device revalidation died: the host float64 loop below
                # gives the same answers one rung slower
                res.note_fallback(getattr(exc, "site", "engine.step_drift"),
                                  "device_revalidation", "host", exc)
                use_dev = False
            if use_dev and np.any(stale & (delta > geo.slack
                                           - eng.drift_guard)):
                # a rebuild is coming, or a drift sits within the float32
                # guard band of its slack: rebuild decisions and the
                # conservative LET re-extraction boxes use exact float64
                use_dev = False
            if use_dev and res.enabled and res.health_checks:
                # sampled MAC-slack audit: a silent drift underestimate is
                # the one failure that serves a stale potential as a hit
                for j in [j for j in range(P) if len(geo.owners[j])][:4]:
                    idx = geo.owners[j]
                    exact = math.sqrt(float(
                        ((new_x[idx] - geo.x_ref[idx]) ** 2)
                        .sum(axis=1).max()))
                    res.audits["checks"] += 1
                    if abs(exact - float(delta[j])) > eng.drift_guard:
                        res.audits["failures"] += 1
                        obs.counter_add("resilience.audit_failures")
                        use_dev = False
                        break
        if not use_dev:
            if eng is not None:
                eng.discard_pending()
            delta = np.zeros(P)              # drift vs structure reference
            stale = np.zeros(P, dtype=bool)  # numeric payload out of date
            for j in range(P):
                idx = geo.owners[j]
                if len(idx) == 0:
                    continue
                delta[j] = math.sqrt(float(
                    ((new_x[idx] - geo.x_ref[idx]) ** 2).sum(axis=1).max()))
                stale[j] = (not np.array_equal(new_x[idx], geo.x0[idx])
                            or not np.array_equal(new_q[idx], geo.q0[idx]))

        rebuilt = tuple(int(j) for j in range(P)
                        if stale[j] and delta[j] > geo.slack[j])
        refreshed = tuple(int(j) for j in range(P)
                          if stale[j] and j not in rebuilt)
        report = StepReport(cache_hit=not (rebuilt or refreshed),
                            rebuilt=rebuilt, refreshed=refreshed,
                            shift=tuple(delta.tolist()),
                            slack=tuple(geo.slack.tolist()),
                            version=geo.version + bool(rebuilt or refreshed))
        if report.cache_hit:
            if eng is not None:
                eng.discard_pending()
            return report

        # Engine-backed within-slack refreshes stay on the device: the engine
        # recomputes the multipoles from the restacked payload, and the host
        # mirrors are deferred to sync_host_multipoles.  The reference
        # executor reads the host mirrors, so they are refreshed eagerly.
        defer = self.engine_enabled and not rebuilt
        self._geo = self._advance(geo, new_x, new_q, delta, set(rebuilt),
                                  set(refreshed), defer_numeric=defer,
                                  device=self.device)
        self._phi = None
        if rebuilt:            # structure and bytes matrix changed: stale
            self._comm_cache.clear()
            self._engine = None
            self._dist = None                # wire layout / spans changed too
        else:
            if self._engine is not None:
                self._engine.refresh_payload(self._geo, use_pending=use_dev)
            if self._dist is not None:
                # the dist engine recomputes multipoles AND LET wire
                # payloads on the device from the restacked (x, q)
                self._dist.refresh_payload(self._geo)
        return report

    @staticmethod
    def _advance(geo: GeometryPlan, new_x, new_q, delta, rebuilt: set,
                 refreshed: set, defer_numeric: bool = False,
                 device=None) -> GeometryPlan:
        spec = geo.spec
        dev = resolve_device(device)
        backend = resolve_traversal_backend(spec.traversal_backend, dev)
        P = spec.nparts
        ops = get_operators(spec.p, dev)
        touched = rebuilt | refreshed
        if rebuilt:
            # LET re-extraction below reads refreshed senders' host
            # multipoles: fill any deferred mirrors first
            sync_host_multipoles(geo, dev)
        trees, scheds, Ms = list(geo.trees), list(geo.scheds), list(geo.Ms)
        boxes, adj_boxes = geo.boxes.copy(), geo.adj_boxes.copy()
        lets, B = dict(geo.lets), geo.bytes_matrix.copy()
        x_ref = geo.x_ref.copy()

        # 1. rebuild invalidated partitions' local structure from scratch
        for j in rebuilt:
            idx = geo.owners[j]
            t = build_tree(new_x[idx], new_q[idx], ncrit=spec.ncrit)
            trees[j], scheds[j] = t, build_tree_schedules(t)
            Ms[j] = upward_pass(t, ops, sched=scheds[j]).cpu().numpy()
            boxes[j, 0] = new_x[idx].min(axis=0)
            boxes[j, 1] = new_x[idx].max(axis=0)
            # union-expand the adjacency box: Lemma-1 neighbour sets only
            # grow, so cached reachability stays conservative
            adj_boxes[j, 0] = np.minimum(adj_boxes[j, 0], boxes[j, 0])
            adj_boxes[j, 1] = np.maximum(adj_boxes[j, 1], boxes[j, 1])
            x_ref[idx] = new_x[idx]

        # 2. drift within slack: same structure, rebound coordinates and
        #    charges; the multipoles are recomputed about the build-time
        #    centers, or left to the engine when deferred
        for j in refreshed:
            idx = geo.owners[j]
            t = trees[j]
            t = dc_replace(t, x=new_x[idx][t.perm], q=new_q[idx][t.perm])
            trees[j] = t
            if not defer_numeric:
                Ms[j] = upward_pass(t, ops, sched=scheds[j]).cpu().numpy()

        # 3. LETs: re-extract a pair iff either end was rebuilt; rebind the
        #    payload iff only the sender drifted within slack
        for i in range(P):
            if trees[i] is None:
                continue
            targets = [j for j in range(P) if j != i and trees[j] is not None
                       and (i in rebuilt or j in rebuilt)]
            if targets:
                tj = np.asarray(targets)
                lo, hi = boxes[tj, 0].copy(), boxes[tj, 1].copy()
                # a valid-but-drifted receiver can poke past its build-time
                # tight box by at most its drift: extract conservatively
                pad = np.array([delta[j] if j not in rebuilt else 0.0
                                for j in targets])
                lo -= pad[:, None]
                hi += pad[:, None]
                for j, let in zip(targets, extract_lets(trees[i], Ms[i],
                                                        lo, hi, spec.theta)):
                    lets[(i, j)] = let
                    B[i, j] = let.nbytes
            if i in refreshed and not defer_numeric:
                # rebuilt senders were re-extracted above
                for j in range(P):
                    if j != i and (i, j) in lets and j not in rebuilt:
                        lets[(i, j)] = refresh_let(lets[(i, j)], trees[i],
                                                   Ms[i])

        # 4. receiver plans: re-traverse a pair iff either end was rebuilt;
        #    re-graft iff its LET payload was rebound (deferred with the
        #    payload itself)
        receivers = list(geo.receivers)
        pad_cells = _geometry_pad_cells(trees) if rebuilt else None
        for j in range(P) if not defer_numeric else ():
            if trees[j] is None:
                continue
            r = receivers[j]
            senders = [i for i in range(P) if (i, j) in lets]
            if j not in touched and not any(i in touched for i in senders):
                continue
            old = {rb.sender: rb for rb in r.remote}
            remote = []
            for i in senders:
                if i in rebuilt or j in rebuilt:
                    remote.append(_remote_block(i, lets[(i, j)], trees[j],
                                                spec.theta, backend,
                                                pad_cells, dev))
                elif i in touched:
                    remote.append(_rebind_remote(old[i], lets[(i, j)]))
                else:
                    remote.append(old[i])
            if j in rebuilt:
                local, lm = _plan_pair(trees[j], trees[j], spec.theta, False,
                                       backend, pad_cells, dev)
            else:
                local, lm = r.local, r.local_margin
            receivers[j] = ReceiverPlan(tree=trees[j], sched=scheds[j],
                                        local=local, local_margin=lm,
                                        remote=remote)

        if rebuilt:
            adj = adjacency_from_boxes(adj_boxes)
            deg = float(np.max([len(a) for a in adj]))
            diam = graph_diameter(adj)
            slack = _slack_budget(P, spec.theta, receivers, lets)
        else:
            deg, diam, slack = geo.adjacency_degree, geo.diameter, geo.slack

        # deferred-mirror bookkeeping: a rebuild synced everything up front;
        # otherwise carry the prior stale partitions (minus any recomputed)
        prior = set() if rebuilt else set(geo.Ms_stale)
        stale = tuple(sorted((prior | refreshed) if defer_numeric
                             else (prior - refreshed)))
        return GeometryPlan(
            spec=spec, n=geo.n, x0=new_x, q0=new_q, x_ref=x_ref,
            part=geo.part, owners=geo.owners, boxes=boxes,
            adj_boxes=adj_boxes, trees=trees, scheds=scheds, Ms=Ms, lets=lets,
            receivers=receivers, bytes_matrix=B, adjacency_degree=deg,
            diameter=diam, slack=slack,
            partition_stats=geo.partition_stats, version=geo.version + 1,
            Ms_stale=stale)
