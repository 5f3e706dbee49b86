"""Layered FMM API of the port: GeometryPlan -> FMMSession.

The port of the parts of `repro.core.api` on the single-device main path:

  1. `plan_geometry(x, q, PartitionSpec) -> GeometryPlan` — all host-side
     geometry, built once: partitioning, completely local trees, batched
     sender-side LET extraction (`extract_lets` runs once per sender for all
     remote boxes), per-receiver frozen interaction plans against every
     grafted subtree, the (P, P) bytes matrix and the MAC slack budget.  It
     is NumPy throughout except for the per-tree upward pass that fills the
     LET payload multipoles, which runs in PyTorch on `device`.
  2. `FMMSession` — holds a `GeometryPlan` and evaluates it through the
     batched `DeviceEngine` (repro_torch.core.engine).

Planning uses the host dual traversal only: `traversal_backend` accepts
"host", "auto" or None; "device" raises NotImplementedError until the
device traversal is ported.  Protocol schedules, stepping, multi-device
exchange, observability and resilience are later slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace as dc_replace

import numpy as np

from repro_torch.core.engine import DeviceEngine
from repro_torch.core.fmm import upward_pass
from repro_torch.core.hsdx import adjacency_from_boxes, graph_diameter
from repro_torch.core.let import LETData, extract_lets, graft
from repro_torch.core.multipole import get_operators
from repro_torch.core.partition.hot import hot_partition
from repro_torch.core.partition.orb import orb_partition
from repro_torch.core.plan import (InteractionPlan, TreeSchedules,
                                   build_interaction_plan,
                                   build_tree_schedules)
from repro_torch.core.traversal import resolve_traversal_backend
from repro_torch.core.tree import build_tree
from repro_torch.device import resolve_device

__all__ = ["PartitionSpec", "GeometryPlan", "RemoteBlock", "ReceiverPlan",
           "plan_geometry", "FMMSession", "DEFAULT_SFC_BOX_INFLATION"]

# default eps-inflation of SFC partitions' tight boxes when deriving the
# adjacency graph (fraction of the global span); ORB regions share split
# planes exactly and need no inflation
DEFAULT_SFC_BOX_INFLATION = 0.03

_EMPTY_LO, _EMPTY_HI = np.inf, -np.inf      # empty-partition box sentinel


# ------------------------------------------------------------------ specs --
@dataclass(frozen=True)
class PartitionSpec:
    """Geometry parameters: everything `plan_geometry` needs.

    `traversal_backend`: "host", "auto" or None (all the NumPy traversal);
    "device" is not ported yet and raises."""
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
    """Every protocol-independent artifact, built once per geometry."""
    spec: PartitionSpec
    n: int
    x0: np.ndarray               # (N, 3) positions, original order
    q0: np.ndarray               # (N,)   charges
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

    @property
    def nparts(self) -> int:
        return self.spec.nparts

    @property
    def theta(self) -> float:
        return self.spec.theta

    @property
    def p(self) -> int:
        return self.spec.p


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


def _plan_pair(tgt, src, theta: float, with_m2p: bool):
    """Traverse one (target, source) pair on the host and freeze its
    interaction plan; returns (inter, min accepted M2L margin)."""
    inter = build_interaction_plan(tgt, src, theta, with_m2p=with_m2p)
    return inter, _m2l_margin(inter, tgt, src, theta)


def _remote_block(i: int, let: LETData, tree, theta: float) -> RemoteBlock:
    g = graft(let)
    inter, margin = _plan_pair(tree, g, theta, True)
    return RemoteBlock(sender=i, graft=g, inter=inter, margin=margin)


def plan_geometry(x, q, spec: PartitionSpec | None = None, *, device=None,
                  **overrides) -> GeometryPlan:
    """Partition, build local trees, extract every LET (one batched
    `extract_lets` call per sender), traverse every receiver pair.  Keyword
    overrides patch the spec: `plan_geometry(x, q, nparts=16)`.  The LET
    payload multipoles are computed on `device` (None: the card)."""
    spec = dc_replace(spec or PartitionSpec(), **overrides)
    resolve_traversal_backend(spec.traversal_backend)
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    _validate_geometry_inputs(x, q, spec)
    n = len(x)
    P = spec.nparts
    part, boxes, adj_boxes = _partition(
        x, P, spec.method, sfc_box_inflation=spec.sfc_box_inflation)
    ops = get_operators(spec.p, resolve_device(device))

    # --- completely local trees (local bounding box, tight cells; §3) ------
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

    # --- sender-initiated LET extraction: all remote boxes per sender in one
    #     batched frontier pass; empty partitions neither send nor receive --
    lets: dict[tuple[int, int], LETData] = {}
    B = np.zeros((P, P), dtype=np.int64)
    for i in range(P):
        if trees[i] is None:
            continue
        others = np.array([j for j in range(P)
                           if j != i and trees[j] is not None], dtype=np.int64)
        if len(others) == 0:
            continue
        for j, let in zip(others, extract_lets(trees[i], Ms[i],
                                               boxes[others, 0],
                                               boxes[others, 1], spec.theta)):
            lets[(i, int(j))] = let
            B[i, j] = let.nbytes

    # --- receiver side: graft + traverse ONCE into frozen plans ------------
    receivers: list = []
    for j in range(P):
        if trees[j] is None:
            receivers.append(None)
            continue
        t = trees[j]
        local, local_margin = _plan_pair(t, t, spec.theta, False)
        remote = [_remote_block(i, lets[(i, j)], t, spec.theta)
                  for i in range(P) if (i, j) in lets]
        receivers.append(ReceiverPlan(tree=t, sched=scheds[j], local=local,
                                      local_margin=local_margin,
                                      remote=remote))

    adj = adjacency_from_boxes(adj_boxes)
    deg = float(np.max([len(a) for a in adj]))
    return GeometryPlan(
        spec=spec, n=n, x0=x.copy(), q0=q.copy(), x_ref=x.copy(),
        part=part, owners=owners, boxes=boxes, adj_boxes=adj_boxes,
        trees=trees, scheds=scheds, Ms=Ms, lets=lets,
        receivers=receivers, bytes_matrix=B,
        adjacency_degree=deg, diameter=graph_diameter(adj),
        slack=_slack_budget(P, spec.theta, receivers, lets),
        partition_stats=dict(nparts=P, method=spec.method),
    )


# --------------------------------------------------------------- layer 3 ---
class FMMSession:
    """One geometry evaluated through the batched `DeviceEngine`.

    `device=None` runs on the card (raises without one); pass
    `device="cpu"` to run on the CPU, where the kernel wrappers use their
    plain versions.  `p2p_stream` selects the streaming near field (K2)
    over the gathered buckets (K1, the default)."""

    def __init__(self, geometry: GeometryPlan, *, device=None,
                 p2p_stream: bool = False):
        if not (hasattr(geometry, "receivers")
                and hasattr(geometry, "bytes_matrix")):
            raise ValueError(
                f"geometry: expected a GeometryPlan (plan_geometry(...) "
                f"output), got {type(geometry).__name__}")
        self._geo = geometry
        self.device = resolve_device(device)
        self.p2p_stream = bool(p2p_stream)
        self._engine = None

    @classmethod
    def from_points(cls, x, q, spec: PartitionSpec | None = None, *,
                    device=None, p2p_stream: bool = False,
                    **overrides) -> "FMMSession":
        dev = resolve_device(device)
        return cls(plan_geometry(x, q, spec, device=dev, **overrides),
                   device=dev, p2p_stream=p2p_stream)

    @property
    def geometry(self) -> GeometryPlan:
        return self._geo

    @property
    def engine(self) -> DeviceEngine:
        """The session's `DeviceEngine`, built on first access."""
        if self._engine is None:
            self._engine = DeviceEngine.from_geometry(
                self._geo, device=self.device, p2p_stream=self.p2p_stream)
        return self._engine

    def evaluate(self) -> np.ndarray:
        """Run the engine now; returns the potential in original body order
        (float64, host, read-only)."""
        phi = self.engine.evaluate()
        phi.setflags(write=False)
        return phi
