"""Legacy multi-partition FMM entry points — thin shims over the port's api.

The port of `repro.core.distributed_fmm`.  The paper's pipeline lives in
three composable layers (see repro_torch.core.api): `plan_geometry` (partitioning + local trees + batched LET
extraction + receiver interaction plans, protocol-free), `schedule_comm`
(cheap pure protocol scheduling over the frozen bytes matrix) and
`FMMSession` (device-resident execution, protocol sweeps, and MAC-slack
timestep revalidation).

`run_distributed_fmm` and `build_distributed_plan` are retained as
*deprecated* shims that compose those layers exactly as the monolithic
implementation did — tests pin them bit for bit to the layered path.  Each
warns `DeprecationWarning` exactly once per process.  Both plan and
execute on `device` (None: the card, with K3 in planning and K1 in the
near field); `device="cpu"` runs the plain versions.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import api
from repro_torch.core.api import (DEFAULT_SFC_BOX_INFLATION, PartitionSpec,
                                  execute_geometry)
from repro_torch.device import resolve_device

__all__ = ["DistributedFMM", "DistributedPlan", "build_distributed_plan",
           "execute_distributed_plan", "run_distributed_fmm",
           "DEFAULT_SFC_BOX_INFLATION"]

_DEPRECATION_WARNED: set = set()


def _warn_once(name: str, replacement: str) -> None:
    if name in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(name)
    warnings.warn(
        f"{name} is deprecated; use {replacement} from "
        "repro_torch.core.api "
        "(one GeometryPlan serves all protocols and timesteps)",
        DeprecationWarning, stacklevel=3)


@dataclass
class DistributedFMM:
    phi: np.ndarray                      # potential, original body order
    bytes_matrix: np.ndarray             # (P, P) LET bytes i -> j
    schedule_stats: dict
    loggp_time: float
    partition_stats: dict
    n_stages: int
    adjacency_degree: float
    diameter: int


@dataclass
class DistributedPlan:
    """Legacy fused plan: one GeometryPlan + one CommSchedule flattened into
    the pre-layering shape `execute_distributed_plan` consumes."""
    n: int
    nparts: int
    theta: float
    p: int
    part: np.ndarray
    owners: list
    boxes: np.ndarray
    adj_boxes: np.ndarray
    trees: list
    Ms: list                                     # per-partition multipoles (np)
    lets: dict                                   # (i, j) -> LETData
    receivers: list                              # api.ReceiverPlan per partition
    bytes_matrix: np.ndarray
    schedule_stats: dict
    loggp_time: float
    n_stages: int
    adjacency_degree: float
    diameter: int
    partition_stats: dict = field(default_factory=dict)


def _spec(nparts, method, theta, ncrit, p, sfc_box_inflation) -> PartitionSpec:
    return PartitionSpec(nparts=nparts, method=method, theta=theta,
                         ncrit=ncrit, p=p,
                         sfc_box_inflation=sfc_box_inflation)


def build_distributed_plan(x, q, nparts: int = 8, method: str = "orb",
                           protocol: str = "hsdx", theta: float = 0.5,
                           ncrit: int = 64, p: int = 4,
                           grain_bytes: int | None = None,
                           check_delivery: bool = True,
                           sfc_box_inflation: float = DEFAULT_SFC_BOX_INFLATION,
                           *, device=None) -> DistributedPlan:
    """Deprecated: `api.plan_geometry` + `api.schedule_comm` compose the same
    artifacts without fusing the protocol into the geometry."""
    _warn_once("build_distributed_plan", "plan_geometry/schedule_comm")
    geo = api.plan_geometry(
        x, q, _spec(nparts, method, theta, ncrit, p, sfc_box_inflation),
        device=device)
    cs = api.schedule_comm(geo, protocol, grain_bytes=grain_bytes,
                           check_delivery=check_delivery)
    return DistributedPlan(
        n=geo.n, nparts=geo.nparts, theta=geo.theta, p=geo.p, part=geo.part,
        owners=geo.owners, boxes=geo.boxes, adj_boxes=geo.adj_boxes,
        trees=geo.trees, Ms=geo.Ms, lets=geo.lets, receivers=geo.receivers,
        bytes_matrix=geo.bytes_matrix, schedule_stats=cs.stats,
        loggp_time=cs.loggp_time, n_stages=cs.n_stages,
        adjacency_degree=geo.adjacency_degree, diameter=geo.diameter,
        partition_stats=geo.partition_stats,
    )


def execute_distributed_plan(plan: DistributedPlan,
                             use_kernels: bool | None = None, *,
                             device=None) -> np.ndarray:
    """Kernels + gathers only: no traversal, no list building, no padding."""
    return execute_geometry(plan, use_kernels=use_kernels, device=device)


def run_distributed_fmm(x, q, nparts: int = 8, method: str = "orb",
                        protocol: str = "hsdx", theta: float = 0.5,
                        ncrit: int = 64, p: int = 4,
                        grain_bytes: int | None = None,
                        check_delivery: bool = True,
                        sfc_box_inflation: float = DEFAULT_SFC_BOX_INFLATION,
                        *, device=None) -> DistributedFMM:
    """Deprecated: `api.FMMSession.potentials` evaluates the same pipeline
    with plan reuse across protocols/timesteps."""
    _warn_once("run_distributed_fmm", "FMMSession.potentials")
    dev = resolve_device(device)
    geo = api.plan_geometry(
        x, q, _spec(nparts, method, theta, ncrit, p, sfc_box_inflation),
        device=dev)
    cs = api.schedule_comm(geo, protocol, grain_bytes=grain_bytes,
                           check_delivery=check_delivery)
    phi = execute_geometry(geo, device=dev)
    return DistributedFMM(
        phi=phi, bytes_matrix=geo.bytes_matrix, schedule_stats=cs.stats,
        loggp_time=cs.loggp_time, partition_stats=geo.partition_stats,
        n_stages=cs.n_stages, adjacency_degree=geo.adjacency_degree,
        diameter=geo.diameter,
    )
