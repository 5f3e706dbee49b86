"""Rank meshes for the multi-rank exchange engine (`core.dist`).

The port's counterpart of `repro.launch.mesh.host_device_mesh`: a mesh is a
`core.dist.comm` communicator, and `FMMSession(mesh=...)` /
`ShardedEngine(geometry, mesh)` take either kind.

  stacked_mesh(n)  : n ranks stacked in this process on one device (the
                     card unless the CPU is asked for); on the card their
                     exchange rounds are copies within its memory;
  group_mesh()     : one rank per process of an initialised
                     `torch.distributed` group (gloo for CPU tensors, nccl
                     for CUDA tensors), e.g. after
                     `init_process_group("gloo", init_method="tcp://
                     localhost:<port>", world_size=D, rank=r)`.
"""
from __future__ import annotations

from repro_torch.core.dist.comm import GroupComm, StackedComm
from repro_torch.device import resolve_device

__all__ = ["stacked_mesh", "group_mesh"]


def stacked_mesh(n: int, device=None) -> StackedComm:
    """`n` ranks in this process on `device` (None: the card; raises
    without one)."""
    return StackedComm(n, resolve_device(device))


def group_mesh(group=None, device=None) -> GroupComm:
    """This process's rank of `group` (None: the default group) on
    `device` (None: the card; raises without one, and a gloo group raises
    for a CUDA device)."""
    return GroupComm(group, resolve_device(device))
