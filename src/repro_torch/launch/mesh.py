"""Rank meshes: the multi-rank exchange engine's (`core.dist`) and the LM
tier's named meshes, the port of `repro.launch.mesh`.

A mesh is a `core.dist.comm` communicator with named axes: `axis_names`,
`shape` (a dict, as `jax.sharding.Mesh.shape`) and ranks numbered
row-major over the axes, as `jax.make_mesh` numbers devices.
`FMMSession(mesh=...)` / `ShardedEngine(geometry, mesh)` take either kind,
and `Parallelism(mesh=...)` (`sharding.parallel`) the named ones.

  stacked_mesh(n)  : n ranks stacked in this process on one device (the
                     card unless the CPU is asked for), one axis "ranks";
                     on the card their collectives are copies within its
                     memory;
  group_mesh()     : one rank per process of an initialised
                     `torch.distributed` group (gloo for CPU tensors, nccl
                     for CUDA tensors), e.g. after
                     `init_process_group("gloo", init_method="tcp://
                     localhost:<port>", world_size=D, rank=r)`;
  make_mesh_compat(shape, axes)  : the stacked ranks of a named mesh;
  make_group_mesh(shape, axes)   : the same over a group of prod(shape)
                                   processes;
  make_production_mesh()         : the reference's (16, 16) ('data',
                                   'model') or (2, 16, 16) ('pod', 'data',
                                   'model') TPU layout, 256 or 512 stacked
                                   ranks; it allocates nothing until a
                                   collective runs on it.
"""
from __future__ import annotations

import math

from repro_torch.core.dist.comm import GroupComm, StackedComm
from repro_torch.device import resolve_device

__all__ = ["stacked_mesh", "group_mesh", "make_mesh_compat",
           "make_group_mesh", "make_production_mesh", "parallelism_for",
           "host_device_mesh", "ensure_host_device_count"]


def stacked_mesh(n: int, device=None) -> StackedComm:
    """`n` ranks in this process on `device` (None: the card; raises
    without one)."""
    return StackedComm(n, resolve_device(device))


def group_mesh(group=None, device=None) -> GroupComm:
    """This process's rank of `group` (None: the default group) on
    `device` (None: the card; raises without one, and a gloo group raises
    for a CUDA device)."""
    return GroupComm(group, resolve_device(device))


def make_mesh_compat(shape, axes, device=None) -> StackedComm:
    """A named mesh of prod(shape) ranks stacked in this process on
    `device` (None: the card), ranks row-major over `axes`."""
    return StackedComm(math.prod(shape), resolve_device(device),
                       axis_names=axes, shape=shape)


def make_group_mesh(shape, axes, group=None, device=None) -> GroupComm:
    """A named mesh over the prod(shape) processes of `group` (None: the
    default group), this process being the group's rank, row-major over
    `axes`."""
    return GroupComm(group, resolve_device(device), axis_names=axes,
                     shape=shape)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production layout as stacked ranks: (16, 16)
    ('data', 'model'), or (2, 16, 16) ('pod', 'data', 'model') with
    `multi_pod`.  On the TPU these are chips of one or two v5e pods; here
    they are ranks of one device, which hold nothing until used."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device)


def parallelism_for(mesh, *, hierarchical: bool = True, q_chunk: int = 256,
                    kv_chunk: int = 1024, use_pallas: bool = False,
                    moe_seq_shard: bool = False):
    """The reference's `Parallelism` for a production-style mesh: data
    axes ('pod', 'data') with a pod axis, else ('data',); model axis
    'model'."""
    from repro_torch.sharding.parallel import Parallelism
    multi = "pod" in mesh.axis_names
    return Parallelism(
        mesh=mesh,
        data_axes=("pod", "data") if multi else ("data",),
        model_axis="model",
        pod_axis="pod" if multi else None,
        hierarchical=hierarchical,
        moe_seq_shard=moe_seq_shard,
        q_chunk=q_chunk, kv_chunk=kv_chunk, use_pallas=use_pallas,
    )


def ensure_host_device_count(n: int) -> None:
    """Check that a host mesh of `n` ranks can be made.  The reference
    sets XLA's host-platform device count before JAX starts; stacked ranks
    need no flag (any number of them share one device), so this only
    refuses n < 1.  It is kept so that callers of the reference's API run
    unchanged."""
    if int(n) < 1:
        raise ValueError(f"a host mesh needs at least one rank, got {n}")


def host_device_mesh(n: int, axis: str = "ranks") -> StackedComm:
    """A 1-D mesh of `n` ranks stacked on the CPU under `axis`: the
    reference's host-platform mesh for the exchange engine and its CPU
    tests."""
    ensure_host_device_count(n)
    return StackedComm(n, resolve_device("cpu"), axis_names=(axis,))
