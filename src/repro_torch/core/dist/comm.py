"""The collectives a rank program runs: stacked ranks or a process group.

The counterpart of `shard_map`'s collectives in `repro.core.dist`.  A
`shard_map` rank function calls its collectives from inside; one process
cannot loop over ranks that way, so the port's rank programs run in steps
(pack, exchange, compute) over the pools of every rank a process holds,
and a communicator moves the buffers of one exchange round between them.
Both implementations have one small interface:

  local_ranks : the ranks this process holds, in the order of the leading
                axis of every buffer it passes (L of them);
  n_ranks     : D, the ranks of the whole program;
  device      : where the buffers live;
  all_to_all(buf)        : (L, D, seg) -> (L, D, seg), rank s's received
                           block r is rank r's block s;
  ppermute(buf, perm)    : (L, cap) -> (L, cap) along ((src, dst), ...),
                           zeros at a rank that is nobody's destination;
  all_gather(t)          : (L, ...) -> (D, ...), every rank's row.

`StackedComm` holds all D ranks in this process on one device: an
all_to_all is a transpose of the stacked buffers and a ppermute an indexed
copy (on the card, copies within its memory).  `GroupComm` holds one rank
per process of a `torch.distributed` group: `all_to_all_single` on the
contiguous (D * seg) buffer, `batch_isend_irecv` over the pairs that involve
this rank, and `all_gather`.  A gloo group moves CPU tensors only: CUDA
tensors over it raise instead of being copied through the host.
"""
from __future__ import annotations

import torch

__all__ = ["StackedComm", "GroupComm"]


class StackedComm:
    """All `n_ranks` ranks in this process, their buffers stacked (D, ...)
    on one device."""

    def __init__(self, n_ranks: int, device):
        if int(n_ranks) < 1:
            raise ValueError(f"n_ranks: need at least one rank, got "
                             f"{n_ranks}")
        self.n_ranks = int(n_ranks)
        self.local_ranks = tuple(range(self.n_ranks))
        self.device = torch.device(device)
        self._perms: dict = {}

    def _check(self, buf: torch.Tensor) -> None:
        if buf.shape[0] != self.n_ranks:
            raise ValueError(f"stacked buffers need a leading axis of "
                             f"{self.n_ranks} ranks, got {tuple(buf.shape)}")

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        self._check(buf)
        return buf.transpose(0, 1).contiguous()

    def ppermute(self, buf: torch.Tensor, perm) -> torch.Tensor:
        self._check(buf)
        out = torch.zeros_like(buf)
        if perm:
            key = (tuple(perm), buf.device)
            idx = self._perms.get(key)
            if idx is None:
                idx = torch.tensor(perm, dtype=torch.int64,
                                   device=buf.device).T
                self._perms[key] = idx
            out[idx[1]] = buf[idx[0]]
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self._check(t)
        return t


class GroupComm:
    """One rank per process of an initialised `torch.distributed` group
    (`group=None`: the default group)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("GroupComm needs an initialised "
                               "torch.distributed process group")
        self._dist = dist
        self.group = group
        self.n_ranks = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local_ranks = (self.rank,)
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        if self.backend == "gloo" and self.device.type != "cpu":
            raise ValueError(f"a gloo group moves CPU tensors only; got "
                             f"device {self.device} (use an nccl group for "
                             f"CUDA tensors)")

    def _peer(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def _check(self, buf: torch.Tensor) -> None:
        if buf.device != self.device:
            raise ValueError(f"buffer on {buf.device}, communicator on "
                             f"{self.device}")
        if buf.shape[0] != 1:
            raise ValueError(f"a group rank passes its own buffer only: "
                             f"leading axis 1, got {tuple(buf.shape)}")

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        self._check(buf)
        send = buf.contiguous()
        out = torch.empty_like(send)
        self._dist.all_to_all_single(out.view(-1), send.view(-1),
                                     group=self.group)
        return out

    def ppermute(self, buf: torch.Tensor, perm) -> torch.Tensor:
        self._check(buf)
        send = buf.contiguous()
        out = torch.zeros_like(send)
        ops = []
        for s, d in perm:
            if s == self.rank:
                ops.append(self._dist.P2POp(self._dist.isend, send[0],
                                            self._peer(d), self.group))
            if d == self.rank:
                ops.append(self._dist.P2POp(self._dist.irecv, out[0],
                                            self._peer(s), self.group))
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self._check(t)
        row = t[0].contiguous()
        parts = [torch.empty_like(row) for _ in range(self.n_ranks)]
        self._dist.all_gather(parts, row, group=self.group)
        return torch.stack(parts)
