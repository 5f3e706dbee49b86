"""Parallelism descriptor threaded through the model code, the port of
`repro.sharding.parallel`.

Mesh conventions (`launch.mesh`, the reference's production layout):
  single pod : (data=16, model=16)            axes ('data', 'model')
  multi-pod  : (pod=2, data=16, model=16)     axes ('pod', 'data', 'model')

`data_axes` (possibly ('pod', 'data')) carry data parallelism and the
expert weights' FSDP shards; `model_axis` carries expert parallelism.
`hierarchical=True` selects the paper-derived two-stage collectives where
they apply: the train step's gradient reduction runs
`core.collectives.hierarchical_all_reduce` (reduce-scatter over 'data',
all-reduce over 'pod', all-gather over 'data'), so what crosses the pod
axis is 1/|data| of the gradient.  On the TPU the pod axis is the scarce
inter-pod link; here it is a named axis of ranks, and what matters is the
byte count each stage carries.

The mesh is a `core.dist.comm` communicator (`launch.mesh`): ranks stacked
in one process on one device, or one rank per `torch.distributed`
process.  The reference hands layout hints to GSPMD (`constrain`); the
port has no GSPMD, so every collective is explicit (the MoE's all-to-all
and FSDP gather, the train step's gradient reduction) and `constrain`
returns its input.  `remat`, `q_chunk` and `kv_chunk` are kept for parity
and read by nothing: K4 serves every length and the port does not remat
by layer.  `use_pallas` is never read in the reference either (ROADMAP.md,
faults of the reference); K4 and K5 serve attention and WKV whatever it
says.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = ["Parallelism", "NONE"]


@dataclass(frozen=True)
class Parallelism:
    mesh: Any = None                      # a launch.mesh mesh | None
    data_axes: tuple = ()                 # e.g. ('data',) or ('pod', 'data')
    model_axis: str | None = None
    pod_axis: str | None = None
    hierarchical: bool = True             # HSDX-style collectives
    moe_seq_shard: bool = False           # sequence-shard tokens over the
                                          # model axis before routing
    remat: bool = True
    q_chunk: int = 256
    kv_chunk: int = 1024
    use_pallas: bool = False

    @property
    def dp(self):
        """Spec entry for the batch dimension."""
        return self.data_axes if self.data_axes else None

    @property
    def tp(self):
        return self.model_axis

    def dp_size(self) -> int:
        if not self.mesh or not self.data_axes:
            return 1
        out = 1
        for a in self.data_axes:
            out *= self.mesh.shape[a]
        return out

    def tp_size(self) -> int:
        if not self.mesh or not self.model_axis:
            return 1
        return self.mesh.shape[self.model_axis]

    def constrain(self, x, *spec):
        """The reference's `with_sharding_constraint`: a layout hint for
        GSPMD, which the port does not have.  On stacked ranks a tensor is
        the global array, on a group rank that rank's slice; either way
        the hint changes nothing, so `x` is returned as it is."""
        return x


NONE = Parallelism()
