"""Parallelism descriptor threaded through the model code, the port of
`repro.sharding.parallel`.

Mesh conventions (`launch.mesh`, the reference's production layout):
  single pod : (data=16, model=16)            axes ('data', 'model')
  multi-pod  : (pod=2, data=16, model=16)     axes ('pod', 'data', 'model')

`data_axes` (possibly ('pod', 'data')) carry data parallelism and FSDP:
with more than one rank on 'data', each rank holds 1/|data| of its
weight block on the dim where the reference's spec says 'data'
(1/|pod x data| when the weights were placed with `fsdp_pod`, the
reference's `param_shardings(fsdp_pod=)`), all-gathered a superblock at
a time and its gradient reduce-scattered; `model_axis` carries tensor
and expert parallelism.  The weights carry their placement, as the
reference's arguments carry their shardings: `models.tp.shard_model(...,
fsdp_pod=, fsdp=)` cuts them, and the rank program reads the cut off
them (`models.tp.infer_cut`).
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
port has no GSPMD, so every collective is explicit and `constrain`
returns its input.  What reads the fields:

  model_axis  `models.tp` (through `transformer`, `decode`, `moe`): with
              more than one rank on it, the dense, moe, encdec and vlm
              families run on the weight blocks of the 'model' entries of
              the reference's specs (`tp.shard_model`), Megatron-style,
              with one all-reduce over it per sublayer, the MoE's
              all-to-alls, and the vocabulary's all-reduces and
              all-gathers; rwkv6 and hymba read whole leaves;
  data_axes   the batch split of the stacked route (`tp.TP`), the MoE's
              aux mean, the axes the FSDP cut may span and the train
              step's gradient reduction;
  remat       `transformer` (forward and loss): with grad enabled, each
              superblock under `torch.utils.checkpoint`, as the
              reference's `jax.checkpoint` (the serving entry points pass
              `Parallelism(remat=False)`, as the reference's engine does);
  hierarchical, pod_axis  the train step's reduction.

`q_chunk` and `kv_chunk` are kept for parity and read by nothing: K4
serves every length.  `use_pallas` is never read in the reference either
(ROADMAP.md, faults of the reference); K4 and K5 serve attention and WKV
whatever it says.
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
