"""Multi-rank exchange engine: the paper's LET protocols as rank programs.

The port of `repro.core.dist`.  The fourth pipeline tier made distributed:
`plan_geometry` (host geometry) -> `schedule_comm` (modeled protocol
schedules) -> **dist exchange** (this package: the modeled schedule executed
as rank programs over a communicator) -> the engine's phase functions per
rank.

  layout.py   : one shared pool word space over every inter-rank LET span:
                52 float32 words per cell / 8 per body, so span bytes equal
                `GeometryPlan.bytes_matrix` exactly, plus per-rank
                pack/unpack gather tables (NumPy);
  programs.py : bulk all_to_all, grain-chunked ppermute rounds, and the
                HSDX relay tree, each built from (and checked equal to) the
                `protocols.Schedule` the LogGP model costs, and the round
                executor `apply_exchange`;
  comm.py     : the collectives: `StackedComm` (all ranks in one process,
                on one device) and `GroupComm` (one rank per
                `torch.distributed` process);
  engine.py   : `ShardedEngine`: the batched engine's stacked envelopes
                split over the ranks, the exchange wedged between the
                upward pass and the far field, halo-mapped M2L/M2P/P2P (K1
                on every rank), float64 accumulation on the device.

Entry points: `launch.mesh.stacked_mesh(n)` / `group_mesh()` for a mesh,
`api.FMMSession(mesh=...)` for session-level dispatch.
"""
from repro_torch.core.dist.engine import (ExchangeVerificationError,
                                          ShardedEngine)
from repro_torch.core.dist.layout import (CELL_WORDS, BODY_WORDS, WireLayout,
                                          WireTables, build_wire_layout,
                                          build_wire_tables)
from repro_torch.core.dist.programs import (DIST_PROTOCOLS, ExchangeProgram,
                                            Round, apply_exchange,
                                            build_exchange_program,
                                            predicted_time, rank_schedule,
                                            round_tables)

__all__ = ["ShardedEngine", "CELL_WORDS", "BODY_WORDS", "WireLayout",
           "WireTables", "build_wire_layout", "build_wire_tables",
           "DIST_PROTOCOLS", "ExchangeProgram", "Round", "apply_exchange",
           "build_exchange_program", "predicted_time", "rank_schedule",
           "round_tables", "ExchangeVerificationError"]
