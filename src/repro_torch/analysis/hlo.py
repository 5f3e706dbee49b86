"""Collective bytes per category, the port's counterpart of
`repro.analysis.hlo`.

The reference parses the compiled, post-partitioning HLO text and sums the
result sizes of every all-gather / all-reduce / reduce-scatter / all-to-all
/ collective-permute: shapes there are per device, so the sums are per
device.  The port has no HLO.  Its collectives are calls of a
`core.dist.comm` communicator, and while a walker of `analysis.hlo_walk` is
active each call records its category and the bytes of one rank's result;
`collective_bytes` sums those records in the reference's form.
"""
from __future__ import annotations

from collections import defaultdict

__all__ = ["collective_bytes"]


def collective_bytes(records) -> dict:
    """{"bytes", "counts", "total_bytes"} per category over a walker's
    collective records (`Walker.records`): per-rank result bytes and calls,
    the reference's keys."""
    out = defaultdict(int)
    counts = defaultdict(int)
    for r in records:
        out[r["category"]] += int(r["bytes"])
        counts[r["category"]] += 1
    return {"bytes": dict(out), "counts": dict(counts),
            "total_bytes": sum(out.values())}
