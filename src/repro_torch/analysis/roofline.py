"""Three-term roofline from dry-run artifacts, the port of
`repro.analysis.roofline`, on the H100's constants.

    compute term    = FLOPs_per_rank / peak_FLOPs
    memory term     = HBM_bytes_per_rank / HBM_bw
    collective term = collective_bytes_per_rank / (links * link_bw)

The formula is the reference's, unchanged.  FLOPs: the walked dot FLOPs of
the rank's program (`analysis.hlo_walk`).  Those come in two conventions.
`dot_flops` is the reference's: K4 and K5 report the reference's dots for
what they compute, and the reference's attention is plain dots over every
(query, key) pair.  `port.dot_flops_card` is the card's: each kernel's own
operations in their place, so K4 counts only the pairs that its causal
mask and window admit.  A `Chip` with `card_flops` (the H100) reads the
card's figure where the artifact or the walk has one; the v5e constants
read the reference's.  Memory bytes: 2x the walked result bytes (reads ~
writes).  Collective bytes: the per-rank result bytes of the
communicators' collectives.

The card's constants are a frozen `Chip`.  `H100_SXM` is the default: one
NVIDIA H100 SXM5 80GB at its full 700 W (NVIDIA H100 Tensor Core GPU data
sheet): 989e12 FLOP/s dense bfloat16 on the tensor cores, 3.35e12 B/s of
HBM3, and 18 fourth-generation NVLink links of 25e9 B/s a direction (900
GB/s both ways in all); they are the peaks `PERF.md` §6's kernel bounds
use.  `V5E` holds the reference's TPU v5e constants, so that a test can
hold the formula to the reference's; no TPU figure is the port's default.

MODEL_FLOPS = 6 N D (train) / 2 N D (inference) per token with N = active
params; the ratio MODEL_FLOPS / walked FLOPs measures how much of the
program's compute is "useful".
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

__all__ = ["Chip", "H100_SXM", "V5E", "Roofline", "model_flops_per_step",
           "roofline_from_artifact", "load_artifacts"]


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float           # bf16 FLOP/s
    hbm_bw: float               # B/s
    link_bw: float              # B/s per link, one direction
    n_links: int
    card_flops: bool            # the kernels' own FLOPs, not the reference's


H100_SXM = Chip("NVIDIA H100 SXM5 80GB (700 W)", 989e12, 3.35e12, 25e9, 18,
                True)
V5E = Chip("TPU v5e (the reference's constants)", 197e12, 819e9, 50e9, 3,
           False)


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def fraction_of_roofline(self) -> float:
        """compute_time / bound_time: 1.0 = perfectly compute-bound."""
        return self.compute_s / max(self.bound_s, 1e-30)


def model_flops_per_step(rec: dict) -> float:
    """6*N_active*D for train, 2*N_active*D for inference (whole step,
    all ranks)."""
    from repro_torch.configs import SHAPES
    n_act = rec["active_params"]
    sh = SHAPES[rec["shape"]]
    if sh.kind == "train":
        return 6.0 * n_act * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * n_act * sh.global_batch * sh.seq_len
    return 2.0 * n_act * sh.global_batch          # one token per sequence


def roofline_from_artifact(rec: dict, walked: dict | None = None,
                           chip: Chip = H100_SXM) -> dict:
    n_ranks = 1
    for d in rec["mesh"]:
        n_ranks *= d
    if walked is not None:
        flops_dev = walked["dot_flops"]
        mem_dev = walked.get("result_bytes", 0.0) * 2.0
        coll_dev = walked["total_collective_bytes"]
    else:
        flops_dev = rec.get("flops") or 0.0
        mem_dev = rec.get("bytes_accessed") or 0.0
        coll_dev = rec["collectives"]["total_bytes"]
    if chip.card_flops:
        src = walked if walked is not None and "port" in walked else rec
        flops_dev = src.get("port", {}).get("dot_flops_card", flops_dev)
    r = Roofline(
        compute_s=flops_dev / chip.peak_flops,
        memory_s=mem_dev / chip.hbm_bw,
        collective_s=coll_dev / (chip.n_links * chip.link_bw),
    )
    mflops = model_flops_per_step(rec)
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": "x".join(map(str, rec["mesh"])),
        "compute_s": r.compute_s, "memory_s": r.memory_s,
        "collective_s": r.collective_s, "dominant": r.dominant,
        "bound_s": r.bound_s,
        "roofline_fraction": r.fraction_of_roofline,
        "model_flops": mflops,
        "hlo_flops_dev": flops_dev,
        "useful_ratio": mflops / max(flops_dev * n_ranks, 1e-30),
        "collective_GB_dev": coll_dev / 1e9,
        "mem_GB_args": rec["memory"].get("argument_size_in_bytes", 0) / 1e9,
        "mem_GB_temp": rec["memory"].get("temp_size_in_bytes", 0) / 1e9,
    }


def load_artifacts(art_dir: str, pattern: str = "") -> list[dict]:
    out = []
    for f in sorted(os.listdir(art_dir)):
        if not f.endswith(".json") or pattern not in f:
            continue
        with open(os.path.join(art_dir, f)) as fh:
            out.append(json.load(fh))
    return out
