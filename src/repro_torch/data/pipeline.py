"""Deterministic, shardable, resumable synthetic LM data pipeline: the
port's copy of the reference's `repro.data.pipeline` (NumPy only, so the
same seed gives the same batches token for token).

Tokens are a hash-mixed Markov-ish stream: deterministic in (seed, step,
shard) — `hash` of a tuple of ints is the same in every process — so (a)
every host generates its own shard with zero input I/O and (b)
resume-after-restart is exact: the cursor is one integer in the
checkpoint.  A real deployment swaps this class for a file-backed reader
with the same (state, next_batch) contract.  Batches are NumPy arrays;
the trainer moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DataState", "SyntheticLM"]


@dataclass
class DataState:
    step: int = 0
    seed: int = 0


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_shards: int = 1, shard: int = 0):
        if global_batch % n_shards:
            raise ValueError(f"SyntheticLM: global batch {global_batch} is "
                             f"not a multiple of {n_shards} shards")
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = global_batch // n_shards
        self.shard = shard
        self.state = DataState(0, seed)

    def next_batch(self):
        s = self.state
        rng = np.random.default_rng(
            np.uint64(hash((s.seed, s.step, self.shard)) & 0xFFFFFFFF))
        # mixture of skewed unigram + local repetition (learnable structure)
        base = rng.zipf(1.5, size=(self.batch, self.seq_len + 1)) % self.vocab
        rep = rng.integers(0, self.vocab, (self.batch, 1))
        mask = rng.random((self.batch, self.seq_len + 1)) < 0.3
        seq = np.where(mask, rep, base).astype(np.int32)
        self.state = DataState(s.step + 1, s.seed)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    # ---- checkpoint contract -------------------------------------------
    def snapshot(self) -> dict:
        return {"step": self.state.step, "seed": self.state.seed}

    def restore(self, snap: dict):
        self.state = DataState(int(snap["step"]), int(snap["seed"]))
