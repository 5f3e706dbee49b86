"""Batched serving engine: continuous batching over a fixed slot grid.

Requests arrive with prompts of varying length; the engine packs them into
B slots, prefills them right-aligned to a common length into the shared
S_max cache, and decodes one token per step for every live slot, retiring
finished slots and admitting queued requests (slot reuse = continuous
batching).  At a batch boundary the live requests are prefilled again with
their prompt plus what they have generated, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, B: int = 4, S_max: int = 128):
        self.model, self.B, self.S_max = model, B, S_max
        self.queue: list[Request] = []
        self.slots: list[Request | None] = [None] * B
        self.pos = 0
        self.cache = None
        self.finished: list[Request] = []
        self._next = None

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit_and_prefill(self) -> bool:
        """Pack queued prompts to a common length and prefill the batch."""
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.pop(0)
        # context = prompt + already-generated tokens (batch-boundary refill
        # must not lose the continuation of still-running requests)
        ctx = {i: (r.prompt + r.out) for i, r in enumerate(self.slots)
               if r is not None}
        if not ctx:
            return False
        L = max(len(c) for c in ctx.values())
        toks = np.zeros((self.B, L), np.int64)
        for i, c in ctx.items():    # right-align so decode position is shared
            toks[i, L - len(c):] = c
        self.cache, logits = self.model.prefill(
            torch.as_tensor(toks, device=self.model.device), S_max=self.S_max)
        self.pos = L
        self._emit(logits)
        return True

    def _emit(self, logits):
        """Greedy next token of every slot; append it to the live requests."""
        tok = logits[:, -1, :].argmax(-1)
        self._next = tok[:, None]
        for i, t in enumerate(tok.tolist()):
            r = self.slots[i]
            if r is None or r.done:
                continue
            r.out.append(t)
            self._retire(i)

    def _retire(self, i):
        r = self.slots[i]
        if r is not None and len(r.out) >= r.max_new:
            r.done = True
            self.finished.append(r)
            self.slots[i] = None    # slot reuse (continuous batching)

    def step(self):
        logits, self.cache = self.model.decode_step(self.cache, self._next,
                                                    self.pos)
        self.pos += 1
        self._emit(logits)

    def run(self, max_steps: int = 64) -> list[Request]:
        if not self._admit_and_prefill():
            return self.finished
        for _ in range(max_steps):
            if all(s is None for s in self.slots):
                if not self.queue:
                    break
                if not self._admit_and_prefill():
                    break
                continue
            if any(s is None for s in self.slots) and self.queue:
                # batch boundary: refill free slots (continuous batching);
                # running requests keep their full context via re-prefill
                if not self._admit_and_prefill():
                    break
                continue
            self.step()
            if self.pos >= self.S_max - 1:
                break
        self.finished.extend(r for r in self.slots if r is not None)
        return self.finished
