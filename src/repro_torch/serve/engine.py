"""Batched serving engine: continuous batching over a fixed slot grid.

Requests arrive with prompts of varying length; the engine packs them into
B slots, prefills them right-aligned to a common length into the shared
S_max cache, and decodes one token per step for every live slot, retiring
finished slots and admitting queued requests (slot reuse = continuous
batching).  At a batch boundary the live requests are prefilled again with
their prompt plus what they have generated, as the reference does.

The decode step is one CUDA graph replay on the card (`graph=None` or True;
the reference decodes as one `jax.jit` program): captured at the first
prefill over static tokens, position, cache and logits, every prefill's
cache is copied into the static cache, and each step copies the next
tokens and position in and replays.  On the CPU (`graph=None` there means
off) `graph=True` runs the step eagerly over the same static buffers;
`graph=False` calls `model.decode_step` on the prefill's cache.  A cache
entry is a flat dict of tensors per superblock (gemma3's rings and the
MoE layers' caches alike, hymba's SSM state and conv tail), which
`_bind_cache` copies key by key; the MoE sublayers read nothing back to the
host, so their step captures too.  The greedy choice and its `tolist()`
stay outside the graph.

`par` (the reference's argument and default, `Parallelism(remat=
False)`) goes to every prefill and decode step: under a mesh with a model
axis the model runs on the model ranks' blocks (`models.tp`; the engine's
model holds them), and the step still captures as one graph.

The engine prefills tokens only, as the reference's does, so it refuses
the encoder-decoder and vlm models, whose prefill also needs frame or patch
embeddings: they are served through `Model.prefill` and `decode_step`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.graphs import CapturedCall
from repro_torch.sharding.parallel import Parallelism

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, B: int = 4, S_max: int = 128,
                 graph: bool | None = None,
                 par: Parallelism = Parallelism(remat=False)):
        cfg = getattr(model, "cfg", None)
        if cfg is not None and (cfg.is_encdec or cfg.family == "vlm"):
            raise ValueError(
                f"ServeEngine: {cfg.name} needs frame or patch embeddings "
                f"beside its tokens, and the engine prefills tokens only "
                f"(as the reference's does): serve it through "
                f"Model.prefill(tokens, S_max, frames= / vis=) and "
                f"Model.decode_step")
        self.model, self.B, self.S_max, self.par = model, B, S_max, par
        self.graph = (model.device.type == "cuda" if graph is None
                      else bool(graph))
        self.queue: list[Request] = []
        self.slots: list[Request | None] = [None] * B
        self.pos = 0
        self.cache = None
        self.finished: list[Request] = []
        self._next = None
        self._static = None          # static tokens, pos and cache
        self.decode_call = None      # the captured decode step

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
        cache, logits = self.model.prefill(
            torch.as_tensor(toks, device=self.model.device), S_max=self.S_max,
            par=self.par)
        self.cache = self._bind_cache(cache) if self.graph else cache
        self.pos = L
        self._emit(logits)
        return True

    def _bind_cache(self, cache) -> dict:
        """Copy a prefill's cache into the decode step's static cache,
        capturing the step over static buffers at the first call (its
        warm-up writes the static cache, which the copy then overwrites).
        Every prefill of this engine has B rows and S_max, so one capture
        serves them all."""
        if self._static is None:
            dev = self.model.device
            st = {"tokens": torch.zeros(self.B, 1, dtype=torch.long,
                                        device=dev),
                  "pos": torch.zeros((), dtype=torch.long, device=dev),
                  "cache": {"blocks": [{k: torch.zeros_like(v)
                                        for k, v in c.items()}
                                       for c in cache["blocks"]]}}
            self._static = st
            # the step closes over the model, `par` and the static buffers,
            # never over the engine: a closure holding `self` would make
            # the engine and its captured call a reference cycle, and a
            # dropped engine would keep the graph's pool until the cyclic
            # collector ran
            model, par = self.model, self.par
            self.decode_call = CapturedCall(lambda: model.decode_step(
                st["cache"], st["tokens"], st["pos"], par)[:1], dev)
        static = self._static["cache"]
        for dst, src in zip(static["blocks"], cache["blocks"]):
            for k, buf in dst.items():
                buf.copy_(src[k])
        return static

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
        if self.graph:
            self._static["tokens"].copy_(self._next)
            self._static["pos"].fill_(self.pos)
            logits, = self.decode_call.replay()
        else:
            logits, self.cache = self.model.decode_step(
                self.cache, self._next, self.pos, self.par)
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
