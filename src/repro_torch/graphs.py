"""Calls captured as CUDA graphs: the port's counterpart of a jitted or
fused program, shared by the FMM engine's compiled entries
(`core.engine.exe_cache`) and the LM decode step (`serve.engine`).

`CapturedCall(fn, device)` takes a function of no arguments that reads
static buffers and returns a tuple of tensors.  On a CUDA device it follows
PyTorch's documented pattern: `fn` runs on a side stream first (so the nvcc
build, lazily built tables and any first-call `cudaFuncSetAttribute` happen
there, never during capture), the outputs get buffers of their own
allocated before the capture (outside the graph's private memory pool), and
one call is captured into a `torch.cuda.CUDAGraph` that copies its results
into them.  `replay()` then runs every kernel of that call in one launch.
A failed warm-up or capture raises; nothing falls back to eager calls.
Python's cyclic garbage collector is run before the capture and held off
during it: a dead object that owns a graph and sits in a reference cycle
(none of the port's own does; a caller's may) freed in the middle of a
capture resets that graph, a CUDA call a capturing stream does not
permit, and the capture fails.  `fn` should not close over the object
that holds its `CapturedCall`, or that object is such a cycle.

On the CPU nothing is captured, because the caller asked for the CPU:
`replay()` calls `fn` over the same static buffers.

Launch counts.  The kernel wrappers count their launches in Python, which
a replay does not run.  A capture takes back what the wrappers counted
while it recorded (no kernel ran then), keeps it in `launches`, and every
replay adds it to the wrappers' counters, so the counts stay those of the
kernels that ran.
"""
from __future__ import annotations

import gc
import time

import torch

from repro_torch.kernels import attention, mac, p2p, p2p_stream, rwkv

__all__ = ["CapturedCall", "KERNELS", "launch_counts"]

KERNELS = {"K1": p2p, "K2": p2p_stream, "K3": mac, "K4": attention,
           "K5": rwkv}


def launch_counts() -> dict:
    """{kernel id: its wrapper's `launches` counter}."""
    return {k: m.launches for k, m in KERNELS.items()}


class CapturedCall:
    """`fn()` captured once on `device` (CUDA), or called as is (CPU).

    Attributes on CUDA: `outputs` (the static output buffers a replay
    fills), `launches` ({kernel id: launches a replay makes}), `capture_s`
    (host seconds of warm-up and capture), and `reserved_before` /
    `reserved_after` (`torch.cuda.memory_reserved` around the capture) with
    their difference `pool_bytes`, the graph's private pool."""

    def __init__(self, fn, device, warmup: int = 2):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self.launches: dict = {}
        self.capture_s = 0.0
        self.reserved_before = self.reserved_after = self.pool_bytes = 0
        if self.device.type == "cuda":
            self._capture(warmup)

    def _capture(self, warmup: int) -> None:
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                out = self.fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.outputs = tuple(torch.empty_like(o) for o in out)
        del out
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.reserved_before = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                for o, r in zip(self.outputs, self.fn()):
                    o.copy_(r)
        finally:
            if collecting:
                gc.enable()
            after = launch_counts()
            for k, n in before.items():
                KERNELS[k].launches = n
        torch.cuda.synchronize(dev)
        self.reserved_after = torch.cuda.memory_reserved(dev)
        self.pool_bytes = self.reserved_after - self.reserved_before
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> tuple:
        """Run the call once: one graph replay on CUDA (its kernels' counters
        advanced by what the capture recorded), `fn()` on the CPU."""
        if self.graph is None:
            return tuple(self.fn())
        self.graph.replay()
        for k, n in self.launches.items():
            KERNELS[k].launches += n
        return self.outputs
