"""The cost hook: where kernels, communicators and stacked-rank code report
to a per-rank cost walker.

A walker (`analysis.hlo_walk.Walker`, used by the dry run and by its check
on the card) sets `ACTIVE` to itself while it runs and restores it after;
this module depends on nothing of the analysis.  The reports:

  report_kernel      one launch of a hand-written kernel (or its meta
                     stand-in): its operations, bytes read and written and
                     the reference's dot FLOPs for the same work;
  record_collective  one call of a communicator's collective: its method,
                     axes and one rank's result bytes;
  stacked(L)         a scope in which one process runs L ranks' work on
                     stacked (L, ...) buffers, so that the walker can give
                     one rank's share;
  checkpoint_contexts  the (forward, recompute) contexts of a
                     `torch.utils.checkpoint` call: a recompute runs with
                     the torch-function modes cleared, so the walker hands
                     back the ones it needs there.

Without a walker each costs one `None` check.  A call site that builds its
report from shapes tests `ACTIVE is not None` first, so that it does no
work at all on the hot path.
"""
from __future__ import annotations

from contextlib import nullcontext

__all__ = ["ACTIVE", "stacked", "report_kernel", "record_collective",
           "checkpoint_contexts"]

ACTIVE = None


def stacked(L: int):
    """A scope of L stacked ranks in the active walker; a no-op without
    one."""
    w = ACTIVE
    if w is None:
        return nullcontext()
    return w.stacked(L)


def report_kernel(name: str, **counts) -> None:
    """A kernel's launch for the active walker; nothing without one."""
    w = ACTIVE
    if w is not None:
        w.kernel(name, **counts)


def record_collective(mesh, method: str, axes, per_rank_bytes) -> None:
    """A collective call for the active walker; nothing without one."""
    w = ACTIVE
    if w is not None:
        w.collective(mesh, method, axes, per_rank_bytes)


def checkpoint_contexts():
    """`context_fn` of a non-reentrant `torch.utils.checkpoint`: (a no-op,
    the active walker's recompute context); two no-ops without one."""
    w = ACTIVE
    return nullcontext(), (w.recompute_context() if w is not None
                           else nullcontext())
