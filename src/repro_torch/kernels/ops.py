"""K1 launched at its autotuned launch shape.

The port of `repro.kernels.ops.p2p_auto`.  The reference's module also
wraps its other kernels for interpret mode; the port's kernel wrappers
(`kernels.p2p`, `attention`, `rwkv`) pick the kernel or its plain version
by the tensors' device themselves, so only the autotuned P2P needs a
module here.
"""
from __future__ import annotations

from repro_torch.kernels import p2p as _p2p

__all__ = ["p2p_auto"]


def p2p_auto(q, x_src, x_tgt):
    """K1 with the warps a block tuned for the bucket's shape class.

    q (P, S), x_src (P, S, 3), x_tgt (P, T, 3) float32 -> (P, T) float32.
    On the card the class (S, P, T) is looked up in the autotune cache
    (`kernels.p2p.best_p2p_warps`), which times the candidates on this
    call's own tensors the first time it meets the class, and K1 launches
    with the choice (one count in `kernels.p2p.launches`).  CPU tensors run
    the plain version `p2p_ref`, as `kernels.p2p.p2p` does, and consult no
    cache."""
    _p2p._check(q, x_src, x_tgt)
    if q.device.type == "cpu":
        return _p2p.p2p_ref(q, x_src, x_tgt)
    _p2p._check_cuda(q, x_src, x_tgt)
    P, S = q.shape
    warps = _p2p.best_p2p_warps(S, P, x_tgt.shape[1],
                                sample=(q, x_src, x_tgt))
    return _p2p.p2p(q, x_src, x_tgt, warps=warps)
