"""Error-feedback int8 gradient compression, the reference's
`repro.train.grad_compress`: per-tensor scale, no stochastic rounding, the
quantisation residual carried to the next step.  No training path calls
it (the reference's neither): it is the piece of a data-parallel
all-reduce that would send a quarter of the bytes.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "decompress_tree", "init_errors"]


def quantize_int8(x):
    """(int8 values, float32 0-d scale): round(x / scale) clipped to
    [-127, 127], scale = max(max|x|, 1e-12) / 127."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_tree(grads, errors):
    """Returns (quantized tree, scales tree, new error-feedback tree)."""
    qs, ss, es = [], [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(errors)):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        qs.append(q)
        ss.append(s)
        es.append(g32 - dequantize_int8(q, s))
    return tuple(tree_unflatten(grads, t) for t in (qs, ss, es))


def decompress_tree(qs, ss):
    return tree_unflatten(qs, [dequantize_int8(q, s) for q, s in
                               zip(tree_leaves(qs), tree_leaves(ss))])


def init_errors(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
