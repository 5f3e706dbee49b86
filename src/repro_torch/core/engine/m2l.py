"""Batched far field: one segment-summed M2L over every (receiver, sender)
pair, then the stacked downward sweep and the leaf evaluation.

The port of `repro.core.engine.m2l`.  Every plan's valid M2L rows were
concatenated at table-build time with *global* cell ids
(`p * n_cells_max + c`); they run here in chunks of `M2L_CHUNK` rows, each
one derivative evaluation, one batched (nk x nk) product and one
`index_add_` into the flat local array.  Chunking bounds the transient
(rows, nk, nk) translation matrices: at 2^23 rows a single pass would hold
about 13 GB of them.

M2P fallback rows (truncated remote cells vs large local leaves) batch the
same way against the flat multipole array.
"""
from __future__ import annotations

import torch

from repro_torch.core.multipole import M2L_CHUNK

__all__ = ["far_tail_kernel", "m2p_vals_kernel"]


def _offsets(P: int, stride: int, device) -> torch.Tensor:
    return torch.arange(P, device=device, dtype=torch.int64) * stride


def far_tail_kernel(ops, M, x, m2l: dict, up: dict, M_src=None):
    """M (P, C, nk), x (P, N, 3) + the M2L rows and the stacked downward /
    leaf tables -> padded L2P values (P, Bl, W) f32.  `M_src` holds the
    multipoles the M2L rows' sources index (default M's flat view; the
    multi-rank engine passes its rank's cells followed by the received
    halo cells)."""
    P, C, nk = M.shape
    N = x.shape[1]
    dev = M.device
    M_flat = M.reshape(P * C, nk)
    if M_src is None:
        M_src = M_flat
    L = torch.zeros_like(M_flat)
    for a in range(0, m2l["src"].shape[0], M2L_CHUNK):
        sl = slice(a, a + M2L_CHUNK)
        contrib = (ops.m2l(M_src[m2l["src"][sl]], m2l["d"][sl])
                   * m2l["mask"][sl, None])
        L.index_add_(0, m2l["tgt"][sl], contrib)

    coff = _offsets(P, C, dev)
    for lvl in range(up["down_ids"].shape[1]):             # slot 0 = level 1
        ids = (up["down_ids"][:, lvl] + coff[:, None]).reshape(-1)
        parents = (up["down_parents"][:, lvl] + coff[:, None]).reshape(-1)
        contrib = (ops.l2l(L[parents], up["down_d"][:, lvl].reshape(-1, 3))
                   * up["down_mask"][:, lvl].reshape(-1, 1))
        L.index_add_(0, ids, contrib)

    y = x.reshape(-1, 3)[up["leaf_idx"] + _offsets(P, N, dev)[:, None, None]]
    Lf = L[up["leaves"] + coff[:, None]]                    # (P, Bl, nk)
    return ops.l2p(Lf, y, up["leaf_centers"]) * up["leaf_mask"][..., None]


def m2p_vals_kernel(ops, M, x, b, centers, mask, t_idx, M_src=None):
    """Batched M2P fallback values (B, wt) against flat global multipoles
    (or against `M_src`, as in `far_tail_kernel`)."""
    P, C, nk = M.shape
    if M_src is None:
        M_src = M.reshape(P * C, nk)
    x_flat = x.reshape(-1, 3)
    return ops.m2p(M_src[b], x_flat[t_idx], centers) * mask[:, None]
