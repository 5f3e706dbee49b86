"""Batched multi-tree upward pass: P2M + M2M for every partition at once.

The port of `repro.core.engine.upward`.  The reference vmaps one closure
over the partition axis; here the partition axis is an explicit batch
dimension folded into global ids (`p * n_cells_max + c`, `p * n_bodies_max
+ b`), so each phase is one gather, one batched operator call and one
`index_add_` over all partitions.  Padding rows gather in-range slot 0 and
contribute exactly 0 through their masks.

Level slots are bottom-aligned (slot 0 = each tree's own deepest level), so
M2M always runs children-before-parents even when partition depths differ.
"""
from __future__ import annotations

import torch

__all__ = ["batched_upward_kernel"]


def _offsets(P: int, stride: int, device) -> torch.Tensor:
    return torch.arange(P, device=device, dtype=torch.int64) * stride


def batched_upward_kernel(ops, x, q, tables: dict, n_cells: int):
    """x (P, N, 3) f32, q (P, N) f32 + stacked device tables (the
    `BatchedUpwardSchedule.tables` keys) -> M (P, n_cells, nk) f32."""
    P, N = q.shape
    dev = x.device
    boff = _offsets(P, N, dev)
    coff = _offsets(P, n_cells, dev)
    x_flat = x.reshape(-1, 3)
    q_flat = q.reshape(-1)

    li = tables["leaf_idx"] + boff[:, None, None]          # (P, Bl, W)
    xi = x_flat[li]
    qi = torch.where(tables["leaf_valid"], q_flat[li],
                     torch.zeros((), dtype=q.dtype, device=dev))
    M_leaf = (ops.p2m(qi, xi, tables["leaf_centers"])
              * tables["leaf_mask"][..., None])            # (P, Bl, nk)
    M = torch.zeros(P * n_cells, ops.nk, dtype=torch.float32, device=dev)
    M.index_add_(0, (tables["leaves"] + coff[:, None]).reshape(-1),
                 M_leaf.reshape(-1, ops.nk))

    for lvl in range(tables["up_ids"].shape[1]):           # slot 0 = deepest
        ids = (tables["up_ids"][:, lvl] + coff[:, None]).reshape(-1)
        parents = (tables["up_parents"][:, lvl] + coff[:, None]).reshape(-1)
        contrib = (ops.m2m(M[ids], tables["up_d"][:, lvl].reshape(-1, 3))
                   * tables["up_mask"][:, lvl].reshape(-1, 1))
        M.index_add_(0, parents, contrib)
    return M.reshape(P, n_cells, ops.nk)
