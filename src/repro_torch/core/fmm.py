"""Per-tree pieces of the FMM evaluator that the geometry plan needs.

The port of three parts of `repro.core.fmm`: the float64 direct-sum oracle
`direct_potential`, the per-tree `upward_pass` (P2M at the leaves, then M2M
level by level) that `plan_geometry` runs for the LET payload multipoles,
and the plain masked P2P values `_p2p_vals`.  The reference's per-tree
executors (`*_apply`, `execute_fmm_plan`) come in a later slice; the batched
engine (repro_torch.core.engine) is the evaluator of this one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.multipole import MultipoleOperators
from repro_torch.core.plan import TreeSchedules, build_tree_schedules
from repro_torch.core.tree import Tree
from repro_torch.device import resolve_device
from repro_torch.kernels.p2p import p2p_ref

__all__ = ["direct_potential", "upward_pass"]


def direct_potential(x, q, x_tgt=None, chunk: int = 2048,
                     device=None) -> np.ndarray:
    """O(N^2) float64 oracle (self-interaction excluded), computed on
    `device` (None: the card) in float64 and returned as a host array."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)
    q = torch.as_tensor(np.asarray(q, dtype=np.float64), device=dev)
    xt = x if x_tgt is None else torch.as_tensor(
        np.asarray(x_tgt, dtype=np.float64), device=dev)
    out = torch.zeros(len(xt), dtype=torch.float64, device=dev)
    for s in range(0, len(xt), chunk):
        d = xt[s:s + chunk, None, :] - x[None, :, :]
        r2 = (d * d).sum(-1)
        inv = torch.where(r2 > 0, 1.0 / torch.sqrt(r2.clamp_min(1e-300)),
                          torch.zeros((), dtype=r2.dtype, device=dev))
        out[s:s + chunk] = inv @ q
    return out.cpu().numpy()


def _p2p_vals(xt, xs, qs, mask):
    """Plain masked P2P values: xt (B, T, 3), xs (B, S, 3), qs (B, S),
    mask (B,) -> (B, T)."""
    return p2p_ref(qs, xs, xt) * mask[:, None]


def upward_pass(tree: Tree, ops: MultipoleOperators,
                sched: TreeSchedules | None = None) -> torch.Tensor:
    """P2M at leaves, then M2M level-by-level (deepest first). -> (C, nk)
    float32 on the operator set's device."""
    if sched is None:
        sched = build_tree_schedules(tree)
    dev = ops.device

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    x = t(tree.x, torch.float32)
    q = t(tree.q, torch.float32)
    leaf_idx = t(sched.leaf_idx)
    xi = x[leaf_idx]
    qi = torch.where(t(sched.leaf_valid), q[leaf_idx],
                     torch.zeros((), device=dev))
    M_leaf = (ops.p2m(qi, xi, t(sched.leaf_centers))
              * t(sched.leaf_mask)[:, None])
    M = torch.zeros(sched.n_cells, ops.nk, dtype=torch.float32, device=dev)
    M.index_add_(0, t(sched.leaves), M_leaf)
    for ls in reversed(sched.levels):
        contrib = ops.m2m(M[t(ls.ids)], t(ls.d)) * t(ls.mask)[:, None]
        M.index_add_(0, t(ls.parents), contrib)
    return M
