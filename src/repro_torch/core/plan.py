"""Interaction plans: the plan/execute split for the FMM host pipeline.

Host-side NumPy, as in the JAX reference (`repro.core.plan`), kept
output-identical to it.  Plan *construction* (dual-tree traversal, pair-list
padding and bucketing, leaf body-gather index tables, per-level
upward/downward schedules) happens here; the batched device engine
(repro_torch.core.engine) stacks these frozen tables across partitions and
executes them with no list construction or padding work.

Key structures:

  - `InteractionPlan` — padded M2L pair arrays (with precomputed f32
    displacement vectors), P2P pair *blocks bucketed by source-leaf width*
    (one huge boundary leaf in a grafted LET does not force every pair to
    pad to the global maximum), and padded M2P fallback pairs.
  - `TreeSchedules` — padded leaf gathers plus per-level (ids, parents,
    displacement) arrays shared by the upward and downward passes.
  - `FMMPlan` — one (target tree, source tree) evaluation: interactions +
    both trees' schedules.

Every bucket row's body gather is a contiguous run (`padded_body_gather`
emits `body_start + arange`), which is what lets the streaming P2P kernel
read a row as one `(start, length)` slab
(`engine.schedules.build_p2p_stream_tables` verifies it).

All pad widths and bucket sizes are powers of two, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.traversal import dual_traversal
from repro_torch.core.tree import bucket_size

__all__ = [
    "P2PBlock", "InteractionPlan", "LevelSchedule", "TreeSchedules", "FMMPlan",
    "bucket_size", "pad_pairs", "pad_ids", "padded_body_gather",
    "build_p2p_blocks", "build_interaction_plan", "build_tree_schedules",
    "build_fmm_plan",
]

_EMPTY_PAIRS = np.zeros((0, 2), dtype=np.int64)


# ------------------------------------------------------- padding helpers ---
# bucket_size lives in tree.py (one power-of-two rule for plan padding and
# device cell tables alike) and is re-exported here for its historic callers.
def pad_pairs(pairs: np.ndarray):
    """Pad a (n, 2) pair list to a power-of-2 bucket.  Padding replicates the
    first pair: indices stay valid (root cells can be huge) and M2L
    displacements stay nonzero; the mask zeroes the values."""
    n = len(pairs)
    m = bucket_size(max(n, 1))
    out = np.tile(pairs[0], (m, 1)).astype(np.int64) if n else np.zeros((m, 2), np.int64)
    out[:n] = pairs
    mask = np.zeros(m, dtype=np.float32)
    mask[:n] = 1.0
    return out, mask


def pad_ids(ids: np.ndarray, pad_value: int | None = None):
    n = len(ids)
    m = bucket_size(max(n, 1))
    fill = (ids[0] if (pad_value is None and n) else (pad_value or 0))
    out = np.full(m, fill, dtype=np.int64)
    out[:n] = ids
    mask = np.zeros(m, dtype=np.float32)
    mask[:n] = 1.0
    return out, mask


def padded_body_gather(tree, cells: np.ndarray, width: int):
    """(len(cells), width) body gather table: clipped-safe indices + validity
    mask, built with one broadcast (no per-cell loop)."""
    nb = np.asarray(tree.n_body)[cells]
    if width < 1 or int(nb.max(initial=0)) > width:
        # never truncate silently (matches Tree.padded_leaf_bodies)
        raise ValueError("padded_body_gather: cell population exceeds gather width")
    col = np.arange(width, dtype=np.int64)
    idx = np.asarray(tree.body_start)[cells][:, None] + col[None, :]
    valid = col[None, :] < nb[:, None]
    return np.where(valid, idx, 0), valid


# ------------------------------------------------------------ dataclasses --
@dataclass(frozen=True)
class P2PBlock:
    """One bucket of P2P leaf pairs whose source leaves share a padded width."""
    n: int                   # valid pairs
    mask: np.ndarray         # (B,) float32
    t_idx: np.ndarray        # (B, wt) clipped-safe target body gather
    t_valid: np.ndarray      # (B, wt) bool
    s_idx: np.ndarray        # (B, ws) clipped-safe source body gather
    s_valid: np.ndarray      # (B, ws) bool

    @property
    def shape(self):
        return (len(self.mask), self.t_idx.shape[1], self.s_idx.shape[1])


@dataclass(frozen=True)
class InteractionPlan:
    """Padded, bucketed interaction lists for one (target, source) tree pair."""
    n_tgt_cells: int
    n_tgt_bodies: int
    # M2L: padded pair arrays + precomputed displacement vectors
    n_m2l: int
    m2l_a: np.ndarray        # (B,) padded target cell ids
    m2l_b: np.ndarray        # (B,) padded source cell ids
    m2l_mask: np.ndarray     # (B,) float32
    m2l_d: np.ndarray        # (B, 3) float32  tgt_center - src_center
    # P2P: blocks bucketed by source-leaf width
    n_p2p: int
    p2p_blocks: tuple
    # M2P fallback (truncated LET cells vs large local leaves)
    n_m2p: int
    m2p_b: np.ndarray        # (B,) padded source cell ids
    m2p_mask: np.ndarray     # (B,) float32
    m2p_centers: np.ndarray  # (B, 3) float32 source centers
    m2p_t_idx: np.ndarray    # (B, wt)
    m2p_t_valid: np.ndarray  # (B, wt) bool


@dataclass(frozen=True)
class LevelSchedule:
    """One tree level's padded (ids, parents, displacement) arrays — used by
    M2M (child -> parent) and L2L (parent -> child) alike."""
    ids: np.ndarray          # (B,) padded cell ids
    parents: np.ndarray      # (B,)
    mask: np.ndarray         # (B,) float32
    d: np.ndarray            # (B, 3) float32  center[ids] - center[parents]


@dataclass(frozen=True)
class TreeSchedules:
    """Charge-independent schedules for one tree's vertical passes."""
    n_cells: int
    leaves: np.ndarray       # (B,) padded leaf ids
    leaf_mask: np.ndarray    # (B,) float32
    leaf_centers: np.ndarray # (B, 3) float32
    leaf_idx: np.ndarray     # (B, w) clipped-safe body gather
    leaf_valid: np.ndarray   # (B, w) bool
    levels: tuple            # LevelSchedule per level 1..max (top-down order)


@dataclass(frozen=True)
class FMMPlan:
    """Everything needed to evaluate src -> tgt repeatedly with zero host-side
    list construction: build once with `build_fmm_plan`, execute many times
    with `fmm.execute_fmm_plan`."""
    tgt_tree: object
    src_tree: object
    theta: float
    p: int
    interactions: InteractionPlan
    tgt_sched: TreeSchedules
    src_sched: object        # TreeSchedules, or None for grafted LETs
                             # (their multipoles arrive precomputed)


# --------------------------------------------------------------- builders --
def build_p2p_blocks(tgt_tree, src_tree, pairs: np.ndarray,
                     tgt_width: int | None = None) -> tuple:
    """Bucket P2P pairs by power-of-two source-leaf width.

    This replaces the seed's single global source width
    (`src_tree.ncrit == n_body.max()` for grafted LETs), which padded every
    pair to the largest boundary leaf.  Pairs whose source leaves hold 5 and
    500 bodies now land in separate (8-wide and 512-wide) blocks."""
    if len(pairs) == 0:
        return ()
    wt = tgt_width or bucket_size(max(int(tgt_tree.ncrit), 1), lo=8)
    src_nb = np.asarray(src_tree.n_body)[pairs[:, 1]]
    widths = np.maximum(8, 2 ** np.ceil(np.log2(np.maximum(src_nb, 1))).astype(np.int64))
    blocks = []
    for w in np.unique(widths):
        sub = pairs[widths == w]
        padded, mask = pad_pairs(sub)
        t_idx, t_valid = padded_body_gather(tgt_tree, padded[:, 0], wt)
        s_idx, s_valid = padded_body_gather(src_tree, padded[:, 1], int(w))
        blocks.append(P2PBlock(n=len(sub), mask=mask, t_idx=t_idx,
                               t_valid=t_valid, s_idx=s_idx, s_valid=s_valid))
    return tuple(blocks)


def build_interaction_plan(tgt_tree, src_tree, theta: float = 0.5,
                           with_m2p: bool = False,
                           m2l_pairs=None, p2p_pairs=None,
                           m2p_pairs=None,
                           traversal_backend: str | None = None,
                           device=None) -> InteractionPlan:
    """Traverse (unless pair lists are supplied) and freeze the padded /
    bucketed interaction lists for one (target, source) tree pair.

    `traversal_backend` selects where the dual traversal runs: "host" (the
    NumPy float64 reference), "device" (the frontier loop with the MAC
    kernel K3 of repro_torch.core.engine.traversal, on `device`), or
    None/"auto": "device" when `device` (None: the card) is a CUDA device,
    "host" on the CPU."""
    if m2l_pairs is None or p2p_pairs is None:
        from repro_torch.core.engine.traversal import (
            device_dual_traversal, resolve_traversal_backend)
        if resolve_traversal_backend(traversal_backend, device) == "device":
            m2l_pairs, p2p_pairs, m2p_d, _ = device_dual_traversal(
                tgt_tree, src_tree, theta, with_m2p=with_m2p, device=device)
            if with_m2p:
                m2p_pairs = m2p_d
        elif with_m2p:
            m2l_pairs, p2p_pairs, m2p_pairs = dual_traversal(
                tgt_tree, src_tree, theta, with_m2p=True)
        else:
            m2l_pairs, p2p_pairs = dual_traversal(tgt_tree, src_tree, theta)
    m2l_pairs = np.asarray(m2l_pairs, dtype=np.int64).reshape(-1, 2)
    p2p_pairs = np.asarray(p2p_pairs, dtype=np.int64).reshape(-1, 2)
    m2p_pairs = (np.asarray(m2p_pairs, dtype=np.int64).reshape(-1, 2)
                 if m2p_pairs is not None else _EMPTY_PAIRS)

    wt = bucket_size(max(int(tgt_tree.ncrit), 1), lo=8)

    m2l_p, m2l_mask = pad_pairs(m2l_pairs)
    m2l_d = (np.asarray(tgt_tree.center)[m2l_p[:, 0]]
             - np.asarray(src_tree.center)[m2l_p[:, 1]]).astype(np.float32)

    p2p_blocks = build_p2p_blocks(tgt_tree, src_tree, p2p_pairs, tgt_width=wt)

    if len(m2p_pairs):
        m2p_p, m2p_mask = pad_pairs(m2p_pairs)
        m2p_t_idx, m2p_t_valid = padded_body_gather(tgt_tree, m2p_p[:, 0], wt)
        m2p_centers = np.asarray(src_tree.center)[m2p_p[:, 1]].astype(np.float32)
    else:
        m2p_p = np.zeros((0, 2), dtype=np.int64)
        m2p_mask = np.zeros(0, dtype=np.float32)
        m2p_t_idx = np.zeros((0, wt), dtype=np.int64)
        m2p_t_valid = np.zeros((0, wt), dtype=bool)
        m2p_centers = np.zeros((0, 3), dtype=np.float32)

    return InteractionPlan(
        n_tgt_cells=int(tgt_tree.n_cells),
        n_tgt_bodies=len(tgt_tree.x),
        n_m2l=len(m2l_pairs), m2l_a=m2l_p[:, 0], m2l_b=m2l_p[:, 1],
        m2l_mask=m2l_mask, m2l_d=m2l_d,
        n_p2p=len(p2p_pairs), p2p_blocks=p2p_blocks,
        n_m2p=len(m2p_pairs), m2p_b=m2p_p[:, 1], m2p_mask=m2p_mask,
        m2p_centers=m2p_centers, m2p_t_idx=m2p_t_idx, m2p_t_valid=m2p_t_valid,
    )


def build_tree_schedules(tree) -> TreeSchedules:
    """Freeze the leaf gathers and per-level M2M/L2L index arrays of a tree."""
    leaves, leaf_mask = pad_ids(tree.leaves)
    w = bucket_size(max(int(tree.ncrit), 1), lo=8)
    leaf_idx, leaf_valid = padded_body_gather(tree, leaves, w)
    leaf_centers = np.asarray(tree.center)[leaves].astype(np.float32)
    levels = []
    for lvl in range(1, int(tree.level.max()) + 1):
        ids = np.nonzero(tree.level == lvl)[0]
        if len(ids) == 0:
            continue
        ids_p, mask = pad_ids(ids)
        parents = np.asarray(tree.parent)[ids_p]
        d = (np.asarray(tree.center)[ids_p]
             - np.asarray(tree.center)[parents]).astype(np.float32)
        levels.append(LevelSchedule(ids=ids_p, parents=parents, mask=mask, d=d))
    return TreeSchedules(
        n_cells=int(tree.n_cells), leaves=leaves, leaf_mask=leaf_mask,
        leaf_centers=leaf_centers, leaf_idx=leaf_idx, leaf_valid=leaf_valid,
        levels=tuple(levels),
    )


def build_fmm_plan(tgt_tree, src_tree, theta: float = 0.5, p: int = 4,
                   with_m2p: bool = False,
                   m2l_pairs=None, p2p_pairs=None, m2p_pairs=None,
                   traversal_backend: str | None = None,
                   device=None) -> FMMPlan:
    """Build the full plan for evaluating src_tree -> tgt_tree."""
    interactions = build_interaction_plan(
        tgt_tree, src_tree, theta=theta, with_m2p=with_m2p,
        m2l_pairs=m2l_pairs, p2p_pairs=p2p_pairs, m2p_pairs=m2p_pairs,
        traversal_backend=traversal_backend, device=device)
    tgt_sched = build_tree_schedules(tgt_tree)
    if src_tree is tgt_tree:
        src_sched = tgt_sched
    elif hasattr(src_tree, "level"):
        src_sched = build_tree_schedules(src_tree)
    else:                    # grafted LET: multipoles are shipped, not built
        src_sched = None
    return FMMPlan(tgt_tree=tgt_tree, src_tree=src_tree, theta=theta, p=p,
                   interactions=interactions, tgt_sched=tgt_sched,
                   src_sched=src_sched)
