"""Single-partition FMM evaluator: host-built plans, PyTorch arithmetic.

The port of `repro.core.fmm`.  The numeric passes (P2M, M2M, M2L, L2L, L2P,
P2P, M2P) run as batched tensor operations over the padded index tables of
an `FMMPlan` (repro_torch.core.plan).  Plan construction (traversal,
padding, bucketing — NumPy) lives in plan.py; this module only *executes*
plans, so a plan built once can be evaluated many times at kernel cost.
These per-tree executors are the reference the batched engine
(repro_torch.core.engine) is pinned against, and `api.execute_geometry`
runs them one partition at a time.

Where the port differs from the reference:

  - Device.  An executor runs on one device: the operator set's
    (`ops.device`) where it takes one, else `device=`, which defaults to
    the upload hook's device (an `api.DeviceMemo` has one) and then to the
    card (`executor_device`).
  - Upload hook.  `asarray=` (an `api.DeviceMemo` or compatible) must return
    a `torch.Tensor` on the executor's device; `device_hook` raises
    `TypeError` otherwise, since a hook that hands back host arrays would
    upload every table again on every call.
  - Near field.  On a CUDA device every P2P block is one K1 launch at the
    warps a block autotuned for its shape class (`kernels.ops.p2p_auto`,
    as the reference's blocks go through its `p2p_auto`; float32
    contiguous blocks); `use_kernels=False` there raises, since the device
    alone picks the path.  On the CPU, `use_kernels` True or None runs
    `p2p_auto`, which takes K1's plain version for CPU tensors, and False
    runs the plain `_p2p_vals` (row chunks, as `kernels.p2p.p2p_ref`).
  - Accumulation.  Potentials are summed in float64 with `index_add_` on the
    executor's device (the reference sums on the host with `np.add.at`).
    The passes return float64 tensors on that device; `execute_fmm_plan`,
    `evaluate` and `fmm_potential` copy the result to the host once.
  - M2L runs in chunks of `M2L_CHUNK` pairs, as the engine's far field does.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.multipole import (M2L_CHUNK, MultipoleOperators,
                                        get_operators)
from repro_torch.core.plan import (FMMPlan, InteractionPlan, TreeSchedules,
                                   build_fmm_plan, build_interaction_plan,
                                   build_tree_schedules)
from repro_torch.core.tree import Tree, build_tree
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import p2p_auto
from repro_torch.kernels.p2p import p2p_ref

__all__ = ["fmm_potential", "evaluate", "execute_fmm_plan", "direct_potential",
           "upward_pass", "downward_pass", "m2l_pass", "m2l_apply", "p2p_pass",
           "p2p_apply", "m2p_pass", "m2p_apply", "l2p_pass", "device_hook",
           "executor_device", "resolve_use_kernels",
           "build_interaction_subset"]

F32, F64 = torch.float32, torch.float64


def executor_device(asarray=None, device=None) -> torch.device:
    """The device an executor runs on: `device` where given, else the upload
    hook's `device` attribute (an `api.DeviceMemo`'s), else the card."""
    if device is None:
        device = getattr(asarray, "device", None)
    return resolve_device(device)


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def device_hook(asarray, device):
    """Normalize an `asarray=` executor hook (api.DeviceMemo or compatible)
    for the executor's `device`.

    Contract: the hook returns a `torch.Tensor` on `device` for `hook(arr)`
    and `hook(arr, dtype)`.  Returning a NumPy array (or a tensor elsewhere)
    would make every call upload the table again, defeating the memoization
    the hook exists for, so the wrapper raises `TypeError` instead.  With no
    hook, arrays are converted with `torch.as_tensor` on every call."""
    device = torch.device(device)
    if asarray is None:
        def upload(arr, dtype=None):
            return torch.as_tensor(arr, dtype=dtype, device=device)
        return upload

    def checked(arr, dtype=None):
        out = asarray(arr, dtype) if dtype is not None else asarray(arr)
        if not (isinstance(out, torch.Tensor) and _on(out, device)):
            got = (f"a tensor on {out.device}" if isinstance(out, torch.Tensor)
                   else type(out).__name__)
            raise TypeError(
                f"asarray hook must return a torch.Tensor on {device}, got "
                f"{got}: a hook that returns host arrays would upload every "
                "table again on every call (see api.DeviceMemo)")
        return out

    return checked


def resolve_use_kernels(use_kernels, device: torch.device) -> bool:
    """Whether the near field calls the K1 wrapper: always on a CUDA device
    (False raises there), on the CPU unless `use_kernels` is False."""
    if use_kernels is False and device.type == "cuda":
        raise ValueError(
            "use_kernels=False: the plain near field runs on the CPU only; "
            "on a CUDA device every P2P block launches K1")
    return use_kernels is not False


def direct_potential(x, q, x_tgt=None, chunk: int = 2048,
                     device=None) -> np.ndarray:
    """O(N^2) float64 oracle (self-interaction excluded), computed on
    `device` (None: the card) in float64 and returned as a host array."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)
    q = torch.as_tensor(np.asarray(q, dtype=np.float64), device=dev)
    xt = x if x_tgt is None else torch.as_tensor(
        np.asarray(x_tgt, dtype=np.float64), device=dev)
    out = torch.zeros(len(xt), dtype=F64, device=dev)
    for s in range(0, len(xt), chunk):
        d = xt[s:s + chunk, None, :] - x[None, :, :]
        r2 = (d * d).sum(-1)
        inv = torch.where(r2 > 0, 1.0 / torch.sqrt(r2.clamp_min(1e-300)),
                          torch.zeros((), dtype=r2.dtype, device=dev))
        out[s:s + chunk] = inv @ q
    return out.cpu().numpy()


# ------------------------------------------------------ pass bodies ------
def _p2m_scatter(ops, q, x, centers, leaf_ids, mask, n_cells):
    M_leaf = ops.p2m(q, x, centers) * mask[:, None]
    M = torch.zeros(n_cells, ops.nk, dtype=F32, device=M_leaf.device)
    return M.index_add_(0, leaf_ids, M_leaf)


def _m2m_scatter(ops, M, M_child, d, parents, mask):
    return M.index_add(0, parents, ops.m2m(M_child, d) * mask[:, None])


def _m2l_scatter(ops, M, b, d, a, mask, n_cells):
    """Sum of M2L(M[b], d) into locals at a, M2L_CHUNK pairs at a time: the
    (pairs, nk, nk) translation matrices of one pass would not fit on the
    card at the main workload's plans."""
    L = torch.zeros(n_cells, ops.nk, dtype=M.dtype, device=M.device)
    for s in range(0, a.shape[0], M2L_CHUNK):
        sl = slice(s, s + M2L_CHUNK)
        L.index_add_(0, a[sl], ops.m2l(M[b[sl]], d[sl]) * mask[sl, None])
    return L


def _l2l_scatter(ops, L, L_parent, d, ids, mask):
    return L.index_add(0, ids, ops.l2l(L_parent, d) * mask[:, None])


def _l2p_vals(ops, L_leaf, y, centers, mask):
    return ops.l2p(L_leaf, y, centers) * mask[:, None]


def _m2p_vals(ops, M, y, centers, mask):
    return ops.m2p(M, y, centers) * mask[:, None]


def _p2p_vals(xt, xs, qs, mask):
    """Plain masked P2P values: xt (B, T, 3), xs (B, S, 3), qs (B, S),
    mask (B,) -> (B, T)."""
    return p2p_ref(qs, xs, xt) * mask[:, None]


def _accumulate(phi, idx, valid, vals):
    """phi[idx] += vals where valid, in float64 on phi's device."""
    zero = torch.zeros((), dtype=F64, device=phi.device)
    return phi.index_add_(0, idx.reshape(-1),
                          torch.where(valid.reshape(-1),
                                      vals.reshape(-1).to(F64), zero))


def _zeros64(n: int, device) -> torch.Tensor:
    return torch.zeros(n, dtype=F64, device=device)


# ------------------------------------------------------------- passes ------
# Every executor takes an optional `asarray` hook: a session passes a
# memoizing uploader (api.DeviceMemo) so the frozen NumPy index tables reach
# the device once, keeping plan.py NumPy-only while repeated execution
# uploads nothing.
def upward_pass(tree: Tree, ops: MultipoleOperators,
                sched: TreeSchedules | None = None,
                asarray=None) -> torch.Tensor:
    """P2M at leaves, then M2M level by level (deepest first) -> (C, nk)
    float32 on the operator set's device."""
    if sched is None:
        sched = build_tree_schedules(tree)
    aa = device_hook(asarray, ops.device)
    x = aa(tree.x, F32)
    q = aa(tree.q, F32)
    leaf_idx = aa(sched.leaf_idx)
    qi = torch.where(aa(sched.leaf_valid), q[leaf_idx],
                     torch.zeros((), dtype=F32, device=ops.device))
    M = _p2m_scatter(ops, qi, x[leaf_idx], aa(sched.leaf_centers),
                     aa(sched.leaves), aa(sched.leaf_mask), sched.n_cells)
    for ls in reversed(sched.levels):
        M = _m2m_scatter(ops, M, M[aa(ls.ids)], aa(ls.d), aa(ls.parents),
                         aa(ls.mask))
    return M


def downward_pass(tree: Tree, ops, L, sched: TreeSchedules | None = None,
                  asarray=None) -> torch.Tensor:
    """L2L level by level (top down) -> (C, nk) float32; L is not changed."""
    if sched is None:
        sched = build_tree_schedules(tree)
    aa = device_hook(asarray, ops.device)
    for ls in sched.levels:
        L = _l2l_scatter(ops, L, L[aa(ls.parents)], aa(ls.d), aa(ls.ids),
                         aa(ls.mask))
    return L


def l2p_pass(tree: Tree, ops, L, sched: TreeSchedules | None = None,
             asarray=None) -> torch.Tensor:
    """Locals at the leaves -> (n_bodies,) float64 potential on the device."""
    if sched is None:
        sched = build_tree_schedules(tree)
    aa = device_hook(asarray, ops.device)
    leaf_idx = aa(sched.leaf_idx)
    y = aa(tree.x, F32)[leaf_idx]
    vals = _l2p_vals(ops, L[aa(sched.leaves)], y, aa(sched.leaf_centers),
                     aa(sched.leaf_mask))
    return _accumulate(_zeros64(len(tree.x), ops.device), leaf_idx,
                       aa(sched.leaf_valid), vals)


def m2l_apply(ops, M, plan: InteractionPlan, asarray=None) -> torch.Tensor:
    """Execute the plan's padded M2L list against multipoles M ->
    (n_tgt_cells, nk) float32 locals."""
    aa = device_hook(asarray, ops.device)
    M = aa(M, F32)
    if plan.n_m2l == 0:
        return torch.zeros(plan.n_tgt_cells, ops.nk, dtype=F32,
                           device=ops.device)
    return _m2l_scatter(ops, M, aa(plan.m2l_b), aa(plan.m2l_d),
                        aa(plan.m2l_a), aa(plan.m2l_mask), plan.n_tgt_cells)


def m2l_pass(ops, M, tgt_tree, src_tree, pairs) -> torch.Tensor:
    plan = build_interaction_subset(tgt_tree, src_tree, m2l_pairs=pairs)
    return m2l_apply(ops, M, plan)


def build_interaction_subset(tgt_tree, src_tree, m2l_pairs=None,
                             p2p_pairs=None, m2p_pairs=None) -> InteractionPlan:
    """Plan just the supplied pair lists (compat shim for the pair-based API)."""
    empty = np.zeros((0, 2), dtype=np.int64)
    return build_interaction_plan(
        tgt_tree, src_tree,
        m2l_pairs=(empty if m2l_pairs is None else m2l_pairs),
        p2p_pairs=(empty if p2p_pairs is None else p2p_pairs),
        m2p_pairs=m2p_pairs)


def p2p_apply(tgt_tree, src_tree, plan: InteractionPlan,
              use_kernels: bool | None = None, asarray=None, *,
              device=None) -> torch.Tensor:
    """Execute the plan's bucketed P2P blocks -> (n_tgt_bodies,) float64 on
    the device.  Each block's source width is sized to its own leaves, so a
    grafted LET's one big boundary leaf does not inflate every pair's
    padding.  On a CUDA device each block is one K1 launch."""
    dev = executor_device(asarray, device)
    kernels = resolve_use_kernels(use_kernels, dev)
    phi = _zeros64(plan.n_tgt_bodies, dev)
    if plan.n_p2p == 0:
        return phi
    aa = device_hook(asarray, dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    xt_all = aa(tgt_tree.x, F32)
    xs_all = aa(src_tree.x, F32)
    qs_all = aa(src_tree.q, F32)
    for blk in plan.p2p_blocks:
        t_idx, s_idx, mask = aa(blk.t_idx), aa(blk.s_idx), aa(blk.mask)
        xt = xt_all[t_idx]
        xs = xs_all[s_idx]
        qs = torch.where(aa(blk.s_valid), qs_all[s_idx], zero)
        if kernels:
            vals = p2p_auto(qs, xs, xt) * mask[:, None]
        else:
            vals = _p2p_vals(xt, xs, qs, mask)
        _accumulate(phi, t_idx, aa(blk.t_valid), vals)
    return phi


def p2p_pass(tgt_tree: Tree, src_tree, pairs,
             use_kernels: bool | None = None, *,
             device=None) -> torch.Tensor:
    plan = build_interaction_subset(tgt_tree, src_tree, p2p_pairs=pairs)
    return p2p_apply(tgt_tree, src_tree, plan, use_kernels=use_kernels,
                     device=device)


def m2p_apply(tgt_tree, src_M, plan: InteractionPlan, p: int = 4,
              asarray=None, *, device=None) -> torch.Tensor:
    """Execute the plan's padded M2P fallback list (truncated remote cells
    that fail the MAC against a large local leaf) -> (n_tgt_bodies,)
    float64 on the device."""
    dev = executor_device(asarray, device)
    ops = get_operators(p, dev)
    phi = _zeros64(plan.n_tgt_bodies, dev)
    if plan.n_m2p == 0:
        return phi
    aa = device_hook(asarray, dev)
    t_idx = aa(plan.m2p_t_idx)
    y = aa(tgt_tree.x, F32)[t_idx]
    M = aa(src_M, F32)[aa(plan.m2p_b)]
    vals = _m2p_vals(ops, M, y, aa(plan.m2p_centers), aa(plan.m2p_mask))
    return _accumulate(phi, t_idx, aa(plan.m2p_t_valid), vals)


def m2p_pass(tgt_tree: Tree, src_M, src_centers, pairs, p: int = 4, *,
             device=None) -> torch.Tensor:
    if len(pairs) == 0:
        return _zeros64(len(tgt_tree.x), resolve_device(device))
    src = SimpleNamespace(center=src_centers)   # the planner only needs centers
    plan = build_interaction_subset(tgt_tree, src, m2p_pairs=pairs)
    return m2p_apply(tgt_tree, src_M, plan, p=p, device=device)


# ------------------------------------------------------- plan execution ----
def execute_fmm_plan(plan: FMMPlan, use_kernels: bool | None = None,
                     M=None, asarray=None, *, device=None) -> np.ndarray:
    """Evaluate a prebuilt FMMPlan: kernels + gathers only, no host-side list
    construction or padding.  `M` overrides the source multipoles (grafted
    LETs ship theirs; locally they are rebuilt from the plan's schedules).
    `asarray` optionally memoizes host->device uploads (api.DeviceMemo).
    Returns the potential at the target bodies (sorted order) on the host."""
    dev = executor_device(asarray, device)
    ops = get_operators(plan.p, dev)
    inter = plan.interactions
    if M is None:
        if plan.src_sched is not None:
            M = upward_pass(plan.src_tree, ops, sched=plan.src_sched,
                            asarray=asarray)
        else:
            M = plan.src_tree.M           # grafted LET: shipped multipoles
    L = m2l_apply(ops, M, inter, asarray=asarray)
    L = downward_pass(plan.tgt_tree, ops, L, sched=plan.tgt_sched,
                      asarray=asarray)
    phi = l2p_pass(plan.tgt_tree, ops, L, sched=plan.tgt_sched, asarray=asarray)
    phi += p2p_apply(plan.tgt_tree, plan.src_tree, inter,
                     use_kernels=use_kernels, asarray=asarray, device=dev)
    if inter.n_m2p:
        phi += m2p_apply(plan.tgt_tree, M, inter, p=plan.p, asarray=asarray,
                         device=dev)
    return phi.cpu().numpy()


def evaluate(tgt_tree: Tree, src_tree: Tree, theta: float = 0.5, p: int = 4,
             m2l_pairs=None, p2p_pairs=None, use_kernels: bool | None = None,
             plan: FMMPlan | None = None, *, device=None) -> np.ndarray:
    """Potential at tgt_tree bodies (sorted order) due to src_tree bodies,
    on `device` (None: the card).  Pass a prebuilt `plan` (see
    plan.build_fmm_plan) to skip all host-side geometry work."""
    dev = resolve_device(device)
    if plan is None:
        plan = build_fmm_plan(tgt_tree, src_tree, theta=theta, p=p,
                              m2l_pairs=m2l_pairs, p2p_pairs=p2p_pairs,
                              device=dev)
    return execute_fmm_plan(plan, use_kernels=use_kernels, device=dev)


def fmm_potential(x, q, theta: float = 0.5, ncrit: int = 64, p: int = 4,
                  use_kernels: bool | None = None, *,
                  device=None) -> np.ndarray:
    """FMM potential in the *original* body order."""
    tree = build_tree(x, q, ncrit=ncrit)
    phi_sorted = evaluate(tree, tree, theta=theta, p=p,
                          use_kernels=use_kernels, device=device)
    out = np.empty_like(phi_sorted)
    out[tree.perm] = phi_sorted
    return out
