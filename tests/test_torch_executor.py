"""The port's per-tree executors (repro_torch.core.fmm) and the per-partition
reference executor `api.execute_geometry`, against the JAX reference's
(`repro.core.fmm`, `repro.core.api.execute_geometry` on its jnp route), on
the same inputs, on the CPU; and the executor's upload memo (`DeviceMemo`).

Potentials at rtol 1e-6 / atol 2e-5, as tests/test_engine.py: both packages
sum the same float32 terms in float64, grouped differently.  Expansion
coefficients (the multipoles of `upward_pass`, the locals of `m2l_apply`
and `downward_pass`) at the float32 operator tolerance of
tests/test_torch_multipole.py, rtol 1e-5 with atol 1e-5 of the largest
value: the port's M2L derivatives are float64 rounded once, the
reference's float32 AD, which alone moves a high-order local by a few
1e-6 of its size (4.8e-6 observed here).

The reference compiles its passes per (rows, cells) shape, about 3 s for
each M2L shape, so the geometries are small (N <= 500).  At N = 4,000 in
8 parts (`tools/executor_vs_reference.py`, seeds 5, 7, 9, 11) 0 to 2 of
the 4,000 potentials sit up to 1.16x past the potential tolerance: both
packages sum their near and far fields in float32 in different orders,
each part differs by up to ~1e-5 there, and the near part stays within
1.14 eps32 * sum|q|/r of its pairs.  The reference's own M2L derivatives
swapped into the port leave the same outliers.
"""
import gc

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import fmm as jfmm
from repro.core.multipole import get_operators as jget_operators
from repro.core.plan import build_fmm_plan as jbuild_fmm_plan
from repro.core.tree import build_tree as jbuild_tree
from repro_torch.core import fmm
from repro_torch.core.api import (DeviceMemo, FMMSession, PartitionSpec,
                                  execute_geometry, plan_geometry)
from repro_torch.core.distributions import make_distribution
from repro_torch.core.multipole import get_operators
from repro_torch.core.plan import build_fmm_plan
from repro_torch.core.tree import build_tree
from repro_torch.kernels import p2p as kp2p

RTOL, ATOL = 1e-6, 2e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _close_coeffs(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _problem(n, seed=5, qseed=6):
    x = make_distribution("sphere", n, seed=seed)
    q = np.random.default_rng(qseed).uniform(-1, 1, n)
    return x, q


def _clustered_problem():
    """Duplicated sites -> >= 3 of 8 morton partitions empty."""
    pts = np.array([[.1, .1, .1], [.8, .2, .3], [.3, .9, .5],
                    [.6, .6, .9], [.9, .9, .1]])
    x = np.repeat(pts, 60, axis=0)
    q = np.random.default_rng(1).uniform(-1, 1, len(x))
    return x, q


CASES = {
    "orb5": lambda: (*_problem(300), dict(nparts=5, method="orb", ncrit=48)),
    "hilbert4": lambda: (*_problem(400, seed=7), dict(nparts=4,
                                                      method="hilbert",
                                                      ncrit=48)),
    "empty": lambda: (*_clustered_problem(), dict(nparts=8, method="morton",
                                                  ncrit=48)),
    # the tree of the single-tree tests, so the reference reuses its shapes
    "one": lambda: (*_problem(500, seed=3, qseed=4), dict(nparts=1,
                                                          ncrit=32)),
}


@pytest.fixture(scope="module")
def geometries():
    """Each case planned by both packages (host traversal), built once."""
    out = {}
    for name, make in CASES.items():
        x, q, spec = make()
        out[name] = (plan_geometry(x, q, PartitionSpec(**spec), device="cpu"),
                     japi.plan_geometry(x, q, japi.PartitionSpec(
                         traversal_backend="host", **spec)))
    return out


@pytest.fixture(scope="module")
def executed(geometries):
    """`execute_geometry(g, device="cpu")` of a case, run once: the tests
    that hold it to the reference, to the engine and to the memo's result
    share it."""
    runs = {}

    def get(case):
        if case not in runs:
            runs[case] = execute_geometry(geometries[case][0], device="cpu")
        return runs[case]
    return get


# ------------------------------------------------------ per-tree passes ----
@pytest.fixture(scope="module")
def tree_case():
    x, q = _problem(500, seed=3, qseed=4)
    t, rt = build_tree(x, q, ncrit=32), jbuild_tree(x, q, ncrit=32)
    plan = build_fmm_plan(t, t, traversal_backend="host", device="cpu")
    rplan = jbuild_fmm_plan(rt, rt)
    return x, q, t, rt, plan, rplan


def test_upward_downward_l2p_match_reference(tree_case):
    _, _, t, rt, plan, rplan = tree_case
    ops, jops = get_operators(4, CPU), jget_operators(4)
    M = fmm.upward_pass(t, ops, sched=plan.tgt_sched)
    jM = jfmm.upward_pass(rt, jops, sched=rplan.tgt_sched)
    _close_coeffs(M, jM)
    L0 = np.array(jfmm.m2l_apply(jops, jM, rplan.interactions))
    L_own = fmm.m2l_apply(ops, np.array(jM), plan.interactions)
    _close_coeffs(L_own, L0)
    L = fmm.downward_pass(t, ops, torch.as_tensor(L0), sched=plan.tgt_sched)
    jL = jfmm.downward_pass(rt, jops, L0, sched=rplan.tgt_sched)
    _close_coeffs(L, jL)
    phi = fmm.l2p_pass(t, ops, torch.as_tensor(np.array(jL)),
                       sched=plan.tgt_sched)
    assert phi.dtype == torch.float64
    want = jfmm.l2p_pass(rt, jops, jL, sched=rplan.tgt_sched)
    _close(phi, want)
    # the port's own locals, carried down to the bodies: a potential again
    own = fmm.l2p_pass(t, ops, fmm.downward_pass(t, ops, L_own,
                                                 sched=plan.tgt_sched),
                       sched=plan.tgt_sched)
    _close(own, want)


@pytest.mark.parametrize("src", ["tree", "let"])
def test_p2p_apply_matches_reference(src, tree_case, geometries):
    if src == "tree":
        _, _, t, rt, plan, rplan = tree_case
        args, jargs = (t, t, plan.interactions), (rt, rt, rplan.interactions)
    else:                  # a receiver's grafted LET (one boundary leaf each)
        g, r = geometries["orb5"]
        rb, jrb = g.receivers[0].remote[0], r.receivers[0].remote[0]
        assert rb.inter.n_p2p > 0
        args = (g.receivers[0].tree, rb.graft, rb.inter)
        jargs = (r.receivers[0].tree, jrb.graft, jrb.inter)
    want = jfmm.p2p_apply(*jargs)
    got = fmm.p2p_apply(*args, device="cpu")
    assert got.dtype == torch.float64 and got.device == CPU
    _close(got, want)
    _close(fmm.p2p_apply(*args, use_kernels=True, device="cpu"), want)


def test_m2p_apply_matches_reference(geometries):
    g, r = geometries["orb5"]
    found = 0
    for rc, jrc in zip(g.receivers, r.receivers):
        for rb, jrb in zip(rc.remote, jrc.remote):
            if rb.inter.n_m2p:
                found += 1
                _close(fmm.m2p_apply(rc.tree, rb.graft.M, rb.inter,
                                     device="cpu"),
                       jfmm.m2p_apply(jrc.tree, jrb.graft.M, jrb.inter))
    assert found                       # the orb5 plan has M2P pairs


@pytest.mark.parametrize("entry", ["execute_fmm_plan", "evaluate",
                                   "fmm_potential"])
def test_single_tree_entry_points_match_reference(entry, tree_case):
    x, q, t, rt, plan, rplan = tree_case
    if entry == "execute_fmm_plan":
        got, want = (fmm.execute_fmm_plan(plan, device="cpu"),
                     jfmm.execute_fmm_plan(rplan))
    elif entry == "evaluate":
        got, want = fmm.evaluate(t, t, device="cpu"), jfmm.evaluate(rt, rt)
    else:
        got = fmm.fmm_potential(x, q, ncrit=32, device="cpu")
        want = jfmm.fmm_potential(x, q, ncrit=32)
        rel = np.linalg.norm(got - fmm.direct_potential(x, q, device="cpu"))
        assert rel / np.linalg.norm(want) < 3e-3
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    _close(got, want)


def test_pair_list_passes_match_reference(tree_case):
    _, _, t, rt, plan, rplan = tree_case
    ops, jops = get_operators(4, CPU), jget_operators(4)
    from repro_torch.core.traversal import dual_traversal
    m2l, p2p = dual_traversal(t, t, 0.5)
    M = np.array(jfmm.upward_pass(rt, jops))
    _close_coeffs(fmm.m2l_pass(ops, M, t, t, m2l),
                  jfmm.m2l_pass(jops, M, rt, rt, m2l))
    _close(fmm.p2p_pass(t, t, p2p, device="cpu"), jfmm.p2p_pass(rt, rt, p2p))
    # M2P of the root's multipole at 40 leaves: the pass is the plan
    # subset of m2p_apply (held to the reference above)
    leaves = np.nonzero(t.n_child == 0)[0]
    far = np.stack([leaves[:40], np.zeros(40, np.int64)], axis=1)
    sub = fmm.build_interaction_subset(t, t, m2p_pairs=far)
    assert sub.n_m2p == 40
    np.testing.assert_array_equal(
        fmm.m2p_pass(t, M, t.center, far, device="cpu"),
        fmm.m2p_apply(t, M, sub, device="cpu"))
    assert not fmm.m2p_pass(t, M, t.center, far[:0], device="cpu").any()


# ---------------------------------------------------- execute_geometry -----
@pytest.mark.parametrize("case", list(CASES))
def test_execute_geometry_matches_reference(case, geometries, executed):
    g, r = geometries[case]
    got = executed(case)
    assert got.shape == (g.n,) and got.dtype == np.float64
    _close(got, japi.execute_geometry(r, use_kernels=False))
    if case == "empty":
        assert sum(t is None for t in g.trees) >= 3
    if case == "orb5":
        assert any(rb.inter.n_m2p for rc in g.receivers for rb in rc.remote)


@pytest.mark.parametrize("case", list(CASES))
def test_execute_geometry_matches_engine(case, geometries, executed):
    g, _ = geometries[case]
    _close(executed(case), FMMSession(g, device="cpu").evaluate())


def test_use_kernels_true_equals_false_on_cpu(geometries):
    g, _ = geometries["orb5"]
    before = kp2p.launches
    a = execute_geometry(g, use_kernels=True, device="cpu")
    b = execute_geometry(g, use_kernels=False, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert kp2p.launches == before     # the CPU launches no kernel


def test_plain_near_field_only_on_the_cpu():
    """The device picks the near field: K1's wrapper (True / None), the
    plain `_p2p_vals` on the CPU (False), and False refused on CUDA."""
    assert fmm.resolve_use_kernels(None, CPU)
    assert fmm.resolve_use_kernels(True, CPU)
    assert not fmm.resolve_use_kernels(False, CPU)
    cuda = torch.device("cuda", 0)
    assert fmm.resolve_use_kernels(None, cuda)
    assert fmm.resolve_use_kernels(True, cuda)
    with pytest.raises(ValueError, match="CPU only"):
        fmm.resolve_use_kernels(False, cuda)


def test_executor_without_a_card_raises(geometries):
    g, _ = geometries["one"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_geometry(g)


# --------------------------------------------------------- DeviceMemo ------
def test_memo_uploads_once(geometries, executed):
    g, _ = geometries["orb5"]
    memo = DeviceMemo("cpu")
    first = execute_geometry(g, asarray=memo)
    misses, hits = memo.misses, memo.hits
    assert misses > 0 and len(memo) == misses
    second = execute_geometry(g, asarray=memo)
    assert memo.misses == misses and memo.hits > hits
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, executed("orb5"))


def test_hook_returning_host_arrays_raises(geometries):
    g, _ = geometries["one"]
    with pytest.raises(TypeError, match="torch.Tensor"):
        execute_geometry(g, asarray=lambda a, dtype=None: np.asarray(a),
                         device="cpu")


def test_memo_is_resident_and_passes_tensors_through():
    memo = DeviceMemo("cpu")
    a = np.arange(6.0)
    t = memo(a, torch.float32)
    assert memo.is_resident(t) and not memo.is_resident(torch.zeros(6))
    assert memo(a, torch.float32) is t and (memo.misses, memo.hits) == (1, 1)
    u = torch.ones(3, dtype=torch.float64)
    assert memo(u) is u and memo.misses == 1 and len(memo) == 1
    assert memo(u, torch.float32).dtype == torch.float32


def test_memo_entries_evict_after_a_step_replaces_their_arrays():
    x, q = _problem(900)
    sess = FMMSession.from_points(x, q, PartitionSpec(nparts=4, ncrit=48),
                                  device="cpu", engine=False)
    sess.evaluate()
    n0 = len(sess.memo)
    eps = float(sess.geometry.slack.min())
    x1 = x + np.random.default_rng(2).uniform(-eps / 4, eps / 4, x.shape)
    rep = sess.step(x1)
    assert rep.rebuilt == () and len(rep.refreshed) == 4
    sess.evaluate()
    gc.collect()
    # the refreshed positions and multipoles replaced their predecessors,
    # whose entries left with the old geometry: the memo did not grow
    assert len(sess.memo) <= n0
    assert all(view is not None for _, view in sess.memo._views.values())
    misses = sess.memo.misses
    sess.evaluate()
    assert sess.memo.misses == misses


def test_device_hook_checks_the_device():
    hook = fmm.device_hook(lambda a, dtype=None: torch.as_tensor(a), "cpu")
    assert hook(np.zeros(3)).device == CPU
    assert fmm.executor_device(DeviceMemo("cpu")) == CPU
    with pytest.raises(TypeError, match="torch.Tensor on cpu"):
        fmm.device_hook(lambda a, dtype=None: [0.0], "cpu")(np.zeros(1))
