"""The port's device dual traversal (repro_torch.core.engine.traversal) and
its MAC kernel's plain version (repro_torch.kernels.mac) against the JAX
reference, on the CPU.

On the CPU the K3 wrapper runs `mac_margins_ref`.  The traversal must emit
the host traversal's pair lists in the same ORDER (not only the same sets)
and the reference device traversal's (`use_kernel=False`), on the
reference's golden cases (tests/test_traversal_device.py), which are robust
against float32/float64 MAC flips.  Margins: float32 arithmetic in both
frameworks, rtol 1e-6 / atol 1e-7 (as the reference's kernel test); against
the host's float64 margin rtol 1e-4 (the reference's geometry tolerance).
The reference's jitted traversal lets XLA contract `theta*d - (ra + rb)`
into an fma, while the port and the reference's eager `mac_margins_ref`
round `theta*d` first; so against the jitted traversal's margin the
absolute tolerance is one float32 ulp of the largest `theta*d` scored
(`_fma_atol`), and against the eager oracle on the same pairs it is 1e-7.
Device-planned geometries are held against the port's host-planned one and
the reference's device-planned one: identical pair lists, LETs and bytes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.engine.traversal as dtrav
from repro.core.api import PartitionSpec as JSpec
from repro.core.api import plan_geometry as jplan
from repro.core.engine.traversal import device_dual_traversal as jtraverse
from repro.core.fmm import upward_pass as jupward
from repro.core.let import extract_let as jextract_let
from repro.core.let import graft as jgraft
from repro.core.multipole import get_operators as jops
from repro.core.tree import build_tree as jbuild_tree
from repro.kernels.mac import mac_margins as jmac
from repro.kernels.mac import mac_margins_ref as jmac_ref
from repro_torch.core.api import PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine.traversal import (device_dual_traversal,
                                               resolve_traversal_backend)
from repro_torch.core.fmm import upward_pass
from repro_torch.core.let import extract_let, graft
from repro_torch.core.multipole import get_operators
from repro_torch.core.plan import build_interaction_plan
from repro_torch.core.traversal import dual_traversal
from repro_torch.core.tree import build_tree
from repro_torch.kernels import mac as kmac

RTOL, ATOL = 1e-6, 1e-7

GOLDEN = [("sphere", 48), ("plummer", 32), ("cube", 64)]


def _problem(n=1200, seed=3, dist="sphere"):
    x = make_distribution(dist, n, seed=seed)
    q = np.random.default_rng(seed + 1).uniform(-1, 1, n)
    return x, q


def _host_margin(t, s, m2l, theta=0.5):
    a, b = m2l[:, 0], m2l[:, 1]
    d = np.linalg.norm(t.center[a] - s.center[b], axis=1)
    return float(np.min(theta * d - (t.radius[a] + s.radius[b])))


def _fma_atol(t, s, a, b, theta=0.5):
    """One float32 ulp of the largest theta*d over the pairs (a, b)."""
    if len(a) == 0:
        return ATOL
    d = np.linalg.norm(np.asarray(t.center)[a] - np.asarray(s.center)[b],
                       axis=1)
    return max(ATOL, float(np.spacing(np.float32(theta * d.max()))))


# ------------------------------------------------------------- K3 plain ---
@pytest.mark.parametrize("K", [128, 256, 1024])
def test_mac_plain_matches_pallas_interpret_and_ref(K):
    rng = np.random.default_rng(K)
    ca, cb = (rng.uniform(-1, 1, (K, 3)).astype(np.float32) for _ in "ab")
    ra, rb = (rng.uniform(0, .2, K).astype(np.float32) for _ in "ab")
    got = kmac.mac_margins(*(torch.as_tensor(v) for v in (ca, ra, cb, rb)),
                           0.5).numpy()
    j = [jnp.asarray(v) for v in (ca, ra, cb, rb)]
    np.testing.assert_allclose(got, np.asarray(jmac(*j, 0.5, interpret=True)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jmac_ref(*j, 0.5)),
                               rtol=RTOL, atol=ATOL)
    assert got.dtype == np.float32


def test_mac_wrapper_checks_its_inputs():
    z3, z1 = torch.zeros(100, 3), torch.zeros(100)
    with pytest.raises(ValueError, match="multiple"):
        kmac.mac_margins(z3, z1, z3, z1, 0.5)
    with pytest.raises(ValueError):
        kmac.mac_margins(torch.zeros(128, 2), torch.zeros(128),
                         torch.zeros(128, 3), torch.zeros(128), 0.5)
    with pytest.raises(TypeError):
        kmac.mac_margins(torch.zeros(128, 3, dtype=torch.float64),
                         torch.zeros(128), torch.zeros(128, 3),
                         torch.zeros(128), 0.5)
    before = kmac.launches
    kmac.mac_margins(torch.zeros(128, 3), torch.zeros(128),
                     torch.ones(128, 3), torch.zeros(128), 0.5)
    assert kmac.launches == before       # the CPU runs the plain version


# ------------------------------------------------------ golden: one pair ---
@pytest.fixture(scope="module", params=GOLDEN, ids=[d for d, _ in GOLDEN])
def local_case(request):
    dist, ncrit = request.param
    x, q = _problem(dist=dist)
    t = build_tree(x, q, ncrit=ncrit)
    jt = jbuild_tree(x, q, ncrit=ncrit)
    return (t, dual_traversal(t, t, 0.5),
            device_dual_traversal(t, t, 0.5, device="cpu"),
            jtraverse(jt, jt, 0.5, use_kernel=False))


def test_device_traversal_order_identical_to_host(local_case):
    _, (m2l_h, p2p_h), (m2l_d, p2p_d, m2p_d, _), _ = local_case
    np.testing.assert_array_equal(m2l_d, m2l_h)
    np.testing.assert_array_equal(p2p_d, p2p_h)
    assert len(m2p_d) == 0 and m2l_d.dtype == np.int64


def test_device_traversal_matches_reference_device_traversal(local_case):
    t, _, mine, ref = local_case
    for a, b in zip(mine[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    m2l = mine[0]
    np.testing.assert_allclose(mine[3], ref[3], rtol=RTOL,
                               atol=_fma_atol(t, t, m2l[:, 0], m2l[:, 1]))


def test_device_margin_matches_reference_mac_oracle(local_case):
    """The margin is the minimum of the reference's eager oracle
    `mac_margins_ref` over the accepted pairs, in float32."""
    t, _, (m2l, _, _, margin), _ = local_case
    c, r = t.center.astype(np.float32), t.radius.astype(np.float32)
    a, b = m2l[:, 0], m2l[:, 1]
    ref = np.asarray(jmac_ref(jnp.asarray(c[a]), jnp.asarray(r[a]),
                              jnp.asarray(c[b]), jnp.asarray(r[b]), 0.5))
    np.testing.assert_allclose(margin, ref.min(), rtol=RTOL, atol=ATOL)


def test_device_margin_is_the_host_slack_quantity(local_case):
    t, (m2l_h, _), (_, _, _, margin), _ = local_case
    np.testing.assert_allclose(margin, _host_margin(t, t, m2l_h), rtol=1e-4,
                               atol=1e-7)


def test_plain_and_kernel_route_emit_identical_lists(local_case):
    t, _, via_wrapper, _ = local_case
    plain = device_dual_traversal(t, t, 0.5, use_kernel=False, device="cpu")
    for a, b in zip(plain[:3], via_wrapper[:3]):
        np.testing.assert_array_equal(a, b)
    assert plain[3] == via_wrapper[3]


def test_build_interaction_plan_device_route(local_case):
    """`build_interaction_plan(traversal_backend="device")` traverses with
    the device loop and freezes the host route's plan."""
    t = local_case[0]
    dev = build_interaction_plan(t, t, 0.5, traversal_backend="device",
                                 device="cpu")
    host = build_interaction_plan(t, t, 0.5, traversal_backend="host")
    for a, b in zip(_pair_lists(dev), _pair_lists(host)):
        np.testing.assert_array_equal(a, b)


def test_device_traversal_grafted_let_with_m2p():
    x, q = _problem(n=1600, dist="sphere")
    idx = x[:, 0] < 0
    lo, hi = x[~idx].min(0), x[~idx].max(0)
    t_src = build_tree(x[idx], q[idx], ncrit=32)
    t_tgt = build_tree(x[~idx], q[~idx], ncrit=256)    # large leaves => M2P
    M = upward_pass(t_src, get_operators(4, "cpu")).numpy()
    g = graft(extract_let(t_src, M, lo, hi, 0.5))
    host = dual_traversal(t_tgt, g, 0.5, with_m2p=True)
    dev = device_dual_traversal(t_tgt, g, 0.5, with_m2p=True, device="cpu")
    assert len(host[2]) > 0
    for h, d in zip(host, dev[:3]):
        np.testing.assert_array_equal(d, h)
    js = jbuild_tree(x[idx], q[idx], ncrit=32)
    jg = jgraft(jextract_let(js, np.asarray(jupward(js, jops(4))), lo, hi,
                             0.5))
    ref = jtraverse(jbuild_tree(x[~idx], q[~idx], ncrit=256), jg, 0.5,
                    with_m2p=True, use_kernel=False)
    for r, d in zip(ref[:3], dev[:3]):
        np.testing.assert_array_equal(d, r)
    np.testing.assert_allclose(dev[3], ref[3], rtol=RTOL, atol=_fma_atol(
        t_tgt, g, dev[0][:, 0], dev[0][:, 1]))
    with pytest.raises(AssertionError, match="with_m2p"):
        device_dual_traversal(t_tgt, g, 0.5, device="cpu")


def test_device_traversal_overflow_retry(monkeypatch):
    """Tiny initial capacities double transparently, and the doubled caps
    are remembered for the padded-cell class."""
    monkeypatch.setattr(dtrav, "_CAPS_CACHE", {})
    monkeypatch.setattr(dtrav, "traversal_caps",
                        lambda pad: (128, 128, 128, 128))
    x, q = _problem(n=800)
    t = build_tree(x, q, ncrit=32)
    m2l_h, p2p_h = dual_traversal(t, t, 0.5)
    assert len(m2l_h) > 128 and len(p2p_h) > 128
    m2l_d, p2p_d, _, _ = device_dual_traversal(t, t, 0.5, device="cpu")
    np.testing.assert_array_equal(m2l_d, m2l_h)
    np.testing.assert_array_equal(p2p_d, p2p_h)
    (pad, caps), = dtrav._CAPS_CACHE.items()
    assert pad >= t.n_cells
    assert all(c > 128 for c in caps[:3])
    with pytest.raises(RuntimeError, match="overflowed"):
        device_dual_traversal(t, t, 0.5, device="cpu", max_retries=0)


def test_resolve_traversal_backend():
    assert resolve_traversal_backend("host", "cpu") == "host"
    assert resolve_traversal_backend("device", "cpu") == "device"
    assert resolve_traversal_backend(None, "cpu") == "host"
    assert resolve_traversal_backend("auto", "cpu") == "host"
    with pytest.raises(ValueError, match="traversal_backend"):
        resolve_traversal_backend("gpu", "cpu")


# -------------------------------------------------- golden: whole geometry --
def _pair_lists(inter):
    """(m2l pairs, m2p source cells, p2p gathers) of one InteractionPlan."""
    return ([inter.m2l_a[:inter.n_m2l], inter.m2l_b[:inter.n_m2l],
             inter.m2p_b[:inter.n_m2p], inter.m2p_t_idx]
            + [a for blk in inter.p2p_blocks
               for a in (blk.mask, blk.t_idx, blk.s_idx)])


def _assert_geometry_identical(a, b, slack_rtol):
    np.testing.assert_array_equal(a.bytes_matrix, b.bytes_matrix)
    np.testing.assert_allclose(a.slack, b.slack, rtol=slack_rtol, atol=1e-7)
    for ra, rb in zip(a.receivers, b.receivers):
        assert (ra is None) == (rb is None)
        if ra is None:
            continue
        assert [r.sender for r in ra.remote] == [r.sender for r in rb.remote]
        plans = [(ra.local, rb.local)] + [(u.inter, v.inter)
                                          for u, v in zip(ra.remote,
                                                          rb.remote)]
        for pa, pb in plans:
            assert len(pa.p2p_blocks) == len(pb.p2p_blocks)
            for u, v in zip(_pair_lists(pa), _pair_lists(pb)):
                np.testing.assert_array_equal(u, v)
    assert a.lets.keys() == b.lets.keys()
    for k in a.lets:
        for f in ("center", "radius", "child_start", "n_child", "body_start",
                  "n_body", "truncated", "x", "q"):
            np.testing.assert_array_equal(getattr(a.lets[k], f),
                                          getattr(b.lets[k], f))


def _clustered_problem():
    """Duplicated sites: >= 3 of 8 morton partitions are empty."""
    pts = np.array([[.1, .1, .1], [.8, .2, .3], [.3, .9, .5],
                    [.6, .6, .9], [.9, .9, .1]])
    x = np.repeat(pts, 60, axis=0)
    return x, np.random.default_rng(1).uniform(-1, 1, len(x))


GEOMETRIES = {"orb": ("orb", 4, 48), "morton": ("morton", 4, 48),
              "empty_partitions": ("morton", 8, 64)}


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def planned(request):
    method, nparts, ncrit = GEOMETRIES[request.param]
    if request.param == "empty_partitions":
        x, q = _clustered_problem()
    else:
        x = make_distribution("sphere", 1200, seed=7)
        q = np.random.default_rng(8).uniform(-1, 1, 1200)
    kw = dict(nparts=nparts, method=method, ncrit=ncrit)
    host = plan_geometry(x, q, PartitionSpec(**kw), device="cpu")
    dev = plan_geometry(x, q, PartitionSpec(traversal_backend="device", **kw),
                        device="cpu")
    ref = jplan(x, q, JSpec(traversal_backend="device", **kw))
    return request.param, host, dev, ref


def test_device_planned_geometry_matches_host_planned(planned):
    name, host, dev, _ = planned
    _assert_geometry_identical(dev, host, slack_rtol=1e-4)
    if name == "empty_partitions":
        empty = [p for p in range(8) if len(dev.owners[p]) == 0]
        assert len(empty) >= 3
        assert all(dev.receivers[p] is None for p in empty)


def test_device_planned_geometry_matches_reference_device_planned(planned):
    _, _, dev, ref = planned
    _assert_geometry_identical(dev, ref, slack_rtol=1e-4)
    for rd, rr in zip(dev.receivers, ref.receivers):
        if rd is None:
            continue
        pairs = [(rd.local, rd.tree, rd.local_margin, rr.local_margin)]
        pairs += [(u.inter, u.graft, u.margin, v.margin)
                  for u, v in zip(rd.remote, rr.remote)]
        for inter, src, mine, theirs in pairs:
            atol = _fma_atol(rd.tree, src, inter.m2l_a[:inter.n_m2l],
                             inter.m2l_b[:inter.n_m2l])
            np.testing.assert_allclose(mine, theirs, rtol=RTOL, atol=atol)
