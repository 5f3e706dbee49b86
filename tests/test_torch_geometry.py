"""The port's host geometry (repro_torch.core.api.plan_geometry and the
NumPy modules under it) against the JAX reference's
`repro.core.api.plan_geometry(..., traversal_backend="host")` on the same
numpy inputs.

Everything structural is compared for exact equality: partition, boxes,
bytes matrix, slack, every interaction plan's pair lists and padded tables,
every LET's structure and shipped bodies, and every `build_engine_tables`
array.  The LET payload multipoles are float32 sums computed by different
frameworks, so they compare allclose (rtol 1e-5, atol 1e-6 of the largest
|M|).
"""
import numpy as np
import pytest

from repro.core.api import PartitionSpec as JSpec
from repro.core.api import plan_geometry as jplan
from repro.core.engine import build_engine_tables as jtables
from repro.core.engine.schedules import build_p2p_stream_tables as jstream
from repro_torch.core.api import PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine import build_engine_tables
from repro_torch.core.engine.schedules import build_p2p_stream_tables


def _problem(n=1500, seed=5, qseed=6, dist="sphere"):
    x = make_distribution(dist, n, seed=seed)
    q = np.random.default_rng(qseed).uniform(-1, 1, n)
    return x, q


def flatten_tables(t) -> dict:
    """Every array of an EngineTables (either package's), by name."""
    out = {k: getattr(t, k) for k in ("n", "n_parts", "n_cells_max",
                                      "n_bodies_max", "p", "l2p_t_idx",
                                      "orig_idx", "flat_idx")}
    out.update({f"up/{k}": v for k, v in t.up.tables.items()})
    out.update({f"m2l/{k}": v for k, v in t.m2l.items()})
    out.update({f"m2p/{k}": v for k, v in t.m2p.items()})
    for i, b in enumerate(t.p2p_buckets):
        out.update({f"p2p/{i}/{k}": v for k, v in b.items()})
    return out


def _assert_plans_equal(a, b):
    for f in ("n_tgt_cells", "n_tgt_bodies", "n_m2l", "n_p2p", "n_m2p"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("m2l_a", "m2l_b", "m2l_mask", "m2l_d", "m2p_b", "m2p_mask",
              "m2p_centers", "m2p_t_idx", "m2p_t_valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert len(a.p2p_blocks) == len(b.p2p_blocks)
    for x, y in zip(a.p2p_blocks, b.p2p_blocks):
        assert x.n == y.n
        for f in ("mask", "t_idx", "t_valid", "s_idx", "s_valid"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


@pytest.fixture(scope="module", params=[("orb", 4), ("hilbert", 4)],
                ids=["orb", "hilbert"])
def geometries(request):
    method, nparts = request.param
    x, q = _problem()
    g = plan_geometry(x, q, PartitionSpec(nparts=nparts, method=method,
                                          ncrit=48), device="cpu")
    r = jplan(x, q, JSpec(nparts=nparts, method=method, ncrit=48,
                          traversal_backend="host"))
    return g, r


def test_partition_boxes_bytes_and_slack_equal(geometries):
    g, r = geometries
    np.testing.assert_array_equal(g.part, r.part)
    np.testing.assert_array_equal(g.boxes, r.boxes)
    np.testing.assert_array_equal(g.adj_boxes, r.adj_boxes)
    np.testing.assert_array_equal(g.bytes_matrix, r.bytes_matrix)
    np.testing.assert_array_equal(g.slack, r.slack)
    assert (g.adjacency_degree, g.diameter) == (r.adjacency_degree,
                                                r.diameter)
    for a, b in zip(g.owners, r.owners):
        np.testing.assert_array_equal(a, b)


def test_trees_and_interaction_plans_equal(geometries):
    g, r = geometries
    for tg, tr in zip(g.trees, r.trees):
        for f in ("x", "q", "perm", "parent", "child_start", "n_child",
                  "body_start", "n_body", "center", "radius", "level"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(tr, f))
    for rg, rr in zip(g.receivers, r.receivers):
        assert rg.local_margin == rr.local_margin
        _assert_plans_equal(rg.local, rr.local)
        assert [b.sender for b in rg.remote] == [b.sender for b in rr.remote]
        for bg, br in zip(rg.remote, rr.remote):
            assert bg.margin == br.margin
            _assert_plans_equal(bg.inter, br.inter)


def test_lets_equal_and_payload_multipoles_close(geometries):
    g, r = geometries
    assert g.lets.keys() == r.lets.keys()
    for key in g.lets:
        a, b = g.lets[key], r.lets[key]
        for f in ("center", "radius", "child_start", "n_child", "body_start",
                  "n_body", "truncated", "x", "q", "cell_src", "body_src"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.trunc_margin == b.trunc_margin
        np.testing.assert_allclose(a.M, b.M, rtol=1e-5,
                                   atol=1e-6 * np.abs(b.M).max())
    for a, b in zip(g.Ms, r.Ms):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def test_engine_and_stream_tables_equal(geometries):
    g, r = geometries
    tg, tr = build_engine_tables(g), jtables(r)
    fg, fr = flatten_tables(tg), flatten_tables(tr)
    assert fg.keys() == fr.keys()
    for k in fg:
        np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)
        if isinstance(fr[k], np.ndarray):
            assert fg[k].dtype == fr[k].dtype, k
    sg = build_p2p_stream_tables(tg.p2p_buckets, 128)
    sr = jstream(tr.p2p_buckets, 128)
    assert sg.keys() == sr.keys()
    for k in sg:
        np.testing.assert_array_equal(sg[k], sr[k], err_msg=k)


def test_device_traversal_is_not_ported():
    """The name predates the device traversal's port: "device" now plans
    (on the CPU with K3's plain version) to the host-planned geometry, and
    an unknown backend still raises."""
    x, q = _problem(n=200)
    dev = plan_geometry(x, q, PartitionSpec(nparts=2,
                                            traversal_backend="device"),
                        device="cpu")
    host = plan_geometry(x, q, PartitionSpec(nparts=2), device="cpu")
    np.testing.assert_array_equal(dev.bytes_matrix, host.bytes_matrix)
    for rd, rh in zip(dev.receivers, host.receivers):
        _assert_plans_equal(rd.local, rh.local)
    with pytest.raises(ValueError):
        plan_geometry(x, q, PartitionSpec(nparts=2,
                                          traversal_backend="gpu"),
                      device="cpu")


@pytest.mark.parametrize("bad", ["shape", "nan", "theta", "nparts"])
def test_invalid_inputs_are_named(bad):
    x, q = _problem(n=100)
    spec = PartitionSpec(nparts=2)
    if bad == "shape":
        x = x[:, :2]
    elif bad == "nan":
        x = x.copy()
        x[3, 1] = np.nan
    elif bad == "theta":
        spec = PartitionSpec(nparts=2, theta=0.0)
    else:
        spec = PartitionSpec(nparts=0)
    with pytest.raises(ValueError):
        plan_geometry(x, q, spec, device="cpu")
