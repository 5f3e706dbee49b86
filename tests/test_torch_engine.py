"""The port's batched engine (repro_torch.core.engine.DeviceEngine, through
`FMMSession`) against the JAX reference's
`repro.core.engine.DeviceEngine(geo, use_kernels=False).evaluate()`, on the
CPU.

Tolerance rtol 1e-6 / atol 2e-5, as tests/test_engine.py: both engines sum
the same float32 terms in float64, grouped differently (segment sums,
batched products, the port's float64-then-rounded M2L derivatives against
the reference's float32 AD).  End to end against the float64 direct sum:
rel-L2 < 3e-3, as examples/quickstart.py.
"""
import numpy as np
import pytest
import torch

from repro.core.api import PartitionSpec as JSpec
from repro.core.api import plan_geometry as jplan
from repro.core.engine import DeviceEngine as JEngine
from repro.core.engine import build_engine_tables as jtables
from repro.core.engine import stack_bodies as jstack
from repro_torch.convert import engine_tables_from_numpy
from repro_torch.core import engine as eng_mod
from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine import DeviceEngine
from repro_torch.core.fmm import direct_potential

RTOL, ATOL = 1e-6, 2e-5


def _problem(n=1500, seed=5, qseed=6, dist="sphere"):
    x = make_distribution(dist, n, seed=seed)
    q = np.random.default_rng(qseed).uniform(-1, 1, n)
    return x, q


def _clustered_problem():
    """Duplicated sites -> >= 3 of 8 morton partitions empty."""
    pts = np.array([[.1, .1, .1], [.8, .2, .3], [.3, .9, .5],
                    [.6, .6, .9], [.9, .9, .1]])
    x = np.repeat(pts, 60, axis=0)
    q = np.random.default_rng(1).uniform(-1, 1, len(x))
    return x, q


def _pair(x, q, **spec):
    g = plan_geometry(x, q, PartitionSpec(**spec), device="cpu")
    r = jplan(x, q, JSpec(traversal_backend="host", **spec))
    return g, r


def _flatten(t) -> dict:
    """A reference EngineTables as the flat dict `convert` takes."""
    out = {k: getattr(t, k) for k in ("n", "n_parts", "n_cells_max",
                                      "n_bodies_max", "p", "l2p_t_idx",
                                      "orig_idx", "flat_idx")}
    out.update({f"up/{k}": v for k, v in t.up.tables.items()})
    out.update({f"m2l/{k}": v for k, v in t.m2l.items()})
    out.update({f"m2p/{k}": v for k, v in t.m2p.items()})
    for i, b in enumerate(t.p2p_buckets):
        out.update({f"p2p/{i}/{k}": v for k, v in b.items()})
    return out


@pytest.fixture(scope="module")
def orb_case():
    """One ORB geometry planned by both packages, and the reference's
    potential for it (shared so the reference compiles its engine once)."""
    x, q = _problem()
    g, r = _pair(x, q, nparts=5, method="orb", ncrit=48)
    return g, r, JEngine(r, use_kernels=False).evaluate()


def test_engine_matches_reference(orb_case):
    g, _, ref = orb_case
    phi = FMMSession(g, device="cpu").evaluate()
    np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)
    assert not phi.flags.writeable


def test_engine_single_partition_matches_reference():
    x, q = _problem(n=800, dist="plummer")
    g, r = _pair(x, q, nparts=1, ncrit=48)
    ref = JEngine(r, use_kernels=False).evaluate()
    phi = FMMSession(g, device="cpu").evaluate()
    np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)


def test_engine_with_empty_partitions_matches_reference():
    x, q = _clustered_problem()
    g, r = _pair(x, q, nparts=8, method="morton", ncrit=64)
    assert sum(len(o) == 0 for o in g.owners) >= 3
    ref = JEngine(r, use_kernels=False).evaluate()
    for stream in (False, True):
        phi = FMMSession(g, device="cpu", p2p_stream=stream).evaluate()
        np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)


def test_engine_on_reference_tables_via_convert(orb_case):
    """The port's engine on exactly the reference's tables and payload."""
    _, r, ref = orb_case
    jt = jtables(r)
    x_pad, q_pad = jstack(r.trees, jt.n_bodies_max)
    tables = engine_tables_from_numpy(_flatten(jt), "cpu")
    assert isinstance(tables.m2l["src"], torch.Tensor)
    for stream in (False, True):
        phi = DeviceEngine(tables, x_pad, q_pad, device="cpu",
                           p2p_stream=stream).evaluate()
        np.testing.assert_allclose(phi, ref, rtol=RTOL, atol=ATOL)


def test_convert_names_missing_arrays():
    x, q = _problem(n=300)
    flat = _flatten(jtables(jplan(x, q, JSpec(nparts=2,
                                              traversal_backend="host"))))
    del flat["m2l/d"]
    with pytest.raises(KeyError, match="m2l/d"):
        engine_tables_from_numpy(flat, "cpu")


def test_stream_matches_gathered_in_port():
    x, q = _problem(n=2000, seed=3)
    g = plan_geometry(x, q, PartitionSpec(nparts=4, ncrit=32), device="cpu")
    gathered = FMMSession(g, device="cpu").evaluate()
    sess = FMMSession(g, device="cpu", p2p_stream=True)
    stream = sess.evaluate()
    assert sess.engine.stream_tables() is not None
    assert sess.engine.stream_fallbacks == 0
    np.testing.assert_allclose(stream, gathered, rtol=RTOL, atol=ATOL)


def test_stream_falls_back_to_gathered_buckets(monkeypatch):
    x, q = _problem(n=1000, seed=4)
    g = plan_geometry(x, q, PartitionSpec(nparts=2), device="cpu")
    gathered = FMMSession(g, device="cpu").evaluate()
    monkeypatch.setattr(eng_mod, "build_p2p_stream_tables",
                        lambda buckets, block_t: None)
    sess = FMMSession(g, device="cpu", p2p_stream=True)
    phi = sess.evaluate()
    assert sess.engine.stream_fallbacks == 1
    assert not sess.engine.p2p_stream
    np.testing.assert_array_equal(phi, gathered)


def test_end_to_end_against_direct_sum():
    x = make_distribution("sphere", 3000, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, 3000)
    phi = FMMSession.from_points(x, q, PartitionSpec(nparts=8),
                                 device="cpu").evaluate()
    d = direct_potential(x, q, device="cpu")
    assert phi.shape == (3000,) and np.isfinite(phi).all()
    assert np.linalg.norm(phi - d) / np.linalg.norm(d) < 3e-3


def test_default_device_is_the_card():
    """device=None means CUDA: without a card the entry points raise
    instead of running on the CPU."""
    x, q = _problem(n=400)
    if torch.cuda.is_available():
        sess = FMMSession.from_points(x, q, PartitionSpec(nparts=2))
        assert sess.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FMMSession.from_points(x, q, PartitionSpec(nparts=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        direct_potential(x, q)
