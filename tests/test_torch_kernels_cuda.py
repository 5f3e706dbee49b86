"""The port's CUDA kernels K1 (csrc/p2p.cu), K2 (csrc/p2p_stream.cu) and
K3 (csrc/mac.cu) against their plain PyTorch versions, on the card, and the
paths that run them: the engine, the device traversal and a step.

A CUDA kernel has no CPU mode: every test here takes the `cuda_device`
fixture, which skips it where no card is present.  The file imports no JAX,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerance rtol/atol 2e-5 against the plain versions (float32 sums in
another order, `rsqrtf` against `torch.rsqrt`); K1 and K2 are bitwise equal
on identical slabs because they share one tile body.  K3 equals its plain
version bit for bit: both round the same float32 steps in the same order.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine import build_engine_tables, stack_bodies
from repro_torch.core.engine.p2p import stream_payload
from repro_torch.core.engine.schedules import build_p2p_stream_tables
from repro_torch.kernels import mac as kmac
from repro_torch.kernels import p2p as kp2p
from repro_torch.kernels import p2p_stream as kstream

RTOL = ATOL = 2e-5


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _p2p_inputs(P, S, T, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (P, S)).astype(np.float32)
    xs = rng.uniform(-1, 1, (P, S, 3)).astype(np.float32)
    xt = rng.uniform(-1, 1, (P, T, 3)).astype(np.float32)
    return [torch.as_tensor(a) for a in (q, xs, xt)]


@pytest.fixture(scope="module")
def stream_case():
    """Stream tables and payload of a small real geometry."""
    n = 1200
    x = make_distribution("sphere", n, seed=7)
    q = np.random.default_rng(8).uniform(-1, 1, n)
    geo = plan_geometry(x, q, PartitionSpec(nparts=4, ncrit=32),
                        device="cpu")
    tables = build_engine_tables(geo)
    x_pad, q_pad = stack_bodies(geo.trees, tables.n_bodies_max)
    stream = build_p2p_stream_tables(tables.p2p_buckets, 128)
    payload = stream_payload(torch.as_tensor(x_pad), torch.as_tensor(q_pad),
                             stream["pad"])
    return stream, payload


@pytest.mark.parametrize("P,S,T", [(4, 64, 128), (3, 40, 200), (1000, 32, 64),
                                   (5, 300, 37)])
def test_k1_matches_plain_on_card(cuda_device, P, S, T):
    q, xs, xt = (t.to(cuda_device) for t in _p2p_inputs(P, S, T))
    before = kp2p.launches
    got = kp2p.p2p(q, xs, xt)
    torch.cuda.synchronize()
    assert kp2p.launches == before + 1
    torch.testing.assert_close(got, kp2p.p2p_ref(q, xs, xt), rtol=RTOL,
                               atol=ATOL)


def test_k1_rejects_non_contiguous_on_card(cuda_device):
    q, xs, xt = (t.to(cuda_device) for t in _p2p_inputs(4, 8, 16))
    with pytest.raises(ValueError):
        kp2p.p2p(q, xs, xt.transpose(0, 1).contiguous().transpose(0, 1))


def test_k2_matches_plain_and_k1_bitwise_on_card(cuda_device, stream_case):
    stream, payload = stream_case
    bt, smax = stream["block_t"], stream["smax"]
    meta = torch.as_tensor(stream["meta"]).to(cuda_device)
    pay = payload.to(cuda_device)
    before = kstream.launches
    got = kstream.p2p_stream(meta, pay, block_t=bt, smax=smax)
    torch.cuda.synchronize()
    assert kstream.launches == before + 1
    torch.testing.assert_close(
        got, kstream.p2p_stream_gathered(meta, pay, block_t=bt, smax=smax),
        rtol=RTOL, atol=ATOL)
    live = meta[meta[:, 3] > 0].contiguous()
    q, xs, xt = kstream.stream_slabs(live, pay, block_t=bt, smax=smax)
    assert torch.equal(kp2p.p2p(q, xs, xt),
                       kstream.p2p_stream(live, pay, block_t=bt, smax=smax))


def test_engine_on_card_launches_kernels_and_matches_cpu(cuda_device):
    """The session on the card goes through K1 (gathered) and K2 (stream)
    and agrees with the session on the CPU at rtol 1e-5 / atol 1e-4 plus
    1e-6 of sum_j |q_j| / r_ij: the card's atomics and rsqrtf round the
    float32 terms in another order, so the difference scales with the sum
    of each potential's absolute terms, not with the potential."""
    from repro_torch.core.api import FMMSession
    x = make_distribution("sphere", 3000, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, 3000)
    spec = PartitionSpec(nparts=4)
    geo = plan_geometry(x, q, spec, device="cpu")
    phi_abs = FMMSession(plan_geometry(x, np.abs(q), spec, device="cpu"),
                         device="cpu").evaluate()
    for stream in (False, True):
        k1, k2 = kp2p.launches, kstream.launches
        card = FMMSession(geo, device=cuda_device,
                          p2p_stream=stream).evaluate()
        if stream:
            assert kstream.launches == k2 + 1 and kp2p.launches == k1
        else:
            assert kp2p.launches > k1 and kstream.launches == k2
        cpu = FMMSession(geo, device="cpu", p2p_stream=stream).evaluate()
        tol = 1e-4 + 1e-5 * np.abs(cpu) + 1e-6 * phi_abs
        assert np.all(np.abs(card - cpu) <= tol)


@pytest.mark.parametrize("K", [128, 4096, 1 << 20])
def test_k3_matches_plain_bitwise_on_card(cuda_device, K):
    rng = np.random.default_rng(K)
    ca, cb = (torch.as_tensor(rng.uniform(-1, 1, (K, 3)).astype(np.float32),
                              device=cuda_device) for _ in "ab")
    ra, rb = (torch.as_tensor(rng.uniform(0, .3, K).astype(np.float32),
                              device=cuda_device) for _ in "ab")
    before = kmac.launches
    got = kmac.mac_margins(ca, ra, cb, rb, 0.37)
    torch.cuda.synchronize()
    assert kmac.launches == before + 1
    assert torch.equal(got, kmac.mac_margins_ref(ca, ra, cb, rb, 0.37))
    with pytest.raises(ValueError, match="multiple"):
        kmac.mac_margins(ca[:100], ra[:100], cb[:100], rb[:100], 0.37)


def test_device_traversal_on_card_matches_host(cuda_device):
    """A robust tree (the reference's golden sphere case): the traversal
    through K3 on the card emits the host traversal's lists in order."""
    from repro_torch.core.engine.traversal import device_dual_traversal
    from repro_torch.core.traversal import dual_traversal
    from repro_torch.core.tree import build_tree
    x = make_distribution("sphere", 1200, seed=3)
    q = np.random.default_rng(4).uniform(-1, 1, 1200)
    t = build_tree(x, q, ncrit=48)
    before = kmac.launches
    m2l, p2p, m2p, margin = device_dual_traversal(t, t, 0.5,
                                                  device=cuda_device)
    assert kmac.launches > before
    m2l_h, p2p_h = dual_traversal(t, t, 0.5)
    np.testing.assert_array_equal(m2l, m2l_h)
    np.testing.assert_array_equal(p2p, p2p_h)
    assert len(m2p) == 0
    plain = device_dual_traversal(t, t, 0.5, use_kernel=False, device="cpu")
    assert margin == plain[3]


def test_step_on_card_matches_cpu(cuda_device):
    """A within-slack step of a device-planned session on the card against
    the same step on the CPU (planned with K3's plain version, so both hold
    the same plans), at the engine test's card-against-CPU tolerance."""
    from repro_torch.core.api import FMMSession
    from repro_torch.core.fmm import direct_potential
    x = make_distribution("sphere", 3000, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, 3000)
    spec = PartitionSpec(nparts=4, traversal_backend="device")
    card = FMMSession.from_points(x, q, spec, device=cuda_device)
    cpu = FMMSession.from_points(x, q, spec, device="cpu")
    card.evaluate()
    cpu.evaluate()
    eps = float(cpu.geometry.slack.min())
    x1 = x + np.random.default_rng(2).uniform(-eps / 4, eps / 4, x.shape)
    rc, rh = card.step(x1), cpu.step(x1)
    assert rc.rebuilt == rh.rebuilt == () and rc.refreshed == rh.refreshed
    assert len(rc.refreshed) == 4
    phi_c, phi_h = card.evaluate(), cpu.evaluate()
    absum = direct_potential(x1, np.abs(q), device="cpu")
    tol = 1e-4 + 1e-5 * np.abs(phi_h) + 1e-6 * absum
    assert np.all(np.abs(phi_c - phi_h) <= tol)
