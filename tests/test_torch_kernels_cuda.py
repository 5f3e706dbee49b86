"""The port's CUDA kernels K1 (csrc/p2p.cu), K2 (csrc/p2p_stream.cu), K3
(csrc/mac.cu), K4 (csrc/attention.cu) and K5 (csrc/wkv.cu) against their
plain PyTorch versions, on the card, and the paths that run them: the
engine, the per-partition reference executor, `run_distributed_fmm`, the
device traversal, a step, and the language models.

A CUDA kernel has no CPU mode: every test here takes the `cuda_device`
fixture, which skips it where no card is present.  The file imports no JAX,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerance rtol/atol 2e-5 against the plain versions (float32 sums in
another order, `rsqrtf` against `torch.rsqrt`); K2 writes exactly 0.0 past
each tile's tgt_len, where its plain version sums the slab, so it is held
to the plain version on the lanes below tgt_len and to zeros on the rest;
K1 and K2 are bitwise equal on identical slabs below tgt_len because they
share one pair body and one summation order.  K3 equals its plain
version bit for bit: both round the same float32 steps in the same order.
K4 against `attention_rounded_ref`, the plain version with the kernel's
roundings: rtol/atol 2e-4 in float32; in bfloat16 atol 4e-3 + rtol 1.6e-2
elementwise (two units in the last place of a bfloat16 output at the worst:
both round one float32 value to it) and 1e-2 per query row in relative L2,
the limits chip_smoke.py holds it to at qwen3-0.6b's shape; the bfloat16
tensor-core kernel also against `attention_tiled_ref`, in its own tile
order (K4_TILED_ROW_REL, K4_TILED_ROW_MEDIAN below).  K5 at rtol/atol 1e-4 in float32; in
bfloat16 both round one float32 sum (taken in another order) to the output
type, so they may land on neighbouring values: rtol 1e-2 / atol 1e-4; two
K5 launches on the same inputs are bitwise equal.  Training: K4's and K5's
autograd Functions (the kernel forward, the PyTorch backward) against
autograd through the plain versions at every head size and mask kind, a
forward without grad building no graph, and one float32 train step of
the qwen3 and rwkv6 smoke models on the card against the CPU (their
limits beside the tests).  The sharding tier: dbrx-smoke's expert-parallel
MoE on a mesh stacked on the card against the same mesh on the CPU, and a
graphed decode step under that mesh against the eager one.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine import build_engine_tables, stack_bodies
from repro_torch.core.engine.p2p import stream_payload
from repro_torch.core.engine.schedules import build_p2p_stream_tables
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import mac as kmac
from repro_torch.kernels import p2p as kp2p
from repro_torch.kernels import p2p_stream as kstream
from repro_torch.kernels import rwkv as krwkv

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


def _k2_against_plain(got, meta, pay, bt, smax):
    """K2's output against its plain version on the lanes below each tile's
    tgt_len, at RTOL / ATOL, and exactly 0.0 on every other lane."""
    lane = torch.arange(bt, device=meta.device)
    valid = lane[None, :] < meta[:, 3:4]
    want = kstream.p2p_stream_gathered(meta, pay, block_t=bt, smax=smax)
    torch.testing.assert_close(got[valid], want[valid], rtol=RTOL, atol=ATOL)
    rest = got[~valid]
    assert torch.equal(rest, torch.zeros_like(rest))
    return valid


def test_k2_matches_plain_and_k1_bitwise_on_card(cuda_device, stream_case):
    """K2 against its plain version on the out_valid lanes (exact zeros on
    the rest), and K1 on the same slabs bit for bit on the lanes below each
    tile's tgt_len: past it K2 writes 0 where K1 sums the slab."""
    stream, payload = stream_case
    bt, smax = stream["block_t"], stream["smax"]
    meta = torch.as_tensor(stream["meta"]).to(cuda_device)
    pay = payload.to(cuda_device)
    before = kstream.launches
    got = kstream.p2p_stream(meta, pay, block_t=bt, smax=smax)
    torch.cuda.synchronize()
    assert kstream.launches == before + 1
    valid = _k2_against_plain(got, meta, pay, bt, smax)
    assert torch.equal(valid.cpu(), torch.as_tensor(stream["out_valid"]))
    live = meta[meta[:, 3] > 0].contiguous()
    q, xs, xt = kstream.stream_slabs(live, pay, block_t=bt, smax=smax)
    k1 = kp2p.p2p(q, xs, xt)
    k2 = kstream.p2p_stream(live, pay, block_t=bt, smax=smax)
    lv = torch.arange(bt, device=cuda_device)[None, :] < live[:, 3:4]
    assert torch.equal(k1[lv], k2[lv])


def _k2_meta(block_t, seed=0):
    """A hand-built tile table: every (tgt_len, src_len) of the edge cases,
    a dead tile between each two live ones and two at the end, on a random
    payload (charges in [-1, 1], a few exactly 0) padded as the engine pads
    it."""
    rng = np.random.default_rng(seed)
    t_lens = [1, 31, 32, 33, 64, 65, 128] + ([200, 256] if block_t > 128
                                             else [])
    rows = []
    F = 5000
    for tl in t_lens:
        for sl in (0, 1, 31, 33, 64):
            rows.append([rng.integers(0, F - 64), sl,
                         rng.integers(0, F - block_t), tl])
            rows.append([0, 0, 0, 0])
    rows += [[0, 0, 0, 0]] * 2
    meta = np.asarray(rows, np.int32)
    x = rng.uniform(-1, 1, (3, F))
    q = rng.uniform(-1, 1, F)
    q[rng.choice(F, 200, replace=False)] = 0.0
    pay = np.concatenate([np.concatenate([x, q[None]]),
                          np.zeros((4, max(64, block_t)))], axis=1)
    return meta, pay.astype(np.float32)


@pytest.mark.parametrize("block_t", [128, 256])
def test_k2_live_pairs_only_on_card(cuda_device, block_t):
    """tgt_len across the two-targets-a-lane passes, src_len across the
    32-source chunks (smax 64), dead tiles between live ones."""
    meta, pay = _k2_meta(block_t)
    meta = torch.as_tensor(meta, device=cuda_device)
    pay = torch.as_tensor(pay, device=cuda_device)
    got = kstream.p2p_stream(meta, pay, block_t=block_t, smax=64)
    torch.cuda.synchronize()
    _k2_against_plain(got, meta, pay, block_t, 64)
    # a tile with no sources is all zeros, a dead tile too
    assert not got[meta[:, 1] == 0].any()


def test_k2_bitwise_repeatable_on_card(cuda_device):
    """Two launches give the same bits."""
    meta, pay = _k2_meta(256, seed=1)
    meta = torch.as_tensor(meta, device=cuda_device)
    pay = torch.as_tensor(pay, device=cuda_device)
    assert torch.equal(kstream.p2p_stream(meta, pay, block_t=256, smax=64),
                       kstream.p2p_stream(meta, pay, block_t=256, smax=64))


def _k1_zero_patterns(P, S, T, seed=0):
    """K1 inputs whose rows end in zero charges (row i keeps (i * 7) % (S +
    1) sources), with interior zeros and some rows all zero."""
    q, xs, xt = _p2p_inputs(P, S, T, seed)
    keep = (torch.arange(P) * 7) % (S + 1)
    q[torch.arange(S)[None, :] >= keep[:, None]] = 0.0
    q[:, ::5] = 0.0                                   # interior zeros
    q[::4] = 0.0                                      # rows of padding
    return q, xs, xt


@pytest.mark.parametrize("S", [45, 300])
@pytest.mark.parametrize("T", [1, 37, 64, 200])
def test_k1_trimmed_rows_match_plain_on_card(cuda_device, S, T):
    q, xs, xt = (t.to(cuda_device) for t in _k1_zero_patterns(23, S, T))
    got = kp2p.p2p(q, xs, xt)
    torch.testing.assert_close(got, kp2p.p2p_ref(q, xs, xt), rtol=RTOL,
                               atol=ATOL)
    assert not got[::4].any()                         # padding rows are 0


@pytest.mark.parametrize("S,keep", [(64, 23), (37, 1), (300, 257)])
def test_k1_stops_at_the_last_charge_bitwise_on_card(cuda_device, S, keep):
    """A row gives the bits of the same row with its trailing zero sources
    cut off (S = 37 also takes the unaligned rows' scalar loads)."""
    q, xs, xt = (t.to(cuda_device) for t in _p2p_inputs(9, S, 64, seed=S))
    q[:, keep:] = 0.0
    cut = kp2p.p2p(q[:, :keep].contiguous(), xs[:, :keep].contiguous(), xt)
    assert torch.equal(kp2p.p2p(q, xs, xt), cut)


def test_k1_bitwise_repeatable_on_card(cuda_device):
    """Two launches give the same bits."""
    q, xs, xt = (t.to(cuda_device)
                 for t in _k1_zero_patterns(1000, 40, 64, seed=3))
    assert torch.equal(kp2p.p2p(q, xs, xt), kp2p.p2p(q, xs, xt))


def test_engine_on_card_launches_kernels_and_matches_cpu(cuda_device):
    """The per-phase session on the card goes through K1 (gathered) and K2
    (stream) and agrees with the session on the CPU at rtol 1e-5 / atol
    1e-4 plus 1e-6 of sum_j |q_j| / r_ij: the card's atomics and rsqrtf
    round the float32 terms in another order, so the difference scales
    with the sum of each potential's absolute terms, not with the
    potential.  (The compiled session: test_fused_evaluate_on_card_*.)"""
    from repro_torch.core.api import FMMSession
    x = make_distribution("sphere", 3000, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, 3000)
    spec = PartitionSpec(nparts=4)
    geo = plan_geometry(x, q, spec, device="cpu")
    phi_abs = FMMSession(plan_geometry(x, np.abs(q), spec, device="cpu"),
                         device="cpu").evaluate()
    for stream in (False, True):
        k1, k2 = kp2p.launches, kstream.launches
        card = FMMSession(geo, device=cuda_device, p2p_stream=stream,
                          fused=False).evaluate()
        if stream:
            assert kstream.launches == k2 + 1 and kp2p.launches == k1
        else:
            assert kp2p.launches > k1 and kstream.launches == k2
        cpu = FMMSession(geo, device="cpu", p2p_stream=stream).evaluate()
        tol = 1e-4 + 1e-5 * np.abs(cpu) + 1e-6 * phi_abs
        assert np.all(np.abs(card - cpu) <= tol)


def test_executor_refuses_plain_near_field_on_card(cuda_device):
    """On the card the near field is K1: `use_kernels=False` raises in
    `execute_geometry` and `fmm.p2p_apply` before anything launches."""
    from repro_torch.core import fmm
    from repro_torch.core.api import execute_geometry
    x = make_distribution("sphere", 3000, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, 3000)
    geo = plan_geometry(x, q, PartitionSpec(nparts=4), device="cpu")
    r = geo.receivers[0]
    before = kp2p.launches
    with pytest.raises(ValueError, match="CPU only"):
        execute_geometry(geo, use_kernels=False, device=cuda_device)
    with pytest.raises(ValueError, match="CPU only"):
        fmm.p2p_apply(r.tree, r.tree, r.local, use_kernels=False,
                      device=cuda_device)
    assert kp2p.launches == before


def test_executor_on_card_launches_k1_per_block_and_matches_cpu(cuda_device):
    """`execute_geometry` on the card runs K1 once for every P2P block of
    every plan it evaluates, agrees with the executor on the CPU at the
    engine test's card-against-CPU tolerance, and a memoized repeat
    uploads nothing."""
    from repro_torch.core.api import DeviceMemo, FMMSession, execute_geometry
    x = make_distribution("sphere", 3000, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, 3000)
    spec = PartitionSpec(nparts=4)
    geo = plan_geometry(x, q, spec, device="cpu")
    phi_abs = FMMSession(plan_geometry(x, np.abs(q), spec, device="cpu"),
                         device="cpu").evaluate()
    blocks = sum(len(pl.p2p_blocks) for r in geo.receivers
                 for pl in [r.local] + [rb.inter for rb in r.remote]
                 if pl.n_p2p)
    memo = DeviceMemo(cuda_device)
    before = kp2p.launches
    card = execute_geometry(geo, asarray=memo)
    assert kp2p.launches == before + blocks
    misses = memo.misses
    again = execute_geometry(geo, asarray=memo)
    assert memo.misses == misses and kp2p.launches == before + 2 * blocks
    cpu = execute_geometry(geo, device="cpu")
    tol = 1e-4 + 1e-5 * np.abs(cpu) + 1e-6 * phi_abs
    assert np.all(np.abs(card - cpu) <= tol)
    assert np.all(np.abs(again - cpu) <= tol)
    sess = FMMSession(geo, device=cuda_device, engine=False)
    assert np.all(np.abs(sess.evaluate() - cpu) <= tol)
    assert kp2p.launches == before + 3 * blocks


def test_run_distributed_fmm_on_card_matches_direct_sum(cuda_device):
    """The quickstart's call on the card at N = 20,000: planned with K3,
    evaluated with K1, rel-L2 < 3e-3 against the float64 direct sum."""
    import warnings
    from repro_torch.core.distributed_fmm import run_distributed_fmm
    from repro_torch.core.fmm import direct_potential
    n = 20000
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)
    k1, k3 = kp2p.launches, kmac.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = run_distributed_fmm(x, q, nparts=8, method="orb",
                                  protocol="hsdx", theta=0.5, ncrit=64)
    assert kp2p.launches > k1 and kmac.launches > k3
    d = direct_potential(x, q, device=cuda_device)
    assert np.linalg.norm(res.phi - d) / np.linalg.norm(d) < 3e-3
    assert res.n_stages >= 1 and res.schedule_stats["n_msgs"] > 0


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


def _normal(rng, shape, dtype, device, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.as_tensor(a, device=device).to(dtype)


@pytest.mark.parametrize("B,H,Hkv,S,D,dtype,window,causal", [
    (1, 4, 4, 128, 64, torch.float32, None, True),
    (2, 4, 2, 256, 64, torch.float32, None, True),
    (1, 8, 2, 128, 128, torch.float32, None, True),
    (1, 2, 1, 200, 64, torch.float32, None, True),
    (1, 2, 2, 256, 64, torch.float32, 64, True),
    (1, 2, 2, 256, 64, torch.float32, 128, True),
    (2, 4, 1, 100, 32, torch.float32, None, False),
    (1, 2, 2, 128, 64, torch.bfloat16, None, True),
    (1, 16, 8, 1024, 128, torch.bfloat16, None, True),
    (1, 4, 2, 333, 128, torch.bfloat16, 64, True),
    (1, 2, 1, 200, 256, torch.float32, None, True),    # gemma3's head dim
    (1, 2, 2, 300, 256, torch.float32, 64, True),
    (2, 2, 1, 77, 256, torch.float32, None, False),
    (1, 4, 2, 333, 256, torch.bfloat16, 64, True),
])
def test_k4_matches_plain_on_card(cuda_device, B, H, Hkv, S, D, dtype,
                                  window, causal):
    rng = np.random.default_rng(S + D + H)
    q = _normal(rng, (B, H, S, D), dtype, cuda_device)
    k = _normal(rng, (B, Hkv, S, D), dtype, cuda_device)
    v = _normal(rng, (B, Hkv, S, D), dtype, cuda_device)
    before = kattn.launches
    got = kattn.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kattn.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = kattn.attention_rounded_ref(q, k, v, causal=causal,
                                       window=window).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=1.6e-2, atol=4e-3)
        err = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
        assert float(err.max()) <= 1e-2


# K4's limits in bfloat16 against `attention_rounded_ref` (see the module
# docstring), and per row against `attention_tiled_ref` with the kernel's own
# 128-key tiles, which differs from the kernel only by the order of float32
# sums: the largest per-row relative L2 measured on the card was 3.1e-3
# (one bf16 step in a row of small outputs; K4_TILED_ROW_REL about twice
# that), and the median 0, where against `attention_rounded_ref` it is
# 2.2e-3 (p rounded against the row's max changes most rows), so the median
# is held to K4_TILED_ROW_MEDIAN
K4_ATOL, K4_RTOL, K4_ROW_REL = 4e-3, 1.6e-2, 1e-2
K4_TILED_ROW_REL, K4_TILED_ROW_MEDIAN = 6e-3, 1e-3


def _k4_bf16_case(device, B, H, Hkv, S, D, window, causal, seed=None):
    """K4 on bfloat16 inputs from a numpy seed: (got, q, k, v), having
    checked one launch and the result against `attention_rounded_ref`."""
    rng = np.random.default_rng(S + D + H if seed is None else seed)
    q, k, v = (_normal(rng, (B, n, S, D), torch.bfloat16, device)
               for n in (H, Hkv, Hkv))
    before = kattn.launches
    got = kattn.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kattn.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = kattn.attention_rounded_ref(q, k, v, causal=causal,
                                       window=window).float()
    torch.testing.assert_close(got.float(), want, rtol=K4_RTOL, atol=K4_ATOL)
    err = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) <= K4_ROW_REL
    return got, q, k, v


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [15, 127, 128, 129, 1000, 4096])
def test_k4_bf16_tensor_cores_on_card(cuda_device, S, D):
    """The wgmma/TMA kernel at every head size, around the 128-row and
    128-key tile edges (64-key at D = 256) and at the models' lengths;
    B = 2 with B x Hkv = 4 kv heads, so a ragged last tile that read past S
    would read the next head's rows instead of zeros."""
    _k4_bf16_case(cuda_device, 2, 4, 2, S, D, None, True)


@pytest.mark.parametrize("B,H,Hkv,S,D,window,causal", [
    (1, 4, 4, 1000, 128, None, True),     # GQA group 1
    (2, 8, 2, 1000, 64, None, True),      # GQA group 4
    (2, 4, 2, 1000, 128, 200, True),      # window edge inside tiles
    (1, 4, 1, 4096, 64, 128, True),       # window of one tile, unaligned
    (2, 4, 2, 333, 32, 64, True),
    (2, 4, 2, 129, 128, None, False),     # non-causal, ragged
    (1, 4, 4, 1000, 64, 300, False),      # non-causal with a window
    (2, 2, 1, 15, 128, None, False),
    (2, 4, 2, 1000, 256, 200, True),      # D = 256: window inside tiles
    (1, 4, 1, 1100, 256, 64, True),       # window of one 64-key tile
    (2, 2, 1, 193, 256, None, False),     # non-causal, ragged
])
def test_k4_bf16_masks_and_groups_on_card(cuda_device, B, H, Hkv, S, D,
                                          window, causal):
    _k4_bf16_case(cuda_device, B, H, Hkv, S, D, window, causal)


@pytest.mark.parametrize("B,H,Hkv,S,D,window", [
    (1, 16, 8, 4096, 128, None),          # qwen3-0.6b's prefill
    (2, 4, 2, 1000, 64, 200),
    (2, 4, 2, 129, 32, None),
    (1, 16, 8, 4096, 256, None),          # gemma3-12b's global prefill
    (1, 16, 8, 4096, 256, 1024),          # and its local (window) one
])
def test_k4_bf16_matches_tiled_ref_on_card(cuda_device, B, H, Hkv, S, D,
                                           window):
    """In the kernel's own tile order the p roundings are the kernel's, so
    the two agree to float32 summation order: per row within
    K4_TILED_ROW_REL, and most rows exactly (median K4_TILED_ROW_MEDIAN)."""
    got, q, k, v = _k4_bf16_case(cuda_device, B, H, Hkv, S, D, window, True)
    want = kattn.attention_tiled_ref(q, k, v, window=window,
                                     block_k=kattn.BLOCK_K[D]).float()
    torch.testing.assert_close(got.float(), want, rtol=K4_RTOL, atol=K4_ATOL)
    err = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) <= K4_TILED_ROW_REL
    assert float(err.median()) <= K4_TILED_ROW_MEDIAN


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,dtype", [
    (2, 4, 2, 129, 77, 64, torch.bfloat16),     # ragged keys, B x Hkv = 4
    (1, 8, 2, 200, 1600, 128, torch.bfloat16),  # vlm cross: 1,600 patches
    (2, 4, 1, 1000, 333, 256, torch.bfloat16),  # D = 256, 64-key tiles
    (2, 4, 2, 64, 200, 32, torch.bfloat16),     # more keys than queries
    (2, 4, 2, 1000, 1000, 64, torch.bfloat16),  # encoder: Sq == Sk
    (1, 16, 16, 1024, 1024, 64, torch.bfloat16),
    (2, 4, 2, 129, 77, 64, torch.float32),
    (1, 4, 2, 100, 300, 128, torch.float32),
    (1, 2, 1, 50, 130, 256, torch.float32),
    (2, 4, 2, 333, 333, 128, torch.float32),    # encoder: Sq == Sk
])
def test_k4_over_keys_of_their_own_length_on_card(cuda_device, B, H, Hkv, Sq,
                                                  Sk, D, dtype):
    """K4 unmasked (`causal=False`) over k/v of Sk rows for Sq queries, the
    models' cross-attention over a memory and the encoder's bidirectional
    self-attention, against its plain versions: float32 at 2e-4 against
    `attention_rounded_ref`; bfloat16 at K4's limits against it and per row
    against `attention_tiled_ref`.  With B x Hkv > 1 and Sk ragged, a key
    tile read past one head's Sk rows would read the next head's."""
    rng = np.random.default_rng(Sq + Sk + D)
    q = _normal(rng, (B, H, Sq, D), dtype, cuda_device)
    k = _normal(rng, (B, Hkv, Sk, D), dtype, cuda_device)
    v = _normal(rng, (B, Hkv, Sk, D), dtype, cuda_device)
    before = kattn.launches
    got = kattn.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kattn.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = kattn.attention_rounded_ref(q, k, v, causal=False).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        return
    torch.testing.assert_close(got.float(), want, rtol=K4_RTOL, atol=K4_ATOL)
    err = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) <= K4_ROW_REL
    tiled = kattn.attention_tiled_ref(q, k, v, causal=False).float()
    err = (got.float() - tiled).norm(dim=-1) / tiled.norm(dim=-1)
    assert float(err.max()) <= K4_TILED_ROW_REL


def test_k4_bf16_rejects_misaligned_on_card(cuda_device):
    buf = torch.zeros(2 * 64 * 64 + 1, device=cuda_device,
                      dtype=torch.bfloat16)
    q = buf[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        kattn.flash_attention(q, q, q)


def test_k4_rejects_what_it_does_not_take_on_card(cuda_device):
    q = torch.zeros(1, 2, 64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_attention(q.transpose(2, 3), q.transpose(2, 3), q)
    q48 = torch.zeros(1, 2, 64, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        kattn.flash_attention(q48, q48, q48)
    with pytest.raises(TypeError):
        kattn.flash_attention(q.half(), q.half(), q.half())


def _wkv_inputs(rng, BH, C, D, dtype, device, random_state, w_lo=0.8):
    r, k, v = (_normal(rng, (BH, C, D), dtype, device, 0.5) for _ in "rkv")
    w = torch.as_tensor(rng.uniform(w_lo, 1.0, (BH, C, D)).astype(np.float32),
                        device=device)
    u = _normal(rng, (BH, D), torch.float32, device, 0.1)
    s0 = (_normal(rng, (BH, D, D), torch.float32, device, 0.1)
          if random_state else torch.zeros(BH, D, D, device=device))
    return r, k, v, w, u, s0


# the grid's edges: every head dim, C below, at and off a multiple of the
# staged chunk (8 or 16 tokens), both launches of D = 64 (2 columns a lane
# below BH 66, 4 from it), decode (C = 1) at the serving batch (BH = 4
# slots x 32 heads), and rwkv6-1.6b's 4,096-token prefill
@pytest.mark.parametrize("BH,C,D,dtype,random_state", [
    (2, 128, 64, torch.float32, False),
    (4, 64, 32, torch.float32, True),
    (1, 256, 128, torch.float32, True),
    (3, 37, 64, torch.float32, True),
    (6, 1, 64, torch.float32, True),
    (8, 200, 64, torch.bfloat16, True),
    (8, 1, 64, torch.bfloat16, True),
    (4, 100, 32, torch.bfloat16, True),
    (2, 77, 128, torch.bfloat16, True),
    (3, 37, 64, torch.bfloat16, False),
    (3, 37, 128, torch.float32, True),
    (128, 1, 64, torch.bfloat16, True),
    (128, 1, 128, torch.float32, False),
    (32, 4096, 64, torch.bfloat16, True),
    (65, 50, 64, torch.float32, True),
    (66, 50, 64, torch.float32, True),
    (128, 300, 64, torch.bfloat16, False),
])
def test_k5_matches_plain_on_card(cuda_device, BH, C, D, dtype, random_state):
    rng = np.random.default_rng(BH * C + D)
    r, k, v, w, u, s0 = _wkv_inputs(rng, BH, C, D, dtype, cuda_device,
                                    random_state)
    before = krwkv.launches
    y, s1 = krwkv.wkv_chunk(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert krwkv.launches == before + 1
    assert y.dtype == dtype and s1.dtype == torch.float32
    y_want, s_want = krwkv.wkv_ref(r, k, v, w, u, s0)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-4)
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(s1, s_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_at_the_decay_clamp_on_card(cuda_device, dtype):
    """Decays at the model's clamp (1e-5), every tenth one at 1: y and the
    state stay finite and match the plain version at the same limits."""
    rng = np.random.default_rng(11)
    r, k, v, w, u, s0 = _wkv_inputs(rng, 4, 300, 64, dtype, cuda_device,
                                    True)
    w = torch.full_like(w, 1e-5)
    w[:, ::10] = 1.0
    y, s1 = krwkv.wkv_chunk(r, k, v, w, u, s0)
    y_want, s_want = krwkv.wkv_ref(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s1).all()
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-4)
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol[0],
                               atol=tol[1])
    torch.testing.assert_close(s1, s_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("BH,C,D", [(32, 1000, 64), (128, 1, 64),
                                    (3, 37, 128)])
def test_k5_bitwise_repeatable_on_card(cuda_device, BH, C, D):
    """No atomics: two launches on the same inputs agree bit for bit."""
    rng = np.random.default_rng(C)
    args = _wkv_inputs(rng, BH, C, D, torch.bfloat16, cuda_device, True)
    y1, s1 = krwkv.wkv_chunk(*args)
    y2, s2 = krwkv.wkv_chunk(*args)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("BH,splits", [(32, (15, 1, 1)), (32, (32, 8)),
                                       (128, (15, 1, 1)), (128, (16, 1))])
def test_k5_split_into_launches_is_bitwise_on_card(cuda_device, BH, splits):
    """A sequence cut into launches (a prefill, then decode steps), the
    state handed from one to the next, gives the bits of one launch over
    the whole sequence, at both of D = 64's launch shapes."""
    rng = np.random.default_rng(BH + len(splits))
    r, k, v, w, u, s0 = _wkv_inputs(rng, BH, sum(splits), 64, torch.bfloat16,
                                    cuda_device, True)
    y_all, s_all = krwkv.wkv_chunk(r, k, v, w, u, s0)
    ys, s, t = [], s0, 0
    for c in splits:
        y, s = krwkv.wkv_chunk(r[:, t:t + c], k[:, t:t + c], v[:, t:t + c],
                               w[:, t:t + c], u, s)
        ys.append(y)
        t += c
    assert torch.equal(torch.cat(ys, 1), y_all) and torch.equal(s, s_all)


def test_k5_takes_unaligned_views_on_card(cuda_device):
    """Contiguous views that start off a 16-byte boundary (the kernel reads
    16 bytes at a time) give the result of aligned copies."""
    rng = np.random.default_rng(5)
    r, k, v, w, u, s0 = _wkv_inputs(rng, 2, 65, 32, torch.bfloat16,
                                    cuda_device, True)
    flat = [torch.cat([t.new_zeros(1), t.flatten()]) for t in (r, k, v, w)]
    views = [f[1:].view(t.shape) for f, t in zip(flat, (r, k, v, w))]
    assert all(t.data_ptr() % 16 for t in views)
    y, s1 = krwkv.wkv_chunk(*views, u, s0)
    y_want, s_want = krwkv.wkv_chunk(r, k, v, w, u, s0)
    assert torch.equal(y, y_want) and torch.equal(s1, s_want)


def test_k5_chunk_invariance_on_card(cuda_device):
    rng = np.random.default_rng(3)
    r, k, v = (_normal(rng, (2, 128, 32), torch.float32, cuda_device, 0.3)
               for _ in "rkv")
    w = torch.as_tensor(rng.uniform(0.9, 0.999, (2, 128, 32)).astype(
        np.float32), device=cuda_device)
    u = _normal(rng, (2, 32), torch.float32, cuda_device, 0.1)
    s0 = _normal(rng, (2, 32, 32), torch.float32, cuda_device, 0.1)
    y32, s32 = krwkv.rwkv6_wkv(r, k, v, w, u, s0, chunk=32)
    y128, s128 = krwkv.rwkv6_wkv(r, k, v, w, u, s0, chunk=128)
    assert torch.equal(y32, y128) and torch.equal(s32, s128)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b", "gemma3-12b",
                                  "dbrx-132b"])
def test_lm_on_card_matches_cpu_and_serves(cuda_device, arch):
    """The smoke model in float32 on the card (through K4 / K5) against the
    same weights on the CPU (through the plain versions), at rtol/atol 1e-4
    of the logits; then the engine serves one request on the card, and each
    token it emits is the argmax of a full forward over the sequence so
    far, up to 1e-3 of the logits: decode reads keys and values from the
    bfloat16 cache, the forward does not."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import map_tree
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = _on_card(replace(get_config(arch, smoke=True), dtype="float32"))
    params = build_model(cfg, seed=0, device="cpu").params
    card = build_model(cfg, map_tree(lambda t: t.float().to(cuda_device),
                                     params))
    cpu = build_model(cfg, map_tree(lambda t: t.float(), params))
    toks = torch.as_tensor(np.random.default_rng(0).integers(1, 200, (2, 64)))
    counter = krwkv if cfg.family == "ssm" else kattn
    before = counter.launches
    lg_card = card.logits(card(toks.to(cuda_device)))
    torch.cuda.synchronize()
    assert counter.launches == before + cfg.n_layers
    torch.testing.assert_close(lg_card.cpu(), cpu.logits(cpu(toks)),
                               rtol=1e-4, atol=1e-4)

    prompt = [3, 17, 91, 45]
    eng = ServeEngine(card, B=1, S_max=32)
    eng.submit(Request(rid=0, prompt=prompt, max_new=5))
    out = eng.run(max_steps=10)[0].out
    seq = list(prompt)
    for t in out:
        h = card(torch.as_tensor([seq], device=cuda_device))
        lg = card.logits(h[:, -1:])[0, -1]
        assert float(lg.max() - lg[t]) <= 1e-3, (seq, t, int(lg.argmax()))
        seq.append(t)


def test_rwkv6_served_alone_matches_forward_bitwise_on_card(cuda_device):
    """rwkv6-1.6b at full width (random bfloat16 weights, seed 0): two
    requests of chip_smoke.py's draw, each served alone (prefill, then
    decode through K5 at C = 1), give exactly the logits of a forward over
    the sequence so far.  K5 is bitwise the same however a sequence is cut
    into launches, and `rms_norm` normalises each row on its own, so the
    two paths may not differ at all."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("rwkv6-1.6b")
    model = build_model(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, int(rng.integers(
        4, 16)))] for _ in range(6)]

    class Tape:
        def __init__(self):
            self.device, self.logits = model.device, []

        def prefill(self, *args, **kw):
            cache, lg = model.prefill(*args, **kw)
            self.logits.append(lg[:, -1])
            return cache, lg

        def decode_step(self, *args):
            lg, cache = model.decode_step(*args)
            self.logits.append(lg[:, -1])
            return lg, cache

    for prompt in (prompts[0], prompts[5]):
        tape = Tape()                   # records calls: the eager step
        eng = ServeEngine(tape, B=1, S_max=32, graph=False)
        eng.submit(Request(rid=0, prompt=list(prompt), max_new=6))
        out = eng.run(max_steps=16)[0].out
        seq = list(prompt)
        for t, lg_e in zip(out, tape.logits):
            h = model(torch.as_tensor([seq], device=cuda_device))
            assert torch.equal(lg_e[0], model.logits(h[:, -1:])[0, -1]), seq
            seq.append(t)


# ------------------------------------------------- compiled serving (graphs) --
@pytest.mark.parametrize("stream", [False, True])
def test_fused_evaluate_on_card_replays_and_matches_eager(cuda_device,
                                                          stream):
    """At N = 20,000 the compiled session (the card's default) captures one
    CUDA graph per entry and serves each warm evaluate and within-slack
    step as one replay that runs K1 (gathered) or K2 (stream), with the
    kernels' counters advanced by the launches the capture recorded.  Its
    potentials agree with the per-phase session's at rtol 1e-6 / atol 2e-5
    plus 1e-7 of sum_j |q_j| / r_ij: both run the same kernels, but
    `index_add_`'s float32 atomics add in an order that changes from run
    to run, and that rounding scales with the sum of absolute terms."""
    from repro_torch.core.api import FMMSession
    from repro_torch.core.engine import ExecutableCache
    n = 20000
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)
    spec = PartitionSpec(nparts=8)
    geo = plan_geometry(x, q, spec, device="cpu")
    phi_abs = FMMSession(plan_geometry(x, np.abs(q), spec, device="cpu"),
                         device="cpu").evaluate()
    cache = ExecutableCache()
    graphed = FMMSession(geo, device=cuda_device, p2p_stream=stream,
                         exe_cache=cache)
    eager = FMMSession(geo, device=cuda_device, p2p_stream=stream,
                       fused=False)
    assert graphed.engine.fused and not eager.engine.fused

    def close(a, b):
        tol = 2e-5 + 1e-6 * np.abs(b) + 1e-7 * phi_abs
        assert np.all(np.abs(a - b) <= tol), float(np.abs(a - b).max())

    close(graphed.evaluate(), eager.evaluate())
    entry = graphed.engine._entries["evaluate"]
    assert entry.call.graph is not None and cache.misses == 1
    counter, name = (kstream, "K2") if stream else (kp2p, "K1")
    per_replay = entry.launches[name]
    assert per_replay == (1 if stream else
                          len(graphed.engine.tables.p2p_buckets))
    before, calls = counter.launches, entry.calls
    phi = graphed.evaluate()
    torch.cuda.synchronize()
    assert counter.launches == before + per_replay
    assert entry.calls == calls + 1
    close(phi, eager.evaluate())

    eps = float(geo.slack.min())
    x1 = x + np.random.default_rng(2).uniform(-eps / 4, eps / 4, x.shape)
    rg, re_ = graphed.step(x1), eager.step(x1)
    assert rg.rebuilt == re_.rebuilt == () and rg.refreshed == re_.refreshed
    assert graphed.engine._entries["step"].calls == 1
    absum = FMMSession(plan_geometry(x1, np.abs(q), spec, device="cpu"),
                       device="cpu").evaluate()
    phi_g, phi_e = graphed.evaluate(), eager.evaluate()
    tol = 2e-5 + 1e-6 * np.abs(phi_e) + 1e-7 * absum
    assert np.all(np.abs(phi_g - phi_e) <= tol)


def _on_card(cfg):
    """A smoke config whose head size K4 is not built for (gemma3's and
    dbrx's 16) with head size 32, its smallest."""
    from dataclasses import replace
    return cfg if cfg.family == "ssm" or cfg.hd in kattn.HEAD_DIMS else \
        replace(cfg, head_dim=32)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_lm_families_on_card_match_cpu(cuda_device, arch):
    """The hybrid, encoder-decoder and vlm smoke models in float32 at head
    dim 32 on the card (every attention over a sequence through K4: hymba's
    windowed and global layers, the encoder, self- and cross-attention)
    against the same weights on the CPU: the forward's logits, with K4
    launched once an attention sublayer, then a prefill of 60 tokens and
    three decode steps, at rtol/atol 1e-4 of the logits.  hymba's SSM
    conv taps, A_log and D skip are drawn from N(0, 0.3) (the init zeroes
    the taps, so the decode's conv tail would multiply by zero)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import map_tree
    cfg = _on_card(replace(get_config(arch, smoke=True), dtype="float32"))
    params = build_model(cfg, seed=0, device="cpu").params
    rng = np.random.default_rng(0)
    if cfg.family == "hybrid":
        for pb in params["blocks"]:
            for leaf in ("conv_w", "A_log", "D_skip"):
                t = pb["ssm0"][leaf]
                t.copy_(torch.as_tensor(rng.normal(0, 0.3, tuple(t.shape))))
    card = build_model(cfg, map_tree(lambda t: t.float().to(cuda_device),
                                     params))
    cpu = build_model(cfg, map_tree(lambda t: t.float(), params))
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 64)))
    emb = {}
    if cfg.is_encdec:
        emb["frames"] = torch.as_tensor(
            rng.normal(0, 0.1, (2, 64, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        emb["vis"] = torch.as_tensor(rng.normal(
            0, 0.1, (2, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32))

    def on(dev, n=64):
        return {k: (v[:, :n] if k == "frames" else v).to(dev)
                for k, v in emb.items()}

    before = kattn.launches
    lg_card = card.logits(card(toks.to(cuda_device), **on(cuda_device)))
    torch.cuda.synchronize()
    assert kattn.launches - before == cfg.n_enc_layers + cfg.n_layers * (
        2 if cfg.is_encdec else 1)
    torch.testing.assert_close(lg_card.cpu(),
                               cpu.logits(cpu(toks, **on("cpu"))),
                               rtol=1e-4, atol=1e-4)
    cache_c, lg_c = card.prefill(toks[:, :60].to(cuda_device), 64,
                                 **on(cuda_device, 60))
    cache_h, lg_h = cpu.prefill(toks[:, :60], 64, **on("cpu", 60))
    torch.testing.assert_close(lg_c.cpu(), lg_h, rtol=1e-4, atol=1e-4)
    for pos in range(60, 63):
        nxt = toks[:, pos:pos + 1]
        lg_c, cache_c = card.decode_step(cache_c, nxt.to(cuda_device), pos)
        lg_h, cache_h = cpu.decode_step(cache_h, nxt, pos)
        torch.testing.assert_close(lg_c.cpu(), lg_h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b", "gemma3-12b",
                                  "dbrx-132b", "hymba-1.5b"])
def test_serve_engine_graph_matches_eager_on_card(cuda_device, arch):
    """A tiny model (the smoke config, bfloat16) served on the card with the
    decode step as one CUDA graph replay gives the same tokens as the eager
    step for every request; rwkv6's replay runs K5 once a layer and no
    replay runs K4 (decode attention is plain PyTorch).  gemma3's replay
    writes its ring caches at a position read on the device (decoded past
    its window of 16), dbrx's routes through its MoE sublayers, hymba's
    writes its SSM state and conv tail in place."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = _on_card(get_config(arch, smoke=True))
    model = build_model(cfg, seed=0, device=cuda_device)
    outs = []
    for graph in (False, None):
        rng = np.random.default_rng(0)
        eng = ServeEngine(model, B=4, S_max=64, graph=graph)
        for rid in range(8):
            eng.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
                1, cfg.vocab, int(rng.integers(4, 16)))], max_new=8))
        outs.append({r.rid: r.out for r in eng.run(max_steps=64)})
    assert eng.graph and eng.decode_call.graph is not None
    assert sorted(outs[1]) == list(range(8)) and outs[0] == outs[1]
    launches = eng.decode_call.launches
    assert "K4" not in launches
    if cfg.family == "ssm":
        assert launches == {"K5": cfg.n_layers}


def test_capture_holds_the_garbage_collector_off_on_card(cuda_device):
    """A dead object that owns a CUDA graph and is only reachable through a
    reference cycle (an engine and its captured call's closure), freed by
    Python's collector in the middle of another capture, resets its graph,
    which a capturing stream does not permit: the capture fails (seen on
    the card when the qwen3 then rwkv6 cases of
    `test_lm_on_card_matches_cpu_and_serves` ran back to back).
    `CapturedCall` therefore holds the automatic collector off while it
    captures, and only then: the two warm-up calls see it on, the captured
    call off, and it is on again afterwards."""
    import gc

    from repro_torch.graphs import CapturedCall
    x = torch.arange(8.0, device=cuda_device)
    seen = []

    def fn():
        seen.append(gc.isenabled())
        return (x * 2,)

    assert gc.isenabled()
    call = CapturedCall(fn, cuda_device)
    assert seen == [True, True, False] and gc.isenabled()
    out, = call.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2)


# ------------------------------------------------ multi-rank exchange --------
@pytest.mark.parametrize("protocol", ["bulk", "grain", "hsdx"])
def test_stacked_dist_engine_on_card_matches_engine(cuda_device, protocol):
    """At N = 20,000 in 8 parts, 4 ranks stacked on the card: each rank's
    P2P buckets launch K1 (one launch a bucket a rank), every span arrives
    word for word, and the potential agrees with the card's per-phase
    engine at rtol 1e-6 / atol 2e-5 plus 1e-7 of sum_j |q_j| / r_ij (both
    use float32 `index_add_` atomics, whose order changes from run to
    run); a within-slack step of a mesh session keeps the same agreement."""
    from repro_torch.core.api import FMMSession
    from repro_torch.launch.mesh import stacked_mesh
    n = 20000
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)
    spec = PartitionSpec(nparts=8)
    geo = plan_geometry(x, q, spec, device="cpu")
    phi_abs = FMMSession(plan_geometry(x, np.abs(q), spec, device="cpu"),
                         device="cpu").evaluate()
    eager = FMMSession(geo, device=cuda_device, fused=False)
    sess = FMMSession(geo, device=cuda_device,
                      mesh=stacked_mesh(4, cuda_device),
                      dist_protocol=protocol)

    def close(a, b, absum):
        tol = 2e-5 + 1e-6 * np.abs(b) + 1e-7 * absum
        assert np.all(np.abs(a - b) <= tol), float(np.abs(a - b).max())

    before = kp2p.launches
    phi = sess.evaluate()
    torch.cuda.synchronize()
    assert kp2p.launches - before == 4 * len(sess.dist.p2p_buckets) > 0
    assert sess.dist.verify_exchange(protocol) == len(sess.dist.layout.pairs)
    close(phi, eager.evaluate(), phi_abs)

    eps = float(geo.slack.min())
    x1 = x + np.random.default_rng(2).uniform(-eps / 4, eps / 4, x.shape)
    rs, re_ = sess.step(x1), eager.step(x1)
    assert rs.rebuilt == re_.rebuilt == () and rs.refreshed == re_.refreshed
    absum = FMMSession(plan_geometry(x1, np.abs(q), spec, device="cpu"),
                       device="cpu").evaluate()
    close(sess.evaluate(), eager.evaluate(), absum)


# ------------------------------------------- observability and resilience --
def _card_case(n=20000):
    """Phase 8's N = 20,000 case: geometry planned on the CPU, and sum_j
    |q_j| / r_ij for the agreement gate."""
    from repro_torch.core.api import FMMSession
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)
    spec = PartitionSpec(nparts=8)
    geo = plan_geometry(x, q, spec, device="cpu")
    phi_abs = FMMSession(plan_geometry(x, np.abs(q), spec, device="cpu"),
                         device="cpu").evaluate()
    return geo, phi_abs


def _close_to(a, b, phi_abs):
    tol = 2e-5 + 1e-6 * np.abs(b) + 1e-7 * phi_abs
    assert np.all(np.abs(a - b) <= tol), float(np.abs(a - b).max())


def test_fault_in_capture_then_next_rung_on_card(cuda_device, monkeypatch):
    """A fault raised inside a CUDA graph capture (`kernels.p2p.launch`,
    armed once the capture has begun, past the warm-up) ends the capture,
    caches nothing and leaves the card usable: the resilient session serves
    the evaluate on the next rung (per_phase, K1 launched eagerly), and a
    new session then captures the same shape class and replays it."""
    from repro_torch.core.api import FMMSession
    from repro_torch.core.engine import ExecutableCache
    from repro_torch.resilience import fallback as res_fb
    from repro_torch.resilience import faults as res_faults
    geo, phi_abs = _card_case()
    want = FMMSession(geo, device=cuda_device, fused=False).evaluate()
    real = torch.cuda.graph
    armed = []

    class ArmingGraph:
        def __init__(self, *a, **kw):
            self.cm = real(*a, **kw)

        def __enter__(self):
            self.cm.__enter__()
            res_faults.arm(res_faults.FaultPlan({"kernels.p2p.launch": {}}))
            armed.append(1)
            return self

        def __exit__(self, *exc):
            return self.cm.__exit__(*exc)

    res_fb.reset_ledger()
    cache = ExecutableCache()
    sess = FMMSession(geo, device=cuda_device, exe_cache=cache,
                      resilience=True)
    monkeypatch.setattr(torch.cuda, "graph", ArmingGraph)
    try:
        before = kp2p.launches
        phi = sess.evaluate()
        torch.cuda.synchronize()
    finally:
        res_faults.disarm()
        monkeypatch.setattr(torch.cuda, "graph", real)
    assert armed == [1] and len(cache) == 0
    assert [(f["site"], f["from"], f["to"]) for f in
            sess.resilience.fallbacks] == \
        [("kernels.p2p.launch", "gathered", "per_phase")]
    assert sess.resilience.rung == "per_phase" and kp2p.launches > before
    _close_to(phi, want, phi_abs)
    _close_to(sess.evaluate(), want, phi_abs)       # the next rung again
    again = FMMSession(geo, device=cuda_device, exe_cache=cache)
    again.evaluate()
    entry = again.engine._entries["evaluate"]
    assert entry.call.graph is not None and cache.misses == 2
    before, per = kp2p.launches, entry.launches["K1"]
    _close_to(again.evaluate(), want, phi_abs)
    torch.cuda.synchronize()
    assert kp2p.launches - before == per > 0
    res_fb.reset_ledger()
    res_faults.reset_stats()


@pytest.mark.parametrize("fences", [False, True])
def test_traced_warm_evaluate_is_one_replay_on_card(cuda_device, fences):
    """With tracing on (and with fences), a warm graphed evaluate is still
    one replay: spans and counters sit outside the captured call, and a
    fence never runs inside a capture; `report()` records the captured
    entry, its calls and the K1 launches a replay makes."""
    from repro_torch import obs
    from repro_torch.core.api import FMMSession
    from repro_torch.core.engine import ExecutableCache
    geo, phi_abs = _card_case()
    want = FMMSession(geo, device=cuda_device, fused=False).evaluate()
    obs.configure(enabled=True, fences=fences)
    try:
        sess = FMMSession(geo, device=cuda_device,
                          exe_cache=ExecutableCache())
        sess.evaluate()
        entry = sess.engine._entries["evaluate"]
        before, calls = kp2p.launches, entry.calls
        phi = sess.evaluate()
        torch.cuda.synchronize()
        per = entry.launches["K1"]
        assert entry.call.graph is not None and entry.calls == calls + 1
        assert kp2p.launches - before == per > 0
        rep = sess.report()
        la = rep["launches"]["evaluate"]
        assert la["captured"] and la["entry_computations"] == 1
        assert la["calls"] == 2 and la["kernel_launches"] == {"K1": per}
        counters = rep["metrics"]["counters"]
        assert counters["engine.fused_launches"] == 2
        assert counters["exe_cache.misses"] == 1
        assert rep["timings"]["engine.fused_evaluate"]["count"] == 2
        assert rep["obs"]["fences"] is fences
    finally:
        obs.configure(enabled=False)
        obs.reset()
    _close_to(phi, want, phi_abs)


# ------------------------------------------------------------- training ---
# K4's and K5's autograd Functions (the kernel forward, the PyTorch
# backward) against autograd through their plain versions on the same card
# inputs: float32 at 1e-4 of the largest |gradient| (K4's float32 forward
# against `attention_rounded_ref` at 2e-4, sums in another order);
# bfloat16 per tensor in relative L2 at chip_smoke.py's GRAD_REL_L2 (K4:
# the q, k gradients are rounded to bfloat16 once where autograd rounds
# them after each cast, and K4's bfloat16 output enters rowsum(dO O),
# 3.3e-3 to 4.0e-3 measured; K5: its gradients rounded to bfloat16 once,
# 3.0e-5 measured)
GRAD_BF16_REL_L2 = {"K4": 1e-2, "K5": 1e-4}


def _grads(fn, inputs, out_grads):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, out_grads)


def _hold_grads(got, want, dtype, kernel):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()))
        else:
            assert float((g - w).norm() / w.norm()) <= \
                GRAD_BF16_REL_L2[kernel]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", ["causal", "window", "unmasked"])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_k4_autograd_matches_plain_on_card(cuda_device, D, mask, dtype):
    rng = np.random.default_rng(D)
    B, H, Hkv, Sq = 2, 4, 2, 200
    Sk = 333 if mask == "unmasked" else Sq
    causal, window = mask != "unmasked", 64 if mask == "window" else None
    q = _normal(rng, (B, H, Sq, D), dtype, cuda_device)
    k, v = (_normal(rng, (B, Hkv, Sk, D), dtype, cuda_device)
            for _ in range(2))
    do = _normal(rng, (B, H, Sq, D), dtype, cuda_device)
    launches, calls = kattn.launches, kattn.backward_calls
    got = _grads(lambda *t: kattn.flash_attention(*t, causal=causal,
                                                  window=window),
                 (q, k, v), do)
    torch.cuda.synchronize()
    assert kattn.launches == launches + 1
    assert kattn.backward_calls == calls + 1
    want = _grads(lambda *t: kattn.attention_rounded_ref(
        *t, causal=causal, window=window), (q, k, v), do)
    _hold_grads(got, want, dtype, "K4")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_k5_autograd_matches_plain_on_card(cuda_device, D, dtype):
    rng = np.random.default_rng(D)
    r, k, v, w, u, s0 = _wkv_inputs(rng, 6, 100, D, dtype, cuda_device,
                                    random_state=True)
    dy = _normal(rng, (6, 100, D), dtype, cuda_device)
    ds = _normal(rng, (6, D, D), torch.float32, cuda_device)
    launches, calls = krwkv.launches, krwkv.backward_calls
    got = _grads(krwkv.wkv_chunk, (r, k, v, w, u, s0), (dy, ds))
    torch.cuda.synchronize()
    assert krwkv.launches == launches + 1
    assert krwkv.backward_calls == calls + 1
    want = _grads(krwkv.wkv_ref, (r, k, v, w, u, s0), (dy, ds))
    _hold_grads(got, want, dtype, "K5")


def test_forward_without_grad_builds_no_graph_on_card(cuda_device):
    """Serving is untouched: under no_grad, and with grad on over a served
    (frozen) model, the forward launches K4 once a layer and builds no
    autograd graph; with trainable weights the Function runs and its
    backward reaches the weights in front of K4."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_weights
    from repro_torch.models import transformer as ttf
    cfg = get_config("qwen3-0.6b", smoke=True)
    model = build_model(cfg, seed=0, device=cuda_device)
    tokens = torch.randint(1, cfg.vocab, (2, 64), device=cuda_device)
    for grad in (False, True):
        launches, calls = kattn.launches, kattn.backward_calls
        with torch.set_grad_enabled(grad):
            h = model(tokens)
        torch.cuda.synchronize()
        assert kattn.launches == launches + cfg.n_layers
        assert h.grad_fn is None and not h.requires_grad
        assert kattn.backward_calls == calls
    params = init_weights(cfg, seed=0, device=cuda_device, trainable=True)
    launches, calls = kattn.launches, kattn.backward_calls
    loss, _ = ttf.loss_fn(params, {"tokens": tokens, "labels": tokens}, cfg)
    loss.backward()
    assert kattn.launches == launches + cfg.n_layers
    assert kattn.backward_calls == calls + cfg.n_layers
    for pb in params["blocks"]:
        assert float(pb["attn0"]["wq"].grad.abs().max()) > 0
    served = build_model(cfg, params)
    assert not any(p.requires_grad for p in served.parameters())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One float32 train step of the smoke model from one init, on the card
    (K4 or K5 forward, their PyTorch backwards) and on the CPU (autograd
    through the plain versions): loss and grad norm at rtol 1e-4, every
    leaf's gradient within 1e-3 of its largest |g| (tests/test_torch_
    train.py's limit against the reference), and the new master weights
    at rtol 1e-4.  Adam's first step moves a weight by lr g / (|g| + eps),
    nearly lr sign(g), so a weight whose (clipped) gradient lies within
    the two devices' float32 rounding of zero (under 1e-4 of its leaf's
    largest, or 100 eps) may step otherwise: those are held to 2 lr, the
    step's bound.  The optimizer alone, fed the CPU's gradients on both
    devices, gives the same masters at rtol 1e-5."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_weights
    from repro_torch.models.params import (map_tree, tree_leaves,
                                           tree_unflatten)
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.train.train_step import make_train_step, value_and_grad
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    init = init_weights(cfg, seed=3, device="cpu")
    batch = SyntheticLM(cfg.vocab, 64, 4, seed=3).next_batch()
    out = {}
    for dev in ("cpu", cuda_device):
        params = map_tree(lambda t: t.to(dev).requires_grad_(), init)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        _, _, grads = value_and_grad(params, b, cfg)
        launches = (kattn.launches, krwkv.launches)
        p, opt, m = make_train_step(cfg, opt_cfg)(params, init_opt_state(
            params), b)
        if dev != "cpu":
            n = (kattn.launches - launches[0], krwkv.launches - launches[1])
            assert n == ((0, cfg.n_layers) if cfg.family == "ssm" else
                         (cfg.n_layers, 0))
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         [t.cpu() for t in tree_leaves(grads)],
                         [t.cpu() for t in tree_leaves(opt.master)],
                         [t.cpu() for t in tree_leaves(opt.m)])
    (l_c, n_c, g_c, ma_c, m_c), (l_d, n_d, g_d, ma_d, _) = (
        out["cpu"], out[str(cuda_device)])
    np.testing.assert_allclose(l_d, l_c, rtol=1e-4)
    np.testing.assert_allclose(n_d, n_c, rtol=1e-4)
    for a, b in zip(g_d, g_c):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-3 * float(b.abs().max()))
    for a, b, mm in zip(ma_d, ma_c, m_c):
        g = mm.abs() / (1 - opt_cfg.b1)                 # the clipped g
        tiny = (g > 0) & ((g <= 1e-4 * g.max()) | (g <= 100 * opt_cfg.eps))
        torch.testing.assert_close(a[~tiny], b[~tiny], rtol=1e-4, atol=1e-7)
        assert bool(((a - b).abs()[tiny] <= 2 * opt_cfg.lr).all())
    # the optimizer alone on the same gradients
    masters = []
    for dev in ("cpu", cuda_device):
        grads = tree_unflatten(init, [t.to(dev) for t in g_c])
        opt = init_opt_state(map_tree(lambda t: t.to(dev), init))
        _, opt, _ = adamw_update(grads, opt, opt_cfg,
                                 param_dtype=torch.float32)
        masters.append([t.cpu() for t in tree_leaves(opt.master)])
    for a, b in zip(*masters):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def _stacked_par(device, seq=False):
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.sharding.parallel import Parallelism
    mesh = make_mesh_compat((2, 2), ("data", "model"), device)
    return Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                       moe_seq_shard=seq, remat=False)


@pytest.mark.parametrize("seq", [False, True])
def test_expert_parallel_moe_on_card_matches_cpu(cuda_device, seq):
    """dbrx-smoke's MoE layer (float32) expert-parallel on a (data 2, model
    2) mesh stacked on the card against the same mesh stacked on the CPU:
    the same routes and drops (a capacity factor of 0.5 drops slots),
    outputs, aux and the gradient of x within 1e-5 of their largest
    values (float32 products in another order)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    for cf in (4.0, 0.5):
        cfg = replace(get_config("dbrx-132b", smoke=True), dtype="float32",
                      capacity_factor=cf)
        p = {k: v.float() for k, v in init_params(
            moe.moe_defs(cfg), torch.Generator().manual_seed(0)).items()}
        x = torch.randn(4, 16, cfg.d_model,
                        generator=torch.Generator().manual_seed(1)) * 0.3
        out = {}
        for dev in ("cpu", cuda_device):
            xx = x.to(dev).detach().requires_grad_()
            with moe.routing_log() as log:
                y, aux = moe.moe_ffn(xx, {k: v.to(dev) for k, v in p.items()},
                                     cfg, _stacked_par(dev, seq))
            ((y ** 2).sum() + aux).backward()
            out[str(dev)] = (y.detach().cpu(), float(aux), xx.grad.cpu(),
                             [(e.cpu(), k.cpu()) for e, k, _ in log])
        (y_c, a_c, g_c, l_c), (y_d, a_d, g_d, l_d) = out.values()
        assert len(l_c) == len(l_d) == 4
        for (e1, k1), (e2, k2) in zip(l_c, l_d):
            assert torch.equal(e1, e2) and torch.equal(k1, k2)
        assert (cf == 0.5) == any(bool((~k).any()) for _, k in l_c)
        torch.testing.assert_close(y_d, y_c, rtol=0,
                                   atol=1e-5 * float(y_c.abs().max()))
        np.testing.assert_allclose(a_d, a_c, rtol=1e-5)
        torch.testing.assert_close(g_d, g_c, rtol=0,
                                   atol=1e-5 * float(g_c.abs().max()))


def test_graphed_decode_under_a_stacked_mesh_on_card(cuda_device):
    """dbrx-smoke (bfloat16) served on a (data 2, model 2) mesh stacked on
    the card: the decode step captured as one graph gives the eager step's
    tokens for every request."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = _on_card(get_config("dbrx-132b", smoke=True))
    model = build_model(cfg, seed=0, device=cuda_device)
    par = _stacked_par(cuda_device)
    outs = []
    for graph in (False, None):
        rng = np.random.default_rng(0)
        eng = ServeEngine(model, B=4, S_max=64, graph=graph, par=par)
        for rid in range(8):
            eng.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
                1, cfg.vocab, int(rng.integers(4, 16)))], max_new=8))
        outs.append({r.rid: r.out for r in eng.run(max_steps=64)})
    assert eng.graph and eng.decode_call.graph is not None
    assert sorted(outs[1]) == list(range(8)) and outs[0] == outs[1]
    assert "K4" not in eng.decode_call.launches
