"""The contract between the port's P2P kernels and their callers, on the CPU.

K2 on the card writes exactly 0.0 in every lane at or past a tile's
tgt_len, where its plain version (and the reference) computes the slab's
sum; the engine must not read those lanes.  Here the port's `p2p_stream`
is replaced by the plain version with those lanes overwritten (by 0.0, as
the kernel writes them, or by NaN), and the streaming session must give the
same potential bit for bit.  Also the launch shapes the wrappers pass to
the kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine import p2p as engine_p2p
from repro_torch.kernels import p2p as kp2p
from repro_torch.kernels import p2p_stream as kstream


@pytest.fixture(scope="module")
def small_geometry():
    x = make_distribution("sphere", 2000, seed=3)
    q = np.random.default_rng(4).uniform(-1, 1, 2000)
    return plan_geometry(x, q, PartitionSpec(nparts=4, ncrit=32),
                         device="cpu")


@pytest.mark.parametrize("fill", [0.0, float("nan")])
def test_stream_caller_drops_lanes_past_tgt_len(monkeypatch, small_geometry,
                                                fill):
    want = FMMSession(small_geometry, device="cpu",
                      p2p_stream=True).evaluate()
    calls = []

    def lanes_past_tgt_len_overwritten(meta, payload, *, block_t, smax,
                                       warps=None):
        out = kstream.p2p_stream_gathered(meta, payload, block_t=block_t,
                                          smax=smax)
        lane = torch.arange(block_t)
        out[lane[None, :] >= meta[:, 3:4]] = fill
        calls.append(meta.shape[0])
        return out

    monkeypatch.setattr(engine_p2p, "p2p_stream",
                        lanes_past_tgt_len_overwritten)
    sess = FMMSession(small_geometry, device="cpu", p2p_stream=True)
    got = sess.evaluate()
    assert calls and sess.engine.stream_fallbacks == 0
    # the stream table really has such lanes: tiles short of block_t
    assert not sess.engine.stream_tables()["out_valid"].all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("launch_params,per_warp", [
    (kp2p.p2p_launch_params, kp2p.ROWS_PER_WARP),
    (kstream.stream_launch_params, kstream.TILES_PER_WARP)])
def test_launch_params_fill_the_card(launch_params, per_warp):
    """4 warps a block where the grid gives every SM two blocks (the main
    path's 0.26-2.1 million rows and tiles), halved for smaller grids."""
    assert launch_params(262144) == launch_params(2097152) == 4
    assert launch_params(per_warp * 4 * 264) == 4
    assert launch_params(per_warp * 4 * 263) == 2
    assert launch_params(1) == launch_params(0) == 1
    for n in (1, 100, 1000, 10**4, 10**5):
        w = launch_params(n)
        assert 1 <= w <= 4 and w & (w - 1) == 0
