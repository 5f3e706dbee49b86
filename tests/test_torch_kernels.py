"""The port's P2P kernels K1 (repro_torch.kernels.p2p) and K2
(repro_torch.kernels.p2p_stream).

On the CPU the wrappers run their plain versions; those are held against
the JAX reference's Pallas kernel in interpret mode and its jnp oracle
(K1), and against the reference's `p2p_stream_gathered` (K2 — the Pallas
streaming pin is red on this tree, so the XLA slab program is the oracle).
Tolerance rtol/atol 2e-5, as tests/test_kernels.py: float32 sums associated
differently by the two frameworks.

The CUDA kernels themselves are tested on the card in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fmm as jfmm
from repro.core.engine.p2p import p2p_stream_gathered as jax_stream_gathered
from repro.kernels import ref as jref
from repro.kernels.p2p import p2p_pallas
from repro_torch.core import fmm as tfmm
from repro_torch.core.api import PartitionSpec, plan_geometry
from repro_torch.core.distributions import make_distribution
from repro_torch.core.engine import build_engine_tables, stack_bodies
from repro_torch.core.engine.p2p import stream_payload
from repro_torch.core.engine.schedules import build_p2p_stream_tables
from repro_torch.kernels import p2p as kp2p
from repro_torch.kernels import p2p_stream as kstream

RTOL = ATOL = 2e-5


def _p2p_inputs(P, S, T, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (P, S)).astype(np.float32)
    xs = rng.uniform(-1, 1, (P, S, 3)).astype(np.float32)
    xt = rng.uniform(-1, 1, (P, T, 3)).astype(np.float32)
    return q, xs, xt


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


# ------------------------------------------------------------ K1 plain ----
@pytest.mark.parametrize("P,S,T", [(4, 64, 128), (3, 40, 200), (2, 8, 64)])
def test_p2p_plain_matches_pallas_interpret_and_ref(P, S, T):
    q, xs, xt = _p2p_inputs(P, S, T)
    got = kp2p.p2p(*_t(q, xs, xt)).numpy()
    pallas = np.asarray(p2p_pallas(jnp.asarray(q), jnp.asarray(xs),
                                   jnp.asarray(xt), interpret=True))
    oracle = np.asarray(jref.p2p_ref(jnp.asarray(q), jnp.asarray(xs),
                                     jnp.asarray(xt)))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def test_p2p_plain_self_pair_and_padded_sources():
    q, x, _ = _p2p_inputs(2, 48, 1, seed=1)
    got = kp2p.p2p_ref(*_t(q, x, x)).numpy()        # r == 0 diagonal adds 0
    want = np.asarray(jref.p2p_ref(jnp.asarray(q), jnp.asarray(x),
                                   jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    q, xs, xt = _p2p_inputs(2, 64, 32, seed=2)
    q[:, 40:] = 0.0                                  # padded sources
    got = kp2p.p2p_ref(*_t(q, xs, xt)).numpy()
    want = kp2p.p2p_ref(*_t(q[:, :40].copy(), xs[:, :40].copy(), xt)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_p2p_plain_chunking_covers_every_row(monkeypatch):
    """Chunks of 2 rows (7 rows: a ragged last chunk) give the one-chunk
    answer up to the batched product's reassociation."""
    q, xs, xt = _t(*_p2p_inputs(7, 16, 32, seed=3))
    whole = kp2p.p2p_ref(q, xs, xt)
    monkeypatch.setattr(kp2p, "_ELEMS_PER_CHUNK", 16 * 32 * 2)
    torch.testing.assert_close(kp2p.p2p_ref(q, xs, xt), whole, rtol=RTOL,
                               atol=ATOL)


def test_fmm_p2p_vals_matches_reference():
    """The masked plain values of `core.fmm._p2p_vals` against the
    reference's `repro.core.fmm._p2p_vals`."""
    q, xs, xt = _p2p_inputs(6, 16, 24, seed=4)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    got = tfmm._p2p_vals(*_t(xt, xs, q, mask)).numpy()
    want = np.asarray(jfmm._p2p_vals(jnp.asarray(xt), jnp.asarray(xs),
                                     jnp.asarray(q), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[mask == 0].any()


def test_p2p_wrapper_rejects_bad_inputs():
    q, xs, xt = _t(*_p2p_inputs(2, 8, 16))
    with pytest.raises(TypeError):
        kp2p.p2p(q.double(), xs, xt)
    with pytest.raises(ValueError):
        kp2p.p2p(q[:, :4], xs, xt)
    with pytest.raises(ValueError):
        kp2p.p2p(q, xs[..., :2], xt)


# ------------------------------------------------------------ K2 plain ----
@pytest.fixture(scope="module")
def stream_case():
    """Stream tables and payload of a small real geometry (port-built)."""
    n = 1200
    x = make_distribution("sphere", n, seed=7)
    q = np.random.default_rng(8).uniform(-1, 1, n)
    geo = plan_geometry(x, q, PartitionSpec(nparts=4, ncrit=32),
                        device="cpu")
    tables = build_engine_tables(geo)
    x_pad, q_pad = stack_bodies(geo.trees, tables.n_bodies_max)
    stream = build_p2p_stream_tables(tables.p2p_buckets, 128)
    assert stream is not None
    payload = stream_payload(torch.as_tensor(x_pad), torch.as_tensor(q_pad),
                             stream["pad"])
    return stream, payload


def test_stream_plain_matches_reference(stream_case):
    stream, payload = stream_case
    bt, smax = stream["block_t"], stream["smax"]
    meta = torch.as_tensor(stream["meta"])
    got = kstream.p2p_stream(meta, payload, block_t=bt, smax=smax).numpy()
    want = np.asarray(jax_stream_gathered(jnp.asarray(stream["meta"]),
                                          jnp.asarray(payload.numpy()),
                                          block_t=bt, smax=smax))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    dead = stream["meta"][:, 3] == 0
    assert not got[dead].any()                       # dead tiles are zeros


def test_stream_plain_is_k1_plain_on_slabs(stream_case):
    """K2's plain version is K1's plain version on the gathered slabs."""
    stream, payload = stream_case
    bt, smax = stream["block_t"], stream["smax"]
    meta = torch.as_tensor(stream["meta"])
    live = meta[meta[:, 3] > 0]
    q, xs, xt = kstream.stream_slabs(live, payload, block_t=bt, smax=smax)
    assert torch.equal(kp2p.p2p_ref(q, xs, xt),
                       kstream.p2p_stream_gathered(live, payload,
                                                   block_t=bt, smax=smax))


def test_stream_wrapper_rejects_bad_inputs(stream_case):
    stream, payload = stream_case
    meta = torch.as_tensor(stream["meta"])
    with pytest.raises(ValueError):
        kstream.p2p_stream(meta.long(), payload, block_t=128, smax=64)
    with pytest.raises(ValueError):
        kstream.p2p_stream(meta, payload[:3], block_t=128, smax=64)
