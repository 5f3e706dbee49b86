"""The port's LM kernels K4 (repro_torch.kernels.attention) and K5
(repro_torch.kernels.rwkv) on the CPU, where their wrappers run the plain
versions, held against the JAX reference's oracles.

K4's `attention_ref` against `repro.kernels.ref.attention_ref` on the shapes
of tests/test_kernels.py, at its tolerances (rtol/atol 2e-4; bfloat16
5e-2), and, in the model layout, against `repro.models.layers.
attention_full`; `attention_tiled_ref` (the kernel's tile order) against
the reference's oracle (float32 1e-5, bfloat16 5e-2) and against
`attention_rounded_ref` (float32 1e-5, bfloat16 at K4's limits).  K5's `wkv_ref` / `rwkv6_wkv` against `repro.kernels.ref.
wkv_ref` (1e-4), against the model's chunkwise `repro.models.rwkv6.
wkv_chunked` with `w` clipped as the port clips it, and for chunk
invariance (1e-5); K5's launch shapes (`wkv_launch_params`) cover every
(head, row, column) of the state exactly once.  The Pallas interpret paths are not the oracle: they are
red on this tree.  The CUDA kernels themselves are tested on the card in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import rwkv as krwkv
from repro_torch.models import layers as tlayers


def _both(a, dtype):
    """One numpy array as a JAX and a torch array of `dtype`."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------- K4 -------
@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (1, 4, 4, 128, 64),     # MHA
    (2, 4, 2, 256, 64),     # GQA group 2
    (1, 8, 2, 128, 128),    # GQA group 4
    (1, 2, 1, 200, 64),     # ragged seq
])
def test_attention_ref_matches_reference(B, H, Hkv, S, D):
    rng = np.random.default_rng(S + D)
    qj, qt = _both(rng.normal(size=(B, H, S, D)).astype(np.float32), "float32")
    kj, kt = _both(rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
                   "float32")
    vj, vt = _both(rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
                   "float32")
    got = kattn.flash_attention(qt, kt, vt, causal=True)
    assert torch.equal(got, kattn.attention_ref(qt, kt, vt, causal=True))
    want = jref.attention_ref(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [64, 128])
def test_attention_ref_sliding_window(window):
    rng = np.random.default_rng(window)
    arrs = [_both(rng.normal(size=(1, 2, 256, 64)).astype(np.float32),
                  "float32") for _ in range(3)]
    got = kattn.flash_attention(*(t for _, t in arrs), window=window)
    want = jref.attention_ref(*(j for j, _ in arrs), window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,H,Hkv,S,D,dtype,window", [
    (1, 4, 4, 128, 64, "float32", None),
    (2, 4, 2, 256, 64, "float32", None),
    (1, 8, 2, 128, 128, "float32", None),
    (1, 2, 1, 200, 64, "float32", None),
    (1, 2, 2, 256, 64, "float32", 64),
    (1, 2, 2, 128, 64, "bfloat16", None),
])
def test_attention_rounded_ref_matches_reference(B, H, Hkv, S, D, dtype,
                                                 window):
    """The plain version with the kernel's roundings (the one the card holds
    K4 to) against the reference's oracle, at its tolerances."""
    rng = np.random.default_rng(S + D + H)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.normal(size=(B, h, S, D)).astype(np.float32), dtype)
        for h in (H, Hkv, Hkv))
    got = kattn.attention_rounded_ref(qt, kt, vt, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jref.attention_ref(qj, kj, vj, window=window)
    tol = 2e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# `attention_tiled_ref`, the plain version in the kernel's 128-key tiles
# (64-key tiles at D = 256)
_TILED_CASES = [
    (1, 4, 4, 128, 64, None, True),     # MHA, one tile
    (2, 4, 2, 256, 64, None, True),     # GQA group 2, two tiles
    (1, 8, 2, 128, 128, None, True),    # GQA group 4
    (1, 2, 1, 200, 64, None, True),     # ragged S
    (1, 2, 2, 256, 64, 64, True),       # window
    (1, 2, 2, 300, 32, 100, True),      # window edge inside tiles, ragged
    (2, 4, 1, 100, 32, None, False),    # non-causal
    (2, 4, 2, 129, 128, None, True),    # B = 2, one key past a tile
    (1, 2, 1, 200, 256, None, True),    # D = 256: 64-key tiles, ragged
    (2, 2, 2, 150, 256, 70, True),      # D = 256, window edge inside tiles
]


def _tiled_inputs(B, H, Hkv, S, D, dtype):
    rng = np.random.default_rng(S + D + H)
    return [_both(rng.normal(size=(B, h, S, D)).astype(np.float32), dtype)
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,window,causal", _TILED_CASES)
def test_attention_tiled_ref_matches_reference(B, H, Hkv, S, D, window, causal,
                                               dtype):
    """Against the reference's oracle: float32 at 1e-5; bfloat16 at the
    reference's own bfloat16 tolerance for its flash kernel, 5e-2
    (tests/test_kernels.py).  The oracle rounds the scores to bfloat16,
    the kernel's roundings do not, so K4's tighter limits do not apply to
    this pair (measured on these cases: 7.3e-3 past K4's atol, 1.28e-2 per
    row); they hold against `attention_rounded_ref` below."""
    (qj, qt), (kj, kt), (vj, vt) = _tiled_inputs(B, H, Hkv, S, D, dtype)
    got = kattn.attention_tiled_ref(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jref.attention_ref(qj, kj, vj, causal=causal, window=window)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,window,causal", _TILED_CASES)
def test_attention_tiled_ref_matches_rounded_ref(B, H, Hkv, S, D, window,
                                                 causal, dtype):
    """Against the plain version with the same roundings but p rounded
    against the row's max: float32 at 1e-5; bfloat16 at K4's limits (atol
    4e-3 + rtol 1.6e-2, per-row relative L2 1e-2).  With one tile over all
    keys the two are the same arithmetic, bit for bit."""
    (_, qt), (_, kt), (_, vt) = _tiled_inputs(B, H, Hkv, S, D, dtype)
    got = kattn.attention_tiled_ref(qt, kt, vt, causal=causal, window=window)
    want = kattn.attention_rounded_ref(qt, kt, vt, causal=causal,
                                       window=window)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                                   atol=4e-3)
        rel = ((got.float() - want.float()).norm(dim=-1)
               / want.float().norm(dim=-1))
        assert float(rel.max()) <= 1e-2
    one = kattn.attention_tiled_ref(qt, kt, vt, causal=causal, window=window,
                                    block_k=S)
    assert torch.equal(one, want)


def test_attention_ref_bf16():
    rng = np.random.default_rng(7)
    arrs = [_both(rng.normal(size=(1, 2, 128, 64)).astype(np.float32),
                  "bfloat16") for _ in range(3)]
    got = kattn.flash_attention(*(t for _, t in arrs))
    want = jref.attention_ref(*(j for j, _ in arrs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("B,S,H,Hkv,hd", [(2, 64, 4, 2, 32),
                                          (1, 200, 16, 8, 128)])
def test_attention_flash_matches_model_attention_full(B, S, H, Hkv, hd):
    """The model-layout wrapper (B, S, H, hd) of K4's plain version against
    the reference model's self-attention."""
    rng = np.random.default_rng(B * S)
    qj, qt = _both(rng.normal(size=(B, S, H, hd)).astype(np.float32),
                   "float32")
    kj, kt = _both(rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
                   "float32")
    vj, vt = _both(rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
                   "float32")
    got = tlayers.attention_flash(qt, kt, vt, causal=True)
    want = jlayers.attention_full(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0)])
@pytest.mark.parametrize("mask", [dict(causal=False, kv_len=14),
                                  dict(causal=True, window=5)])
def test_attention_full_matches_reference(dtype, tol, mask):
    """The port's `attention_full` (a single query at position 13 against a
    padded cache, masked by `kv_len`, or causal with a window) against the
    reference's; in bfloat16 the scale is rounded to the input type as JAX
    rounds it, so the two agree exactly."""
    rng = np.random.default_rng(11)
    qj, qt = _both(rng.normal(size=(3, 1, 4, 32)).astype(np.float32), dtype)
    kj, kt = _both(rng.normal(size=(3, 24, 2, 32)).astype(np.float32), dtype)
    vj, vt = _both(rng.normal(size=(3, 24, 2, 32)).astype(np.float32), dtype)
    got = tlayers.attention_full(qt, kt, vt, q_offset=13, **mask)
    want = jlayers.attention_full(qj, kj, vj, q_offset=13, **mask)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 4, 16, 32)
    with pytest.raises(ValueError, match="multiple"):
        kattn.flash_attention(q, torch.zeros(1, 3, 16, 32),
                              torch.zeros(1, 3, 16, 32))
    with pytest.raises(ValueError, match="window"):
        kattn.flash_attention(q, q, q, window=0)
    with pytest.raises(TypeError):
        kattn.flash_attention(q.double(), q.double(), q.double())


# ---------------------------------------------------------------- K5 -------
def _wkv_inputs(BH, S, D, seed, w_lo=0.8, w_hi=0.999, state_scale=0.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (BH, S, D)).astype(np.float32)
    u = (rng.normal(size=(BH, D)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(BH, D, D)) * state_scale).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("BH,S,D,chunk", [(2, 128, 64, 64), (4, 64, 32, 32),
                                          (1, 256, 64, 128)])
def test_wkv_matches_reference(BH, S, D, chunk):
    arrs = _wkv_inputs(BH, S, D, S * D)
    y_want, s_want = jref.wkv_ref(*(jnp.asarray(a) for a in arrs))
    t = [torch.as_tensor(a) for a in arrs]
    for y, s in (krwkv.wkv_ref(*t), krwkv.rwkv6_wkv(*t, chunk=chunk)):
        np.testing.assert_allclose(_np(y), _np(y_want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(s), _np(s_want), rtol=1e-4, atol=1e-4)


def test_wkv_bf16_inputs_match_reference():
    """bfloat16 r/k/v, float32 w and state, as the model passes them: both
    compute in float32 and round y once to bfloat16."""
    r, k, v, w, u, s0 = _wkv_inputs(4, 32, 32, 5, state_scale=0.1)
    rj, rt = _both(r, "bfloat16")
    kj, kt = _both(k, "bfloat16")
    vj, vt = _both(v, "bfloat16")
    y_want, s_want = jref.wkv_ref(rj, kj, vj, jnp.asarray(w), jnp.asarray(u),
                                  jnp.asarray(s0))
    y, s = krwkv.rwkv6_wkv(rt, kt, vt, *(torch.as_tensor(a)
                                         for a in (w, u, s0)), chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_want), rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(_np(s), _np(s_want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,w_lo,clipped", [(16, 0.2, True),
                                             (64, 0.8, False),
                                             (128, 0.8, False)])
def test_rwkv6_wkv_matches_model_wkv_chunked(S, w_lo, clipped):
    """Against the reference model's chunkwise WKV (B, H, S, hd).  With
    `clipped`, some decays lie below 1e-5, which the reference clips inside
    `log(clip(w))` and the port clips before the kernel.  The chunkwise form
    scales keys by exp(-cumsum(log w)) over a chunk of min(64, S) tokens,
    which overflows float32 (NaN in the reference) once a channel's decay
    product over the chunk falls below e^-88 (ROADMAP.md, faults of the
    reference); the long cases keep decays in (0.8, 1), as the token loop
    tests above do."""
    B, H, hd = 2, 2, 32
    r, k, v, w, u, s0 = _wkv_inputs(B * H, S, hd, S, w_lo=w_lo, w_hi=1.0,
                                     state_scale=0.1)
    if clipped:
        w[:, ::5, ::3] = 1e-7
    u_h = u[:H]
    y_want, s_want = wkv_chunked(
        *(jnp.asarray(a.reshape(B, H, S, hd)) for a in (r, k, v, w)),
        jnp.asarray(u_h), jnp.asarray(s0.reshape(B, H, hd, hd)))
    y, s = krwkv.rwkv6_wkv(
        *(torch.as_tensor(a) for a in (r, k, v)),
        torch.as_tensor(w).clamp(1e-5, 1.0),
        torch.as_tensor(np.tile(u_h, (B, 1))), torch.as_tensor(s0),
        chunk=min(64, S))
    np.testing.assert_allclose(_np(y).reshape(B, H, S, hd), _np(y_want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s).reshape(B, H, hd, hd), _np(s_want),
                               rtol=1e-4, atol=1e-4)


def test_rwkv6_wkv_chunk_invariance():
    rng = np.random.default_rng(3)
    args = [torch.as_tensor(rng.normal(size=(2, 128, 32)).astype(np.float32)
                            * 0.3) for _ in range(3)]
    w = torch.as_tensor(rng.uniform(0.9, 0.999, (2, 128, 32)).astype(
        np.float32))
    u = torch.as_tensor((rng.normal(size=(2, 32)) * 0.1).astype(np.float32))
    s0 = torch.as_tensor((rng.normal(size=(2, 32, 32)) * 0.1).astype(
        np.float32))
    y32, s32 = krwkv.rwkv6_wkv(*args, w, u, s0, chunk=32)
    y128, s128 = krwkv.rwkv6_wkv(*args, w, u, s0, chunk=128)
    torch.testing.assert_close(y32, y128, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s32, s128, rtol=1e-5, atol=1e-5)


def test_rwkv6_wkv_rejects_ragged_chunks_and_bad_shapes():
    r, k, v, w, u, s0 = (torch.as_tensor(a) for a in _wkv_inputs(1, 48, 32,
                                                                  0))
    with pytest.raises(ValueError, match="multiple of chunk"):
        krwkv.rwkv6_wkv(r, k, v, w, u, s0, chunk=32)
    with pytest.raises(ValueError, match="state"):
        krwkv.wkv_chunk(r, k, v, w, u, s0[:, :16])


@pytest.mark.parametrize("BH", [1, 32, 128])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_wkv_launch_params_cover_the_state(D, BH):
    """K5's launch, as `wkv_launch_params` chooses it and csrc/wkv.cu maps
    it (block b: head b // (D / JC); thread t: columns (b % (D / JC)) JC +
    (t // G) JL + c, c < JL, rows 4 (q G + t % G) + e, e < 4): G lanes of
    one warp share a column, a block fits the card, and the grid covers
    every (head, row, column) of the state exactly once, for a prefill and
    for decode."""
    for C in (1, 37, 4096):
        G, JC, JL, TC = krwkv.wkv_launch_params(BH, C, D)
        assert D % G == 0 and D % JC == 0 and (D // G) % 4 == 0
        assert 32 % G == 0 and JC % JL == 0 and G * JC // JL <= 1024
        assert TC >= 1 and TC & (TC - 1) == 0 and (TC == 1) == (C == 1)
        owners = np.zeros((BH, D, D), np.int64)    # (head, row, column)
        for b in range(BH * D // JC):
            bh, cb = divmod(b, D // JC)
            for t in range(G * JC // JL):
                rows = [4 * (q * G + t % G) + e for q in range(D // G // 4)
                        for e in range(4)]
                for c in range(JL):
                    owners[bh, rows, cb * JC + t // G * JL + c] += 1
        assert (owners == 1).all()
    with pytest.raises(ValueError, match="head dim"):
        krwkv.wkv_launch_params(BH, 16, 48)
