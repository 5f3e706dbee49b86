"""K4's backward kernel (`repro_torch.kernels.attention._launch_bwd`,
csrc/attention_bwd.cu) where the CPU can reach it, and the oracle of the
row statistics it reads.

The dry run's stand-in on the `meta` device: at several shapes, masks
(causal, windowed, unmasked over keys of their own length, a one-sided
window) and GQA groups (1 to 8, smollm-360m's 3), the backward of K4's
Function reports "K4.bwd" in closed form (7 products of 2 D operations an
admitted pair, 9 at head size 256; q, k, v, o, dO and the statistics read
once, dq, dk, dv and the bfloat16 row scratch written once, the group
scratch of `attention_bwd_launch_params`' parts written and read once; the
reference's backward dots, 8 B H Sq Sk D), returns gradients of the inputs' shapes and types, never
reaches the plain `flash_attention_bwd`, and allocates no (G, Sq, Sk)
float32 block, where the plain version, walked the same way, does.  The
wrapper refuses, naming the fault, what the kernel does not take.

`attention_stats_ref`, the plain version of the statistics K4 leaves for
its backward (each row's max m and sum l of p = exp(s - m)), against the
JAX reference's softmax on the same numpy inputs, in float32: P = exp(s -
m) / l against `jax.nn.softmax` of the reference's scores (atol 1e-6) and
m + log l against `jax.nn.logsumexp` (atol 1e-5).  The card tests hold the
kernel's statistics and gradients to these plain versions
(tests/test_torch_kernels_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.analysis import hlo_walk
from repro_torch.kernels import attention as kattn


def meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# (B, H, Hkv, Sq, Sk, D, causal, window)
CASES = {
    "causal g1": (2, 4, 4, 512, 512, 64, True, None),
    "causal g2": (2, 4, 2, 640, 640, 32, True, None),
    "smollm g3": (1, 6, 2, 1024, 1024, 64, True, None),
    "window g2": (2, 4, 2, 768, 768, 128, True, 100),
    "unmasked g8": (1, 16, 2, 512, 1000, 128, False, None),
    "one-sided window g4": (1, 8, 2, 600, 600, 64, False, 70),
    "d256 window g2": (1, 4, 2, 1024, 1024, 256, True, 300),
    "d256 unmasked g1": (1, 2, 2, 700, 1100, 256, False, None),
}


def _walk_backward(B, H, Hkv, Sq, Sk, D, causal, window):
    q = meta(B, H, Sq, D, grad=True)
    k, v = (meta(B, Hkv, Sk, D, grad=True) for _ in range(2))
    with hlo_walk.Walker() as w:
        held = w.track([q, k, v])
        o = kattn.flash_attention(q, k, v, causal=causal, window=window)
        g = torch.autograd.grad(o, [q, k, v], meta(B, H, Sq, D))
    return w, g, w.peak_raw - held, (q, k, v)


@pytest.mark.parametrize("case", list(CASES))
def test_k4_backward_meta_report_in_closed_form(case, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("flash_attention_bwd reached on meta")

    B, H, Hkv, Sq, Sk, D, causal, window = CASES[case]
    n0 = (kattn.launches, kattn.backward_launches, kattn.backward_calls)
    with monkeypatch.context() as mp:
        mp.setattr(kattn, "flash_attention_bwd", refuse)
        w, g, peak, ins = _walk_backward(*CASES[case])
    # meta launches nothing; the Function's backward ran once
    assert (kattn.launches, kattn.backward_launches,
            kattn.backward_calls) == (n0[0], n0[1], n0[2] + 1)
    assert [(t.shape, t.dtype) for t in g] == [(t.shape, t.dtype)
                                               for t in ins]
    res = w.result()
    pairs = kattn.admitted_pairs(Sq, Sk, causal, window) * B * H
    products = 7 if D <= 128 else 9
    rows = B * H * Sq
    # the bfloat16 launch's scratch: a float4 a row of Sq padded to 64, and
    # the group's parts' float32 dK and dV, written and read once
    parts = kattn.attention_bwd_launch_params(B, H, Hkv, Sq, Sk, D, causal,
                                              window)[0]
    row_scratch = 16.0 * B * H * (-(-Sq // 64) * 64)
    group = 8.0 * parts * B * Hkv * Sk * D if parts > 1 else 0.0
    assert res["port"]["kernels"]["K4.bwd"] == {
        "launches": 1, "operations": 2.0 * products * D * pairs,
        "bytes": 2.0 * (4 * rows * D + 4 * B * Hkv * Sk * D) + 8.0 * rows
        + row_scratch + 2 * group}
    fwd = res["port"]["kernels"]["K4"]
    assert res["dot_flops"] == 12.0 * B * H * Sq * Sk * D
    assert res["port"]["dot_flops_card"] == fwd["operations"] + \
        2.0 * products * D * pairs
    # no (G, Sq, Sk) float32 block: the plain version walked the same way
    # peaks at least one such block higher, less the kernel's scratch (q *
    # scale, the row scratch and the group scratch), which the plain version
    # does not allocate
    monkeypatch.setattr(kattn, "_launch_bwd", _plain_bwd)
    _, _, plain_peak, _ = _walk_backward(*CASES[case])
    scratch = 2 * B * H * Sq * D + row_scratch + group
    assert plain_peak - peak >= 4 * (H // Hkv) * Sq * Sk - scratch


def _plain_bwd(q, k, v, o, do, stats, causal, window):
    return kattn.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                     window=window)


@pytest.mark.parametrize("case", ["causal g2", "unmasked g8",
                                  "d256 window g2"])
def test_plain_backward_walked_on_meta_holds_the_blocks(case, monkeypatch):
    """The same walk with the plain version in the kernel's place holds at
    least one group's (G, Sq, Sk) float32 scores: what the kernel's route
    no longer allocates."""
    monkeypatch.setattr(kattn, "_launch_bwd", _plain_bwd)
    B, H, Hkv, Sq, Sk, D, causal, window = CASES[case]
    w, _, peak, _ = _walk_backward(*CASES[case])
    assert "K4.bwd" not in w.result()["port"]["kernels"]
    assert peak >= 4 * (H // Hkv) * Sq * Sk


def _bwd_args(B=2, H=4, Hkv=2, S=256, D=64, dtype=torch.bfloat16):
    q, o, do = (meta(B, H, S, D, dtype=dtype) for _ in range(3))
    k, v = (meta(B, Hkv, S, D, dtype=dtype) for _ in range(2))
    stats = meta(2, B, H, S, dtype=torch.float32)
    return [q, k, v, o, do, stats]


def _misaligned_do(args):
    base = torch.empty(args[4].numel() + 1, dtype=args[4].dtype,
                       device="meta")
    args[4] = base[1:].view(args[4].shape)
    return args


REFUSALS = {
    "head dim": (lambda: _bwd_args(D=48), "head dim"),
    "stats shape": (lambda: _bwd_args()[:5] + [meta(2, 2, 4, 100,
                                                    dtype=torch.float32)],
                    "stats must be"),
    "stats type": (lambda: _bwd_args()[:5] + [meta(2, 2, 4, 256)],
                   "stats must be"),
    "do shape": (lambda: _bwd_args()[:4] + [meta(2, 4, 100, 64)]
                 + _bwd_args()[5:], "do must match"),
    "o type": (lambda: _bwd_args()[:3] + [meta(2, 4, 256, 64,
                                               dtype=torch.float32)]
               + _bwd_args()[4:], "o must match"),
    "not contiguous": (lambda: _bwd_args()[:4] + [
        meta(2, 4, 64, 256).transpose(2, 3)] + _bwd_args()[5:],
        "contiguous"),
    "misaligned": (lambda: _misaligned_do(_bwd_args()), "aligned"),
    "cpu": (lambda: [torch.zeros(t.shape, dtype=t.dtype)
                     for t in _bwd_args()], "unsupported device"),
}


@pytest.mark.parametrize("fault", list(REFUSALS))
def test_k4_backward_wrapper_refuses_what_the_kernel_does_not_take(fault):
    make, match = REFUSALS[fault]
    before = kattn.backward_launches
    with pytest.raises(ValueError, match=match):
        kattn._launch_bwd(*make(), True, None)
    assert kattn.backward_launches == before


def _ref_scores(qn, kn, causal, window):
    """The reference's masked float32 scores, (B, Hkv, G, Sq, Sk): q in
    the model layout (B, Sq, H, D) scaled as `attention_full` scales it,
    `_gqa_scores`, the mask with the reference's NEG_INF."""
    B, H, Sq, D = qn.shape
    Hkv, Sk = kn.shape[1], kn.shape[2]
    qg = jnp.asarray(qn.transpose(0, 2, 1, 3)).reshape(
        B, Sq, Hkv, H // Hkv, D) * (D ** -0.5)
    s = jlayers._gqa_scores(qg, jnp.asarray(kn.transpose(0, 2, 1, 3)))
    qi = jnp.arange(Sq)[:, None]
    ki = jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return jnp.where(mask[None, None, None], s, jlayers.NEG_INF)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", [
    (2, 4, 2, 200, 200, 64, True, None),
    (1, 6, 2, 333, 333, 32, True, 64),
    (2, 8, 1, 150, 260, 128, False, None),
    (1, 4, 4, 120, 120, 256, False, 40),
])
def test_stats_ref_matches_reference_softmax(B, H, Hkv, Sq, Sk, D, causal,
                                             window):
    rng = np.random.default_rng(Sq + D)
    qn = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    kn = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    st = kattn.attention_stats_ref(torch.as_tensor(qn), torch.as_tensor(kn),
                                   causal=causal, window=window)
    assert st.shape == (2, B, H, Sq) and st.dtype == torch.float32
    s = _ref_scores(qn, kn, causal, window)
    G = H // Hkv
    m = st[0].numpy().reshape(B, Hkv, G, Sq)[..., None]
    l = st[1].numpy().reshape(B, Hkv, G, Sq)[..., None]
    p = np.exp(np.asarray(s) - m) / np.maximum(l, 1e-30)
    np.testing.assert_allclose(p, np.asarray(jax.nn.softmax(s, axis=-1)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose((m + np.log(l))[..., 0],
                               np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=0, atol=1e-5)
