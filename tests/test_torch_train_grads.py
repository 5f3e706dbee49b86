"""The gradients of K4 and K5, and the loss and gradients of the hybrid,
encoder-decoder and vlm families, against the JAX reference, on the CPU
(tests/test_torch_train.py holds the dense, sliding-window, MoE and ssm
families with the same checks and weights; the two files share the work
so that each stays short under `--dist loadfile`).

Kernel backwards: `flash_attention_bwd` (causal, windowed, unmasked Sk !=
Sq; GQA) and `wkv_bwd` (a nonzero initial state and final-state gradient)
against autograd through the plain versions with the kernels' roundings
(`attention_rounded_ref`, `wkv_ref`) and against `jax.vjp` of the
reference oracles (`repro.kernels.ref`; Sq == Sk, its mask's shape):
float32 at 1e-5 of the largest |gradient| (sums in another order),
bfloat16 inputs at 2e-2 (the gradients are rounded to bfloat16 once,
2^-9, where autograd rounds them after each cast it passes back through).

Families: hymba (hybrid), seamless (encdec) and llama-3.2-vision (vlm) in
float32, and qwen3 in bfloat16 (noise on the per-layer vectors only), at
tests/test_torch_train.py's limits: the loss at rtol 1e-4 (bfloat16 5e-2),
each leaf's gradient within 1e-3 (5e-2) of its largest |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import rwkv as krwkv

from test_torch_train import (Case, check_grads, check_loss, make_batch,
                              named_leaves)

CASES = [(a, "float32") for a in ("hymba-1.5b", "seamless-m4t-medium",
                                  "llama-3.2-vision-90b")] + [
    ("qwen3-0.6b", "bfloat16")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    return Case(*request.param)


def test_loss_matches_reference(case):
    check_loss(case)


def test_every_gradient_matches_reference(case):
    check_grads(case)


KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ATTN_CASES = [  # (H, Hkv, Sq, Sk, D, causal, window)
    (4, 2, 48, 48, 32, True, None),
    (4, 2, 48, 48, 32, True, 16),
    (4, 4, 40, 40, 64, False, None),
    (4, 1, 24, 56, 32, False, None),
]


def _attn_inputs(H, Hkv, Sq, Sk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    q, k, v = mk(2, H, Sq, D), mk(2, Hkv, Sk, D), mk(2, Hkv, Sk, D)
    do = mk(2, H, Sq, D)
    return [t.to(dtype) for t in (q, k, v)], do.to(dtype)


def _close(got, want, tol, what):
    if isinstance(want, torch.Tensor):
        want = want.float()
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_CASES, ids=lambda s: "-".join(
    map(str, s)))
def test_flash_attention_bwd_matches_autograd(shape, dtype):
    H, Hkv, Sq, Sk, D, causal, window = shape
    (q, k, v), do = _attn_inputs(H, Hkv, Sq, Sk, D, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = kattn.attention_rounded_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, do)
    got = kattn.flash_attention_bwd(q, k, v, o.detach(), do, causal=causal,
                                    window=window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close(g, w, KERNEL_TOL[dtype], f"d{name}")


@pytest.mark.parametrize("shape", [s for s in ATTN_CASES if s[2] == s[3]],
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_bwd_matches_reference_vjp(shape):
    H, Hkv, Sq, Sk, D, causal, window = shape
    (q, k, v), do = _attn_inputs(H, Hkv, Sq, Sk, D, torch.float32, seed=1)
    o, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal, window=window),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    got = kattn.flash_attention_bwd(q, k, v, torch.as_tensor(np.asarray(o)),
                                    do, causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, KERNEL_TOL[torch.float32], f"d{name}")


def _wkv_inputs(BH, C, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=-1, hi=1: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, s).astype(np.float32))
    r, k, v = (f(BH, C, D).to(dtype) for _ in range(3))
    w = f(BH, C, D, lo=0.6, hi=1.0)
    u, s0 = f(BH, D), f(BH, D, D) * 0.5
    dy, ds = f(BH, C, D).to(dtype), f(BH, D, D)
    return (r, k, v, w, u, s0), dy, ds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_wkv_bwd_matches_autograd(dtype):
    args, dy, ds = _wkv_inputs(3, 24, 16, dtype)
    leaves = [t.clone().requires_grad_() for t in args]
    y, s1 = krwkv.wkv_ref(*leaves)
    want = torch.autograd.grad((y, s1), leaves, (dy, ds))
    got = krwkv.wkv_bwd(*args, dy, ds)
    for name, g, w, x in zip(("r", "k", "v", "w", "u", "state"), got, want,
                             args):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        _close(g, w, KERNEL_TOL[dtype], f"d{name}")


def test_wkv_bwd_matches_reference_vjp():
    args, dy, ds = _wkv_inputs(3, 24, 16, torch.float32, seed=1)
    (y, s1), vjp = jax.vjp(jref.wkv_ref,
                           *(jnp.asarray(t.numpy()) for t in args))
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(ds.numpy())))
    got = krwkv.wkv_bwd(*args, dy, ds)
    for name, g, w in zip(("r", "k", "v", "w", "u", "state"), got, want):
        _close(g, w, KERNEL_TOL[torch.float32], f"d{name}")
    # no final-state gradient: the same as a zero one
    zero = krwkv.wkv_bwd(*args, dy, None)
    ref0 = krwkv.wkv_bwd(*args, dy, torch.zeros_like(ds))
    for a, b in zip(zero, ref0):
        assert torch.equal(a, b)


def test_init_weights_in_the_model_type_and_trainable():
    """A float32 config trains from the port's own init: its bfloat16
    weights come in float32 (the MoE router stays float32), every leaf
    requires grad, and each gets a gradient; the served model holds the
    tree detached."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_weights, weight_structs
    from repro_torch.train.train_step import value_and_grad
    cfg = replace(get_config("dbrx-132b", smoke=True), dtype="float32")
    params = init_weights(cfg, seed=0, device="cpu", trainable=True)
    like = weight_structs(cfg)
    for (name, p), (_, m) in zip(named_leaves(params), named_leaves(like)):
        assert p.dtype == m.dtype == torch.float32 and p.shape == m.shape
        assert p.requires_grad and p.is_leaf and m.is_meta, name
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg).items()}
    loss, parts, grads = value_and_grad(params, batch, cfg)
    assert float(parts["aux"]) > 0
    for name, g in named_leaves(grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, \
            name
    served = build_model(cfg, params)
    assert not any(p.requires_grad for p in served.parameters())
    assert served.params["embed"].data_ptr() == params["embed"].data_ptr()
