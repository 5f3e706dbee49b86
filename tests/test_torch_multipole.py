"""The port's multipole operators (repro_torch.core.multipole) against the
JAX reference (repro.core.multipole) on the same numpy inputs, and against
direct summation in the idiom of tests/test_multipole.py.

Tolerances:
  - tables: exact (the same NumPy code).
  - derivs in float64: rtol 1e-12 — the port's closed-form recurrence and
    the reference's nested forward-mode AD are both exact up to float64
    rounding (observed ~2e-13 on entries near zero).
  - float32 operators: rtol 1e-5 with atol 1e-5 of the largest reference
    value — the same algebra in float32 associated differently by the two
    frameworks; the port's derivatives are float64 rounded once, the
    reference's are float32 AD, which alone differs by ~1e-6 of the
    largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multipole as jmp
from repro_torch.core import multipole as tmp

P_ORDERS = (2, 3, 4)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _displacements(seed=0, n=40):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * 1.5 + np.array([3.0, -1.0, 0.5])


@pytest.mark.parametrize("p", P_ORDERS)
def test_tables_identical(p):
    a, b = jmp._tables(p), tmp._tables(p)
    assert a.keys() == b.keys()
    for k in a:
        if k == "per_order_pos":
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("p", P_ORDERS)
def test_derivs_float64_match_reference(p):
    d = _displacements()
    ops_j = jmp.MultipoleOperators(p)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jax.vmap(ops_j.derivs))(
            jnp.asarray(d, jnp.float64)))
    got = tmp.MultipoleOperators(p).derivs(_t(d, torch.float64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _operator_inputs(seed=2, B=24, n=16):
    rng = np.random.default_rng(seed)
    return dict(
        M=rng.normal(size=(B, 20)).astype(np.float32),
        d=(rng.normal(size=(B, 3)) + np.array([4.0, 0, 0])).astype(np.float32),
        q=rng.uniform(-1, 1, (B, n)).astype(np.float32),
        x=rng.uniform(-0.5, 0.5, (B, n, 3)).astype(np.float32),
        c=rng.uniform(-0.1, 0.1, (B, 3)).astype(np.float32),
        y=(rng.uniform(-0.5, 0.5, (B, n, 3)) + 5.0).astype(np.float32),
    )


@pytest.mark.parametrize("name", ["p2m", "m2m", "l2l", "m2l", "l2p", "m2p"])
def test_batched_operator_matches_reference(name):
    a = _operator_inputs()
    J, T = jmp.get_operators(4), tmp.get_operators(4, "cpu")
    args = {"p2m": ("q", "x", "c"), "m2m": ("M", "d"), "l2l": ("M", "d"),
            "m2l": ("M", "d"), "l2p": ("M", "x", "c"),
            "m2p": ("M", "y", "c")}[name]
    want = jax.jit(getattr(J, name + "_v"))(*(jnp.asarray(a[k])
                                              for k in args))
    got = getattr(T, name)(*(_t(a[k]) for k in args))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


# ------------------------------------------- physics, port on its own ----
def _clusters(seed=0, n=32, sep=6.0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (n, 3))
    tgt = rng.uniform(-0.5, 0.5, (n, 3)) + np.array([sep, 0.0, 0.0])
    q = rng.uniform(-1, 1, n)
    return src, q, tgt


def _direct(q, src, tgt):
    d = tgt[:, None, :] - src[None, :, :]
    return (q[None, :] / np.sqrt((d ** 2).sum(-1))).sum(-1)


def test_num_coeffs():
    assert tmp.num_coeffs(4) == 20
    assert len(tmp.multi_indices(3)) == 20
    assert len(tmp.multi_indices(6)) == 84


def test_p2m_m2p_matches_direct():
    src, q, tgt = _clusters(sep=8.0)
    ops = tmp.get_operators(4)
    c = torch.zeros(3)
    M = ops.p2m(_t(q), _t(src), c)
    phi = ops.m2p(M, _t(tgt), c).numpy()
    ref = _direct(q, src, tgt)
    assert np.linalg.norm(phi - ref) / np.linalg.norm(ref) < 1e-3


def test_m2l_l2l_l2p_chain_matches_direct():
    src, q, tgt = _clusters(sep=6.0, n=48)
    ops = tmp.get_operators(4)
    c_src = _t(src.mean(0))
    c_tgt = _t(tgt.mean(0))
    M = ops.p2m(_t(q), _t(src), c_src)
    ref = _direct(q, src, tgt)
    phi = ops.l2p(ops.m2l(M, c_tgt - c_src), _t(tgt), c_tgt).numpy()
    assert np.linalg.norm(phi - ref) / np.linalg.norm(ref) < 2e-3
    c_mid = c_tgt + _t([0.2, 0.1, -0.15])
    L2 = ops.l2l(ops.m2l(M, c_mid - c_src), c_tgt - c_mid)
    phi2 = ops.l2p(L2, _t(tgt), c_tgt).numpy()
    assert np.linalg.norm(phi2 - ref) / np.linalg.norm(ref) < 4e-3


def test_convergence_with_order():
    src, q, tgt = _clusters(sep=4.0)
    ref = _direct(q, src, tgt)
    errs = []
    for p in (2, 3, 4):
        ops = tmp.MultipoleOperators(p)
        c_src, c_tgt = _t(src.mean(0)), _t(tgt.mean(0))
        L = ops.m2l(ops.p2m(_t(q), _t(src), c_src), c_tgt - c_src)
        phi = ops.l2p(L, _t(tgt), c_tgt).numpy()
        errs.append(np.linalg.norm(phi - ref) / np.linalg.norm(ref))
    assert errs[2] < errs[1] < errs[0]


def test_p2p_matches_reference_and_self_term_zero():
    src, q, tgt = _clusters(sep=1.0)
    got = tmp.p2p(_t(q), _t(src), _t(tgt)).numpy()
    want = np.asarray(jmp.p2p(jnp.asarray(q, jnp.float32),
                              jnp.asarray(src, jnp.float32),
                              jnp.asarray(tgt, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    self_phi = tmp.p2p(_t(q), _t(src), _t(src)).numpy()
    assert np.all(np.isfinite(self_phi))
