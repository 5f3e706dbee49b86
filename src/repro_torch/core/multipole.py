"""Cartesian Taylor multipole operators for the Laplace kernel G(r) = 1/|r|.

The port of `repro.core.multipole` (exaFMM's Laplace Cartesian kernel at
order P=4).  A multipole expansion about center c is the coefficient vector

    M_k = sum_i q_i (x_i - c)^k / k!          for multi-indices |k| <= P-1,

a local expansion is  phi(y) = sum_j L_j (y - c)^j / j!.

The M2L translation needs derivative tensors D_k G up to order 2(P-1).  The
reference builds them with nested forward-mode AD; at millions of M2L rows
the full order-6 tensors (3^6 entries a row) would not fit, so this module
uses the closed-form recurrence for the Taylor coefficients
a_k = D_k(1/r) / k! of 1/|d|, with a_0 = 1/|d| and n = |k|:

    n |d|^2 a_k = -(2n - 1) sum_i d_i a_{k - e_i} - (n - 1) sum_i a_{k - 2 e_i}

and D_k = k! a_k.  It runs in float64 and rounds once to the caller's dtype.

Every operator is batched: inputs carry any number of leading row
dimensions, and the tables live on the operator set's device.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["multi_indices", "num_coeffs", "MultipoleOperators",
           "get_operators", "p2p", "M2L_CHUNK"]

# M2L rows per operator call in the per-tree executors (core.fmm) and the
# engine's far field: bounds the transient (rows, nk, nk) translation
# matrices, which at 2^23 rows would take about 13 GB in one call.
M2L_CHUNK = 1 << 19


def multi_indices(max_order: int) -> np.ndarray:
    """All 3D multi-indices k with |k| <= max_order, ordered by order then lex."""
    out = []
    for n in range(max_order + 1):
        for kx in range(n, -1, -1):
            for ky in range(n - kx, -1, -1):
                out.append((kx, ky, n - kx - ky))
    return np.array(out, dtype=np.int32)


def num_coeffs(p: int) -> int:
    """Number of coefficients for expansion order p (indices |k| <= p-1)."""
    return (p * (p + 1) * (p + 2)) // 6


def _factorial_prod(idx: np.ndarray) -> np.ndarray:
    f = np.array([math.factorial(i) for i in range(idx.max() + 1)], dtype=np.float64)
    return f[idx[:, 0]] * f[idx[:, 1]] * f[idx[:, 2]]


@lru_cache(maxsize=None)
def _tables(p: int):
    """Precomputed integer/float tables for order-p operators (NumPy, host)."""
    K = multi_indices(p - 1)            # (nk, 3) expansion indices
    E = multi_indices(2 * (p - 1))      # (ne, 3) extended (for M2L derivatives)
    nk, ne = len(K), len(E)
    lookup = {tuple(k): i for i, k in enumerate(E)}
    fact_K = _factorial_prod(K)                       # k!
    order_K = K.sum(axis=1)

    # translation tables: T[j, k] uses monomial at (j - k) (M2M) or (k - j) (L2L)
    m2m_idx = np.zeros((nk, nk), dtype=np.int32)
    m2m_valid = np.zeros((nk, nk), dtype=bool)
    l2l_idx = np.zeros((nk, nk), dtype=np.int32)
    l2l_valid = np.zeros((nk, nk), dtype=bool)
    m2l_idx = np.zeros((nk, nk), dtype=np.int32)      # index of (j + k) in E
    for j in range(nk):
        for k in range(nk):
            d = K[j] - K[k]
            if (d >= 0).all():
                m2m_idx[j, k] = lookup[tuple(d)]
                m2m_valid[j, k] = True
            d = K[k] - K[j]
            if (d >= 0).all():
                l2l_idx[j, k] = lookup[tuple(d)]
                l2l_valid[j, k] = True
            m2l_idx[j, k] = lookup[tuple(K[j] + K[k])]

    # inverse factorial of the *monomial* index per table entry
    fact_E = _factorial_prod(E)
    inv_fact_E = 1.0 / fact_E
    sign_K = np.where(order_K % 2 == 0, 1.0, -1.0)    # (-1)^|k|

    # gather map: for each extended index of order n, the flat position inside
    # the order-n full derivative tensor (shape 3^n), via repeated axes (0/1/2)
    per_order_pos = []
    for n in range(2 * (p - 1) + 1):
        rows = E[E.sum(axis=1) == n]
        pos = []
        for kx, ky, kz in rows:
            digits = [0] * kx + [1] * ky + [2] * kz
            flat = 0
            for dgt in digits:
                flat = flat * 3 + dgt
            pos.append(flat)
        per_order_pos.append(np.array(pos, dtype=np.int32))
    return dict(
        K=K, E=E, nk=nk, ne=ne,
        inv_fact_K=(1.0 / fact_K), sign_K=sign_K, order_K=order_K,
        m2m_idx=m2m_idx, m2m_valid=m2m_valid,
        l2l_idx=l2l_idx, l2l_valid=l2l_valid,
        m2l_idx=m2l_idx, inv_fact_E=inv_fact_E,
        per_order_pos=per_order_pos,
    )


@lru_cache(maxsize=None)
def _recurrence_tables(p: int):
    """Per derivative order n >= 1: the E-row range of order n, and for each
    of its indices k the E-rows of k - e_i and k - 2 e_i (with validity
    masks) that the Taylor-coefficient recurrence reads."""
    E = _tables(p)["E"]
    lookup = {tuple(k): i for i, k in enumerate(E)}
    order = E.sum(axis=1)
    out = []
    for n in range(1, 2 * (p - 1) + 1):
        rows = np.nonzero(order == n)[0]
        idx1 = np.zeros((len(rows), 3), np.int64)
        idx2 = np.zeros((len(rows), 3), np.int64)
        v1 = np.zeros((len(rows), 3))
        v2 = np.zeros((len(rows), 3))
        for r, k in enumerate(E[rows]):
            for i in range(3):
                e = np.zeros(3, np.int32)
                e[i] = 1
                if k[i] >= 1:
                    idx1[r, i] = lookup[tuple(k - e)]
                    v1[r, i] = 1.0
                if k[i] >= 2:
                    idx2[r, i] = lookup[tuple(k - 2 * e)]
                    v2[r, i] = 1.0
        out.append((n, int(rows[0]), int(rows[-1]) + 1, idx1, v1, idx2, v2))
    return out


class MultipoleOperators:
    """Order-p Cartesian Taylor operators on one device; every method maps
    over leading row dimensions."""

    def __init__(self, p: int = 4, device="cpu"):
        self.p = p
        self.device = torch.device(device)
        t = _tables(p)
        self.nk = t["nk"]
        self.ne = t["ne"]
        self._max_order = 2 * (p - 1)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        i64, f32, f64 = torch.int64, torch.float32, torch.float64
        self._K = dev(t["K"], i64)
        self._E = dev(t["E"], i64)
        self._inv_fact_K = dev(t["inv_fact_K"], f32)
        self._sign_K = dev(t["sign_K"], f32)
        self._m2m_idx = dev(t["m2m_idx"], i64)
        self._m2m_valid = dev(t["m2m_valid"], torch.bool)
        self._l2l_idx = dev(t["l2l_idx"], i64)
        self._l2l_valid = dev(t["l2l_valid"], torch.bool)
        self._m2l_idx = dev(t["m2l_idx"], i64)
        self._inv_fact_E = dev(t["inv_fact_E"], f32)
        self._fact_E64 = dev(1.0 / t["inv_fact_E"], f64)
        self._rec = [(n, lo, hi, dev(i1, i64), dev(v1, f64), dev(i2, i64),
                      dev(v2, f64))
                     for n, lo, hi, i1, v1, i2, v2 in _recurrence_tables(p)]

    # ---- building blocks -------------------------------------------------
    @staticmethod
    def _powers(d, max_order: int):
        """d (..., 3) -> (..., 3, max_order + 1) with d^0 .. d^max_order."""
        pows = [torch.ones_like(d)]
        for _ in range(max_order):
            pows.append(pows[-1] * d)
        return torch.stack(pows, dim=-1)

    def _monomials(self, d, idx, max_order: int):
        pows = self._powers(d, max_order)
        return (pows[..., 0, idx[:, 0]] * pows[..., 1, idx[:, 1]]
                * pows[..., 2, idx[:, 2]])

    def monomials_ext(self, d):
        """d^k for every extended multi-index k. d: (..., 3) -> (..., ne)."""
        return self._monomials(d, self._E, self._max_order)

    def monomials_k(self, d):
        """d^k for every expansion multi-index k. d: (..., 3) -> (..., nk)."""
        return self._monomials(d, self._K, self.p - 1)

    def derivs(self, d):
        """All derivative values D_k G(d) for |k| <= 2(p-1).
        d: (..., 3) -> (..., ne), in d's dtype (computed in float64)."""
        lead = d.shape[:-1]
        d64 = d.reshape(-1, 3).to(torch.float64)
        r2 = (d64 * d64).sum(-1)
        inv_r2 = 1.0 / r2
        a = torch.empty(d64.shape[0], self.ne, dtype=torch.float64,
                        device=d64.device)
        a[:, 0] = torch.rsqrt(r2)
        for n, lo, hi, i1, v1, i2, v2 in self._rec:
            s1 = (a[:, i1] * d64[:, None, :] * v1).sum(-1)
            s2 = (a[:, i2] * v2).sum(-1)
            a[:, lo:hi] = ((-(2 * n - 1)) * s1 - (n - 1) * s2) \
                * (inv_r2 / n)[:, None]
        return (a * self._fact_E64).to(d.dtype).reshape(*lead, self.ne)

    # ---- operators ---------------------------------------------------------
    def p2m(self, q, x, center):
        """q (..., n), x (..., n, 3), center (..., 3) -> (..., nk).
        Padded bodies carry q = 0."""
        mono = self.monomials_k(x - center[..., None, :])      # (..., n, nk)
        return (q[..., None] * mono).sum(-2) * self._inv_fact_K

    def _translate(self, C, d, idx, valid):
        mono = self.monomials_ext(d)                           # (..., ne)
        T = torch.where(valid, mono[..., idx] * self._inv_fact_E[idx],
                        torch.zeros((), dtype=mono.dtype, device=mono.device))
        return (T @ C[..., None])[..., 0]

    def m2m(self, M, d):
        """Translate multipoles by d = c_child - c_parent. (..., nk)."""
        return self._translate(M, d, self._m2m_idx, self._m2m_valid)

    def l2l(self, L, d):
        """Translate locals by d = c_child - c_parent. (..., nk)."""
        return self._translate(L, d, self._l2l_idx, self._l2l_valid)

    def m2l(self, M, d):
        """Multipoles at c_M -> locals at c_L; d = c_L - c_M. (..., nk)."""
        D = self.derivs(d)                                     # (..., ne)
        T = D[..., self._m2l_idx] * self._sign_K               # (..., nk, nk)
        return (T @ M[..., None])[..., 0]

    def l2p(self, L, y, center):
        """Evaluate locals at targets: L (..., nk), y (..., n, 3),
        center (..., 3) -> (..., n)."""
        mono = self.monomials_k(y - center[..., None, :])      # (..., n, nk)
        return (mono @ (L * self._inv_fact_K)[..., None])[..., 0]

    def m2p(self, M, y, center):
        """Direct multipole evaluation at targets: M (..., nk), y (..., n, 3),
        center (..., 3) -> (..., n)."""
        D = self.derivs(y - center[..., None, :])              # (..., n, ne)
        # m2l_idx[0, :] maps k -> index of (0 + k) = k in E
        coef = M * self._sign_K                                # (..., nk)
        return (D[..., self._m2l_idx[0]] * coef[..., None, :]).sum(-1)


@lru_cache(maxsize=None)
def _operators(p: int, device: str) -> MultipoleOperators:
    return MultipoleOperators(p, device)


def get_operators(p: int = 4, device="cpu") -> MultipoleOperators:
    """Cached operator set per (order, device)."""
    return _operators(int(p), str(torch.device(device)))


def p2p(q_src, x_src, x_tgt, eps2: float = 0.0):
    """Direct Laplace potential: phi_t = sum_s q_s / |x_t - x_s| (self term 0).
    q_src (S,), x_src (S, 3), x_tgt (T, 3) -> (T,)."""
    d = x_tgt[:, None, :] - x_src[None, :, :]
    r2 = (d * d).sum(-1) + eps2
    inv_r = torch.where(r2 > 0, torch.rsqrt(r2.clamp_min(1e-30)),
                        torch.zeros((), dtype=r2.dtype, device=r2.device))
    return inv_r @ q_src
