"""Space-filling-curve keys: Morton (Z-order) and Hilbert (Skilling transform).

Vectorized NumPy over (N, 3) integer grid coordinates.  Hilbert follows John
Skilling, "Programming the Hilbert curve" (AIP CP 707, 2004) — the same curve
family the paper evaluates (and finds wanting for boundary distributions).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "morton_encode", "morton_decode", "hilbert_encode", "hilbert_decode",
    "coords_from_points", "keys_for_points",
]


def _as_grid(ijk) -> np.ndarray:
    g = np.asarray(ijk, dtype=np.uint64)
    if g.ndim == 1:
        g = g[None, :]
    return g


def morton_encode(ijk, depth: int) -> np.ndarray:
    """Interleave bits: key = x2 y2 z2 x1 y1 z1 x0 y0 z0 (x most significant)."""
    g = _as_grid(ijk)
    g = np.clip(g, 0, (1 << depth) - 1)
    key = np.zeros(len(g), dtype=np.uint64)
    for b in range(depth):
        for dim in range(3):
            bit = (g[:, dim] >> np.uint64(b)) & np.uint64(1)
            key |= bit << np.uint64(3 * b + (2 - dim))
    return key


def morton_decode(keys, depth: int) -> np.ndarray:
    k = np.asarray(keys, dtype=np.uint64)
    out = np.zeros((len(k), 3), dtype=np.uint64)
    for b in range(depth):
        for dim in range(3):
            bit = (k >> np.uint64(3 * b + (2 - dim))) & np.uint64(1)
            out[:, dim] |= bit << np.uint64(b)
    return out


def _axes_to_transpose(X: np.ndarray, b: int) -> np.ndarray:
    """Skilling AxestoTranspose, vectorized. X: (N,3) uint64 (modified copy)."""
    X = X.astype(np.uint64).copy()
    M = np.uint64(1 << (b - 1))
    Q = M
    while Q > np.uint64(1):
        P = Q - np.uint64(1)
        for i in range(3):
            hi = (X[:, i] & Q) != 0
            # invert where hi, exchange low bits of X0<->Xi elsewhere
            X[:, 0] = np.where(hi, X[:, 0] ^ P, X[:, 0])
            t = np.where(hi, np.uint64(0), (X[:, 0] ^ X[:, i]) & P)
            X[:, 0] ^= t
            X[:, i] ^= t
        Q >>= np.uint64(1)
    # Gray encode
    for i in range(1, 3):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(len(X), dtype=np.uint64)
    Q = M
    while Q > np.uint64(1):
        t = np.where((X[:, 2] & Q) != 0, t ^ (Q - np.uint64(1)), t)
        Q >>= np.uint64(1)
    for i in range(3):
        X[:, i] ^= t
    return X


def _transpose_to_axes(X: np.ndarray, b: int) -> np.ndarray:
    X = X.astype(np.uint64).copy()
    N = np.uint64(2 << (b - 1))
    # Gray decode
    t = X[:, 2] >> np.uint64(1)
    for i in (2, 1):
        X[:, i] ^= X[:, i - 1]
    X[:, 0] ^= t
    Q = np.uint64(2)
    while Q != N:
        P = Q - np.uint64(1)
        for i in (2, 1, 0):
            hi = (X[:, i] & Q) != 0
            X[:, 0] = np.where(hi, X[:, 0] ^ P, X[:, 0])
            t = np.where(hi, np.uint64(0), (X[:, 0] ^ X[:, i]) & P)
            X[:, 0] ^= t
            X[:, i] ^= t
        Q <<= np.uint64(1)
    return X


def _pack_transpose(X: np.ndarray, b: int) -> np.ndarray:
    """Interleave transpose-format words into a single Hilbert index."""
    key = np.zeros(len(X), dtype=np.uint64)
    for bit in range(b - 1, -1, -1):
        for dim in range(3):
            v = (X[:, dim] >> np.uint64(bit)) & np.uint64(1)
            key = (key << np.uint64(1)) | v
    return key


def _unpack_transpose(keys: np.ndarray, b: int) -> np.ndarray:
    k = np.asarray(keys, dtype=np.uint64)
    X = np.zeros((len(k), 3), dtype=np.uint64)
    pos = 3 * b - 1
    for bit in range(b - 1, -1, -1):
        for dim in range(3):
            v = (k >> np.uint64(pos)) & np.uint64(1)
            X[:, dim] |= v << np.uint64(bit)
            pos -= 1
    return X


def hilbert_encode(ijk, depth: int) -> np.ndarray:
    g = _as_grid(ijk)
    g = np.clip(g, 0, (1 << depth) - 1)
    return _pack_transpose(_axes_to_transpose(g, depth), depth)


def hilbert_decode(keys, depth: int) -> np.ndarray:
    return _transpose_to_axes(_unpack_transpose(keys, depth), depth)


def coords_from_points(x: np.ndarray, depth: int, bbox=None) -> np.ndarray:
    """Map float points to integer grid coordinates at the given depth."""
    x = np.asarray(x, dtype=np.float64)
    if bbox is None:
        lo, hi = x.min(axis=0), x.max(axis=0)
    else:
        lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
    span = np.maximum((hi - lo).max(), 1e-300)
    g = ((x - lo) / (span * (1 + 1e-9)) * (1 << depth)).astype(np.uint64)
    return np.clip(g, 0, (1 << depth) - 1)


def keys_for_points(x: np.ndarray, depth: int = 10, curve: str = "hilbert",
                    bbox=None) -> np.ndarray:
    g = coords_from_points(x, depth, bbox)
    if curve == "hilbert":
        return hilbert_encode(g, depth)
    if curve == "morton":
        return morton_encode(g, depth)
    raise ValueError(f"unknown curve {curve!r}")
