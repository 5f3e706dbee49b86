"""Particle distributions used by the paper's experiments.

`sphere` (boundary/surface — the paper's main target, ~50% of FMM use via
boundary integral equations), `cube` (uniform volume — classical case where
HOT is optimal), `ellipsoid` (PVFMM comparison, Fig 9), `plummer` (astro).
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_distribution"]


def make_distribution(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "cube":
        return rng.uniform(-1, 1, (n, 3))
    if kind == "sphere":
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    if kind == "ellipsoid":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return v * np.array([2.0, 1.0, 0.5])
    if kind == "plummer":
        # Plummer model with unit scale radius, clipped to 10 radii
        m = rng.uniform(0, 1, n)
        r = np.minimum((m ** (-2.0 / 3.0) - 1.0) ** -0.5, 10.0)
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return v * r[:, None]
    raise ValueError(f"unknown distribution {kind!r}")
