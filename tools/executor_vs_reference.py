#!/usr/bin/env python3
"""Where the port's per-partition executor and the JAX reference's differ,
and why, at N = 4,000 in 8 parts, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/executor_vs_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/executor_vs_reference.py \
        --seeds 5 7 --n 4000

For each seed: a sphere of N bodies (`make_distribution(..., seed)`),
charges uniform in [-1, 1) from `default_rng(seed + 1)`, `PartitionSpec(
nparts=8, method="orb", ncrit=64)`, planned by both packages with the host
traversal.  It runs `repro_torch.core.api.execute_geometry` (CPU) and
`repro.core.api.execute_geometry` (jnp route) and prints:

  - the values past tests/test_engine.py's tolerance (rtol 1e-6 / atol
    2e-5) and the largest |diff| / tolerance;
  - the near field's difference alone, against the same tolerance and
    against eps32 * sum|q|/r over the near pairs (the rounding scale of a
    reordered float32 near-field sum), and the far field's;
  - at the worst values, the difference split into the near field (P2P +
    M2P, summed in float32 per block by both packages, in different orders)
    and the far field (M2L, L2L, L2P), beside that scale, and both
    packages' error against the float64 direct sum;
  - the same comparison with the port's M2L derivatives replaced by the
    reference's (float32 `jax.jacfwd`), which removes that one difference
    between the two far fields.

It needs both packages, so it runs where JAX is installed, as the tests do.
The reference compiles its passes per shape: about 2 minutes a seed.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import api as japi
from repro.core import fmm as jfmm
from repro.core.multipole import get_operators as jget_operators
from repro_torch.core import fmm
from repro_torch.core import multipole
from repro_torch.core.api import (PartitionSpec, execute_geometry,
                                  plan_geometry)
from repro_torch.core.distributions import make_distribution

RTOL, ATOL = 1e-6, 2e-5
EPS32 = float(np.finfo(np.float32).eps)


def near_field(geo, port: bool) -> np.ndarray:
    """P2P + M2P of every receiver, in original body order (float64)."""
    mod, kw = (fmm, dict(device="cpu")) if port else (jfmm, {})
    out = np.zeros(geo.n)
    for j in range(geo.nparts):
        r = geo.receivers[j]
        if r is None:
            continue
        t = r.tree
        phi = np.asarray(mod.p2p_apply(t, t, r.local, use_kernels=False,
                                       **kw), dtype=np.float64)
        for rb in r.remote:
            if rb.inter.n_p2p:
                phi = phi + np.asarray(mod.p2p_apply(
                    t, rb.graft, rb.inter, use_kernels=False, **kw))
            if rb.inter.n_m2p:
                phi = phi + np.asarray(mod.m2p_apply(
                    t, rb.graft.M, rb.inter, p=geo.p, **kw))
        out[geo.owners[j][t.perm]] = phi
    return out


def reference_derivs():
    """MultipoleOperators.derivs computed by the reference (float32 AD)."""
    jd = jax.jit(jax.vmap(jget_operators(4).derivs))

    def derivs(self, d):
        lead = d.shape[:-1]
        a = np.array(jd(jnp.asarray(d.reshape(-1, 3).cpu().numpy(),
                                    dtype=jnp.float32)))
        return torch.as_tensor(a).to(d.dtype).reshape(*lead, self.ne)
    return derivs


def over(got, want) -> tuple:
    ratio = np.abs(got - want) / (ATOL + RTOL * np.abs(want))
    return int((ratio > 1).sum()), float(ratio.max()), ratio


def run(seed: int, n: int, top: int) -> None:
    x = make_distribution("sphere", n, seed=seed)
    q = np.random.default_rng(seed + 1).uniform(-1, 1, n)
    spec = dict(nparts=8, method="orb", ncrit=64)
    g = plan_geometry(x, q, PartitionSpec(**spec), device="cpu")
    r = japi.plan_geometry(x, q, japi.PartitionSpec(traversal_backend="host",
                                                    **spec))
    want = np.asarray(japi.execute_geometry(r, use_kernels=False))
    got = execute_geometry(g, device="cpu")
    near_g, near_r = near_field(g, True), near_field(r, False)
    g_abs = plan_geometry(x, np.abs(q), PartitionSpec(**spec), device="cpu")
    near_abs = near_field(g_abs, True)
    exact = fmm.direct_potential(x, q, device="cpu")
    n_over, worst, ratio = over(got, want)
    print(f"seed {seed}, N {n}: {n_over} of {n} past rtol {RTOL:g} / atol "
          f"{ATOL:g}, largest |diff| / tol {worst:.3f}; largest |diff| / "
          f"(eps32 * near sum|q|/r) "
          f"{float((np.abs(got - want) / (EPS32 * near_abs)).max()):.3f}",
          flush=True)
    dn_all = near_g - near_r
    df_all = got - want - dn_all
    print(f"  near field alone: {over(near_g, near_r)[0]} past the tolerance,"
          f" largest |near diff| {float(np.abs(dn_all).max()):.3e}, largest "
          f"|near diff| / (eps32 * near sum|q|/r) "
          f"{float((np.abs(dn_all) / (EPS32 * near_abs)).max()):.3f}; far "
          f"field alone: largest |far diff| {float(np.abs(df_all).max()):.3e}",
          flush=True)
    for i in np.argsort(ratio)[::-1][:top]:
        dn = near_g[i] - near_r[i]
        print(f"  body {i}: phi {want[i]:+.4f}, diff {got[i] - want[i]:+.3e}"
              f" = near {dn:+.3e} + far {got[i] - want[i] - dn:+.3e} "
              f"(|diff| / tol {ratio[i]:.3f}); eps32 * near sum|q|/r "
              f"{EPS32 * near_abs[i]:.3e}; error vs direct sum: port "
              f"{got[i] - exact[i]:+.3e}, reference {want[i] - exact[i]:+.3e}",
              flush=True)
    plain = multipole.MultipoleOperators.derivs
    multipole.MultipoleOperators.derivs = reference_derivs()
    try:
        got_ad = execute_geometry(g, device="cpu")
    finally:
        multipole.MultipoleOperators.derivs = plain
    n_ad, worst_ad, _ = over(got_ad, want)
    print(f"  with the reference's float32-AD M2L derivatives: {n_ad} past, "
          f"largest |diff| / tol {worst_ad:.3f} (was {n_over}, {worst:.3f})",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 7, 9, 11])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--top", type=int, default=3)
    args = ap.parse_args()
    for seed in args.seeds:
        run(seed, args.n, args.top)


if __name__ == "__main__":
    main()
