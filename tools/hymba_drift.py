#!/usr/bin/env python3
"""How far hymba's bfloat16 decode drifts from its forward, in the JAX
reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/hymba_drift.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/hymba_drift.py --seeds 0 1 2
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/hymba_drift.py --deep \
        --seeds 0 1 2

hymba's decode step rounds the SSM state to the model's type before C . h
(`repro.models.decode.decode_step`), where the forward's scan keeps it in
float32, so a served token's logits differ from a forward over the same
sequence by more than a plain transformer's.  For each seed: a config in
bfloat16 with the reference's init (`model.init(key(seed))`), a prompt
prefilled and decode steps chained on each package's own cache, each
step's logits against a forward over the sequence so far.  Prints, per
package, the smallest and largest |decode - forward| as a share of the
forward's largest |logit|, and the same for the port with a planted fault
(the SSM state zeroed before each step), which a gate set from these
figures must see.

Without `--deep`: the smoke config (3 layers, d_model 64), the SSM's
`conv_w`, `A_log` and `D_skip` drawn from N(0, 0.3) (the init zeroes the
conv and sets A = -1, which hides the conv tail), a prompt of 16 tokens
and 20 steps.  With `--deep`: hymba-1.5b's own config (32 layers, the
global layers 0, 15 and 31, head dim 64, SSM state 16, vocab 32,001) with
its width cut from d_model 1600 to 320 (5 heads, 1 kv head, d_ff 1,100)
so that it runs on a CPU, the init as it is (as `chip_smoke.py` serves the
model), and `chip_smoke.py`'s traffic: 8 prompts of 4-15 tokens from
`default_rng(seed)`, 8 steps each.  `chip_smoke.py` sets its gate for
hymba's served tokens (HYMBA_LOGIT_TOL) from the reference's figures.

It needs both packages, so it runs where JAX is installed, as the tests do
(about a minute a seed; `--deep` a few).
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.transformer import logits_fn as jlogits_fn
from repro.sharding.parallel import Parallelism
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model

ARCH = "hymba-1.5b"
PROMPT, STEPS, SSM_SCALE = 16, 20, 0.3


DEEP = dict(d_model=320, n_heads=5, n_kv_heads=1, d_ff=1100)


def weights(seed, deep=False):
    cfg = (replace(jget_config(ARCH), **DEEP) if deep
           else jget_config(ARCH, smoke=True))
    model = jbuild_model(cfg)
    params = model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    if deep:
        return cfg, model, params, rng

    def draw(path, a):
        if path[-1].key not in ("conv_w", "A_log", "D_skip"):
            return a
        return jnp.asarray(rng.normal(0, SSM_SCALE, a.shape).astype(
            np.float32)).astype(a.dtype)

    return cfg, model, jax.tree_util.tree_map_with_path(draw, params), rng


def share(lg, fwd):
    lg, fwd = np.asarray(lg, np.float32), np.asarray(fwd, np.float32)
    return float(np.abs(lg - fwd).max() / np.abs(fwd).max())


def reference_drift(cfg, model, params, toks, prompt=PROMPT):
    par = Parallelism(remat=False)
    step = jax.jit(lambda c, t, p: model.decode_step(params, c, t, p, par))
    fwd = jax.jit(lambda t: jlogits_fn(params, model.forward(
        params, {"tokens": t}, par)[0][:, -1:], cfg, par))
    n = toks.shape[1]
    cache, _ = model.prefill(params, {"tokens": jnp.asarray(
        toks[:, :prompt], jnp.int32)}, par, S_max=n)
    out = []
    for pos in range(prompt, n):
        lg, cache = step(cache, jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                         jnp.int32(pos))
        want = fwd(jnp.asarray(toks[:, :pos + 1], jnp.int32))
        out.append(share(lg.astype(jnp.float32), want.astype(jnp.float32)))
    return out


def port_drift(params, toks, deep=False, prompt=PROMPT, stale=False):
    """The port's drift; with `stale`, of a planted fault: the SSM state
    zeroed before each step (not carried), as `chip_smoke.py` plants it."""
    cfg = (replace(get_config(ARCH), **DEEP) if deep
           else get_config(ARCH, smoke=True))
    tree = jax.tree.map(np.asarray, params)
    model = build_model(cfg, lm_params_from_numpy(cfg, tree, device="cpu"))
    n = toks.shape[1]
    cache, _ = model.prefill(torch.as_tensor(toks[:, :prompt]), n)
    out = []
    with torch.no_grad():
        for pos in range(prompt, n):
            if stale:
                for c in cache["blocks"]:
                    c["ssm_h"].zero_()
            lg, cache = model.decode_step(
                cache, torch.as_tensor(toks[:, pos:pos + 1]), pos)
            want = model.logits(model(torch.as_tensor(toks[:, :pos + 1]))
                                [:, -1:])
            out.append(share(lg.float().numpy(), want.float().numpy()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--deep", action="store_true",
                    help="hymba-1.5b's depth at d_model 320, its init, "
                         "chip_smoke.py's traffic")
    args = ap.parse_args()
    for seed in args.seeds:
        cfg, model, params, rng = weights(seed, args.deep)
        if args.deep:       # 8 requests of 4-15 tokens, 8 steps each
            runs = [(rng.integers(1, cfg.vocab, (1, p + 8)), p) for p in
                    (int(rng.integers(4, 16)) for _ in range(8))]
            what = "8 requests of 4-15 tokens, 8 steps each"
        else:
            runs = [(rng.integers(1, cfg.vocab, (2, PROMPT + STEPS)),
                     PROMPT)]
            what = f"{STEPS} steps after a {PROMPT}-token prefill"
        for name, fn in (("reference", lambda t, p: reference_drift(
                              cfg, model, params, t, p)),
                         ("port", lambda t, p: port_drift(
                              params, t, args.deep, p)),
                         ("port, SSM state not carried (a planted fault)",
                          lambda t, p: port_drift(params, t, args.deep, p,
                                                  stale=True))):
            d = [x for toks, p in runs for x in fn(toks, p)]
            print(f"seed {seed} {name} ({cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}): decode against forward, {what}: "
                  f"{min(d):.4e} to {max(d):.4e} of the largest |logit|",
                  flush=True)


if __name__ == "__main__":
    main()
