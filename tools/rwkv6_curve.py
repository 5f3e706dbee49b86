#!/usr/bin/env python3
"""rwkv6's training loss curve under two learning-rate schedules.

    python3 tools/rwkv6_curve.py                      # rwkv6-1.6b on the card
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/rwkv6_curve.py \\
        --smoke --device cpu --reference              # smoke, both packages

Trains rwkv6 with the port's train step (`train.train_step`) for --steps
steps of `SyntheticLM(seed=0)` batches, batch --batch x --seq, lr --lr,
once under each schedule of --warmups (AdamWConfig(warmup=w, total_steps=
--total)), from the same weights each time, and prints each step's loss and
grad norm.  warmup 1 of total_steps 10 is what `launch.train.run` gives a
3-step run (chip_smoke.py phase 11 (d)): the first update takes the full
rate.  On the card the weights are `init_weights(cfg, seed=0)`; the card
and its power limit are printed beside the numbers.

`--reference` (CPU only; needs JAX) starts from the reference's own init
carried across by `convert` and runs the reference's train step
(`repro.train.train_step`) beside the port's on the same batches, printing
both curves and their largest relative difference.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import init_weights  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ARCH = "rwkv6-1.6b"


def port_curve(cfg, params, steps, batch, seq, opt_cfg, dev):
    """(losses, grad norms) of `steps` port train steps from `params`."""
    ptree = map_tree(lambda t: t.detach().clone().requires_grad_(), params)
    step = make_train_step(cfg, opt_cfg)
    opt = topt.init_opt_state(ptree)
    data = SyntheticLM(cfg.vocab, seq, batch, seed=0)
    out = []
    for _ in range(steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in data.next_batch().items()}
        ptree, opt, m = step(ptree, opt, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    del ptree, opt
    return np.array(out)


def reference_curve(jcfg, jmodel, params, steps, batch, seq, kw):
    import jax
    import jax.numpy as jnp
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.sharding.parallel import Parallelism
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step as jmake
    jstep = jax.jit(jmake(jmodel, Parallelism(remat=False),
                          jopt.AdamWConfig(**kw)))
    opt = jopt.init_opt_state(params)
    data = JSyntheticLM(jcfg.vocab, seq, batch, seed=0)
    out = []
    for _ in range(steps):
        b = {k: jnp.asarray(v) for k, v in data.next_batch().items()}
        params, opt, m = jstep(params, opt, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return np.array(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="override the config's dtype (e.g. float32)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--total", type=int, default=10)
    ap.add_argument("--warmups", type=int, nargs="+", default=[1, 3])
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("rwkv6_curve: no CUDA device available", file=sys.stderr)
        return 2
    if args.reference and dev.type != "cpu":
        print("rwkv6_curve: --reference runs on the CPU only",
              file=sys.stderr)
        return 2
    cfg = get_config(ARCH, smoke=args.smoke)
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}; batch {args.batch} x {args.seq}, lr "
          f"{args.lr}, {args.steps} steps; device {card}", flush=True)
    if args.reference:
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config as jget_config
        from repro.models import build_model as jbuild_model
        jcfg = replace(jget_config(ARCH, smoke=args.smoke), dtype=cfg.dtype)
        jmodel = jbuild_model(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        if cfg.dtype == "float32":
            jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                      dev)
    else:
        params = init_weights(cfg, seed=0, device=dev)
    for w in args.warmups:
        kw = dict(lr=args.lr, warmup=w, total_steps=args.total)
        t0 = time.perf_counter()
        got = port_curve(cfg, params, args.steps, args.batch, args.seq,
                         topt.AdamWConfig(**kw), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        print(f"  warmup {w} of total_steps {args.total}: port losses "
              f"{np.round(got[:, 0], 5).tolist()}; grad norms "
              f"{np.round(got[:, 1], 3).tolist()}; {wall:.2f} s; device "
              f"{card}", flush=True)
        if not np.isfinite(got).all():
            print(f"rwkv6_curve: non-finite loss or grad norm at warmup {w}",
                  file=sys.stderr)
            return 1
        if args.reference:
            want = reference_curve(jcfg, jmodel, jparams, args.steps,
                                   args.batch, args.seq, kw)
            rel = np.abs(got - want) / np.abs(want)
            print(f"  warmup {w}: reference losses "
                  f"{np.round(want[:, 0], 5).tolist()}; grad norms "
                  f"{np.round(want[:, 1], 3).tolist()}; largest relative "
                  f"difference, loss {np.nanmax(rel[:, 0]):.3e}, grad norm "
                  f"{np.nanmax(rel[:, 1]):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
