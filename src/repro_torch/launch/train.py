"""Fault-tolerant training driver, the reference's `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 50 --batch 4 --seq 512 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 30 --device cpu [--simulate-failure-at 20]

It trains on the card unless `--device` / `device=` says otherwise; it
never moves to the CPU on its own.
  - checkpoint/restart: atomic saves every --ckpt-every steps (and at the
    end), in the reference's format; on start the driver resumes from the
    latest step (params, optimizer state, data cursor);
  - straggler mitigation: a per-step deadline; steps that exceed it are
    logged and counted;
  - failure injection: --simulate-failure-at N raises at step N, so the
    restart path stays tested.
Weights start from `init_weights(cfg, seed=seed)` (a seeded
`torch.Generator` on the device); data is `SyntheticLM(seed=seed)`.  The
step runs under `par` (default: the reference's `Parallelism(remat=
False)`, no mesh); a `Parallelism` over a mesh makes it data parallel
over its data axes (`train.train_step`, the batch split over its data
ranks) and tensor parallel over its model axis: the weights and the
optimizer state are then the blocks and FSDP cuts the ranks hold
(`models.tp.shard_model`), and the checkpoints hold whole leaves (put
together on save, cut on load).  `--model-ranks N` stacks N model ranks
on the device (a (data 1, model N) mesh, remat on).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import init_weights, weight_structs
from repro_torch.models import tp as tp_mod
from repro_torch.models.params import map_tree, shard_params
from repro_torch.sharding.parallel import Parallelism
from repro_torch.train.optimizer import (AdamWConfig, OptState,
                                        init_opt_state)
from repro_torch.train.train_step import make_train_step

__all__ = ["run", "main"]


def run(arch: str, smoke: bool, steps: int, batch: int, seq: int,
        ckpt_dir: str, ckpt_every: int = 20, lr: float = 3e-4,
        simulate_failure_at: int | None = None, n_micro: int = 1,
        step_deadline_s: float = 120.0, log_every: int = 5,
        seed: int = 0, device=None, par: Parallelism | None = None) -> dict:
    """Train `arch` for `steps` steps (resuming from `ckpt_dir`'s latest
    step when there is one).  Returns {"losses", "grad_norms",
    "step_s", "stragglers", "final_loss"}, the lists over the steps this
    call ran."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    opt_cfg = AdamWConfig(lr=lr, total_steps=max(steps, 10),
                          warmup=min(20, steps // 5 + 1))
    par = Parallelism(remat=False) if par is None else par
    train_step = make_train_step(cfg, opt_cfg, n_micro=n_micro, par=par)

    sh = None
    if tp_mod.plan(cfg, par) is not None:
        sh = tp_mod.par_shardings(cfg, par)
    sh_state = None if sh is None else {
        "params": sh, "opt": OptState(sh, sh, sh, None)}

    def placed(tree):
        """A whole tree as the blocks and cuts `par`'s ranks run on."""
        return tree if sh is None else shard_params(tree, sh)

    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    start = 0
    last = latest_step(ckpt_dir) if ckpt_dir else None
    if last is not None:
        like = weight_structs(cfg)
        like = {"params": like, "opt": init_opt_state(like)}
        state, extra = load_checkpoint(ckpt_dir, last, like, device=dev,
                                       shardings=sh_state)
        params = map_tree(lambda p: p.requires_grad_(), state["params"])
        opt_state = state["opt"]
        data.restore(extra["data"])
        start = last
        print(f"[train] resumed from step {start}")
    else:
        params = map_tree(lambda t: t.requires_grad_(), placed(
            init_weights(cfg, seed=seed, device=dev)))
        opt_state = init_opt_state(params)

    losses, gnorms, times, stragglers = [], [], [], 0
    for step in range(start, steps):
        if simulate_failure_at is not None and step == simulate_failure_at:
            raise RuntimeError(f"simulated node failure at step {step}")
        t0 = time.time()
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in data.next_batch().items()}
        params, opt_state, metrics = train_step(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if dt > step_deadline_s:
            stragglers += 1
            print(f"[train] step {step}: STRAGGLER {dt:.1f}s > "
                  f"{step_deadline_s}s")
        losses.append(loss)
        gnorms.append(metrics["grad_norm"])
        times.append(dt)
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            extra={"data": data.snapshot()},
                            shardings=sh_state)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, {"params": params, "opt": opt_state},
                        extra={"data": data.snapshot()}, shardings=sh_state)
    return {"losses": losses, "grad_norms": [float(g) for g in gnorms],
            "step_s": times, "stragglers": stragglers,
            "final_loss": losses[-1] if losses else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="model ranks stacked on the device (tensor "
                         "parallel; 1: no mesh)")
    args = ap.parse_args(argv)
    par = None
    if args.model_ranks > 1:
        mesh = make_mesh_compat((1, args.model_ranks), ("data", "model"),
                                resolve_device(args.device))
        par = Parallelism(mesh=mesh, data_axes=("data",),
                          model_axis="model")
    out = run(args.arch, args.smoke, args.steps, args.batch, args.seq,
              args.ckpt_dir, args.ckpt_every, args.lr,
              args.simulate_failure_at, args.n_micro, device=args.device,
              par=par)
    print(json.dumps({"final_loss": out["final_loss"],
                      "stragglers": out["stragglers"]}))


if __name__ == "__main__":
    main()
