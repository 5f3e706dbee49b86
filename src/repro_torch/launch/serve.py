"""Serving CLI: continuous batching over the decode path, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 8 --slots 4 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu

`--arch` takes the architectures `repro_torch.configs.list_archs()` names
that prefill from tokens alone: qwen3-0.6b (the default), phi4-mini-3.8b,
smollm-360m, gemma3-12b (sliding-window superblocks with ring caches),
hymba-1.5b (attention and SSM heads), dbrx-132b and llama4-scout-17b-a16e
(MoE; at full depth neither fits one 80 GB card) and rwkv6-1.6b.  The
engine prefills tokens only, as the reference's does, so it refuses
seamless-m4t-medium and llama-3.2-vision-90b, whose prefill needs frame or
patch embeddings (serve them through `Model.prefill` and `decode_step`).
Weights are random, drawn from a generator seeded with 0.
`--model-ranks N` serves them tensor parallel on N model ranks stacked on
the device (a (data 1, model N) mesh; the engine's `par=`, the weights as
`models.tp.shard_model`'s blocks).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import build_model
from repro_torch.models.tp import shard_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sharding.parallel import Parallelism


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="one of repro_torch.configs.list_archs()")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="model ranks stacked on the device (tensor "
                         "parallel; 1: no mesh)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encdec or cfg.family == "vlm":
        ap.error(f"{args.arch} prefills from frame or patch embeddings "
                 f"beside its tokens; the engine prefills tokens only: serve "
                 f"it through Model.prefill and Model.decode_step")
    dev = resolve_device(args.device)
    model = build_model(cfg, seed=0, device=dev)
    par = Parallelism(remat=False)
    if args.model_ranks > 1:
        mesh = make_mesh_compat((1, args.model_ranks), ("data", "model"),
                                dev)
        par = Parallelism(mesh=mesh, data_axes=("data",),
                          model_axis="model", remat=False)
        model = build_model(cfg, shard_model(model.params, cfg, mesh))
    engine = ServeEngine(model, B=args.slots, S_max=args.s_max, par=par)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 16))
        engine.submit(Request(rid=rid,
                              prompt=[int(t) for t in
                                      rng.integers(1, cfg.vocab, plen)],
                              max_new=args.max_new))
    t0 = time.perf_counter()
    done = engine.run(max_steps=args.s_max)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s through {args.slots} slots) on {where}")
    return done


if __name__ == "__main__":
    main()
