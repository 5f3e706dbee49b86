#!/usr/bin/env python3
"""How far the model ranks' bfloat16 program sits from one card's, and
both from the same weights in float32, on the CPU.

    PYTHONPATH=src python3 tools/tp_bf16_drift.py --arch rwkv6-1.6b \
        --layers 4 [--ranks 4] [--tokens 16] [--seed 0]

The rank program of `models.tp` adds each rank's bfloat16 partial sums
(the row-parallel products' outputs, as the reference's GSPMD program
reduces its dots in their type) where one card's products round once, so
the two bfloat16 programs differ by the model's own bfloat16 noise.  For
`--arch` at full width and `--layers` layers (the init `init_weights(cfg,
seed)`), a forward over one prompt of `--tokens` tokens: one card in
bfloat16, `--ranks` model ranks stacked in bfloat16, and both in float32
from the same weights.  Prints each one's largest |logit - float32 one
card's| as a share of the latter's largest |logit|.  `chip_smoke.py`
holds the ranks against one card at TP_NOISE_RATIO times one card's own
distance from float32 for the reason these figures give.  About a minute
at 4 layers of rwkv6-1.6b (a few GB of memory).
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import build_model, init_weights
from repro_torch.models import tp as tpm
from repro_torch.models.params import map_tree
from repro_torch.sharding.parallel import Parallelism


def logits(cfg, params, toks, par=None):
    model = build_model(cfg, params)
    kw = {} if par is None else {"par": par}
    h = model(toks, **kw)
    lg = model.logits(h, par) if par is not None else model.logits(h)
    return lg[0, :, :cfg.vocab].float()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = replace(get_config(args.arch), n_layers=args.layers)
    f32 = replace(cfg, dtype="float32")
    params = init_weights(cfg, seed=args.seed, device="cpu")
    p32 = map_tree(lambda t: t.float(), params)
    mesh = make_mesh_compat((1, args.ranks), ("data", "model"), "cpu")
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                      remat=False)
    toks = torch.randint(1, cfg.vocab, (1, args.tokens),
                         generator=torch.Generator().manual_seed(args.seed))
    with torch.no_grad():
        ref = logits(f32, p32, toks)
        runs = {
            "one card, bfloat16": logits(cfg, params, toks),
            f"{args.ranks} ranks, bfloat16": logits(
                cfg, tpm.shard_model(params, cfg, mesh), toks, par),
            f"{args.ranks} ranks, float32": logits(
                f32, tpm.shard_model(p32, f32, mesh), toks, par)}
    scale = float(ref.abs().max())
    print(f"{args.arch}, {args.layers} layers at full width, "
          f"{args.tokens} tokens, seed {args.seed}: the float32 one card's "
          f"largest |logit| {scale:.4f}")
    for label, lg in runs.items():
        print(f"  {label}: {float((lg - ref).abs().max()) / scale:.4e} of "
              f"it from the float32 one card")
    a, b = list(runs.values())[:2]
    print(f"  the two bfloat16 programs apart: "
          f"{float((a - b).abs().max()) / scale:.4e}")


if __name__ == "__main__":
    main()
