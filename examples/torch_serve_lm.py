"""Batched serving with the PyTorch/CUDA port: continuous batching with
prefill + decode.

    PYTHONPATH=src python examples/torch_serve_lm.py                # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The port's counterpart of examples/serve_lm.py: the qwen3-0.6b smoke model
with random weights (seed 0), 6 requests through 4 slots of a
`ServeEngine` (prefill through the CUDA kernel K4 on the card, the decode
step one CUDA graph replay there).  `--arch` takes any architecture that
prefills from tokens alone (`repro_torch.launch.serve` lists them).
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg, seed=0, device=dev)
    engine = ServeEngine(model, B=4, S_max=96)

    rng = np.random.default_rng(0)
    for rid in range(6):                      # 6 requests > 4 slots: queueing
        plen = int(rng.integers(4, 12))
        engine.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
            1, cfg.vocab, plen)], max_new=8))
    finished = engine.run(max_steps=64)
    for r in sorted(finished, key=lambda r: r.rid):
        print(f"request {r.rid}: prompt_len={len(r.prompt)} -> {r.out}")
    assert len(finished) >= 4
    print(f"OK — served {len(finished)} requests through 4 slots on {dev}")
    return finished


if __name__ == "__main__":
    main()
