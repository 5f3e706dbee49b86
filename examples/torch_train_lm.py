"""End-to-end driver of the port: train a ~360M-param LM for a few hundred
steps, on the card (`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300   # 360M
    PYTHONPATH=src python examples/torch_train_lm.py --steps 60 --smoke

The counterpart of examples/train_lm.py: the synthetic deterministic data
pipeline, AdamW with float32 master weights, K4 in every forward and its
gradient in every backward, a checkpoint every 50 steps with
restart-on-relaunch (kill it mid-run and run again to see the resume).
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    out = run("smollm-360m", smoke=args.smoke, steps=args.steps,
              batch=8 if args.smoke else 4, seq=64 if args.smoke else 512,
              ckpt_dir=args.ckpt_dir, ckpt_every=50,
              lr=3e-3 if args.smoke else 3e-4, device=args.device)
    print(f"final loss {out['final_loss']:.4f} over {args.steps} steps "
          f"({out['stragglers']} straggler steps)")


if __name__ == "__main__":
    main()
