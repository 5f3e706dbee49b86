"""Quickstart of the PyTorch/CUDA port: solve an N-body boundary problem with
the distributed FMM.

    PYTHONPATH=src python examples/torch_quickstart.py                # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's counterpart of examples/quickstart.py: partitions a spherical
*boundary* distribution (the paper's target workload) with hybrid ORB,
schedules the LET exchange with HSDX, evaluates the potential (the near
field through the CUDA kernel K1 on the card, its plain version on the CPU)
and checks it against the O(N^2) direct sum.
"""
import argparse
import warnings

import numpy as np

from repro_torch.core.distributed_fmm import run_distributed_fmm
from repro_torch.core.distributions import make_distribution
from repro_torch.core.fmm import direct_potential
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, nparts = 4000, 8
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)

    with warnings.catch_warnings():     # the legacy entry point warns once
        warnings.simplefilter("ignore", DeprecationWarning)
        res = run_distributed_fmm(x, q, nparts=nparts, method="orb",
                                  protocol="hsdx", theta=0.5, ncrit=64,
                                  device=dev)
    ref = direct_potential(x, q, device=dev)
    err = np.linalg.norm(res.phi - ref) / np.linalg.norm(ref)

    print(f"N={n} particles on a sphere, {nparts} partitions (hybrid ORB), "
          f"on {dev}")
    print(f"rel. L2 error vs direct sum : {err:.2e}  (P=4 Cartesian, theta=0.5)")
    print(f"LET volume                  : {res.bytes_matrix.sum()/1e6:.2f} MB total")
    print(f"HSDX stages                 : {res.n_stages} "
          f"(adjacency degree max {res.adjacency_degree:.0f}, diameter {res.diameter})")
    st = res.schedule_stats
    print(f"messages                    : {st['n_msgs']} "
          f"(relay factor {st['relay_factor']:.2f})")
    print(f"LogGP time model            : {res.loggp_time*1e3:.2f} ms")
    assert err < 3e-3, err
    print("OK")
    return err


if __name__ == "__main__":
    main()
