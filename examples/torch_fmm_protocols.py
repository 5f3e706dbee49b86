"""Compare the paper's four LET-exchange protocols on one problem, with the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_fmm_protocols.py                # the card
    PYTHONPATH=src python examples/torch_fmm_protocols.py --device cpu

The port's counterpart of examples/fmm_protocols.py.  One `FMMSession` plans
the geometry once (partitioning, local trees, LET extraction, receiver
traversals) and `sweep()` answers every protocol from that single
`GeometryPlan`: the potential is evaluated once and shared; only the
communication schedules differ.  Prints the Table-2/Fig-7 accounting
(stages, messages, wire bytes, relay factor, LogGP model time per protocol)
for a sphere distribution under hybrid-ORB partitioning.

The exchange then runs as real collective programs (`repro_torch.core.
dist`) over 4 ranks stacked on the device (`launch.mesh.stacked_mesh`;
`group_mesh` takes a `torch.distributed` group instead): bulk, grain and
hsdx, each against the single-device potential.  With tracing on
(`REPRO_TRACE=1`, or `repro_torch.obs.configure(enabled=True)`),
`session.report()` adds each protocol's measured exchange beside its LogGP
prediction.  Last, a resilient session absorbs an injected fault of the
compiled evaluate by dropping one rung of the degradation ladder.
"""
import argparse
import warnings

import numpy as np

from repro_torch import obs
from repro_torch.core.api import FMMSession, PartitionSpec
from repro_torch.core.distributions import make_distribution
from repro_torch.core.fmm import direct_potential
from repro_torch.core.protocols import PROTOCOLS
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import stacked_mesh
from repro_torch.resilience import inject_faults

RANKS = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, nparts = 4000, 8
    x = make_distribution("sphere", n, seed=1)
    q = np.ones(n) / n
    sess = FMMSession.from_points(x, q, PartitionSpec(nparts=nparts,
                                                      method="orb"),
                                  device=dev)
    sweep = sess.sweep()
    print(f"{'protocol':<12}{'stages':>7}{'msgs':>7}{'wire MB':>9}"
          f"{'relay':>7}{'LogGP ms':>10}")
    for name in PROTOCOLS:
        res = sweep[name]
        st = res.schedule_stats
        print(f"{name:<12}{res.n_stages:>7}{st['n_msgs']:>7}"
              f"{st['wire_bytes']/1e6:>9.2f}{st['relay_factor']:>7.2f}"
              f"{res.loggp_time*1e3:>10.3f}")
    # every protocol delivered a schedule over the same LET volume, and the
    # shared potential matches the O(N^2) direct oracle
    phi = sweep[PROTOCOLS[0]].phi
    ref = direct_potential(x, q, device=dev)
    err = np.linalg.norm(phi - ref) / np.linalg.norm(ref)
    assert err < 3e-3, err
    print("all protocols served from one GeometryPlan "
          f"({sess.memo.misses} device uploads; rel L2 vs direct {err:.2e})")

    # --- the exchange as collective programs, ranks stacked on the device --
    mesh = stacked_mesh(RANKS, dev)
    for proto_name in ("bulk", "grain", "hsdx"):
        dsess = FMMSession(sess.geometry, device=dev, mesh=mesh,
                           dist_protocol=proto_name)
        dphi = dsess.evaluate()
        st = dsess.exchange_stats
        ok = np.allclose(dphi, phi, rtol=1e-6, atol=2e-5)
        assert ok, proto_name
        print(f"dist {proto_name:<6} D={RANKS} rounds={st['n_rounds']:>2}"
              f" moved={st['moved_bytes']/1e6:.3f}MB"
              f" delivered={st['delivered_bytes']/1e6:.3f}MB"
              f" parity={ok}")
    # flight recorder: measured exchange against the LogGP model, one call
    if obs.enabled():
        rep = FMMSession(sess.geometry, device=dev, mesh=mesh).report()
        for proto_name, st in rep["exchange"]["protocols"].items():
            print(f"drift {proto_name:<6}"
                  f" measured={st['measured_s']*1e3:.3f}ms"
                  f" loggp={st['loggp_s']*1e3:.3f}ms"
                  f" model_drift={st['model_drift']:.2f}")
    else:
        print("(REPRO_TRACE=1 adds measured-vs-LogGP model_drift via "
              "session.report())")

    # --- resilience: inject a fault, watch the ladder absorb it -----------
    # A resilient session walks the degradation ladder (dist -> streaming
    # -> gathered -> per_phase -> reference) instead of raising: here the
    # compiled evaluate's launch is killed with a simulated
    # RESOURCE_EXHAUSTED, the session drops one rung, recomputes, and
    # reports the downgrade.  `REPRO_FAULTS="fused.launch:1"` arms the same
    # plan from the environment; `REPRO_RESILIENCE=1` turns the ladder on.
    rsess = FMMSession(sess.geometry, device=dev, engine=True, fused=True,
                       p2p_stream=False, resilience=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with inject_faults("fused.launch"):
            rphi = rsess.evaluate()
    blk = rsess.report()["resilience"]
    fb = blk["fallbacks"][0]
    assert np.allclose(rphi, phi, rtol=1e-6, atol=2e-5)
    print(f"chaos: killed {fb['site']} -> degraded {fb['from']!r} to "
          f"{fb['to']!r}, phi parity kept "
          f"(degraded={blk['degraded']}, rung={blk['rung']})")
    return err


if __name__ == "__main__":
    main()
