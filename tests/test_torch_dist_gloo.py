"""The port's multi-rank engine over `torch.distributed`: one rank per
process on a gloo group, against the same ranks stacked in one process.

Four worker processes (the script below, which imports `torch` and
`repro_torch` only) join a gloo group through a file under `tmp_path`,
evaluate both reference geometries with every protocol through
`FMMSession(mesh=group_mesh(device="cpu"))`, and save their potentials and
their exchanged pools.  Every rank runs the same float32 operations on the
same inputs as its stacked counterpart, so the potentials and every pool
word (the trash slot aside, whose value is undefined) must be equal bit for
bit; each worker also records that it loaded no JAX and no `repro`.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
from repro_torch.core.dist import DIST_PROTOCOLS
from repro_torch.launch.mesh import stacked_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
    from repro_torch.launch.mesh import group_mesh

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    spec = PartitionSpec(nparts=8, method="morton", ncrit=64)
    res = {}
    data = np.load(f"{out}/inputs.npz")
    for case in ("slab", "clustered"):
        geo = plan_geometry(data[f"{case}_x"], data[f"{case}_q"], spec,
                            device="cpu")
        mesh = group_mesh(device="cpu")
        for p in ("bulk", "grain", "hsdx"):
            sess = FMMSession(geo, device="cpu", mesh=mesh, dist_protocol=p)
            res[f"{case}_phi_{p}"] = sess.evaluate()
            packed, exchanged = sess.dist.exchange_pools(p)
            res[f"{case}_packed_{p}"] = packed
            res[f"{case}_exchanged_{p}"] = exchanged
            res[f"{case}_spans_{p}"] = sess.dist.verify_exchange(p)
    res["loaded"] = np.array(sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "jaxlib", "repro."))), dtype=str)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""").strip()


def _inputs():
    rng = np.random.default_rng(3)
    slab_x = rng.uniform(0, 1, (800, 3))
    slab_x[:, 0] *= 4.0
    slab_q = rng.uniform(-1, 1, 800)
    pts = np.array([[.1, .1, .1], [.8, .2, .3], [.3, .9, .5],
                    [.6, .6, .9], [.9, .9, .1]])
    cl_x = np.repeat(pts, 60, axis=0)
    cl_q = np.random.default_rng(1).uniform(-1, 1, len(cl_x))
    return dict(slab_x=slab_x, slab_q=slab_q, clustered_x=cl_x,
                clustered_q=cl_q)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Run the four workers; returns (inputs, [rank results])."""
    out = tmp_path_factory.mktemp("gloo")
    inputs = _inputs()
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD),
         f"file://{out}/rendezvous", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, "\n".join(errs)
    return inputs, [dict(np.load(out / f"rank{r}.npz"))
                    for r in range(WORLD)]


def test_workers_load_no_jax_or_reference(gloo_run):
    for res in gloo_run[1]:
        assert res["loaded"].size == 0, res["loaded"]


@pytest.mark.parametrize("case", ["slab", "clustered"])
@pytest.mark.parametrize("protocol", DIST_PROTOCOLS)
def test_gloo_route_equals_stacked_route_bit_for_bit(gloo_run, case,
                                                     protocol):
    inputs, results = gloo_run
    geo = plan_geometry(inputs[f"{case}_x"], inputs[f"{case}_q"],
                        PartitionSpec(nparts=8, method="morton", ncrit=64),
                        device="cpu")
    sess = FMMSession(geo, device="cpu", mesh=stacked_mesh(WORLD, "cpu"),
                      dist_protocol=protocol)
    phi = sess.evaluate()
    packed, exchanged = sess.dist.exchange_pools(protocol)
    spans = len(sess.dist.layout.pairs)
    for res in results:
        np.testing.assert_array_equal(res[f"{case}_phi_{protocol}"], phi)
        np.testing.assert_array_equal(
            res[f"{case}_packed_{protocol}"][:, :-1], packed[:, :-1])
        np.testing.assert_array_equal(
            res[f"{case}_exchanged_{protocol}"][:, :-1], exchanged[:, :-1])
        assert int(res[f"{case}_spans_{protocol}"]) == spans > 0
