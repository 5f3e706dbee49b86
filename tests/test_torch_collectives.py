"""The port's collectives (`repro_torch.core.collectives`) and the named
meshes' axis collectives (`core.dist.comm`), against the JAX reference's
`repro.core.collectives` on the same inputs, and the stacked mesh against
a gloo group, on the CPU.

The reference runs once, in a subprocess with 8 virtual host devices (as
tests/test_collectives.py runs it), on that test's inputs and on random
float32 ones.  The port's functions run on the same meshes with ranks
stacked in this process.  The rings add in the reference's hop order, so
their outputs are equal to the reference's bit for bit, as are every pure
data movement (gathers, all-to-alls, ppermutes).  (The reference runs as
one jitted program, so every input is made in NumPy: XLA would contract
a product into a ring's first add.)  The reference's
`hierarchical_all_reduce` sums inside XLA's psum_scatter / psum, whose
order is its own, and the overlapped matmul multiplies in XLA: those are
held at rtol 1e-6 (atol 1e-4 for the matmul, the reference test's).

Four gloo processes (a script importing `torch` and `repro_torch` only)
run the seven functions on 4-rank meshes, one rank each; every sum adds
in group order on both meshes, so their outputs equal the stacked mesh's
bit for bit.  The file takes about 10 s on the CPU.
"""
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.launch.mesh import make_mesh_compat

from test_torch_dist_gloo import run_side_by_side

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.core import collectives as C
    from repro.launch.mesh import make_mesh_compat as make_mesh

    mesh = make_mesh((8,), ("proc",))
    mesh2 = make_mesh((2, 4), ("pod", "data"))

    def sm(fn, m, i, o):
        return shard_map(fn, mesh=m, in_specs=i, out_specs=o)

    def run(inp):      # one program: one compile
        out = {}
        for tag in ("int", "rnd"):
            x, y, w = inp[f"x_{tag}"], inp[f"y_{tag}"], inp[f"w_{tag}"]
            out[f"rag_{tag}"] = sm(lambda s: C.ring_all_gather(s, "proc"),
                                   mesh, P("proc"), P("proc"))(x)
            out[f"ragr_{tag}"] = sm(lambda s: C.ring_all_gather(
                s, "proc", reverse=True), mesh, P("proc"), P("proc"))(x)
            out[f"rrs_{tag}"] = sm(lambda s: C.ring_reduce_scatter(
                s, "proc"), mesh, P(None), P("proc"))(x)
            out[f"rrs_full_{tag}"] = sm(lambda s: C.ring_reduce_scatter(
                s, "proc"), mesh, P("proc"), P("proc"))(inp[f"x8_{tag}"])
            out[f"har_{tag}"] = sm(lambda s: C.hierarchical_all_reduce(
                s, "data", "pod"), mesh2, P(("pod", "data")),
                P(("pod", "data")))(y)
            out[f"agm_{tag}"] = sm(lambda s: C.all_gather_matmul_overlapped(
                s, w, "proc"), mesh, P("proc"), P("proc"))(x)
        out["a2a2"] = sm(lambda s: C.two_stage_all_to_all(
            s[0], "data", "pod")[None], mesh2, P(("pod", "data")),
            P(("pod", "data")))(inp["z"])
        out["nbr"] = sm(lambda s: C.neighbor_exchange(s, "proc", 1), mesh,
                        P("proc"), P("proc"))(inp["nb"])
        out["nbr3"] = sm(lambda s: C.neighbor_exchange(s, "proc", 3), mesh,
                         P("proc"), P("proc"))(inp["nb"])
        out["hsdx"] = sm(lambda s: C.hsdx_grid_exchange(
            s[0], "proc", (2, 2, 2), stages=2)[None], mesh, P("proc"),
            P("proc"))(inp["hs"])
        return out

    inp = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    out = jax.jit(run)(inp)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""").strip()

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import make_group_mesh

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    inp = {k: torch.as_tensor(v) for k, v in
           np.load(f"{out}/inputs.npz").items()}
    flat = make_group_mesh((4,), ("proc",), device="cpu")
    two = make_group_mesh((2, 2), ("pod", "data"), device="cpu")
    mine = lambda k: inp[k][rank:rank + 1]
    res = {}
    for name, fn in RUNS.items():
        res[name] = fn(mine, flat, two).numpy()
    res["loaded"] = np.array(sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "jaxlib", "repro."))), dtype=str)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""").strip()

# the seven functions on 4-rank meshes, each given its rank's inputs
# through `mine` (a stacked mesh passes every rank's): the same code runs
# in the workers (its source is sent with them) and in this process
_RUNS = textwrap.dedent("""
    RUNS = {
        "rag": lambda mine, flat, two: C.ring_all_gather(
            mine("a"), flat, "proc"),
        "ragr": lambda mine, flat, two: C.ring_all_gather(
            mine("a"), flat, "proc", reverse=True),
        "rrs": lambda mine, flat, two: C.ring_reduce_scatter(
            mine("b"), flat, "proc"),
        "har": lambda mine, flat, two: C.hierarchical_all_reduce(
            mine("c"), two, "data", "pod"),
        "flat": lambda mine, flat, two: C.hierarchical_all_reduce(
            mine("c"), two, ("pod", "data"), None),
        "a2a2": lambda mine, flat, two: C.two_stage_all_to_all(
            mine("d"), two, "data", "pod", split_axis=1, concat_axis=1),
        "agm": lambda mine, flat, two: C.all_gather_matmul_overlapped(
            mine("a"), mine("w")[0], flat, "proc"),
        "nbr": lambda mine, flat, two: C.neighbor_exchange(
            mine("a"), flat, "proc", 3),
        "hsdx": lambda mine, flat, two: C.hsdx_grid_exchange(
            mine("a"), flat, "proc", (1, 2, 2), stages=2),
    }
""").strip()
exec(_RUNS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and the four gloo workers' results, the
    five processes run side by side."""
    out = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    ref_in = {"x_int": np.arange(8 * 4 * 3, dtype=np.float32).reshape(32, 3),
              "y_int": np.arange(8 * 5, dtype=np.float32).reshape(8, 5),
              "w_int": np.arange(3 * 7, dtype=np.float32).reshape(3, 7) / 10,
              "x_rnd": rng.normal(size=(32, 3)).astype(np.float32),
              "y_rnd": rng.normal(size=(8, 5)).astype(np.float32),
              "w_rnd": rng.normal(size=(3, 7)).astype(np.float32),
              "z": np.arange(8 * 8 * 2, dtype=np.float32).reshape(8, 8, 2),
              "nb": np.arange(8.0, dtype=np.float32)[:, None],
              "hs": (np.eye(8, dtype=np.float32)[:, None, :]
                     + 0.01 * rng.normal(size=(8, 1, 8)).astype(np.float32))}
    for tag in ("int", "rnd"):    # rank r's buffer: (r + 1) x
        ref_in[f"x8_{tag}"] = np.concatenate([ref_in[f"x_{tag}"] * (r + 1)
                                              for r in range(8)])
    np.savez(out / "ref_in.npz", **ref_in)
    gl_in = {"a": rng.normal(size=(4, 3, 5)), "b": rng.normal(size=(4, 8, 3)),
             "c": rng.normal(size=(4, 7, 3)),
             "d": rng.normal(size=(4, 2, 8, 3)),
             "w": np.repeat(rng.normal(size=(1, 5, 6)), 4, 0)}
    gl_in = {k: v.astype(np.float32) for k, v in gl_in.items()}
    np.savez(out / "inputs.npz", **gl_in)
    run_side_by_side(
        [[sys.executable, "-c", _REFERENCE, str(out / "ref_in.npz"),
          str(out / "ref_out.npz")]]
        + [[sys.executable, "-c", _WORKER.replace("res = {}",
                                                  _RUNS + "\nres = {}"),
            str(r), "4", f"file://{out}/rendezvous", str(out)]
           for r in range(4)], timeout=300, JAX_PLATFORMS="cpu")
    return (ref_in, dict(np.load(out / "ref_out.npz")), gl_in,
            [dict(np.load(out / f"rank{r}.npz")) for r in range(4)])


def _stacked(shape, axes):
    return make_mesh_compat(shape, axes, "cpu")


@pytest.mark.parametrize("tag", ["int", "rnd"])
def test_rings_equal_reference_bit_for_bit(runs, tag):
    inp, ref = runs[0], runs[1]
    mesh = _stacked((8,), ("proc",))
    x = torch.as_tensor(inp[f"x_{tag}"])
    xs = x.reshape(8, 4, 3)
    for key, rev in (("rag", False), ("ragr", True)):
        got = C.ring_all_gather(xs, mesh, "proc", reverse=rev)
        np.testing.assert_array_equal(got.reshape(-1, 3).numpy(),
                                      ref[f"{key}_{tag}"])
    got = C.ring_reduce_scatter(x.expand(8, 32, 3), mesh, "proc")
    np.testing.assert_array_equal(got.reshape(32, 3).numpy(),
                                  ref[f"rrs_{tag}"])
    got = C.ring_reduce_scatter(torch.as_tensor(inp[f"x8_{tag}"]).reshape(
        8, 32, 3), mesh, "proc")
    np.testing.assert_array_equal(got.reshape(32, 3).numpy(),
                                  ref[f"rrs_full_{tag}"])


@pytest.mark.parametrize("tag", ["int", "rnd"])
def test_reductions_and_matmul_match_reference(runs, tag):
    inp, ref = runs[0], runs[1]
    mesh2 = _stacked((2, 4), ("pod", "data"))
    y = torch.as_tensor(inp[f"y_{tag}"]).reshape(8, 1, 5)
    stats = []
    got = C.hierarchical_all_reduce(y, mesh2, "data", "pod", stats=stats)
    np.testing.assert_allclose(got.reshape(8, 5).numpy(), ref[f"har_{tag}"],
                               rtol=1e-6, atol=1e-6)
    # 5 words padded to 8 over 4 data ranks: 2 words a rank cross pods
    assert [(s["stage"], s["axes"], s["bytes_per_rank"]) for s in stats] == [
        ("reduce_scatter", ("data",), 32), ("all_reduce", ("pod",), 8),
        ("all_gather", ("data",), 8)]
    flat = []
    np.testing.assert_allclose(C.hierarchical_all_reduce(
        y, mesh2, ("pod", "data"), None, stats=flat).reshape(8, 5).numpy(),
        ref[f"har_{tag}"], rtol=1e-6, atol=1e-6)
    assert flat == [{"stage": "all_reduce", "axes": ("pod", "data"),
                     "bytes_per_rank": 20}]
    mesh = _stacked((8,), ("proc",))
    x = torch.as_tensor(inp[f"x_{tag}"]).reshape(8, 4, 3)
    got = C.all_gather_matmul_overlapped(x, torch.as_tensor(inp[f"w_{tag}"]),
                                         mesh, "proc")
    np.testing.assert_allclose(got.reshape(-1, 7).numpy(), ref[f"agm_{tag}"],
                               rtol=1e-6, atol=1e-4)


def test_exchanges_equal_reference(runs):
    inp, ref = runs[0], runs[1]
    mesh = _stacked((8,), ("proc",))
    mesh2 = _stacked((2, 4), ("pod", "data"))
    got = C.two_stage_all_to_all(torch.as_tensor(inp["z"]), mesh2, "data",
                                 "pod")
    np.testing.assert_array_equal(got.numpy(), ref["a2a2"])
    # ... which is the flat all-to-all over (pod, data)
    assert torch.equal(got, mesh2.all_to_all(torch.as_tensor(inp["z"]),
                                             ("pod", "data")))
    nb = torch.as_tensor(inp["nb"])
    for key, shift in (("nbr", 1), ("nbr3", 3)):
        np.testing.assert_array_equal(
            C.neighbor_exchange(nb, mesh, "proc", shift).numpy(), ref[key])
    got = C.hsdx_grid_exchange(torch.as_tensor(inp["hs"]), mesh, "proc",
                               (2, 2, 2), stages=2)
    want = ref["hsdx"]
    # stage 0 only moves data; stage 1 relays a mean of 26 payloads
    np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0])
    np.testing.assert_allclose(got[:, 1].numpy(), want[:, 1], rtol=1e-6,
                               atol=1e-6)
    seen = got[:, 0].reshape(8, 26, 8).argmax(-1)   # the reference test's
    assert all(set(seen[r].tolist()) >= set(range(8)) - {r} for r in range(8))


def test_stacked_collectives_are_differentiable():
    mesh = _stacked((2, 4), ("pod", "data"))
    y = torch.randn(8, 3, 5, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.arange(8 * 3 * 5, dtype=torch.float32).reshape(8, 3, 5)
    (C.hierarchical_all_reduce(y, mesh, "data", "pod") * w).sum().backward()
    # every rank's input reaches every rank's output once
    assert torch.equal(y.grad, w.sum(0, keepdim=True).expand(8, 3, 5))


def test_gloo_ranks_equal_stacked_bit_for_bit(runs):
    _, _, gl_in, ranks = runs
    for res in ranks:
        assert res["loaded"].size == 0, res["loaded"]
    inp = {k: torch.as_tensor(v) for k, v in gl_in.items()}
    flat = _stacked((4,), ("proc",))
    two = _stacked((2, 2), ("pod", "data"))
    for name, fn in RUNS.items():
        want = fn(lambda k: inp[k], flat, two).numpy()
        got = np.concatenate([res[name] for res in ranks])
        np.testing.assert_array_equal(got, want, err_msg=name)
