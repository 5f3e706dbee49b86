"""The port's expert-parallel MoE (`models.moe._moe_shard_map`) and its
data-parallel train step (`train.train_step`, `par=`), against the JAX
reference, and the stacked mesh against a gloo group, on the CPU.

The reference runs once, in a subprocess with 4 virtual host devices (as
tests/test_moe_distributed.py runs it), as one jitted program: its
`moe_ffn` on a (data 2, model 2) mesh at dbrx's and llama4-scout's smoke
configs in float32 (capacity factor 4: nothing drops), with and without
`moe_seq_shard`, `jax.grad` through dbrx's route, and its single-device
`train_step` of smollm-smoke (float32) on a batch of 4.  The port runs the
same inputs on a stacked (2, 2) mesh.  Limits: the MoE outputs at 1e-4
(tests/test_moe_distributed.py's), the aux loss at rtol 1e-5; gradients
within 1e-3 of each leaf's largest |g| and the loss at rtol 1e-4
(tests/test_torch_train.py's).  Tokens whose k-th and (k+1)-th router
logits lie within `ROUTER_TIE` = 1e-5 are left out of the MoE comparisons
(the gradient case must have none): the router reads x directly here, a
64-term float32 product, which the two packages round apart by ~1e-7, so
only such a near tie could route differently.  The data-parallel step splits the batch over (pod 2, data
2) ranks and reduces the gradients hierarchically (and flat): against the
reference's single-device step, the loss, the grad norm and the clipped
gradient (the first moment over 1 - b1) at those limits.

At a capacity factor of 0.5 tokens drop, and the expert-parallel route is
held to its oracle: `_moe_dense` on each data shard, whose capacity and
drops are the same (the dropped slots equal, the outputs at 1e-6).

Under a model axis the MoE takes the rank's expert block and a copy of the
router (`models.tp.model_shardings` of `moe_defs`); gradients of the
blocks are reassembled into whole leaves before they are compared.

Four gloo processes (importing `torch` and `repro_torch` only) run the
MoE forward on a group (data 2, model 2) mesh, the train step on a group
(pod 2, data 2) mesh, and two train steps on the group (data 2, model 2)
mesh on each rank's weight blocks: dbrx-smoke (experts and dense leaves
over 'model') and qwen3-smoke (tensor parallel at tp 2), one rank each:
all equal to the stacked mesh bit for bit (a rank's cut leaf against the
stacked mesh's row of that rank, a leaf without a cut against its model
rank's).  The file takes about 25 s on
the CPU.
"""
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import moe as tmoe
from repro_torch.models import weight_structs
from repro_torch.models.params import (map_tree, shard_params, tree_leaves,
                                       unshard_params)
from repro_torch.models import transformer as tf
from repro_torch.models.tp import model_shardings, shard_model, unshard_model
from repro_torch.sharding.parallel import Parallelism
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

from test_torch_dist_gloo import run_side_by_side
from test_torch_train import reference_weights

MOE_ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
TRAIN_ARCH, B, S = "smollm-360m", 4, 32
OPT = dict(lr=1e-3, warmup=2, total_steps=20)
ROUTER_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from dataclasses import replace
    import jax, jax.numpy as jnp, numpy as np
    from repro.ckpt import checkpoint as jckpt
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh_compat
    from repro.models import build_model
    from repro.models.moe import moe_ffn
    from repro.sharding.parallel import Parallelism
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step

    d = sys.argv[1]
    inp = dict(np.load(f"{d}/moe_in.npz"))
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                      remat=False)
    cfgs = {a: replace(get_config(a, smoke=True), dtype="float32")
            for a in ("dbrx-132b", "llama4-scout-17b-a16e")}
    tcfg = replace(get_config("smollm-360m", smoke=True), dtype="float32")
    tmodel = build_model(tcfg)
    like = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                        tmodel.param_structs())
    tparams = jckpt.load_checkpoint(f"{d}/smollm", 0,
                                    {"params": like})[0]["params"]
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup=2, total_steps=20)
    step = make_train_step(tmodel, Parallelism(remat=False), opt_cfg)

    def run(inp, tparams, batch):
        out = {}
        for a, cfg in cfgs.items():
            p = {k: inp[f"{a}/{k}"] for k in
                 ("router", "w_gate", "w_up", "w_down")}
            x = inp[f"{a}/x"]
            for tag, pp in (("", par), ("seq_", replace(
                    par, moe_seq_shard=True))):
                out[f"{a}/{tag}y"], out[f"{a}/{tag}aux"] = moe_ffn(
                    x, p, cfg, pp)
            if a == "dbrx-132b":
                def f(x, p):
                    y, aux = moe_ffn(x, p, cfg, par)
                    return jnp.sum(y ** 2) + aux
                gx, gp = jax.grad(f, argnums=(0, 1))(x, p)
                out[f"{a}/g/x"] = gx
                for k, v in gp.items():
                    out[f"{a}/g/{k}"] = v
        _, opt, m = step(tparams, jopt.init_opt_state(tparams), batch)
        out["train/loss"], out["train/grad_norm"] = m["loss"], m["grad_norm"]
        out["train/m"] = opt.m
        return out

    batch = {k: jnp.asarray(v) for k, v in np.load(f"{d}/batch.npz").items()}
    out = jax.jit(run)(inp, tparams, batch)
    jckpt.save_checkpoint(f"{d}/ref_m", 0, {"m": out.pop("train/m")})
    np.savez(f"{d}/ref_out.npz", **{k: np.asarray(v) for k, v in out.items()})
""").strip()

_WORKER = textwrap.dedent("""
    import sys
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.models import init_weights, moe, weight_structs
    from repro_torch.models.params import map_tree, shard_params, tree_leaves
    from repro_torch.models.tp import model_shardings, shard_model
    from repro_torch.sharding.parallel import Parallelism
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import make_train_step

    rank, world, init, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    res = {}
    inp = {k: torch.as_tensor(v) for k, v in
           np.load(f"{d}/moe_in.npz").items()}
    mesh = make_group_mesh((2, 2), ("data", "model"), device="cpu")
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model")
    me = mesh.coords(rank)[0]
    cfg = replace(get_config("dbrx-132b", smoke=True), dtype="float32")
    p = shard_params({k: inp[f"dbrx-132b/{k}"] for k in
                      ("router", "w_gate", "w_up", "w_down")},
                     model_shardings(moe.moe_defs(cfg), cfg, mesh))
    x = inp["dbrx-132b/x"][2 * me:2 * me + 2]
    with torch.no_grad():
        for tag, pp in (("", par), ("seq_", replace(par,
                                                    moe_seq_shard=True))):
            res[f"{tag}y"], res[f"{tag}aux"] = (
                t.numpy() for t in moe.moe_ffn(x, p, cfg, pp))
    # one train step on the rank's weight blocks: dbrx (experts and dense
    # leaves over 'model') and qwen3 (tensor parallel at tp 2)
    tp_batch = {k: torch.as_tensor(v[2 * me:2 * me + 2]) for k, v in
                np.load(f"{d}/tp_batch.npz").items()}
    for a in ("dbrx-132b", "qwen3-0.6b"):
        acfg = replace(get_config(a, smoke=True), dtype="float32")
        blocks = map_tree(lambda t: t.requires_grad_(), shard_model(
            init_weights(acfg, seed=0, device="cpu"), acfg, mesh))
        step = make_train_step(acfg, topt.AdamWConfig(
            lr=1e-3, warmup=2, total_steps=20), par=par)
        newp, _, m = step(blocks, topt.init_opt_state(blocks), tp_batch)
        res[f"tp/{a}/loss"] = m["loss"].numpy()
        res[f"tp/{a}/grad_norm"] = m["grad_norm"].numpy()
        for i, t in enumerate(tree_leaves(newp)):
            res[f"tp/{a}/p{i}"] = t.detach().numpy()

    tcfg = replace(get_config("smollm-360m", smoke=True), dtype="float32")
    params = load_checkpoint(f"{d}/smollm", 0, {"params": weight_structs(
        tcfg)}, device="cpu")[0]["params"]
    batch = {k: torch.as_tensor(v[rank:rank + 1]) for k, v in
             np.load(f"{d}/batch.npz").items()}
    two = make_group_mesh((2, 2), ("pod", "data"), device="cpu")
    for tag, hier in (("hier", True), ("flat", False)):
        pt = Parallelism(mesh=two, data_axes=("pod", "data"),
                         pod_axis="pod", hierarchical=hier)
        ptree = map_tree(lambda t: t.requires_grad_(), shard_model(
            params, tcfg, two))
        step = make_train_step(tcfg, topt.AdamWConfig(
            lr=1e-3, warmup=2, total_steps=20), par=pt)
        newp, opt, m = step(ptree, topt.init_opt_state(ptree), batch)
        res[f"{tag}/loss"] = m["loss"].numpy()
        res[f"{tag}/grad_norm"] = m["grad_norm"].numpy()
        for i, t in enumerate(tree_leaves(opt.m)):
            res[f"{tag}/m{i}"] = t.numpy()
        for i, t in enumerate(tree_leaves(newp)):
            res[f"{tag}/p{i}"] = t.detach().numpy()
    res["loaded"] = np.array(sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "jaxlib", "repro."))), dtype=str)
    np.savez(f"{d}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""").strip()


def _moe_inputs(rng):
    """Per arch: x (4, 16, D) * 0.3 and the four expert weights, drawn at
    the reference's init scales (1 / sqrt(fan_in)), float32."""
    out = {}
    for a in MOE_ARCHS:
        cfg = get_config(a, smoke=True)
        D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        for k, shape in (("router", (D, E)), ("w_gate", (E, D, F)),
                         ("w_up", (E, D, F)), ("w_down", (E, F, D))):
            out[f"{a}/{k}"] = (rng.normal(size=shape) / np.sqrt(
                shape[-2])).astype(np.float32)
        out[f"{a}/x"] = (rng.normal(size=(4, 16, D)) * 0.3).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the four gloo ranks' results),
    the five processes run side by side."""
    d = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    moe_in = _moe_inputs(rng)
    np.savez(d / "moe_in.npz", **moe_in)
    _, _, params = reference_weights(TRAIN_ARCH, "float32")
    jckpt.save_checkpoint(str(d / "smollm"), 0, {"params": params})
    seq = rng.integers(1, get_config(TRAIN_ARCH, smoke=True).vocab,
                       (B, S + 1))
    batch = {"tokens": seq[:, :-1].astype(np.int32),
             "labels": seq[:, 1:].astype(np.int32)}
    np.savez(d / "batch.npz", **batch)
    np.savez(d / "tp_batch.npz", **_tp_batch())
    run_side_by_side(
        [[sys.executable, "-c", _REFERENCE, str(d)]]
        + [[sys.executable, "-c", _WORKER, str(r), "4",
            f"file://{d}/rendezvous", str(d)] for r in range(4)],
        timeout=300, JAX_PLATFORMS="cpu")
    return (d, moe_in, batch, dict(np.load(d / "ref_out.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(4)])


def _tp_batch():
    """The tensor-parallel steps' batch: 4 x 16 tokens of the smoke
    vocabulary."""
    seq = np.random.default_rng(7).integers(1, 256, (4, 17))
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def _moe_case(moe_in, arch, **kw):
    cfg = replace(get_config(arch, smoke=True), dtype="float32", **kw)
    p = {k: torch.as_tensor(moe_in[f"{arch}/{k}"]) for k in
         ("router", "w_gate", "w_up", "w_down")}
    return cfg, p, torch.as_tensor(moe_in[f"{arch}/x"])


def _par(seq=False):
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    return Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                       moe_seq_shard=seq)


def _moe_sh(cfg, par):
    """The MoE leaves' placement over the model axis."""
    return model_shardings(tmoe.moe_defs(cfg), cfg, par.mesh)


def _moe_ffn(x, p, cfg, par):
    """`moe_ffn` on the rank blocks of the whole leaves p."""
    return tmoe.moe_ffn(x, shard_params(p, _moe_sh(cfg, par)), cfg, par)


def _untied(cfg, p, x):
    """(B, S): the tokens whose router margins lie above ROUTER_TIE."""
    m = tmoe._margin(x.reshape(-1, x.shape[-1]), p["router"], cfg.top_k)
    ok = (m > ROUTER_TIE).reshape(x.shape[:2])
    assert ok.float().mean() > 0.9
    return ok


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_matches_reference(runs, arch, seq):
    _, moe_in, _, ref, _ = runs
    cfg, p, x = _moe_case(moe_in, arch)
    with tmoe.routing_log() as log:
        y, aux = _moe_ffn(x, p, cfg, _par(seq))
    # one routing a rank: each rank routes its data shard (of 32 tokens),
    # or its model slice of it (16) with moe_seq_shard; nothing drops
    assert [tuple(e[0].shape) for e in log] == [(16 if seq else 32,
                                                 cfg.top_k)] * 4
    assert all(bool(e[1].all()) for e in log)
    tag = "seq_" if seq else ""
    ok = _untied(cfg, p, x)
    np.testing.assert_allclose(y[ok].numpy(), ref[f"{arch}/{tag}y"][ok.numpy()],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), ref[f"{arch}/{tag}aux"],
                               rtol=1e-5)
    # the dense route on one shard is the reference's oracle: with nothing
    # dropped, equal outputs
    yd, _ = tmoe._moe_dense(x, p, cfg)
    np.testing.assert_allclose(y.numpy(), yd.numpy(), atol=1e-5, rtol=0)


def test_expert_parallel_gradients_match_reference(runs):
    _, moe_in, _, ref, _ = runs
    cfg, p, x = _moe_case(moe_in, "dbrx-132b")
    ok = _untied(cfg, p, x)
    assert bool(ok.all()), "a near tie in the gradient case's inputs"
    sh = _moe_sh(cfg, _par())
    p = {k: v.requires_grad_() for k, v in shard_params(p, sh).items()}
    x = x.clone().requires_grad_()
    y, aux = tmoe.moe_ffn(x, p, cfg, _par())
    ((y ** 2).sum() + aux).backward()
    # the router's copies hold one gradient, the whole one
    assert torch.equal(p["router"].grad[0], p["router"].grad[1])
    whole = unshard_params({k: v.grad for k, v in p.items()}, sh)
    for name, g in [("x", x.grad)] + list(whole.items()):
        want = ref[f"dbrx-132b/g/{name}"]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("seq", [False, True])
def test_dropping_capacity_matches_per_shard_oracle(runs, seq):
    _, moe_in, _, _, _ = runs
    cfg, p, x = _moe_case(moe_in, "dbrx-132b", capacity_factor=0.5)
    with tmoe.routing_log() as log:
        y, aux = _moe_ffn(x, p, cfg, _par(seq))
    kept = torch.cat([e[1] for e in log])
    # the oracle: _moe_dense on each shard the route splits the tokens into
    # (data shards; with moe_seq_shard, each model rank's slice of one)
    # (B 4, S 16): data shard d holds rows 2d, 2d + 1; with moe_seq_shard
    # model rank m routes the shard's m-th 16 tokens, which is row 2d + m
    shards = x.split(1 if seq else 2)
    with tmoe.routing_log() as olog:
        outs = [tmoe._moe_dense(s, p, cfg) for s in shards]
    okept = torch.cat([e[1] for e in olog])
    if not seq:       # each data shard routed by both of its model ranks
        okept = torch.cat([olog[0][1], olog[0][1], olog[1][1], olog[1][1]])
    assert torch.equal(kept, okept) and int((~kept).sum()) > 0
    want = torch.cat([o[0] for o in outs]).reshape(-1, x.shape[-1])
    np.testing.assert_allclose(y.reshape(-1, x.shape[-1]).numpy(),
                               want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(aux), float(sum(
        o[1] for o in outs) / len(outs)), rtol=1e-6)


def _train(runs, hier: bool):
    d, _, batch, _, _ = runs
    cfg = replace(get_config(TRAIN_ARCH, smoke=True), dtype="float32")
    params = load_checkpoint(str(d / "smollm"), 0, {
        "params": weight_structs(cfg)}, device="cpu")[0]["params"]
    mesh = make_mesh_compat((2, 2), ("pod", "data"), "cpu")
    ptree = map_tree(lambda t: t.requires_grad_(), shard_model(
        params, cfg, mesh))
    par = Parallelism(mesh=mesh, data_axes=("pod", "data"), pod_axis="pod",
                      hierarchical=hier)
    step = make_train_step(cfg, topt.AdamWConfig(**OPT), par=par)
    newp, opt, m = step(ptree, topt.init_opt_state(ptree),
                        {k: torch.as_tensor(v) for k, v in batch.items()})
    return newp, opt, m, step.comm, mesh


@pytest.mark.parametrize("hier", [True, False])
def test_data_parallel_step_matches_reference(runs, hier):
    d, ref = runs[0], runs[3]
    _, opt, m, comm, mesh = _train(runs, hier)
    np.testing.assert_allclose(float(m["loss"]), ref["train/loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), ref["train/grad_norm"],
                               rtol=1e-4)
    cfg = replace(get_config(TRAIN_ARCH, smoke=True), dtype="float32")
    jm = load_checkpoint(str(d / "ref_m"), 0, {"m": weight_structs(cfg)},
                         device="cpu")[0]["m"]
    whole = unshard_model(opt.m, cfg, mesh)
    for got, want in zip(tree_leaves(whole), tree_leaves(jm)):
        assert got.shape == want.shape
        # the clipped gradient, m / (1 - b1), within 1e-3 of its largest
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-3 * float(want.abs().max()))
    # the cut leaves (a rank's cuts: 1/|data| of them) cross the pod axis
    # in an all-reduce of their own; the rest, 1/|data| of them
    # hierarchically, all of them flat
    sh = tree_leaves(model_shardings(tf.model_defs(cfg), cfg, mesh))
    cut = sum(t[0].numel() for t, s in zip(tree_leaves(opt.m), sh)
              if s.cut_axes)
    rest = sum(t[0].numel() for t, s in zip(tree_leaves(opt.m), sh)
               if not s.cut_axes) + 1                      # + the loss
    assert comm[0]["stage"] == "reduce_scatter" and comm[0]["axes"] == (
        "data",)
    assert comm[1] == {"stage": "all_reduce", "axes": ("pod",),
                       "bytes_per_rank": 4 * cut}
    if hier:
        assert comm[2:] == [
            {"stage": "reduce_scatter", "axes": ("data",),
             "bytes_per_rank": 4 * (rest + rest % 2)},
            {"stage": "all_reduce", "axes": ("pod",),
             "bytes_per_rank": 4 * -(-rest // 2)},
            {"stage": "all_gather", "axes": ("data",),
             "bytes_per_rank": 4 * -(-rest // 2)}]
    else:
        assert comm[2:] == [{"stage": "all_reduce", "axes": ("pod", "data"),
                             "bytes_per_rank": 4 * rest}]


def test_hierarchical_and_flat_reductions_agree(runs):
    a, b = _train(runs, True), _train(runs, False)
    for x, y in zip(tree_leaves(a[1].m), tree_leaves(b[1].m)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-7 * float(y.abs().max()))


def _tp_step(arch):
    """One train step of `arch`-smoke on the stacked (data 2, model 2)
    mesh, on the weight blocks: (new blocks, metrics)."""
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    par = _par()
    from repro_torch.models import init_weights
    blocks = map_tree(lambda t: t.requires_grad_(), shard_model(
        init_weights(cfg, seed=0, device="cpu"), cfg, par.mesh))
    step = make_train_step(cfg, topt.AdamWConfig(**OPT), par=par)
    newp, _, m = step(blocks, topt.init_opt_state(blocks),
                      {k: torch.as_tensor(v) for k, v in _tp_batch().items()})
    return newp, m


def _row(t, r: int, n_model: int) -> int:
    """The row of rank r in a stacked leaf: its own for a cut leaf (one a
    rank), its model rank's otherwise."""
    return r if t.shape[0] == 4 else r % n_model


def test_gloo_ranks_equal_stacked_bit_for_bit(runs):
    _, moe_in, _, _, ranks = runs
    for res in ranks:
        assert res["loaded"].size == 0, res["loaded"]
    # expert-parallel (dbrx) and tensor-parallel (qwen3) train steps on
    # the group (data 2, model 2) mesh: rank (d, m) holds model rank m's
    # blocks, equal to the stacked mesh's
    for arch in ("dbrx-132b", "qwen3-0.6b"):
        newp, m = _tp_step(arch)
        for r, res in enumerate(ranks):
            assert res[f"tp/{arch}/loss"] == m["loss"].numpy(), arch
            assert res[f"tp/{arch}/grad_norm"] == m["grad_norm"].numpy()
            for i, t in enumerate(tree_leaves(newp)):
                np.testing.assert_array_equal(res[f"tp/{arch}/p{i}"][0],
                                              t.detach()[_row(t, r, 2)]
                                              .numpy())
    cfg, p, x = _moe_case(moe_in, "dbrx-132b")
    with torch.no_grad():
        for tag, seq in (("", False), ("seq_", True)):
            y, aux = _moe_ffn(x, p, cfg, _par(seq))
            # rank (d, m) holds data shard d's output, whatever m
            for r, res in enumerate(ranks):
                dd = r // 2
                np.testing.assert_array_equal(res[f"{tag}y"],
                                              y[2 * dd:2 * dd + 2].numpy())
                assert res[f"{tag}aux"] == aux.numpy()
    for tag, hier in (("hier", True), ("flat", False)):
        newp, opt, m, _, _ = _train(runs, hier)
        for r, res in enumerate(ranks):
            assert res[f"{tag}/loss"] == m["loss"].numpy()
            assert res[f"{tag}/grad_norm"] == m["grad_norm"].numpy()
            for i, t in enumerate(tree_leaves(opt.m)):
                np.testing.assert_array_equal(res[f"{tag}/m{i}"][0],
                                              t[_row(t, r, 1)].numpy())
            for i, t in enumerate(tree_leaves(newp)):
                np.testing.assert_array_equal(res[f"{tag}/p{i}"][0],
                                              t.detach()[_row(t, r, 1)]
                                              .numpy())


def test_expert_parallel_train_step_on_a_stacked_mesh(runs):
    """dbrx-smoke trained one step on a stacked (data 2, model 2) mesh:
    each data rank's loss runs the expert-parallel route over its model
    ranks; the gradient equals the mean of the data shards' own gradients
    through `_moe_dense` (their capacities are the shards')."""
    _, moe_in, _, _, _ = runs
    cfg = replace(get_config("dbrx-132b", smoke=True), dtype="float32")
    from repro_torch.models import init_weights
    from repro_torch.train.train_step import value_and_grad
    params = init_weights(cfg, seed=0, device="cpu", trainable=True)
    rng = np.random.default_rng(4)
    seq = rng.integers(1, cfg.vocab, (4, 17))
    batch = {"tokens": torch.as_tensor(seq[:, :-1]),
             "labels": torch.as_tensor(seq[:, 1:])}
    mesh = _par().mesh
    blocks = map_tree(lambda t: t.detach().requires_grad_(),
                      shard_model(params, cfg, mesh))
    step = make_train_step(cfg, topt.AdamWConfig(**OPT), par=_par())
    _, opt, m = step(blocks, topt.init_opt_state(blocks), batch)
    opt = opt._replace(m=unshard_model(opt.m, cfg, mesh))
    want = [torch.zeros(t.shape) for t in tree_leaves(params)]
    losses = []
    for j in range(2):
        sl = {k: v[2 * j:2 * j + 2] for k, v in batch.items()}
        loss, _, g = value_and_grad(params, sl, cfg)
        losses.append(float(loss))
        for w, gg in zip(want, tree_leaves(g)):
            w += gg.float() / 2
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=1e-6)
    b1 = topt.AdamWConfig().b1
    scale = min(1.0, topt.AdamWConfig().clip_norm / float(m["grad_norm"]))
    for got, w in zip(tree_leaves(opt.m), want):
        np.testing.assert_allclose(got.numpy() / (1 - b1), w.numpy() * scale,
                                   rtol=0, atol=1e-5 * float(
                                       w.abs().max() * scale) + 1e-12)
