"""FSDP over the data axes (`models.tp`): each rank holds 1/|data| of its
weight block on the dim where the reference's spec says 'data', gathered
a superblock at a time, its gradient reduce-scattered, on the CPU.

  placement   every family's cut shapes at production widths against the
              reference's `param_shardings` on an `AbstractMesh` ((16, 16)
              and (2, 16, 16), with and without `fsdp_pod`), leaf by leaf;
              the leaves that differ are listed below with the reason;
  round trip  whole leaves through `shard_model` / `unshard_model` on a
              (data 3, model 2) mesh (d_model 64: an uneven cut of 22),
              and the pads zero after an AdamW step;
  placement without the cut
              qwen3, dbrx and rwkv6 one step on stacked (data 2, model 2)
              cut and whole over 'data' (`shard_model(fsdp=False)`, the
              model blocks alone): the loss equal, the grad norm and the
              updated weights at rtol 1e-6 (the norm's squares are summed
              in other groups: a cut leaf's once, a whole one's halved on
              each data rank, so the clip scale moves by an ulp);
  routes      four gloo processes run the same steps on group meshes
              ((data 2, model 2); smollm on (pod 2, data 2) cut over
              ('pod', 'data')) and round-trip the leaves there: equal to
              the stacked mesh bit for bit;
  reference   the reference's jitted train step of qwen3-smoke under its
              `param_shardings` on a (data 2, model 2) host mesh (4
              virtual devices, in a subprocess beside the gloo ranks)
              against the port's FSDP step: the loss and grad norm at rtol
              1e-4, the clipped gradient (m / (1 - b1)) within 1e-3 of each
              leaf's largest |g| (the LM tests' limits);
  checkpoint  the step's cuts saved whole, loaded onto (data 4) and onto
              one rank, and read by the reference's `load_checkpoint`;
  serving     a prefill and 4 decode steps cut and whole over 'data'
              (qwen3 and rwkv6 on their rank programs; rwkv6 and hymba
              on (data 4), where the whole-leaf path reads the gathered
              leaves) within 1e-4 of the largest |logit|.

Float32 smoke configs throughout.  About 30 s on the CPU.
"""
import math
import sys
import textwrap
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.models import transformer as jtf
from repro.models.params import ParamDef as JDef
from repro.models import build_model as jbuild_model
from repro.models.params import param_shardings as jparam_shardings
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import build_model, init_weights, weight_structs
from repro_torch.models import decode as tdecode
from repro_torch.models import transformer as tf
from repro_torch.models.params import ParamDef, map_tree, tree_leaves
from repro_torch.models.tp import (COVERED, ATTN_KEYS, model_shardings,
                                   shard_model, unshard_model)
from repro_torch.sharding.parallel import Parallelism
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

from test_torch_dist_gloo import run_side_by_side
from test_torch_train import reference_weights

OPT = dict(lr=1e-3, warmup=2, total_steps=20)
STEP_ARCHS = ("qwen3-0.6b", "dbrx-132b", "rwkv6-1.6b")

# The leaves whose cut shape differs from the reference's shard shape, and
# why: the head rule gives every model rank whole key/value heads and one
# group size, padded to the widest rank (`tp.head_placement`), where the
# reference splits the head columns evenly.  rwkv6's time mix splits on
# head boundaries, 2 of its 32 heads a rank: the reference's even split.
# On the dim the 'data' entry names every leaf equals the reference's.
HEAD_RULE = {
    "phi4-mini-3.8b": ("wq", "wk", "wv", "wo"),    # 24 / 8 heads over 16
    "smollm-360m": ("wq", "wk", "wv", "wo"),       # 15 / 5
    "llama4-scout-17b-a16e": ("wq", "wk", "wv", "wo"),   # 40 / 8
    "hymba-1.5b": ("wq", "wk", "wv", "wo"),        # 25 / 5
    "qwen3-0.6b": ("wk", "wv"),                    # 8 KV heads over 16
    "gemma3-12b": ("wk", "wv"),
    "llama-3.2-vision-90b": ("wk", "wv"),
    "dbrx-132b": ("wk", "wv"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return replace(get_config(arch, smoke=True), dtype="float32")


def _par(mesh, **kw):
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return Parallelism(mesh=mesh, data_axes=dp, pod_axis="pod" if "pod" in
                       dp else None, model_axis="model" if "model" in
                       mesh.axis_names else None, **kw)


def _batch(seed=7, B=4, S=16):
    seq = np.random.default_rng(seed).integers(1, 256, (B, S + 1))
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


# ------------------------------------------------------------ placement ----
def _port_leaves(defs, sh, path=()):
    if isinstance(defs, list):            # one superblock stands for all
        yield from _port_leaves(defs[0], sh[0], path)
        return
    for k, v in defs.items():
        if isinstance(v, ParamDef):
            yield path + (k,), v, sh[k]
        else:
            yield from _port_leaves(v, sh[k], path + (k,))


def _ref_leaves(defs, sh, path=()):
    for k, v in defs.items():
        if isinstance(v, JDef):
            yield path + (k,), v, sh[k]
        else:
            yield from _ref_leaves(v, sh[k], path + (k,))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cut_shapes_match_the_reference(multi_pod):
    dims, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    mesh = make_mesh_compat(dims, names, "meta")
    amesh = AbstractMesh(dims, names)
    checked = 0
    for arch in list_archs():
        cfg = get_config(arch)
        pdefs = tf.model_defs(cfg)
        jdefs = jtf.model_defs(jget_config(arch))
        for pod in (False, True):
            sh = model_shardings(pdefs, cfg, mesh, fsdp_pod=pod)
            ref = {p: (d, s) for p, d, s in _ref_leaves(
                jdefs, jparam_shardings(jdefs, amesh, fsdp_pod=pod))}
            apart = set()
            for p, d, s in _port_leaves(pdefs, sh):
                jd, js = ref[p]
                lead = len(jd.shape) - len(d.shape)     # the stacked dim
                want = tuple(js.shard_shape(tuple(jd.shape)))[lead:]
                got = s.block_shape(d.shape)
                if "data" in d.spec:        # the cut: always the reference's
                    k = d.spec.index("data")
                    assert s.cut_axes == (("pod", "data") if pod and
                                          multi_pod else ("data",))
                    assert got[k] == want[k], (arch, p)
                if got != want:
                    # only the model dim differs
                    k = d.spec.index("model")
                    assert got[:k] + got[k + 1:] == want[:k] + want[k + 1:]
                    apart.add(p[-1])
                checked += 1
            assert cfg.family in COVERED
            assert apart == set(HEAD_RULE.get(arch, ())), arch
            assert apart <= set(ATTN_KEYS)
    assert checked > 400


# ----------------------------------------------------------- round trip ----
def test_round_trip_and_pads_stay_zero():
    """(data 3, model 2): d_model 64 cut in 3 pieces of 22 (2 pad rows or
    columns on the last data rank); the whole leaves come back exactly,
    and after an AdamW step the pads of the weights, the masters and both
    moments are zero."""
    cfg = _cfg("qwen3-0.6b")
    mesh = make_mesh_compat((3, 2), ("data", "model"), "cpu")
    whole = init_weights(cfg, seed=3, device="cpu")
    blocks = shard_model(whole, cfg, mesh)
    back = unshard_model(blocks, cfg, mesh)
    for a, b in zip(tree_leaves(whole), tree_leaves(back)):
        assert torch.equal(a, b)
    sh = tree_leaves(model_shardings(tf.model_defs(cfg), cfg, mesh))
    assert sum(1 for s in sh if s.cut_axes) > 0
    blocks = map_tree(lambda t: t.requires_grad_(), blocks)
    step = make_train_step(cfg, topt.AdamWConfig(**OPT), par=_par(mesh))
    b = {k: torch.as_tensor(v) for k, v in _batch(B=6).items()}
    newp, opt, m = step(blocks, topt.init_opt_state(blocks), b)
    assert math.isfinite(float(m["loss"]))
    ranks = mesh.axis_index("data")
    pads = 0
    for tree in (newp, opt.master, opt.m, opt.v):
        for t, s in zip(tree_leaves(tree), sh):
            if not s.cut_axes:
                continue
            for r, j in enumerate(ranks):
                live = max(0, min(s.cut_width, s.cut_len - j * s.cut_width))
                pad = t[r].narrow(s.cut_dim, live, s.cut_width - live)
                pads += pad.numel()
                if pad.numel():
                    assert float(pad.detach().abs().max()) == 0.0
    assert pads > 0


# ---------------------------------------- the gloo ranks, the reference ----
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from dataclasses import replace
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.ckpt import checkpoint as jckpt
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh_compat
    from repro.models import build_model
    from repro.sharding.parallel import Parallelism
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step

    d = sys.argv[1]
    cfg = replace(get_config("qwen3-0.6b", smoke=True), dtype="float32")
    model = build_model(cfg)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                      remat=False)
    like = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                        model.param_structs())
    params = jckpt.load_checkpoint(f"{d}/ref", 0, {"params": like})[0]["params"]
    psh = model.param_shardings(mesh)
    opt = jopt.init_opt_state(params)
    osh = type(opt)(psh, psh, psh, NamedSharding(mesh, P()))
    batch = {k: jnp.asarray(v) for k, v in np.load(f"{d}/batch.npz").items()}
    bsh = {k: NamedSharding(mesh, P("data", None)) for k in batch}
    step = jax.jit(make_train_step(model, par, jopt.AdamWConfig(
        lr=1e-3, warmup=2, total_steps=20)), in_shardings=(psh, osh, bsh))
    _, opt, m = step(jax.device_put(params, psh), jax.device_put(opt, osh),
                     jax.device_put(batch, bsh))
    jckpt.save_checkpoint(f"{d}/ref_m", 0, {"m": opt.m})
    np.savez(f"{d}/ref_out.npz", loss=np.asarray(m["loss"]),
             grad_norm=np.asarray(m["grad_norm"]))
""").strip()

_WORKER = textwrap.dedent("""
    import sys
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.models import init_weights
    from repro_torch.models.params import map_tree, tree_leaves
    from repro_torch.models.tp import shard_model, unshard_model
    from repro_torch.sharding.parallel import Parallelism
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import make_train_step

    rank, world, init, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    res = {}
    opt_cfg = topt.AdamWConfig(lr=1e-3, warmup=2, total_steps=20)
    batch = dict(np.load(f"{d}/batch.npz"))
    mesh = make_group_mesh((2, 2), ("data", "model"), device="cpu")
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model")
    me = mesh.coords(rank)[0]
    mine = {k: torch.as_tensor(v[2 * me:2 * me + 2]) for k, v in
            batch.items()}
    for a in ("qwen3-0.6b", "dbrx-132b", "rwkv6-1.6b"):
        cfg = replace(get_config(a, smoke=True), dtype="float32")
        whole = init_weights(cfg, seed=0, device="cpu")
        blocks = shard_model(whole, cfg, mesh)
        res[f"{a}/round_trip"] = np.array(all(torch.equal(x, y) for x, y in
            zip(tree_leaves(whole), tree_leaves(unshard_model(
                blocks, cfg, mesh)))))
        blocks = map_tree(lambda t: t.requires_grad_(), blocks)
        step = make_train_step(cfg, opt_cfg, par=par)
        newp, _, m = step(blocks, topt.init_opt_state(blocks), mine)
        res[f"{a}/loss"] = m["loss"].numpy()
        res[f"{a}/grad_norm"] = m["grad_norm"].numpy()
        for i, t in enumerate(tree_leaves(newp)):
            res[f"{a}/p{i}"] = t.detach().numpy()
    # ('pod', 'data'): every weight cut over both, one reduce-scatter
    two = make_group_mesh((2, 2), ("pod", "data"), device="cpu")
    cfg = replace(get_config("smollm-360m", smoke=True), dtype="float32")
    blocks = map_tree(lambda t: t.requires_grad_(), shard_model(
        init_weights(cfg, seed=0, device="cpu"), cfg, two, fsdp_pod=True))
    pt = Parallelism(mesh=two, data_axes=("pod", "data"), pod_axis="pod")
    step = make_train_step(cfg, opt_cfg, par=pt)
    newp, _, m = step(blocks, topt.init_opt_state(blocks), {
        k: torch.as_tensor(v[rank:rank + 1]) for k, v in batch.items()})
    res["pod/loss"], res["pod/grad_norm"] = (m["loss"].numpy(),
                                             m["grad_norm"].numpy())
    for i, t in enumerate(tree_leaves(newp)):
        res[f"pod/p{i}"] = t.detach().numpy()
    res["pod/comm"] = np.array([str(s) for s in step.comm])
    np.savez(f"{d}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""").strip()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(directory, the reference's outputs, the four gloo ranks' results),
    the five processes run side by side."""
    d = tmp_path_factory.mktemp("fsdp")
    _, _, params = reference_weights("qwen3-0.6b", "float32")
    jckpt.save_checkpoint(str(d / "ref"), 0, {"params": params})
    np.savez(d / "batch.npz", **_batch())
    run_side_by_side(
        [[sys.executable, "-c", _REFERENCE, str(d)]]
        + [[sys.executable, "-c", _WORKER, str(r), "4",
            f"file://{d}/rendezvous", str(d)] for r in range(4)],
        timeout=300, JAX_PLATFORMS="cpu")
    return (d, dict(np.load(d / "ref_out.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(4)])


def _step(arch, mesh, fsdp=True, fsdp_pod=False, whole=None, batch=None):
    """One train step of `arch`-smoke on a stacked mesh: (new blocks, opt,
    metrics, step)."""
    cfg = _cfg(arch)
    whole = init_weights(cfg, seed=0, device="cpu") if whole is None \
        else whole
    blocks = map_tree(lambda t: t.requires_grad_(), shard_model(
        whole, cfg, mesh, fsdp=fsdp, fsdp_pod=fsdp_pod))
    step = make_train_step(cfg, topt.AdamWConfig(**OPT), par=_par(mesh))
    b = {k: torch.as_tensor(v) for k, v in (batch or _batch()).items()}
    newp, opt, m = step(blocks, topt.init_opt_state(blocks), b)
    return newp, opt, m, step


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_fsdp_step_equals_the_placement_without_the_cut(arch):
    cfg = _cfg(arch)
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    a, _, ma, sa = _step(arch, mesh)
    b, _, mb, sb = _step(arch, mesh, fsdp=False)
    assert [s["stage"] for s in sa.comm] == ["reduce_scatter", "all_reduce"]
    assert [s["stage"] for s in sb.comm] == ["all_reduce"]
    assert float(ma["loss"]) == float(mb["loss"])
    np.testing.assert_allclose(float(ma["grad_norm"]), float(mb["grad_norm"]),
                               rtol=1e-6)
    wa = unshard_model(a, cfg, mesh)
    wb = unshard_model(b, cfg, mesh, fsdp=False)
    for x, y in zip(tree_leaves(wa), tree_leaves(wb)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=1e-6, atol=1e-6 * float(
                                       y.detach().abs().max()))


def test_gloo_ranks_equal_stacked_bit_for_bit(runs):
    _, _, ranks = runs
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    for arch in STEP_ARCHS:
        newp, _, m, _ = _step(arch, mesh)
        for r, res in enumerate(ranks):
            assert bool(res[f"{arch}/round_trip"]), arch
            assert res[f"{arch}/loss"] == m["loss"].numpy(), arch
            assert res[f"{arch}/grad_norm"] == m["grad_norm"].numpy(), arch
            for i, t in enumerate(tree_leaves(newp)):
                row = r if t.shape[0] == 4 else r % t.shape[0]
                np.testing.assert_array_equal(res[f"{arch}/p{i}"][0],
                                              t.detach()[row].numpy())
    two = make_mesh_compat((2, 2), ("pod", "data"), "cpu")
    b = _batch()
    newp, _, m, step = _step("smollm-360m", two, fsdp_pod=True, batch=b)
    # one reduce-scatter over ('pod', 'data'); after it only the uncut
    # leaves' (the norms') and the loss's hierarchical all-reduce
    cfg = _cfg("smollm-360m")
    sh = tree_leaves(model_shardings(tf.model_defs(cfg), cfg, two,
                                     fsdp_pod=True))
    rest = sum(t[0].numel() for t, s in zip(tree_leaves(newp), sh)
               if not s.cut_axes) + 1
    assert all(s.cut_axes == ("pod", "data") for s in sh if s.cut_axes)
    half = 4 * -(-rest // 2)
    assert [(s["stage"], s["axes"]) for s in step.comm[:1]] == [
        ("reduce_scatter", ("pod", "data"))]
    assert step.comm[1:] == [
        {"stage": "reduce_scatter", "axes": ("data",),
         "bytes_per_rank": 4 * (rest + rest % 2)},
        {"stage": "all_reduce", "axes": ("pod",), "bytes_per_rank": half},
        {"stage": "all_gather", "axes": ("data",), "bytes_per_rank": half}]
    for r, res in enumerate(ranks):
        assert res["pod/loss"] == m["loss"].numpy()
        assert res["pod/grad_norm"] == m["grad_norm"].numpy()
        assert list(res["pod/comm"]) == [str(s) for s in step.comm]
        for i, t in enumerate(tree_leaves(newp)):
            np.testing.assert_array_equal(res[f"pod/p{i}"][0],
                                          t.detach()[r % t.shape[0]].numpy())


def test_fsdp_step_matches_the_reference(runs):
    d, ref, _ = runs
    cfg = _cfg("qwen3-0.6b")
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    sh = model_shardings(tf.model_defs(cfg), cfg, mesh)
    blocks = load_checkpoint(str(d / "ref"), 0, {
        "params": weight_structs(cfg)}, shardings={"params": sh})[0]["params"]
    blocks = map_tree(lambda t: t.requires_grad_(), blocks)
    step = make_train_step(cfg, topt.AdamWConfig(**OPT), par=_par(
        mesh, remat=False))
    newp, opt, m = step(blocks, topt.init_opt_state(blocks), {
        k: torch.as_tensor(v) for k, v in _batch().items()})
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"],
                               rtol=1e-4)
    jm = load_checkpoint(str(d / "ref_m"), 0, {"m": weight_structs(cfg)},
                         device="cpu")[0]["m"]
    for got, want in zip(tree_leaves(unshard_model(opt.m, cfg, mesh)),
                         tree_leaves(jm)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-3 * float(want.abs().max()))


def test_checkpoint_of_cuts_across_meshes(tmp_path):
    """One FSDP step's cuts on (data 2, model 2) saved whole, loaded onto
    (data 4) and onto one rank, and read by the reference's reader: every
    leaf equal."""
    _checkpoint_across_meshes("qwen3-0.6b", tmp_path)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_checkpoint_of_rank_blocks_across_meshes(arch, tmp_path):
    """rwkv6's and hymba's blocks and cuts, as qwen3's, and loaded onto
    (model 4) too (rwkv6: a rank without a head)."""
    whole = _checkpoint_across_meshes(arch, tmp_path)
    cfg = _cfg(arch)
    four = make_mesh_compat((4,), ("model",), "cpu")
    got = load_checkpoint(str(tmp_path), 1, {"params": weight_structs(cfg)},
                          shardings={"params": model_shardings(
                              tf.model_defs(cfg), cfg, four)})[0]["params"]
    for w, a in zip(tree_leaves(whole), tree_leaves(unshard_model(
            got, cfg, four))):
        assert torch.equal(w.detach(), a)


def _checkpoint_across_meshes(arch, tmp_path):
    cfg = _cfg(arch)
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    sh = model_shardings(tf.model_defs(cfg), cfg, mesh)
    newp, _, _, _ = _step(arch, mesh)
    whole = unshard_model(newp, cfg, mesh)
    save_checkpoint(str(tmp_path), 1, {"params": newp},
                    shardings={"params": sh})
    four = make_mesh_compat((4,), ("data",), "cpu")
    sh4 = model_shardings(tf.model_defs(cfg), cfg, four)
    got4 = load_checkpoint(str(tmp_path), 1, {"params": weight_structs(cfg)},
                           shardings={"params": sh4})[0]["params"]
    assert got4["embed"].shape == (4, 256, 16)          # D 64 over 4
    one = load_checkpoint(str(tmp_path), 1, {"params": weight_structs(cfg)},
                          device="cpu")[0]["params"]
    jcfg = replace(jget_config(arch, smoke=True), dtype="float32")
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, np.float32),
                        jbuild_model(jcfg).param_structs())
    jone = jckpt.load_checkpoint(str(tmp_path), 1, {"params": like})[0]
    jone = lm_params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                  jone["params"]), "cpu")
    for w, a, b, j in zip(tree_leaves(whole),
                          tree_leaves(unshard_model(got4, cfg, four)),
                          tree_leaves(one), tree_leaves(jone)):
        assert torch.equal(w.detach(), a) and torch.equal(w.detach(), b)
        assert torch.equal(w.detach(), j)
    return whole


# -------------------------------------------------------------- serving ----
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_serving_under_fsdp(arch):
    cfg = _cfg(arch)
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    par = _par(mesh, remat=False)
    whole = init_weights(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(_batch(B=4, S=8)["tokens"])
    outs = []
    for fsdp in (True, False):
        model = build_model(cfg, shard_model(whole, cfg, mesh, fsdp=fsdp))
        with torch.no_grad():
            cache, lg = model.prefill(toks, 16, par=par)
            got = [lg]
            nxt = lg.argmax(-1)
            for i in range(4):
                lg, cache = model.decode_step(cache, nxt, 8 + i, par=par)
                got.append(lg)
                nxt = lg.argmax(-1)
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    # the caches: the rank program's one a rank (4 ranks, 2 rows of the
    # batch each)
    cache = tdecode.init_cache(cfg, 4, 16, "cpu", par)
    if arch == "qwen3-0.6b":
        assert cache["blocks"][0]["k"].shape[:2] == (4, 2)
    else:
        assert cache["blocks"][0]["tm_tok"].shape == (4, 2, 1, cfg.d_model)
        assert cache["blocks"][0]["wkv"].shape[:3] == (4, 2, 1)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_whole_leaf_serving_under_fsdp(arch):
    """(data 4), no model axis: the whole-leaf path on the gathered leaves
    (`decode._whole_view`), cut and whole over 'data', against the
    unsharded model; its caches whole."""
    cfg = _cfg(arch)
    mesh = make_mesh_compat((4,), ("data",), "cpu")
    par = _par(mesh, remat=False)
    whole = init_weights(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(_batch(B=4, S=8)["tokens"])
    outs = []
    for tree, pp in ((whole, Parallelism(remat=False)),
                     (shard_model(whole, cfg, mesh), par),
                     (shard_model(whole, cfg, mesh, fsdp=False), par)):
        model = build_model(cfg, tree)
        with torch.no_grad():
            cache, lg = model.prefill(toks, 16, par=pp)
            got = [lg]
            nxt = lg.argmax(-1)
            for i in range(4):
                lg, cache = model.decode_step(cache, nxt, 8 + i, par=pp)
                got.append(lg)
                nxt = lg.argmax(-1)
        outs.append(got)
    for run in outs[1:]:
        for a, b in zip(run, outs[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
    first = next(iter(tdecode.init_cache(cfg, 4, 16, "cpu", par)[
        "blocks"][0].values()))
    assert first.shape[0] == 4 and first.dim() == (3 if cfg.family == "ssm"
                                                   else 4)
