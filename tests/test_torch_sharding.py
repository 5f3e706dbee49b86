"""The port's sharding tier against the JAX reference's, on the CPU:
`sharding.parallel.Parallelism`, the LM half of `launch.mesh`, every
architecture's parameter specs, `param_shardings`, `shard_params` /
`unshard_params`, and the elastic reshard on load
(`load_checkpoint(shardings=)`).

The reference's `Parallelism` and `parallelism_for` read a mesh's
`shape` and `axis_names` only (its `constrain` needs JAX devices, so it
is not called), so they run here over a stand-in with the port's mesh's
names and sizes, as tests/test_torch_dist_tables.py builds the
reference's engine over a stand-in mesh.  Specs are compared leaf for
leaf with the reference's `model.defs()` (the reference stacks the
superblocks' defs on a leading axis, the port keeps a list, so the
reference's leading None and stacked dim are dropped), for the full
configs of all ten architectures: defs only, nothing is allocated.
The file takes a few seconds.
"""
from dataclasses import fields
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.launch.mesh import parallelism_for as jparallelism_for
from repro.models import build_model as jbuild_model
from repro.models.params import ParamDef as JParamDef
from repro.sharding.parallel import Parallelism as JParallelism
from repro_torch.ckpt import load_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import (ensure_host_device_count,
                                     host_device_mesh, make_mesh_compat,
                                     make_production_mesh, parallelism_for)
from repro_torch.models import weight_structs
from repro_torch.models.params import (Sharding, map_tree, param_shardings,
                                       shard_params, tree_leaves,
                                       unshard_params)
from repro_torch.models.transformer import model_defs
from repro_torch.sharding.parallel import NONE, Parallelism

from test_torch_train import reference_weights

MESHES = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _stand_in(mesh):
    return SimpleNamespace(shape=dict(mesh.shape), axis_names=mesh.axis_names)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_parallelism_matches_reference(shape, axes):
    mesh = make_mesh_compat(shape, axes, "cpu")
    assert mesh.shape == dict(zip(axes, shape))
    assert mesh.axis_names == axes and mesh.size == int(np.prod(shape))
    for kw in (dict(), dict(hierarchical=False, moe_seq_shard=True,
                            q_chunk=128, kv_chunk=512, use_pallas=True)):
        par = parallelism_for(mesh, **kw)
        ref = jparallelism_for(_stand_in(mesh), **kw)
        for f in fields(JParallelism):
            if f.name != "mesh":
                assert getattr(par, f.name) == getattr(ref, f.name), f.name
        assert par.mesh is mesh
        assert (par.dp, par.tp, par.dp_size(), par.tp_size()) == (
            ref.dp, ref.tp, ref.dp_size(), ref.tp_size())
    # the same fields and defaults, and NONE's sizes
    assert [f.name for f in fields(Parallelism)] == [
        f.name for f in fields(JParallelism)]
    assert Parallelism() == NONE
    assert (NONE.dp, NONE.dp_size(), NONE.tp_size()) == (None, 1, 1)
    x = torch.ones(2, 3)
    assert par.constrain(x, par.dp, None) is x   # no GSPMD: a no-op


def test_production_mesh_and_host_mesh():
    one, two = make_production_mesh(device="cpu"), make_production_mesh(
        multi_pod=True, device="cpu")
    assert (one.axis_names, one.shape) == (("data", "model"),
                                           {"data": 16, "model": 16})
    assert (two.axis_names, two.shape) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    for mesh in (one, two):
        par, ref = parallelism_for(mesh), jparallelism_for(_stand_in(mesh))
        assert (par.data_axes, par.pod_axis, par.dp_size(), par.tp_size()) \
            == (ref.data_axes, ref.pod_axis, ref.dp_size(), ref.tp_size())
    # ranks numbered row-major over the axes, as jax.make_mesh numbers them
    assert two.coords(17) == (0, 1, 1) and two.rank_of((1, 0, 3)) == 259
    assert two.group_ranks(17, "data")[:3] == [1, 17, 33]
    host = host_device_mesh(8)
    assert (host.axis_names, host.size, host.device.type) == (("ranks",), 8,
                                                              "cpu")
    assert host_device_mesh(4, axis="proc").axis_names == ("proc",)
    ensure_host_device_count(512)
    with pytest.raises(ValueError):
        ensure_host_device_count(0)


def _spec_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch):
    jdefs = jbuild_model(jget_config(arch)).defs()
    defs = model_defs(get_config(arch))
    n = 0
    for key, sub in defs.items():
        if key in ("blocks", "enc_blocks"):
            want = jax.tree.map(
                lambda d: (tuple(d.shape[1:]), tuple(d.spec[1:]), d.init,
                           d.scale, d.dtype), jdefs[key],
                is_leaf=lambda x: isinstance(x, JParamDef))
            assert all(d.spec[0] is None for d in jax.tree.leaves(
                jdefs[key], is_leaf=lambda x: isinstance(x, JParamDef)))
            for block in sub:
                got = map_tree(lambda d: (tuple(d.shape), tuple(d.spec),
                                          d.init, d.scale, d.dtype), block)
                assert dict(_spec_leaves(got)) == dict(_spec_leaves(
                    jax.tree.map(lambda x: x, want, is_leaf=lambda x:
                                 isinstance(x, tuple))))
                n += len(list(_spec_leaves(got)))
        else:
            d, j = sub, jdefs[key]
            assert (d.shape, d.spec, d.init, d.scale, d.dtype) == (
                j.shape, j.spec, j.init, j.scale, j.dtype), key
            n += 1
    assert n > 0


@pytest.mark.parametrize("shape,axes", MESHES)
def test_shard_unshard_round_trip(shape, axes):
    cfg = get_config("dbrx-132b", smoke=True)
    mesh = make_mesh_compat(shape, axes, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = map_tree(lambda t: torch.randn(t.shape, generator=gen).to(
        t.dtype), weight_structs(cfg))
    sh = param_shardings(model_defs(cfg), mesh)
    blocks = shard_params(params, sh)
    w = params["blocks"][0]["moe0"]["w_down"]        # ("model", None, "data")
    b = blocks["blocks"][0]["moe0"]["w_down"]
    E, F, D = w.shape
    for r in range(mesh.size):
        c = dict(zip(axes, mesh.coords(r)))
        m, d = c["model"], c["data"]
        k = mesh.shape["data"]
        assert torch.equal(b[r], w[m * E // 2:(m + 1) * E // 2, :,
                                   d * D // k:(d + 1) * D // k])
    assert b.shape == (mesh.size, E // 2, F, D // mesh.shape["data"])
    back = unshard_params(blocks, sh)
    for x, y in zip(tree_leaves(params), tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # fsdp_pod widens 'data' to ('pod', 'data') on a mesh with a pod axis
    wide = param_shardings(model_defs(cfg), mesh, fsdp_pod=True)
    spec = wide["blocks"][0]["moe0"]["w_down"].spec
    assert spec == (("model", None, ("pod", "data")) if "pod" in axes
                    else ("model", None, "data"))
    for x, y in zip(tree_leaves(params), tree_leaves(unshard_params(
            shard_params(params, wide), wide))):
        assert torch.equal(x, y)
    assert param_shardings(model_defs(cfg), None)["embed"] is None
    with pytest.raises(ValueError, match="does not split"):
        Sharding(mesh, ("model",)).block_shape((3,))


def test_reference_checkpoint_reshards_on_load(tmp_path):
    cfg, _, params = reference_weights("qwen3-0.6b", "bfloat16")
    jckpt.save_checkpoint(str(tmp_path), 3, {"params": params},
                          extra={"data": {"step": 3}})
    mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
    tcfg = get_config("qwen3-0.6b", smoke=True)
    sh = param_shardings(model_defs(tcfg), mesh)
    got, extra = load_checkpoint(str(tmp_path), 3,
                                 {"params": weight_structs(tcfg)},
                                 shardings={"params": sh})
    assert extra == {"data": {"step": 3}}
    whole = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    for (name, blk), (_, w), (_, s) in zip(_spec_leaves(got["params"]),
                                           _spec_leaves(whole),
                                           _spec_leaves(sh)):
        assert blk.shape == (4,) + s.block_shape(w.shape), name
        for r in range(4):
            assert torch.equal(blk[r], s.block(w, r)), name
    wq = got["params"]["blocks"][0]["attn0"]["wq"]   # ("data", "model")
    d_in, d_out = whole["blocks"][0]["attn0"]["wq"].shape
    assert wq.shape == (4, d_in // 2, d_out // 2)
    assert wq.dtype == torch.bfloat16
