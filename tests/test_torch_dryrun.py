"""The port's dry run (`repro_torch.launch.dryrun`, `configs.input_specs`)
against the JAX reference's, on the CPU.

The cell tables are compared for all 40 (architecture x shape) cells in
both layouts, (16, 16) and (2, 16, 16): `input_specs` (names, shapes,
types by name), `cell_enabled` (33 cells a layout) and `_micro_batches`;
in every enabled cell `batch_shardings` and `cache_shardings` entry for
entry against the reference's `PartitionSpec`s over a
`jax.sharding.AbstractMesh` of the same axes (the reference stacks the
superblocks' caches on leading axes, the port keeps one entry per
superblock: the reference's leading entries, all None, are dropped).

The dry run's FLOPs against the reference's walked HLO: qwen3's smoke
config prefilled on a (2, 1) host mesh (the reference lowered in a
subprocess with two host devices, the port's one data rank on meta).
One full-size cell runs end to end (smollm-360m train_4k on (16, 16),
~25 s), every tensor the walker sees on meta (and 0-d host scalars).
"""
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_enabled as jcell_enabled
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs as jlist_archs
from repro_torch.analysis import hlo_walk
from repro_torch.configs import (SHAPES, cell_enabled, get_config, get_shape,
                                 input_specs, list_archs)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_mesh_compat, make_production_mesh,
                                     parallelism_for)
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tf
from repro_torch.models import weight_structs
from repro_torch.models.params import Sharding, tree_leaves
from repro_torch.models.tp import model_shardings
from repro_torch.models.transformer import padded_vocab
from repro_torch.sharding.parallel import NONE, Parallelism

LAYOUTS = [False, True]
CELLS = [(a, s) for a in list_archs() for s in SHAPES]


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dryrun module (its import sets XLA_FLAGS, which is
    put back afterwards: JAX has started already in this process)."""
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def _abstract_mesh(multi_pod):
    from jax.sharding import AbstractMesh
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _norm(entry):
    """A spec entry as a tuple of axis names (None: not split)."""
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec(spec, ndim):
    s = tuple(_norm(e) for e in spec)
    return s + (None,) * (ndim - len(s))


def test_arch_and_shape_tables_match_reference():
    assert list_archs() == jlist_archs() and len(CELLS) == 40
    assert list(SHAPES) == list(JSHAPES)
    for name, sh in SHAPES.items():
        j = JSHAPES[name]
        assert (sh.name, sh.seq_len, sh.global_batch, sh.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
        assert get_shape(name) == sh


@pytest.mark.parametrize("multi_pod", LAYOUTS, ids=["1pod", "2pod"])
def test_cells_specs_and_micro_batches_match_reference(jdryrun, multi_pod):
    dp = 32 if multi_pod else 16
    enabled = 0
    for arch, shape_name in CELLS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        sh, jsh = SHAPES[shape_name], JSHAPES[shape_name]
        ok, why = cell_enabled(cfg, sh)
        assert (ok, why) == jcell_enabled(jcfg, jsh)
        enabled += ok
        got, want = input_specs(cfg, sh), jinput_specs(jcfg, jsh)
        assert list(got) == list(want), (arch, shape_name)
        for name, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[name].shape)
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype)
        if sh.kind == "train":
            assert dryrun._micro_batches(cfg, sh, dp) == \
                jdryrun._micro_batches(jcfg, jsh, dp)
    assert enabled == 33


@pytest.mark.parametrize("multi_pod", LAYOUTS, ids=["1pod", "2pod"])
def test_batch_and_cache_shardings_match_reference(jdryrun, multi_pod):
    from repro.launch.mesh import parallelism_for as jparallelism_for
    from repro.models import build_model as jbuild_model
    jmesh = _abstract_mesh(multi_pod)
    jpar = jparallelism_for(jmesh)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    par = parallelism_for(mesh)
    checked = 0
    for arch, shape_name in CELLS:
        cfg, sh = get_config(arch), SHAPES[shape_name]
        if not cell_enabled(cfg, sh)[0]:
            continue
        jcfg, jsh = jget_config(arch), JSHAPES[shape_name]
        got = dryrun.batch_shardings(cfg, sh, mesh, par)
        want = jdryrun.batch_shardings(jcfg, jsh, jmesh, jpar)
        assert list(got) == list(want)
        for name, s in got.items():
            nd = input_specs(cfg, sh)[name].dim()
            assert s.mesh is mesh
            assert _spec(s.spec, nd) == _spec(want[name].spec, nd), (
                arch, shape_name, name)
        if sh.kind != "decode":
            continue
        B, S_max = sh.global_batch, sh.seq_len
        shardable = B % par.dp_size() == 0
        cache = decode_mod.init_cache(cfg, B, S_max, "meta")
        jstruct = jbuild_model(jcfg).cache_struct(B, S_max)
        got = dryrun.cache_shardings(cfg, mesh, par, cache, shardable)
        want = jdryrun.cache_shardings(jcfg, jmesh, jpar, jstruct, shardable)
        assert set(cache) == set(jstruct), arch
        assert set(cache["blocks"][0]) == set(jstruct["blocks"]), arch
        pairs = [(k, cache[k], got[k], want[k], jstruct[k])
                 for k in cache if k != "blocks"]
        for i, c in enumerate(cache["blocks"]):
            pairs += [(k, c[k], got["blocks"][i][k], want["blocks"][k],
                       jstruct["blocks"][k]) for k in c]
        for key, t, s, w, js in pairs:
            ws = _spec(w.spec, len(js.shape))
            lead = len(js.shape) - t.dim()
            assert ws[:lead] == (None,) * lead, (arch, key, ws)
            assert _spec(s.spec, t.dim()) == ws[lead:], (arch, key)
            checked += 1
    assert checked > 0


def test_rank_batch_and_local_parallelism():
    one = make_production_mesh(device="meta")
    par = parallelism_for(one)
    assert dryrun.rank_batch(SHAPES["prefill_32k"], 16) == 2
    assert dryrun.rank_batch(SHAPES["decode_32k"], 32) == 4
    assert dryrun.rank_batch(SHAPES["long_500k"], 16) == 1
    # one data rank: the ranks of data coordinate 0 of the whole mesh, the
    # model axis stacked on meta (every family models.tp covers)
    for arch in ("smollm-360m", "dbrx-132b", "rwkv6-1.6b", "hymba-1.5b"):
        local = dryrun.local_parallelism(par, get_config(arch))
        mesh = local.mesh
        assert mesh.device.type == "meta" and mesh.n_ranks == 256
        assert mesh.axis_names == ("data", "model")
        assert mesh.axis_index("model") == list(range(16))
        assert set(mesh.axis_index("data")) == {0}
    # no model axis of more than one rank: the one rank, whose program is
    # the whole-leaf one
    flat = parallelism_for(make_mesh_compat((16, 1), ("data", "model"),
                                            "meta"))
    local = dryrun.local_parallelism(flat, get_config("rwkv6-1.6b"))
    assert local.mesh.local_ranks == (0,) and local.mesh.n_ranks == 16


_REF_PREFILL = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    from repro.analysis.hlo_walk import weighted_analysis
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import dryrun
    from repro.launch.mesh import make_mesh_compat, parallelism_for
    from repro.models import build_model
    cfg = get_config("qwen3-0.6b", smoke=True)
    shape = ShapeConfig("p", 256, 4, "prefill")
    mesh = make_mesh_compat((2, 1), ("data", "model"))
    par = parallelism_for(mesh)
    model = build_model(cfg)
    fn = jax.jit(lambda p, b: model.prefill(p, b, par, 256 + 128),
                 in_shardings=(model.param_shardings(mesh),
                               dryrun.batch_shardings(cfg, shape, mesh, par)))
    txt = fn.lower(model.param_structs(),
                   dryrun.input_specs(cfg, shape)).compile().as_text()
    print("DOT", weighted_analysis(txt)["dot_flops"])
""").strip()


def _port_prefill_flops(cfg, B, S):
    shape = ShapeConfig("p", S, B, "prefill")
    w, _, _ = dryrun.walk_program(*dryrun.rank_program(cfg, shape, NONE,
                                                       B=B))
    return w.result()


def test_prefill_dot_flops_near_reference_walk():
    """qwen3-smoke, 4 x 256 tokens on a (2, 1) mesh: one rank prefills 2
    sequences.  The reference's prefill runs the blocks twice: a forward
    for the last hidden state, then a second pass over the same sublayers
    that collects the caches (XLA merges that pass's repeated key and
    value projections, so they cost nothing more); the port's prefill
    collects them in its one pass.  Both take the last token's logits once,
    and both count attention over every (query, key) pair (the reference's
    causal attention is plain dots over all pairs; K4 reports 4 B H S^2 hd
    the same way), so no causal overcount separates them, and a prefill
    has neither remat nor chunked attention.  So the reference's per-device
    dot FLOPs are 2 (port - logits) + logits, held within 1e-6."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _REF_PREFILL],
                         capture_output=True, text=True, env=env, timeout=600)
    line = [x for x in out.stdout.splitlines() if x.startswith("DOT")]
    assert line, (out.stdout[-500:], out.stderr[-2000:])
    ref = float(line[0].split()[1])
    cfg = get_config("qwen3-0.6b", smoke=True)
    B, S = 2, 256
    got = _port_prefill_flops(cfg, B, S)
    assert got["port"]["kernels"]["K4"]["launches"] == cfg.n_layers
    logits = 2.0 * B * cfg.d_model * padded_vocab(cfg)
    assert math.isclose(ref, 2 * (got["dot_flops"] - logits) + logits,
                        rel_tol=1e-6), (ref, got["dot_flops"], logits)


def test_full_size_train_cell_on_meta_end_to_end():
    """smollm-360m train_4k on (16, 16): an `ok` artifact with every
    reference key, one data rank's 16 sequences in 2 micro-batches on its
    16 stacked model ranks, K4 once a layer a micro-batch and again in
    each superblock's recompute on the 15 model ranks that hold a query
    head (15 heads over 5 KV heads at tp 16: one rank holds none); FSDP
    over 'data': the rank holds 1/16 of its blocks, each superblock's
    cuts all-gathered (again in its recompute) and their float32
    gradient reduce-scattered in its backward (the tied embedding twice:
    its lookup and the head), the other leaves and the loss all-reduced
    over 'data', beside the model axis's all-reduces and all-gathers;
    every tensor the walker sees lies on meta (host scalars aside)."""
    seen = set()

    class Spy(hlo_walk.Walker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            for a in list(args) + list((kwargs or {}).values()) + [out]:
                for t in (a if isinstance(a, (list, tuple)) else [a]):
                    if isinstance(t, torch.Tensor):
                        seen.add((t.device.type, t.dim() == 0
                                  if t.device.type == "cpu" else True))
            return out

    real = dryrun.Walker
    dryrun.Walker = Spy
    try:
        res, none = dryrun.lower_cell("smollm-360m", "train_4k", False)
    finally:
        dryrun.Walker = real
    assert none is None
    assert seen <= {("meta", True), ("cpu", True)}, seen
    for key in ("arch", "shape", "multi_pod", "hierarchical", "mesh", "axes",
                "lower_s", "compile_s", "flops", "bytes_accessed", "memory",
                "collectives", "walked", "params", "active_params",
                "n_micro"):
        assert key in res, key
    assert set(res["memory"]) == {
        "temp_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes", "generated_code_size_in_bytes"}
    assert res["mesh"] == [16, 16] and res["n_micro"] == 2
    port = res["port"]
    assert port["rank_batch"] == 16 and port["dp_size"] == 16
    assert port["kernels"]["K4"]["launches"] == 32 * 2 * 2 * 15 / 16
    cfg = get_config("smollm-360m")
    mesh = make_production_mesh(device="meta")
    defs = tf.model_defs(cfg)
    sh = tree_leaves(model_shardings(defs, cfg, mesh))
    cut = sum(16 * math.prod(s.block_shape(d.shape)) for d, s in zip(
        tree_leaves(defs), sh) if s.cut_axes)
    rest = sum(math.prod(s.block_shape(d.shape)) for d, s in zip(
        tree_leaves(defs), sh) if not s.cut_axes)
    emb = 16 * math.prod(sh[0].block_shape(defs["embed"].shape))
    assert cfg.tie_embeddings and sh[0].cut_axes == ("data",)
    assert port["reduction"]["stages"] == [
        {"stage": "reduce_scatter", "axes": ["data"],
         "bytes_per_rank": 4 * 2 * (cut + emb)},
        {"stage": "all_reduce", "axes": ["data"],
         "bytes_per_rank": 4 * (rest + 1)}]
    # the walker records a reduce-scatter's result: 1/16 of what goes in
    assert port["step"]["collective_bytes"]["reduce-scatter"] == \
        4 * 2 * (cut + emb) // 16
    assert set(port["step"]["collective_bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter"}
    # held within the padding of the reference's argument bytes: the head
    # rule pads wq / wo to a whole head a rank (64 columns for 60) and
    # gives each rank a whole KV head (64 for 20)
    args = res["memory"]["argument_size_in_bytes"]
    assert args < port["held_bytes"] < 1.15 * args
    assert res["walked"]["inter_pod_bytes"] == 0
    assert res["memory"]["temp_size_in_bytes"] == \
        port["peak_bytes"] - port["held_bytes"]


@pytest.mark.parametrize("cut", [False, True])
def test_held_bytes_are_the_rank_blocks(cut):
    """qwen3-smoke on a (model 2) meta mesh, and one data rank of a (data 2,
    model 2) one (its row: FSDP cuts over 'data'): a train rank's held
    bytes are its weight blocks (cuts), their three float32 optimizer
    copies and the batch, and a decode rank's its weight blocks (cuts),
    its caches' key/value heads and the batch: each the sum of
    `_block_bytes` over the leaves it holds, under the reference's specs
    with their 'model' entries (and, cut, their 'data' entries)."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    if cut:
        mesh = make_mesh_compat((2, 2), ("data", "model"), "meta")
        par = dryrun.local_parallelism(Parallelism(
            mesh=mesh, data_axes=("data",), model_axis="model",
            remat=False), cfg)
        keep = ("data", "model")
    else:
        mesh = make_mesh_compat((2,), ("model",), "meta")
        par = Parallelism(mesh=mesh, model_axis="model", remat=False)
        keep = ("model",)

    def ref_spec(spec):
        return Sharding(mesh, tuple(e if e in keep else None for e in spec))

    defs = tf.model_defs(cfg)
    whole = weight_structs(cfg)
    sh = [ref_spec(d.spec) for d in tree_leaves(defs)]
    params = sum(dryrun._block_bytes(t, s)
                 for t, s in zip(tree_leaves(whole), sh))
    opt = 3 * sum(dryrun._block_bytes(t.float(), s)
                  for t, s in zip(tree_leaves(whole), sh))
    for kind, extra in (("train", opt), ("decode", None)):
        shape = ShapeConfig("c", 64, 4, kind)
        args, run = dryrun.rank_program(cfg, shape, par)
        assert run.ranks == 2
        _, _, held = dryrun.walk_program(args, run)
        batch = sum(t.numel() * t.element_size()
                    for t in args["batch"].values())
        if extra is None:           # the caches' heads over 'model'
            gcache = decode_mod.init_cache(cfg, 4, 64, "meta")
            extra = sum(dryrun._block_bytes(t, Sharding(
                mesh, (None, None, "model", None)))
                for t in tree_leaves(gcache))
        assert held == params + extra + batch, kind


def test_skipped_and_failed_cells_become_artifacts(tmp_path, monkeypatch):
    res, _ = dryrun.lower_cell("qwen3-0.6b", "long_500k", False)
    assert set(res) == {"arch", "shape", "skipped"}

    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    import json
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__1pod.json")
                     .read_text())
    assert rec["error"] == "RuntimeError: planted" and "trace" in rec
