"""Multi-pod dry run: every (architecture x input shape) cell's step on the
`meta` device over the production mesh, with its per-rank memory, FLOPs,
bytes and collective traffic; the port of `repro.launch.dryrun`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \
      --shape train_4k [--multi-pod] [--flat] [--opt-moe] [--fsdp-pod] \
      [--out artifacts/] [--skip-existing]

The reference lowers and compiles each cell's jitted step on the 256- or
512-device production mesh and reads XLA's memory and cost analyses and the
collective bytes of the compiled HLO.  The port has no XLA: `lower_cell`
runs the cell's step itself, on meta tensors (shapes and types, no storage,
nothing computed), through the port's entry points (`make_train_step`,
`Model.prefill`, `Model.decode_step`; K4 and K5 stand in on meta,
`kernels/attention.py`, `kernels/rwkv.py`), under the walker of
`analysis.hlo_walk`, which counts what the program dispatches.  Nothing is
allocated, so the full-size cells run on a CPU.

The artifact describes the program of one rank, as the reference's
post-SPMD figures do.  The mesh is `make_production_mesh(multi_pod=...,
device="meta")`, (16, 16) ('data', 'model') or (2, 16, 16) ('pod', 'data',
'model').  One data rank runs (`local_parallelism`): its ranks of data
coordinate 0 as a `core.dist.comm.RowComm` on meta, its 16 model ranks
stacked (every family: `models.tp` places rwkv6's time-mix heads and
channel-mix columns and hymba's attention heads and SSM channels as it
places the other families' heads and columns; the one rank where the
mesh has no model axis of more than one rank); collectives along the
model axis run over the row, those along
the data axes give meta results and record their bytes against the whole
mesh.  The weights are the blocks and FSDP cuts `tp.shard_model` gives
that row (over 'data', or ('pod', 'data') with `--fsdp-pod`):

  train    global_batch / dp_size sequences in `_micro_batches` micro-
           batches (the reference's arithmetic), the train step with its
           per-superblock gathers, the reduce-scatters of their backwards
           and the rest of the gradient reduction (`train_step.comm`'s
           stages, under `port.reduction`);
  prefill, B / dp_size sequences where dp_size divides the batch, else the
  decode   whole batch (the reference replicates it then); S_max is
           seq_len + 128 for a prefill and seq_len for a decode step,
           whose cache comes from `decode.init_cache(..., device="meta",
           par)` (the model ranks' key/value heads).

The 16 or 32 data ranks are never summed into a per-rank figure.  Where
ranks are stacked (the row's model ranks), the walker counts the stacked
total and derives one rank's share: the work inside the stacked scope
(and the backward of what it made), the bytes it allocates and the
stacked arguments (weight blocks and cuts, optimizer state, caches:
`Walker.track(..., L)`) count 1/L each, L the stacked ranks; each
collective's bytes are one rank's result already.  `port.stacked` keeps
the totals as run.

Artifact keys are the reference's, so its `report` and `roofline` read a
port artifact unchanged:

  lower_s     seconds to build the rank's arguments and step;
  compile_s   seconds of the meta run (of the step and the reduction);
  flops       the walked dot FLOPs; bytes_accessed the walked bytes read
              plus written: eager execution counts every loop trip, so
              neither has XLA's once-per-computation undercount;
  memory      per rank: `argument_size_in_bytes` under the reference's
              shardings (param and cache specs, batch over the data axes:
              what XLA's figure means; an uneven dim rounds up, as XLA
              pads it), `temp_size_in_bytes` the walker's peak less the
              arguments the rank holds, `output_size_in_bytes` the step's
              outputs under the same shardings, and
              `generated_code_size_in_bytes` 0;
  collectives `analysis.hlo.collective_bytes` of the records;
  walked      `weighted_analysis`'s keys, per rank.

The port's own figures are under `port`: the bytes the rank holds under
the port's placement (`held_bytes`, split in `held` into parameters,
optimizer state, batch and caches: the blocks of the 'model' entries of
the reference's specs cut over their 'data' entries, `models.tp`), its
peak (`peak_bytes`, against one 80 GB card:
`fits_80gb`), the kernels' launches, operations and bytes, the dot FLOPs
as the card runs them (`dot_flops_card`: the kernels' operations in place
of the reference's dots, what the H100 roofline reads), the step's walk,
the reduction's stages, and the stacked totals.  `save_artifact` writes no
`.hlo.gz`: there is no HLO.  Failures are recorded as artifacts too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis.hlo import collective_bytes
from repro_torch.analysis.hlo_walk import Walker
from repro_torch.configs import (SHAPES, cell_enabled, get_config,
                                 input_specs, list_archs)
from repro_torch.configs.base import active_param_count, param_count
from repro_torch.core.dist.comm import RowComm
from repro_torch.launch.mesh import make_production_mesh, parallelism_for
from repro_torch.models import decode as decode_mod
from repro_torch.models import tp as tp_mod
from repro_torch.models import transformer as tf
from repro_torch.models.params import (Sharding, map_tree, param_shardings,
                                       param_structs, tree_leaves)
from repro_torch.models.registry import Model, init_weights, weight_structs
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

__all__ = ["lower_cell", "save_artifact", "batch_shardings",
           "cache_shardings", "rank_batch", "local_parallelism",
           "rank_program", "walk_program", "CARD_BYTES", "main"]

CARD_BYTES = 80 * 10 ** 9       # one H100's memory, 80 GB


def _micro_batches(cfg, shape, dp_size: int, budget_bytes: float = 2.5e9) -> int:
    """Grad-accumulation microbatches so per-device remat checkpoints fit."""
    layers = cfg.n_layers + cfg.n_enc_layers
    per_layer = shape.global_batch / dp_size * shape.seq_len * cfg.d_model * 2
    n = max(1, math.ceil(per_layer * layers / budget_bytes))
    n = 1 << (n - 1).bit_length()                  # next pow2
    return min(n, shape.global_batch // dp_size * 0 + max(1, shape.global_batch // dp_size))


def batch_shardings(cfg, shape, mesh, par) -> dict:
    """Per input, its `Sharding` on the mesh: the reference's specs, batch
    over the data axes (replicated when they do not divide it), `pos`
    replicated."""
    dp = par.data_axes
    specs = {}
    for name, struct in input_specs(cfg, shape).items():
        if name == "pos" or shape.global_batch % par.dp_size() != 0:
            spec = ()
        elif struct.dim() == 2:
            spec = (dp, None)
        else:
            spec = (dp, None, None)
        specs[name] = Sharding(mesh, spec)
    return specs


def cache_shardings(cfg, mesh, par, cache, batch_shardable: bool):
    """Per cache leaf, its `Sharding`: the reference's key-path rules (batch
    over data, the cache's sequence over model, recurrent states' channels
    over model).  The reference stacks the superblocks' caches on a leading
    axis (a dense model's also on a sublayer axis); the port keeps one
    entry per superblock, so each spec is the reference's with those
    leading `None` entries dropped: its last `ndim` entries."""
    dp = par.data_axes if batch_shardable else None
    tp = par.model_axis
    rules = {"k": (None, dp, tp, None, None), "v": (None, dp, tp, None, None),
             "k_loc": (None, dp, tp, None, None),
             "v_loc": (None, dp, tp, None, None),
             "k_glob": (dp, tp, None, None), "v_glob": (dp, tp, None, None),
             "wkv": (dp, tp, None, None), "tm_tok": (dp, None, None),
             "cm_tok": (dp, None, None), "conv": (dp, None, None),
             "ssm_h": (dp, tp, None), "memory": (dp, None, None)}

    def one(key, t):
        spec = rules.get(key)
        return Sharding(mesh, () if spec is None else spec[-t.dim():])

    out = {k: v for k, v in cache.items() if k != "blocks"}
    out = {k: one(k, v) for k, v in out.items()}
    out["blocks"] = [{k: one(k, v) for k, v in c.items()}
                     for c in cache["blocks"]]
    return out


def _block_bytes(t: torch.Tensor, sh: Sharding | None) -> int:
    """One rank's bytes of t under a sharding (an uneven dim rounds up, as
    XLA pads it)."""
    n = t.element_size()
    spec = tuple(sh.spec) if sh is not None else ()
    for i, d in enumerate(t.shape):
        e = spec[i] if i < len(spec) else None
        k = sh.mesh.axis_size(e) if e else 1
        n *= -(-d // k)
    return n


def _sharded_bytes(tree, shardings) -> int:
    return sum(_block_bytes(t, s) for t, s in
               zip(tree_leaves(tree), tree_leaves(shardings)))


def _whole_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def rank_batch(shape, dp_size: int) -> int:
    """The sequences one data rank runs: B / dp_size where it divides, else
    the whole (replicated) batch."""
    B = shape.global_batch
    return B // dp_size if B % dp_size == 0 else B


def _inputs(cfg, shape, B: int, device, gen) -> dict:
    """The rank's batch: `input_specs`' names and types at batch B on
    `device` (meta: empty; else drawn from `gen`), `pos` as the decode
    step takes it (a 0-d int64 tensor, the last position)."""
    out = {}
    for name, s in input_specs(cfg, shape).items():
        shp = (B,) + tuple(s.shape[1:]) if s.dim() else ()
        if name == "pos":
            out[name] = torch.full((), shape.seq_len - 1, dtype=torch.long,
                                   device=device)
        elif str(device) == "meta":
            out[name] = torch.empty(shp, dtype=s.dtype, device="meta")
        elif s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab, shp, generator=gen,
                                      dtype=torch.int32, device=device)
        else:
            out[name] = (torch.randn(shp, generator=gen, device=device)
                         * 0.1).to(s.dtype)
    return out


def local_parallelism(par, cfg):
    """The `Parallelism` of one data rank's program on meta (module
    docstring): `par` with its mesh a `RowComm` of the ranks of data
    coordinate 0, over the model axis where it has more than one rank,
    else the one rank."""
    covered = cfg.family in tp_mod.COVERED and par.tp_size() > 1
    row = RowComm(par.mesh.dims, par.mesh.axis_names,
                  (par.model_axis,) if covered else (), device="meta")
    return dataclasses.replace(par, mesh=row)


def rank_program(cfg, shape, par, *, n_micro: int = 1, B: int | None = None,
                 device="meta", seed: int = 0, fsdp_pod: bool = False):
    """(arguments, run) of one data rank's step: the arguments the rank
    holds ({"params", "opt", "batch", "cache"} as the kind needs; meta
    tensors on meta, a seeded random init elsewhere) and `run()`, which
    runs the step on them.  `par` is the rank's `Parallelism`
    (`local_parallelism`'s on meta; a mesh whose every rank this process
    holds elsewhere); B the rank's sequences (default: the shape's);
    `fsdp_pod`, the weights cut over ('pod', 'data')."""
    B = shape.global_batch if B is None else B
    dev = torch.device(device)
    meta = dev.type == "meta"
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
    train = shape.kind == "train"
    tp = tp_mod.plan(cfg, par)
    params = weight_structs(cfg) if meta else init_weights(cfg, seed=seed,
                                                           device=dev)
    if tp is not None:
        params = tp_mod.shard_model(params, cfg, par.mesh, par.model_axis,
                                    data_axes=par.data_axes,
                                    fsdp_pod=fsdp_pod)
    if train:
        params = map_tree(lambda t: t.requires_grad_(), params)
    batch = _inputs(cfg, shape, B, dev, gen)
    if train:
        opt = init_opt_state(params)
        step = make_train_step(cfg, AdamWConfig(), n_micro=n_micro, par=par)
        args, run = _ranked({"params": params, "opt": list(opt[:3]),
                             "batch": batch},
                            lambda: step(params, opt, batch), tp)
        run.step = step
        return args, run
    model = Model(cfg, params)
    if shape.kind == "prefill":
        S_max = shape.seq_len + 128

        def run():
            with torch.no_grad():
                return model.prefill(batch["tokens"], S_max,
                                     frames=batch.get("frames"),
                                     vis=batch.get("vis"), par=par)
        return _ranked({"params": model.params, "batch": batch}, run, tp)
    cache = decode_mod.init_cache(cfg, B, shape.seq_len, dev, par)

    def run():
        with torch.no_grad():
            return model.decode_step(cache, batch["tokens"], batch["pos"],
                                     par=par)
    return _ranked({"params": model.params, "batch": batch, "cache": cache},
                   run, tp)


def _ranked(args, run, tp):
    """`run` marked with the stacked ranks that hold the weights and
    optimizer state (`ranks`) and the caches (`cache_ranks`: one a rank
    under the rank program over a model axis, whole under the
    whole-leaf one); `walk_program` counts 1/L of them a rank."""
    run.ranks = tp.L if tp is not None and tp.stacked else 1
    run.cache_ranks = run.ranks if tp is not None and tp.covered else 1
    return args, run


def _ranks_of(run, key: str) -> int:
    if key == "batch":
        return 1
    if key == "cache":
        return getattr(run, "cache_ranks", 1)
    return getattr(run, "ranks", 1)


def held_parts(args, run) -> dict:
    """One rank's bytes of each argument (the batch whole, the rest 1/L
    of the stacked ranks')."""
    return {k: _whole_bytes(v) / _ranks_of(run, k) for k, v in args.items()}


def walk_program(args, run, device_type: str = "meta") -> tuple:
    """Run a rank program under a walker: (the walker, seconds, one rank's
    bytes of the arguments, `held_parts` summed).  The step's outputs are
    dropped."""
    t0 = time.perf_counter()
    with Walker(device_type) as w:
        for k, v in args.items():
            w.track(v, _ranks_of(run, k))
        out = run()
        del out
    held = int(round(sum(held_parts(args, run).values())))
    return w, time.perf_counter() - t0, held


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               hierarchical: bool = True, donate: bool = True,
               moe_seq_shard: bool = False, fsdp_pod: bool = False):
    """One cell's per-rank artifact on meta: (result, None).  `donate` is
    the reference's and changes nothing here: the port's step keeps its
    inputs until the caller drops them.  The second item stands where the
    reference returns its HLO text; the port has none."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_enabled(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}, None
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    par = parallelism_for(mesh, hierarchical=hierarchical,
                          moe_seq_shard=moe_seq_shard)
    dp = par.dp_size()
    local = local_parallelism(par, cfg)
    B = rank_batch(shape, dp)
    defs = tf.model_defs(cfg)
    pstructs, pshard = param_structs(defs), param_shardings(
        defs, mesh, fsdp_pod=fsdp_pod)
    gspecs = input_specs(cfg, shape)
    arg_bytes = (_sharded_bytes(pstructs, pshard)
                 + _sharded_bytes(gspecs, batch_shardings(cfg, shape, mesh,
                                                          par)))
    extra = {}
    if shape.kind == "train":
        n_micro = _micro_batches(cfg, shape, dp)
        extra["n_micro"] = n_micro
        opt_bytes = 3 * sum(_block_bytes(t.float(), s) for t, s in zip(
            tree_leaves(pstructs), tree_leaves(pshard))) + 4
        arg_bytes += opt_bytes
        out_bytes = _sharded_bytes(pstructs, pshard) + opt_bytes + 3 * 4
        args, run = rank_program(cfg, shape, local, n_micro=n_micro, B=B,
                                 fsdp_pod=fsdp_pod)
    else:
        S_max = shape.seq_len + (128 if shape.kind == "prefill" else 0)
        shardable = shape.global_batch % dp == 0
        gcache = decode_mod.init_cache(cfg, shape.global_batch, S_max,
                                       "meta")
        cache_bytes = _sharded_bytes(gcache, cache_shardings(
            cfg, mesh, par, gcache, shardable))
        logits = torch.empty((shape.global_batch, 1, tf.padded_vocab(cfg)),
                             dtype=getattr(torch, cfg.dtype), device="meta")
        out_bytes = cache_bytes + _block_bytes(logits, Sharding(
            mesh, (par.data_axes if shardable else None,)))
        if shape.kind == "decode":
            arg_bytes += cache_bytes
        args, run = rank_program(cfg, shape, local, B=B, fsdp_pod=fsdp_pod)
    t_lower = time.perf_counter() - t0

    w_step, t_step, held = walk_program(args, run)
    step = w_step.result()
    walked = {k: v for k, v in step.items() if k != "port"}
    peak = step["port"]["peak_bytes"]
    kernels = step["port"]["kernels"]
    read_bytes = step["port"]["read_bytes"]
    coll = collective_bytes(w_step.records)
    stages = run.step.comm if shape.kind == "train" else None
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "hierarchical": hierarchical,
        "mesh": list(mesh.dims), "axes": list(mesh.axis_names),
        "lower_s": round(t_lower, 3), "compile_s": round(t_step, 3),
        "flops": walked["dot_flops"],
        "bytes_accessed": walked["result_bytes"] + read_bytes,
        "memory": {
            "temp_size_in_bytes": int(peak - held),
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "generated_code_size_in_bytes": 0,
        },
        "collectives": coll,
        "walked": walked,
        "params": param_count(cfg),
        "active_params": active_param_count(cfg),
        **extra,
        "port": {
            "device": "meta", "dp_size": dp, "rank_batch": B,
            "model_ranks_stacked": len(local.mesh.local_ranks),
            "fsdp_pod": fsdp_pod,
            "held_bytes": int(held),
            "held": {k: int(round(v)) for k, v in held_parts(
                args, run).items()},
            "peak_bytes": int(peak),
            "fits_80gb": bool(peak <= CARD_BYTES),
            "kernels": kernels,
            "dot_flops_card": step["port"]["dot_flops_card"],
            "read_bytes": read_bytes,
            "step": step,
            "reduction": (None if stages is None else
                          {"stages": [dict(s, axes=list(s["axes"]))
                                      for s in stages]}),
            "stacked": step["port"]["stacked"],
            "per_rank": "one data rank's program; its stacked model-axis "
                        "ranks (the weight blocks and FSDP cuts of "
                        "models.tp) count 1/L each (analysis.hlo_walk)",
        },
    }
    return result, None


def save_artifact(path: str, res: dict, hlo_txt: str | None = None):
    """The artifact as JSON (the reference also writes its HLO text; the
    port has none, and `hlo_txt` is ignored)."""
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--flat", action="store_true",
                    help="disable hierarchical (HSDX-style) collectives")
    ap.add_argument("--opt-moe", action="store_true",
                    help="sequence-sharded MoE dispatch (perf hillclimb)")
    ap.add_argument("--fsdp-pod", action="store_true",
                    help="flat ZeRO-3 across pods (vs pod-replicated params "
                         "+ cross-pod grad all-reduce, the default)")
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{'2pod' if args.multi_pod else '1pod'}"
            if args.flat:
                tag += "__flat"
            if args.opt_moe:
                tag += "__optmoe"
            if args.fsdp_pod:
                tag += "__fsdppod"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            t0 = time.perf_counter()
            try:
                res, _ = lower_cell(arch, shape, args.multi_pod,
                                    hierarchical=not args.flat,
                                    moe_seq_shard=args.opt_moe,
                                    fsdp_pod=args.fsdp_pod)
            except Exception as e:  # record failures as artifacts too
                res = {"arch": arch, "shape": shape,
                       "multi_pod": args.multi_pod,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-3000:]}
            save_artifact(path, res)
            status = ("SKIP " + res["skipped"]) if "skipped" in res else \
                ("ERROR " + res["error"][:120]) if "error" in res else \
                (f"ok lower={res['lower_s']}s compile={res['compile_s']}s "
                 f"coll={res['collectives']['total_bytes']/1e9:.2f}GB/rank "
                 f"peak={res['port']['peak_bytes']/1e9:.2f}GB/rank")
            print(f"[dryrun] {tag}: {status} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[dryrun] all cells: {time.perf_counter() - t_all:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
