"""Carry engine state and model weights across from NumPy.

The FMM has no trained weights: an evaluation's state is the geometry's
stacked engine tables plus the (x, q) payload.  `engine_tables_from_numpy`
builds the port's `EngineTables` on a device from a flat dictionary of NumPy
arrays and ints, whatever produced them — for instance the reference
package's `build_engine_tables`, flattened — so the port's engine can be run
on exactly another implementation's tables and payload:

    tables = engine_tables_from_numpy(arrays, device)
    phi = DeviceEngine(tables, x_pad, q_pad, device=device).evaluate()

Keys of `arrays`:

    n, n_parts, n_cells_max, n_bodies_max, p          ints
    up/<name>    every `BatchedUpwardSchedule.tables` entry (UP_KEYS)
    m2l/<name>   src, tgt, mask, d
    m2p/<name>   b, mask, centers, t_idx, t_valid
    p2p/<i>/<name>  t_idx, t_valid, s_idx, s_valid, mask for bucket i = 0, 1, ...
    l2p_t_idx, orig_idx, flat_idx

`lm_params_from_numpy(cfg, tree)` turns a language model's parameter tree,
as the reference package's `Model.init` lays it out and converted leaf by
leaf to NumPy, into the port's weight tree for `build_model(cfg, params=)`:
the `(n_superblocks, ...)` leaves under `blocks`, and under an encdec
model's `enc_blocks` the `(n_enc_layers, ...)` ones, are unstacked into one
tree per superblock (a gemma3 superblock holds `attn0` .. `attn5` and
`mlp0` .. `mlp5`, a moe one `attn0` and `moe0` with expert stacks (E, D, F)
and a float32 router, a vlm one `attn0` .. `attn3`, `cross4` and an MLP
each, a hymba one `attn0`, `ssm0` and `mlp0`, an encdec decoder layer
`attn0`, `dec_cross0` and `mlp0`), bfloat16 goes through float32 (exact),
float32 stays float32, and the weights keep the reference's `x @ W`
orientation, W shaped (d_in, d_out).  With `par=` (a `Parallelism` whose
mesh has a model axis) the tree comes as the rank blocks the models run
on under it (`models.tp.shard_model`: each local model rank's heads,
d_ff columns, vocabulary rows and experts, stacked).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.schedules import (BatchedUpwardSchedule,
                                               EngineTables)
from repro_torch.device import resolve_device
from repro_torch.models.params import ParamDef, map_tree
from repro_torch.models.transformer import _n_superblocks, model_defs

__all__ = ["engine_tables_from_numpy", "lm_params_from_numpy", "unstack",
           "UP_KEYS", "M2L_KEYS", "M2P_KEYS", "BUCKET_KEYS"]

UP_KEYS = ("leaves", "leaf_mask", "leaf_centers", "leaf_idx", "leaf_valid",
           "up_ids", "up_parents", "up_mask", "up_d",
           "down_ids", "down_parents", "down_mask", "down_d")
M2L_KEYS = ("src", "tgt", "mask", "d")
M2P_KEYS = ("b", "mask", "centers", "t_idx", "t_valid")
BUCKET_KEYS = ("t_idx", "t_valid", "s_idx", "s_valid", "mask")

_INT, _F32, _BOOL = np.int64, np.float32, bool
_DTYPES = {"mask": _F32, "leaf_mask": _F32, "up_mask": _F32,
           "down_mask": _F32, "leaf_centers": _F32, "centers": _F32,
           "d": _F32, "up_d": _F32, "down_d": _F32, "leaf_valid": _BOOL,
           "t_valid": _BOOL, "s_valid": _BOOL}


def _arr(arrays: dict, key: str) -> np.ndarray:
    if key not in arrays:
        raise KeyError(f"engine tables: missing array {key!r}")
    name = key.rsplit("/", 1)[-1]
    return np.ascontiguousarray(arrays[key], dtype=_DTYPES.get(name, _INT))


def engine_tables_from_numpy(arrays: dict, device) -> EngineTables:
    """Flat {key: NumPy array or int} (module docstring) -> the port's
    `EngineTables` as tensors on `device`.  Ids become int64, masks and
    geometry float32, validity bool."""
    ints = {k: int(arrays[k]) for k in ("n", "n_parts", "n_cells_max",
                                        "n_bodies_max", "p")
            if k in arrays}
    missing = {"n", "n_parts", "n_cells_max", "n_bodies_max", "p"} - set(ints)
    if missing:
        raise KeyError(f"engine tables: missing ints {sorted(missing)}")
    up = BatchedUpwardSchedule(
        n_parts=ints["n_parts"], n_cells_max=ints["n_cells_max"],
        n_bodies_max=ints["n_bodies_max"],
        tables={k: _arr(arrays, f"up/{k}") for k in UP_KEYS})
    n_buckets = len({k.split("/")[1] for k in arrays
                     if k.startswith("p2p/")})
    buckets = tuple({k: _arr(arrays, f"p2p/{i}/{k}") for k in BUCKET_KEYS}
                    for i in range(n_buckets))
    tables = EngineTables(
        n=ints["n"], n_parts=ints["n_parts"],
        n_cells_max=ints["n_cells_max"], n_bodies_max=ints["n_bodies_max"],
        p=ints["p"], up=up,
        m2l={k: _arr(arrays, f"m2l/{k}") for k in M2L_KEYS},
        m2p={k: _arr(arrays, f"m2p/{k}") for k in M2P_KEYS},
        p2p_buckets=buckets,
        l2p_t_idx=_arr(arrays, "l2p_t_idx"),
        orig_idx=_arr(arrays, "orig_idx"),
        flat_idx=_arr(arrays, "flat_idx"))
    return tables.to(device)


def lm_params_from_numpy(cfg, tree: dict, device=None, par=None) -> dict:
    """The reference's parameter tree of `cfg` (nested dicts of NumPy
    arrays, block leaves stacked on a leading superblock axis) -> the port's
    weight tree on `device` (default: the card), as the rank blocks of
    `par`'s model axis when `par` has one (module docstring).  Every leaf
    keeps its type (bfloat16 or float32); a missing, extra or misshapen
    leaf raises."""
    dev = resolve_device(device)
    flat = dict(tree)
    for key, n in (("blocks", _n_superblocks(cfg)),
                   ("enc_blocks", cfg.n_enc_layers)):
        if key not in tree:
            continue
        for a in _leaves(tree[key]):
            if np.shape(a)[0] != n:
                raise ValueError(f"lm_params_from_numpy: {key} leaf of shape "
                                 f"{np.shape(a)} is not stacked over {n} "
                                 f"superblocks")
        flat[key] = unstack(tree[key], n)

    def one(d: ParamDef, a, path: str) -> torch.Tensor:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {d.shape}")
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(a.astype(np.float32) if bf16 else np.array(a))
        return t.to(dev, torch.bfloat16 if bf16 else t.dtype)

    whole = _zip(one, model_defs(cfg), flat)
    if par is None or par.mesh is None or par.model_axis is None:
        return whole
    from repro_torch.models.tp import shard_model
    return shard_model(whole, cfg, par.mesh, par.model_axis)


def unstack(tree, n: int) -> list:
    """A tree whose leaves are stacked on a leading axis of n (the
    reference's superblock layout) -> a list of n trees, the port's."""
    return [map_tree(lambda a, i=i: np.asarray(a)[i], tree)
            for i in range(n)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _zip(fn, defs, tree, path="params"):
    """fn(def, leaf, path) over two trees of the same keys."""
    if isinstance(defs, ParamDef):
        return fn(defs, tree, path)
    if isinstance(defs, list):
        if len(defs) != len(tree):
            raise ValueError(f"{path}: {len(tree)} entries, expected "
                             f"{len(defs)}")
        return [_zip(fn, d, t, f"{path}[{i}]")
                for i, (d, t) in enumerate(zip(defs, tree))]
    if set(defs) != set(tree):
        raise ValueError(f"{path}: keys {sorted(tree)}, expected "
                         f"{sorted(defs)}")
    return {k: _zip(fn, defs[k], tree[k], f"{path}/{k}") for k in defs}
