"""Checkpoints in the reference's on-disk format (`repro.ckpt.checkpoint`),
so a checkpoint written by either package loads in the other.

Layout:  <dir>/step_<N:08d>/shard_0.npz + manifest.json, written to a
temporary directory and renamed into place (a crash mid-save never
corrupts the latest step), the oldest steps past `keep` deleted.  Keys are
the reference's tree paths joined by "/": dict keys as they are, a
NamedTuple's fields as ".name" (`opt/.master/blocks/attn0/wq`, `opt/.m`,
`opt/.v`, `opt/.step`).  A list of per-superblock trees (the port's
`blocks`, `enc_blocks`) is saved stacked on a leading (n, ...) axis, as the
reference stacks its superblocks, and unstacked on load
(`convert.unstack`).  bfloat16 leaves are upcast to float32 (npz cannot
hold bfloat16; exact) and cast back to the like tree's type on load; a
Python int leaf (the optimizer's step) is stored as an int32 scalar, the
reference's type.

`load_checkpoint(..., shardings=)` is the reference's elastic reshard on
load: with a tree of `models.params.Sharding`s (`param_shardings(defs,
mesh)`, None where a leaf stays whole) each leaf lands as the blocks the
ranks of this process hold on that mesh (`shard_params`: (L, *block)) on
the mesh's device, whatever mesh shape wrote the checkpoint (the file
holds whole leaves).  Without it, `device=` (default: the card) takes the
whole tree.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.convert import unstack
from repro_torch.device import resolve_device
from repro_torch.models.params import shard_leaf

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]

SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree, key: str, out: dict) -> None:
    """{path: array} of a tree, lists stacked on a leading axis."""
    join = (lambda k: f"{key}{SEP}{k}") if key else str
    if _is_namedtuple(tree):
        for name in tree._fields:
            _flatten(getattr(tree, name), join(f".{name}"), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, join(k), out)
    elif isinstance(tree, list):
        parts = []
        for sub in tree:
            parts.append({})
            _flatten(sub, key, parts[-1])
        for k in parts[0]:
            out[k] = np.stack([p[k] for p in parts])
    else:
        out[key] = _to_numpy(tree)


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    keep: int = 3):
    """Atomic save of a tree (+ JSON-serializable extras, e.g. the data
    cursor).  Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays = {}
        _flatten(tree, "", arrays)
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _restore(like, key: str, arrays: dict, dev):
    """A tree of `like`'s structure from {path: array} (lists unstacked),
    leaves of like's types on `dev`."""
    join = (lambda k: f"{key}{SEP}{k}") if key else str
    if _is_namedtuple(like):
        return type(like)(*(_restore(getattr(like, name), join(f".{name}"),
                                     arrays, dev) for name in like._fields))
    if isinstance(like, dict):
        return {k: _restore(v, join(k), arrays, dev) for k, v in like.items()}
    if isinstance(like, list):
        sub = {k: v for k, v in arrays.items()
               if k == key or k.startswith(key + SEP)}
        return [_restore(lk, key, part, dev) for lk, part in
                zip(like, unstack(sub, len(like)))]
    if key not in arrays:
        raise KeyError(f"load_checkpoint: no leaf {key!r} in the checkpoint")
    arr = arrays[key]
    shape = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"load_checkpoint: {key} has shape {arr.shape}, "
                         f"expected {shape}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev, like.dtype)
    return type(like)(arr)


def _shard(tree, shardings):
    """Each tensor leaf cut to its blocks where `shardings` has a
    `Sharding` (the trees of one structure, None for a whole leaf)."""
    if shardings is None:
        return tree
    if _is_namedtuple(tree):
        return type(tree)(*(_shard(getattr(tree, n), getattr(shardings, n))
                            for n in tree._fields))
    if isinstance(tree, dict):
        return {k: _shard(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shard(v, s) for v, s in zip(tree, shardings)]
    return shard_leaf(tree, shardings) if isinstance(tree, torch.Tensor) \
        else tree


def _first_mesh(shardings):
    if shardings is None:
        return None
    if isinstance(shardings, dict):
        shardings = list(shardings.values())
    if isinstance(shardings, (list, tuple)):
        for s in shardings:
            m = _first_mesh(s)
            if m is not None:
                return m
        return None
    return shardings.mesh


def load_checkpoint(ckpt_dir: str, step: int, like_tree, device=None,
                    shardings=None):
    """Restore step `step` into the structure of `like_tree` (its leaves
    give shapes and types: tensors, on any device, or Python numbers),
    onto `device` (default: the card), or, with `shardings`, each leaf as
    the blocks this process's ranks hold on the mesh's device (see the
    module docstring).  Returns (tree, extra)."""
    mesh = _first_mesh(shardings)
    dev = mesh.device if mesh is not None else resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_0.npz")) as npz:
        arrays = dict(npz)
    tree = _restore(like_tree, "", arrays, dev)
    return _shard(tree, shardings), manifest["extra"]
