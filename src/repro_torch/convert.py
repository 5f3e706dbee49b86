"""Carry engine state across from stacked NumPy tables.

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
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine.schedules import (BatchedUpwardSchedule,
                                               EngineTables)

__all__ = ["engine_tables_from_numpy", "UP_KEYS", "M2L_KEYS", "M2P_KEYS",
           "BUCKET_KEYS"]

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
