"""K1: the gathered P2P Laplace direct sum, its plain version and its wrapper.

For a batch of P interaction rows, each with S gathered sources and T
gathered targets:

    phi[p, t] = sum_s q[p, s] / |x_tgt[p, t] - x_src[p, s]|     (r = 0 adds 0)

`p2p` replaces the Pallas TPU kernel `repro.kernels.p2p.p2p_pallas` with the
hand-written CUDA kernel `csrc/p2p.cu` (built for sm_90a, bound through
ctypes).  On this card the kernel is bound by device-memory bytes once it
skips the buckets' padding: one warp takes a row (ROWS_PER_WARP rows in
turn; `p2p_launch_params` picks the warps per block), stops the row's
source loop at its last nonzero charge (a row of zero charges only reads
q), and gives each lane two targets a pass, so each source staged in
shared memory feeds two pairs (see the note in the source).  The sum is bit for bit that of the full
loop over S.  `p2p_ref` is the plain PyTorch version (the counterpart of
`repro.kernels.ref.p2p_ref`); the wrapper runs it for tensors on the CPU
and launches the kernel for tensors on a CUDA device.

The launch autotune (`best_p2p_warps` for K1's warps a block,
`best_stream_params` for K2's block_t and warps) and its disk cache are the
port of the reference's `best_block_t` / `best_stream_params`: measured by
CUDA events on the card, once per shape class per card and build, then
read from a JSON file (`REPRO_P2P_CACHE_PATH`, `REPRO_P2P_CACHE=0` turns
persistence off); on the CPU they cache the heuristics and touch no disk.

`launches` counts kernel launches: the wrapper adds one where it launches
the kernel, and nowhere else.  The autotune's timed launches count in
`sweep_launches` instead.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import statistics
import time
import warnings

import torch

from repro_torch import obs
from repro_torch.kernels.build import library
from repro_torch.resilience import faults as _faults

__all__ = ["p2p", "p2p_ref", "p2p_launch_params", "heuristic_stream_params",
           "effective_block_t", "best_p2p_warps", "best_stream_params",
           "backend_key", "clear_memory_cache", "measurable",
           "BLOCK_CANDIDATES", "WARP_CANDIDATES"]

BLOCK_CANDIDATES = (128, 256, 512)
WARP_CANDIDATES = (1, 2, 4, 8, 16)      # warps a block K1 and K2 accept
_SMS = 132                      # streaming multiprocessors of an H100
ROWS_PER_WARP = 8               # REPRO_P2P_ROWS of csrc/p2p.cu

launches = 0

_ELEMS_PER_CHUNK = 1 << 26      # (rows x T x S) pairs per plain-version step


def p2p_ref(q, x_src, x_tgt):
    """Plain version: q (P, S), x_src (P, S, 3), x_tgt (P, T, 3) -> (P, T).
    Rows go in chunks of at most 2^26 pairs, so the (rows, T, S, 3)
    differences fit on the card at the engine's widest buckets."""
    P, S = q.shape
    T = x_tgt.shape[1]
    out = torch.empty(P, T, dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    step = max(1, _ELEMS_PER_CHUNK // max(T * S, 1))
    for a in range(0, P, step):
        d = x_tgt[a:a + step, :, None, :] - x_src[a:a + step, None, :, :]
        r2 = (d * d).sum(-1)
        inv = torch.where(r2 > 0, torch.rsqrt(r2.clamp_min(1e-30)), zero)
        out[a:a + step] = torch.einsum("pts,ps->pt", inv, q[a:a + step])
    return out


def _check(q, x_src, x_tgt):
    if q.dim() != 2 or x_src.dim() != 3 or x_tgt.dim() != 3 \
            or x_src.shape[2] != 3 or x_tgt.shape[2] != 3:
        raise ValueError(f"p2p: expected q (P, S), x_src (P, S, 3), "
                         f"x_tgt (P, T, 3); got {tuple(q.shape)}, "
                         f"{tuple(x_src.shape)}, {tuple(x_tgt.shape)}")
    if tuple(x_src.shape[:2]) != tuple(q.shape) \
            or x_tgt.shape[0] != q.shape[0]:
        raise ValueError(f"p2p: row/source counts disagree: q "
                         f"{tuple(q.shape)}, x_src {tuple(x_src.shape)}, "
                         f"x_tgt {tuple(x_tgt.shape)}")
    for name, t in (("q", q), ("x_src", x_src), ("x_tgt", x_tgt)):
        if t.dtype != torch.float32:
            raise TypeError(f"p2p: {name} must be float32, got {t.dtype}")
    if not (q.device == x_src.device == x_tgt.device):
        raise ValueError(f"p2p: inputs on different devices: {q.device}, "
                         f"{x_src.device}, {x_tgt.device}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("p2p.cu")
    lib.repro_p2p_gathered.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_p2p_gathered.restype = ctypes.c_int
    lib.repro_p2p_error_string.argtypes = [ctypes.c_int]
    lib.repro_p2p_error_string.restype = ctypes.c_char_p
    return lib


def warps_per_block(units: int, most: int) -> int:
    """Warps per block for a launch of one warp per row or tile: `most`,
    halved while the grid would give the card's SMs fewer than two blocks
    each, so that small launches still spread over every SM."""
    w = most
    while w > 1 and -(-units // w) < 2 * _SMS:
        w //= 2
    return w


def p2p_launch_params(P: int) -> int:
    """Warps per block of K1's launch over P rows (ROWS_PER_WARP rows a
    warp): 4, fewer for grids too small to give every SM two blocks.  At
    the main path's buckets 4 measured 2-3% faster than 8 (`PERF.md` §6)."""
    return warps_per_block(-(-P // ROWS_PER_WARP), 4)


def _launch(q, x_src, x_tgt, warps: int):
    """Launch K1 on the current stream with `warps` warps per block, on
    checked contiguous CUDA tensors; returns the (P, T) output.  Raises if
    the launch fails.  Counts nothing: `p2p` counts its launches, the
    autotune its timed ones."""
    P, S = q.shape
    T = x_tgt.shape[1]
    out = torch.empty(P, T, dtype=torch.float32, device=q.device)
    if P == 0 or T == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_p2p_gathered(
            q.data_ptr(), x_src.data_ptr(), x_tgt.data_ptr(), out.data_ptr(),
            P, S, T, int(warps), stream)
    if err != 0:
        raise RuntimeError("p2p kernel launch failed: "
                           + lib.repro_p2p_error_string(err).decode())
    return out


def _check_cuda(q, x_src, x_tgt) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"p2p: unsupported device {dev}")
    for name, t in (("q", q), ("x_src", x_src), ("x_tgt", x_tgt)):
        if not t.is_contiguous():
            raise ValueError(f"p2p: {name} must be contiguous")


def p2p(q, x_src, x_tgt, *, warps: int | None = None):
    """q (P, S), x_src (P, S, 3), x_tgt (P, T, 3) float32 -> (P, T) float32.
    CPU tensors run `p2p_ref`; CUDA tensors launch K1 on the current stream
    with `warps` warps per block, one of `WARP_CANDIDATES`
    (`p2p_launch_params(P)` when None; `kernels.ops.p2p_auto` passes the
    autotune's choice), raising if the launch fails; any other device
    raises."""
    global launches
    _check(q, x_src, x_tgt)
    if q.device.type == "cpu":
        return p2p_ref(q, x_src, x_tgt)
    _check_cuda(q, x_src, x_tgt)
    if warps is None:
        warps = p2p_launch_params(q.shape[0])
    elif warps not in WARP_CANDIDATES:
        raise ValueError(f"p2p: warps must be one of {WARP_CANDIDATES}, "
                         f"got {warps}")
    out = _launch(q, x_src, x_tgt, warps)
    if out.numel():
        launches += 1
    return out


def heuristic_stream_params(smax: int, wt_max: int) -> tuple[int, int]:
    """The reference's cold-cache choice for the streaming kernel
    (`repro.kernels.p2p._heuristic_stream_params`), copied unchanged: the
    smallest block_t candidate covering the widest target class, shrunk
    until two buffers of (source slab + target slab) fit ~1 MB, and
    n_buffers = 2.  The port's K2 takes block_t from it (it has no DMA
    pipeline, so n_buffers goes unused); `best_stream_params` returns it
    where it measures nothing."""
    nb = 2
    choice = BLOCK_CANDIDATES[0]
    for c in BLOCK_CANDIDATES:
        if nb * (4 * smax + 4 * c) * 4 > 1 << 20:   # (3+1)*SM + (3+1)*bt f32s
            break
        choice = c
        if c >= wt_max:
            break
    return choice, nb


def effective_block_t(T: int, block_t: int) -> int:
    """The reference's `repro.kernels.p2p.effective_block_t`: the target
    tile width worth launching, never wider than the 128-lane-aligned cover
    of T (a 512 block on a 64-target class would carry 448 dead lanes)."""
    return max(128, min(block_t, ((T + 127) // 128) * 128))


# ------------------------------------------------------- launch autotune --
# The counterpart of the reference's `best_block_t` / `best_stream_params`
# and their disk cache (`repro.kernels.p2p`).  K1 has no target block: its
# tunable launch shape is the warps a block that `repro_p2p_gathered`
# takes.  K2's is (block_t, warps a block): warps in place of the
# reference's DMA pipeline depth `n_buffers`, since K2 has no DMA pipeline.
#
# (S, n_pairs, T) -> K1's warps a block, keyed by the bucket's padded shape
# class, never by array identity: every execution of the same geometry (and
# every geometry sharing bucket shapes) reuses one decision.
_WARPS_CACHE: dict[tuple[int, int, int], int] = {}
# (smax, n_rows, wt_max) -> (block_t, warps) for K2, keyed by the stream
# schedule's block_t-independent shape class; warps None means
# `stream_launch_params(n_tiles)` (the heuristic, resolved at launch)
_STREAM_CACHE: dict[tuple[int, int, int], tuple] = {}

# Timed launches of the measured sweeps: they count here, never in
# `launches` (K2's in `p2p_stream.sweep_launches`).
sweep_launches = 0
# One record per measured decision: {"kind", "key", "ms": {candidate: ms},
# "choice", "heuristic", "wall_s"}.
sweeps: list = []

# --- on-disk persistence of MEASURED choices -------------------------------
# A measured sweep is the expensive part of warm-up; persisting it keyed by
# (backend, shape class) lets repeat runs skip it.  Heuristic choices (the
# CPU, a call without a sample) are free to recompute and never persisted,
# so CPU runs touch no disk.  Opt out with REPRO_P2P_CACHE=0; relocate
# with REPRO_P2P_CACHE_PATH (the reference's variables).
#
# Schema (version 2, the reference's): {"version": 2, "entries": {backend:
# {key: value}}}.  Keys are "S,n,T" (K1, value = int warps a block) or
# "stream:smax,rows,wt" (K2, value = [block_t, warps]; the reference stores
# [block_t, n_buffers] there).  The unversioned v1 layout ({backend: {key:
# value}}) is migrated silently on read and rewritten as version 2 on the
# next save; a file of an unknown (future) version is ignored.  The port's
# backend (`backend_key`) names the card and the kernels' build, never the
# reference's "cpu" / "gpu" / "tpu": a file shared with the reference is
# read by each package for its own entries only, and a rebuilt kernel is
# tuned again.
#
# Degradation contract: the disk cache is an optimization, never a
# correctness or liveness dependency.  An unreadable or unwritable location
# warns once, flips the process to in-memory-only operation and never
# touches the disk again; a corrupt file is moved aside and rebuilt.
_PERSIST_LOADED = False
_PERSIST_BROKEN = False
_QUARANTINED = False
_SCHEMA_VERSION = 2


def clear_memory_cache() -> None:
    """Forget every in-memory decision and reload the disk file at the next
    measured lookup, as a fresh process would (the disk itself is left
    alone; the warn-once states stay)."""
    global _PERSIST_LOADED
    _WARPS_CACHE.clear()
    _STREAM_CACHE.clear()
    _PERSIST_LOADED = False


def backend_key() -> str:
    """The port's backend key in the cache file: the current card's name,
    its compute capability and the digests under which K1's and K2's
    libraries are built (`build.digest`)."""
    from repro_torch.kernels.build import digest
    major, minor = torch.cuda.get_device_capability()
    return (f"cuda:{torch.cuda.get_device_name()}:sm_{major}{minor}:"
            f"p2p-{digest('p2p.cu')}:p2p_stream-{digest('p2p_stream.cu')}")


def _cache_io_failed(action: str, exc: BaseException) -> None:
    """First disk failure: one RuntimeWarning, then in-memory-only mode."""
    global _PERSIST_BROKEN
    if _PERSIST_BROKEN:
        return
    _PERSIST_BROKEN = True
    from repro_torch.resilience import fallback as _fb
    _fb.record_fallback(f"p2p.cache.{action}", "disk_cache", "in_memory",
                        warn=False)      # the warning below is the warn-once
    warnings.warn(
        f"p2p autotune cache disabled: could not {action} "
        f"{_persist_path()!r} ({exc!r}); continuing with the in-memory "
        f"cache only (set REPRO_P2P_CACHE_PATH to a writable location or "
        f"REPRO_P2P_CACHE=0 to silence)", RuntimeWarning, stacklevel=3)


def _quarantine_corrupt(exc: BaseException) -> None:
    """Corrupt or truncated cache JSON: move the file aside to
    `<path>.corrupt`, count `p2p.cache.quarantined`, warn once and keep
    running.  The location is still usable, so persistence stays on and
    the next save rebuilds the file."""
    global _QUARANTINED
    path = _persist_path()
    try:
        os.replace(path, path + ".corrupt")
    except OSError:
        pass                             # a racing process already moved it
    obs.counter_add("p2p.cache.quarantined")
    if _QUARANTINED:
        return
    _QUARANTINED = True
    warnings.warn(
        f"p2p autotune cache {path!r} is corrupt ({exc!r}); quarantined to "
        f"{path + '.corrupt'!r} and rebuilding from scratch (warns once)",
        RuntimeWarning, stacklevel=3)


def _persist_enabled() -> bool:
    return os.environ.get("REPRO_P2P_CACHE", "1").lower() not in (
        "0", "", "off", "no", "false")


def _persist_path() -> str:
    return os.environ.get("REPRO_P2P_CACHE_PATH") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-fmm",
        "p2p_block_cache.json")


def _parse_entries(data) -> dict:
    """An on-disk payload as {backend: {key_str: value}}: the versioned
    schema, or the unversioned v1 (exactly the entries mapping); anything
    else, a future version included, gives {}."""
    if not isinstance(data, dict):
        return {}
    version = data.get("version")
    if version is None:                      # legacy v1: entries at top level
        return {k: v for k, v in data.items() if isinstance(v, dict)}
    if version == _SCHEMA_VERSION:
        entries = data.get("entries", {})
        return entries if isinstance(entries, dict) else {}
    return {}                                # unknown/future schema: ignore


def _load_persisted(backend: str) -> None:
    """Merge `backend`'s persisted choices into the in-memory caches (once
    per process; in-memory entries win).  Entries that are not a valid
    launch shape of the port's kernels are skipped."""
    global _PERSIST_LOADED
    if _PERSIST_LOADED:
        return
    _PERSIST_LOADED = True
    try:
        _faults.fire("p2p.cache.read")
        with open(_persist_path()) as f:
            data = json.load(f)
    except FileNotFoundError:
        return                       # cold cache: normal, silent
    except ValueError as exc:        # corrupt/truncated JSON: quarantine it
        _quarantine_corrupt(exc)
        return
    except (OSError, _faults.InjectedFault) as exc:
        # unreadable location (or an injected read fault): warn once, degrade
        _cache_io_failed("read", exc)
        return
    for k, v in _parse_entries(data).get(backend, {}).items():
        try:
            if k.startswith("stream:"):
                sm, rows, wt = (int(t) for t in k[len("stream:"):].split(","))
                bt, w = int(v[0]), int(v[1])
                if bt > 0 and bt % 128 == 0 and w in WARP_CANDIDATES:
                    _STREAM_CACHE.setdefault((sm, rows, wt), (bt, w))
                continue
            S, n, T = (int(t) for t in k.split(","))
            w = int(v)
        except (TypeError, ValueError, IndexError):
            continue
        if w in WARP_CANDIDATES:
            _WARPS_CACHE.setdefault((S, n, T), w)


def _save_persisted(backend: str, key_str: str, value) -> None:
    """Read-merge-write in the versioned schema, through a per-pid
    temporary file and `os.replace`; a legacy v1 file is migrated whole on
    the first save.  An unwritable location warns once and flips to
    in-memory-only operation."""
    path = _persist_path()
    try:
        _faults.fire("p2p.cache.write")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            with open(path) as f:
                entries = _parse_entries(json.load(f))
        except OSError:
            entries = {}
        except ValueError as exc:    # corrupt on the read-merge: quarantine
            _quarantine_corrupt(exc)
            entries = {}
        entries.setdefault(backend, {})[key_str] = value
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _SCHEMA_VERSION, "entries": entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except (OSError, _faults.InjectedFault) as exc:
        _cache_io_failed("write", exc)


def measurable(t) -> bool:
    """Whether a timed sweep can run on tensor `t`: on a CUDA device and
    outside a graph capture (a capture records launches and runs none)."""
    return t.device.type == "cuda" and \
        not torch.cuda.is_current_stream_capturing()


def _time_k1(sample, warps: int) -> float:
    """Device ms of K1 at `warps` on `sample`: one warm-up launch, then the
    median of 3 timed by CUDA events.  None counts in `launches`."""
    global sweep_launches
    q, xs, xt = sample
    _launch(q, xs, xt, warps)
    ms = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _launch(q, xs, xt, warps)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    sweep_launches += 4
    return statistics.median(ms)


def best_p2p_warps(S: int, n_pairs: int, T: int, *, sample=None) -> int:
    """K1's warps a block for a bucket shape class, cached by (S, n_pairs,
    T): the port's `repro.kernels.p2p.best_block_t` (K1 has no target
    block; its launch shape is the warps a block).

    With `sample` = (q, x_src, x_tgt) on the card (outside a graph
    capture), the first call for a class times every candidate of
    `WARP_CANDIDATES` on it (`_time_k1`), keeps the argmin and persists it
    under the reference's "S,n,T" key; a later process reads it from the
    file.  On the CPU, without a sample or inside a capture it caches
    `p2p_launch_params(n_pairs)`, never persisted.  Counts
    `p2p.autotune.decisions` / `p2p.autotune.cache_hits` and emits the
    `p2p.autotune` event (the reference's fields, `warps` for `block_t`)."""
    key = (int(S), int(n_pairs), int(T))
    measure = sample is not None and measurable(sample[0])
    persist = measure and _persist_enabled() and not _PERSIST_BROKEN
    if persist:
        backend = backend_key()
        _load_persisted(backend)
        persist = not _PERSIST_BROKEN    # the load may have just broken it
    hit = _WARPS_CACHE.get(key)
    if hit is not None:
        obs.counter_add("p2p.autotune.cache_hits")
        return hit
    heuristic = p2p_launch_params(n_pairs)
    if not measure:
        mode, choice = "heuristic", heuristic
    else:
        mode = "measured"
        t0 = time.perf_counter()
        ms = {w: _time_k1(sample, w) for w in WARP_CANDIDATES}
        choice = min(ms, key=ms.get)     # the first of equal times, as ref
        sweeps.append({"kind": "K1", "key": key, "ms": ms, "choice": choice,
                       "heuristic": heuristic,
                       "wall_s": time.perf_counter() - t0})
        if persist:
            _save_persisted(backend, ",".join(map(str, key)), int(choice))
    _WARPS_CACHE[key] = choice
    obs.counter_add("p2p.autotune.decisions")
    if obs.enabled():
        obs.event("p2p.autotune",
                  {"S": key[0], "n_pairs": key[1], "T": key[2],
                   "warps": int(choice), "mode": mode})
    return choice


def best_stream_params(smax: int, n_rows: int, wt_max: int, *,
                       measure=None) -> tuple:
    """K2's (block_t, warps a block), cached by the stream schedule's
    block_t-independent shape class (smax, n_rows, wt_max): the port's
    `repro.kernels.p2p.best_stream_params`, with K2's warps a block in
    place of the reference's `n_buffers` (K2 has no DMA pipeline).

    With `measure(block_t, warps) -> ms` (the engine's closure on the card:
    it builds the stream tables at that block_t and times one K2 launch),
    the first call for a class sweeps block_t over `effective_block_t(
    wt_max, c)` for c in `BLOCK_CANDIDATES` and warps over
    `WARP_CANDIDATES`, 3 measures each, keeps the argmin of the medians and
    persists it under "stream:smax,rows,wt".  Without it (the CPU) it
    caches `(heuristic_stream_params(smax, wt_max)[0], None)`: the
    reference's block_t, and warps None for `stream_launch_params` at the
    launch.  Counts and emits `p2p.autotune.stream` like `best_p2p_warps`."""
    key = (int(smax), int(n_rows), int(wt_max))
    persist = measure is not None and _persist_enabled() \
        and not _PERSIST_BROKEN
    if persist:
        backend = backend_key()
        _load_persisted(backend)
        persist = not _PERSIST_BROKEN
    hit = _STREAM_CACHE.get(key)
    if hit is not None:
        obs.counter_add("p2p.autotune.cache_hits")
        return hit
    heuristic = (heuristic_stream_params(smax, wt_max)[0], None)
    if measure is None:
        mode, choice = "heuristic", heuristic
    else:
        mode = "measured"
        t0 = time.perf_counter()
        ms = {}
        for bt in sorted({effective_block_t(wt_max, c)
                          for c in BLOCK_CANDIDATES}):
            for w in WARP_CANDIDATES:
                ms[(bt, w)] = statistics.median(measure(bt, w)
                                                for _ in range(3))
        choice = min(ms, key=ms.get)
        sweeps.append({"kind": "K2", "key": key, "ms": ms, "choice": choice,
                       "heuristic": heuristic,
                       "wall_s": time.perf_counter() - t0})
        if persist:
            _save_persisted(backend, "stream:" + ",".join(map(str, key)),
                            [int(choice[0]), int(choice[1])])
    _STREAM_CACHE[key] = choice
    obs.counter_add("p2p.autotune.decisions")
    if obs.enabled():
        obs.event("p2p.autotune.stream",
                  {"smax": key[0], "n_rows": key[1], "wt_max": key[2],
                   "block_t": int(choice[0]), "warps": choice[1],
                   "mode": mode})
    return choice
