"""K2: the streaming P2P kernel, its plain version and its wrapper.

The same Laplace sum as K1 (`kernels.p2p`), over one unified tile table for
every P2P width class (`engine.schedules.build_p2p_stream_tables`), with the
gather done inside the kernel:

  meta     (Ti, 4) int32 — [src_start, src_len, tgt_start, tgt_len] per tile;
           tiles with tgt_len == 0 are dead padding and return zeros.
  payload  (4, F) float32 — structure of arrays [x; y; z; q] over the flat
           body axis, with at least max(smax, block_t) zero rows at the end
           (`engine.p2p.stream_payload`).

Tile i sums the (4, smax) source slab starting at src_start, with q masked
to 0 past src_len, into the lanes of the (4, block_t) target slab starting
at tgt_start.  The two versions differ past tgt_len, where the caller drops
every lane through the table's `out_valid`:

  - the kernel evaluates only the live src_len x tgt_len pairs of a tile and
    writes exactly 0.0 in lanes [tgt_len, block_t) (and in dead tiles);
  - the plain version `p2p_stream_gathered` computes every lane, as the
    reference does, so it stays comparable with `repro` on all of them.

`p2p_stream` replaces the Pallas TPU kernel
`repro.kernels.p2p_stream.p2p_stream` with the hand-written CUDA kernel
`csrc/p2p_stream.cu` (sm_90a, bound through ctypes).  On this card it is
bound by device-memory bytes, most of them the (Ti, block_t) output: one
warp takes a tile (TILES_PER_WARP tiles in turn; `stream_launch_params`
picks the warps per block), reads its meta row and its sources from the
payload in place, and runs the pair body it shares with K1, so the two
agree bit for bit on identical slabs in every lane below tgt_len (see the
note in the source).
`p2p_stream_gathered` is the counterpart of
`repro.core.engine.p2p.p2p_stream_gathered`: it gathers the same slabs and
runs K1's plain version on them.

`launches` counts kernel launches: the wrapper adds one where it launches
the kernel, and nowhere else.  The autotune's timed launches (`timed_ms`)
count in `sweep_launches` instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.p2p import WARP_CANDIDATES, p2p_ref, warps_per_block

__all__ = ["p2p_stream", "p2p_stream_gathered", "stream_launch_params",
           "stream_slabs", "timed_ms"]

TILES_PER_WARP = 8              # REPRO_P2P_TILES of csrc/p2p_stream.cu

launches = 0
sweep_launches = 0              # the autotune's timed launches (`timed_ms`)

_ELEMS_PER_CHUNK = 1 << 26      # (tiles x block_t x smax) pairs per step


def stream_slabs(meta, payload, *, block_t: int, smax: int):
    """The slabs tile by tile, as K1's operands: q (Ti, smax) masked past
    src_len, x_src (Ti, smax, 3), x_tgt (Ti, block_t, 3)."""
    lane_s = torch.arange(smax, device=meta.device)
    lane_t = torch.arange(block_t, device=meta.device)
    m = meta.long()
    src = payload[:, m[:, 0:1] + lane_s[None, :]]          # (4, Ti, smax)
    tgt = payload[:, m[:, 2:3] + lane_t[None, :]]          # (4, Ti, block_t)
    q = torch.where(lane_s[None, :] < m[:, 1:2], src[3],
                    torch.zeros((), dtype=payload.dtype,
                                device=payload.device))
    return (q.contiguous(), src[:3].permute(1, 2, 0).contiguous(),
            tgt[:3].permute(1, 2, 0).contiguous())


def p2p_stream_gathered(meta, payload, *, block_t: int, smax: int):
    """Plain version: meta (Ti, 4) int32, payload (4, F) f32 ->
    (Ti, block_t) f32.  Tiles go in chunks of at most 2^26 pairs."""
    Ti = meta.shape[0]
    out = torch.empty(Ti, block_t, dtype=payload.dtype, device=payload.device)
    step = max(1, _ELEMS_PER_CHUNK // max(block_t * smax, 1))
    for a in range(0, Ti, step):
        m = meta[a:a + step]
        q, xs, xt = stream_slabs(m, payload, block_t=block_t, smax=smax)
        phi = p2p_ref(q, xs, xt)
        out[a:a + step] = torch.where((m[:, 3] > 0)[:, None], phi,
                                      torch.zeros((), dtype=phi.dtype,
                                                  device=phi.device))
    return out


def _check(meta, payload, block_t, smax):
    if meta.dim() != 2 or meta.shape[1] != 4 or meta.dtype != torch.int32:
        raise ValueError(f"p2p_stream: meta must be (Ti, 4) int32, got "
                         f"{tuple(meta.shape)} {meta.dtype}")
    if payload.dim() != 2 or payload.shape[0] != 4 \
            or payload.dtype != torch.float32:
        raise ValueError(f"p2p_stream: payload must be (4, F) float32, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    if meta.device != payload.device:
        raise ValueError(f"p2p_stream: meta on {meta.device}, payload on "
                         f"{payload.device}")
    if block_t < 1 or smax < 1:
        raise ValueError(f"p2p_stream: block_t and smax must be positive, "
                         f"got {block_t}, {smax}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("p2p_stream.cu")
    lib.repro_p2p_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_p2p_stream.restype = ctypes.c_int
    lib.repro_p2p_stream_error_string.argtypes = [ctypes.c_int]
    lib.repro_p2p_stream_error_string.restype = ctypes.c_char_p
    return lib


def stream_launch_params(n_tiles: int) -> int:
    """Warps per block of K2's launch over n_tiles tiles (TILES_PER_WARP
    tiles a warp): 4, fewer for grids too small to give every SM two
    blocks.  At the main path's 2^21 tiles 4 measured 1-2% faster than 8
    (`PERF.md` §6)."""
    return warps_per_block(-(-n_tiles // TILES_PER_WARP), 4)


def _launch(meta, payload, block_t: int, smax: int, warps: int):
    """Launch K2 on the current stream with `warps` warps per block, on
    checked contiguous CUDA tensors; returns the (Ti, block_t) output.
    Raises if the launch fails.  Counts nothing."""
    dev = payload.device
    Ti = meta.shape[0]
    out = torch.empty(Ti, block_t, dtype=torch.float32, device=dev)
    if Ti == 0:
        return out
    if meta.data_ptr() % 16:            # the kernel reads a row as an int4
        meta = meta.clone()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_p2p_stream(meta.data_ptr(), payload.data_ptr(),
                                   out.data_ptr(), Ti, payload.shape[1],
                                   block_t, smax, int(warps), stream)
    if err != 0:
        raise RuntimeError("p2p_stream kernel launch failed: "
                           + lib.repro_p2p_stream_error_string(err).decode())
    return out


def _check_cuda(meta, payload) -> None:
    if payload.device.type != "cuda":
        raise ValueError(f"p2p_stream: unsupported device {payload.device}")
    if not (meta.is_contiguous() and payload.is_contiguous()):
        raise ValueError("p2p_stream: meta and payload must be contiguous")


def p2p_stream(meta, payload, *, block_t: int, smax: int,
               warps: int | None = None):
    """meta (Ti, 4) int32, payload (4, F) float32 -> (Ti, block_t) float32.
    CPU tensors run `p2p_stream_gathered`; CUDA tensors launch K2 on the
    current stream with `warps` warps per block (`stream_launch_params(Ti)`
    when None; the engine passes the autotune's choice), raising if the
    launch fails; any other device raises.  On the card lanes at or past a
    tile's tgt_len are 0.0 (the plain version computes them; see the
    module note)."""
    global launches
    _check(meta, payload, block_t, smax)
    if payload.device.type == "cpu":
        return p2p_stream_gathered(meta, payload, block_t=block_t, smax=smax)
    _check_cuda(meta, payload)
    if warps is None:
        warps = stream_launch_params(meta.shape[0])
    elif warps not in WARP_CANDIDATES:
        raise ValueError(f"p2p_stream: warps must be one of "
                         f"{WARP_CANDIDATES}, got {warps}")
    out = _launch(meta, payload, block_t, smax, warps)
    if meta.shape[0]:
        launches += 1
    return out


def timed_ms(meta, payload, *, block_t: int, smax: int, warps: int) -> float:
    """Device ms of one K2 launch at `warps` on the card, by CUDA events,
    after one warm-up launch: the measure of K2's autotune sweep
    (`kernels.p2p.best_stream_params`).  Neither launch counts in
    `launches`; both count in `sweep_launches`."""
    global sweep_launches
    _check(meta, payload, block_t, smax)
    _check_cuda(meta, payload)
    _launch(meta, payload, block_t, smax, warps)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    _launch(meta, payload, block_t, smax, warps)
    b.record()
    b.synchronize()
    sweep_launches += 2
    return a.elapsed_time(b)
