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

`launches` counts kernel launches: the wrapper adds one where it launches
the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library

__all__ = ["p2p", "p2p_ref", "p2p_launch_params", "heuristic_stream_params",
           "BLOCK_CANDIDATES"]

BLOCK_CANDIDATES = (128, 256, 512)
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


def p2p(q, x_src, x_tgt):
    """q (P, S), x_src (P, S, 3), x_tgt (P, T, 3) float32 -> (P, T) float32.
    CPU tensors run `p2p_ref`; CUDA tensors launch K1 on the current stream
    with `p2p_launch_params(P)` warps per block, raising if the launch
    fails; any other device raises."""
    global launches
    _check(q, x_src, x_tgt)
    dev = q.device
    if dev.type == "cpu":
        return p2p_ref(q, x_src, x_tgt)
    if dev.type != "cuda":
        raise ValueError(f"p2p: unsupported device {dev}")
    for name, t in (("q", q), ("x_src", x_src), ("x_tgt", x_tgt)):
        if not t.is_contiguous():
            raise ValueError(f"p2p: {name} must be contiguous")
    P, S = q.shape
    T = x_tgt.shape[1]
    out = torch.empty(P, T, dtype=torch.float32, device=dev)
    if P == 0 or T == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_p2p_gathered(
            q.data_ptr(), x_src.data_ptr(), x_tgt.data_ptr(), out.data_ptr(),
            P, S, T, p2p_launch_params(P), stream)
    if err != 0:
        raise RuntimeError("p2p kernel launch failed: "
                           + lib.repro_p2p_error_string(err).decode())
    launches += 1
    return out


def heuristic_stream_params(smax: int, wt_max: int) -> tuple[int, int]:
    """The reference's cold-cache choice for the streaming kernel
    (`repro.kernels.p2p._heuristic_stream_params`), copied unchanged: the
    smallest block_t candidate covering the widest target class, shrunk
    until two buffers of (source slab + target slab) fit ~1 MB, and
    n_buffers = 2.  The port's K2 uses block_t only; the measured autotune
    comes in a later change."""
    nb = 2
    choice = BLOCK_CANDIDATES[0]
    for c in BLOCK_CANDIDATES:
        if nb * (4 * smax + 4 * c) * 4 > 1 << 20:   # (3+1)*SM + (3+1)*bt f32s
            break
        choice = c
        if c >= wt_max:
            break
    return choice, nb
