"""K5: the RWKV6 (Finch) WKV recurrence, its plain version and its wrappers.

Per batch-head, with state S in R^{D x D}:

    y_t = sum_i r_t[i] * (S_{t-1}[i, :] + u[i] * k_t[i] * v_t)
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t          (w_t = data-dependent decay)

`wkv_chunk` replaces the Pallas TPU kernel `repro.kernels.rwkv.wkv_chunk`
with the hand-written CUDA kernel `csrc/wkv.cu` (sm_90a, bound through
ctypes), and `rwkv6_wkv` replaces the reference's chunk scan
(`repro.kernels.ops.rwkv6_wkv`, a `lax.scan` over chunk launches): the
kernel keeps the state in registers for the whole sequence, so one launch
covers every chunk and the result does not depend on `chunk`.  The
recurrence is serial in t, so the kernel splits each head's state by
columns over blocks and by rows over lanes (`wkv_launch_params`; see the
note in the source).

`wkv_ref` is the plain PyTorch version, the token loop of
`repro.kernels.ref.wkv_ref`, in float32.  The wrapper runs it for tensors on
the CPU and launches the kernel for tensors on a CUDA device.

`launches` counts kernel launches: the wrapper adds one where it launches
the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library

__all__ = ["wkv_chunk", "rwkv6_wkv", "wkv_ref", "wkv_launch_params",
           "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128)       # the head sizes the kernel is built for
_SMS = 132                      # streaming multiprocessors of an H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def wkv_ref(r, k, v, w, u, state):
    """Plain version: r/k/v/w (BH, C, D), u (BH, D), state (BH, D, D) ->
    (y (BH, C, D) in r's type, new state in state's type)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uu = u.float()[:, :, None]
    s = state.float()
    y = torch.empty(vf.shape, dtype=torch.float32, device=vf.device)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        y[:, t] = (rf[:, t, :, None] * (s + uu * kv)).sum(1)
        s = wf[:, t, :, None] * s + kv
    return y.to(r.dtype), s.to(state.dtype)


def _check(r, k, v, w, u, state):
    if r.dim() != 3:
        raise ValueError(f"wkv: expected r (BH, C, D); got {tuple(r.shape)}")
    BH, C, D = r.shape
    for name, t, shape in (("k", k, (BH, C, D)), ("v", v, (BH, C, D)),
                           ("w", w, (BH, C, D)), ("u", u, (BH, D)),
                           ("state", state, (BH, D, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"wkv: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise TypeError(f"wkv: r, k, v must share one type of float32 / "
                        f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (r, k, v, w, u, state)}
    if len(devs) != 1:
        raise ValueError(f"wkv: inputs on different devices: {devs}")


def wkv_launch_params(BH: int, C: int, D: int) -> tuple:
    """(G, JC, JL, TC) of K5's launch for BH batch-heads, C tokens and head
    dim D: each column of a head's state is owned by G adjacent lanes
    holding D / G rows each, a lane holds JL such columns, a block JC
    columns (D / JC blocks a head, G JC / JL threads each), and TC tokens
    are staged per step (1 for decode).  At D = 64 (rwkv6's heads): where
    the blocks fill every SM twice over, the kernel is bound by reads of
    shared memory, which 4 columns a lane cut to a quarter; below that,
    by how fast each of an SM's few warps issues, where 2 columns a lane
    over 4 warps and 16-token chunks measured fastest (`PERF.md` §6).
    The kernel is built for exactly these choices (WKV_CONFIGS in
    csrc/wkv.cu)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim {D} not in {HEAD_DIMS}")
    if D == 64:
        G, JC = 16, 16
        JL, TC = (4, 8) if BH * (D // JC) >= 2 * _SMS else (2, 16)
    else:
        G, JC, JL, TC = 8, 16, 1, 16 if D == 32 else 8
    return G, JC, JL, 1 if C <= 1 else TC


def _aligned(t):
    """t, or a copy of it if its data is not 16-byte aligned (the kernel
    reads r, k, v and w 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("wkv.cu")
    lib.repro_wkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.repro_wkv.restype = ctypes.c_int
    lib.repro_wkv_error_string.argtypes = [ctypes.c_int]
    lib.repro_wkv_error_string.restype = ctypes.c_char_p
    return lib


def wkv_chunk(r, k, v, w, u, state):
    """Any number of tokens C.  r/k/v (BH, C, D) float32 or bfloat16, w
    (BH, C, D), u (BH, D), state (BH, D, D) -> (y (BH, C, D) in r's type,
    new state (BH, D, D) float32).  CPU tensors run `wkv_ref`; CUDA tensors
    (D in `HEAD_DIMS`; w, u and state are taken as float32) launch K5 on the
    current stream, raising if the launch fails; any other device raises."""
    global launches
    _check(r, k, v, w, u, state)
    dev = r.device
    if dev.type == "cpu":
        y, s1 = wkv_ref(r, k, v, w, u, state)
        return y, s1.float()
    if dev.type != "cuda":
        raise ValueError(f"wkv: unsupported device {dev}")
    BH, C, D = r.shape
    G, JC, JL, TC = wkv_launch_params(BH, C, D)
    r, k, v = (_aligned(t.contiguous()) for t in (r, k, v))
    w = _aligned(w.float().contiguous())
    u, state = (t.float().contiguous() for t in (u, state))
    y = torch.empty_like(r)
    s1 = torch.empty_like(state)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_wkv(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), u.data_ptr(), state.data_ptr(),
                            y.data_ptr(), s1.data_ptr(), _DTYPES[r.dtype], BH,
                            C, D, G, JC, JL, TC, stream)
    if err != 0:
        raise RuntimeError("wkv kernel launch failed: "
                           + lib.repro_wkv_error_string(err).decode())
    launches += 1
    return y, s1


def rwkv6_wkv(r, k, v, w, u, state, *, chunk: int = 64):
    """Full-sequence WKV.  r/k/v/w (BH, S, D), u (BH, D), state (BH, D, D);
    S a multiple of `chunk` (ValueError otherwise), as the reference's chunk
    scan demands.  Returns (y (BH, S, D), final state).  One launch covers
    the whole sequence, so the result does not depend on `chunk`."""
    S = r.shape[1]
    if chunk < 1 or S % chunk:
        raise ValueError(f"rwkv6_wkv: sequence {S} not a multiple of chunk "
                         f"{chunk}")
    return wkv_chunk(r, k, v, w, u, state)
