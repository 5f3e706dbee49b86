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

The gradient.  The Pallas kernel has no backward kernel (the reference
trains through plain XLA), so the port has none to port: on the card,
`wkv_chunk` wraps K5 in a `torch.autograd.Function` whenever grad mode is
on and an input requires grad, and its backward is the PyTorch function
`wkv_bwd`, the adjoint recurrence in float32 over states recomputed
token by token (never by dividing by w).  Without grad (serving, its CUDA
graphs) the wrapper launches K5 exactly as before.  On the CPU, autograd
differentiates `wkv_ref` itself.

`launches` counts kernel launches: the wrapper adds one where it launches
the kernel, and nowhere else.  `backward_calls` counts the Function's
backward passes (PyTorch work, no kernel of this module).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library

__all__ = ["wkv_chunk", "rwkv6_wkv", "wkv_ref", "wkv_bwd",
           "wkv_launch_params", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128)       # the head sizes the kernel is built for
_SMS = 132                      # streaming multiprocessors of an H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
backward_calls = 0


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


def _launch(r, k, v, w, u, state):
    """K5 on the current stream over prepared CUDA tensors (r/k/v
    contiguous and aligned, w, u and state float32) -> (y, new state)."""
    global launches
    BH, C, D = r.shape
    G, JC, JL, TC = wkv_launch_params(BH, C, D)
    y = torch.empty_like(r)
    s1 = torch.empty_like(state)
    dev = r.device
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


def wkv_bwd(r, k, v, w, u, state, dy, dstate=None):
    """The gradient of the WKV recurrence: the inputs of `wkv_ref`, dy
    (BH, C, D) and the new state's gradient dstate (BH, D, D; None for 0)
    -> (dr, dk, dv, dw, du, dstate0), each in its input's type.  With G_t
    = dL/dS_t (S_t the state after token t; G_C = dstate), float32:

        dr_t[i] = sum_j dy_t[j] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
        du[i]   = sum_t r_t[i] k_t[i] (dy_t . v_t)
        dk_t[i] = r_t[i] u[i] (dy_t . v_t) + sum_j G_t[i, j] v_t[j]
        dv_t[j] = (sum_i r_t[i] u[i] k_t[i]) dy_t[j] + sum_i G_t[i, j] k_t[i]
        dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   dstate0 = G_0.

    The states S_0 .. S_{C-1} are recomputed forward, S_t = w_t S_{t-1} +
    k_t v_t^T, and kept with the G_t: two (C, BH, D, D) float32 buffers,
    so only the two token loops are serial."""
    BH, C, D = r.shape
    rt, kt, vt, wt, dyt = (a.float().transpose(0, 1).contiguous()
                           for a in (r, k, v, w, dy))       # (C, BH, D)
    uf = u.float()
    S = torch.empty(C, BH, D, D, dtype=torch.float32, device=r.device)
    Gs = torch.empty_like(S)
    tmp = torch.empty(BH, D, D, dtype=torch.float32, device=r.device)
    S[0] = state.float()
    for t in range(C - 1):                              # S[t] = S_{t-1}
        torch.mul(kt[t, :, :, None], vt[t, :, None, :], out=tmp)
        torch.addcmul(tmp, wt[t, :, :, None], S[t], out=S[t + 1])
    if dstate is None:
        Gs[C - 1].zero_()
    else:
        Gs[C - 1] = dstate.float()
    for t in range(C - 1, 0, -1):                       # Gs[t] = G_t
        torch.mul(rt[t, :, :, None], dyt[t, :, None, :], out=tmp)
        torch.addcmul(tmp, wt[t, :, :, None], Gs[t], out=Gs[t - 1])
    ds0 = torch.addcmul(rt[0, :, :, None] * dyt[0, :, None, :],
                        wt[0, :, :, None], Gs[0])
    dyv = (dyt * vt).sum(-1, keepdim=True)              # (C, BH, 1)
    ruk = (rt * uf * kt).sum(-1, keepdim=True)
    dr = (S @ dyt[..., None])[..., 0] + uf * kt * dyv
    du = (rt * kt * dyv).sum(0)
    dk = (Gs @ vt[..., None])[..., 0] + rt * uf * dyv
    dv = (Gs.transpose(-1, -2) @ kt[..., None])[..., 0] + ruk * dyt
    dw = (Gs * S).sum(-1)
    back = [a.transpose(0, 1).to(x.dtype) for a, x in
            ((dr, r), (dk, k), (dv, v), (dw, w))]
    return (*back, du.to(u.dtype), ds0.to(state.dtype))


class _WKV(torch.autograd.Function):
    """K5 forward, `wkv_bwd` backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s1 = _launch(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return y, s1

    @staticmethod
    def backward(ctx, dy, dstate):
        global backward_calls
        grads = wkv_bwd(*ctx.saved_tensors, dy, dstate)
        backward_calls += 1
        return grads


def wkv_chunk(r, k, v, w, u, state):
    """Any number of tokens C.  r/k/v (BH, C, D) float32 or bfloat16, w
    (BH, C, D), u (BH, D), state (BH, D, D) -> (y (BH, C, D) in r's type,
    new state (BH, D, D) float32).  CPU tensors run `wkv_ref`; CUDA tensors
    (D in `HEAD_DIMS`; w, u and state are taken as float32) launch K5 on the
    current stream, raising if the launch fails, through the autograd
    Function when grad mode is on and an input requires grad; any other
    device raises."""
    _check(r, k, v, w, u, state)
    dev = r.device
    if dev.type == "cpu":
        y, s1 = wkv_ref(r, k, v, w, u, state)
        return y, s1.float()
    if dev.type != "cuda":
        raise ValueError(f"wkv: unsupported device {dev}")
    r, k, v = (_aligned(t.contiguous()) for t in (r, k, v))
    w = _aligned(w.float().contiguous())
    u, state = (t.float().contiguous() for t in (u, state))
    args = (r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _WKV.apply(*args)
    return _launch(*args)


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
