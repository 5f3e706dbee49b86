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
trains through XLA's autodiff of `wkv_chunked`), so the port's backward
replaces no TPU kernel: on the card, `wkv_chunk` wraps K5 in a
`torch.autograd.Function` whenever grad mode is on and an input requires
grad, and its backward launches the hand-written kernel `csrc/wkv_bwd.cu`
(`_launch_bwd`): the adjoint recurrence in float32 over states rebuilt
from checkpoints (never by dividing by w), split by rows of the state over
blocks, its inputs staged by asynchronous copies two stages ahead
(`wkv_bwd_launch_params`; see the note in the source).  `wkv_bwd` is its
plain version, which the tests and `chip_smoke.py` hold it to; nothing on
the card's path calls it.  Without grad (serving, its CUDA graphs) the
wrapper launches K5 exactly as before.  On the CPU, autograd
differentiates `wkv_ref` itself.

The dry run (`launch.dryrun`) runs the models on the `meta` device.  There
the wrappers prepare their inputs as on the card and return empty outputs
of the launch's shapes and types, through the autograd Function as on the
card, and compute nothing: the backward allocates its outputs and scratch
and runs no token loop.  Each launch, and each meta stand-in for one,
reports to the active walker (`obs.cost`).  "K5": 5 operations per (token,
head, i, j), r, k, v, w read and y written once per (token, head, channel)
and the state read and written once (`PERF.md` §6's bound), and the dot
FLOPs of the reference's chunkwise `wkv_chunked` over chunks of c = min(64,
C): per batch-head and token 4 D^2 + 4 c D + 2 D (the inter-chunk product,
the intra-chunk scores and their product with v, the bonus term, the state
update).  "K5.bwd": the backward kernel's 17 operations per (token, head, i,
j) (the 14 of its bound and the states rebuilt a second time), r, k, v,
dy, w read and dr, dk, dv, dw written once per (token,
head, channel), the state and its gradient read and dstate0 written once,
and twice the forward's reference dot FLOPs (the adjoint of each of
`wkv_chunked`'s products).

`launches` counts K5's launches and `backward_launches` its backward's:
each wrapper adds one where it launches its kernel, and nowhere else.
`backward_calls` counts the Function's backward passes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library
from repro_torch.obs import cost

__all__ = ["wkv_chunk", "rwkv6_wkv", "wkv_ref", "wkv_bwd",
           "wkv_launch_params", "wkv_bwd_launch_params", "bwd_fit",
           "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128)       # the head sizes the kernel is built for
_SMS = 132                      # streaming multiprocessors of an H100
REF_CHUNK = 64                  # the reference's wkv_chunked chunk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
backward_launches = 0
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


def wkv_bwd_launch_params(BH: int, C: int, D: int) -> tuple:
    """(JL, A, NW, TB) of K5's backward for BH batch-heads, C tokens and
    head dim D: a row's D columns lie on D / JL adjacent lanes, JL columns
    a lane; a lane holds A rows, a block NW warps (NW 32 A / (D / JL) rows,
    so D over that many blocks a head), and stages are TB tokens, the
    states checkpointed in device memory at each.  At D = 64 (rwkv6's
    heads), measured fastest at each BH of the main path
    (`tools/wkv_bwd_variants.py`, `PERF.md` §6): 4 rows a lane in 4-token
    stages where 2 rows would take two waves (BH 128: 256 blocks, one
    wave), 2 rows in 8-token stages from BH 33, 1 row in 16-token stages
    from BH 17, and 2 columns a lane over 8 warps below, which doubles the
    warps an SM.  The kernel is built for exactly these choices
    (WKV_BWD_CONFIGS in csrc/wkv_bwd.cu)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim {D} not in {HEAD_DIMS}")
    if D == 64:
        if BH * 4 > 2 * _SMS:
            return 4, 4, 4, 4
        if BH > 32:
            return 4, 2, 4, 8
        return (4, 1, 4, 16) if BH > 16 else (2, 1, 8, 16)
    return (4, 1, 2, 4) if D == 32 else (4, 2, 8, 4)


def _bwd_shape(D: int, params) -> tuple:
    """(rows a block, row blocks a head, threads a block) of a backward
    launch (JL, A, NW, TB)."""
    JL, A, NW = params[:3]
    rows = NW * (32 // (D // JL)) * A
    return rows, D // rows, 32 * NW


def _bwd_blocks(C: int, D: int, params) -> tuple:
    """(row blocks a head, stages a head (a checkpoint each), tokens padded
    to whole stages) of a backward launch (JL, A, NW, TB)."""
    nb = -(-C // params[3])
    return _bwd_shape(D, params)[1], nb, nb * params[3]


def _bwd_smem(D: int, params, nbyte: int) -> int:
    """Dynamic shared memory bytes of a backward block, r, k, v, dy of
    `nbyte` bytes: a ring of 3 stages and a checkpoint for each, two stages
    of the warps' dv shares, two of dr or dk and dw on their way out, u's
    rows.  A copy of `Shape::kBytes` in csrc/wkv_bwd.cu, which is what the
    card allocates, for the CPU tests; the card tests hold the two equal
    (`bwd_fit`)."""
    JL, A, NW, TB = params
    rows, _, threads = _bwd_shape(D, params)
    stage = TB * rows * (2 * nbyte + 4) + TB * D * 2 * nbyte + 4 * TB
    return (3 * stage + 3 * A * JL * threads * 4 + 2 * NW * TB * D * 4
            + 4 * TB * rows * 4 + rows * 4)


def _bwd_min_blocks(D: int, params) -> int:
    """The blocks an SM the kernel is compiled to fit (its launch bounds,
    a copy of `Shape::kMinBlocks` in csrc/wkv_bwd.cu for the CPU tests): at
    most 128 registers a thread where a lane's TB states fit in 32."""
    JL, A, _, TB = params
    return 512 // _bwd_shape(D, params)[2] if TB * A * JL <= 32 else 1


def _aligned(t):
    """t, or a copy of it if its data is not 16-byte aligned (the kernel
    reads r, k, v and w 16 bytes at a time; on meta the offset into its
    storage tells, the allocator's blocks being 512-byte aligned)."""
    off = (t.storage_offset() * t.element_size() if t.device.type == "meta"
           else t.data_ptr())
    return t if off % 16 == 0 else t.clone()


def _ref_dots(BH: int, C: int, D: int) -> float:
    """The dot FLOPs of the reference's `wkv_chunked` on (BH, C, D)."""
    return BH * C * (4.0 * D * D + 4.0 * min(REF_CHUNK, C) * D + 2.0 * D)


def _report(r) -> None:
    """One launch of K5 for the active walker (see the module docstring)."""
    BH, C, D = r.shape
    nbyte = r.element_size()
    cost.report_kernel(
        "K5", operations=5.0 * BH * C * D * D,
        read_bytes=BH * C * D * (3.0 * nbyte + 4) + 4.0 * BH * D * D,
        write_bytes=BH * C * D * float(nbyte) + 4.0 * BH * D * D,
        dot_flops=_ref_dots(BH, C, D))


def _report_bwd(r) -> None:
    """One launch of K5's backward for the active walker (see the module
    docstring)."""
    BH, C, D = r.shape
    nbyte = r.element_size()
    cost.report_kernel(
        "K5.bwd", operations=17.0 * BH * C * D * D,
        read_bytes=BH * C * D * (4.0 * nbyte + 4) + 8.0 * BH * D * D,
        write_bytes=BH * C * D * (3.0 * nbyte + 4) + 4.0 * BH * D * D,
        dot_flops=2.0 * _ref_dots(BH, C, D))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("wkv.cu")
    lib.repro_wkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.repro_wkv.restype = ctypes.c_int
    lib.repro_wkv_error_string.argtypes = [ctypes.c_int]
    lib.repro_wkv_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd(variants: bool = False):
    lib = library("wkv_bwd.cu",
                  ("REPRO_WKV_BWD_VARIANTS",) if variants else ())
    lib.repro_wkv_bwd.argtypes = [ctypes.c_void_p] * 17 \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.repro_wkv_bwd.restype = ctypes.c_int
    lib.repro_wkv_bwd_fit.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.repro_wkv_bwd_fit.restype = ctypes.c_int
    lib.repro_wkv_bwd_error_string.argtypes = [ctypes.c_int]
    lib.repro_wkv_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_fit(dtype, D: int, params, variants: bool = False) -> dict:
    """What the card makes of a backward launch (JL, A, NW, TB) for r of
    `dtype` (`variants`: from the library built with the launches tried):
    resident blocks an SM, registers and spilled bytes a thread, shared
    memory bytes a block."""
    lib = _lib_bwd(variants)
    out = (ctypes.c_int * 4)()
    err = lib.repro_wkv_bwd_fit(_DTYPES[dtype], D, *params, out)
    if err != 0:
        raise RuntimeError("wkv backward kernel: "
                           + lib.repro_wkv_bwd_error_string(err).decode())
    return dict(zip(("blocks_per_sm", "registers", "spill_bytes",
                     "smem_bytes"), out))


def _launch(r, k, v, w, u, state):
    """K5 on the current stream over prepared CUDA tensors (r/k/v
    contiguous and aligned, w, u and state float32) -> (y, new state)
    (meta tensors: empty outputs, the launch reported; nothing runs)."""
    global launches
    BH, C, D = r.shape
    G, JC, JL, TC = wkv_launch_params(BH, C, D)
    y = torch.empty_like(r)
    s1 = torch.empty_like(state)
    if r.device.type == "meta":
        if cost.ACTIVE is not None:
            _report(r)
        return y, s1
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
    if cost.ACTIVE is not None:
        _report(r)
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
    so only the two token loops are serial.  The plain version of K5's
    backward kernel (`_launch_bwd`), which the tests hold it to."""
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


def _launch_bwd(r, k, v, w, u, state, dy, dstate=None, params=None):
    """K5's backward: the inputs of `wkv_chunk`, dy (BH, C, D) and the new
    state's gradient dstate (BH, D, D; None for 0) -> (dr, dk, dv in r's
    type, dw, du, dstate0 float32).  CPU tensors run `wkv_bwd` (its
    gradients in their inputs' types); CUDA tensors (D in `HEAD_DIMS`, C
    >= 1) launch `csrc/wkv_bwd.cu` on the current stream, raising if the
    launch fails; meta tensors allocate the outputs and the launch's
    scratch, report the launch and compute nothing; any other device
    raises.  `params` launches that (JL, A, NW, TB) instead of
    `wkv_bwd_launch_params`'s, from the library built with the launches
    tried (REPRO_WKV_BWD_VARIANTS, `tools/wkv_bwd_variants.py`)."""
    global backward_launches
    _check(r, k, v, w, u, state)
    BH, C, D = r.shape
    if tuple(dy.shape) != (BH, C, D) or (
            dstate is not None and tuple(dstate.shape) != (BH, D, D)):
        raise ValueError(f"wkv backward: dy must be {(BH, C, D)} and dstate "
                         f"{(BH, D, D)}; got {tuple(dy.shape)}, "
                         f"{None if dstate is None else tuple(dstate.shape)}")
    dev = r.device
    if dev.type == "cpu":
        return wkv_bwd(r, k, v, w, u, state, dy, dstate)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"wkv: unsupported device {dev}")
    if {dy.device} | ({dstate.device} if dstate is not None else set()) \
            != {dev}:
        raise ValueError("wkv backward: dy and dstate must lie on r's device")
    if C < 1:
        raise ValueError("wkv backward: needs at least one token")
    launch = tuple(params or wkv_bwd_launch_params(BH, C, D))
    nrb, nb, cp = _bwd_blocks(C, D, launch)
    r, k, v, dy = (_aligned(t.contiguous()) for t in (r, k, v,
                                                        dy.to(r.dtype)))
    w, state = (_aligned(t.float().contiguous()) for t in (w, state))
    u = u.float().contiguous()
    if dstate is not None:
        dstate = _aligned(dstate.float().contiguous())
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw, du, ds0 = (torch.empty_like(t) for t in (w, u, state))
    f32 = dict(dtype=torch.float32, device=dev)
    ck = torch.empty(BH, nb, D, D, **f32)          # states every stage
    dyv = torch.empty(2, BH, cp, **f32)            # dy . v, sum r u k
    part = torch.empty(nrb, BH, C, D, **f32)       # row blocks' dv shares
    if dev.type == "meta":
        if cost.ACTIVE is not None:
            _report_bwd(r)
        return dr, dk, dv, dw, du, ds0
    lib = _lib_bwd(params is not None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_wkv_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), ck.data_ptr(), part.data_ptr(), dyv.data_ptr(),
            _DTYPES[r.dtype], BH, C, D, *launch, stream)
    if err != 0:
        raise RuntimeError("wkv backward kernel launch failed: "
                           + lib.repro_wkv_bwd_error_string(err).decode())
    backward_launches += 1
    if cost.ACTIVE is not None:
        _report_bwd(r)
    return dr, dk, dv, dw, du, ds0


class _WKV(torch.autograd.Function):
    """K5 forward, its backward kernel backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s1 = _launch(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return y, s1

    @staticmethod
    def backward(ctx, dy, dstate):
        global backward_calls
        grads = _launch_bwd(*ctx.saved_tensors, dy, dstate)
        backward_calls += 1
        return grads


def wkv_chunk(r, k, v, w, u, state):
    """Any number of tokens C.  r/k/v (BH, C, D) float32 or bfloat16, w
    (BH, C, D), u (BH, D), state (BH, D, D) -> (y (BH, C, D) in r's type,
    new state (BH, D, D) float32).  CPU tensors run `wkv_ref`; CUDA tensors
    (D in `HEAD_DIMS`; w, u and state are taken as float32) launch K5 on the
    current stream, raising if the launch fails, through the autograd
    Function when grad mode is on and an input requires grad; meta tensors
    take the same route and compute nothing (the dry run's); any other
    device raises."""
    _check(r, k, v, w, u, state)
    dev = r.device
    if dev.type == "cpu":
        y, s1 = wkv_ref(r, k, v, w, u, state)
        return y, s1.float()
    if dev.type not in ("cuda", "meta"):
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
