"""K4: blocked flash attention (GQA, causal, sliding window, or unmasked
over keys of their own length), its plain versions and its wrapper.

`flash_attention` replaces the Pallas TPU kernel
`repro.kernels.attention.flash_attention` with the hand-written CUDA kernel
`csrc/attention.cu` (sm_90a, bound through ctypes).  q (B, H, Sq, D), k/v
(B, Hkv, Sk, D), H a multiple of Hkv (query head h reads kv head h // group),
float32 or bfloat16 -> (B, H, Sq, D) in the same type.  Sk may differ from
Sq only with `causal=False` and no window: the models' cross-attention over
a memory (the reference computes it unmasked); `causal=False` with Sq == Sk
is an encoder's bidirectional self-attention.  The kernel keeps the
Pallas kernel's roundings (q * scale in the input type, p in v's type before
the PV product, float32 accumulation, acc / max(l, 1e-30)), masks keys past
Sk and visits only the key tiles that the causal and window bounds admit.  At
the models' shapes it is bound by operations (S^2 D / 2 multiply-adds per
head).  In bfloat16 both products run on the tensor cores (wgmma, K and V
tiles brought by TMA, 128 query rows and 128-key tiles, 64-key tiles at
head dim 256: `BLOCK_K`); float32 runs on the CUDA cores, since TF32 would
round the inputs (see the note in the source).

`attention_ref` is the plain PyTorch version, the counterpart of
`repro.kernels.ref.attention_ref`: the whole (Sq, Sk) score matrix, masked
with -1e30, softmax in float32.  The wrapper runs it for tensors on the CPU
and launches the kernel for tensors on a CUDA device.  In bfloat16 it rounds
the scores to bfloat16, as the reference's oracle does, where the kernel
rounds q * scale; `attention_rounded_ref` is the plain version with the
kernel's roundings, to hold the kernel to a bfloat16 tolerance of about one
unit in the last place of the output.  `attention_tiled_ref` also walks the
keys in the kernel's tiles (the Pallas kernel's online softmax, p rounded
against the running max), so it differs from the bfloat16 kernel only by
the order of float32 sums.

The gradient.  The Pallas kernel has no backward kernel (the reference
trains through plain XLA), so the port has none to port: on the card,
`flash_attention` wraps K4 in a `torch.autograd.Function` whenever grad
mode is on and an input requires grad, and its backward is the PyTorch
function `flash_attention_bwd`, which recomputes P with K4's roundings
and takes the standard flash-attention adjoint (dV = P^T dO, dS = P (dO
V^T - rowsum(dO O)), dQ and dK from dS and the scale), summed over each
GQA group's query heads.  Without grad (serving, its CUDA graphs) the
wrapper launches K4 exactly as before.  On the CPU, autograd
differentiates `attention_ref` itself.

`launches` counts kernel launches: the wrapper adds one where it launches
the kernel, and nowhere else.  `backward_calls` counts the Function's
backward passes (PyTorch work, no kernel of this module).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library

__all__ = ["flash_attention", "flash_attention_bwd", "attention_ref",
           "attention_rounded_ref", "attention_tiled_ref", "HEAD_DIMS",
           "BLOCK_K", "NEG_INF"]

HEAD_DIMS = (32, 64, 128, 256)  # the head sizes the kernel is built for
# keys per tile of the bfloat16 kernel, by head size (csrc: Layout<D>::kBK)
BLOCK_K = {32: 128, 64: 128, 128: 128, 256: 64}
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# float32 bytes of one (query, key) block that the backward may hold at a
# time; it takes as many (batch, kv-head) groups together as fit
BWD_BLOCK_BYTES = 1 << 28

launches = 0
backward_calls = 0


def _mask(Sq, Sk, causal, window, device, k0=0):
    """(Sq, Sk) bool: the keys k0 .. k0 + Sk - 1 each query may see."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(k0, k0 + Sk, device=device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """Plain version: q (B, H, Sq, D); k/v (B, Hkv, Sk, D) -> (B, H, Sq,
    D)."""
    B, H, Sq, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / (D ** 0.5)
    mask = _mask(Sq, k.shape[2], causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def attention_rounded_ref(q, k, v, *, causal: bool = True,
                          window: int | None = None):
    """Plain version with the kernel's (the Pallas kernel's) roundings:
    q * scale in the input type (scale rounded to it first), float32 scores,
    p = exp(s - max) rounded to v's type before a float32 PV product, and
    acc / max(l, 1e-30) with l the sum of the unrounded p, rounded to the
    input type.  The kernel rounds p against the running max of the key
    tiles it has seen, this against the row's max, so in bfloat16 a term of
    the PV sum may differ by one rounding of p (2^-9 of it)."""
    B, H, Sq, D = q.shape
    group = H // k.shape[1]
    scale = float(torch.tensor(D ** -0.5, dtype=q.dtype))
    qs = (q * scale).float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    s = s.masked_fill(~_mask(Sq, k.shape[2], causal, window, q.device),
                      NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf)
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def attention_tiled_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None, block_k: int | None = None):
    """Plain version in the kernel's (the Pallas kernel's) tile order: the
    online softmax over key tiles of `block_k` (default: the bfloat16
    kernel's at this head size, `BLOCK_K`), with `attention_rounded_ref`'s
    roundings but p = exp(s - m) rounded to v's type against the running max
    m of the tiles seen so far, l the sum of the unrounded p, and the
    accumulator rescaled by exp(m_old - m) per tile.  Every tile is visited:
    one the kernel skips is masked for every row of its query tile, and adds
    exactly 0 after a live tile, or is scaled by exactly 0 before one."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    block_k = block_k or BLOCK_K.get(D, 128)
    group = H // k.shape[1]
    scale = float(torch.tensor(D ** -0.5, dtype=q.dtype))
    qs = (q * scale).float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros(B, H, Sq, 1, device=q.device)
    acc = torch.zeros(B, H, Sq, D, device=q.device)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        s = torch.einsum("bhqd,bhkd->bhqk", qs, kf[:, :, k0:k1])
        s = s.masked_fill(~_mask(Sq, k1 - k0, causal, window, q.device, k0),
                          NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf[:, :, k0:k1])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: expected q (B, H, Sq, D) and k/v "
                         f"(B, Hkv, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if (k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1
            or H % k.shape[1] != 0):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (H a multiple of Hkv)")
    if k.shape[2] != Sq and (causal or window is not None):
        raise ValueError(f"flash_attention: {k.shape[2]} keys for {Sq} "
                         f"queries: keys of another length take neither the "
                         f"causal mask nor a window")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q, k, v must share one type of "
                        f"float32 / bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: inputs on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("attention.cu")
    lib.repro_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_attention_error_string.argtypes = [ctypes.c_int]
    lib.repro_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, causal, window):
    """K4 on the current stream: checked CUDA tensors -> o."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    B, H, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} must be 16-byte "
                                 f"aligned in bfloat16 (TMA)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D,
            float(D ** -0.5),
            int(causal), 0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.repro_attention_error_string(err).decode())
    launches += 1
    return out


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        window: int | None = None):
    """The gradient of K4: q (B, H, Sq, D), k/v (B, Hkv, Sk, D), the
    forward's output o and its gradient do (B, H, Sq, D) -> (dq, dk, dv) in
    the inputs' types.  P is recomputed with `attention_rounded_ref`'s
    roundings (q * scale in the input type, float32 scores, p = exp(s -
    max) over l = sum p; dV takes p rounded to v's type, as the PV product
    did); dS = P (dO V^T - rowsum(dO O)), dQ = scale dS K, dK = dS^T (q *
    scale), dV = P^T dO, each summed over the query heads of a GQA group.
    Float32 throughout.  It runs over (batch, kv-head) groups, as many at a
    time as keep one float32 (query, key) block within BWD_BLOCK_BYTES."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = float(torch.tensor(D ** -0.5, dtype=q.dtype))
    masked = ~_mask(Sq, Sk, causal, window, q.device)
    n = B * Hkv
    qg = q.reshape(n, G, Sq, D)
    og = o.reshape(n, G, Sq, D)
    dog = do.reshape(n, G, Sq, D)
    kg, vg = k.reshape(n, Sk, D), v.reshape(n, Sk, D)
    dq = torch.empty_like(q).reshape(n, G, Sq, D)
    dk = torch.empty_like(k).reshape(n, Sk, D)
    dv = torch.empty_like(v).reshape(n, Sk, D)
    per = max(1, BWD_BLOCK_BYTES // (4 * G * Sq * Sk))
    for i in range(0, n, per):
        j = min(i + per, n)
        qs = (qg[i:j] * scale).float()
        kf, vf = kg[i:j].float(), vg[i:j].float()
        dof = dog[i:j].float()
        s = torch.einsum("ngqd,nkd->ngqk", qs, kf)
        s.masked_fill_(masked, NEG_INF)
        p = torch.exp_(s.sub_(s.amax(-1, keepdim=True)))
        inv_l = p.sum(-1, keepdim=True).clamp_min_(1e-30).reciprocal_()
        dv[i:j] = torch.einsum("ngqk,ngqd->nkd",
                               p.to(v.dtype).float() * inv_l, dof)
        p.mul_(inv_l)                                   # P
        rows = (dof * og[i:j].float()).sum(-1, keepdim=True)
        ds = torch.einsum("ngqd,nkd->ngqk", dof, vf).sub_(rows).mul_(p)
        del p
        dq[i:j] = torch.einsum("ngqk,nkd->ngqd", ds, kf).mul_(scale)
        dk[i:j] = torch.einsum("ngqk,ngqd->nkd", ds, qs)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


class _FlashAttention(torch.autograd.Function):
    """K4 forward, `flash_attention_bwd` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o = _launch(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        global backward_calls
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                         window=ctx.window)
        backward_calls += 1
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q (B, H, Sq, D); k/v (B, Hkv, Sk, D) -> (B, H, Sq, D), any lengths,
    Sk != Sq only with `causal=False` and no window.  CPU tensors run
    `attention_ref`; CUDA tensors (contiguous, D in `HEAD_DIMS`, bfloat16
    ones 16-byte aligned for the TMA) launch K4 on the current stream,
    raising if the launch fails, through the autograd Function when grad
    mode is on and an input requires grad; any other device raises."""
    _check(q, k, v, causal, window)
    dev = q.device
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)
