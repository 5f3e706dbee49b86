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
trains through XLA's autodiff of its plain attention), so the port has
none to port: on the card, `flash_attention` wraps K4 in a
`torch.autograd.Function` whenever grad mode is on and an input requires
grad.  Its forward asks K4 for each query row's float32 softmax statistics
as well (the final max m and the sum l, (2, B, H, Sq); `attention_stats_ref`
is their plain version), and its backward launches the hand-written kernel
`csrc/attention_bwd.cu` (`_launch_bwd`), which recomputes P from them with
K4's roundings and takes the flash-attention adjoint (dV = P^T dO, dS = P
(dO V^T - rowsum(dO O)), dQ and dK from dS and the scale), summed over each
GQA group's query heads, with no atomics.  `flash_attention_bwd` is its
plain version in PyTorch, which the tests hold it to; it runs for no tensor
of the main path.  Without grad (serving, its CUDA graphs) the wrapper
launches K4 exactly as before, with no statistics.  On the CPU, autograd
differentiates `attention_ref` itself.

The backward's launch.  In bfloat16 it runs on the tensor cores (`wgmma`,
TMA): a dQ kernel a 64-row query tile, a dK / dV kernel a 64-key tile and a
run of a GQA group's query heads.  `attention_bwd_launch_params` chooses how
many runs (`parts`) a group is cut into, just as many as the dK / dV grid
needs to fill the card, since each part above one writes float32 dK and dV
to a scratch that a last kernel adds up in head order, and the tiles
(`BWD_TILES`: dQ takes 128 keys a step up to head size 64 at long
sequences).

The dry run (`launch.dryrun`) runs the models on the `meta` device.  There
the wrapper computes nothing: it makes the launch's checks and returns
empty outputs of their shapes and types, through the autograd Function as
on the card; the backward allocates what the kernel's launch allocates and
runs nothing.  Each launch, and each meta stand-in for one, reports to the
active walker (`obs.cost`).  "K4": the operations of the (query, key)
pairs the mask admits (`admitted_pairs`; 4 D a pair, QK^T and PV, an fma
counted as 2), q, k and v read once and the output written once (`PERF.md`
§6's bound), and the reference's dot FLOPs, 4 B H Sq Sk D: its attention
is plain XLA dots over every pair.  "K4.bwd": the kernel's 7 products of 2
D operations an admitted pair (9 at head size 256, where dK and dV are
taken in two halves), q, k, v, o, dO and the statistics read once, dq, dk,
dv and the row scratch written once (float32 delta a row; in bfloat16 a
float4 a row of Sq padded to a multiple of 64), the group scratch's float32
dK and dV written and read once when `parts` > 1, and the reference's
backward dot FLOPs, 8 B H Sq Sk D (the adjoints of its two products).

`launches` counts K4's launches and `backward_launches` its backward's:
each wrapper adds one where it launches its kernel, and nowhere else.
`backward_calls` counts the Function's backward passes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library
from repro_torch.obs import cost

__all__ = ["flash_attention", "flash_attention_bwd", "attention_ref",
           "attention_rounded_ref", "attention_tiled_ref",
           "attention_stats_ref", "admitted_pairs",
           "attention_bwd_launch_params", "group_parts", "HEAD_DIMS", "BLOCK_K",
           "BWD_TILES", "NEG_INF"]

HEAD_DIMS = (32, 64, 128, 256)  # the head sizes the kernel is built for
# keys per tile of the bfloat16 kernel, by head size (csrc: Layout<D>::kBK)
BLOCK_K = {32: 128, 64: 128, 128: 128, 256: 64}
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# float32 bytes of one (query, key) block that the backward may hold at a
# time; it takes as many (batch, kv-head) groups together as fit
BWD_BLOCK_BYTES = 1 << 28
# the bfloat16 backward's tiles by head size, (query rows a dK / dV step,
# the keys a dQ step may take): what csrc/attention_bwd.cu is built for
# (tc::Tiles<D>: kBQ; kBKd, and kBKdLong from _BWD_LONG keys)
BWD_TILES = {32: (64, (64, 128)), 64: (64, (64, 128)), 128: (64, (64,)),
             256: (64, (64,))}
_BWD_LONG = 2048
# the keys of a dK / dV block and the rows its row scratch pads Sq to
_BWD_KEYS = _BWD_ROW_PAD = 64
# dK / dV blocks an SM holds at once by head size (shared memory: 99 KB a
# block at D = 128, 195 KB at D = 256), and the H100's SMs
_BWD_RESIDENT = {32: 2, 64: 2, 128: 2, 256: 1}
_SMS = 132

launches = 0
backward_launches = 0
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


def attention_stats_ref(q, k, *, causal: bool = True,
                        window: int | None = None):
    """Plain version of the row statistics K4 leaves for its backward:
    q (B, H, Sq, D), k (B, Hkv, Sk, D) -> (2, B, H, Sq) float32, the max m
    of each query row's masked scores (float32, of q * scale rounded to the
    input type, as `attention_rounded_ref` takes them) and the sum l of p =
    exp(s - m) over its keys, so that P = p / max(l, 1e-30)."""
    B, H, Sq, D = q.shape
    group = H // k.shape[1]
    scale = float(torch.tensor(D ** -0.5, dtype=q.dtype))
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(),
                     k.float().repeat_interleave(group, dim=1))
    s = s.masked_fill(~_mask(Sq, k.shape[2], causal, window, q.device),
                      NEG_INF)
    m = s.amax(-1)
    return torch.stack((m, torch.exp(s - m[..., None]).sum(-1)))


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


def admitted_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs of one head that the causal mask and the window
    admit (every pair unmasked, Sk keys)."""
    if not causal:
        return Sq * Sk
    w = min(window or Sq, Sq)
    return w * (w + 1) // 2 + (Sq - w) * w


def attention_bwd_launch_params(B: int, H: int, Hkv: int, Sq: int, Sk: int,
                                D: int, causal: bool, window) -> tuple:
    """(parts, bq, bkd) of K4's bfloat16 backward at q (B, H, Sq, D), k/v
    (B, Hkv, Sk, D): each GQA group's H / Hkv query heads are cut into
    `parts` runs of consecutive heads (`group_parts`), one dK / dV block a
    run and 64-key tile; bq, the query rows of a dK / dV step, and bkd, the
    keys of a dQ step, are `BWD_TILES[D]`'s, bkd its longer choice from
    2,048 keys on (128 up to head size 64: twice the products a step, where a
    block walks enough key tiles that its half-masked diagonal one costs
    little; at 512 keys it measured slower, `PERF.md` §6).  A part beyond one
    costs its float32 dK and dV written to a scratch and read back (8 B Hkv
    Sk D bytes each way), so `parts` is 1 where the blocks of whole groups
    fill the card (`_BWD_RESIDENT` blocks on each of its 132 SMs), and
    otherwise the least count whose heaviest block walks no more query
    steps (`_bwd_query_steps`) than the card's mean load, the grid's steps
    over 132 SMs: beyond that the heaviest block alone sets the kernel's
    time, as a causal grid's first key tiles do.  At most the group."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head dim {D} not in "
                         f"{HEAD_DIMS}")
    bq, bkds = BWD_TILES[D]
    bkd = bkds[-1] if Sk >= _BWD_LONG else bkds[0]
    G = H // Hkv
    steps = _bwd_query_steps(Sq, Sk, bq, causal, window)
    if B * Hkv * len(steps) >= _SMS * _BWD_RESIDENT[D]:
        return 1, bq, bkd
    load = B * H * sum(steps) / _SMS
    parts = next((p for p in range(1, G) if -(-G // p) * max(steps) <= load),
                 G)
    return parts, bq, bkd


def _bwd_query_steps(Sq: int, Sk: int, bq: int, causal: bool,
                     window) -> list:
    """The query tiles of bq rows that see a key of each 64-key tile (one
    head's steps of each dK / dV block; csrc's query_tiles)."""
    out = []
    for k0 in range(0, Sk, _BWD_KEYS):
        last = Sq - 1
        if window is not None:
            last = min(last, k0 + _BWD_KEYS - 1 + window - 1)
        out.append(max(0, last // bq + 1 - (k0 // bq if causal else 0)))
    return out


def group_parts(G: int, parts: int) -> list:
    """The query heads (0 .. G - 1 of a GQA group) of each of `parts` runs,
    as the dK / dV kernel cuts them: run i holds heads i G // parts .. (i +
    1) G // parts - 1."""
    return [list(range(i * G // parts, (i + 1) * G // parts))
            for i in range(parts)]


def _report(q, k, causal, window) -> None:
    """One launch of K4 for the active walker (see the module docstring)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    nbyte = q.element_size()
    cost.report_kernel(
        "K4", operations=4.0 * D * admitted_pairs(Sq, Sk, causal, window)
        * B * H, read_bytes=nbyte * (B * H * Sq * D + 2.0 * B * Hkv * Sk * D),
        write_bytes=nbyte * B * H * Sq * D,
        dot_flops=4.0 * B * H * Sq * Sk * D)


def _report_bwd(q, k, causal, window, parts) -> None:
    """One launch of K4's backward for the active walker (see the module
    docstring)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    nbyte = q.element_size()
    products = 7 if D <= 128 else 9
    rows = B * H * Sq
    scratch = (16.0 * B * H * -(-Sq // _BWD_ROW_PAD) * _BWD_ROW_PAD
               if q.dtype == torch.bfloat16 else 4.0 * rows)
    group = 8.0 * parts * B * Hkv * Sk * D if parts > 1 else 0.0
    cost.report_kernel(
        "K4.bwd", operations=2.0 * products * D
        * admitted_pairs(Sq, Sk, causal, window) * B * H,
        read_bytes=nbyte * (3.0 * rows * D + 2.0 * B * Hkv * Sk * D)
        + 8.0 * rows + group,
        write_bytes=nbyte * (1.0 * rows * D + 2.0 * B * Hkv * Sk * D)
        + scratch + group, dot_flops=8.0 * B * H * Sq * Sk * D)


def _misaligned(t) -> int:
    """Bytes past a 16-byte boundary where t's data starts (on meta, from
    its storage offset: the allocator's blocks are 512-byte aligned)."""
    if t.device.type == "meta":
        return t.storage_offset() * t.element_size() % 16
    return t.data_ptr() % 16


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("attention.cu")
    lib.repro_flash_attention.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_attention_error_string.argtypes = [ctypes.c_int]
    lib.repro_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    lib = library("attention_bwd.cu")
    lib.repro_flash_attention_bwd.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    lib.repro_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.repro_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, causal, window, stats=None):
    """K4 on the current stream: checked CUDA tensors -> o; `stats`, a
    float32 (2, B, H, Sq) tensor on q's device, also receives each row's m
    and l (meta tensors: an empty o, the launch reported; nothing runs)."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    B, H, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if _misaligned(t):
                raise ValueError(f"flash_attention: {name} must be 16-byte "
                                 f"aligned in bfloat16 (TMA)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.device.type == "meta":
        if cost.ACTIVE is not None:
            _report(q, k, causal, window)
        return out
    dev = q.device
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            _DTYPES[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D,
            float(D ** -0.5),
            int(causal), 0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.repro_attention_error_string(err).decode())
    launches += 1
    if cost.ACTIVE is not None:
        _report(q, k, causal, window)
    return out


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        window: int | None = None):
    """The gradient of K4, the plain version of its backward kernel
    (`_launch_bwd`): q (B, H, Sq, D), k/v (B, Hkv, Sk, D), the forward's
    output o and its gradient do (B, H, Sq, D) -> (dq, dk, dv) in the
    inputs' types.  P is recomputed with `attention_rounded_ref`'s
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


def _launch_bwd(q, k, v, o, do, stats, causal, window, params=None):
    """K4's backward on the current stream: K4's inputs, its output o, o's
    gradient do (B, H, Sq, D) and the statistics its launch wrote (float32
    (2, B, H, Sq)) -> (dq, dk, dv) in the inputs' type.  CUDA tensors
    (contiguous, D in `HEAD_DIMS`, bfloat16 ones 16-byte aligned) launch
    `csrc/attention_bwd.cu`, raising if the launch fails; meta tensors
    allocate what the launch allocates, report it and compute nothing; any
    other device raises.  In bfloat16 the launch takes `params`, (parts, bq,
    bkd), or `attention_bwd_launch_params`'s (float32 takes none).
    Allocates dq, dk, dv and the launch's scratch with torch.empty: q *
    scale (q's shape), the row scratch (float32 delta (B, H, Sq); in
    bfloat16 (B H Sqp, 4) float32, Sq padded to a multiple of 64) and, for
    parts > 1, the group scratch (parts, 2, B, Hkv, Sk, D) float32."""
    global backward_launches
    _check(q, k, v, causal, window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention backward: unsupported device "
                         f"{dev}")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"flash_attention backward: {name} must match "
                             f"q {tuple(q.shape)} {q.dtype} on {dev}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if (tuple(stats.shape) != (2, B, H, Sq) or stats.dtype != torch.float32
            or stats.device != dev):
        raise ValueError(f"flash_attention backward: stats must be float32 "
                         f"{(2, B, H, Sq)} on {dev}; got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    for name, t in named + (("stats", stats),):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"contiguous")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head dim {D} not in "
                         f"{HEAD_DIMS}")
    tc = q.dtype == torch.bfloat16
    parts, bq, bkd = 1, 0, 0
    if tc:
        for name, t in named:
            if _misaligned(t):
                raise ValueError(f"flash_attention backward: {name} must be "
                                 f"16-byte aligned in bfloat16 (TMA)")
        parts, bq, bkd = params or attention_bwd_launch_params(
            B, H, Hkv, Sq, Sk, D, causal, window)
        if (bq != BWD_TILES[D][0] or bkd not in BWD_TILES[D][1]
                or not 1 <= parts <= H // Hkv):
            raise ValueError(f"flash_attention backward: launch "
                             f"{(parts, bq, bkd)} not built: tiles "
                             f"{BWD_TILES[D]} at head dim {D}, 1 to "
                             f"{H // Hkv} parts")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    qs = torch.empty_like(q)
    if tc:
        sqp = -(-Sq // _BWD_ROW_PAD) * _BWD_ROW_PAD
        rows = torch.empty(B * H * sqp, 4, dtype=torch.float32, device=dev)
    else:
        rows = torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
    part = (torch.empty(parts, 2, B, Hkv, Sk, D, dtype=torch.float32,
                        device=dev) if parts > 1 else None)
    if dq.numel() == 0:
        return dq, dk, dv
    if dev.type == "meta":
        if cost.ACTIVE is not None:
            _report_bwd(q, k, causal, window, parts)
        return dq, dk, dv
    lib = _lib_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), rows.data_ptr(), qs.data_ptr(), _DTYPES[q.dtype],
            B, H, Hkv, Sq, Sk, D, float(D ** -0.5),
            int(causal), 0 if window is None else int(window),
            None if part is None else part.data_ptr(), parts, bq, bkd,
            stream)
    if err != 0:
        raise RuntimeError("attention backward kernel launch failed: "
                           + lib.repro_attention_bwd_error_string(err)
                           .decode())
    backward_launches += 1
    if cost.ACTIVE is not None:
        _report_bwd(q, k, causal, window, parts)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K4 forward (with its row statistics), its backward kernel
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, H, Sq, _ = q.shape
        stats = torch.empty(2, B, H, Sq, dtype=torch.float32,
                            device=q.device)
        o = _launch(q, k, v, causal, window, stats)
        ctx.save_for_backward(q, k, v, o, stats)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        global backward_calls
        q, k, v, o, stats = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, o, do.contiguous(), stats,
                                 ctx.causal, ctx.window)
        backward_calls += 1
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q (B, H, Sq, D); k/v (B, Hkv, Sk, D) -> (B, H, Sq, D), any lengths,
    Sk != Sq only with `causal=False` and no window.  CPU tensors run
    `attention_ref`; CUDA tensors (contiguous, D in `HEAD_DIMS`, bfloat16
    ones 16-byte aligned for the TMA) launch K4 on the current stream,
    raising if the launch fails, through the autograd Function when grad
    mode is on and an input requires grad; meta tensors take the same
    route and compute nothing (the dry run's); any other device raises."""
    _check(q, k, v, causal, window)
    dev = q.device
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)
