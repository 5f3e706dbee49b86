"""Shared model layers: RMSNorm, RoPE, SwiGLU and attention.

Self-attention over a whole sequence goes to the hand-written kernel K4
(`attention_flash`, the model-layout wrapper of
`repro_torch.kernels.attention.flash_attention`: in bfloat16 on the tensor
cores, in float32 on the CUDA cores), where the reference runs its
plain-XLA `attention_full` / `attention_chunked`.  `attention_full`
stays for the single-query decode against the cache with its `kv_len` mask,
which the reference also computes outside Pallas.  Layouts are the
reference's: q (B, S, H, hd), k/v (B, S, Hkv, hd).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention import flash_attention

__all__ = ["rms_norm", "swiglu", "rope_freqs", "apply_rope", "attention_full",
           "attention_flash", "NEG_INF"]

NEG_INF = -1e30


def rms_norm(x, gamma, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) in float32, rounded to x's type, times
    gamma.  `F.rms_norm` normalises each row on its own, so a row's result
    does not depend on how many rows are normalised with it; on the card a
    mean over the last dimension may sum a row in another order when the
    row count changes, and then a request served in pieces (prefill, then
    decode) drifts from a forward over its whole sequence."""
    xn = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return xn.to(x.dtype) * gamma


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _in_type(value: float, dtype) -> float:
    """A Python scalar rounded to `dtype`, as JAX rounds a weakly typed
    scalar to the array it multiplies."""
    return float(torch.tensor(value, dtype=dtype))


def attention_full(q, k, v, *, causal=True, window=None, q_offset=0,
                   kv_len=None):
    """One-shot masked attention.  q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd).
    `kv_len` masks padded cache tails (decode).  Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd) * _in_type(hd ** -0.5, q.dtype)
    s = torch.einsum("bsngd,btnd->bngst", qg, k).float()      # (B,n,G,Sq,Sk)
    qi = q_offset + torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    if kv_len is not None:
        mask &= ki < kv_len
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bngst,btnd->bsngd", p, v)
    return o.reshape(B, Sq, H, hd)


def attention_flash(q, k, v, *, causal=True, window=None):
    """Self-attention over a whole sequence through K4.  q: (B, S, H, hd);
    k/v: (B, S, Hkv, hd) -> (B, S, H, hd).  The kernel's layout is
    (B, H, S, hd), so the heads move in front and back again."""
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(),
                        causal=causal, window=window)
    return o.transpose(1, 2)
