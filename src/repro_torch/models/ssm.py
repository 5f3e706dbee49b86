"""Selective SSM (Mamba-style) head of hymba's hybrid layers.

Diagonal selective state space: h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t,
y_t = C_t . h_t + D x_t, with dt, B and C read from the input.  As in the
reference (`repro.models.ssm`), time is cut into chunks of min(256, S)
tokens, with the reference's contract that S is a whole number of them;
the state is carried from chunk to chunk, and inside a chunk the scan is a
doubling (Hillis-Steele) scan: log2(chunk) passes of whole-tensor products,
all chunks at once, where the reference runs `lax.associative_scan`.  A
4,096-token prefill is then 8 passes and 16 carries a layer, not 4,096
steps driven from the host.  The scan and the step run in float32; the
reference computes them outside Pallas, so there is no TPU kernel here.

Dtype promotions are the reference's: `dt`, `Bm` and `xi` keep the model's
type (bfloat16), `A` is float32, so `a = exp(dt A)` is float32 and
`b = dt Bm xi` is rounded in the model's type before the float32 scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

__all__ = ["ssm_defs", "selective_scan", "ssm_head", "ssm_step", "CHUNK"]

CHUNK = 256     # the reference's chunk (tokens) of the selective scan


def ssm_defs(cfg):
    d, n = cfg.d_model, cfg.ssm_state
    return {
        "in_proj": ParamDef((d, d), ("data", "model")),
        "dt_proj": ParamDef((d, 1), ("data", None)),
        "B_proj": ParamDef((d, n), ("data", None)),
        "C_proj": ParamDef((d, n), ("data", None)),
        "A_log": ParamDef((d, n), ("model", None), init="zeros"),
        "D_skip": ParamDef((d,), (None,), init="ones"),
        "conv_w": ParamDef((4, d), (None, "model"), init="zeros"),
        "out_proj": ParamDef((d, d), ("model", "data")),
    }


def _causal_conv(x, w):
    """Depthwise causal conv of width 4.  x: (B, S, D); w: (4, D): tap w[3]
    on x_t, w[0] on x_{t-3}, summed in x's type in the reference's order."""
    S = x.shape[1]
    out = 0
    for k in range(4):
        shifted = F.pad(x, (0, 0, k, 0))[:, :S]
        out = out + shifted * w[3 - k][None, None, :]
    return out


def _doubling_scan(a, b, dim):
    """Inclusive scan of (a, b) under (a1, b1) then (a2, b2) -> (a1 a2,
    b1 a2 + b2) along `dim`, in log2 passes: (prod a, the state from 0)."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_prev = a.narrow(dim, 0, n - d)
        b_prev = b.narrow(dim, 0, n - d)
        a_cur = a.narrow(dim, d, n - d)
        b_cur = b.narrow(dim, d, n - d)
        a = torch.cat([a.narrow(dim, 0, d), a_prev * a_cur], dim)
        b = torch.cat([b.narrow(dim, 0, d), b_prev * a_cur + b_cur], dim)
        d *= 2
    return a, b


def selective_scan(a, b, C, chunk: int = CHUNK):
    """h_t = a_t * h_{t-1} + b_t from h = 0; y_t = C_t . h_t.  a, b:
    (B, S, D, N); C: (B, S, N) -> (y (B, S, D), h_last (B, D, N)).  S must
    be a whole number of chunks of min(chunk, S), as in the reference."""
    B, S, D, N = a.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"selective_scan: {S} tokens are not a whole number "
                         f"of chunks of {chunk} (the reference's contract)")
    nc = S // chunk
    aa, bb = _doubling_scan(a.reshape(B, nc, chunk, D, N),
                            b.reshape(B, nc, chunk, D, N), dim=2)
    h = torch.zeros(B, D, N, dtype=a.dtype, device=a.device)
    Cc = C.reshape(B, nc, chunk, N)
    ys = []
    for c in range(nc):
        hs = aa[:, c] * h[:, None] + bb[:, c]            # (B, chunk, D, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cc[:, c]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def ssm_head(x, p, cfg):
    """x: (B, S, D) -> (y (B, S, D) after out_proj, h_last (B, D, N)
    float32), the state from 0 (a prefill; a decode steps `ssm_step`)."""
    xi = x @ p["in_proj"]
    xi = F.silu(_causal_conv(xi, p["conv_w"]) + xi)
    dt = F.softplus(xi @ p["dt_proj"])                            # (B, S, 1)
    Bm = xi @ p["B_proj"]                                         # (B, S, N)
    Cm = xi @ p["C_proj"]
    A = -torch.exp(p["A_log"].float())                            # (D, N)
    a = torch.exp(dt[..., None] * A[None, None])                  # (B,S,D,N)
    b = (dt[..., None] * Bm[:, :, None, :]) * xi[..., None]       # (B,S,D,N)
    y_state, h_last = selective_scan(a.float(), b.float(), Cm.float())
    y = y_state.to(x.dtype) + xi * p["D_skip"]
    return y @ p["out_proj"], h_last


def ssm_step(x, p, conv, h):
    """One token of the SSM head, the reference's decode form.  x: (B, 1,
    D); conv (B, 4, D): the last 4 rows of the input projection (the causal
    conv's tail, in the cache's type); h (B, D, N) float32 state -> (y (B,
    1, D) after out_proj, the new tail, the new state).  The state is
    rounded to x's type before C . h, as the reference's decode does."""
    xi = x @ p["in_proj"]                                         # (B, 1, D)
    conv = torch.cat([conv[:, 1:], xi.to(conv.dtype)], dim=1)     # (B, 4, D)
    xi = F.silu((conv.to(xi.dtype) * p["conv_w"][None]).sum(
        1, keepdim=True) + xi)
    dt = F.softplus(xi @ p["dt_proj"])                            # (B, 1, 1)
    Bm = xi @ p["B_proj"]
    Cm = xi @ p["C_proj"]
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[..., None] * A[None, None])[:, 0]            # (B, D, N)
    b = ((dt[..., None] * Bm[:, :, None, :]) * xi[..., None])[:, 0]
    h = a * h + b.float()
    y = torch.einsum("bdn,bn->bd", h.to(xi.dtype), Cm[:, 0])
    return (y + xi[:, 0] * p["D_skip"])[:, None] @ p["out_proj"], conv, h
