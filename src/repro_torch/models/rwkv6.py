"""RWKV6 (Finch) blocks: time-mix with data-dependent decay + channel-mix.

The WKV recurrence runs in the hand-written kernel K5
(`repro_torch.kernels.rwkv.rwkv6_wkv`), where the reference runs its
plain-XLA chunkwise `wkv_chunked`.  The reference takes `log(clip(w, 1e-5,
1))` there, so the port clips `w` to [1e-5, 1] before the kernel, and keeps
the reference's `chunk = min(64, S)` with its `S % chunk == 0` contract.
Attention-free: the decode state is O(D^2/H) per layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv import rwkv6_wkv
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamDef

__all__ = ["rwkv_defs", "time_mix", "channel_mix", "rwkv_block"]

CHUNK = 64


def rwkv_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln1": ParamDef((d,), init="ones"),
        "ln2": ParamDef((d,), init="ones"),
        # time-mix
        "mu_r": ParamDef((d,), init="zeros"),
        "mu_k": ParamDef((d,), init="zeros"),
        "mu_v": ParamDef((d,), init="zeros"),
        "mu_w": ParamDef((d,), init="zeros"),
        "mu_g": ParamDef((d,), init="zeros"),
        "w_r": ParamDef((d, d)),
        "w_k": ParamDef((d, d)),
        "w_v": ParamDef((d, d)),
        "w_w": ParamDef((d, d), scale=1e-2),
        "w_g": ParamDef((d, d)),
        "w_o": ParamDef((d, d)),
        "w_bias": ParamDef((d,), init="zeros"),
        "u_bonus": ParamDef((d,), init="zeros"),
        "ln_x": ParamDef((d,), init="ones"),
        # channel-mix
        "cmu_k": ParamDef((d,), init="zeros"),
        "cmu_r": ParamDef((d,), init="zeros"),
        "cw_k": ParamDef((d, f)),
        "cw_v": ParamDef((f, d)),
        "cw_r": ParamDef((d, d)),
    }


def _token_shift(x, prev):
    """prev: (B, 1, D) last token of the previous segment (or zeros)."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def time_mix(x, p, cfg, prev_tok=None, wkv_state=None):
    """x: (B, S, D).  Returns (out, (last_token, wkv_state))."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    prev = prev_tok if prev_tok is not None else x.new_zeros(B, 1, D)
    xs = _token_shift(x, prev)

    def mix(mu):
        return x + (xs - x) * mu

    def heads(a):                                    # (B, S, D) -> (B*H, S, hd)
        return a.reshape(B, S, H, hd).transpose(1, 2).reshape(B * H, S, hd)

    r = heads(mix(p["mu_r"]) @ p["w_r"])
    k = heads(mix(p["mu_k"]) @ p["w_k"])
    v = heads(mix(p["mu_v"]) @ p["w_v"])
    g = F.silu(mix(p["mu_g"]) @ p["w_g"])
    w = torch.exp(-torch.exp((mix(p["mu_w"]) @ p["w_w"] + p["w_bias"])
                             .float()))              # (B, S, D) in (0, 1)
    w = heads(w.clamp(1e-5, 1.0))
    u = p["u_bonus"].reshape(1, H, hd).expand(B, H, hd).reshape(B * H, hd)
    s0 = (wkv_state if wkv_state is not None
          else torch.zeros(B, H, hd, hd, dtype=torch.float32,
                           device=x.device))
    y, s1 = rwkv6_wkv(r, k, v, w, u, s0.reshape(B * H, hd, hd),
                      chunk=min(CHUNK, S))
    y = y.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, D)
    y = rms_norm(y, p["ln_x"], 1e-5) * g
    return y @ p["w_o"], (x[:, -1:], s1.reshape(B, H, hd, hd))


def channel_mix(x, p, prev_tok=None):
    B, S, D = x.shape
    prev = prev_tok if prev_tok is not None else x.new_zeros(B, 1, D)
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * p["cmu_k"]
    xr = x + (xs - x) * p["cmu_r"]
    k = torch.square(F.relu(xk @ p["cw_k"]))
    return torch.sigmoid(xr @ p["cw_r"]) * (k @ p["cw_v"]), x[:, -1:]


def rwkv_block(x, p, cfg, cache=None):
    """cache: dict(tm_tok, wkv, cm_tok) or None.  Returns (x, new_cache)."""
    tm_tok = cache["tm_tok"] if cache else None
    wkv = cache["wkv"] if cache else None
    cm_tok = cache["cm_tok"] if cache else None
    h, (tm_tok_n, wkv_n) = time_mix(rms_norm(x, p["ln1"]), p, cfg, tm_tok, wkv)
    x = x + h
    h, cm_tok_n = channel_mix(rms_norm(x, p["ln2"]), p, cm_tok)
    x = x + h
    return x, {"tm_tok": tm_tok_n, "wkv": wkv_n, "cm_tok": cm_tok_n}
