"""Decoder stack of the dense, moe and ssm families.

A *superblock* is the repeating layer pattern, as in the reference: dense,
one attention and one MLP sublayer (`attn0`, `mlp0`); gemma3, 5 local
(sliding-window) + 1 global attention sublayers, each with its MLP
(`attn0` .. `attn5`, `mlp0` .. `mlp5`); moe, attention and an expert FFN
(`attn0`, `moe0`); rwkv6, one time-mix + channel-mix block (`rwkv`).  The
reference stacks the superblocks' weights and scans over them; the port
keeps one weight tree per superblock (`params["blocks"]`, a list of
`n_layers / period` trees) and runs them as a Python loop.  Weights keep the
reference's orientation: `x @ W` with W shaped (d_in, d_out).  Every
attention sublayer runs K4, with the sliding window on local ones.

The reference's hybrid, encdec and vlm families (and cross-attention) are
queued in ROADMAP.md and raise NotImplementedError here, as do training and
sharding.
"""
from __future__ import annotations

import torch

from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (apply_rope, attention_flash, rms_norm,
                                       swiglu)
from repro_torch.models.params import ParamDef, stack_defs

__all__ = ["attn_defs", "mlp_defs", "superblock_defs", "model_defs",
           "padded_vocab", "forward", "forward_with_aux", "superblock",
           "logits_fn", "check_supported"]


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what the port does not serve yet."""
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md, LM tier); the port serves dense, moe and ssm")
    if cfg.cross_attn_period or cfg.is_encdec or cfg.global_layers:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention, encoder-decoder and explicit "
            f"global-layer layouts are not ported yet (ROADMAP.md)")
    if cfg.family == "ssm" and cfg.norm_eps != 1e-5:
        raise NotImplementedError(
            f"{cfg.name}: rwkv6 with norm_eps {cfg.norm_eps} (the block "
            f"normalises with 1e-5, the reference's prefill cache with "
            f"norm_eps; only equal values are ported)")


# ============================================================ param defs ====
def attn_defs(cfg):
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    defs = {
        "ln": ParamDef((d,), init="ones"),
        "wq": ParamDef((d, H * hd)),
        "wk": ParamDef((d, Hkv * hd)),
        "wv": ParamDef((d, Hkv * hd)),
        "wo": ParamDef((H * hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), init="ones")
        defs["k_norm"] = ParamDef((hd,), init="ones")
    return defs


def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamDef((d,), init="ones"),
        "w_gate": ParamDef((d, f)),
        "w_up": ParamDef((d, f)),
        "w_down": ParamDef((f, d)),
    }


def superblock_defs(cfg):
    """Param defs for ONE superblock of the given family."""
    check_supported(cfg)
    if cfg.family == "ssm":
        return {"rwkv": rwkv_mod.rwkv_defs(cfg)}
    blocks = {}
    for s in range(_period(cfg)):
        blocks[f"attn{s}"] = attn_defs(cfg)
        if cfg.n_experts:
            blocks[f"moe{s}"] = dict(moe_mod.moe_defs(cfg),
                                     ln=ParamDef((cfg.d_model,), init="ones"))
        else:
            blocks[f"mlp{s}"] = mlp_defs(cfg)
    return blocks


def _period(cfg) -> int:
    return cfg.swa_period or 1


def _n_superblocks(cfg) -> int:
    n, period = cfg.n_layers, _period(cfg)
    if n % period:
        raise ValueError(f"{cfg.name}: {n} layers are not a whole number of "
                         f"superblocks of {period}")
    return n // period


def _sublayer_kind(cfg, s) -> str:
    if cfg.swa_period:
        return "attn_local" if s < cfg.swa_period - 1 else "attn_global"
    return "attn"


def padded_vocab(cfg) -> int:
    """Embedding tables padded to a 256 multiple, as the reference pads them
    (labels never index the padding)."""
    return -(-cfg.vocab // 256) * 256


def model_defs(cfg):
    d = cfg.d_model
    vp = padded_vocab(cfg)
    defs = {
        "embed": ParamDef((vp, d), scale=0.02),
        "final_ln": ParamDef((d,), init="ones"),
        "blocks": stack_defs(superblock_defs(cfg), _n_superblocks(cfg)),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, vp), scale=0.02)
    return defs


# =========================================================== sub-layers =====
def _attn_sublayer(h, p, cfg, *, positions, window=None):
    """Pre-norm causal self-attention with residual, through K4 (within
    `window` keys when given).  Returns (h, k, v): the new residual stream
    and the layer's rotated keys and values (B, S, Hkv, hd), which prefill
    stores in the cache."""
    B, S, _ = h.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention_flash(q, k, v, causal=True, window=window)
    return h + o.reshape(B, S, H * hd) @ p["wo"], k, v


def _mlp_sublayer(h, p, cfg):
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _moe_sublayer(h, p, cfg):
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    y, aux = moe_mod.moe_ffn(x, p, cfg)
    return h + y, aux


def _ffn_sublayer(h, pb, cfg, s):
    """Sublayer s's MLP or expert FFN: (h, aux), aux 0.0 for an MLP."""
    if cfg.n_experts:
        return _moe_sublayer(h, pb[f"moe{s}"], cfg)
    return _mlp_sublayer(h, pb[f"mlp{s}"], cfg), 0.0


def superblock(h, pb, cfg, *, positions):
    """One attention superblock over a whole sequence: (h, aux, kv), kv one
    (kind, k, v) per attention sublayer, in order."""
    aux, kv = 0.0, []
    for s in range(_period(cfg)):
        kind = _sublayer_kind(cfg, s)
        window = cfg.sliding_window if kind == "attn_local" else None
        h, k, v = _attn_sublayer(h, pb[f"attn{s}"], cfg, positions=positions,
                                 window=window)
        kv.append((kind, k, v))
        h, aux_s = _ffn_sublayer(h, pb, cfg, s)
        aux = aux + aux_s
    return h, aux, kv


# ============================================================= forward ======
def embed(params, tokens, cfg):
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


def forward_with_aux(params, tokens, cfg):
    """Full-sequence forward -> (final hidden states (B, S, D), the MoE aux
    loss summed over layers: a float32 0-d tensor, 0 without experts)."""
    check_supported(cfg)
    h = embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        for pb in params["blocks"]:
            h, _ = rwkv_mod.rwkv_block(h, pb["rwkv"], cfg)
    else:
        positions = torch.arange(tokens.shape[1], device=h.device)
        for pb in params["blocks"]:
            h, aux_b, _ = superblock(h, pb, cfg, positions=positions)
            aux = aux + aux_b
    return rms_norm(h, params["final_ln"], cfg.norm_eps), aux


def forward(params, tokens, cfg):
    """Full-sequence forward -> final hidden states (B, S, D)."""
    return forward_with_aux(params, tokens, cfg)[0]


def logits_fn(params, h, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)
