"""Decoder stack of the dense and ssm families.

A *superblock* is the repeating layer pattern: dense, one attention and one
MLP sublayer (`attn0`, `mlp0`); rwkv6, one time-mix + channel-mix block
(`rwkv`).  The reference stacks the superblocks' weights and scans over
them; the port keeps one weight tree per superblock (`params["blocks"]`, a
list) and runs the layers as a Python loop.  Weights keep the reference's
orientation: `x @ W` with W shaped (d_in, d_out).

The reference's other families (moe, hybrid, encdec, vlm) and sliding-window
layouts are queued in ROADMAP.md and raise NotImplementedError here, as do
training and sharding.
"""
from __future__ import annotations

import torch

from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (apply_rope, attention_flash, rms_norm,
                                       swiglu)
from repro_torch.models.params import ParamDef, stack_defs

__all__ = ["attn_defs", "mlp_defs", "superblock_defs", "model_defs",
           "padded_vocab", "forward", "logits_fn", "check_supported"]


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what the port does not serve yet."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md, LM tier); the port serves dense and ssm")
    if cfg.sliding_window or cfg.swa_period or cfg.cross_attn_period \
            or cfg.n_experts or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window, cross-attention, MoE and "
            f"encoder-decoder layouts are not ported yet (ROADMAP.md)")
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
    return {"attn0": attn_defs(cfg), "mlp0": mlp_defs(cfg)}


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
        "blocks": stack_defs(superblock_defs(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, vp), scale=0.02)
    return defs


# =========================================================== sub-layers =====
def _attn_sublayer(h, p, cfg, *, positions):
    """Pre-norm causal self-attention with residual, through K4.  Returns
    (h, k, v): the new residual stream and the layer's rotated keys and
    values (B, S, Hkv, hd), which prefill stores in the cache."""
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
    o = attention_flash(q, k, v, causal=True)
    return h + o.reshape(B, S, H * hd) @ p["wo"], k, v


def _mlp_sublayer(h, p, cfg):
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ============================================================= forward ======
def embed(params, tokens, cfg):
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


def forward(params, tokens, cfg):
    """Full-sequence forward -> final hidden states (B, S, D)."""
    check_supported(cfg)
    h = embed(params, tokens, cfg)
    if cfg.family == "ssm":
        for pb in params["blocks"]:
            h, _ = rwkv_mod.rwkv_block(h, pb["rwkv"], cfg)
    else:
        positions = torch.arange(tokens.shape[1], device=h.device)
        for pb in params["blocks"]:
            h, _, _ = _attn_sublayer(h, pb["attn0"], cfg, positions=positions)
            h = _mlp_sublayer(h, pb["mlp0"], cfg)
    return rms_norm(h, params["final_ln"], cfg.norm_eps)


def logits_fn(params, h, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)
