"""Serving path: prefill + single-token decode with caches.

Cache layout, one entry per layer in `cache["blocks"]`:

  dense : {'k', 'v'}  (B, S_max, Hkv, hd) bfloat16 (`CDT`)
  rwkv6 : {'tm_tok', 'cm_tok'} (B, 1, D) bfloat16 token-shift tails and
          {'wkv'} (B, H, hd, hd) float32 state: O(1) in sequence length.

Prefill collects the caches in the same pass as the forward, so a dense
prefill launches K4 once per layer (the reference runs the forward and then
a second pass over the blocks to collect them); the caches equal the
reference's.  That includes the rwkv6 channel-mix tail, which the reference
stores as `rms_norm(block_output, ln2)[:, -1:]` where the block reads
`rms_norm(x_after_time_mix, ln2)` (ROADMAP.md, faults of the reference):
the port reproduces it.  The dense caches are bfloat16 whatever the model's
type, as `init_cache` makes them and `decode_step` writes them.

`decode_step` updates the caches in place: a dense cache one position per
step (`index_copy_` at `pos`), the rwkv6 state and token tails by `copy_`.
`pos` may be a 0-d int64 tensor on the device, which every read of it
(RoPE, the cache write, the `kv_len` mask) takes as it is, so a CUDA graph
of the step replays at any position (`serve.engine`); this matches the
reference's traced `pos` and `dynamic_update_slice`.
"""
from __future__ import annotations

import torch

from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import apply_rope, attention_full, rms_norm
from repro_torch.models.transformer import (_attn_sublayer, _mlp_sublayer,
                                            check_supported, embed, logits_fn)

__all__ = ["CDT", "init_cache", "prefill", "decode_step"]

CDT = torch.bfloat16


def init_cache(cfg, B: int, S_max: int, device) -> dict:
    check_supported(cfg)
    hd, D = cfg.hd, cfg.d_model
    if cfg.family == "ssm":
        def per():
            return {"tm_tok": torch.zeros(B, 1, D, dtype=CDT, device=device),
                    "wkv": torch.zeros(B, cfg.n_heads, hd, hd,
                                       dtype=torch.float32, device=device),
                    "cm_tok": torch.zeros(B, 1, D, dtype=CDT, device=device)}
    else:
        def per():
            shape = (B, S_max, cfg.n_kv_heads, hd)
            return {"k": torch.zeros(shape, dtype=CDT, device=device),
                    "v": torch.zeros(shape, dtype=CDT, device=device)}
    return {"blocks": [per() for _ in range(cfg.n_layers)]}


# ------------------------------------------------------- kv projections ----
def _kv(x, p, cfg, positions):
    B, S, _ = x.shape
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _q(x, p, cfg, positions):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta)


# ---------------------------------------------------------------- prefill --
def prefill(params, tokens, cfg, S_max: int):
    """Run the full prompt (B, S); return (cache, last-token logits
    (B, 1, V))."""
    check_supported(cfg)
    B, S = tokens.shape
    if S > S_max:
        raise ValueError(f"prefill: prompt of {S} tokens exceeds S_max "
                         f"{S_max}")
    x = embed(params, tokens, cfg)
    cache = init_cache(cfg, B, S_max, x.device)
    if cfg.family == "ssm":
        h = _prefill_recurrent(params, x, cfg, cache)
    else:
        positions = torch.arange(S, device=x.device)
        h = x
        for pb, c in zip(params["blocks"], cache["blocks"]):
            h, k, v = _attn_sublayer(h, pb["attn0"], cfg, positions=positions)
            c["k"][:, :S] = k
            c["v"][:, :S] = v
            h = _mlp_sublayer(h, pb["mlp0"], cfg)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return cache, logits_fn(params, h[:, -1:], cfg)


def _prefill_recurrent(params, x, cfg, cache):
    """rwkv6: run the blocks, filling each layer's shift tails and WKV
    state.  Returns the last block's output."""
    for pb, c in zip(params["blocks"], cache["blocks"]):
        p = pb["rwkv"]
        x, ent = rwkv_mod.rwkv_block(x, p, cfg)
        c["tm_tok"] = ent["tm_tok"].to(CDT)
        c["wkv"] = ent["wkv"]
        # the reference's entry: the block OUTPUT normalised (see above)
        c["cm_tok"] = rms_norm(x, p["ln2"], cfg.norm_eps)[:, -1:].to(CDT)
    return x


# ----------------------------------------------------------------- decode --
def decode_step(params, cache, tokens, pos, cfg):
    """One token for every sequence.  tokens: (B, 1); pos: the position
    being written, an int or a 0-d int64 tensor on the tokens' device.
    Updates `cache` in place; returns (logits (B, 1, V), cache)."""
    check_supported(cfg)
    B = tokens.shape[0]
    h = embed(params, tokens, cfg)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.long, device=h.device)
    if cfg.family == "ssm":
        for pb, c in zip(params["blocks"], cache["blocks"]):
            h, new_c = rwkv_mod.rwkv_block(
                h, pb["rwkv"], cfg,
                cache={"tm_tok": c["tm_tok"].to(h.dtype), "wkv": c["wkv"],
                       "cm_tok": c["cm_tok"].to(h.dtype)})
            for k in ("tm_tok", "wkv", "cm_tok"):
                c[k].copy_(new_c[k])
    else:
        positions = pos.reshape(1)
        for pb, c in zip(params["blocks"], cache["blocks"]):
            pa = pb["attn0"]
            xn = rms_norm(h, pa["ln"], cfg.norm_eps)
            q = _q(xn, pa, cfg, positions)
            k, v = _kv(xn, pa, cfg, positions)
            c["k"].index_copy_(1, positions, k.to(c["k"].dtype))
            c["v"].index_copy_(1, positions, v.to(c["v"].dtype))
            o = attention_full(q, c["k"].to(q.dtype), c["v"].to(q.dtype),
                               causal=False, kv_len=pos + 1)
            h = h + o.reshape(B, 1, -1) @ pa["wo"]
            h = _mlp_sublayer(h, pb["mlp0"], cfg)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return logits_fn(params, h, cfg), cache
