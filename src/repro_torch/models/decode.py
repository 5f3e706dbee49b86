"""Serving path: prefill + single-token decode with caches.

Cache layout, one entry per superblock in `cache["blocks"]` (so the cache
and the weights index alike), the reference's per-superblock entry:

  dense, moe : {'k', 'v'}  (B, S_max, Hkv, hd) bfloat16 (`CDT`)
  gemma3     : {'k_loc', 'v_loc'} (5, B, window, Hkv, hd), RING buffers of
               the 5 local sublayers (position p in slot p % window), and
               {'k_glob', 'v_glob'} (B, S_max, Hkv, hd) of the global one
  rwkv6      : {'tm_tok', 'cm_tok'} (B, 1, D) bfloat16 token-shift tails and
               {'wkv'} (B, H, hd, hd) float32 state: O(1) in sequence length.

A local sublayer's ring holds its last `window` keys whatever S_max is, so
its cache bytes scale with the window, not with the context.

Prefill collects the caches in the same pass as the forward, so a prefill
launches K4 once per attention sublayer (the reference runs the forward
and then a second pass over the blocks to collect them); the caches equal
the reference's, the rings laid out as its `_ring_fill` lays them.  That
includes the rwkv6 channel-mix tail, which the reference stores as
`rms_norm(block_output, ln2)[:, -1:]` where the block reads
`rms_norm(x_after_time_mix, ln2)` (ROADMAP.md, faults of the reference):
the port reproduces it.  The attention caches are bfloat16 whatever the
model's type, as `init_cache` makes them and `decode_step` writes them.

`decode_step` updates the caches in place: a full cache one position per
step (`index_copy_` at `pos`), a ring at `pos % window` with `kv_len =
min(pos + 1, window)` valid slots, the rwkv6 state and token tails by
`copy_`.  `pos` may be a 0-d int64 tensor on the device, which every read
of it (RoPE, the cache writes, the `kv_len` masks) takes as it is, and the
MoE sublayer reads nothing back to the host, so a CUDA graph of the step
replays at any position (`serve.engine`); this matches the reference's
traced `pos` and `dynamic_update_slice`.
"""
from __future__ import annotations

import torch

from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import apply_rope, attention_full, rms_norm
from repro_torch.models.transformer import (_ffn_sublayer, _n_superblocks,
                                            _period, _sublayer_kind,
                                            check_supported, embed, logits_fn,
                                            superblock)

__all__ = ["CDT", "init_cache", "prefill", "decode_step"]

CDT = torch.bfloat16


def init_cache(cfg, B: int, S_max: int, device) -> dict:
    check_supported(cfg)
    hd, D, Hkv = cfg.hd, cfg.d_model, cfg.n_kv_heads

    def z(*shape, dtype=CDT):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family == "ssm":
        def per():
            return {"tm_tok": z(B, 1, D),
                    "wkv": z(B, cfg.n_heads, hd, hd, dtype=torch.float32),
                    "cm_tok": z(B, 1, D)}
    elif cfg.swa_period:
        nl, w = cfg.swa_period - 1, cfg.sliding_window

        def per():
            return {"k_loc": z(nl, B, w, Hkv, hd), "v_loc": z(nl, B, w, Hkv, hd),
                    "k_glob": z(B, S_max, Hkv, hd),
                    "v_glob": z(B, S_max, Hkv, hd)}
    else:
        def per():
            return {"k": z(B, S_max, Hkv, hd), "v": z(B, S_max, Hkv, hd)}
    return {"blocks": [per() for _ in range(_n_superblocks(cfg))]}


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


def _ring_fill(ring, k_full):
    """The last `window` positions of k_full (B, S, n, hd) into the ring
    (B, window, n, hd), position p in slot p % window (in place)."""
    S, window = k_full.shape[1], ring.shape[1]
    take = min(window, S)
    slots = torch.arange(S - take, S, device=ring.device) % window
    ring[:, slots] = k_full[:, S - take:].to(ring.dtype)


def _store_kv(c, kv, S):
    """One superblock's prefill keys and values (kind, k, v) into its
    cache entry c."""
    li = 0
    for kind, k, v in kv:
        if kind == "attn_local":
            _ring_fill(c["k_loc"][li], k)
            _ring_fill(c["v_loc"][li], v)
            li += 1
        else:
            glob = kind == "attn_global"
            c["k_glob" if glob else "k"][:, :S] = k
            c["v_glob" if glob else "v"][:, :S] = v


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
            h, _, kv = superblock(h, pb, cfg, positions=positions)
            _store_kv(c, kv, S)
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
            li = 0          # local (ring) sublayer counter
            for s in range(_period(cfg)):
                kind = _sublayer_kind(cfg, s)
                pa = pb[f"attn{s}"]
                xn = rms_norm(h, pa["ln"], cfg.norm_eps)
                q = _q(xn, pa, cfg, positions)
                k, v = _kv(xn, pa, cfg, positions)
                at, kv_len = positions, pos + 1
                if kind == "attn_local":        # ring slot pos % window
                    w = cfg.sliding_window
                    kc, vc = c["k_loc"][li], c["v_loc"][li]
                    at, kv_len = positions % w, torch.clamp(kv_len, max=w)
                    li += 1
                elif kind == "attn_global":
                    kc, vc = c["k_glob"], c["v_glob"]
                else:
                    kc, vc = c["k"], c["v"]
                kc.index_copy_(1, at, k.to(kc.dtype))
                vc.index_copy_(1, at, v.to(vc.dtype))
                o = attention_full(q, kc.to(q.dtype), vc.to(q.dtype),
                                   causal=False, kv_len=kv_len)
                h = h + o.reshape(B, 1, -1) @ pa["wo"]
                h, _ = _ffn_sublayer(h, pb, cfg, s)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return logits_fn(params, h, cfg), cache
