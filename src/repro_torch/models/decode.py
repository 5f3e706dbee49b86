"""Serving path: prefill + single-token decode with caches.

Cache layout, one entry per superblock in `cache["blocks"]` (so the cache
and the weights index alike), the reference's per-superblock entry:

  dense, moe,
  encdec     : {'k', 'v'}  (B, S_max, Hkv, hd) bfloat16 (`CDT`)
  vlm        : {'k', 'v'}  (n_self, B, S_max, Hkv, hd), the superblock's
               n_self = cross_attn_period - 1 self sublayers stacked
  gemma3     : {'k_loc', 'v_loc'} (5, B, window, Hkv, hd), RING buffers of
               the 5 local sublayers (position p in slot p % window), and
               {'k_glob', 'v_glob'} (B, S_max, Hkv, hd) of the global one
  hybrid     : {'k', 'v'} (B, S_max, Hkv, hd) (a full cache: a local layer
               masks to its window when it reads), {'ssm_h'} (B, D, N)
               float32 SSM state and {'conv'} (B, 4, D) the last 4 rows of
               the SSM's input projection (the causal conv's tail)
  rwkv6      : {'tm_tok', 'cm_tok'} (B, 1, D) bfloat16 token-shift tails and
               {'wkv'} (B, H, hd, hd) float32 state: O(1) in sequence length.

and beside the blocks what cross-attention reads, stored once: vlm,
`cache["memory"]` (B, n_vis_tokens, D), the patch embeddings; encdec,
`cache["memory"]` (B, S_max, D), the encoder's output padded to S_max, and
`cache["memory_len"]`, its live rows (a 0-d int64 tensor).

A local sublayer's ring holds its last `window` keys whatever S_max is, so
its cache bytes scale with the window, not with the context.

Prefill collects the caches in the same pass as the forward, so a prefill
launches K4 once per attention sublayer over the sequence (the reference
runs the forward and then a second pass over the blocks to collect them):
self, encoder and cross-attention alike; the encoder runs once.  The caches
equal the reference's, the rings laid out as its `_ring_fill` lays them.
That includes the rwkv6 channel-mix tail, which the reference stores as
`rms_norm(block_output, ln2)[:, -1:]` where the block reads
`rms_norm(x_after_time_mix, ln2)` (ROADMAP.md, faults of the reference):
the port reproduces it.  The attention caches and the memory are bfloat16
whatever the model's type, as `init_cache` makes them and `decode_step`
writes them.  An encdec prompt's frames must have the prompt's length, as
the reference's prefill requires (its encoder reads `arange(S)`).

`decode_step` updates the caches in place: a full cache one position per
step (`index_copy_` at `pos`), a ring at `pos % window` with `kv_len =
min(pos + 1, window)` valid slots, hymba's SSM state and conv tail and the
rwkv6 state and token tails by `copy_`.  A hymba layer's window is fixed
per layer in Python (None on a global layer).  Cross-attention reads the
stored memory (encdec: its `memory_len` live rows) through
`attention_full`, as the single-query self-attention does.  `pos` may be a
0-d int64 tensor on the device, which every read of it (RoPE, the cache
writes, the `kv_len` masks) takes as it is, and the MoE sublayer reads
nothing back to the host, so a CUDA graph of the step replays at any
position (`serve.engine`); this matches the reference's traced `pos` and
`dynamic_update_slice`.

`par` (the reference's argument, `NONE` by default) reaches the MoE
sublayers only: under a mesh with a model axis they run the
expert-parallel route (`models.moe`), whose stacked collectives read
nothing back either, so a step under a stacked mesh captures too.
"""
from __future__ import annotations

import torch

from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_rope, attention_full, rms_norm
from repro_torch.models.transformer import (_attn_sublayer, _ffn_sublayer,
                                            _mlp_sublayer, _n_superblocks,
                                            _period, _sublayer_kind, _window,
                                            check_supported, embed,
                                            hybrid_block, logits_fn,
                                            memory_of, superblock)
from repro_torch.sharding.parallel import NONE

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
    elif cfg.family == "hybrid":
        def per():
            return {"k": z(B, S_max, Hkv, hd), "v": z(B, S_max, Hkv, hd),
                    "ssm_h": z(B, D, cfg.ssm_state, dtype=torch.float32),
                    "conv": z(B, 4, D)}
    elif cfg.cross_attn_period:
        n_self = cfg.cross_attn_period - 1

        def per():
            return {"k": z(n_self, B, S_max, Hkv, hd),
                    "v": z(n_self, B, S_max, Hkv, hd)}
    elif cfg.swa_period:
        nl, w = cfg.swa_period - 1, cfg.sliding_window

        def per():
            return {"k_loc": z(nl, B, w, Hkv, hd), "v_loc": z(nl, B, w, Hkv, hd),
                    "k_glob": z(B, S_max, Hkv, hd),
                    "v_glob": z(B, S_max, Hkv, hd)}
    else:
        def per():
            return {"k": z(B, S_max, Hkv, hd), "v": z(B, S_max, Hkv, hd)}
    cache = {"blocks": [per() for _ in range(_n_superblocks(cfg))]}
    if cfg.family == "vlm":
        cache["memory"] = z(B, cfg.n_vis_tokens, D)
    if cfg.is_encdec:
        cache["memory"] = z(B, S_max, D)
        cache["memory_len"] = z(dtype=torch.long)
    return cache


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


def _store_kv(c, kv, S, cfg):
    """One superblock's prefill keys and values (kind, k, v) into its
    cache entry c (a vlm's self caches stacked, the i-th self sublayer's
    at index i)."""
    li = si = 0
    for kind, k, v in kv:
        if kind == "attn_local":
            _ring_fill(c["k_loc"][li], k)
            _ring_fill(c["v_loc"][li], v)
            li += 1
        elif kind == "attn_global":
            c["k_glob"][:, :S] = k
            c["v_glob"][:, :S] = v
        else:
            kc, vc = c["k"], c["v"]
            if cfg.cross_attn_period:
                kc, vc = kc[si], vc[si]
                si += 1
            kc[:, :S] = k
            vc[:, :S] = v


# ---------------------------------------------------------------- prefill --
def prefill(params, tokens, cfg, S_max: int, *, frames=None, vis=None,
            par=NONE):
    """Run the full prompt (B, S), with the frame embeddings (B, S, D) of an
    encdec model or the patch embeddings (B, n_vis_tokens, D) of a vlm;
    return (cache, last-token logits (B, 1, V))."""
    check_supported(cfg)
    B, S = tokens.shape
    if S > S_max:
        raise ValueError(f"prefill: prompt of {S} tokens exceeds S_max "
                         f"{S_max}")
    if cfg.is_encdec and frames is not None and frames.shape[:2] != (B, S):
        raise ValueError(f"prefill: frames {tuple(frames.shape)} for a "
                         f"prompt of ({B}, {S}) tokens (the encoder reads "
                         f"the prompt's positions)")
    x = embed(params, tokens, cfg)
    cache = init_cache(cfg, B, S_max, x.device)
    positions = torch.arange(S, device=x.device)
    if cfg.family == "ssm":
        h = _prefill_recurrent(params, x, cfg, cache)
    elif cfg.family == "hybrid":
        h = x
        for i, (pb, c) in enumerate(zip(params["blocks"], cache["blocks"])):
            h, ent = hybrid_block(h, pb, cfg, positions=positions,
                                  window=_window(cfg, i))
            c["k"][:, :S] = ent["k"]
            c["v"][:, :S] = ent["v"]
            c["ssm_h"].copy_(ent["ssm_h"])
            tail = ent["x_tail"] @ pb["ssm0"]["in_proj"]
            c["conv"][:, 4 - tail.shape[1]:] = tail
    else:
        memory = memory_of(params, cfg, frames, vis)
        if memory is not None:
            cache["memory"][:, :memory.shape[1]] = memory
        if cfg.is_encdec:
            cache["memory_len"].fill_(S)
        h = x
        for pb, c in zip(params["blocks"], cache["blocks"]):
            h, _, kv = superblock(h, pb, cfg, positions=positions,
                                  memory=memory, par=par)
            _store_kv(c, kv, S, cfg)
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
def _hybrid_step(h, pb, c, cfg, pos, window):
    """One hymba layer for one token: attention over the full cache (its
    keys from pos - window + 1 unless window is None), the SSM head one
    step from `ssm_h` and the conv tail, both averaged into the residual,
    then the MLP.  Writes k / v at pos, `ssm_h` and `conv` in place."""
    B = h.shape[0]
    pa, ps = pb["attn0"], pb["ssm0"]
    positions = pos.reshape(1)
    xn = rms_norm(h, pa["ln"], cfg.norm_eps)
    q = _q(xn, pa, cfg, positions)
    k, v = _kv(xn, pa, cfg, positions)
    c["k"].index_copy_(1, positions, k.to(CDT))
    c["v"].index_copy_(1, positions, v.to(CDT))
    o = attention_full(q, c["k"].to(q.dtype), c["v"].to(q.dtype),
                       causal=False, window=window, q_offset=pos,
                       kv_len=pos + 1)
    o_attn = o.reshape(B, 1, -1) @ pa["wo"]
    y_ssm, conv, ssm_h = ssm_mod.ssm_step(xn, ps, c["conv"], c["ssm_h"])
    c["ssm_h"].copy_(ssm_h)
    c["conv"].copy_(conv)
    return _mlp_sublayer(h + 0.5 * (o_attn + y_ssm), pb["mlp0"], cfg)


def decode_step(params, cache, tokens, pos, cfg, par=NONE):
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
    elif cfg.family == "hybrid":
        for i, (pb, c) in enumerate(zip(params["blocks"], cache["blocks"])):
            h = _hybrid_step(h, pb, c, cfg, pos, _window(cfg, i))
    else:
        positions = pos.reshape(1)
        memory, mem_len = cache.get("memory"), None
        if memory is not None:      # cross-attention reads its live rows
            mem_len = cache.get("memory_len", memory.shape[1])
            memory = memory.to(h.dtype)
        for pb, c in zip(params["blocks"], cache["blocks"]):
            li = si = 0     # local (ring) and stacked self sublayer counters
            for s in range(_period(cfg)):
                kind = _sublayer_kind(cfg, s)
                if kind == "cross":
                    h, _, _ = _attn_sublayer(h, pb[f"cross{s}"], cfg,
                                             positions=positions,
                                             memory=memory, kv_len=mem_len)
                else:
                    pa = pb[f"attn{s}"]
                    xn = rms_norm(h, pa["ln"], cfg.norm_eps)
                    q = _q(xn, pa, cfg, positions)
                    k, v = _kv(xn, pa, cfg, positions)
                    at, kv_len = positions, pos + 1
                    if kind == "attn_local":    # ring slot pos % window
                        w = cfg.sliding_window
                        kc, vc = c["k_loc"][li], c["v_loc"][li]
                        at, kv_len = positions % w, torch.clamp(kv_len, max=w)
                        li += 1
                    elif kind == "attn_global":
                        kc, vc = c["k_glob"], c["v_glob"]
                    elif cfg.cross_attn_period:     # vlm: stacked caches
                        kc, vc = c["k"][si], c["v"][si]
                        si += 1
                    else:
                        kc, vc = c["k"], c["v"]
                    kc.index_copy_(1, at, k.to(kc.dtype))
                    vc.index_copy_(1, at, v.to(vc.dtype))
                    o = attention_full(q, kc.to(q.dtype), vc.to(q.dtype),
                                       causal=False, kv_len=kv_len)
                    h = h + o.reshape(B, 1, -1) @ pa["wo"]
                if cfg.is_encdec:
                    h, _, _ = _attn_sublayer(h, pb[f"dec_cross{s}"], cfg,
                                             positions=positions,
                                             memory=memory, kv_len=mem_len)
                h, _ = _ffn_sublayer(h, pb, cfg, s, par)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return logits_fn(params, h, cfg), cache
