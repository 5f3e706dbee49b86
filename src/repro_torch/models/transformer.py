"""Decoder (and encoder) stacks of every family of the reference.

A *superblock* is the repeating layer pattern, as in the reference: dense,
one attention and one MLP sublayer (`attn0`, `mlp0`); gemma3, 5 local
(sliding-window) + 1 global attention sublayers, each with its MLP
(`attn0` .. `attn5`, `mlp0` .. `mlp5`); vlm, `cross_attn_period - 1` self
and one cross-attention sublayer over the patch embeddings (`attn0` ..
`attn3`, `cross4`, an MLP each); moe, attention and an expert FFN (`attn0`,
`moe0`); encdec, a decoder layer of self-attention, cross-attention over
the encoder's memory and an MLP (`attn0`, `dec_cross0`, `mlp0`) after an
encoder of bidirectional layers (`enc_blocks`, `enc_ln`); hybrid (hymba),
attention and SSM heads in parallel on one normalised input, their outputs
averaged, then an MLP (`attn0`, `ssm0`, `mlp0`), sliding-window except at
`global_layers`; rwkv6, one time-mix + channel-mix block (`rwkv`).  The
reference stacks the superblocks' weights and scans over them; the port
keeps one weight tree per superblock (`params["blocks"]`, a list of
`n_layers / period` trees; `enc_blocks` likewise) and runs them as a Python
loop.  Weights keep the reference's orientation: `x @ W` with W shaped
(d_in, d_out).  Every attention over a whole sequence runs K4: causal (with
the sliding window on local and hymba's non-global layers), bidirectional
in the encoder, and unmasked across to the memory, whose keys and values
take no RoPE.

The training loss is the reference's: `loss_fn` = `chunked_xent` over the
final hidden states (sequence chunks of min(512, S), each chunk's logits
recomputed in backward) plus 0.01 of the MoE aux loss.

`par` (a `sharding.parallel.Parallelism`, `NONE` by default) is the
reference's.  Under a mesh with a model axis of more than one rank every
family runs on the blocks a rank holds (`models.tp`: heads, d_ff
columns, vocabulary rows, experts, rwkv6's time-mix heads and channel-mix
columns, hymba's SSM channels; the weight tree is `tp.shard_model`'s), as
one SPMD program over the ranks this process holds.  With more than one
data rank the leaves with a 'data' entry are held cut over the data axes
(FSDP, `models.tp`): each superblock gathers its tree at its entry
(inside its checkpoint), and the embedding, `final_ln` and the head are
gathered where they are read; a mesh without a model axis then runs each
rank's data shard through the whole-leaf functions below on its gathered
leaves (`_whole_ranks`).  `par.constrain` returns its input (the port
has no GSPMD).
With `par.remat` (the default) and grad enabled, each superblock (the
rwkv6 block, the hymba layer, the encoder block) runs under
`torch.utils.checkpoint` (non-reentrant), as the reference's
`jax.checkpoint`: its activations are recomputed in backward, which
launches its K4 / K5 calls again.  The reference's `chunked` (its chunked
jnp attention) is dropped: K4 serves every length.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import tp as tp_mod
from repro_torch.models.layers import (apply_rope, attention_flash,
                                       attention_full, rms_norm, swiglu)
from repro_torch.models.params import ParamDef, stack_defs
from repro_torch.obs import cost
from repro_torch.sharding.parallel import NONE

__all__ = ["attn_defs", "mlp_defs", "superblock_defs", "model_defs",
           "padded_vocab", "forward", "forward_with_aux", "superblock",
           "hybrid_block", "encode", "memory_of", "logits_fn",
           "chunked_xent", "loss_fn", "rank_losses", "check_supported"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what the port does not serve."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of the "
            f"reference's {FAMILIES}")
    if cfg.family == "ssm" and cfg.norm_eps != 1e-5:
        raise NotImplementedError(
            f"{cfg.name}: rwkv6 with norm_eps {cfg.norm_eps} (the block "
            f"normalises with 1e-5, the reference's prefill cache with "
            f"norm_eps; only equal values are ported)")


# ============================================================ param defs ====
def attn_defs(cfg):
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    defs = {
        "ln": ParamDef((d,), (None,), init="ones"),
        "wq": ParamDef((d, H * hd), ("data", "model")),
        "wk": ParamDef((d, Hkv * hd), ("data", "model")),
        "wv": ParamDef((d, Hkv * hd), ("data", "model")),
        "wo": ParamDef((H * hd, d), ("model", "data")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones")
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return defs


def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamDef((d,), (None,), init="ones"),
        "w_gate": ParamDef((d, f), ("data", "model")),
        "w_up": ParamDef((d, f), ("data", "model")),
        "w_down": ParamDef((f, d), ("model", "data")),
    }


def superblock_defs(cfg, decoder=True):
    """Param defs for ONE superblock of the given family (of its encoder
    with `decoder=False`)."""
    check_supported(cfg)
    if cfg.family == "ssm":
        return {"rwkv": rwkv_mod.rwkv_defs(cfg)}
    blocks = {}
    for s in range(_period(cfg) if decoder else 1):
        kind = _sublayer_kind(cfg, s, decoder)
        if kind == "cross":
            blocks[f"cross{s}"] = attn_defs(cfg)
        else:
            blocks[f"attn{s}"] = attn_defs(cfg)
        if cfg.family == "hybrid":
            blocks[f"ssm{s}"] = ssm_mod.ssm_defs(cfg)
        if cfg.n_experts and decoder:
            blocks[f"moe{s}"] = dict(moe_mod.moe_defs(cfg),
                                     ln=ParamDef((cfg.d_model,), (None,),
                                                 init="ones"))
        else:
            blocks[f"mlp{s}"] = mlp_defs(cfg)
        if cfg.is_encdec and decoder:
            blocks[f"dec_cross{s}"] = attn_defs(cfg)
    return blocks


def _period(cfg) -> int:
    return cfg.swa_period or cfg.cross_attn_period or 1


def _n_superblocks(cfg, decoder=True) -> int:
    n = cfg.n_layers if decoder else cfg.n_enc_layers
    period = _period(cfg) if decoder else 1
    if n % period:
        raise ValueError(f"{cfg.name}: {n} layers are not a whole number of "
                         f"superblocks of {period}")
    return n // period


def _sublayer_kind(cfg, s, decoder=True) -> str:
    if not decoder:
        return "attn_bidir"
    if cfg.swa_period:
        return "attn_local" if s < cfg.swa_period - 1 else "attn_global"
    if cfg.cross_attn_period:
        return "cross" if s == cfg.cross_attn_period - 1 else "attn"
    return "attn"


def _window(cfg, i):
    """hymba's window of superblock i: None (full causal) on a global
    layer, where the reference masks with a window of S + 1."""
    return None if i in cfg.global_layers else cfg.sliding_window


def padded_vocab(cfg) -> int:
    """Embedding tables padded to a 256 multiple, as the reference pads them
    (labels never index the padding)."""
    return -(-cfg.vocab // 256) * 256


def model_defs(cfg):
    d = cfg.d_model
    vp = padded_vocab(cfg)
    defs = {
        "embed": ParamDef((vp, d), ("model", "data"), scale=0.02),
        "final_ln": ParamDef((d,), (None,), init="ones"),
        "blocks": stack_defs(superblock_defs(cfg), _n_superblocks(cfg)),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, vp), ("data", "model"), scale=0.02)
    if cfg.is_encdec:
        defs["enc_blocks"] = stack_defs(superblock_defs(cfg, decoder=False),
                                        cfg.n_enc_layers)
        defs["enc_ln"] = ParamDef((d,), (None,), init="ones")
    return defs


# =========================================================== sub-layers =====
def _attn_sublayer(h, p, cfg, *, positions, causal=True, window=None,
                   memory=None, kv_len=None, tp=None):
    """Pre-norm attention with residual, through K4: causal self-attention
    (within `window` keys when given), bidirectional (`causal=False`), or
    cross-attention over `memory` (B, Sm, D), whose keys take no RoPE and
    no mask.  With `kv_len` (a decode step's one query over a stored
    memory, its first kv_len rows live) it runs `attention_full`, as the
    decode attention does.  Returns (h, k, v): the new residual stream and
    the layer's keys and values (B, Sk, Hkv, hd), which prefill stores in
    the cache.  With `tp` each rank's heads (`tp.attn_sublayer`; h (L, B,
    S, D), k and v per-rank lists)."""
    if tp is not None:
        return tp_mod.attn_sublayer(h, p, cfg, tp, positions=positions,
                                    causal=causal, window=window,
                                    memory=memory, kv_len=kv_len)
    B, S, _ = h.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    src = x if memory is None else memory
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (src @ p["wk"]).reshape(B, src.shape[1], Hkv, hd)
    v = (src @ p["wv"]).reshape(B, src.shape[1], Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if memory is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    else:
        causal, window = False, None
    if kv_len is not None:
        o = attention_full(q, k, v, causal=False, kv_len=kv_len)
    else:
        o = attention_flash(q, k, v, causal=causal, window=window)
    return h + o.reshape(B, S, H * hd) @ p["wo"], k, v


def _mlp_sublayer(h, p, cfg, tp=None):
    if tp is not None:
        return tp_mod.mlp_sublayer(h, p, cfg, tp)
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _moe_sublayer(h, p, cfg, par=NONE, tp=None):
    if tp is not None:
        x = tp.norm(h, p["ln"], cfg.norm_eps)
        y, aux = moe_mod.moe_ranks(x, p, cfg, par, tp)
        return h + y, aux
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    y, aux = moe_mod.moe_ffn(x, p, cfg, par)
    return h + par.constrain(y, par.dp, None, None), aux


def _ffn_sublayer(h, pb, cfg, s, par=NONE, tp=None):
    """Sublayer s's MLP or expert FFN: (h, aux), aux 0.0 for an MLP."""
    if cfg.n_experts:
        return _moe_sublayer(h, pb[f"moe{s}"], cfg, par, tp)
    return _mlp_sublayer(h, pb[f"mlp{s}"], cfg, tp), 0.0


def superblock(h, pb, cfg, *, positions, memory=None, par=NONE, tp=None):
    """One attention superblock over a whole sequence: (h, aux, kv), kv one
    (kind, k, v) per self-attention sublayer, in order; `memory` is what
    the cross-attention sublayers read (vlm, encdec).  With `tp`, on each
    rank's blocks (h (L, B, S, D), aux (L,) with experts), the block as
    the ranks hold it gathered first (`tp.gather`)."""
    if tp is not None:
        pb = tp.gather(pb, tp.block_sh)
    aux, kv = 0.0, []
    for s in range(_period(cfg)):
        kind = _sublayer_kind(cfg, s)
        if kind == "cross":
            h, _, _ = _attn_sublayer(h, pb[f"cross{s}"], cfg,
                                     positions=positions, memory=memory,
                                     tp=tp)
        else:
            window = cfg.sliding_window if kind == "attn_local" else None
            h, k, v = _attn_sublayer(h, pb[f"attn{s}"], cfg,
                                     positions=positions, window=window,
                                     tp=tp)
            kv.append((kind, k, v))
        if cfg.is_encdec:
            h, _, _ = _attn_sublayer(h, pb[f"dec_cross{s}"], cfg,
                                     positions=positions, memory=memory,
                                     tp=tp)
        h, aux_s = _ffn_sublayer(h, pb, cfg, s, par, tp)
        aux = aux + aux_s
    return h, aux, kv


def _remat(par) -> bool:
    """Whether superblocks run under `torch.utils.checkpoint`."""
    return bool(par.remat) and torch.is_grad_enabled()


def _maybe_remat(on: bool, fn, *args, **kw):
    if on:
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=cost.checkpoint_contexts, **kw)
    return fn(*args, **kw)


def hybrid_block(h, pb, cfg, *, positions, window):
    """One hymba layer over a whole sequence: attention (through K4, within
    `window` keys unless None) and the SSM head read one normalised input,
    their outputs averaged into the residual, then the MLP.  Returns (h,
    entry): the layer's rotated keys and values (B, S, Hkv, hd), the SSM's
    last state `ssm_h` (B, D, N) float32, and `x_tail`, the normalised
    input's last (up to) 4 rows, whose SSM input projection is the decode
    step's conv tail."""
    pa, ps = pb["attn0"], pb["ssm0"]
    x = rms_norm(h, pa["ln"], cfg.norm_eps)
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = apply_rope((x @ pa["wq"]).reshape(B, S, H, hd), positions,
                   cfg.rope_theta)
    k = apply_rope((x @ pa["wk"]).reshape(B, S, Hkv, hd), positions,
                   cfg.rope_theta)
    v = (x @ pa["wv"]).reshape(B, S, Hkv, hd)
    o_attn = attention_flash(q, k, v, causal=True, window=window)
    o_attn = o_attn.reshape(B, S, H * hd) @ pa["wo"]
    o_ssm, h_last = ssm_mod.ssm_head(x, ps, cfg)
    h = _mlp_sublayer(h + 0.5 * (o_attn + o_ssm), pb["mlp0"], cfg)
    return h, {"k": k, "v": v, "ssm_h": h_last, "x_tail": x[:, -4:]}


# ============================================================= forward ======
def embed(params, tokens, cfg):
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


def _enc_block(m, pb, cfg, positions, tp=None):
    if tp is not None:
        pb = tp.gather(pb, tp.sh["enc_blocks"][0])
    m, _, _ = _attn_sublayer(m, pb["attn0"], cfg, positions=positions,
                             causal=False, tp=tp)
    return _mlp_sublayer(m, pb["mlp0"], cfg, tp)


def encode(params, frames, cfg, tp=None, remat=False):
    """The encoder over frame embeddings (B, S, D) (with `tp`, each rank's
    copy (L, B, S, D)): bidirectional self-attention (through K4) and an
    MLP a layer (each under checkpoint with `remat`), then `enc_ln`."""
    m = frames.to(getattr(torch, cfg.dtype))
    positions = torch.arange(m.shape[-2], device=m.device)
    for pb in params["enc_blocks"]:
        m = _maybe_remat(remat, _enc_block, m, pb, cfg, positions, tp)
    if tp is not None:
        return tp.norm(m, params["enc_ln"], cfg.norm_eps)
    return rms_norm(m, params["enc_ln"], cfg.norm_eps)


def memory_of(params, cfg, frames=None, vis=None, tp=None, remat=False):
    """What the cross-attention sublayers read: the encoder's output over
    `frames` (encdec), the patch embeddings `vis` (vlm), else None; raises
    where the family needs one that was not given.  With `tp`, each rank's
    copy (L, B, Sm, D)."""
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"`frames`, the frame embeddings (B, S, D)")
        return encode(params, frames if tp is None else tp.enter(frames),
                      cfg, tp, remat)
    if cfg.family == "vlm":
        if vis is None:
            raise ValueError(f"{cfg.name}: a vlm needs `vis`, the patch "
                             f"embeddings (B, n_vis_tokens, D)")
        vis = vis.to(getattr(torch, cfg.dtype))
        return vis if tp is None else tp.enter(vis)
    return None


def _rank_layer(h, pb, cfg, tp, positions, i):
    """Superblock i of rwkv6's or hymba's rank program: its tree gathered
    (`tp.gather`), then `tp.rwkv_block` / `tp.hybrid_layer`."""
    pb = tp.gather(pb, tp.block_sh)
    if cfg.family == "ssm":
        return tp_mod.rwkv_block(h, pb["rwkv"], cfg, tp)[0]
    return tp_mod.hybrid_layer(h, pb, cfg, tp, positions=positions,
                               window=_window(cfg, i))[0]


def _forward_ranks(params, tokens, cfg, frames, vis, par, tp):
    """The rank program's forward: (final hidden states (L, B_l, S, D),
    aux (L,))."""
    if not tp.covered:
        return _whole_ranks(params, tokens, cfg, frames, vis, par, tp)
    remat = _remat(par)
    h = tp_mod.embed(params, tp.enter(tokens), cfg, tp)
    aux = torch.zeros(tp.L, dtype=torch.float32, device=h.device)
    positions = torch.arange(tokens.shape[1], device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        for i, pb in enumerate(params["blocks"]):
            h = _maybe_remat(remat, _rank_layer, h, pb, cfg, tp, positions,
                             i)
        return tp.norm(h, params["final_ln"], cfg.norm_eps), aux
    memory = memory_of(params, cfg, frames, vis, tp, remat)
    for pb in params["blocks"]:
        h, aux_b, _ = _maybe_remat(remat, superblock, h, pb, cfg,
                                   positions=positions, memory=memory,
                                   par=par, tp=tp)
        aux = aux + aux_b
    return tp.norm(h, params["final_ln"], cfg.norm_eps), aux


def _whole_block(h, pb, cfg, tp, positions, memory, i):
    """Superblock i of the whole-leaf rank program: its tree gathered,
    then each rank's rows through the single-rank block: (h, aux (L,))."""
    g = tp.gather(pb, tp.block_sh)
    hs, auxs = [], []
    for j in range(tp.L):
        pj = tp_mod.rank_tree(g, j)
        if cfg.family == "ssm":
            y, aux = rwkv_mod.rwkv_block(h[j], pj["rwkv"], cfg)[0], 0.0
        elif cfg.family == "hybrid":
            y, aux = hybrid_block(h[j], pj, cfg, positions=positions,
                                  window=_window(cfg, i))[0], 0.0
        else:
            y, aux, _ = superblock(h[j], pj, cfg, positions=positions,
                                   memory=None if memory is None
                                   else memory[j])
        hs.append(y)
        auxs.append(torch.as_tensor(aux, dtype=torch.float32,
                                    device=h.device))
    return torch.stack(hs), torch.stack(auxs)


def _whole_enc(m, pb, cfg, tp, positions):
    g = tp.gather(pb, tp.sh["enc_blocks"][0])
    return torch.stack([_enc_block(m[j], tp_mod.rank_tree(g, j), cfg,
                                   positions) for j in range(tp.L)])


def _whole_ranks(params, tokens, cfg, frames, vis, par, tp):
    """`_forward_ranks` where each rank runs the whole-leaf model on its
    data shard (`TP.covered` false: data ranks and no model axis)."""
    remat = _remat(par)
    h = tp_mod.embed(params, tp.enter(tokens), cfg, tp)
    positions = torch.arange(tokens.shape[1], device=h.device)
    memory = None
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"`frames`, the frame embeddings (B, S, D)")
        m = tp.enter(frames).to(getattr(torch, cfg.dtype))
        mpos = torch.arange(m.shape[-2], device=m.device)
        for pb in params["enc_blocks"]:
            m = _maybe_remat(remat, _whole_enc, m, pb, cfg, tp, mpos)
        memory = tp.norm(m, params["enc_ln"], cfg.norm_eps)
    elif cfg.family == "vlm":
        memory = memory_of(params, cfg, vis=vis, tp=tp)
    aux = torch.zeros(tp.L, dtype=torch.float32, device=h.device)
    for i, pb in enumerate(params["blocks"]):
        h, aux_b = _maybe_remat(remat, _whole_block, h, pb, cfg, tp,
                                positions, memory, i)
        aux = aux + aux_b
    return tp.norm(h, params["final_ln"], cfg.norm_eps), aux


def forward_with_aux(params, tokens, cfg, *, frames=None, vis=None,
                     par=NONE):
    """Full-sequence forward -> (final hidden states (B, S, D), the MoE aux
    loss summed over layers: a float32 0-d tensor, 0 without experts)."""
    check_supported(cfg)
    tp = tp_mod.plan(cfg, par, params)
    if tp is not None:
        with tp.scope():
            h, aux = _forward_ranks(params, tokens, cfg, frames, vis, par,
                                    tp)
            return tp.leave(h), tp.leave_mean(aux)
    remat = _remat(par)
    h = par.constrain(embed(params, tokens, cfg), par.dp, None, None)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    positions = torch.arange(tokens.shape[1], device=h.device)
    if cfg.family == "ssm":
        for pb in params["blocks"]:
            h, _ = _maybe_remat(remat, rwkv_mod.rwkv_block, h, pb["rwkv"],
                                cfg)
    elif cfg.family == "hybrid":
        for i, pb in enumerate(params["blocks"]):
            h, _ = _maybe_remat(remat, hybrid_block, h, pb, cfg,
                                positions=positions, window=_window(cfg, i))
    else:
        memory = memory_of(params, cfg, frames, vis, remat=remat)
        for pb in params["blocks"]:
            h, aux_b, _ = _maybe_remat(remat, superblock, h, pb, cfg,
                                       positions=positions, memory=memory,
                                       par=par)
            aux = aux + aux_b
    return rms_norm(h, params["final_ln"], cfg.norm_eps), aux


def forward(params, tokens, cfg, *, frames=None, vis=None, par=NONE):
    """Full-sequence forward -> final hidden states (B, S, D)."""
    return forward_with_aux(params, tokens, cfg, frames=frames, vis=vis,
                            par=par)[0]


def logits_fn(params, h, cfg, par=NONE):
    """Final hidden states (B, S, D) -> logits (B, S, padded vocab); under
    a model axis from the vocabulary blocks, all-gathered."""
    tp = tp_mod.plan(cfg, par, params)
    if tp is not None:
        with tp.scope():
            return tp.leave(tp_mod.logits(params, tp.enter(h), cfg, tp))
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def _xent_sum(hs, ls, w):
    """Sum over one chunk of logsumexp(logits) - the gold logit, the logits
    taken in h's type and then in float32, as the reference takes them."""
    logits = (hs @ w.to(hs.dtype)).float()
    gold = logits.gather(-1, ls[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_xent(params, h, labels, cfg, chunk: int = 512):
    """Mean softmax cross-entropy of h (B, S, D) against labels (B, S),
    over sequence chunks of min(chunk, S) (S a whole number of them, the
    reference's assertion): with grad on, each chunk's (B, chunk, V)
    logits are recomputed in backward (`torch.utils.checkpoint`), so the
    full logits never live at once."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_xent: {S} tokens are not a whole number "
                         f"of chunks of {chunk}")
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        args = (h[:, i:i + chunk], labels[:, i:i + chunk], w)
        total = total + (checkpoint(_xent_sum, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _xent_sum(*args))
    return total / (B * S)


def rank_losses(params, batch, cfg, par, tp):
    """The rank program's training loss: (ce + 0.01 aux, ce, aux), each
    (L,) per local rank (its data shard's mean)."""
    check_supported(cfg)
    with tp.scope():
        h, aux = _forward_ranks(params, batch["tokens"], cfg,
                                batch.get("frames"), batch.get("vis"), par,
                                tp)
        ce = tp_mod.chunked_xent(params, h, tp.enter(batch["labels"]), cfg,
                                 tp)
        return ce + 0.01 * aux, ce, aux


def loss_fn(params, batch, cfg, par=NONE):
    """The training loss of a weight tree on a batch (`tokens`, `labels`;
    `frames` / `vis` where the family needs them): (ce + 0.01 aux, {"ce":
    ce, "aux": aux}), aux the MoE load-balance and z-loss summed over
    layers (0 without experts); under a rank program the mean over the
    data shards."""
    tp = tp_mod.plan(cfg, par, params)
    if tp is not None:
        loss, ce, aux = rank_losses(params, batch, cfg, par, tp)
        with tp.scope():
            return tp.leave_mean(loss), {"ce": tp.leave_mean(ce),
                                         "aux": tp.leave_mean(aux)}
    h, aux = forward_with_aux(params, batch["tokens"], cfg,
                              frames=batch.get("frames"), vis=batch.get("vis"),
                              par=par)
    ce = chunked_xent(params, h, batch["labels"], cfg)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}
