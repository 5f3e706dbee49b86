"""The port's superblock layouts (repro_torch.models) against the JAX
reference (repro.models), on the CPU: gemma3's 5 local : 1 global
sliding-window superblocks with ring-buffer caches, and the plain dense
phi4-mini and smollm, on their smoke configs in float32 and bfloat16.

Weights and tolerances are tests/test_torch_lm.py's: the reference's init
with N(0, 0.2) noise on every leaf, handed over through
`convert.lm_params_from_numpy`; float32 1e-4 (a cache entry within one
bfloat16 step, a decode after each side's own prefill within 2e-3);
bfloat16 5e-2 of the largest reference value.  Compared: configs, the
conversion, forward logits, prefill logits and caches (the rings `k_loc` /
`v_loc` and `k_glob` / `v_glob` included), a decode step from the same
cache (20 tokens: gemma3-smoke's rings of 16 wrap in prefill), and a
prompt of 14 tokens decoded to 20 (they wrap during decode), S_max 32.  The helpers here also
serve tests/test_torch_lm_moe.py.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import active_param_count as jactive_param_count
from repro.configs import get_config as jget_config
from repro.configs import param_count as jparam_count
from repro.models.transformer import logits_fn as jlogits_fn
from repro_torch.configs import active_param_count, get_config, param_count
from repro_torch.models import moe as tmoe
from repro_torch.models.decode import CDT

from test_torch_lm import BF16_STEP, PAR, _np, perturbed_reference, port_of

ARCHS = ["gemma3-12b", "phi4-mini-3.8b", "smollm-360m"]
DTYPES = ["float32", "bfloat16"]
S_MAX = 32
S = 20                  # > gemma3-smoke's window: the rings wrap in prefill
# prefill PROMPT tokens, then decode to S: the rings wrap during decode
PROMPT = 14
# a decoded cache row (hd values) against the reference's prefill of the
# whole sequence: the paths differ (decode attends over bfloat16 caches),
# which moved rows by up to 3.5e-2 (float32) / 1.8e-1 (bfloat16) in
# relative L2 here; a row from a wrong or stale position is uncorrelated
# with the right one (about sqrt(2))
DECODED_ROW_REL = {"float32": 0.1, "bfloat16": 0.5}
# MoE routing near tie: a token whose k-th and (k+1)-th router logits lie
# within TIE of each other (at some MoE sublayer) may pick another expert
# on the other side, which rounds the router's input elsewhere; its rows
# are left out of the comparisons.  bfloat16 flipped a choice at a margin
# of 3.8e-2 here (float32 at none); MAX_TIES bounds the share left out.
TIE = {"float32": 1e-3, "bfloat16": 0.1}
MAX_TIES = 0.25


class Pair:
    """The reference and the port on the same weights, with the
    reference's prefill of the S tokens and its decode step, jitted (one
    compilation for every step)."""

    def __init__(self, arch, dtype):
        self.arch, self.dtype = arch, dtype
        self.cfg, self.jmodel, self.params = perturbed_reference(arch, dtype)
        self.tmodel = port_of(arch, dtype, self.params)
        self.tokens = np.random.default_rng(0).integers(1, self.cfg.vocab,
                                                        (2, S))
        jm, params = self.jmodel, self.params
        self.cache_r, self.lg_r = jm.prefill(
            params, {"tokens": jnp.asarray(self.tokens, jnp.int32)}, PAR,
            S_max=S_MAX)
        self.step = jax.jit(lambda c, t, p: jm.decode_step(params, c, t, p,
                                                           PAR))


def ref_entries(cache_r):
    """The reference's cache as {name: (n_superblocks, ...)} numpy, in the
    port's per-superblock shapes (a dense or moe entry drops the reference's
    axis of one self-attention sublayer)."""
    out = {}
    for key, a in cache_r["blocks"].items():
        a = _np(a)
        out[key] = a[:, 0] if key in ("k", "v") else a
    return out


def port_cache_from_ref(cache_r):
    """The reference's cache in the port's layout, bfloat16."""
    ent = ref_entries(cache_r)
    n = next(iter(ent.values())).shape[0]
    return {"blocks": [{k: torch.as_tensor(v[i]).to(CDT)
                        for k, v in ent.items()} for i in range(n)]}


def ref_cache_from_port(cache_t):
    """The port's cache in the reference's layout, bfloat16: the layout its
    `init_cache` makes, which its decode step writes into."""
    return {"blocks": {
        k: jnp.asarray(np.stack([_np(c[k])[None] if k in ("k", "v")
                                 else _np(c[k]) for c in cache_t["blocks"]]),
                       jnp.bfloat16)
        for k in cache_t["blocks"][0]}}


def check_configs(arch, smoke):
    cfg, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert asdict(cfg) == asdict(ref)
    assert param_count(cfg) == jparam_count(ref)
    assert active_param_count(cfg) == jactive_param_count(ref)


def check_convert(pr):
    tree = pr.tmodel.params
    assert len(tree["blocks"]) == pr.cfg.n_layers // (pr.cfg.swa_period or 1)
    for key, sub in tree["blocks"][-1].items():
        for leaf, t in sub.items():
            want = pr.params["blocks"][key][leaf][-1]
            assert t.dtype == (torch.float32 if want.dtype == jnp.float32
                               else torch.bfloat16), (key, leaf)
            np.testing.assert_array_equal(_np(t), _np(want))


def logged(pr, shape, fn):
    """fn() under the port's routing log -> (its result, a bool array of
    `shape` (B, S): the tokens some MoE sublayer routed at a near tie,
    router-logit margin at most TIE[dtype]).  All False without experts.
    The smoke configs' capacity factor of 4.0 drops nothing: checked."""
    with tmoe.routing_log() as log:
        out = fn()
    ties = np.zeros(shape, bool)
    for _, keep, margin in log:
        assert bool(keep.all())
        ties |= _np(margin).reshape(shape) <= TIE[pr.dtype]
    return out, ties


def few(pr, ties):
    assert ties.mean() <= MAX_TIES, (pr.arch, pr.dtype, int(ties.sum()))
    return ~ties


def close_rows(got, want, dtype, what, ok):
    """`close` on the rows `ok` selects (a bool mask over the leading
    axes), the bfloat16 scale taken over the whole of `want`."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ok = np.broadcast_to(ok.reshape(ok.shape + (1,) * (got.ndim - ok.ndim)),
                         got.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                   atol=5e-2 * np.abs(want).max(),
                                   err_msg=what)


def check_forward(pr):
    """Forward logits, less the rows of near-tie tokens; returns the two
    aux losses (port, reference)."""
    h, aux_r = pr.jmodel.forward(pr.params, {"tokens": jnp.asarray(
        pr.tokens, jnp.int32)}, PAR)
    (h_t, aux_t), ties = logged(pr, pr.tokens.shape, lambda: (
        pr.tmodel.forward_with_aux(torch.as_tensor(pr.tokens))))
    close_rows(pr.tmodel.logits(h_t), jlogits_fn(pr.params, h, pr.cfg, PAR),
               pr.dtype, f"{pr.arch} {pr.dtype} forward logits", few(pr, ties))
    return aux_t, aux_r


def _pos_mask(ties, key):
    """Rows of cache entry `key` (n_superblocks, B, S_max, ...) to compare:
    a full cache's positions less the near-tie tokens; every ring slot."""
    if key not in ("k", "v"):
        assert not ties.any()
        return np.ones((1,), bool)
    ok = np.ones((ties.shape[0], S_MAX), bool)
    ok[:, :ties.shape[1]] = ~ties
    return ok[None]


def check_cache(cache_t, cache_r, dtype, what, ties):
    """The port's cache against the reference's, entry by entry, less the
    positions of near-tie tokens: float32 within one bfloat16 step (the
    reference keeps a float32 model's prefill caches in float32),
    bfloat16 at `close`'s tolerance."""
    ref = ref_entries(cache_r)
    assert set(ref) == set(cache_t["blocks"][0])
    for key, want in ref.items():
        got = np.stack([_np(c[key]) for c in cache_t["blocks"]])
        assert cache_t["blocks"][0][key].dtype == CDT, key
        ok = _pos_mask(ties, key)
        if dtype == "float32":
            want = _np(torch.as_tensor(want).to(CDT))
            ok = np.broadcast_to(ok.reshape(ok.shape + (1,) * (
                got.ndim - ok.ndim)), got.shape)
            err = np.abs(got - want)[ok]
            assert np.all(err <= BF16_STEP * np.abs(want)[ok]), \
                (what, key, float(err.max()))
        else:
            close_rows(got, want, dtype, f"{what}: cache {key}", ok)
    return ref


def check_prefill(pr):
    (cache_t, lg_t), ties = logged(pr, pr.tokens.shape, lambda: (
        pr.tmodel.prefill(torch.as_tensor(pr.tokens), S_MAX)))
    what = f"{pr.arch} {pr.dtype} prefill"
    close_rows(lg_t, pr.lg_r, pr.dtype, what + " logits",
               few(pr, ties)[:, -1:])
    return check_cache(cache_t, pr.cache_r, pr.dtype, what, ties)


def check_decode_same_cache(pr):
    cache_r = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pr.cache_r)
    nxt = pr.tokens[:, -1:]
    lg_r, _ = pr.step(cache_r, jnp.asarray(nxt, jnp.int32), jnp.int32(S))
    (lg_t, _), ties = logged(pr, nxt.shape, lambda: pr.tmodel.decode_step(
        port_cache_from_ref(cache_r), torch.as_tensor(nxt), S))
    close_rows(lg_t, lg_r, pr.dtype, f"{pr.arch} {pr.dtype} decode logits, "
               f"same cache", ~ties)


def check_prefill_then_decode(pr):
    """The port prefills PROMPT tokens and decodes the rest of the S.
    Each step's logits against the reference's decode step from the same
    cache (the port's, handed over); then each row of the port's cache
    against the reference's prefill of all S tokens, whose rings its
    `_ring_fill` lays out (DECODED_ROW_REL), and the rows not written yet
    exactly 0.  Rows of near-tie tokens are left out: those the port's
    prefill, decode steps or prefill of all S tokens routed at a near tie.
    The reference's own decode cannot be chained past one step on a 5 : 1
    superblock: it writes each local sublayer's ring into the stack it was
    given, so only the last local sublayer's write survives the step
    (ROADMAP.md, faults of the reference)."""
    arch, dtype, cfg = pr.arch, pr.dtype, pr.cfg
    (cache_t, _), ties_p = logged(pr, (2, PROMPT), lambda: pr.tmodel.prefill(
        torch.as_tensor(pr.tokens[:, :PROMPT]), S_MAX))
    _, ties = logged(pr, pr.tokens.shape, lambda: pr.tmodel.prefill(
        torch.as_tensor(pr.tokens), S_MAX))
    ties[:, :PROMPT] |= ties_p
    for pos in range(PROMPT, S):
        nxt = pr.tokens[:, pos:pos + 1]
        lg_r, _ = pr.step(ref_cache_from_port(cache_t),
                          jnp.asarray(nxt, jnp.int32), jnp.int32(pos))
        (lg_t, cache_t), tie = logged(pr, nxt.shape, lambda: (
            pr.tmodel.decode_step(cache_t, torch.as_tensor(nxt), pos)))
        ties[:, pos:pos + 1] |= tie
        what = f"{arch} {dtype} prefill {PROMPT} + decode at {pos}"
        if dtype == "float32":
            # each side writes its own k / v of this step into the cache:
            # one may round to the bfloat16 neighbour of the other's
            np.testing.assert_allclose(_np(lg_t)[~tie[:, 0]],
                                       _np(lg_r)[~tie[:, 0]], rtol=0,
                                       atol=2e-3, err_msg=what)
        else:
            close_rows(lg_t, lg_r, dtype, what, ~tie)
    few(pr, ties)
    for key, want in ref_entries(pr.cache_r).items():
        got = np.stack([_np(c[key]) for c in cache_t["blocks"]])
        norm = np.linalg.norm(want, axis=-1)
        ok = _pos_mask(ties, key)
        ok = np.broadcast_to(ok.reshape(ok.shape + (1,) * (
            norm.ndim - ok.ndim)), norm.shape) & (norm > 0)
        rel = np.linalg.norm(got - want, axis=-1)[ok] / norm[ok]
        assert float(rel.max()) <= DECODED_ROW_REL[dtype], (arch, dtype, key)
        assert not got[norm == 0].any(), (arch, dtype, key)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return Pair(*request.param)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    check_configs(arch, smoke)


def test_convert_unstacks_superblocks(pair):
    check_convert(pair)


def test_forward_logits_match(pair):
    check_forward(pair)


def test_prefill_logits_and_caches_match(pair):
    ref = check_prefill(pair)
    cfg = pair.cfg
    if cfg.swa_period:
        assert set(ref) == {"k_loc", "v_loc", "k_glob", "v_glob"}
        assert ref["k_loc"].shape[1:4] == (cfg.swa_period - 1, 2,
                                           cfg.sliding_window)


def test_decode_step_matches_from_the_same_cache(pair):
    check_decode_same_cache(pair)


def test_prefill_then_decode_past_the_window(pair):
    if pair.cfg.swa_period:
        assert PROMPT < pair.cfg.sliding_window < S
    check_prefill_then_decode(pair)
