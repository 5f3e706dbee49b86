"""The port's mixture-of-experts layers (repro_torch.models.moe and the moe
superblock) against the JAX reference (repro.models.moe, repro.models), on
the CPU: dbrx (16 experts, top 4) and llama4-scout (16 experts, top 1),
on their smoke configs in float32 and bfloat16.

The model comparisons are tests/test_torch_lm_swa.py's, at
tests/test_torch_lm.py's tolerances, plus the aux loss of the forward
against the reference's second output (float32 1e-4 relative; bfloat16
5e-2: the router reads the bfloat16 hidden state, which the two round at
different places).  Routing on the same inputs: `_route`'s expert choices
equal the reference's except where the k-th and (k+1)-th router
probabilities lie within TIE of each other, where float32 sums taken in
another order may order them the other way (the exempted tokens are
counted and must be few); gates, capacity positions, `keep` and the aux
loss at float32 1e-5.  The drop path, which the smoke configs never take
(capacity factor 4.0), with a variant of capacity factor 0.5: `keep`
exactly the reference's, the layer's output at 1e-5.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

from test_torch_lm import _np
from test_torch_lm_swa import (DTYPES, Pair, check_configs, check_convert,
                               check_decode_same_cache, check_forward,
                               check_prefill, check_prefill_then_decode)

ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e"]
TIE = 1e-5              # routing near tie: top-k probability gap
T_ROUTE = 512           # tokens routed in the routing tests


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return Pair(*request.param)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    check_configs(arch, smoke)


def test_convert_keeps_experts_and_the_float32_router(pair):
    check_convert(pair)
    moe = pair.tmodel.params["blocks"][0]["moe0"]
    cfg = pair.cfg
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert moe["w_down"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)


def test_forward_logits_and_aux_match(pair):
    aux_t, aux_r = check_forward(pair)
    rtol = 1e-4 if pair.dtype == "float32" else 5e-2
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=rtol)
    assert float(aux_t) > 0


def test_prefill_logits_and_caches_match(pair):
    assert set(check_prefill(pair)) == {"k", "v"}


def test_decode_step_matches_from_the_same_cache(pair):
    check_decode_same_cache(pair)


def test_prefill_then_decode_matches(pair):
    check_prefill_then_decode(pair)


# --------------------------------------------------------------- routing ---
def _route_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T_ROUTE, cfg.d_model)).astype(np.float32)
    w = (rng.normal(size=(cfg.d_model, cfg.n_experts))
         / np.sqrt(cfg.d_model)).astype(np.float32)
    return x, w


def _near_ties(x, w, top_k):
    """Tokens whose k-th and (k+1)-th router probabilities (float64) lie
    within TIE."""
    lg = x.astype(np.float64) @ w.astype(np.float64)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p = -np.sort(-p / p.sum(-1, keepdims=True), axis=-1)
    return p[:, top_k - 1] - p[:, top_k] <= TIE


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_route_matches_reference(arch, seed):
    cfg = get_config(arch, smoke=True)
    x, w = _route_inputs(cfg, seed)
    C = tmoe._capacity(T_ROUTE, cfg)
    got = tmoe._route(torch.as_tensor(x), torch.as_tensor(w), cfg.n_experts,
                      cfg.top_k, C)
    want = jmoe._route(jnp.asarray(x), jnp.asarray(w), cfg.n_experts,
                       cfg.top_k, C)
    tie = _near_ties(x, w, cfg.top_k)
    assert int(tie.sum()) <= 2, int(tie.sum())
    g_t, e_t, pos_t, keep_t, aux_t = (_np(a) for a in got)
    g_r, e_r, pos_r, keep_r, aux_r = (_np(a) for a in want)
    ok = ~tie
    np.testing.assert_array_equal(e_t[ok], e_r[ok])
    np.testing.assert_allclose(g_t[ok], g_r[ok], rtol=1e-5, atol=1e-6)
    if not tie.any():       # capacity positions follow every earlier choice
        np.testing.assert_array_equal(pos_t, pos_r)
        np.testing.assert_array_equal(keep_t, keep_r)
    np.testing.assert_allclose(aux_t, aux_r, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_slots_match_reference(arch):
    """A capacity factor of 0.5 (test only) makes experts overflow: the
    slots kept, the trash row for the dropped ones and the layer's output
    equal the reference's."""
    cfg = replace(get_config(arch, smoke=True), capacity_factor=0.5)
    jcfg = replace(jget_config(arch, smoke=True), capacity_factor=0.5)
    rng = np.random.default_rng(7)
    x, w = _route_inputs(cfg, 7)
    assert not _near_ties(x, w, cfg.top_k).any()
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": w,
         "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x3 = x.reshape(4, T_ROUTE // 4, d)
    with tmoe.routing_log() as log:
        y_t, aux_t = tmoe.moe_ffn(torch.as_tensor(x3),
                                  {k: torch.as_tensor(v) for k, v in p.items()},
                                  cfg)
    y_r, aux_r = jmoe._moe_dense(jnp.asarray(x3),
                                 {k: jnp.asarray(v) for k, v in p.items()},
                                 jcfg)
    (eidx, keep, _), = log
    C = tmoe._capacity(T_ROUTE, cfg)
    _, e_r, _, keep_r, _ = jmoe._route(jnp.asarray(x), jnp.asarray(w), e,
                                       cfg.top_k, C)
    np.testing.assert_array_equal(_np(eidx), _np(e_r))
    np.testing.assert_array_equal(_np(keep), _np(keep_r))
    assert 0 < int((~keep).sum()) < keep.numel()
    np.testing.assert_allclose(_np(y_t), _np(y_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-5)
