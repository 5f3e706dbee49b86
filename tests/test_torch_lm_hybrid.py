"""The port's hybrid family (hymba: attention and SSM heads in parallel,
repro_torch.models.ssm and the hybrid branches of models.transformer /
models.decode) against the JAX reference, on the CPU.

Weights: the reference's init, the SSM's `conv_w`, `A_log` and `D_skip`
drawn from N(0, 0.3) (the init zeroes the conv and sets A = -1, which would
hide the conv tail and the decay); in float32 N(0, 0.2) noise on every
other leaf, as tests/test_torch_lm.py adds; in bfloat16 on the per-layer
vectors only, the matrices kept at their init.  With noise on the matrices
the smoke model's bfloat16 logits sit 19% of their largest value from its
own float32 ones (the reference's, measured), so a bfloat16 comparison
there holds nothing but rounding; with the init matrices that gap is 6.1%,
and the port lies within 3.7% of the reference.

Tolerances (tests/test_torch_lm.py's): float32 1e-4 on logits and float32
state (a chained step's `ssm_h` at 1e-4 of its largest value), a bfloat16
cache entry within one bfloat16 step, a decode step chained on the port's
own cache within 2e-3 (each side writes its own k / v into the bfloat16
cache); bfloat16 5e-2 of the largest reference value, a chained bfloat16
decode step `CHAINED_BF16` (its reason beside it).  The SSM alone: float32 at rtol/atol 1e-5 (the doubling scan
multiplies in another order than `lax.associative_scan`), bfloat16 at 2e-2
of the largest value (one rounding of `b`, `xi` or the output apart).

Every decode step is held to the reference's `decode_step` from the same
cache (the port's, handed over), not to a forward: the reference's own
bfloat16 decode rounds the SSM state to bfloat16 before C . h where its
forward's scan stays in float32, which moves a step 0.9% to 8.2% of the
largest logit away from the forward on this config (tools/hymba_drift.py,
seeds 0-2; ROADMAP.md §3).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro.models.transformer import logits_fn as jlogits_fn
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.models.decode import CDT
from repro_torch.serve.engine import Request, ServeEngine

from test_torch_lm import BF16_STEP, PAR, _np, close
from test_torch_lm_swa import S_MAX, Pair, check_configs

ARCH = "hymba-1.5b"
DTYPES = ["float32", "bfloat16"]
SSM_SCALE = 0.3
SSM_LEAVES = ("conv_w", "A_log", "D_skip")
PROMPT, STEPS = 6, 20       # prefill 6 tokens, decode to 26: past the window
# a bfloat16 decode step chained on the port's cache against the reference's
# step from that cache, as a share of the largest logit: the reference's own
# bfloat16 step lies up to 5.4e-2 from its float32 step on the same cache
# here, and up to 6.1e-2 from its forward (ROADMAP.md §3), and two bfloat16
# implementations may lie on either side of the exact value: 2 x 6.1e-2
# (the port measured 8.7e-2 at the worst of these 20 steps)
CHAINED_BF16 = 0.122


def ssm_perturbed(params, seed=2):
    """`params` with the SSM's conv taps, A_log and D skip drawn from
    N(0, SSM_SCALE), in each leaf's type."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key not in SSM_LEAVES:
            return a
        return jnp.asarray(rng.normal(0, SSM_SCALE, a.shape).astype(
            np.float32)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module", params=DTYPES)
def pair(request):
    dtype = request.param
    return Pair(ARCH, dtype, vectors_only=dtype == "bfloat16",
                perturb=ssm_perturbed)


def ref_cache_from_port(cache_t):
    """The port's hymba cache in the reference's layout: every entry
    stacked over the layers, in its own type (ssm_h float32)."""
    return {"blocks": {
        k: jnp.asarray(np.stack([_np(c[k]) for c in cache_t["blocks"]]),
                       jnp.float32 if k == "ssm_h" else jnp.bfloat16)
        for k in cache_t["blocks"][0]}}


def port_cache_from_ref(cache_r):
    ent = {k: _np(a) for k, a in cache_r["blocks"].items()}
    n = ent["k"].shape[0]
    return {"blocks": [{k: torch.as_tensor(v[i]).to(
        torch.float32 if k == "ssm_h" else CDT) for k, v in ent.items()}
        for i in range(n)]}


# ------------------------------------------------------------- the SSM ----
def _ssm_inputs(dtype, S, seed=0):
    cfg = replace(get_config(ARCH, smoke=True), dtype=dtype)
    rng = np.random.default_rng(seed)
    D, N = cfg.d_model, cfg.ssm_state
    shapes = {"in_proj": (D, D), "dt_proj": (D, 1), "B_proj": (D, N),
              "C_proj": (D, N), "A_log": (D, N), "D_skip": (D,),
              "conv_w": (4, D), "out_proj": (D, D)}
    p = {k: (rng.normal(size=s) * (SSM_SCALE if k in SSM_LEAVES
                                   else s[0] ** -0.5)).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.normal(size=(2, S, D)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jp = {k: jnp.asarray(v).astype(jd) for k, v in p.items()}
    tp = {k: torch.as_tensor(_np(v)).to(getattr(torch, dtype))
          for k, v in jp.items()}
    jx = jnp.asarray(x).astype(jd)
    return cfg, replace(jget_config(ARCH, smoke=True), dtype=dtype), jp, tp, \
        jx, torch.as_tensor(_np(jx)).to(getattr(torch, dtype))


def _ssm_close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("S,chunk", [(16, 256), (32, 8), (48, 16), (5, 256)])
def test_selective_scan_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 8, 4)).astype(np.float32)
    b = rng.normal(size=(2, S, 8, 4)).astype(np.float32)
    C = rng.normal(size=(2, S, 4)).astype(np.float32)
    y_r, h_r = jssm.selective_scan(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(C), chunk=chunk)
    y_t, h_t = tssm.selective_scan(torch.as_tensor(a), torch.as_tensor(b),
                                   torch.as_tensor(C), chunk=chunk)
    _ssm_close(y_t, y_r, "float32", f"y S {S} chunk {chunk}")
    _ssm_close(h_t, h_r, "float32", f"h_last S {S} chunk {chunk}")


def test_selective_scan_keeps_the_whole_chunk_contract():
    a = torch.ones(1, 24, 2, 2)
    with pytest.raises(ValueError, match="whole number of chunks"):
        tssm.selective_scan(a, a, torch.ones(1, 24, 2), chunk=16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_head_matches_reference(dtype):
    cfg, jcfg, jp, tp, jx, tx = _ssm_inputs(dtype, 32)
    y_r, h_r = jssm.ssm_head(jx, jp, jcfg)
    y_t, h_t = tssm.ssm_head(tx, tp, cfg)
    assert y_t.dtype == tx.dtype and h_t.dtype == torch.float32
    _ssm_close(y_t, y_r, dtype, f"ssm_head y {dtype}")
    _ssm_close(h_t, h_r, dtype, f"ssm_head h_last {dtype}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_head_stepped_from_a_state_matches_reference(dtype):
    cfg, jcfg, jp, tp, jx, tx = _ssm_inputs(dtype, 3, seed=1)
    h0 = np.random.default_rng(3).normal(size=(2, cfg.d_model,
                                               cfg.ssm_state))
    h0 = h0.astype(np.float32)
    y_r, h_r = jssm.ssm_head(jx, jp, jcfg, h0=jnp.asarray(h0))
    # the served step (`ssm_step`, which the decode calls), token by token
    # from h0 and a zero conv tail (the reference's zero-padded conv), the
    # tail in the model's type so that float32 rounds nothing
    conv, h_t, ys = torch.zeros(2, 4, cfg.d_model, dtype=tx.dtype), \
        torch.as_tensor(h0), []
    for t in range(tx.shape[1]):
        y, conv, h_t = tssm.ssm_step(tx[:, t:t + 1], tp, conv, h_t)
        ys.append(y)
    y_t = torch.cat(ys, dim=1)
    assert h_t.dtype == torch.float32
    _ssm_close(y_t, y_r, dtype, f"ssm_head from h0 y {dtype}")
    _ssm_close(h_t, h_r, dtype, f"ssm_head from h0 h_last {dtype}")


# ------------------------------------------------------- the hymba model ----
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(smoke):
    check_configs(ARCH, smoke)


def test_convert_and_forward_logits_match(pair):
    cfg = pair.cfg
    tree = pair.tmodel.params
    assert len(tree["blocks"]) == cfg.n_layers
    assert set(tree["blocks"][0]) == {"attn0", "ssm0", "mlp0"}
    for leaf in SSM_LEAVES:
        np.testing.assert_array_equal(
            _np(tree["blocks"][-1]["ssm0"][leaf]),
            _np(pair.params["blocks"]["ssm0"][leaf][-1]))
    h, _ = pair.jmodel.forward(pair.params, pair.batch(pair.tokens), PAR)
    close(pair.tmodel.logits(pair.tmodel(torch.as_tensor(pair.tokens))),
          jlogits_fn(pair.params, h, cfg, PAR), pair.dtype,
          f"hymba {pair.dtype} forward logits")


def test_prefill_logits_and_caches_match(pair):
    cache_t, lg_t = pair.tmodel.prefill(torch.as_tensor(pair.tokens), S_MAX)
    what = f"hymba {pair.dtype} prefill"
    close(lg_t, pair.lg_r, pair.dtype, what + " logits")
    ref = {k: _np(a) for k, a in pair.cache_r["blocks"].items()}
    assert set(ref) == set(cache_t["blocks"][0]) == {"k", "v", "ssm_h",
                                                      "conv"}
    for key, want in ref.items():
        got = np.stack([_np(c[key]) for c in cache_t["blocks"]])
        stored = cache_t["blocks"][0][key].dtype
        assert stored == (torch.float32 if key == "ssm_h" else CDT), key
        if pair.dtype == "float32" and stored == CDT:
            # the reference keeps a float32 model's k / v in float32
            want = _np(torch.as_tensor(want).to(CDT))
            err = np.abs(got - want)
            assert np.all(err <= BF16_STEP * np.abs(want)), \
                (key, float(err.max()))
        else:
            close(got, want, pair.dtype, f"{what} cache {key}")


def test_decode_step_matches_from_the_same_cache(pair):
    cache_r = jax.tree.map(lambda a: a if a.dtype == jnp.float32 and
                           a.ndim == 4 else a.astype(jnp.bfloat16),
                           pair.cache_r)
    nxt = pair.tokens[:, -1:]
    lg_r, _ = pair.step(cache_r, jnp.asarray(nxt, jnp.int32),
                        jnp.int32(pair.tokens.shape[1]))
    lg_t, _ = pair.tmodel.decode_step(port_cache_from_ref(cache_r),
                                      torch.as_tensor(nxt),
                                      pair.tokens.shape[1])
    close(lg_t, lg_r, pair.dtype, f"hymba {pair.dtype} decode, same cache")


def test_chained_decode_past_the_window(pair):
    """The port prefills PROMPT tokens and decodes STEPS more, past the
    window of 16 (so the local layers mask keys the global one reads);
    each step against the reference's decode step from the port's cache,
    and the cache it leaves against the one the reference's step leaves."""
    cfg, dtype = pair.cfg, pair.dtype
    assert PROMPT < cfg.sliding_window < PROMPT + STEPS <= S_MAX
    toks = np.random.default_rng(5).integers(1, cfg.vocab,
                                             (2, PROMPT + STEPS))
    cache_t, _ = pair.tmodel.prefill(torch.as_tensor(toks[:, :PROMPT]),
                                     S_MAX)
    for pos in range(PROMPT, PROMPT + STEPS):
        nxt = toks[:, pos:pos + 1]
        lg_r, cache_r = pair.step(ref_cache_from_port(cache_t),
                                  jnp.asarray(nxt, jnp.int32),
                                  jnp.int32(pos))
        lg_t, cache_t = pair.tmodel.decode_step(cache_t, torch.as_tensor(nxt),
                                                pos)
        what = f"hymba {dtype} decode at {pos}"
        if dtype == "float32":
            np.testing.assert_allclose(_np(lg_t), _np(lg_r), rtol=0,
                                       atol=2e-3, err_msg=what)
        else:
            np.testing.assert_allclose(
                _np(lg_t), _np(lg_r), rtol=0,
                atol=CHAINED_BF16 * np.abs(_np(lg_r)).max(), err_msg=what)
        for key in ("ssm_h", "conv"):
            got = np.stack([_np(c[key]) for c in cache_t["blocks"]])
            want = _np(cache_r["blocks"][key])
            if dtype == "bfloat16":
                close(got, want, dtype, f"{what}: {key}")
            elif key == "conv":     # a bfloat16 entry: one step apart
                err = np.abs(got - want)
                assert np.all(err <= BF16_STEP * np.abs(want)), (what, key)
            else:                   # float32 sums in another order
                np.testing.assert_allclose(
                    got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                    err_msg=f"{what}: {key}")
    k = cache_t["blocks"][0]["k"]
    assert k[:, :PROMPT + STEPS].abs().sum(-1).min() > 0
    assert not k[:, PROMPT + STEPS:].abs().sum()


def test_serve_engine_graph_matches_eager_on_cpu():
    """`ServeEngine(graph=True)` runs the decode step over static buffers
    (`ssm_h` and `conv` among them) eagerly on the CPU: the same tokens as
    `graph=False`, past the window."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, seed=0, device="cpu")
    outs = []
    for graph in (False, True):
        rng = np.random.default_rng(0)
        eng = ServeEngine(model, B=2, S_max=S_MAX, graph=graph)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
                1, cfg.vocab, int(rng.integers(4, 8)))], max_new=14))
        outs.append({r.rid: r.out for r in eng.run(max_steps=S_MAX)})
    assert sorted(outs[0]) == [0, 1, 2]
    assert all(len(o) == 14 for o in outs[0].values())
    assert outs[0] == outs[1]
    assert set(eng._static["cache"]["blocks"][0]) == {"k", "v", "ssm_h",
                                                      "conv"}

