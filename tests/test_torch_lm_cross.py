"""Cross-attention and the encoder on the CPU, against the JAX reference:
K4's plain versions over keys of their own length, and the encoder-decoder
seamless-m4t-medium and the vlm llama-3.2-vision-90b on their smoke
configs (repro_torch.models.transformer / models.decode), with their frame
and patch embeddings drawn from a seed at scale 0.1, as the reference's
tests draw them.

Weights as in tests/test_torch_lm_hybrid.py: the reference's init with
N(0, 0.2) noise on every leaf in float32, on the per-layer vectors only in
bfloat16 (with noise on the matrices the smoke models' bfloat16 logits sit
10.6% (seamless) and 6.5% (vlm) of their largest value from their own
float32 ones, the reference's, measured: nothing but rounding to compare).

Tolerances are tests/test_torch_lm.py's: float32 1e-4 (a cache entry
within one bfloat16 step, a decode step chained on the port's own cache
within 2e-3); bfloat16 5e-2 of the largest reference value.  K4's plain
versions: float32 2e-4 against the reference's `attention_full`, bfloat16
5e-2 (the reference's own bfloat16 tolerance for its attention kernel,
tests/test_kernels.py), `attention_tiled_ref` against
`attention_rounded_ref` at 1e-5 / K4's bfloat16 limits.

The reference's prefill runs its forward for the logits, over the memory
in the model's type, and then a second pass for the caches, over the
memory as stored (bfloat16); the port's one pass reads the memory in the
model's type, so a float32 cache entry of a layer after the first cross
sublayer lies within one bfloat16 step of the reference's only up to that
rounding: it is held to `MEMORY_ROUNDED` (relative L2 per row).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models.transformer import logits_fn as jlogits_fn
from repro_torch.configs import get_config
from repro_torch.kernels import attention as kattn
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.decode import CDT
from repro_torch.serve.engine import ServeEngine

from test_torch_lm import BF16_STEP, PAR, _np, close
from test_torch_lm_swa import S, S_MAX, Pair, check_configs

ARCHS = ["seamless-m4t-medium", "llama-3.2-vision-90b"]
DTYPES = ["float32", "bfloat16"]
EMBED_SCALE = 0.1
PROMPT = 12             # prefill 12 tokens, then decode to S_MAX - 1
# a float32 cache row after a cross sublayer: the reference's second pass
# reads the memory rounded to bfloat16 (module docstring); measured 1.0e-2
# (seamless) and 2.5e-3 (vlm) per row in relative L2
MEMORY_ROUNDED = 2e-2


def embeddings(cfg, seed=3):
    """The reference's batch keys beside the tokens: frames (2, S, D) for
    an encoder-decoder, vis (2, n_vis_tokens, D) for a vlm."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        shape, key = (2, S, cfg.d_model), "frames"
    else:
        shape, key = (2, cfg.n_vis_tokens, cfg.d_model), "vis"
    return {key: (rng.normal(size=shape) * EMBED_SCALE).astype(np.float32)}


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    return Pair(arch, dtype, vectors_only=dtype == "bfloat16",
                inputs=embeddings)


def ref_entries(pr, cache_r):
    """The reference's self caches as {name: (n_superblocks, ...)} in the
    port's per-superblock shapes: an encdec entry drops the axis of its one
    self sublayer, a vlm one keeps its n_self stacked sublayers."""
    out = {}
    for key, a in cache_r["blocks"].items():
        a = _np(a)
        out[key] = a[:, 0] if pr.cfg.is_encdec else a
    return out


def port_cache_from_ref(pr, cache_r):
    ent = ref_entries(pr, cache_r)
    n = ent["k"].shape[0]
    out = {"blocks": [{k: torch.as_tensor(v[i]).to(CDT)
                       for k, v in ent.items()} for i in range(n)],
           "memory": torch.as_tensor(_np(cache_r["memory"])).to(CDT)}
    if pr.cfg.is_encdec:
        out["memory_len"] = torch.tensor(int(cache_r["memory_len"]))
    return out


def ref_cache_from_port(pr, cache_t):
    blocks = {k: np.stack([_np(c[k]) for c in cache_t["blocks"]])
              for k in cache_t["blocks"][0]}
    if pr.cfg.is_encdec:
        blocks = {k: a[:, None] for k, a in blocks.items()}
    out = {"blocks": {k: jnp.asarray(a, jnp.bfloat16)
                      for k, a in blocks.items()},
           "memory": jnp.asarray(_np(cache_t["memory"]), jnp.bfloat16)}
    if pr.cfg.is_encdec:
        out["memory_len"] = jnp.asarray(int(cache_t["memory_len"]),
                                        jnp.int32)
    return out


# -------------------------------------------------- K4 over a memory ----
_CROSS = [(2, 4, 2, 5, 13, 16), (1, 4, 4, 20, 8, 32), (1, 8, 2, 130, 300, 64)]


def _cross_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed=0):
    rng = np.random.default_rng(seed + Sq + Sk)
    jd = jnp.dtype(dtype)
    out = []
    for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)):
        a = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jd)
        out.append((a, torch.as_tensor(_np(a)).to(getattr(torch, dtype))))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", _CROSS)
def test_k4_plain_versions_over_a_memory_match_reference(B, H, Hkv, Sq, Sk,
                                                         D, dtype):
    """K4's three plain versions with Sk != Sq, unmasked, against the
    reference's `attention_full(causal=False)` in the model layout."""
    (qj, qt), (kj, kt), (vj, vt) = _cross_inputs(B, H, Hkv, Sq, Sk, D, dtype)
    want = _np(jlayers.attention_full(qj, kj, vj, causal=False))
    q, k, v = (t.transpose(1, 2).contiguous() for t in (qt, kt, vt))
    tol = 2e-4 if dtype == "float32" else 5e-2
    outs = {}
    for name, fn in (("attention_ref", kattn.attention_ref),
                     ("attention_rounded_ref", kattn.attention_rounded_ref),
                     ("attention_tiled_ref", kattn.attention_tiled_ref)):
        got = fn(q, k, v, causal=False)
        assert got.shape == q.shape and got.dtype == q.dtype, name
        outs[name] = got
        np.testing.assert_allclose(_np(got.transpose(1, 2)), want, rtol=tol,
                                   atol=tol, err_msg=name)
    got = kattn.flash_attention(q, k, v, causal=False)
    assert torch.equal(got, outs["attention_ref"])
    tiled = kattn.attention_tiled_ref(q, k, v, causal=False, block_k=7)
    if dtype == "float32":
        torch.testing.assert_close(tiled, outs["attention_rounded_ref"],
                                   rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(tiled.float(),
                                   outs["attention_rounded_ref"].float(),
                                   rtol=1.6e-2, atol=4e-3)


def test_k4_refuses_masks_over_keys_of_another_length():
    q, kv = torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 9, 32)
    with pytest.raises(ValueError, match="another length"):
        kattn.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="another length"):
        kattn.flash_attention(q, kv, kv, causal=False, window=4)
    with pytest.raises(ValueError, match="fit"):
        kattn.flash_attention(q, torch.zeros(1, 2, 9, 16),
                              torch.zeros(1, 2, 9, 16), causal=False)


# ------------------------------------------------------------ the models --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    check_configs(arch, smoke)


def test_convert_and_forward_logits_match(pair):
    cfg, tree = pair.cfg, pair.tmodel.params
    if cfg.is_encdec:
        assert len(tree["enc_blocks"]) == cfg.n_enc_layers
        assert set(tree["blocks"][0]) == {"attn0", "dec_cross0", "mlp0"}
        np.testing.assert_array_equal(
            _np(tree["enc_blocks"][-1]["attn0"]["wq"]),
            _np(pair.params["enc_blocks"]["attn0"]["wq"][-1]))
    else:
        p = cfg.cross_attn_period
        assert f"cross{p - 1}" in tree["blocks"][0]
        np.testing.assert_array_equal(
            _np(tree["blocks"][-1][f"cross{p - 1}"]["wk"]),
            _np(pair.params["blocks"][f"cross{p - 1}"]["wk"][-1]))
    h, _ = pair.jmodel.forward(pair.params, pair.batch(pair.tokens), PAR)
    got = pair.tmodel.logits(pair.tmodel(torch.as_tensor(pair.tokens),
                                         **pair.kw()))
    close(got, jlogits_fn(pair.params, h, cfg, PAR), pair.dtype,
          f"{pair.arch} {pair.dtype} forward logits")


def test_prefill_logits_and_caches_match(pair):
    cfg, dtype = pair.cfg, pair.dtype
    cache_t, lg_t = pair.tmodel.prefill(torch.as_tensor(pair.tokens), S_MAX,
                                        **pair.kw())
    what = f"{pair.arch} {dtype} prefill"
    close(lg_t, pair.lg_r, dtype, what + " logits")
    mem_r = _np(pair.cache_r["memory"])
    assert cache_t["memory"].dtype == CDT
    assert cache_t["memory"].shape == mem_r.shape
    if cfg.is_encdec:
        assert mem_r.shape[1] == S_MAX
        assert int(cache_t["memory_len"]) == int(pair.cache_r["memory_len"])
        assert not cache_t["memory"][:, S:].abs().sum()
    if dtype == "bfloat16":
        close(cache_t["memory"], mem_r, dtype, what + " memory")
    else:       # both round a float32 memory to bfloat16 once
        err = np.abs(_np(cache_t["memory"]) - mem_r)
        assert np.all(err <= BF16_STEP * np.abs(mem_r)), what + " memory"
    ref = ref_entries(pair, pair.cache_r)
    assert set(ref) == set(cache_t["blocks"][0]) == {"k", "v"}
    if cfg.family == "vlm":
        assert cache_t["blocks"][0]["k"].shape[0] == cfg.cross_attn_period - 1
    for key, want in ref.items():
        got = np.stack([_np(c[key]) for c in cache_t["blocks"]])
        assert got.shape == want.shape, key
        if dtype == "bfloat16":
            close(got, want, dtype, f"{what} cache {key}")
            continue
        want = _np(torch.as_tensor(want).to(CDT))
        # before the first cross sublayer the memory has not been read
        first = got[0, 0] if cfg.family == "vlm" else got[0]
        err = np.abs(first - (want[0, 0] if cfg.family == "vlm" else
                              want[0]))
        assert np.all(err <= BF16_STEP * np.abs(want).max()), key
        norm = np.linalg.norm(want, axis=-1)
        rel = np.linalg.norm(got - want, axis=-1)[norm > 0] / norm[norm > 0]
        assert float(rel.max()) <= MEMORY_ROUNDED, (key, float(rel.max()))


def test_decode_step_matches_from_the_same_cache(pair):
    cache_r = jax.tree.map(lambda a: a if a.dtype == jnp.int32
                           else a.astype(jnp.bfloat16), pair.cache_r)
    nxt = pair.tokens[:, -1:]
    lg_r, _ = pair.step(cache_r, jnp.asarray(nxt, jnp.int32), jnp.int32(S))
    lg_t, _ = pair.tmodel.decode_step(port_cache_from_ref(pair, cache_r),
                                      torch.as_tensor(nxt), S)
    close(lg_t, lg_r, pair.dtype,
          f"{pair.arch} {pair.dtype} decode, same cache")


def test_chained_decode_matches(pair):
    """The port prefills PROMPT tokens (and their frames) and decodes to
    S_MAX - 1; each step against the reference's decode step from the
    port's cache, and the caches the two steps leave."""
    dtype = pair.dtype
    toks = np.random.default_rng(5).integers(1, pair.cfg.vocab, (2, S_MAX))
    cache_t, _ = pair.tmodel.prefill(torch.as_tensor(toks[:, :PROMPT]),
                                     S_MAX, **pair.kw(PROMPT))
    for pos in range(PROMPT, S_MAX - 1):
        nxt = toks[:, pos:pos + 1]
        lg_r, cache_r = pair.step(ref_cache_from_port(pair, cache_t),
                                  jnp.asarray(nxt, jnp.int32),
                                  jnp.int32(pos))
        lg_t, cache_t = pair.tmodel.decode_step(cache_t, torch.as_tensor(nxt),
                                                pos)
        what = f"{pair.arch} {dtype} decode at {pos}"
        if dtype == "float32":
            np.testing.assert_allclose(_np(lg_t), _np(lg_r), rtol=0,
                                       atol=2e-3, err_msg=what)
        else:
            close(lg_t, lg_r, dtype, what)
    for key, want in ref_entries(pair, cache_r).items():
        got = np.stack([_np(c[key]) for c in cache_t["blocks"]])
        if dtype == "bfloat16":
            close(got, want, dtype, f"{what}: cache {key}")
        else:   # each side wrote its own step's k / v: one step apart
            err = np.abs(got - want)
            assert np.all(err <= BF16_STEP * np.abs(want)), (what, key)
    assert not cache_t["blocks"][0]["k"][..., S_MAX - 1:, :, :].abs().sum()


def test_missing_embeddings_raise(pair):
    with pytest.raises(ValueError, match="frames" if pair.cfg.is_encdec
                       else "vis"):
        pair.tmodel(torch.as_tensor(pair.tokens))
    if pair.cfg.is_encdec:
        with pytest.raises(ValueError, match="frames"):
            pair.tmodel.prefill(torch.as_tensor(pair.tokens), S_MAX,
                                frames=torch.zeros(2, S - 1,
                                                   pair.cfg.d_model))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_serve_cli_refuse_embedding_models(arch):
    """The reference's engine prefills tokens only, which fails on these
    two (its prefill asserts frames / vis): the port's engine and serving
    CLI refuse them up front."""
    model = build_model(get_config(arch, smoke=True), device="cpu")
    with pytest.raises(ValueError, match="Model.prefill"):
        ServeEngine(model, B=2, S_max=16)
    with pytest.raises(SystemExit):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_float32_models_build_and_run_on_the_cpu():
    """The dtype handling of the memory: a float32 model reads bfloat16
    embeddings and stores a bfloat16 memory."""
    cfg = replace(get_config(ARCHS[1], smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu").to(torch.float32)
    vis = torch.randn(1, cfg.n_vis_tokens, cfg.d_model).to(torch.bfloat16)
    cache, lg = model.prefill(torch.ones(1, 3, dtype=torch.long), 8, vis=vis)
    assert lg.dtype == torch.float32 and cache["memory"].dtype == CDT
    assert torch.equal(cache["memory"], vis)
