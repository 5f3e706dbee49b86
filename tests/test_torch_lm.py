"""The port's language models (repro_torch.models) against the JAX reference
(repro.models) on the qwen3 and rwkv6 smoke configs, on the CPU.

Weights come from the reference's `model.init`, with N(0, 0.2) numpy noise
added to every leaf (so the token-shift mixing vectors, zero at init, take
part), passed to the port through `convert.lm_params_from_numpy`.  Compared:
forward logits, prefill logits and caches (rwkv6's `cm_tok` included), one
decode step from the same cache, and a decode step after each side's own
prefill.

Tolerances.  float32 (`replace(cfg, dtype="float32")`, weights cast): 1e-4
on logits and on float32 state.  Cache entries are stored in bfloat16 on
both sides; where a float32 value lies at a bfloat16 rounding boundary the
two may round to neighbours, so those entries agree within one bfloat16 step
(2^-7 relative), and a decode step after each side's own prefill within 2e-3
(such a neighbour moves a logit by up to a few 1e-4 here).  bfloat16: 5e-2
of the largest reference value: XLA and PyTorch round to bfloat16 at
different places (fused elementwise chains keep float32 in XLA; K4's plain
version rounds the scores where `attention_full` rounds q * scale), each a
2^-9 relative error carried through the layers; 5e-2 is the reference's own
bfloat16 tolerance for its attention kernel (tests/test_kernels.py).
"""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import param_count as jparam_count
from repro.models import build_model as jbuild_model
from repro.models.transformer import logits_fn as jlogits_fn
from repro.sharding.parallel import Parallelism
from repro_torch.configs import get_config, param_count
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf
from repro_torch.models.decode import CDT

PAR = Parallelism(remat=False)
ARCHS = ["qwen3-0.6b", "rwkv6-1.6b"]
DTYPES = ["float32", "bfloat16"]
NOISE = 0.2
S, S_MAX = 8, 16
BF16_STEP = 2.0 ** -7


def perturbed_reference(arch, dtype, seed=1, vectors_only=False):
    """(reference cfg, model, params) with N(0, NOISE) added to every leaf,
    or with `vectors_only` to the per-layer vectors alone (norm gains,
    mixing vectors, biases), leaving the random matrices at their init."""
    cfg = replace(jget_config(arch, smoke=True), dtype=dtype)
    model = jbuild_model(cfg)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        a32 = np.asarray(a.astype(jnp.float32))
        vector = a.ndim == (2 if path[0].key == "blocks" else 1)
        if vector or not vectors_only:
            a32 = a32 + rng.normal(0, NOISE, a32.shape).astype(np.float32)
        return jnp.asarray(a32).astype(
            jnp.float32 if dtype == "float32" else a.dtype)

    return cfg, model, jax.tree_util.tree_map_with_path(noisy, params)


def port_of(arch, dtype, params):
    """The port's model of the same config holding the same weights."""
    cfg = replace(get_config(arch, smoke=True), dtype=dtype)
    tree = jax.tree.map(np.asarray, params)
    return build_model(cfg, lm_params_from_numpy(cfg, tree, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-2 * np.abs(want).max(),
                                   err_msg=what)


def ref_cache_entries(cache_r, arch):
    """The reference's stacked cache as {name: (n_layers, ...)} numpy."""
    out = {}
    for key, a in cache_r["blocks"].items():
        a = _np(a)
        out[key] = a[:, 0] if arch.startswith("qwen") else a
    return out


def port_cache_from_ref(cache_r, arch):
    """The reference's prefill cache in the port's layout: one entry per
    layer, bfloat16 where the port stores bfloat16."""
    ent = ref_cache_entries(cache_r, arch)
    n = next(iter(ent.values())).shape[0]
    return {"blocks": [
        {k: torch.as_tensor(v[i]).to(torch.float32 if k == "wkv" else CDT)
         for k, v in ent.items()} for i in range(n)]}


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    cfg, jmodel, params = perturbed_reference(arch, dtype)
    tokens = np.random.default_rng(0).integers(1, cfg.vocab, (2, S))
    return arch, dtype, cfg, jmodel, params, port_of(arch, dtype, params), tokens


def test_convert_unstacks_and_keeps_types(pair):
    arch, dtype, cfg, _, params, tmodel, _ = pair
    tree = tmodel.params
    assert len(tree["blocks"]) == cfg.n_layers
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert all(p.dtype == want for p in tmodel.parameters())
    key = "rwkv" if arch.startswith("rwkv") else "attn0"
    leaf = "w_r" if arch.startswith("rwkv") else "wq"
    np.testing.assert_array_equal(_np(tree["blocks"][1][key][leaf]),
                                  _np(params["blocks"][key][leaf][1]))
    ttf.check_supported(tmodel.cfg)


def test_forward_logits_match(pair):
    arch, dtype, cfg, jmodel, params, tmodel, tokens = pair
    h, _ = jmodel.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                          PAR)
    want = jlogits_fn(params, h, cfg, PAR)
    got = tmodel.logits(tmodel(torch.as_tensor(tokens)))
    close(got, want, dtype, f"{arch} {dtype} forward logits")


def test_prefill_logits_and_caches_match(pair):
    arch, dtype, cfg, jmodel, params, tmodel, tokens = pair
    cache_r, lg_r = jmodel.prefill(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, PAR, S_max=S_MAX)
    cache_t, lg_t = tmodel.prefill(torch.as_tensor(tokens), S_MAX)
    close(lg_t, lg_r, dtype, f"{arch} {dtype} prefill logits")
    ref = ref_cache_entries(cache_r, arch)
    assert set(ref) == set(cache_t["blocks"][0])
    if arch.startswith("rwkv"):
        assert set(ref) == {"tm_tok", "wkv", "cm_tok"}
    for key, want in ref.items():
        got = np.stack([_np(c[key]) for c in cache_t["blocks"]])
        stored = cache_t["blocks"][0][key].dtype
        assert stored == (torch.float32 if key == "wkv" else CDT), key
        if dtype == "float32" and stored == CDT:
            # the reference keeps a float32 model's dense k/v in float32
            want = _np(torch.as_tensor(want).to(CDT))
            err = np.abs(got - want)
            assert np.all(err <= BF16_STEP * np.abs(want)), \
                (key, float(err.max()))
        else:
            close(got, want, dtype, f"{arch} {dtype} cache {key}")


def test_decode_step_matches_from_the_same_cache(pair):
    arch, dtype, cfg, jmodel, params, tmodel, tokens = pair
    cache_r, _ = jmodel.prefill(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, PAR, S_max=S_MAX)
    # the reference's float32 dense prefill keeps k/v in float32, which its
    # own decode step cannot write bfloat16 into: hand it the bfloat16 cache
    cache_r = jax.tree.map(lambda a: a if a.dtype == jnp.float32 and
                           arch.startswith("rwkv") else a.astype(jnp.bfloat16),
                           cache_r)
    nxt = tokens[:, -1:]
    lg_r, _ = jmodel.decode_step(params, cache_r, jnp.asarray(nxt, jnp.int32),
                                 jnp.int32(S), PAR)
    lg_t, _ = tmodel.decode_step(port_cache_from_ref(cache_r, arch),
                                 torch.as_tensor(nxt), S)
    close(lg_t, lg_r, dtype, f"{arch} {dtype} decode logits, same cache")


def test_prefill_then_decode_matches(pair):
    arch, dtype, cfg, jmodel, params, tmodel, tokens = pair
    cache_r, _ = jmodel.prefill(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, PAR, S_max=S_MAX)
    cache_r = jax.tree.map(lambda a: a if a.dtype == jnp.float32 and
                           arch.startswith("rwkv") else a.astype(jnp.bfloat16),
                           cache_r)
    cache_t, _ = tmodel.prefill(torch.as_tensor(tokens), S_MAX)
    nxt = tokens[:, :1]
    lg_r, _ = jmodel.decode_step(params, cache_r, jnp.asarray(nxt, jnp.int32),
                                 jnp.int32(S), PAR)
    lg_t, cache_t = tmodel.decode_step(cache_t, torch.as_tensor(nxt), S)
    if dtype == "float32":
        np.testing.assert_allclose(_np(lg_t), _np(lg_r), rtol=0, atol=2e-3)
    else:
        close(lg_t, lg_r, dtype, f"{arch} {dtype} prefill + decode logits")
    if arch.startswith("qwen"):          # the step wrote position S in place
        assert cache_t["blocks"][0]["k"][:, S].abs().sum() > 0
        assert cache_t["blocks"][0]["k"][:, S + 1:].abs().sum() == 0


def test_unported_families_raise():
    """Every family of the reference is ported: `list_archs()` names the
    reference's ten architectures and each config resolves.  What
    `check_supported` still refuses raises: rwkv6 with another norm_eps
    (its block normalises with 1e-5), and a family the reference has not."""
    from repro.configs import list_archs as jlist_archs
    from repro_torch.configs import list_archs
    assert list_archs() == jlist_archs() and len(list_archs()) == 10
    for arch in list_archs():
        assert get_config(arch).name == arch
    cfg = replace(get_config("rwkv6-1.6b", smoke=True), norm_eps=1e-6)
    with pytest.raises(NotImplementedError, match="norm_eps"):
        build_model(cfg, device="cpu")
    cfg = replace(get_config("qwen3-0.6b", smoke=True), family="diffusion")
    with pytest.raises(NotImplementedError, match="family"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    cfg, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert asdict(cfg) == asdict(ref)
    assert param_count(cfg) == jparam_count(ref)
    assert ttf.padded_vocab(cfg) == -(-cfg.vocab // 256) * 256


def test_convert_rejects_a_misshapen_tree():
    cfg, _, params = perturbed_reference("qwen3-0.6b", "float32")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, final_ln=tree["final_ln"][:-1])
    with pytest.raises(ValueError, match="final_ln"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    bad = dict(tree, extra=tree["final_ln"])
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(cfg, bad, device="cpu")


def test_model_params_follow_a_conversion():
    """`Model.params` is built once, holds the registered parameters
    themselves, and is rebuilt when `.to()` converts them."""
    model = build_model(get_config("qwen3-0.6b", smoke=True), device="cpu")
    tree = model.params
    assert model.params is tree
    leaves = {id(t) for t in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))}
    assert leaves == {id(p) for p in model.parameters()}
    model.to(torch.float32)
    assert model.params["embed"].dtype == torch.float32
    assert model.params["blocks"][0]["attn0"]["wq"].dtype == torch.float32
