"""The port's training tier (repro_torch.models.transformer.loss_fn,
repro_torch.train) against the JAX reference, on the CPU.

Loss and gradients, per family: qwen3 (dense, qk_norm), gemma3 (sliding
window), dbrx (MoE) and rwkv6 (ssm) here; hymba (hybrid), seamless
(encdec), llama-3.2-vision (vlm) and a bfloat16 case in
tests/test_torch_train_grads.py, with this file's `Case`, checks and
weights.  Smoke configs in float32, B = 2, S = 32, with
tests/test_torch_lm.py's kind of weights (drawn in NumPy at the
reference's init scales, plus N(0, 0.2) on every leaf; faster than the
reference's own `init`).  rwkv6 keeps its decay projection `w_w` at its
init scale: with noise on it, its decays fall below e^-88 over a
32-token chunk and the reference's `wkv_chunked` overflows to NaN
(ROADMAP.md §3), so there is nothing to compare.  seamless and the vlm
take frames / patches at scale 0.1 (tests/test_torch_lm_cross.py's).  A
batch row in which some MoE sublayer routed a token at a near tie
(router-logit margin at most `TIE`, read through `moe.routing_log()`) is
left out of both sides' loss: routing is discontinuous there, and causal
attention carries a changed route only along its own row.  Limits: the
loss at rtol 1e-4, each leaf's gradient within 1e-3 of that leaf's
largest |g|; the bfloat16 case (qwen3, noise on the per-layer vectors
only, as tests/test_torch_lm_hybrid.py draws bfloat16 weights) at 5e-2 of
both.

The optimizer pieces (`lr_schedule`, `global_norm`, `adamw_update` with
and without clipping) and `grad_compress` against the reference's, and the
reference's own optimizer tests.  tests/test_torch_ckpt.py holds one
train step against the reference's.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.params import ParamDef
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.models.transformer import loss_fn
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import value_and_grad

from test_torch_lm import NOISE, PAR, port_of
from test_torch_lm_swa import TIE

B, S = 2, 32
EMBED_SCALE = 0.1
# the families held here; tests/test_torch_train_grads.py holds hymba,
# seamless, the vlm and the bfloat16 case with the same checks
CASES = [(a, "float32") for a in ("qwen3-0.6b", "gemma3-12b", "dbrx-132b",
                                  "rwkv6-1.6b")]
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def named_leaves(tree, path="params"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def make_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, cfg.vocab, (B, S + 1))
    batch = {"tokens": seq[:, :-1].astype(np.int32),
             "labels": seq[:, 1:].astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = (rng.normal(size=(B, S, cfg.d_model))
                           * EMBED_SCALE).astype(np.float32)
    if cfg.family == "vlm":
        batch["vis"] = (rng.normal(size=(B, cfg.n_vis_tokens, cfg.d_model))
                        * EMBED_SCALE).astype(np.float32)
    return batch


def reference_weights(arch, dtype, seed=1):
    """(reference cfg, model, params): every leaf drawn in NumPy as the
    reference's init draws it (ones, zeros, or N(0, 1) x its scale) plus
    N(0, NOISE) (in bfloat16 on the per-layer vectors only), rwkv6's `w_w`
    without noise; in the model's type (the MoE router float32)."""
    cfg = replace(jget_config(arch, smoke=True), dtype=dtype)
    jmodel = jbuild_model(cfg)
    rng = np.random.default_rng(seed)

    def draw(path, d):
        if d.init == "ones":
            a = np.ones(d.shape, np.float32)
        elif d.init == "zeros":
            a = np.zeros(d.shape, np.float32)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = d.scale if d.scale is not None else fan_in ** -0.5
            a = (rng.normal(size=d.shape) * scale).astype(np.float32)
        vector = len(d.shape) == (2 if path[0].key == "blocks" else 1)
        if path[-1].key != "w_w" and (vector or dtype == "float32"):
            a = a + rng.normal(0, NOISE, d.shape).astype(np.float32)
        out = jnp.asarray(a)
        return out if dtype == "float32" else out.astype(jnp.dtype(d.dtype))

    params = jax.tree_util.tree_map_with_path(
        draw, jmodel.defs(), is_leaf=lambda x: isinstance(x, ParamDef))
    return cfg, jmodel, params


def trainable(model):
    return map_tree(lambda t: t.detach().clone().requires_grad_(),
                    model.params)


def rows_without_ties(tcfg, ptree, batch, dtype):
    """The batch rows in which no MoE sublayer routed a token at a near
    tie (every row without experts)."""
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad(), tmoe.routing_log() as log:
        loss_fn(ptree, tb, tcfg)
    ties = np.zeros((B, S), bool)
    for _, keep, margin in log:
        assert bool(keep.all())
        ties |= margin.float().numpy().reshape(B, S) <= TIE[dtype]
    keep = ~ties.any(1)
    assert keep.any(), "every row holds a near-tie routing"
    return keep


class Case:
    """One family's loss and gradients on both sides, computed once."""

    def __init__(self, arch, dtype):
        self.arch, self.dtype = arch, dtype
        self.cfg, jmodel, params = reference_weights(arch, dtype)
        tmodel = port_of(arch, dtype, params)
        ptree = trainable(tmodel)
        batch = make_batch(self.cfg)
        rows = rows_without_ties(tmodel.cfg, ptree, batch, dtype)
        batch = {k: v[rows] for k, v in batch.items()}
        self.rows = int(rows.sum())
        f = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss(p, b, PAR), has_aux=True))
        (loss_r, parts_r), g_r = f(params, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        self.loss_r = float(loss_r)
        self.aux_r = float(parts_r["aux"])
        self.grads_r = lm_params_from_numpy(
            tmodel.cfg, jax.tree.map(lambda a: np.asarray(
                a.astype(jnp.float32)), g_r), device="cpu")
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss_t, parts_t, self.grads_t = value_and_grad(ptree, tb, tmodel.cfg)
        self.loss_t = float(loss_t)
        self.aux_t = float(parts_t["aux"].detach())
        self.params = ptree


def check_loss(case):
    rtol = LOSS_RTOL[case.dtype]
    assert np.isfinite(case.loss_r)
    np.testing.assert_allclose(case.loss_t, case.loss_r, rtol=rtol)
    np.testing.assert_allclose(case.aux_t, case.aux_r, rtol=rtol, atol=1e-6)
    if case.cfg.n_experts:
        assert case.aux_r > 0


def check_grads(case):
    tol = GRAD_TOL[case.dtype]
    want = dict(named_leaves(case.grads_r))
    got = dict(named_leaves(case.grads_t))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].float().numpy()
        g = g.float().numpy()
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{case.arch} {case.dtype} {name}")
    # a weight in front of attention or WKV gets a gradient
    first = case.grads_t["blocks"][0]
    key = "rwkv" if case.cfg.family == "ssm" else "attn0"
    lead = first[key]["w_r" if key == "rwkv" else "wq"]
    assert float(lead.abs().max()) > 0


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    return Case(*request.param)


def test_loss_matches_reference(case):
    check_loss(case)


def test_every_gradient_matches_reference(case):
    check_grads(case)


# ------------------------------------------------------ optimizer pieces ---
def _tree(rng, scale=1.0):
    return {"a": rng.normal(size=(5, 3)).astype(np.float32) * scale,
            "b": {"c": rng.normal(size=(7,)).astype(np.float32) * scale}}


def _t(tree):
    return map_tree(torch.as_tensor, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 101, 5000, 10_000,
                                  20_000])
def test_lr_schedule_matches_reference(step):
    cfg = topt.AdamWConfig(lr=3e-3, warmup=100, total_steps=10_000)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup=100, total_steps=10_000)
    np.testing.assert_allclose(topt.lr_schedule(cfg, step),
                               float(jopt.lr_schedule(jcfg, step)),
                               rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-2, 100.0], ids=["unclipped",
                                                             "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup=2, total_steps=10, weight_decay=0.1)
    jo = jopt.init_opt_state(_j(params))
    to = topt.init_opt_state(_t(params))
    for _ in range(4):
        g = _tree(rng, grad_scale)
        jp, jo, jm = jopt.adamw_update(_j(g), jo, jopt.AdamWConfig(**kw),
                                       param_dtype=jnp.float32)
        tp, to, tm = topt.adamw_update(_t(g), to, topt.AdamWConfig(**kw),
                                       param_dtype=torch.float32)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(topt.global_norm(_t(g))),
                                   float(jopt.global_norm(_j(g))), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(tree_leaves(to.v), jax.tree.leaves(jo.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert to.step == int(jo.step) == 4


def test_adamw_converges_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup=1,
                           total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = topt.init_opt_state(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(150):
        g = {"w": opt.master["w"] - target}
        params, opt, _ = topt.adamw_update(g, opt, cfg,
                                           param_dtype=torch.float32)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.15)


def test_grad_clip_applied_and_params_in_their_type():
    cfg = topt.AdamWConfig(clip_norm=1.0, warmup=1)
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    opt = topt.init_opt_state(params)
    p, opt, m = topt.adamw_update({"w": torch.full((4,), 100.0)}, opt, cfg)
    assert float(m["grad_norm"]) > 1.0  # reported pre-clip
    assert p["w"].dtype == torch.bfloat16
    assert opt.master["w"].dtype == torch.float32


def test_grad_compress_matches_reference():
    rng = np.random.default_rng(0)
    g = _tree(rng)
    te, je = gc.init_errors(_t(g)), jgc.init_errors(_j(g))
    for _ in range(3):
        tq, ts, te = gc.compress_tree(_t(g), te)
        jq, js, je = jgc.compress_tree(_j(g), je)
        for a, b in zip(tree_leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(ts) + tree_leaves(te),
                        jax.tree.leaves(js) + jax.tree.leaves(je)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)
        for a, b in zip(tree_leaves(gc.decompress_tree(tq, ts)),
                        jax.tree.leaves(jgc.decompress_tree(jq, js))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    q, s = gc.quantize_int8(torch.tensor([0.0, 1.0, -2.54]))
    np.testing.assert_array_equal(q.numpy(), [0, 50, -127])


def test_grad_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.normal(size=(256,)).astype(np.float32))}
    errs = gc.init_errors(g)
    total_deq = torch.zeros(256)
    for _ in range(20):
        q, s, errs = gc.compress_tree(g, errs)
        total_deq = total_deq + gc.decompress_tree(q, s)["w"]
    total_true = 20 * g["w"]
    rel = float(torch.linalg.norm(total_deq - total_true)
                / torch.linalg.norm(total_true))
    assert rel < 5e-3, rel
