"""The LM tier on the rank's own blocks over the model axis (`models.tp`),
against the unsharded port and, in one case, the JAX reference, on the CPU.

Smoke configs in float32, ranks stacked in this process on a (model 2) and
a (model 4) mesh.  Each of the families `models.tp` covers (dense: qwen3,
smollm with 3 query heads over 1 KV head, dealt 2 + 1 at tp 2 and 1 + 1 +
1 + 0 at tp 4, phi4-mini, gemma3's rings; moe: dbrx, llama4-scout;
encdec: seamless; vlm: llama-3.2-vision; ssm: rwkv6, 2 heads, none on
ranks 2 and 3 at tp 4; hybrid: hymba's attention and SSM channels) runs
from the blocks of one seeded weight tree (`tp.shard_model`) and from
the tree itself:

  forward logits within 2e-5 of the largest |logit|, the loss at rtol
  1e-6, and every leaf's gradient (the blocks reassembled by
  `tp.unshard_model`) within a relative L2 of 1e-5; a leaf every rank
  holds whole (norms, the router) has the same gradient on each rank;
  a prefill and 4 greedy decode steps within 1e-4 of the largest |logit|:
  the caches are bfloat16, where a key the two programs compute a float32
  ulp apart may round to neighbouring values (2^-8 apart).

Remat (`Parallelism.remat`, a superblock under `torch.utils.checkpoint`)
gives the same loss and gradients bit for bit, and `moe.routing_log()`
records each routing once.  qwen3-smoke, rwkv6-smoke and hymba-smoke run
the reference's forward and loss (at `Parallelism()`, weights from
tests/test_torch_train.py's `reference_weights`) against the port at tp 2,
at the LM tests' limits: logits by tests/test_torch_lm.py's `close`, the
loss at rtol 1e-4, gradients within 1e-3 of each leaf's largest |g|.
rwkv6's token-shift mixes need no psum (their raw gradients are whole on
every rank), its w_bias / u_bonus / ln_x do.  Two gloo processes, one
model rank each, train rwkv6 and hymba one step and serve a prefill and
2 decode steps on a group (model 2) mesh: equal to the stacked ranks bit
for bit.  The head-placement rule is checked at the production mesh's tp
16.  About 40 s on the CPU.
"""
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import build_model, init_weights
from repro_torch.models import moe as tmoe
from repro_torch.models import tp as tpm
from repro_torch.models import transformer as tf
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.sharding.parallel import Parallelism
from repro_torch.train.train_step import value_and_grad

ARCHS = ("qwen3-0.6b", "smollm-360m", "phi4-mini-3.8b", "gemma3-12b",
         "dbrx-132b", "llama4-scout-17b-a16e", "seamless-m4t-medium",
         "llama-3.2-vision-90b", "rwkv6-1.6b", "hymba-1.5b")
B, S = 2, 16
LOGIT_TOL, LOSS_RTOL, GRAD_REL_L2, DECODE_TOL = 2e-5, 1e-6, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, tp, remat=False):
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    mesh = make_mesh_compat((tp,), ("model",), "cpu")
    par = Parallelism(mesh=mesh, model_axis="model", remat=remat)
    params = init_weights(cfg, seed=0, device="cpu")
    return cfg, mesh, par, params, tpm.shard_model(params, cfg, mesh)


def _batch(cfg, seed=1, b=B, s=S):
    g = torch.Generator().manual_seed(seed)
    seq = torch.randint(1, cfg.vocab, (b, s + 1), generator=g)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if cfg.is_encdec:
        batch["frames"] = torch.randn(b, s, cfg.d_model, generator=g) * 0.3
    if cfg.family == "vlm":
        batch["vis"] = torch.randn(b, cfg.n_vis_tokens, cfg.d_model,
                                   generator=g) * 0.3
    return batch


def _inputs(batch):
    return {k: batch[k] for k in ("frames", "vis") if k in batch}


def _trainable(tree):
    return map_tree(lambda t: t.clone().requires_grad_(), tree)


def _rel(a, b):
    return float((a - b).norm() / b.norm()) if b.norm() > 0 else \
        float(a.norm())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_unsharded(arch, tp):
    cfg, mesh, par, params, blocks = _setup(arch, tp)
    batch = _batch(cfg)
    with torch.no_grad():
        want = tf.logits_fn(params, tf.forward(
            params, batch["tokens"], cfg, **_inputs(batch)), cfg)
        got = tf.logits_fn(blocks, tf.forward(
            blocks, batch["tokens"], cfg, par=par, **_inputs(batch)), cfg,
            par)
    assert got.shape == want.shape
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= LOGIT_TOL, err
    l0, _, g0 = value_and_grad(_trainable(params), batch, cfg)
    l1, _, g1 = value_and_grad(_trainable(blocks), batch, cfg, par)
    np.testing.assert_allclose(float(l1), float(l0), rtol=LOSS_RTOL)
    whole = tpm.unshard_model(g1, cfg, mesh)
    for (path, a), b in zip(_named(g0), tree_leaves(whole)):
        assert _rel(b, a) <= GRAD_REL_L2, (path, _rel(b, a))
    sh = tpm.model_shardings(tf.model_defs(cfg), cfg, mesh)
    for g, s in zip(tree_leaves(g1), tree_leaves(sh)):
        if s.dim is None:
            assert all(torch.equal(g[0], g[i]) for i in range(tp)), s


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(arch, tp):
    cfg, mesh, par, params, blocks = _setup(arch, tp)
    m0, m1 = build_model(cfg, params), build_model(cfg, blocks)
    batch = _batch(cfg, seed=2, s=8)
    kw = _inputs(batch)
    with torch.no_grad():
        c0, l0 = m0.prefill(batch["tokens"], 16, **kw)
        c1, l1 = m1.prefill(batch["tokens"], 16, par=par, **kw)
        # the rank caches hold the ranks' own key/value heads (rwkv6:
        # their WKV states)
        plan = tpm.plan(cfg, par)
        if cfg.family == "ssm":
            k = c1["blocks"][0]["wkv"]
            assert k.shape[:3] == (tp, B, max(plan.hq))
        else:
            k = next(iter(c1["blocks"][0].values()))
            assert k.shape[0] == tp and k.shape[-2] == max(plan.hkv)
        worst = float((l1 - l0).abs().max() / l0.abs().max())
        nxt = l0[:, -1].argmax(-1)[:, None]
        for step in range(4):
            l0, c0 = m0.decode_step(c0, nxt, 8 + step)
            l1, c1 = m1.decode_step(c1, nxt, 8 + step, par)
            worst = max(worst, float((l1 - l0).abs().max()
                                     / l0.abs().max()))
            nxt = l0[:, -1].argmax(-1)[:, None]
    assert worst <= DECODE_TOL, worst


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b",
                                  "seamless-m4t-medium", "rwkv6-1.6b",
                                  "hymba-1.5b"])
def test_remat_is_bit_for_bit(arch):
    cfg, mesh, par, params, blocks = _setup(arch, 2)
    batch = _batch(cfg)
    runs = []
    for remat in (False, True):
        with tmoe.routing_log() as log:
            loss, _, g = value_and_grad(_trainable(blocks), batch, cfg,
                                        replace(par, remat=remat))
        runs.append((loss, g, len(log)))
    (la, ga, na), (lb, gb, nb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ga),
                                                 tree_leaves(gb)))
    # each routing once: one entry a rank a MoE sublayer
    assert na == nb == (cfg.n_layers * 2 if cfg.n_experts else 0)
    # and without a mesh: the reference's default remat on the whole tree
    l0, _, g0 = value_and_grad(_trainable(params), batch, cfg,
                               Parallelism(remat=False))
    l1, _, g1 = value_and_grad(_trainable(params), batch, cfg)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


def test_matches_reference_package():
    """qwen3-smoke at tp 2 against the JAX package's forward, loss and
    gradients at `Parallelism()`, the weights carried into the blocks by
    `lm_params_from_numpy(par=)`."""
    _against_reference("qwen3-0.6b")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_rwkv6_and_hymba_match_reference_package(arch):
    """rwkv6 (its heads split 1 + 1, the channel mix's gate columns 32 +
    32) and hymba (its attention and SSM channels) at tp 2, as qwen3."""
    _against_reference(arch)


def _against_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import logits_fn as jlogits_fn
    from repro.sharding.parallel import Parallelism as JPar
    from repro_torch.convert import lm_params_from_numpy
    from test_torch_lm import close
    from test_torch_train import make_batch, reference_weights
    jcfg, jmodel, params = reference_weights(arch, "float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    mesh = make_mesh_compat((2,), ("model",), "cpu")
    par = Parallelism(mesh=mesh, model_axis="model")
    tree = jax.tree.map(np.asarray, params)
    blocks = lm_params_from_numpy(cfg, tree, device="cpu", par=par)
    assert all(t.shape[0] == 2 for t in tree_leaves(blocks))
    batch = make_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    h, _ = jmodel.forward(params, jb, JPar())
    want = jlogits_fn(params, h, jcfg, JPar())
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    model = build_model(cfg, blocks)
    got = model.logits(model(tb["tokens"], par=par), par)
    close(got, want, "float32", f"{arch} tp 2 forward logits")
    (loss_r, _), g_r = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, JPar()), has_aux=True)(params)
    loss_t, _, g_t = value_and_grad(_trainable(blocks), tb, cfg, par)
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=1e-4)
    want_g = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, g_r),
                                  device="cpu")
    for (path, w), g in zip(_named(want_g), tree_leaves(
            tpm.unshard_model(g_t, cfg, mesh))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * float(w.abs().max()),
                                   err_msg=path)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_bfloat16_ranks_keep_the_model_type(arch):
    """bfloat16 at tp 4 (rwkv6: two ranks without a head): a prefill and 2
    decode steps keep bfloat16 hidden states (the rank without a head adds
    its float32 collective results as bfloat16 zeros) and stay within
    tests/test_torch_lm.py's bfloat16 limit (5e-2 of the largest |logit|)
    of the unsharded model."""
    cfg = get_config(arch, smoke=True)
    mesh = make_mesh_compat((4,), ("model",), "cpu")
    par = Parallelism(mesh=mesh, model_axis="model", remat=False)
    params = init_weights(cfg, seed=0, device="cpu")
    m0 = build_model(cfg, params)
    m1 = build_model(cfg, tpm.shard_model(params, cfg, mesh))
    toks = _batch(cfg, seed=3, s=8)["tokens"]
    with torch.no_grad():
        assert m1(toks, par=par).dtype == torch.bfloat16
        c0, l0 = m0.prefill(toks, 16)
        c1, l1 = m1.prefill(toks, 16, par=par)
        worst = float((l1 - l0).float().abs().max() / l0.float().abs().max())
        nxt = l0[:, -1].argmax(-1)[:, None]
        for step in range(2):
            l0, c0 = m0.decode_step(c0, nxt, 8 + step)
            l1, c1 = m1.decode_step(c1, nxt, 8 + step, par)
            worst = max(worst, float((l1 - l0).float().abs().max()
                                     / l0.float().abs().max()))
    assert worst <= 5e-2, worst


def test_rwkv6_mixes_need_no_psum():
    """The token-shift mixes (mu_*, cmu_*) are taken before f, so their
    raw gradients (no `sync_grads`) are the whole gradient on every rank;
    w_bias, u_bonus and ln_x are read on each rank's heads only: their
    raw gradients are partial, placed `reduce="model"`, and sum to the
    whole one."""
    cfg, mesh, par, params, blocks = _setup("rwkv6-1.6b", 2)
    batch = _batch(cfg)
    sh = tpm.model_shardings(tf.model_defs(cfg), cfg, mesh)
    p0, p1 = _trainable(params), _trainable(blocks)
    g0 = torch.autograd.grad(tf.loss_fn(p0, batch, cfg)[0],
                             tree_leaves(p0))
    g1 = torch.autograd.grad(tf.loss_fn(p1, batch, cfg, par)[0],
                             tree_leaves(p1))
    named = [path for path, _ in _named(p0)]
    mixes = partial = 0
    for path, a, b, s in zip(named, g0, g1, tree_leaves(sh)):
        name = path.rsplit("/", 1)[-1]
        if name.startswith(("mu_", "cmu_")):
            assert s.reduce is None, path
            for i in range(2):
                assert _rel(b[i], a) <= GRAD_REL_L2, (path, i)
            mixes += 1
        elif name in ("w_bias", "u_bonus", "ln_x"):
            assert s.reduce == "model", path
            assert _rel(b[0], a) > 0.1 and _rel(b[0] + b[1], a) <= \
                GRAD_REL_L2, path
            partial += 1
    assert (mixes, partial) == (7 * cfg.n_layers, 3 * cfg.n_layers)


_GLOO_WORKER = textwrap.dedent("""
    import sys
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.models import build_model, init_weights
    from repro_torch.models.params import map_tree, tree_leaves
    from repro_torch.models.tp import shard_model
    from repro_torch.sharding.parallel import Parallelism
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import make_train_step

    rank, world, init, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    mesh = make_group_mesh((2,), ("model",), device="cpu")
    par = Parallelism(mesh=mesh, model_axis="model")
    batch = {k: torch.as_tensor(v) for k, v in
             np.load(f"{d}/batch.npz").items()}
    res = {}
    for a in ("rwkv6-1.6b", "hymba-1.5b"):
        cfg = replace(get_config(a, smoke=True), dtype="float32")
        blocks = shard_model(init_weights(cfg, seed=0, device="cpu"), cfg,
                             mesh)
        with torch.no_grad():
            model = build_model(cfg, blocks)
            serve = replace(par, remat=False)
            cache, lg = model.prefill(batch["tokens"][:, :8], 16, par=serve)
            res[f"{a}/serve0"] = lg.numpy()
            for i in range(2):
                lg, cache = model.decode_step(cache, lg.argmax(-1), 8 + i,
                                              par=serve)
                res[f"{a}/serve{i + 1}"] = lg.numpy()
        blocks = map_tree(lambda t: t.requires_grad_(), blocks)
        step = make_train_step(cfg, topt.AdamWConfig(
            lr=1e-3, warmup=2, total_steps=20), par=par)
        newp, _, m = step(blocks, topt.init_opt_state(blocks), batch)
        res[f"{a}/loss"] = m["loss"].numpy()
        res[f"{a}/grad_norm"] = m["grad_norm"].numpy()
        for i, t in enumerate(tree_leaves(newp)):
            res[f"{a}/p{i}"] = t.detach().numpy()
    np.savez(f"{d}/rank{rank}.npz", **res)
    dist.destroy_process_group()
""").strip()


def test_gloo_ranks_equal_stacked_bit_for_bit(tmp_path):
    """rwkv6 and hymba on a group (model 2) mesh, one rank a process: a
    prefill and 2 decode steps and one train step, equal to the stacked
    mesh's bit for bit."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import make_train_step
    from test_torch_dist_gloo import run_side_by_side
    batch = {k: v.numpy() for k, v in _batch(get_config(
        "rwkv6-1.6b", smoke=True), seed=5).items()}
    np.savez(tmp_path / "batch.npz", **batch)
    run_side_by_side([[sys.executable, "-c", _GLOO_WORKER, str(r), "2",
                       f"file://{tmp_path}/rendezvous", str(tmp_path)]
                      for r in range(2)], timeout=300)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        cfg, mesh, par, params, blocks = _setup(arch, 2, remat=True)
        with torch.no_grad():
            model = build_model(cfg, blocks)
            serve = replace(par, remat=False)
            cache, lg = model.prefill(tb["tokens"][:, :8], 16, par=serve)
            want = [lg]
            for i in range(2):
                lg, cache = model.decode_step(cache, lg.argmax(-1), 8 + i,
                                              par=serve)
                want.append(lg)
        blocks = _trainable(blocks)
        step = make_train_step(cfg, topt.AdamWConfig(
            lr=1e-3, warmup=2, total_steps=20), par=par)
        newp, _, m = step(blocks, topt.init_opt_state(blocks), tb)
        for r, res in enumerate(ranks):
            for i, w in enumerate(want):
                np.testing.assert_array_equal(res[f"{arch}/serve{i}"],
                                              w.numpy())
            assert res[f"{arch}/loss"] == m["loss"].numpy(), arch
            assert res[f"{arch}/grad_norm"] == m["grad_norm"].numpy()
            for i, t in enumerate(tree_leaves(newp)):
                np.testing.assert_array_equal(res[f"{arch}/p{i}"][0],
                                              t.detach()[r].numpy())


def test_head_placement_rule():
    """Whole KV heads and one group size a rank; query heads dealt as
    evenly as possible (the production tp 16, and the smoke smollm)."""
    place = tpm.head_placement
    # phi4-mini 24 / 8: two ranks a KV group, its 3 query heads 2 + 1
    assert place(24, 8, 16)[:2] == [(0, 2, 0, 1), (2, 3, 0, 1)]
    # llama4-scout 40 / 8: 5 query heads a group, 3 + 2
    assert [q1 - q0 for q0, q1, _, _ in place(40, 8, 16)] == [3, 2] * 8
    # smollm 15 / 5 at 16: 4 ranks on the first group (1 + 1 + 1 + 0)
    sm = place(15, 5, 16)
    assert [q1 - q0 for q0, q1, _, _ in sm[:4]] == [1, 1, 1, 0]
    assert [k0 for _, _, k0, _ in sm] == [0] * 4 + [1] * 3 + [2] * 3 + \
        [3] * 3 + [4] * 3
    # fewer ranks than KV groups: the groups dealt 2 + 1 + 1 + 1
    assert place(15, 5, 4) == [(0, 6, 0, 2), (6, 9, 2, 3), (9, 12, 3, 4),
                               (12, 15, 4, 5)]
    assert place(3, 1, 2) == [(0, 2, 0, 1), (2, 3, 0, 1)]
    assert place(3, 1, 4) == [(0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 0, 1),
                              (3, 3, 0, 1)]
    for H, Hkv, tp in ((24, 8, 16), (40, 8, 16), (15, 5, 16), (64, 8, 16),
                       (16, 8, 16), (16, 16, 16), (15, 5, 4)):
        heads = place(H, Hkv, tp)
        assert len(heads) == tp
        covered = sorted(q for q0, q1, _, _ in heads for q in range(q0, q1))
        assert covered == list(range(H))
        for q0, q1, k0, k1 in heads:
            assert q1 == q0 or (q1 - q0) % (k1 - k0) == 0
            assert all(k0 <= q // (H // Hkv) < k1 for q in range(q0, q1))
