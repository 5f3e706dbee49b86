"""The port's data pipeline, checkpoints and training driver
(repro_torch.data, repro_torch.ckpt, repro_torch.launch.train) against the
JAX reference, on the CPU.

- `SyntheticLM`'s batches equal the reference's token for token (several
  seeds, shards and steps), and resume from a snapshot exactly.
- Checkpoint format: a tree of qwen3-smoke's bfloat16 weights and a
  stepped optimizer state saved by the reference's `save_checkpoint`
  loads in the port with every leaf equal, and the port's save of it
  loads in the reference's `load_checkpoint` equal to the original: the
  same keys, shapes, types and manifest (superblock leaves stacked).
  Saves are atomic (a failed save leaves no step and no temporary
  directory) and `keep` collects old steps.
- The driver: the loss falls over 30 smoke steps (the reference's
  `test_loss_decreases`); a run failed at step 7 and resumed from its
  step-6 checkpoint ends on the uninterrupted run's last 3 losses at rtol
  2e-4 (the reference's `test_checkpoint_restart_exact`); and the port
  resumes from the checkpoint the reference's `launch.train.run` wrote at
  step 6 of qwen3-smoke (bfloat16) and follows the reference's
  uninterrupted losses within 5e-2 (relative): the same model, data and
  optimizer state, rounded to bfloat16 at other places.
- One `train_step` of qwen3-smoke in float32 (tests/test_torch_train.py's
  weights) against the reference's `make_train_step` with n_micro 1 and
  2: loss, grad_norm, lr and the new master weights at rtol 1e-5 (atol
  1e-7).  Adam's first step moves a weight by lr g / (|g| + eps), nearly
  lr sign(g); where the (clipped) gradient is within 100 eps of zero, eps
  takes part and the step follows the gradient's last bits, which the two
  packages round differently (entries at |g| of 1.3e-8 to 1.0e-7 moved by
  up to 2.7e-5 of their value): those master entries are held to 2 lr, the
  step's bound, and must be under 1% of all.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.train import run as jrun
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import run
from repro_torch.models import weight_structs
from repro_torch.models.params import tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

from test_torch_lm import PAR, port_of
from test_torch_train import (make_batch, named_leaves, reference_weights,
                              trainable)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and more threads
    only contend with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data ---
@pytest.mark.parametrize("vocab,seq,batch,seed,n_shards", [
    (1000, 32, 8, 3, 1), (256, 64, 8, 0, 4), (151936, 16, 2, 7, 1)])
def test_synthetic_batches_equal_reference(vocab, seq, batch, seed, n_shards):
    for shard in range(n_shards):
        t = SyntheticLM(vocab, seq, batch, seed=seed, n_shards=n_shards,
                        shard=shard)
        j = JSyntheticLM(vocab, seq, batch, seed=seed, n_shards=n_shards,
                         shard=shard)
        for _ in range(3):
            bt, bj = t.next_batch(), j.next_batch()
            for key in ("tokens", "labels"):
                assert bt[key].dtype == bj[key].dtype
                np.testing.assert_array_equal(bt[key], bj[key])
        assert t.snapshot() == j.snapshot()


def test_data_determinism_and_resume():
    d1 = SyntheticLM(1000, 32, 8, seed=3)
    b1 = d1.next_batch()
    np.testing.assert_array_equal(
        b1["tokens"], SyntheticLM(1000, 32, 8, seed=3).next_batch()["tokens"])
    d1.next_batch()
    snap = d1.snapshot()
    ref = d1.next_batch()
    d3 = SyntheticLM(1000, 32, 8, seed=3)
    d3.restore(snap)
    np.testing.assert_array_equal(ref["tokens"], d3.next_batch()["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    shards = [SyntheticLM(1000, 16, 8, seed=1, n_shards=4, shard=k)
              for k in range(4)]
    batches = [s.next_batch()["tokens"] for s in shards]
    assert all(b.shape == (2, 16) for b in batches)
    assert not np.array_equal(batches[0], batches[1])


# ------------------------------------------------------------ checkpoint ---
@pytest.fixture(scope="module")
def ref_state():
    """The reference's {"params", "opt"} of qwen3-smoke in bfloat16 with an
    optimizer state as after one step (float32 masters, nonzero moments,
    step 1)."""
    cfg, _, params = reference_weights("qwen3-0.6b", "bfloat16")
    f32 = jax.tree.map(lambda p: p.astype(jnp.float32), params)
    opt = jopt.OptState(f32, jax.tree.map(lambda p: 0.1 * p, f32),
                        jax.tree.map(lambda p: 0.01 * p * p, f32),
                        jnp.ones((), jnp.int32))
    return cfg, {"params": params, "opt": opt}


def _port_like(cfg):
    like = weight_structs(cfg)
    return {"params": like, "opt": topt.init_opt_state(like)}


def _port_of_ref(cfg, tree):
    """The reference's {"params", "opt"} in the port's layout (numpy)."""
    conv = lambda t: lm_params_from_numpy(  # noqa: E731
        cfg, jax.tree.map(np.asarray, t), device="cpu")
    opt = tree["opt"]
    return {"params": conv(tree["params"]),
            "opt": topt.OptState(conv(opt.master), conv(opt.m), conv(opt.v),
                                 int(opt.step))}


def _npz(path):
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        return dict(z)


def test_reference_checkpoint_loads_in_port_and_back(tmp_path, ref_state):
    cfg, tree_j = ref_state
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save_checkpoint(dj, 5, tree_j, extra={"data": {"step": 5,
                                                         "seed": 0}})
    got, extra = load_checkpoint(dj, 5, _port_like(cfg), device="cpu")
    assert extra == {"data": {"step": 5, "seed": 0}}
    want = _port_of_ref(cfg, tree_j)
    assert got["opt"].step == 1
    pairs = [("params", got["params"], want["params"])] + [
        (f"opt/.{f}", getattr(got["opt"], f), getattr(want["opt"], f))
        for f in ("master", "m", "v")]
    for prefix, ta, tb in pairs:
        for (name, a), (_, b) in zip(named_leaves(ta, prefix),
                                     named_leaves(tb, prefix)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name
    assert got["params"]["embed"].dtype == torch.bfloat16

    save_checkpoint(dt, 5, got, extra=extra)
    za, zb = _npz(os.path.join(dj, "step_00000005")), _npz(
        os.path.join(dt, "step_00000005"))
    assert set(za) == set(zb)
    assert "params/blocks/attn0/wq" in za and "opt/.step" in za
    assert "opt/.master/blocks/mlp0/w_down" in za
    for key in za:
        assert za[key].dtype == zb[key].dtype and za[key].shape == \
            zb[key].shape, key
        np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
    manifests = [json.load(open(os.path.join(d, "step_00000005",
                                             "manifest.json")))
                 for d in (dj, dt)]
    assert manifests[0] == manifests[1]

    back, extra_j = jckpt.load_checkpoint(dt, 5, tree_j)
    assert extra_j == extra
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree_j)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))


def test_checkpoint_atomic_and_gc(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones(3, 3)},
            "l": [{"x": torch.full((2,), float(i))} for i in range(3)]}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, tree, extra={"x": s}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert latest_step(d) == 5
    got, extra = load_checkpoint(d, 5, tree, device="cpu")
    assert extra["x"] == 5
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert torch.equal(a, b)
    assert _npz(os.path.join(d, "step_00000005"))["l/x"].shape == (3, 2)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", fail)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(d, 6, tree)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------- driver ---
def test_loss_decreases():
    out = run("smollm-360m", smoke=True, steps=30, batch=8, seq=64,
              ckpt_dir="", lr=3e-3, device="cpu")
    assert len(out["losses"]) == 30 and out["stragglers"] == 0
    assert np.isfinite(out["grad_norms"]).all()
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)


def test_checkpoint_restart_exact(tmp_path):
    d = str(tmp_path / "ck")
    kw = dict(smoke=True, steps=12, batch=4, seq=32, lr=1e-3, seed=7,
              device="cpu")
    ref = run("qwen3-0.6b", ckpt_dir="", **kw)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        run("qwen3-0.6b", ckpt_dir=d, ckpt_every=3, simulate_failure_at=7,
            **kw)
    assert latest_step(d) == 6
    resumed = run("qwen3-0.6b", ckpt_dir=d, ckpt_every=3, **kw)
    assert len(resumed["losses"]) == 6
    np.testing.assert_allclose(resumed["losses"][-3:], ref["losses"][-3:],
                               rtol=2e-4)


def test_port_resumes_from_reference_checkpoint(tmp_path):
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(smoke=True, steps=12, batch=4, seq=32, lr=1e-3, seed=7)
    ref = jrun("qwen3-0.6b", ckpt_dir=dj, ckpt_every=3, **kw)
    os.makedirs(dt)
    shutil.copytree(os.path.join(dj, "step_00000006"),
                    os.path.join(dt, "step_00000006"))
    out = run("qwen3-0.6b", ckpt_dir=dt, ckpt_every=3, device="cpu", **kw)
    assert len(out["losses"]) == 6
    np.testing.assert_allclose(out["losses"], ref["losses"][6:], rtol=5e-2)
    assert get_config("qwen3-0.6b", smoke=True).dtype == "bfloat16"


# ------------------------------------------------------------ train step ---
@pytest.fixture(scope="module")
def step_pair():
    cfg, jmodel, params = reference_weights("qwen3-0.6b", "float32")
    tmodel = port_of("qwen3-0.6b", "float32", params)
    return cfg, jmodel, params, tmodel, make_batch(cfg, seed=5)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(step_pair, n_micro):
    cfg, jmodel, params, tmodel, batch = step_pair
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup=2, total_steps=20)
    jstep = jax.jit(jmake_train_step(jmodel, PAR, opt_cfg, n_micro=n_micro))
    jp, jo, jm = jstep(params, jopt.init_opt_state(params),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(tmodel, topt.AdamWConfig(
        lr=1e-3, warmup=2, total_steps=20), n_micro=n_micro)
    ptree = trainable(tmodel)
    tp, to, tm = step(ptree, topt.init_opt_state(ptree),
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    assert to.step == int(jo.step) == 1
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    lr = float(jm["lr"])
    want, g_ref = (dict(named_leaves(lm_params_from_numpy(
        tmodel.cfg, jax.tree.map(np.asarray, t), "cpu")))
        for t in (jo.master, jo.m))
    exempt = 0
    for name, got in named_leaves(to.master):
        got, w = got.numpy(), want[name].numpy()
        g = np.abs(g_ref[name].numpy()) / (1 - opt_cfg.b1)  # the clipped g
        tiny = g <= 100 * opt_cfg.eps
        np.testing.assert_allclose(got[~tiny], w[~tiny], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        assert np.all(np.abs(got[tiny] - w[tiny]) <= 2 * lr), name
        exempt += int(tiny.sum())
    assert exempt <= 1e-2 * sum(t.numel() for t in tree_leaves(to.master))
    for got, master in zip(tree_leaves(tp), tree_leaves(to.master)):
        assert got.requires_grad and got.is_leaf
        assert torch.equal(got.detach(), master)
