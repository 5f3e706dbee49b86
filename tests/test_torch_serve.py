"""The port's serving engine (repro_torch.serve.engine) against the JAX
reference's (repro.serve.engine) on the same requests, on the CPU.

Both engines serve 8 requests (prompts of 4-15 tokens from default_rng(0))
through 4 slots with the same weights: the reference's init with N(0, 0.2)
noise on every per-layer vector (norm gains, token-shift mixing vectors,
biases; tests/test_torch_lm.py).  The random matrices keep their init
here: with them perturbed too, rwkv6's decays fall so fast that the
reference's chunkwise WKV overflows float32 over a re-prefilled context of
~20 tokens and returns NaN (ROADMAP.md, faults of the reference).  A float32
reference prefill keeps dense k/v in float32, which its own decode step
cannot update, so the reference's cache is handed on in bfloat16, as its
`init_cache` makes it.  Both engines run the same schedule of prefills, re-prefills at batch boundaries
and decode steps: it depends only on lengths, never on token values.  Every
call's logits are recorded.  For each request, the two engines must emit
the same tokens up to the first step where the reference's top-2 logit gap
is within the comparison's tolerance, where either token is a fair greedy
choice and the continuations may part: float32 2e-3 (a bfloat16 cache
entry rounded to its neighbour, tests/test_torch_lm.py), bfloat16 5e-2 of
the largest logit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.serve.engine import Request, ServeEngine

from test_torch_lm import PAR, perturbed_reference, port_of

N_REQ, SLOTS, MAX_NEW, S_MAX = 8, 4, 8, 64
# tokens compared before near ties stop the comparison, at least: of 64 in
# all, float32 compares 54-61 here, bfloat16 (whose tolerance is a few
# percent of the logits, so near ties are common over 256 tokens) 5-16
MIN_COMPARED = {"float32": 32, "bfloat16": 4}


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    out = []
    for rid in range(N_REQ):
        plen = int(rng.integers(4, 16))
        out.append(cls(rid=rid, prompt=[int(t) for t in
                                        rng.integers(1, vocab, plen)],
                       max_new=MAX_NEW))
    return out


class _Recorder:
    """Stands in for a model: forwards prefill / decode and records, per
    call, which request sits in each slot and the last-token logits."""

    def __init__(self, prefill, decode):
        self._prefill, self._decode = prefill, decode
        self.engine = None
        self.calls = []

    def _log(self, logits):
        self.calls.append(([None if r is None else r.rid
                            for r in self.engine.slots],
                           np.asarray(jnp.asarray(logits).astype(jnp.float32)
                                      if not isinstance(logits, torch.Tensor)
                                      else logits.float())[:, -1]))
        return logits

    def prefill(self, *args, **kw):
        cache, logits = self._prefill(*args, **kw)
        return cache, self._log(logits)

    def decode(self, *args):
        logits, cache = self._decode(*args)
        return self._log(logits), cache


def _bf16_kv(prefill):
    def run(*args, **kw):
        cache, logits = prefill(*args, **kw)
        return jax.tree.map(lambda a: a if a.dtype == jnp.float32 and a.ndim
                            == 5 else a.astype(jnp.bfloat16), cache), logits
    return run


def _serve_reference(cfg, jmodel, params):
    rec = _Recorder(_bf16_kv(jmodel.prefill), None)
    rec.decode_step = jmodel.decode_step       # traced by the engine's jit
    eng = JServeEngine(rec, params, B=SLOTS, S_max=S_MAX, par=PAR)
    rec._decode, rec.engine = eng._decode, eng
    eng._decode = rec.decode
    for r in _requests(JRequest, cfg.vocab):
        eng.submit(r)
    return {r.rid: r.out for r in eng.run(max_steps=S_MAX)}, rec.calls


class _PortRecorder(_Recorder):
    def __init__(self, model):
        super().__init__(model.prefill, model.decode_step)
        self.device = model.device

    def decode_step(self, *args):
        return self.decode(*args)


def _serve_port(cfg, tmodel):
    rec = _PortRecorder(tmodel)
    eng = ServeEngine(rec, B=SLOTS, S_max=S_MAX)
    rec.engine = eng
    for r in _requests(Request, cfg.vocab):
        eng.submit(r)
    return {r.rid: r.out for r in eng.run(max_steps=S_MAX)}, rec.calls


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_serves_like_the_reference(arch, dtype):
    cfg, jmodel, params = perturbed_reference(arch, dtype, vectors_only=True)
    tmodel = port_of(arch, dtype, params)
    out_r, calls_r = _serve_reference(cfg, jmodel, params)
    out_t, calls_t = _serve_port(cfg, tmodel)
    assert sorted(out_r) == sorted(out_t) == list(range(N_REQ))
    assert all(len(out_t[i]) == len(out_r[i]) == MAX_NEW for i in out_r)
    assert [c[0] for c in calls_r] == [c[0] for c in calls_t]  # one schedule

    tol = 2e-3 if dtype == "float32" else 5e-2 * max(
        np.abs(c[1]).max() for c in calls_r)
    open_ = set(range(N_REQ))              # requests still being compared
    compared = 0
    for (slots, lg_r), (_, lg_t) in zip(calls_r, calls_t):
        for i, rid in enumerate(slots):
            if rid not in open_:
                continue
            top2 = np.sort(lg_r[i])[-2:]
            if top2[1] - top2[0] <= tol:   # a near tie: stop comparing rid
                open_.discard(rid)
                continue
            assert int(lg_t[i].argmax()) == int(lg_r[i].argmax()), \
                (arch, dtype, rid)
            compared += 1
    for rid in open_:                      # compared to the end: identical
        assert out_t[rid] == out_r[rid], (arch, dtype, rid)
    assert compared >= MIN_COMPARED[dtype], compared


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                       "--requests", "5", "--slots", "2", "--max-new", "3",
                       "--s-max", "32"])
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out) == 3 for r in done)
    assert "served 5 requests, 15 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma3-12b", "dbrx-132b"])
def test_static_buffer_step_serves_like_the_eager_step(arch):
    """`graph=True` on the CPU runs the decode step eagerly over the static
    tokens, position and cache that a CUDA graph replays on the card:
    gemma3's ring caches (a 5 : 1 superblock, decoded past its window of
    16) and dbrx's MoE sublayers must serve the same tokens as `graph=
    False`, which decodes on each prefill's own cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, seed=0, device="cpu")
    outs = []
    for graph in (False, True):
        eng = ServeEngine(model, B=SLOTS, S_max=S_MAX, graph=graph)
        for r in _requests(Request, cfg.vocab):
            r.max_new = 12
            eng.submit(r)
        outs.append({r.rid: r.out for r in eng.run(max_steps=S_MAX)})
    assert eng._static is not None and eng.decode_call.graph is None
    assert sorted(outs[1]) == list(range(N_REQ)) and outs[0] == outs[1]
    assert max(len(r.prompt) for r in _requests(Request, cfg.vocab)) + 12 \
        > (cfg.sliding_window or 0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_dropped_graphed_engine_is_freed_without_the_collector(arch):
    """A `ServeEngine(graph=True)` whose decode step has been built (after
    a prefill and one step) is freed as soon as it is dropped, with the
    cyclic collector off: its captured call closes over the model, `par`
    and the static buffers, never over the engine, so on the card the
    graph's pool goes with the engine."""
    import gc
    import weakref
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, seed=0, device="cpu")
    collecting = gc.isenabled()
    gc.disable()
    try:
        eng = ServeEngine(model, B=2, S_max=S_MAX, graph=True)
        eng.submit(Request(rid=0, prompt=[3, 5, 7], max_new=4))
        assert eng._admit_and_prefill()
        eng.step()
        assert eng.decode_call is not None
        refs = (weakref.ref(eng), weakref.ref(eng.decode_call),
                weakref.ref(eng._static["tokens"]))
        del eng
        assert [r() for r in refs] == [None, None, None]
    finally:
        if collecting:
            gc.enable()
