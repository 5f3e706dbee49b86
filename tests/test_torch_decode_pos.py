"""The port's decode step with its position as a device tensor, and the
serving engine's static-buffer decode path, on the CPU.

`decode_step` takes `pos` as an int or as a 0-d int64 tensor (what a CUDA
graph of the step reads from its static buffer): both must give the same
logits and caches bit for bit, step after step, for the dense (qwen3) and
the ssm (rwkv6) smoke configs.  `ServeEngine(graph=True)` runs that step
over static tokens, position and cache (captured on the card, eager on the
CPU) and must serve the same tokens, from the same logits bit for bit, as
`graph=False`, which hands each prefill's cache to `decode_step` directly.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["qwen3-0.6b", "rwkv6-1.6b"]
B, S, S_MAX, STEPS = 2, 6, 16, 5


def _model(arch):
    return build_model(get_config(arch, smoke=True), seed=0, device="cpu")


def _clone(cache):
    return {"blocks": [{k: v.clone() for k, v in c.items()}
                       for c in cache["blocks"]]}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_tensor_pos_is_bitwise_the_int_pos(arch):
    model = _model(arch)
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, (B, S)))
    cache_i, lg = model.prefill(toks, S_MAX)
    cache_t = _clone(cache_i)
    pos_t = torch.zeros((), dtype=torch.long)
    nxt = lg[:, -1].argmax(-1)[:, None]
    for step in range(STEPS):
        pos_t.fill_(S + step)
        lg_i, out_i = model.decode_step(cache_i, nxt, S + step)
        lg_t, out_t = model.decode_step(cache_t, nxt, pos_t)
        assert out_i is cache_i and out_t is cache_t     # updated in place
        assert torch.equal(lg_i, lg_t), (arch, step)
        for ci, ct in zip(cache_i["blocks"], cache_t["blocks"]):
            for k in ci:
                assert torch.equal(ci[k], ct[k]), (arch, step, k)
        nxt = lg_i[:, -1].argmax(-1)[:, None]
    if cfg.family == "dense":
        k = cache_i["blocks"][0]["k"]
        assert k[:, S + STEPS - 1].abs().sum() > 0
        assert k[:, S + STEPS:].abs().sum() == 0


class _Logits(ServeEngine):
    """A ServeEngine that keeps a copy of every call's logits."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seen = []

    def _emit(self, logits):
        self.seen.append(logits[:, -1].clone())
        super()._emit(logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_static_decode_serves_like_eager(arch):
    model = _model(arch)
    runs = []
    for graph in (False, True):
        rng = np.random.default_rng(0)
        eng = _Logits(model, B=4, S_max=48, graph=graph)
        for rid in range(6):
            eng.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
                1, model.cfg.vocab, int(rng.integers(4, 16)))], max_new=6))
        done = {r.rid: r.out for r in eng.run(max_steps=48)}
        runs.append((done, eng))
    (out_e, eager), (out_g, graphed) = runs
    assert sorted(out_g) == list(range(6)) and out_g == out_e
    assert len(graphed.seen) == len(eager.seen)
    assert all(torch.equal(a, b) for a, b in zip(graphed.seen, eager.seen))
    assert graphed.cache is graphed._static["cache"]
    assert graphed.decode_call.graph is None          # nothing captured here
    assert ServeEngine(model).graph is False          # the CPU default
