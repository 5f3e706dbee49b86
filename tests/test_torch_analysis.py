"""The port's analysis tier (`repro_torch.analysis.{hlo, hlo_walk, roofline,
report}`) against the JAX reference's, on the CPU.

The walker: exact dot FLOPs on the reference's 7-trip (256, 512) @ (512,
512) loop, run as one rank's shard of a (2, 4) mesh; what it counts for
views, in-place and indexed writes, allocations and frees, autograd's saved
tensors, a stacked scope and its backward; K4's and K5's meta stand-ins
against the formulas of their bounds; `rms_norm` on meta taken the card's
way.  The communicators' records: the pod classification against the
reference's `_crosses_pod` on the replica-group strings of the same mesh
axes, and a smoke MoE decode step on a stacked (pod 2, data 2, model 2)
meta mesh against the collectives' own byte formulas, split into intra-
and inter-pod.  The roofline with the reference's v5e constants, the
dry-run and roofline tables and the observability section against the
reference's functions on the same artifacts and the same report dict; the
reference's `report` reads port artifacts.
"""
import json
import math

import pytest
import torch

from repro_torch.analysis import hlo, hlo_walk, report, roofline
from repro_torch.obs import cost
from repro_torch.configs import get_config
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import rwkv as krwkv
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat, parallelism_for
from repro_torch.models import decode as decode_mod
from repro_torch.models.moe import _capacity
from repro_torch.models.registry import Model, weight_structs
from repro_torch.models import transformer as tf
from repro_torch.models.params import tree_leaves
from repro_torch.models.tp import model_shardings, shard_model
from repro_torch.models.transformer import padded_vocab


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_walker_exact_on_seven_trip_loop():
    """The reference's module, as one rank of a (2, 4) ('data', 'model')
    mesh runs it: its (128, 512) shard of the carry times its (512, 128)
    shard of w, all-gathered back over 'model', 7 trips: exactly 2 * 128 *
    512 * 128 * 7 dot FLOPs a rank (the 8 ranks stacked in one scope), and
    7 all-gathers of one rank's (128, 512) float32 result."""
    mesh = make_mesh_compat((2, 4), ("data", "model"), "meta")
    a, w = meta(8, 128, 512), meta(8, 512, 128)
    with hlo_walk.Walker() as walk:
        with cost.stacked(8):
            c = a
            for _ in range(7):
                c = mesh.all_gather(torch.bmm(c, w), "model", dim=1,
                                    tiled=True)
            c.sum()
    res = walk.result()
    assert res["dot_flops"] == 2 * 128 * 512 * 128 * 7
    assert res["collective_bytes"] == {"all-gather": 7 * 128 * 512 * 4}
    assert res["collective_counts"] == {"all-gather": 7}
    assert res["port"]["stacked"]["dot_flops"] == 8 * res["dot_flops"]
    assert res["intra_pod_bytes"] == res["total_collective_bytes"]
    assert hlo.collective_bytes(walk.records) == {
        "bytes": {"all-gather": 7 * 128 * 512 * 4},
        "counts": {"all-gather": 7}, "total_bytes": 7 * 128 * 512 * 4}


def test_walker_counts_writes_views_and_products():
    x, y = meta(4, 8), meta(8, 16)
    idx = torch.empty(3, dtype=torch.long, device="meta")
    src = meta(3, 16)
    p, r = meta(2, 4, 8), meta(2, 8, 4)
    with hlo_walk.Walker() as w:
        z = x @ y                                  # writes 4 * 16 floats
        z.view(16, 4).t()                          # views: nothing
        z.add_(1.0)                                # writes z again
        buf = torch.empty(10, 16, device="meta")   # an allocation only
        buf.index_copy_(0, idx, src)               # writes its source
        torch.einsum("bij,bjk->bik", p, r)         # one bmm
    res = w.result()
    assert res["dot_flops"] == 2 * 4 * 16 * 8 + 2 * 2 * 4 * 4 * 8
    assert res["result_bytes"] == 4 * (64 + 64 + 48 + 32)
    # what the writing ops read: x and y, z, buf + idx + src, p and r
    assert res["port"]["read_bytes"] == 4 * (32 + 128) + 256 + (
        640 + 3 * 8 + 192) + 4 * (64 + 64)


def test_walker_peak_follows_storage_lifetimes():
    a = meta(1024)                     # 4 KiB, tracked as an argument
    with hlo_walk.Walker() as w:
        held = w.track({"a": a})
        b = a * 2                      # +4 KiB
        views = [b[:10], b.view(32, 32)]
        del b                          # the views keep it
        c = views[0] + 1               # +512 B (one block)
        del views                      # b goes with its last view
        assert w.live_raw == 4096 + 512
        del c
        assert w.live_raw == 4096
        d = meta(10, grad=True)        # +512
        e = d.exp()                    # +512, saved for backward
        f = e.sum()                    # +512
        del e
        assert w.live_raw == 4096 + 3 * 512    # autograd still holds e
        f.backward()
    assert held == 4096
    assert w.peak_raw == 4096 + 4096 + 512
    assert w.result()["port"]["peak_bytes"] == w.peak_raw


def test_stacked_scope_counts_per_rank_with_its_backward():
    """Forward work in a scope of 4 stacked ranks counts 1/4 per rank, and
    so does the backward of the nodes made there (its accumulation too);
    what runs outside counts whole."""
    x = meta(4, 8, 8, grad=True)
    wt = meta(8, 8, grad=True)
    with hlo_walk.Walker() as w:
        h = torch.matmul(x.reshape(32, 8), wt)            # outside: whole
        with cost.stacked(4):
            y = torch.bmm(h.reshape(4, 8, 8), h.reshape(4, 8, 8))
            s = y.sum()
        g = torch.autograd.grad(s * 2, [x, wt])
    res = w.result()
    flops_mm, flops_bmm = 2 * 32 * 8 * 8, 2 * 4 * 8 * 8 * 8
    # forward: mm whole, bmm / 4; backward: bmm's two bmm / 4 each, mm's two
    # products whole
    assert res["dot_flops"] == flops_mm + flops_bmm / 4 + 2 * flops_bmm / 4 \
        + 2 * flops_mm
    assert res["port"]["stacked"]["dot_flops"] == 3 * flops_mm + 3 * flops_bmm
    assert res["port"]["stacked"]["ranks"] == [4]
    assert all(t.shape == u.shape for t, u in zip(g, (x, wt)))


@pytest.mark.parametrize("case", ["causal", "window", "unmasked", "d256",
                                  "backward"])
def test_k4_meta_report(case):
    B, H, Hkv, S, D = 2, 8, 2, 300, 64
    Sk, causal, window = S, True, None
    if case == "window":
        window = 100
    if case == "unmasked":
        Sk, causal = 500, False
    if case == "d256":
        D = 256
    bf = torch.bfloat16
    grad = case == "backward"
    q = meta(B, H, S, D, dtype=bf, grad=grad)
    k, v = (meta(B, Hkv, Sk, D, dtype=bf, grad=grad) for _ in range(2))
    n0 = kattn.launches
    with hlo_walk.Walker() as w:
        o = kattn.flash_attention(q, k, v, causal=causal, window=window)
        if grad:
            torch.autograd.grad(o, [q, k, v], meta(*o.shape, dtype=bf))
    assert kattn.launches == n0          # meta launches nothing
    assert o.shape == q.shape and o.dtype == bf and o.device.type == "meta"
    kern = w.result()["port"]["kernels"]["K4"]
    pairs = kattn.admitted_pairs(S, Sk, causal, window)
    assert kern == {"launches": 1, "operations": 4.0 * D * pairs * B * H,
                    "bytes": 2.0 * (2 * B * H * S * D + 2 * B * Hkv * Sk * D)}
    ref_dots = 4.0 * B * H * S * Sk * D
    res = w.result()
    if not grad:
        assert res["dot_flops"] == ref_dots
        assert res["port"]["dot_flops_card"] == kern["operations"]
    else:   # the backward kernel in closed form: 7 products of 2 D
        # operations an admitted pair; the reference's backward dots, the
        # adjoints of its two products, twice the forward's
        bwd = res["port"]["kernels"]["K4.bwd"]
        assert bwd["launches"] == 1
        assert bwd["operations"] == 14.0 * D * pairs * B * H
        assert res["dot_flops"] == ref_dots + 2 * ref_dots
        assert res["port"]["dot_flops_card"] == kern["operations"] \
            + bwd["operations"]
    if causal:      # the card computes only the admitted pairs
        assert res["port"]["dot_flops_card"] < res["dot_flops"]
    with pytest.raises(ValueError, match="head dim"):
        kattn.flash_attention(meta(1, 2, 8, 16, dtype=bf),
                              meta(1, 2, 8, 16, dtype=bf),
                              meta(1, 2, 8, 16, dtype=bf))


@pytest.mark.parametrize("grad", [False, True])
def test_k5_meta_report(grad):
    BH, C, D = 6, 200, 64
    bf = torch.bfloat16
    r, k, v = (meta(BH, C, D, dtype=bf, grad=grad) for _ in range(3))
    wd = meta(BH, C, D, grad=grad)
    u, s0 = meta(BH, D, grad=grad), meta(BH, D, D, grad=grad)
    n0, nb0 = krwkv.launches, krwkv.backward_launches
    with hlo_walk.Walker() as w:
        y, s1 = krwkv.wkv_chunk(r, k, v, wd, u, s0)
        if grad:
            g = torch.autograd.grad((y, s1), [r, k, v, wd, u, s0],
                                    (meta(BH, C, D, dtype=bf),
                                     meta(BH, D, D)))
    assert (krwkv.launches, krwkv.backward_launches) == (n0, nb0)
    assert (y.shape, y.dtype, s1.shape, s1.dtype) == (
        (BH, C, D), bf, (BH, D, D), torch.float32)
    kern = w.result()["port"]["kernels"]["K5"]
    assert kern == {"launches": 1, "operations": 5.0 * BH * C * D * D,
                    "bytes": BH * C * D * (3 * 2 + 4 + 2) + 8.0 * BH * D * D}
    c = min(64, C)
    ref_dots = BH * C * (4.0 * D * D + 4.0 * c * D + 2 * D)
    if not grad:
        assert w.result()["dot_flops"] == ref_dots
        assert w.result()["port"]["dot_flops_card"] == kern["operations"]
        assert "K5.bwd" not in w.result()["port"]["kernels"]
    else:   # the backward kernel in closed form: 17 operations a (token,
        # head, i, j), r k v dy dr dk dv in bf16 and w dw in float32 once
        # each, the state, its gradient and dstate0 once; twice the
        # reference's dots (the adjoint of each product)
        bwd = w.result()["port"]["kernels"]["K5.bwd"]
        assert bwd == {"launches": 1, "operations": 17.0 * BH * C * D * D,
                       "bytes": BH * C * D * (7 * 2 + 2 * 4)
                       + 3 * 4.0 * BH * D * D}
        assert w.result()["dot_flops"] == 3 * ref_dots
        assert w.result()["port"]["dot_flops_card"] == kern["operations"] \
            + bwd["operations"]
        assert [(t.shape, t.dtype) for t in g] == [
            (x.shape, x.dtype) for x in (r, k, v, wd, u, s0)]


def test_k5_meta_backward_runs_no_token_loop(monkeypatch):
    """On meta the backward allocates its outputs and scratch and reports
    its launch: the plain `wkv_bwd` (two token loops) is never reached,
    here at rwkv6-1.6b's train_4k length, and the walker's peak holds the
    backward's scratch: the states every stage of TB tokens, dy . v and
    sum r u k a token padded to whole stages, and the row blocks' shares of
    dv."""
    def refuse(*a, **kw):
        raise AssertionError("wkv_bwd reached on meta")

    monkeypatch.setattr(krwkv, "wkv_bwd", refuse)
    BH, C, D = 8, 4096, 64
    bf = torch.bfloat16
    r, k, v = (meta(BH, C, D, dtype=bf, grad=True) for _ in range(3))
    wd = meta(BH, C, D, grad=True)
    u, s0 = meta(BH, D, grad=True), meta(BH, D, D, grad=True)
    with hlo_walk.Walker() as w:
        held = w.track([r, k, v, wd, u, s0])
        y, s1 = krwkv.wkv_chunk(r, k, v, wd, u, s0)
        torch.autograd.grad((y, s1), [r, k, v, wd, u, s0],
                            (meta(BH, C, D, dtype=bf), meta(BH, D, D)))
    assert w.result()["port"]["kernels"]["K5.bwd"]["launches"] == 1
    params = krwkv.wkv_bwd_launch_params(BH, C, D)
    nrb, nb, cp = krwkv._bwd_blocks(C, D, params)
    assert (nb, cp) == (C // params[3], C)
    scratch = 4 * BH * (nb * D * D + 2 * cp + nrb * C * D)
    grads = BH * C * D * (3 * 2 + 4) + 4 * BH * (D + D * D)
    assert w.peak_raw - held >= scratch + grads


@pytest.mark.parametrize("D", krwkv.HEAD_DIMS)
def test_k5_backward_launch_shapes(D):
    """Every launch `wkv_bwd_launch_params` chooses: whole rows of JL
    columns a lane within a warp, D rows cut into whole blocks (at most 8 a
    head), the folded sums and the staged tokens powers of two, the block's
    shared memory within the card's 227 KB, and the stages and padded
    tokens the launch's scratch takes."""
    for BH in (1, 16, 32, 33, 64, 128, 512):
        for C in (1, 77, 300, 513):
            JL, A, NW, TB = params = krwkv.wkv_bwd_launch_params(BH, C, D)
            lanes = D // JL
            assert JL in (2, 4) and lanes <= 32 and 32 % lanes == 0
            rows, nrb, threads = krwkv._bwd_shape(D, params)
            assert rows == NW * (32 // lanes) * A and D % rows == 0
            assert nrb == D // rows <= 8 and threads == 32 * NW
            n = TB * A
            assert n & (n - 1) == 0 and TB & (TB - 1) == 0 and TB >= 4
            for nbyte in (2, 4):
                assert rows * nbyte % 16 == 0
                assert krwkv._bwd_smem(D, params, nbyte) <= 227 * 1024
            nb = -(-C // TB)
            assert krwkv._bwd_blocks(C, D, params) == (nrb, nb, nb * TB)
    with pytest.raises(ValueError, match="head dim"):
        krwkv.wkv_bwd_launch_params(4, 10, 48)


def test_k5_backward_launch_params_fill_the_card():
    """At rwkv6's head dim, each BH the main path gives the backward (128 at
    batch 4, 64 at batch 2, 32 on one of 2 data ranks, 16 on one of 4 model
    ranks) puts at least 4 warps an SM of the H100's 132 to work, and its
    blocks fit one wave at 2 an SM: the registers its launch bounds allow a
    thread (255, or 128 for 256 threads) fit two blocks in an SM's 65,536
    and its shared memory fits twice in 228 KB (1 KB a block reserved).  BH
    128 takes 4 rows a lane, 256 blocks, where 2 rows would take 512
    blocks, two waves."""
    sms, D = 132, 64
    for BH in (128, 64, 32, 16):
        params = krwkv.wkv_bwd_launch_params(BH, 512, D)
        _, nrb, threads = krwkv._bwd_shape(D, params)
        assert BH * nrb * threads / 32 / sms >= 4, (BH, params)
        regs = min(255, 65536 // (threads * krwkv._bwd_min_blocks(D, params)))
        assert 2 * threads * regs <= 65536, (BH, params)
        smem = max(krwkv._bwd_smem(D, params, n) for n in (2, 4))
        assert 2 * (smem + 1024) <= 228 * 1024
        assert BH * nrb <= 2 * sms, (BH, params)
    two_rows = krwkv.wkv_bwd_launch_params(64, 512, D)
    assert two_rows[1] == 2
    assert 128 * krwkv._bwd_shape(D, two_rows)[1] > 2 * sms


def test_rms_norm_on_meta_is_counted_as_the_card_dispatches_it():
    """CUDA's composite `rms_norm` calls `_fused_rms_norm`: its output and
    a float32 rstd a row; its backward writes the input's gradient."""
    x = meta(6, 10, grad=True)
    with hlo_walk.Walker() as w:
        y = torch.nn.functional.rms_norm(x, (10,), eps=1e-5)
        fwd = w.raw.result_bytes
        torch.autograd.grad(y, [x], meta(6, 10))
    assert y.shape == x.shape and y.device.type == "meta"
    assert fwd == 6 * 10 * 4 + 6 * 4
    assert w.raw.result_bytes - fwd == 6 * 10 * 4
    cpu = torch.nn.functional.rms_norm(torch.ones(2, 4), (4,))
    assert torch.equal(cpu, torch.ones(2, 4) / math.sqrt(1 + 1.1920929e-07))


MESH = ((2, 16, 16), ("pod", "data", "model"))
AXES = ["pod", "data", "model", ("pod", "data"), ("data", "model"),
        ("pod", "model"), None]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_pod_classification_matches_reference(multi_pod):
    from repro.analysis.hlo_walk import _crosses_pod
    shape, axes = MESH if multi_pod else ((16, 16), ("data", "model"))
    mesh = make_mesh_compat(shape, axes, "meta")
    for ax in AXES:
        if ax is not None and any(a not in axes for a in (
                (ax,) if isinstance(ax, str) else ax)):
            continue
        names = () if ax is None else (ax,) if isinstance(ax, str) else ax
        if ax is None:
            groups = [list(range(mesh.n_ranks))]
        else:
            groups = [mesh.group_ranks(r, ax) for r in range(mesh.n_ranks)
                      if mesh.group_ranks(r, ax)[0] == r]
        explicit = "all-reduce(%x), replica_groups={" + ",".join(
            "{" + ",".join(map(str, g)) + "}" for g in groups) + "}"
        want = _crosses_pod(explicit, 256)
        if ax is not None:
            ks = [axes.index(a) for a in names]
            perm = [i for i in range(len(axes)) if i not in ks] + ks
            iota = (f"all-reduce(%x), replica_groups=[{len(groups)},"
                    f"{len(groups[0])}]<={list(shape)}T"
                    f"({','.join(map(str, perm))})").replace(" ", "")
            assert _crosses_pod(iota, 256) == want, iota
        assert hlo_walk.crosses_pod(mesh, ax) == want, ax
        assert want == (multi_pod and (ax is None or "pod" in names))


def test_moe_collectives_match_their_formulas():
    """dbrx-smoke's decode step (batch 8) on a stacked (pod 2, data 2,
    model 2) meta mesh under the reference's `Parallelism`, on the weight
    blocks of the model axis: the embedding's and every attention
    sublayer's all-reduce over 'model' (one rank's (B_l, 1, D) bfloat16
    residual), per MoE sublayer the dispatch and return all-to-alls over
    'model' (n_model * E_loc * C rows of D a rank) and the aux loss's
    means over 'pod' and 'data' (one float32 a rank; the 'pod' one crosses
    pods), and the logits' all-gather over 'model' (B_l x the padded
    vocabulary a rank); FSDP: the leaves with a 'data' entry held cut over
    'data', each superblock's cuts all-gathered at its entry as one flat
    buffer, the embedding's and the head's where they are read (a rank's
    result: every member's cuts)."""
    cfg = get_config("dbrx-132b", smoke=True)
    mesh = make_mesh_compat((2, 2, 2), ("pod", "data", "model"), "meta")
    par = parallelism_for(mesh)
    B, S_max = 8, 32
    model = Model(cfg, shard_model(weight_structs(cfg), cfg, mesh))
    cache = decode_mod.init_cache(cfg, B, S_max, "meta", par)
    tokens = torch.empty(B, 1, dtype=torch.int32, device="meta")
    pos = torch.full((), 5, dtype=torch.long, device="meta")
    with hlo_walk.Walker() as w, torch.no_grad():
        model.decode_step(cache, tokens, pos, par=par)
    E, D, n_model, n_dp = cfg.n_experts, cfg.d_model, 2, 4
    E_loc, B_l = E // n_model, B // n_dp
    C = _capacity(B_l, cfg)
    a2a = n_model * E_loc * C * D * 2
    h = B_l * D * 2
    layers = cfg.n_layers
    defs = tf.model_defs(cfg)
    sh = model_shardings(defs, cfg, mesh)

    def gathered(d, s):
        return 2 * s.n_cut * math.prod(s.block_shape(d.shape)) \
            if s.cut_axes else 0
    fsdp = sum(gathered(d, s) for d, s in zip(tree_leaves(defs),
                                              tree_leaves(sh)))
    assert not cfg.tie_embeddings
    want = {"all-reduce": h + layers * (h + 2 * 4),
            "all-to-all": layers * 2 * a2a,
            "all-gather": B_l * padded_vocab(cfg) * 2 + fsdp}
    res = w.result()
    assert res["collective_bytes"] == want
    assert res["collective_counts"] == {"all-reduce": 1 + 3 * layers,
                                        "all-to-all": 2 * layers,
                                        "all-gather": 1 + layers + 2}
    assert res["inter_pod_bytes"] == layers * 4
    assert res["intra_pod_bytes"] == sum(want.values()) - layers * 4
    assert hlo.collective_bytes(w.records)["total_bytes"] == sum(
        want.values())
    # the walker gone, the communicator records nothing
    assert cost.ACTIVE is None
    mesh.psum(torch.ones(8, 2), "pod")


# ------------------------------------------------------- roofline, report --
@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Port artifacts of a few quick cells (both layouts), a skipped and a
    failed one, in a directory as `launch.dryrun.main` writes them."""
    d = tmp_path_factory.mktemp("artifacts")
    for arch, shape, pod in (("qwen3-0.6b", "prefill_32k", False),
                             ("qwen3-0.6b", "decode_32k", False),
                             ("qwen3-0.6b", "decode_32k", True),
                             ("rwkv6-1.6b", "decode_32k", False),
                             ("rwkv6-1.6b", "long_500k", False),
                             ("smollm-360m", "long_500k", False)):
        res, _ = dryrun.lower_cell(arch, shape, pod)
        dryrun.save_artifact(str(d / f"{arch}__{shape}__"
                                 f"{'2pod' if pod else '1pod'}.json"), res)
    (d / "phi4-mini-3.8b__decode_32k__1pod.json").write_text(json.dumps(
        {"arch": "phi4-mini-3.8b", "shape": "decode_32k",
         "multi_pod": False, "error": "RuntimeError: planted"}))
    return d


def test_artifact_has_every_reference_key(artifacts):
    rec = json.loads((artifacts / "qwen3-0.6b__decode_32k__1pod.json")
                     .read_text())
    ref_keys = {"arch", "shape", "multi_pod", "hierarchical", "mesh", "axes",
                "lower_s", "compile_s", "flops", "bytes_accessed", "memory",
                "collectives", "walked", "params", "active_params"}
    assert ref_keys <= set(rec)
    assert set(rec["walked"]) == {
        "collective_bytes", "collective_counts", "total_collective_bytes",
        "inter_pod_bytes", "intra_pod_bytes", "dot_flops", "result_bytes"}
    assert rec["memory"]["generated_code_size_in_bytes"] == 0
    assert rec["port"]["rank_batch"] == 8 and rec["port"]["fits_80gb"]


def test_roofline_with_v5e_constants_matches_reference(artifacts):
    from repro.analysis import roofline as jroofline
    recs = [r for r in roofline.load_artifacts(str(artifacts))
            if "skipped" not in r and "error" not in r]
    assert len(recs) == 5
    assert roofline.V5E.peak_flops == jroofline.PEAK_FLOPS
    assert roofline.V5E.hbm_bw == jroofline.HBM_BW
    assert (roofline.V5E.link_bw, roofline.V5E.n_links) == (
        jroofline.LINK_BW, jroofline.N_LINKS)
    for r in recs:
        for walked in (r["walked"], None):
            got = roofline.roofline_from_artifact(r, walked,
                                                  chip=roofline.V5E)
            assert got == jroofline.roofline_from_artifact(r, walked)
        h = roofline.roofline_from_artifact(r, r["walked"])
        assert h["compute_s"] == r["port"]["dot_flops_card"] / 989e12
        assert roofline.roofline_from_artifact(r, None)["compute_s"] == \
            h["compute_s"]
        assert h["memory_s"] == 2 * r["walked"]["result_bytes"] / 3.35e12
        assert roofline.model_flops_per_step(r) == \
            jroofline.model_flops_per_step(r)


def test_report_tables_match_reference(artifacts):
    from repro.analysis import report as jreport
    recs, jrecs = report.load(str(artifacts)), jreport.load(str(artifacts))
    assert recs == jrecs and len(recs) == 7
    for pod in ("1pod", "2pod"):
        assert report.dryrun_table(recs, pod) == jreport.dryrun_table(
            jrecs, pod)
    got = report.roofline_table(recs, chip=roofline.V5E).splitlines()
    want = jreport.roofline_table(jrecs).splitlines()
    assert len(got) == len(want) == 2 + 4
    for g, w in zip(got[2:], want[2:]):        # all but the advice column
        assert g.split(" | ")[:-1] == w.split(" | ")[:-1]
    assert got[:2] == want[:2]
    mine = report.roofline_table(recs)
    assert "VMEM" not in mine and "MXU" not in mine


def test_reference_report_reads_port_artifacts(artifacts, capsys):
    import sys
    from repro.analysis import report as jreport
    argv = sys.argv
    sys.argv = ["report", "--artifacts", str(artifacts)]
    try:
        jreport.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "qwen3-0.6b | decode_32k | ok" in out
    report.main(["--artifacts", str(artifacts)])
    mine = capsys.readouterr().out
    assert "256 ranks" in mine and "512 ranks" in mine and "chips" not in mine


def test_observability_section_matches_reference():
    import numpy as np
    from repro.analysis import report as jreport
    from repro_torch import obs
    from repro_torch.core.api import FMMSession, PartitionSpec
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (300, 3))
    q = rng.uniform(-1, 1, 300)
    obs.configure(enabled=True)
    try:
        sess = FMMSession.from_points(x, q, PartitionSpec(nparts=2, ncrit=32),
                                      device="cpu")
        sess.evaluate()
        rep = json.loads(json.dumps(sess.report(), default=str))
    finally:
        obs.configure(enabled=False)
        obs.reset()
    got = report.observability_section(rep)
    assert got == jreport.observability_section(rep)
    assert "| span |" in got
