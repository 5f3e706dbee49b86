"""The launch parameters of K4's bfloat16 backward
(`repro_torch.kernels.attention.attention_bwd_launch_params`), on the CPU.

A GQA group's query heads are cut into `parts` runs of consecutive heads
(`group_parts`), one dK / dV block a run and 64-key tile: every head falls
in exactly one run, in order, and the runs differ by at most one head.
`parts` is 1 where the dK / dV grid of whole groups already fills the
card's slots (two blocks on each of its 132 SMs up to head size 128, one at
256); below that, the least count whose heaviest block walks no more query
steps than the grid's steps over 132 SMs, at most the group.  A block's
steps (the query tiles that see a key of its tile) are counted against a
brute-force count over the mask.  The training shapes of
`chip_smoke.K4_GRAD_CASES` and the card tests' shapes (two kv heads of
groups 1, 2, 3, 8; Sq 200, Sk 200 or 333) get the parts written in the
source note of csrc/attention_bwd.cu, and every shape gets the tiles the
kernel is built for (tc::Tiles, read from the source).
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import hlo_walk
from repro_torch.kernels import attention as kattn

CSRC = (Path(kattn.__file__).resolve().parent / "csrc" / "attention_bwd.cu")


@pytest.mark.parametrize("G", [1, 2, 3, 5, 8, 16])
def test_group_parts_cover_every_head_once_in_order(G):
    for parts in range(1, G + 1):
        runs = kattn.group_parts(G, parts)
        assert len(runs) == parts
        assert [h for run in runs for h in run] == list(range(G))
        sizes = [len(run) for run in runs]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


# (B, H, Hkv, Sq, Sk, D, causal, window) -> parts
TRAINING = {
    "smollm-360m": ((4, 15, 5, 512, 512, 64, True, None), 2),
    "qwen3-0.6b": ((4, 16, 8, 512, 512, 128, True, None), 1),
    "gemma3-12b local": ((1, 16, 8, 2048, 2048, 256, True, 1024), 1),
    "llama-3.2-vision-90b cross": ((1, 64, 8, 512, 1600, 128, False, None),
                                   1),
    "smollm-360m train_4k rank": ((2, 3, 1, 4096, 4096, 64, True, None), 3),
}


@pytest.mark.parametrize("case", list(TRAINING))
def test_training_shapes_get_the_noted_parts(case):
    """... and dQ's 128-key steps at the train_4k rank's 4,096 keys alone."""
    shape, parts = TRAINING[case]
    bkd = 128 if case.endswith("train_4k rank") else 64
    assert kattn.attention_bwd_launch_params(*shape) == (parts, 64, bkd)


@pytest.mark.parametrize("group", [1, 2, 3, 8])
@pytest.mark.parametrize("mask", ["causal", "window", "unmasked"])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_card_test_shapes_take_the_whole_group(D, mask, group):
    """16 to 24 dK / dV blocks a group, far from filling the card, whose
    heaviest block walks 4 query steps a head against a mean load of 0.3 to
    5.8: every head of the group is a part of its own."""
    Sk = 333 if mask == "unmasked" else 200
    got = kattn.attention_bwd_launch_params(
        2, 2 * group, 2, 200, Sk, D, mask != "unmasked",
        64 if mask == "window" else None)
    assert got == (group, 64, 64)


def _steps(Sq, Sk, bq, causal, window):
    """Query tiles of bq rows with a live pair in each 64-key tile, by
    brute force over the mask."""
    live = kattn._mask(Sq, Sk, causal, window, "cpu")
    return [sum(bool(live[q0:q0 + bq, k0:k0 + 64].any())
                for q0 in range(0, Sq, bq)) for k0 in range(0, Sk, 64)]


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (200, 200, True, None), (512, 512, True, None), (700, 700, True, 100),
    (300, 300, False, 70), (200, 333, False, None), (640, 640, True, 1000)])
def test_query_steps_match_the_mask(Sq, Sk, causal, window):
    assert kattn._bwd_query_steps(Sq, Sk, 64, causal, window) == _steps(
        Sq, Sk, 64, causal, window)


@pytest.mark.parametrize("D", kattn.HEAD_DIMS)
def test_one_part_where_the_grid_fills_the_card(D):
    resident = 1 if D == 256 else 2
    # B Hkv key tiles of 64 at or past 132 x resident blocks
    for B, Hkv, S in [(1, 8, 64 * 33 * resident), (4, 8, 4096),
                      (2, 66 * resident, 64), (8, 16, 2048)]:
        assert B * Hkv * -(-S // 64) >= 132 * resident
        assert kattn.attention_bwd_launch_params(
            B, 4 * Hkv, Hkv, S, S, D, True, None)[0] == 1


@pytest.mark.parametrize("D", kattn.HEAD_DIMS)
def test_parts_grow_only_until_the_heaviest_block_meets_the_mean(D):
    """Below the card's slots: the least parts whose heaviest block (its
    run of ceil(G / parts) heads, each the most query steps of a key tile)
    walks no more steps than the grid's over 132 SMs, else the group."""
    slots = 132 * (1 if D == 256 else 2)
    for B, H, Hkv, S, causal in [
            (1, 32, 2, 1024, True), (2, 12, 4, 512, True),
            (1, 64, 8, 256, False), (1, 40, 1, 2048, True),
            (3, 9, 3, 700, True), (2, 24, 1, 4096, True),
            (1, 16, 2, 3000, False)]:
        steps = _steps(S, S, 64, causal, None)
        assert B * Hkv * len(steps) < slots
        load = B * H * sum(steps) / 132
        G = H // Hkv
        parts = kattn.attention_bwd_launch_params(B, H, Hkv, S, S, D,
                                                  causal, None)[0]
        assert 1 <= parts <= G
        assert parts == G or -(-G // parts) * max(steps) <= load
        assert parts == 1 or -(-G // (parts - 1)) * max(steps) > load


def test_tiles_are_those_the_kernel_is_built_for():
    """dK / dV steps of kBQ query rows; dQ steps of kBKd keys, kBKdLong (128
    up to head size 64) from 2,048 keys on."""
    src = CSRC.read_text()
    tiles = src[src.index("struct Tiles {"):]
    tiles = tiles[:tiles.index("};")]
    bq = int(re.search(r"kBQ = (\d+);", tiles)[1])
    bkd = int(re.search(r"kBKd = (\d+);", tiles)[1])
    long = re.search(r"kBKdLong = D <= (\d+) \? (\d+) : (\d+);", tiles)
    assert set(kattn.BWD_TILES) == set(kattn.HEAD_DIMS)
    for D in kattn.HEAD_DIMS:
        built = (bkd, int(long[2])) if D <= int(long[1]) else (bkd,)
        assert kattn.BWD_TILES[D] == (bq, built)
        for Sk, want in ((100, bkd), (2047, bkd), (2048, built[-1])):
            assert kattn.attention_bwd_launch_params(
                1, 2, 1, Sk, Sk, D, True, None)[1:] == (bq, want)
    with pytest.raises(ValueError, match="head dim"):
        kattn.attention_bwd_launch_params(1, 2, 1, 100, 100, 48, True, None)


@pytest.mark.parametrize("params", [(0, 64, 64), (4, 64, 64), (1, 32, 64),
                                    (1, 64, 32), (1, 64, 256)])
def test_wrapper_refuses_a_launch_it_is_not_built_for(params):
    """A group of 3 heads at head size 64: parts outside 1..3 or other
    tiles are refused on meta, before any allocation, naming the launch."""
    q, o, do = (torch.empty(2, 6, 100, 64, dtype=torch.bfloat16,
                            device="meta") for _ in range(3))
    k, v = (torch.empty(2, 2, 100, 64, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    stats = torch.empty(2, 2, 6, 100, device="meta")
    before = kattn.backward_launches
    with pytest.raises(ValueError, match="not built"):
        kattn._launch_bwd(q, k, v, o, do, stats, True, None, params=params)
    assert kattn.backward_launches == before


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_meta_allocates_the_group_scratch_of_its_parts(parts):
    """On meta the launch allocates what the card's does: the group scratch
    (parts, 2, B, Hkv, Sk, D) float32 only for parts > 1, and reports its
    bytes written and read once."""
    B, H, Hkv, S, D = 2, 6, 2, 256, 64
    q, o, do = (torch.empty(B, H, S, D, dtype=torch.bfloat16,
                            device="meta") for _ in range(3))
    k, v = (torch.empty(B, Hkv, S, D, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    stats = torch.empty(2, B, H, S, device="meta")
    with hlo_walk.Walker() as w:
        held = w.track([q, k, v, o, do, stats])
        kattn._launch_bwd(q, k, v, o, do, stats, True, None,
                          params=(parts, 64, 64))
    group = 8 * parts * B * Hkv * S * D if parts > 1 else 0
    outs = 2 * (B * H * S * D + 2 * B * Hkv * S * D)
    scratch = 2 * B * H * S * D + 16 * B * H * S
    assert w.peak_raw - held == outs + scratch + group
    kern = w.result()["port"]["kernels"]["K4.bwd"]
    assert kern["bytes"] == 2.0 * (4 * B * H * S * D + 4 * B * Hkv * S * D) \
        + 8.0 * B * H * S + 16.0 * B * H * S + 2 * group
