#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # N = 2^20 bodies, the default
    python3 chip_smoke.py --n 65536  # a smaller run of the same phases
    python3 chip_smoke.py --out DIR  # phase 8b's trace and report there
                                     # (default build/obs, gitignored)

Drives the port's paths on the card.  The FMM path —
`FMMSession.from_points(x, q, spec)` (planned with the device dual traversal
and its MAC kernel K3), `.evaluate()` and `.step(new_x)` — on the
repository's default workload: a sphere-surface (boundary) distribution
from `make_distribution("sphere", N, seed=42)`, charges uniform in [-1, 1]
from `default_rng(0)`, and `PartitionSpec(nparts=8, method="orb",
theta=0.5, ncrit=64, p=4)`.  The LM serving path — `ServeEngine` over
`build_model(cfg)` — for qwen3-0.6b, phi4-mini-3.8b and smollm-360m (dense
self-attention through K4), gemma3-12b (5 local : 1 global sliding-window
superblocks with ring caches, head dim 256 through K4), hymba-1.5b
(attention and SSM heads in parallel, sliding-window attention through K4
but on 3 global layers) and rwkv6-1.6b (the WKV recurrence through K5) at
full width and depth, and the MoE dbrx-132b and llama4-scout-17b-a16e at
full width with depth cut to LM_CUT layers; and `Model.prefill` +
`decode_step` (the engine prefills tokens only) for the encoder-decoder
seamless-m4t-medium (its encoder, decoder self- and cross-attention through
K4) at full size and llama-3.2-vision-90b (cross-attention over 1,600 patch
embeddings through K4) at full width, depth cut to LM_CUT layers; random
bfloat16 weights from a seeded generator.  And the LM training path —
`launch.train.run`, the reference's driver — on smollm-360m at full size
(K4 in every forward, its gradient in every backward) and rwkv6-1.6b (K5).

Phases, in order; any failed check raises and ends the run non-zero:

  1. the card's name and power limit; build the five CUDA kernels from
     `src/repro_torch/kernels/csrc` with nvcc (sm_90a, one process each),
     printing ptxas's registers and spills per kernel (K4 by path and
     head size, D = 256 included);
  2. plan the N-body geometry with the device traversal (K3's launch count
     set to 0 just before, read just after) and with the host traversal,
     and compare every receiver's pair lists: a difference is allowed only
     where it starts at a borderline pair (|float64 margin| <= 1e-4 (R_A +
     R_B), or a float32 tie of the radii that decides which cell splits),
     each printed; slacks agree at rtol 1e-4 / atol 1e-7 (the reference's
     tests/test_traversal_device.py);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes: K3 bit for bit on the largest frontier of that
     planning and on every generation of one full traversal, K1 on every
     P2P bucket, K2 on the stream table (its out_valid lanes; exactly 0.0
     on the others, where the plain version sums the slab), and K1 against
     K2 bit for bit on identical live slabs below each tile's tgt_len; time
     kernel and plain version with CUDA events; for K1 and K2 also print
     ptxas's registers and spills, the launch shape and the pair terms
     evaluated beside the live pairs (tools/p2p_variants.py times the other
     launch shapes);
  4. at N = 20,000 the engine on the card against the engine on the CPU,
     at rtol 1e-5 / atol 1e-4 plus 1e-6 of sum_j |q_j| / r_ij: both sum
     float32 terms in different orders (the card's atomics change order
     from run to run), so each potential's rounding scales with the sum of
     its absolute terms (~1e4 here), not with the potential, which cancels;
     then a within-slack and a beyond-slack step of a card session and a
     CPU session (planned with K3's plain version) at the same tolerance;
  5. the main path at N, gathered (K1) then streaming (K2), with every
     launch count set to 0 just before and read just after; the two
     potentials agree, and both match a float64 direct sum on 4,096
     sampled targets (computed on the card);
  6. the protocol layer and the per-partition reference executor on the
     main path's geometry (planned once in phase 2): `FMMSession.sweep()`
     of the four protocols with delivery checked (stages, messages, wire
     MB, relay factor, rounds and LogGP ms each; one evaluation serves all
     four, the same read-only potential); `execute_geometry(geo,
     use_kernels=True, asarray=DeviceMemo)` cold and warm (median of 3),
     with K1's launches per call (one per P2P block) and the memo's
     uploads per call (none after the first); K1 against its plain
     version on the executor's own blocks (for each (T, S) the remote block
     with the fewest rows and the local one with the most, each with its
     launch shape, at phase 3's tolerance); the executor against the
     engine at phase 4's tolerance (sum_j |q_j| / r_ij from an engine
     evaluate with |q|) and at rel-L2 < 3e-3 against phase 5's direct sum;
     the quickstart's
     `run_distributed_fmm(x, q, nparts=8, ...)` at N on the card (planned
     with K3; one DeprecationWarning); and `plan_geometry` of the same
     points in 64 parts with the host traversal, whose four schedules
     (delivery checked) must give the stage and message counts of
     PLAN64_COUNTS at N = 2^20, HSDX relaying over several stages;
  7. stepping at N: three within-slack steps (no rebuild, every partition
     refreshed) and one beyond-slack step of one partition (only it
     rebuilt, re-traversed through K3), each matching a float64 direct sum
     at the stepped positions;
 7b. the multi-rank LET exchange on the main path's geometry, the ranks
     stacked on the card (one card: NCCL refuses two ranks on one device),
     at D = 4 and 8 ranks (DIST_RANKS), for each of bulk, grain and hsdx
     through `FMMSession(geo, mesh=stacked_mesh(D))`: the ShardedEngine's
     build time, the program's rounds, cold and warm evaluates (median of
     3), K1's launches a call (the counter set to 0 just before each warm
     evaluate and read just after: one a bucket a rank), the spans
     `verify_exchange` finds word-exact, moved / delivered / padded MB, the
     exchange alone timed (copies within the card's memory, not a network)
     beside its LogGP prediction for a wire, peak `memory_allocated`,
     agreement with the eager engine as in phase 8 (the eager engine
     against itself beside it) and rel-L2 < 3e-3 against phase 5's direct
     sum; K1 against its plain version on every launch of a dist
     evaluation at phase 3's tolerance; one within-slack step of the mesh
     session, each protocol then against a direct sum at the stepped
     positions;
     (phases 2-7b drive the per-phase engine, `fused=False`; phase 10's
     engines the eager decode step, `graph=False`)
  8. compiled serving as CUDA graphs, the card's default: at N on the
     main path's geometry, on each route (gathered K1, stream K2), a
     compiled `FMMSession` against a per-phase one: capture time,
     `memory_reserved` before and after the capture and the graph's pool,
     warm evaluates (median of 3) with device busy shares, one replay per
     evaluate (entry calls, launch log, the route's kernel counter set to
     0 just before and read just after), the route's kernel named in a
     profiled replay with its share, agreement at tests/test_engine.py's
     rtol 1e-6 / atol 2e-5 (the count past it printed, held to that plus
     1e-7 sum|q|/r, with the eager path against itself beside it) and
     rel-L2 < 3e-3 against phase 5's direct sum; a second geometry of the
     same shape class (the points reflected through the origin: same
     digest, other tables) served from the same entry with no capture and
     one hit, its rebind copy timed, both evaluated alternately; three
     within-slack steps, one replay each, against per-phase steps; the
     same comparison at N = 2^15; for qwen3-0.6b and rwkv6-1.6b, phase
     10's traffic through `ServeEngine(graph=True)` against `graph=False`
     (same tokens, logits within 1e-3 of the largest |logit|), tokens/s of
     the first run (capture included) and of a warm run, decode-step time
     and device busy share both ways, the launches a replay makes (K5
     once a layer for rwkv6, no K4); the same for gemma3-12b (its ring
     caches written at a position read on the device), dbrx-132b (its
     MoE sublayers, depth cut) and hymba-1.5b (its SSM state and conv
     tail static buffers of the graph), each with its seconds;
  8b. observability and resilience, on the main path's geometry at N (and
     N = 2^15), one card: the warm graphed (gathered) evaluate, median of
     3, with `repro_torch.obs` disabled, enabled, and enabled with fences,
     each one replay per evaluate (entry calls, K1 launches), and what
     tracing adds; the fenced spans of one per-phase evaluate
     (`engine.upward`, `engine.far_field`, `engine.p2p_bucket` once a
     bucket, `engine.m2p`) beside its wall time; `report()`'s keys (the
     reference's) and the chrome trace written to
     `<--out>/phase8b_trace.json` (events, dropped); the chaos matrix
     with `resilience=True`, one site at a time — `exe_cache.compile`
     transient (retried, then one capture), `kernels.p2p.launch` raised
     inside a CUDA graph capture (gathered -> per_phase, nothing cached),
     `fused.launch` and `p2p.stream.tables` on a stream (K2) session
     (streaming -> gathered), `memo.upload` on an `engine=False` session
     (the bottom rung: a typed `ResilienceError`, then a clean evaluate)
     and `dist.build_program` on 4 stacked ranks, bulk (dist -> gathered)
     — each with its fallbacks, retries and the serving rung's K1 launches
     (the counter set to 0 just before, read just after, > 0), its
     potential held to a clean per-phase one at phase 8's gate, then the
     accounting identity (faults fired = counted fallbacks + typed errors
     + retries of transient faults); and `python -m
     repro_torch.analysis.check_counters` on the card, which must exit 0
     (its report and trace under `<--out>/check_counters/`);
  9. K4 and K5 against their plain versions on the card: K4 (against the
     plain version with its roundings, and against the one that also walks
     its 128-key tiles) at qwen3-0.6b's prefill shape (B 1, H 16, Hkv 8,
     S 4096, D 128, bfloat16, causal; elementwise and per-row tolerances
     K4_BF16_*, K4_TILED_ROW_REL), at (1, 2, 1, 200, 64) float32 and with
     a window of 64; K5 (its launch parameters printed; bfloat16 r/k/v,
     float32 w in (0.8, 1), zero and random initial state, y at rtol 1e-2
     / atol 1e-4, the state at 1e-4) at rwkv6-1.6b's (BH 4 x 32, S 1024,
     D 64), at the serving prefill's (32, 4096, 64) and at decode's
     contiguous (128, 1, 64), each timed by device time and by a call from
     the host beside its bound; each timed with CUDA events
     beside its plain version, K4 also beside
     `F.scaled_dot_product_attention` on the same inputs (a yardstick the
     port never calls), in bfloat16 at S = 512 to 4,096 (D 128) and at
     (1, 32, 8, 4096, 64) with TFLOP/s and the share of its bound, and once
     in float32; K4 at gemma3-12b's prefill shape (B 1, H 16, Hkv 8, S
     4096, D 256, bfloat16, causal, without and with a window of 1,024)
     and at hymba-1.5b's (1, 25, 5, 4096, 64, with its window of 2,048)
     against both plain versions at the same limits, timed beside its
     bound and SDPA (causal, or a boolean window mask), and at D = 256 in
     float32 against `attention_ref`; K4 unmasked over keys of their own
     length: at llama-3.2-vision-90b's cross-attention (q (1, 64, 4096,
     128) against k/v (1, 8, 1600, 128)) and at seamless-m4t-medium's
     encoder (1, 16, 16, 4096, 64), bfloat16, against both plain versions
     at the same limits, each timed beside its bound (every (query, key)
     pair) and SDPA (no mask, GQA), and in float32 with Sk != Sq against
     `attention_ref`;
 10. serving, for each of qwen3-0.6b, rwkv6-1.6b, gemma3-12b, phi4-mini-
     3.8b, smollm-360m and dbrx-132b (4 of 40 layers): `ServeEngine(B=4,
     S_max=128)` answers 8 requests (prompts of 4-15 tokens from
     default_rng(0), 8 new tokens each) and then prefills one 4,096-token
     prompt, with the model's kernel count set to 0 just before and read
     just after (K4 once a layer in that prefill: 48 for gemma3-12b);
     tokens/s, prefill and decode-step times, a profile of one decode step
     and of the long prefill (the port's kernels named, each with its
     share of device time), dbrx's dropped MoE slots; each request served
     alone: the engine's logits (prefill, then decode over the cache)
     agree with a full forward over the sequence so far within
     LM_LOGIT_TOL of the largest |logit| (bfloat16 rounds the two paths
     differently), and each greedy token is the forward's argmax except at
     near ties (top-2 gap at most twice the measured difference), counted;
     with experts, only the steps at which the engine routed every token
     of the sequence as the forward did and neither dropped a slot are
     held to this (the others counted: random weights route most tokens
     to the same experts, so dbrx drops slots in most steps); then dbrx
     and llama4-scout-17b-a16e (4 of 48 layers): a 6-token request's
     prefill and decode step, which no expert's capacity can refuse,
     against its full forward the same way; hymba-1.5b served as the
     dense models are (K4 once a layer a prefill, the 4,096-token prompt
     past its window of 2,048), its engine logits held to the forward at
     HYMBA_LOGIT_TOL, set from the reference's own decode drift (its
     decode rounds the SSM state to bfloat16, its forward does not), and
     the same requests served again with a planted fault (the SSM state
     zeroed before each decode step), which must read beyond that limit;
     seamless-m4t-medium (12 + 12 layers) and llama-3.2-vision-90b (10 of
     100 layers), through `Model.prefill` + `decode_step`: 4 prompts of
     16 tokens with their frames (4, 16, 1024) or patch embeddings (4,
     1600, 8192) drawn from default_rng(0) at scale 0.1, prefill and 8
     greedy steps, each within LM_LOGIT_TOL of a forward over the sequence
     so far (with the same frames or patches) and its argmax except at
     near ties, then a 4,096-token prefill (seamless with 4,096 frames)
     with K4 once an attention sublayer (36: 12 encoder, 12 self, 12
     cross; 10: 8 self, 2 cross), each with its profile and K4's device
     time;
 11. LM training, the reference's training tier on the card:
     (a) the gradients of K4's and K5's autograd Functions (the kernel
     forward, the PyTorch backward `flash_attention_bwd` / `wkv_bwd`)
     against autograd through their plain versions (`attention_rounded_ref`,
     `wkv_ref`) on the same bfloat16 inputs, per tensor max |error| and
     relative L2 (GRAD_MAX_REL, GRAD_REL_L2): K4 at smollm-360m's (4, 15 /
     5, 512, 64) and qwen3-0.6b's (4, 16 / 8, 512, 128) causal shapes,
     gemma3-12b's D = 256 with its window of 1,024 at S = 2,048, and
     unmasked over 1,600 keys (llama-3.2-vision-90b's cross); K5 at
     rwkv6-1.6b's (4 x 32, 512, 64) with a random initial state and
     final-state gradient; each backward timed beside its forward, the
     plain forward + backward and (K4) SDPA's forward + backward (CUDA
     events); (b) `launch.train.run` on smollm-360m at full width and depth
     with the example's full-size settings (batch 4, seq 512, lr 3e-4) for
     30 of its 300 steps: every loss and grad norm finite, the mean of the
     last 5 losses at least 0.1 below that of the first 5, K4 launched 32
     times a step and its backward as often; warm step time, tokens/s,
     peak memory; 3 steps under the profiler (device busy and idle) and 3
     split into forward, backward (K4's backward function on its own) and
     optimizer; (c) restart exactness (the reference's
     `test_checkpoint_restart_exact`): smollm-360m cut to 2 layers at full
     width, 12 steps uninterrupted against a run failed at step 7 with a
     checkpoint every 3 steps (~1.1 GB each, in a temporary directory under
     build/, deleted afterwards) and resumed from step 6: the last 3 losses
     at rtol 2e-4; (d) rwkv6-1.6b at full width and depth, batch 2, seq
     512, 3 steps: finite losses and grad norms, K5 launched 24 times a
     step and its backward as often, the step time and the backward WKV's
     share of it; K4's and K5's launches of (b)-(d) count in the kernels'
     line;
 12. the LM sharding tier, ranks stacked on the card: (a) the seven
     collectives of `core.collectives` on (8,) and (pod 2, data 4)
     meshes, at tests/test_collectives.py's inputs and at COLL_WORDS
     random float32 words a rank, bit for bit against NumPy models that
     add in the same order (the overlapped matmul against the card's own
     per-chunk products), each timed, and the hierarchical all-reduce's
     bytes a rank per stage: the pod stage carries 1/|data| of the flat
     all-reduce's (the padding aside); (b) dbrx-132b's MoE layer at full
     width (random bfloat16 weights, seed 0), 4 x 1,024 tokens,
     expert-parallel on a stacked (data 2, model 2) mesh against the
     per-data-shard dense oracle (the same capacity, the same drops): the
     outputs within MOE_OUT_TOL of its largest |y|, the aux loss, the
     routes and the slots dropped equal; with `moe_seq_shard` against the
     per-(data x model)-shard oracle; a planted fault (the dispatch
     all-to-all's blocks sent one model rank off) must read beyond the
     limit; the gradients of x and the four weights through both routes
     within MOE_GRAD_REL_L2; time and peak memory beside the oracle's and
     one dense layer's, the all-to-all's bytes a rank; (c) dbrx-132b and
     llama4-scout-17b-a16e (LM_CUT layers, full width) served by
     `ServeEngine(par=)` on the (2, 2) mesh with phase 10's requests: K4's
     launches equal to those without the mesh, the graphed decode under
     the mesh equal to the eager one, and each request (and a 6-token
     one) served with its twin (one a data rank) held to a forward under
     the same mesh by phase 10's rule; (d) smollm-360m's data-parallel
     train step on a stacked (pod 2, data 2) mesh (batch 4, seq 512),
     hierarchical and flat, against the single-card step on the same
     batch (DP_LOSS_RTOL, DP_NORM_RTOL, DP_GRAD_REL_L2, DP_STEP_LR), K4
     once a layer a data rank, each reduction's time and bytes on the pod
     axis;
 13. one JSON line listing every ported kernel;
 14. the last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager
from dataclasses import replace as dc_replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, at the full 700 W
# power limit): float32 outside the tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per (target, source) pair in the P2P tile body
# (p2p_common.cuh): 3 subtractions, r^2 as 1 multiply + 2 fma (5), the
# rsqrt (1), and the fma into the sum (2); an fma counts as 2.
FLOPS_PER_PAIR = 11
# K3 per scored lane: two centers and two radii read, one margin written
# (36 bytes); 3 subtractions, 3 multiplies, 2 additions, the square root,
# the theta multiply, the radius sum and the final subtraction (12 ops)
MAC_BYTES_PER_LANE = 36
MAC_OPS_PER_LANE = 12
RTOL_KERNEL = 2e-5
# Published bf16 dense tensor-core peak of one H100 SXM (data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
# K5 per (token, head, i, j), the least the function needs: the output
# y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i takes one fma per entry (2;
# the second sum is O(D) per token), the update w_i S_ij + k_i v_j one
# multiply and one fma (3); an fma counts as 2
WKV_OPS_PER_ENTRY = 5
# K4 at the main path's shape in bfloat16, against `attention_rounded_ref`:
# elementwise atol + rtol |plain| (rtol two units in the last place of a
# bfloat16 value at the worst; atol one unit at |o| in [0.5, 1), above the
# 1e-3 at which one value of 8.4 million failed), and per query row
# ||got - plain|| <= K4_ROW_REL ||plain|| (2.3x the largest measured,
# 4.4e-3), which also holds the rows whose outputs are small
K4_BF16_ATOL, K4_BF16_RTOL, K4_ROW_REL = 4e-3, 1.6e-2, 1e-2
# K4 per query row against `attention_tiled_ref`, the plain version in the
# kernel's own 128-key tiles: the same p roundings, float32 sums in another
# order; about 2x the largest measured (3.1e-3, one bf16 step in a row of
# small outputs; tests/test_torch_kernels_cuda.py also holds the median)
K4_TILED_ROW_REL = 6e-3
# greedy check: every logit of the engine's path (prefill, then decode over
# the cache) within LM_LOGIT_TOL of the largest |logit| of a full forward
# over the same sequence (about twice the 1.55e-2 measured on one request
# of qwen3-0.6b, whose decode attention rounds the scores to bfloat16 where
# K4 keeps them in float32; rwkv6-1.6b read 0); a token is exempt from being the forward's argmax only
# where the forward's top-2 gap is at most twice the difference measured at
# that step, the one case in which the two paths may order the top two
# differently
LM_LOGIT_TOL = 3e-2
# LM serving: requests, slots, new tokens, cache length, the long prompt
LM_REQUESTS, LM_SLOTS, LM_NEW, LM_SMAX, LM_LONG = 8, 4, 8, 128, 4096
# depth of the models one card cannot hold (full width: 26.6 and 19.3 GiB
# of bfloat16 weights at 4 layers, by param_count)
LM_CUT = {"dbrx-132b": 4, "llama4-scout-17b-a16e": 4,
          "llama-3.2-vision-90b": 10}
# hymba's engine-against-forward gate: its decode rounds the SSM state to
# bfloat16 before C . h where the forward's scan stays in float32 (as the
# reference's does), so a served token's logits sit farther from a forward
# than a plain transformer's, the more so the deeper the model.
# tools/hymba_drift.py --deep measures the reference's own decode against
# its forward on the CPU at hymba-1.5b's depth (32 layers, its global
# layers, the init as served here, width cut to d_model 320, this script's
# traffic): up to 2.30e-1 / 1.63e-1 / 1.43e-1 of the largest |logit| at
# seeds 0 / 1 / 2 (the 3-layer smoke config reads at most 8.17e-2; a limit
# of 0.1 set from that failed on the card at 1.014e-1); the limit is the
# largest, rounded up.  The port on the same weights: up to 1.39e-1 /
# 1.20e-1 / 1.33e-1; with a planted fault, the SSM state not carried from
# step to step, 5.91e-1 / 4.33e-1 / 6.99e-1 at the least, so every step of
# that wrong decode reads beyond the limit; phase 10 plants it on the card
# too.  The other models keep LM_LOGIT_TOL.
HYMBA_LOGIT_TOL = 0.25
# phase 11 (a): the gradients of K4's and K5's autograd Functions against
# autograd through their plain versions (`attention_rounded_ref`, `wkv_ref`)
# on the same bfloat16 inputs, per tensor: relative L2 and max |error| /
# max |plain|.  Measured on the card (H100, 700 W): K4 dq / dk 3.3e-3 to
# 4.0e-3 in relative L2 and up to 6.9e-3 of the largest |plain| (the
# bfloat16 q, k grads: one rounding here, two in autograd's casts; K4's
# bfloat16 output enters rowsum(dO O)), dv under 1e-4; K5's bfloat16 dr /
# dk / dv up to 3.0e-5 and 3.2e-3 (half a bfloat16 unit at their largest
# values), its float32 dw / du / dstate up to 4.4e-7.  Limits about 2.5x
# the largest relative L2 and 2x the largest max, K5's max one bfloat16
# unit (2^-7)
GRAD_REL_L2 = {"K4": 1e-2, "K5": 1e-4}
GRAD_MAX_REL = {"K4": 1.5e-2, "K5": 7.8e-3}
# ... at training shapes: (label, (B, H, Hkv, Sq, Sk, D), causal, window)
K4_GRAD_CASES = (
    ("smollm-360m", (4, 15, 5, 512, 512, 64), True, None),
    ("qwen3-0.6b", (4, 16, 8, 512, 512, 128), True, None),
    ("gemma3-12b local", (1, 16, 8, 2048, 2048, 256), True, 1024),
    ("llama-3.2-vision-90b cross", (1, 64, 8, 512, 1600, 128), False, None))
K5_GRAD_SHAPE = (4 * 32, 512, 64)           # rwkv6-1.6b: (B H, S, D)
# phase 11 (b)-(d): the reference's training main path and its cuts
TRAIN_ARCH, TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = (
    "smollm-360m", 30, 4, 512, 3e-4)
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 2, 12, 3, 7
RWKV_TRAIN_B, RWKV_TRAIN_STEPS = 2, 3
# frame and patch embeddings, drawn at the reference's tests' scale
EMBED_SCALE = 0.1
BITWISE_TILES = 1 << 20      # live tiles in the K1 == K2 bitwise check
MOVER = 1                    # the partition the beyond-slack step shifts
MOVER_SHIFT = np.array([0.15, -0.1, 0.2])


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[phase] {name}: start", flush=True)
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median warm time of fn() in ms, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one fn() in ms: `reps` calls enqueued behind a sleep
    kernel, so the card runs them back to back and the host's time to
    enqueue each call (the wrapper's checks, the ctypes call) is hidden.
    For kernels of a few microseconds, where `cuda_ms` times the host."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)         # ~5 ms: longer than the enqueue
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


@contextmanager
def wall_of(module, name: str, acc: dict):
    """Sum the wall time of every call of module.name into acc[name] and
    count the calls in acc[name + "#"]."""
    real = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            acc[name + "#"] = acc.get(name + "#", 0) + 1

    setattr(module, name, timed)
    try:
        yield acc
    finally:
        setattr(module, name, real)


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def print_ptxas(logs: dict, src: str) -> None:
    """The ptxas lines (registers, spills) of one source from phase 1."""
    lines = [ln.strip() for ln in logs.get(src, "").splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in lines or ["(no ptxas output: built before this run)"]:
        print(f"  {src} ptxas: {ln}", flush=True)


def check_close(name, got, want, absum):
    """|got - want| <= RTOL_KERNEL * (|want| + absum) elementwise, where
    absum = sum_s |q_s| / r_ts: the error of a float32 sum reordered is
    proportional to the sum of its absolute terms, and at N = 2^20 single
    terms reach 10^3 while cancellation leaves some sums near 0."""
    err = (got - want).abs()
    tol = RTOL_KERNEL * (want.abs() + absum)
    bad = int((err > tol).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"  {name}: max_abs_err {max_err:.3e}, max |plain| "
          f"{float(want.abs().max()):.3e}, over tolerance {bad}", flush=True)
    if bad:
        raise AssertionError(f"{name}: {bad} values outside tolerance")
    return max_err


# K5's template arguments in ptxas's mangled entry names: type, D, G, JC,
# JL, TC
WKV_ENTRY = re.compile(r"wkv_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi"
                       r"(\d+)ELi(\d+)ELi(\d+)E")
# K4's: the kernel (tc: bf16 wgmma; kernel: float32 CUDA cores) and D
ATTN_ENTRY = re.compile(r"flash_attention_(tc|kernel)I(?:f)?Li(\d+)E")
# the port's kernels as the profiler names them (their CUDA function names)
KERNEL_NAMES = {"flash_attention_tc": "K4 (bf16, wgmma + TMA)",
                "flash_attention_kernel": "K4 (float32, CUDA cores)",
                "wkv_kernel": "K5", "p2p_gathered_kernel": "K1",
                "p2p_stream_kernel": "K2"}


def profile_run(torch, label: str, fn, top: int = 8) -> tuple:
    """One warm fn() under torch.profiler: the device-busy share (time of
    the device's own events over wall time) and the kernels that take the
    most device time, each with its share of the busy time and, for the
    port's own kernels, its name in this script.  Only device-side events
    are summed: a CPU op's device time repeats that of the kernels it
    launched.  Returns (wall s, busy s, [(name, device us, count)])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    if not rows:
        print(f"  {label} profile: device time not measured (the profiler "
              f"recorded no device events); wall {wall:.4f} s", flush=True)
        return wall, None, rows
    print(f"  {label} profile: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, "
          f"{sum(r[2] for r in rows)} device ops", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        ours = [v for n, v in KERNEL_NAMES.items() if n in key]
        print(f"    {us / 1e3:9.3f} ms {100 * us / 1e6 / busy:5.1f}%  "
              f"x{count:<5d} {ours[0] + ': ' if ours else ''}{key[:90]}",
              flush=True)
    return wall, busy, rows


class FrontierSpy:
    """Stands in for K3's wrapper while a traversal runs: passes every call
    through, keeps the inputs of the largest frontier generation scored,
    and with `check=True` holds every generation's result against the
    plain version bit for bit."""

    def __init__(self, torch, kmac, check: bool = False):
        self.torch, self.kmac, self.check = torch, kmac, check
        self.real = kmac.mac_margins
        self.largest = None
        self.calls = self.mismatches = 0

    def __call__(self, ca, ra, cb, rb, theta):
        out = self.real(ca, ra, cb, rb, theta)
        self.calls += 1
        if self.largest is None or ra.shape[0] > self.largest[1].shape[0]:
            self.largest = (ca, ra, cb, rb, theta)
        if self.check and not self.torch.equal(
                out, self.kmac.mac_margins_ref(ca, ra, cb, rb, theta)):
            self.mismatches += 1
        return out

    def __enter__(self):
        self.kmac.mac_margins = self
        return self

    def __exit__(self, *exc):
        self.kmac.mac_margins = self.real


def plan_arrays(inter) -> list:
    """Every pair list of one InteractionPlan: M2L pairs, M2P source cells
    and target gathers, and each P2P bucket's pairs as body gathers."""
    out = [np.array([inter.n_m2l, inter.n_p2p, inter.n_m2p,
                     len(inter.p2p_blocks)]),
           inter.m2l_a[:inter.n_m2l], inter.m2l_b[:inter.n_m2l],
           inter.m2p_b[:inter.n_m2p], inter.m2p_t_idx[:inter.n_m2p]]
    for blk in inter.p2p_blocks:
        out += [blk.t_idx[:blk.n], blk.s_idx[:blk.n]]
    return out


def same_plan(a, b) -> bool:
    pa, pb = plan_arrays(a), plan_arrays(b)
    return len(pa) == len(pb) and all(
        u.shape == v.shape and np.array_equal(u, v) for u, v in zip(pa, pb))


def root_flips(torch, kmac, tgt, src, theta: float) -> list:
    """Walk the host traversal (float64) and score each generation's pairs
    also as the device does (float32 tables, K3's plain version, which K3
    equals bit for bit).  Returns the pairs where the two decide
    differently: the MAC, or which cell splits.  Every difference between
    the two traversals' pair lists starts at one of them."""
    tc, tr = np.asarray(tgt.center), np.asarray(tgt.radius)
    sc, sr = np.asarray(src.center), np.asarray(src.radius)
    f32 = [torch.as_tensor(a.astype(np.float32)) for a in (tc, tr, sc, sr)]
    t_leaf, s_leaf = np.asarray(tgt.is_leaf), np.asarray(src.is_leaf)
    flips = []
    A = np.zeros(1, np.int64)
    B = np.zeros(1, np.int64)
    while len(A):
        n = len(A)
        K = -(-n // kmac.MAC_BLOCK) * kmac.MAC_BLOCK
        ia = torch.as_tensor(np.pad(A, (0, K - n)))
        ib = torch.as_tensor(np.pad(B, (0, K - n)))
        m32 = kmac.mac_margins_ref(f32[0][ia], f32[1][ia], f32[2][ib],
                                   f32[3][ib], theta).numpy()[:n]
        d = np.linalg.norm(tc[A] - sc[B], axis=1)
        rsum = tr[A] + sr[B]
        far = rsum < theta * d
        for k in np.nonzero(far != (m32 > 0))[0]:
            flips.append(("mac", int(A[k]), int(B[k]),
                          float(theta * d[k] - rsum[k]), float(rsum[k])))
        A, B = A[~far], B[~far]
        both_leaf = t_leaf[A] & s_leaf[B]
        A, B = A[~both_leaf], B[~both_leaf]
        if not len(A):
            break
        split_t = (~t_leaf[A]) & (s_leaf[B] | (tr[A] >= sr[B]))
        split_32 = (~t_leaf[A]) & (s_leaf[B] | (tr[A].astype(np.float32)
                                                >= sr[B].astype(np.float32)))
        for k in np.nonzero(split_t != split_32)[0]:
            flips.append(("split", int(A[k]), int(B[k]),
                          float(tr[A[k]] - sr[B[k]]),
                          float(tr[A[k]] + sr[B[k]])))
        At, Bt = A[split_t], B[split_t]
        As, Bs = A[~split_t], B[~split_t]
        nt = np.asarray(tgt.n_child)[At]
        ns = np.asarray(src.n_child)[Bs]
        rep_t = np.repeat(np.arange(len(At)), nt)
        rep_s = np.repeat(np.arange(len(Bs)), ns)
        child_t = (np.asarray(tgt.child_start)[At][rep_t]
                   + np.arange(len(rep_t)) - np.repeat(np.cumsum(nt) - nt, nt))
        child_s = (np.asarray(src.child_start)[Bs][rep_s]
                   + np.arange(len(rep_s)) - np.repeat(np.cumsum(ns) - ns, ns))
        A = np.concatenate([child_t, As[rep_s]])
        B = np.concatenate([Bt[rep_t], child_s])
    return flips


def compare_geometries(torch, kmac, geo_d, geo_h) -> None:
    """Device-planned against host-planned geometry (phase 2's check)."""
    theta = geo_h.theta
    total = differ = 0
    bad = []
    for j, (rd, rh) in enumerate(zip(geo_d.receivers, geo_h.receivers)):
        if (rd is None) != (rh is None):
            raise AssertionError(f"receiver {j}: present in one plan only")
        if rd is None:
            continue
        pairs = [("local", rd.local, rh.local, rd.tree)]
        if [u.sender for u in rd.remote] != [v.sender for v in rh.remote]:
            raise AssertionError(f"receiver {j}: different senders")
        pairs += [(f"from {u.sender}", u.inter, v.inter, v.graft)
                  for u, v in zip(rd.remote, rh.remote)]
        for label, pd, ph, src in pairs:
            total += 1
            if same_plan(pd, ph):
                continue
            differ += 1
            flips = root_flips(torch, kmac, rh.tree, src, theta)
            if not flips:
                raise AssertionError(f"receiver {j} {label}: pair lists "
                                     f"differ with no decision that does")
            for kind, a, b, v, rsum in flips:
                if kind == "mac":
                    ok = abs(v) <= 1e-4 * rsum
                    what = f"f64 margin {v:.3e}, R_A + R_B {rsum:.3e}"
                else:
                    ok = abs(v) <= 1e-6 * rsum
                    what = (f"split tie: R_A - R_B {v:.3e} (f64), equal in "
                            f"f32, R_A + R_B {rsum:.3e}")
                print(f"  differing pair: receiver {j} {label}, cells "
                      f"({a}, {b}), {kind}: {what}"
                      f"{'' if ok else ' -- NOT borderline'}", flush=True)
                if not ok:
                    bad.append((j, label, a, b))
    print(f"  pair lists: {total - differ} of {total} traversals identical "
          f"to the host's, {differ} differ", flush=True)
    if bad:
        raise AssertionError(f"device and host plans differ beyond "
                             f"borderline pairs: {bad}")
    rel = np.abs(geo_d.slack - geo_h.slack) / np.maximum(geo_h.slack, 1e-300)
    print(f"  slack: device {np.array2string(geo_d.slack, precision=4)}, "
          f"host {np.array2string(geo_h.slack, precision=4)}, max rel diff "
          f"{rel.max():.3e}", flush=True)
    if not np.allclose(geo_d.slack, geo_h.slack, rtol=1e-4, atol=1e-7):
        raise AssertionError("device and host slacks differ beyond rtol "
                             "1e-4 / atol 1e-7")
    np.testing.assert_array_equal(geo_d.bytes_matrix, geo_h.bytes_matrix)


def rel_l2(dev, x, q, phi, direct_potential) -> float:
    """rel-L2 error of phi on 4,096 sampled targets against a float64
    direct sum at positions x (computed on the card)."""
    n = len(x)
    idx = np.random.default_rng(1).choice(n, size=min(4096, n),
                                          replace=False)
    d = direct_potential(x, q, x_tgt=x[idx], chunk=64, device=dev)
    return float(np.linalg.norm(phi[idx] - d) / np.linalg.norm(d))


def check_tol(torch, name, got, want, rtol, atol, row_rel=None) -> float:
    """|got - want| <= atol + rtol |want| elementwise, in float32, and with
    `row_rel` ||got - want|| <= row_rel ||want|| over each row (the last
    dimension); prints and returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    bad = int((err > tol).sum())
    max_err = float(err.max())
    worst = int((err / tol).argmax())
    print(f"  {name}: closest to its tolerance: |got - plain| "
          f"{float(err.flatten()[worst]):.3e} at |plain| "
          f"{float(want.flatten()[worst].abs()):.3e}, tolerance "
          f"{float(tol.flatten()[worst]):.3e}", flush=True)
    rows = ""
    if row_rel is not None:
        rel = err.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        bad_rows = int((rel > row_rel).sum())
        rows = (f"; per-row relative L2 max {float(rel.max()):.3e}, median "
                f"{float(rel.median()):.3e}, over {row_rel}: {bad_rows}")
        bad += bad_rows
    print(f"  {name}: max_abs_err {max_err:.3e}, max |plain| "
          f"{float(want.abs().max()):.3e}, median |plain| "
          f"{float(want.abs().median()):.3e}, over rtol {rtol} / atol "
          f"{atol}: {bad}{rows}", flush=True)
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} values outside tolerance")
    return max_err


# the protocol table of the 64-partition host plan of the default workload
# at N = 2^20 (stages, messages), fixed by the plan's bytes matrix and
# adjacency boxes, which the host traversal makes independent of the card
PLAN64_COUNTS = {"alltoallv": (1, 4032), "nbx": (1, 4032),
                 "pairwise": (6, 384), "hsdx": (5, 1669)}


def print_comm(label: str, cs) -> None:
    st = cs.stats
    print(f"  {label} {cs.protocol:9s}: stages {st['n_stages']}, messages "
          f"{st['n_msgs']}, wire {st['wire_bytes'] / 1e6:.2f} MB, relay "
          f"factor {st['relay_factor']:.3f}, rounds {st['n_rounds']}, LogGP "
          f"{cs.loggp_time * 1e3:.3f} ms (the cost model's output)",
          flush=True)


def executor_k1_blocks(torch, kp2p, walked, dev) -> None:
    """K1 against its plain version at the executor's own launch shapes:
    for each (T, S), the remote block with the fewest rows (the smallest
    grids, where `p2p_launch_params` gives fewer warps a block) and the
    local block with the most, gathered on the card as `fmm.p2p_apply`
    gathers them.  These launches are checks, not the path's."""
    f32 = torch.float32
    pick = {}
    for local, tgt, src, b in walked:
        key = (b.shape[1], b.shape[2], local)
        old = pick.get(key)
        if old is None or (b.shape[0] > old[2].shape[0] if local
                           else b.shape[0] < old[2].shape[0]):
            pick[key] = (tgt, src, b)
    for (T, S, local), (tgt, src, b) in sorted(pick.items()):
        def up(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        xt = up(tgt.x, f32)[up(b.t_idx)]
        xs = up(src.x, f32)[up(b.s_idx)]
        qs = torch.where(up(b.s_valid), up(src.q, f32)[up(b.s_idx)],
                         torch.zeros((), dtype=f32, device=dev))
        P = qs.shape[0]
        warps = kp2p.p2p_launch_params(P)
        grid = -(-(-(-P // kp2p.ROWS_PER_WARP)) // warps)
        check_close(f"K1 executor {'local' if local else 'remote'} block "
                    f"(rows {P}, T {T}, S {S}), {warps} warps a block, "
                    f"{grid} blocks", kp2p.p2p(qs, xs, xt),
                    kp2p.p2p_ref(qs, xs, xt),
                    kp2p.p2p_ref(qs.abs(), xs, xt))
        del xt, xs, qs


def protocols_and_executor(torch, sess, x, q, idx, d, dev, card) -> None:
    """Phase 6: the protocol sweep, the per-partition reference executor
    with K1, the legacy `run_distributed_fmm`, and the schedules of a
    64-partition host plan, on the main path's geometry."""
    import warnings
    from repro_torch.core import api as tapi
    from repro_torch.core.distributed_fmm import run_distributed_fmm
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.kernels import mac as kmac
    from repro_torch.kernels import p2p as kp2p

    geo, n = sess.geometry, len(x)
    B = geo.bytes_matrix
    print(f"  geometry: {geo.spec.nparts} parts, diameter {geo.diameter}, "
          f"max degree {geo.adjacency_degree:.0f}, LET {B.sum() / 1e6:.2f} "
          f"MB in {int((B > 0).sum())} pairs", flush=True)

    # -- the sweep: four protocols from one evaluation --------------------
    sweeper = tapi.FMMSession(geo, device=dev, fused=False)
    _, t_engine = timed_sync(torch, lambda: sweeper.engine)
    acc = {}
    with wall_of(DeviceEngine, "evaluate", acc):
        out, t_sweep = timed_sync(
            torch, lambda: sweeper.sweep(check_delivery=True))
    for cs in (res.comm for res in out.values()):
        print_comm("nparts 8", cs)
    phis = [res.phi for res in out.values()]
    print(f"  sweep (check_delivery=True): {t_sweep:.4f} s host time for "
          f"{len(out)} protocols and {acc['evaluate#']} evaluation(s) "
          f"({acc['evaluate']:.4f} s of it; engine tables built before it "
          f"in {t_engine:.3f} s); card {card}", flush=True)
    if acc["evaluate#"] != 1 or not all(p is phis[0] for p in phis) \
            or phis[0].flags.writeable:
        raise AssertionError("the sweep did not serve every protocol from "
                             "one read-only evaluation")
    phi_eng = phis[0]
    e = sweeper.engine
    phi_abs = DeviceEngine(e.tables, e.x.cpu().numpy(),
                           e.q.abs().cpu().numpy(), device=dev,
                           fused=False).evaluate()
    del sweeper, e, out, phis

    # -- the reference executor: K1 on every P2P block --------------------
    plans = [pl for r in geo.receivers if r is not None
             for pl in [r.local] + [rb.inter for rb in r.remote]]
    blocks = [b for pl in plans if pl.n_p2p for b in pl.p2p_blocks]
    # (local?, target tree, source tree, block) as p2p_apply walks them
    walked = [(src is r.tree, r.tree, src, b) for r in geo.receivers
              if r is not None
              for src, pl in [(r.tree, r.local)]
              + [(rb.graft, rb.inter) for rb in r.remote]
              if pl.n_p2p for b in pl.p2p_blocks]
    shapes = sorted({b.shape[1:] for b in blocks})
    rows = sum(b.shape[0] for b in blocks)
    print(f"  executor: {len(plans)} interaction plans, {len(blocks)} P2P "
          f"blocks, {rows} rows, (T, S) {shapes}, "
          f"{sum(pl.n_m2l for pl in plans)} M2L pairs, "
          f"{sum(pl.n_m2p for pl in plans)} M2P pairs", flush=True)
    memo = tapi.DeviceMemo(dev)
    times, per_call, misses = [], [], []
    for _ in range(4):
        kp2p.launches = 0
        m0 = memo.misses
        phi_x, t = timed_sync(torch, lambda: tapi.execute_geometry(
            geo, use_kernels=True, asarray=memo))
        times.append(t)
        per_call.append(kp2p.launches)
        misses.append(memo.misses - m0)
    print(f"  execute_geometry(use_kernels=True, asarray=memo): cold "
          f"{times[0]:.4f} s, warm median {statistics.median(times[1:]):.4f}"
          f" s (runs {', '.join(f'{t:.4f}' for t in times[1:])}); K1 "
          f"launches per call {per_call}; memo uploads per call {misses} "
          f"({len(memo)} tables resident); card {card}", flush=True)
    if per_call != [len(blocks)] * 4 or misses[1:] != [0, 0, 0]:
        raise AssertionError("the executor did not launch K1 once per P2P "
                             "block, or uploaded a table again")
    executor_k1_blocks(torch, kp2p, walked, dev)
    diff = np.abs(phi_x - phi_eng)
    tol = 1e-4 + 1e-5 * np.abs(phi_eng) + 1e-6 * phi_abs
    worst = float((diff / tol).max())
    rel = float(np.linalg.norm(phi_x[idx] - d) / np.linalg.norm(d))
    print(f"  executor vs engine: max |diff| {diff.max():.3e}, largest "
          f"|diff| / (1e-4 + 1e-5 |phi| + 1e-6 sum|q|/r) {worst:.3f}; "
          f"rel-L2 vs direct sum on {len(idx)} targets {rel:.3e}",
          flush=True)
    if not (phi_x.shape == (n,) and np.isfinite(phi_x).all()
            and worst <= 1.0 and rel < 3e-3):
        raise AssertionError("the reference executor disagrees with the "
                             "engine or the direct sum")
    del memo, phi_x

    # -- the quickstart's call at the full N ------------------------------
    kmac.launches = 0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res, t_run = timed_sync(torch, lambda: run_distributed_fmm(
            x, q, nparts=8, method="orb", protocol="hsdx", theta=0.5,
            ncrit=64))
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    rel = float(np.linalg.norm(res.phi[idx] - d) / np.linalg.norm(d))
    st = res.schedule_stats
    print(f"  run_distributed_fmm (N={n}, 8 parts, hybrid ORB, hsdx): "
          f"{t_run:.3f} s wall, K3 launches {kmac.launches}; card {card}",
          flush=True)
    print(f"    rel. L2 error vs direct sum : {rel:.2e} ({len(idx)} sampled "
          f"targets)", flush=True)
    print(f"    LET volume                  : "
          f"{res.bytes_matrix.sum() / 1e6:.2f} MB total", flush=True)
    print(f"    HSDX stages                 : {res.n_stages} (adjacency "
          f"degree max {res.adjacency_degree:.0f}, diameter "
          f"{res.diameter})", flush=True)
    print(f"    messages                    : {st['n_msgs']} (relay factor "
          f"{st['relay_factor']:.2f})", flush=True)
    print(f"    LogGP time model            : {res.loggp_time * 1e3:.2f} ms",
          flush=True)
    if not (rel < 3e-3 and len(dep) == 1 and kmac.launches > 0):
        raise AssertionError(f"run_distributed_fmm: rel-L2 {rel}, "
                             f"{len(dep)} DeprecationWarning(s)")
    del res

    # -- a relaying HSDX at scale: 64 partitions, host-traversed ----------
    geo64, t_plan = timed_sync(torch, lambda: tapi.plan_geometry(
        x, q, dc_replace(geo.spec, nparts=64, traversal_backend="host"),
        device=dev))
    B64 = geo64.bytes_matrix
    print(f"  nparts 64 (host traversal): planned in {t_plan:.3f} s; "
          f"diameter {geo64.diameter}, max degree "
          f"{geo64.adjacency_degree:.0f}, LET {B64.sum() / 1e6:.2f} MB in "
          f"{int((B64 > 0).sum())} ordered pairs; card {card}", flush=True)
    t0 = time.perf_counter()
    comms = {name: tapi.schedule_comm(geo64, name, check_delivery=True)
             for name in PLAN64_COUNTS}
    t_sched = time.perf_counter() - t0
    for cs in comms.values():
        print_comm("nparts 64", cs)
    print(f"  nparts 64: four schedules with delivery checked in "
          f"{t_sched:.3f} s host time", flush=True)
    got = {k: (cs.n_stages, cs.stats["n_msgs"]) for k, cs in comms.items()}
    want = PLAN64_COUNTS if n == 1 << 20 else got
    hsdx = comms["hsdx"]
    if got != want or hsdx.n_stages <= 1 \
            or hsdx.stats["payload_bytes"] != int(B64.sum()):
        raise AssertionError(f"nparts 64 schedules: {got}, expected "
                             f"{want} and HSDX relaying the whole LET")


def attn_pairs(s_: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs of one head that the causal mask and the window
    admit (every pair unmasked, sk keys)."""
    if not causal:
        return s_ * sk
    w = min(window or s_, s_)
    return w * (w + 1) // 2 + (s_ - w) * w


def lm_kernel_checks(torch, kattn, krwkv, dev, power) -> dict:
    """Phase 9: K4 and K5 against their plain versions, timed."""
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def normal(shape, dtype, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.as_tensor(a, device=dev).to(dtype)

    def k4_bound(b, h, hk, s_, d, nbyte, window=None, causal=True, sk=None):
        """(bound ms, its side, operations) of K4 at one shape, the
        operations those of the (query, key) pairs the causal mask and the
        window admit, or of every pair without a mask (sk keys, default
        s_)."""
        sk = sk or s_
        pairs = attn_pairs(s_, sk, causal, window)
        ops = 4.0 * d * pairs * b * h                  # QK^T and PV, fma = 2
        nb = nbyte * (2.0 * b * h * s_ * d + 2.0 * b * hk * sk * d)
        peak = PEAK_BF16_FLOPS if nbyte == 2 else PEAK_F32_FLOPS
        tb, to = nb / PEAK_BYTES * 1e3, ops / peak * 1e3
        return ((tb, "bytes") if tb >= to else (to, "operations")) + (ops,)

    out = {}
    # K4 at qwen3-0.6b's prefill shape, against the plain version that
    # rounds as the kernel does (see K4_BF16_ATOL) and against the one that
    # also walks the kernel's 128-key tiles (K4_TILED_ROW_REL)
    B, H, Hkv, S, D = 1, 16, 8, LM_LONG, 128
    q, k, v = (normal((B, h, S, D), bf16) for h in (H, Hkv, Hkv))
    got = kattn.flash_attention(q, k, v, causal=True)
    err = check_tol(torch, f"K4 ({B}, {H}, {Hkv}, {S}, {D}) bf16 causal", got,
                    kattn.attention_rounded_ref(q, k, v, causal=True),
                    K4_BF16_RTOL, K4_BF16_ATOL, row_rel=K4_ROW_REL)
    check_tol(torch, f"K4 ({B}, {H}, {Hkv}, {S}, {D}) bf16 causal against "
              f"attention_tiled_ref (block_k {kattn.BLOCK_K[D]})", got,
              kattn.attention_tiled_ref(q, k, v, causal=True),
              K4_BF16_RTOL, K4_BF16_ATOL, row_rel=K4_TILED_ROW_REL)
    for shape, window in (((1, 2, 1, 200, 64), None),
                          ((1, 2, 2, 256, 64), 64)):
        b, h, hk, s_, d = shape
        q2, k2, v2 = (normal((b, n, s_, d), f32) for n in (h, hk, hk))
        check_tol(torch, f"K4 {shape} f32 causal window {window}",
                  kattn.flash_attention(q2, k2, v2, window=window),
                  kattn.attention_rounded_ref(q2, k2, v2, window=window),
                  2e-4, 2e-4)
    ms = device_ms(torch, lambda: kattn.flash_attention(q, k, v), reps=20)
    call_ms = cuda_ms(torch, lambda: kattn.flash_attention(q, k, v))
    pms = cuda_ms(torch, lambda: kattn.attention_rounded_ref(q, k, v), reps=3)
    lms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=20)
    bms, by, ops = k4_bound(B, H, Hkv, S, D, 2)
    print(f"  K4 at qwen3-0.6b prefill: {ms:.4f} ms device time ({call_ms:.4f}"
          f" ms a call from the host), plain {pms:.4f} ms, "
          f"scaled_dot_product_attention {lms:.4f} ms, bound {bms:.4f} ms "
          f"({by}, {ops / 1e9:.2f} GFLOP at the bf16 tensor-core peak); "
          f"{ops / ms / 1e9:.2f} TFLOP/s, {100 * bms / ms:.1f}% of the bound; "
          f"power limit {power}", flush=True)
    out["K4"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                     max_abs_err=err, library_ms=lms)
    del q, k, v, got

    # K4 causal at the windowed models' prefill shapes: gemma3-12b's at
    # head dim 256 (64-key tiles), its global sublayers unwindowed, its
    # local ones within 1,024; hymba-1.5b's (GQA 25 / 5, head dim 64), 29 of
    # its 32 layers within 2,048
    for arch, (B, H, Hkv, S, D), windows in (
            ("gemma3-12b", (1, 16, 8, LM_LONG, 256), (None, 1024)),
            ("hymba-1.5b", (1, 25, 5, LM_LONG, 64), (2048,))):
        q, k, v = (normal((B, h, S, D), bf16) for h in (H, Hkv, Hkv))
        qi = torch.arange(S, device=dev)
        for window in windows:
            label = (f"K4 ({B}, {H}, {Hkv}, {S}, {D}) bf16 causal, window "
                     f"{window}")
            got = kattn.flash_attention(q, k, v, causal=True, window=window)
            err = max(err, check_tol(
                torch, label, got, kattn.attention_rounded_ref(
                    q, k, v, causal=True, window=window),
                K4_BF16_RTOL, K4_BF16_ATOL, row_rel=K4_ROW_REL))
            check_tol(torch, f"{label} against attention_tiled_ref (block_k "
                      f"{kattn.BLOCK_K[D]})", got, kattn.attention_tiled_ref(
                          q, k, v, causal=True, window=window),
                      K4_BF16_RTOL, K4_BF16_ATOL, row_rel=K4_TILED_ROW_REL)
            del got
            mask = (qi[None, :] <= qi[:, None]) & (
                qi[None, :] > qi[:, None] - (window or S + 1))
            t = device_ms(torch, lambda: kattn.flash_attention(
                q, k, v, window=window), reps=20)
            t_p = cuda_ms(torch, lambda: kattn.attention_rounded_ref(
                q, k, v, window=window), reps=3)
            t_l = device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True) if window is None
                else F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                    enable_gqa=True),
                reps=20)
            bms_s, by_s, ops_s = k4_bound(B, H, Hkv, S, D, 2, window)
            print(f"  K4 at {arch} prefill, window {window}: {t:.4f} ms, "
                  f"{ops_s / t / 1e9:.2f} TFLOP/s, bound {bms_s:.4f} ms "
                  f"({by_s}, {ops_s / 1e9:.2f} GFLOP), "
                  f"{100 * bms_s / t:.1f}% of the bound; plain {t_p:.4f} ms;"
                  f" scaled_dot_product_attention {t_l:.4f} ms "
                  f"({'causal' if window is None else 'a boolean window mask'}"
                  f", GQA); power limit {power}", flush=True)
            out[f"K4_{arch}_w{window}"] = dict(ms=t, plain_ms=t_p,
                                              bound_ms=bms_s, library_ms=t_l)
            del mask
        del q, k, v
    for shape, window in (((1, 2, 1, 300, 256), None),
                          ((1, 2, 2, 333, 256), 64)):
        b, h, hk, s_, d = shape
        q2, k2, v2 = (normal((b, n, s_, d), f32) for n in (h, hk, hk))
        check_tol(torch, f"K4 {shape} f32 causal window {window} against "
                  f"attention_ref", kattn.flash_attention(q2, k2, v2,
                                                          window=window),
                  kattn.attention_ref(q2, k2, v2, window=window), 2e-4, 2e-4)

    # K4 unmasked over keys of their own length: llama-3.2-vision-90b's
    # cross-attention over 1,600 patch embeddings, seamless-m4t-medium's
    # bidirectional encoder (Sq == Sk); each against both plain versions
    for label, (b, h, hk, s_, sk, d) in (
            ("llama-3.2-vision-90b cross", (1, 64, 8, LM_LONG, 1600, 128)),
            ("seamless-m4t-medium encoder", (1, 16, 16, LM_LONG, LM_LONG,
                                             64))):
        q = normal((b, h, s_, d), bf16)
        k, v = (normal((b, hk, sk, d), bf16) for _ in range(2))
        shape = f"q {(b, h, s_, d)}, k/v {(b, hk, sk, d)}"
        got = kattn.flash_attention(q, k, v, causal=False)
        err = max(err, check_tol(
            torch, f"K4 {label} {shape} bf16 unmasked", got,
            kattn.attention_rounded_ref(q, k, v, causal=False),
            K4_BF16_RTOL, K4_BF16_ATOL, row_rel=K4_ROW_REL))
        check_tol(torch, f"K4 {label} against attention_tiled_ref (block_k "
                  f"{kattn.BLOCK_K[d]})", got, kattn.attention_tiled_ref(
                      q, k, v, causal=False),
                  K4_BF16_RTOL, K4_BF16_ATOL, row_rel=K4_TILED_ROW_REL)
        del got
        t = device_ms(torch, lambda: kattn.flash_attention(
            q, k, v, causal=False), reps=20)
        t_p = cuda_ms(torch, lambda: kattn.attention_rounded_ref(
            q, k, v, causal=False), reps=3)
        t_l = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True), reps=20)
        bms_s, by_s, ops_s = k4_bound(b, h, hk, s_, d, 2, causal=False,
                                      sk=sk)
        print(f"  K4 at {label} ({shape}, bf16, no mask): {t:.4f} ms, "
              f"{ops_s / t / 1e9:.2f} TFLOP/s, bound {bms_s:.4f} ms ({by_s}, "
              f"{ops_s / 1e9:.2f} GFLOP), {100 * bms_s / t:.1f}% of the "
              f"bound; plain {t_p:.4f} ms; scaled_dot_product_attention "
              f"{t_l:.4f} ms (no mask, GQA); power limit {power}",
              flush=True)
        out[f"K4_{label.split()[-1]}"] = dict(ms=t, plain_ms=t_p,
                                             bound_ms=bms_s, library_ms=t_l)
        del q, k, v
    for shape in ((2, 4, 2, 300, 77, 64), (1, 4, 1, 100, 333, 128)):
        b, h, hk, s_, sk, d = shape
        q2 = normal((b, h, s_, d), f32)
        k2, v2 = (normal((b, hk, sk, d), f32) for _ in range(2))
        check_tol(torch, f"K4 {shape} f32 unmasked, Sk != Sq, against "
                  f"attention_ref", kattn.flash_attention(q2, k2, v2,
                                                          causal=False),
                  kattn.attention_ref(q2, k2, v2, causal=False), 2e-4, 2e-4)
    out["K4"]["max_abs_err"] = err

    # K4 across lengths and head sizes, each beside SDPA on the same inputs
    for b, h, hk, s_, d in ((1, 16, 8, 512, 128), (1, 16, 8, 1024, 128),
                            (1, 16, 8, 2048, 128), (1, 16, 8, 4096, 128),
                            (1, 32, 8, 4096, 64)):
        q, k, v = (normal((b, n, s_, d), bf16) for n in (h, hk, hk))
        t = device_ms(torch, lambda: kattn.flash_attention(q, k, v), reps=20)
        t_l = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=20)
        bms_s, by_s, ops_s = k4_bound(b, h, hk, s_, d, 2)
        print(f"  K4 bf16 causal {(b, h, hk, s_, d)}: {t:.4f} ms, "
              f"{ops_s / t / 1e9:.2f} TFLOP/s, bound {bms_s:.4f} ms ({by_s}), "
              f"{100 * bms_s / t:.1f}% of the bound; "
              f"scaled_dot_product_attention {t_l:.4f} ms "
              f"({ops_s / t_l / 1e9:.2f} TFLOP/s); power limit {power}",
              flush=True)
    del q, k, v
    # the float32 path (CUDA cores), once
    b, h, hk, s_, d = 1, 16, 8, 1024, 128
    q, k, v = (normal((b, n, s_, d), f32) for n in (h, hk, hk))
    t = device_ms(torch, lambda: kattn.flash_attention(q, k, v), reps=10)
    bms_s, by_s, ops_s = k4_bound(b, h, hk, s_, d, 4)
    print(f"  K4 float32 causal {(b, h, hk, s_, d)} (CUDA cores): {t:.4f} ms, "
          f"{ops_s / t / 1e9:.2f} TFLOP/s, bound {bms_s:.4f} ms ({by_s}, "
          f"float32 peak outside the tensor cores); power limit {power}",
          flush=True)
    del q, k, v

    # K5 at rwkv6-1.6b's shapes: 4 slots x 32 heads x 1,024 tokens, the
    # serving path's prefill of one 4,096-token prompt, and decode (C = 1)
    def k5_inputs(BH, C, D, random_state):
        r, k, v = (normal((BH, C, D), bf16, 0.5) for _ in range(3))
        w = torch.as_tensor(rng.uniform(0.8, 1.0, (BH, C, D)).astype(
            np.float32), device=dev)
        s0 = (normal((BH, D, D), f32, 0.1) if random_state
              else torch.zeros(BH, D, D, device=dev))
        return r, k, v, w, normal((BH, D), f32, 0.1), s0

    def k5_check(label, args):
        y, s1 = krwkv.wkv_chunk(*args)
        y_p, s_p = krwkv.wkv_ref(*args)
        return max(check_tol(torch, f"K5 y {label}", y, y_p, 1e-2, 1e-4),
                   check_tol(torch, f"K5 state {label}", s1, s_p, 1e-4,
                             1e-4))

    def k5_bound(BH, C, D):
        """(ms, side): r, k, v, y in bf16 and w in float32 once per (token,
        head, channel), the state read and written once; 5 ops an entry."""
        nbytes = BH * C * D * (3 * 2 + 4 + 2) + 2 * 4.0 * BH * D * D
        return bound_ms(nbytes, float(WKV_OPS_PER_ENTRY) * BH * C * D * D)

    err = 0.0
    times = {}
    for BH, C, D in ((4 * 32, 1024, 64), (32, LM_LONG, 64), (4 * 32, 1, 64)):
        print(f"  K5 ({BH}, {C}, {D}): launch (G, JC, JL, TC) = "
              f"{krwkv.wkv_launch_params(BH, C, D)}", flush=True)
        for random_state in (False, True):
            args = k5_inputs(BH, C, D, random_state)
            err = max(err, k5_check(f"({BH}, {C}, {D}) bf16, "
                                    f"{'random' if random_state else 'zero'}"
                                    f" s0", args))
        ms = device_ms(torch, lambda: krwkv.wkv_chunk(*args))
        call_ms = cuda_ms(torch, lambda: krwkv.wkv_chunk(*args))
        bms, by = k5_bound(BH, C, D)
        times[(BH, C, D)] = (ms, bms, by, args)
        print(f"  K5 ({BH}, {C}, {D}) bf16: {ms:.4f} ms device time "
              f"({call_ms:.4f} ms a call from the host), bound {bms:.4f} ms "
              f"({by}), {100 * bms / ms:.1f}% of the bound; power limit "
              f"{power}", flush=True)
    ms, bms, by, args = times[(4 * 32, 1024, 64)]
    pms = cuda_ms(torch, lambda: krwkv.wkv_ref(*args), reps=3)
    print(f"  K5 at rwkv6-1.6b prefill (128, 1024, 64): {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {bms:.4f} ms ({by}); power limit {power}",
          flush=True)
    out["K5"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                     max_abs_err=err, library_ms=None)
    return out


def timed_sync(torch, fn):
    """(result, seconds) of fn() between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def lm_config(arch: str):
    """`get_config(arch)` at full width, with depth cut to LM_CUT[arch]
    layers where one card cannot hold the model (printed)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in LM_CUT:
        print(f"  {arch}: n_layers cut from {cfg.n_layers} to {LM_CUT[arch]} "
              f"(full width), to fit one card", flush=True)
        cfg = dc_replace(cfg, n_layers=LM_CUT[arch])
    return cfg


def moe_routes(log) -> list:
    """A routing log's entries as [(expert sets (T, k) sorted, keep)], one
    per MoE sublayer call."""
    return [(e.sort(dim=-1).values, keep) for e, keep, _ in log]


def drops(routes) -> int:
    return sum(int((~keep).sum()) for _, keep in routes)


class LogitTape:
    """Stands in for the model in a `ServeEngine`: forwards prefill and
    decode_step and keeps each call's last-position logits in float32 and
    its MoE routing (`moe_routes`; empty without experts)."""

    def __init__(self, model):
        self.model, self.device = model, model.device
        self.logits, self.routes = [], []

    def _call(self, fn, *args, **kw):
        from repro_torch.models import moe as tmoe
        with tmoe.routing_log() as log:
            out = fn(*args, **kw)
        self.routes.append(moe_routes(log))
        return out

    def prefill(self, *args, **kw):
        cache, lg = self._call(self.model.prefill, *args, **kw)
        self.logits.append(lg[:, -1].float())
        return cache, lg

    def decode_step(self, *args):
        lg, cache = self._call(self.model.decode_step, *args)
        self.logits.append(lg[:, -1].float())
        return lg, cache


class StaleStateTape(LogitTape):
    """A `LogitTape` with a planted fault, for hymba: the SSM state is not
    carried from step to step (zeroed before each decode step)."""

    def decode_step(self, cache, *args):
        for c in cache["blocks"]:
            c["ssm_h"].zero_()
        return super().decode_step(cache, *args)


def logit_gap(lg_e, lg_f):
    """Per row of the engine's logits lg_e and a forward's lg_f (B, V)
    float32: (|lg_e - lg_f| as a share of the forward's largest |logit|,
    the forward's top-2 gap on the same scale, that scale)."""
    scale = lg_f.abs().amax(-1)
    top2 = lg_f.topk(2, dim=-1).values
    return ((lg_e - lg_f).abs().amax(-1) / scale,
            (top2[:, 0] - top2[:, 1]) / scale, scale)


def hold_step(lg_e, lg_f, toks, tol: float, where: str) -> tuple:
    """The gate of one serving step against a forward over the same
    sequence: each row's greedy token `toks` (B,) is the argmax of the
    engine's logits lg_e, which lie within `tol` of the largest |logit| of
    the forward's lg_f; the token is the forward's argmax unless the
    forward's top-2 gap is at most twice that difference (a near tie).
    Returns (largest difference, near ties, tokens apart from the
    forward's argmax)."""
    diff, gap, scale = logit_gap(lg_e, lg_f)
    near = apart = 0
    for t, t_e, t_f, d, g, sc in zip(
            toks.tolist(), lg_e.argmax(-1).tolist(), lg_f.argmax(-1).tolist(),
            diff.tolist(), gap.tolist(), scale.tolist()):
        at = (f"{where}: token {t} (forward argmax {t_f}, |engine - "
              f"forward| {d:.3e} of the largest |logit| {sc:.3f}, forward "
              f"top-2 gap {g:.3e})")
        if t_e != t:
            raise AssertionError(f"{at}: not the engine's argmax")
        if d > tol:
            raise AssertionError(f"{at}: engine and forward logits differ "
                                 f"beyond {tol}")
        if g <= 2 * d:
            near += 1
            apart += t != t_f
            print(f"    near tie: {at}", flush=True)
        elif t != t_f:
            raise AssertionError(f"{at}: not the forward's argmax")
    return float(diff.max()), near, apart


def greedy_check(torch, model, prompt, out, tape,
                 tol: float = LM_LOGIT_TOL) -> dict:
    """Each token a request served alone was given: the argmax of the
    engine's logits (`tape`), and those logits within `tol` of the
    largest |logit| of a full forward over the sequence so far.  The token
    must be the forward's argmax unless the forward's top-2 gap is at most
    twice the difference of the two at that step.  With experts, a step is
    held to this only where the engine's calls so far (prefill, then one
    token a step) routed every token of the sequence to the same experts as
    the forward did, at every MoE sublayer, and neither dropped a slot: at
    a routing near tie the two paths, which round the router's input
    differently, may choose other experts.  Returns {tokens, exempt (near
    ties), apart (tokens not the forward's argmax, each at a near tie),
    unrouted (routes differ), dropped (steps where either run dropped),
    worst (largest difference as a fraction of the largest |logit|)}."""
    from repro_torch.models import moe as tmoe
    if len(tape.logits) != len(out):
        raise AssertionError(f"{len(tape.logits)} engine calls for "
                             f"{len(out)} tokens")
    seq, res = list(prompt), dict(tokens=len(out), exempt=0, apart=0,
                                  unrouted=0, dropped=0, worst=0.0)
    for i, (t, lg_e) in enumerate(zip(out, tape.logits)):
        with tmoe.routing_log() as log:
            h = model(torch.as_tensor([seq], device=model.device))
        fwd = moe_routes(log)
        eng = [(torch.cat([c[j][0] for c in tape.routes[:i + 1]]),
                torch.cat([c[j][1] for c in tape.routes[:i + 1]]))
               for j in range(len(fwd))]
        if drops(fwd) or drops(eng):
            res["dropped"] += 1
            seq.append(t)
            continue
        if not all(torch.equal(a[0], b[0]) for a, b in zip(eng, fwd)):
            res["unrouted"] += 1
            seq.append(t)
            continue
        lg = model.logits(h[:, -1:])[:, -1].float()
        worst, near, apart = hold_step(lg_e, lg, torch.as_tensor([t]), tol,
                                       f"length {len(seq)}")
        res["worst"] = max(res["worst"], worst)
        res["exempt"] += near
        res["apart"] += apart
        seq.append(t)
    return res


def forward_drift(torch, model, prompt, out, tape) -> float:
    """The largest |engine - forward| (as a share of the forward's largest
    |logit|) over the steps of a request served alone, read, not held."""
    seq, worst = list(prompt), 0.0
    for t, lg_e in zip(out, tape.logits):
        h = model(torch.as_tensor([seq], device=model.device))
        lg = model.logits(h[:, -1:])[:, -1].float()
        worst = max(worst, float(logit_gap(lg_e, lg)[0].max()))
        seq.append(t)
    return worst


def serve_lm(torch, arch: str, counter, dev, card) -> dict:
    """Phase 10 for one architecture: the serving path at full width."""
    from repro_torch.configs import param_count
    from repro_torch.models import build_model
    from repro_torch.models import moe as tmoe
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = lm_config(arch)
    model, t_init = timed_sync(torch, lambda: build_model(cfg, seed=0,
                                                          device=dev))
    n_par = sum(p.numel() for p in model.parameters())
    print(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_par} parameters ({param_count(cfg)} by param_count), "
          f"{sum(p.numel() * p.element_size() for p in model.parameters())} "
          f"bytes; random init {t_init:.3f} s", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        1, cfg.vocab, int(rng.integers(4, 16)))], max_new=LM_NEW)
        for i in range(LM_REQUESTS)]
    # warm-up: build the kernels' libraries, cuBLAS handles, the allocator
    model.prefill(torch.as_tensor([reqs[0].prompt], device=dev), LM_SMAX)

    engine = ServeEngine(model, B=LM_SLOTS, S_max=LM_SMAX, graph=False)
    for r in reqs:
        engine.submit(r)
    counter.launches = 0
    with tmoe.routing_log() as log:
        done, t_serve = timed_sync(torch, lambda: engine.run(
            max_steps=LM_SMAX))
    drop_serve = drops(moe_routes(log))
    toks = sum(len(r.out) for r in done)
    long = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab, (1, LM_LONG)), device=dev)
    before = counter.launches
    with tmoe.routing_log() as log:
        (cache, lg_long), t_long = timed_sync(torch, lambda: model.prefill(
            long, LM_LONG))
    drop_long = drops(moe_routes(log))
    per_prefill = counter.launches - before
    launches = counter.launches
    if len(done) != LM_REQUESTS or any(len(r.out) != LM_NEW for r in done):
        raise AssertionError(f"{arch}: served {[len(r.out) for r in done]}")
    if not torch.isfinite(lg_long).all() or lg_long.shape != (
            1, 1, model.weights.embed.shape[0]):
        raise AssertionError(f"{arch}: bad logits of the long prefill")
    if launches <= 0:
        raise AssertionError(f"{arch}: its kernel was not launched")
    if cfg.family != "ssm" and per_prefill != cfg.n_layers:
        raise AssertionError(f"{arch}: {per_prefill} K4 launches in a "
                             f"prefill, not one a layer ({cfg.n_layers})")
    del cache, lg_long
    print(f"  {arch}: served {len(done)} requests, {toks} tokens in "
          f"{t_serve:.4f} s ({toks / t_serve:.2f} tok/s through {LM_SLOTS} "
          f"slots), prefill of {LM_LONG} tokens {t_long:.4f} s; kernel "
          f"launches {launches}, {per_prefill} in the {LM_LONG}-token "
          f"prefill; card {card}", flush=True)
    if cfg.n_experts:
        print(f"  {arch}: MoE slots dropped (capacity factor "
              f"{cfg.capacity_factor}): {drop_serve} over the served "
              f"requests, {drop_long} in the {LM_LONG}-token prefill",
              flush=True)

    batch = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab, (LM_SLOTS, 15)), device=dev)
    t_pre = []
    for _ in range(3):
        (cache, lg), t = timed_sync(torch, lambda: model.prefill(batch,
                                                                 LM_SMAX))
        t_pre.append(t)
    nxt = lg[:, -1].argmax(-1)[:, None]
    t_dec = []
    for i in range(5):
        (lg, cache), t = timed_sync(torch, lambda: model.decode_step(
            cache, nxt, 15 + i))
        t_dec.append(t)
    print(f"  {arch}: prefill ({LM_SLOTS} x 15 tokens) median "
          f"{statistics.median(t_pre) * 1e3:.3f} ms, decode step ({LM_SLOTS} "
          f"slots) median {statistics.median(t_dec) * 1e3:.3f} ms "
          f"(runs {', '.join(f'{t * 1e3:.3f}' for t in t_dec)})", flush=True)
    profile_run(torch, f"{arch} decode step", lambda: model.decode_step(
        cache, nxt, 20))
    del cache
    _, _, rows = profile_run(torch, f"{arch} prefill of {LM_LONG} tokens",
                             lambda: model.prefill(long, LM_LONG))
    if rows:
        name = "wkv_kernel" if cfg.family == "ssm" else "flash_attention"
        print(f"  {arch} prefill of {LM_LONG} tokens: "
              f"{kernel_share(rows, name)}", flush=True)

    tol = HYMBA_LOGIT_TOL if cfg.family == "hybrid" else LM_LOGIT_TOL
    tot = dict(tokens=0, exempt=0, apart=0, unrouted=0, dropped=0,
               worst=0.0)
    for r in reqs:                  # each request served alone
        tape = LogitTape(model)
        solo = ServeEngine(tape, B=1, S_max=LM_SMAX, graph=False)
        solo.submit(Request(rid=r.rid, prompt=list(r.prompt),
                            max_new=LM_NEW))
        out = solo.run(max_steps=LM_SMAX)[0].out
        res = greedy_check(torch, model, r.prompt, out, tape, tol)
        tot = {k: max(v, res[k]) if k == "worst" else v + res[k]
               for k, v in tot.items()}
    held = tot["tokens"] - tot["unrouted"] - tot["dropped"]
    print(f"  {arch}: greedy continuations of the {len(reqs)} requests, "
          f"each served alone: {held - tot['apart']} of {tot['tokens']} "
          f"tokens the exact argmax of a full forward, {tot['apart']} not "
          f"(each at a near tie); {tot['exempt']} steps near ties, their "
          f"argmax not held; engine logits within {tot['worst']:.3e} of "
          f"the largest |logit| of the forward's (limit {tol})",
          flush=True)
    if cfg.n_experts:
        print(f"  {arch}: of those {tot['tokens']} steps, {held} held to the "
              f"gate; {tot['unrouted']} not, the engine having routed some "
              f"token of the sequence to other experts than the forward "
              f"(a near tie of the router), {tot['dropped']} not, one of the "
              f"two having dropped a slot", flush=True)
    if held <= 0:
        raise AssertionError(f"{arch}: no step was held to the gate")
    if cfg.family == "hybrid":      # the gate must fail a wrong decode
        planted = 0.0
        for r in reqs:
            tape = StaleStateTape(model)
            solo = ServeEngine(tape, B=1, S_max=LM_SMAX, graph=False)
            solo.submit(Request(rid=r.rid, prompt=list(r.prompt),
                                max_new=LM_NEW))
            out = solo.run(max_steps=LM_SMAX)[0].out
            planted = max(planted, forward_drift(torch, model, r.prompt, out,
                                                 tape))
        print(f"  {arch}: planted fault, the SSM state not carried from step "
              f"to step: engine logits up to {planted:.3e} of the largest "
              f"|logit| from the forward's (limit {tol}; the right decode "
              f"{tot['worst']:.3e})", flush=True)
        if planted <= tol:
            raise AssertionError(f"{arch}: a decode that drops its SSM state "
                                 f"reads {planted:.3e}, within the gate's "
                                 f"{tol}")
    del model, engine, solo
    torch.cuda.empty_cache()
    return dict(launches=launches, tok_s=toks / t_serve)


def serve_embedded(torch, arch: str, dev, card) -> int:
    """Phase 10 for an encoder-decoder or vlm model, which the engine does
    not serve (its prefill takes tokens only): `Model.prefill` of
    LM_SLOTS prompts of 16 tokens with their frames or patch embeddings,
    LM_NEW greedy `decode_step`s, each step's logits (the prefill's last
    included) within LM_LOGIT_TOL of the largest |logit| of a forward over
    the sequence so far with the same frames or patches, its token the
    forward's argmax unless the forward's top-2 gap is at most twice the
    difference; then a prefill of LM_LONG tokens (seamless with as many
    frames), with K4 counted (once an attention sublayer) and profiled.
    Returns K4's launches."""
    from repro_torch.kernels import attention as kattn
    from repro_torch.models import build_model
    cfg = lm_config(arch)
    model, t_init = timed_sync(torch, lambda: build_model(cfg, seed=0,
                                                          device=dev))
    print(f"  {arch}: {cfg.n_layers} decoder layers, {cfg.n_enc_layers} "
          f"encoder layers, d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{sum(p.numel() * p.element_size() for p in model.parameters())} "
          f"bytes; random init {t_init:.3f} s", flush=True)
    rng = np.random.default_rng(0)
    key = "frames" if cfg.is_encdec else "vis"

    def embeddings(b, s_):
        rows = s_ if cfg.is_encdec else cfg.n_vis_tokens
        a = rng.normal(size=(b, rows, cfg.d_model)) * EMBED_SCALE
        return {key: torch.as_tensor(a.astype(np.float32), device=dev).to(
            torch.bfloat16)}

    B, P = LM_SLOTS, 16
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (B, P)), device=dev)
    emb = embeddings(B, P)
    per_prefill = cfg.n_enc_layers + cfg.n_layers * (2 if cfg.is_encdec
                                                     else 1)
    model.prefill(prompts, LM_SMAX, **emb)         # warm-up
    kattn.launches = 0
    (cache, lg), t_pre = timed_sync(torch, lambda: model.prefill(
        prompts, LM_SMAX, **emb))
    launches = kattn.launches
    seq, t_dec, worst, near, apart = prompts, [], 0.0, 0, 0
    for i in range(LM_NEW + 1):
        lg_e = lg[:, -1].float()
        lg_f = model.logits(model(seq, **emb)[:, -1:])[:, -1].float()
        tok = lg_e.argmax(-1)
        w, n_near, n_apart = hold_step(lg_e, lg_f, tok, LM_LOGIT_TOL,
                                       f"{arch}: step {i}")
        worst, near, apart = max(worst, w), near + n_near, apart + n_apart
        if i == LM_NEW:
            break
        (lg, cache), t = timed_sync(torch, lambda: model.decode_step(
            cache, tok[:, None], P + i))
        t_dec.append(t)
        seq = torch.cat([seq, tok[:, None]], dim=1)
    t_step = statistics.median(t_dec)
    print(f"  {arch}: prefill of {B} x {P} tokens {t_pre * 1e3:.3f} ms "
          f"(K4 launches {launches}), {LM_NEW} greedy decode steps, median "
          f"{t_step * 1e3:.3f} ms ({B / t_step:.2f} tok/s through {B} "
          f"sequences; runs "
          f"{', '.join(f'{t * 1e3:.3f}' for t in t_dec)}); against a forward "
          f"over the sequence so far: {B * (LM_NEW + 1)} steps within "
          f"{worst:.3e} of the largest |logit| (limit {LM_LOGIT_TOL}), "
          f"{near} near ties, {apart} tokens apart from the forward's argmax;"
          f" card {card}", flush=True)
    if launches != per_prefill:
        raise AssertionError(f"{arch}: {launches} K4 launches in a prefill, "
                             f"not one an attention sublayer ({per_prefill})")
    profile_run(torch, f"{arch} decode step", lambda: model.decode_step(
        cache, tok[:, None], P + LM_NEW))
    del cache, lg, seq, emb

    long = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab, (1, LM_LONG)), device=dev)
    emb = embeddings(1, LM_LONG)
    kattn.launches = 0
    (cache, lg_long), t_long = timed_sync(torch, lambda: model.prefill(
        long, LM_LONG, **emb))
    long_launches = kattn.launches
    if not torch.isfinite(lg_long).all() or lg_long.shape != (
            1, 1, model.weights.embed.shape[0]):
        raise AssertionError(f"{arch}: bad logits of the long prefill")
    if long_launches != per_prefill:
        raise AssertionError(f"{arch}: {long_launches} K4 launches in the "
                             f"{LM_LONG}-token prefill, not {per_prefill}")
    del cache, lg_long
    print(f"  {arch}: prefill of {LM_LONG} tokens ({key} "
          f"{tuple(emb[key].shape)}) {t_long:.4f} s, K4 launches "
          f"{long_launches}; card {card}", flush=True)
    _, _, rows = profile_run(torch, f"{arch} prefill of {LM_LONG} tokens",
                             lambda: model.prefill(long, LM_LONG, **emb))
    if rows:
        print(f"  {arch} prefill of {LM_LONG} tokens: "
              f"{kernel_share(rows, 'flash_attention')}", flush=True)
    del model, emb
    torch.cuda.empty_cache()
    return launches + long_launches


def moe_forward_check(torch, arch: str, dev, card) -> int:
    """Phase 10, a MoE model at full width (depth cut): one prefill and one
    decode step of a request short enough that no expert can overflow its
    capacity, served alone and held to a full forward as `greedy_check`
    holds them.  Returns K4's launches in that run."""
    from repro_torch.kernels import attention as kattn
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = lm_config(arch)
    model, t_init = timed_sync(torch, lambda: build_model(cfg, seed=0,
                                                          device=dev))
    print(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, "
          f"{sum(p.numel() for p in model.parameters())} parameters; random "
          f"init {t_init:.3f} s", flush=True)
    # 6 tokens: a forward over the 7 of the decode step routes at most 7
    # slots to an expert (one a token), inside the least capacity of 8, so
    # neither run can drop a slot and both steps can be held to the gate
    prompt = [int(t) for t in np.random.default_rng(0).integers(
        1, cfg.vocab, 6)]
    tape = LogitTape(model)
    solo = ServeEngine(tape, B=1, S_max=LM_SMAX, graph=False)
    solo.submit(Request(rid=0, prompt=prompt, max_new=2))
    kattn.launches = 0
    out, t = timed_sync(torch, lambda: solo.run(max_steps=LM_SMAX)[0].out)
    launches = kattn.launches
    res = greedy_check(torch, model, prompt, out, tape)
    held = res["tokens"] - res["unrouted"] - res["dropped"]
    print(f"  {arch}: prefill of {len(prompt)} tokens and a decode step "
          f"{t:.4f} s, K4 launches {launches}; against a full forward: "
          f"{held} of {res['tokens']} steps held to the gate ({res['exempt']}"
          f" near ties of the logits, {res['unrouted']} routed apart, "
          f"{res['dropped']} with a dropped slot), logits within "
          f"{res['worst']:.3e} of the largest |logit|; card {card}",
          flush=True)
    if launches != cfg.n_layers or held <= 0:
        raise AssertionError(f"{arch}: K4 launches {launches}, {held} steps "
                             f"held to the gate")
    del model, solo, tape
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 8 ------
def agree(label, got, want, phi_abs, card) -> None:
    """got against want at tests/test_engine.py's rtol 1e-6 / atol 2e-5,
    printing how many values lie past it, and held to that plus 1e-7 of
    sum_j |q_j| / r_ij: the float32 `index_add_` atomics of the upward
    pass and the M2L add in an order that changes from run to run, so two
    runs of the same kernels differ by float32 rounding of the absolute
    terms, not of the potential (which cancels)."""
    diff = np.abs(got - want)
    plain = 2e-5 + 1e-6 * np.abs(want)
    over = int((diff > plain).sum())
    worst = float((diff / (plain + 1e-7 * phi_abs)).max())
    print(f"    {label}: max |diff| {diff.max():.3e}, {over} of {len(want)} "
          f"past rtol 1e-6 / atol 2e-5 (largest ratio "
          f"{float((diff / plain).max()):.3f}); largest |diff| / (that + "
          f"1e-7 sum|q|/r) {worst:.3f}; card {card}", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"{label}: potentials disagree")


def profile_diff(label: str, rows_a, rows_b) -> None:
    """The kernels whose count or device time differs between two profiles
    (by more than 0.1 ms), from profile_run's rows."""
    a = {r[0]: r[1:] for r in rows_a}
    b = {r[0]: r[1:] for r in rows_b}
    out = []
    for key in sorted(set(a) | set(b)):
        (ua, ca), (ub, cb) = a.get(key, (0.0, 0)), b.get(key, (0.0, 0))
        if ca != cb or abs(ub - ua) > 100:
            out.append(f"    x{ca} -> x{cb}, {ua / 1e3:.3f} -> {ub / 1e3:.3f}"
                       f" ms  {key[:100]}")
    print(f"  {label}: {len(out)} kernels differ in count or by > 0.1 ms"
          + "".join("\n" + o for o in out), flush=True)


def kernel_share(rows, name: str) -> str:
    """'<kernel>: <ms> ms, <share>% of the device time' from profile rows."""
    busy = sum(r[1] for r in rows)
    mine = [r for r in rows if name in r[0]]
    if not mine:
        raise AssertionError(f"{name} does not appear in the profile")
    us = sum(r[1] for r in mine)
    return (f"{name} {us / 1e3:.4f} ms x{sum(r[2] for r in mine)}, "
            f"{100 * us / busy:.2f}% of the device time")


def fmm_graph_route(torch, label, geo, stream, cache, idx, d, dev, card,
                    phi_abs=None):
    """Eager against graphed warm evaluates of one route on `geo`: capture,
    pool, medians of 3 with device busy shares, one replay per evaluate,
    the route's kernel in a profiled replay, agreement.  Returns (graphed
    session, eager session, eager potential, phi_abs)."""
    from repro_torch.core.api import FMMSession
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.kernels import p2p as kp2p
    from repro_torch.kernels import p2p_stream as kstream
    eager = FMMSession(geo, device=dev, p2p_stream=stream, fused=False)
    graphed = FMMSession(geo, device=dev, p2p_stream=stream, exe_cache=cache)
    if not graphed.engine.fused or eager.engine.fused:
        raise AssertionError("the card's default is not the compiled path")
    eager.evaluate()
    t_e, t_f = [], []
    for _ in range(3):
        phi_e, t = timed_sync(torch, eager.evaluate)
        t_e.append(t)

    def eager_full():          # the multipoles recomputed, as after a step
        eager.engine._M = None
        return eager.evaluate()

    for _ in range(3):
        t_f.append(timed_sync(torch, eager_full)[1])
    phi_e2 = eager.evaluate()
    if phi_abs is None:
        e = eager.engine
        phi_abs = DeviceEngine(e.tables, e.x.cpu().numpy(),
                               e.q.abs().cpu().numpy(), device=dev,
                               fused=False).evaluate()
    misses = cache.misses
    _, t_cold = timed_sync(torch, graphed.evaluate)
    entry = graphed.engine._entries["evaluate"]
    call = entry.call
    if cache.misses != misses + 1 or call.graph is None:
        raise AssertionError(f"{label}: no capture on the first evaluate")
    kern, counter = ("K2", kstream) if stream else ("K1", kp2p)
    per = entry.launches.get(kern, 0)
    print(f"  {label}: capture {call.capture_s:.4f} s (warm-up of 2 and "
          f"capture; first evaluate {t_cold:.4f} s); memory_reserved "
          f"{call.reserved_before / 2**30:.3f} GiB before the capture, "
          f"{call.reserved_after / 2**30:.3f} GiB after: pool "
          f"{call.pool_bytes / 2**30:.3f} GiB; launches a replay "
          f"{entry.launches}; card {card}", flush=True)
    counter.launches = 0
    calls, log = entry.calls, len(graphed.engine.launch_log)
    t_g = []
    for _ in range(3):
        phi_g, t = timed_sync(torch, graphed.evaluate)
        t_g.append(t)
    launched = counter.launches
    replays = entry.calls - calls
    kinds = [k for k, _ in graphed.engine.launch_log[log:]]
    print(f"  {label}: warm evaluate, median of 3: eager "
          f"{statistics.median(t_e):.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in t_e)}; the multipoles cached "
          f"per payload), eager with the upward pass "
          f"{statistics.median(t_f):.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in t_f)}), graphed "
          f"{statistics.median(t_g):.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in t_g)}); {replays} replays for 3 "
          f"evaluates, {kern} launches {launched} ({per} a replay); card "
          f"{card}", flush=True)
    if replays != 3 or kinds != ["evaluate"] * 3 or per <= 0 \
            or launched != 3 * per:
        raise AssertionError(f"{label}: not one replay per warm evaluate "
                             f"({replays}, {kinds}, {kern} {launched})")
    _, _, rows_e = profile_run(torch, f"{label} eager evaluate",
                               eager_full, top=4)
    _, _, rows = profile_run(torch, f"{label} graphed evaluate",
                             graphed.evaluate, top=4)
    profile_diff(f"{label}: graphed replay against the eager evaluate with "
                 f"the upward pass", rows_e, rows)
    name = "p2p_stream_kernel" if stream else "p2p_gathered_kernel"
    print(f"  {label} graphed replay: {kernel_share(rows, name)} ({kern}); "
          f"card {card}", flush=True)
    agree(f"{label} graphed vs eager", phi_g, phi_e, phi_abs, card)
    agree(f"{label} eager vs eager (run to run)", phi_e2, phi_e, phi_abs,
          card)
    if d is not None:
        rel = float(np.linalg.norm(phi_g[idx] - d) / np.linalg.norm(d))
        print(f"  {label} graphed: rel-L2 vs direct sum {rel:.3e}; card "
              f"{card}", flush=True)
        if not rel < 3e-3:
            raise AssertionError(f"{label}: rel-L2 {rel} >= 3e-3")
    return graphed, eager, phi_e, phi_abs


def compiled_fmm(torch, geo, x, q, spec, idx, d, dev, card) -> None:
    """Phase 8, FMM: both routes at N, a second geometry of the same shape
    class, within-slack steps, and N = 2^15."""
    from repro_torch.core.api import FMMSession, plan_geometry
    from repro_torch.core.distributions import make_distribution
    from repro_torch.core.engine import ExecutableCache, shape_class_digest
    from repro_torch.core.engine import fused as fmod
    from repro_torch.core.fmm import direct_potential
    n = len(x)
    cache_s = ExecutableCache()
    fmm_graph_route(torch, f"stream (K2), N = {n}", geo, True, cache_s, idx,
                    d, dev, card)
    del cache_s
    torch.cuda.empty_cache()
    cache = ExecutableCache()
    graphed, eager, phi_e, phi_abs = fmm_graph_route(
        torch, f"gathered (K1), N = {n}", geo, False, cache, idx, d, dev,
        card)

    # -- a second geometry of the same shape class: the points reflected --
    geo_b, t_plan = timed_sync(torch, lambda: plan_geometry(-x, q, spec,
                                                            device=dev))
    sess_b = FMMSession(geo_b, device=dev, exe_cache=cache)
    eager_b = FMMSession(geo_b, device=dev, fused=False)
    fa = fmod.flatten_eval_tables(graphed.engine.tables)
    fb = fmod.flatten_eval_tables(sess_b.engine.tables)
    differ = [k for k in fa if not torch.equal(fa[k], fb[k])]
    if shape_class_digest(fa) != shape_class_digest(fb) or not differ:
        raise AssertionError("the reflected geometry is not another "
                             "geometry of the same shape class")
    stats = cache.stats()
    entry = sess_b.engine._fused_entry("evaluate")
    if entry is not graphed.engine._entries["evaluate"] \
            or cache.misses != stats["misses"] \
            or cache.hits != stats["hits"] + 1:
        raise AssertionError(f"second geometry: {cache.stats()} after "
                             f"{stats}")
    graphed.evaluate()                          # the entry holds A's tables
    _, t_rebind = timed_sync(torch, lambda: sess_b.engine._bind(
        entry, "evaluate"))
    tab_bytes = sum(v.numel() * v.element_size() for v in fb.values())
    print(f"  second geometry (the points reflected through the origin, "
          f"planned in {t_plan:.3f} s): same digest, {len(differ)} of "
          f"{len(fa)} tables differ; cache {cache.stats()} (no capture, "
          f"one hit); rebind copy of {tab_bytes / 2**30:.3f} GiB of tables "
          f"and the payload {t_rebind * 1e3:.3f} ms; card {card}",
          flush=True)
    phi_eb = eager_b.evaluate()
    for sess, want, tag in [(graphed, phi_e, "A"), (sess_b, phi_eb, "B")] * 2:
        (phi, t) = timed_sync(torch, sess.evaluate)
        agree(f"geometry {tag} graphed ({t:.4f} s, rebinds "
              f"{entry.rebinds}) vs its eager", phi, want, phi_abs, card)
    rel = float(np.linalg.norm(phi[idx] - d) / np.linalg.norm(d))
    print(f"  geometry B: rel-L2 vs the direct sum (reflection-invariant) "
          f"{rel:.3e}; card {card}", flush=True)
    if not rel < 3e-3:
        raise AssertionError(f"geometry B: rel-L2 {rel}")
    del sess_b, eager_b, geo_b, fa, fb
    torch.cuda.empty_cache()

    # -- within-slack steps: graphed against eager -------------------------
    eps = float(geo.slack.min())
    rng = np.random.default_rng(2)
    decided = []
    real = graphed.engine.refresh_payload

    def spy(geometry, *, use_pending=False):
        decided.append(use_pending)
        return real(geometry, use_pending=use_pending)

    graphed.engine.refresh_payload = spy
    for k in range(3):
        xk = x + rng.uniform(-eps / 4, eps / 4, x.shape)
        entry_s = graphed.engine._entries.get("step")
        calls = 0 if entry_s is None else entry_s.calls
        rg, t_g = timed_sync(torch, lambda: graphed.step(xk))
        re_, t_e = timed_sync(torch, lambda: eager.step(xk))
        replays = graphed.engine._entries["step"].calls - calls
        phi_g, tg = timed_sync(torch, graphed.evaluate)
        phi_e, te = timed_sync(torch, eager.evaluate)
        print(f"  within-slack step {k + 1}: graphed {t_g:.4f} s ({replays} "
              f"replay of the step), eager {t_e:.4f} s; evaluate after it "
              f"graphed {tg:.4f} s, eager {te:.4f} s; card {card}",
              flush=True)
        if rg.rebuilt != () or rg.refreshed != re_.refreshed or replays != 1:
            raise AssertionError(f"step {k + 1}: {rg}, {re_}, {replays}")
        agree(f"after step {k + 1}, graphed vs eager", phi_g, phi_e, phi_abs,
              card)
    print(f"  steps that took the device decision: {sum(decided)} of "
          f"{len(decided)} (the rest revalidated on the host in float64, "
          f"the drift within the float32 guard band); card {card}",
          flush=True)
    del graphed, eager, cache
    torch.cuda.empty_cache()

    # -- N = 2^15, 8 parts: where the host bounds the eager evaluate -------
    m = 1 << 15
    xm = make_distribution("sphere", m, seed=42)
    qm = np.random.default_rng(0).uniform(-1, 1, m)
    geo_m = plan_geometry(xm, qm, spec, device=dev)
    im = np.random.default_rng(1).choice(m, size=4096, replace=False)
    dm = direct_potential(xm, qm, x_tgt=xm[im], chunk=64, device=dev)
    g, e, _, _ = fmm_graph_route(torch, f"gathered (K1), N = {m}", geo_m,
                                 False, ExecutableCache(), im, dm, dev, card)
    del g, e
    torch.cuda.empty_cache()


class LogitRecorder:
    """Keeps a float32 copy of the logits of every call a ServeEngine makes
    (prefill and decode) by wrapping its `_emit`."""

    def __init__(self, engine):
        self.logits = []
        real = engine._emit

        def emit(logits):
            self.logits.append(logits[:, -1].float().clone())
            real(logits)

        engine._emit = emit


def lm_graph(torch, arch: str, dev, card) -> None:
    """Phase 8, LM: ServeEngine with the decode step as one graph replay
    against the eager step, on phase 10's traffic."""
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.kernels import rwkv as krwkv
    cfg = lm_config(arch)
    model = build_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, int(
        rng.integers(4, 16)))] for _ in range(LM_REQUESTS)]
    model.prefill(torch.as_tensor([prompts[0]], device=dev), LM_SMAX)
    res = {}
    for label, graph in (("eager", False), ("graphed", True)):
        eng = ServeEngine(model, B=LM_SLOTS, S_max=LM_SMAX, graph=graph)
        rec = LogitRecorder(eng)
        runs = []
        for run in range(2):
            reqs = [Request(rid=i, prompt=list(p), max_new=LM_NEW)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            krwkv.launches = 0
            _, t = timed_sync(torch, lambda: eng.run(max_steps=LM_SMAX))
            toks = {r.rid: list(r.out) for r in reqs}
            runs.append((toks, t, krwkv.launches))
        res[label] = (eng, rec, runs)
    (eng_e, rec_e, runs_e), (eng_g, rec_g, runs_g) = res["eager"], \
        res["graphed"]
    n_tok = LM_REQUESTS * LM_NEW
    same = all(r[0] == runs_e[0][0] for r in runs_e + runs_g)
    n_calls = len(rec_e.logits)
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(rec_g.logits, rec_e.logits))
    call = eng_g.decode_call
    print(f"  {arch}: graphed and eager ServeEngine tokens "
          f"{'identical' if same else 'DIFFER'} for all {LM_REQUESTS} "
          f"requests over 2 runs each; logits of {len(rec_g.logits)} / "
          f"{n_calls} calls, largest difference {worst:.3e} of the largest "
          f"|logit|; card {card}", flush=True)
    if not same or len(rec_g.logits) != n_calls or worst > 1e-3:
        raise AssertionError(f"{arch}: graphed and eager serving differ")
    print(f"  {arch}: capture {call.capture_s:.4f} s, memory_reserved "
          f"{call.reserved_before / 2**30:.3f} -> "
          f"{call.reserved_after / 2**30:.3f} GiB (pool "
          f"{call.pool_bytes / 2**20:.1f} MiB); launches a replay "
          f"{call.launches}; card {card}", flush=True)
    if "K4" in call.launches or (cfg.family == "ssm" and call.launches.get(
            "K5") != cfg.n_layers):
        raise AssertionError(f"{arch}: captured launches {call.launches}")
    for label, runs, note in (("eager", runs_e, ""),
                              ("graphed", runs_g, ", capture included")):
        (_, t1, _), (_, t2, k5) = runs
        print(f"  {arch} {label}: {n_tok} tokens, first run {t1:.4f} s "
              f"({n_tok / t1:.2f} tok/s{note}), warm run {t2:.4f} s "
              f"({n_tok / t2:.2f} tok/s); K5 launches on the warm run {k5}; "
              f"card {card}", flush=True)

    batch = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab, (LM_SLOTS, 15)), device=dev)
    cache, lg = model.prefill(batch, LM_SMAX)
    nxt = lg[:, -1].argmax(-1)[:, None]
    st = eng_g._static
    eng_g._bind_cache(cache)
    st["tokens"].copy_(nxt)
    t_e, t_g = [], []
    for i in range(5):
        _, t = timed_sync(torch, lambda: model.decode_step(cache, nxt,
                                                           15 + i))
        t_e.append(t)
        st["pos"].fill_(15 + i)
        _, t = timed_sync(torch, call.replay)
        t_g.append(t)
    k5 = krwkv.launches
    call.replay()
    k5 = krwkv.launches - k5
    print(f"  {arch}: decode step ({LM_SLOTS} slots), median of 5: eager "
          f"{statistics.median(t_e) * 1e3:.3f} ms, graphed replay "
          f"{statistics.median(t_g) * 1e3:.3f} ms (runs "
          f"{', '.join(f'{t * 1e3:.3f}' for t in t_g)}); K5 launches a "
          f"replay {k5}; card {card}", flush=True)
    profile_run(torch, f"{arch} eager decode step",
                lambda: model.decode_step(cache, nxt, 20), top=3)
    profile_run(torch, f"{arch} graphed decode step", call.replay, top=3)
    del model, cache, eng_e, eng_g, rec_e, rec_g, st, call
    torch.cuda.empty_cache()


# ----------------------------------------------------------- phase 8b ------
REPORT_KEYS = {"obs", "timings", "metrics", "memo", "exe_cache", "geometry",
               "resilience", "launches", "exchange"}
PHASE_SPANS = ("engine.upward", "engine.far_field", "engine.p2p_bucket",
               "engine.m2p")


def traced_replays(torch, label, geo, dev, card) -> None:
    """What tracing costs a warm graphed (gathered) evaluate: medians of 3
    with obs disabled, enabled, and enabled with fences, each checked to be
    one replay per evaluate (entry calls, K1 launches)."""
    from repro_torch import obs
    from repro_torch.core.api import FMMSession
    from repro_torch.core.engine import ExecutableCache
    from repro_torch.kernels import p2p as kp2p
    sess = FMMSession(geo, device=dev, exe_cache=ExecutableCache())
    sess.evaluate()                                 # capture
    entry = sess.engine._entries["evaluate"]
    per = entry.launches.get("K1", 0)
    med = {}
    for mode, kw in (("disabled", None), ("enabled", {}),
                     ("enabled + fences", {"fences": True})):
        if kw is None:
            obs.configure(enabled=False)
        else:
            obs.configure(enabled=True, **kw)
        calls = entry.calls
        kp2p.launches = 0
        times = [timed_sync(torch, sess.evaluate)[1] for _ in range(3)]
        launched = kp2p.launches
        med[mode] = statistics.median(times)
        print(f"  {label}, obs {mode}: warm graphed evaluate median "
              f"{med[mode]:.5f} s (runs {', '.join(f'{t:.5f}' for t in times)}"
              f"); {entry.calls - calls} replays for 3 evaluates, K1 "
              f"launches {launched} ({per} a replay); card {card}",
              flush=True)
        if entry.calls - calls != 3 or per <= 0 or launched != 3 * per:
            raise AssertionError(f"{label}, obs {mode}: not one replay per "
                                 f"warm evaluate")
    obs.configure(enabled=False)
    obs.reset()
    print(f"  {label}: tracing adds {med['enabled'] - med['disabled']:+.5f} "
          f"s, with fences {med['enabled + fences'] - med['disabled']:+.5f} "
          f"s to the {med['disabled']:.5f} s untraced evaluate; card {card}",
          flush=True)
    del sess, entry
    torch.cuda.empty_cache()


def chaos_case(torch, label, make, site, counter, clean, phi_abs, card,
               arm=None) -> None:
    """One site of the chaos matrix, resilience on: arm it (with `arm`, a
    context manager, in place of `inject_faults(site)`), evaluate with the
    kernel counter set to 0 just before and read just after, print the
    fallbacks, retries and launches, and hold the potential to the clean
    one at phase 8's gate."""
    from repro_torch.resilience import ResilienceError, inject_faults
    from repro_torch.resilience import fallback as res_fb
    sess = make()
    retried = res_fb.retry_total()
    rung = sess._current_rung()
    cm = arm if arm is not None else inject_faults(site)
    counter.launches = 0
    typed = None
    t0 = time.perf_counter()
    try:
        with cm:
            phi = sess.evaluate()
    except ResilienceError as exc:
        typed = exc
    dt = time.perf_counter() - t0
    st = sess.resilience
    fb = [(f["site"], f["from"], f["to"]) for f in st.fallbacks]
    print(f"  chaos {label}: {rung} -> rung {st.rung}, fallbacks {fb}, "
          f"retries {res_fb.retry_total() - retried}, typed error "
          f"{None if typed is None else typed.site}, {counter.__name__} "
          f"launches {counter.launches}; {dt:.3f} s; card {card}",
          flush=True)
    if typed is not None:
        counter.launches = 0
        phi = sess.evaluate()                       # the fault is spent
        print(f"    evaluated again on rung {st.rung}: "
              f"{counter.__name__} launches {counter.launches}", flush=True)
    if counter.launches <= 0:
        raise AssertionError(f"chaos {label}: the serving rung launched no "
                             f"{counter.__name__}")
    agree(f"chaos {label} vs the clean potential", phi, clean, phi_abs, card)
    return sess


def obs_resilience(torch, geo, spec, x, q, dev, card, out_dir) -> None:
    """Phase 8b: tracing's cost, fenced phase times, report() and the
    chrome trace, the chaos matrix with resilience on, and the counters
    gate on the card."""
    from repro_torch import obs
    from repro_torch.core.api import FMMSession, plan_geometry
    from repro_torch.core.distributions import make_distribution
    from repro_torch.core.engine import DeviceEngine, ExecutableCache
    from repro_torch.kernels import p2p as kp2p
    from repro_torch.launch.mesh import stacked_mesh
    from repro_torch.resilience import RetryPolicy
    from repro_torch.resilience import fallback as res_fb
    from repro_torch.resilience import faults as res_faults
    n = len(x)

    # -- 1. what tracing costs, at N and at 2^15 ---------------------------
    traced_replays(torch, f"N = {n}", geo, dev, card)
    m = 1 << 15
    xm = make_distribution("sphere", m, seed=42)
    qm = np.random.default_rng(0).uniform(-1, 1, m)
    traced_replays(torch, f"N = {m}", plan_geometry(xm, qm, spec,
                                                    device=dev), dev, card)

    # -- 2. fenced phase times of one per-phase evaluate -------------------
    tracer = obs.configure(enabled=True, fences=True)
    eager = FMMSession(geo, device=dev, fused=False)
    eager.evaluate()
    tracer.clear()
    eager.engine._M = None                  # the upward pass recomputed
    clean, t_wall = timed_sync(torch, eager.evaluate)
    spans = {}
    for s in tracer.spans():
        spans.setdefault(s.name, []).append(s.dur_s)
    parts = ", ".join(f"{k} {sum(spans.get(k, [0.0])):.5f} s"
                      + (f" (x{len(spans[k])}: "
                         + ", ".join(f"{v:.5f}" for v in spans[k]) + ")"
                         if len(spans.get(k, [])) > 1 else "")
                      for k in PHASE_SPANS)
    print(f"  fenced phases of one per-phase evaluate at N = {n}: {parts}; "
          f"session.evaluate {sum(spans['session.evaluate']):.5f} s, wall "
          f"{t_wall:.5f} s; card {card}", flush=True)
    if len(spans.get("engine.p2p_bucket", [])) != \
            len(eager.engine.tables.p2p_buckets) or any(
                k not in spans for k in PHASE_SPANS):
        raise AssertionError(f"fenced phases missing: {sorted(spans)}")
    e = eager.engine
    phi_abs = DeviceEngine(e.tables, e.x.cpu().numpy(),
                           e.q.abs().cpu().numpy(), device=dev,
                           fused=False).evaluate()

    # -- 3. report() and the chrome trace ----------------------------------
    rep = eager.report()
    if set(rep) != REPORT_KEYS:
        raise AssertionError(f"report() keys {sorted(rep)}")
    ct = tracer.to_chrome_trace()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "phase8b_trace.json"
    path.write_text(json.dumps(ct, default=str))
    print(f"  report(): keys {sorted(rep)}; chrome trace "
          f"{out_dir.name}/{path.name}: {len(ct['traceEvents'])} events, "
          f"dropped {ct['otherData']['dropped_events']}", flush=True)
    del eager, e
    obs.configure(enabled=True)             # counters on, no fences
    obs.reset()

    # -- 4. the chaos matrix, resilience on --------------------------------
    res_faults.reset_stats()
    res_fb.reset_ledger()
    cache = ExecutableCache()
    quick = RetryPolicy(sleep=lambda s: None)

    def session(**kw):
        s = FMMSession(geo, device=dev, resilience=True, exe_cache=cache,
                       **kw)
        s.resilience.retry = quick
        return s

    @contextmanager
    def armed_in_capture(site):
        """Arm `site` once the capture has begun (past the warm-up), so
        the fault is raised inside `torch.cuda.graph`."""
        real = torch.cuda.graph

        @contextmanager
        def graph(*a, **kw):
            with real(*a, **kw):
                res_faults.arm(res_faults.FaultPlan({site: {}}))
                yield

        torch.cuda.graph = graph
        try:
            yield
        finally:
            torch.cuda.graph = real
            res_faults.disarm()

    reserved = torch.cuda.memory_reserved(dev)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always", RuntimeWarning)
        # exe_cache.compile, transient: retried, then one capture
        s = chaos_case(torch, "exe_cache.compile (transient)",
                       lambda: session(), "exe_cache.compile", kp2p, clean,
                       phi_abs, card, arm=res_faults.inject_faults(
                           {"exe_cache.compile": {"transient": True}}))
        if s.resilience.degraded or cache.misses != 1 or len(cache) != 1:
            raise AssertionError(f"transient capture fault: {cache.stats()}")
        del s
        # kernels.p2p.launch raised inside the capture of a fresh shape
        # class (its own cache): one rung down, nothing cached, card usable
        own = ExecutableCache()
        s = chaos_case(torch, "kernels.p2p.launch (in the capture)",
                       lambda: FMMSession(geo, device=dev, resilience=True,
                                          exe_cache=own),
                       "kernels.p2p.launch", kp2p, clean, phi_abs, card,
                       arm=armed_in_capture("kernels.p2p.launch"))
        if len(own) != 0 or s.resilience.fallbacks[0]["to"] != "per_phase":
            raise AssertionError(f"capture fault: {own.stats()}, "
                                 f"{s.resilience.fallbacks}")
        del s, own
        torch.cuda.empty_cache()
        for label, kw, site in (
                ("fused.launch (stream session)", dict(p2p_stream=True),
                 "fused.launch"),
                ("p2p.stream.tables", dict(p2p_stream=True),
                 "p2p.stream.tables")):
            s = chaos_case(torch, label, lambda: session(**kw), site, kp2p,
                           clean, phi_abs, card)
            if [(f["from"], f["to"]) for f in s.resilience.fallbacks] != \
                    [("streaming", "gathered")]:
                raise AssertionError(f"{label}: {s.resilience.fallbacks}")
            del s
        s = chaos_case(torch, "memo.upload (engine=False)",
                       lambda: session(engine=False), "memo.upload", kp2p,
                       clean, phi_abs, card)
        del s
        s = chaos_case(torch, "dist.build_program (4 stacked ranks, bulk)",
                       lambda: session(mesh=stacked_mesh(4, dev)),
                       "dist.build_program", kp2p, clean, phi_abs, card)
        if [(f["from"], f["to"]) for f in s.resilience.fallbacks] != \
                [("dist", "gathered")]:
            raise AssertionError(f"dist: {s.resilience.fallbacks}")
        del s
    fired = res_faults.fired_total()
    led = res_fb.ledger_counts()
    fallbacks, typed = res_fb.fallback_total(), res_fb.typed_error_total()
    retries = res_fb.retry_total()
    print(f"  chaos accounting: faults fired {res_faults.fired_counts()} "
          f"({fired}) = counted fallbacks {fallbacks} + typed errors {typed} "
          f"+ retries of transients {retries}; ledgers {led}; "
          f"{len(warned)} RuntimeWarnings (one per transition); "
          f"memory_reserved {reserved / 2**30:.3f} GiB before the matrix, "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB after "
          f"(the matrix's gathered entry held by its cache); card {card}",
          flush=True)
    if fired != fallbacks + typed + retries or fired != 6:
        raise AssertionError("chaos accounting identity broken")
    obs.configure(enabled=False)
    obs.reset()
    del cache
    torch.cuda.empty_cache()

    # -- 5. the counters gate on the card ----------------------------------
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.check_counters",
         "--out", str(out_dir / "check_counters")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    for line in gate.stdout.strip().splitlines():
        print(f"  gate: {line}", flush=True)
    if gate.returncode != 0:
        print(gate.stderr[-3000:], file=sys.stderr)
        raise AssertionError(f"check_counters exited {gate.returncode}")


# ----------------------------------------------------------- phase 7b ------
DIST_RANKS = (4, 8)          # ranks stacked on the card: 2 and 1 parts each


def dist_k1_checks(torch, kp2p, sess, protocol, card) -> float:
    """K1 against its plain version on every launch of one dist evaluation
    (each rank's buckets, gathered after a real exchange), at phase 3's
    tolerance (check_close's), one line a bucket over the ranks; returns
    the largest |K1 - plain|."""
    per = {}
    for r, bi, qs, xs, xt in sess.dist.near_field_operands(protocol):
        got = kp2p.p2p(qs, xs, xt)
        want = kp2p.p2p_ref(qs, xs, xt)
        err = (got - want).abs()
        tol = RTOL_KERNEL * (want.abs() + kp2p.p2p_ref(qs.abs(), xs, xt))
        P, S = qs.shape
        b = per.setdefault(bi, {"shape": (P, xt.shape[1], S), "ranks": 0,
                                "err": 0.0, "bad": 0})
        b["ranks"] += 1
        b["err"] = max(b["err"], float(err.max()))
        b["bad"] += int((err > tol).sum())
        del got, want, err, tol
    for bi, b in per.items():
        P, T, S = b["shape"]
        print(f"  K1 on the dist path, bucket {bi} (rows {P} a rank, T {T}, "
              f"S {S}, {kp2p.p2p_launch_params(P)} warps a block) on "
              f"{b['ranks']} ranks: max_abs_err {b['err']:.3e}, over "
              f"tolerance {b['bad']}; card {card}", flush=True)
        if b["bad"]:
            raise AssertionError(f"K1 dist bucket {bi}: {b['bad']} values "
                                 f"outside tolerance")
    return max(b["err"] for b in per.values())


def dist_exchange(torch, geo, x, q, idx, d, dev, card) -> float:
    """Phase 7b: the multi-rank LET exchange, ranks stacked on the card, for
    each of DIST_RANKS and each protocol, against the eager engine and the
    direct sum; one within-slack step of the mesh session.  Returns K1's
    largest |K1 - plain| on the dist path."""
    from repro_torch.core.api import FMMSession
    from repro_torch.core.dist import DIST_PROTOCOLS
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.fmm import direct_potential
    from repro_torch.kernels import p2p as kp2p
    from repro_torch.launch.mesh import stacked_mesh
    eager = FMMSession(geo, device=dev, fused=False)
    phi_e = eager.evaluate()
    e = eager.engine
    phi_abs = DeviceEngine(e.tables, e.x.cpu().numpy(),
                           e.q.abs().cpu().numpy(), device=dev,
                           fused=False).evaluate()
    e._M = None                     # recompute the multipoles, as dist does
    agree("eager engine vs itself (run to run, upward recomputed)",
          eager.evaluate(), phi_e, phi_abs, card)
    del eager, e
    eps = float(geo.slack.min())
    x1 = x + np.random.default_rng(5).uniform(-eps / 4, eps / 4, x.shape)
    d1 = direct_potential(x1, q, x_tgt=x1[idx], chunk=64, device=dev)
    k1_err = 0.0
    for D in DIST_RANKS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        sess = FMMSession(geo, device=dev, mesh=stacked_mesh(D, dev))
        eng, t_build = timed_sync(torch, lambda: sess.dist)
        lay = eng.layout
        print(f"  D = {D} ranks stacked on the card ({lay.parts_per_rank} "
              f"parts a rank): ShardedEngine built in {t_build:.3f} s "
              f"(NumPy tables and upload); {len(lay.pairs)} inter-rank "
              f"spans, {lay.total_words * 4 / 1e6:.3f} MB a pool; "
              f"{len(eng.p2p_buckets)} P2P buckets a rank (rows "
              f"{[int(b['mask'].shape[1]) for b in eng.p2p_buckets]}); "
              f"card {card}", flush=True)
        for protocol in DIST_PROTOCOLS:
            sess.dist_protocol = protocol
            prog, t_prog = timed_sync(torch, lambda: eng.program(protocol))
            _, t_cold = timed_sync(torch, sess.evaluate)
            warm, calls = [], []
            for _ in range(3):
                kp2p.launches = 0
                phi, t = timed_sync(torch, sess.evaluate)
                calls.append(kp2p.launches)
                warm.append(t)
            per_call = calls[0]
            spans = eng.verify_exchange(protocol)
            st = eng.measure_exchange(protocol, reps=3)
            print(f"  D {D} {protocol}: program built in {t_prog:.3f} s, "
                  f"{prog.n_rounds} rounds; evaluate cold {t_cold:.4f} s, "
                  f"warm median {statistics.median(warm):.4f} s (runs "
                  f"{', '.join(f'{w:.4f}' for w in warm)}); K1 launches a "
                  f"call {per_call} ({D} ranks x {len(eng.p2p_buckets)} "
                  f"buckets); verify_exchange: {spans} of "
                  f"{len(lay.pairs)} spans word-exact; card {card}",
                  flush=True)
            print(f"  D {D} {protocol}: moved {st['moved_bytes'] / 1e6:.3f} "
                  f"MB, delivered {st['delivered_bytes'] / 1e6:.3f} MB, "
                  f"padded wire {st['padded_wire_bytes'] / 1e6:.3f} MB; "
                  f"exchange alone (copies within the card's memory, not a "
                  f"network) {st['measured_s'] * 1e3:.4f} ms, mean of 3 "
                  f"after a warm-up; LogGP prediction for a wire "
                  f"{st['loggp_s'] * 1e3:.4f} ms; card {card}", flush=True)
            if calls != [D * len(eng.p2p_buckets)] * 3 or per_call <= 0:
                raise AssertionError(f"D {D} {protocol}: K1 launched "
                                     f"{per_call} times a call")
            if spans != len(lay.pairs) or not prog.n_rounds:
                raise AssertionError(f"D {D} {protocol}: {spans} spans, "
                                     f"{prog.n_rounds} rounds")
            if phi.shape != (len(x),) or not np.isfinite(phi).all():
                raise AssertionError(f"D {D} {protocol}: bad potential")
            agree(f"D {D} {protocol} vs the eager engine", phi, phi_e,
                  phi_abs, card)
            rel = float(np.linalg.norm(phi[idx] - d) / np.linalg.norm(d))
            print(f"  D {D} {protocol}: rel-L2 vs direct sum {rel:.3e}",
                  flush=True)
            if not rel < 3e-3:
                raise AssertionError(f"D {D} {protocol}: rel-L2 {rel}")
        peak = torch.cuda.max_memory_allocated(dev) - base
        print(f"  D {D}: peak memory_allocated over the build and the "
              f"evaluates {peak / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held before; card {card}", flush=True)
        k1_err = max(k1_err, dist_k1_checks(torch, kp2p, sess, "hsdx", card))

        rep, t_step = timed_sync(torch, lambda: sess.step(x1))
        if rep.rebuilt != () or len(rep.refreshed) != geo.nparts \
                or sess.dist is not eng:
            raise AssertionError(f"D {D} within-slack step: {rep}")
        for protocol in DIST_PROTOCOLS:
            sess.dist_protocol = protocol
            phi1, t_eval = timed_sync(torch, sess.evaluate)
            rel = float(np.linalg.norm(phi1[idx] - d1) / np.linalg.norm(d1))
            print(f"  D {D} within-slack step ({t_step:.4f} s, every "
                  f"partition refreshed, the dist engine kept), then "
                  f"{protocol} evaluate {t_eval:.4f} s: rel-L2 vs direct sum "
                  f"at the stepped positions {rel:.3e}; card {card}",
                  flush=True)
            if not (np.isfinite(phi1).all() and rel < 3e-3):
                raise AssertionError(f"D {D} step {protocol}: rel-L2 {rel}")
        del sess, eng, phi, phi1
    torch.cuda.empty_cache()
    return k1_err


# ------------------------------------------------------------ phase 11 -----
@contextmanager
def patched(module, name: str, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextmanager
def events_of(torch, module, name: str, acc: list):
    """Time every call of module.name on the device with CUDA events (no
    synchronisation): appends (start, end) event pairs to acc; read them
    with `events_ms` after a synchronisation."""
    real = getattr(module, name)

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kw)
        b.record()
        acc.append((a, b))
        return out

    with patched(module, name, timed):
        yield acc


def events_ms(acc: list) -> float:
    return sum(a.elapsed_time(b) for a, b in acc)


def grad_errors(torch, kernel: str, names, got, want) -> None:
    """Each gradient against its plain counterpart: max |error| and the
    relative L2 error, held to GRAD_MAX_REL / GRAD_REL_L2."""
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{kernel} d{name}: shape {tuple(g.shape)} "
                                 f"or non-finite values")
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        rel = float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w).clamp_min(1e-30))
        print(f"    d{name}: max |err| {err:.3e} (max |plain| {scale:.3e}, "
              f"{err / max(scale, 1e-30):.3e} of it), relative L2 {rel:.3e}",
              flush=True)
        if rel > GRAD_REL_L2[kernel] or err > GRAD_MAX_REL[kernel] * scale:
            raise AssertionError(f"{kernel} d{name}: relative L2 {rel:.3e} "
                                 f"(limit {GRAD_REL_L2[kernel]}) or max "
                                 f"{err:.3e} over {GRAD_MAX_REL[kernel]} x "
                                 f"{scale:.3e}")


def kernel_gradients(torch, kattn, krwkv, dev, power) -> None:
    """Phase 11 (a): K4's and K5's autograd Functions against autograd
    through their plain versions, on the card, at training shapes; each
    backward timed beside its forward (CUDA events)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(11)
    bf16 = torch.bfloat16

    def normal(shape, dtype=bf16, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.as_tensor(a, device=dev).to(dtype)

    def grads(fn, inputs, outs_grad):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, leaves, outs_grad)

    for label, (b, h, hk, sq, sk, d), causal, window in K4_GRAD_CASES:
        q = normal((b, h, sq, d))
        k, v = normal((b, hk, sk, d)), normal((b, hk, sk, d))
        do = normal((b, h, sq, d))
        n0 = kattn.backward_calls
        got = grads(lambda *t: kattn.flash_attention(
            *t, causal=causal, window=window), (q, k, v), do)
        if kattn.backward_calls != n0 + 1:
            raise AssertionError("K4's backward did not run")
        want = grads(lambda *t: kattn.attention_rounded_ref(
            *t, causal=causal, window=window), (q, k, v), do)
        shape = f"q {(b, h, sq, d)}, k/v {(b, hk, sk, d)}"
        print(f"  K4 gradient at {label} ({shape}, bf16, "
              f"{'causal' if causal else 'no mask'}"
              f"{f', window {window}' if window else ''}) against autograd "
              f"through attention_rounded_ref:", flush=True)
        grad_errors(torch, "K4", "qkv", got, want)
        del got, want
        o = kattn.flash_attention(q, k, v, causal=causal, window=window)
        fwd = cuda_ms(torch, lambda: kattn.flash_attention(
            q, k, v, causal=causal, window=window))
        bwd = cuda_ms(torch, lambda: kattn.flash_attention_bwd(
            q, k, v, o, do, causal=causal, window=window), reps=3)
        plain = cuda_ms(torch, lambda: grads(lambda *t: kattn.
                                             attention_rounded_ref(
                                                 *t, causal=causal,
                                                 window=window),
                                             (q, k, v), do), reps=3)
        mask = (None if window is None
                else kattn._mask(sq, sk, causal, window, dev))
        lib = cuda_ms(torch, lambda: grads(
            lambda *t: F.scaled_dot_product_attention(
                *t, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True), (q, k, v), do), reps=3)
        # the backward's least work: 5 products of 2 D ops a pair (QK^T
        # again, dO V^T, P^T dO, dS K, dS^T Q) at the bf16 tensor-core
        # peak; q, k, v, o, dO read and dq, dk, dv written once, bf16
        ops = 10.0 * d * attn_pairs(sq, sk, causal, window) * b * h
        nbytes = 2.0 * (4 * b * h * sq * d + 4 * b * hk * sk * d)
        bms = max(nbytes / PEAK_BYTES, ops / PEAK_BF16_FLOPS) * 1e3
        print(f"    K4 forward {fwd:.4f} ms, backward (flash_attention_bwd) "
              f"{bwd:.4f} ms ({bwd / fwd:.1f}x; bound {bms:.4f} ms, "
              f"{ops / 1e9:.2f} GFLOP, {100 * bms / bwd:.2f}% of it); plain "
              f"forward + backward {plain:.4f} ms; "
              f"scaled_dot_product_attention forward + backward {lib:.4f} "
              f"ms; power limit {power}", flush=True)
        del q, k, v, do, o, mask
        torch.cuda.empty_cache()

    BH, C, D = K5_GRAD_SHAPE
    r, k, v = (normal((BH, C, D), bf16, 0.5) for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.8, 1.0, (BH, C, D)).astype(np.float32),
                        device=dev)
    u, s0 = normal((BH, D), torch.float32, 0.1), normal(
        (BH, D, D), torch.float32, 0.1)
    dy, ds = normal((BH, C, D), bf16), normal((BH, D, D), torch.float32)
    n0 = krwkv.backward_calls
    got = grads(krwkv.wkv_chunk, (r, k, v, w, u, s0), (dy, ds))
    if krwkv.backward_calls != n0 + 1:
        raise AssertionError("K5's backward did not run")
    want = grads(krwkv.wkv_ref, (r, k, v, w, u, s0), (dy, ds))
    print(f"  K5 gradient at rwkv6-1.6b's ({BH}, {C}, {D}) bf16 (float32 w, "
          f"u, state) against autograd through wkv_ref:", flush=True)
    grad_errors(torch, "K5", ("r", "k", "v", "w", "u", "state"), got, want)
    del got, want
    args = (r, k, v, w, u, s0)
    fwd = cuda_ms(torch, lambda: krwkv.wkv_chunk(*args))
    bwd = cuda_ms(torch, lambda: krwkv.wkv_bwd(*args, dy, ds), reps=3)
    plain = cuda_ms(torch, lambda: grads(krwkv.wkv_ref, args, (dy, ds)),
                    reps=1)
    # the backward's least work per (token, head, i, j), float32: the
    # state again (3), the adjoint update (3), dr, dk, dv (2 each), dw (2);
    # r, k, v, dy, dr, dk, dv in bf16, w and dw in float32, once each
    bms, by = bound_ms(BH * C * D * (7 * 2 + 2 * 4) + 3 * 4.0 * BH * D * D,
                       14.0 * BH * C * D * D)
    print(f"    K5 forward {fwd:.4f} ms, backward (wkv_bwd) {bwd:.4f} ms "
          f"({bwd / fwd:.1f}x; bound {bms:.4f} ms ({by}), "
          f"{100 * bms / bwd:.2f}% of it); plain forward + backward "
          f"{plain:.4f} ms; power limit {power}", flush=True)
    del r, k, v, w, u, s0, dy, ds, args
    torch.cuda.empty_cache()


def train_step_split(torch, kattn, cfg, dev, card) -> None:
    """Where one smollm-360m step's time goes: 3 steps under
    torch.profiler (device busy and idle shares), then 3 steps with a
    synchronisation after each part: forward (the loss), backward (K4's
    backward function timed on its own with CUDA events), optimizer."""
    from repro_torch.models import init_weights
    from repro_torch.models import transformer as ttf
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.data import SyntheticLM
    from repro_torch.models.params import (map_tree, tree_leaves,
                                           tree_unflatten)
    params = init_weights(cfg, seed=0, device=dev, trainable=True)
    opt = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup=TRAIN_STEPS // 5 + 1)
    step = tstep.make_train_step(cfg, opt_cfg)
    data = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B, seed=1)

    def batch():
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data.next_batch().items()}

    state = [params, opt]

    def steps(n):
        for _ in range(n):
            p, o, m = step(state[0], state[1], batch())
            state[:] = [p, o]
        float(m["loss"])

    steps(2)                                    # warm
    wall, busy, _ = profile_run(torch, "smollm-360m train, 3 steps",
                                lambda: steps(3), top=10)
    parts = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    k4b = []
    with events_of(torch, kattn, "flash_attention_bwd", k4b):
        for _ in range(3):
            b = batch()
            params, opt = state
            (loss, _), t = timed_sync(torch, lambda: ttf.loss_fn(
                params, b, cfg))
            parts["forward"] += t
            leaves = tree_leaves(params)
            g, t = timed_sync(torch, lambda: torch.autograd.grad(loss,
                                                                 leaves))
            if any(x is None for x in g):
                raise AssertionError("a weight got no gradient")
            parts["backward"] += t
            gtree = tree_unflatten(params, g)
            (p, o, _), t = timed_sync(torch, lambda: adamw_update(
                gtree, opt, opt_cfg, param_dtype=torch.bfloat16))
            parts["optimizer"] += t
            state[:] = [map_tree(lambda x: x.requires_grad_(), p), o]
    k4_bwd = events_ms(k4b) / 1e3
    total = sum(parts.values())
    print(f"  smollm-360m step split (3 steps, a synchronisation after each "
          f"part; card {card}): forward {parts['forward'] / 3:.4f} s, "
          f"backward {parts['backward'] / 3:.4f} s (K4's backward function "
          f"{k4_bwd / 3:.4f} s of device time, {len(k4b) // 3} calls a step),"
          f" optimizer {parts['optimizer'] / 3:.4f} s; a step "
          f"{total / 3:.4f} s" + (
              f"; unsynchronised under the profiler {wall / 3:.4f} s a step,"
              f" device busy {100 * busy / wall:.1f}%, idle (waiting on the "
              f"host) {100 * (1 - busy / wall):.1f}%" if busy else ""),
          flush=True)
    del state, params, opt, p, o, gtree, loss, g
    torch.cuda.empty_cache()


def lm_training(torch, kattn, krwkv, dev, card) -> dict:
    """Phase 11 (b)-(d): the reference's training main path,
    `launch.train.run`, on the card.  Returns the K4 and K5 launches of
    those runs."""
    import tempfile
    from repro_torch.ckpt import latest_step
    from repro_torch.configs import get_config
    from repro_torch.launch import train as ltrain
    launches = {"K4": 0, "K5": 0}

    # (b) smollm-360m at full width and depth, the example's full-size
    # settings, 30 of its 300 steps
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kattn.launches, n_bwd = 0, kattn.backward_calls
    t0 = time.perf_counter()
    out = ltrain.run(TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS,
                     batch=TRAIN_B, seq=TRAIN_S, ckpt_dir="", lr=TRAIN_LR,
                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, bwd = kattn.launches, kattn.backward_calls - n_bwd
    launches["K4"] += k4
    losses = np.array(out["losses"])
    first, last = losses[:5].mean(), losses[-5:].mean()
    warm = statistics.median(out["step_s"][5:])
    print(f"  {TRAIN_ARCH} ({cfg.n_layers} layers, batch {TRAIN_B}, seq "
          f"{TRAIN_S}, lr {TRAIN_LR}, {TRAIN_STEPS} steps; the example runs 300): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f}; grad norms "
          f"{min(out['grad_norms']):.3f}..{max(out['grad_norms']):.3f}; "
          f"first step {out['step_s'][0]:.3f} s, warm step (median of "
          f"steps 5-{TRAIN_STEPS - 1}) {warm:.4f} s, "
          f"{TRAIN_B * TRAIN_S / warm:.1f} tokens/s; {wall:.2f} s in all; "
          f"peak memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f}"
          f" GiB over the {base / 2**30:.2f} GiB allocated before; K4 launches "
          f"{k4} ({k4 / TRAIN_STEPS:.0f} a step), its backward"
          f" {bwd} times; card {card}", flush=True)
    if not (np.isfinite(losses).all()
            and np.isfinite(out["grad_norms"]).all()):
        raise AssertionError(f"{TRAIN_ARCH}: non-finite loss or grad norm")
    if not last <= first - 0.1:
        raise AssertionError(f"{TRAIN_ARCH}: loss fell from {first:.4f} to "
                             f"{last:.4f}, less than 0.1")
    if k4 != cfg.n_layers * TRAIN_STEPS or bwd != k4:
        raise AssertionError(f"{TRAIN_ARCH}: K4 launched {k4} times, its "
                             f"backward {bwd}, expected "
                             f"{cfg.n_layers * TRAIN_STEPS}")
    torch.cuda.empty_cache()
    kattn.launches = 0
    train_step_split(torch, kattn, cfg, dev, card)
    launches["K4"] += kattn.launches

    # (c) restart exactness: full width cut to 2 layers (a checkpoint of
    # ~1.1 GB), 12 steps uninterrupted against 7 + a resume from step 6
    cut = dc_replace(cfg, n_layers=RESTART_LAYERS)
    print(f"  restart: {TRAIN_ARCH} n_layers cut from {cfg.n_layers} to "
          f"{RESTART_LAYERS} (full width)", flush=True)
    kw = dict(smoke=False, steps=RESTART_STEPS, batch=TRAIN_B, seq=TRAIN_S,
              lr=1e-3, seed=7, device=dev)
    (ROOT / "build").mkdir(exist_ok=True)
    kattn.launches = 0
    with patched(ltrain, "get_config", lambda arch, smoke=False: cut), \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ref = ltrain.run(TRAIN_ARCH, ckpt_dir="", **kw)
        t0 = time.perf_counter()
        try:
            ltrain.run(TRAIN_ARCH, ckpt_dir=tmp, ckpt_every=RESTART_EVERY,
                       simulate_failure_at=RESTART_FAIL, **kw)
            raise AssertionError("the simulated failure did not happen")
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        t_fail = time.perf_counter() - t0
        last_step = latest_step(tmp)
        size = sum(f.stat().st_size for f in (
            Path(tmp) / f"step_{last_step:08d}").iterdir())
        t0 = time.perf_counter()
        res = ltrain.run(TRAIN_ARCH, ckpt_dir=tmp, ckpt_every=RESTART_EVERY,
                         **kw)
        t_res = time.perf_counter() - t0
    launches["K4"] += kattn.launches
    a, b = np.array(res["losses"][-3:]), np.array(ref["losses"][-3:])
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"  restart: failed at step {RESTART_FAIL} after checkpoints every "
          f"{RESTART_EVERY} steps ({size / 1e9:.3f} GB each, {t_fail:.2f} s "
          f"with saves), resumed from step {last_step} ({t_res:.2f} s); last "
          f"3 losses {np.round(a, 6).tolist()} against the uninterrupted "
          f"{np.round(b, 6).tolist()}, max relative difference {rel:.3e} "
          f"(limit 2e-4); K4 launches {kattn.launches}; card {card}",
          flush=True)
    if last_step != RESTART_FAIL - 1 or not rel <= 2e-4:
        raise AssertionError(f"restart: resumed from {last_step}, losses "
                             f"{rel:.3e} apart")
    torch.cuda.empty_cache()

    # (d) rwkv6-1.6b at full width and depth: K5 forward and backward
    arch = "rwkv6-1.6b"
    rcfg = get_config(arch)
    krwkv.launches, n_bwd = 0, krwkv.backward_calls
    wb = []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with events_of(torch, krwkv, "wkv_bwd", wb):
        out = ltrain.run(arch, smoke=False, steps=RWKV_TRAIN_STEPS,
                         batch=RWKV_TRAIN_B, seq=TRAIN_S, ckpt_dir="",
                         lr=TRAIN_LR, device=dev)
        torch.cuda.synchronize()
    k5, bwd = krwkv.launches, krwkv.backward_calls - n_bwd
    launches["K5"] += k5
    wkv_s = events_ms(wb[-rcfg.n_layers:]) / 1e3       # the last step's
    step_s = out["step_s"][-1]
    print(f"  {arch} ({rcfg.n_layers} layers, batch {RWKV_TRAIN_B}, seq "
          f"{TRAIN_S}, {RWKV_TRAIN_STEPS} steps): losses "
          f"{np.round(out['losses'], 4).tolist()}, grad norms "
          f"{np.round(out['grad_norms'], 3).tolist()}; steps "
          f"{np.round(out['step_s'], 3).tolist()} s; the last step's "
          f"backward WKV (wkv_bwd, device time) {wkv_s:.4f} s, "
          f"{100 * wkv_s / step_s:.1f}% of it; peak memory "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB over "
          f"the {base / 2**30:.2f} GiB allocated before; K5 launches "
          f"{k5} ({k5 / RWKV_TRAIN_STEPS:.0f} a step), its backward {bwd} "
          f"times; card {card}", flush=True)
    if not (np.isfinite(out["losses"]).all()
            and np.isfinite(out["grad_norms"]).all()):
        raise AssertionError(f"{arch}: non-finite loss or grad norm")
    if k5 != rcfg.n_layers * RWKV_TRAIN_STEPS or bwd != k5:
        raise AssertionError(f"{arch}: K5 launched {k5} times, its backward "
                             f"{bwd}, expected "
                             f"{rcfg.n_layers * RWKV_TRAIN_STEPS}")
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 12 -----
# (a) the collectives at one large shape on stacked meshes: per rank words
COLL_WORDS = 1 << 20
# (b) dbrx-132b's MoE layer at full width on a stacked (data 2, model 2)
# mesh: a batch of 4 x 1,024 tokens, against the per-shard oracle.  On the
# card (H100, 700 W) the two routes gave the same bits: outputs, aux and
# every gradient (their batched products differ in batch count only, and
# each row's sum runs alike).  The limits allow one bfloat16 unit at the
# largest value (2^-8 of it) on every output and the same relative L2 on
# each gradient, so a change of product shapes that rounds a row apart
# still passes while a misrouted block (the planted fault: 1.351 of the
# largest |y|) cannot
MOE_B, MOE_S = 4, 1024
MOE_OUT_TOL = 2.0 ** -8
MOE_GRAD_REL_L2 = 2.0 ** -8
# (d) smollm-360m's data-parallel step on a stacked (pod 2, data 2) mesh
# against the single-card step on the same batch (batch 4 x 512).  On the
# card (H100, 700 W) both reductions read: the loss 8.7e-8 apart
# (relative), the grad norm 1.27e-3, each leaf's clipped gradient up to
# 2.76e-2 in relative L2 (bfloat16 products over batch 1 against batch
# 4), the updated masters up to 0.020 learning rates apart (Adam's first
# step moves a weight by about lr sign(g)).  Limits about 2.5x those (the
# loss at 1e-6, a few float32 units)
DP_B, DP_S = 4, 512
DP_LOSS_RTOL, DP_NORM_RTOL, DP_GRAD_REL_L2, DP_STEP_LR = 1e-6, 3e-3, 7e-2, 0.05


def np_ring_reduce_scatter(parts):
    """NumPy model of `ring_reduce_scatter` in its hop order: parts (n, n,
    ...) float32, rank r's chunk c at parts[r, c]; chunk c summed as
    ((0 + parts[c+1, c]) + parts[c+2, c]) + ... + parts[c, c]."""
    n = parts.shape[0]
    out = []
    for c in range(n):
        acc = np.zeros_like(parts[0, 0])
        for t in range(n - 1):
            acc = acc + parts[(c + t + 1) % n, c]
        out.append(acc + parts[c, c])
    return np.stack(out)


def np_ordered_sum(rows):
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc


def np_hsdx(x, grid, stages):
    """NumPy model of `hsdx_grid_exchange` on a 1-rank-a-coordinate grid:
    (n, stages, 26, ...), the relay the mean of a stage's payloads added in
    offset order, times float32(1/26)."""
    from repro_torch.core.collectives import grid_offsets
    gx, gy, gz = grid
    n = gx * gy * gz
    coords = np.array([(i // (gy * gz), (i // gz) % gy, i % gz)
                       for i in range(n)])
    out = []
    for _ in range(stages):
        recv = []
        for off in grid_offsets():
            src = (coords - np.array(off)) % np.array(grid)
            recv.append(x[src[:, 0] * gy * gz + src[:, 1] * gz + src[:, 2]])
        out.append(np.stack(recv, 1))
        x = np_ordered_sum(recv) * np.float32(1.0 / len(recv))
    return np.stack(out, 1)


def collectives_on_card(torch, dev, card) -> None:
    """Phase 12 (a): the seven collectives on stacked (8,) and (pod 2,
    data 4) meshes, at tests/test_collectives.py's inputs and at one large
    shape (random float32), bit for bit against NumPy models of the same
    order (the overlapped matmul against the card's own per-chunk
    products); the hierarchical all-reduce's bytes a rank per stage."""
    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import make_mesh_compat
    flat = make_mesh_compat((8,), ("proc",), dev)
    two = make_mesh_compat((2, 4), ("pod", "data"), dev)
    rng = np.random.default_rng(0)
    W = COLL_WORDS
    cases = {
        "reference test's inputs": dict(
            x=np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3),
            y=np.arange(8 * 5, dtype=np.float32).reshape(8, 1, 5),
            z=np.arange(8 * 8 * 2, dtype=np.float32).reshape(8, 8, 2),
            w=np.arange(3 * 7, dtype=np.float32).reshape(3, 7) / 10,
            hs=np.eye(8, dtype=np.float32)[:, None, :]),
        f"large, {W} words a rank": dict(
            x=rng.normal(size=(8, W // 8, 8)).astype(np.float32),
            y=rng.normal(size=(8, W + 3)).astype(np.float32),
            z=rng.normal(size=(8, 8, W // 8)).astype(np.float32),
            w=rng.normal(size=(512, 512)).astype(np.float32),
            xm=rng.normal(size=(8, 256, 512)).astype(np.float32),
            hs=rng.normal(size=(8, W // 16)).astype(np.float32))}
    for label, c in cases.items():
        t = {k: torch.as_tensor(v, device=dev) for k, v in c.items()}
        x, n = c["x"], 8
        checks, times = [], {}

        def run(name, fn):
            out, s = timed_sync(torch, fn)
            times[name] = s
            return out.cpu().numpy()

        whole = x.reshape(-1, *x.shape[2:])
        for rev in (False, True):
            got = run(f"ring_all_gather{' reverse' * rev}",
                      lambda: C.ring_all_gather(t["x"], flat, "proc",
                                                reverse=rev))
            checks.append((f"ring_all_gather reverse={rev}",
                           np.array_equal(got, np.broadcast_to(
                               whole, (n,) + whole.shape))))
        # rank r's buffer: (r + 1) x, its chunk c (r + 1) x[c]
        parts = x[None] * np.arange(1, n + 1, dtype=np.float32).reshape(
            (n,) + (1,) * x.ndim)
        got = run("ring_reduce_scatter", lambda: C.ring_reduce_scatter(
            torch.as_tensor(parts.reshape(n, -1, *x.shape[2:]), device=dev),
            flat, "proc"))
        checks.append(("ring_reduce_scatter", np.array_equal(
            got, np_ring_reduce_scatter(parts))))
        y = c["y"]
        stats, fstats = [], []
        got = run("hierarchical_all_reduce", lambda: C.hierarchical_all_reduce(
            t["y"], two, "data", "pod", stats=stats))
        yy = y.reshape(2, 4, -1)
        want = np_ordered_sum([np_ordered_sum(list(yy[p])) for p in (0, 1)])
        checks.append(("hierarchical_all_reduce", np.array_equal(
            got, np.broadcast_to(want.reshape(y.shape[1:]), y.shape))))
        got = run("flat all-reduce", lambda: C.hierarchical_all_reduce(
            t["y"], two, ("pod", "data"), None, stats=fstats))
        checks.append(("flat all-reduce", np.array_equal(got, np.broadcast_to(
            np_ordered_sum(list(y)), y.shape))))
        outer = sum(s["bytes_per_rank"] for s in stats if "pod" in s["axes"])
        flat_b = fstats[0]["bytes_per_rank"]
        size = y[0].size
        print(f"  {label}: hierarchical_all_reduce of {4 * size} B a rank: "
              + ", ".join(f"{s['stage']} over {'/'.join(s['axes'])} "
                          f"{s['bytes_per_rank']} B a rank" for s in stats)
              + f"; the flat all-reduce over pod/data {flat_b} B a rank; the "
              f"pod axis carries {outer / flat_b:.6f} of it (1/|data| = "
              f"0.25, the padding to a multiple of 4 words aside)",
              flush=True)
        if outer != 4 * -(-size // 4) or flat_b != 4 * size:
            raise AssertionError(f"pod-axis bytes {outer} against the flat "
                                 f"{flat_b}")
        got = run("two_stage_all_to_all", lambda: C.two_stage_all_to_all(
            t["z"], two, "data", "pod"))
        checks.append(("two_stage_all_to_all", np.array_equal(
            got, np.swapaxes(c["z"], 0, 1))))
        xm = t.get("xm", t["x"])
        got = run("all_gather_matmul_overlapped",
                  lambda: C.all_gather_matmul_overlapped(xm, t["w"], flat,
                                                         "proc"))
        chunks = torch.cat([xm[s] @ t["w"] for s in range(n)]).cpu().numpy()
        checks.append(("all_gather_matmul_overlapped", np.array_equal(
            got, np.broadcast_to(chunks, (n,) + chunks.shape))))
        f64 = (xm.double().reshape(-1, xm.shape[-1]) @ t["w"].double())
        print(f"  {label}: all_gather_matmul_overlapped against float64: max "
              f"|diff| {float((torch.as_tensor(got[0], device=dev) - f64).abs().max()):.3e}",
              flush=True)
        got = run("neighbor_exchange", lambda: C.neighbor_exchange(
            t["x"], flat, "proc", 1))
        checks.append(("neighbor_exchange", np.array_equal(
            got, np.roll(x, 1, axis=0))))
        got = run("hsdx_grid_exchange", lambda: C.hsdx_grid_exchange(
            t["hs"], flat, "proc", (2, 2, 2), stages=2))
        checks.append(("hsdx_grid_exchange", np.array_equal(
            got, np_hsdx(c["hs"], (2, 2, 2), 2))))
        print(f"  {label}: "
              + ", ".join(f"{k} {'bit for bit' if ok else 'DIFFERS'}"
                          for k, ok in checks), flush=True)
        print(f"  {label}: times (s, a call, stacked on the card): "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"; card {card}", flush=True)
        bad = [k for k, ok in checks if not ok]
        if bad:
            raise AssertionError(f"collectives differ from their NumPy "
                                 f"models: {bad}")


def _moe_oracle(torch, tmoe, x, p, cfg, parts):
    """`_moe_dense` on each of `parts` slices of the batch's tokens (B, S,
    D) -> (y, aux mean, routing log)."""
    D = x.shape[-1]
    xs = x.reshape(parts, -1, D)
    with tmoe.routing_log() as log:
        outs = [tmoe._moe_dense(s[None], p, cfg) for s in xs]
    y = torch.cat([o[0] for o in outs], 1).reshape(x.shape)
    return y, sum(o[1] for o in outs) / parts, log


def moe_layer_on_card(torch, dev, card) -> None:
    """Phase 12 (b): dbrx-132b's MoE layer at full width, expert-parallel
    on a stacked (data 2, model 2) mesh, against the per-shard dense
    oracle."""
    from repro_torch.core.dist.comm import StackedComm
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import moe as tmoe
    from repro_torch.models.params import init_params
    from repro_torch.sharding.parallel import Parallelism
    cfg = lm_config("dbrx-132b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_params(tmoe.moe_defs(cfg), gen)
    x = torch.randn(MOE_B, MOE_S, cfg.d_model, generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    mesh = make_mesh_compat((2, 2), ("data", "model"), dev)
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model")
    T = MOE_B * MOE_S
    C = tmoe._capacity(T // 2, cfg)
    print(f"  dbrx-132b MoE layer: d_model {cfg.d_model}, {cfg.n_experts} "
          f"experts top-{cfg.top_k}, d_ff {cfg.d_ff}, capacity factor "
          f"{cfg.capacity_factor}; {T} tokens on a stacked (data 2, model 2) "
          f"mesh, capacity {C} a data rank; card {card}", flush=True)

    def gap(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    for seq in (False, True):
        pp = dc_replace(par, moe_seq_shard=seq)
        with torch.no_grad():
            with tmoe.routing_log() as log:
                y, aux = tmoe.moe_ffn(x, p, cfg, pp)
            yo, auxo, olog = _moe_oracle(torch, tmoe, x, p, cfg,
                                         4 if seq else 2)
        # rank (d, m): without moe_seq_shard data shard d, else its m-th
        # slice: the oracle's entry d, or 2 d + m
        pick = [0, 0, 1, 1] if not seq else [0, 1, 2, 3]
        same_routes = all(torch.equal(log[r][0], olog[pick[r]][0])
                          for r in range(4))
        drop_ep = sum(int((~e[1]).sum()) for e in log)
        drop_or = sum(int((~olog[pick[r]][1]).sum()) for r in range(4))
        err, aerr = gap(y, yo), abs(float(aux) - float(auxo))
        print(f"  moe_seq_shard={seq}: against the per-"
              f"{'(data x model)-' if seq else 'data-'}shard oracle: outputs "
              f"within {err:.3e} of its largest |y| (limit {MOE_OUT_TOL}), "
              f"{int((y != yo).sum())} of {y.numel()} values not bit-equal; "
              f"aux {float(aux):.6f} vs {float(auxo):.6f}; routes "
              f"{'equal' if same_routes else 'DIFFER'}; slots dropped "
              f"{drop_ep} vs {drop_or} (of {4 * len(log[0][1]) * cfg.top_k})",
              flush=True)
        if err > MOE_OUT_TOL or not same_routes or drop_ep != drop_or \
                or aerr > 1e-4 * abs(float(auxo)):
            raise AssertionError(f"expert-parallel MoE against its oracle "
                                 f"(moe_seq_shard={seq})")

    # a planted fault: the dispatch all-to-all sends each block one rank
    # off (block j to model rank j + 1)
    real = StackedComm.all_to_all
    calls = []

    def off_by_one(self, buf, axes=None, dim=0):
        calls.append(axes)
        if axes is not None and len(calls) == 1:
            buf = buf.roll(1, dims=1 + dim)
        return real(self, buf, axes, dim)

    StackedComm.all_to_all = off_by_one
    try:
        with torch.no_grad():
            yf, _ = tmoe.moe_ffn(x, p, cfg, par)
    finally:
        StackedComm.all_to_all = real
    yo, _, _ = _moe_oracle(torch, tmoe, x, p, cfg, 2)
    planted = gap(yf, yo)
    print(f"  planted fault (dispatch blocks sent one model rank off): "
          f"outputs {planted:.3e} of the largest |y| from the oracle "
          f"(limit {MOE_OUT_TOL})", flush=True)
    if planted <= MOE_OUT_TOL:
        raise AssertionError("the planted all-to-all fault reads within the "
                             "limit")
    del yf

    # gradients of x and the four weights, through both routes
    gy = torch.randn(x.shape, generator=gen, device=dev)
    grads = {}
    for label, fn in (("stacked", lambda xx, pp: tmoe.moe_ffn(
            xx, pp, cfg, par)), ("oracle", lambda xx, pp: _moe_oracle(
            torch, tmoe, xx, pp, cfg, 2)[:2])):
        xx = x.clone().requires_grad_()
        pp = {k: v.detach().requires_grad_() for k, v in p.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        (y, aux), t_f = timed_sync(torch, lambda: fn(xx, pp))
        _, t_b = timed_sync(torch, lambda: ((y.float() * gy).sum()
                                            + aux).backward())
        peak = torch.cuda.max_memory_allocated(dev)
        grads[label] = {"x": xx.grad, **{k: v.grad for k, v in pp.items()}}
        print(f"  {label}: forward {t_f:.4f} s, backward {t_b:.4f} s, peak "
              f"{peak / 2**30:.3f} GiB allocated (weights "
              f"{sum(v.numel() * v.element_size() for v in p.values()) / 2**30:.3f} GiB)",
              flush=True)
        del y, aux, xx, pp
    worst = 0.0
    for k in grads["oracle"]:
        a, b = grads["stacked"][k].float(), grads["oracle"][k].float()
        rel = float((a - b).norm() / b.norm())
        worst = max(worst, rel)
        print(f"    grad {k}: relative L2 {rel:.3e}, max |diff| "
              f"{float((a - b).abs().max()):.3e} of max |g| "
              f"{float(b.abs().max()):.3e}", flush=True)
    if worst > MOE_GRAD_REL_L2:
        raise AssertionError(f"expert-parallel gradients {worst} from the "
                             f"oracle's (limit {MOE_GRAD_REL_L2})")
    del grads

    # time and peak memory: the stacked route, the oracle, one dense layer
    for label, fn in (("expert-parallel, stacked (2, 2)",
                       lambda: tmoe.moe_ffn(x, p, cfg, par)),
                      ("per-shard oracle", lambda: _moe_oracle(
                          torch, tmoe, x, p, cfg, 2)),
                      ("single-card dense layer, one shard of 4,096 tokens",
                       lambda: tmoe._moe_dense(x, p, cfg))):
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ms = cuda_ms(torch, fn, reps=3)
            peak = torch.cuda.max_memory_allocated(dev) - base
        print(f"  {label}: {ms:.3f} ms, peak {peak / 2**30:.3f} GiB above "
              f"the weights; card {card}", flush=True)
    print(f"  all-to-all: a rank sends {cfg.n_experts * C * cfg.d_model * 2}"
          f" B each way a call ((E, C, D) bfloat16), half of it to the other "
          f"model rank", flush=True)
    del p, x, gy
    torch.cuda.empty_cache()


def _twin_tape(par):
    """A `LogitTape` whose model calls run under `par` and keep row 0."""
    class Twin(LogitTape):
        def prefill(self, tokens, S_max, **kw):
            cache, lg = self._call(self.model.prefill, tokens, S_max, par=par)
            self.logits.append(lg[:1, -1].float())
            return cache, lg

        def decode_step(self, cache, tokens, pos, *args):
            lg, cache = self._call(self.model.decode_step, cache, tokens,
                                   pos, par)
            self.logits.append(lg[:1, -1].float())
            return lg, cache
    return Twin


def greedy_check_par(torch, model, par, prompt, out, tape) -> dict:
    """`greedy_check` under a mesh of 2 data ranks: the request was served
    with its twin (each data rank holds one copy: its capacity is that of
    the request alone), and each step is held to a forward of the twin pair
    under the same `par`, under phase 10's rule (a step whose routes differ
    or that dropped a slot is counted, not held)."""
    from repro_torch.models import moe as tmoe
    seq, res = list(prompt), dict(tokens=len(out), exempt=0, apart=0,
                                  unrouted=0, dropped=0, worst=0.0)
    for i, (t, lg_e) in enumerate(zip(out, tape.logits)):
        with tmoe.routing_log() as log:
            h = model(torch.as_tensor([seq, seq], device=model.device),
                      par=par)
        fwd = moe_routes(log)
        eng = [(torch.cat([c[j][0] for c in tape.routes[:i + 1]]),
                torch.cat([c[j][1] for c in tape.routes[:i + 1]]))
               for j in range(len(fwd))]
        if drops(fwd) or drops(eng):
            res["dropped"] += 1
        elif not all(torch.equal(a[0], b[0]) for a, b in zip(eng, fwd)):
            res["unrouted"] += 1
        else:
            lg = model.logits(h[:1, -1:])[:, -1].float()
            worst, near, apart = hold_step(lg_e, lg, torch.as_tensor([t]),
                                           LM_LOGIT_TOL, f"length {len(seq)}")
            res["worst"] = max(res["worst"], worst)
            res["exempt"] += near
            res["apart"] += apart
        seq.append(t)
    return res


def serve_under_mesh(torch, arch: str, kattn, dev, card) -> int:
    """Phase 12 (c): `ServeEngine(par=)` on a stacked (data 2, model 2)
    mesh at full width (depth cut as in phase 10).  Returns K4's launches
    under the mesh."""
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sharding.parallel import Parallelism
    cfg = lm_config(arch)
    model = build_model(cfg, seed=0, device=dev)
    mesh = make_mesh_compat((2, 2), ("data", "model"), dev)
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                      remat=False)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, int(
        rng.integers(4, 16)))] for _ in range(LM_REQUESTS)]
    model.prefill(torch.as_tensor([prompts[0]] * 2, device=dev), LM_SMAX,
                  par=par)
    res = {}
    for label, pp, graph in (("one rank", Parallelism(remat=False), False),
                             ("mesh", par, False), ("mesh graphed", par,
                                                    True)):
        eng = ServeEngine(model, B=LM_SLOTS, S_max=LM_SMAX, graph=graph,
                          par=pp)
        rec = LogitRecorder(eng)
        reqs = [Request(rid=i, prompt=list(p), max_new=LM_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kattn.launches = 0
        _, t = timed_sync(torch, lambda: eng.run(max_steps=LM_SMAX))
        res[label] = ({r.rid: list(r.out) for r in reqs}, t,
                      kattn.launches, rec.logits, eng)
        n_tok = LM_REQUESTS * LM_NEW
        print(f"  {arch} {label}: {n_tok} tokens in {t:.4f} s "
              f"({n_tok / t:.2f} tok/s{', capture included' * graph}), K4 "
              f"launches {kattn.launches}; card {card}", flush=True)
    k4 = {k: v[2] for k, v in res.items()}
    if k4["mesh"] != k4["one rank"]:
        raise AssertionError(f"{arch}: K4 launches {k4}")
    toks_e, _, _, lg_e, _ = res["mesh"]
    toks_g, _, _, lg_g, eng_g = res["mesh graphed"]
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(lg_g, lg_e))
    call = eng_g.decode_call
    print(f"  {arch}: graphed decode under the mesh against the eager one: "
          f"tokens {'identical' if toks_g == toks_e else 'DIFFER'}, logits of "
          f"{len(lg_g)} calls within {worst:.3e} of the largest |logit|; "
          f"capture {call.capture_s:.4f} s, pool "
          f"{call.pool_bytes / 2**30:.3f} GiB, launches a replay "
          f"{call.launches}", flush=True)
    if toks_g != toks_e or len(lg_g) != len(lg_e) or worst > 1e-3:
        raise AssertionError(f"{arch}: graphed and eager serving under the "
                             f"mesh differ")
    del res, eng_g, call
    # each request served with its twin, held to a forward under the mesh;
    # a 6-token request too, which no expert's capacity can refuse
    short = [int(t) for t in np.random.default_rng(0).integers(
        1, cfg.vocab, 6)]
    tot = dict(tokens=0, exempt=0, apart=0, unrouted=0, dropped=0,
               worst=0.0)
    Twin = _twin_tape(par)
    for prompt in prompts + [short]:
        tape = Twin(model)
        eng = ServeEngine(tape, B=2, S_max=LM_SMAX, graph=False)
        for rid in (0, 1):
            eng.submit(Request(rid=rid, prompt=list(prompt), max_new=LM_NEW))
        outs = {r.rid: r.out for r in eng.run(max_steps=LM_SMAX)}
        if outs[0] != outs[1]:
            raise AssertionError(f"{arch}: the twins were served apart")
        r = greedy_check_par(torch, model, par, prompt, outs[0], tape)
        tot = {k: max(v, r[k]) if k == "worst" else v + r[k]
               for k, v in tot.items()}
    held = tot["tokens"] - tot["unrouted"] - tot["dropped"]
    print(f"  {arch}: greedy continuations under the mesh, {len(prompts) + 1}"
          f" requests each served with its twin: {held} of {tot['tokens']} "
          f"steps held to a forward under the same mesh ({tot['apart']} "
          f"tokens not its argmax, each at a near tie; {tot['exempt']} near "
          f"ties), {tot['unrouted']} routed apart, {tot['dropped']} with a "
          f"dropped slot; logits within {tot['worst']:.3e} of the largest "
          f"|logit| (limit {LM_LOGIT_TOL})", flush=True)
    if held <= 0:
        raise AssertionError(f"{arch}: no step under the mesh was held")
    # the graphed engine and its captured step form a reference cycle:
    # collect it, so its graph pool is freed before the next model
    del model, eng, rec, tape
    gc.collect()
    torch.cuda.empty_cache()
    return k4["mesh"] + k4["mesh graphed"]


def dp_training_on_card(torch, kattn, dev, card) -> int:
    """Phase 12 (d): smollm-360m's data-parallel step on a stacked (pod 2,
    data 2) mesh, hierarchical and flat, against the single-card step.
    Returns K4's launches in the mesh steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as tcoll
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import init_weights
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.parallel import Parallelism
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    cfg = get_config(TRAIN_ARCH)
    params = init_weights(cfg, seed=0, device=dev, trainable=True)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg.vocab, DP_S, DP_B, seed=0).next_batch().items()}
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    mesh = make_mesh_compat((2, 2), ("pod", "data"), dev)
    runs, launches = {}, 0
    for label, par in (("single card", Parallelism()),
                       ("hierarchical", Parallelism(
                           mesh=mesh, data_axes=("pod", "data"),
                           pod_axis="pod", hierarchical=True)),
                       ("flat", Parallelism(
                           mesh=mesh, data_axes=("pod", "data"),
                           pod_axis="pod", hierarchical=False))):
        step = tstep.make_train_step(cfg, opt_cfg, par=par)
        red = []
        real = tstep.hierarchical_all_reduce

        def timed_reduce(*a, **kw):
            out, s = timed_sync(torch, lambda: real(*a, **kw))
            red.append(s)
            return out

        tstep.hierarchical_all_reduce = timed_reduce
        try:
            kattn.launches = 0
            opt = init_opt_state(params)
            torch.cuda.reset_peak_memory_stats(dev)
            (newp, opt, m), t = timed_sync(torch, lambda: step(
                params, opt, batch))
            k4 = kattn.launches
        finally:
            tstep.hierarchical_all_reduce = real
        peak = torch.cuda.max_memory_allocated(dev)
        runs[label] = (opt, m)
        if par.mesh is not None:
            launches += k4
            pod = sum(s["bytes_per_rank"] for s in step.comm
                      if "pod" in s["axes"])
            print(f"  {label} reduction: "
                  + ", ".join(f"{s['stage']} over {'/'.join(s['axes'])} "
                              f"{s['bytes_per_rank']} B a rank"
                              for s in step.comm)
                  + f"; on the pod axis {pod} B a rank; "
                  f"{red[0]:.4f} s (stacked on the card)", flush=True)
            if k4 != cfg.n_layers * par.dp_size():
                raise AssertionError(f"{label}: K4 launches {k4}")
        print(f"  {label}: step {t:.4f} s, loss {float(m['loss']):.6f}, "
              f"grad norm {float(m['grad_norm']):.6f}, K4 launches {k4}, "
              f"peak {peak / 2**30:.3f} GiB; card {card}", flush=True)
        del newp
    one = runs["single card"]
    for label in ("hierarchical", "flat"):
        opt, m = runs[label]
        dl = abs(float(m["loss"]) - float(one[1]["loss"])) / abs(
            float(one[1]["loss"]))
        dg = abs(float(m["grad_norm"]) - float(one[1]["grad_norm"])) / \
            float(one[1]["grad_norm"])
        g_rel = max(float((a - b).norm() / b.norm()) if b.norm() > 0 else
                    float(a.norm() > 0) for a, b in zip(
                        tree_leaves(opt.m), tree_leaves(one[0].m)))
        w = [(a - b).abs() / opt_cfg.lr for a, b in zip(
            tree_leaves(opt.master), tree_leaves(one[0].master))]
        w_max = max(float(d.max()) for d in w)
        w_far = sum(int((d > 0.1).sum()) for d in w)
        n_w = sum(d.numel() for d in w)
        print(f"  {label} against the single-card step: loss {dl:.3e} "
              f"(relative; limit {DP_LOSS_RTOL}), grad norm {dg:.3e} (limit "
              f"{DP_NORM_RTOL}), clipped gradient per leaf up to {g_rel:.3e} "
              f"relative L2 (limit {DP_GRAD_REL_L2}); updated masters up to "
              f"{w_max:.3f} lr apart (limit {DP_STEP_LR}), {w_far} of {n_w} "
              f"more than 0.1 lr", flush=True)
        if dl > DP_LOSS_RTOL or dg > DP_NORM_RTOL \
                or g_rel > DP_GRAD_REL_L2 or w_max > DP_STEP_LR:
            raise AssertionError(f"{label} data-parallel step against the "
                                 f"single-card step")
    del runs, one, params
    torch.cuda.empty_cache()
    return launches


def lm_sharding(torch, kattn, dev, card) -> int:
    """Phase 12: the LM sharding tier on ranks stacked on the card.
    Returns K4's launches."""
    with phase("LM sharding (a): the collectives on stacked meshes"):
        collectives_on_card(torch, dev, card)
    with phase("LM sharding (b): dbrx-132b's MoE layer, expert-parallel"):
        moe_layer_on_card(torch, dev, card)
    k4 = 0
    for arch in ("dbrx-132b", "llama4-scout-17b-a16e"):
        with phase(f"LM sharding (c): serving {arch} under a (2, 2) mesh"):
            k4 += serve_under_mesh(torch, arch, kattn, dev, card)
    with phase(f"LM sharding (d): {TRAIN_ARCH} data-parallel on (pod 2, "
               f"data 2)"):
        k4 += dp_training_on_card(torch, kattn, dev, card)
    return k4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "obs",
                    help="directory for phase 8b's chrome trace and the "
                         "counters gate's report")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import api as tapi
    from repro_torch.core import plan as tplan
    from repro_torch.core.api import FMMSession, PartitionSpec, plan_geometry
    from repro_torch.core.distributions import make_distribution
    from repro_torch.core.engine.p2p import _gather_bucket, stream_payload
    from repro_torch.core.engine.traversal import device_dual_traversal
    from repro_torch.core.fmm import direct_potential
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import mac as kmac
    from repro_torch.kernels import p2p as kp2p
    from repro_torch.kernels import p2p_stream as kstream
    from repro_torch.kernels import rwkv as krwkv

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # ------------------------------------------------------------- 1 -----
    power = card.split(",")[-1].strip()
    with phase("build kernels (nvcc, sm_90a, one process per source)"):
        logs = kbuild.build()
        for src, log in logs.items():
            entry = ""
            for line in log.splitlines():
                m = WKV_ENTRY.search(line)
                if m:           # K5's instantiations, by template argument
                    entry = (f"wkv_kernel<{'f32' if m[1] == 'f' else 'bf16'}"
                             f", D {m[2]}, G {m[3]}, JC {m[4]}, JL {m[5]}, "
                             f"TC {m[6]}>: ")
                m = ATTN_ENTRY.search(line)
                if m:           # K4's, by path and head size
                    entry = (f"flash_attention "
                             f"{'bf16 wgmma' if m[1] == 'tc' else 'f32 simt'}"
                             f" D {m[2]}: ")
                if ("registers" in line or "smem" in line
                        or "spill" in line or "C75" in line):
                    print(f"  {src}: {entry}{line.strip()}")

    # ------------------------------------------------------------- 2 -----
    n = args.n
    spec = PartitionSpec(nparts=8, method="orb", theta=0.5, ncrit=64, p=4)
    x = make_distribution("sphere", n, seed=42)
    q = np.random.default_rng(0).uniform(-1, 1, n)
    launches = {}
    with phase(f"device planning against host planning, N = {n}"):
        kmac.launches = 0
        trav = {}
        with FrontierSpy(torch, kmac) as spy, \
                wall_of(tapi, "device_dual_traversal", trav):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess_g = FMMSession.from_points(x, q, spec, device=dev,
                                            fused=False)
            torch.cuda.synchronize()
            t_plan = time.perf_counter() - t0
        launches["K3"] = kmac.launches
        print(f"planning, device traversal with K3 (from_points, N={n}): "
              f"{t_plan:.3f} s, of which {trav['device_dual_traversal#']} "
              f"traversals {trav['device_dual_traversal']:.3f} s; K3 launches "
              f"{launches['K3']} (frontier generations scored {spy.calls}, "
              f"largest {spy.largest[1].shape[0]} lanes); card {card}",
              flush=True)
        if launches["K3"] <= 0:
            raise AssertionError("K3 was not launched while planning")
        with wall_of(tplan, "dual_traversal", trav):
            t0 = time.perf_counter()
            geo_h = plan_geometry(x, q, spec, device=dev,
                                  traversal_backend="host")
            t_host = time.perf_counter() - t0
        print(f"planning, host traversal (plan_geometry, N={n}): "
              f"{t_host:.3f} s, of which {trav['dual_traversal#']} "
              f"traversals {trav['dual_traversal']:.3f} s; card {card}",
              flush=True)
        compare_geometries(torch, kmac, sess_g.geometry, geo_h)
        del geo_h
    sess_s = FMMSession(sess_g.geometry, device=dev, p2p_stream=True,
                        fused=False)
    geo_main = sess_g.geometry           # phase 8 plans nothing again

    # ------------------------------------------------------------- 3 -----
    results = {}
    with phase("kernels against their plain versions at the main path's "
               "shapes"):
        ca, ra, cb, rb, theta = spy.largest
        got = kmac.mac_margins(ca, ra, cb, rb, theta)
        want = kmac.mac_margins_ref(ca, ra, cb, rb, theta)
        K = ra.shape[0]
        if not torch.equal(got, want):
            raise AssertionError(f"K3 differs from its plain version on "
                                 f"{int((got != want).sum())} of {K} lanes")
        call_ms = cuda_ms(torch, lambda: kmac.mac_margins(ca, ra, cb, rb,
                                                          theta), reps=21)
        ms = device_ms(torch, lambda: kmac.mac_margins(ca, ra, cb, rb, theta))
        pms = device_ms(torch, lambda: kmac.mac_margins_ref(ca, ra, cb, rb,
                                                            theta))
        bms, by = bound_ms(MAC_BYTES_PER_LANE * K, MAC_OPS_PER_LANE * K)
        print(f"  K3 (largest frontier, {K} lanes): bitwise equal to the "
              f"plain version; device time {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.6f} ms ({by}); one call from the host "
              f"{call_ms:.4f} ms; power limit {power}", flush=True)
        results["K3"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                             max_abs_err=float((got - want).abs().max()))
        del got, want
        geo = sess_g.geometry
        t_big = max((t for t in geo.trees if t is not None),
                    key=lambda t: t.n_cells)
        with FrontierSpy(torch, kmac, check=True) as chk:
            full = device_dual_traversal(t_big, t_big, geo.theta,
                                         device=dev)
        plain = device_dual_traversal(t_big, t_big, geo.theta,
                                      use_kernel=False, device=dev)
        same = all(np.array_equal(a, b) for a, b in zip(full[:3], plain[:3]))
        print(f"  K3 on every generation of one full traversal ({chk.calls} "
              f"generations, {t_big.n_cells} cells): {chk.mismatches} "
              f"differ from the plain version; pair lists "
              f"{'identical' if same else 'DIFFER'} with and without K3",
              flush=True)
        if chk.mismatches or not same or full[3] != plain[3]:
            raise AssertionError("K3 and its plain version disagree over a "
                                 "traversal")
        del spy, chk, ca, ra, cb, rb

        eng = sess_g.engine
        k1 = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
              "bytes_all_targets": 0.0, "pairs": 0, "terms": 0,
              "max_abs_err": 0.0}
        print_ptxas(logs, "p2p.cu")
        for b in eng.tables.p2p_buckets:
            xt, xs, qs = _gather_bucket(eng.x, eng.q, b["t_idx"], b["s_idx"],
                                        b["s_valid"])
            P, S = qs.shape
            T = xt.shape[1]
            got = kp2p.p2p(qs, xs, xt)
            want = kp2p.p2p_ref(qs, xs, xt)
            absum = kp2p.p2p_ref(qs.abs(), xs, xt)
            err = check_close(f"K1 bucket (rows {P}, T {T}, S {S})",
                              got, want, absum)
            live = b["mask"] > 0
            pairs = int((b["t_valid"][live].sum(1).double()
                         * b["s_valid"][live].sum(1).double()).sum())
            # sources up to each row's last nonzero charge (the kernel's
            # loop), the only x_src any implementation must read; a row of
            # zero charges needs none of its targets either
            nz = qs != 0
            trims = torch.where(nz.any(1), S - nz.flip(1).int().argmax(1), 0)
            trim, rows_live = int(trims.sum()), int((trims > 0).sum())
            warps = kp2p.p2p_launch_params(P)
            ms = device_ms(torch, lambda: kp2p.p2p(qs, xs, xt), reps=20)
            call_ms = cuda_ms(torch, lambda: kp2p.p2p(qs, xs, xt))
            pms = cuda_ms(torch, lambda: kp2p.p2p_ref(qs, xs, xt), reps=3)
            nbytes = 4.0 * (P * S + 3 * trim + 3 * rows_live * T + P * T)
            bms, by = bound_ms(nbytes, FLOPS_PER_PAIR * pairs)
            k1["bytes_all_targets"] += nbytes + 12.0 * (P - rows_live) * T
            print(f"  K1 bucket (rows {P}, T {T}, S {S}), {warps} warps a "
                  f"block: {ms:.4f} ms device time (one call from the host "
                  f"{call_ms:.4f}), plain {pms:.4f} ms; terms evaluated "
                  f"{trim * T} for {pairs} live pairs ({trim} sources up to "
                  f"the rows' last charges of {P * S}, {rows_live} rows with "
                  f"a charge); bound {bms:.4f} ms ({by}); power limit "
                  f"{power}", flush=True)
            k1["ms"] += ms
            k1["call_ms"] += call_ms
            k1["plain_ms"] += pms
            k1["bytes"] += nbytes
            k1["pairs"] += pairs
            k1["terms"] += trim * T
            k1["max_abs_err"] = max(k1["max_abs_err"], err)
            del xt, xs, qs, got, want, absum, nz, trims
        bms, by = bound_ms(k1["bytes"], FLOPS_PER_PAIR * k1["pairs"])
        ball, _ = bound_ms(k1["bytes_all_targets"],
                           FLOPS_PER_PAIR * k1["pairs"])
        print(f"  K1 over the buckets, {kp2p.p2p_launch_params(1 << 20)} "
              f"warps a block of {kp2p.ROWS_PER_WARP} rows each: "
              f"{k1['ms']:.4f} ms device time (one call each from the host "
              f"{k1['call_ms']:.4f}), bound {bms:.4f} ms ({by}, "
              f"{k1['bytes'] / 1e9:.4f} GB; {ball:.4f} ms counting the "
              f"targets of rows without a charge), {bms / k1['ms']:.1%} of "
              f"it; terms evaluated {k1['terms']} for {k1['pairs']} live "
              f"pairs", flush=True)
        results["K1"] = dict(ms=k1["ms"], plain_ms=k1["plain_ms"],
                             bound_ms=bms, bound_by=by,
                             max_abs_err=k1["max_abs_err"],
                             pairs=k1["pairs"])

        engs = sess_s.engine
        stream = engs.stream_tables()
        if stream is None:
            raise AssertionError("stream tables fell back to the gathered "
                                 "buckets")
        meta, bt, smax = stream["meta"], stream["block_t"], stream["smax"]
        payload = stream_payload(engs.x, engs.q, stream["pad"])
        print_ptxas(logs, "p2p_stream.cu")
        got = kstream.p2p_stream(meta, payload, block_t=bt, smax=smax)
        want = kstream.p2p_stream_gathered(meta, payload, block_t=bt,
                                           smax=smax)
        pay_abs = payload.clone()
        pay_abs[3].abs_()
        absum = kstream.p2p_stream_gathered(meta, pay_abs, block_t=bt,
                                            smax=smax)
        # the kernel's contract: the plain version's sums on out_valid
        # lanes, exactly 0.0 on the others (which the caller drops)
        valid = stream["out_valid"]
        err = check_close(f"K2 on out_valid lanes (tiles {meta.shape[0]}, "
                          f"block_t {bt}, smax {smax})", got[valid],
                          want[valid], absum[valid])
        nonzero = int((got[~valid] != 0).sum())
        print(f"  K2 off out_valid: {int((~valid).sum())} lanes, "
              f"{nonzero} not exactly 0.0", flush=True)
        if nonzero:
            raise AssertionError(f"K2 wrote {nonzero} nonzero lanes past "
                                 f"tgt_len")
        del want, absum, pay_abs, valid
        live = meta[:, 3] > 0
        ns = meta[live, 1].clamp(0, smax).double()
        nt = meta[live, 3].clamp(0, bt).double()
        pairs = int((ns * nt).sum())
        slots = int((ns * 32 * torch.ceil(nt / 32)).sum())
        warps = kstream.stream_launch_params(meta.shape[0])

        def k2():
            return kstream.p2p_stream(meta, payload, block_t=bt, smax=smax)

        ms = device_ms(torch, k2, reps=20)
        call_ms = cuda_ms(torch, k2)
        pms = cuda_ms(torch, lambda: kstream.p2p_stream_gathered(
            meta, payload, block_t=bt, smax=smax), reps=3)
        nbytes = 4.0 * (meta.numel() + payload.numel() + meta.shape[0] * bt)
        bms, by = bound_ms(nbytes, FLOPS_PER_PAIR * pairs)
        print(f"  K2 (tiles {meta.shape[0]}, live {int(live.sum())}), "
              f"{warps} warps a block of {kstream.TILES_PER_WARP} tiles "
              f"each: {ms:.4f} ms device time (one call "
              f"from the host {call_ms:.4f}), plain {pms:.4f} ms; terms "
              f"evaluated {pairs} = the live pairs (lane slots issued "
              f"{slots}, {smax * bt * int(live.sum())} before: smax x "
              f"block_t a live tile); bound {bms:.4f} ms ({by}), "
              f"{bms / ms:.1%} of it; power limit {power}", flush=True)
        results["K2"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                             max_abs_err=err, pairs=pairs)

        ml = meta[live]
        if ml.shape[0] > BITWISE_TILES:       # an evenly strided sample
            ml = ml[::-(-ml.shape[0] // BITWISE_TILES)].contiguous()
        qs, xs, xt = kstream.stream_slabs(ml, payload, block_t=bt, smax=smax)
        a = kp2p.p2p(qs, xs, xt)
        b2 = kstream.p2p_stream(ml.contiguous(), payload, block_t=bt,
                                smax=smax)
        lv = torch.arange(bt, device=dev)[None, :] < ml[:, 3:4]
        if not torch.equal(a[lv], b2[lv]):
            raise AssertionError(
                f"K1 and K2 differ on identical slabs: "
                f"{int((a[lv] != b2[lv]).sum())} of {int(lv.sum())} values")
        print(f"  K1 == K2 bitwise on {ml.shape[0]} identical live slabs "
              f"({int(lv.sum())} lanes below tgt_len)", flush=True)
        del qs, xs, xt, a, b2, got, ml, lv
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- 4 -----
    with phase("card against CPU, N = 20000"):
        ns = 20000
        xs_ = make_distribution("sphere", ns, seed=42)
        qs_ = np.random.default_rng(0).uniform(-1, 1, ns)
        geo = plan_geometry(xs_, qs_, spec, device="cpu")
        # sum_j |q_j| / r_ij, the scale of each potential's float32 rounding
        phi_abs = FMMSession(plan_geometry(xs_, np.abs(qs_), spec,
                                           device="cpu"),
                             device="cpu").evaluate()
        for stream_on in (False, True):
            phi_c = FMMSession(geo, device=dev, p2p_stream=stream_on,
                               fused=False).evaluate()
            phi_h = FMMSession(geo, device="cpu",
                               p2p_stream=stream_on).evaluate()
            diff = np.abs(phi_c - phi_h)
            plain = int((diff > 1e-4 + 1e-5 * np.abs(phi_h)).sum())
            bad = int((diff > 1e-4 + 1e-5 * np.abs(phi_h)
                       + 1e-6 * phi_abs).sum())
            print(f"  stream={stream_on}: max |card - cpu| {diff.max():.3e}, "
                  f"max |phi| {np.abs(phi_h).max():.3e}, max sum|q|/r "
                  f"{phi_abs.max():.3e}; over rtol 1e-5 + atol 1e-4: {plain}"
                  f", over that + 1e-6 sum|q|/r: {bad}", flush=True)
            if bad:
                raise AssertionError("card and CPU engines disagree")

        # stepped sessions: the card's planned through K3, the CPU's through
        # its plain version (bit for bit the same margins, so the same plans)
        card_s = FMMSession.from_points(xs_, qs_, spec, device=dev,
                                        fused=False)
        cpu_s = FMMSession.from_points(
            xs_, qs_, dc_replace(spec, traversal_backend="device"),
            device="cpu")
        same = all(same_plan(u, v) for rc, rh in zip(
            card_s.geometry.receivers, cpu_s.geometry.receivers)
            for u, v in [(rc.local, rh.local)] + [
                (a.inter, b.inter) for a, b in zip(rc.remote, rh.remote)])
        if not same:
            raise AssertionError("K3 and its plain version planned "
                                 "different geometries")
        card_s.evaluate()
        cpu_s.evaluate()
        eps = float(cpu_s.geometry.slack.min())
        x1 = xs_ + np.random.default_rng(2).uniform(-eps / 4, eps / 4,
                                                    xs_.shape)
        x2 = x1.copy()
        x2[cpu_s.geometry.owners[MOVER]] += MOVER_SHIFT
        for label, xk, want in (("within-slack step", x1, ()),
                                ("beyond-slack step", x2, (MOVER,))):
            rc, rh = card_s.step(xk), cpu_s.step(xk)
            if not (rc.rebuilt == rh.rebuilt == want
                    and rc.refreshed == rh.refreshed):
                raise AssertionError(f"{label}: card {rc} and CPU {rh}")
            phi_c, phi_h = card_s.evaluate(), cpu_s.evaluate()
            absum = direct_potential(xk, np.abs(qs_), device=dev)
            diff = np.abs(phi_c - phi_h)
            bad = int((diff > 1e-4 + 1e-5 * np.abs(phi_h)
                       + 1e-6 * absum).sum())
            print(f"  {label} (rebuilt {rc.rebuilt}, refreshed "
                  f"{rc.refreshed}): max |card - cpu| {diff.max():.3e}, "
                  f"over rtol 1e-5 + atol 1e-4 + 1e-6 sum|q|/r: {bad}",
                  flush=True)
            if bad:
                raise AssertionError(f"{label}: card and CPU disagree")
        del card_s, cpu_s

    # ------------------------------------------------------------- 5 -----
    with phase(f"main path, N = {n}"):
        kp2p.launches = 0
        kstream.launches = 0
        out = {}
        for label, sess in (("gathered", sess_g), ("stream", sess_s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phi = sess.evaluate()
            cold = time.perf_counter() - t0
            warm = []
            for _ in range(3):
                t0 = time.perf_counter()
                phi = sess.evaluate()
                warm.append(time.perf_counter() - t0)
            out[label] = phi
            print(f"  {label}: evaluate cold {cold:.4f} s, warm median "
                  f"{statistics.median(warm):.4f} s "
                  f"(runs {', '.join(f'{w:.4f}' for w in warm)})", flush=True)
        launches.update(K1=kp2p.launches, K2=kstream.launches)
        print(f"  launches on the main path: K1 {launches['K1']}, "
              f"K2 {launches['K2']}", flush=True)
        for k, v in launches.items():
            if v <= 0:
                raise AssertionError(f"{k} was not launched on the main path")

        for label, sess in (("gathered", sess_g), ("stream", sess_s)):
            e = sess.engine
            tm = {}

            def timed(key, fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn()
                torch.cuda.synchronize()
                tm[key] = time.perf_counter() - t0
                return r

            e._M = None       # the multipoles are cached per payload
            M = timed("upward", e.upward)
            far = timed("far_field", lambda: e.far_field(M))
            near = timed("p2p", e.near_field)
            m2p = timed("m2p", lambda: e.m2p(M))
            parts = [far, *near] + ([m2p] if m2p is not None else [])
            timed("accumulate", lambda: e.accumulate(parts))
            print(f"  {label} phases (warm, s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in tm.items()),
                  flush=True)

        for label, sess in (("gathered", sess_g), ("stream", sess_s)):
            profile_run(torch, label, sess.evaluate)

        phi_g, phi_s = out["gathered"], out["stream"]
        for label, phi in out.items():
            if phi.shape != (n,) or not np.isfinite(phi).all():
                raise AssertionError(f"{label}: bad potential")
        # rtol 1e-5; atol 1e-5 of the largest |phi|: the float32
        # index_add_ segment sums (P2M, M2L) use atomics whose order changes
        # from run to run, so two evaluations differ by float32 rounding of
        # terms as large as the largest potential, also where values cancel
        atol = 1e-5 * float(np.abs(phi_g).max())
        diff = np.abs(phi_s - phi_g)
        print(f"  stream vs gathered: max diff {diff.max():.3e}, max |phi| "
              f"{np.abs(phi_g).max():.3e}, values differing "
              f"{int((diff > 0).sum())}", flush=True)
        if not np.allclose(phi_s, phi_g, rtol=1e-5, atol=atol):
            raise AssertionError("stream and gathered potentials disagree")
        idx = np.random.default_rng(1).choice(n, size=min(4096, n),
                                              replace=False)
        t0 = time.perf_counter()
        d = direct_potential(x, q, x_tgt=x[idx], chunk=64, device=dev)
        print(f"  float64 direct sum on {len(idx)} targets: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for label, phi in out.items():
            rel = float(np.linalg.norm(phi[idx] - d) / np.linalg.norm(d))
            print(f"  {label}: rel-L2 error vs direct sum {rel:.3e}",
                  flush=True)
            if not rel < 3e-3:
                raise AssertionError(f"{label}: rel-L2 {rel} >= 3e-3")
        del sess_s, out, phi_g, phi_s

    # ------------------------------------------------------------- 6 -----
    with phase(f"protocols and the reference executor, N = {n}"):
        protocols_and_executor(torch, sess_g, x, q, idx, d, dev, card)
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- 7 -----
    with phase(f"stepping, N = {n}"):
        sess = sess_g
        geo = sess.geometry
        eps = float(geo.slack.min())
        guard = sess.engine.drift_guard
        print(f"  slack min {eps:.4e}, max {geo.slack.max():.4e}; float32 "
              f"drift guard {guard:.4e}: the steps revalidate "
              + ("on the device" if eps > guard else
                 "on the host in float64 (slack below the guard band)"),
              flush=True)
        sess.evaluate()
        rng = np.random.default_rng(2)

        def timed_step(xk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = sess.step(xk)
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t0
            t0 = time.perf_counter()
            phi = sess.evaluate()
            return rep, phi, t_step, time.perf_counter() - t0

        for k in range(3):
            xk = x + rng.uniform(-eps / 4, eps / 4, x.shape)
            rep, phi, t_step, t_eval = timed_step(xk)
            print(f"  within-slack step {k + 1}: rebuilt {rep.rebuilt}, "
                  f"refreshed {rep.refreshed}; step {t_step:.4f} s, "
                  f"evaluate after it {t_eval:.4f} s; card {card}",
                  flush=True)
            if rep.rebuilt != () or len(rep.refreshed) != spec.nparts:
                raise AssertionError(f"within-slack step {k + 1}: {rep}")
        rel = rel_l2(dev, xk, q, phi, direct_potential)
        print(f"  after the within-slack steps: rel-L2 vs direct sum "
              f"{rel:.3e}", flush=True)
        if not rel < 3e-3:
            raise AssertionError(f"stepped rel-L2 {rel} >= 3e-3")

        x_moved = xk.copy()
        x_moved[sess.geometry.owners[MOVER]] += MOVER_SHIFT
        kmac.launches = 0
        rep, phi, t_step, t_eval = timed_step(x_moved)
        k3_step = kmac.launches
        print(f"  beyond-slack step: rebuilt {rep.rebuilt}, refreshed "
              f"{rep.refreshed}, K3 launches {k3_step}; step {t_step:.4f} "
              f"s, evaluate after it (engine rebuilt) {t_eval:.4f} s; card "
              f"{card}", flush=True)
        if rep.rebuilt != (MOVER,) or k3_step <= 0:
            raise AssertionError(f"beyond-slack step: {rep}, K3 launches "
                                 f"{k3_step}")
        rel = rel_l2(dev, x_moved, q, phi, direct_potential)
        print(f"  after the rebuild: rel-L2 vs direct sum {rel:.3e}",
              flush=True)
        if not (phi.shape == (n,) and np.isfinite(phi).all()
                and rel < 3e-3):
            raise AssertionError(f"rebuilt rel-L2 {rel} >= 3e-3")

    # ------------------------------------------------------------ 7b -----
    del sess, sess_g
    torch.cuda.empty_cache()
    with phase(f"multi-rank LET exchange, ranks stacked on the card, N = "
               f"{n}"):
        err = dist_exchange(torch, geo_main, x, q, idx, d, dev, card)
        results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], err)

    # ------------------------------------------------------------- 8 -----
    with phase(f"compiled serving (CUDA graphs), N = {n}"):
        print(f"  card {card}", flush=True)
        compiled_fmm(torch, geo_main, x, q, spec, idx, d, dev, card)
        for arch in ("qwen3-0.6b", "rwkv6-1.6b", "gemma3-12b", "dbrx-132b",
                     "hymba-1.5b"):
            t0 = time.perf_counter()
            lm_graph(torch, arch, dev, card)
            print(f"  {arch}: graph against eager {time.perf_counter() - t0:.3f}"
                  f" s", flush=True)

    # ------------------------------------------------------------ 8b -----
    with phase(f"observability and resilience, N = {n}"):
        obs_resilience(torch, geo_main, spec, x, q, dev, card,
                       args.out.resolve())
    del geo_main

    # ------------------------------------------------------------- 9 -----
    with phase("LM kernels K4 and K5 against their plain versions"):
        results.update(lm_kernel_checks(torch, kattn, krwkv, dev, power))
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ 10 -----
    launches.update(K4=0, K5=0)
    for arch, counter, name in (("qwen3-0.6b", kattn, "K4"),
                                ("rwkv6-1.6b", krwkv, "K5"),
                                ("gemma3-12b", kattn, "K4"),
                                ("phi4-mini-3.8b", kattn, "K4"),
                                ("smollm-360m", kattn, "K4"),
                                ("dbrx-132b", kattn, "K4"),
                                ("hymba-1.5b", kattn, "K4")):
        with phase(f"serving {arch}"):
            launches[name] += serve_lm(torch, arch, counter, dev,
                                       card)["launches"]
    for arch in ("dbrx-132b", "llama4-scout-17b-a16e"):
        with phase(f"{arch}: a short request against its forward"):
            launches["K4"] += moe_forward_check(torch, arch, dev, card)
    for arch in ("seamless-m4t-medium", "llama-3.2-vision-90b"):
        with phase(f"serving {arch} through Model.prefill + decode_step"):
            launches["K4"] += serve_embedded(torch, arch, dev, card)

    # ------------------------------------------------------------ 11 -----
    with phase("LM training: K4's and K5's gradients against their plain "
               "versions"):
        print(f"  card {card}", flush=True)
        kernel_gradients(torch, kattn, krwkv, dev, power)
    with phase(f"LM training: launch.train.run ({TRAIN_ARCH}, restart, "
               f"rwkv6-1.6b)"):
        for name, n in lm_training(torch, kattn, krwkv, dev, card).items():
            launches[name] += n

    # ------------------------------------------------------------ 12 -----
    print(f"  card {card}", flush=True)
    launches["K4"] += lm_sharding(torch, kattn, dev, card)

    # ------------------------------------------------------------ 13 -----
    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    replaces = {
        "K1": ("csrc/p2p.cu", "src/repro/kernels/p2p.py:248"),
        "K2": ("csrc/p2p_stream.cu", "src/repro/kernels/p2p_stream.py:111"),
        "K3": ("csrc/mac.cu", "src/repro/kernels/mac.py:53"),
        "K4": ("csrc/attention.cu", "src/repro/kernels/attention.py:73"),
        "K5": ("csrc/wkv.cu", "src/repro/kernels/rwkv.py:48"),
    }
    kernels = []
    for name, (src, rep) in replaces.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}", "replaces": rep,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
